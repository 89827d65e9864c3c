"""Spectrogram features, pre/de-emphasis filters and silence trimming, the
port of ``dc_tts_tpu/dsp/features.py``.

``wav_to_spectrograms`` is the feature contract of training: pre-emphasis,
|STFT| (``stft.py``), the mel projection, dB and normalisation, on the
tensor's device. ``reduce_mel`` keeps every r-th mel frame for Text2Mel.

The de-emphasis IIR y[t] = x[t] + coef*y[t-1] (``scipy.signal.lfilter([1],
[1, -coef], x)``) is computed blocked, without a sequential loop: within a
block of L samples it is an upper-triangular Toeplitz matmul, and the carry
between blocks (c_f = coef^L c_{f-1} + last of block f) is the same
recurrence over the n/L block ends, again one Toeplitz matmul. The two
matrices and the decay are made once a (coef, L, nb, dtype, device) and kept
on the device (``_deemphasis_tables``): an upload from pageable memory would
make the host wait for the stream on every call. Each upload is counted as
``deemphasis.table_uploads`` (``utils/profiling``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import count
from .mel import mel_filterbank
from .stft import stft


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """y'[0] = y[0]; y'[t] = y[t] - coef*y[t-1]."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


@functools.lru_cache(maxsize=16)
def _iir_toeplitz(coef: float, L: int) -> np.ndarray:
    """(L, L) K[j, i] = coef^(i-j) for i >= j, else 0 (float64 powers)."""
    idx = np.arange(L)
    p = idx[None, :] - idx[:, None]
    K = np.where(p >= 0, coef ** np.maximum(p, 0), 0.0)
    return K.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _deemphasis_tables(coef: float, L: int, nb: int, dtype: torch.dtype,
                       device: torch.device):
    """De-emphasis's (L, L) block Toeplitz, (nb, nb) carry Toeplitz and (L,)
    decay coef^(1..L), float32 values in ``dtype`` on ``device``."""
    count("deemphasis.table_uploads")
    kw = {"device": device, "dtype": dtype}
    return (torch.as_tensor(_iir_toeplitz(coef, L), **kw),
            torch.as_tensor(_iir_toeplitz(coef ** L, nb), **kw),
            torch.as_tensor((coef ** np.arange(1, L + 1)).astype(np.float32),
                            **kw))


def deemphasis(x: torch.Tensor, coef: float, block: int = 512
               ) -> torch.Tensor:
    """Inverse pre-emphasis filter along the last axis, blocked as two
    Toeplitz matmuls (see the module docstring). float32, or float64 for a
    float64 input."""
    if x.dtype != torch.float64:
        x = x.float()
    n = x.shape[-1]
    L = min(block, max(1, n))
    nb = -(-n // L)
    xb = F.pad(x, (0, nb * L - n)).reshape(*x.shape[:-1], nb, L)
    K, Kc, decay = _deemphasis_tables(coef, L, nb, x.dtype, x.device)
    local = xb @ K
    carry = local[..., -1] @ Kc
    prev = F.pad(carry[..., :-1], (1, 0))
    y = local + prev[..., None] * decay
    return y.reshape(*x.shape[:-1], nb * L)[..., :n]


def wav_to_spectrograms(y: torch.Tensor, cfg
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveform (..., n) -> (mel (..., T, n_mels), mag (..., T, n_freq)):
    pre-emphasis -> |STFT| -> mel matmul -> 20 log10(max(1e-5, .)) ->
    clip((db - ref_db + max_db) / max_db, 1e-8, 1), float32, time-major."""
    y = preemphasis(y.float(), cfg.preemphasis)
    mag = stft(y, cfg.n_fft, cfg.hop_length, cfg.win_length).abs()
    basis = torch.as_tensor(mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels),
                            device=y.device)
    mel = mag @ basis.T

    def to_norm_db(x):
        db = 20.0 * torch.log10(torch.clamp(x, min=1e-5))
        return torch.clamp((db - cfg.ref_db + cfg.max_db) / cfg.max_db,
                           1e-8, 1.0)

    return to_norm_db(mel), to_norm_db(mag)


def reduce_mel(mel: np.ndarray, mag: np.ndarray, r: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad T to a multiple of r and keep every r-th mel frame: mel becomes
    (T/r, n_mels), mag keeps (T, n_freq)."""
    t = mel.shape[-2]
    pad = (r - t % r) % r
    widths = [(0, 0)] * (mel.ndim - 2) + [(0, pad), (0, 0)]
    mel = np.pad(mel, widths, mode="constant")
    mag = np.pad(mag, widths, mode="constant")
    return mel[..., ::r, :], mag


def trim_silence(y: np.ndarray, top_db: float = 60.0,
                 frame_length: int = 2048, hop_length: int = 512
                 ) -> np.ndarray:
    """Trim leading/trailing silence, librosa.effects.trim-style (host
    numpy): frame RMS -> dB relative to peak -> keep [first, last] frame
    above -top_db."""
    if y.size == 0:
        return y
    n = len(y)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + n // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    frames = yp[np.minimum(idx, len(yp) - 1)]
    rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=-1))
    ref = rms.max()
    if ref <= 0:
        return y
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    nonsilent = np.flatnonzero(db > -top_db)
    if nonsilent.size == 0:
        return y[:0]
    start = int(nonsilent[0]) * hop_length
    end = min(n, (int(nonsilent[-1]) + 1) * hop_length)
    return y[start:end]
