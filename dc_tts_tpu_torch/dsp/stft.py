"""Centered STFT / iSTFT in ``torch.fft`` form, the port of the ``fft``
method of ``dc_tts_tpu/dsp/stft.py``.

Conventions match librosa's defaults as the original DC-TTS uses them:
center=True (reflect pad n_fft//2), a periodic Hann of win_length
zero-padded symmetrically to n_fft, NOLA normalisation by the summed squared
window. Layout is time-major (..., frames, freq). Overlap-add sums the P =
ceil(n_fft/hop) frame streams in the same order as the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, centered in an n_fft buffer (float32)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad: lpad + win_length] = w
    return out.astype(np.float32)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frame count for a centered STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop


@functools.lru_cache(maxsize=8)
def _ola_window_sq(n_frames: int, n_fft: int, hop: int,
                   win_length: int) -> np.ndarray:
    """1 / summed squared window (NOLA), with sums <= 1e-11 read as 1."""
    win = hann_window(win_length, n_fft).astype(np.float64)
    total = n_fft + hop * (n_frames - 1)
    wsq = np.zeros(total)
    for f in range(n_frames):
        wsq[f * hop: f * hop + n_fft] += win * win
    wsq[wsq <= 1e-11] = 1.0
    return (1.0 / wsq).astype(np.float32)


def _window(win_length: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(hann_window(win_length, n_fft), device=like.device)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """frames (..., F, n_fft) -> (..., n_fft + hop*(F-1)): stream j adds
    segment j of every frame f into output segment f + j."""
    *batch, n_frames, n_fft = frames.shape
    P = -(-n_fft // hop)
    c = F.pad(frames, (0, P * hop - n_fft)).reshape(*batch, n_frames, P, hop)
    out = frames.new_zeros(*batch, n_frames + P - 1, hop)
    for j in range(P):
        out[..., j: j + n_frames, :] += c[..., :, j, :]
    return out.reshape(*batch, -1)[..., : n_fft + hop * (n_frames - 1)]


def stft(y: torch.Tensor, n_fft: int, hop: int,
         win_length: int) -> torch.Tensor:
    """y (..., n) -> complex64 (..., 1 + n//hop, n_freq)."""
    pad = n_fft // 2
    lead = y.shape[:-1]
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = yp.reshape(*lead, -1).unfold(-1, n_fft, hop)
    return torch.fft.rfft(frames * _window(win_length, n_fft, y), dim=-1)


def istft(S: torch.Tensor, n_fft: int, hop: int,
          win_length: int) -> torch.Tensor:
    """S (..., n_frames, n_freq) complex -> (..., hop*(n_frames-1)) float32:
    windowed inverse DFT frames, overlap-add, NOLA, trim n_fft//2 from both
    ends."""
    f = S.shape[-2]
    frames = torch.fft.irfft(S, n=n_fft, dim=-1) \
        * _window(win_length, n_fft, S)
    y = _overlap_add(frames, hop) * torch.as_tensor(
        _ola_window_sq(f, n_fft, hop, win_length), device=S.device)
    pad = n_fft // 2
    return y[..., pad: n_fft + hop * (f - 1) - pad]
