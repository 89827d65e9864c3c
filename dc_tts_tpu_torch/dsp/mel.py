"""Slaney-style mel filterbank, computed once on the host as a constant;
the port's copy of ``dc_tts_tpu/dsp/mel.py`` (numpy).

The same matrix as ``librosa.filters.mel(sr, n_fft, n_mels)`` with
librosa's defaults: fmin=0, fmax=sr/2, the Slaney mel scale (linear below
1 kHz, log above) and Slaney area normalisation.
"""
from __future__ import annotations

import functools

import numpy as np

_F_SP = 200.0 / 3.0           # Hz per mel below the break frequency
_MIN_LOG_HZ = 1000.0          # break frequency
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # mels-per-log-Hz above the break


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region,
                   _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region,
                 _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                 f)
    return f


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32 triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = 1 + n_fft // 2

    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # (n_mels + 2,)

    # Triangular filters via difference-of-ramps.
    fdiff = np.diff(hz_pts)                               # (n_mels+1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]          # (n_mels+2, n_freq)

    lower = -ramps[:-2] / fdiff[:-1, None]                # rising edge
    upper = ramps[2:] / fdiff[1:, None]                   # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))   # (n_mels, n_freq)

    # Slaney area normalization: each filter integrates to ~2/(width in Hz).
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
