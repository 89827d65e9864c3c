"""Host-side wav input and output (scipy)."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from .features import trim_silence


def load_wav(path: str, target_sr: int, trim: bool = True) -> np.ndarray:
    """Read a wav file -> mono float32 in [-1, 1] at target_sr, leading and
    trailing silence trimmed (as librosa.load + librosa.effects.trim)."""
    sr, y = wavfile.read(path)
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif y.dtype == np.int32:
        y = y.astype(np.float32) / 2147483648.0
    elif y.dtype == np.uint8:
        y = (y.astype(np.float32) - 128.0) / 128.0
    else:
        y = y.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=-1)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        y = resample_poly(y, target_sr // g, sr // g).astype(np.float32)
    if trim:
        y = trim_silence(y)
    return np.ascontiguousarray(y, dtype=np.float32)


def save_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write a float32 waveform."""
    wavfile.write(path, sr, np.asarray(y, dtype=np.float32))
