"""Host-side wav output."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def save_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write a float32 waveform."""
    wavfile.write(path, sr, np.asarray(y, dtype=np.float32))
