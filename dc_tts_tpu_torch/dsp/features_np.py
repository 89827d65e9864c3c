"""Feature extraction in numpy for the loader's threads (the on-the-fly
mode, ``TrainLoader(on_the_fly=True)``); the port's copy of
``dc_tts_tpu/dsp/features_np.py``. The threads stay off the card, so this
mirrors ``features.wav_to_spectrograms`` in numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import Config
from .mel import mel_filterbank
from .stft import hann_window, num_frames


def wav_to_spectrograms_np(y: np.ndarray, cfg: Config
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Waveform (n,) -> (mel (T, n_mels), mag (T, n_freq)), float32.

    Same pipeline as the device path: preemphasis -> centered STFT
    magnitude -> mel matmul -> dB -> normalize.
    """
    y = np.asarray(y, np.float32)
    y = np.concatenate([y[:1], y[1:] - cfg.preemphasis * y[:-1]])

    n_fft, hop, win_l = cfg.n_fft, cfg.hop_length, cfg.win_length
    pad = n_fft // 2
    yp = np.pad(y, (pad, pad), mode="reflect")
    f = num_frames(len(y), n_fft, hop)
    idx = np.arange(f)[:, None] * hop + np.arange(n_fft)[None, :]
    if idx.max() >= len(yp):
        yp = np.pad(yp, (0, idx.max() + 1 - len(yp)))
    frames = yp[idx] * hann_window(win_l, n_fft)
    mag = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)

    basis = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels)
    mel = mag @ basis.T

    def to_norm_db(x):
        db = 20.0 * np.log10(np.maximum(1e-5, x))
        return np.clip((db - cfg.ref_db + cfg.max_db) / cfg.max_db,
                       1e-8, 1.0).astype(np.float32)

    return to_norm_db(mel), to_norm_db(mag)
