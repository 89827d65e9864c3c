"""A seeded synthetic corpus in the LJSpeech layout, for exercising the
training path where no speech corpus is at hand.

``make_corpus`` writes ``<dir>/wavs/LJ000-NNNN.wav`` (16-bit PCM) and
``<dir>/transcript.csv`` (``fname|text|text`` lines). Each utterance is a
string of voiced "syllables": a harmonic tone whose pitch glides between
90 and 220 Hz under a few moving formant-like peaks, shaped by a Hann
envelope, with short pauses and up to 0.1 s of silence at both ends. It has the
shape of speech features (harmonics, formants, onsets) and none of its
content: training on it checks wiring, numerics and speed, not voices.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from scipy.io import wavfile


def _utterance(rng: np.random.Generator, seconds: float, sr: int
               ) -> np.ndarray:
    n = int(round(seconds * sr))
    edge = int(min(0.1, seconds / 8) * sr)
    y = np.zeros(n, np.float64)
    t0 = edge
    while t0 < n - edge:
        syl = int(rng.uniform(0.12, 0.3) * sr)
        syl = min(syl, n - edge - t0)
        t = np.arange(syl) / sr
        f0 = rng.uniform(90.0, 220.0) * (1.0 + rng.uniform(-0.2, 0.2)
                                         * t / max(t[-1], 1e-9))
        phase = 2.0 * np.pi * np.cumsum(f0) / sr
        formants = rng.uniform([300.0, 900.0, 2200.0], [900.0, 2200.0,
                                                        3400.0])
        s = np.zeros(syl)
        for h in range(1, int(min(sr / 2 - 1, 4000.0) // 90.0)):
            fh = h * f0.mean()
            if fh >= sr / 2:
                break
            amp = sum(np.exp(-0.5 * ((fh - f) / 150.0) ** 2)
                      for f in formants) / h ** 0.5
            s += amp * np.sin(h * phase)
        s *= np.hanning(syl) * rng.uniform(0.3, 1.0)
        y[t0: t0 + syl] += s
        t0 += syl + int(rng.uniform(0.0, 0.08) * sr)
    y += 1e-3 * rng.standard_normal(n)
    y[:edge] = 0.0
    y[n - edge:] = 0.0
    return (0.8 * y / max(np.abs(y).max(), 1e-9)).astype(np.float32)


def make_corpus(out_dir: str, texts: Sequence[str],
                seconds: Sequence[float], sr: int, seed: int = 0) -> str:
    """Write one utterance per (text, duration in seconds); returns
    ``out_dir``."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, (text, sec) in enumerate(zip(texts, seconds)):
        fname = f"LJ000-{i:04d}"
        y = _utterance(rng, float(sec), sr)
        wavfile.write(os.path.join(wav_dir, fname + ".wav"), sr,
                      np.round(y * 32767.0).astype(np.int16))
        lines.append(f"{fname}|{text}|{text}")
    with open(os.path.join(out_dir, "transcript.csv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return out_dir
