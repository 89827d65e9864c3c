"""Alignment and spectrogram plots (training health checks), the port's
copy of ``dc_tts_tpu/utils/plotting.py``. matplotlib is optional: without
it plotting does nothing.
"""
from __future__ import annotations

import os

import numpy as np


def _get_plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def plot_alignment(alignment: np.ndarray, global_step, out_dir: str) -> str:
    """alignment (N, T) -> out_dir/alignment_{gs}.png."""
    plt = _get_plt()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"alignment_{global_step}.png")
    if plt is None:
        return ""
    fig, ax = plt.subplots()
    im = ax.imshow(np.asarray(alignment), aspect="auto", origin="lower")
    fig.colorbar(im)
    ax.set_xlabel("decoder step (T/r)")
    ax.set_ylabel("text position (N)")
    ax.set_title(f"{global_step} steps")
    fig.savefig(path, format="png")
    plt.close(fig)
    return path


def plot_spectrogram(spec: np.ndarray, name: str, global_step,
                     out_dir: str) -> str:
    """spec (T, bins) -> out_dir/{name}_{gs}.png."""
    plt = _get_plt()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}_{global_step}.png")
    if plt is None:
        return ""
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(spec).T, aspect="auto", origin="lower")
    fig.colorbar(im)
    ax.set_title(f"{name} @ {global_step}")
    fig.savefig(path, format="png")
    plt.close(fig)
    return path
