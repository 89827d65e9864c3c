"""Scalar and image metric logging, the port's copy of
``dc_tts_tpu/utils/logging.py``: a JSONL stream (one line per log step),
plus TensorBoard event files (scalars and the mel/mag/alignment images)
when a SummaryWriter implementation is importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np


def _summary_writer(logdir: str):
    """Best-effort TensorBoard SummaryWriter (torch.utils.tensorboard or
    tensorboardX); None when neither is installed."""
    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        try:
            import importlib
            m = importlib.import_module(mod)
            return m.SummaryWriter(logdir)
        except Exception:
            continue
    return None


class MetricLogger:
    """JSONL metrics stream; ``tensorboard=True`` additionally writes
    TensorBoard event files into ``logdir`` (no-op if no writer backend)."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = _summary_writer(logdir) if tensorboard else None
        if tensorboard and self._tb is None:
            print("WARNING: --tensorboard requested but no SummaryWriter "
                  "backend is importable (need torch.utils.tensorboard or "
                  "tensorboardX); falling back to JSONL-only metrics")

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_image(self, step: int, tag: str, img: np.ndarray) -> None:
        """img: 2-D array (e.g. alignment (N,T) or spectrogram (T,bins)),
        normalized to [0,1] per image. Pixels go to TensorBoard when it is
        enabled; the JSONL stream records none."""
        if self._tb is None:
            return
        img = np.asarray(img, dtype=np.float32)
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        self._tb.add_image(tag, img[None, ...], int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
