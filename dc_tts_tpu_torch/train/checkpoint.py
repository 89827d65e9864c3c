"""Checkpoint restore in the JAX package's npz layout
(``dc_tts_tpu/train/checkpoint.py``).

A checkpoint is ``<logdir>/model_gs_{NNN}k.npz`` holding one array per
parameter leaf, keyed by the leaf's path joined with ``//`` (dict keys and
list indices, e.g. ``audio_enc//3//conv//w``), plus ``__step__``. A full
train state keeps the parameters under ``params//``; a parameters-only
template restores from either.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

_SEP = "//"


def _unflatten_into(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat,
                                   f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_into(v, flat,
                                f"{prefix}{_SEP}{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    key = prefix
    if key not in flat:
        # a params-only template restored from a full train state
        key = "params" + _SEP + prefix
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                         f"model {tuple(template.shape)}")
    return torch.as_tensor(np.asarray(arr), dtype=template.dtype,
                           device=template.device)


def sorted_checkpoints(logdir: str):
    if not os.path.isdir(logdir):
        return []
    pat = re.compile(r"model_gs_(\d+)k\.npz$")
    found = [(int(m.group(1)), f) for f in os.listdir(logdir)
             if (m := pat.match(f))]
    return [f for _, f in sorted(found)]


def latest_path(logdir: str) -> Optional[str]:
    ckpts = sorted_checkpoints(logdir)
    return os.path.join(logdir, ckpts[-1]) if ckpts else None


def restore(logdir: str, template: Any) -> Tuple[Any, int]:
    """Restore the latest checkpoint into ``template``'s structure, dtypes
    and devices. Returns (tree, step); raises FileNotFoundError when the
    directory holds no checkpoint."""
    path = latest_path(logdir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {logdir}")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__", 0))
    return _unflatten_into(template, flat), step
