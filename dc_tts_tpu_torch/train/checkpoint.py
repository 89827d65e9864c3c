"""Checkpoints in the JAX package's npz layout, the port of
``dc_tts_tpu/train/checkpoint.py``.

A checkpoint is ``<logdir>/model_gs_{NNN}k.npz`` holding one array per
leaf, keyed by the leaf's path joined with ``//`` (dict keys and list
indices, e.g. ``audio_enc//3//conv//w``), plus ``__step__``. A train state
keeps the parameters under ``params//`` and the optimizer state under
``opt_state//`` with optax's keys (``train/optimizer.py``), so either
package resumes the other's checkpoints; a parameters-only template
restores from either kind of file.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

_SEP = "//"


def _flatten(tree, prefix="", out=None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{_SEP}{i}" if prefix else str(i), out)
    else:
        out[prefix] = tree.detach().cpu().numpy() \
            if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return out


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


def step_name(step: int) -> str:
    """'model_gs_012k' for step 12000."""
    return "model_gs_" + str(step // 1000).zfill(3) + "k"


def save(logdir: str, tree: Any, step: int, keep: int = 5) -> str:
    """Save a tree as ``model_gs_{NNN}k.npz`` and keep the newest ``keep``
    files (0 keeps all)."""
    os.makedirs(logdir, exist_ok=True)
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step, np.int64)
    path = os.path.join(logdir, step_name(step) + ".npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if keep:
        for old in sorted_checkpoints(logdir)[:-keep]:
            os.remove(os.path.join(logdir, old))
    return path


def save_train_state(logdir: str, params: Any, opt_state: Any, step: int,
                     keep: int = 5) -> str:
    return save(logdir, {"params": params, "opt_state": opt_state}, step,
                keep=keep)


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


def _load_latest(logdir: str):
    path = latest_path(logdir)
    if path is None:
        return None, 0
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return flat, int(flat.pop("__step__", 0))


def restore(logdir: str, template: Any) -> Tuple[Any, int]:
    """Restore the latest checkpoint into ``template``'s structure, dtypes
    and devices. Returns (tree, step); raises FileNotFoundError when the
    directory holds no checkpoint."""
    flat, step = _load_latest(logdir)
    if flat is None:
        raise FileNotFoundError(f"no checkpoint in {logdir}")
    return _unflatten_into(template, flat), step


def restore_or_init(logdir: str, template: Any) -> Tuple[Any, int]:
    """Restore the latest checkpoint if there is one, else keep the
    template at step 0 (the original trainer's crash-and-resume)."""
    try:
        return restore(logdir, template)
    except FileNotFoundError:
        return template, 0


def _fast_forward_counts(opt_state: Any, step: int) -> Any:
    """The optimizer state with every scalar ``count`` set to ``step``: a
    legacy params-only checkpoint resumes the schedule where it stopped
    (the moments cannot be recovered and restart at zero)."""
    if isinstance(opt_state, dict):
        return {k: (torch.tensor(step, dtype=v.dtype)
                    if k == "count" and isinstance(v, torch.Tensor)
                    and v.dim() == 0 else _fast_forward_counts(v, step))
                for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return [_fast_forward_counts(v, step) for v in opt_state]
    return opt_state


def restore_train_state(logdir: str, params_template: Any,
                        opt_state_template: Any
                        ) -> Tuple[Any, Any, int, str]:
    """(params, opt_state, step, kind) from the latest checkpoint. kind is
    "full" (parameters and optimizer state), "legacy" (a params-only file:
    moments at zero, counts fast-forwarded to its step) or "cold" (no
    checkpoint: the templates and step 0)."""
    flat, step = _load_latest(logdir)
    if flat is None:
        return params_template, opt_state_template, 0, "cold"
    try:
        tree = _unflatten_into({"params": params_template,
                                "opt_state": opt_state_template}, flat)
        return tree["params"], tree["opt_state"], step, "full"
    except KeyError:
        params = _unflatten_into(params_template, flat)
        return (params, _fast_forward_counts(opt_state_template, step), step,
                "legacy")
