"""Parameter trees: the port keeps the JAX package's pytree layout (nested
dicts and lists) with torch tensors as leaves, so one checkpoint format and
one set of keys serve both packages. ``from_jax_params`` and
``from_jax_train_state`` carry JAX's parameters and optimizer state (as
numpy) across; a shared npz checkpoint is the other route."""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device="cpu"):
    """A JAX parameter pytree (leaves as numpy arrays, or anything
    ``np.asarray`` reads) -> the port's parameters: the same nesting, float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def to_device(tree, device):
    """Move every tensor leaf of a parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _opt_leaf(v, device):
    a = np.asarray(v)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32)      # counts stay on host
    return torch.tensor(a.astype(np.float32), device=device)


def from_jax_opt_state(opt_state, device="cpu"):
    """An optax chain state (a tuple of NamedTuples, leaves as numpy
    arrays) -> the port's optimizer state (``train/optimizer.py``): each
    NamedTuple becomes a dict of its fields, so ``(EmptyState(),
    ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count),
    EmptyState())`` becomes ``[{}, {"count", "mu", "nu"}, {"count"}, {}]``
    with the same checkpoint keys."""
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        return {f: from_jax_opt_state(getattr(opt_state, f), device)
                for f in opt_state._fields}
    if isinstance(opt_state, dict):
        return {k: from_jax_opt_state(v, device)
                for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return [from_jax_opt_state(v, device) for v in opt_state]
    return _opt_leaf(opt_state, device)


def from_jax_train_state(params, opt_state, device="cpu"):
    """JAX's parameters and optax state (as numpy) -> the port's
    (params, opt_state), parameters marked for gradients."""
    p = from_jax_params(params, device)
    requires_grad(p)
    return p, from_jax_opt_state(opt_state, device)


def requires_grad(tree):
    """Mark every tensor leaf of a parameter tree for gradients."""
    if isinstance(tree, dict):
        for v in tree.values():
            requires_grad(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            requires_grad(v)
    else:
        tree.requires_grad_(True)
