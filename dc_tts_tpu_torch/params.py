"""Parameter trees: the port keeps the JAX package's pytree layout (nested
dicts and lists) with torch tensors as leaves, so one checkpoint format and
one set of keys serve both packages."""
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
