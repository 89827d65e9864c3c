"""Optimizer: per-element gradient clipping, Adam and the Noam schedule, the
port of ``dc_tts_tpu/train/optimizer.py`` (an optax chain there).

    g  = clip(grad, -1, 1)
    mu = (1-b1) g + b1 mu;   nu = (1-b2) g^2 + b2 nu       (b1 0.9, b2 0.999)
    u  = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps), c = count + 1
    p  = p - lr(count) u,  lr(s) = lr0 sqrt(w) min((s+1) w^-1.5, (s+1)^-0.5)

Plain functions over the parameter tree. The state mirrors the optax
chain's, element for element, so a checkpoint carries the JAX package's
keys (``opt_state//1//count``, ``opt_state//1//mu//...``,
``opt_state//1//nu//...``, ``opt_state//2//count``):

    [{}, {"count", "mu", "nu"}, {"count"}, {}]

The counts are int32 scalars on the host; the moments live beside the
parameters. The update runs in place on the parameters and moments, each
operation one multi-tensor launch over all the leaves (``torch._foreach_*``),
elementwise as written above.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..config import Config

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the order of the JAX package's pytree flattening (dict keys
    sorted, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def noam_lr(count: int, init_lr: float, warmup_steps: float) -> np.float32:
    """The learning rate at the 0-based count, in float32 as the JAX
    schedule computes it (evaluated at count + 1)."""
    f = np.float32
    step = f(count) + f(1.0)
    return (f(init_lr * warmup_steps ** 0.5)
            * np.minimum(step * f(warmup_steps ** -1.5), step ** f(-0.5)))


def init_opt_state(params) -> list:
    def count():
        return torch.zeros((), dtype=torch.int32)
    zeros = tree_map(torch.zeros_like, params)
    return [{}, {"count": count(), "mu": zeros,
                 "nu": tree_map(torch.zeros_like, params)},
            {"count": count()}, {}]


@torch.no_grad()
def apply_updates(params, grads, opt_state: list, cfg: Config) -> list:
    """One optimizer step on ``params`` (in place) with ``grads`` (a tree of
    the same structure, or its leaf list). Returns the new state."""
    adam, sched = opt_state[1], opt_state[2]
    c_adam = int(adam["count"]) + 1
    f = np.float32
    bc1 = float(f(1.0) - f(B1) ** f(c_adam))
    bc2 = float(f(1.0) - f(B2) ** f(c_adam))
    lr = float(noam_lr(int(sched["count"]), cfg.lr, cfg.warmup_steps))
    ps, mus, nus = (tree_leaves(t) for t in (params, adam["mu"], adam["nu"]))
    gs = grads if isinstance(grads, list) else tree_leaves(grads)
    # one multi-tensor launch an operation over every leaf: ~13 launches a
    # leaf, ~1000 a SSRN step, would take the host longer than a bf16
    # step's device time
    gs = torch._foreach_clamp_max(torch._foreach_clamp_min(gs, -1.0), 1.0)
    torch._foreach_mul_(mus, B1)
    torch._foreach_add_(mus, gs, alpha=1.0 - B1)
    torch._foreach_mul_(nus, B2)
    torch._foreach_add_(nus, torch._foreach_mul(gs, gs), alpha=1.0 - B2)
    den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
    torch._foreach_add_(den, EPS)
    u = torch._foreach_div(torch._foreach_div(mus, bc1), den)
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(ps, u)
    return [{}, {"count": torch.tensor(c_adam, dtype=torch.int32),
                 "mu": adam["mu"], "nu": adam["nu"]},
            {"count": torch.tensor(int(sched["count"]) + 1,
                                   dtype=torch.int32)}, {}]
