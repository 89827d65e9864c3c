"""Tensor parallelism over the model axis: what GSPMD does for the JAX
package's ``--model-parallel``.

JAX shards the conv and deconv kernels' output channels over the mesh's
model axis (``mesh.param_partition_specs``) and lets GSPMD place the
collectives. Here a model rank holds the contiguous slice j of every such
kernel's output channels (``shard_params``); biases, layer-norm scales, the
embedding and the kernels the rule leaves whole are whole on every rank.
Activations are replicated: a sharded conv computes its slice of the output
channels and gathers them over the model group (``gather_from_model``), so
every model rank computes the same loss. Two autograd rules make the
gradients JAX's:

- ``copy_to_model``: the identity forward; the backward sums the gradient
  over the model group. On a sharded conv's input it adds the other ranks'
  ``dy_j @ W_j^T`` to this rank's, so ``dx`` is whole.
- ``gather_from_model``: the forward gathers along the last dimension in
  model-coordinate order; the backward keeps this rank's slice of the
  incoming gradient, with no sum (every model rank already holds the whole
  gradient, so the sum that ``torch.distributed.nn.functional.all_gather``
  takes would multiply it by the model size).

A conv kernel is sharded exactly when its output width is narrower than its
bias's: the rule shards no other leaf, and a bias is never sharded
(``is_sharded``). ``gather_params`` reads that, so a tree of this rank's
slices (parameters, or Adam's moments, which share their structure) gathers
back to the whole tree without its specs.

A group of None is one rank with nothing to exchange: every function here
is then the identity. The collectives are ``distributed.py``'s, so a gloo
group with tensors on the card goes through the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import all_gather_cat, all_reduce_sum_
from .mesh import Mesh, param_partition_specs


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_sum_([g], ctx.group)
        return g, None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every model rank's x concatenated along the last dimension, in
    model-coordinate order (the group's ranks are its global ranks sorted,
    which is the coordinate order of ``mesh.make_mesh``)."""
    parts = all_gather_cat(x.unsqueeze(0), group, 0)
    return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.j, ctx.n = dist.get_rank(group), x.shape[-1]
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.j * ctx.n: (ctx.j + 1) * ctx.n].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient summed over the model group."""
    return x if group is None else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's x (this rank's slice of the last dimension)
    gathered whole; the gradient back is this rank's slice, not summed."""
    return x if group is None else _GatherFromModel.apply(x, group)


def is_sharded(conv: dict) -> bool:
    """Whether a conv's kernel (K, Cin, Cout) holds a slice of its output
    channels: narrower than its bias."""
    return conv["w"].shape[-1] != conv["b"].shape[-1]


def shard_params(params, mesh: Mesh):
    """This rank's slices of a whole tree by ``param_partition_specs``:
    slice ``mesh.coords["model"]`` of each sharded kernel's last dimension,
    every other leaf whole (all copies). A model axis of 1 returns the tree
    itself."""
    m = mesh.shape["model"]
    if m == 1:
        return params
    j = mesh.coords["model"]

    def shard(x, spec):
        if isinstance(x, dict):
            return {k: shard(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [shard(v, s) for v, s in zip(x, spec)]
        x = x.detach()
        if spec:
            n = x.shape[-1] // m
            x = x[..., j * n: (j + 1) * n]
        return x.clone(memory_format=torch.contiguous_format)

    return shard(params, param_partition_specs(params, mesh))


def gather_params(tree, mesh: Mesh):
    """The whole tree from this rank's slices (``shard_params``' inverse):
    a collective over the model group, which every rank of it calls. The
    leaves are detached; a model axis of 1 returns the tree itself."""
    group = mesh.groups["model"]
    if mesh.shape["model"] == 1 or group is None:
        return tree
    if isinstance(tree, dict):
        out = {k: gather_params(v, mesh) for k, v in tree.items()}
        if "w" in tree and "b" in tree and is_sharded(tree):
            out["w"] = _gather_last(tree["w"].detach(), group)
        return out
    if isinstance(tree, (list, tuple)):
        return [gather_params(v, mesh) for v in tree]
    return tree.detach()
