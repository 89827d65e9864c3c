"""The ranks of a process group as a ``data x model`` grid, the port of
``dc_tts_tpu/parallel/mesh.py``.

JAX arranges devices in a named mesh and GSPMD shards arrays over it. Here
every rank is one process with one device: ``make_mesh`` arranges the
world's ranks row-major as JAX's ``create_device_mesh`` does (rank
``i * model + j`` at data coordinate i, model coordinate j) and builds one
process group for each data axis and each model axis. A spec is a plain
tuple, as ``PartitionSpec``: ``(None, None, "model")`` shards the last
dimension over the model axis, ``()`` replicates.

Data parallelism splits a batch's rows over the data axis (``shard_batch``,
each rank its contiguous rows). Tensor parallelism splits the conv kernels'
output channels over the model axis by ``param_partition_specs``, JAX's
rule (``tp.py``: ``shard_params``, the gathers, the training path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import world

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the grid. ``shape``: {"data": d, "model": m};
    ``coords``: this rank's {"data": i, "model": j}, None for a rank the
    grid leaves out; ``ranks``: the global ranks along each of this rank's
    axes, in coordinate order; ``groups``: their process groups (None
    without a process group: one rank, nothing to exchange)."""
    shape: dict
    coords: Optional[dict]
    ranks: dict
    groups: dict


def _grid(n: int, data: Optional[int], model: int, ranks):
    ranks = list(range(n)) if ranks is None else list(ranks)
    if data is None:
        data = len(ranks) // model
    need = data * model
    if need > len(ranks) or data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, have "
                         f"{len(ranks)}")
    grid = np.asarray(ranks[:need]).reshape(data, model)
    return ({"data": data, "model": model},
            [tuple(int(r) for r in grid[:, j]) for j in range(model)],
            [tuple(int(r) for r in grid[i, :]) for i in range(data)])


def mesh_grid(n: int, rank: int, data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The grid of ``n`` ranks as seen from ``rank``, with no process
    group: a pure function. ``ranks``: the global ranks that form the grid
    (default all of them, in order; an explicit smaller grid takes the
    first data * model). Raises when the grid needs more ranks than
    there are."""
    shape, data_axes, model_axes = _grid(n, data, model, ranks)
    for i, row in enumerate(model_axes):
        if rank in row:
            j = row.index(rank)
            return Mesh(shape, {"data": i, "model": j},
                        {"data": data_axes[j], "model": row},
                        {a: None for a in AXES})
    return Mesh(shape, None, {a: () for a in AXES}, {a: None for a in AXES})


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ``data x model`` grid of this process group's ranks (all on
    ``data`` by default), with a process group for each axis. Every rank
    of the world must call it, in the same order, as each group's creation
    is collective; a rank the grid leaves out gets ``coords`` None."""
    rank, n = world()
    mesh = mesh_grid(n, rank, data, model, ranks)
    if not dist.is_initialized():
        return mesh
    shape, data_axes, model_axes = _grid(n, data, model, ranks)
    groups = {}
    for axis, axes in (("data", data_axes), ("model", model_axes)):
        for members in axes:
            g = dist.new_group(list(members))
            if members == mesh.ranks[axis]:
                groups[axis] = g
    return Mesh(mesh.shape, mesh.coords, mesh.ranks,
                {a: groups.get(a) for a in AXES})


def host_device_count() -> int:
    """Devices of the process group: one a rank."""
    return world()[1]


def _conv_spec(shape, model_axis_size: int) -> tuple:
    """Partition rule for a conv kernel (K, Cin, Cout): shard Cout over
    'model' when it divides evenly and is at least twice the model size;
    otherwise replicate."""
    if len(shape) == 3 and shape[-1] % model_axis_size == 0 and \
            shape[-1] >= 2 * model_axis_size:
        return (None, None, "model")
    return ()


def param_partition_specs(params, mesh: Mesh):
    """A spec for every leaf of a parameter tree: conv and deconv kernels
    shard their output channels over 'model', everything else (biases,
    layer-norm scales, the embedding) is replicated. With a model axis of
    1 every leaf is replicated."""
    if isinstance(params, dict):
        return {k: param_partition_specs(v, mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [param_partition_specs(v, mesh) for v in params]
    return _conv_spec(tuple(params.shape), mesh.shape["model"])


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of a host batch (numpy arrays or
    tensors, the same on every rank), split over the data axis. The batch
    must divide by it."""
    d, i = mesh.shape["data"], mesh.coords["data"]
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % d:
            raise ValueError(f"batch of {B} rows does not divide over a "
                             f"data axis of {d}")
        out[k] = v[i * (B // d): (i + 1) * (B // d)]
    return out


def prefetch_to_device(batches, device, mesh: Optional[Mesh] = None):
    """Yield each numpy batch (this rank's rows of it under ``mesh``) as
    tensors on ``device``. On a card the copy of batch k+1 (from pinned
    memory, on a side stream) is issued before batch k is handed out, so
    it overlaps step k."""
    if mesh is not None:
        batches = (shard_batch(b, mesh) for b in batches)
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield {k: torch.from_numpy(v) for k, v in b.items()}
        return
    side = torch.cuda.Stream(device)

    def put(b):
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(v).pin_memory().to(device,
                                                          non_blocking=True)
                   for k, v in b.items()}
        done = torch.cuda.Event()
        done.record(side)
        return out, done

    def hand_out(item):
        cur, done = item
        main = torch.cuda.current_stream(device)
        main.wait_event(done)
        for t in cur.values():
            t.record_stream(main)
        return cur

    pending = None
    for b in batches:
        nxt = put(b)
        if pending is not None:
            yield hand_out(pending)
        pending = nxt
    if pending is not None:
        yield hand_out(pending)


def assert_sharded_like(tree, specs, mesh: Mesh, shapes) -> None:
    """Each leaf of ``tree`` (this rank's tensors) must have the local
    shape its spec gives the global shape in ``shapes`` (a tree of the
    same structure, of shapes or tensors): every dimension a spec names an
    axis for divided by that axis' size. Raises AssertionError naming the
    leaf."""
    leaves = _leaves_with_path(tree)
    spec_leaves = _leaves_with_path(specs, is_leaf=lambda x: isinstance(
        x, tuple) and all(a is None or isinstance(a, str) for a in x))
    shape_leaves = [s for _, s in _leaves_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple) or hasattr(x,
                                                                  "shape"))]
    assert len(leaves) == len(spec_leaves) == len(shape_leaves)
    for (path, leaf), (_, spec), full in zip(leaves, spec_leaves,
                                             shape_leaves):
        full = tuple(getattr(full, "shape", full))
        want = list(full)
        for dim, axis in enumerate(spec):
            if axis is not None:
                want[dim] = full[dim] // mesh.shape[axis]
        if tuple(leaf.shape) != tuple(want):
            raise AssertionError(
                f"sharding mismatch at {path}: local shape "
                f"{tuple(leaf.shape)}, want {tuple(want)} for spec {spec} "
                f"of {full} on {mesh.shape}")


def _leaves_with_path(tree, path="", is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], f"{path}[{k!r}]",
                                           is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_path(v, f"{path}[{i}]", is_leaf)]
    return [(path, tree)]

