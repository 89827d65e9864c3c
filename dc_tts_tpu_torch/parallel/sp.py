"""Sequence parallelism: the time axis of a conv stack sharded over the
ranks of a mesh axis, with halo exchange; the port of
``dc_tts_tpu/parallel/sp.py``.

SSRN's blocks have small receptive fields (kernel 3, dilation <= 3), so
each rank computes its own frames after fetching ``halo = (K-1)*rate/2``
boundary frames from each neighbour (point to point, all posted at once).
Edge ranks receive nothing and pad with zeros, which is the unsharded op's
SAME zero padding. The stride-2 transposed conv needs one left-halo frame
(y[2t] = x[t] w0 + x[t-1] w2). Blocks run their convs in "valid" mode on
the halo-extended input; layer norms, gates and activations are
positionwise. Every function here takes and returns this rank's slice of
the time axis.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import Config
from ..models import layers as L
from ..models.blocks import C, D, HC, _act
from . import distributed as Dist


def _exchange_halo(x: torch.Tensor, left_n: int, right_n: int, mesh,
                   axis: str = "data") -> torch.Tensor:
    """x (B, T_l, C) extended by left_n trailing frames of the left
    neighbour and right_n leading frames of the right neighbour (zeros
    beyond the edges)."""
    i, n = mesh.coords[axis], mesh.shape[axis]
    peers = mesh.ranks[axis]
    B, _, Ch = x.shape
    left = x.new_zeros(B, left_n, Ch)
    right = x.new_zeros(B, right_n, Ch)
    sends, recvs = [], []
    if left_n and i + 1 < n:
        sends.append((x[:, -left_n:], peers[i + 1]))
    if left_n and i > 0:
        recvs.append((left, peers[i - 1]))
    if right_n and i > 0:
        sends.append((x[:, :right_n], peers[i - 1]))
    if right_n and i + 1 < n:
        recvs.append((right, peers[i + 1]))
    Dist.exchange(sends, recvs, mesh.groups[axis])
    return torch.cat([left, x, right], dim=1)


def _conv_valid(p: dict, x_ext: torch.Tensor, size: int, rate: int,
                t_out: int) -> torch.Tensor:
    """Dilated conv over an already halo-padded input, producing t_out
    frames: the taps concatenated and one matmul, as ``layers.conv1d``."""
    w = p["w"]
    K, cin, cout = w.shape
    taps = x_ext if K == 1 else torch.cat(
        [x_ext[:, k * rate: k * rate + t_out] for k in range(K)], dim=-1)
    return L.matmul(taps, w.reshape(K * cin, cout)) + p["b"]


def _apply_block_sp(p: dict, spec, x: torch.Tensor, mesh, axis: str,
                    ln_eps: float) -> torch.Tensor:
    t_local = x.shape[1]
    if isinstance(spec, D):
        x_prev = _exchange_halo(x, 1, 0, mesh, axis)[:, :t_local]
        w = p["conv"]["w"]
        even = L.matmul(x, w[0]) + L.matmul(x_prev, w[2])
        odd = L.matmul(x, w[1])
        y = torch.stack([even, odd], dim=2).reshape(
            x.shape[0], 2 * t_local, w.shape[-1]) + p["conv"]["b"]
        return _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    total = (spec.size - 1) * spec.rate
    left = total // 2
    x_ext = _exchange_halo(x, left, total - left, mesh, axis) \
        if total else x
    h = _conv_valid(p["conv"], x_ext, spec.size, spec.rate, t_local)
    if isinstance(spec, C):
        return _act(L.layer_norm(p["ln"], h, ln_eps), spec.act)
    if isinstance(spec, HC):
        h1, h2 = torch.chunk(h, 2, dim=-1)
        h1 = torch.sigmoid(L.layer_norm(p["ln1"], h1, ln_eps))
        h2 = L.layer_norm(p["ln2"], h2, ln_eps)
        return h1 * h2 + (1.0 - h1) * x
    raise TypeError(spec)


@torch.no_grad()
def apply_stack_sp(params: Sequence[dict], specs: Sequence,
                   x: torch.Tensor, mesh, *, axis: str = "data",
                   ln_eps: float = 1e-5) -> torch.Tensor:
    """A non-causal stack on this rank's frames x (B, T/n, C) of a time
    axis sharded over ``mesh[axis]`` -> this rank's output frames."""
    for p, spec in zip(params, specs):
        x = _apply_block_sp(p, spec, x, mesh, axis, ln_eps)
    return x


def ssrn_apply_sp(cfg: Config, params, Y_local: torch.Tensor, mesh,
                  axis: str = "data") -> torch.Tensor:
    """Time-sharded SSRN forward: this rank's frames of Y (B, T/r/n,
    n_mels) -> its frames of Z (B, T/n, n_freq), in float32 (the CLI's
    time-shard path runs SSRN at full float32). Equal to ``SSRN.apply``'s
    inference output up to float rounding (tests/test_torch_sp.py)."""
    from ..models.ssrn import ssrn_specs
    return torch.sigmoid(apply_stack_sp(params["stack"], ssrn_specs(cfg),
                                        Y_local, mesh, axis=axis,
                                        ln_eps=cfg.ln_eps))
