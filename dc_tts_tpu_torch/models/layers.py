"""Functional NN primitives, the port of ``dc_tts_tpu/models/layers.py``.

Same contract and weight layouts as the JAX package: parameters are plain
nested dicts of tensors, modules are functions of (params, inputs), and
every conv is shift + concat + ONE matmul over (B*T, K*C_in), so the batch
path and the one-frame decode step share one contraction layout.

  conv:    w (K, C_in, C_out)
  deconv:  w (K, C_in, C_out), see ``conv1d_transpose``

Numerics are float32; the entry points turn TF32 off (``device.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers


def _truncated_normal(shape, std: float, gen: torch.Generator,
                      device) -> torch.Tensor:
    """Normal truncated to +-2 standard deviations, scaled by ``std``."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device)


# stddev of a unit normal truncated to [-2, 2]; jax's variance_scaling
# divides by it so the truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(shape, fan_in: int, gen, device) -> torch.Tensor:
    """He truncated-normal init, as jax's variance_scaling(2.0, "fan_in",
    "truncated_normal"): for (K, Cin, Cout) convs fan_in = K*Cin."""
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return _truncated_normal(shape, std, gen, device)


# ---------------------------------------------------------------------------
# embedding


def init_embedding(gen, vocab_size: int, num_units: int, device="cpu"):
    return {"table": 0.1 * _truncated_normal((vocab_size, num_units), 1.0,
                                             gen, device)}


def embedding_lookup(params, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, N) int -> (B, N, E). Row 0 (PAD) reads as zeros."""
    table = params["table"]
    table = torch.cat([torch.zeros_like(table[:1]), table[1:]], dim=0)
    return table[ids.long()]


# ---------------------------------------------------------------------------
# layer norm


def init_layer_norm(num_units: int, device="cpu"):
    return {"gamma": torch.ones(num_units, device=device),
            "beta": torch.zeros(num_units, device=device)}


def layer_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize over the last axis with the biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["gamma"] \
        + params["beta"]


# ---------------------------------------------------------------------------
# dilated conv1d as shift + matmul


def init_conv(gen, in_ch: int, out_ch: int, size: int, device="cpu"):
    return {"w": _variance_scaling((size, in_ch, out_ch), size * in_ch, gen,
                                   device),
            "b": torch.zeros(out_ch, device=device)}


def _gather_taps(x: torch.Tensor, size: int, rate: int,
                 causal: bool) -> torch.Tensor:
    """x (B, T, C) -> (B, T, size*C): concat of the ``size`` dilated
    time-shifts, tap 0 the oldest (causal) or SAME-centred (non-causal)."""
    if size == 1:
        return x
    total = (size - 1) * rate
    left = total if causal else total // 2
    xp = F.pad(x, (0, 0, left, total - left))
    T = x.shape[1]
    return torch.cat([xp[:, k * rate: k * rate + T] for k in range(size)],
                     dim=-1)


def conv1d(params, x: torch.Tensor, *, size: int = 1, rate: int = 1,
           causal: bool = False) -> torch.Tensor:
    """Dilated 1-D convolution as one matmul. x (B,T,Cin) -> (B,T,Cout)."""
    w = params["w"]
    K, cin, cout = w.shape
    assert K == size
    taps = _gather_taps(x, size, rate, causal)
    return taps @ w.reshape(K * cin, cout) + params["b"]


def conv1d_step(params, frames: torch.Tensor) -> torch.Tensor:
    """One causal conv frame. frames (B, K, Cin), oldest first -> (B, Cout);
    equal to column t of ``conv1d(..., causal=True)``."""
    w = params["w"]
    K, cin, cout = w.shape
    return frames.reshape(frames.shape[0], K * cin) @ w.reshape(K * cin, cout) \
        + params["b"]


# ---------------------------------------------------------------------------
# dropout (inverted)


def dropout(x: torch.Tensor, rate: float, gen, train: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1/(1 - rate). ``gen`` is a ``torch.Generator`` on x's device;
    without it, at rate 0 or outside training, x is returned unchanged. The
    masks are not JAX's bits (the two generators differ)."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# ---------------------------------------------------------------------------
# transposed conv1d, stride 2, SAME


def init_deconv(gen, in_ch: int, out_ch: int, size: int = 3, device="cpu"):
    return init_conv(gen, in_ch, out_ch, size, device)


def conv1d_transpose(params, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, Cin) -> (B, 2T, Cout): stride-2, kernel-3, SAME deconv,
        y[2t] = x[t] @ w[0] + x[t-1] @ w[2],   y[2t+1] = x[t] @ w[1]."""
    w = params["w"]
    B, T, _ = x.shape
    cout = w.shape[-1]
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    even = x @ w[0] + x_prev @ w[2] + params["b"]
    odd = x @ w[1] + params["b"]
    return torch.stack([even, odd], dim=2).reshape(B, 2 * T, cout)
