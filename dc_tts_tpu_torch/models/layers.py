"""Functional NN primitives, the port of ``dc_tts_tpu/models/layers.py``.

Same contract and weight layouts as the JAX package: parameters are plain
nested dicts of tensors, modules are functions of (params, inputs), and
every conv is shift + concat + ONE matmul over (B*T, K*C_in), so the batch
path and the one-frame decode step share one contraction layout.

  conv:    w (K, C_in, C_out)
  deconv:  w (K, C_in, C_out), see ``conv1d_transpose``

Numerics are float32 by default; the entry points turn TF32 off
(``device.py``). The convs take the JAX package's operand modes
(``dtype``): None is true float32; ``"high"`` is the explicit 3-pass bf16
hi/lo split xh@Wh + xh@Wl + xl@Wh (what ``Precision.HIGH`` is on the TPU,
as ``dsp/stft.py``'s ``dft_3x``); ``torch.bfloat16`` rounds both operands
to bf16 (nearest even) and keeps products and sums in float32. On the card
these products of bf16 values run on the tensor cores through
``torch.mm(..., out_dtype=torch.float32)``; on the CPU as float32 products
of the exact upcasts. ``torch.matmul`` of two bf16 tensors would round the
result to bf16, so it is not used. ``out_dtype`` narrows only the stored
result (the ``bfloat16_full`` training mode). Gradients follow JAX's
transpose rules: ``"high"`` takes the same 3-pass products; in bf16 the
cotangent meets the other rounded operand in float32 and the product is
rounded to bf16, the cotangent of JAX's ``astype(bfloat16)``.

Tensor parallelism (``group``, the model axis' process group,
``parallel/tp.py``): a conv whose kernel holds a slice of its output
channels computes that slice, gathers it over the group and adds the whole
bias; its input's gradient is the sum over the group of every rank's
partial product, taken in float32 before any bf16 rounding of it, so the
gradients are one rank's up to float32 summation order. A whole kernel
runs as without a group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dsp.stft import split_bf16
from ..parallel.distributed import all_reduce_sum_
from ..parallel.tp import copy_to_model, gather_from_model, is_sharded

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
    """Normalize over the last axis with the biased variance. The
    statistics and the normalisation are computed in float32 (or x's wider
    type) and the result is cast back to x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * params["gamma"]
            + params["beta"]).to(x.dtype)


# ---------------------------------------------------------------------------
# matmuls in the reduced operand modes


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, products and sums in float32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _lp_mm(a: torch.Tensor, b: torch.Tensor, mode) -> torch.Tensor:
    """a @ b (2-D) in a reduced operand mode, float32 out."""
    if mode == "high":
        ah, al = split_bf16(a.float())
        bh, bl = split_bf16(b.float())
        return _bf16_mm(ah, bh) + _bf16_mm(ah, bl) + _bf16_mm(al, bh)
    return _bf16_mm(a.to(torch.bfloat16), b.to(torch.bfloat16))


class _LowPrecisionMatmul(torch.autograd.Function):
    """a @ b (2-D) in a reduced operand mode, with JAX's gradients (module
    docstring)."""

    @staticmethod
    def forward(ctx, a, b, mode, group):
        ctx.save_for_backward(a, b)
        ctx.mode, ctx.group = mode, group
        return _lp_mm(a, b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.mode == "high":
            if ctx.needs_input_grad[0]:
                da = _lp_mm(g, b.T, "high")
                all_reduce_sum_([da], ctx.group)
            if ctx.needs_input_grad[1]:
                db = _lp_mm(a.T, g, "high")
        else:
            if ctx.needs_input_grad[0]:
                da = g @ _round_bf16(b).T
                all_reduce_sum_([da], ctx.group)
                da = da.to(torch.bfloat16)
            if ctx.needs_input_grad[1]:
                db = (_round_bf16(a).T @ g).to(torch.bfloat16)
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None, None)


def matmul(x: torch.Tensor, w: torch.Tensor, dtype=None,
           group=None) -> torch.Tensor:
    """x (..., Q) @ w (Q, N) in operand mode ``dtype`` (module docstring):
    None in x's precision, ``"high"`` or ``torch.bfloat16`` float32 out.
    ``group``: x's gradient summed over this model group (w a slice of
    the columns)."""
    if dtype is None:
        return copy_to_model(x, group) @ w
    if dtype != "high" and dtype is not torch.bfloat16:
        raise ValueError(f"unknown operand mode {dtype!r}")
    y = _LowPrecisionMatmul.apply(x.reshape(-1, x.shape[-1]), w, dtype,
                                  group)
    return y.reshape(*x.shape[:-1], w.shape[-1])


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
           causal: bool = False, dtype=None, out_dtype=None,
           group=None) -> torch.Tensor:
    """Dilated 1-D convolution as one matmul. x (B,T,Cin) -> (B,T,Cout).
    ``dtype``: the operand mode (module docstring); ``out_dtype`` narrows
    the stored result, to which the bias is added in that dtype. ``group``:
    the model group, for a kernel that holds a slice of the output channels
    (the slice is gathered in the stored dtype)."""
    w = params["w"]
    K, cin, cout = w.shape
    assert K == size
    group = group if is_sharded(params) else None
    taps = _gather_taps(x, size, rate, causal)
    y = matmul(taps, w.reshape(K * cin, cout), dtype, group)
    if out_dtype is not None:
        y = y.to(out_dtype)
    y = gather_from_model(y, group)
    return y + params["b"].to(y.dtype)


def conv1d_step(params, frames: torch.Tensor) -> torch.Tensor:
    """One causal conv frame. frames (B, K, Cin), oldest first -> (B, Cout);
    equal to column t of ``conv1d(..., causal=True)``."""
    w = params["w"]
    K, cin, cout = w.shape
    return frames.reshape(frames.shape[0], K * cin) @ w.reshape(K * cin, cout) \
        + params["b"]


# ---------------------------------------------------------------------------
# classic highway net (in the original modules but called by none of its
# networks; kept as part of the primitive set)


def init_highway(gen, num_units: int, device="cpu"):
    """Glorot-uniform kernels (TF dense's default) and a -1 gate bias, so
    the gates start mostly closed."""
    lim = math.sqrt(6.0 / (2 * num_units))

    def uniform():
        return torch.empty(num_units, num_units).uniform_(
            -lim, lim, generator=gen).to(device)

    return {"h": {"w": uniform(), "b": torch.zeros(num_units, device=device)},
            "t": {"w": uniform(),
                  "b": torch.full((num_units,), -1.0, device=device)}}


def highway(params, x: torch.Tensor) -> torch.Tensor:
    """relu(x W_h + b_h) * T + x * (1 - T), T = sigmoid(x W_t + b_t)."""
    H = torch.relu(x @ params["h"]["w"] + params["h"]["b"])
    T = torch.sigmoid(x @ params["t"]["w"] + params["t"]["b"])
    return H * T + x * (1.0 - T)


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


def conv1d_transpose(params, x: torch.Tensor, dtype=None, out_dtype=None,
                     group=None) -> torch.Tensor:
    """x (B, T, Cin) -> (B, 2T, Cout): stride-2, kernel-3, SAME deconv,
        y[2t] = x[t] @ w[0] + x[t-1] @ w[2],   y[2t+1] = x[t] @ w[1].
    ``dtype`` and ``group`` as ``conv1d``; the two even-phase products and
    the bias are summed in float32 and only then narrowed to ``out_dtype``
    (so a slice is gathered in float32)."""
    w = params["w"]
    B, T, _ = x.shape
    group = group if is_sharded(params) else None
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    even = matmul(x, w[0], dtype, group) + matmul(x_prev, w[2], dtype, group)
    odd = matmul(x, w[1], dtype, group)
    y = gather_from_model(
        torch.stack([even, odd], dim=2).reshape(B, 2 * T, -1), group)
    y = y + params["b"]
    return y if out_dtype is None else y.to(out_dtype)
