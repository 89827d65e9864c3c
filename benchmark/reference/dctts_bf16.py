"""SSRN training with rounded convolution operands: the plain reference of
``compute_dtype="bfloat16"``, beside ``dctts.py`` (whose blocks, losses,
dropout and Adam it reuses) and, as written there, importing nothing of
the measured program.

``compute_dtype="bfloat16"`` states: each convolution's operands, its input
taps and its kernel, are rounded to bfloat16 (nearest even) and the
products and sums stay in float32. Here each operand is rounded where it
enters a product and widened back to the parameters' type (float64 to
judge a run), and everything else (products, sums, layer norms, the gate,
dropout, the losses, clipping and Adam) stays in that type. The rounding is
differentiable in one of two ways, as the configuration states for each
kind of block:

* C and D blocks, as a cast: the cotangent that a rounded operand hands
  back, the result of the product that takes its place, is rounded the
  same way (the transpose of JAX's ``astype(bfloat16)``, which the
  program's convolutions copy). Each tap of a convolution and each input of
  the stride-2 deconvolution is rounded on its own, so that a tap's
  gradient is rounded before the taps are summed back onto their input, as
  the program rounds the gradient of its taps matrix;
* HC blocks, which train through kernel K4 (``use_pallas``), as K4's bf16
  mode states them (the JAX package's ``_make_dot`` / ``_make_dotg``): the
  backward's two products take the conv output's cotangent dh rounded,
  with the rounded taps and kernel, and their results, dW and the conv's
  part of dx, are not rounded.

Where the program rounds otherwise (the differences the comparison's limits
must hold): its products, sums and everything outside them are float32, so
an operand that lies within float32 noise of a tie between two bf16 values
rounds to either, and a few elements of each rounded tensor differ by one
bf16 step; the L1 loss's gradient is the sign of Z - mags, so an element of
Z within that noise of its target takes either sign; the program draws the
same dropout masks (``dctts.step_seed``) but applies them in float32.

``fmt`` names the operand type. ``torch.bfloat16`` is the configuration's.
``torch.float8_e4m3fn`` is the control, the nearest precision below it
(3 mantissa bits against bf16's 7): each rounded tensor is first scaled by
its largest magnitude over e4m3's largest finite value, 448, as float8
training scales a tensor (per tensor, at the time of use), so that nothing
saturates or flushes to zero, and unscaled after the rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dctts as R

_F8_MAX = 448.0          # float8 e4m3 (fn)'s largest finite value


def rounded(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """t rounded to ``fmt`` (nearest even) and widened back to t's type;
    float8 scaled by t's largest magnitude over 448 around the rounding."""
    if fmt == torch.bfloat16:
        return t.to(fmt).to(t.dtype)
    if fmt != torch.float8_e4m3fn:
        raise ValueError(f"no rounding to {fmt}")
    scale = t.abs().amax() / _F8_MAX
    if scale == 0:
        return t
    return (t / scale).to(fmt).to(t.dtype) * scale


class _Round(torch.autograd.Function):
    """``rounded`` forward, and on the cotangent backward."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return rounded(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.fmt), None


class _OperandProduct(torch.autograd.Function):
    """a @ w of the rounded operands, K4's gradients: the cotangent rounded,
    the two products' results not."""

    @staticmethod
    def forward(ctx, a, w, fmt):
        a, w = rounded(a, fmt), rounded(w, fmt)
        ctx.save_for_backward(a, w)
        ctx.fmt = fmt
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = rounded(g, ctx.fmt)
        return g @ w.T, (a.reshape(-1, a.shape[-1]).T
                         @ g.reshape(-1, g.shape[-1])), None


def _cast_product(a, w, fmt):
    return _Round.apply(a, fmt) @ _Round.apply(w, fmt)


def conv1d(x, w, b, size, rate, causal, fmt, product=_cast_product):
    """``dctts.conv1d`` on the rounded taps and tap matrices, each tap's
    product taken by ``product``."""
    total = (size - 1) * rate
    left = total if causal else total // 2
    T = x.shape[1]
    xp = F.pad(x, (0, 0, left, total - left))
    y = b
    for k in range(size):
        y = y + product(xp[:, k * rate: k * rate + T], w[k], fmt)
    return y


def deconv1d(x, w, b, fmt):
    """``dctts.deconv1d`` with each product's operands rounded."""
    B, T, _ = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    even = _cast_product(x, w[0], fmt) + _cast_product(x_prev, w[2], fmt)
    odd = _cast_product(x, w[1], fmt)
    return torch.stack([even, odd], 2).reshape(B, 2 * T, -1) + b


def run_stack(p, name: str, blocks, x, eps, fmt, dropout=None):
    """``dctts.run_stack`` on the rounded convolutions, the HC blocks'
    products with K4's gradients."""
    for i, blk in enumerate(blocks):
        k = f"{name}//{i}"
        w, b = p[k + "//conv//w"], p[k + "//conv//b"]
        product = _OperandProduct.apply if blk.kind == "HC" else \
            _cast_product
        h = deconv1d(x, w, b, fmt) if blk.kind == "D" else \
            conv1d(x, w, b, blk.size, blk.rate, blk.causal, fmt, product)
        x = R._finish(p, k, blk, h, x, eps)
        if dropout is not None:
            x = dropout(x)
    return x


def ssrn_loss(cfg: dict, p, batch: dict, dropout, fmt):
    """``dctts.ssrn_loss`` on the rounded convolutions."""
    logits = run_stack(p, "stack", R.ssrn(cfg), batch["mels"],
                       cfg["ln_eps"], fmt, dropout)
    mags = batch["mags"]
    return torch.mean(torch.abs(torch.sigmoid(logits) - mags)) + \
        R._bd(logits, mags)


class Trainer(R.Trainer):
    """``dctts.Trainer`` of SSRN with its convolutions' operands rounded to
    ``fmt``."""

    def __init__(self, cfg: dict, network: str, params, seed: int,
                 fmt: torch.dtype = torch.bfloat16):
        if network != "ssrn":
            raise ValueError(f"no rounded-operand reference of {network!r}")
        super().__init__(cfg, network, params, seed)
        self.loss_fn = lambda cfg, p, batch, dropout: ssrn_loss(
            cfg, p, batch, dropout, fmt)
