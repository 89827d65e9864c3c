"""Kernel K4's work in an SSRN training step, counted from shapes: each HC
block's forward and backward, at the chip's peaks (``work.PEAK_FLOPS``,
dense bf16, and ``work.PEAK_BYTES``).

An HC block of C channels, K taps, over B rows of T frames:

* FLOPs: the forward's tap product 2 B T (K C) (2 C); the backward's two
  products, dx's and dW's, twice that;
* bytes, each input read once and each output written once, float32: the
  forward reads x (B T C), W (K C 2C), the bias (2C) and the two layer
  norms' gains and shifts (4C) and writes y (B T C); the backward reads the
  same and dy (B T C) and writes dx, dW, the bias's and the norms'
  gradients.

A launch's least time is the larger of its FLOPs over the peak and its
bytes over the bandwidth; the step's is the sum over its launches, which
no implementation can beat, so a share of it cannot pass 100 %."""
from __future__ import annotations

from ..reference import dctts as R
from . import work


def hc_blocks(cfg: dict, T: int) -> list:
    """(K, C, frames) of each HC block of SSRN on T input frames."""
    out, ch = [], cfg["n_mels"]
    for b in R.ssrn(cfg):
        if b.kind == "HC":
            out.append((b.size, ch, T))
        else:
            ch = b.out or ch
            T *= 2 if b.kind == "D" else 1
    return out


def hc_work(B: int, T: int, K: int, C: int) -> dict:
    """{"fwd": (FLOPs, bytes), "bwd": (FLOPs, bytes)} of one HC block."""
    flops = 2 * B * T * (K * C) * (2 * C)
    act, params = 4 * B * T * C, 4 * (K * C * 2 * C + 6 * C)
    return {"fwd": (flops, 2 * act + params),
            "bwd": (2 * flops, 3 * act + 2 * params)}


def least_seconds(cfg: dict, B: int, T: int) -> float:
    """K4's least time in a step of B rows of T mel frames."""
    return sum(work.least_seconds(*w)
               for K, C, t in hc_blocks(cfg, T)
               for w in hc_work(B, t, K, C).values())
