"""Kernels X1-X4: the forward-rDFT prototypes of ``scripts/ct_kernel_exp.py``
(``full_fwd``, ``fact_fwd_tiled``, ``fact_fwd``, ``ablate_fwd``), the
question that led the JAX package to K2: how close does a factored DFT on
the matrix units come to an FFT?

The functions, on frames x (F, 2048) float32, with F = ``x.shape[0]``:
  X1 ``full_fwd``: Xr, Xi (F, 1025) = x @ CF, x @ SF, the dense rDFT.
  X3 ``fact_fwd``: the 16 x 128 Cooley-Tukey split, n = 128*n1 + n2 and
     k = k1 + 16*k2 (``unscramble`` maps its (16, F, 128) layout to (F,
     2048)): stage T reads x[f, n1, n2] as (n1, f, n2); A the 16-point DFT
     over n1; W the twiddles W_2048^(n2*k1); C the 128-point DFT over n2.
     ``transpose_mode`` "swap" or "stack" are two TPU spellings of stage T:
     one function.
  X2 ``fact_fwd_tiled``: the same over tiles of tf frames (F % tf == 0).
  X4 ``ablate_fwd``: X2 with each of the stages T, A, W, C on or off, for a
     timing ablation; it covers the first (F // tf) * tf frames.
Precision ("bf16" below; the script's ``_dot`` rounds its LEFT operand
only, and the product is float32 whatever the right one holds):
  * X1: x rounded to bf16 times bf16 CF, SF, float32 sums.
  * Trap 1, stage A is not bf16: its left operand is the bf16 constant and x
    stays float32, so stage A is float32 x times bf16-rounded C16, S16.
    Stage C rounds z to bf16 (times bf16 C128, S128). The twiddles Tc, Ts
    are float32 in every mode.
  * Trap 2, stages off (X4): without A, gr = gi = x; without W, z = g;
    without C, the output is z in float32, unrounded; without T, the tile's
    (tf, 2048) memory is reinterpreted as (16, tf, 128) with no transpose
    ("wrong math, same shapes"), exactly as the script's reshape.
  * Trap 3, F % tf: at the script's F = 840 and tf = 512, X2 raises (the
    script asserts) and X4 covers frames 0..511 only; the port leaves rows
    512..839 zero (the TPU leaves them unwritten).

What bounds them on the H100 (3.35 TB/s; 67 TFLOP/s float32, 989 dense
bf16, each stage at its own peak): X1 its 2*F*2048*2050 operations (7.05
GFLOP at F = 840: 105 us float32, 7.1 us bf16); the factored form 2.24
MFLOP a frame, 3.7x fewer, so in bf16 the bytes bound it (x read once, all
2048 bins of Xr and Xi written once, twice rfft's 1025: 6.2 us at F = 840
against rfft's 4.1) and in float32 the operations (28 us). The design
(csrc/ct_fwd.cu):
  * X1 is one GEMM, N = 2*1025 with CF and SF interleaved as columns (one
    thread's accumulator pair is one bin): bf16, K3's tensor-core block
    (csrc/bf16_gemm.cuh) whose loader rounds x to bf16, each 32-deep
    k-tile promoted to a float32 register sum (a 2048-deep tensor-core sum
    truncates); float32, a SIMT SGEMM (FFMA, no TF32) whose sums are
    promoted every 64 products (an in-order 2048-deep sum read 1.73e-6 of
    max|FFT| from float64 on the card, near the 2e-6 gate).
  * X2-X4 are one kernel: a block keeps C128, S128 in shared memory and
    walks over groups of 4 frames (8 KB each); stages T, A, W in float32
    FFMA, one thread per (frame, n2), into shared z; stage C is the
    group's 64 x 128 x 128 products (bf16 ``mma.sync`` or FFMA); each (k1,
    f) row of 128 k2 is written contiguous. The stage bits are template
    arguments: a stage that is off costs no instruction.

Every wrapper launches its kernel for CUDA tensors (and raises on what it
cannot take) and runs its plain version for CPU tensors only; each counts
its launches in ``.launches`` (a CUDA graph's replays do not count).
"""
from __future__ import annotations

import numpy as np
import torch

from .gl import _check, _device

N_FFT, N1, N2 = 2048, 16, 128
NF = N_FFT // 2 + 1
# scripts/ct_kernel_exp.py:ablation_main's stage sets, in its order
STAGE_SETS = ("", "T", "TA", "TAW", "TAWC", "C", "AC", "A")
_BITS = {"T": 1, "A": 2, "W": 4, "C": 8}
_NPAD = -(-2 * NF // 128) * 128     # X1's interleaved columns, padded


def consts(bf16: bool, device="cpu") -> dict:
    """The script's ``consts``: computed in float64, then C16, S16, C128,
    S128, CF, SF rounded to bfloat16 (bf16) or float32; Tc, Ts (16, 1, 128)
    float32 in both modes. Also "CS", X1's kernel layout of CF and SF: bf16
    (npad, 2048) with rows 2k, 2k+1 = CF[:, k], SF[:, k], or float32 (2048,
    npad) with those columns, npad = 2176, zero-padded."""
    n1, n2 = np.arange(N1), np.arange(N2)
    ang16 = 2 * np.pi * np.outer(n1, n1) / N1
    angT = 2 * np.pi * np.outer(n1, n2) / N_FFT       # (k1, n2)
    ang128 = 2 * np.pi * np.outer(n2, n2) / N2
    angF = 2 * np.pi * np.outer(np.arange(N_FFT), np.arange(NF)) / N_FFT
    out = dict(C16=np.cos(ang16), S16=-np.sin(ang16),
               Tc=np.cos(angT)[:, None, :], Ts=-np.sin(angT)[:, None, :],
               C128=np.cos(ang128), S128=-np.sin(ang128),
               CF=np.cos(angF), SF=-np.sin(angF))
    dt = torch.bfloat16 if bf16 else torch.float32
    m = {k: torch.from_numpy(v).to(torch.float32 if k in ("Tc", "Ts") else dt)
         for k, v in out.items()}
    cs = torch.zeros(N_FFT, _NPAD, dtype=dt)
    cs[:, 0: 2 * NF: 2], cs[:, 1: 2 * NF: 2] = m["CF"], m["SF"]
    m["CS"] = cs.T.contiguous() if bf16 else cs
    return {k: v.to(device) for k, v in m.items()}


def unscramble(y: torch.Tensor) -> torch.Tensor:
    """(k1, f, k2) -> (f, k) with k = k1 + 16*k2, all 2048 bins."""
    return y.permute(1, 2, 0).reshape(y.shape[1], N_FFT)


# ---------------------------------------------------------------------------
# plain versions


def _dot(a, b, bf16: bool):
    """The script's ``_dot``: with bf16 only ``a`` is rounded to bfloat16;
    products and sums are float32 (bf16 x bf16 products are exact there)."""
    if bf16:
        a = a.to(torch.bfloat16)
    return a.float() @ b.float()


def full_fwd_plain(x, m, bf16: bool):
    """X1's function: (Xr, Xi), each (F, 1025) float32."""
    return _dot(x, m["CF"], bf16), _dot(x, m["SF"], bf16)


def _stages_ok(stages: str) -> str:
    if not isinstance(stages, str) or set(stages) - set(_BITS):
        raise ValueError(f"stages: a string of T, A, W, C, got {stages!r}")
    return stages


def ablate_fwd_plain(x, m, bf16: bool, stages: str, tf: int = 512):
    """X4's function (``_ablate_kernel`` on each of the F // tf tiles): (Xr,
    Xi), each (16, F, 128) float32, rows past the last whole tile zero. X2
    and X3 are its stage set "TAWC" (X3 with tf = F)."""
    _stages_ok(stages)
    F = x.shape[0]
    nT = F // tf
    Fc = nT * tf
    x3 = x[:Fc].reshape(nT, tf, N1, N2)
    if "T" in stages:
        xT = x3.transpose(1, 2)
    else:                       # the script's reshape: wrong math, same shapes
        xT = x3.reshape(nT, N1, tf, N2)
    x2 = xT.reshape(nT, N1, tf * N2)
    if "A" in stages:           # trap 1: float32 x, bf16-rounded constants
        gr = _dot(m["C16"], x2, bf16).reshape(nT, N1, tf, N2)
        gi = _dot(m["S16"], x2, bf16).reshape(nT, N1, tf, N2)
    else:
        gr = gi = x2.reshape(nT, N1, tf, N2)
    if "W" in stages:
        tc, ts = m["Tc"], m["Ts"]
        zr, zi = gr * tc - gi * ts, gr * ts + gi * tc
    else:
        zr, zi = gr, gi
    zr, zi = zr.reshape(nT, N1 * tf, N2), zi.reshape(nT, N1 * tf, N2)
    if "C" in stages:
        c128, s128 = m["C128"], m["S128"]
        yr = _dot(zr, c128, bf16) - _dot(zi, s128, bf16)
        yi = _dot(zr, s128, bf16) + _dot(zi, c128, bf16)
    else:                       # trap 2: z itself, float32, unrounded
        yr, yi = zr, zi
    outs = []
    for y in (yr, yi):
        o = x.new_zeros(N1, F, N2)
        o[:, :Fc] = y.reshape(nT, N1, tf, N2).transpose(0, 1).reshape(
            N1, Fc, N2)
        outs.append(o)
    return tuple(outs)


def fact_fwd_plain(x, m, bf16: bool):
    """X3's function: (Xr, Xi), each (16, F, 128) float32."""
    return ablate_fwd_plain(x, m, bf16, "TAWC", max(x.shape[0], 1))


def fact_fwd_tiled_plain(x, m, bf16: bool, tf: int = 512):
    """X2's function: X3's, over tiles of tf frames."""
    _tiles_ok(x.shape[0], tf)
    return ablate_fwd_plain(x, m, bf16, "TAWC", tf)


# ---------------------------------------------------------------------------
# wrappers


def _tiles_ok(F: int, tf: int) -> None:
    if tf < 1 or F % tf:
        raise ValueError(f"fact_fwd_tiled: F = {F} is not a multiple of tf = "
                         f"{tf} (scripts/ct_kernel_exp.py:133 asserts it)")


def _frames(fn: str, x: torch.Tensor) -> int:
    if x.dim() != 2:
        raise ValueError(f"{fn}: x must be (F, {N_FFT}), got {tuple(x.shape)}")
    _check(f"{fn} x", x, (x.shape[0], N_FFT), torch.float32, x.device)
    return x.shape[0]


def full_fwd(x, m, bf16: bool):
    """Kernel X1: frames x (F, 2048) float32 and ``consts(bf16)`` on the same
    device -> (Xr, Xi), each (F, 1025) float32."""
    if not _device("full_fwd", x):
        return full_fwd_plain(x, m, bf16)
    from ._build import check, load_library
    F, dev = _frames("full_fwd", x), x.device
    if bf16:
        _check("full_fwd CS", m["CS"], (_NPAD, N_FFT), torch.bfloat16, dev)
    else:
        _check("full_fwd CS", m["CS"], (N_FFT, _NPAD), torch.float32, dev)
    xr = torch.empty(F, NF, device=dev)
    xi = torch.empty_like(xr)
    code = load_library().dctts_ct_full(
        x.data_ptr(), m["CS"].data_ptr(), xr.data_ptr(), xi.data_ptr(), F,
        int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    check(code, "forward rDFT kernel X1")
    full_fwd.launches += 1
    return xr, xi


def _fact(fn: str, x, m, bf16: bool, tf: int, stages: str):
    """(Xr, Xi, launched): the factored kernel over the first (F // tf) *
    tf frames, rows past them zeroed here; no launch if no tile is whole."""
    from ._build import check, load_library
    F, dev = _frames(fn, x), x.device
    dt = torch.bfloat16 if bf16 else torch.float32
    for k, shape, t in (("C16", (N1, N1), dt), ("S16", (N1, N1), dt),
                        ("Tc", (N1, 1, N2), torch.float32),
                        ("Ts", (N1, 1, N2), torch.float32),
                        ("C128", (N2, N2), dt), ("S128", (N2, N2), dt)):
        _check(f"{fn} {k}", m[k], shape, t, dev)
    Fc = F // tf * tf
    xr = torch.empty(N1, F, N2, device=dev)
    xi = torch.empty_like(xr)
    if Fc < F:
        xr[:, Fc:], xi[:, Fc:] = 0.0, 0.0
    if Fc == 0:
        return xr, xi, False
    bits = sum(_BITS[s] for s in set(stages))
    code = load_library().dctts_ct_fact(
        x.data_ptr(), *(m[k].data_ptr() for k in ("C16", "S16", "Tc", "Ts",
                                                  "C128", "S128")),
        xr.data_ptr(), xi.data_ptr(), F, Fc, tf, bits, int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    check(code, f"factored DFT kernel ({fn})")
    return xr, xi, True


def fact_fwd(x, m, bf16: bool, transpose_mode: str = "swap"):
    """Kernel X3: frames x (F, 2048) float32 -> (Xr, Xi), each (16, F, 128)
    float32 in the (k1, f, k2) layout. ``transpose_mode`` "swap" or
    "stack": one function."""
    if transpose_mode not in ("swap", "stack"):
        raise ValueError(f"transpose_mode: 'swap' or 'stack', got "
                         f"{transpose_mode!r}")
    if not _device("fact_fwd", x):
        return fact_fwd_plain(x, m, bf16)
    xr, xi, launched = _fact("fact_fwd", x, m, bf16, max(x.shape[0], 1),
                             "TAWC")
    fact_fwd.launches += launched
    return xr, xi


def fact_fwd_tiled(x, m, bf16: bool, tf: int = 512):
    """Kernel X2: X3 over tiles of tf frames; raises ``ValueError`` unless
    tf divides F (the script asserts it)."""
    _tiles_ok(x.shape[0], tf)
    if not _device("fact_fwd_tiled", x):
        return fact_fwd_tiled_plain(x, m, bf16, tf)
    xr, xi, launched = _fact("fact_fwd_tiled", x, m, bf16, tf, "TAWC")
    fact_fwd_tiled.launches += launched
    return xr, xi


def ablate_fwd(x, m, bf16: bool, stages: str, tf: int = 512):
    """Kernel X4: X2 with only ``stages`` (a string of T, A, W, C) on; rows
    past the last whole tile of tf frames are zero (no launch if there is no
    whole tile)."""
    _stages_ok(stages)
    if tf < 1:
        raise ValueError(f"ablate_fwd: tf = {tf}")
    if not _device("ablate_fwd", x):
        return ablate_fwd_plain(x, m, bf16, stages, tf)
    xr, xi, launched = _fact("ablate_fwd", x, m, bf16, tf, stages)
    ablate_fwd.launches += launched
    return xr, xi


full_fwd.launches = fact_fwd.launches = 0
fact_fwd_tiled.launches = ablate_fwd.launches = 0
