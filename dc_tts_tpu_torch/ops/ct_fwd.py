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

What bounds them on the H100 (3.35 TB/s; 67 TFLOP/s float32, 495 TF32, 989
dense bf16, each stage at its own peak): X1 its 2*F*2048*2050 operations
(7.05 GFLOP at F = 840: 7.1 us bf16; float32 105 us on the FMA units, 42.7
us as three TF32 passes); the factored form 2.24 MFLOP a frame, 3.7x fewer,
so in bf16 the bytes bound it (x read once, all 2048 bins of Xr and Xi
written once, twice rfft's 1025: 6.2 us at F = 840 against rfft's 4.1) and
in float32 the operations (28 us on the FMA units). The design
(csrc/ct_fwd.cu):
  * X1 is one GEMM, N = 2*1025 with CF and SF interleaved as rows of B^T
    (one lane's accumulator pair is one bin), 128 x 128 tiles: 7 x 17 = 119
    tiles at F = 840, one wave on 132 SMs. bf16: x rounded to bf16 once a
    call (not once per N tile), then the pipelined bf16 wgmma core of
    csrc/bf16_wgmma.cuh (K3's and K4's). float32: the three-term TF32 split
    on wgmma (K4's float32 core): x split hi/lo in registers, CS's TF32
    parts split once by ``consts``; the tensor cores' sums promoted to
    float32 register sums every 64 products (an in-order 2048-deep sum read
    1.73e-6 of max|FFT| from float64 on the card, near the 2e-6 gate).
  * X2-X4 are one kernel, warp-specialised and persistent: one thread
    copies each frame (8 KB; without T its 16 rows of 512 bytes) into a
    shared ring by bulk copies whose bytes arrive on mbarriers; consumer
    warpgroups run stages T, A, W in float32 FFMA (one thread an n2 of
    each frame) for groups of 4 frames, 64 (frame, k1) rows, into shared
    z, and stage C on the tensor cores: z (bf16-rounded, or split into TF32
    hi/lo) times the resident constant ``fact_consts``, columns k2 = 0..64
    of C128 and S128, as four products P = zr C', Q = zi S', R = zr S', U =
    zi C' (N = 72), then Xr[k] = P - Q, Xr[128 - k] = P + Q, Xi[k] = R + U,
    Xi[128 - k] = U - R (C128[:, 128 - k] = C128[:, k], S128[:, 128 - k] =
    -S128[:, k]). The full [[C, S], [-S, C]] would need 512 KB of float32
    TF32 parts (128 KB bf16); the half-width one 144 KB (36 KB), and 44 %
    fewer products. The stage bits are template arguments: a stage that is
    off costs no instruction.

Every wrapper launches its kernel for CUDA tensors (and raises on what it
cannot take) and runs its plain version for CPU tensors only; each counts
its launches as ``x1.launches`` ... ``x4.launches`` (a CUDA graph's
replays do not count).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count
from .gl import _check, _device

N_FFT, N1, N2 = 2048, 16, 128
NF = N_FFT // 2 + 1
# scripts/ct_kernel_exp.py:ablation_main's stage sets, in its order
STAGE_SETS = ("", "T", "TA", "TAW", "TAWC", "C", "AC", "A")
_BITS = {"T": 1, "A": 2, "W": 4, "C": 8}
_NPAD = -(-2 * NF // 128) * 128     # X1's interleaved columns, padded
# stage C's constant: columns k2 = 0..64 of C128, S128 (the rest by
# symmetry), padded to KC_N rows of the kernel's B tiles
KC_COLS, KC_N = N2 // 2 + 1, 72


def consts(bf16: bool, device="cpu") -> dict:
    """The script's ``consts``: computed in float64, then C16, S16, C128,
    S128, CF, SF rounded to bfloat16 (bf16) or float32; Tc, Ts (16, 1, 128)
    float32 in both modes. Also "CS", X1's kernel layout of CF and SF:
    (npad, 2048) with rows 2k, 2k+1 = CF[:, k], SF[:, k], npad = 2176,
    zero-padded; bf16, or in float32 mode (2, npad, 2048), the TF32 hi and
    lo parts of those rows (``tf32_split``)."""
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
    cs = torch.zeros(_NPAD, N_FFT, dtype=dt)
    cs[0: 2 * NF: 2], cs[1: 2 * NF: 2] = m["CF"].T, m["SF"].T
    m["CS"] = cs if bf16 else torch.stack(tf32_split(cs))
    m["KC"] = fact_consts(m["C128"], m["S128"])
    return {k: v.to(device) for k, v in m.items()}


def _swizzle128(tiles: np.ndarray) -> np.ndarray:
    """(..., rows, per) -> the same values in the 128-byte swizzle of a
    K-major shared-memory tile: row n's 16-byte chunk c at chunk c ^ (n %
    8)."""
    *lead, rows, per = tiles.shape
    epc = per // 8                                   # elements a chunk
    out = np.empty_like(tiles)
    n = np.arange(rows)[:, None]
    c = np.arange(8)[None, :]
    src = tiles.reshape(*lead, rows, 8, epc)
    dst = out.reshape(*lead, rows, 8, epc)
    dst[..., n, c ^ (n % 8), :] = src[..., n, c, :]
    return out


def fact_consts(c128: torch.Tensor, s128: torch.Tensor) -> torch.Tensor:
    """The factored kernel's stage-C constant (csrc/ct_fwd.cu FactC), the
    bytes of its shared-memory image: for M in C128, S128 (bf16; float32:
    the TF32 hi and lo parts of each), the K-major B tiles of rows k2 =
    0..KC_N-1 (columns 0..64 of M, zero past 64) over k = n2, in k-tiles of
    128 bytes (64 bf16 or 32 floats) in the 128-byte swizzle. Flat, in the
    matrices' type."""
    bf16 = c128.dtype == torch.bfloat16
    parts = [c128, s128] if bf16 else [*tf32_split(c128), *tf32_split(s128)]
    per = 64 if bf16 else 32
    out = []
    for m in parts:
        bits = m.view(torch.int16 if bf16 else torch.int32).numpy()
        b = np.zeros((N2, KC_N), bits.dtype)         # (n2, k2)
        b[:, :KC_COLS] = bits[:, :KC_COLS]
        tiles = b.T.reshape(KC_N, N2 // per, per).transpose(1, 0, 2)
        out.append(_swizzle128(np.ascontiguousarray(tiles)).reshape(-1))
    flat = torch.from_numpy(np.concatenate(out))
    return flat.view(torch.bfloat16 if bf16 else torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), the three-term split's
    parts (x - hi is exact in float32)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


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
        _check("full_fwd CS", m["CS"], (2, _NPAD, N_FFT), torch.float32, dev)
    xr = torch.empty(F, NF, device=dev)
    xi = torch.empty_like(xr)
    # bf16: x rounded once a call, into this scratch
    xb = torch.empty(F if bf16 else 1, N_FFT, dtype=torch.bfloat16,
                     device=dev)
    code = load_library().dctts_ct_full(
        x.data_ptr(), m["CS"].data_ptr(), xr.data_ptr(), xi.data_ptr(),
        xb.data_ptr(), F, int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    check(code, "forward rDFT kernel X1")
    count("x1.launches")
    return xr, xi


def _fact(fn: str, x, m, bf16: bool, tf: int, stages: str):
    """(Xr, Xi, launched): the factored kernel over the first (F // tf) *
    tf frames, rows past them zeroed here; no launch if no tile is whole."""
    from ._build import check, load_library
    F, dev = _frames(fn, x), x.device
    dt = torch.bfloat16 if bf16 else torch.float32
    kc_len = (2 if bf16 else 4) * KC_N * N2
    for k, shape, t in (("C16", (N1, N1), dt), ("S16", (N1, N1), dt),
                        ("Tc", (N1, 1, N2), torch.float32),
                        ("Ts", (N1, 1, N2), torch.float32),
                        ("KC", (kc_len,), dt)):
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
                                                  "KC")),
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
    count("x3.launches", launched)
    return xr, xi


def fact_fwd_tiled(x, m, bf16: bool, tf: int = 512):
    """Kernel X2: X3 over tiles of tf frames; raises ``ValueError`` unless
    tf divides F (the script asserts it)."""
    _tiles_ok(x.shape[0], tf)
    if not _device("fact_fwd_tiled", x):
        return fact_fwd_tiled_plain(x, m, bf16, tf)
    xr, xi, launched = _fact("fact_fwd_tiled", x, m, bf16, tf, "TAWC")
    count("x2.launches", launched)
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
    count("x4.launches", launched)
    return xr, xi
