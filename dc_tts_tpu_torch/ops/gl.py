"""Kernel K3: one Griffin-Lim round of the ``dft_pallas`` schedule, the port
of ``dc_tts_tpu/ops/pallas_gl.py:fused_gl_round`` (its Pallas calls
``_k1_call``, body ``_k1_body``, and ``_k2_call``, body ``_k2_body``).

The function (reference semantics: istft -> trim -> reflect-pad -> stft ->
phase normalisation -> |X| imposed again), on spectra padded to fp1 rows:
  K3a: y = overlap-add((Xr @ A + Xi @ B) * win) * 1/sum(w^2), trimmed by
       n_fft/2 at both ends and reflect-padded by n_fft/2 again;
  K3b: E = (frames of y at hop, * win) @ (C + iS), X' = E * mag / max(1e-8,
       |E|); rows >= F of the spectra are read as zero and come out 0.
Every product takes bf16 operands and sums in float32: one pass, or with
``three_pass`` the hi/lo split xh@Mh + xh@Ml + xl@Mh (the head and tail
rounds of the schedule). The constants are bf16 hi/lo splits of the float32
DFT matrices (``gl_fused_consts``).

What bounds it on the H100: the two GEMMs. Rows >= F of the spectrum are
zero and the window is zero outside its win_length samples, so the function
needs 2*(B*F)*win_length*(2*n_freq) operations per GEMM and pass: at B=20,
F=840, win 1102, n_freq 1025, 75.9 GFLOP, 0.077 ms at 989 TFLOP/s of bf16
tensor cores, against 0.05 ms (K3a) and 0.07 ms (K3b) for their inputs and
outputs at 3.35 TB/s. So the design keeps every product on the tensor cores
(csrc/gl.cu), on the pipelined bf16 ``wgmma`` core it shares with K4's bf16
body (csrc/bf16_wgmma.cuh: 128 x 128 block tiles, 64-deep k-tiles, a ring of
shared-memory stages filled by 16-byte ``cp.async`` on ``mbarrier``s,
both operands K-major in shared memory):
  * K3a: a prep pass writes [Xr | Xi]'s B*F rows as aligned bf16 hi (and
    lo) rows, zero-padded to a multiple of 64 (the spectrum's rows of 1025
    floats are not 16-byte aligned, so no 16-byte copy can read them); the
    GEMM, M = B*F frames, K = 2*n_freq padded, N = n_fft, runs only the N
    tiles that meet the window's span (``window_span``: the others are acc
    * 0 = 0 and are written as zeros), and its epilogue windows and writes
    the frames in float32. An overlap-add pass (one thread per sample of the
    reflect-padded signal, shared with K2: csrc/gl_ola.cuh) sums the <= P
    frames over each sample, scales by 1/sum(w^2) and mirrors the n_fft/2
    edges: the trim and reflect-pad the JAX package does between its two
    kernels.
  * K3b: a prep pass gathers frame j from the signal at j*hop over the
    k-tiles of the window's span only, windows it (yp*win in float32, the
    JAX kernel's rounding point) and writes it as bf16 hi (and lo); the
    GEMM, M = B*F, K = the span's k-tiles, N = 2*n_freq, reads C and S
    interleaved as columns, so each accumulator pair is one bin's (Re, Im),
    and the epilogue normalises the phase and multiplies by mag. Rows
    F..f2 of the output are zeroed apart.
Skipping the window's zero tails is exact: those products are exactly 0.
The TPU kernels' padded row tiles and halos exist to fit VMEM: the GEMMs
run over the F frames only, and fp1 is just the public layout's row count.

``fused_gl_round`` (and ``k3a``/``k3b``) launch the kernels for CUDA tensors
and run the plain versions for CPU tensors only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.stft import (_dft_mats, _idft_mats, _ola_window_sq, _overlap_add,
                        hann_window, split_bf16)
from ..dsp.stft import window_span as stft_window_span
from ..utils.profiling import count

# csrc/bf16_wgmma.cuh's block tile (N) and k-tile: the constant matrices
# are padded to these
_BN, _BK = 128, 64


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class GLGeom(NamedTuple):
    """Static geometry of a round, field for field the JAX package's. The
    TPU kernels' tile fields (halo1, tf1, halo2, tf2, seg2) set fp1, the
    public layout's row count; the CUDA kernels read none of them."""
    n_fft: int
    hop: int
    win_length: int
    F: int          # spectrogram frames
    n_freq: int
    P: int          # frames overlapping one hop segment: ceil(n_fft/hop)
    halo1: int      # the TPU kernel 1's left-halo rows
    tf1: int        # the TPU kernel 1's tile frames
    fp1: int        # padded spectrum rows
    halo2: int      # the TPU kernel 2's right-halo rows
    tf2: int        # the TPU kernel 2's tile frames
    f2: int         # padded output rows (== fp1)
    seg2: int       # the TPU kernel 2's padded input segments
    L_sig: int      # istft output samples (after the centre trim)

    @property
    def ly(self) -> int:
        """Samples of the reflect-padded signal between K3a and K3b."""
        return self.L_sig + 2 * (self.n_fft // 2)


def gl_geometry(n_fft: int, hop: int, win_length: int, F: int) -> GLGeom:
    pad = n_fft // 2
    P = -(-n_fft // hop)
    halo1 = _ceil_to(P, 8)
    tf1 = _ceil_to(128, halo1)
    L_sig = n_fft + hop * (F - 1) - 2 * pad
    # K3a must produce every overlap-add position the re-framing reads:
    # [0, pad + L_sig)
    rows_needed = -(-(pad + L_sig) // hop)
    fp1 = _ceil_to(max(F, rows_needed), tf1)
    halo2 = _ceil_to(max(P - 1, 1), 8)
    return GLGeom(n_fft, hop, win_length, F, n_fft // 2 + 1, P, halo1, tf1,
                  fp1, halo2, tf1, fp1, fp1 + halo2, L_sig)


@functools.lru_cache(maxsize=None)
def window_span(g: GLGeom, tile: int) -> tuple[int, int]:
    """[t0, t1): the tiles of ``tile`` samples of an n_fft frame that meet
    the window's nonzero samples (``hann_window(win_length, n_fft)``, the
    constants' "win"). Outside them the window is exactly 0, so K3a's frame
    columns there are acc * 0 = 0 and K3b's operands there are 0: the kernels
    run K3a's N tiles (``_BN``) and K3b's k-tiles (``_BK``) in this range
    only, with the same result."""
    off, n = stft_window_span(g.n_fft, g.win_length)
    return off // tile, -(-(off + n) // tile)


def gl_fused_consts(n_fft: int, hop: int, win_length: int, F: int) -> dict:
    """CPU tensors: "win" (1, n_fft); "wsq_seg" (fp1, hop), the NOLA factor
    truncated to fp1*hop samples and padded with ones; "F_tag" (F, 0) (all
    three the JAX package's entries); and the bf16 hi/lo splits of the
    float32 DFT matrices in the CUDA kernels' layouts, n rows with k
    contiguous, zero-padded: "k3a_hi"/"k3a_lo" ([A ; B] transposed:
    (ceil128(n_fft), ceil64(2 n_freq))) and "k3b_hi"/"k3b_lo" (row 2k = C[:,
    k], 2k+1 = S[:, k]: (ceil128(2 n_freq), ceil64(n_fft))). The JAX
    package's "Ab", "Ab_lo", ..., "Sb_lo" are slices of these
    (``_plain_mats``)."""
    g = gl_geometry(n_fft, hop, win_length, F)
    nf = g.n_freq
    (C, S), (A, B) = _dft_mats(n_fft), _idft_mats(n_fft)
    wsq = _ola_window_sq(F, n_fft, hop, win_length)
    wsq_seg = np.ones((g.fp1 * hop,), np.float32)
    n = min(wsq.shape[0], g.fp1 * hop)
    wsq_seg[:n] = wsq[:n]
    d = {"win": torch.from_numpy(hann_window(win_length, n_fft).reshape(1, -1)),
         "wsq_seg": torch.from_numpy(wsq_seg.reshape(g.fp1, hop)),
         "F_tag": torch.zeros(F, 0)}
    w1 = torch.zeros(2, _ceil_to(n_fft, _BN), _ceil_to(2 * nf, _BK),
                     dtype=torch.bfloat16)
    w2 = torch.zeros(2, _ceil_to(2 * nf, _BN), _ceil_to(n_fft, _BK),
                     dtype=torch.bfloat16)
    for i, parts in enumerate(zip(*(split_bf16(m) for m in (A, B, C, S)))):
        a, b, c, s = parts     # the hi (i = 0) or lo (i = 1) halves
        w1[i, :n_fft, :nf], w1[i, :n_fft, nf: 2 * nf] = a.T, b.T
        w2[i, 0: 2 * nf: 2, :n_fft], w2[i, 1: 2 * nf: 2, :n_fft] = c.T, s.T
    d["k3a_hi"], d["k3a_lo"] = w1.unbind(0)
    d["k3b_hi"], d["k3b_lo"] = w2.unbind(0)
    return d


# ---------------------------------------------------------------------------
# plain versions


def _plain_mats(consts: dict, g: GLGeom, part: str) -> dict:
    """The JAX package's (n_freq, n_fft) "A", "B" and (n_fft, n_freq) "C",
    "S" of one half ("_hi" or "_lo"), as views of the kernels' layouts."""
    n, nf = g.n_fft, g.n_freq
    w1, w2 = consts["k3a" + part], consts["k3b" + part]
    return {"A": w1[:n, :nf].T, "B": w1[:n, nf: 2 * nf].T,
            "C": w2[0: 2 * nf: 2, :n].T, "S": w2[1: 2 * nf: 2, :n].T}


def _mm(x, hi, lo, three: bool):
    """x @ (hi + lo) on bf16 operands, products and sums in x's precision
    (float32; float64 for a reference): xh@hi, or with three the 3-pass
    xh@hi + xh@lo + xl@hi."""
    dt = x.dtype
    xh = x.to(torch.bfloat16).to(dt)
    out = xh @ hi.to(dt)
    if three:
        xl = (x - xh).to(torch.bfloat16).to(dt)
        out = out + xh @ lo.to(dt) + xl @ hi.to(dt)
    return out


def _mms(x, consts, g, key: str, three: bool):
    return _mm(x, _plain_mats(consts, g, "_hi")[key],
               _plain_mats(consts, g, "_lo")[key], three)


def k3a_plain(Xr, Xi, consts: dict, g: GLGeom, three_pass: bool = False):
    """K3a's function: (B, fp1, n_freq) spectrum (rows >= F read as zero)
    -> (B, ly) signal."""
    pad = g.n_fft // 2
    z = (_mms(Xr[:, : g.F], consts, g, "A", three_pass)
         + _mms(Xi[:, : g.F], consts, g, "B", three_pass))
    y = _overlap_add(z * consts["win"], g.hop)[:, pad: pad + g.L_sig] \
        * consts["wsq_seg"].reshape(-1)[pad: pad + g.L_sig]
    return F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]


def k3b_spectrum_plain(yp, consts: dict, g: GLGeom, three_pass: bool = False):
    """The spectrum K3b normalises: the (B, F, n_freq) real and imaginary
    parts of the windowed frames of the (B, ly) signal."""
    fw = yp.unfold(-1, g.n_fft, g.hop) * consts["win"]
    return (_mms(fw, consts, g, "C", three_pass),
            _mms(fw, consts, g, "S", three_pass))


def k3b_plain(yp, mag_p, consts: dict, g: GLGeom, three_pass: bool = False):
    """K3b's function: (B, ly) signal and (B, f2, n_freq) magnitude -> the
    next (Xr, Xi), rows >= F zero."""
    er, ei = k3b_spectrum_plain(yp, consts, g, three_pass)
    s = mag_p[:, : g.F] / torch.clamp(torch.sqrt(er * er + ei * ei), min=1e-8)
    rows = (0, 0, 0, g.f2 - g.F)
    return F.pad(er * s, rows), F.pad(ei * s, rows)


def fused_gl_round_plain(Xr, Xi, mag_p, consts: dict, g: GLGeom,
                         three_pass: bool = False):
    """One round in plain torch, on the tensors' device."""
    return k3b_plain(k3a_plain(Xr, Xi, consts, g, three_pass), mag_p,
                     consts, g, three_pass)


# ---------------------------------------------------------------------------
# wrappers


def _check(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    """Raise unless t is what a kernel reads: contiguous, 16-byte aligned
    (the kernels load 16 bytes at a time), of this dtype, shape and device."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous, 16-byte aligned "
                         f"{dtype} tensor of shape {tuple(shape)} on {dev}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _device(fn: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _weights(name: str, consts: dict, shape, dev):
    hi, lo = consts[name + "_hi"], consts[name + "_lo"]
    for t, n in ((hi, "hi"), (lo, "lo")):
        _check(f"{name}_{n}", t, shape, torch.bfloat16, dev)
    return hi, lo


def _count(kernel: str, three_pass: bool) -> None:
    count(f"{kernel}.launches")
    count(f"{kernel}.{3 if three_pass else 1}pass.launches")


def k3a(Xr, Xi, consts: dict, g: GLGeom, three_pass: bool = False):
    """Kernel K3a and the overlap-add: (B, fp1, n_freq) float32 spectrum
    (rows >= F read as zero, as in the plain version) -> (B, ly) signal.
    Counts its launches as ``k3a.launches`` and, per pass mode,
    ``k3a.1pass.launches`` or ``k3a.3pass.launches``."""
    if not _device("k3a", Xr):
        return k3a_plain(Xr, Xi, consts, g, three_pass)
    from ._build import check, load_library
    dev, B, n = Xr.device, Xr.shape[0], g.n_fft
    for name, t in (("Xr", Xr), ("Xi", Xi)):
        _check(f"k3a {name}", t, (B, g.fp1, g.n_freq), torch.float32, dev)
    hi, lo = _weights("k3a", consts, (_ceil_to(n, _BN),
                                      _ceil_to(2 * g.n_freq, _BK)), dev)
    _check("k3a win", consts["win"], (1, n), torch.float32, dev)
    _check("k3a wsq_seg", consts["wsq_seg"], (g.fp1, g.hop), torch.float32,
           dev)
    frames = torch.empty(B * g.F, n, device=dev)
    yp = torch.empty(B, g.ly, device=dev)
    # the bf16 rows of [Xr | Xi] (hi, and lo with three_pass)
    a = torch.empty((2 if three_pass else 1) * B * g.F * hi.shape[1],
                    dtype=torch.bfloat16, device=dev)
    code = load_library().dctts_gl_k3a(
        Xr.data_ptr(), Xi.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        consts["win"].data_ptr(), consts["wsq_seg"].data_ptr(),
        frames.data_ptr(), yp.data_ptr(), a.data_ptr(), B, n, g.n_freq,
        g.F, g.fp1, g.hop, n // 2, g.L_sig, hi.shape[1],
        *window_span(g, _BN), int(three_pass),
        torch.cuda.current_stream(dev).cuda_stream)
    check(code, "Griffin-Lim round kernel K3a")
    _count("k3a", three_pass)
    return yp


def k3b(yp, mag_p, consts: dict, g: GLGeom, three_pass: bool = False):
    """Kernel K3b: (B, ly) signal and (B, f2, n_freq) float32 magnitude ->
    (Xr, Xi). Counts its launches as K3a does, under ``k3b``."""
    if not _device("k3b", yp):
        return k3b_plain(yp, mag_p, consts, g, three_pass)
    from ._build import check, load_library
    dev, B, n = yp.device, yp.shape[0], g.n_fft
    _check("k3b yp", yp, (B, g.ly), torch.float32, dev)
    _check("k3b mag_p", mag_p, (B, g.f2, g.n_freq), torch.float32, dev)
    hi, lo = _weights("k3b", consts, (_ceil_to(2 * g.n_freq, _BN),
                                      _ceil_to(n, _BK)), dev)
    _check("k3b win", consts["win"], (1, n), torch.float32, dev)
    Xr = torch.empty(B, g.f2, g.n_freq, device=dev)
    Xi = torch.empty_like(Xr)
    Xr[:, g.F:], Xi[:, g.F:] = 0.0, 0.0     # the kernel writes rows < F
    kt0, kt1 = window_span(g, _BK)
    # the windowed frames over the span's k-tiles in bf16 (hi, and lo)
    a = torch.empty((2 if three_pass else 1) * B * g.F * (kt1 - kt0) * _BK,
                    dtype=torch.bfloat16, device=dev)
    code = load_library().dctts_gl_k3b(
        yp.data_ptr(), mag_p.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        consts["win"].data_ptr(), Xr.data_ptr(), Xi.data_ptr(), a.data_ptr(),
        B, n, g.n_freq, g.F, g.f2, g.hop, g.ly, hi.shape[1], hi.shape[0],
        kt0, kt1, int(three_pass), torch.cuda.current_stream(dev).cuda_stream)
    check(code, "Griffin-Lim round kernel K3b")
    _count("k3b", three_pass)
    return Xr, Xi


def fused_gl_round(Xr, Xi, mag_p, consts: dict, g: GLGeom,
                   three_pass: bool = False):
    """One Griffin-Lim round. Xr, Xi, mag_p (B, f2, n_freq) float32 (rows
    >= F of mag_p zero) and the constants of ``gl_fused_consts`` on the same
    device -> the re-imposed (Xr', Xi'). CUDA tensors launch K3a and K3b
    (and raise on what they cannot take); CPU tensors run the plain
    version."""
    return k3b(k3a(Xr, Xi, consts, g, three_pass), mag_p, consts, g,
               three_pass)
