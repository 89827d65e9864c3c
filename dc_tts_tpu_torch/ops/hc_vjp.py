"""Kernel K4: the gated highway-conv (HC) block of training, forward and
backward, the port of ``dc_tts_tpu/ops/pallas_hc_vjp.py:hc_block_trainable``
(forward kernel ``_fwd_kernel``, backward kernel ``_bwd_kernel``).

The function, per batch row (T steps, C channels, K taps at dilation
``rate``; ``left`` frames of zero padding in front, all of them when
causal, half of (K-1)*rate otherwise):

    taps = concat_k x[t + k*rate - left]       (T, K*C)
    h    = taps @ W + b                        (T, 2C);  a = h[:, :C], b2 = h[:, C:]
    n1   = (a - mu1) * inv1;  g = sigmoid(n1*g1 + be1)
    n2   = (b2 - mu2) * inv2; h2 = n2*g2 + be2
    y    = g*h2 + (1-g)*x

and its gradients for a cotangent dy (derivation at
``pallas_hc_vjp.py:14-27``):

    dg  = dy*(h2 - x);  dh2 = dy*g;  dz1 = dg*g*(1-g)
    dg1 = sum dz1*n1;   dbe1 = sum dz1;  dg2 = sum dh2*n2;  dbe2 = sum dh2
    da  = inv1*(dn1 - mean(dn1) - n1*mean(dn1*n1)),  dn1 = dz1*g1
    db2 = inv2*(dn2 - mean(dn2) - n2*mean(dn2*n2)),  dn2 = dh2*g2
    dh  = [da, db2];  db = sum dh;  dW = taps^T @ dh
    dx  = dy*(1-g) + sum_k dh[t - k*rate + left] @ W[k]^T

On the H100 (csrc/hc_vjp.cu) the three tap matmuls dominate: 2*B*T*K*C*2C
float32 operations each, ~1 TFLOP per SSRN step at full width. The TPU
kernel holds a batch row and the weights in VMEM and accumulates the
weight gradients across its sequential grid; the GPU runs blocks in
parallel with 227 KB of shared memory at most, so the port splits the work:
a tensor-core GEMM whose loader does the tap gather (x is never copied into
a taps matrix), then row kernels for the layer norms and the gate. The
backward recomputes h as the TPU kernel does, gathers dx (each output row
sums the K taps that read it, so there are no atomics), and sums dW, db and
the layer-norm gradients over B*T rows in two stages: partials per row range
or row chunk, then a fixed-order sum. Gradients are therefore bitwise
reproducible. There is no time tiling to choose and no VMEM gate: every HC
shape of the trainer runs. The products copy 16 bytes at a time, so they
take C % 4 == 0 (float32) or C % 8 == 0 (bf16); a block of any other C is
stored padded with zero channels to the next such width
(``stored_channels``, ``pad_channels``: x, dy, W's rows and both halves of
its columns, b and the layer-norm vectors), and the row kernels take the
layer norms over the C real channels and write 0 for y, dh and dx in the
padding, so the padding adds nothing to the real outputs. An input the
kernels do not take raises.

The float32 products are float32 on the tensor cores by a three-term TF32
split (3xTF32), the Hopper form of the TPU kernel's ``Precision.HIGHEST``
(a split into bf16 parts on its matrix unit): each operand value is
``hi + lo`` with both parts rounded to TF32 (``tf32_split``: to nearest, ties
away, the low 13 mantissa bits cleared), and each product is
``hi*hi + hi*lo + lo*hi`` with float32 sums (wgmma m64n128k8 .tf32, 128 x
128 block tiles, 32-deep k-tiles). Its bound is 3 x the float32 operations
at 495 TFLOP/s, 2.5 times less time than the same work on the FMA units
(67 TFLOP/s). What it does about what held the SIMT SGEMM before it:

- the tap gather is 16-byte ``cp.async`` copies, each row's source address
  computed once a k-tile, the conv's padding zero fill;
- the copies are asynchronous: a ring of 4 shared-memory stages fed by a
  producer warpgroup, completion on ``mbarrier``s, two consumer warpgroups
  on the tensor cores;
- tf32 ``wgmma`` takes both operands K-major, so each product's B is a TF32
  split copy made once a call (W^T per tap for h, W in its layout for dx,
  dh^T for dW) and A, split in registers, may be staged in any layout;
- the tensor cores' float32 sums truncate over long depths (dW's is B*T),
  so every few k-tiles they are added into separate float32 register sums.

``hc_block_fwd`` and ``hc_block_bwd`` launch the kernels for CUDA tensors
(each counts its launches) and run ``hc_block_fwd_plain`` /
``hc_block_bwd_plain`` for CPU tensors only. ``hc_block_bwd_plain`` is the
hand-derived backward above in PyTorch ops, not autograd, so it is an
independent oracle for the backward kernel. ``hc_block_trainable`` is the
differentiable entry (``HCBlockTrainable``).

``bf16=True`` is the TPU kernel's bf16 operand mode (``_make_dot`` /
``_make_dotg``, taken under ``compute_dtype="bfloat16"``): the operands of
the three tap products are rounded to bf16 (nearest even) at the TPU
kernel's points and nowhere else, products and sums stay float32:

    h    = bf16(taps) @ bf16(W) + b
    dW   = bf16(taps)^T @ bf16(dh)
    dx   = dy*(1-g) + scatter_k bf16(dh) @ bf16(W_k)^T

The layer norms, the gate and the residual stay float32. On the card the
products run on the pipelined bf16 ``wgmma`` core of csrc/bf16_wgmma.cuh
(shared with K3): rounding is elementwise, so ``bf16(taps(x)) ==
taps(bf16(x))`` and x, W and dh are rounded once a call into bf16 copies
(dh by the backward's row kernel), which the same 16-byte ``cp.async`` tap
gather as the float32 core's feeds to shared memory; bf16 ``wgmma`` reads
each operand K-major or MN-major, so W (forward B), dh (dW's B) and x (dW's
A) are read as they lie, with no transposed copy. 64-deep k-tiles, float32
register sums promoted every 2 k-tiles. The copies need C % 8 == 0 (other
widths are padded as above). The wrappers count these launches also
under ``k4.fwd.bf16.launches`` and ``k4.bwd.bf16.launches``.

Spans: the differentiable entry records ``k4.fwd`` around each forward
call and ``k4.bwd`` around each backward call (the kernels' launches on
the card, the plain versions on the CPU) while spans record
(``utils/profiling``); under ``torch.autograd`` on the card the backward
runs in the engine's device thread, so ``k4.bwd`` is a root span there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import count, span

_GEMM_TILE = 128          # csrc/hc_vjp.cu TBM = TBN, and the bf16 BM = BN
_GEMM_DEPTH = 32          # csrc/hc_vjp.cu TBK, the float32 core's k-tile
_BF16_DEPTH = 64          # csrc/bf16_wgmma.cuh BK, the bf16 core's k-tile
_SMS = 132                # H100 SXM streaming multiprocessors
_MAX_C = 5600             # hc_bwd_rows keeps 10*C floats in shared memory


def _pads(size: int, rate: int, causal: bool):
    total = (size - 1) * rate
    left = total if causal else total // 2
    return left, total - left


def _taps(x: torch.Tensor, size: int, rate: int, causal: bool):
    """x (B, T, C) -> (B, T, size*C), tap k reading x[t + k*rate - left]."""
    if size == 1:
        return x
    left, right = _pads(size, rate, causal)
    xp = F.pad(x, (0, 0, left, right))
    T = x.shape[1]
    return torch.cat([xp[:, k * rate: k * rate + T] for k in range(size)],
                     dim=-1)


def _ln(v: torch.Tensor, eps: float):
    mu = v.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((v - mu).square().mean(dim=-1, keepdim=True) + eps)
    return (v - mu) * inv, inv


def tf32_split(t: torch.Tensor):
    """(hi, lo) of float32 t, both TF32 values kept in float32: hi = t
    rounded to nearest with ties away from zero and the low 13 mantissa
    bits cleared (csrc/sm90.cuh's cvt.rna.tf32.f32), lo = the same rounding
    of t - hi. hi + lo is t to within ~2^-22 |t|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(t)
    return hi, rna(t - hi)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _forward_parts(x, w, b, g1, b1, g2, b2, size, rate, causal, eps, bf16):
    """taps and W (rounded to bf16 in bf16 mode) and the forward's parts."""
    K, C, C2 = w.shape
    taps = _taps(x, size, rate, causal)
    if bf16:
        taps, w = _bf16(taps), _bf16(w)
    h = taps @ w.reshape(K * C, C2) + b
    n1, inv1 = _ln(h[..., :C], eps)
    n2, inv2 = _ln(h[..., C:], eps)
    g = torch.sigmoid(n1 * g1 + b1)
    h2 = n2 * g2 + b2
    return taps, w, n1, inv1, n2, inv2, g, h2


# ---------------------------------------------------------------------------
# plain versions


def hc_block_fwd_plain(x, w, b, g1, b1, g2, b2, size: int, rate: int,
                       causal: bool, eps: float,
                       bf16: bool = False) -> torch.Tensor:
    """K4's forward in PyTorch ops, in the input's precision (with bf16,
    the tap product's operands rounded to bf16)."""
    *_, g, h2 = _forward_parts(x, w, b, g1, b1, g2, b2, size, rate, causal,
                               eps, bf16)
    return g * h2 + (1.0 - g) * x


def hc_block_bwd_plain(x, w, b, g1, b1, g2, b2, dy, size: int, rate: int,
                       causal: bool, eps: float, bf16: bool = False):
    """K4's backward by the hand derivation (module docstring) in PyTorch
    ops, without autograd. Returns (dx, dw, db, dg1, db1, dg2, db2). With
    bf16, taps, W and dh are rounded to bf16 where they enter a product."""
    B, T, C = x.shape
    K = size
    taps, w, n1, inv1, n2, inv2, g, h2 = _forward_parts(
        x, w, b, g1, b1, g2, b2, size, rate, causal, eps, bf16)
    dg = dy * (h2 - x)
    dh2 = dy * g
    dz1 = dg * g * (1.0 - g)
    rows = (0, 1)
    dg1, dbe1 = (dz1 * n1).sum(rows), dz1.sum(rows)
    dg2, dbe2 = (dh2 * n2).sum(rows), dh2.sum(rows)
    dn1 = dz1 * g1
    da = inv1 * (dn1 - dn1.mean(-1, keepdim=True)
                 - n1 * (dn1 * n1).mean(-1, keepdim=True))
    dn2 = dh2 * g2
    dbb = inv2 * (dn2 - dn2.mean(-1, keepdim=True)
                  - n2 * (dn2 * n2).mean(-1, keepdim=True))
    dh = torch.cat([da, dbb], dim=-1)                   # (B, T, 2C)
    dbias = dh.sum(rows)
    if bf16:
        dh = _bf16(dh)
    dw = (taps.reshape(-1, K * C).T @ dh.reshape(-1, 2 * C)).reshape(
        K, C, 2 * C)
    # scatter the tap gradients back to the padded input, then un-pad
    dtaps = dh @ w.reshape(K * C, 2 * C).T              # (B, T, K*C)
    left, right = _pads(size, rate, causal)
    dxp = x.new_zeros(B, T + left + right, C)
    for k in range(K):
        dxp[:, k * rate: k * rate + T] += dtaps[..., k * C: (k + 1) * C]
    dx = dxp[:, left: left + T] + dy * (1.0 - g)
    return dx, dw, dbias, dg1, dbe1, dg2, dbe2


# ---------------------------------------------------------------------------
# wrappers


def stored_channels(C: int, bf16: bool) -> int:
    """The channels the CUDA kernels store a block of C in: their products
    copy 16 bytes at a time, so C rounded up to a multiple of 4 (float32) or
    8 (bf16)."""
    q = 8 if bf16 else 4
    return -(-C // q) * q


def _halves(t: torch.Tensor, C: int, Cp: int) -> torch.Tensor:
    """(..., 2C) -> (..., 2Cp): each C-wide half zero-padded to Cp."""
    return torch.cat([F.pad(t[..., :C], (0, Cp - C)),
                      F.pad(t[..., C:], (0, Cp - C))], dim=-1)


def pad_channels(Cp: int, x, w, b, g1, b1, g2, b2, *dy):
    """The block's tensors stored with Cp >= C channels, zero in the
    padding: x and dy (B, T, Cp), W (K, Cp, 2Cp) and b (2Cp,) with each
    half of the output channels padded, the layer-norm vectors (Cp,). The
    zero rows of W keep the padding out of the real channels of h."""
    C = x.shape[-1]
    if Cp == C:
        return (x, w, b, g1, b1, g2, b2, *dy)
    p = (0, Cp - C)
    return (F.pad(x, p), F.pad(_halves(w, C, Cp), (0, 0) + p),
            _halves(b, C, Cp), *(F.pad(t, p) for t in (g1, b1, g2, b2)),
            *(F.pad(t, p) for t in dy))


def unpad_grads(C: int, dx, dw, db, dg1, db1, dg2, db2):
    """``pad_channels``' inverse for the gradients: the real channels."""
    Cp = dx.shape[-1]
    if Cp == C:
        return dx, dw, db, dg1, db1, dg2, db2

    def real(t):  # (..., 2Cp) -> (..., 2C)
        return torch.cat([t[..., :C], t[..., Cp:Cp + C]], dim=-1)
    return (dx[..., :C].contiguous(), real(dw[:, :C]), real(db),
            *(t[:C].contiguous() for t in (dg1, db1, dg2, db2)))


def _check(name: str, x, w, rows, size: int, bf16: bool, extra=()):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if tuple(w.shape) != (size, C, 2 * C):
        raise ValueError(f"{name}: w must be ({size}, {C}, {2 * C}), got "
                         f"{tuple(w.shape)}")
    want = [2 * C] + [C] * 4
    for r, n in zip(rows, want):
        if tuple(r.shape) != (n,):
            raise ValueError(f"{name}: bias/layer-norm vectors must be "
                             f"({2 * C},) and ({C},), got {tuple(r.shape)}")
    for t in (x, w, *rows, *extra):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernels take float32 tensors "
                             f"on one device, got {t.dtype} on {t.device}")
    C = stored_channels(C, bf16)
    if C > _MAX_C:
        raise ValueError(f"{name}: C={C} > {_MAX_C} does not fit the row "
                         "kernel's shared memory")
    if B * T * 2 * C >= 2 ** 31:
        raise ValueError(f"{name}: B*T*2C must be < 2**31")
    if not bf16 and _pad_rows(B * T) * 2 * C >= 2 ** 31:
        raise ValueError(f"{name}: dh^T's padded rows need "
                         "ceil(B*T/32)*32*2C < 2**31")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it, at a 16-byte-aligned address (the kernels' copies
    move 16 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_rows(M: int) -> int:
    """dh^T's row pitch: B*T rounded up to the k-tile (csrc/hc_vjp.cu)."""
    return -(-M // _GEMM_DEPTH) * _GEMM_DEPTH


def _row_chunk(M: int) -> int:
    """Rows per block of the backward's row kernel: about four blocks per
    SM, at least 8 rows each (fixed by the shape, so sums keep their
    order)."""
    return max(8, -(-M // (4 * _SMS)))


def _dw_splits(K: int, C: int, M: int, bf16: bool = False) -> int:
    """Row ranges the dW product is split over: enough blocks for two waves
    of one block per SM, each range at least 8 k-tiles deep (32 rows a
    k-tile float32, 64 bf16)."""
    t = _GEMM_TILE
    tiles = -(-(K * C) // t) * -(-(2 * C) // t)
    min_rows = 8 * (_BF16_DEPTH if bf16 else _GEMM_DEPTH)
    return max(1, min(-(-2 * _SMS // tiles), M // min_rows))


def _count(direction: str, bf16: bool) -> None:
    count(f"k4.{direction}.launches")
    if bf16:
        count(f"k4.{direction}.bf16.launches")


def hc_block_fwd(x, w, b, g1, b1, g2, b2, size: int, rate: int, causal: bool,
                 eps: float, bf16: bool = False) -> torch.Tensor:
    """y = HC(x). x (B, T, C), w (K, C, 2C), b (2C,), g1/b1/g2/b2 (C,).
    CUDA tensors launch the forward kernels (one counted launch per call,
    as ``k4.fwd.launches`` and, with bf16 operands, also
    ``k4.fwd.bf16.launches``); CPU tensors take ``hc_block_fwd_plain``."""
    if x.device.type == "cpu":
        return hc_block_fwd_plain(x, w, b, g1, b1, g2, b2, size, rate,
                                  causal, eps, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"hc_block_fwd: unsupported device {x.device}")
    from ._build import check, load_library

    _check("hc_block_fwd", x, w, (b, g1, b1, g2, b2), size, bf16)
    B, T, Cv = x.shape
    C = stored_channels(Cv, bf16)
    x, w, *rows = (t.contiguous() for t in
                   pad_channels(C, x, w, b, g1, b1, g2, b2))
    x = _aligned(x)
    left, _ = _pads(size, rate, causal)
    lib = load_library()
    h = torch.empty(B, T, 2 * C, device=x.device)
    y = torch.empty_like(x)
    # bf16(W) and bf16(x) for the bf16 product, W^T's TF32 parts for the
    # float32 one
    wsplit = (torch.empty(w.numel() + x.numel(), dtype=torch.bfloat16,
                          device=x.device) if bf16 else
              torch.empty(2 * w.numel(), device=x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.dctts_hc_fwd(x.data_ptr(), w.data_ptr(),
                            *(r.data_ptr() for r in rows), h.data_ptr(),
                            y.data_ptr(), wsplit.data_ptr(), B, T, C, Cv,
                            size, rate, left, float(eps), int(bf16), stream)
    check(code, "HC forward kernels")
    _count("fwd", bf16)
    return y if C == Cv else y[..., :Cv].contiguous()


def hc_block_bwd(x, w, b, g1, b1, g2, b2, dy, size: int, rate: int,
                 causal: bool, eps: float, bf16: bool = False):
    """(dx, dw, db, dg1, db1, dg2, db2) of HC at x for the cotangent dy.
    CUDA tensors launch the backward kernels (one counted launch per call,
    as ``hc_block_fwd`` counts); CPU tensors take ``hc_block_bwd_plain``."""
    if x.device.type == "cpu":
        return hc_block_bwd_plain(x, w, b, g1, b1, g2, b2, dy, size, rate,
                                  causal, eps, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"hc_block_bwd: unsupported device {x.device}")
    from ._build import check, load_library

    _check("hc_block_bwd", x, w, (b, g1, b1, g2, b2), size, bf16, (dy,))
    if dy.shape != x.shape:
        raise ValueError(f"hc_block_bwd: dy {tuple(dy.shape)} != x "
                         f"{tuple(x.shape)}")
    B, T, Cv = x.shape
    C = stored_channels(Cv, bf16)
    x, w, *rows, dy = (t.contiguous() for t in
                       pad_channels(C, x, w, b, g1, b1, g2, b2, dy))
    x = _aligned(x)
    M = B * T
    left, _ = _pads(size, rate, causal)
    R, S = _row_chunk(M), _dw_splits(size, C, M, bf16)
    lib = load_library()
    dev = x.device
    h = torch.empty(B, T, 2 * C, device=dev)
    dh = torch.empty(0 if bf16 else h.numel(), device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dparams = torch.empty(6 * C, device=dev)
    row_part = torch.empty(-(-M // R), 6 * C, device=dev)
    dw_part = torch.empty(S if S > 1 else 0, *w.shape, device=dev)
    if bf16:  # bf16(W) | bf16(x), and bf16(dh)
        wsplit = torch.empty(w.numel() + x.numel(), dtype=torch.bfloat16,
                             device=dev)
        dhsplit = torch.empty(h.numel(), dtype=torch.bfloat16, device=dev)
    else:  # the TF32 parts: W^T and W (hi, lo each), and dh^T
        wsplit = torch.empty(4 * w.numel(), device=dev)
        dhsplit = torch.empty(2 * 2 * C * _pad_rows(M), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.dctts_hc_bwd(x.data_ptr(), w.data_ptr(),
                            *(r.data_ptr() for r in rows), dy.data_ptr(),
                            h.data_ptr(), dh.data_ptr(), dx.data_ptr(),
                            dw.data_ptr(), dparams.data_ptr(),
                            row_part.data_ptr(), dw_part.data_ptr(),
                            wsplit.data_ptr(), dhsplit.data_ptr(), B, T, C,
                            Cv, size, rate, left, float(eps), R, S,
                            int(bf16), stream)
    check(code, "HC backward kernels")
    _count("bwd", bf16)
    db, dg1, db1, dg2, db2 = dparams.split([2 * C, C, C, C, C])
    return unpad_grads(Cv, dx, dw, db, dg1, db1, dg2, db2)


class HCBlockTrainable(torch.autograd.Function):
    """The HC block with K4's hand-written backward."""

    @staticmethod
    def forward(ctx, x, w, b, g1, b1, g2, b2, size, rate, causal, eps, bf16):
        ctx.save_for_backward(x, w, b, g1, b1, g2, b2)
        ctx.geom = (size, rate, causal, eps, bf16)
        with span("k4.fwd"):
            return hc_block_fwd(x, w, b, g1, b1, g2, b2, size, rate, causal,
                                eps, bf16)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        with span("k4.bwd"):
            grads = hc_block_bwd(*ctx.saved_tensors, dy, *ctx.geom)
        return (*grads, None, None, None, None, None)


def hc_block_trainable(x, w, b, g1, b1, g2, b2, size: int, rate: int,
                       causal: bool, eps: float,
                       bf16: bool = False) -> torch.Tensor:
    """Differentiable HC block. x (B, T, C), w (K, C, 2C) -> (B, T, C);
    bf16: the TPU kernel's bf16 operand mode."""
    return HCBlockTrainable.apply(x, w, b, g1, b1, g2, b2, size, rate,
                                  causal, eps, bool(bf16))
