"""Kernel K5: an SSRN block in synthesis under the "high" operand mode, as
one prologue and one epilogue launch around its three bf16 products; and
the tail of a TextEnc block in synthesis under the float32 operand mode, as
one epilogue launch on its float32 product.

The function is ``models/blocks.apply_block`` of a C, HC or D block with
``dtype="high"`` and float32 activations, outside training: gather the
block's taps (``layers._gather_taps``, SAME or causal at its rate; a D
block's current and previous frame), split them into bf16 halves (``dsp/
stft.split_bf16``), take the products hh, hl and lh against the weights'
halves and sum them as (hh + hl) + lh, add the bias, then the block's tail
in float32: C the layer norm and its activation; HC a layer norm of each
half, the sigmoid gate and the highway mix with x; D the even/odd
interleave (even = x W0 + x_prev W2, odd = x W1) and the layer norm.

Replaces no TPU kernel: XLA fused this chain into the products on the TPU.
Eager PyTorch ran it as 21-78 kernels a block, each a pass over the block's
activations: 48.6 of SSRN's 71.4 ms at bulk synthesis's B = 72, against
22.1 ms of products (PERF.md). The chain is bound by bytes; the design
moves each of them once (csrc/ssrn_block.cu):
  * the prologue reads x once and writes the taps' hi and lo halves once,
    in the layout the products take: a C or HC block's rows are time steps
    with the taps side by side, a D block's taps are row blocks of their
    own (x, then x_prev); every row is zero-padded to a multiple of 8
    values, so the products run on cuBLAS's sm90 kernels (1025-wide rows,
    not 16-byte aligned, took its sm75 kernels at ~125 TFLOP/s);
  * the products stay ``torch.mm`` with float32 output against the weight
    halves split and zero-padded once (``pack_weights``), chained through
    ``torch.addmm`` with beta = 1 into the same buffer: hh, then (hh + hl),
    then (hh + hl) + lh, so the sums are added inside the products'
    epilogues and the product is stored once; a D block chains its three
    weights apart (E0, E1, E2);
  * the epilogue reads the summed product once (an HC block also x), adds
    the bias and runs the tail in registers, and writes y once.
The padding adds zero terms only. The layer norms' sums run in another
order than PyTorch's; everything else is the eager chain's arithmetic,
rounding for rounding.

``ssrn_block`` launches the kernels for CUDA tensors and runs
``ssrn_block_plain`` (the eager chain on the same weight halves) for CPU
tensors only. ``models/ssrn.SSRN.apply`` routes a call here when its
tensors are on CUDA, gradients are off, it is not training, the operand
mode is "high" with float32 activations and there is no model group.

TextEnc's C and HC blocks (float32 operands, ``float32_block``) keep their
products as the eager chain takes them: ``layers._gather_taps``, then one
float32 matmul (TF32 off), bit for bit. The epilogue then runs the tail
that eager PyTorch ran as ~25 kernels a block (the bias, two layer norms
over ``torch.chunk``'s strided halves, the sigmoid, four kernels of the
highway mix): 6.4 of TextEnc's 17.4 device ms at B = 72, beside 10.3 of
products; the 14 epilogues take 0.66 (PERF.md). The epilogue's arithmetic
is ``tail_plain``'s; CPU tensors run that. ``models/text2mel.Text2Mel.
text_encode`` routes a call here when its tensors are on CUDA, gradients
are off, it is not training, the operand mode is float32 with float32
activations and there is no model group.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..dsp.stft import split_bf16
from ..models import layers as L
from ..models.blocks import C, D, HC, _act, _highway
from ..utils.profiling import count

# a row of taps or of a product is padded to this many values (16 bytes of
# bf16): cuBLAS's fast kernels need aligned rows
ALIGN = 8
# the kernels' codes (csrc/ssrn_block.cu: Kind, Act)
KINDS = {C: 0, HC: 1, D: 2}
ACTS = {None: 0, "relu": 1}


class Halves(NamedTuple):
    """A block's weight halves, bf16, zero-padded: (Kp, Np) for a C or HC
    block (its (K*C_in, C_out) kernel), (3, Kp, Np) for a D block."""
    hi: torch.Tensor
    lo: torch.Tensor


def _ceil(n: int, m: int = ALIGN) -> int:
    return -(-n // m) * m


def _padded(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) float32 -> zero-padded to (..., Kp, Np)."""
    K, N = w.shape[-2:]
    return F.pad(w.float(), (0, _ceil(N) - N, 0, _ceil(K) - K))


def pack_weights(params: Sequence[dict], specs: Sequence) -> List[Halves]:
    """The stack's conv kernels as the blocks read them: each split once
    into bf16 halves (``split_bf16``) and zero-padded, on the weights'
    device. The halves' top-left (K, N) corner is ``split_bf16`` of the
    kernel; the padding is zero in both."""
    out = []
    for p, spec in zip(params, specs):
        w = p["conv"]["w"]                                 # (K, C_in, C_out)
        K, cin, cout = w.shape
        m = w if isinstance(spec, D) else w.reshape(K * cin, cout)
        out.append(Halves(*split_bf16(_padded(m))))
    return out


def _geometry(spec):
    """(taps S, offset of tap 0, step between taps, separate rows) of a
    block's prologue."""
    if isinstance(spec, D):
        return 2, 0, -1, True                              # x, then x_prev
    total = (spec.size - 1) * spec.rate
    left = total if spec.causal else total // 2
    return spec.size, -left, spec.rate, False


def _chain(ah, al, bh, bl, mm) -> torch.Tensor:
    """(hh + hl) + lh of the halves, float32, through ``mm``."""
    return mm(ah, bh) + mm(ah, bl) + mm(al, bh)


def _taps_width(spec, cin: int) -> int:
    """Values of a row of taps: the block's products' depth K."""
    S, _, _, separate = _geometry(spec)
    return cin if separate else S * cin


# ---------------------------------------------------------------------------
# plain versions


def prologue_plain(x: torch.Tensor, spec, Kp: int):
    """The prologue's (hi, lo) in PyTorch: ``split_bf16`` of the block's
    taps, laid out as the products take them (module docstring) and
    zero-padded to rows of ``Kp`` values. x (B, T, C_in) float32."""
    B, T, cin = x.shape
    if isinstance(spec, D):
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
        taps = torch.cat([x.reshape(B * T, cin), x_prev.reshape(B * T, cin)])
    else:
        taps = L._gather_taps(x, spec.size, spec.rate, spec.causal)
        taps = taps.reshape(B * T, -1)
    return split_bf16(F.pad(taps.float(), (0, Kp - taps.shape[1])))


def ssrn_block_plain(p: dict, spec, x: torch.Tensor, halves: Halves,
                     ln_eps: float, sum_dtype=torch.float32) -> torch.Tensor:
    """K5's function in PyTorch on the packed halves: bit for bit
    ``apply_block(p, spec, x, ln_eps=ln_eps, dtype="high")`` on the CPU
    (the same products of the same unpadded operands, the same tail). With
    ``sum_dtype`` float64 the products' sums and the tail run in float64
    (x's halves are still split from its float32 rounding): a reference for
    both versions."""
    B, T, cin = x.shape
    b = p["conv"]["b"]
    N, M, K = b.shape[0], B * T, _taps_width(spec, cin)
    hi, lo = prologue_plain(x, spec, _ceil(K))
    mm = L._bf16_mm if sum_dtype == torch.float32 else \
        (lambda a, w: a.to(sum_dtype) @ w.to(sum_dtype))

    def prod(rows, wh, wl):
        return _chain(hi[rows, :K].contiguous(), lo[rows, :K].contiguous(),
                      wh[:K, :N].contiguous(), wl[:K, :N].contiguous(), mm)

    if isinstance(spec, D):
        now, prev = slice(0, M), slice(M, 2 * M)
        even = prod(now, halves.hi[0], halves.lo[0]) \
            + prod(prev, halves.hi[2], halves.lo[2])
        odd = prod(now, halves.hi[1], halves.lo[1])
        y = torch.stack([even.reshape(B, T, N), odd.reshape(B, T, N)],
                        dim=2).reshape(B, 2 * T, N) + b
        return _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    h = prod(slice(None), halves.hi, halves.lo).reshape(B, T, N) + b
    if isinstance(spec, HC):
        return _highway(p, h, x, ln_eps)
    return _act(L.layer_norm(p["ln"], h, ln_eps), spec.act)


# ---------------------------------------------------------------------------
# wrapper


def _products(hi, lo, wh, wl) -> torch.Tensor:
    """(hh + hl) + lh on the tensor cores, float32: each sum added in place
    in the next product's epilogue (beta = 1)."""
    f32 = torch.float32
    P = torch.mm(hi, wh, out_dtype=f32)
    torch.addmm(P, hi, wl, out_dtype=f32, out=P)
    return torch.addmm(P, lo, wh, out_dtype=f32, out=P)


def _check_x(x: torch.Tensor, what: str = "ssrn_block") -> None:
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous float32 (B, T, C), "
                         f"got {tuple(x.shape)} {x.dtype}")


def prologue(x: torch.Tensor, spec, Kp: int):
    """The prologue kernel alone on CUDA tensors: ``prologue_plain``'s
    (hi, lo), bf16 (rows, Kp), on the current stream."""
    from ._build import check, load_library

    _check_x(x)
    B, T, cin = x.shape
    S, off0, step, separate = _geometry(spec)
    if Kp % ALIGN or Kp < _taps_width(spec, cin):
        raise ValueError(f"ssrn_block: Kp={Kp} must be a multiple of "
                         f"{ALIGN} >= {_taps_width(spec, cin)}")
    rows = (2 if separate else 1) * B * T
    hi = torch.empty(rows, Kp, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    vec = int(cin % 4 == 0 and x.data_ptr() % 16 == 0)
    check(load_library().dctts_ssrn_prologue(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, T, cin, S, off0, step,
        int(separate), Kp, vec, torch.cuda.current_stream(x.device)
        .cuda_stream), "K5 prologue")
    return hi, lo


def ssrn_block(p: dict, spec, x: torch.Tensor, halves: Halves,
               ln_eps: float) -> torch.Tensor:
    """One SSRN block in the "high" mode. x (B, T, C_in) float32 contiguous
    -> y (B, T, C_out), a D block's (B, 2T, C_out). CUDA tensors launch the
    prologue, the products and the epilogue on the current stream (two
    launches, counted as ``k5.launches``); CPU tensors take
    ``ssrn_block_plain``."""
    if x.device.type == "cpu":
        return ssrn_block_plain(p, spec, x, halves, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"ssrn_block: unsupported device {x.device}")
    kind, act, vecs = _tail_args(p, spec, x, "ssrn_block")
    B, T, cin = x.shape
    N, M, K = vecs[0].shape[0], B * T, _taps_width(spec, cin)
    wh, wl = halves
    if wh.shape[-2:] != (_ceil(K), _ceil(N)) or wh.dtype != torch.bfloat16 \
            or wl.shape != wh.shape or wl.dtype != torch.bfloat16:
        raise ValueError(f"ssrn_block: weight halves {tuple(wh.shape)} do "
                         f"not fit x {tuple(x.shape)} and {N} outputs")
    hi, lo = prologue(x, spec, wh.shape[-2])
    if isinstance(spec, D):
        # E0 = x W0, E2 = x_prev W2 (the even rows), E1 = x W1 (the odd)
        P = (_products(hi[:M], lo[:M], wh[0], wl[0]),
             _products(hi[M:], lo[M:], wh[2], wl[2]),
             _products(hi[:M], lo[:M], wh[1], wl[1]))
        y = torch.empty(B, 2 * T, N, device=x.device)
    else:
        P = (_products(hi, lo, wh, wl),)
        y = torch.empty(B, T, cin if isinstance(spec, HC) else N,
                        device=x.device)
    del hi, lo
    _epilogue(kind, act, P, vecs, x, y, M, ln_eps)
    count("k5.launches", 2)
    return y


def _tail_args(p: dict, spec, x: torch.Tensor, what: str):
    """(kind, act, vectors) of a block's epilogue: the bias, then each
    norm's gain and shift; x checked (``_check_x``)."""
    kind = KINDS.get(type(spec))
    if kind is None:
        raise TypeError(f"{what}: not a C, HC or D block: {spec!r}")
    act = 0 if isinstance(spec, HC) else ACTS.get(spec.act)
    if act is None:
        raise ValueError(f"{what}: activation {spec.act!r}")
    _check_x(x, what)
    ln1, ln2 = (p["ln1"], p["ln2"]) if isinstance(spec, HC) else \
        (p["ln"], None)
    vecs = [p["conv"]["b"], ln1["gamma"], ln1["beta"]] + \
        ([ln2["gamma"], ln2["beta"]] if ln2 else [])
    if any(v.dtype != torch.float32 or not v.is_contiguous()
           or v.device != x.device for v in vecs):
        raise ValueError(f"{what}: biases and norm parameters must be "
                         "contiguous float32 on x's device")
    return kind, act, vecs


def _epilogue(kind: int, act: int, P, vecs, x: torch.Tensor,
              y: torch.Tensor, M: int, ln_eps: float) -> None:
    """The epilogue kernel on the current stream: the products ``P`` (one,
    or D's three) of M rows each, their rows ``P[0].shape[-1]`` apart, into
    y; x is read by an HC block only."""
    from ._build import check, load_library

    # null pointers for what the kind does not read: D's E2 and E1, HC's
    # second norm and its input x
    ptrs = [t.data_ptr() for t in P] + [0] * (3 - len(P))
    ptrs += [v.data_ptr() for v in vecs] + [0] * (5 - len(vecs))
    ptrs.append(x.data_ptr() if kind == KINDS[HC] else 0)
    check(load_library().dctts_ssrn_epilogue(
        kind, *ptrs, y.data_ptr(), M, y.shape[-1], P[0].shape[-1], act,
        float(ln_eps), torch.cuda.current_stream(x.device).cuda_stream),
        "K5 epilogue")


def ssrn_stack_plain(params: Sequence[dict], specs: Sequence,
                     x: torch.Tensor, packed: Sequence[Halves],
                     ln_eps: float, sum_dtype=torch.float32) -> torch.Tensor:
    """The stack's blocks in order through ``ssrn_block_plain``."""
    for p, spec, halves in zip(params, specs, packed):
        x = ssrn_block_plain(p, spec, x, halves, ln_eps, sum_dtype)
    return x


def ssrn_stack(params: Sequence[dict], specs: Sequence, x: torch.Tensor,
               packed: Sequence[Halves], ln_eps: float) -> torch.Tensor:
    """The stack's blocks in order through ``ssrn_block``."""
    x = x.contiguous()
    for p, spec, halves in zip(params, specs, packed):
        x = ssrn_block(p, spec, x, halves, ln_eps)
    return x


# ---------------------------------------------------------------------------
# TextEnc: float32 products, the tail in the epilogue


def _norm_plain(v: torch.Tensor, ln: dict, eps: float) -> torch.Tensor:
    """The epilogue's layer norm: mean = sum * (1/W), var = sum((v -
    mean)^2) * (1/W), ((v - mean) * rsqrt(var + eps)) * gamma + beta."""
    inv = 1.0 / v.shape[-1]
    d = v - v.sum(-1, keepdim=True) * inv
    r = torch.rsqrt((d * d).sum(-1, keepdim=True) * inv + eps)
    return d * r * ln["gamma"] + ln["beta"]


def tail_plain(p: dict, spec, P: torch.Tensor, x: torch.Tensor,
               ln_eps: float) -> torch.Tensor:
    """The epilogue's arithmetic in PyTorch on a C or HC block's float32
    product P (B, T, N), before its bias (csrc/ssrn_block.cu): C the layer
    norm and the activation; HC each half's layer norm, the gate 1 / (1 +
    exp(-h1)) and the highway mix with x. ``blocks.apply_block``'s tail up
    to the order of the norms' sums and the gate's rounding."""
    h = P + p["conv"]["b"]
    if isinstance(spec, HC):
        h1, h2 = torch.chunk(h, 2, dim=-1)
        g = 1.0 / (1.0 + torch.exp(-_norm_plain(h1, p["ln1"], ln_eps)))
        return g * _norm_plain(h2, p["ln2"], ln_eps) + (1.0 - g) * x
    return _act(_norm_plain(h, p["ln"], ln_eps), spec.act)


def float32_block(p: dict, spec, x: torch.Tensor,
                  ln_eps: float) -> torch.Tensor:
    """A C or HC block in the float32 operand mode, x (B, T, C_in) float32
    contiguous -> y (B, T, C_out). The product is the eager chain's
    (``layers.conv1d``'s taps and matmul, bit for bit); CUDA tensors then
    launch the epilogue on it on the current stream (one launch, counted
    as ``k5.textenc.launches``), CPU tensors take ``tail_plain``."""
    if not isinstance(spec, (C, HC)):
        raise TypeError(f"float32_block: not a C or HC block: {spec!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"float32_block: unsupported device {x.device}")
    w = p["conv"]["w"]
    K, cin, cout = w.shape
    P = L.matmul(L._gather_taps(x, spec.size, spec.rate, spec.causal),
                 w.reshape(K * cin, cout))
    if x.device.type == "cpu":
        return tail_plain(p, spec, P, x, ln_eps)
    kind, act, vecs = _tail_args(p, spec, x, "float32_block")
    B, T, _ = x.shape
    y = torch.empty(B, T, cin if isinstance(spec, HC) else cout,
                    device=x.device)
    _epilogue(kind, act, (P,), vecs, x, y, B * T, ln_eps)
    count("k5.textenc.launches")
    return y


def float32_stack(params: Sequence[dict], specs: Sequence, x: torch.Tensor,
                  ln_eps: float) -> torch.Tensor:
    """The stack's blocks in order through ``float32_block``."""
    x = x.contiguous()
    for p, spec in zip(params, specs):
        x = float32_block(p, spec, x, ln_eps)
    return x
