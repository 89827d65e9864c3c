"""Kernel K1: the whole Text2Mel decode loop in one launch.

Replaces ``dc_tts_tpu/ops/pallas_decode.py:fused_decode`` (kernel body
``_decode_kernel``), in each of its four precisions: T steps, each
AudioEnc (3 C + 10 dilated causal HC layers) on the previous mel frame
-> q; one attention row masked to [cursor, cursor + win), softmax, the new
cursor is the first argmax of the softmax output, ctx = a.V; AudioDec on
[ctx; q] -> sigmoid, fed back as the next input frame. Each HC layer keeps
a ring buffer of 2*rate+1 rows (write at t mod R, taps at (t+1) mod R and
(t+rate+1) mod R). Outputs Y (B, T, n_mels) and A (B, N, T).

On the H100 (csrc/decode.cu): the T steps are sequential and every step
reads all ~29 MB of packed weights, so a step is bound by how fast one SM
can stream the weights through L2, and the whole decode by T such steps.
The simple design here: batch rows are independent, so one 512-thread
block owns ``ROWS`` rows and runs all T steps with no synchronisation
between blocks; a step's activations sit in shared memory, the ring
buffers in a global scratch the wrapper allocates (it stays in L2), and
each thread owns one output column of a layer, streaming that column of
the weights once per step for all of its block's rows. Only the <= win
unmasked attention scores are computed: the masked ones are exactly zero
after the softmax. Splitting the weights over the shared memory of all
SMs, with cluster or grid synchronisation, is later work.

Precisions (``prec``), as the JAX kernel's ``mm``: every layer product is
float32 under "highest"; under "high3" it is xh@Wh + xh@Wl + xl@Wh on bf16
halves (the weights split once, ``split_hilo``, the activations each step
as xh = bf16(x), xl = bf16(x - xh), both rounded to nearest even), float32
sums; "hybrid" takes the split products in AudioDec only and keeps
AudioEnc, the q path that sets the cursor, in float32; "default" is one
product of both operands rounded to bf16 with a float32 sum. The attention
row, the layer norms and the gates stay float32 in every mode. "default" is
what the TPU's single-pass dot computes; JAX's interpret mode on the CPU
computes it in float32 instead, so it has no JAX oracle off the TPU. On the
card the split products run as FFMA on the widened bf16 halves: a product
of two bf16 values is exact in float32, so only the order of the sums
differs from the tensor core's.

``fused_decode`` launches the kernel for CUDA tensors and runs
``fused_decode_plain`` (the same loop in PyTorch) for CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..dsp.stft import split_bf16

NEG_INF = -(2.0 ** 32 - 1.0)

# batch rows per thread block; must equal DECODE_ROWS in csrc/decode.cu
ROWS = 4
# the decode precisions, in the kernel's mode numbering (csrc/decode.cu)
PRECS = ("highest", "high3", "hybrid", "default")


class _Layer(NamedTuple):
    kind: str        # "C" | "HC"
    idx: int         # index into the packed weight array of its kind
    cin: int
    cout: int        # C: output width; HC: C (residual width)
    rate: int        # HC dilation
    act: str | None  # C activation


def _programs(cfg) -> Tuple[Tuple[_Layer, ...], Tuple[_Layer, ...]]:
    """Static layer programs for AudioEnc and AudioDec, with packed-array
    indices assigned in traversal order (enc first)."""
    from ..models.blocks import C as Cspec, HC as HCspec
    from ..models.text2mel import audio_dec_specs, audio_enc_specs

    ci = hi = 0
    progs = []
    for specs, cin0 in ((audio_enc_specs(cfg), cfg.n_mels),
                        (audio_dec_specs(cfg), 2 * cfg.d)):
        prog = []
        ch = cin0
        for s in specs:
            if isinstance(s, Cspec):
                out = s.out_ch or ch
                prog.append(_Layer("C", ci, ch, out, 1, s.act))
                ci += 1
                ch = out
            elif isinstance(s, HCspec):
                prog.append(_Layer("HC", hi, ch, ch, s.rate, None))
                hi += 1
            else:
                raise TypeError(s)
        progs.append(tuple(prog))
    return tuple(progs)


def _enc_counts(cfg) -> Tuple[int, int]:
    """(C layers, HC layers) of AudioEnc: the first indices of AudioDec's
    layers in the packed arrays of each kind."""
    enc_prog, _ = _programs(cfg)
    n_c = sum(1 for l in enc_prog if l.kind == "C")
    return n_c, len(enc_prog) - n_c


def split_hilo(w: torch.Tensor) -> torch.Tensor:
    """float32 -> (2, ...) bf16 stack of hi = bf16(w), lo = bf16(w - hi),
    both rounded to nearest even (the JAX kernel's ``hilo``)."""
    return torch.stack(split_bf16(w))


def check_prec(prec: str) -> None:
    """Raise ValueError unless ``prec`` is one of ``PRECS``."""
    if prec not in PRECS:
        raise ValueError(f"unknown decode precision {prec!r}; one of {PRECS}")


def _packed_specs(cfg, prec: str) -> dict:
    """{key: (shape, dtype)} of the arrays the kernel reads in ``prec``."""
    enc_prog, dec_prog = _programs(cfg)
    c_layers = [l for l in enc_prog + dec_prog if l.kind == "C"]
    n_c, n_hc = len(c_layers), len(enc_prog + dec_prog) - len(c_layers)
    cmi, cmo, C = (max(l.cin for l in c_layers),
                   max(l.cout for l in c_layers), cfg.d)
    f32, bf16 = torch.float32, torch.bfloat16
    specs = {"cw": ((n_c, cmi, cmo), f32), "cb": ((n_c, cmo), f32),
             "cln": ((n_c, 2, cmo), f32), "hcw": ((n_hc, 3 * C, 2 * C), f32),
             "hcb": ((n_hc, 2 * C), f32), "hcln": ((n_hc, 4, C), f32)}
    if prec == "high3":
        for k in ("cw", "hcw"):
            specs[k] = ((2, *specs[k][0]), bf16)
    elif prec == "hybrid":
        n_c_enc, n_hc_enc = _enc_counts(cfg)
        specs["cw2"] = ((2, n_c - n_c_enc, cmi, cmo), bf16)
        specs["hcw2"] = ((2, n_hc - n_hc_enc, 3 * C, 2 * C), bf16)
    elif prec == "default":
        for k in ("cw", "hcw"):
            specs[k] = (specs[k][0], bf16)
    return specs


def pack_decode_params(cfg, params, prec: str = "highest") -> dict:
    """AudioEnc+AudioDec weights as the decode kernel of ``prec`` reads
    them. "highest": six dense float32 arrays, laid out as
    ``dc_tts_tpu.ops.pallas_decode.pack_decode_params`` lays them: C-layer
    kernels in (max_cin, max_cout) slots, HC kernels (3*C, 2*C) with taps
    oldest first (lags 2r, r, 0). The other precisions change the kernels
    ``cw`` and ``hcw`` as the JAX ``fused_decode`` does before its call:
    "high3" replaces both by their (2, ...) bf16 hi/lo stacks; "hybrid"
    keeps them and adds the hi/lo stacks of AudioDec's slices only, ``cw2``
    and ``hcw2``; "default" replaces both by their bf16 roundings."""
    check_prec(prec)
    enc_prog, dec_prog = _programs(cfg)
    dev = params["audio_enc"][0]["conv"]["w"].device
    specs = _packed_specs(cfg, "highest")
    cw, cb, cln, hcw, hcb, hcln = (
        torch.zeros(specs[k][0], dtype=torch.float32, device=dev)
        for k in ("cw", "cb", "cln", "hcw", "hcb", "hcln"))
    for stack_params, prog in ((params["audio_enc"], enc_prog),
                               (params["audio_dec"], dec_prog)):
        for p, l in zip(stack_params, prog):
            w = p["conv"]["w"]                           # (K, cin, cout)
            if l.kind == "C":
                cw[l.idx, : l.cin, : l.cout] = w[0]
                cb[l.idx, : l.cout] = p["conv"]["b"]
                cln[l.idx, 0, : l.cout] = p["ln"]["gamma"]
                cln[l.idx, 1, : l.cout] = p["ln"]["beta"]
            else:
                hcw[l.idx] = w.reshape(3 * l.cin, 2 * l.cin)
                hcb[l.idx] = p["conv"]["b"]
                hcln[l.idx, 0] = p["ln1"]["gamma"]
                hcln[l.idx, 1] = p["ln1"]["beta"]
                hcln[l.idx, 2] = p["ln2"]["gamma"]
                hcln[l.idx, 3] = p["ln2"]["beta"]
    packed = {"cw": cw, "cb": cb, "cln": cln,
              "hcw": hcw, "hcb": hcb, "hcln": hcln}
    if prec == "high3":
        packed.update(cw=split_hilo(cw), hcw=split_hilo(hcw))
    elif prec == "hybrid":
        n_c_enc, n_hc_enc = _enc_counts(cfg)
        packed.update(cw2=split_hilo(cw[n_c_enc:]),
                      hcw2=split_hilo(hcw[n_hc_enc:]))
    elif prec == "default":
        packed.update(cw=cw.to(torch.bfloat16), hcw=hcw.to(torch.bfloat16))
    return packed


def _check_packed(packed: dict, cfg, prec: str, device) -> None:
    """Raise unless ``packed`` holds every array the kernel of ``prec``
    reads, of its shape and type, contiguous, on ``device``."""
    for k, (shape, dtype) in _packed_specs(cfg, prec).items():
        x = packed.get(k)
        if x is None or tuple(x.shape) != shape or x.dtype != dtype \
                or x.device != device or not x.is_contiguous():
            raise ValueError(
                f"fused_decode: packed[{k!r}] must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device} for prec={prec!r} "
                "(pack_decode_params(cfg, params, prec))")


# ---------------------------------------------------------------------------
# plain version


def _ln(x, gamma, beta, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def layer_product(x: torch.Tensor, w: torch.Tensor, kind: str,
                  dt=torch.float32) -> torch.Tensor:
    """One layer product x (B, K) @ w as the kernel computes it, by operand
    kind: "f32" (w float32 (K, N)); "split" (w the (2, K, N) bf16 hi/lo
    stack: xh@Wh + xh@Wl + xl@Wh, summed in that order, xh = bf16(x), xl =
    bf16(x - xh)); "bf16" (w bf16 (K, N) and x rounded to bf16, one
    product). Matmuls in ``dt`` of the bf16 values, never of bf16 tensors
    (a bf16 matmul rounds its result)."""
    if kind == "f32":
        return x @ w.to(dt)
    xh = x.to(torch.bfloat16)
    if kind == "bf16":
        return xh.to(dt) @ w.to(dt)
    xl = (x - xh.to(x.dtype)).to(torch.bfloat16)
    xh, xl, wh, wl = (t.to(dt) for t in (xh, xl, w[0], w[1]))
    return xh @ wh + xh @ wl + xl @ wh


def fused_decode_plain(packed: dict, Kt: torch.Tensor, V: torch.Tensor,
                       T: int, cfg, prec: str = "highest",
                       sum_dtype=torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's function in PyTorch: a loop over T steps and the
    packed layers, with one ring buffer of 2*rate+1 rows per HC layer.
    ``packed`` is ``pack_decode_params(cfg, params, prec)``; each layer
    product follows ``prec`` (module docstring), as matmuls in ``sum_dtype``
    of the bf16 values (never a bf16 matmul, which would round its result).
    Everything else runs in ``sum_dtype`` too: float64 gives the reference
    that the kernel's float32 sums are measured against on the card. Y and
    A come back in ``sum_dtype``."""
    check_prec(prec)
    _check_packed(packed, cfg, prec, Kt.device)
    enc_prog, dec_prog = _programs(cfg)
    n_c_enc, n_hc_enc = _enc_counts(cfg)
    B, N, d = Kt.shape
    dev, dt = Kt.device, sum_dtype
    eps = cfg.ln_eps
    cb, cln, hcb, hcln = (packed[k].to(dt)
                          for k in ("cb", "cln", "hcb", "hcln"))
    rings = [torch.zeros(2 * l.rate + 1, B, l.cout, device=dev, dtype=dt)
             for l in enc_prog + dec_prog if l.kind == "HC"]

    def mm(x, kind, idx, rows, cols, dec):
        """The product of packed layer ``idx`` of ``kind`` (its weights'
        first ``rows`` x ``cols``) in this mode."""
        w = packed["cw" if kind == "C" else "hcw"]
        if prec == "high3":
            return layer_product(x, w[:, idx, :rows, :cols], "split", dt)
        if prec == "hybrid" and dec:
            w = packed["cw2" if kind == "C" else "hcw2"]
            idx -= n_c_enc if kind == "C" else n_hc_enc
            return layer_product(x, w[:, idx, :rows, :cols], "split", dt)
        return layer_product(x, w[idx, :rows, :cols],
                             "bf16" if prec == "default" else "f32", dt)

    def run_stack(prog, x, t, ring_base, dec):
        ri = ring_base
        for l in prog:
            if l.kind == "C":
                h = mm(x, "C", l.idx, l.cin, l.cout, dec) + cb[l.idx, : l.cout]
                h = _ln(h, cln[l.idx, 0, : l.cout], cln[l.idx, 1, : l.cout],
                        eps)
                x = torch.relu(h) if l.act == "relu" else h
                continue
            R = 2 * l.rate + 1
            ring = rings[ri]
            ri += 1
            ring[t % R] = x
            taps = torch.cat([ring[(t + 1) % R], ring[(t + l.rate + 1) % R],
                              x], dim=-1)
            h = mm(taps, "HC", l.idx, 3 * l.cout, 2 * l.cout, dec) \
                + hcb[l.idx]
            g = torch.sigmoid(_ln(h[:, : l.cout], hcln[l.idx, 0],
                                  hcln[l.idx, 1], eps))
            h2 = _ln(h[:, l.cout:], hcln[l.idx, 2], hcln[l.idx, 3], eps)
            x = g * h2 + (1.0 - g) * x
        return x

    Kt, V = Kt.to(dt), V.to(dt)
    pos = torch.arange(N, device=dev)[None, :]
    prev = torch.zeros(B, 1, dtype=torch.long, device=dev)
    y = torch.zeros(B, cfg.n_mels, device=dev, dtype=dt)
    Y = torch.empty(B, T, cfg.n_mels, device=dev, dtype=dt)
    A = torch.empty(B, N, T, device=dev, dtype=dt)
    for t in range(T):
        q = run_stack(enc_prog, y, t, 0, False)
        scores = torch.einsum("bnd,bd->bn", Kt, q) * (d ** -0.5)
        disallowed = (pos < prev) | (pos >= prev + cfg.attention_win_size)
        a = torch.softmax(torch.where(disallowed, NEG_INF, scores), dim=-1)
        prev = torch.argmax(a, dim=-1, keepdim=True)
        ctx = torch.einsum("bn,bnd->bd", a, V)
        y = torch.sigmoid(run_stack(dec_prog, torch.cat([ctx, q], dim=-1), t,
                                    n_hc_enc, True))
        Y[:, t] = y
        A[:, :, t] = a
    return Y, A


# ---------------------------------------------------------------------------
# wrapper

_ACT = {None: 0, "relu": 1, "sigmoid": 2}


def _program_array(enc_prog, dec_prog):
    """Layer program as the kernel reads it: 6 ints per layer (kind, idx,
    cin, cout, rate, act), enc layers first."""
    flat = []
    for l in enc_prog + dec_prog:
        flat += [0 if l.kind == "C" else 1, l.idx, l.cin, l.cout, l.rate,
                 _ACT[l.act]]
    return (ctypes.c_int * len(flat))(*flat)


def ring_rows(cfg) -> int:
    """Ring-buffer rows per batch row: sum of 2*rate+1 over the HC layers
    (272 at base_config)."""
    enc_prog, dec_prog = _programs(cfg)
    return sum(2 * l.rate + 1 for l in enc_prog + dec_prog if l.kind == "HC")


def fused_decode(packed: dict, Kt: torch.Tensor, V: torch.Tensor, T: int,
                 cfg, prec: str = "highest"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole autoregressive decode. Kt/V (B, N, d) float32 ->
    (Y (B, T, n_mels), A (B, N, T)). ``packed`` is ``pack_decode_params(cfg,
    params, prec)``. CUDA tensors launch the kernel (and count the launch,
    in ``launches`` and in ``launches_by_prec[prec]``); CPU tensors take
    ``fused_decode_plain``. An unknown ``prec`` raises, and so does a packed
    array of another shape or type than ``prec`` reads: nothing is
    converted quietly."""
    check_prec(prec)
    if Kt.device.type == "cpu":
        return fused_decode_plain(packed, Kt, V, T, cfg, prec)
    if Kt.device.type != "cuda":
        raise ValueError(f"fused_decode: unsupported device {Kt.device}")
    from ._build import check, load_library

    B, N, d = Kt.shape
    for x in (Kt, V):
        if x.device != Kt.device or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError("fused_decode: Kt and V must be contiguous "
                             "float32 tensors on one CUDA device")
    if V.shape != Kt.shape or d != cfg.d:
        raise ValueError(f"fused_decode: Kt {tuple(Kt.shape)} / V "
                         f"{tuple(V.shape)} do not match d={cfg.d}")
    _check_packed(packed, cfg, prec, Kt.device)
    enc_prog, dec_prog = _programs(cfg)
    prog = _program_array(enc_prog, dec_prog)
    lib = load_library()
    Y = torch.empty(B, T, cfg.n_mels, device=Kt.device)
    A = torch.empty(B, N, T, device=Kt.device)
    ring = torch.empty(-(-B // ROWS) * ROWS, ring_rows(cfg), d,
                       device=Kt.device)
    # the float32 kernels (read by "highest", and by AudioEnc under
    # "hybrid"); the bf16 ones (the hi/lo stacks, or the single rounding of
    # "default"), the packed index of the first layer they hold, and the
    # offset of their lo halves in elements
    cmi, cmo = packed["cw"].shape[-2:]
    none = (None, None)
    f32_keys = ("cw", "hcw") if prec in ("highest", "hybrid") else none
    low_keys = {"high3": ("cw", "hcw"), "hybrid": ("cw2", "hcw2"),
                "default": ("cw", "hcw")}.get(prec, none)
    ptrs = [packed[k].data_ptr() if k else None for k in f32_keys + low_keys]
    bases = _enc_counts(cfg) if prec == "hybrid" else (0, 0)
    lo = ([packed[k][0].numel() for k in low_keys]
          if prec in ("high3", "hybrid") else [0, 0])
    stream = torch.cuda.current_stream(Kt.device).cuda_stream
    code = lib.dctts_decode(
        Kt.data_ptr(), V.data_ptr(), ptrs[0], packed["cb"].data_ptr(),
        packed["cln"].data_ptr(), ptrs[1], packed["hcb"].data_ptr(),
        packed["hcln"].data_ptr(), ptrs[2], ptrs[3], ctypes.addressof(prog),
        Y.data_ptr(), A.data_ptr(), ring.data_ptr(),
        len(enc_prog), len(dec_prog), B, N, d, cfg.n_mels, T,
        cfg.attention_win_size, cfg.ln_eps, cmi, cmo, PRECS.index(prec),
        *bases, *lo, stream)
    check(code, f"decode kernel ({prec})")
    fused_decode.launches += 1
    fused_decode.launches_by_prec[prec] += 1
    return Y, A


fused_decode.launches = 0
fused_decode.launches_by_prec = {p: 0 for p in PRECS}
