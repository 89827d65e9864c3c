"""Kernel K1: the whole Text2Mel decode loop in one launch.

Replaces ``dc_tts_tpu/ops/pallas_decode.py:fused_decode`` (kernel body
``_decode_kernel``). Same function, at ``prec="highest"``: T steps, each
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

``fused_decode`` launches the kernel for CUDA tensors and runs
``fused_decode_plain`` (the same loop in PyTorch) for CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

NEG_INF = -(2.0 ** 32 - 1.0)

# batch rows per thread block; must equal DECODE_ROWS in csrc/decode.cu
ROWS = 4


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


def pack_decode_params(cfg, params) -> dict:
    """AudioEnc+AudioDec weights packed into six dense float32 arrays, laid
    out as ``dc_tts_tpu.ops.pallas_decode.pack_decode_params`` lays them:
    C-layer kernels in (max_cin, max_cout) slots, HC kernels (3*C, 2*C) with
    taps oldest first (lags 2r, r, 0)."""
    enc_prog, dec_prog = _programs(cfg)
    layers = list(enc_prog) + list(dec_prog)
    c_layers = [l for l in layers if l.kind == "C"]
    n_hc = len(layers) - len(c_layers)
    c_max_in = max(l.cin for l in c_layers)
    c_max_out = max(l.cout for l in c_layers)
    C = cfg.d
    dev = params["audio_enc"][0]["conv"]["w"].device

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    cw, cb, cln = (z(len(c_layers), c_max_in, c_max_out),
                   z(len(c_layers), c_max_out), z(len(c_layers), 2, c_max_out))
    hcw, hcb, hcln = z(n_hc, 3 * C, 2 * C), z(n_hc, 2 * C), z(n_hc, 4, C)
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
    return {"cw": cw, "cb": cb, "cln": cln,
            "hcw": hcw, "hcb": hcb, "hcln": hcln}


# ---------------------------------------------------------------------------
# plain version


def _ln(x, gamma, beta, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def fused_decode_plain(packed: dict, Kt: torch.Tensor, V: torch.Tensor,
                       T: int, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's function in PyTorch: a loop over T steps and the
    packed layers, with one ring buffer of 2*rate+1 rows per HC layer."""
    enc_prog, dec_prog = _programs(cfg)
    B, N, d = Kt.shape
    dev = Kt.device
    eps = cfg.ln_eps
    cw, cb, cln = packed["cw"], packed["cb"], packed["cln"]
    hcw, hcb, hcln = packed["hcw"], packed["hcb"], packed["hcln"]
    rings = [torch.zeros(2 * l.rate + 1, B, l.cout, device=dev)
             for l in enc_prog + dec_prog if l.kind == "HC"]

    def run_stack(prog, x, t, ring_base):
        ri = ring_base
        for l in prog:
            if l.kind == "C":
                h = x @ cw[l.idx, : l.cin, : l.cout] + cb[l.idx, : l.cout]
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
            h = taps @ hcw[l.idx] + hcb[l.idx]
            g = torch.sigmoid(_ln(h[:, : l.cout], hcln[l.idx, 0],
                                  hcln[l.idx, 1], eps))
            h2 = _ln(h[:, l.cout:], hcln[l.idx, 2], hcln[l.idx, 3], eps)
            x = g * h2 + (1.0 - g) * x
        return x

    n_enc_hc = sum(1 for l in enc_prog if l.kind == "HC")
    pos = torch.arange(N, device=dev)[None, :]
    prev = torch.zeros(B, 1, dtype=torch.long, device=dev)
    y = torch.zeros(B, cfg.n_mels, device=dev)
    Y = torch.empty(B, T, cfg.n_mels, device=dev)
    A = torch.empty(B, N, T, device=dev)
    for t in range(T):
        q = run_stack(enc_prog, y, t, 0)
        scores = torch.einsum("bnd,bd->bn", Kt, q) * (d ** -0.5)
        disallowed = (pos < prev) | (pos >= prev + cfg.attention_win_size)
        a = torch.softmax(torch.where(disallowed, NEG_INF, scores), dim=-1)
        prev = torch.argmax(a, dim=-1, keepdim=True)
        ctx = torch.einsum("bn,bnd->bd", a, V)
        y = torch.sigmoid(run_stack(dec_prog, torch.cat([ctx, q], dim=-1), t,
                                    n_enc_hc))
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
                 cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole autoregressive decode. Kt/V (B, N, d) float32 ->
    (Y (B, T, n_mels), A (B, N, T)). CUDA tensors launch the kernel (and
    count the launch); CPU tensors take ``fused_decode_plain``."""
    if Kt.device.type == "cpu":
        return fused_decode_plain(packed, Kt, V, T, cfg)
    if Kt.device.type != "cuda":
        raise ValueError(f"fused_decode: unsupported device {Kt.device}")
    from ._build import check, load_library

    B, N, d = Kt.shape
    tensors = [Kt, V] + [packed[k] for k in ("cw", "cb", "cln",
                                             "hcw", "hcb", "hcln")]
    for x in tensors:
        if x.device != Kt.device or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError("fused_decode: every input must be a contiguous "
                             "float32 tensor on one CUDA device")
    if V.shape != Kt.shape or d != cfg.d:
        raise ValueError(f"fused_decode: Kt {tuple(Kt.shape)} / V "
                         f"{tuple(V.shape)} do not match d={cfg.d}")
    enc_prog, dec_prog = _programs(cfg)
    prog = _program_array(enc_prog, dec_prog)
    lib = load_library()
    Y = torch.empty(B, T, cfg.n_mels, device=Kt.device)
    A = torch.empty(B, N, T, device=Kt.device)
    ring = torch.empty(-(-B // ROWS) * ROWS, ring_rows(cfg), d,
                       device=Kt.device)
    cw = packed["cw"]
    stream = torch.cuda.current_stream(Kt.device).cuda_stream
    code = lib.dctts_decode(
        *[x.data_ptr() for x in tensors], ctypes.addressof(prog),
        Y.data_ptr(), A.data_ptr(), ring.data_ptr(),
        len(enc_prog), len(dec_prog), B, N, d, cfg.n_mels, T,
        cfg.attention_win_size, cfg.ln_eps, cw.shape[1], cw.shape[2], stream)
    check(code, "decode kernel")
    fused_decode.launches += 1
    return Y, A


fused_decode.launches = 0
