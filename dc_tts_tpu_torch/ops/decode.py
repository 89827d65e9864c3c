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
runs 24 dependent layer products of a few MFLOP each, so the step is a
latency chain, not a matter of bytes or operations. The design: one
cooperative launch of one persistent 512-thread block per SM, in clusters
of ``CLUSTER`` blocks (``WIDE_CLUSTER`` in the wide kernel; the plan's
``cluster``). Block g owns the columns ``block_columns(W, G, g)`` of
every layer of width W and computes them for all B batch rows, so each
weight is read once a step on the whole card; its slice of the weights
(the transposed slots ``cw_t``, ``hcw_t``, ... below: a column's weights
contiguous) stays in shared memory where ``decode_plan`` finds room, and
streams from L2 otherwise. A product task is ``RG`` rows of a few columns
(of one tap each, for an HC layer), one warp; the lanes split k. At large
B the plan takes the kernel's wide instantiation (``task_rows``, e.g.
B = 72): the float32 and bf16 products take tasks of ``RG_WIDE`` rows,
which halves the serial rounds of the block's warps, and every slice lies
in shared memory, those that find no room staged in turn in one slot, each
copied in by the copy engine while the layer before it exchanges its rows
(``staged``, ``stage_cycle``). The
pre-norm rows are exchanged in one of two ways (``EXCHANGES``; the plan
picks one from B and the widest row, ``decode_plan``). "grid", for large
B: each block writes its columns of the pre-norm rows to a global buffer
and all blocks meet at a grid barrier (one a layer); then each block
normalises the rows ``cluster_rows`` of its cluster rank, one warp a row,
gates them, and stores the layer's output rows into the shared memory of
every block of its cluster, and a cluster barrier closes the layer: the
wider the cluster, the fewer rows a block normalises (at B = 72, 36 rows
over a block's 16 warps in clusters of 2, three in turn for some warps; 9
in the wide kernel's clusters of 8) and the fewer each cluster reads.
"flag", for small B
whose rows all lie in shared memory: each block publishes its columns as
8-byte words of a value and the exchange's epoch, gathers every row,
waiting on each word until it carries the epoch, and normalises every row
into its own copy: one L2 round trip a layer, no barrier, at the cost of
B x the widest row read by every block. The attention row, and under
"flag" every norm, is computed redundantly in every block: the same
arithmetic gives the same bits everywhere. In the wide kernel's clusters of
``WIDE_CLUSTER`` (``attn_split``) each rank computes the attention of its
norm rows alone (``attention_rows``) and stores each row's [ctx; q] into
its cluster's copies, and a cluster barrier closes the phase: 9 rows a
block at B = 72, one round of its warps, not 72 in five, and an eighth of
the keys and values read. An HC layer's three taps are
three products of the current input; each block keeps the older taps'
products of its columns in a ring in a global scratch the wrapper
allocates, so only x_t is read. The activation rows sit in shared memory
up to what it holds, the rest in a per-block global spill; any B runs.
Only the <= win unmasked attention scores are computed: the masked ones
are exactly zero after the softmax.

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
differs from the tensor core's. A column's sum over k in the kernel: lane
l of a warp sums k = 128i + 4l + e in order, the 32 lane sums are added
pairwise over xor distances 16, 8, 4, 2, 1, each of the split's three
products apart and then as (hh + hl) + lh; an HC column adds its taps'
products as ((oldest + middle) + current) + bias. The plain version's
matmuls take their own order; the gates of ``chip_smoke.py`` hold the two
apart (tests/test_torch_decode_plan.py emulates the kernel's order).

``fused_decode`` launches the kernel for CUDA tensors and runs
``fused_decode_plain`` (the same loop in PyTorch) for CPU tensors only.

Phases on the device: every instantiation has a stamped twin, which
``launch_decode`` takes while spans record (``utils/profiling.recording``;
``stamp_buffer``): each block reads the SM clock at the loop's boundaries,
after the barriers and waits that stand there (the last warp's first
thread, which has the least work after them; thread 0 where no barrier
stands), and sums the cycles of each of ``PHASES`` (prologue: the zero
start, the resident slices' loads and the first cluster barrier; product:
the norm parameters' issue, the product, its barrier, the staged slice's
issue and the combine up to the grid barrier's first block barrier, under
"flag" thread 0's combine and publish; exchange: under "grid" the grid
barrier, the staged slice's wait and the closing cluster barrier, under
"flag" the gather; norm: the norms, to warp 0's last row; attention: the
attention row, once a step, under ``attn_split`` with its cluster
barrier). The launch's record buffer goes to
``RECORDER.stamps``, which ``summary()`` reads into ``k1.phase.<phase>``.
Its spans: ``k1.prepare`` (the checks, the plan, the occupancy query, the
layer arrays, the buffers and the memset) and ``k1.launch`` (the library
call).
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Tuple

import torch

from ..dsp.stft import split_bf16
from ..utils.profiling import RECORDER, count, recording, span

NEG_INF = -(2.0 ** 32 - 1.0)

# the decode precisions
PRECS = ("highest", "high3", "hybrid", "default")
# batch rows of one product task (a warp); RG in csrc/decode.cu, and
# RG_WIDE there: the kernel's wide instantiation takes tasks of RG_WIDE
# rows for its float32 and bf16 products where that takes fewer serial
# rounds of its warps (``decode_plan``'s ``task_rows``)
RG = 4
RG_WIDE = 8
# blocks of a cluster, which split the grid exchange's norm rows: CL
# there, the width of every plan but the wide kernel's
CLUSTER = 2
# the wide kernel's (CL_WIDE there): a block's warps normalise B / 8
# rows, one round at B <= 128, where B / 2 took three rounds at B = 72; the
# card holds fewer whole clusters of 8 (120 blocks on the H100, not 132),
# which the wide kernel's products absorb (PERF.md, the cluster sweep)
WIDE_CLUSTER = 8
# warps of a block; NW there
WARPS = 16
# the operand kinds of a layer product, in the kernel's numbering (WK_*)
WKINDS = ("f32", "bf16", "split")
# dynamic shared memory one block may use on the H100, bytes
SMEM_MAX = 232448
# the kernel's copies move 16 bytes (4 float32): a weight slot's depth (a
# tap's inputs) is padded to a multiple of this with zero weights
PAD = 4
# the ways the kernel exchanges a layer's pre-norm rows (decode_plan)
EXCHANGES = ("grid", "flag")
# the flagged exchange's most words (B x the widest pre-norm row) that
# every block gathers a layer: past it the grid exchange is faster on the
# H100 (PERF.md, the B sweep of both exchanges: B <= 2 at base_config)
FLAG_WORDS = 1024
# words of a row of the flagged exchange's buffer: a multiple of a
# 128-byte line
LINE_WORDS = 16
# ints a layer of the program the wrapper hands the kernel; LAYER_INTS
# there
LAYER_INTS = 14
# the phases the stamped twins time, in their record's order (PH_* there)
PHASES = ("prologue", "product", "exchange", "norm", "attention")
# 64-bit words of a block's record: the phases' cycles, the block's cycles,
# its %globaltimer at start and end; STAMP_WORDS there
STAMP_WORDS = len(PHASES) + 3
# a stamped twin's static shared memory (its running record,
# sizeof(StampRecord) there, aligned to 128 bytes), bytes
STAMP_SMEM = 128


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
    # the kernel's copies: each slot transposed, a column's weights
    # contiguous, each tap's depth padded (``kernel_slot``; the plain
    # version and the JAX layout read the others)
    for k in [k for k in specs if k.startswith(("cw", "hcw"))]:
        shape, dtype = specs[k]
        depth = (3 * _up(C, PAD) if k.startswith("hcw")
                 else _up(shape[-2], PAD))
        specs[k + "_t"] = ((*shape[:-2], shape[-1], depth), dtype)
    return specs


def kernel_slot(w: torch.Tensor, taps: int) -> torch.Tensor:
    """The kernel's copy of packed kernels w (..., taps * K, N): transposed
    to (..., N, taps * Kp), a column's weights contiguous, each tap's K
    inputs followed by Kp - K zero weights (Kp = K rounded up to ``PAD``), so
    that every tap starts on a 16-byte boundary."""
    *lead, depth, n = w.shape
    K = depth // taps
    t = w.transpose(-1, -2).reshape(*lead, n, taps, K)
    out = t.new_zeros(*lead, n, taps, _up(K, PAD))
    out[..., :K] = t
    return out.reshape(*lead, n, taps * _up(K, PAD))


def pack_decode_params(cfg, params, prec: str = "highest") -> dict:
    """AudioEnc+AudioDec weights as the decode kernel of ``prec`` reads
    them. "highest": six dense float32 arrays, laid out as
    ``dc_tts_tpu.ops.pallas_decode.pack_decode_params`` lays them: C-layer
    kernels in (max_cin, max_cout) slots, HC kernels (3*C, 2*C) with taps
    oldest first (lags 2r, r, 0). The other precisions change the kernels
    ``cw`` and ``hcw`` as the JAX ``fused_decode`` does before its call:
    "high3" replaces both by their (2, ...) bf16 hi/lo stacks; "hybrid"
    keeps them and adds the hi/lo stacks of AudioDec's slices only, ``cw2``
    and ``hcw2``; "default" replaces both by their bf16 roundings. Each of
    those kernels also comes as ``<key>_t`` (``kernel_slot``: a slot's rows
    are its output columns, each tap's depth zero-padded to ``PAD``), the
    layout the CUDA kernel reads."""
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
    for k in [k for k in packed if k.startswith(("cw", "hcw"))]:
        packed[k + "_t"] = kernel_slot(packed[k], 3 if k.startswith("hcw")
                                       else 1)
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
                       sum_dtype=torch.float32,
                       cursors: torch.Tensor | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's function in PyTorch: a loop over T steps and the
    packed layers, with one ring buffer of 2*rate+1 rows per HC layer.
    ``packed`` is ``pack_decode_params(cfg, params, prec)``; each layer
    product follows ``prec`` (module docstring), as matmuls in ``sum_dtype``
    of the bf16 values (never a bf16 matmul, which would round its result).
    Everything else runs in ``sum_dtype`` too: float64 gives the reference
    that the kernel's float32 sums are measured against on the card. Y and
    A come back in ``sum_dtype``.

    ``cursors`` (B, T) integer, for checks only: the cursor after each step
    is taken from it instead of the argmax of this run's attention row (the
    window of step t starts at ``cursors[:, t - 1]``). Replaying another
    run's cursors (``A.argmax(1)`` of the kernel's A) compares every step
    from the same cursor state; the plain version's own choice at each step
    stays in its A."""
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
        prev = (torch.argmax(a, dim=-1, keepdim=True) if cursors is None
                else cursors[:, t: t + 1].to(device=dev, dtype=torch.long))
        ctx = torch.einsum("bn,bnd->bd", a, V)
        y = torch.sigmoid(run_stack(dec_prog, torch.cat([ctx, q], dim=-1), t,
                                    n_hc_enc, True))
        Y[:, t] = y
        A[:, :, t] = a
    return Y, A


# ---------------------------------------------------------------------------
# wrapper

_ACT = {None: 0, "relu": 1, "sigmoid": 2}


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def layer_width(l: _Layer) -> int:
    """Output columns of a layer's product (an HC layer's two halves)."""
    return 2 * l.cout if l.kind == "HC" else l.cout


def layer_depth(l: _Layer) -> int:
    """k of a layer's product as the kernel lays it out: an HC layer's
    three taps of C each, each tap's depth padded to ``PAD``."""
    return 3 * _up(l.cout, PAD) if l.kind == "HC" else _up(l.cin, PAD)


def layer_wkind(prec: str, dec: bool) -> str:
    """The operands of a layer's product in ``prec`` (one of ``WKINDS``):
    "f32" ("highest", AudioEnc under "hybrid"), "bf16" ("default"),
    "split" (the hi/lo products: "high3", AudioDec under "hybrid")."""
    check_prec(prec)
    if prec == "highest" or (prec == "hybrid" and not dec):
        return "f32"
    return "bf16" if prec == "default" else "split"


def block_columns(width: int, blocks: int, g: int) -> Tuple[int, int]:
    """[c0, c1): the output columns that block g of ``blocks`` owns in a
    layer of ``width`` columns (the kernel's ``columns``)."""
    return g * width // blocks, (g + 1) * width // blocks


def row_groups(B: int, rows: int = RG) -> Tuple[Tuple[int, int], ...]:
    """[r0, r1) of each product task's batch rows, tasks of ``rows`` rows;
    every block computes its columns for all of them."""
    return tuple((r, min(r + rows, B)) for r in range(0, B, rows))


def task_columns(wkind: str) -> int:
    """Virtual columns of a product task (VG in csrc/decode.cu): 4, 2 for
    the split, whose three sums a value take the registers."""
    return 2 if wkind == "split" else 4


def task_rounds(B: int, rows: int, nv: int, wkind: str) -> int:
    """Serial rounds of a block's ``WARPS`` warps over a product of ``nv``
    virtual columns for B rows in tasks of ``rows`` rows."""
    tasks = len(row_groups(B, rows)) * -(-nv // task_columns(wkind))
    return -(-tasks // WARPS)


def cluster_rows(B: int, rank: int, width: int) -> Tuple[int, ...]:
    """The batch rows whose layer norms the block of cluster rank ``rank``
    computes (and stores into every member of its cluster) in clusters of
    ``width``: rank, rank + width, ... (the kernel's ``post``)."""
    return tuple(range(rank, B, width))


def attention_rows(B: int, rank: int, width: int,
                   split: bool) -> Tuple[int, ...]:
    """The batch rows whose attention the block of cluster rank ``rank``
    computes in clusters of ``width``: under the plan's ``attn_split`` its
    norm rows (``cluster_rows``), whose [ctx; q] it stores into every member
    of its cluster (csrc/decode.cu ``attention_split``); else every row."""
    return cluster_rows(B, rank, width) if split else tuple(range(B))


def row_owner(b: int, blocks: int) -> int:
    """The block that writes batch row b of A (and of Y) over ``blocks``
    blocks (the kernel's ``b % gridDim.x``). The blocks are whole clusters,
    so its cluster rank is b % width: one of the blocks that compute row b
    (``attention_rows``, ``cluster_rows``), the one of cluster
    (b / width) % clusters."""
    return b % blocks


def cluster_widths(wide: bool) -> Tuple[int, ...]:
    """The cluster widths the kernel is built at (csrc/decode.cu
    ``decode_instance``): the wide kernel at ``WIDE_CLUSTER`` (its plans')
    and at ``CLUSTER``; every other instantiation at ``CLUSTER``."""
    return (WIDE_CLUSTER, CLUSTER) if wide else (CLUSTER,)


def general_kernel(cfg) -> bool:
    """Whether ``cfg`` needs the kernel's general instantiation (GEN in
    csrc/decode.cu; the grid exchange only): a window of more than 4 keys,
    d > 256, a C layer wider than 512 or an HC layer wider than 256, or
    the C layers' norm parameters off 16-byte boundaries (the widest C
    layer odd)."""
    enc, dec = _programs(cfg)
    cmo = max(l.cout for l in enc + dec if l.kind == "C")
    return (cfg.attention_win_size > 4 or cfg.d > 256 or cmo % 2 == 1
            or any(l.cout > (256 if l.kind == "HC" else 512)
                   for l in enc + dec))


class DecodePlan(NamedTuple):
    """The kernel's partition and shared-memory layout for one launch."""
    blocks: int
    B: int
    exchange: str         # one of EXCHANGES
    xw: int               # floats per activation row
    ldh: int              # floats per pre-norm row
    ldx: int              # elements per row of the exchange buffer
    exchange_bytes: int   # the exchange buffer, both parities
    rows_sh: int          # activation rows in shared memory; the rest spill
    nv_max: int           # most product columns (taps x columns) a block has
    part_off: int         # bytes: the product sums (B x nv_max floats)
    prev_off: int         # bytes: the cursors (B ints)
    ln_off: int           # bytes: a layer's norm parameters
    z_off: int            # bytes: a warp's normalised row (ldh floats)
    nmax: Tuple[int, ...]  # per layer: most columns a block owns
    woff: Tuple[int, ...]  # per layer: bytes to its slice in shared memory
    #                        (resident, or the staging slot), or -1 (L2)
    smem: int             # dynamic shared memory bytes
    ring_floats: int      # per block: its HC columns' tap products
    spill_floats: int     # per block: the activation rows past rows_sh
    barriers_per_step: int
    staged: Tuple[bool, ...]  # per layer: fetched into the slot each step
    stage_off: int        # bytes: the staging slot, or -1 (none)
    stage_bytes: int      # the staging slot's size (0: none)
    sbar_off: int         # bytes: the slot's mbarrier (8), or -1
    task_rows: Tuple[int, ...]  # per layer: rows of a product task
    cluster: int = CLUSTER  # blocks of a cluster
    attn_split: bool = False  # the attention rows split over the cluster's
    #                           ranks: the wide kernel at WIDE_CLUSTER


def staged_rows(B: int, exchange: str, width: int) -> int:
    """Rows of ``ldh`` floats a block stages in shared memory: under
    "grid" one a warp for its cluster rank's rows in clusters of ``width``
    (rank 0 holds the most), under "flag" every row (gathered, normalised
    in place, then applied by every thread)."""
    return (B if exchange == "flag"
            else min(WARPS, len(cluster_rows(B, 0, width))))


def stageable(l: _Layer, wkind: str, ldw: int) -> bool:
    """Whether layer l's slice can be staged: the copy engine moves its
    rows (``layer_depth`` weights) from a slot of pitch ``ldw`` weights
    only in 16-byte multiples."""
    esz = 4 if wkind == "f32" else 2
    return layer_depth(l) * esz % 16 == 0 and ldw * esz % 16 == 0


def slice_bytes(l: _Layer, n: int, wkind: str) -> int:
    """Bytes of a block's slice of ``n`` columns of layer l's slot(s) in
    shared memory (the split's hi and lo halves), 16-byte aligned."""
    return _up(n * layer_depth(l) * (4 if wkind == "f32" else 2)
               * (2 if wkind == "split" else 1), 16)


def decode_plan(cfg, B: int, blocks: int, prec: str = "highest",
                exchange: str | None = None,
                cluster: int | None = None) -> DecodePlan:
    """Where the kernel keeps what, at batch B over ``blocks`` blocks: the
    activation rows first (as many as shared memory holds), then each
    layer's weight slice, in program order, where it still fits (the rest
    stream from L2). Rows and weight slots are padded to ``PAD`` floats
    (``layer_depth``, ``kernel_slot``), so any d, n_mels and layer width
    run; only shared memory (here) and co-residency (``launch_decode``)
    refuse a config.

    The grid exchange's wide kernel, for a config of the common kernel
    (not ``general_kernel``) whose float32 or bf16 products take fewer
    serial rounds of the warps in tasks of ``RG_WIDE`` rows than of ``RG``
    (``task_rounds``: from B = 33 at base_config over 132 blocks), where
    every row and every slice then lies in shared memory: the slices that
    find no room (``staged``, each ``stageable``) share one staging slot,
    laid out with its mbarrier before the rows, into which each is copied
    every step while the layer before it in the cycle of staged layers
    exchanges its rows (csrc/decode.cu). Every other plan keeps the layout
    above, and tasks of ``RG`` rows.

    The cluster width (``cluster`` None): ``WIDE_CLUSTER`` for the wide
    kernel, ``CLUSTER`` for every other; the grid exchange's staging of
    the normalised rows follows it (``staged_rows``). Given a width the
    plan's kernel is not built at (``cluster_widths``), raises ValueError.
    The wide kernel at ``WIDE_CLUSTER`` splits the attention rows over the
    cluster's ranks (``attn_split``, ``attention_rows``); in clusters of
    ``CLUSTER`` a rank's 36 rows at B = 72 took three rounds of its warps
    and K1 did not gain, so every other plan computes every row in every
    block.

    The exchange (``exchange`` None): "flag" where the common kernel takes
    the config (``general_kernel``), every row lies in shared memory and
    every block's gather, B x the widest pre-norm row, is at most
    ``FLAG_WORDS`` words; "grid" otherwise. Given "flag" where it cannot
    run, raises ValueError."""
    if exchange is not None and exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; one of {EXCHANGES}")
    enc, dec = _programs(cfg)
    layers = [(False, l) for l in enc] + [(True, l) for l in dec]
    xw = _up(max(2 * cfg.d, cfg.n_mels), PAD)
    ldh = max(layer_width(l) for _, l in layers)
    nmax = tuple(-(-layer_width(l) // blocks) for _, l in layers)
    nv_max = max((3 if l.kind == "HC" else 1) * n
                 for (_, l), n in zip(layers, nmax))
    cmo = max(l.cout for _, l in layers if l.kind == "C")
    ln_bytes = _up(4 * max(4 * cfg.d, 2 * cmo), 16)

    wkinds = [layer_wkind(prec, is_dec) for is_dec, _ in layers]
    sizes = [slice_bytes(l, n, k)
             for (_, l), n, k in zip(layers, nmax, wkinds)]
    pitch = {"C": _up(max(l.cin for _, l in layers if l.kind == "C"), PAD)}
    can_stage = [stageable(l, k, pitch.get(l.kind, layer_depth(l)))
                 for (_, l), k in zip(layers, wkinds)]

    def layout(exchange, width, slot=0):
        """(staging bytes, bytes before the activation rows, rows in
        shared memory) in clusters of ``width``, with a weight staging slot
        of ``slot`` bytes."""
        z_bytes = _up(4 * ldh * staged_rows(B, exchange, width), 16)
        fixed = (_up(4 * B * nv_max, 16) + _up(4 * B, 16) + ln_bytes
                 + z_bytes + slot)
        return z_bytes, fixed, min(B, max(0, (SMEM_MAX - fixed) // (4 * xw)))

    width = cluster or CLUSTER
    if exchange != "grid":
        flag_fits = not general_kernel(cfg) and layout("flag", width)[2] == B
        if exchange == "flag" and not flag_fits:
            raise ValueError(f"fused_decode: the flagged exchange needs the "
                             f"common kernel and all {B} rows in shared "
                             "memory")
        if exchange is None:
            exchange = ("flag" if flag_fits and B * ldh <= FLAG_WORDS
                        else "grid")
    z_bytes, fixed, rows_sh = layout(exchange, width)
    if fixed > SMEM_MAX:
        raise ValueError(f"fused_decode: B={B} over {blocks} blocks needs "
                         f"{fixed} bytes of shared memory before any "
                         "activation row; take more blocks")

    def place(start):
        """Each slice's offset in program order from ``start`` where it
        still fits, else -1; and the end of the last placed."""
        cur, offs = start, []
        for size in sizes:
            offs.append(cur if cur + size <= SMEM_MAX else -1)
            cur += size if offs[-1] >= 0 else 0
        return offs, cur

    def regions(rows_sh, z_bytes, slot):
        """(part_off, prev_off, ln_off, z_off, stage_off, first free)."""
        part_off = 4 * xw * rows_sh
        prev_off = part_off + _up(4 * B * nv_max, 16)
        ln_off = prev_off + _up(4 * B, 16)
        z_off = ln_off + ln_bytes
        return (part_off, prev_off, ln_off, z_off, z_off + z_bytes,
                z_off + z_bytes + slot)

    *offs, cur = regions(rows_sh, z_bytes, 0)
    woff, cur = place(cur)
    stage_off, slot, staged = -1, 0, [False] * len(layers)
    task_rows = [RG] * len(layers)
    wide = [k != "split" and task_rounds(B, RG_WIDE, v, k)
            < task_rounds(B, RG, v, k)
            for (_, l), n, k in zip(layers, nmax, wkinds)
            for v in [(3 if l.kind == "HC" else 1) * n]]
    if exchange == "grid" and not general_kernel(cfg) and any(wide):
        # the wide kernel: every row and every slice in shared memory, the
        # slices that find no room staged in turn in one slot (with its
        # mbarrier) laid out before the rows; one alone keeps it, resident
        w_slot = 0 if min(woff) >= 0 or not any(can_stage) else max(
            s_ for s_, ok in zip(sizes, can_stage) if ok) + 16
        w_width = cluster or WIDE_CLUSTER
        w_z, w_fixed, w_rows = layout(exchange, w_width, w_slot)
        *w_offs, w_cur = regions(w_rows, w_z, w_slot)
        w_woff, w_cur = place(w_cur)
        w_staged = [o < 0 for o in w_woff]
        if (w_fixed <= SMEM_MAX and w_rows == B and all(
                ok for s_, ok in zip(w_staged, can_stage) if s_)):
            rows_sh, offs, cur, width = w_rows, w_offs, w_cur, w_width
            if w_slot:
                stage_off, slot = offs[-1], w_slot - 16
            woff = [stage_off if s_ else o for s_, o in zip(w_staged, w_woff)]
            staged = w_staged if sum(w_staged) > 1 else [False] * len(layers)
            task_rows = [RG_WIDE if w else RG for w in wide]
    wide_kernel = RG_WIDE in task_rows
    if width not in cluster_widths(wide_kernel):
        raise ValueError(f"fused_decode: the plan's kernel at B={B} is not "
                         f"built in clusters of {width}")
    part_off, prev_off, ln_off, z_off, _ = offs
    ldx = _up(ldh, LINE_WORDS) if exchange == "flag" else ldh
    hc = [n for (_, l), n in zip(layers, nmax) if l.kind == "HC"]
    return DecodePlan(
        blocks=blocks, B=B, exchange=exchange, xw=xw, ldh=ldh, ldx=ldx,
        exchange_bytes=2 * B * ldx * (8 if exchange == "flag" else 4),
        rows_sh=rows_sh, nv_max=nv_max,
        part_off=part_off, prev_off=prev_off, ln_off=ln_off, z_off=z_off,
        nmax=nmax, woff=tuple(woff), smem=cur,
        ring_floats=ring_rows(cfg) * B * max(hc, default=0) * 2,
        spill_floats=(B - rows_sh) * xw,
        barriers_per_step=len(layers) if exchange == "grid" else 0,
        staged=tuple(staged), stage_off=stage_off, stage_bytes=slot,
        sbar_off=stage_off + slot if stage_off >= 0 else -1,
        task_rows=tuple(task_rows), cluster=width,
        attn_split=wide_kernel and width == WIDE_CLUSTER)


# the next launch's first epoch of the flagged exchange
_EPOCH0 = [1]


def next_epoch0(n: int) -> int:
    """The first of the ``n`` epochs of a launch's flagged exchanges, one
    an exchange (``exchange_epoch``): each launch takes the n after the last
    launch's, none 0 (the zeroed buffer's words), below 2**32."""
    e0 = _EPOCH0[0]
    if e0 + n > 2 ** 32:
        e0 = 1
    _EPOCH0[0] = e0 + n
    return e0


def exchange_epoch(epoch0: int, t: int, layer: int, n_layers: int) -> int:
    """The epoch that the flagged exchange of ``layer`` at step ``t``
    carries (the kernel's ``epoch0 + t * nl + li``)."""
    return (epoch0 + t * n_layers + layer) % 2 ** 32


def ring_rows(cfg) -> int:
    """Ring rows per batch row: sum of 2*rate+1 over the HC layers (272 at
    base_config)."""
    enc_prog, dec_prog = _programs(cfg)
    return sum(2 * l.rate + 1 for l in enc_prog + dec_prog if l.kind == "HC")


def stage_cycle(plan: DecodePlan) -> dict:
    """{staged layer: the staged layer whose slice it fetches into the
    staging slot under its exchange}: each the next in program order, the
    last the first (the next step's)."""
    staged = [i for i, s in enumerate(plan.staged) if s]
    return dict(zip(staged, staged[1:] + staged[:1]))


def _layer_arrays(packed: dict, cfg, prec: str, plan: DecodePlan):
    """The layer program as the kernel reads it: ``LAYER_INTS`` ints a
    layer (kind, cin, cout, rate, act, ring_off, wkind, ldw, woff, nmax, kp:
    a tap's depth padded to ``PAD``, lnv: 1 if the norm parameters lie on
    16-byte boundaries at a multiple of 4 floats, fetch: the staged layer
    whose slice it fetches (``stage_cycle``) or -1, rg: its product's task
    rows) and 4 pointers (w, wl, bias, ln), AudioEnc's layers first."""
    enc, dec = _programs(cfg)
    n_c_enc, n_hc_enc = _enc_counts(cfg)
    fetch = stage_cycle(plan)
    ints, ptrs, ring_off = [], [], 0
    for li, (is_dec, l) in enumerate([(False, l) for l in enc]
                                     + [(True, l) for l in dec]):
        hc = l.kind == "HC"
        kind = layer_wkind(prec, is_dec)
        key, idx = ("hcw_t" if hc else "cw_t"), l.idx
        if prec == "hybrid" and is_dec:
            key, idx = key[:-2] + "2_t", idx - (n_hc_enc if hc else n_c_enc)
        w = packed[key]
        hi, lo = (w[0, idx], w[1, idx]) if kind == "split" else (w[idx], None)
        ln = packed["hcln" if hc else "cln"][l.idx]
        lnv = ln.numel() % 4 == 0 and ln.data_ptr() % 16 == 0
        ints += [int(hc), l.cin, l.cout, l.rate, _ACT[l.act], ring_off,
                 WKINDS.index(kind), w.shape[-1], plan.woff[li],
                 plan.nmax[li], layer_depth(l) // (3 if hc else 1), int(lnv),
                 fetch.get(li, -1), plan.task_rows[li]]
        ptrs += [hi.data_ptr(), lo.data_ptr() if lo is not None else None,
                 packed["hcb" if hc else "cb"][l.idx].data_ptr(), ln.data_ptr()]
        ring_off += 2 * l.rate + 1 if hc else 0
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_void_p * len(ptrs))(*ptrs))


def _coresident(smem: int, device, cluster: int) -> Tuple[int, int]:
    from ._build import check, load_library

    blocks, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        check(load_library().dctts_decode_coresident(
            smem, cluster, ctypes.byref(blocks), ctypes.byref(sms)),
            "decode occupancy query")
    return blocks.value, sms.value


def coresident_blocks(smem: int, device, cluster: int = CLUSTER
                      ) -> Tuple[int, int]:
    """(the most blocks of the kernel, in clusters of ``cluster``, with
    ``smem`` bytes of shared memory that fit on ``device`` at once, its
    SMs): the occupancy query, of the instantiation launched at that width,
    that the cooperative launch is checked against."""
    return _coresident(smem, device, cluster)


@functools.lru_cache(maxsize=None)
def decode_blocks(device, cluster: int = CLUSTER) -> int:
    """The kernel's grid on ``device`` in clusters of ``cluster``: one
    block per SM, in whole clusters, as many as fit at once."""
    fits, sms = _coresident(SMEM_MAX, device, cluster)
    return min(sms // cluster * cluster, fits)


@functools.lru_cache(maxsize=64)
def launch_plan(cfg, B: int, prec: str, device, blocks: int | None = None,
                exchange: str | None = None,
                cluster: int | None = None) -> DecodePlan:
    """The plan of a launch at batch B: over ``blocks`` blocks, or (None)
    as many whole clusters of the plan's width as fit on ``device`` at once
    (``decode_blocks``); with ``exchange`` and ``cluster``, or the plan's
    choices (``decode_plan``). Raises ValueError unless the blocks are
    whole clusters of the plan's width; needs the card only for
    ``blocks`` None. Kept per arguments: a chunk's launch plans once (the
    wide kernel's plan is taken twice, over the blocks of each width)."""
    if blocks is None:
        blocks = decode_blocks(device, cluster or CLUSTER)
        plan = decode_plan(cfg, B, blocks, prec, exchange, cluster)
        if plan.cluster != CLUSTER and cluster is None:
            wide = decode_blocks(device, plan.cluster)
            if wide != blocks:
                plan = decode_plan(cfg, B, wide, prec, exchange)
    else:
        plan = decode_plan(cfg, B, blocks, prec, exchange, cluster)
    if plan.blocks < plan.cluster or plan.blocks % plan.cluster:
        raise ValueError(f"fused_decode: {plan.blocks} blocks are not whole "
                         f"clusters of {plan.cluster}")
    return plan


def fused_decode(packed: dict, Kt: torch.Tensor, V: torch.Tensor, T: int,
                 cfg, prec: str = "highest"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole autoregressive decode. Kt/V (B, N, d) float32 ->
    (Y (B, T, n_mels), A (B, N, T)). ``packed`` is ``pack_decode_params(cfg,
    params, prec)``. CUDA tensors launch the kernel over one block per SM
    in whole clusters (``launch_plan``), with the exchange and the cluster
    width ``decode_plan`` picks, and count
    the launch as ``k1.launches``, ``k1.<prec>.launches`` and
    ``k1.<exchange>.launches``, and as ``k1.attn_split.launches`` where the
    plan splits the attention rows (``attn_split``); CPU tensors take
    ``fused_decode_plain``.
    An unknown ``prec`` raises, and so does a packed array of another shape
    or type than ``prec`` reads: nothing is converted quietly."""
    check_prec(prec)
    if Kt.device.type == "cpu":
        return fused_decode_plain(packed, Kt, V, T, cfg, prec)
    if Kt.device.type != "cuda":
        raise ValueError(f"fused_decode: unsupported device {Kt.device}")
    return launch_decode(packed, Kt, V, T, cfg, prec)


def kernel_name(cfg, plan: DecodePlan) -> str:
    """The instantiation ``plan``'s launch takes (csrc/decode.cu
    ``decode_instance``): "flag", "general", "wide" (wide tasks or staged
    slices) or "common"."""
    if plan.exchange == "flag":
        return "flag"
    if general_kernel(cfg):
        return "general"
    return ("wide" if RG_WIDE in plan.task_rows or any(plan.staged)
            else "common")


def instance_label(function: str) -> str | None:
    """"<kernel> CL<width>", with " stamped" for a stamped twin, of a
    ``decode_kernel`` instantiation's mangled name (as ptxas reports it,
    ``_build.ptxas_report``; also from before the twins, whose names lack
    the STAMP argument); None for another function."""
    m = re.search(r"decode_kernelILb([01])ELb([01])ELb([01])ELi(\d+)E"
                  r"(?:Lb([01])E)?", function)
    if m is None:
        return None
    gen, flag, wide, width, stamp = m.groups()
    kernel = ("flag" if flag == "1" else "general" if gen == "1"
              else "wide" if wide == "1" else "common")
    return f"{kernel} CL{width}" + (" stamped" if stamp == "1" else "")


def stamp_buffer(plan: DecodePlan, device) -> torch.Tensor | None:
    """The record buffer of the launch's stamped twin (``plan.blocks`` x
    ``STAMP_WORDS`` int64, written whole by the kernel), or None for the
    unstamped kernel: None unless spans record (``recording()``) and the
    plan leaves the twin's ``STAMP_SMEM`` bytes of shared memory."""
    if not recording() or plan.smem + STAMP_SMEM > SMEM_MAX:
        return None
    return torch.empty(plan.blocks, STAMP_WORDS, dtype=torch.int64,
                       device=device)


def launch_decode(packed: dict, Kt: torch.Tensor, V: torch.Tensor, T: int,
                  cfg, prec: str = "highest", blocks: int | None = None,
                  exchange: str | None = None, cluster: int | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_decode``'s launch on CUDA tensors, over ``blocks`` blocks
    in clusters of ``cluster``, with ``exchange`` (``launch_plan``'s choices
    where None; ``cluster`` is given by tests and the smoke only). Raises,
    before launching, if the blocks are not whole clusters, the grid cannot
    be co-resident or the exchange cannot run. While spans record, the
    stamped twin (``stamp_buffer``), its record kept by ``RECORDER``."""
    from ._build import check, load_library

    with span("k1.prepare"):
        B, N, d = Kt.shape
        for x in (Kt, V):
            if x.device != Kt.device or x.dtype != torch.float32 \
                    or not x.is_contiguous() or x.device.type != "cuda":
                raise ValueError("fused_decode: Kt and V must be contiguous "
                                 "float32 tensors on one CUDA device")
        if V.shape != Kt.shape or d != cfg.d:
            raise ValueError(f"fused_decode: Kt {tuple(Kt.shape)} / V "
                             f"{tuple(V.shape)} do not match d={cfg.d}")
        _check_packed(packed, cfg, prec, Kt.device)
        enc_prog, dec_prog = _programs(cfg)
        plan = launch_plan(cfg, B, prec, Kt.device, blocks, exchange,
                           cluster)
        blocks = plan.blocks
        fits, _ = coresident_blocks(plan.smem, Kt.device, plan.cluster)
        if blocks > fits:
            raise RuntimeError(f"fused_decode: {blocks} blocks of "
                               f"{plan.smem} bytes cannot be co-resident "
                               f"({fits} can)")
        ints, ptrs = _layer_arrays(packed, cfg, prec, plan)
        dev = Kt.device
        Y = torch.empty(B, T, cfg.n_mels, device=dev)
        A = torch.empty(B, N, T, device=dev)
        flag = plan.exchange == "flag"
        # one memset either way: the flagged exchange's words (0 is no
        # epoch), or the grid barrier's counter
        if flag:
            hbuf, bar = exchange_buffer(plan, dev), None
            epoch0 = next_epoch0(T * len(plan.nmax))
        else:
            hbuf = torch.empty(2, B, plan.ldh, device=dev)
            bar, epoch0 = torch.zeros(1, dtype=torch.int32, device=dev), 0
        ring = torch.empty(max(1, blocks * plan.ring_floats), device=dev)
        spill = torch.empty(max(1, blocks * plan.spill_floats), device=dev)
        stamps = stamp_buffer(plan, dev)
        cmo = packed["cb"].shape[-1]
        stream = torch.cuda.current_stream(dev).cuda_stream
    with span("k1.launch"):
        code = load_library().dctts_decode(
            Kt.data_ptr(), V.data_ptr(), Y.data_ptr(), A.data_ptr(),
            hbuf.data_ptr(), ring.data_ptr(), spill.data_ptr(),
            None if bar is None else bar.data_ptr(),
            ctypes.addressof(ints), ctypes.addressof(ptrs), len(enc_prog),
            len(dec_prog), B, N, d, cfg.n_mels, T, cfg.attention_win_size,
            cfg.ln_eps, cmo, plan.xw, plan.ldh,
            plan.rows_sh, plan.ring_floats, plan.spill_floats, plan.part_off,
            plan.prev_off, plan.ln_off, plan.z_off, plan.nv_max, plan.smem,
            blocks, plan.cluster, int(flag), plan.ldx,
            min(stage_cycle(plan), default=-1), plan.sbar_off, epoch0,
            None if stamps is None else stamps.data_ptr(), stream)
    check(code, f"decode kernel ({prec}, {plan.exchange} exchange)")
    if stamps is not None:
        RECORDER.stamps("k1", PHASES, stamps, kernel=kernel_name(cfg, plan),
                        exchange=plan.exchange, cluster=plan.cluster,
                        blocks=blocks, B=B)
    for name in ("k1", f"k1.{prec}", f"k1.{plan.exchange}"):
        count(name + ".launches")
    if plan.attn_split:
        count("k1.attn_split.launches")
    return Y, A


def exchange_buffer(plan: DecodePlan, device) -> torch.Tensor:
    """The flagged exchange's words, zeroed: both parities of B rows of
    ``ldx`` 8-byte words {value, epoch} (int32 pairs)."""
    return torch.zeros(plan.exchange_bytes // 4, dtype=torch.int32,
                       device=device)
