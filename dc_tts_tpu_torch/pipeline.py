"""Batched synthesis on one GPU: text -> mel -> linear spectrogram ->
waveform, the port of ``dc_tts_tpu/pipeline.py``'s single-device path.

The chain per batch: TextEnc -> the T-step autoregressive decode (kernel K1
in the default "fused" mode, in precision ``decode_prec``; "incremental"
and "reference" are plain torch) -> SSRN -> denormalize -> Griffin-Lim
(``cfg.stft_method``: kernel K2 under the default "dft_pallas2", kernel K3
under "dft_pallas", plain torch transforms otherwise) -> de-emphasis ->
optional 16-bit PCM quantisation on the device. Every step is enqueued on
the current CUDA stream; the host waits for the device only in a batch's
ids upload and in the copy back, which ``synthesize_ids_chunked`` overlaps
with the next chunk.

The parallel modes run on ``torch.distributed``, one device a rank
(``parallel/``): ``Synthesizer(mesh=)`` splits each batch's rows over the
data axis, every rank running the whole single-device chain on its own
rows (the JAX package's ``shard_map``), and gathers the outputs in row
order; ``synthesize_time_sharded`` decodes on rank 0 and shards SSRN and
Griffin-Lim over time; ``PipelinedSynthesizer`` decodes on one half of the
ranks and vocodes on the other, microbatch after microbatch.

SSRN's conv matmuls take ``ssrn_precision`` in synthesis, as in the JAX
package: "high" (the default: the 3-pass bf16 hi/lo split, the config's
``compute_dtype="float32_high"``; on the card each block runs kernel K5
around its products, the weight halves split once when the synthesizer is
built), "highest" (the config as given) or
"bf16" (``compute_dtype="bfloat16"``). The decode kernel's layer products
take ``decode_prec`` (``ops.decode.PRECS``): "highest" (the default, float32),
"hybrid" (AudioEnc float32, AudioDec the 3-pass split), "high3" (the split
everywhere) or "default" (one bf16 pass). The reduced ones are opt-in: at
random init their rounding flips attention cursors (argmax ties of a
diffuse attention), as the JAX package measured; TextEnc stays float32.

On the card the Synthesizer runs TextEnc as one captured CUDA graph a batch
shape (``text_encode_graphs``): at one sentence a call its ~360 eager
launches took longer on the host than the encoder takes on the device, and
the decode kernel, which needs its K and V, waited for them. The graph
holds the call synthesis makes, each block's tail one launch of K5's
epilogue (``models/text2mel.takes_k5``): the embedding, each block's taps,
product and epilogue, then K and V's copies, 65 kernels at 72 sentences
and 78 at one (386 and 399 with the eager tails).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from . import text as text_mod
from .config import Config
from .device import resolve_device
from .dsp.features import trim_silence
from .dsp.griffin_lim import spectrogram_to_wav
from .models.ssrn import SSRN
from .models.text2mel import Text2Mel
from .ops.decode import check_prec, pack_decode_params
from .params import to_device
from .parallel import distributed as D
from .train.optimizer import tree_leaves
from .utils.profiling import count, span

DECODE_MODES = ("fused", "incremental", "reference")
# ssrn_precision -> the compute_dtype SSRN runs under (None: the config's)
SSRN_PRECISIONS = {"highest": None, "high": "float32_high",
                   "bf16": "bfloat16"}


def _ssrn(cfg: Config, ssrn_precision: str) -> SSRN:
    """SSRN under a synthesis ``ssrn_precision``."""
    if ssrn_precision not in SSRN_PRECISIONS:
        raise ValueError(f"ssrn_precision={ssrn_precision!r}; use one "
                         f"of {tuple(SSRN_PRECISIONS)}")
    dtype = SSRN_PRECISIONS[ssrn_precision]
    return SSRN(cfg if dtype is None else cfg.replace(compute_dtype=dtype))


def _pad_rows(ids: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the batch up to a multiple with PAD(0) rows (they decode garbage
    and are sliced off by the caller)."""
    ids = np.asarray(ids)
    padded = -(-ids.shape[0] // multiple) * multiple
    if padded == ids.shape[0]:
        return ids
    return np.concatenate(
        [ids, np.zeros((padded - ids.shape[0], ids.shape[1]), ids.dtype)])


# batch shapes whose TextEnc graph the Synthesizer keeps: a chunk size, its
# tail and single requests, with room to spare
TEXTENC_GRAPHS = 4


class GraphCache:
    """``fn(x)`` -> a tuple of tensors, replayed from one captured CUDA graph
    a shape of ``x``; the ``capacity`` shapes used last are kept, the least
    recently used evicted. Captures and replays are counted as
    ``<prefix>.captures`` and ``<prefix>.replays``.

    A shape's first call runs ``fn`` once eagerly on a side stream (cuBLAS
    picks its algorithms and allocates its workspace there), then captures
    it into a graph with a memory pool of its own; every call copies ``x``
    into the graph's static input and replays it on the current stream. The
    outputs are the graph's static tensors, overwritten by the shape's next
    replay."""

    def __init__(self, fn, capacity: int, prefix: str):
        self.fn, self.capacity, self.prefix = fn, capacity, prefix
        self.graphs: OrderedDict = OrderedDict()  # shape -> (x, graph, outs)

    def __call__(self, x: torch.Tensor):
        key = tuple(x.shape)
        entry = self.graphs.get(key)
        if entry is None:
            while len(self.graphs) >= self.capacity:
                self.graphs.popitem(last=False)
            entry = self.graphs[key] = self._capture(x)
            count(self.prefix + ".captures")
        else:
            self.graphs.move_to_end(key)
        static_x, graph, outs = entry
        static_x.copy_(x)
        graph.replay()
        count(self.prefix + ".replays")
        return outs

    def _capture(self, x: torch.Tensor):
        static_x = x.clone()
        here = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.fn(static_x)
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # "thread_local": only this thread's calls are held to the capture's
        # rules, so another thread's CUDA calls (the profiler's, a loader's)
        # neither fail it nor are failed by it
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = self.fn(static_x)
        return static_x, graph, outs


def text_encode_graphs(text2mel: Text2Mel, params) -> GraphCache:
    """Inference TextEnc on the card, ids (B, N) -> (K, V) contiguous, from
    a ``GraphCache`` of ``TEXTENC_GRAPHS`` batch shapes (the encoder of
    ``text2mel.text_encode(params, ids)`` with gradients off: the same
    kernels, bit for bit, K5's epilogue among them). Its counters are
    ``textenc.graph.captures`` and ``.replays``; ``k5.textenc.launches``
    counts the epilogue while a shape is captured, never in a replay."""

    @torch.no_grad()
    def encode(ids):
        Kt, V = text2mel.text_encode(params, ids)
        return Kt.contiguous(), V.contiguous()

    return GraphCache(encode, TEXTENC_GRAPHS, "textenc.graph")


def _replicate(trees, src: int, group) -> None:
    """The same parameter values on every rank of ``group``: global rank
    ``src``'s (the JAX package's contract, "the same value on every
    process", made true rather than assumed)."""
    D.broadcast_([t for tree in trees for t in tree_leaves(tree)], src,
                 group)


class Synthesizer:
    """Both networks' parameters on one device, and the synthesis chain.

    device defaults to "cuda" and raises when there is no CUDA device;
    pass device="cpu" to run the plain PyTorch versions on the CPU.
    decode_mode "auto" is the fused decode kernel. ssrn_precision and
    decode_prec: see the module docstring; decode_prec is read by the fused
    mode only, as in the JAX package.

    With a ``mesh`` (``parallel.make_mesh``) this rank synthesizes its
    rows of every batch, padded with PAD rows to a multiple of the data
    axis, and every rank returns the whole batch. The parameters are rank
    0's of the data axis, broadcast here.

    On CUDA, TextEnc runs from ``text_encode_graphs``: a graph captured at
    the first call of each batch shape (a warm-up call of the shape takes
    the capture out of later timing)."""

    def __init__(self, cfg: Config, t2m_params, ssrn_params, *,
                 device="cuda", mesh=None, decode_mode: str = "auto",
                 pcm16: bool = False, ssrn_precision: str = "high",
                 decode_prec: str = "highest"):
        self.ssrn = _ssrn(cfg, ssrn_precision)
        check_prec(decode_prec)
        if decode_mode == "auto":
            decode_mode = "fused"
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode={decode_mode!r}; use one of "
                             f"{('auto',) + DECODE_MODES}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.text2mel = Text2Mel(cfg)
        self.t2m_params = to_device(t2m_params, self.device)
        self.ssrn_params = to_device(ssrn_params, self.device)
        if mesh is not None:
            if mesh.coords is None:
                raise ValueError("this rank lies outside the mesh")
            _replicate((self.t2m_params, self.ssrn_params),
                       mesh.ranks["data"][0], mesh.groups["data"])
        self.mesh = mesh
        self.decode_mode = decode_mode
        self.decode_prec = decode_prec
        self.pcm16 = pcm16
        # the decode kernel's weights packed for decode_prec (~29 MB at
        # base_config), made once here rather than on every batch
        self.packed = None
        if decode_mode == "fused":
            self.packed = pack_decode_params(cfg, self.t2m_params,
                                             decode_prec)
        # SSRN's kernel halves for K5 (~120 MB at base_config), split once
        # here rather than on every batch; None under ssrn_precision other
        # than "high"
        self.ssrn_packed = self.ssrn.pack(self.ssrn_params)
        # synthesize_ids_chunked's pinned staging pair, (bytes, event) a
        # slot, and the chunk whose copy back is pending: (event, slot, rows)
        self._staging, self._staging_bytes = [], 0
        self._pending = None
        self.text_encoder = None
        if self.device.type == "cuda":
            self.text_encoder = text_encode_graphs(self.text2mel,
                                                   self.t2m_params)

    @classmethod
    def from_checkpoints(cls, cfg: Config, logdir1: str, logdir2: str,
                         **kw) -> "Synthesizer":
        """Text2Mel from logdir1 and SSRN from logdir2 (either package's
        checkpoints); ``kw`` as the constructor's."""
        t2m_params, ssrn_params = restore_synthesis_params(cfg, logdir1,
                                                           logdir2)
        return cls(cfg, t2m_params, ssrn_params, **kw)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _synthesize_rows(self, ids):
        ids = np.asarray(ids)
        with span("synth.rows", n=ids.shape[0]):
            ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
            with span("text2mel"):
                # K and V are the graph's outputs, which the next call's
                # replay overwrites: every consumer (K1, or the step loop)
                # is enqueued on this stream before that replay
                Y, align = self.text2mel.decode(
                    self.t2m_params, ids, mode=self.decode_mode,
                    prec=self.decode_prec, packed=self.packed,
                    text_encoder=self.text_encoder)
            # the chunk before's copy back, while the card decodes this one
            self._drain()
            with span("ssrn"):
                _, Z = self.ssrn.apply(self.ssrn_params, Y,
                                       packed=self.ssrn_packed)
            with span("vocoder"):
                wav = spectrogram_to_wav(Z, self.cfg)
                if self.pcm16:
                    wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0
                                      ).to(torch.int16)
            return wav, Y, Z, align

    def _my_rows(self, ids) -> np.ndarray:
        """This rank's rows of a batch padded to the data axis."""
        nd, i = self.mesh.shape["data"], self.mesh.coords["data"]
        ids = _pad_rows(ids, nd)
        b = ids.shape[0] // nd
        return ids[i * b: (i + 1) * b]

    def _gather(self, t: torch.Tensor, B: int) -> torch.Tensor:
        return D.all_gather_cat(t, self.mesh.groups["data"])[:B]

    def synthesize_ids(self, ids):
        """ids (B, max_N) int -> (wavs (B, n_samples), Y, Z, align), all on
        the device; wavs are int16 when pcm16 is set. Spans as
        ``synthesize_ids_chunked``'s, without the copy to the host."""
        with span("synth.call"):
            if self.mesh is None:
                return self._synthesize_rows(ids)
            B = np.asarray(ids).shape[0]
            return tuple(self._gather(o, B)
                         for o in self._synthesize_rows(self._my_rows(ids)))

    def synthesize_ids_chunked(self, ids, chunk: int = 40) -> np.ndarray:
        """Any batch size, in chunks of ``chunk`` rows -> wavs (B, n_samples)
        on the host, an array of the caller's own. Under a mesh the chunk is
        first rounded up to a multiple of the data axis.

        On the card each chunk's waveform is copied, non-blocking, into one
        slot of a pinned staging pair that the Synthesizer keeps (grown to
        the largest chunk seen; each pinned allocation counted as
        ``to_host.staging.allocs``), and an event is recorded after the
        copy. The next chunk's rows, once its decode is enqueued, wait for
        that event and copy the slot into its rows of the output while the
        card decodes; after the last chunk the host waits for that one. So
        a caller that waits for each chunk (one that reads a chunk's
        outputs) waits for no copy. The host's one other wait a chunk is
        the ids' upload at its start. Under a mesh every chunk is enqueued
        before the first gather, as the gathers are collectives, and each
        chunk is copied back after the next one's gather. On the CPU each
        chunk is copied into its rows directly.

        Spans (``utils/profiling``): ``synth.call`` around the call, the
        tree's root; in it ``synth.rows`` a chunk (``n`` its rows), which
        holds ``text2mel`` (``Text2Mel.decode``'s ``text2mel.text_encode``
        and ``text2mel.decode``), ``ssrn`` and ``vocoder`` (``vocoder.
        griffin_lim``, then de-emphasis and pcm16 in its self time). On the
        card the copy back, in ``synth.to_host`` spans: ``to_host.pin``
        (obtaining a staging slot) after each chunk, then for each chunk
        ``to_host.wait`` (the host waiting for its copy) and
        ``to_host.cat`` (its slot copied into the output), in the next
        chunk's ``synth.rows`` or after the last."""
        ids = np.asarray(ids)
        if self.mesh is not None:
            nd = self.mesh.shape["data"]
            chunk = -(-chunk // nd) * nd
        parts = [ids[i: i + chunk] for i in range(0, ids.shape[0], chunk)]
        with span("synth.call"):
            if self.mesh is None:
                wavs = (self._synthesize_rows(p)[0] for p in parts)
            else:
                # every chunk enqueued before the first gather waits on one
                local = [self._synthesize_rows(self._my_rows(p))[0]
                         for p in parts]
                wavs = (self._gather(w, len(p))
                        for w, p in zip(local, parts))
            return self._copy_back(wavs, ids.shape[0])

    def _copy_back(self, wavs, B: int) -> np.ndarray:
        """The chunks' device waveforms, in row order, -> (B, n_samples) on
        the host, each chunk's copy left pending for the next chunk's rows
        to finish (``synthesize_ids_chunked``)."""
        out, row = None, 0
        try:
            for k, w in enumerate(wavs):
                if out is None:
                    out = torch.empty((B, *w.shape[1:]), dtype=w.dtype)
                dst = out[row: row + w.shape[0]]
                row += w.shape[0]
                if self.device.type != "cuda":
                    dst.copy_(w)
                    continue
                with span("synth.to_host"):
                    with span("to_host.pin"):
                        slot, event = self._staging_slot(k % 2, w)
                    slot.copy_(w, non_blocking=True)
                    event.record(torch.cuda.current_stream(self.device))
                # the chunk before's, if this chunk's rows did not take it
                # (a mesh's gathers synthesize no rows)
                self._drain()
                self._pending = event, slot, dst
            self._drain()
        finally:
            self._pending = None
        return out.numpy()

    def _drain(self) -> None:
        """The pending chunk's copy back, if any: wait for its copy into its
        staging slot, then copy the slot into its rows of the output."""
        if self._pending is None:
            return
        event, slot, dst = self._pending
        self._pending = None
        with span("synth.to_host"):
            with span("to_host.wait"):
                event.synchronize()
            with span("to_host.cat"):
                dst.copy_(slot)

    def _staging_slot(self, i: int, w: torch.Tensor):
        """Slot ``i`` of the pinned staging pair as a tensor shaped like
        ``w``, and the slot's event. Both slots are reallocated when ``w``
        outgrows them; a copy still pending keeps its old slot alive."""
        nbytes = w.numel() * w.element_size()
        if nbytes > self._staging_bytes:
            self._staging = [(torch.empty(nbytes, dtype=torch.uint8,
                                          pin_memory=True),
                              torch.cuda.Event()) for _ in range(2)]
            self._staging_bytes = nbytes
            count("to_host.staging.allocs", 2)
        buf, event = self._staging[i]
        return buf[:nbytes].view(w.dtype).view(w.shape), event

    def synthesize(self, sentences: Sequence[str], *, trim: bool = True):
        """Raw sentences -> list of float32 waveforms (host, trimmed)."""
        ids = text_mod.encode_batch(list(sentences), self.cfg)
        wavs = self.synthesize_ids(ids)[0].cpu().numpy()
        if wavs.dtype == np.int16:
            wavs = wavs.astype(np.float32) / 32767.0
        if trim:
            return [trim_silence(w) for w in wavs]
        return list(wavs)


@torch.no_grad()
def synthesize_time_sharded(cfg: Config, t2m_params, ssrn_params, ids, *,
                            n_shards: int = 0, decode_mode: str = "fused",
                            device="cuda"):
    """Sequence-parallel synthesis: shard the TIME axis, not utterances.

    Rank 0 decodes the batch (the autoregressive loop has no time
    parallelism; kernel K1 at "highest" in the fused mode), scatters Y's
    time slices to the ranks of an ``n_shards`` mesh (default all ranks),
    which run SSRN in float32 and the Griffin-Lim loop time-sharded with
    halo exchanges (``parallel/sp.py``, ``parallel/sp_gl.py``): the
    long-utterance latency axis that per-utterance data parallelism cannot
    cover. cfg.max_T must divide by the shard count and each Griffin-Lim
    shard must exceed the overlap halo (``griffin_lim_sp``). Every rank of
    the world calls it with the same ids; the mesh's ranks return (wav (B,
    samples), Y, Z, align), the whole batch on each, and a rank the mesh
    leaves out returns None."""
    from .parallel.mesh import make_mesh
    from .parallel.sp import ssrn_apply_sp
    from .parallel.sp_gl import time_sharded_vocoder

    n = n_shards or D.world()[1]
    if cfg.max_T % n:
        raise ValueError(
            f"--time-shard {n} must divide the frame grid: max_T="
            f"{cfg.max_T} (and max_T*r={cfg.max_T * cfg.r} GL frames)")
    mesh = make_mesh(data=n, model=1)
    if mesh.coords is None:
        return None
    dev = resolve_device(device)
    group, root = mesh.groups["data"], mesh.ranks["data"][0]
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    B = ids.shape[0]
    parts = align = None
    if mesh.coords["data"] == 0:
        Y, align = Text2Mel(cfg).decode(to_device(t2m_params, dev), ids,
                                        mode=decode_mode)
        parts = list(Y.split(cfg.max_T // n, dim=1))
    else:
        align = torch.empty(B, ids.shape[1], cfg.max_T, device=dev)
    Y_local = D.scatter(torch.empty(B, cfg.max_T // n, cfg.n_mels,
                                    device=dev), parts, root, group)
    ssrn_params = to_device(ssrn_params, dev)
    _replicate((ssrn_params,), root, group)
    Z_local = ssrn_apply_sp(cfg, ssrn_params, Y_local, mesh)
    wav = time_sharded_vocoder(Z_local, cfg, mesh)
    D.broadcast_([align], root, group)
    return (wav, D.all_gather_cat(Y_local, group, dim=1),
            D.all_gather_cat(Z_local, group, dim=1), align)


class PipelinedSynthesizer:
    """Pipeline-parallel batched synthesis over two groups of ranks.

    Stage 1 (Text2Mel's decode, kernel K1) runs on ranks [0, h), h = world
    // 2, stage 2 (SSRN at ``ssrn_precision``, then Griffin-Lim, kernel K2
    by default) on ranks [h, world). Each microbatch's rows are split over
    each stage's ranks; Y's rows go from stage 1 to stage 2 by non-blocking
    sends, so stage 1 decodes microbatch i+1 while stage 2 vocodes
    microbatch i. The generalisation of the reference's two-GPU split of
    the two networks. Every rank of the world constructs it and calls
    ``synthesize_ids`` with the same ids."""

    def __init__(self, cfg: Config, t2m_params, ssrn_params, *,
                 microbatch: int = 8, ssrn_precision: str = "high",
                 device="cuda"):
        from .parallel.mesh import make_mesh

        rank, n = D.world()
        if n < 2:
            raise ValueError("the pipeline needs >= 2 ranks")
        half, other = n // 2, n - n // 2
        if microbatch % half or microbatch % other:
            raise ValueError(
                f"--microbatch {microbatch} must be divisible by both "
                f"stage sizes ({half} and {other} of {n} ranks)")
        self.cfg = cfg
        self.microbatch = microbatch
        self.device = resolve_device(device)
        self.mesh1 = make_mesh(data=half, ranks=range(half))
        self.mesh2 = make_mesh(data=other, ranks=range(half, n))
        self.stage = 1 if rank < half else 2
        if self.stage == 1:
            self.t2m_params = to_device(t2m_params, self.device)
            _replicate((self.t2m_params,), 0, self.mesh1.groups["data"])
            self.packed = pack_decode_params(cfg, self.t2m_params, "highest")
        else:
            self.ssrn = _ssrn(cfg, ssrn_precision)
            self.ssrn_params = to_device(ssrn_params, self.device)
            _replicate((self.ssrn_params,), half, self.mesh2.groups["data"])
            self.ssrn_packed = self.ssrn.pack(self.ssrn_params)

    def _routes(self, j: int, k: int):
        """Rows [lo, hi) of a microbatch that stage-1 rank j decodes and
        stage-2 rank k vocodes (empty when they share none)."""
        r1 = self.microbatch // self.mesh1.shape["data"]
        r2 = self.microbatch // self.mesh2.shape["data"]
        return max(j * r1, k * r2), min((j + 1) * r1, (k + 1) * r2)

    @torch.no_grad()
    def synthesize_ids(self, ids) -> np.ndarray:
        """ids (B, max_N) -> wavs (B, n_samples) float32 on the host, on
        every rank. Any B: the batch is padded to a microbatch multiple
        (pad rows decode garbage and are dropped)."""
        cfg, mb, dev = self.cfg, self.microbatch, self.device
        B = np.asarray(ids).shape[0]
        ids = _pad_rows(ids, mb)
        n_mb = ids.shape[0] // mb
        n1, n2 = self.mesh1.shape["data"], self.mesh2.shape["data"]
        world = torch.distributed.group.WORLD
        n_samples = cfg.hop_length * (cfg.max_T * cfg.r - 1)
        if self.stage == 1:
            j, r1 = self.mesh1.coords["data"], mb // n1
            sends = []
            for m in range(n_mb):
                rows = torch.as_tensor(ids[m * mb + j * r1:
                                           m * mb + (j + 1) * r1],
                                       dtype=torch.long, device=dev)
                Y, _ = Text2Mel(cfg).decode(self.t2m_params, rows,
                                            mode="fused", packed=self.packed)
                for k in range(n2):
                    lo, hi = self._routes(j, k)
                    if lo < hi:
                        sends.append(D.isend(Y[lo - j * r1: hi - j * r1],
                                             n1 + k, world))
            for s in sends:
                s.wait()
        else:
            k, r2 = self.mesh2.coords["data"], mb // n2
            # every receive posted first: microbatch i+1 arrives while i is
            # vocoded
            recvs = [[D.irecv(torch.empty(hi - lo, cfg.max_T, cfg.n_mels,
                                          device=dev), j, world)
                      for j in range(n1)
                      for lo, hi in [self._routes(j, k)] if lo < hi]
                     for _ in range(n_mb)]
            mine = []
            for parts in recvs:
                Y = torch.cat([p.wait() for p in parts])
                _, Z = self.ssrn.apply(self.ssrn_params, Y,
                                       packed=self.ssrn_packed)
                mine.append(spectrogram_to_wav(Z, cfg))
        out = torch.empty(n_mb, mb, n_samples, device=dev)
        for k in range(n2):
            part = torch.stack(mine) if self.stage == 2 and \
                k == self.mesh2.coords["data"] else \
                torch.empty(n_mb, mb // n2, n_samples, device=dev)
            D.broadcast_([part], n1 + k, world)
            out[:, k * (mb // n2): (k + 1) * (mb // n2)] = part
        return out.reshape(-1, n_samples)[:B].cpu().numpy()


def restore_synthesis_params(cfg: Config, logdir1: str, logdir2: str):
    """(t2m_params, ssrn_params) on the CPU from the two checkpoint
    namespaces: Text2Mel from logdir1, SSRN from logdir2."""
    from .train import checkpoint
    gen = torch.Generator().manual_seed(0)
    t2m_params, _ = checkpoint.restore(logdir1, Text2Mel(cfg).init(gen))
    ssrn_params, _ = checkpoint.restore(logdir2, SSRN(cfg).init(gen))
    return t2m_params, ssrn_params
