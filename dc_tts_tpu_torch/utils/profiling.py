"""Profiling helpers, the port of ``dc_tts_tpu/utils/profiling.py``: the
program's spans, the ``torch.profiler`` exporter, and the FLOP counters.

Spans: ``with span("text2mel.decode"):`` marks a stage of the program.
Recording is off by default, and a span then costs one check of the
profiler's flag. It is on while ``torch.profiler`` records (the span then
enters ``record_function``, so it lands in the same Chrome trace, on the
same clock, as the operations and kernels it launched) and inside
``collect()``. A recorded span keeps its name, the id of its tree (the
outermost span's ``key``, or a running number), its parent, its host start
and end (``time.perf_counter_ns``), the rows it handles (``n``) and, once
CUDA is initialised, a pair of timing CUDA events on the current stream. No
span waits for the device. ``summary()`` waits once and sums the spans by
name; ``reset()`` empties the store. A module that records stages names
them in its own docstring.

Phases inside a kernel: a kernel with a stamped twin (K1, ``ops/decode.py``)
launches it while spans record (``recording()``) and hands its record buffer
to ``RECORDER.stamps``: per block, each phase's clock64 cycles, the block's
cycles and its ``%globaltimer`` at start and end. ``summary()`` reads the
buffers after its one wait and adds an entry ``<kernel>.phase.<phase>`` a
phase (``phase_ms``).

Counters: the code that launches a kernel, or captures or replays a graph,
calls ``count(name)`` once it has; ``counts()`` reads them and
``reset_counts()`` sets them to 0. A launch counts under its kernel's name
and under its variant's, if it has one (``k1.launches`` and
``k1.high3.launches``), so nothing is summed at read time.

``trace(logdir)`` records a ``torch.profiler`` trace of a code region (CPU
and, where present, CUDA activity) as a Chrome trace, the spans inside it as
``user_annotation`` events; the FLOP counters give the roofline numerators,
equal to the JAX package's; ``mfu`` divides by the H100 SXM's published
peaks.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled

# the counters: name -> count (kernel launches, graph captures and replays)
_COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> collections.Counter:
    """A copy of the counters (a name never counted reads 0)."""
    return collections.Counter(_COUNTS)


def reset_counts() -> None:
    """Set every counter to 0."""
    _COUNTS.clear()


class _Record:
    __slots__ = ("name", "sid", "tree", "parent", "n", "t0", "t1", "ev0",
                 "ev1")


class _Stamped:
    __slots__ = ("name", "phases", "words", "plan", "ms")


def phase_ms(words: torch.Tensor, n_phases: int) -> torch.Tensor:
    """One stamped launch's record (blocks, ``n_phases`` + 3) int64: each
    block's phase cycles, its cycles, its ``%globaltimer`` ns at start and
    end -> (n_phases, 3) float64: each phase's ms, the mean, the largest and
    the least over the blocks. A block's phase takes its share of the
    block's cycles times the block's globaltimer span, so the split holds
    while the SM clock moves."""
    w = words.cpu()
    span_ns = (w[:, n_phases + 2] - w[:, n_phases + 1]).double()
    ms = (w[:, :n_phases].double() / w[:, n_phases:n_phases + 1].double()
          * span_ns[:, None] / 1e6)
    return torch.stack([ms.mean(0), ms.amax(0), ms.amin(0)], dim=1)


class Recorder:
    """The spans recorded so far, at most ``cap`` of them; spans past the
    cap are counted in ``dropped`` and not kept."""

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.collecting = 0          # open collect() blocks
        self._ids = itertools.count()
        self._trees = itertools.count()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget the kept spans (spans still open are not kept) and the
        stamped launches."""
        self.records: list = []
        self.stamped: list = []
        self.dropped = 0

    def stamps(self, name: str, phases, words: torch.Tensor, **plan) -> None:
        """Keep a stamped launch of kernel ``name``: ``words`` its record
        buffer (blocks, len(phases) + 3) int64, filled on the stream;
        ``plan`` what the launch ran (kernel, exchange, cluster, blocks,
        B). Past ``cap`` it is counted in ``dropped``."""
        if len(self.stamped) >= self.cap:
            self.dropped += 1
            return
        st = _Stamped()
        st.name, st.phases, st.words, st.plan, st.ms = (name, tuple(phases),
                                                        words, plan, None)
        self.stamped.append(st)

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def summary(self) -> dict:
        """Per span name: ``count``, ``n`` (rows summed over the spans that
        give them, else None), ``host_ms`` and ``host_self_ms`` (minus the
        child spans' host ms), ``device_ms`` and ``device_self_ms`` (the
        CUDA event pairs' stream time; None without events). Beside them
        the counters counted so far (``counts()``) and ``spans.dropped``.
        Per phase of a stamped kernel, ``<kernel>.phase.<phase>``: ``count``
        (launches), ``device_ms``, ``device_ms_max`` and ``device_ms_min``
        (the sums over its launches of the phase's mean, largest and least
        ms over the blocks, ``phase_ms``), ``plans`` (launches by plan).
        Waits for the device once."""
        done = [r for r in self.records if r.t1 is not None]
        if any(r.ev0 is not None for r in done) or any(
                st.ms is None and st.words.is_cuda for st in self.stamped):
            torch.cuda.synchronize()
        host, dev, child_host, child_dev = {}, {}, {}, {}
        for r in done:
            host[r.sid] = h = (r.t1 - r.t0) / 1e6
            dev[r.sid] = d = None if r.ev0 is None else \
                r.ev0.elapsed_time(r.ev1)
            if r.parent is not None:
                child_host[r.parent] = child_host.get(r.parent, 0.0) + h
                if d is not None:
                    child_dev[r.parent] = child_dev.get(r.parent, 0.0) + d
        out: dict = {}
        for r in done:
            s = out.setdefault(r.name, {
                "count": 0, "n": None, "host_ms": 0.0, "host_self_ms": 0.0,
                "device_ms": None, "device_self_ms": None})
            s["count"] += 1
            if r.n is not None:
                s["n"] = (s["n"] or 0) + r.n
            s["host_ms"] += host[r.sid]
            s["host_self_ms"] += host[r.sid] - child_host.get(r.sid, 0.0)
            if dev[r.sid] is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + dev[r.sid]
                s["device_self_ms"] = (s["device_self_ms"] or 0.0) \
                    + dev[r.sid] - child_dev.get(r.sid, 0.0)
        for st in self.stamped:
            if st.ms is None:     # read once; the device buffer is let go
                st.ms, st.words = phase_ms(st.words, len(st.phases)), None
            plan = " ".join(f"{k} {v}" for k, v in st.plan.items())
            for phase, (mean, most, least) in zip(st.phases, st.ms.tolist()):
                s = out.setdefault(f"{st.name}.phase.{phase}", {
                    "count": 0, "n": None, "host_ms": None,
                    "host_self_ms": None, "device_ms": 0.0,
                    "device_self_ms": 0.0, "device_ms_max": 0.0,
                    "device_ms_min": 0.0, "plans": {}})
                s["count"] += 1
                s["device_ms"] += mean
                s["device_self_ms"] += mean
                s["device_ms_max"] += most
                s["device_ms_min"] += least
                s["plans"][plan] = s["plans"].get(plan, 0) + 1
        out.update(counts())
        out["spans.dropped"] = self.dropped
        return out


RECORDER = Recorder()


class span:
    """``with span(name, n=None, key=None):`` one stage of the program.
    ``n``: the rows it handles; ``key``: the tree's id when this span is
    outermost (a training step's number), a running number otherwise."""

    __slots__ = ("name", "n", "key", "_rec", "_rf")

    def __init__(self, name: str, n: int | None = None, key=None):
        self.name, self.n, self.key = name, n, key
        self._rec = self._rf = None

    def __enter__(self):
        rec = RECORDER
        on_profiler = _profiling()
        if not (on_profiler or rec.collecting):
            return self
        if on_profiler:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack = rec.stack()
        r = self._rec = _Record()
        r.name, r.n, r.t1 = self.name, self.n, None
        r.sid = next(rec._ids)
        if stack:
            r.parent, r.tree = stack[-1].sid, stack[-1].tree
        else:
            r.parent = None
            r.tree = self.key if self.key is not None else next(rec._trees)
        r.ev0 = r.ev1 = None
        if torch.cuda.is_initialized():
            r.ev0 = torch.cuda.Event(enable_timing=True)
            r.ev1 = torch.cuda.Event(enable_timing=True)
            r.ev0.record()
        stack.append(r)
        if len(rec.records) < rec.cap:
            rec.records.append(r)
        else:
            rec.dropped += 1
        r.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = self._rec
        if r is None:
            return False
        r.t1 = time.perf_counter_ns()
        if r.ev1 is not None:
            r.ev1.record()
        RECORDER.stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether spans record now: ``torch.profiler`` runs, or a
    ``collect()`` block is open (the check ``span`` makes)."""
    return bool(_profiling() or RECORDER.collecting)


@contextlib.contextmanager
def collect():
    """Record spans inside the block without ``torch.profiler``."""
    RECORDER.collecting += 1
    try:
        yield
    finally:
        RECORDER.collecting -= 1


def summary() -> dict:
    """``RECORDER.summary()``: the recorded spans summed by name."""
    return RECORDER.summary()


def reset() -> None:
    """Forget every recorded span and stamped launch."""
    RECORDER.reset()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region; writes ``<logdir>/trace.json`` (Chrome format)
    and yields the profiler (``key_averages()`` for per-kernel sums)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def conv_stack_flops(batch: int, t: int, specs, in_ch: int) -> int:
    """Forward FLOPs of a C/HC/D stack (2*M*N*K per matmul)."""
    from ..models.blocks import HC, C, D, stack_in_channels
    total = 0
    tt = t
    for spec, cin in zip(specs, stack_in_channels(specs, in_ch)):
        if isinstance(spec, HC):
            total += 2 * batch * tt * (spec.size * cin) * (2 * cin)
        elif isinstance(spec, C):
            cout = spec.out_ch or cin
            total += 2 * batch * tt * (spec.size * cin) * cout
        elif isinstance(spec, D):
            cout = spec.out_ch or cin
            total += 2 * batch * tt * cin * cout * 3
            tt *= 2
    return total


def griffin_lim_flops(batch: int, frames: int, n_fft: int, n_iter: int,
                      method: str = "dft") -> int:
    """Matmul FLOPs of the Griffin-Lim loop (n_iter + 1 transforms each
    way). dft family: four real matmuls per round (forward cos/sin, inverse
    cos/sin). "ct": the 128-point matmul stage plus the N2-point
    multiply-reduce. "fft": 5 N log2 N per transform. "dft_pallas2": the
    TPU kernel's factored 16 x (n_fft/16) transform."""
    n_freq = n_fft // 2 + 1
    if method == "fft":
        per_tf = 5 * n_fft * math.log2(n_fft) * batch * frames
        return int((n_iter + 1) * 2 * per_tf)
    if method == "ct":
        n1 = 128
        n2 = n_fft // n1
        mxu = 2 * batch * frames * n2 * n1 * n1 * 2
        vpu = 2 * batch * frames * n2 * n2 * n1 * 2
        return (n_iter + 1) * (mxu + vpu) * 2
    if method == "dft_pallas2":
        n1, n2 = 16, n_fft // 16
        stage16 = 2 * n1 * n1 * n_fft * 2
        stage128 = 4 * n1 * n2 * n2 * 2
        return (n_iter + 1) * batch * frames * (stage16 + stage128) * 2
    per_dir = 2 * batch * frames * n_fft * n_freq * 2
    return (n_iter + 1) * per_dir * 2


# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): dense
# bf16 and dense TF32 on the tensor cores (float32 sums), and float32
# outside them (what float32 products run at with TF32 off).
H100_BF16_PEAK_FLOPS = 989e12
H100_TF32_PEAK_FLOPS = 495e12
H100_FP32_PEAK_FLOPS = 67e12


def mfu(flops: int, seconds: float, passes: int = 1,
        peak: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilization: algorithmic FLOPs x tensor-core passes (3
    for the bf16 hi/lo split) over peak x seconds. In [0, 1]."""
    return flops * passes / (seconds * peak)
