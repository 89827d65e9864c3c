"""The traced run's instruments: CUDA-event spans that the benchmark
records around the program's layer entries, and ``torch.profiler``'s
device trace, reduced to busy time, kernel counts and the breakdown."""
from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile

import torch

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named device intervals, one list per name: ``mark()`` records a CUDA
    event on the current stream, ``add(name, start, end)`` keeps a pair of
    them. ``ms`` waits for the device."""

    def __init__(self):
        self.pairs = collections.defaultdict(list)

    @staticmethod
    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def add(self, name: str, start, end) -> None:
        self.pairs[name].append((start, end))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.pairs.items()}


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block's host and device activity when ``enabled``;
    yields a dict that holds the reduced trace afterwards."""
    out: dict = {}
    if not enabled:
        yield out
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            yield out
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(reduce_trace(events))


def _union(iv):
    merged = []
    for a, b in sorted(iv):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list) -> dict:
    """Chrome-trace events -> busy_s, window_s, kernels, device_ops (the
    ten kernels with the most time) and idle_gaps (the idle time between
    device activity, summed by the innermost host operation running at
    each gap's middle; the ten largest)."""
    win = [e for e in events if e.get("name") == "bench.window"
           and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    gpu, per_name, kernels = [], collections.Counter(), 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in GPU_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        gpu.append((a, b))
        per_name[e["name"]] += (b - a) / 1e6
        kernels += e["cat"] == "kernel"
    busy = _union(gpu)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("cpu_op", "cuda_runtime", "python_function")
                   and e.get("name") != "bench.window"),
                  key=lambda x: x[0])
    by_host, active, i = collections.Counter(), [], 0
    for a, b in gaps:                       # gaps and host both by start
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active \
            else "host outside any profiled operation"
        by_host[name] += (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernels": kernels,
            "device_ops": [[k, v] for k, v in per_name.most_common(10)],
            "idle_gaps": [[k, v] for k, v in by_host.most_common(10)]}
