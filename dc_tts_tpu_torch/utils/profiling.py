"""Profiling helpers, the port of ``dc_tts_tpu/utils/profiling.py``.

``trace(logdir)`` records a ``torch.profiler`` trace of a code region (CPU
and, where present, CUDA activity) as a Chrome trace; ``time_fn`` times a
callable with CUDA events on the card; the FLOP counters give the roofline
numerators, equal to the JAX package's; ``mfu`` divides by the H100 SXM's
published peaks.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable

import torch


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


def time_fn(fn: Callable, *args, iters: int = 3, warmup: int = 1) -> float:
    """Mean seconds of fn(*args): CUDA events around ``iters`` calls on the
    current stream after ``warmup`` calls, on the card; the host clock
    otherwise (CPU only: no device time)."""
    for _ in range(warmup):
        fn(*args)
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


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
