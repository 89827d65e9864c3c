"""One run of one cell: set-up, the measured window, the reading of its
metrics, then the comparison that decides ``correct``."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import check
from .guard import forbidden_modules
from .registry import Registry
from .trace import Spans, profiled


class Refused(RuntimeError):
    """The run cannot be made here; nothing is printed on stdout."""


class Readings:
    """What a metric's reader reads: the window's host times, the spans
    and the trace of a traced run, and the work counted from shapes."""

    def __init__(self, cell, unit_s, setup_s, spans, trace):
        self.cell, self.unit_s, self.setup_s = cell, unit_s, setup_s
        self.units, self.window_s = cell.units, cell.window_s
        self.spans = spans or {}
        self.trace = trace or None

    def span_ms(self, name: str):
        v = self.spans.get(name)
        return float(np.mean(v)) if v else None

    def calls(self) -> int:
        return self.units * self.cell.calls_per_unit()


def _sizes(cfg_file: dict, rehearse: bool) -> dict:
    cfg = dict(cfg_file["sizes"])
    if rehearse:
        cfg.update(cfg_file["rehearsal"])
    return cfg


def prepare(workload: str, seed: int, reg: Registry, rehearse: bool):
    """-> (workload entry, cell): the cell set up, its first call or steps
    done."""
    w = reg.workload(workload)
    cfg_file = reg.config(w["config"])
    traffic = dict(reg.traffic(w["traffic"]))
    if rehearse:
        traffic.update(traffic.get("rehearsal", {}))
        device = torch.device("cpu")
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < w["chips"]:
            raise Refused(f"{workload} needs {w['chips']} CUDA device(s); "
                          f"this machine has {n}")
        device = torch.device("cuda", 0)
    from dc_tts_tpu_torch.device import fp32_numerics
    fp32_numerics()
    t0 = time.perf_counter()
    torch.zeros(1, device=device)          # the CUDA context
    t1 = time.perf_counter()
    cfg = _sizes(cfg_file, rehearse)
    cell = reg.driver(traffic["driver"])(cfg, cfg_file["program"], traffic,
                                         seed, device)
    cell.setup_marks = {"context": t1 - t0, **getattr(cell, "setup_marks",
                                                       {})}
    return w, cell


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             reg: Registry | None = None, rehearse: bool = False,
             t_start: float | None = None):
    """-> (result line as a dict, check lines). ``rehearse``: the CPU at the
    configuration's rehearsal sizes, no number under any metric."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = reg or Registry()
    t_in = time.perf_counter()
    w, cell = prepare(workload, seed, reg, rehearse)
    device = cell.device
    setup_s = time.perf_counter() - t_start
    marks = {"imports": t_in - t_start, **cell.setup_marks}

    spans, tr = None, None
    gc0 = [g["collections"] for g in gc.get_stats()]
    if trace:
        on_card = device.type == "cuda"
        if on_card:
            sp = Spans()
            cell.instrument(sp)
        with profiled(on_card) as tr:
            unit_s = cell.run_window(seconds, cell.traffic["trace_units"])
        if on_card:
            cell.instrument(None)
            spans = sp.ms()
    else:
        unit_s = cell.run_window(seconds, None)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    readings = Readings(cell, unit_s, setup_s, spans, tr)
    metrics = {}
    for m in reg.metrics(workload, trace):
        v = None if rehearse else reg.reader(m["name"])(readings)
        if v is not None or rehearse:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = cell.attempted()
    numbers = cell.judge()
    correct, failed, checks = check.verdict(numbers,
                                            reg.checks(workload)["numbers"])
    bad = forbidden_modules()
    if bad:
        raise Refused("the run holds modules of the JAX package or JAX: "
                      + ", ".join(bad))
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    gcs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    lines = [f"window: {cell.units} units in {cell.window_s:.3f} s; garbage "
             f"collections a generation {gcs}; set-up s "
             + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())]
    if unit_s:
        q = np.percentile(np.asarray(unit_s) * 1e3, [50, 90, 95, 99, 100])
        lines[0] += (f"; a unit's host ms p50 {q[0]:.3f} p90 {q[1]:.3f} "
                     f"p95 {q[2]:.3f} p99 {q[3]:.3f} max {q[4]:.3f}")
    lines += [f"check {k}: {v['value']!r} <= {v['limit']!r}"
              for k, v in checks.items()]
    return result, lines


def stderr(*lines):
    for ln in lines:
        print(ln, file=sys.stderr, flush=True)
