"""Per cent: the counted FLOPs of every stage of the traced calls over the
traced window at 989 TFLOP/s."""
from benchmark.harness import work


def read(r):
    if r.trace is None:
        return None
    flops = sum(f for f, _ in r.cell.work_per_unit().values()) * r.calls()
    return 100.0 * flops / (r.trace["window_s"] * work.PEAK_FLOPS)
