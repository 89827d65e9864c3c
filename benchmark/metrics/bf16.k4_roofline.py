"""Per cent: K4's least time over the traced steps (``harness/k4_work.py``:
each HC block's forward and backward, FLOPs at 989 TFLOP/s or bytes at
3.35 TB/s, the larger) over the device ms of the program's ``k4.fwd`` and
``k4.bwd`` spans."""
from benchmark.harness import spans


def read(r):
    fwd = spans.per("k4.fwd", "device_ms", 1)
    bwd = spans.per("k4.bwd", "device_ms", 1)
    if fwd is None or bwd is None:
        return None
    return 100.0 * r.cell.k4_least_s * 1e3 / (fwd + bwd)
