"""Per cent: the least time of the vocoder layer's counted work (its FLOPs at
989 TFLOP/s or its bytes at 3.35 TB/s, the larger) over its device ms."""
from benchmark.harness import work


def read(r):
    ms = r.span_ms("vocoder")
    if ms is None:
        return None
    flops, nbytes = r.cell.work_per_unit()["vocoder"]
    return 100.0 * work.least_seconds(flops, nbytes) * 1e3 / ms
