"""Per cent: three times the forward's counted FLOPs of every traced step
at its batch's (N, T), over the traced window at 989 TFLOP/s."""
from benchmark.harness import work


def read(r):
    if r.trace is None:
        return None
    return 100.0 * r.cell.window_flops / (r.trace["window_s"]
                                          * work.PEAK_FLOPS)
