"""Device ms of the program's ``k4.bwd`` spans a step (kernel K4's backward
launches, the HC blocks' gradients): their CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("k4.bwd", "device_ms", r.units)
