"""Device ms of the program's ``k4.fwd`` spans a step (kernel K4's forward
launches, the HC blocks' forwards): their CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("k4.fwd", "device_ms", r.units)
