"""Device ms of the program's ``vocoder.griffin_lim`` span (denormalize and
the Griffin-Lim kernel K2) a chunk: its CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("vocoder.griffin_lim", "device_ms", r.calls())
