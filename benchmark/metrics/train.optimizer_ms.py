"""Device ms of the program's ``train.optimizer`` span a step (clipping,
Adam, Noam): its CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("train.optimizer", "device_ms", r.units)
