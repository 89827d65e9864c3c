"""Device ms of the program's ``train.backward`` span a step (the gradients
by autograd): its CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("train.backward", "device_ms", r.units)
