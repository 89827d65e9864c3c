"""Device ms of the program's ``train.forward`` span a step (the network, the
loss and the metrics): its CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("train.forward", "device_ms", r.units)
