"""Device ms of the program's ``text2mel.decode`` span (the decode kernel K1
and its launch) a chunk: its CUDA events' stream time."""
from benchmark.harness import spans


def read(r):
    return spans.per("text2mel.decode", "device_ms", r.calls())
