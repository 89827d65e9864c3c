"""Host ms of the program's ``to_host.pin`` spans a pass: the pinned host
buffers allocated for the copy back, one a chunk."""
from benchmark.harness import spans


def read(r):
    return spans.per("to_host.pin", "host_ms", r.units)
