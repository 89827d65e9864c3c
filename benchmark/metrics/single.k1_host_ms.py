"""Host ms of the program's ``text2mel.decode`` span a request: the decode's
launch as the host makes it (plan, occupancy query, layer arrays,
allocations, the launch call)."""
from benchmark.harness import spans


def read(r):
    return spans.per("text2mel.decode", "host_ms", r.units)
