"""Host ms of the program's ``k1.prepare`` span a request: K1's launch prepared
on the host (the checks, the plan, the occupancy query, the layer arrays,
the buffers and the memset), before the library call."""
from benchmark.harness import spans


def read(r):
    return spans.per("k1.prepare", "host_ms", r.units)
