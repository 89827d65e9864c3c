"""Host ms of the program's ``to_host.wait`` span a request: the host waiting
for the device before the copy back is read."""
from benchmark.harness import spans


def read(r):
    return spans.per("to_host.wait", "host_ms", r.units)
