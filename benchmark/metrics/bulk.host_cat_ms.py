"""Host ms of the program's ``to_host.cat`` span a pass: the concatenation of
the pass's pcm16 waveforms on the host after the copy back."""
from benchmark.harness import spans


def read(r):
    return spans.per("to_host.cat", "host_ms", r.units)
