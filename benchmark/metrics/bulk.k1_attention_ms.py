"""Device ms of K1's attention phase a chunk (the attention row, once a step):
the program's ``k1.phase.attention`` entry, each launch's mean over the
blocks of the stamped twin, summed; recorded only while spans record, so
None without a trace or off the card."""
from benchmark.harness import spans


def read(r):
    return spans.per("k1.phase.attention", "device_ms", r.calls())
