"""Device ms of K1's exchange phase a request (the grid barrier, the staged
slice's wait and the cluster barrier, or the flagged exchange's gather): the
program's ``k1.phase.exchange`` entry, each launch's mean over the blocks of
the stamped twin, summed; recorded only while spans record, so None without
a trace or off the card."""
from benchmark.harness import spans


def read(r):
    return spans.per("k1.phase.exchange", "device_ms", r.calls())
