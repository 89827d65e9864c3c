"""Device ms of K1's product phase a chunk (the norm parameters' issue, the
layer products, the combine (under the flagged exchange its publish)): the
program's ``k1.phase.product`` entry, each launch's mean over the blocks of
the stamped twin, summed; recorded only while spans record, so None without
a trace or off the card."""
from benchmark.harness import spans


def read(r):
    return spans.per("k1.phase.product", "device_ms", r.calls())
