"""Device ms of K1's norm phase a chunk (the layer norms, gates and
activations, stored into the cluster's copies): the program's
``k1.phase.norm`` entry, each launch's mean over the blocks of the stamped
twin, summed; recorded only while spans record, so None without a trace or
off the card."""
from benchmark.harness import spans


def read(r):
    return spans.per("k1.phase.norm", "device_ms", r.calls())
