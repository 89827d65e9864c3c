"""Per cent of the traced window in which no operation ran on the
device."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
