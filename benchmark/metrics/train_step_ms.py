"""The window over the steps it completed, ended by one wait for the
device."""


def read(r):
    return r.window_s * 1e3 / r.units
