"""Seconds from the process's start to the window's: imports, the card's
context, the kernel library, the weights, the warm-up."""


def read(r):
    return r.setup_s
