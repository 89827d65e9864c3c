"""The run's guard against the JAX package: the process that prints the
result may hold none of these top-level modules. Names are compared whole
(the part before the first dot): ``dc_tts_tpu_torch`` is the program,
``dc_tts_tpu`` the JAX package it was ported from."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dc_tts_tpu"})


def forbidden_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(names & FORBIDDEN)
