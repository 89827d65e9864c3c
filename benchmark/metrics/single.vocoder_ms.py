"""Device ms of the vocoder layer a call (CUDA events around its entry)."""


def read(r):
    return r.span_ms("vocoder")
