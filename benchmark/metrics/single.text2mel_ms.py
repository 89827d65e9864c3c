"""Device ms of the text2mel layer a call (CUDA events around its entry)."""


def read(r):
    return r.span_ms("text2mel")
