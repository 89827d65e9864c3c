"""Device ms of the ssrn layer a call (CUDA events around its entry)."""


def read(r):
    return r.span_ms("ssrn")
