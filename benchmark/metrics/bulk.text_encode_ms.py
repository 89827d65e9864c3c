"""Device ms of the program's ``text2mel.text_encode`` span (TextEnc) a chunk:
its CUDA events' stream time, which holds the stream's wait for the host
where the stage is host-paced."""
from benchmark.harness import spans


def read(r):
    return spans.per("text2mel.text_encode", "device_ms", r.calls())
