"""Device ms of the program's ``text2mel.text_encode`` span (TextEnc) a
request: its CUDA events' stream time, which at B = 1 holds the stream's
wait for the host's launches."""
from benchmark.harness import spans


def read(r):
    return spans.per("text2mel.text_encode", "device_ms", r.units)
