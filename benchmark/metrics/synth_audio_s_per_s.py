"""Seconds of speech delivered as pcm16 on the host per second of the
window, over every whole pass in it."""


def read(r):
    return r.cell.audio_seconds() / r.window_s
