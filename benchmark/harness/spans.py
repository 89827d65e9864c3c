"""The program's own spans (``dc_tts_tpu_torch/utils/profiling.py``) over a
traced window: the program records them while ``torch.profiler`` runs, which
is the traced window alone. A program without spans, or without the span
asked for, reads None."""


def per(name: str, field: str, count):
    """The summed ``field`` ("device_ms", "host_ms", ...) of the program's
    spans named ``name`` over ``count`` (calls, passes, requests or steps),
    or None."""
    from dc_tts_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    s = summary().get(name)
    v = s.get(field) if isinstance(s, dict) else None
    return None if v is None else v / count
