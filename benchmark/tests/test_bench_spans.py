"""The per-layer metrics that read the program's spans: each reader, on a
built ``summary()``, gives its span's field a call, pass, request or step;
None without its span and None for a program that records no spans; each
is found by the registry for its cell."""
import types

import pytest

from benchmark.harness.registry import Registry
from dc_tts_tpu_torch.utils import profiling

# metric -> (cell, span, field, divided by r.calls() or r.units)
READS = {
    "bulk.text_encode_ms": ("synth.lj.bulk72", "text2mel.text_encode",
                            "device_ms", "calls"),
    "bulk.k1_ms": ("synth.lj.bulk72", "text2mel.decode", "device_ms",
                   "calls"),
    "bulk.griffin_lim_ms": ("synth.lj.bulk72", "vocoder.griffin_lim",
                            "device_ms", "calls"),
    "bulk.host_cat_ms": ("synth.lj.bulk72", "to_host.cat", "host_ms",
                         "units"),
    "bulk.pinned_alloc_ms": ("synth.lj.bulk72", "to_host.pin", "host_ms",
                             "units"),
    "single.text_encode_ms": ("synth.lj.single", "text2mel.text_encode",
                              "device_ms", "units"),
    "single.k1_ms": ("synth.lj.single", "text2mel.decode", "device_ms",
                     "units"),
    "single.k1_host_ms": ("synth.lj.single", "text2mel.decode", "host_ms",
                          "units"),
    "single.device_wait_ms": ("synth.lj.single", "to_host.wait", "host_ms",
                              "units"),
    "train.forward_ms": ("train.lj.ssrn", "train.forward", "device_ms",
                         "units"),
    "train.backward_ms": ("train.lj.ssrn", "train.backward", "device_ms",
                          "units"),
    "train.optimizer_ms": ("train.lj.ssrn", "train.optimizer", "device_ms",
                           "units"),
}
SPANS = sorted({span for _, span, _, _ in READS.values()})
# every span's fields distinct, so a reader of the wrong one reads wrong
SUMMARY = {span: {"count": 5, "n": None, "host_ms": 100.0 + 10 * i,
                  "host_self_ms": 1.0 + i, "device_ms": 300.0 + 10 * i,
                  "device_self_ms": 3.0 + i}
           for i, span in enumerate(SPANS)}
SUMMARY.update({"k1.launches": 9, "spans.dropped": 0})
READINGS = types.SimpleNamespace(units=4, calls=lambda: 40)


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_reads_its_span(monkeypatch, metric):
    _, span, field, base = READS[metric]
    read = Registry().reader(metric)
    monkeypatch.setattr(profiling, "summary", lambda: SUMMARY)
    want = SUMMARY[span][field] / (40 if base == "calls" else 4)
    assert read(READINGS) == pytest.approx(want)
    others = {k: v for k, v in SUMMARY.items() if k != span}
    monkeypatch.setattr(profiling, "summary", lambda: others)
    assert read(READINGS) is None
    # a program that predates the spans
    monkeypatch.delattr(profiling, "summary")
    assert read(READINGS) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_span_metric_is_found_for_its_cell(metric):
    reg = Registry()
    cell = READS[metric][0]
    entry = [m for m in reg.metrics(cell, True) if m["name"] == metric]
    assert len(entry) == 1 and entry[0]["workloads"] == [cell]
    assert entry[0]["source"] == "program_span"
    assert entry[0]["better"] == "lower" and entry[0]["unit"] == "ms"
    assert metric not in [m["name"] for w in reg.spec["workloads"]
                          if w["name"] != cell
                          for m in reg.metrics(w["name"], True)]


def test_a_reader_on_the_programs_own_summary():
    """Spans the program recorded on the CPU: host ms read as they were
    kept; device ms and the copy back to a card absent, so None."""
    import numpy as np

    from dc_tts_tpu_torch.bench import seeded_synthesizer
    from dc_tts_tpu_torch.config import test_config

    synth = seeded_synthesizer(test_config(), "cpu", pcm16=True)
    ids = np.zeros((2, test_config().max_N), np.int64)
    ids[:, :5] = 3
    profiling.reset()
    try:
        with profiling.collect():
            for i in range(2):
                synth.synthesize_ids_chunked(ids[i: i + 1], 1)
        s = profiling.summary()
        reg, two = Registry(), types.SimpleNamespace(units=2,
                                                     calls=lambda: 2)
        assert reg.reader("single.k1_host_ms")(two) == pytest.approx(
            s["text2mel.decode"]["host_ms"] / 2)
        assert s["text2mel.decode"]["count"] == 2
        for metric in ("single.k1_ms", "single.device_wait_ms",
                       "bulk.host_cat_ms"):
            assert reg.reader(metric)(two) is None, metric
    finally:
        profiling.reset()
