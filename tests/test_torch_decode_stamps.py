"""K1's phases on the device, checked on the CPU: the reduction of a stamped
launch's record buffer into ``k1.phase.*`` entries (``utils/profiling``),
the decision that takes the stamped twin (``ops/decode.stamp_buffer``: only
while spans record), the record's layout against ``csrc/decode.cu``, and
the names and ptxas report by which the card's checks find each
instantiation. The twins themselves run on the card
(``tests/test_torch_cuda.py -k stamp``)."""
import os
import re
import types

import pytest
import torch

from benchmark.harness import spans
from benchmark.harness.registry import Registry
from dc_tts_tpu_torch.config import base_config, test_config
from dc_tts_tpu_torch.ops import _build
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.utils import profiling

P = len(K1.PHASES)
# the per-layer metrics that read them: metric -> (cell, summary entry,
# field, divided by the calls or the units)
METRICS = {
    **{f"{cell}.k1_{phase}_ms": (wl, f"k1.phase.{phase}", "device_ms",
                                 "calls")
       for cell, wl in (("bulk", "synth.lj.bulk72"),
                        ("single", "synth.lj.single"))
       for phase in ("product", "exchange", "norm", "attention")},
    "single.k1_prepare_host_ms": ("synth.lj.single", "k1.prepare",
                                  "host_ms", "units")}
MOVES = {"synth.lj.bulk72": "synth_audio_s_per_s",
         "synth.lj.single": "utt_latency_p95_ms"}
# the cells each metric is reported in: the bulk cells at B = 72 and 288
CELLS = {"synth.lj.bulk72": ["synth.lj.bulk72", "synth.lj.bulk288"],
         "synth.lj.single": ["synth.lj.single"]}
GT0 = 1_760_000_000_123_456_789   # a globaltimer reading: ns since 1970
# per block: each phase's cycles, and the block's globaltimer span (ns);
# the second block's clock ran twice as fast as the first's
BLOCKS = [([100, 400, 200, 250, 50], 2_000_000),
          ([300, 300, 300, 300, 800], 2_000_000),
          ([50, 500, 150, 200, 100], 4_000_000)]


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _words(blocks=BLOCKS, gt0=GT0):
    rows = [cyc + [sum(cyc), gt0 + 7 * i, gt0 + 7 * i + span]
            for i, (cyc, span) in enumerate(blocks)]
    return torch.tensor(rows, dtype=torch.int64)


def _want(blocks=BLOCKS):
    """Each block's phases in ms: its share of the cycles x its span."""
    return [[c / sum(cyc) * span / 1e6 for c in cyc] for cyc, span in blocks]


def test_phase_ms_scales_cycles_by_the_globaltimer_and_tiles():
    """Each block's phase takes its share of the block's cycles times the
    block's globaltimer span (read from int64 stamps near 2**60 without
    loss); the phases of each block add up to its span; the mean, largest
    and least over the blocks."""
    got = profiling.phase_ms(_words(), P)
    want = _want()
    assert got.shape == (P, 3) and got.dtype == torch.float64
    for j in range(P):
        col = [w[j] for w in want]
        assert got[j].tolist() == pytest.approx(
            [sum(col) / len(col), max(col), min(col)], rel=1e-12)
    for w, (_, span) in zip(want, BLOCKS):
        assert sum(w) == pytest.approx(span / 1e6, rel=1e-12)
    assert float(got[:, 0].sum()) == pytest.approx(
        sum(span for _, span in BLOCKS) / len(BLOCKS) / 1e6, rel=1e-12)


def test_summary_sums_stamped_launches_by_phase():
    """Two launches of one plan and one of another: one entry a phase,
    ``count`` the launches, ``device_ms`` / ``device_ms_max`` /
    ``device_ms_min`` the sums of each launch's mean / largest / least over
    its blocks, the launches by plan; ``spans.per`` reads them as it reads
    a span; ``reset`` drops them."""
    wide = dict(kernel="wide", exchange="grid", cluster=8, blocks=3, B=72)
    flag = dict(kernel="flag", exchange="flag", cluster=2, blocks=2, B=1)
    short = BLOCKS[:2]
    for words, plan in ((_words(), wide), (_words(), wide),
                        (_words(short), flag)):
        profiling.RECORDER.stamps("k1", K1.PHASES, words, **plan)
    s = profiling.summary()
    assert s["spans.dropped"] == 0
    three, two = profiling.phase_ms(_words(), P), profiling.phase_ms(
        _words(short), P)
    for j, phase in enumerate(K1.PHASES):
        e = s[f"k1.phase.{phase}"]
        assert e["count"] == 3 and e["n"] is None and e["host_ms"] is None
        for k, field in enumerate(("device_ms", "device_ms_max",
                                   "device_ms_min")):
            assert e[field] == pytest.approx(
                2 * float(three[j, k]) + float(two[j, k]), rel=1e-12)
        assert e["device_self_ms"] == e["device_ms"]
        assert e["plans"] == {
            "kernel wide exchange grid cluster 8 blocks 3 B 72": 2,
            "kernel flag exchange flag cluster 2 blocks 2 B 1": 1}
        assert spans.per(f"k1.phase.{phase}", "device_ms", 2) == \
            pytest.approx(e["device_ms"] / 2)
    # read once: a second summary gives the same entries
    assert profiling.summary()["k1.phase.norm"] == s["k1.phase.norm"]
    profiling.reset()
    assert not [k for k in profiling.summary() if k.startswith("k1.phase")]


def test_stamped_launches_past_the_cap_are_dropped(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "cap", 2)
    for _ in range(3):
        profiling.RECORDER.stamps("k1", K1.PHASES, _words(), kernel="wide")
    s = profiling.summary()
    assert s["k1.phase.product"]["count"] == 2 and s["spans.dropped"] == 1


@pytest.mark.parametrize("mode", ["off", "collect", "profiler"])
def test_the_twin_runs_only_while_spans_record(mode):
    """``launch_decode``'s decision: no buffer (the unstamped kernel)
    unless spans record, inside ``collect()`` or under ``torch.profiler``,
    and then a buffer of a record a block; none, recording or not, where
    the plan leaves no room for the twin's record in shared memory (at
    B = 72 under "default": 16 bytes)."""
    cfg = base_config()
    plan = K1.decode_plan(cfg, 72, 120, "highest")
    full = K1.decode_plan(cfg, 72, 120, "default")
    assert plan.smem + K1.STAMP_SMEM <= K1.SMEM_MAX
    assert full.smem + K1.STAMP_SMEM > K1.SMEM_MAX
    if mode == "off":
        assert not profiling.recording()
        assert K1.stamp_buffer(plan, "cpu") is None
        return
    with (profiling.collect() if mode == "collect" else
          torch.profiler.profile(
              activities=[torch.profiler.ProfilerActivity.CPU])):
        assert profiling.recording()
        buf = K1.stamp_buffer(plan, "cpu")
        assert K1.stamp_buffer(full, "cpu") is None
    assert buf.shape == (plan.blocks, K1.STAMP_WORDS)
    assert buf.dtype == torch.int64
    assert not profiling.recording()


def test_record_layout_matches_the_kernel():
    """``PHASES`` in the order of csrc/decode.cu's ``PH_*`` indices, and
    a block's record of ``STAMP_WORDS`` words as the kernel lays it."""
    path = os.path.join(os.path.dirname(K1.__file__), "..", "csrc",
                        "decode.cu")
    with open(path) as f:
        src = f.read()
    ph = {m[0].lower(): int(m[1])
          for m in re.findall(r"#define PH_(\w+) (\d+)", src)}
    assert sorted(ph, key=ph.get) == list(K1.PHASES)
    assert re.search(rf"#define N_PHASES {P}\b", src)
    assert "#define STAMP_WORDS (N_PHASES + 3)" in src
    assert K1.STAMP_WORDS == P + 3


@pytest.mark.parametrize("name,B,kernel", [
    ("base", 1, "flag"), ("base", 20, "common"), ("base", 72, "wide"),
    ("d264", 20, "general")])
def test_kernel_name_of_a_plan(name, B, kernel):
    """The instantiation a launch takes, as ``RECORDER.stamps`` is told:
    at base_config B = 1 the flagged exchange, B = 20 the common kernel,
    B = 72 the wide one; d = 264 the general kernel."""
    cfg = base_config() if name == "base" else test_config().replace(d=264)
    plan = K1.decode_plan(cfg, B, 132)
    assert K1.kernel_name(cfg, plan) == kernel


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113decode_kernelILb0ELb1ELb0ELi2ELb1EEEvNS_4ArgsENS_7ProgramE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113decode_kernelILb0ELb1ELb0ELi2ELb1EEEvNS_4ArgsENS_7ProgramE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 128 bytes smem
ptxas info    : Function properties for _ZN12_GLOBAL__N_114normalise_wideILi2EEEvPKfifPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113decode_kernelILb0ELb0ELb1ELi8ELb0EEEvNS_4ArgsENS_7ProgramE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113decode_kernelILb0ELb0ELb1ELi8ELb0EEEvNS_4ArgsENS_7ProgramE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112barrier_kernelEPji' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112barrier_kernelEPji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 1 barriers
"""


def test_ptxas_report_names_each_instantiation():
    """The build log's ptxas report per entry function (registers, spill
    bytes, static shared memory; a device function's properties are not an
    entry), and each decode_kernel instantiation's label."""
    rep = _build.ptxas_report(PTXAS_LOG)
    assert len(rep) == 3
    labels = {K1.instance_label(f): v for f, v in rep.items()}
    assert labels["flag CL2 stamped"] == {"registers": 128, "spill_stores": 4,
                                          "spill_loads": 4, "smem": 128}
    assert labels["wide CL8"] == {"registers": 128, "spill_stores": 0,
                                  "spill_loads": 0, "smem": 0}
    assert labels[None]["registers"] == 12
    assert K1.instance_label(
        "_ZN12_GLOBAL__N_113decode_kernelILb1ELb0ELb0ELi2ELb0EEEvNS_4ArgsE"
        "NS_7ProgramE") == "general CL2"
    assert K1.instance_label(
        "_ZN12_GLOBAL__N_113decode_kernelILb0ELb0ELb0ELi2ELb1EEEvNS_4ArgsE"
        "NS_7ProgramE") == "common CL2 stamped"


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_each_phase_metric_has_its_entry_and_reads_its_field(metric,
                                                             monkeypatch):
    """Each new per-layer metric: one entry in BENCHMARK.json, for its
    cells only (the bulk metrics for both bulk cells), read from the
    program's summary (a phase's device ms over the
    calls, ``k1.prepare``'s host ms over the requests); None where the
    summary lacks its entry, as in a run that recorded nothing."""
    cell, entry, field, base = METRICS[metric]
    reg = Registry()
    found = [m for m in reg.spec["per_layer"] if m["name"] == metric]
    assert len(found) == 1
    m = found[0]
    assert (m["workloads"], m["source"], m["unit"], m["better"],
            m["moves"]) == (CELLS[cell], "program_span", "ms", "lower",
                            MOVES[cell])
    assert m["layer"] == ("Kernel K1" if "phase" in entry
                          else "Host launch path")
    read = reg.reader(metric)
    r = types.SimpleNamespace(units=4, calls=lambda: 40)
    assert read(r) is None                  # nothing recorded
    monkeypatch.setattr(profiling, "summary",
                        lambda: {entry: {field: 120.0}, "k1.launches": 3})
    assert read(r) == pytest.approx(120.0 / (40 if base == "calls" else 4))


def test_phase_metrics_read_none_off_the_card():
    """Requests synthesised on the CPU while spans record: the plain
    decode launches no kernel, so no phase and no ``k1.prepare``; every new
    metric reads None."""
    import numpy as np

    from dc_tts_tpu_torch.bench import seeded_synthesizer

    cfg = test_config()
    synth = seeded_synthesizer(cfg, "cpu", pcm16=True)
    ids = np.zeros((2, cfg.max_N), np.int64)
    ids[:, :5] = 3
    with profiling.collect():
        for i in range(2):
            synth.synthesize_ids_chunked(ids[i: i + 1], 1)
    s = profiling.summary()
    assert s["text2mel.decode"]["count"] == 2 and "k1.prepare" not in s
    reg = Registry()
    r = types.SimpleNamespace(units=2, calls=lambda: 2)
    for metric in sorted(METRICS):
        assert reg.reader(metric)(r) is None, metric
