"""The program's spans (``dc_tts_tpu_torch/utils/profiling.py``) on the CPU:
nothing recorded while recording is off; under ``torch.profiler`` the
synthesis chain's span tree, one ``user_annotation`` a span enclosing its
stage's operations; the training step's tree; results bitwise the same with
recording on and off; the store's cap."""
import json

import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.bench import seeded_nets
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.dsp.griffin_lim import denormalize_mag, griffin_lim
from dc_tts_tpu_torch.ops.decode import fused_decode
from dc_tts_tpu_torch.pipeline import Synthesizer
from dc_tts_tpu_torch.train import steps as TS
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()
CHUNK = 2
# the chain's spans on the CPU: name -> parent (no copy back to a card)
SYNTH_TREE = {"synth.call": None, "synth.rows": "synth.call",
              "text2mel": "synth.rows",
              "text2mel.text_encode": "text2mel",
              "text2mel.decode": "text2mel",
              "ssrn": "synth.rows", "vocoder": "synth.rows",
              "vocoder.griffin_lim": "vocoder"}
TRAIN_TREE = {"train.step": None, "train.forward": "train.step",
              "train.backward": "train.step",
              "train.optimizer": "train.step"}


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def synth():
    return Synthesizer(CFG, *seeded_nets(CFG), device="cpu", pcm16=True)


def _ids(B=3):
    ids = np.zeros((B, CFG.max_N), np.int64)
    for i in range(B):
        n = 6 + 3 * i
        ids[i, :n] = (np.arange(n) % 28) + 3
    return ids


def _profiled(fn, tmp_path):
    """fn's result under torch.profiler (CPU) and the exported trace's
    complete events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / f"trace{len(list(tmp_path.iterdir()))}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    return out, events


def _ops_in(events, a, b):
    """Names of the operations that run inside [a, b], in order."""
    return [e["name"] for e in sorted(events, key=lambda e: float(e["ts"]))
            if e.get("cat") == "cpu_op" and a <= float(e["ts"])
            and float(e["ts"]) + float(e["dur"]) <= b]


def _tree(records):
    """{name: parent name} of the kept spans, and their tree ids."""
    by_id = {r.sid: r for r in records}
    return ({r.name: None if r.parent is None else by_id[r.parent].name
             for r in records}, {r.tree for r in records})


def _train(net, seed=0):
    cfg = CFG.replace(dropout_rate=0.05)
    init, make = ((TS.init_text2mel_state, TS.make_text2mel_step)
                  if net == "text2mel" else
                  (TS.init_ssrn_state, TS.make_ssrn_step))
    state = init(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    B = 2
    batch = {"texts": torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                                   (B, cfg.max_N))),
             "text_lens": torch.tensor([12, cfg.max_N], dtype=torch.int32),
             "mel_lens": torch.tensor([18, cfg.max_T], dtype=torch.int32),
             "mels": torch.rand(B, cfg.max_T, cfg.n_mels,
                                generator=torch.Generator().manual_seed(1)),
             "mags": torch.rand(B, cfg.max_T * cfg.r, cfg.n_freq,
                                generator=torch.Generator().manual_seed(2))}
    return state, make(cfg, seed=3), batch


def _params(state):
    return [t.detach().clone() for t in
            TS.tree_leaves(state.params)]


def test_recording_off_keeps_nothing_and_annotates_nothing(synth,
                                                           monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    synth.synthesize_ids_chunked(_ids(), CHUNK)
    state, step, batch = _train("ssrn")
    step(state, batch, torch.Generator())
    assert profiling.RECORDER.records == []
    s = profiling.summary()
    assert s["spans.dropped"] == 0
    assert not [k for k, v in s.items() if isinstance(v, dict)]
    # collect() keeps spans but enters no annotation without the profiler
    with profiling.collect():
        synth.synthesize_ids_chunked(_ids(), CHUNK)
    assert profiling.summary()["synth.rows"]["count"] == 2


def test_synthesis_spans_under_the_profiler(synth, tmp_path):
    ids = _ids()
    wav, events = _profiled(
        lambda: synth.synthesize_ids_chunked(ids, CHUNK), tmp_path)
    records = profiling.RECORDER.records
    tree, trees = _tree(records)
    assert tree == SYNTH_TREE and len(trees) == 1
    s = profiling.summary()
    assert s["synth.call"]["count"] == 1
    assert s["synth.rows"]["count"] == 2 and s["synth.rows"]["n"] == 3
    for name in SYNTH_TREE:
        if name not in ("synth.call", "synth.rows"):
            assert s[name]["count"] == 2, name
        assert s[name]["device_ms"] is None
        assert 0 <= s[name]["host_self_ms"] <= s[name]["host_ms"]
    assert s["synth.call"]["host_ms"] >= s["synth.rows"]["host_ms"]
    assert s["vocoder"]["host_self_ms"] == pytest.approx(
        s["vocoder"]["host_ms"] - s["vocoder.griffin_lim"]["host_ms"])
    # one annotation a span, nested as the spans are
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in SYNTH_TREE]
    assert sorted(e["name"] for e in notes) == sorted(r.name for r in records)
    span = {n: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in notes if e["name"] == n] for n in SYNTH_TREE}
    for child, parent in SYNTH_TREE.items():
        if parent is not None:
            assert all(any(pa <= a and b <= pb for pa, pb in span[parent])
                       for a, b in span[child]), child
    # each stage's annotation encloses the operations its stage runs alone
    first = torch.as_tensor(ids[:CHUNK])
    with torch.no_grad():
        Kt, V = synth.text2mel.text_encode(synth.t2m_params, first)
        Y, _ = fused_decode(synth.packed, Kt.contiguous(), V.contiguous(),
                            CFG.max_T, CFG, synth.decode_prec)
        _, Z = synth.ssrn.apply(synth.ssrn_params, Y)
    alone = {
        "text2mel.text_encode": lambda: synth.text2mel.text_encode(
            synth.t2m_params, first),
        "text2mel.decode": lambda: fused_decode(
            synth.packed, Kt.contiguous(), V.contiguous(), CFG.max_T, CFG,
            synth.decode_prec),
        "ssrn": lambda: synth.ssrn.apply(synth.ssrn_params, Y),
        "vocoder.griffin_lim": lambda: griffin_lim(
            denormalize_mag(Z, CFG), CFG.n_fft, CFG.hop_length,
            CFG.win_length, CFG.n_iter, method=CFG.stft_method)}
    for name, fn in alone.items():
        with torch.no_grad():
            _, own = _profiled(fn, tmp_path)
        ops = _ops_in(own, -np.inf, np.inf)
        assert ops and _ops_in(events, *span[name][0]) == ops, name
    # pcm16 in the vocoder's own time, not in Griffin-Lim's
    (va, vb), (ga, gb) = span["vocoder"][0], span["vocoder.griffin_lim"][0]
    rounds = [e for e in events if e.get("cat") == "cpu_op"
              and e["name"] == "aten::round" and va <= float(e["ts"]) <= vb]
    assert rounds and all(not ga <= float(e["ts"]) <= gb for e in rounds)
    np.testing.assert_array_equal(wav, synth.synthesize_ids_chunked(ids,
                                                                    CHUNK))


@pytest.mark.parametrize("net", ["ssrn", "text2mel"])
def test_training_spans(net):
    state, step, batch = _train(net)
    gen = torch.Generator()
    with profiling.collect():
        for _ in range(2):
            state, _ = step(state, batch, gen)
    records = profiling.RECORDER.records
    by_id = {r.sid: r for r in records}
    roots = [r for r in records if r.parent is None]
    assert [(r.name, r.tree) for r in roots] == [("train.step", 0),
                                                 ("train.step", 1)]
    for r in records:
        if r.parent is not None:
            assert TRAIN_TREE[r.name] == by_id[r.parent].name
            assert r.tree == by_id[r.parent].tree
    s = profiling.summary()
    assert {k: s[k]["count"] for k in TRAIN_TREE} == dict.fromkeys(
        TRAIN_TREE, 2)
    kids = sum(s[k]["host_ms"] for k in TRAIN_TREE if k != "train.step")
    assert s["train.step"]["host_self_ms"] == pytest.approx(
        s["train.step"]["host_ms"] - kids)


def test_results_equal_with_recording_on_and_off(synth, tmp_path):
    ids = _ids()
    off = synth.synthesize_ids_chunked(ids, CHUNK)
    on, _ = _profiled(lambda: synth.synthesize_ids_chunked(ids, CHUNK),
                      tmp_path)
    with profiling.collect():
        collected = synth.synthesize_ids_chunked(ids, CHUNK)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(collected, off)
    for net in ("ssrn", "text2mel"):
        runs = []
        for record in (False, True):
            state, step, batch = _train(net)
            if record:
                _profiled(lambda: step(state, batch, torch.Generator()),
                          tmp_path)
            else:
                step(state, batch, torch.Generator())
            runs.append(_params(state))
        for a, b in zip(*runs):
            assert torch.equal(a, b), net


def test_the_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "cap", 3)
    with profiling.collect():
        with profiling.span("outer", n=4, key="k"):
            for _ in range(4):
                with profiling.span("inner"):
                    pass
    s = profiling.summary()
    assert len(profiling.RECORDER.records) == 3
    assert s["spans.dropped"] == 2
    assert s["outer"]["count"] == 1 and s["outer"]["n"] == 4
    assert s["inner"]["count"] == 2
    assert {r.tree for r in profiling.RECORDER.records} == {"k"}
    profiling.reset()
    assert profiling.summary()["spans.dropped"] == 0


def test_summary_reads_the_launch_counters():
    """What ``count()`` counts reads back in ``counts()`` and
    ``summary()``; ``counts()`` is a copy, in which a name never counted
    reads 0; ``reset_counts()`` clears the store."""
    profiling.reset_counts()
    profiling.count("k1.launches", 7)
    profiling.count("k4.bwd.launches", 2)
    profiling.count("k4.bwd.launches")
    s, c = profiling.summary(), profiling.counts()
    assert s["k1.launches"] == 7 and s["k4.bwd.launches"] == 3
    assert c == {"k1.launches": 7, "k4.bwd.launches": 3}
    assert c["k2.launches"] == 0
    c["k1.launches"] += 1
    assert profiling.counts()["k1.launches"] == 7
    profiling.reset_counts()
    assert profiling.counts() == {}
    assert "k1.launches" not in profiling.summary()


def test_summary_reads_k1_launches_by_exchange():
    """K1's launches by exchange are names of their own beside its total,
    each read back as counted."""
    profiling.reset_counts()
    for exchange, n in (("grid", 2), ("flag", 3)):
        for name in ("k1", f"k1.{exchange}"):
            profiling.count(name + ".launches", n)
    s = profiling.summary()
    assert (s["k1.grid.launches"], s["k1.flag.launches"]) == (2, 3)
    assert s["k1.launches"] == 5
    profiling.reset_counts()
    assert profiling.counts()["k1.grid.launches"] == 0
