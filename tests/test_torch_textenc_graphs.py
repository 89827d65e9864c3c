"""TextEnc's graph cache (``pipeline.GraphCache``, ``text_encode_graphs``)
on the CPU: ``Text2Mel.decode``'s ``text_encoder`` hook against the default
path in every mode, the CPU Synthesizer's eager TextEnc (no capture), and
the cache's rule (a graph a shape, the least recently used shape evicted,
each call's input copied in before the replay) with capture stubbed out.
The captured graphs themselves run on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch import pipeline
from dc_tts_tpu_torch.bench import seeded_nets
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.models import Text2Mel
from dc_tts_tpu_torch.pipeline import GraphCache, Synthesizer
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()


def _ids(B, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, CFG.max_N), np.int64)
    for i in range(B):
        n = int(rng.integers(3, CFG.max_N))
        ids[i, :n] = rng.integers(2, CFG.vocab_size, n)
    return ids


@pytest.mark.parametrize("mode", ["incremental", "fused", "reference"])
def test_decode_text_encoder_hook_matches_default(mode):
    """``decode(..., text_encoder=fn)`` calls fn once in TextEnc's place
    and decodes to the default path's Y and A."""
    model = Text2Mel(CFG)
    params = seeded_nets(CFG)[0]
    ids = torch.as_tensor(_ids(2))
    calls = []

    def encoder(x):
        calls.append(x)
        return tuple(t.contiguous() for t in model.text_encode(params, x))

    with torch.no_grad():
        Y, A = model.decode(params, ids, 6, mode=mode)
        Yh, Ah = model.decode(params, ids, 6, mode=mode,
                              text_encoder=encoder)
    assert len(calls) == 1 and calls[0] is ids
    assert torch.equal(Yh, Y) and torch.equal(Ah, A)


def test_cpu_synthesizer_never_captures():
    """A CPU Synthesizer keeps no text encoder and counts no capture,
    replay or launch. A shape's first de-emphasis builds its tables, counted
    once a process (``deemphasis.table_uploads``) by whichever call came
    first, another test's included: so the first call may move that
    counter alone, and a second call of the shape moves none."""
    synth = Synthesizer(CFG, *seeded_nets(CFG), device="cpu",
                        decode_mode="incremental")
    before = profiling.counts()
    synth.synthesize_ids(_ids(1))
    assert set(profiling.counts() - before) <= {"deemphasis.table_uploads"}
    before = profiling.counts()
    synth.synthesize_ids(_ids(1))
    assert synth.text_encoder is None
    assert profiling.counts() == before


class _Replay:
    """A stand-in for a captured graph: replay() runs fn on the static
    input into the static outputs."""

    def __init__(self, fn, x, outs):
        self.fn, self.x, self.outs = fn, x, outs

    def replay(self):
        for o, new in zip(self.outs, self.fn(self.x)):
            o.copy_(new)


class _StubCache(GraphCache):
    def _capture(self, x):
        static_x = x.clone()
        outs = tuple(o.clone() for o in self.fn(static_x))
        return static_x, _Replay(self.fn, static_x, outs), outs


def _cache(capacity):
    profiling.reset_counts()
    return _StubCache(lambda x: (2 * x, x + 1), capacity, "stub")


def _graph_counts():
    c = profiling.counts()
    return c["stub.captures"], c["stub.replays"]


def test_graph_cache_one_graph_a_shape_fresh_input_each_call():
    """Two inputs of one shape: one capture, two replays, the static
    outputs handed back each time and holding the second input's result."""
    cache = _cache(2)
    a, b = torch.arange(6.).reshape(2, 3), -torch.arange(6.).reshape(2, 3)
    first = cache(a)
    assert torch.equal(first[0], 2 * a)
    second = cache(b)
    assert _graph_counts() == (1, 2)
    assert all(s is f for s, f in zip(second, first))
    assert torch.equal(second[0], 2 * b) and torch.equal(second[1], b + 1)
    assert list(cache.graphs) == [(2, 3)]


def test_graph_cache_evicts_the_least_recently_used_shape():
    """Capacity 2, shapes a b a c b: c evicts b (a was used after it), b
    evicts a and is captured again, and computes from its own input."""
    cache = _cache(2)
    x = {k: torch.full((k, 2), float(k)) for k in (1, 2, 3)}
    for k in (1, 2, 1, 3):
        cache(x[k])
    assert list(cache.graphs) == [(1, 2), (3, 2)]
    out = cache(x[2] + 5)
    assert list(cache.graphs) == [(3, 2), (2, 2)]
    assert _graph_counts() == (4, 5)
    assert torch.equal(out[0], 2 * (x[2] + 5))


def test_text_encode_graphs_counts_on_the_function(monkeypatch):
    """The Synthesizer's cache counts its captures and replays as
    ``textenc.graph.captures`` and ``.replays`` (what
    ``profiling.summary()`` reads), and holds ``TEXTENC_GRAPHS`` shapes."""
    monkeypatch.setattr(GraphCache, "_capture", _StubCache._capture)
    cache = pipeline.text_encode_graphs(Text2Mel(CFG), seeded_nets(CFG)[0])
    ids = torch.as_tensor(_ids(1))
    profiling.reset_counts()
    cache(ids)
    cache(ids)
    s = profiling.summary()
    assert (s["textenc.graph.captures"], s["textenc.graph.replays"]) == (1, 2)
    assert cache.capacity == pipeline.TEXTENC_GRAPHS
