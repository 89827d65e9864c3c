"""Kernel K5's CPU side (``ops/ssrn_block.py``): the plain version bit for
bit ``blocks.apply_block`` in the "high" operand mode for every block kind
SSRN has (and a causal HC), the prologue's plain layout, the weight halves
``pack_weights`` splits once, ``SSRN.apply``'s routing (``takes_k5``: what
the call can observe, never a CPU tensor, training, gradients, another
operand mode or a model group), the synthesizer packing the halves once,
and the ``k5.launches`` counter. TextEnc's side: the epilogue's arithmetic
in PyTorch (``tail_plain``) against ``blocks.apply_block`` in the float32
operand mode at 1e-6 x max(1, max|y|), ``Text2Mel.text_encode``'s routing
(``text2mel.takes_k5``: synthesis on the card in the float32 mode only),
the route forced open on the CPU against the eager chain, and
``float32_block``'s refusals. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dc_tts_tpu_torch import pipeline
from dc_tts_tpu_torch.bench import seeded_nets
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.dsp.stft import split_bf16
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.models import blocks
from dc_tts_tpu_torch.models import ssrn as ssrn_mod
from dc_tts_tpu_torch.models import text2mel as t2m_mod
from dc_tts_tpu_torch.models.blocks import C, D, HC
from dc_tts_tpu_torch.ops import ssrn_block as K5
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = test_config()
# (spec, C_in): every kind of block SSRN has, and a causal HC
SPECS = {"C-linear": (C(1, 1, 129, None), 48),
         "C-relu": (C(1, 1, None, "relu"), 129),
         "HC-rate1": (HC(3, 1), 48),
         "HC-rate3": (HC(3, 3), 48),
         "HC-causal": (HC(3, 3, causal=True), 48),
         "D": (D(3), 48)}
# (B, T, width scale): the benchmark's rehearsal sizes (c 48, n_freq 129,
# max_T 24), then a larger one
SIZES = {"rehearsal": (2, 24, 1), "larger": (3, 40, 4)}


def _block(spec, cin, seed):
    """One block's parameters, every leaf moved by 0.1 x N(0, 1) so that no
    bias is 0 and no norm's gain is 1."""
    gen = torch.Generator().manual_seed(seed)
    (p,), _ = blocks.init_stack(gen, cin, [spec])
    return {k: {n: t + 0.1 * torch.randn(t.shape, generator=gen)
                for n, t in v.items()} for k, v in p.items()}


def _scaled(spec, cin, k):
    if isinstance(spec, C) and spec.out_ch:
        spec = C(spec.size, spec.rate, spec.out_ch * k + (k > 1), spec.act)
    return spec, cin * k + (k > 1 and cin % 2)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(SPECS))
def test_plain_is_apply_block_bitwise(name, size):
    B, T, k = SIZES[size]
    spec, cin = _scaled(*SPECS[name], k)
    p = _block(spec, cin, seed=len(name) + k)
    x = torch.randn(B, T, cin, generator=torch.Generator().manual_seed(k))
    halves = K5.pack_weights([p], [spec])[0]
    with torch.no_grad():
        want = blocks.apply_block(p, spec, x, ln_eps=CFG.ln_eps,
                                  dtype="high")
        got = K5.ssrn_block(p, spec, x, halves, CFG.ln_eps)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(SPECS))
def test_prologue_plain_layout(name):
    """Rows of taps zero-padded to a multiple of 8: a C or HC block's the
    gathered taps of each time step, a D block's x then x_prev."""
    spec, cin = SPECS[name]
    x = torch.randn(2, 7, cin, generator=torch.Generator().manual_seed(3))
    K = K5._taps_width(spec, cin)
    Kp = K5._ceil(K)
    hi, lo = K5.prologue_plain(x, spec, Kp)
    if isinstance(spec, D):
        prev = torch.cat([torch.zeros(2, 1, cin), x[:, :-1]], dim=1)
        taps = torch.cat([x.reshape(14, cin), prev.reshape(14, cin)])
    else:
        from dc_tts_tpu_torch.models.layers import _gather_taps
        taps = _gather_taps(x, spec.size, spec.rate,
                            spec.causal).reshape(14, -1)
    h, lw = split_bf16(taps)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == (taps.shape[0], Kp) and Kp % 8 == 0
    assert torch.equal(hi[:, :K], h) and torch.equal(lo[:, :K], lw)
    assert not hi[:, K:].any() and not lo[:, K:].any()


def test_pack_weights_are_split_bf16_of_the_kernels():
    params = seeded_nets(CFG)[1]["stack"]
    specs = ssrn_mod.ssrn_specs(CFG)
    packed = K5.pack_weights(params, specs)
    assert len(packed) == len(specs) == 16
    for p, spec, (hi, lo) in zip(params, specs, packed):
        w = p["conv"]["w"]
        K, cin, cout = w.shape
        mats = w if isinstance(spec, D) else w.reshape(K * cin, cout)
        assert hi.shape[-2:] == (K5._ceil(mats.shape[-2]), K5._ceil(cout))
        for got, want in zip((hi, lo), split_bf16(mats)):
            full = torch.zeros_like(got)
            full[..., :mats.shape[-2], :cout] = want
            assert torch.equal(got, full)


def test_pack_is_none_outside_the_high_mode():
    params = seeded_nets(CFG)[1]
    assert SSRN(CFG).pack(params) is None
    assert SSRN(CFG.replace(compute_dtype="bfloat16")).pack(params) is None
    assert len(SSRN(CFG.replace(compute_dtype="float32_high")).pack(
        params)) == 16


def _on_cuda():
    return SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case", ["k5", "cpu", "train", "grad", "float32",
                                  "bf16", "bf16_full", "group"])
def test_takes_k5_only_in_synthesis_on_the_card(case):
    kw = dict(Y=_on_cuda(), train=False, dtype="high", act_dtype=None,
              model_group=None)
    if case == "cpu":
        kw["Y"] = torch.zeros(1)
    elif case == "train":
        kw["train"] = True
    elif case in ("float32", "bf16", "bf16_full"):
        compute = {"float32": "float32", "bf16": "bfloat16",
                   "bf16_full": "bfloat16_full"}[case]
        kw["dtype"], kw["act_dtype"] = blocks.operand_modes(compute)
    elif case == "group":
        kw["model_group"] = object()
    with torch.set_grad_enabled(case == "grad"):
        assert ssrn_mod.takes_k5(**kw) == (case == "k5")


@pytest.mark.parametrize("compute", ["float32", "float32_high", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_cpu_calls_never_reach_k5(monkeypatch, compute, train):
    calls = []
    monkeypatch.setattr(ssrn_mod, "ssrn_stack",
                        lambda *a, **k: calls.append(a))
    model = SSRN(CFG.replace(compute_dtype=compute))
    params = seeded_nets(CFG)[1]
    Y = torch.randn(1, 6, CFG.n_mels)
    with torch.no_grad():
        logits, Z = model.apply(params, Y, train=train,
                                gen=torch.Generator().manual_seed(0),
                                packed=model.pack(params))
    assert not calls and Z.shape == (1, 24, CFG.n_freq)


def test_apply_through_k5_stack_is_the_eager_chain(monkeypatch):
    """With the route forced open on the CPU, ``SSRN.apply`` runs the whole
    stack through ``ssrn_block`` (its plain version here), packing when
    not given the halves: bitwise the eager chain's logits and Z."""
    model = SSRN(CFG.replace(compute_dtype="float32_high"))
    params = seeded_nets(CFG)[1]
    Y = torch.randn(2, 6, CFG.n_mels,
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model.apply(params, Y)
        monkeypatch.setattr(ssrn_mod, "takes_k5", lambda *a: True)
        seen = []
        real = K5.ssrn_block
        monkeypatch.setattr(K5, "ssrn_block",
                            lambda p, s, x, h, e: seen.append(s)
                            or real(p, s, x, h, e))
        for packed in (None, model.pack(params)):
            got = model.apply(params, Y, packed=packed)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert seen == list(ssrn_mod.ssrn_specs(CFG)) * 2


def test_synthesizer_packs_the_halves_once(monkeypatch):
    """Built once per Synthesizer, handed to every ``SSRN.apply`` call."""
    packs, applied = [], []
    real_pack, real_apply = SSRN.pack, SSRN.apply

    def pack(self, params):
        packs.append(self)
        return real_pack(self, params)

    def apply(self, params, Y, **kw):
        applied.append(kw.get("packed"))
        return real_apply(self, params, Y, **kw)

    monkeypatch.setattr(SSRN, "pack", pack)
    monkeypatch.setattr(SSRN, "apply", apply)
    synth = pipeline.Synthesizer(CFG, *seeded_nets(CFG), device="cpu",
                                 decode_mode="incremental")
    rng = np.random.default_rng(0)
    ids = rng.integers(2, CFG.vocab_size, (2, CFG.max_N))
    synth.synthesize_ids(ids)
    synth.synthesize_ids_chunked(ids, 1)
    assert len(packs) == 1 and len(applied) == 3
    assert all(a is synth.ssrn_packed for a in applied)
    assert len(synth.ssrn_packed) == 16
    other = pipeline.Synthesizer(CFG, *seeded_nets(CFG), device="cpu",
                                 decode_mode="incremental",
                                 ssrn_precision="highest")
    assert other.ssrn_packed is None


def test_k5_launches_in_the_summary():
    profiling.reset_counts()
    profiling.count("k5.launches", 6)
    assert profiling.summary()["k5.launches"] == 6
    assert profiling.counts()["k5.launches"] == 6
    profiling.reset_counts()
    assert "k5.launches" not in profiling.summary()


def test_cuda_wrapper_refuses_other_devices():
    p = _block(HC(3, 1), 8, seed=1)
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K5.ssrn_block(p, HC(3, 1), x, K5.pack_weights([p], [HC(3, 1)])[0],
                      1e-5)


# ---------------------------------------------------------------------------
# TextEnc: float32 products, the tail in K5's epilogue

# (spec, C_in): every kind of block TextEnc has, and a causal HC
TEXTENC_SPECS = {"C-relu": (C(1, 1, 96, "relu"), 40),
                 "C-linear": (C(1, 1, None, None), 96),
                 "HC-rate1": (HC(3, 1), 48),
                 "HC-rate9": (HC(3, 9), 48),
                 "HC-size1": (HC(1, 1), 48),
                 "HC-causal": (HC(3, 3, causal=True), 48)}


def _tail_gap(got, want):
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(TEXTENC_SPECS))
def test_tail_plain_is_apply_block_in_float32(name, size):
    """The epilogue's arithmetic on the block's own float32 product, and
    ``float32_block`` on the CPU, within 1e-6 x max(1, max|y|) of
    ``apply_block`` (only the norms' sums and the gate's rounding
    differ)."""
    from dc_tts_tpu_torch.models.layers import _gather_taps
    B, T, k = SIZES[size]
    spec, cin = _scaled(*TEXTENC_SPECS[name], k)
    p = _block(spec, cin, seed=len(name) + 7 * k)
    x = torch.randn(B, T, cin, generator=torch.Generator().manual_seed(k))
    w = p["conv"]["w"]
    with torch.no_grad():
        want = blocks.apply_block(p, spec, x, ln_eps=CFG.ln_eps)
        P = _gather_taps(x, spec.size, spec.rate, spec.causal) @ \
            w.reshape(-1, w.shape[-1])
        got = K5.tail_plain(p, spec, P, x, CFG.ln_eps)
        block = K5.float32_block(p, spec, x, CFG.ln_eps)
    assert got.shape == want.shape == block.shape
    assert torch.equal(block, got)
    assert _tail_gap(got, want) <= 1e-6


@pytest.mark.parametrize("case", ["k5", "cpu", "train", "grad", "high",
                                  "bf16", "bf16_full", "group"])
def test_text_encode_takes_k5_only_in_float32_synthesis_on_the_card(case):
    kw = dict(x=_on_cuda(), train=False, dtype=None, act_dtype=None,
              model_group=None)
    if case == "cpu":
        kw["x"] = torch.zeros(1)
    elif case == "train":
        kw["train"] = True
    elif case in ("high", "bf16", "bf16_full"):
        compute = {"high": "float32_high", "bf16": "bfloat16",
                   "bf16_full": "bfloat16_full"}[case]
        kw["dtype"], kw["act_dtype"] = blocks.operand_modes(compute)
    elif case == "group":
        kw["model_group"] = object()
    with torch.set_grad_enabled(case == "grad"):
        assert t2m_mod.takes_k5(**kw) == (case == "k5")


@pytest.mark.parametrize("compute", ["float32", "float32_high", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_cpu_text_encode_never_takes_the_route(monkeypatch, compute, train):
    calls = []
    monkeypatch.setattr(t2m_mod, "float32_stack",
                        lambda *a, **k: calls.append(a))
    model = Text2Mel(CFG.replace(compute_dtype=compute))
    params = seeded_nets(CFG)[0]
    ids = torch.randint(2, CFG.vocab_size, (2, CFG.max_N),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        K, V = model.text_encode(params, ids, train=train,
                                 gen=torch.Generator().manual_seed(0))
    assert not calls and K.shape == V.shape == (2, CFG.max_N, CFG.d)


def test_text_encode_through_the_route_is_the_eager_chain(monkeypatch):
    """With the route forced open on the CPU, ``text_encode`` runs every
    TextEnc block through ``float32_block`` (``tail_plain`` here): K and
    V within 1e-5 x max(1, max|K|) of the eager chain's over the 14
    blocks, each block's within 1e-6 of ``apply_block`` on its own
    input."""
    model = Text2Mel(CFG)
    params = seeded_nets(CFG)[0]
    ids = torch.randint(2, CFG.vocab_size, (3, CFG.max_N),
                        generator=torch.Generator().manual_seed(4))
    seen = []
    real = K5.float32_block

    def block(p, spec, x, eps):
        y = real(p, spec, x, eps)
        seen.append(_tail_gap(y, blocks.apply_block(p, spec, x, ln_eps=eps)))
        return y

    with torch.no_grad():
        want = model.text_encode(params, ids)
        monkeypatch.setattr(t2m_mod, "takes_k5", lambda *a: True)
        monkeypatch.setattr(K5, "float32_block", block)
        got = model.text_encode(params, ids)
    assert len(seen) == len(t2m_mod.text_enc_specs(CFG)) == 14
    assert max(seen) <= 1e-6
    scale = max(1.0, *(float(t.abs().max()) for t in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_float32_block_refuses_d_blocks_and_other_devices():
    p = _block(HC(3, 1), 8, seed=2)
    with pytest.raises(ValueError, match="unsupported device"):
        K5.float32_block(p, HC(3, 1), torch.zeros(1, 4, 8, device="meta"),
                         1e-5)
    d = _block(D(3), 8, seed=3)
    with pytest.raises(TypeError, match="not a C or HC block"):
        K5.float32_block(d, D(3), torch.zeros(1, 4, 8), 1e-5)
