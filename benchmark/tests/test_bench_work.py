"""The frozen counters against the repository's own figures at the
published sizes (base_config): K1 57.1 GFLOP and K2 95.6 GFLOP at B = 20
(PERF.md's kernel table, chip_smoke.py's counts), TextEnc's 246 GFLOP at
B = 40 (profile_stages: MFU 36.1 % of 67 TFLOP/s in 10.178 ms), the
training steps' 3 x forward (bench_train: 18.5 % of 67 TFLOP/s in 69.9
ms, 42.9 % in 131.5 ms), and the port's own conv counter, leaf for leaf."""
import json
import math
import os

import pytest

from benchmark.harness import work
from benchmark.reference import dctts as R

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(HERE, "..", "configs", "dctts_lj.synth.json")) as f:
        return json.load(f)["sizes"]


@pytest.mark.parametrize("name,value,figure,rel", [
    ("k1", lambda c: work.k1_flops(c, 20), 57.1e9, 1e-3),
    ("k2", lambda c: work.k2_flops(c, 20), 95.6e9, 1e-3),
    ("text_enc", lambda c: work.text_enc_flops(c, 40, 180),
     0.361 * 67e12 * 10.178e-3, 2e-3),
    ("train_text2mel", lambda c: work.train_flops(c, "text2mel", 32, 180, 210),
     0.185 * 67e12 * 69.9e-3, 5e-3),
    ("train_ssrn", lambda c: work.train_flops(c, "ssrn", 32, 180, 210),
     0.429 * 67e12 * 131.5e-3, 5e-3),
])
def test_counts_match_the_repos_figures(cfg, name, value, figure, rel):
    assert value(cfg) == pytest.approx(figure, rel=rel)


def test_conv_counter_is_the_ports(cfg):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs
    from dc_tts_tpu_torch.models.text2mel import (audio_dec_specs,
                                                  audio_enc_specs,
                                                  text_enc_specs)
    from dc_tts_tpu_torch.utils.profiling import conv_stack_flops
    pc = base_config()
    pairs = [(R.text_enc(cfg), text_enc_specs(pc), cfg["e"], 180),
             (R.audio_enc(cfg), audio_enc_specs(pc), cfg["n_mels"], 210),
             (R.audio_dec(cfg), audio_dec_specs(pc), 2 * cfg["d"], 210),
             (R.ssrn(cfg), ssrn_specs(pc), cfg["n_mels"], 210)]
    for mine, theirs, cin, t in pairs:
        assert work.conv_stack_flops(7, t, mine, cin) == \
            conv_stack_flops(7, t, theirs, cin)


def test_parameter_layout_is_the_ports(cfg):
    import torch

    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models.ssrn import SSRN
    from dc_tts_tpu_torch.models.text2mel import Text2Mel
    from benchmark.harness.inputs import flatten
    pc = base_config()
    for net, model in (("text2mel", Text2Mel(pc)), ("ssrn", SSRN(pc))):
        theirs = flatten(model.init(torch.Generator().manual_seed(0)))
        assert {k: tuple(v.shape) for k, v in theirs.items()} == \
            R.param_shapes(cfg, net)


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(1, 3.35e12) == pytest.approx(1.0)


def test_bulk_chunk_work(cfg):
    st = work.synth_stages(cfg, 72, 180)
    total = sum(f for f, _ in st.values())
    assert 3.5e12 < total < 4.0e12          # ~3.8 TFLOP a chunk of 72
    assert work.n_samples(cfg) == 230725
    assert math.isclose(work.k2_flops(cfg, 72), 72 / 20 * 95.56e9,
                        rel_tol=1e-3)
