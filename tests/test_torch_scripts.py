"""The port's entry points beside the package, on the CPU at the tiny config:
``dc_tts_tpu_torch.bench`` (the JSON line, its sample count against the JAX
``Synthesizer``'s, a failure ending the run without a value) and the
scripts ``bench_train``, ``profile_stages``, ``bench_variants`` and
``scaling_bench`` (two spawned gloo ranks)."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch import bench
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.parallel.distributed import run_ranks
from dc_tts_tpu_torch.scripts import (bench_train, bench_variants,
                                      profile_stages, scaling_bench)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py:155-175's keys, and the card's name and power limit
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "delivery",
              "value_device", "rep_times_device_s", "stft_method",
              "sentences", "chunk", "reps", "rep_times_s", "rep_spread",
              "card"}
TINY_ENV = {"BENCH_SENTENCES": "4", "BENCH_CHUNK": "2", "BENCH_REPS": "1"}


def _jax_samples(n_sentences: int) -> int:
    """Samples of the JAX Synthesizer's pcm16 output for the tiny config
    and the bench's first ``n_sentences`` (shapes only: nothing runs)."""
    from dc_tts_tpu.config import test_config as jax_test_config
    from dc_tts_tpu.models.ssrn import SSRN
    from dc_tts_tpu.models.text2mel import Text2Mel
    from dc_tts_tpu.pipeline import Synthesizer

    cfg = jax_test_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    synth = Synthesizer(cfg, Text2Mel(cfg).init(k1), SSRN(cfg).init(k2),
                        pcm16=True)
    ids = bench.bench_ids(test_config(), n_sentences)
    wav = jax.eval_shape(synth._synth_fn, synth.t2m_params,
                         synth.ssrn_params, ids, synth._gl_mats)[0]
    return int(np.prod(wav.shape))


def test_bench_json_line(monkeypatch, capsys):
    for k, v in TINY_ENV.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu", "--tiny"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == BENCH_KEYS
    assert (r["metric"], r["unit"], r["delivery"], r["card"]) == (
        "audio_seconds_per_second_per_chip", "audio-s/s", "pcm16", "cpu")
    assert (r["sentences"], r["chunk"], r["reps"]) == (4, 2, 1)
    assert r["stft_method"] == "dft_pallas2"
    for k in ("value", "value_device", "vs_baseline"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert len(r["rep_times_s"]) == len(r["rep_times_device_s"]) == 1
    # the samples behind value are the JAX Synthesizer's for this workload
    samples = r["value"] * float(np.median(r["rep_times_s"])) * \
        test_config().sr
    assert samples == pytest.approx(_jax_samples(4), rel=1e-9)
    with open(os.path.join(ROOT, "baseline_cpu.json")) as f:
        baseline = json.load(f)["audio_s_per_s"]
    assert r["vs_baseline"] == pytest.approx(r["value"] / baseline)


def test_bench_failure_exits_non_zero_without_a_value():
    """A synthesis that raises ends the run with a non-zero code and
    prints no value (there is no fallback)."""
    code = textwrap.dedent("""
        import sys
        from dc_tts_tpu_torch import bench, pipeline

        def boom(self, ids):
            raise RuntimeError("injected synthesis failure")

        pipeline.Synthesizer._synthesize_rows = boom
        sys.exit(bench.main(["--device", "cpu", "--tiny"]))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, **TINY_ENV},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "injected synthesis failure" in res.stderr
    assert '"value"' not in res.stdout


def test_bench_train_one_variant_of_each_network():
    cfg = test_config()
    batch = bench_train.synth_batch(cfg, 7, "cpu")
    rows = [bench_train.bench_step(label, vcfg, which, batch, "cpu", iters=1)
            for label, which, vcfg, _ in bench_train.variants(cfg)
            if label in ("t2m f32 pallas-vjp", "ssrn bf16 convs")]
    assert [r["label"] for r in rows] == ["t2m f32 pallas-vjp",
                                          "ssrn bf16 convs"]
    for r in rows:
        assert np.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0
        assert r["fenced_ms"] > 0 and r["train_flops"] > 0
        assert r["mfu"] is None                 # no card: not measured


def test_profile_stages(capsys):
    r = profile_stages.profile(test_config(), torch.device("cpu"), reps=1)
    assert r["batch"] == 40 and set(r["ms"]) == set(profile_stages.STAGES)
    assert all(v > 0 for v in r["ms"].values())
    assert sum(r["share"].values()) == pytest.approx(1.0)
    assert all(f > 0 for f in r["flops"].values())
    assert all(v is None for v in r["mfu"].values())
    assert profile_stages.main(["--tiny", "--device", "cpu",
                                "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert all(k in out for k in profile_stages.STAGES)


def test_bench_variants_two_methods(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ONLY", "fft GL,dft_pallas2")
    assert bench_variants.main(["--tiny", "--device", "cpu",
                                "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("batch 40")
    assert [ln.split("  ")[0].strip() for ln in lines[1:]] == [
        "fft GL, f32 convs", "dft_pallas2 GL, f32 convs (default)"]
    assert all(ln.endswith("audio-s/s") for ln in lines[1:])


def test_scaling_bench_on_two_gloo_ranks(capfd):
    """Sizes 1 and 2 on two spawned ranks: a result and a printed line a
    size; rank 0's rows at size 2 are size 1's rows, bitwise."""
    out = run_ranks(scaling_bench.run, 2, args=(True, 2, "cpu", 1))
    printed = [ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("devices=")]
    assert [ln.split()[0:2] for ln in printed] == [["devices=", "1"],
                                                   ["devices=", "2"]]
    r0, r1 = out
    assert [r["devices"] for r in r0] == [1, 2]
    assert r1[0] is None and r1[1]["devices"] == 2      # rank 1: size 2
    one, two = r0
    assert (one["batch"], two["batch"]) == (2, 4)
    assert two["wav"].shape[0] == 4
    np.testing.assert_array_equal(two["wav"][:2], one["wav"])
    assert one["efficiency"] == 1.0 and two["audio_s_per_s"] > 0
