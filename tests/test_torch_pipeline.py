"""The whole slice: the port's Synthesizer on the CPU against the JAX
Synthesizer, and the guards around the port.

One JAX run at ``test_config().replace(stft_method="fft")`` (its decode
still runs the fused Pallas kernel, in interpret mode) is the reference for
Y (atol 2e-5, the fused-decode tolerance), Z (1e-4, the golden tolerance)
and the waveform (1e-4): both sides run float32 Griffin-Lim rounds.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.models.ssrn import SSRN as JSSRN
from dc_tts_tpu.models.text2mel import Text2Mel as JText2Mel
from dc_tts_tpu.pipeline import Synthesizer as JSynthesizer

from dc_tts_tpu_torch import synthesize as cli
from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.ops import gl2 as K2
from dc_tts_tpu_torch.params import from_jax_params
from dc_tts_tpu_torch.pipeline import Synthesizer, restore_synthesis_params
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SENTS = os.path.join(ROOT, "harvard_sentences.txt")


@pytest.fixture(scope="module")
def params():
    p1 = JText2Mel(jax_test_config()).init(jax.random.PRNGKey(0))
    p2 = JSSRN(jax_test_config()).init(jax.random.PRNGKey(1))
    ids = np.zeros((3, jax_test_config().max_N), np.int32)
    for i in range(3):
        ids[i, : 6 + 3 * i] = (np.arange(6 + 3 * i) % 28) + 3
    return p1, p2, ids


def test_synthesizer_matches_jax(params):
    p1, p2, ids = params
    jcfg = jax_test_config().replace(stft_method="fft")
    jwav, jY, jZ, jA = (np.asarray(o) for o in
                        JSynthesizer(jcfg, p1, p2).synthesize_ids(ids))
    synth = Synthesizer(test_config().replace(stft_method="fft"),
                        from_jax_params(p1), from_jax_params(p2),
                        device="cpu")
    wav, Y, Z, A = (o.numpy() for o in synth.synthesize_ids(ids))
    np.testing.assert_array_equal(A.argmax(axis=1), jA.argmax(axis=1))
    np.testing.assert_allclose(Y, jY, atol=2e-5, rtol=0)
    np.testing.assert_allclose(Z, jZ, atol=1e-4, rtol=0)
    assert wav.shape == jwav.shape and np.isfinite(wav).all()
    np.testing.assert_allclose(wav, jwav, atol=1e-4, rtol=0)
    # the default stft_method on CPU tensors is the same plain loop
    synth_default = Synthesizer(test_config(), from_jax_params(p1),
                                from_jax_params(p2), device="cpu")
    assert torch.equal(synth_default.synthesize_ids(ids)[0],
                       torch.as_tensor(wav))


def test_chunked_and_pcm16(params):
    """Chunks and whole batches agree to 1 LSB. SSRN runs at "highest":
    the default "high" split rounds its operands to 16 bits, so the
    decode's ~1e-6 batch-size noise moves Z by ~2e-5 there."""
    p1, p2, ids = params
    synth = Synthesizer(test_config(), from_jax_params(p1),
                        from_jax_params(p2), device="cpu", pcm16=True,
                        ssrn_precision="highest")
    whole = synth.synthesize_ids(ids)[0].numpy()
    assert whole.dtype == np.int16
    chunked = synth.synthesize_ids_chunked(ids, chunk=2)
    assert chunked.shape == whole.shape and chunked.dtype == np.int16
    assert np.abs(chunked.astype(np.int32) - whole).max() <= 1
    wavs = synth.synthesize(["Hello there.", "A second, longer sentence."])
    assert len(wavs) == 2 and all(w.dtype == np.float32 for w in wavs)


def test_constructor_refuses_unported_options(params):
    """Every decode mode and precision of the JAX package is ported: only
    an unknown name raises."""
    p1, p2, _ = params
    t1, t2 = from_jax_params(p1), from_jax_params(p2)
    for kw in ({"decode_prec": "high"}, {"decode_prec": "bf16"},
               {"decode_mode": "pipelined"}, {"ssrn_precision": "high3"}):
        with pytest.raises(ValueError):
            Synthesizer(test_config(), t1, t2, device="cpu", **kw)


@pytest.mark.parametrize("mode,prec", [("fused", "hybrid"),
                                       ("fused", "high3"),
                                       ("fused", "default"),
                                       ("reference", "highest")])
def test_synthesizer_decode_modes_and_precisions(params, mode, prec):
    """The Synthesizer packs the decode weights once for its decode_prec
    and decodes as Text2Mel.decode does in that mode and precision."""
    from dc_tts_tpu_torch.models import Text2Mel
    p1, p2, ids = params
    t1 = from_jax_params(p1)
    synth = Synthesizer(test_config(), t1, from_jax_params(p2),
                        device="cpu", decode_mode=mode, decode_prec=prec,
                        pcm16=True)
    if mode == "fused":
        assert synth.packed.keys() == K1.pack_decode_params(
            test_config(), t1, prec).keys()
        assert synth.packed["hcw" if prec != "hybrid" else "hcw2"].dtype \
            == (torch.float32 if prec == "highest" else torch.bfloat16)
    else:
        assert synth.packed is None
    before = profiling.counts()
    wav, Y, Z, A = synth.synthesize_ids(ids)
    assert profiling.counts() == before
    Yd, Ad = Text2Mel(test_config()).decode(t1, torch.as_tensor(ids),
                                            mode=mode, prec=prec)
    assert torch.equal(Y, Yd) and torch.equal(A, Ad)
    assert wav.dtype == torch.int16 and wav.shape[0] == ids.shape[0]
    assert bool(torch.isfinite(Z).all())


def test_from_checkpoints(params, tmp_path):
    """Text2Mel from logdir1 and SSRN from logdir2, with the constructor's
    options."""
    from dc_tts_tpu_torch.train import checkpoint
    p1, p2, ids = params
    t1, t2 = from_jax_params(p1), from_jax_params(p2)
    checkpoint.save(str(tmp_path / "l1"), t1, 1000)
    checkpoint.save(str(tmp_path / "l2"), t2, 2000)
    synth = Synthesizer.from_checkpoints(
        test_config(), str(tmp_path / "l1"), str(tmp_path / "l2"),
        device="cpu", decode_prec="hybrid")
    assert synth.decode_prec == "hybrid" and "cw2" in synth.packed
    direct = Synthesizer(test_config(), t1, t2, device="cpu",
                         decode_prec="hybrid")
    for got, want in zip(synth.synthesize_ids(ids),
                         direct.synthesize_ids(ids)):
        assert torch.equal(got, want)


def test_entry_points_need_cuda_unless_asked_for_cpu(params, tmp_path):
    """Without a CUDA device, the default device raises before any work:
    nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p1, p2, _ = params
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(test_config(), from_jax_params(p1), from_jax_params(p2))
    out = tmp_path / "wavs"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--tiny", "--random-weights", "--sentences", SENTS,
                  "--out", str(out)])
    assert not out.exists()


def test_cli_on_cpu_and_refused_flags(tmp_path):
    """--mesh runs as one rank without torchrun and writes what the plain
    run writes; the JAX CLI's usage errors: the parallel modes with each
    other or with an option they fix, and a reduced --decode-precision
    with --mode incremental or reference."""
    out = tmp_path / "wavs"
    cli.main(["--tiny", "--random-weights", "--device", "cpu",
              "--sentences", SENTS, "--out", str(out)])
    assert len(list(out.glob("*.wav"))) == 40
    cli.main(["--tiny", "--random-weights", "--device", "cpu", "--mesh",
              "--sentences", SENTS, "--out", str(tmp_path / "mesh")])
    for i in (1, 40):
        assert (tmp_path / "mesh" / f"{i}.wav").read_bytes() == \
            (out / f"{i}.wav").read_bytes()
    for flag in (["--pipeline", "--mesh"], ["--pipeline", "--plots"],
                 ["--pipeline", "--mode", "incremental"],
                 ["--pipeline", "--decode-precision", "hybrid"],
                 ["--time-shard", "2", "--mesh"],
                 ["--time-shard", "2", "--pipeline"],
                 ["--time-shard", "2", "--ssrn-precision", "bf16"],
                 ["--time-shard", "2", "--plots"],
                 ["--mode", "incremental", "--decode-precision", "hybrid"],
                 ["--mode", "reference", "--decode-precision", "high3"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--tiny", "--random-weights", "--device", "cpu",
                      "--out", str(tmp_path / "no"), *flag])
        assert e.value.code == 2
    assert not (tmp_path / "no").exists()


@pytest.mark.parametrize("flags", [["--mode", "reference"],
                                   ["--decode-precision", "high3"],
                                   ["--decode-precision", "hybrid",
                                    "--plots"]])
def test_cli_decode_modes_and_plots(tmp_path, flags):
    sents = tmp_path / "three.txt"
    sents.write_text("header\n1. The birch canoe slid on the smooth planks."
                     "\n2. Glue the sheet to the dark blue background.\n"
                     "3. It is easy to tell the depth of a well.\n")
    out = tmp_path / "wavs"
    cli.main(["--tiny", "--random-weights", "--device", "cpu",
              "--sentences", str(sents), "--out", str(out), *flags])
    assert sorted(p.name for p in out.glob("*.wav")) == [
        "1.wav", "2.wav", "3.wav"]
    if "--plots" in flags:
        pytest.importorskip("matplotlib")
        assert sorted(p.name for p in out.glob("*.png")) == [
            f"alignment_utt{i}.png" for i in (1, 2, 3)]


def test_restore_synthesis_params_from_jax_checkpoints(params, tmp_path):
    """Text2Mel from logdir1 and SSRN from logdir2, as the JAX package
    saves them, restore bit for bit."""
    from dc_tts_tpu.train import checkpoint as jckpt
    p1, p2, _ = params
    jckpt.save(str(tmp_path / "l1"), p1, step=1000)
    jckpt.save(str(tmp_path / "l2"), p2, step=2000)
    t1, t2 = restore_synthesis_params(test_config(), str(tmp_path / "l1"),
                                      str(tmp_path / "l2"))
    for got, want in ((t1, p1), (t2, p2)):
        got_leaves = jax.tree_util.tree_leaves(got)
        want_leaves = jax.tree_util.tree_leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port and run a tiny CPU synthesis, also
    data-parallel over a one-rank gloo group, in a process where importing
    jax or dc_tts_tpu fails."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["dc_tts_tpu"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        import dc_tts_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from dc_tts_tpu_torch import Synthesizer, test_config
        from dc_tts_tpu_torch.models import SSRN, Text2Mel
        cfg = test_config()
        gen = torch.Generator().manual_seed(0)
        s = Synthesizer(cfg, Text2Mel(cfg).init(gen), SSRN(cfg).init(gen),
                        device="cpu")
        ids = np.zeros((2, cfg.max_N), np.int32)
        ids[:, :5] = 7
        wav = s.synthesize_ids(ids)[0]
        assert wav.shape == (2, cfg.hop_length * (cfg.max_T_full - 1))
        assert bool(torch.isfinite(wav).all())
        import os, tempfile, torch.distributed as dist
        from dc_tts_tpu_torch.parallel import distributed, make_mesh
        with tempfile.TemporaryDirectory() as tmp:
            assert distributed.initialize(
                num_processes=1, process_id=0, device="cpu",
                init_method="file://" + os.path.join(tmp, "store"))
            mesh = make_mesh()
            assert dist.get_backend(mesh.groups["data"]) == "gloo"
            dp = Synthesizer(cfg, s.t2m_params, s.ssrn_params,
                             device="cpu", mesh=mesh)
            assert torch.equal(dp.synthesize_ids(ids)[0], wav)
            dist.destroy_process_group()
        assert not any(k == "jax" or k.startswith(("jax.", "dc_tts_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_wrappers_take_plain_versions_on_cpu():
    """The kernel wrappers choose by the tensor's device alone: CPU tensors
    run the plain versions and count no launch."""
    cfg = test_config()
    gen = torch.Generator().manual_seed(1)
    from dc_tts_tpu_torch.models import Text2Mel
    p = Text2Mel(cfg).init(gen)
    Kt = torch.randn(2, cfg.max_N, cfg.d, generator=gen)
    V = torch.randn(2, cfg.max_N, cfg.d, generator=gen)
    packed = K1.pack_decode_params(cfg, p)
    g = K2.gl2_geometry(cfg.n_fft, cfg.hop_length, cfg.win_length, 40)
    mag = K2.scramble_mag(torch.rand(2, 40, cfg.n_freq, generator=gen), g)
    consts = K2.gl2_consts(cfg.n_fft, cfg.hop_length, cfg.win_length, 40)
    before = profiling.counts()
    assert all(torch.equal(a, b) for a, b in zip(
        K1.fused_decode(packed, Kt, V, 4, cfg),
        K1.fused_decode_plain(packed, Kt, V, 4, cfg)))
    assert torch.equal(K2.gl2_run(mag, consts, g, 2),
                       K2.gl2_run_plain(mag, consts, g, 2))
    assert profiling.counts() == before
