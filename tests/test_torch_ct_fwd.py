"""The forward-rDFT prototypes X1-X4 (``dc_tts_tpu_torch/ops/ct_fwd.py``) and
their CLI against ``scripts/ct_kernel_exp.py`` on the CPU.

The script is imported by path; its functions read the module global ``F``
at call time, so each test sets it. Its kernels run in interpret mode
(``ablate_fwd`` has no ``interpret`` argument: the test builds the same
``pallas_call`` from ``_ablate_kernel`` and ``ablate_fwd``'s specs).
Tolerances, over max |FFT| of the frames:
  * port against JAX: 1e-5 in float32 and for X1 in bf16; 1e-3 for the
    factored forms in bf16 (their stage C rounds to bf16 float32 sums taken
    in another order, so one flipped rounding of z shows in the output);
  * the CLI against numpy's float64 FFT: 2e-6 in float32, 5e-3 in bf16.
Traps of the script held here: stage A is float32 in bf16 mode (its
``_dot`` rounds only the constant); stages switched off (no T is a reshape,
no C leaves z unrounded); X4 covers only whole tiles of tf frames (rows
past them are zero in the port), and X2 raises unless tf divides F.
"""
import functools
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dc_tts_tpu_torch.ops import ct_fwd as X
from dc_tts_tpu_torch.scripts import ct_kernel_exp as cli
from dc_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "ct_kernel_exp.py")
F_SMALL, TF_SMALL = 64, 32


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("ct_kernel_exp_script",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(F, seed=0):
    return np.random.default_rng(seed).standard_normal((F, 2048)).astype(
        np.float32)


def _scale(x):
    return float(np.abs(np.fft.fft(x.astype(np.float64), axis=-1)).max())


def _dist(got, want, scale, rows=slice(None)):
    """max |got - want| over both outputs, over ``scale``; for (16, F, 128)
    outputs only the frames ``rows``."""
    d = 0.0
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.ndim == 3:
            g, w = g[:, rows], w[:, rows]
        d = max(d, float(np.abs(g - w).max()))
    return d / scale


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("bf16", [False, True])
def test_consts_bit_equal(script, bf16):
    got, want = X.consts(bf16), script.consts(bf16)
    assert set(got) == set(want) | {"CS", "KC"}
    for k in want:
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)
    # X1's kernel layout: CF, SF interleaved as rows; in float32 their TF32
    # hi and lo parts (cvt.rna: to nearest, ties away from zero, 10 bits)
    if bf16:
        cs = got["CS"].T
        assert torch.equal(cs[:, 0:2050:2], got["CF"])
        assert torch.equal(cs[:, 1:2050:2], got["SF"])
        assert float(cs[:, 2050:].float().abs().sum()) == 0.0
        return
    hi, lo = (got["CS"][i].T.double().numpy() for i in (0, 1))
    ref = np.zeros((2048, 2176))
    ref[:, 0:2050:2] = got["CF"].numpy()
    ref[:, 1:2050:2] = got["SF"].numpy()
    np.testing.assert_array_equal(hi, _tf32(ref))
    np.testing.assert_array_equal(lo, _tf32(ref - hi))
    assert float(np.abs(hi + lo - ref).max()) <= 2.0 ** -21


def _tf32(v):
    """float64 values of float32 numbers -> their TF32 rounding, to nearest
    with ties away from zero, from the decimal definition (not bit tricks):
    a multiple of 2^(e - 10) for |v| in [2^e, 2^(e+1))."""
    v = np.asarray(v, np.float64).astype(np.float32).astype(np.float64)
    out = np.zeros_like(v)
    nz = v != 0
    e = np.floor(np.log2(np.abs(v[nz])))
    q = 2.0 ** (e - 10)
    out[nz] = np.sign(v[nz]) * np.floor(np.abs(v[nz]) / q + 0.5) * q
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_stage_c_constant_matches_script(script, bf16):
    """The factored kernel's stage-C constant ("KC"): its columns k2 = 0..64
    are the script's C128 and S128 bit for bit (bf16) or their exact TF32
    hi/lo split (float32); the packed [[C128, S128], [-S128, C128]] that its
    butterfly applies (columns 65..127 by C128[:, 128-k] = C128[:, k],
    S128[:, 128-k] = -S128[:, k]) equals the script's: exactly on those
    columns, elsewhere within 1e-13 (the script's float64 cos and sin at
    their zeros, e.g. cos(pi/2) = 6e-17, are the only asymmetry), plus the
    split's 2^-22 in float32."""
    got = X.consts(bf16)
    want = {k: torch.from_numpy(np.asarray(script.consts(bf16)[k]).astype(
        np.float32)).to(got["C128"].dtype) for k in ("C128", "S128")}
    M = _stage_c_matrix(got["KC"])
    C, S = want["C128"].double(), want["S128"].double()
    ref = torch.cat([torch.cat([C, S], 1), torch.cat([-S, C], 1)], 0)
    cols = list(range(X.KC_COLS)) + list(range(128, 128 + X.KC_COLS))
    if bf16:
        assert torch.equal(M[:, cols], ref[:, cols])
    else:
        # the image holds exactly tf32_split(C128), tf32_split(S128)
        assert torch.equal(got["KC"], X.fact_consts(want["C128"],
                                                    want["S128"]))
        h, lo = X.tf32_split(want["C128"])
        assert torch.equal(_tf32_t(want["C128"]), h)
        assert torch.equal(_tf32_t(want["C128"] - h), lo)
        assert float((M[:, cols] - ref[:, cols]).abs().max()) <= 2.0 ** -22
    assert float((M - ref).abs().max()) <= 1e-13 + (0 if bf16 else 2 ** -22)


def _stage_c_matrix(kc: torch.Tensor) -> torch.Tensor:
    """The (256, 256) float64 matrix [[C128, S128], [-S128, C128]] that the
    factored kernel's stage C applies to [zr | zi] (float32: the sum of the
    TF32 parts), rebuilt from its constant ``fact_consts``: columns 0..64
    read back, columns 65..127 by the symmetry its butterfly uses,
    C128[:, 128 - k] = C128[:, k] and S128[:, 128 - k] = -S128[:, k]."""
    bf16 = kc.dtype == torch.bfloat16
    per = 64 if bf16 else 32
    v = kc.view(torch.int16 if bf16 else torch.int32).cpu().numpy()
    tiles = v.reshape(-1, X.N2 // per, X.KC_N, per)
    back = X._swizzle128(tiles)  # the swizzle is an involution
    mats = back.transpose(0, 2, 1, 3).reshape(-1, X.KC_N, X.N2)
    vals = (torch.from_numpy(np.ascontiguousarray(mats))
            .view(kc.dtype).double())  # (parts, k2, n2)
    if not bf16:
        vals = torch.stack([vals[0] + vals[1], vals[2] + vals[3]])
    c, s = (vals[i, :X.KC_COLS].T for i in (0, 1))  # (n2, k2 <= 64)
    k = torch.arange(X.KC_COLS, X.N2)
    C = torch.cat([c, c[:, X.N2 - k]], dim=1)
    S = torch.cat([s, -s[:, X.N2 - k]], dim=1)
    return torch.cat([torch.cat([C, S], 1), torch.cat([-S, C], 1)], 0)


def _tf32_t(t):
    return torch.from_numpy(_tf32(t.double().numpy())).float()


def test_unscramble(script, monkeypatch):
    monkeypatch.setattr(script, "F", F_SMALL)
    y = np.random.default_rng(1).standard_normal((16, F_SMALL, 128)).astype(
        np.float32)
    np.testing.assert_array_equal(X.unscramble(torch.from_numpy(y)).numpy(),
                                  script.unscramble(y))


def _jax_run(script, variant, x, bf16):
    m = script.consts(bf16)
    xj = jnp.asarray(x)
    if variant == "full":
        return script.full_fwd(xj, m, bf16, True)
    if variant == "fact-tiled":
        return script.fact_fwd_tiled(xj, m, bf16, True, tf=TF_SMALL)
    return script.fact_fwd(xj, m, bf16, True, variant.split("-")[1])


def _port_run(variant, x, bf16):
    m, xt = X.consts(bf16), torch.from_numpy(x)
    if variant == "full":
        return X.full_fwd(xt, m, bf16)
    if variant == "fact-tiled":
        return X.fact_fwd_tiled(xt, m, bf16, TF_SMALL)
    return X.fact_fwd(xt, m, bf16, variant.split("-")[1])


@pytest.mark.parametrize("variant", cli.VARIANTS)
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_jax_kernel(script, monkeypatch, variant, bf16):
    """X1, X3 (both transpose modes) and X2 (tf 32) on CPU tensors: the
    plain versions, no launch counted, against the script's kernels."""
    monkeypatch.setattr(script, "F", F_SMALL)
    x = _frames(F_SMALL)
    before = profiling.counts()
    got = _port_run(variant, x, bf16)
    assert profiling.counts() == before
    want = _jax_run(script, variant, x, bf16)
    assert tuple(got[0].shape) == np.asarray(want[0]).shape
    tol = 1e-3 if bf16 and variant != "full" else 1e-5
    d = _dist(got, want, _scale(x))
    assert d <= tol, d


def _jax_ablate(script, x, bf16, stages, tf):
    """ablate_fwd's pallas_call (scripts/ct_kernel_exp.py:284-299) in
    interpret mode."""
    F, N1, N2 = x.shape[0], 16, 128
    m = script.consts(bf16)
    mat = lambda shape: pl.BlockSpec(shape,  # noqa: E731
                                     lambda t: tuple(0 for _ in shape))
    out = pl.BlockSpec((N1, tf, N2), lambda t: (0, t, 0))
    return pl.pallas_call(
        functools.partial(script._ablate_kernel, bf16=bf16, tf=tf,
                          stages=stages),
        grid=(F // tf,),
        in_specs=[pl.BlockSpec((tf, 2048), lambda t: (t, 0)),
                  mat((N1, N1)), mat((N1, N1)),
                  mat((N1, 1, N2)), mat((N1, 1, N2)),
                  mat((N2, N2)), mat((N2, N2))],
        out_specs=(out, out),
        out_shape=(jax.ShapeDtypeStruct((N1, F, N2), jnp.float32),) * 2,
        interpret=True,
    )(jnp.asarray(x), m["C16"], m["S16"], m["Tc"], m["Ts"], m["C128"],
      m["S128"])


@pytest.mark.parametrize("stages", X.STAGE_SETS)
@pytest.mark.parametrize("bf16", [False, True])
def test_ablate_plain_matches_jax_kernel(script, stages, bf16):
    """X4 at F = 80, tf = 32: the 64 frames of the two whole tiles against
    the script's kernel; rows 64..79 zero in the port (the TPU leaves them
    unwritten)."""
    F = 80
    x = _frames(F, seed=2)
    got = X.ablate_fwd(torch.from_numpy(x), X.consts(bf16), bf16, stages,
                       TF_SMALL)
    want = _jax_ablate(script, x, bf16, stages, TF_SMALL)
    covered = F // TF_SMALL * TF_SMALL
    tol = 1e-3 if bf16 and "C" in stages else 1e-5
    d = _dist(got, want, _scale(x[:covered]), slice(0, covered))
    assert d <= tol, (stages, d)
    assert max(float(g[:, covered:].abs().max()) for g in got) == 0.0


def test_stage_traps():
    """Without C the output is z unrounded (float32) even in bf16 mode;
    without A and W it is the frames themselves, without T read through
    the tile's reshape."""
    x = torch.from_numpy(_frames(32, seed=3))
    m = X.consts(True)
    yr, yi = X.ablate_fwd(x, m, True, "T", 32)
    assert torch.equal(yr, yi)
    assert torch.equal(yr, x.reshape(32, 16, 128).transpose(0, 1))
    yr, _ = X.ablate_fwd(x, m, True, "", 32)
    assert torch.equal(yr, x.reshape(16, 32, 128))
    yr, _ = X.ablate_fwd(x, m, True, "TAW", 32)
    assert not torch.equal(yr, yr.bfloat16().float())
    # stage A in bf16 mode: float32 frames times the bf16-rounded constants
    ga, _ = X.ablate_fwd(x, m, True, "TA", 32)
    want = torch.einsum("kn,fnj->kfj", m["C16"].float(),
                        x.reshape(32, 16, 128))
    torch.testing.assert_close(ga, want, rtol=0, atol=1e-5)


def test_bad_arguments_raise():
    x = torch.from_numpy(_frames(F_SMALL))
    m = X.consts(False)
    with pytest.raises(ValueError):
        X.fact_fwd_tiled(x, m, False, 48)          # 48 does not divide 64
    with pytest.raises(ValueError):
        X.fact_fwd_tiled(x[:40], m, False, 32)
    with pytest.raises(ValueError):
        X.ablate_fwd(x, m, False, "TX", 32)
    with pytest.raises(ValueError):
        X.fact_fwd(x, m, False, "rotate")


def _cli(capsys, monkeypatch, F, *argv):
    monkeypatch.setenv("CT_F", str(F))
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


_ERR = re.compile(r"^\[(\S+)/(\S+)\] rel err (\S+)$", re.M)


@pytest.mark.parametrize("variant,prec,F", [
    ("full", "f32", 64), ("full", "bf16", 64), ("fact-swap", "bf16", 64),
    ("fact-stack", "f32", 64), ("fact-tiled", "f32", 512)])
def test_cli_on_cpu(capsys, monkeypatch, variant, prec, F):
    """The CLI's main on the CPU: the script's lines, the rel err to numpy's
    float64 FFT within 2e-6 (f32) / 5e-3 (bf16), nothing timed."""
    out = _cli(capsys, monkeypatch, F, variant, prec, "5")
    (v, p, err), = _ERR.findall(out)
    assert (v, p) == (variant, prec)
    assert float(err) <= (5e-3 if prec == "bf16" else 2e-6), out
    assert "ms/call" not in out


@pytest.mark.parametrize("variant,prec", [("full", "bf16"),
                                          ("fact-swap", "f32")])
def test_cli_matches_script_main(script, capsys, monkeypatch, variant,
                                 prec):
    """The slice end to end: the CLI's line against the script's main (in
    interpret mode) at F = 64, the same format and rel err (the script's
    reference is numpy's FFT of the float32 frames: a few 1e-7 apart)."""
    monkeypatch.setattr(script, "F", F_SMALL)
    monkeypatch.setattr("sys.argv", ["ct_kernel_exp.py", variant, prec])
    assert script.main() == 0
    want = _ERR.findall(capsys.readouterr().out)
    got = _ERR.findall(_cli(capsys, monkeypatch, F_SMALL, variant, prec))
    assert [g[:2] for g in got] == [w[:2] for w in want] == [(variant, prec)]
    assert abs(float(got[0][2]) - float(want[0][2])) <= (
        1e-4 if prec == "bf16" else 1e-6), (got, want)


def test_cli_refusals(monkeypatch, capsys):
    """fact-tiled raises unless 512 divides CT_F; ablate has no CPU mode (a
    usage error); without --device cpu and no CUDA device the CLI raises."""
    monkeypatch.setenv("CT_F", "64")
    with pytest.raises(ValueError):
        cli.main(["fact-tiled", "f32", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli.main(["ablate", "--device", "cpu"])
    assert e.value.code == 2
    assert "no CPU mode" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["full", "f32"], ["ablate"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
