"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present. Run them
on a machine with an H100:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: the decode kernel at the JAX fused-decode test's 2e-5 with an
identical cursor trajectory (past its old domain limits: against the plain
version replayed on the kernel's cursors, a cursor differing only in a
tie below 1e-6); its reduced-precision bodies at chip_smoke.py's
gate (max(2e-5, 2 x the plain version's float32-vs-float64 distance)); its
flagged exchange bit for bit the grid exchange's (the same arithmetic). The
Griffin-Lim kernel at 1e-5 from its plain version run in float64 (also at
a non-power-of-two n_fft, 480 = 32 x 15): the phase normalisation of
near-zero bins amplifies rounding, so the float32 plain version is itself
up to ~3e-5 from the float64 one at n_fft 2048, more than the kernel is.
An SSRN training step at c = 10 under use_pallas (K4 on every HC block,
the 10-channel ones stored padded) equal to the CPU step's loss at rtol
1e-5. The Griffin-Lim round
kernels K3a/K3b (bf16 operands, float32 sums) at max 2e-2 and mean 1e-5
from their plain version on the same operands, the CPU tests' gates
against JAX (the phase normalisation of near-zero bins amplifies a sum's
rounding into the max; the mean stays small). The HC block kernels K4 at
max(2e-5 x max, 2 x the float32 plain version's distance) from their plain
versions run in float64, in both operand modes (float32; bf16 at the same
rounding points). The forward-rDFT prototypes
X1-X4 at 1e-5 of max |FFT| from their plain versions, 1e-3 for the
factored kernels in bf16 (stage C rounds float32 sums taken in another
order to bf16), the CPU tests' gates against JAX. The program's spans
against ``torch.profiler``'s device trace of single requests: one clock.
The chunked copy back through the pinned staging pair bit for bit
``synthesize_ids`` over the chunks, overlapped with the next chunk, its
host waits outside the vocoder.
TextEnc replayed from its captured graph (``pipeline.text_encode_graphs``)
bit for bit the eager encoder, alone and through the Synthesizer; in
synthesis each TextEnc block's tail through K5's epilogue on its float32
product, bitwise the eager product, y within 1e-5 x max(1, max|y|) of the
eager chain's, K and V within the same bound. SSRN's
blocks through K5 (``ops/ssrn_block.py``): the prologue's bf16 halves bit
for bit its plain version's; each block's y within 1e-5 x max(1, max|y|)
of the eager chain's; the whole SSRN's Z within max(1e-5, 2 x the eager
chain's distance between float32 and float64 sums) of it (K1's gate): only
float32 sums run in another order, the layer norms' and, on the padded
shapes' cuBLAS kernels, the products'.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import base_config, test_config
from dc_tts_tpu_torch.device import fp32_numerics
from dc_tts_tpu_torch.dsp.griffin_lim import spectrogram_to_wav
from dc_tts_tpu_torch.models import SSRN, Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.ops import gl2 as K2
from dc_tts_tpu_torch.pipeline import Synthesizer
from dc_tts_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fp32_numerics()
    return torch.device("cuda")


def _ids(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, cfg.max_N), np.int64)
    for i in range(B):
        n = int(rng.integers(5, cfg.max_N))
        ids[i, :n] = rng.integers(2, cfg.vocab_size, n)
    return torch.as_tensor(ids)


def _counted(before):
    """Each counter's increase since ``before`` (a ``profiling.counts()``)."""
    return profiling.counts() - before


def _first_flip(A_k, A_p):
    """(step, margin) of the first cursor flip, or None; margin: the gap
    between the two largest probabilities of the plain version's row."""
    diff = A_k.argmax(1) != A_p.argmax(1)
    if not bool(diff.any()):
        return None
    t = int(diff.any(0).nonzero()[0])
    b = int(diff[:, t].nonzero()[0])
    top = A_p[b, :, t].topk(2).values
    return t, float(top[0] - top[1])


@pytest.mark.parametrize("prec", K1.PRECS)
@pytest.mark.parametrize("B", [1, 5, 20])
def test_decode_kernel_matches_plain(cuda, B, prec):
    """"highest" at 2e-5 with identical cursors; the reduced bodies at
    chip_smoke.py's gate: max(2e-5, 2 x the plain version's float32-vs-
    float64 distance), over the steps before the first cursor flip, a
    flip counting as a tie below max(1e-6, the gate for A)."""
    cfg = test_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(B), cuda)
    _check_decode(cfg, p, _ids(cfg, B).to(cuda), prec)


@pytest.mark.parametrize("prec", K1.PRECS)
def test_decode_kernel_at_b72_matches_plain(cuda, prec):
    """Bulk synthesis's chunk: base_config at B = 72 over all 210 steps,
    where the plan takes the wide kernel (wide product tasks, most layers'
    slices staged) but under "high3" (every product split: tasks of RG
    rows, the common kernel), at ``test_decode_kernel_matches_plain``'s
    gates, one grid-exchange launch each."""
    cfg = base_config()
    plan = K1.decode_plan(cfg, 72, K1.decode_blocks(cuda), prec)
    assert plan.exchange == "grid"
    assert any(plan.staged) == (K1.RG_WIDE in plan.task_rows) == (
        prec != "high3")
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(72), cuda)
    _check_decode(cfg, p, _ids(cfg, 72).to(cuda), prec)


@pytest.mark.parametrize("prec", [p for p in K1.PRECS if p != "high3"])
def test_decode_cluster_widths_agree_at_b72(cuda, prec):
    """In every precision the wide kernel takes (not "high3", whose split
    products keep the common kernel), base_config at B = 72 over all 210
    steps: the plan's clusters of ``WIDE_CLUSTER``, over the blocks whole
    clusters of it give, and clusters of ``CLUSTER`` give Y and A bit for
    bit (each row normalised by one warp in the same lane order, each
    column summed in the same order); two grid-exchange launches."""
    cfg = base_config()
    plan = K1.launch_plan(cfg, 72, prec, cuda)
    assert plan.cluster == K1.WIDE_CLUSTER and K1.RG_WIDE in plan.task_rows
    assert plan.blocks == K1.decode_blocks(cuda, K1.WIDE_CLUSTER)
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(72), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, 72).to(cuda))
    Kt, V = Kt.contiguous(), V.contiguous()
    packed = K1.pack_decode_params(cfg, p, prec)
    c0 = profiling.counts()
    Y, A = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg, prec,
                            cluster=K1.WIDE_CLUSTER)
    Y2, A2 = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg, prec,
                              cluster=K1.CLUSTER)
    torch.cuda.synchronize()
    assert _counted(c0)["k1.grid.launches"] == 2
    assert torch.equal(Y, Y2) and torch.equal(A, A2)
    assert bool(torch.isfinite(Y).all())


def test_decode_attention_split_bitwise(cuda):
    """base_config over all 210 steps at B = 72 and at the smallest and
    largest B whose launch takes the wide kernel (its plan ``attn_split``):
    the wide kernel in clusters of ``WIDE_CLUSTER``, each rank computing
    its own rows' attention, gives Y and A bit for bit those of the same
    kernel over the same blocks in clusters of ``CLUSTER``, which computes
    every row in every block; ``k1.attn_split.launches`` counts the first
    launch only."""
    cfg = base_config()
    wide = [B for B in range(1, 289)
            if K1.launch_plan(cfg, B, "highest", cuda).attn_split]
    assert 72 in wide and wide == list(range(wide[0], wide[-1] + 1))
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(30), cuda)
    packed = K1.pack_decode_params(cfg, p)
    for B in (wide[0], 72, wide[-1]):
        plan = K1.launch_plan(cfg, B, "highest", cuda)
        assert plan.cluster == K1.WIDE_CLUSTER
        Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B, seed=B).to(cuda))
        Kt, V = Kt.contiguous(), V.contiguous()
        c0 = profiling.counts()
        Y, A = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg)
        c1 = profiling.counts()
        Y2, A2 = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg,
                                  blocks=plan.blocks, cluster=K1.CLUSTER)
        torch.cuda.synchronize()
        assert (c1 - c0)["k1.attn_split.launches"] == 1
        assert _counted(c1)["k1.attn_split.launches"] == 0
        assert torch.equal(Y, Y2) and torch.equal(A, A2), B
        assert bool(torch.isfinite(Y).all())


def test_decode_counts_attention_split_launches(cuda):
    """``fused_decode`` at base_config counts ``k1.attn_split.launches``
    once a launch at bulk synthesis's B = 72 and never at B = 1 or 20."""
    cfg = base_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(4), cuda)
    packed = K1.pack_decode_params(cfg, p)
    for B, n in ((72, 1), (20, 0), (1, 0)):
        Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B).to(cuda))
        c0 = profiling.counts()
        for _ in range(2):
            K1.fused_decode(packed, Kt.contiguous(), V.contiguous(), 8, cfg)
        torch.cuda.synchronize()
        c = _counted(c0)
        assert (c["k1.launches"], c["k1.attn_split.launches"]) == (2, 2 * n)


def _check_decode(cfg, p, ids, prec):
    """The decode kernel on ``ids`` against the plain version: "highest"
    at 2e-5 with identical cursors, the reduced bodies at chip_smoke.py's
    gate; one launch, counted under its precision and exchange."""
    B = ids.shape[0]
    Kt, V = Text2Mel(cfg).text_encode(p, ids)
    packed = K1.pack_decode_params(cfg, p, prec)
    x = K1.decode_plan(cfg, B, K1.decode_blocks(ids.device), prec).exchange
    c0 = profiling.counts()
    Y, A = K1.fused_decode(packed, Kt.contiguous(), V.contiguous(),
                           cfg.max_T, cfg, prec)
    torch.cuda.synchronize()
    n = _counted(c0)
    assert (n["k1.launches"], n[f"k1.{prec}.launches"],
            n[f"k1.{x}.launches"]) == (1, 1, 1)
    Yp, Ap = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg, prec)
    if prec == "highest":
        assert torch.equal(A.argmax(1), Ap.argmax(1))
        torch.testing.assert_close(Y, Yp, atol=2e-5, rtol=0)
        torch.testing.assert_close(A, Ap, atol=2e-5, rtol=0)
        return
    Y64, A64 = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg, prec,
                                     torch.float64)
    upto = cfg.max_T
    f64 = _first_flip(A64, Ap.double())
    if f64 is not None:
        upto = f64[0] + 1
    flip = _first_flip(A, Ap)
    if flip is not None:
        upto = min(upto, flip[0] + 1)
    gate_y = max(2e-5, 2 * float((Y64 - Yp.double())[:, :upto].abs().max()))
    gate_a = max(2e-5, 2 * float((A64 - Ap.double())[..., :upto].abs().max()))
    assert flip is None or flip[1] < max(1e-6, gate_a)
    assert float((Y - Yp)[:, :upto].abs().max()) <= gate_y
    assert float((A - Ap)[..., :upto].abs().max()) <= gate_a
    assert bool(torch.isfinite(Y).all())


# one config past each limit the kernel once had, at test_config() widths
PAST_LIMITS = {"d17": dict(d=17), "d18": dict(d=18), "d264": dict(d=264),
               "n_mels10": dict(n_mels=10),
               "win5": dict(attention_win_size=5),
               "win9": dict(attention_win_size=9),
               "c520": dict(n_mels=520)}


@pytest.mark.parametrize("name", sorted(PAST_LIMITS))
def test_decode_kernel_past_the_old_limits(cuda, name):
    """d % 4 (17: its C layers' norm parameters also off 16-byte
    boundaries), n_mels % 4, d > 256, a window > 4 (5, and 9: two register
    chunks of keys) and a C layer wider than 512, in "highest": against
    the plain version replayed on the kernel's cursors, every step within
    2e-5, every cursor the plain version's own or a tie below 1e-6."""
    cfg = test_config().replace(**PAST_LIMITS[name])
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(7), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, 5).to(cuda))
    Kt, V = Kt.contiguous(), V.contiguous()
    packed = K1.pack_decode_params(cfg, p)
    c0 = profiling.counts()
    Y, A = K1.fused_decode(packed, Kt, V, cfg.max_T, cfg)
    torch.cuda.synchronize()
    assert _counted(c0)["k1.launches"] == 1
    Yr, Ar = K1.fused_decode_plain(packed, Kt, V, cfg.max_T, cfg,
                                   cursors=A.argmax(1))
    for b, t in (A.argmax(1) != Ar.argmax(1)).nonzero().tolist():
        top = Ar[b, :, t].topk(2).values
        assert float(top[0] - top[1]) < 1e-6, (b, t)
    torch.testing.assert_close(Y, Yr, atol=2e-5, rtol=0)
    torch.testing.assert_close(A, Ar, atol=2e-5, rtol=0)
    if name == "win9":
        assert int((A > 0).sum(1).max()) == 9


# the flagged exchange against the grid exchange: base_config, and a config
# past one of the kernel's old limits that the common kernel takes (d 18:
# each tap padded to the copy width)
EXCHANGE_CONFIGS = {"base": base_config,
                    "d18": lambda: test_config().replace(d=18)}


@pytest.mark.parametrize("prec", K1.PRECS)
@pytest.mark.parametrize("name", sorted(EXCHANGE_CONFIGS))
def test_flag_exchange_matches_grid_bitwise(cuda, name, prec):
    """Y and A through the flagged exchange equal the grid exchange's
    bit for bit at B = 1, 2, 3, 5 and 8 (``launch_decode`` given each):
    every block's norms take the same arithmetic as the cluster ranks'."""
    cfg = EXCHANGE_CONFIGS[name]()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(11), cuda)
    packed = K1.pack_decode_params(cfg, p, prec)
    for B in (1, 2, 3, 5, 8):
        Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B, seed=B).to(cuda))
        Kt, V = Kt.contiguous(), V.contiguous()
        c0 = profiling.counts()
        Yg, Ag = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg, prec,
                                  exchange="grid")
        Yf, Af = K1.launch_decode(packed, Kt, V, cfg.max_T, cfg, prec,
                                  exchange="flag")
        torch.cuda.synchronize()
        n = _counted(c0)
        assert (n["k1.grid.launches"], n["k1.flag.launches"]) == (1, 1)
        assert torch.equal(Yf, Yg) and torch.equal(Af, Ag), B


def test_decode_counts_launches_by_exchange(cuda):
    """At base_config ``fused_decode`` takes the flagged exchange at
    B = 1, one launch a call, and the grid exchange at B = 72."""
    cfg = base_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(4), cuda)
    packed = K1.pack_decode_params(cfg, p)
    for B, x in ((1, "flag"), (72, "grid")):
        Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B).to(cuda))
        c0 = profiling.counts()
        for _ in range(2):
            K1.fused_decode(packed, Kt.contiguous(), V.contiguous(), 8, cfg)
        torch.cuda.synchronize()
        n = _counted(c0)
        assert {e: n[f"k1.{e}.launches"] for e in K1.EXCHANGES} == {
            e: 2 * (e == x) for e in K1.EXCHANGES}, B


@pytest.mark.parametrize("B,kernel", [(1, "flag"), (20, "common"),
                                      (72, "wide")])
def test_stamped_twin_matches_and_tiles_its_run(cuda, B, kernel):
    """At base_config, B = 1, 20 and 72 (the flagged, common and wide
    kernels): the launch takes no twin while spans do not record, and its
    stamped twin inside ``collect()``, whose Y and A equal the unstamped
    kernel's bit for bit. Each block's phase cycles add up to its cycles;
    its phases in ns add up to its globaltimer span within 0.5 %, at an SM
    clock between 0.5 and 2.5 GHz; the blocks' mean span lies within 3 % of
    the CUDA events' time of the launch (enqueued while the stream sleeps,
    so no host preparation shows); one ``k1.phase.*`` entry a phase."""
    cfg = base_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(B), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B).to(cuda))
    Kt, V = Kt.contiguous(), V.contiguous()
    packed = K1.pack_decode_params(cfg, p)
    T = cfg.max_T
    profiling.reset()
    Y, A = K1.launch_decode(packed, Kt, V, T, cfg)
    assert profiling.RECORDER.stamped == []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))
    with profiling.collect():
        start.record()
        Ys, As = K1.launch_decode(packed, Kt, V, T, cfg)
        end.record()
    torch.cuda.synchronize()
    launch_ms = start.elapsed_time(end)
    assert torch.equal(Y, Ys) and torch.equal(A, As)
    (st,) = profiling.RECORDER.stamped
    P = len(K1.PHASES)
    w = st.words.cpu()
    assert st.plan["kernel"] == kernel
    assert w.shape == (st.plan["blocks"], K1.STAMP_WORDS)
    assert torch.equal(w[:, :P].sum(1), w[:, P])
    span_ns = (w[:, P + 2] - w[:, P + 1]).double()
    ns = w[:, :P].double() / w[:, P:P + 1].double() * span_ns[:, None]
    assert float(((ns.sum(1) - span_ns).abs() / span_ns).max()) <= 0.005
    ghz = w[:, P].double() / span_ns
    assert 0.5 < float(ghz.min()) and float(ghz.max()) < 2.5
    mean_ms = float(span_ns.mean()) / 1e6
    print(f"B={B}: blocks' mean span {mean_ms:.3f} ms, events "
          f"{launch_ms:.3f} ms")
    assert abs(mean_ms - launch_ms) <= 0.03 * launch_ms
    s = profiling.summary()
    profiling.reset()
    assert [s[f"k1.phase.{ph}"]["count"] for ph in K1.PHASES] == [1] * P
    assert sum(s[f"k1.phase.{ph}"]["device_ms"] for ph in K1.PHASES) == \
        pytest.approx(mean_ms, rel=1e-9)


# ptxas of each unstamped decode_kernel instantiation (registers, spill
# stores in bytes, static shared memory) as the stamped twins found them:
# the twins' template argument left these unchanged. An edit of
# csrc/decode.cu that moves one updates this table and says why.
PTXAS_UNSTAMPED = {"common CL2": (128, 0, 0), "flag CL2": (128, 12, 0),
                   "general CL2": (128, 0, 0), "wide CL2": (128, 4, 0),
                   "wide CL8": (128, 0, 0)}


def test_stamped_twins_do_not_spill(cuda):
    """The build log's ptxas report: every instantiation has a stamped
    twin, which spills nothing and holds its record in ``STAMP_SMEM``
    bytes of static shared memory; the unstamped instantiations keep their registers,
    spills and shared memory (``PTXAS_UNSTAMPED``)."""
    from dc_tts_tpu_torch.ops import _build
    _build.load_library()
    rep = {K1.instance_label(f): v for f, v in _build.ptxas_report().items()
           if K1.instance_label(f)}
    assert set(rep) == set(PTXAS_UNSTAMPED) | {
        k + " stamped" for k in PTXAS_UNSTAMPED}
    for label, v in sorted(rep.items()):
        print(label, v)
        if label.endswith(" stamped"):
            assert v["spill_stores"] == v["spill_loads"] == 0, label
            assert v["smem"] == K1.STAMP_SMEM and v["registers"] <= 128
        else:
            assert (v["registers"], v["spill_stores"], v["smem"]) == \
                PTXAS_UNSTAMPED[label], label


def test_decode_kernel_spills_rows(cuda):
    """At base_config width, a batch past the rows one block's shared
    memory holds: the rest run from the per-block global spill, at the
    "highest" gate (2e-5, identical cursors) over 40 steps."""
    cfg = base_config()
    blocks = K1.decode_blocks(cuda)
    B = 6 + next(b for b in range(1, 1000)
                 if K1.decode_plan(cfg, b, blocks).spill_floats)
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(2), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, B).to(cuda))
    packed = K1.pack_decode_params(cfg, p)
    Kt, V = Kt.contiguous(), V.contiguous()
    Y, A = K1.fused_decode(packed, Kt, V, 40, cfg)
    Yp, Ap = K1.fused_decode_plain(packed, Kt, V, 40, cfg)
    assert torch.equal(A.argmax(1), Ap.argmax(1))
    torch.testing.assert_close(Y, Yp, atol=2e-5, rtol=0)
    torch.testing.assert_close(A, Ap, atol=2e-5, rtol=0)


def test_decode_refuses_grid_not_coresident(cuda, monkeypatch):
    """If the occupancy query the wrapper checks says fewer blocks fit at
    once than the grid has, the launch raises before it is made."""
    cfg = test_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(0), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, 2).to(cuda))
    packed = K1.pack_decode_params(cfg, p)
    real = K1.coresident_blocks

    def fewer(smem, device, cluster=K1.CLUSTER):
        fits, sms = real(smem, device, cluster)
        return K1.decode_blocks(device, cluster) - 1, sms

    monkeypatch.setattr(K1, "coresident_blocks", fewer)
    c0 = profiling.counts()
    with pytest.raises(RuntimeError, match="co-resident"):
        K1.fused_decode(packed, Kt.contiguous(), V.contiguous(), 4, cfg)
    assert profiling.counts() == c0


def test_decode_kernel_refuses_bad_packing(cuda):
    """Another precision's packing raises before any launch: no quiet
    conversion."""
    cfg = test_config()
    p = Text2Mel(cfg).init(torch.Generator().manual_seed(0), cuda)
    Kt, V = Text2Mel(cfg).text_encode(p, _ids(cfg, 2).to(cuda))
    c0 = profiling.counts()
    for prec, other in (("high3", "highest"), ("hybrid", "high3"),
                        ("default", "hybrid")):
        with pytest.raises(ValueError, match="packed"):
            K1.fused_decode(K1.pack_decode_params(cfg, p, other),
                            Kt.contiguous(), V.contiguous(), 4, cfg, prec)
    assert profiling.counts() == c0


# the JAX gl2 test's geometry, and a non-power-of-two n_fft (32 * 15) with
# hop and window in the base config's ratios and an odd F
@pytest.mark.parametrize("geom", [(512, 69, 275, 160), (480, 64, 258, 41)])
@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_gl2_kernel_matches_plain(cuda, n_iter, geom):
    n_fft, hop, win, F = geom
    g = K2.gl2_geometry(n_fft, hop, win, F)
    mag = torch.rand(3, F, n_fft // 2 + 1,
                     generator=torch.Generator().manual_seed(n_iter)) + 0.05
    scr = K2.scramble_mag(mag.to(cuda), g)
    consts = {k: torch.as_tensor(v, device=cuda)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    y = K2.gl2_run(scr, consts, g, n_iter)
    yp = K2.gl2_run_plain(scr.double(), consts, g, n_iter)
    torch.cuda.synchronize()
    assert y.shape == yp.shape == (3, g.L_sig)
    torch.testing.assert_close(y.double(), yp, atol=1e-5, rtol=0)


# the cells' geometry (n_fft 2048, hop 275, win 1102, F 840) at their
# batches (single B = 1, the smoke's B = 20, bulk72's B = 72) and a
# non-power-of-two n_fft (32 * 33) in the base config's ratios
@pytest.mark.parametrize("B,geom", [(1, (2048, 275, 1102, 840)),
                                    (20, (2048, 275, 1102, 840)),
                                    (72, (2048, 275, 1102, 840)),
                                    (20, (1056, 142, 568, 61))])
def test_gl2_kernel_at_the_cells_batches_matches_plain(cuda, B, geom):
    """The 1e-5 gate against the float64 plain version after 1 and 3
    rounds; each row's bits do not depend on the batch it came in; one
    counted launch a call, of the one frame kernel: n_fft/16 threads an
    item in whole warps, at most the items in blocks."""
    n_fft, hop, win, F = geom
    g = K2.gl2_geometry(n_fft, hop, win, F)
    mag = torch.rand(B, F, n_fft // 2 + 1,
                     generator=torch.Generator().manual_seed(B)) + 0.05
    scr = K2.scramble_mag(mag.to(cuda), g)
    consts = {k: torch.as_tensor(v, device=cuda)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    for n_iter in (1, 3):
        c0 = profiling.counts()
        y = K2.gl2_run(scr, consts, g, n_iter)
        assert _counted(c0) == {"k2.launches": 1}
        frame = K2.gl2_run.frame
        assert frame["threads"] == -(-n_fft // 16 // 32) * 32
        assert frame["grid"] == min(frame["blocks_per_sm"] * torch.cuda.
                                    get_device_properties(cuda).
                                    multi_processor_count, (F + 1) // 2 * B)
        yp = K2.gl2_run_plain(scr.double(), consts, g, n_iter)
        torch.testing.assert_close(y.double(), yp, atol=1e-5, rtol=0)
        rows = [0, B - 1] if B > 1 else [0]
        for b in rows:
            one = K2.gl2_run(scr[b: b + 1].contiguous(), consts, g, n_iter)
            assert torch.equal(one[0], y[b])
        del y, yp


def test_synthesizer_on_cuda_matches_cpu(cuda):
    """Y and Z against the CPU run; the waveform against the float64 plain
    vocoder on the card's own Z (see the module docstring)."""
    cfg = test_config()
    gen = torch.Generator().manual_seed(0)
    p1, p2 = Text2Mel(cfg).init(gen), SSRN(cfg).init(gen)
    ids = _ids(cfg, 3).numpy()
    wav, Y, Z, A = (o.cpu() for o in
                    Synthesizer(cfg, p1, p2).synthesize_ids(ids))
    cpu = Synthesizer(cfg, p1, p2, device="cpu").synthesize_ids(ids)
    assert torch.equal(A.argmax(1), cpu[3].argmax(1))
    torch.testing.assert_close(Y, cpu[1], atol=2e-5, rtol=0)
    torch.testing.assert_close(Z, cpu[2], atol=1e-4, rtol=0)
    ref = spectrogram_to_wav(Z.double(), cfg.replace(stft_method="fft"))
    torch.testing.assert_close(wav.double(), ref, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ K3


def _k3_inputs(dev, B=3, F=160, seed=0, geom=(512, 69, 275)):
    """(g, consts, Xr, Xi, mag_p) at the JAX K3 test's geometry (or
    another n_fft, hop, win_length)."""
    from dc_tts_tpu_torch.ops import gl as K3
    g = K3.gl_geometry(*geom, F)
    rng = np.random.default_rng(seed)
    pad = ((0, 0), (0, g.f2 - F), (0, 0))
    mag, Xr, Xi = (torch.tensor(np.pad(a, pad), device=dev) for a in (
        rng.random((B, F, g.n_freq), np.float32),
        rng.standard_normal((B, F, g.n_freq)).astype(np.float32),
        rng.standard_normal((B, F, g.n_freq)).astype(np.float32)))
    consts = {k: v.to(dev) for k, v in
              K3.gl_fused_consts(*geom, F).items()}
    return g, consts, Xr, Xi, mag


@pytest.mark.parametrize("three", [False, True])
def test_k3_matches_plain(cuda, three, geom=(512, 69, 275), F=160):
    """One round against the plain version on the card: max |d| <= 2e-2
    and mean |d| <= 1e-5 (the CPU tests' gates against JAX); the signal
    between the kernels within 1e-5 x its max; padded rows exactly 0."""
    from dc_tts_tpu_torch.ops import gl as K3
    g, consts, Xr, Xi, mag = _k3_inputs(cuda, F=F, geom=geom)
    npass = 3 if three else 1
    c0 = profiling.counts()
    got = K3.fused_gl_round(Xr, Xi, mag, consts, g, three)
    y = K3.k3a(Xr, Xi, consts, g, three)
    torch.cuda.synchronize()
    n = _counted(c0)
    assert (n[f"k3a.{npass}pass.launches"],
            n[f"k3b.{npass}pass.launches"]) == (2, 1)
    want = K3.fused_gl_round_plain(Xr, Xi, mag, consts, g, three)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(got, want)])
    assert float(d.max()) <= 2e-2 and float(d.mean()) <= 1e-5, \
        (float(d.max()), float(d.mean()))
    yp = K3.k3a_plain(Xr, Xi, consts, g, three)
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float(got[0][:, g.F:].abs().max()) == 0.0


@pytest.mark.parametrize("three", [False, True])
@pytest.mark.parametrize("geom,F", [((2048, 275, 1102), 90),
                                    ((1024, 128, 400), 70)])
def test_k3_window_span_edges_match_plain(cuda, three, geom, F):
    """test_k3_matches_plain at geometries whose window span starts and
    ends inside a tile: the production one (nonzero samples [474, 1575) of
    2048: K3a runs N tiles 3-12 of 16, K3b k-tiles 7-24 of 32) and 1024 /
    400 ([313, 712): N tiles 2-5 of 8, k-tiles 4-11 of 16)."""
    from dc_tts_tpu_torch.ops import gl as K3
    nz = np.flatnonzero(K3.hann_window(geom[2], geom[0]))
    for tile in (K3._BN, K3._BK):
        assert nz[0] % tile and (nz[-1] + 1) % tile
    test_k3_matches_plain(cuda, three, geom, F)


def test_k3_launch_counts_and_bad_input(cuda):
    """griffin_lim("dft_pallas") at n_iter=4 runs 3 three-pass and 1
    single-pass rounds through K3; a float64 input, a wrong shape or
    constants left on the CPU raise on the card (never the plain
    version)."""
    from dc_tts_tpu_torch.dsp.griffin_lim import griffin_lim
    from dc_tts_tpu_torch.ops import gl as K3
    g, consts, Xr, Xi, mag = _k3_inputs(cuda, B=2)
    want = {f"{k}{mode}.launches": n for k in ("k3a", "k3b")
            for mode, n in (("", 4), (".1pass", 1), (".3pass", 3))}
    profiling.reset_counts()
    wav = griffin_lim(mag[:, :g.F], 512, 69, 275, 4, method="dft_pallas")
    torch.cuda.synchronize()
    assert profiling.counts() == want
    assert wav.shape == (2, g.L_sig) and bool(torch.isfinite(wav).all())
    with pytest.raises(ValueError):
        K3.fused_gl_round(Xr.double(), Xi.double(), mag.double(), consts, g)
    with pytest.raises(ValueError):
        K3.fused_gl_round(Xr[:, 1:], Xi[:, 1:], mag[:, 1:], consts, g)
    with pytest.raises(ValueError):
        K3.fused_gl_round(Xr, Xi, mag, {k: v.cpu() for k, v in
                                        consts.items()}, g)
    assert profiling.counts() == want


# ------------------------------------------------------------------ K4


def _hc_inputs(B, T, C, size, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C))
    w = rng.standard_normal((size, C, 2 * C)) * (2.0 / (size * C)) ** 0.5
    vecs = [rng.standard_normal(n) * 0.3 + (1.0 if i in (1, 3) else 0.0)
            for i, n in enumerate([2 * C, C, C, C, C])]
    dy = rng.standard_normal((B, T, C))
    return [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (x, w, *vecs, dy)]


@pytest.mark.parametrize("B,T,C,size,rate,causal", [
    (2, 100, 64, 3, 27, True), (2, 50, 512, 3, 3, False),
    # the tensor-core core's edges: B*T not a multiple of the 128-row tile,
    # tiles spanning two batch rows (centred padding); T shorter than a
    # tile (causal, C = 32); K = 1 with C not a multiple of the k-tile;
    # C = 1024
    (3, 100, 64, 3, 9, False), (5, 20, 32, 3, 2, True),
    (4, 37, 48, 1, 1, False), (2, 300, 1024, 3, 1, False),
    # C not a multiple of 4: stored padded with zero channels
    (2, 60, 10, 3, 2, False), (3, 37, 6, 1, 1, True)])
def test_hc_kernels_match_plain(cuda, B, T, C, size, rate, causal):
    """Forward and all 7 gradients against the plain versions run in
    float64: each within max(2e-5 x its max |value|, 2 x the float32 plain
    version's own distance)."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    *args, dy = _hc_inputs(B, T, C, size, 7, cuda)
    geo = (size, rate, causal, 1e-5)
    c0 = profiling.counts()
    outs = (K4.hc_block_fwd(*args, *geo), *K4.hc_block_bwd(*args, dy, *geo))
    torch.cuda.synchronize()
    assert _counted(c0) == {"k4.fwd.launches": 1, "k4.bwd.launches": 1}
    a64 = [a.double() for a in args]
    ref = (K4.hc_block_fwd_plain(*a64, *geo),
           *K4.hc_block_bwd_plain(*a64, dy.double(), *geo))
    p32 = (K4.hc_block_fwd_plain(*args, *geo),
           *K4.hc_block_bwd_plain(*args, dy, *geo))
    for name, o, r, p in zip(("y", "dx", "dw", "db", "dg1", "db1", "dg2",
                              "db2"), outs, ref, p32):
        assert o.shape == r.shape, name
        err = float((o.double() - r).abs().max())
        tol = max(2e-5 * float(r.abs().max()),
                  2 * float((p.double() - r).abs().max()))
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("B,T,C,size,rate,causal", [
    (2, 100, 64, 3, 27, True), (2, 50, 512, 3, 3, False),
    # the float32 test's edges for the bf16 core: B*T not a multiple of the
    # 128-row tile, tiles spanning two batch rows; T shorter than a tile; K
    # = 1 with C not a multiple of the 64-deep k-tile; C = 1024
    (3, 100, 64, 3, 9, False), (5, 20, 32, 3, 2, True),
    (4, 37, 48, 1, 1, False), (2, 300, 1024, 3, 1, False),
    # C not a multiple of 8: stored padded with zero channels
    (2, 60, 12, 3, 2, False), (2, 40, 10, 3, 1, True)])
def test_hc_bf16_kernels_match_plain(cuda, B, T, C, size, rate, causal):
    """The bf16 operand body: forward and all 7 gradients against the plain
    version with the same bf16 rounding points run in float64, each within
    max(2e-5 x its max |value|, 2 x the float32 plain version's own
    distance: float32 rounding flips a bf16 rounding of dh now and then);
    bitwise-equal repeated gradients; launches counted apart."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    *args, dy = _hc_inputs(B, T, C, size, 8, cuda)
    geo = (size, rate, causal, 1e-5, True)
    c0 = profiling.counts()
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = K4.hc_block_trainable(*leaves, *geo)
    outs = (y.detach(), *torch.autograd.grad(y, leaves, dy))
    again = K4.hc_block_bwd(*args, dy, *geo)
    torch.cuda.synchronize()
    assert _counted(c0) == {"k4.fwd.launches": 1, "k4.fwd.bf16.launches": 1,
                            "k4.bwd.launches": 2, "k4.bwd.bf16.launches": 2}
    assert all(torch.equal(a, b) for a, b in zip(outs[1:], again))
    a64 = [a.double() for a in args]
    ref = (K4.hc_block_fwd_plain(*a64, *geo),
           *K4.hc_block_bwd_plain(*a64, dy.double(), *geo))
    p32 = (K4.hc_block_fwd_plain(*args, *geo),
           *K4.hc_block_bwd_plain(*args, dy, *geo))
    for name, o, r, p in zip(("y", "dx", "dw", "db", "dg1", "db1", "dg2",
                              "db2"), outs, ref, p32):
        err = float((o.double() - r).abs().max())
        tol = max(2e-5 * float(r.abs().max()),
                  2 * float((p.double() - r).abs().max()))
        assert err <= tol, (name, err, tol)
    # the operands are rounded: the float32 body differs
    y32 = K4.hc_block_fwd(*args, *geo[:-1])
    assert float((y32 - outs[0]).abs().max()) > 1e-4


def test_hc_narrow_channels_launch_the_kernels(cuda):
    """The cores copy 16 bytes (4 float32, 8 bf16 channels) at a time: C =
    12 in bf16 and C = 10 in float32 are stored padded and launch the
    kernels in both directions (never the plain version), with outputs of
    the caller's shapes."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    for C, bf16 in ((12, True), (10, False)):
        *args, dy = _hc_inputs(2, 30, C, 3, 12, cuda)
        c0 = profiling.counts()
        y = K4.hc_block_fwd(*args, 3, 1, False, 1e-5, bf16)
        grads = K4.hc_block_bwd(*args, dy, 3, 1, False, 1e-5, bf16)
        assert _counted(c0) == {
            f"k4.{d}{v}.launches": 1 for d in ("fwd", "bwd")
            for v in ("", ".bf16")[:1 + bf16]}
        assert y.shape == args[0].shape
        assert [g.shape for g in grads] == [a.shape for a in args]
        assert all(bool(torch.isfinite(t).all()) for t in (y, *grads))


@pytest.mark.parametrize("B,T", [(4, 90), (4, 300)])
def test_hc_backward_is_deterministic(cuda, B, T):
    """Repeated gradients are bitwise equal; at T=300 dW's depth B*T is
    split over several row ranges, summed in a fixed order."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    *args, dy = _hc_inputs(B, T, 128, 3, 9, cuda)
    if T == 300:
        assert K4._dw_splits(3, 128, B * T) > 1
    g1 = K4.hc_block_bwd(*args, dy, 3, 9, False, 1e-5)
    g2 = K4.hc_block_bwd(*args, dy, 3, 9, False, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_hc_autograd_uses_kernels_and_raises_on_bad_input(cuda):
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    *args, dy = _hc_inputs(2, 40, 32, 3, 11, cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    c0 = profiling.counts()
    y = K4.hc_block_trainable(*leaves, 3, 1, True, 1e-5)
    grads = torch.autograd.grad(y, leaves, dy)
    assert _counted(c0) == {"k4.fwd.launches": 1, "k4.bwd.launches": 1}
    direct = K4.hc_block_bwd(*args, dy, 3, 1, True, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))
    # a float64 input or a weight of the wrong shape raises on the card
    # (never the plain version)
    with pytest.raises(ValueError):
        K4.hc_block_trainable(*[a.double() for a in args], 3, 1, True, 1e-5)
    with pytest.raises(ValueError):
        K4.hc_block_trainable(args[0], args[1][:2], *args[2:], 3, 1, True,
                              1e-5)
    assert _counted(c0)["k4.fwd.launches"] == 1


# ------------------------------------------------------------------ X1-X4


def _ct_case(F, bf16, dev):
    """Seeded frames on the card, the constants, and max |FFT| (float64)."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x = np.random.default_rng(F).standard_normal((F, 2048)).astype(np.float32)
    scale = float(np.abs(np.fft.fft(x.astype(np.float64), axis=-1)).max())
    return torch.from_numpy(x).to(dev), X.consts(bf16, dev), scale


def _ct_dist(got, want, scale):
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) / scale


@pytest.mark.parametrize("F", [64, 840])
@pytest.mark.parametrize("bf16", [False, True])
def test_ct_full_and_fact_match_plain(cuda, F, bf16):
    """X1 and X3 (both transpose modes) against their plain versions on the
    card: 1e-5 of max |FFT|, and 1e-3 for the factored kernel in bf16 (its
    stage C rounds float32 sums taken in another order to bf16)."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x, m, scale = _ct_case(F, bf16, cuda)
    c0 = profiling.counts()
    got = X.full_fwd(x, m, bf16)
    assert got[0].shape == (F, 1025)
    assert _ct_dist(got, X.full_fwd_plain(x, m, bf16), scale) <= 1e-5
    want = X.fact_fwd_plain(x, m, bf16)
    for mode in ("swap", "stack"):
        got = X.fact_fwd(x, m, bf16, mode)
        assert got[0].shape == (16, F, 128)
        assert _ct_dist(got, want, scale) <= (1e-3 if bf16 else 1e-5)
    torch.cuda.synchronize()
    n = _counted(c0)
    assert (n["x1.launches"], n["x3.launches"]) == (1, 2)


@pytest.mark.parametrize("F,tf", [(64, 32), (1024, 512)])
@pytest.mark.parametrize("bf16", [False, True])
def test_ct_tiled_matches_plain(cuda, F, tf, bf16):
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x, m, scale = _ct_case(F, bf16, cuda)
    c0 = profiling.counts()
    got = X.fact_fwd_tiled(x, m, bf16, tf)
    assert _counted(c0)["x2.launches"] == 1
    want = X.fact_fwd_tiled_plain(x, m, bf16, tf)
    assert _ct_dist(got, want, scale) <= (1e-3 if bf16 else 1e-5)
    with pytest.raises(ValueError):
        X.fact_fwd_tiled(x[:-1], m, bf16, tf)
    assert _counted(c0)["x2.launches"] == 1


@pytest.mark.parametrize("F,tf", [(80, 32), (840, 512)])
@pytest.mark.parametrize("bf16", [False, True])
def test_ct_ablate_matches_plain(cuda, F, tf, bf16):
    """X4 at every stage set of the script's ablation: the covered frames
    against the plain version, the rest exactly 0."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x, m, scale = _ct_case(F, bf16, cuda)
    Fc = F // tf * tf
    for stages in X.STAGE_SETS:
        c0 = profiling.counts()
        got = X.ablate_fwd(x, m, bf16, stages, tf)
        assert _counted(c0)["x4.launches"] == 1
        want = X.ablate_fwd_plain(x, m, bf16, stages, tf)
        tol = 1e-3 if bf16 and "C" in stages else 1e-5
        assert _ct_dist(got, want, scale) <= tol, stages
        assert max(float(g[:, Fc:].abs().max()) for g in got) == 0.0


@pytest.mark.parametrize("bf16", [False, True])
def test_ct_ragged_frames_match_plain(cuda, bf16):
    """F that no tile or frame group divides: X1 and X3 at F = 203 (X1's
    128-row tiles, the factored kernel's groups of 4 frames), X2 at
    F = 210 in tiles of 105, X4 at F = 203 in tiles of 67 (201 frames
    covered) at every stage set; the gates of the tests above."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x, m, scale = _ct_case(203, bf16, cuda)
    fact_tol = 1e-3 if bf16 else 1e-5
    assert _ct_dist(X.full_fwd(x, m, bf16), X.full_fwd_plain(x, m, bf16),
                    scale) <= 1e-5
    assert _ct_dist(X.fact_fwd(x, m, bf16), X.fact_fwd_plain(x, m, bf16),
                    scale) <= fact_tol
    for stages in X.STAGE_SETS:
        got = X.ablate_fwd(x, m, bf16, stages, 67)
        want = X.ablate_fwd_plain(x, m, bf16, stages, 67)
        tol = fact_tol if "C" in stages else 1e-5
        assert _ct_dist(got, want, scale) <= tol, stages
        assert max(float(g[:, 201:].abs().max()) for g in got) == 0.0
    x, m, scale = _ct_case(210, bf16, cuda)
    assert _ct_dist(X.fact_fwd_tiled(x, m, bf16, 105),
                    X.fact_fwd_tiled_plain(x, m, bf16, 105), scale) \
        <= fact_tol


def test_ct_bad_input_raises(cuda):
    """A float64 or misaligned x, or constants of the other precision or on
    the CPU, raise on the card (never the plain version)."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    x, m, _ = _ct_case(64, True, cuda)
    c0 = profiling.counts()
    with pytest.raises(ValueError):
        X.full_fwd(x.double(), m, True)
    with pytest.raises(ValueError):
        X.full_fwd(x, X.consts(False, cuda), True)
    with pytest.raises(ValueError):
        X.fact_fwd(x, {k: v.cpu() for k, v in m.items()}, True)
    with pytest.raises(ValueError):
        X.fact_fwd(x.flatten()[1:-2047].view(63, 2048), m, True)
    assert profiling.counts() == c0


def test_ssrn_step_at_c10_launches_k4_on_every_block(cuda, monkeypatch):
    """c = 10 under use_pallas: every HC block of SSRN launches K4, those of
    10 channels (C % 4 != 0, stored padded) as those of 20, once forward
    and once backward; the step's loss equals the CPU step's."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4
    from dc_tts_tpu_torch.train import steps as TS

    widths = []
    kernel = K4.hc_block_trainable

    def spy(x, *a, **kw):
        widths.append(x.shape[-1])
        return kernel(x, *a, **kw)
    monkeypatch.setattr(K4, "hc_block_trainable", spy)
    cfg = test_config().replace(c=10, use_pallas=True)
    rng = np.random.default_rng(0)
    batch = {"mels": rng.uniform(0, 1, (2, cfg.max_T, cfg.n_mels)),
             "mags": rng.uniform(0, 1, (2, cfg.max_T * cfg.r, cfg.n_freq))}
    losses = {}
    for dev in ("cpu", cuda):
        state = TS.init_ssrn_state(cfg, torch.Generator().manual_seed(0), dev)
        b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        widths.clear()
        c0 = profiling.counts()
        _, m = TS.make_ssrn_step(cfg)(state, b, None)
        losses[str(dev)] = float(m["loss"])
    torch.cuda.synchronize()
    assert set(widths) == {10, 20}
    n = _counted(c0)
    assert (n["k4.fwd.launches"], n["k4.bwd.launches"]) == (len(widths),
                                                            len(widths))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


# ------------------------------------------------------------------ spans


def _innermost(t0, t1, notes):
    """Name of the shortest annotation that holds [t0, t1], or None."""
    held = [(b - a, n) for n, a, b in notes if a <= t0 and t1 <= b]
    return min(held)[1] if held else None


# the runtime calls in which the host waits for the device
HOST_WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")


def _traced(logdir):
    """The complete events of ``utils/profiling.trace``'s trace in
    ``logdir``, and its annotations as (name, start, end)."""
    import json
    with open(logdir / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    return events, [(e["name"], *_at(e)) for e in events
                    if e.get("cat") == "user_annotation"]


def _at(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _host_waits(events, notes):
    """{runtime call: [innermost annotation of each]} of the host's waits
    inside the ``synth.call`` annotations' span."""
    calls = [(a, b) for n, a, b in notes if n == "synth.call"]
    t0, t1 = min(a for a, _ in calls), max(b for _, b in calls)
    waits = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["name"] in HOST_WAITS \
                and t0 <= float(e["ts"]) <= t1:
            waits.setdefault(e["name"], []).append(
                _innermost(*_at(e), notes))
    return waits


def test_spans_share_the_device_trace_clock(cuda, tmp_path):
    """Three single-sentence requests at base_config under
    ``utils/profiling.trace``: each K1 launch's runtime call lies inside a
    ``k1.launch`` annotation, inside ``text2mel.decode`` as ``k1.prepare``
    is, the launch the stamped twin; each wait of the host for the device
    during the calls inside a program span (the copy back's
    ``cudaEventSynchronize`` in ``to_host.wait``, one a request; ``-s``
    prints where the stream synchronisations of pageable copies lie), and
    ``text2mel.decode``'s device ms holds K1's kernel time."""
    from dc_tts_tpu_torch.bench import seeded_nets

    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg), pcm16=True)
    ids = _ids(cfg, 3).numpy()
    synth.synthesize_ids_chunked(ids[:1], 1)                 # warm-up
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        for i in range(3):
            synth.synthesize_ids_chunked(ids[i: i + 1], 1)
    s = profiling.summary()
    profiling.reset()
    events, notes = _traced(tmp_path)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "decode_kernel" in e["name"]]
    corr = {e["args"]["correlation"] for e in kernels}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in corr]
    assert len(kernels) == len(launches) == 3 == s["text2mel.decode"][
        "count"] == s["k1.prepare"]["count"] == s["k1.launch"]["count"]
    assert [_innermost(*_at(e), notes) for e in launches] == \
        ["k1.launch"] * 3
    decodes = [(a, b) for n, a, b in notes if n == "text2mel.decode"]
    for n, a, b in notes:
        if n in ("k1.prepare", "k1.launch"):
            assert any(da <= a and b <= db for da, db in decodes), n
    # the profiler records spans, so each launch took the stamped twin
    assert s["k1.phase.product"]["count"] == 3
    waits = _host_waits(events, notes)
    print("waits by innermost span:", waits)
    assert waits["cudaEventSynchronize"] == ["to_host.wait"] * 3
    assert None not in sum(waits.values(), [])
    k_ms = sum(float(e["dur"]) for e in kernels) / 1e3
    dec = s["text2mel.decode"]
    assert 0.99 * k_ms <= dec["device_ms"] <= k_ms + dec["host_ms"] + 1.0


def test_chunked_copy_back_overlaps_and_vocoder_never_waits(cuda, tmp_path):
    """Five rows at base_config in chunks of 2 (a tail of 1): the pcm16
    output bit for bit the concatenation of ``synthesize_ids`` over the
    chunks, and the caller's own (a later call leaves it as it was). The
    staging pair is allocated in the first call and de-emphasis's tables
    are uploaded there, never in the second. Under ``utils/profiling.trace``
    the second call's host waits lie in ``to_host.wait`` (one event wait a
    chunk) or in ``synth.rows`` (the ids' upload, at most one a chunk),
    none in ``vocoder``, and chunk k's copy into the output runs inside
    chunk k + 1's ``synth.rows``, once its decode is enqueued, or after the
    last chunk."""
    from dc_tts_tpu_torch.bench import seeded_nets

    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg), pcm16=True)
    ids = _ids(cfg, 5, seed=5).numpy()
    c0 = profiling.counts()
    first = synth.synthesize_ids_chunked(ids, 2)
    assert _counted(c0)["to_host.staging.allocs"] == 2
    want = torch.cat([synth.synthesize_ids(ids[i: i + 2])[0].cpu()
                      for i in range(0, 5, 2)]).numpy()
    assert first.dtype == np.int16 and first.shape == want.shape
    np.testing.assert_array_equal(first, want)
    kept = first.copy()
    other = _ids(cfg, 5, seed=6).numpy()
    c1 = profiling.counts()
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        second = synth.synthesize_ids_chunked(other, 2)
    profiling.reset()
    n = _counted(c1)
    assert n["to_host.staging.allocs"] == n["deemphasis.table_uploads"] == 0
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    events, notes = _traced(tmp_path)
    waits = _host_waits(events, notes)
    print("waits by innermost span:", waits)
    assert waits["cudaEventSynchronize"] == ["to_host.wait"] * 3
    assert "cudaDeviceSynchronize" not in waits
    uploads = waits.get("cudaStreamSynchronize", [])
    assert set(uploads) <= {"synth.rows"} and len(uploads) <= 3

    def spans(name):
        return sorted((a, b) for m, a, b in notes if m == name)
    rows, decodes = spans("synth.rows"), spans("text2mel.decode")
    cats = spans("to_host.cat")
    assert len(rows) == len(decodes) == len(cats) == 3
    for k in range(2):
        assert decodes[k + 1][1] <= cats[k][0] and cats[k][1] <= rows[k + 1][1]
    assert cats[2][0] >= rows[2][1]
    np.testing.assert_array_equal(
        second, torch.cat([synth.synthesize_ids(other[i: i + 2])[0].cpu()
                           for i in range(0, 5, 2)]).numpy())


# ------------------------------------------------------------------ TextEnc graphs


def _biased_t2m(cfg, dev, seed=7):
    """Text2Mel's initial weights with every leaf moved by 0.1 x N(0, 1):
    biases, norm shifts and gains away from 0 and 1."""
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(seed)
    p = Text2Mel(cfg).init(gen)
    return tree_map(lambda t: (t + 0.1 * torch.randn(t.shape, generator=gen)
                               ).to(dev), p)


@pytest.mark.parametrize("B,N", [(1, 180), (72, 180), (3, 40)])
def test_textenc_graph_bitwise_equals_eager(cuda, B, N):
    """The captured TextEnc's K and V equal eager ``text_encode``'s in
    synthesis (gradients off, the tails through K5) bit for bit, at its
    capture and at a replay with other ids."""
    from dc_tts_tpu_torch.pipeline import text_encode_graphs
    cfg = base_config().replace(max_N=N)
    model = Text2Mel(cfg)
    p = _biased_t2m(cfg, cuda)
    graphs = text_encode_graphs(model, p)
    for seed in (0, 1):
        ids = _ids(cfg, B, seed=seed).to(cuda)
        K, V = graphs(ids)
        with torch.no_grad():
            Ke, Ve = model.text_encode(p, ids)
        assert K.is_contiguous() and V.is_contiguous()
        assert torch.equal(K, Ke) and torch.equal(V, Ve), seed


@pytest.mark.parametrize("B", [1, 4])
def test_synthesizer_textenc_graph_matches_eager_chain(cuda, B):
    """Two batches of other ids through the Synthesizer back to back, with
    no wait between: Y, A and pcm16 bitwise the eager TextEnc's (a stale
    static input would give the second the first's); one capture for the
    shape, one replay a call."""
    from dc_tts_tpu_torch.bench import seeded_nets
    cfg = base_config()
    synth = Synthesizer(cfg, _biased_t2m(cfg, "cpu"), seeded_nets(cfg)[1],
                        pcm16=True)
    batches = [_ids(cfg, B, seed=10 + B + i).numpy() for i in range(2)]
    c0 = profiling.counts()
    graphed = [synth.synthesize_ids(ids) for ids in batches]
    torch.cuda.synchronize()
    n = _counted(c0)
    assert (n["textenc.graph.captures"], n["textenc.graph.replays"]) == (1, 2)
    encoder, synth.text_encoder = synth.text_encoder, None
    eager = [synth.synthesize_ids(ids) for ids in batches]
    synth.text_encoder = encoder
    for (w, Y, _, A), (we, Ye, _, Ae) in zip(graphed, eager):
        assert w.dtype == torch.int16
        assert torch.equal(Y, Ye) and torch.equal(A, Ae)
        assert torch.equal(w, we)
    assert not torch.equal(graphed[0][1], graphed[1][1])


def test_textenc_graph_cache_evicts_and_recaptures(cuda):
    """One shape past ``TEXTENC_GRAPHS``: the least recently used shape is
    evicted, and on its next call captured again, bitwise the eager K, V."""
    from dc_tts_tpu_torch.pipeline import TEXTENC_GRAPHS
    from dc_tts_tpu_torch.pipeline import text_encode_graphs
    cfg = test_config()
    model = Text2Mel(cfg)
    p = _biased_t2m(cfg, cuda)
    graphs = text_encode_graphs(model, p)
    ids = {B: _ids(cfg, B, seed=B).to(cuda)
           for B in range(1, TEXTENC_GRAPHS + 2)}
    c0 = profiling.counts()
    for B in range(1, TEXTENC_GRAPHS + 1):
        graphs(ids[B])
    graphs(ids[1])                         # shape 2 is now the oldest
    graphs(ids[TEXTENC_GRAPHS + 1])
    assert _counted(c0)["textenc.graph.captures"] == TEXTENC_GRAPHS + 1
    assert (2, cfg.max_N) not in graphs.graphs
    assert len(graphs.graphs) == TEXTENC_GRAPHS
    K, V = graphs(ids[2])
    assert _counted(c0)["textenc.graph.captures"] == TEXTENC_GRAPHS + 2
    with torch.no_grad():
        Ke, Ve = model.text_encode(p, ids[2])
    assert torch.equal(K, Ke) and torch.equal(V, Ve)


def test_textenc_graph_captured_under_the_profiler(cuda):
    """A shape's first call while ``torch.profiler`` records (capture and
    replay inside the trace) gives the eager K, V bit for bit, and a
    replay's kernels appear in the trace."""
    from dc_tts_tpu_torch.pipeline import text_encode_graphs
    cfg = test_config()
    model = Text2Mel(cfg)
    p = _biased_t2m(cfg, cuda)
    graphs = text_encode_graphs(model, p)
    ids = _ids(cfg, 2).to(cuda)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        K, V = graphs(ids)
        K, V = graphs(ids)
        torch.cuda.synchronize()
    with torch.no_grad():
        Ke, Ve = model.text_encode(p, ids)
    assert torch.equal(K, Ke) and torch.equal(V, Ve)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


# ------------------------------------------------------------------ K5


def _biased_ssrn(cfg, dev, seed=11):
    """SSRN's initial weights with every bias, norm gain and shift moved by
    0.1 x N(0, 1), the convs kept (the benchmark's kind of weights)."""
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(seed)
    p = SSRN(cfg).init(gen)
    stack = [{k: {n: (t if n == "w" else
                      t + 0.1 * torch.randn(t.shape, generator=gen))
                  for n, t in v.items()} for k, v in blk.items()}
             for blk in p["stack"]]
    return tree_map(lambda t: t.to(dev), {"stack": stack})


def _k5_case(dev, B, seed=3):
    cfg = base_config().replace(compute_dtype="float32_high")
    gen = torch.Generator(device=dev).manual_seed(seed)
    Y = torch.rand(B, cfg.max_T, cfg.n_mels, generator=gen, device=dev)
    return cfg, _biased_ssrn(cfg, dev), Y


@pytest.mark.parametrize("B", [1, 72])
def test_k5_blocks_match_the_eager_chain(cuda, B, monkeypatch):
    """Every SSRN block through K5 on its input in the eager chain: the
    prologue's halves bitwise its plain version's; y within 1e-5 x max(1,
    max|y|) of ``apply_block``'s (the layer norms' sums run in another
    order; the products' sums are added in the next product's epilogue);
    two launches a block, and never the plain version on CUDA."""
    from dc_tts_tpu_torch.models import blocks
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs
    from dc_tts_tpu_torch.ops import ssrn_block as K5

    def refuse(*a):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(K5, "ssrn_block_plain", refuse)
    cfg, params, x = _k5_case(cuda, B)
    specs = ssrn_specs(cfg)
    packed = SSRN(cfg).pack(params)
    worst = {}
    with torch.no_grad():
        for i, (p, spec, h) in enumerate(zip(params["stack"], specs,
                                             packed)):
            Kp = h.hi.shape[-2]
            for got, want in zip(K5.prologue(x, spec, Kp),
                                 K5.prologue_plain(x, spec, Kp)):
                assert torch.equal(got, want), (i, spec)
            c0 = profiling.counts()
            y = K5.ssrn_block(p, spec, x, h, cfg.ln_eps)
            assert _counted(c0)["k5.launches"] == 2
            want = blocks.apply_block(p, spec, x, ln_eps=cfg.ln_eps,
                                      dtype="high")
            d = float((y - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[f"{i}:{type(spec).__name__}"] = (d, scale)
            assert y.shape == want.shape and d <= 1e-5 * scale, (i, spec, d)
            x = want
    print({k: f"{d:.2e}/{s:.1f}" for k, (d, s) in worst.items()})


def _k5_gate(params, specs, Y, ln_eps, packed):
    """(the eager chain's Z, the gate for K5's Z against it): max(1e-5, 2 x
    the distance between the plain version with float32 sums and with
    float64 sums), the gate of K1's reduced bodies. K5 reorders float32
    sums only (the layer norms', and the products' inside cuBLAS, whose
    kernels differ with the padded shapes), so it lies within the float32
    noise of the chain, which over 16 blocks is ~1e-5 of Z."""
    from dc_tts_tpu_torch.models.blocks import apply_stack
    from dc_tts_tpu_torch.ops import ssrn_block as K5
    with torch.no_grad():
        Zp = torch.sigmoid(apply_stack(params["stack"], specs, Y,
                                       ln_eps=ln_eps, dtype="high"))
        Z64 = torch.sigmoid(K5.ssrn_stack_plain(
            params["stack"], specs, Y, packed, ln_eps, torch.float64))
    return Zp, Z64, max(1e-5, 2 * float((Zp - Z64).abs().max()))


@pytest.mark.parametrize("B", [1, 72])
def test_k5_ssrn_matches_the_eager_chain(cuda, B):
    """``SSRN.apply`` in synthesis's "high" mode on the card takes K5 (32
    launches a call, the halves packed when not given, bitwise the same):
    Z within ``_k5_gate`` of the eager chain's."""
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs

    cfg, params, Y = _k5_case(cuda, B, seed=4)
    model = SSRN(cfg)
    packed = model.pack(params)
    with torch.no_grad():
        c0 = profiling.counts()
        _, Z = model.apply(params, Y, packed=packed)
        assert _counted(c0)["k5.launches"] == 32
        _, Z2 = model.apply(params, Y)
    Zp, Z64, gate = _k5_gate(params, ssrn_specs(cfg), Y, cfg.ln_eps, packed)
    dZ = float((Z - Zp).abs().max())
    print(f"B={B} max|dZ| K5-eager {dZ:.3e}, K5-float64 "
          f"{float((Z - Z64).abs().max()):.3e}, eager-float64 "
          f"{float((Zp - Z64).abs().max()):.3e}; gate {gate:.3e}")
    assert torch.equal(Z, Z2)
    assert Z.shape == (B, cfg.max_T * cfg.r, cfg.n_freq) and dZ <= gate


def test_k5_not_taken_with_gradients_or_other_modes(cuda):
    """Gradients on, training, float32 and bf16 operands: no K5 launch."""
    cfg, params, Y = _k5_case(cuda, 1, seed=5)
    c0 = profiling.counts()
    SSRN(cfg).apply(params, Y)                          # gradients on
    with torch.no_grad():
        SSRN(cfg.replace(dropout_rate=0.0)).apply(params, Y, train=True)
        for compute in ("float32", "bfloat16", "bfloat16_full"):
            SSRN(cfg.replace(compute_dtype=compute)).apply(params, Y)
    assert _counted(c0)["k5.launches"] == 0


def test_synthesizer_runs_k5_once_a_block(cuda):
    """The default Synthesizer on the card: 32 K5 launches a chunk, Z
    within ``_k5_gate`` of the eager chain on the chunk's own Y."""
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs
    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg), pcm16=True)
    c0 = profiling.counts()
    _, Y, Z, _ = synth.synthesize_ids(_ids(cfg, 3).numpy())
    assert _counted(c0)["k5.launches"] == 32
    Zp, _, gate = _k5_gate(synth.ssrn_params, ssrn_specs(cfg), Y,
                           cfg.ln_eps, synth.ssrn_packed)
    assert float((Z - Zp).abs().max()) <= gate


# ------------------------------------------------------------ K5 in TextEnc


@pytest.mark.parametrize("B", [1, 2, 72])
def test_textenc_k5_blocks_match_the_eager_chain(cuda, B, monkeypatch):
    """Every TextEnc block through ``float32_block`` on its input in the
    eager chain, at N = 180: the product bitwise ``layers.conv1d``'s before
    its bias, y within 1e-5 x max(1, max|y|) of ``apply_block``'s (the
    layer norms' sums in another order), one epilogue launch a block and
    never the plain tail on CUDA; then ``text_encode`` routed (gradients
    off, 14 launches) against the eager chain (gradients on, none): K and
    V within the same bound."""
    from dc_tts_tpu_torch.models import blocks
    from dc_tts_tpu_torch.models import layers as L
    from dc_tts_tpu_torch.models.text2mel import text_enc_specs
    from dc_tts_tpu_torch.ops import ssrn_block as K5

    def refuse(*a):
        raise AssertionError("the plain tail ran on CUDA tensors")

    monkeypatch.setattr(K5, "tail_plain", refuse)
    cfg = base_config()
    model, p = Text2Mel(cfg), _biased_t2m(cfg, cuda)
    ids = _ids(cfg, B, seed=B).to(cuda)
    specs = text_enc_specs(cfg)
    worst = {}
    with torch.no_grad():
        x = L.embedding_lookup(p["embed"], ids)
        for i, (bp, spec) in enumerate(zip(p["text_enc"], specs)):
            w = bp["conv"]["w"]
            prod = L.matmul(L._gather_taps(x, spec.size, spec.rate,
                                           spec.causal),
                            w.reshape(-1, w.shape[-1]))
            conv = L.conv1d(bp["conv"], x, size=spec.size, rate=spec.rate)
            assert torch.equal(prod + bp["conv"]["b"], conv), (i, spec)
            c0 = profiling.counts()
            y = K5.float32_block(bp, spec, x, cfg.ln_eps)
            assert _counted(c0)["k5.textenc.launches"] == 1
            want = blocks.apply_block(bp, spec, x, ln_eps=cfg.ln_eps)
            d = float((y - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[f"{i}:{type(spec).__name__}"] = (d, scale)
            assert y.shape == want.shape and d <= 1e-5 * scale, (i, spec, d)
            x = want
        c0 = profiling.counts()
        K, V = model.text_encode(p, ids)
        assert _counted(c0)["k5.textenc.launches"] == len(specs) == 14
    c0 = profiling.counts()
    Ke, Ve = model.text_encode(p, ids)                  # gradients on
    assert _counted(c0)["k5.textenc.launches"] == 0
    scale = max(1.0, float(Ke.abs().max()), float(Ve.abs().max()))
    dK, dV = float((K - Ke).abs().max()), float((V - Ve).abs().max())
    print(f"B={B} max|dK| {dK:.3e} max|dV| {dV:.3e} scale {scale:.2f}; "
          + str({k: f"{d:.2e}/{s:.1f}" for k, (d, s) in worst.items()}))
    assert K.shape == Ke.shape == (B, cfg.max_N, cfg.d)
    assert max(dK, dV) <= 1e-5 * scale


def test_textenc_k5_not_taken_off_the_route(cuda):
    """Gradients on, training, the "high" and bf16 operand modes: TextEnc
    launches no epilogue, and its K and V are the eager chain's bits."""
    from dc_tts_tpu_torch.models.blocks import apply_stack
    from dc_tts_tpu_torch.models import layers as L
    from dc_tts_tpu_torch.models.text2mel import text_enc_specs
    cfg = test_config()
    p = _biased_t2m(cfg, cuda)
    ids = _ids(cfg, 2).to(cuda)
    c0 = profiling.counts()
    K, V = Text2Mel(cfg).text_encode(p, ids)             # gradients on
    with torch.no_grad():
        Text2Mel(cfg.replace(dropout_rate=0.0)).text_encode(p, ids,
                                                            train=True)
        for compute in ("float32_high", "bfloat16", "bfloat16_full"):
            Text2Mel(cfg.replace(compute_dtype=compute)).text_encode(p, ids)
        want = apply_stack(p["text_enc"], text_enc_specs(cfg),
                           L.embedding_lookup(p["embed"], ids),
                           ln_eps=cfg.ln_eps)
    assert _counted(c0)["k5.textenc.launches"] == 0
    assert torch.equal(torch.cat([K, V], -1), want)


def test_synthesizer_counts_textenc_k5_at_capture(cuda):
    """The Synthesizer's TextEnc graph launches the epilogue once a block
    in each of the capture's two calls (the side stream's, then the
    captured one), and a replay counts none; SSRN's K5 still launches 32
    times a call."""
    from dc_tts_tpu_torch.bench import seeded_nets
    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg), pcm16=True)
    ids = _ids(cfg, 2).numpy()
    c0 = profiling.counts()
    synth.synthesize_ids(ids)
    n = _counted(c0)
    assert (n["k5.textenc.launches"], n["k5.launches"]) == (28, 32)
    c0 = profiling.counts()
    synth.synthesize_ids(ids)
    n = _counted(c0)
    assert (n["k5.textenc.launches"], n["k5.launches"]) == (0, 32)
