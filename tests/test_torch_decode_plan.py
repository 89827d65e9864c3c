"""K1's partition over the card's blocks, checked on the CPU.

The CUDA kernel (``csrc/decode.cu``) splits every layer's output columns
over the blocks of one cooperative launch and runs every batch row through
each block in tasks of ``RG`` rows (``RG_WIDE`` in its wide instantiation
at large B); ``decode_plan`` lays out its shared memory, the wide kernel's
staging slot among it. These tests hold that host-side plan to covering every column and
row exactly once, the transposed packing to the JAX-layout keys bitwise,
and an emulation of the kernel's product arithmetic (each block's column
slice, each column summed over k in the kernel's lane order and butterfly)
to ``layer_product``. No card is needed.
"""
import numpy as np
import pytest
import torch

from dc_tts_tpu_torch.config import base_config, test_config
from dc_tts_tpu_torch.models import Text2Mel
from dc_tts_tpu_torch.ops import decode as K1
from dc_tts_tpu_torch.utils import profiling

CONFIGS = {"test": test_config, "base": base_config}
# grid sizes the kernel takes: whole clusters (one block per SM: 132 on
# the H100)
BLOCKS = (32, 64, 132)


def _layers(cfg):
    enc, dec = K1._programs(cfg)
    return [(False, l) for l in enc] + [(True, l) for l in dec]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("B", [1, 5, 20, 72])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_partition_covers_every_column_and_row(name, B, blocks):
    """Every output column of every layer is owned by exactly one block,
    every batch row lies in exactly one row group of at most RG rows, and
    its layer norms are computed by exactly one block of each cluster."""
    cfg = CONFIGS[name]()
    for _, l in _layers(cfg):
        width = K1.layer_width(l)
        owner = np.zeros(width, np.int64)
        for g in range(blocks):
            c0, c1 = K1.block_columns(width, blocks, g)
            assert 0 <= c0 <= c1 <= width
            owner[c0:c1] += 1
        assert (owner == 1).all(), (l, blocks)
    rows = np.zeros(B, np.int64)
    for r0, r1 in K1.row_groups(B):
        assert 0 < r1 - r0 <= K1.RG
        rows[r0:r1] += 1
    assert (rows == 1).all()
    # each row's layer norms: one block of each cluster
    normed = np.zeros(B, np.int64)
    for rank in range(K1.CLUSTER):
        normed[list(K1.cluster_rows(B, rank, K1.CLUSTER))] += 1
    assert (normed == 1).all()


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("B", [1, 5, 20, 72])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_fits_shared_memory(name, B, blocks):
    """In every precision: the layout fits one block's shared memory, its
    regions are 16-byte aligned and do not overlap, a resident slice holds
    the block's largest column slice, and the rows past the resident ones
    spill."""
    cfg = CONFIGS[name]()
    for prec in K1.PRECS:
        plan = K1.decode_plan(cfg, B, blocks, prec)
        assert plan.smem <= K1.SMEM_MAX
        assert plan.rows_sh + plan.spill_floats // plan.xw == B
        assert plan.xw % 4 == 0 and plan.xw >= max(2 * cfg.d, cfg.n_mels)
        assert plan.part_off == 4 * plan.xw * plan.rows_sh
        assert plan.prev_off >= plan.part_off + 4 * B * plan.nv_max
        spans = [(plan.prev_off, plan.prev_off + 4 * B),
                 (plan.ln_off, plan.ln_off + 4 * 4 * cfg.d),
                 (plan.z_off, plan.z_off + 4 * plan.ldh
                  * K1.staged_rows(B, plan.exchange, plan.cluster))]
        for (is_dec, l), n, off in zip(_layers(cfg), plan.nmax, plan.woff):
            width = K1.layer_width(l)
            assert n == max(c1 - c0 for c0, c1 in (
                K1.block_columns(width, blocks, g) for g in range(blocks)))
            if off < 0:
                continue
            kind = K1.layer_wkind(prec, is_dec)
            size = n * K1.layer_depth(l) * (4 if kind == "f32" else 2) \
                * (2 if kind == "split" else 1)
            assert off % 16 == 0
            if off == plan.stage_off:  # the staging slot holds it
                assert size <= plan.stage_bytes
            else:
                spans.append((off, off + size))
        if plan.stage_off >= 0:
            spans.append((plan.stage_off, plan.sbar_off + 8))
        spans.sort()
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            assert e0 <= s1
        assert spans[-1][1] <= plan.smem
        hc = [l for _, l in _layers(cfg) if l.kind == "HC"]
        assert plan.ring_floats == K1.ring_rows(cfg) * B * 2 * \
            -(-2 * cfg.d // blocks) * bool(hc)
        assert plan.barriers_per_step == (
            len(_layers(cfg)) if plan.exchange == "grid" else 0)
        # the staging holds a row for every warp that normalises one: under
        # "grid" (sized for rank 0) in every rank, under "flag" every row
        assert len(K1.cluster_rows(B, 0, plan.cluster)) == max(
            len(K1.cluster_rows(B, r, plan.cluster))
            for r in range(plan.cluster))
        assert K1.staged_rows(B, "flag", plan.cluster) == B


@pytest.mark.parametrize("prec", K1.PRECS)
@pytest.mark.parametrize("blocks", [32, 132])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_grid_plans_stage_every_slice_that_finds_no_room(name, blocks, prec):
    """For B = 1 .. 288: the layout fits shared memory; where the grid
    exchange takes wide tasks (the wide kernel: wherever they take fewer
    rounds of the warps and every row then fits) every layer's slice is
    resident or staged, the staging slot holds the largest staged slice
    and lies apart from the resident ones, and the staged layers fetch
    each other in one cycle in program order; every other plan stages
    nothing. Every layer's task shape is one the kernel reads: RG rows, or
    RG_WIDE (not the split's products, every row and slice in shared
    memory, the grid exchange only, and fewer rounds of the warps than
    RG), its sums a divisor of the 32 lanes, its row groups covering B
    once."""
    cfg = CONFIGS[name]()
    layers = _layers(cfg)
    for B in range(1, 289):
        plan = K1.decode_plan(cfg, B, blocks, prec)
        assert plan.smem <= K1.SMEM_MAX
        sizes = [K1.slice_bytes(l, n, K1.layer_wkind(prec, d))
                 for (d, l), n in zip(layers, plan.nmax)]
        staged = [i for i, s in enumerate(plan.staged) if s]
        if K1.RG_WIDE in plan.task_rows:
            assert plan.exchange == "grid" and min(plan.woff) >= 0, B
        else:
            assert not staged and plan.stage_off == plan.sbar_off == -1
        if plan.stage_off >= 0:
            assert plan.stage_bytes == max(sizes)
            assert plan.stage_off % 16 == 0
            # the slot's mbarrier just past it
            assert plan.sbar_off == plan.stage_off + plan.stage_bytes
            assert plan.sbar_off % 8 == 0 and plan.sbar_off + 8 <= plan.smem
            for i, (o, size) in enumerate(zip(plan.woff, sizes)):
                if o != plan.stage_off:
                    assert o >= plan.sbar_off + 8 or o + size <= plan.stage_off
        assert all(plan.woff[i] == plan.stage_off for i in staged)
        assert len(staged) != 1
        cycle = K1.stage_cycle(plan)
        assert sorted(cycle) == sorted(cycle.values()) == staged
        assert all(cycle[a] == b for a, b in zip(staged, staged[1:]))
        for (d, l), n, rows in zip(layers, plan.nmax, plan.task_rows):
            kind = K1.layer_wkind(prec, d)
            assert rows in (K1.RG, K1.RG_WIDE)
            assert 32 % (rows * K1.task_columns(kind)) == 0
            covered = np.zeros(B, np.int64)
            for r0, r1 in K1.row_groups(B, rows):
                assert 0 < r1 - r0 <= rows
                covered[r0:r1] += 1
            assert (covered == 1).all()
            if rows == K1.RG_WIDE:
                nv = (3 if l.kind == "HC" else 1) * n
                assert kind != "split" and plan.rows_sh == B
                assert min(plan.woff) >= 0
                assert plan.exchange == "grid"
                assert K1.task_rounds(B, K1.RG_WIDE, nv, kind) < \
                    K1.task_rounds(B, K1.RG, nv, kind)


def test_plan_at_b72_stages_and_takes_wide_tasks():
    """bulk synthesis's chunk at base_config over the H100's 132 blocks:
    every activation row in shared memory, every layer's slice in it (most
    staged), and the float32 products in tasks of RG_WIDE rows (an HC
    layer's 27 tasks take 2 rounds of the 16 warps, not 54 in 4)."""
    plan = K1.decode_plan(base_config(), 72, 132)
    assert plan.exchange == "grid" and plan.rows_sh == 72
    assert all(o >= 0 for o in plan.woff) and sum(plan.staged) >= 12
    assert set(plan.task_rows) == {K1.RG_WIDE}
    assert K1.task_rounds(72, K1.RG_WIDE, 12, "f32") == 2
    assert K1.task_rounds(72, K1.RG, 12, "f32") == 4
    # the split's products keep RG rows
    assert set(K1.decode_plan(base_config(), 72, 132, "high3").task_rows) \
        == {K1.RG}


@pytest.mark.parametrize("blocks", [120, 128, 132])
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("B", [1, 5, 20, 72])
def test_cluster_rows_follow_the_width(B, width, blocks):
    """In clusters of 2, 4 or 8 over the grids whole clusters of each
    width give on the H100 (132, 120) and 128: every row's layer norms are
    computed by exactly one rank of each cluster, rank 0 holds the most
    rows, and the grid exchange's staging of the normalised rows (sized
    for rank 0) holds a row for every warp of any rank that normalises
    one."""
    normed = np.zeros(B, np.int64)
    counts = []
    for rank in range(width):
        rows = K1.cluster_rows(B, rank, width)
        assert all(b % width == rank for b in rows)
        normed[list(rows)] += 1
        counts.append(len(rows))
    assert (normed == 1).all()
    assert counts[0] == max(counts)
    staged = K1.staged_rows(B, "grid", width)
    assert staged == min(K1.WARPS, counts[0])
    assert K1.staged_rows(B, "flag", width) == B
    # a plan of this width, where the kernel it takes is built at it,
    # stages that many rows
    plan = K1.decode_plan(base_config(), B, blocks)
    if width in K1.cluster_widths(K1.RG_WIDE in plan.task_rows):
        plan = K1.decode_plan(base_config(), B, blocks, cluster=width)
        assert plan.cluster == width
        assert plan.z_off + 4 * plan.ldh * K1.staged_rows(
            B, plan.exchange, width) <= plan.smem


def test_plan_at_b72_takes_the_wide_cluster():
    """At bulk synthesis's B = 72 the base_config plan takes the wide
    kernel in clusters of ``WIDE_CLUSTER`` (a block normalises 72 /
    WIDE_CLUSTER rows over its 16 warps, one round), over the grid whole
    clusters of it give on the H100 (120) and others, and in clusters of
    ``CLUSTER`` when asked, with the same task shape; every other kernel
    keeps clusters of ``CLUSTER`` (the common kernel at B = 20 and under
    "high3", the flagged one at B <= 2) and refuses another width."""
    cfg = base_config()
    for blocks in (120, 128, 132):
        plan = K1.decode_plan(cfg, 72, blocks)
        assert plan.cluster == K1.WIDE_CLUSTER > K1.CLUSTER
        assert set(plan.task_rows) == {K1.RG_WIDE}
        # a block's rows take its warps one round, not three
        assert len(K1.cluster_rows(72, 0, plan.cluster)) <= K1.WARPS
        assert len(K1.cluster_rows(72, 0, K1.CLUSTER)) > 2 * K1.WARPS
        narrow = K1.decode_plan(cfg, 72, blocks, cluster=K1.CLUSTER)
        assert narrow.cluster == K1.CLUSTER
        assert narrow.task_rows == plan.task_rows
        assert sum(narrow.staged) >= 12 and min(narrow.woff) >= 0
    for B, prec in ((20, "highest"), (72, "high3"), (1, "highest"),
                    (2, "highest")):
        plan = K1.decode_plan(cfg, B, 132, prec)
        assert plan.cluster == K1.CLUSTER and K1.RG_WIDE not in plan.task_rows
        with pytest.raises(ValueError, match="clusters of"):
            K1.decode_plan(cfg, B, 132, prec, cluster=K1.WIDE_CLUSTER)


def _wide_batches(blocks):
    """The B (1 .. 288) at which the base_config plan over ``blocks``
    blocks takes the wide kernel's tasks."""
    cfg = base_config()
    return [B for B in range(1, 289)
            if K1.RG_WIDE in K1.decode_plan(cfg, B, blocks).task_rows]


@pytest.mark.parametrize("blocks", [120, 128, 132])
@pytest.mark.parametrize("width", [2, 4, 8])
def test_attention_rows_and_owners_cover_every_row(width, blocks):
    """Over the grid whole clusters of ``width`` give from 120, 128 or 132
    blocks, at every B the wide kernel takes there at base_config: with
    the attention split, every row's attention is computed by exactly one
    rank of each cluster, the rank that normalises it; and every row of A
    has exactly one writer over the grid, a block that computes the row
    (its owner, of rank b % width in cluster (b / width) % clusters).
    Without the split every block computes every row and the owner alone
    writes it."""
    grid = blocks // width * width
    clusters = grid // width
    batches = _wide_batches(grid)
    assert batches and min(batches) > 2
    for B in batches:
        for split in (True, False):
            writers = np.zeros(B, np.int64)
            for c in range(clusters):
                computed = np.zeros(B, np.int64)
                for rank in range(width):
                    g = c * width + rank
                    rows = K1.attention_rows(B, rank, width, split)
                    computed[list(rows)] += 1
                    if split:
                        assert rows == K1.cluster_rows(B, rank, width)
                    for b in rows:
                        writers[b] += K1.row_owner(b, grid) == g
                assert (computed == (1 if split else width)).all(), (B, c)
            assert (writers == 1).all(), (B, split)
        for b in range(B):
            g = K1.row_owner(b, grid)
            assert (g % width, g // width) == (b % width,
                                               (b // width) % clusters)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_splits_the_attention_where_it_takes_wide_tasks(name):
    """``decode_plan`` sets ``attn_split`` exactly where it takes RG_WIDE
    tasks (the wide kernel, in its clusters of ``WIDE_CLUSTER``), over 120,
    128 and 132 blocks, B = 1 .. 288, in every precision; asked for
    clusters of ``CLUSTER`` the wide kernel keeps every row's attention in
    every block. At base_config over the H100's 132 blocks (the grid a
    launch plans over first): split at B = 72, not at B = 1 or 20."""
    cfg = CONFIGS[name]()
    for blocks in (120, 128, 132):
        for prec in K1.PRECS:
            for B in range(1, 289):
                plan = K1.decode_plan(cfg, B, blocks, prec)
                wide = K1.RG_WIDE in plan.task_rows
                assert plan.attn_split == wide, (blocks, prec, B)
                assert plan.attn_split == (
                    K1.kernel_name(cfg, plan) == "wide"
                    and plan.cluster == K1.WIDE_CLUSTER)
                if wide:
                    assert not K1.decode_plan(cfg, B, blocks, prec,
                                              cluster=K1.CLUSTER).attn_split
    if name == "base":
        assert [K1.decode_plan(cfg, B, 132).attn_split
                for B in (72, 20, 1)] == [True, False, False]


@pytest.mark.parametrize("blocks", [120, 126, 128, 130, 131, 132])
def test_launch_refuses_blocks_not_whole_clusters(blocks):
    """``launch_decode``'s check (``launch_plan``, no card needed when the
    blocks are given): the grid must be whole clusters of the plan's width
    (at B = 72 the wide kernel's ``WIDE_CLUSTER``; at B = 1 the flagged
    exchange's ``CLUSTER``); asked for clusters of ``CLUSTER``, the wide
    kernel takes them on any even grid."""
    cfg = base_config()
    for B in (72, 20, 1):
        width = K1.decode_plan(cfg, B, blocks).cluster
        assert width == {72: K1.WIDE_CLUSTER, 1: K1.CLUSTER}.get(B, width)
        if blocks % width:
            with pytest.raises(ValueError, match="whole clusters"):
                K1.launch_plan(cfg, B, "highest", "cpu", blocks)
        else:
            plan = K1.launch_plan(cfg, B, "highest", "cpu", blocks)
            assert (plan.blocks, plan.cluster) == (blocks, width)
    if blocks % K1.CLUSTER:
        with pytest.raises(ValueError, match="whole clusters"):
            K1.launch_plan(cfg, 72, "highest", "cpu", blocks,
                           cluster=K1.CLUSTER)
    else:
        plan = K1.launch_plan(cfg, 72, "highest", "cpu", blocks,
                              cluster=K1.CLUSTER)
        assert plan.cluster == K1.CLUSTER and K1.RG_WIDE in plan.task_rows


# the flagged exchange's plans at base_config over 132 blocks, field for
# field (neither staging nor wide tasks: that kernel's code is unchanged)
_NMAX = (2, 2, 2, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 2, 4, 4, 4, 4, 4, 4, 2, 2,
         2, 1)
FLAG_PLANS = {
    1: K1.DecodePlan(
        blocks=132, B=1, exchange="flag", xw=512, ldh=512, ldx=512,
        exchange_bytes=8192, rows_sh=1, nv_max=12, part_off=2048,
        prev_off=2096, ln_off=2112, z_off=6208, nmax=_NMAX,
        woff=(8256, 8896, 10944, 12992, 25280, 37568, 49856, 62144, 74432,
              86720, 99008, 111296, 123584, 135872, 139968, 152256, 164544,
              176832, 189120, 201408, 213696, 215744, 217792, 219840),
        smem=220864, ring_floats=2176, spill_floats=0, barriers_per_step=0,
        staged=(False,) * 24, stage_off=-1, stage_bytes=0, sbar_off=-1,
        task_rows=(4,) * 24),
    2: K1.DecodePlan(
        blocks=132, B=2, exchange="flag", xw=512, ldh=512, ldx=512,
        exchange_bytes=16384, rows_sh=2, nv_max=12, part_off=4096,
        prev_off=4192, ln_off=4208, z_off=8304, nmax=_NMAX,
        woff=(12400, 13040, 15088, 17136, 29424, 41712, 54000, 66288, 78576,
              90864, 103152, 115440, 127728, 140016, 144112, 156400, 168688,
              180976, 193264, 205552, 217840, 219888, 221936, 223984),
        smem=225008, ring_floats=4352, spill_floats=0, barriers_per_step=0,
        staged=(False,) * 24, stage_off=-1, stage_bytes=0, sbar_off=-1,
        task_rows=(4,) * 24)}


@pytest.mark.parametrize("B", sorted(FLAG_PLANS))
def test_flag_plans_are_pinned(B):
    """At B = 1 and 2 the plan is the flagged exchange's, literally (in
    the precisions whose slices take 4 bytes a weight)."""
    for prec in ("highest", "high3"):
        assert K1.decode_plan(base_config(), B, 132, prec) == FLAG_PLANS[B]


@pytest.mark.parametrize("name", ["win5", "d264", "c520"])
def test_general_kernel_neither_stages_nor_widens(name):
    """A config of the general kernel keeps its product and its slices as
    before: tasks of RG rows, slices that find no room stream from L2."""
    cfg = test_config().replace(**GENERAL[name][0])
    for B in (20, 72, 200):
        plan = K1.decode_plan(cfg, B, 32)
        assert plan.stage_off == -1 and not any(plan.staged)
        assert set(plan.task_rows) == {K1.RG}


# the exchange decode_plan picks at base_config over the H100's 132 blocks
RULE = {1: "flag", 2: "flag", 3: "grid", 8: "grid", 20: "grid", 72: "grid"}


@pytest.mark.parametrize("B", sorted(RULE))
def test_plan_picks_the_exchange(B):
    """The flagged exchange at small B, the grid exchange from the B
    where every block's gather (B x the widest pre-norm row) passes
    ``FLAG_WORDS``, in every precision; either is taken when asked."""
    cfg = base_config()
    for prec in K1.PRECS:
        plan = K1.decode_plan(cfg, B, 132, prec)
        assert plan.exchange == RULE[B]
        assert (plan.exchange == "flag") == (B * plan.ldh <= K1.FLAG_WORDS)
        assert K1.decode_plan(cfg, B, 132, prec, "grid").exchange == "grid"
        if B <= 20:
            assert K1.decode_plan(cfg, B, 132, prec, "flag").exchange == \
                "flag"
        else:  # B rows staged besides B rows: past shared memory
            with pytest.raises(ValueError, match="shared memory"):
                K1.decode_plan(cfg, B, 132, prec, "flag")
    with pytest.raises(ValueError, match="exchange"):
        K1.decode_plan(cfg, B, 132, "highest", "ring")


@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 20])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exchange_buffer_size_and_alignment(name, B):
    """The flagged exchange's buffer: two parities of B rows of ``ldx``
    8-byte words, each row on a 128-byte line and at least the widest
    pre-norm row, zeroed (0 is no epoch); the grid exchange's: two parities
    of B rows of ``ldh`` floats."""
    cfg = CONFIGS[name]()
    flag = K1.decode_plan(cfg, B, 132, exchange="flag")
    assert flag.ldx >= flag.ldh and (8 * flag.ldx) % 128 == 0
    assert flag.exchange_bytes == 2 * B * flag.ldx * 8
    words = K1.exchange_buffer(flag, "cpu")
    assert words.dtype == torch.int32 and words.numel() * 4 == \
        flag.exchange_bytes and not bool(words.any())
    assert words.data_ptr() % 8 == 0
    grid = K1.decode_plan(cfg, B, 132, exchange="grid")
    assert grid.ldx == grid.ldh and grid.exchange_bytes == 2 * B * grid.ldh * 4


def test_exchange_epochs_are_unique():
    """A launch's 5040 exchanges (210 steps x 24 layers at base_config)
    carry distinct epochs, none 0, and two launches share none; past 2**32
    the epochs start again at 1."""
    cfg = base_config()
    nl = len(_layers(cfg))
    T = cfg.max_T
    launches = []
    for _ in range(2):
        e0 = K1.next_epoch0(T * nl)
        launches.append({K1.exchange_epoch(e0, t, li, nl)
                         for t in range(T) for li in range(nl)})
    assert T * nl == 5040
    assert all(len(e) == 5040 and 0 not in e for e in launches)
    assert not launches[0] & launches[1]
    saved = K1._EPOCH0[0]
    try:
        K1._EPOCH0[0] = 2 ** 32 - 100
        e0 = K1.next_epoch0(T * nl)
        assert e0 == 1 and K1.next_epoch0(T * nl) == 1 + T * nl
    finally:
        K1._EPOCH0[0] = saved


def test_rows_that_spill_take_the_grid_exchange(monkeypatch):
    """From the B whose rows (with the flagged exchange's staging of
    every row) no longer all fit in shared memory, the plan takes the grid
    exchange, however many words a gather may read, and refuses the flagged
    one; past that the grid exchange's own rows spill too."""
    cfg = base_config()
    monkeypatch.setattr(K1, "FLAG_WORDS", 10 ** 9)
    B = next(b for b in range(1, 1000)
             if K1.decode_plan(cfg, b, 132).exchange == "grid")
    assert B > 1 and K1.decode_plan(cfg, B - 1, 132).rows_sh == B - 1
    with pytest.raises(ValueError, match="shared memory"):
        K1.decode_plan(cfg, B, 132, exchange="flag")
    spill = next(b for b in range(B, 1000)
                 if K1.decode_plan(cfg, b, 132).spill_floats)
    plan = K1.decode_plan(cfg, spill, 132)
    assert plan.exchange == "grid" and plan.rows_sh < spill
    with pytest.raises(ValueError, match="shared memory"):
        K1.decode_plan(cfg, spill, 132, exchange="flag")


# configs of the general kernel (GEN), and two of the common one
GENERAL = {"win5": (dict(attention_win_size=5), True),
           "d264": (dict(d=264), True), "d17": (dict(d=17), True),
           "c520": (dict(n_mels=520), True), "d18": (dict(d=18), False),
           "n_mels10": (dict(n_mels=10), False)}


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_configs_take_the_grid_exchange(name):
    """``general_kernel`` agrees with the condition the C entry takes
    from the layer program (a window past 4 keys, d > 256, a C layer wider
    than 512, an HC layer wider than 256, norm parameters off 16 bytes);
    such a config takes the grid exchange at every B and refuses the
    flagged one."""
    kw, general = GENERAL[name]
    cfg = test_config().replace(**kw)
    params = Text2Mel(cfg).init(torch.Generator().manual_seed(3), "cpu")
    packed = K1.pack_decode_params(cfg, params)
    plan = K1.decode_plan(cfg, 1, 132)
    ints = np.asarray(K1._layer_arrays(packed, cfg, "highest", plan)[0][:])
    kind, cout, lnv = ints.reshape(-1, K1.LAYER_INTS)[:, [0, 2, 11]].T
    c_side = (cfg.attention_win_size > 4 or cfg.d > 256 or not lnv.all()
              or bool((cout > np.where(kind == 1, 256, 512)).any()))
    assert K1.general_kernel(cfg) == c_side == general
    if general:
        assert all(K1.decode_plan(cfg, B, 132).exchange == "grid"
                   for B in (1, 2, 8))
        with pytest.raises(ValueError, match="common kernel"):
            K1.decode_plan(cfg, 1, 132, exchange="flag")
    else:
        assert plan.exchange == "flag"


def test_plan_refuses_too_few_blocks():
    """A block's product sums for all B rows must fit its shared memory:
    too few blocks for B raises rather than launch."""
    with pytest.raises(ValueError, match="more blocks"):
        K1.decode_plan(base_config(), 72, 1)


@pytest.fixture(scope="module")
def packed_test():
    cfg = test_config()
    params = Text2Mel(cfg).init(torch.Generator().manual_seed(3), "cpu")
    return cfg, {p: K1.pack_decode_params(cfg, params, p) for p in K1.PRECS}


@pytest.mark.parametrize("prec", K1.PRECS)
def test_transposed_packing_round_trips(packed_test, prec):
    """Each kernel copy ``<key>_t`` transposed back is the JAX-layout key,
    bit for bit, and is listed in ``_packed_specs``."""
    cfg, packed = packed_test
    got = packed[prec]
    specs = K1._packed_specs(cfg, prec)
    keys = [k for k in got if k.startswith(("cw", "hcw"))
            and not k.endswith("_t")]
    assert keys and all(k + "_t" in specs for k in keys)
    for k in keys:
        back = got[k + "_t"].transpose(-1, -2)
        assert back.dtype == got[k].dtype
        assert torch.equal(back.view(torch.int16) if back.dtype ==
                           torch.bfloat16 else back.view(torch.int32),
                           got[k].view(torch.int16) if back.dtype ==
                           torch.bfloat16 else got[k].view(torch.int32))


@pytest.mark.parametrize("prec", K1.PRECS)
def test_layer_program_by_prec(packed_test, prec):
    """The program the wrapper hands the kernel: each layer's operand kind
    (hybrid: float32 in AudioEnc, the split in AudioDec), its slot's pitch,
    a tap's padded depth, its ring rows in order, and pointers into the
    transposed copies."""
    cfg, packed = packed_test
    p = packed[prec]
    plan = K1.decode_plan(cfg, 5, 7, prec)
    ints, ptrs = K1._layer_arrays(p, cfg, prec, plan)
    ints = np.asarray(ints[:]).reshape(-1, K1.LAYER_INTS)
    ptrs = [ptrs[i:i + 4] for i in range(0, len(ptrs), 4)]
    ring_off = 0
    for li, (is_dec, l) in enumerate(_layers(cfg)):
        (kind, cin, cout, rate, act, roff, wk, ldw, woff, nmax, kp, lnv,
         fetch, rg) = ints[li]
        assert fetch == K1.stage_cycle(plan).get(li, -1)
        assert rg == plan.task_rows[li]
        hc = l.kind == "HC"
        assert (kind, cin, cout, rate) == (int(hc), l.cin, l.cout, l.rate)
        assert K1.WKINDS[wk] == K1.layer_wkind(prec, is_dec)
        assert ldw == (3 * K1._up(cfg.d, K1.PAD) if hc
                       else p["cw_t"].shape[-1])
        assert (woff, nmax) == (plan.woff[li], plan.nmax[li])
        # a tap's padded depth; the norm parameters on 16-byte boundaries
        assert kp == K1.layer_depth(l) // (3 if hc else 1) and lnv == 1
        assert roff == ring_off
        ring_off += 2 * l.rate + 1 if hc else 0
        key = "hcw_t" if hc else "cw_t"
        idx = l.idx
        if prec == "hybrid" and is_dec:
            n_c, n_hc = K1._enc_counts(cfg)
            key, idx = key[:-2] + "2_t", idx - (n_hc if hc else n_c)
        w = p[key]
        if K1.WKINDS[wk] == "split":
            assert ptrs[li][:2] == [w[0, idx].data_ptr(), w[1, idx].data_ptr()]
        else:
            assert ptrs[li][0] == w[idx].data_ptr() and ptrs[li][1] is None
    assert ring_off == K1.ring_rows(cfg)


def test_launch_refuses_cpu_tensors(packed_test):
    """The kernel's launch takes CUDA tensors only: a CPU tensor raises
    before the library is loaded."""
    cfg, packed = packed_test
    Kt = torch.zeros(2, cfg.max_N, cfg.d)
    before = profiling.counts()
    with pytest.raises(ValueError, match="CUDA"):
        K1.launch_decode(packed["highest"], Kt, Kt.clone(), 4, cfg)
    assert profiling.counts() == before


# ---------------------------------------------------------------------------
# the kernel's product arithmetic, emulated


def _fma(a, b, c):
    """float32 fma(a, b, c): the product of two float32 values is exact in
    float64, and so, but for a double rounding, is its sum with c."""
    return (a.double() * b.double() + c.double()).float()


def _warp_column_sums(x, w_t, kind):
    """x (B, K) float32, w_t the columns' weights (n, K) (kind "f32"
    float32, "bf16" bf16; "split" the (2, n, K) bf16 hi/lo stack) ->
    (B, n) as csrc/decode.cu's ``product`` sums each column: lane l of a
    warp takes k = 128i + 4l + e in order with FFMA, then an xor butterfly
    over the lanes; "split" sums hh, hl, lh apart and adds (hh + hl) + lh."""
    B, K = x.shape
    Kp = -(-K // 128) * 128
    xp = torch.nn.functional.pad(x, (0, Kp - K))
    ws = [w_t] if kind != "split" else [w_t[0], w_t[1]]
    ws = [torch.nn.functional.pad(w.float(), (0, Kp - K)) for w in ws]
    if kind == "f32":
        xs = [xp]
    else:
        xh = xp.to(torch.bfloat16).float()
        xs = [xh, (xp - xh).to(torch.bfloat16).float()]
    n, nch = ws[0].shape[0], Kp // 128

    def lanes(a):          # (rows, Kp) -> (nch, 4, rows, 32)
        return a.view(a.shape[0], nch, 32, 4).permute(1, 3, 0, 2)

    xs, ws = [lanes(a) for a in xs], [lanes(w) for w in ws]
    # the split's products: hh = xh.wh, hl = xh.wl, lh = xl.wh
    pairs = {"f32": [(0, 0)], "bf16": [(0, 0)],
             "split": [(0, 0), (0, 1), (1, 0)]}[kind]
    sums = []
    for xi, wi in pairs:
        acc = torch.zeros(B, n, 32)
        for i in range(nch):
            for e in range(4):
                acc = _fma(xs[xi][i, e][:, None, :], ws[wi][i, e][None],
                           acc)
        lane = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lane ^ o]
        sums.append(acc[..., 0])
    return sums[0] if kind != "split" else (sums[0] + sums[1]) + sums[2]


def _partitioned_product(x, w_t, kind, hc, blocks):
    """The layer product as the kernel's blocks compute it: each block's
    column slice, an HC column as ((oldest tap + middle) + current) of its
    three taps' sums; the slices concatenated."""
    width = w_t.shape[-2]
    cols = []
    for g in range(blocks):
        c0, c1 = K1.block_columns(width, blocks, g)
        wg = w_t[..., c0:c1, :]
        if not hc:
            cols.append(_warp_column_sums(x, wg, kind))
            continue
        C = x.shape[1] // 3
        p = [_warp_column_sums(x[:, j * C:(j + 1) * C],
                               wg[..., j * C:(j + 1) * C], kind)
             for j in range(3)]
        cols.append((p[0] + p[1]) + p[2])
    return torch.cat(cols, dim=1)


# base_config's products: AudioEnc's first C layer (k = n_mels = 80, one
# partial 128-chunk), AudioDec's first (512 -> 256), an HC layer (3 taps
# of 256 -> 512)
SHAPES = {"c80": (80, 256, False), "c512": (512, 256, False),
          "hc": (768, 512, True)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "split"])
def test_partitioned_product_matches_layer_product(kind, shape):
    """Per-block slices concatenated equal the unpartitioned sum bitwise
    (the partition changes no column's order over k), at every block count
    the kernel may take; against ``layer_product`` (torch's own order) the
    emulation is within float32's bound for a sum of K products taken in
    another order: 2 K 2^-24 x (|x| @ |w|) per element (x the operand
    values the kind multiplies)."""
    K, width, hc = SHAPES[shape]
    rng = np.random.default_rng(K + width)
    x = torch.as_tensor(rng.standard_normal((5, K)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((K, width)) / np.sqrt(K),
                        dtype=torch.float32)
    if kind == "f32":
        wk = w
    elif kind == "bf16":
        wk = w.to(torch.bfloat16)
    else:
        wk = K1.split_hilo(w)
    w_t = wk.transpose(-1, -2).contiguous()
    whole = _partitioned_product(x, w_t, kind, hc, 1)
    for blocks in BLOCKS:
        assert torch.equal(_partitioned_product(x, w_t, kind, hc, blocks),
                           whole)
    want = K1.layer_product(x, wk, kind)
    xa = x.abs() if kind == "f32" else x.to(torch.bfloat16).float().abs()
    wa = wk.float().abs() if kind != "split" else wk[0].float().abs()
    bound = 2 * K * 2.0 ** -24 * (xa.double() @ wa.double())
    assert bool(((whole.double() - want.double()).abs() <= bound).all())
    # and both near the float64 product of the same operands
    ref = K1.layer_product(x.double(), wk, kind, torch.float64)
    assert float((whole.double() - ref).abs().max()) < 1e-5
