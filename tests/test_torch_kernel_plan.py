"""Launch plans of the cluster kernels of ``gru_chain`` and of the
weight-gradient GEMM that both recurrence backwards run, computed on
the CPU from the shapes: each fits 227 KB of shared memory, fills the
card at the music step's B=256, and a plan too wide raises. Every shape
of the range the kernels take plans (H a multiple of 32 up to 512, tick
GRUs of 1 to 4 layers), and the music step's H=128 plans are the ones
the kernels have run since the resident layouts were designed. The tick
loop's forward where no cluster holds its weights (the wave layout)
plans one cooperative wave of at most 132 CTAs whose row groups cover
every row and whose unit groups cover every unit, its shared memory
mirroring the kernel's layout term for term. The GRU
chain's wide layout (H=384 and 512) plans one cooperative wave of CTAs
that covers every row at each shape the card runs it at: the wide cases
of ``torch_card_cases``, the tick loop's backward chains, the analysis
batches and a data-parallel rank's rows. The AR regulariser's forward plan (a cluster
a dim) covers every row in whole passes and runs in one wave of the
clusters the card holds at once."""

import numpy as np
import pytest

import torch_card_cases as cases
from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops.gru_kernel import ChainPlan
from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.ops import reg_kernel as rk

HS = (64, 128, 256)
VS = (34, 130)
B, T, E = 256, 24, 10
# (M, N, K, D) of the weight-gradient GEMMs at HS x VS that fewer than 100
# CTAs run even at their least split (``gru_kernel.ATB_MIN_TERMS`` terms):
# (name, T, D, B, M, N), T·B terms
FEW_CTA_GEMMS = {(m, n, t * b, d) for _, t, d, b, m, n in (
    ("beat dW_hh H=64", 4, 1, 256, 64, 192), ("beat dW_hh H=128", 4, 1, 256, 128, 384),
    ("demb V=34", 6, 1, 1024, 34, 10), ("dout_w H=64 V=34", 6, 1, 1024, 64, 34),
    ("dout_w H=128 V=34", 6, 1, 1024, 128, 34))}


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("h", HS)
def test_plans_fit_and_fill_the_card(h, v):
    for d in (2, 1):  # the encoder's biGRU layers and the beat GRU
        for backward in (False, True):
            plan = gk.gru_plan(d, B, h, backward)
            assert plan.smem_bytes <= gk.MAX_SMEM
            assert plan.smem_bytes == 4 * gk.chain_smem_floats(backward, h, plan.clusters,
                                                              plan.rows)
            assert h % plan.clusters == 0 and plan.rows % gk.ROWS_PER_THREAD == 0
            assert plan.clusters > 1 and plan.rows * h // plan.clusters <= gk.THREADS
            assert plan.ctas >= 100, (d, backward, plan)
            assert plan.grid == (plan.clusters * -(-B // plan.rows), d)
    # the GEMMs: gru_chain's dW_hh at both layer shapes, the tick loop's six;
    # each fills the card (100 CTAs) but the named few whose least split
    # (ATB_MIN_TERMS terms) still leaves fewer: they take that split
    gemms = [(h, 3 * h, T * B, 2), (h, 3 * h, 4 * B, 1)]
    gemms += [(m, n, T * B, 1) for m, _, n in hk.gemm_shapes(h, E, v)]
    for m, n, k, d in gemms:
        splits = gk.atb_splits(m, n, k, d)
        assert 1 <= splits <= -(-k // gk.TC_DEPTH)
        bm, bn = gk.TC_TILES[gk.atb_tile(m, n)]
        tiles = d * -(-m // bm) * -(-n // bn)
        if (m, n, k, d) in FEW_CTA_GEMMS:
            assert tiles * splits < 100 and gk.atb_chunk(k, splits) == gk.ATB_MIN_TERMS
            assert splits == k // gk.ATB_MIN_TERMS, (m, n, k, d)
        else:
            assert tiles * splits >= 100, (m, n, k, d)


def test_music_step_plan_is_one_wave_of_one_cta_an_sm():
    for backward in (False, True):
        enc, beat = gk.gru_plan(2, B, 128, backward), gk.gru_plan(1, B, 128, backward)
        assert (enc.clusters, enc.rows, enc.ctas) == (2, 8, 128)
        assert (beat.clusters, beat.rows, beat.ctas) == (2, 4, 128)
        # the w_hh slice, 128 x 196 floats, is most of it; more than half
        # an SM's 228 KB keeps a second CTA off the SM
        for plan in (enc, beat):
            assert 114 * 1024 < plan.smem_bytes <= gk.MAX_SMEM


def test_ragged_batch_covers_every_row():
    plan = gk.gru_plan(2, 100, 128, True)
    assert plan.grid[0] // plan.clusters * plan.rows >= 100


@pytest.mark.parametrize("backward", [False, True])
def test_too_wide_raises_naming_h(backward):
    with pytest.raises(ValueError, match="H=2048"):
        gk.gru_plan(2, B, 2048, backward)


# The tick loop's forward: clusters whose CTAs hold their weight slices


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("h", HS[:2])
def test_hier_plan_fits(h, v):
    plan = hk.hier_plan(B, h, E, v)
    assert plan.smem_bytes <= gk.MAX_SMEM == 227 * 1024
    assert plan.smem_bytes == 4 * hk.fwd_smem_floats(h, E, v, plan.clusters, plan.rows)
    assert h % plan.clusters == 0 and plan.rows % gk.ROWS_PER_THREAD == 0
    assert plan.rows * h // plan.clusters <= gk.THREADS


@pytest.mark.parametrize("v", VS)
def test_hier_plan_is_one_wave_at_the_music_step(v):
    plan = hk.hier_plan(B, 128, E, v)
    assert plan.clusters > 1 and 100 <= plan.ctas <= gk.SMS
    assert plan.grid[0] // plan.clusters <= hk.RESIDENT_CLUSTERS[plan.clusters]
    # one CTA an SM: more than half an SM's shared memory keeps a second off
    assert plan.smem_bytes > 114 * 1024
    # the backward's chains: a beat's 6 ticks on 4 x 256 rows
    chain = hk.chain_plan(T, B, 128, 6)
    assert chain.grid[0] // chain.clusters * chain.rows >= 4 * B


def test_hier_plan_ragged_batch_covers_every_row():
    plan = hk.hier_plan(100, 128, E, 130)
    assert plan.grid[0] // plan.clusters * plan.rows >= 100
    assert (plan.grid[0] // plan.clusters - 1) * plan.rows < 100  # no idle cluster


@pytest.mark.parametrize("h", [256, 2048])
def test_hier_plan_too_wide_raises_naming_h_and_v(h):
    if h == 256:
        # the three H x 3H matrices alone take 2.4 MB, more than the 1.8 MB
        # of shared memory of a cluster of 8 CTAs: the wave layout, 16
        # units a CTA (150 KB of slices) on 16 unit groups x 8 row groups
        plan = hk.hier_plan(B, h, E, 130)
        assert isinstance(plan, hk.WavePlan) and plan.smem_bytes <= gk.MAX_SMEM
        assert plan.smem_bytes == 4 * hk.wave_smem_floats(h, E, 130, 2, plan.units, plan.rows,
                                                          plan.pass_rows)
        assert (plan.units, plan.rows, plan.ctas) == (16, 32, 128)
        return
    # a 4-row tile of 2048 / 8 units a CTA takes 1024 threads, and 4
    # units a CTA of the three matrices take 394 KB
    with pytest.raises(ValueError, match=f"H={h}, V=130"):
        hk.hier_plan(B, h, E, 130)


# The range the kernels take: no shape in it raises on the card

RANGE_H = tuple(range(32, 513, 32))
RANGE_B = (1, 100, 256, 1024)


def _check_wide_plan(plan, backward, h, rows, d):
    """One cooperative wave of CTAs of 256 threads (at most 512), one CTA
    an SM, whose row groups cover every row and whose slices cover every
    unit, each within 227 KB."""
    assert isinstance(plan, gk.WidePlan) and plan.units in gk.WIDE_UNITS
    assert plan.smem_bytes == 4 * gk.wide_smem_floats(backward, h, plan.units) <= gk.MAX_SMEM
    assert gk.WIDE_THREADS <= gk.THREADS
    # more than half an SM's shared memory: one CTA an SM, every CTA on the card at once
    assert plan.smem_bytes > gk.SM_SMEM // 2 - gk.CTA_RESERVED
    row_groups = -(-rows // plan.rows)
    assert plan.ctas == d * -(-h // plan.units) * row_groups <= gk.SMS
    assert row_groups * plan.rows >= rows and (row_groups - 1) * plan.rows < rows
    assert plan.passes * plan.pass_rows >= plan.rows


def _check_chain_plan(plan, backward, h, rows, d):
    if isinstance(plan, gk.WidePlan):
        _check_wide_plan(plan, backward, h, rows, d)
        return
    assert plan.smem_bytes <= gk.MAX_SMEM
    assert plan.smem_bytes == 4 * gk.chain_smem_floats(backward, h, plan.clusters, plan.rows)
    assert h % plan.clusters == 0 and plan.rows % gk.ROWS_PER_THREAD == 0
    assert plan.rows * h // plan.clusters <= gk.THREADS
    assert plan.grid == (plan.clusters * -(-rows // plan.rows), d)


def _check_wave_plan(plan, b, h, e, v, layers):
    """One cooperative wave of at most SMS CTAs of 256 threads (one an SM
    at most: every CTA on the card at once), whose row groups cover every
    row with no idle group and whose unit groups cover every unit, within
    227 KB of shared memory, the layout mirrored term for term."""
    assert isinstance(plan, hk.WavePlan) and plan.units in hk.WAVE_UNITS
    assert plan.smem_bytes == 4 * hk.wave_smem_floats(h, e, v, layers, plan.units, plan.rows,
                                                      plan.pass_rows) <= gk.MAX_SMEM
    groups, row_groups = h // plan.units, -(-b // plan.rows)
    assert groups * plan.units == h  # the unit slices cover every unit, once
    assert plan.ctas == groups * row_groups <= gk.SMS
    assert row_groups * plan.rows >= b and (row_groups - 1) * plan.rows < b
    # a pass holds whole m-tiles, at most 8 warp items, and a row group
    # needs at most one partial pass
    assert plan.pass_rows in hk.WAVE_PASS_ROWS
    assert plan.pass_rows // 16 * plan.unit_tiles <= gk.WIDE_THREADS // 32
    assert plan.passes * plan.pass_rows >= plan.rows
    assert plan.pass_rows <= max(16, -(-plan.rows // 16) * 16)
    # the head: whole n-tiles of 8 columns, on at most every unit group
    vc, nh = hk.wave_head(h, v, plan.units)
    assert vc % 8 == 0 and nh <= groups and nh * vc >= v > (nh - 1) * vc


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("h", RANGE_H)
def test_every_shape_in_the_range_plans(h, layers):
    for b in RANGE_B:
        for v in VS:
            for e in (10, 32):
                plan = hk.hier_plan(b, h, e, v, layers)
                if isinstance(plan, hk.WavePlan):
                    _check_wave_plan(plan, b, h, e, v, layers)
                else:
                    assert plan.smem_bytes <= gk.MAX_SMEM
                    assert plan.smem_bytes == 4 * hk.fwd_smem_floats(
                        h, e, v, plan.clusters, plan.rows, layers)
                    assert h % plan.clusters == 0 and plan.rows % gk.ROWS_PER_THREAD == 0
                    assert plan.rows * h // plan.clusters <= gk.THREADS
                    assert plan.grid == (plan.clusters * -(-b // plan.rows), 1)
                for t in (4, 24):
                    for tpb in (5, 6, 24):
                        fwd, bwd = hk.hier_plans(t, b, h, e, v, layers, tpb)
                        assert fwd == plan
                        _check_chain_plan(bwd, True, h, -(-t // tpb) * b, 1)
        if layers == 1:  # gru_chain has no depth: once a width
            for d in (1, 2):
                for backward in (False, True):
                    _check_chain_plan(gk.gru_plan(d, b, h, backward), backward, h, b, d)


def test_music_step_plans_are_unchanged():
    # the H=128 plans of the music step (B=256) and of the ragged B=100,
    # field for field, as the resident layouts chose them before the
    # streamed and wave layouts existed
    def plan(c, rb, smem, grid):
        return ChainPlan(c, rb, smem, grid)

    assert hk.hier_plan(B, 128, E, 130) == plan(8, 20, 170928, (104, 1))
    assert hk.hier_plan(B, 128, E, 34) == plan(8, 20, 159584, (104, 1))
    assert hk.hier_plan(100, 128, E, 130) == plan(8, 8, 132384, (104, 1))
    assert hk.hier_plan(100, 128, E, 34) == plan(8, 8, 124016, (104, 1))
    assert hk.chain_plan(T, B, 128, 6) == plan(2, 8, 148224, (256, 1))
    assert hk.chain_plan(T, B, 128, 24) == plan(2, 4, 132864, (128, 1))
    assert hk.chain_plan(T, B, 128, 5) == plan(2, 8, 148224, (320, 1))
    want = {(1, False): plan(2, 4, 124672, (128, 1)), (1, True): plan(2, 4, 132864, (128, 1)),
            (2, False): plan(2, 8, 131840, (64, 2)), (2, True): plan(2, 8, 148224, (64, 2))}
    for (d, backward), p in want.items():
        assert gk.gru_plan(d, B, 128, backward) == p
    assert gk.gru_plan(2, 100, 128, True) == plan(8, 16, 83136, (56, 2))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d,h", [(2, 384), (2, 512), (1, 384), (1, 512), (2, 416), (1, 544)])
def test_wide_gru_chain_streams_its_weights(d, h, backward):
    # the reference's own widths: no cluster of 8 CTAs holds the w_hh
    # slices beside a tile (253 KB forward at H=384, C=8, 4 rows), so the
    # wide layout spreads w_hh over one wave of CTAs, each holding its
    # units' slice for the whole call and streaming only the step's
    # operand rows, in chunks of WIDE_DEPTH terms
    assert 4 * gk.chain_smem_floats(False, h, 8, 4) > gk.MAX_SMEM
    plan = gk.gru_plan(d, B, h, backward)
    _check_wide_plan(plan, backward, h, B, d)
    assert plan.passes == 1
    # the slice: 3U gate columns of H terms, or U rows of 3H, padded to whole chunks
    padded = -(-(3 * h if backward else h) // gk.WIDE_DEPTH) * gk.WIDE_DEPTH + 4
    slice_floats = plan.units * padded * (1 if backward else 3)
    assert 4 * slice_floats <= plan.smem_bytes


def test_hier_plan_streams_only_where_nothing_resident_fits():
    # the wave layout where no cluster holds the slices, the resident
    # cluster layout everywhere else
    for h, layers in ((128, 1), (128, 2), (128, 3), (256, 1)):
        assert isinstance(hk.hier_plan(B, h, E, 130, layers), ChainPlan)
    for h, layers in ((128, 4), (256, 2), (384, 2), (512, 2), (512, 4)):
        assert isinstance(hk.hier_plan(B, h, E, 130, layers), hk.WavePlan)


# The tick loop's forward where no cluster holds the weights: the wave
# layout, one cooperative wave of CTAs each holding its units' slices

def test_wave_plan_at_the_512_wide_step():
    # (B, H, V, L) = (256, 512, 130, 2): 8 units a CTA (16 would take 295
    # KB of slices), 64 unit groups x 2 row groups of 128 rows in one pass,
    # no depth split; 17 head CTAs of 8 columns a row group
    for v in VS:
        plan = hk.hier_plan(B, 512, E, v, 2)
        assert plan == hk.WavePlan(8, 128, 128, 225728, 128)
        assert (plan.unit_tiles, plan.splits, plan.passes) == (1, 1, 1)
    assert hk.wave_head(512, 130, 8) == (8, 17)
    assert hk.wave_head(512, 34, 8) == (8, 5)
    assert 4 * hk.wave_smem_floats(512, E, 130, 2, 16, 128, 64) > gk.MAX_SMEM


def test_wave_smem_mirrors_the_layout_term_for_term():
    # wave_layout in csrc/hier_tick_chain.cu at the 512-wide step, region
    # by region (floats): w_ih0e's 24 columns of E = 10 padded to a chunk
    # of 32 (+4), three 512-deep matrices of 24 columns (+4), out_w's 8
    # columns, 3 bias slices of 24, out_b's 8, three chunk buffers of 128
    # rows x 36, the head's two per-row partials of 128 rows x 1 n-tile,
    # 128 tokens
    regions = [24 * 36, 3 * 24 * 516, 8 * 516, 3 * 24, 8, 3 * 128 * 36, 128, 128, 128]
    assert hk.wave_smem_floats(512, 10, 130, 2, 8, 128, 128) == sum(regions) == 56432
    # a depth split whose partial sums outgrow the chunk buffers: one
    # 16-row pass of 2 unit tiles (U = 16), 4 splits an item, 2 items
    assert hk.wave_splits(16, 16) == 4
    floats = hk.wave_smem_floats(256, 10, 130, 2, 16, 16, 16)
    slices = 48 * 36 + 3 * 48 * 260 + 16 * 260 + 3 * 48 + 16
    assert floats == slices + 3 * 2 * 12 * 32 + 2 * 32 + 16
    assert 3 * 2 * 12 * 32 > 3 * 16 * 36


@pytest.mark.parametrize("b", RANGE_B + (6, 22, 120))
@pytest.mark.parametrize("h,layers,vs", [(512, 2, VS), (384, 2, VS), (256, 2, VS),
                                         (128, 4, (130,)), (512, 4, VS)])
def test_wave_plan_is_one_wave_that_covers_every_row_and_unit(h, layers, vs, b):
    # (H=128 at 4 layers and V=34 fits a cluster of 8 CTAs: resident)
    for v in vs:
        plan = hk.hier_plan(b, h, E, v, layers)
        _check_wave_plan(plan, b, h, E, v, layers)
        # as many row groups as fit: another would leave a group fewer
        # than 16 rows or the card more CTAs than SMs
        groups = h // plan.units
        assert plan.rows <= 16 or (plan.ctas // groups + 1) * groups > gk.SMS


def test_wave_plan_prefers_the_most_ctas_then_the_most_units():
    # H=256, L=2: 16, 8 and 4 units all give 128 CTAs; the most units win
    assert hk.hier_plan(B, 256, E, 130, 2).units == 16
    # one row: the most unit groups (4 units, 128 CTAs) make each CTA's
    # share of the chain the shortest
    assert hk.hier_plan(1, 512, E, 34, 2) == hk.WavePlan(4, 1, 16, 99776, 128)
    # a data-parallel rank's 128 rows at the 512-wide step: 2 row groups
    # of 64 in one pass, the depth split over 2 warps
    plan = hk.hier_plan(128, 512, E, 130, 2)
    assert (plan.units, plan.rows, plan.pass_rows, plan.splits) == (8, 64, 64, 2)


@pytest.mark.parametrize("layers", [0, 5])
def test_hier_plans_refuse_a_depth_outside_the_range(layers):
    with pytest.raises(ValueError, match=f"H=128, L={layers}"):
        hk.hier_plans(T, B, 128, E, 130, layers, 6)


# The AR regulariser's forward: a cluster of C CTAs a regularised dim

# the dSprites and music steps, the card cases' ragged and large
# batches, the most dims a call takes, and batches smaller than a cluster
REG_SHAPES = [(5, 128), (4, 256), (5, 100), (3, 700), (2, 8192), (32, 128), (16, 128),
              (1, 1), (3, 5), (1, 40_000)]


@pytest.mark.parametrize("r,b", REG_SHAPES)
def test_reg_plan_covers_every_row_in_whole_passes(r, b):
    plan = rk.reg_plan(r, b)
    c, rows, s, t = plan.clusters, plan.rows, plan.slices, plan.threads
    assert plan.grid == (c, r) and plan.ctas == c * r
    assert c in (1, 2, 4, 8) and c * rows >= b and (c - 1) * rows < b  # no idle CTA
    assert t & (t - 1) == 0 and 32 <= t <= rk.MAX_THREADS
    assert s & (s - 1) == 0 and s <= b and t % s == 0  # a pass of t items holds whole rows
    assert rows * s <= t or s == 1
    assert plan.waves == 1


def test_reg_plan_at_the_step_shapes_keeps_every_thread_on_pairs():
    # dSprites (R=5, B=128) and music (R=4, B=256): clusters of 8, one
    # wave of the 15 the card holds, every thread a (row, slice) item
    for (r, b), want in (((5, 128), (8, 16, 16, 256)), ((4, 256), (8, 32, 8, 256))):
        plan = rk.reg_plan(r, b)
        assert (plan.clusters, plan.rows, plan.slices, plan.threads) == want
        assert plan.rows * plan.slices == plan.threads
        assert r <= hk.RESIDENT_CLUSTERS[plan.clusters]


def test_reg_plan_counts_waves_against_resident_clusters():
    # 16 or 32 clusters of 8 need 2 or 3 waves of the 15 the card holds:
    # smaller clusters keep them to one wave
    assert rk.reg_plan(15, 128).clusters == 8
    assert rk.reg_plan(16, 128).clusters == 4
    plan = rk.reg_plan(32, 128)
    assert (plan.clusters, plan.ctas, plan.waves) == (2, 64, 1)


@pytest.mark.parametrize("r,b", [(0, 128), (rk.MAX_DIMS + 1, 128), (5, 0)])
def test_reg_plan_refuses_what_the_kernel_does_not_take(r, b):
    with pytest.raises(ValueError, match=f"R={r}, B={b}"):
        rk.reg_plan(r, b)


# The wide layout at every shape the card runs it at: torch_card_cases'
# wide cases, the tick loop's backward chains (n_beats x B rows, one direction)
# of its wide and deep shapes, the analysis batches and a data-parallel
# rank's B/W rows, both directions

WIDE_CASES = sorted(
    {(d, b, h) for _, d, b, h in cases.WIDE_GRU_CASES}
    | {(1, -(-cases.HIER_T // tpb) * b, h)
       for h, _ in cases.WIDE_DEEP_HIER for tpb in (6, 24, 5) for b in (256, 128, 64)}
    | {(d, b, 512) for d in (1, 2) for b in (1, 6, 10, 22, 120)}
    | {(d, 256 // w, h) for d in (1, 2) for w in (2, 4) for h in (384, 512)})


@pytest.mark.parametrize("d,b,h", WIDE_CASES)
def test_wide_plans_are_one_wave_that_covers_every_row(d, b, h):
    for backward in (False, True):
        plan = gk.gru_plan(d, b, h, backward)
        _check_chain_plan(plan, backward, h, b, d)
        assert isinstance(plan, gk.WidePlan) == (h >= 384)


def test_the_tick_loops_wide_chain_is_one_wave_of_128_ctas():
    # 4 beats x 256 rows of 6 ticks at H=512: 16 unit groups x 8 row groups
    plan = hk.chain_plan(24, 256, 512, 6)
    assert plan == gk.gru_plan(1, 1024, 512, True)
    assert (plan.units, plan.rows, plan.ctas, plan.passes) == (32, 128, 128, 2)


@pytest.mark.parametrize("d,h", [(2, 1024), (1, 2048), (2, 4096)])
def test_a_width_no_wide_plan_fits_raises_naming_h(d, h):
    for backward in (False, True):
        with pytest.raises(ValueError, match=f"H={h}"):
            gk.gru_plan(d, B, h, backward)


@pytest.mark.parametrize("t,d,b,h", cases.WIDE_GRU_CASES)
def test_the_wide_weight_gradient_sums_at_most_1024_terms_a_split(t, d, b, h):
    k = t * b
    splits = gk.atb_splits(h, 3 * h, k, d)
    # each split's terms: gemm_chunk in csrc/tc_gemm.cuh, whole 32-term K tiles
    chunk = -(-(-(-k // splits)) // gk.TC_DEPTH) * gk.TC_DEPTH
    assert gk.ATB_MAX_TERMS == 1024
    assert chunk <= max(gk.ATB_MAX_TERMS, gk.TC_DEPTH)
    assert splits <= -(-k // gk.TC_DEPTH)


# ---------------------------------------------------------------------------
# The backwards' tensor-core engine (csrc/tc_gemm.cuh): the Python mirrors of
# its tiles, splits and shared memory, and of the tick loop's scratch and kept gh
# ---------------------------------------------------------------------------


def _engine_gemms(h):
    """(M, N, K, D) of every weight-gradient GEMM of a train step at width h:
    gru_chain's dW_hh (encoder, beat GRU), the tick loop's 2L + 2."""
    return ([(h, 3 * h, T * B, 2), (h, 3 * h, 4 * B, 1)]
            + [(m, n, T * B, 1) for m, _, n in hk.gemm_shapes(h, E, 130)])


@pytest.mark.parametrize("h", (64, 128, 256, 384, 512))
def test_the_weight_gradient_splits_cover_the_terms_in_order(h):
    for m, n, k, d in _engine_gemms(h):
        splits = gk.atb_splits(m, n, k, d)
        chunk = gk.atb_chunk(k, splits)
        assert chunk % gk.TC_DEPTH == 0 and 1 <= splits <= -(-k // gk.TC_DEPTH)
        bounds = [(i * chunk, min((i + 1) * chunk, k)) for i in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(lo < hi for lo, hi in bounds), (m, n, k, d, splits)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert chunk <= gk.ATB_MAX_TERMS


def test_the_engines_tiles_by_shape():
    assert gk.atb_tile(512, 1536) == gk.atb_tile(512, 130) == "big"
    assert gk.atb_tile(10, 1536) == "narrow_m"  # dW_ih0e at E = 10
    assert gk.atb_tile(130, 10) == gk.atb_tile(6144, 10) == "narrow_n"  # demb, dpe
    # the 512-wide encoder's dW_hh: 4 x 12 tiles of both directions, in 8
    # splits of 768 terms: 768 CTAs, a whole number of the card's waves near
    assert gk.atb_splits(512, 1536, 24 * 256, 2) == 8


def test_the_row_products_tiles_by_shape():
    rows = 6 * 4 * 256  # the tick loop's chain rows at B=256
    assert gk.row_tile(rows, 10) == "narrow_n"  # dpe
    # H=512: 48 x 12 and 48 x 4 tiles of 128 x 128 fill the card's 132 SMs
    assert gk.row_tile(rows, 1536) == gk.row_tile(rows, 512) == "big"
    # H=128: 48 tiles of 128 x 128 would leave SMs idle
    assert gk.row_tile(rows, 128) == gk.row_tile(rows, 130) == "mid"
    assert gk.TC_TILES["mid"] == (64, 64)


@pytest.mark.parametrize("form", list(gk.TC_FORMS))
@pytest.mark.parametrize("tile", list(gk.TC_TILES))
def test_the_engines_shared_memory_fits_227_kb(form, tile):
    smem = gk.tc_smem_bytes(form, tile)
    assert 0 < smem <= gk.MAX_SMEM
    bm, bn = gk.TC_TILES[tile]
    # three stages of an A and a B tile: term-major (32 x (width + 8)) or
    # row-major (width x 36) floats
    a_term, b_term = gk.TC_FORMS[form]
    a = 32 * (bm + 8) if a_term else bm * 36
    b = 32 * (bn + 8) if b_term else bn * 36
    assert smem == 4 * 3 * (a + b)


def test_the_big_tiles_leading_dimensions_keep_fragment_loads_conflict_free():
    # lane (g, t) of a warp reads row t, column g of a term-major tile and
    # row g, term t of a row-major one: 32 distinct banks
    for width in (16, 128):
        ld = width + 8
        assert len({(t * ld + g) % 32 for g in range(8) for t in range(4)}) == 32
    assert len({(g * 36 + t) % 32 for g in range(8) for t in range(4)}) == 32


@pytest.mark.parametrize("h,layers,keeps", [(512, 2, True), (384, 2, True), (512, 1, True),
                                            (256, 2, False), (128, 4, False), (128, 2, False)])
def test_the_forward_keeps_gh_where_the_wide_chains_read_it(h, layers, keeps):
    assert hk.keeps_gh(T, B, h, E, 130, layers, 6) is keeps
    if keeps:  # the wave forward, wide chains
        assert isinstance(hk.hier_plan(B, h, E, 130, layers), hk.WavePlan)
        assert isinstance(hk.chain_plan(T, B, h, 6), gk.WidePlan)
    # the chains' layout: 6 ticks on 4 beats x 256 rows; a padded last beat
    assert hk.gh_shape(T, B, h, layers, 6) == (layers, 6, 4 * B, 3 * h)
    assert hk.gh_shape(T, B, h, layers, 5) == (layers, 5, 5 * B, 3 * h)
    # 37.7 MB a layer at B=256, H=512
    if h == 512:
        assert 4 * np.prod(hk.gh_shape(T, B, h, 1, 6)) == 24 * 256 * 1536 * 4


def test_the_tick_loops_backward_scratch_mirror():
    # R = 6 x 4 x 256 chain rows, one region each, rounded to 16 bytes
    R, bc, h, v = 6 * 4 * B, 4 * B, 512, 130
    want = (R + R * E + R * v + 2 * 2 * bc * h + R * h + 3 * R * h + R * h + 2 * 3 * R * h
            + R * E + 4)
    assert hk.bwd_scratch_floats(T, B, h, E, v, 6, 2) == want
    # no gh region: the wide chains read the forward's
    assert hk.bwd_scratch_floats(T, B, h, E, v, 6, 2) - hk.bwd_scratch_floats(
        T, B, h, E, v, 6, 1) == 2 * bc * h


@pytest.mark.parametrize("h", [252, 360])
def test_a_forward_that_keeps_gh_runs_wide_where_only_the_backward_is_wide(h):
    # a cluster holds the forward's slices of w_hh but not the backward's:
    # the forward that keeps gh for the wide backward runs wide too
    for d, b in ((2, 256), (1, 1), (2, 119)):
        assert isinstance(gk.gru_plan(d, b, h, False), ChainPlan)
        assert isinstance(gk.gru_plan(d, b, h, True), gk.WidePlan)
        assert gk.fwd_plan(d, b, h) == gk.gru_plan(d, b, h, False)
        assert gk.fwd_plan(d, b, h, keep_gh=True) == gk.wide_plan(d, b, h, False)


def test_a_forward_that_keeps_gh_plans_as_before_across_the_range():
    for h in range(32, 513, 32):
        for d in (1, 2):
            for b in (1, 120, 256, 1024):
                assert gk.fwd_plan(d, b, h, keep_gh=True) == gk.gru_plan(d, b, h, False)


@pytest.mark.parametrize("h", [384, 512])
def test_the_wide_backward_holds_only_its_own_rows_of_w_hh(h):
    # U rows of 3H terms, padded to whole 32-term chunks plus 4, then three
    # chunk buffers of a pass's rows: no room for the forward's slice
    for u in gk.WIDE_UNITS:
        stages = 3 * gk.wide_pass_rows(u) * (32 + 4)
        assert gk.wide_smem_floats(True, h, u) == u * (-(-3 * h // 32) * 32 + 4) + stages
        assert gk.wide_smem_floats(False, h, u) == 3 * u * (-(-h // 32) * 32 + 4) + stages
