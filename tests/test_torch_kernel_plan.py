"""Launch plans of the cluster kernels of ``gru_chain`` and of the
weight-gradient GEMM that both recurrence backwards run, computed on
the CPU from the shapes: each fits 227 KB of shared memory, fills the
card at the music step's B=256, and a plan too wide raises. Every shape
of the range the kernels take plans (H a multiple of 32 up to 512, tick
GRUs of 1 to 4 layers), and the music step's H=128 plans are the ones
the kernels have run since the resident layouts were designed. The AR
regulariser's forward plan (a cluster a dim) covers every row in whole
passes and runs in one wave of the clusters the card holds at once."""

import pytest

from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops.gru_kernel import ChainPlan
from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.ops import reg_kernel as rk

HS = (64, 128, 256)
VS = (34, 130)
B, T, E = 256, 24, 10


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
    # the GEMMs: gru_chain's dW_hh at both layer shapes, the tick loop's six
    gemms = [(h, True, 3 * h, T * B, 2), (h, True, 3 * h, 4 * B, 1)]
    gemms += [(m, bias, n, T * B, 1) for m, bias, n in hk.gemm_shapes(h, E, v)]
    for m, bias, n, k, d in gemms:
        splits = gk.atb_splits(m, bias, n, k, d)
        assert 1 <= splits <= -(-k // gk.GEMM_DEPTH)
        tiles = d * -(-(m + bias) // gk.GEMM_TILE) * -(-n // gk.GEMM_TILE)
        assert tiles * splits >= 100, (m, bias, n, k, d)


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
        # of shared memory of a cluster of 8 CTAs: the streamed layout
        plan = hk.hier_plan(B, h, E, 130)
        assert plan.streamed and plan.smem_bytes <= gk.MAX_SMEM
        assert plan.smem_bytes == 4 * hk.fwd_smem_floats(h, E, 130, plan.clusters, plan.rows,
                                                         2, True)
        return
    # a 4-row tile of 2048 / 8 units a CTA takes 1024 threads
    with pytest.raises(ValueError, match=f"H={h}, V=130"):
        hk.hier_plan(B, h, E, 130)


# The range the kernels take: no shape in it raises on the card

RANGE_H = tuple(range(32, 513, 32))
RANGE_B = (1, 100, 256, 1024)


def _check_chain_plan(plan, backward, h, rows, d):
    assert plan.smem_bytes <= gk.MAX_SMEM
    assert plan.smem_bytes == 4 * gk.chain_smem_floats(backward, h, plan.clusters, plan.rows,
                                                      plan.streamed)
    assert h % plan.clusters == 0 and plan.rows % gk.ROWS_PER_THREAD == 0
    assert plan.rows * h // plan.clusters <= gk.THREADS
    assert plan.grid == (plan.clusters * -(-rows // plan.rows), d)


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("h", RANGE_H)
def test_every_shape_in_the_range_plans(h, layers):
    for b in RANGE_B:
        for v in VS:
            for e in (10, 32):
                plan = hk.hier_plan(b, h, e, v, layers)
                assert plan.smem_bytes <= gk.MAX_SMEM
                assert plan.smem_bytes == 4 * hk.fwd_smem_floats(
                    h, e, v, plan.clusters, plan.rows, layers, plan.streamed)
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
    # streamed layouts existed
    def plan(c, rb, smem, grid):
        return ChainPlan(c, rb, smem, grid, False)

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


@pytest.mark.parametrize("d,h", [(2, 384), (2, 512), (1, 384), (1, 512)])
def test_wide_gru_chain_streams_its_weights(d, h):
    # the reference's own widths: no cluster of 8 CTAs holds the w_hh
    # slices beside a tile (253 KB forward at H=384, C=8, 4 rows), so
    # each step reads them from L2 in stages of STREAM_DEPTH rows
    assert 4 * gk.chain_smem_floats(False, h, 8, 4) > gk.MAX_SMEM
    for backward in (False, True):
        plan = gk.gru_plan(d, B, h, backward)
        assert plan.streamed
        _check_chain_plan(plan, backward, h, B, d)
        kernel = "gru_bwd" if backward else "gru_fwd"
        held = gk.CLUSTERS_HELD[gk.ctas_per_sm(plan.smem_bytes, gk.STREAMED_REGISTERS[kernel])]
        assert gk.plan_waves(plan, kernel) == -(-(plan.ctas // plan.clusters)
                                                 // held[plan.clusters])


def test_hier_plan_streams_only_where_nothing_resident_fits():
    for h, layers in ((128, 1), (128, 2), (128, 3), (256, 1)):
        assert not hk.hier_plan(B, h, E, 130, layers).streamed
    for h, layers in ((128, 4), (256, 2), (384, 2), (512, 2), (512, 4)):
        assert hk.hier_plan(B, h, E, 130, layers).streamed


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
