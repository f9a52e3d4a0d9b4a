"""The work counter of ``arvae_tpu_torch/utils/kernel_work.py``: FLOP,
bytes and bounds at the music step's shapes, how the counts scale with
T, B, H, V and the tick GRU's depth L, and the counts at the reference's
own width (H=512)."""

import pytest

from arvae_tpu_torch.utils import kernel_work as kw

# the music step: encoder layer (T, D, B, H), beat layer, tick loop
ENC, BEAT = (24, 2, 256, 128), (4, 1, 256, 128)
HIER = dict(T=24, B=256, H=128, E=10, V=130, ticks_per_beat=6)


def _hier(backward=False, **over):
    return kw.hier_tick_chain(**{**HIER, **over}, backward=backward)


CASES = {
    "gru_fwd_flop": (lambda: kw.gru_chain(*ENC).flop, 1_207_959_552),
    "gru_fwd_flop_beat": (lambda: kw.gru_chain(*BEAT).flop, 100_663_296),
    "gru_bwd_is_3x_fwd": (lambda: kw.gru_chain(*ENC, backward=True).flop,
                          3 * 1_207_959_552),
    "gru_flop_linear_in_T": (lambda: kw.gru_chain(48, 2, 256, 128).flop,
                             2 * 1_207_959_552),
    "gru_flop_linear_in_B": (lambda: kw.gru_chain(24, 2, 100, 128).flop,
                             1_207_959_552 * 100 // 256),
    "gru_flop_quadratic_in_H": (lambda: kw.gru_chain(24, 2, 256, 64).flop,
                                1_207_959_552 // 4),
    "hier_flop_per_row_step": (lambda: kw.hier_flop_per_row_step(128, 10, 130), 335_872),
    "hier_fwd_flop": (lambda: _hier().flop, 335_872 * 24 * 256),
    "hier_bwd_is_3x_fwd": (lambda: _hier(backward=True).flop, 3 * 335_872 * 24 * 256),
    "hier_flop_in_V": (lambda: _hier(V=34).flop - _hier().flop, 2 * 128 * (34 - 130) * 24 * 256),
    "hier_flop_in_H": (lambda: kw.hier_flop_per_row_step(64, 10, 130),
                       2 * 10 * 192 + 6 * 64 * 192 + 2 * 64 * 130),
    "hier_flop_in_T_and_B": (lambda: _hier(T=12, B=100).flop, 335_872 * 12 * 100),
    # a tick GRU of L layers: 2L - 1 H x 3H products a row and step
    "hier_flop_per_row_step_L3": (lambda: kw.hier_flop_per_row_step(128, 10, 130, 3),
                                  2 * 10 * 384 + 5 * 2 * 128 * 384 + 2 * 128 * 130),
    "hier_flop_L1_has_one_product": (lambda: kw.hier_flop_per_row_step(128, 10, 130, 1),
                                     2 * 10 * 384 + 2 * 128 * 384 + 2 * 128 * 130),
    "hier_fwd_bytes_in_L": (lambda: _hier(L=3).bytes - _hier().bytes,
                            4 * (4 * 256 * 128 + 2 * (128 * 384 + 384) + 24 * 256 * 128)),
    "hier_bwd_is_3x_fwd_L3": (lambda: _hier(backward=True, L=3).flop, 3 * _hier(L=3).flop),
    # the reference's own width: H=512 for the encoder, beat and tick GRUs
    "gru_fwd_flop_h512": (lambda: kw.gru_chain(24, 2, 256, 512).flop,
                          2 * 24 * 2 * 256 * 512 * 1536),
    "gru_fwd_bytes_h512": (lambda: kw.gru_chain(24, 2, 256, 512).bytes,
                           4 * (24 * 2 * 256 * 1536 + 2 * 512 * 1536 + 2 * 1536
                                + 2 * 256 * 512 + 24 * 2 * 256 * 512)),
    "hier_fwd_flop_h512": (lambda: _hier(H=512).flop,
                           24 * 256 * (2 * 10 * 1536 + 3 * 2 * 512 * 1536 + 2 * 512 * 130)),
    "hier_fwd_flop_h512_L3": (lambda: _hier(H=512, L=3).flop,
                              24 * 256 * (2 * 10 * 1536 + 5 * 2 * 512 * 1536 + 2 * 512 * 130)),
    # the backwards' weight-gradient GEMM: 2·D·M·N·K, A and X read once, the
    # output (and the bias) written once; the row product 2·M·K·N
    "atb_flop_encoder_h512": (lambda: kw.atb(512, 1536, 6144, 2, True).flop,
                              2 * 2 * 512 * 1536 * 6144),
    "atb_bytes_encoder_h512": (lambda: kw.atb(512, 1536, 6144, 2, True).bytes,
                               4 * 2 * (6144 * 512 + 6144 * 1536 + 512 * 1536 + 1536)),
    # the embedding's gradient: A the one-hot of 6144 int32 tokens, a
    # scatter-add of N = 10 floats for each token that lands
    "atb_flop_demb": (lambda: kw.atb(130, 10, 6144, tokens=6144).flop, 10 * 6144),
    "atb_flop_demb_tokens_that_land": (lambda: kw.atb(130, 10, 6144, tokens=5500).flop,
                                       10 * 5500),
    "atb_bytes_demb": (lambda: kw.atb(130, 10, 6144, tokens=5500).bytes,
                       4 * (6144 + 6144 * 10 + 130 * 10)),
    "atb_bytes_no_bias": (lambda: kw.atb(10, 1536, 6144).bytes,
                          4 * (6144 * 10 + 6144 * 1536 + 10 * 1536)),
    "row_product_flop": (lambda: kw.row_product(6144, 1536, 512).flop, 2 * 6144 * 1536 * 512),
    "row_product_bytes": (lambda: kw.row_product(6144, 10, 1536).bytes,
                          4 * (6144 * 10 + 10 * 1536 + 6144 * 1536)),
    "reg_pairs": (lambda: kw.reg_loss(4, 256, factors=False).flop,
                  kw.REG_FWD_OPS_PER_PAIR * 4 * 256 ** 2),
    "reg_fwd_with_factors": (lambda: kw.reg_loss(4, 256).flop,
                             (kw.REG_FWD_OPS_PER_PAIR + kw.REG_FACTOR_OPS_PER_PAIR)
                             * 4 * 256 ** 2),
    "reg_factors_written": (lambda: kw.reg_loss(5, 128).bytes
                            - kw.reg_loss(5, 128, factors=False).bytes, 4 * (5 * 128 + 5)),
    "reg_bwd_is_a_scale": (lambda: kw.reg_loss(4, 256, backward=True).flop, 4 * 256 + 8),
    "reg_bwd_writes_the_whole_gradient": (
        lambda: kw.reg_loss(5, 128, backward=True, Z=10).bytes,
        4 * (5 * 128 + 10 + 128 * 10 + 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_counts(name):
    fn, want = CASES[name]
    assert fn() == want


# (work, bound ms, MB moved) from the music step's table, to the digits it gives
BOUNDS = {
    "gru_fwd": (lambda: kw.gru_chain(*ENC), 0.018, 25.8),
    "gru_bwd": (lambda: kw.gru_chain(*ENC, backward=True), 0.054, 51.0),
    "gru_bwd_beat": (lambda: kw.gru_chain(*BEAT, backward=True), 0.0045, None),
    "hier_fwd": (lambda: _hier(), 0.031, 13.0),
    "hier_bwd": (lambda: _hier(backward=True), 0.092, 16.0),
}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_bounds_match_the_table(name):
    fn, bound_ms, mb = BOUNDS[name]
    work = fn()
    assert work.bound_by == "operations"
    assert work.bound_ms == pytest.approx(bound_ms, rel=0.05)
    if mb is not None:
        assert work.bytes / 1e6 == pytest.approx(mb, rel=0.05)


def test_reg_forward_is_bound_by_operations_and_backward_by_bytes():
    for r, b in ((4, 256), (5, 128)):
        assert kw.reg_loss(r, b).bound_by == "operations"
        assert kw.reg_loss(r, b, factors=False).bound_by == "operations"
        assert kw.reg_loss(r, b, backward=True, Z=32).bound_by == "bytes"


def test_reg_is_a_few_kilobytes_and_under_a_microsecond():
    for r, b in ((4, 256), (5, 128)):
        for backward in (False, True):
            work = kw.reg_loss(r, b, backward)
            assert work.bytes < 16_384
            assert work.bound_ms < 1e-3


@pytest.mark.parametrize("shape", [(24, 2, 256, 512), (4, 1, 256, 512), (24, 1, 256, 384),
                                   (6, 1, 1024, 512)])
def test_the_wide_layouts_tf32x3_bound_is_three_tf32_products_an_operation(shape):
    # the GRU chain's wide layout multiplies in 3xTF32: its bound at the
    # TF32 rate is three TF32 operations for each fp32 one, below the fp32
    # bound by 495 / (3 x 67) and never below the bytes' time
    for backward in (False, True):
        w = kw.gru_chain(*shape, backward=backward)
        tf32_ms = 1e3 * 3 * w.flop / 495e12
        assert w.tf32x3_bound_ms == pytest.approx(max(tf32_ms, w.bytes_ms), rel=1e-12)
        assert w.bytes_ms <= w.tf32x3_bound_ms < w.bound_ms


def test_the_512_wide_steps_weight_gradients_are_bound_by_operations():
    # the encoder's two biGRU layers, the beat GRU's two, the tick loop's
    # six: about 72 GFLOP a step, 1.07 ms at the fp32 rate, 0.43 in 3xTF32
    gemms = ([kw.atb(512, 1536, 6144, 2, True)] * 2 + [kw.atb(512, 1536, 1024, 1, True)] * 2
             + [kw.atb(512, 1536, 6144, 1, True)] * 3
             + [kw.atb(10, 1536, 6144), kw.atb(130, 10, 6144, tokens=6144),
                kw.atb(512, 130, 6144, 1, True)])
    assert sum(w.flop for w in gemms) / 1e9 == pytest.approx(71.7, rel=0.01)
    flop = sum(w.flop for w in gemms)
    assert 1e3 * flop / kw.PEAK_FP32_FLOP_PER_S == pytest.approx(1.07, rel=0.01)
    assert 1e3 * 3 * flop / kw.PEAK_TF32_FLOP_PER_S == pytest.approx(0.43, rel=0.02)
    # the bounds add the tiny GEMMs' bytes
    assert sum(w.bound_ms for w in gemms) == pytest.approx(1.08, rel=0.01)
    assert sum(w.tf32x3_bound_ms for w in gemms) == pytest.approx(0.447, rel=0.01)
    assert kw.atb(512, 1536, 6144, 2, True).bound_by == "operations"
    # the tiny ones move more bytes than they compute; the embedding's
    # gradient reads its tokens, not a dense 6144 x 130 one-hot
    demb = kw.atb(130, 10, 6144, tokens=6144)
    assert demb.bound_by == "bytes" and demb.bytes < kw.atb(130, 10, 6144).bytes / 12
    assert demb.tf32x3_bound_ms == demb.bound_ms == demb.bytes_ms
