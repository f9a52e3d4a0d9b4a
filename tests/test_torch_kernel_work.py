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
