"""Operations and bytes of the port's recurrence kernels, from their shapes.

Copied from the port's ``utils/kernel_work.py`` (its forward counts and
its bytes: each input read once, each output written once, float32 and
int32 both 4 bytes), with one change: a backward counts twice its
forward's operations, the products it needs (the transposed products
and the weight gradients), where ``kernel_work`` counts three times,
the gate recompute included. The forward of the wide and wave layouts
keeps the gates for the backward, so no recompute is needed work.

- ``gru_chain`` forward: ``2·T·D·B·H·3H`` (the hidden product of every step);
- ``hier_tick_chain`` forward, per row and step, for a tick GRU of L
  layers: ``2·E·3H + (2L−1)·2·H·3H + 2·H·V`` (the fed embedding's
  product, the 2L−1 H×3H products, the head).
"""

from __future__ import annotations

from dataclasses import dataclass

WORD = 4
BACKWARD_PRODUCTS = 2


@dataclass(frozen=True)
class Work:
    flop: int
    bytes: int

    def least_seconds(self, peaks: dict) -> float:
        """Operations at the peak FLOP rate or bytes at the peak
        bandwidth, the larger."""
        return max(self.flop / peaks["tf32_flop_per_s"], self.bytes / peaks["bytes_per_s"])


def gru_chain(T: int, D: int, B: int, H: int, backward: bool = False) -> Work:
    """gi (T,D,B,3H), w_hh (D,H,3H), b_hh (D,3H), h0 (D,B,H) -> outs
    (T,D,B,H); the backward also reads outs and douts and writes dgi,
    dh0, dw_hh and db_hh."""
    flop = 2 * T * D * B * H * 3 * H
    gi, w, b, h0, outs = T * D * B * 3 * H, D * H * 3 * H, D * 3 * H, D * B * H, T * D * B * H
    if not backward:
        return Work(flop, WORD * (gi + w + b + h0 + outs))
    return Work(BACKWARD_PRODUCTS * flop, WORD * (2 * (gi + w + b + h0) + 2 * outs))


def hier_flop_per_row_step(H: int, E: int, V: int, L: int = 2) -> int:
    return 2 * E * 3 * H + (2 * L - 1) * 2 * H * 3 * H + 2 * H * V


def _hier_float_operands(T: int, B: int, H: int, E: int, V: int, tpb: int, L: int) -> int:
    nb = -(-T // tpb)
    return (nb * B * 3 * H + nb * L * B * H + B * E + V * E + E * 3 * H
            + (2 * L - 1) * (H * 3 * H + 3 * H) + H * V + V)


def hier_tick_chain(T: int, B: int, H: int, E: int, V: int, ticks_per_beat: int,
                    backward: bool = False, L: int = 2) -> Work:
    """The 9 + 4(L−1) float operands, teacher and seed (1,) and score
    (T,B) -> weights (T,B,V), samples (T,B) and the L layers' hiddens
    (T,B,H); the backward reads seed, samples, the hiddens, dweights and
    the float operands and writes their gradients."""
    flop = T * B * hier_flop_per_row_step(H, E, V, L)
    floats = _hier_float_operands(T, B, H, E, V, ticks_per_beat, L)
    tb = T * B
    if not backward:
        return Work(flop, WORD * (2 + tb + floats + tb * V + tb + L * tb * H))
    return Work(BACKWARD_PRODUCTS * flop, WORD * (1 + tb + L * tb * H + tb * V + 2 * floats))
