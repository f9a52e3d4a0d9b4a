"""Work each kernel function must do, counted from its shapes, and the
least time an H100 could take for it.

The port's counterpart of ``analytic_matmul_flops`` in
``scripts/bench_measure_vae.py``. For each kernel function: the
floating-point operations its algorithm needs, the bytes it must move
(each input read once, each output written once, float32 and int32 both
4 bytes), and the bound: the larger of operations over the card's fp32
peak and bytes over its memory rate. The port runs float32 with TF32
off, so the fp32 rate of the CUDA cores is the peak that applies.

Counts:
- ``gru_chain`` forward: ``2·T·D·B·H·3H`` (the hidden product of every
  step); the backward three times that (the gate recompute, ``dgh·w_hhᵀ``
  and ``dW_hh``).
- ``hier_tick_chain`` forward, per row and step, for a tick GRU of L
  layers: ``2·E·3H + (2L−1)·2·H·3H + 2·H·V`` (the fed embedding's
  product, the 2L−1 H×3H products, the head); the backward three times
  that (recompute, transposed products, weight gradients).
- ``fused_reg_loss`` forward: ``R·B²`` pair terms, each counted as its
  elementwise operations with ``tanh`` as one: 8 for the loss, 7 more
  for the gradient factors G and D when a gradient is wanted. The
  backward scales the factors by the cotangent: ``R·B`` products and
  ``2R`` for ddelta.
"""

from __future__ import annotations

from dataclasses import dataclass

# H100 SXM, published, at the 700 W power limit: fp32 on the CUDA cores
# and HBM3.
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
WORD = 4  # bytes of a float32 or an int32

# z_i − z_j, ×δ, tanh, a_i − a_j, sign, −, |·|, +
REG_FWD_OPS_PER_PAIR = 8
# sign(t − s), t², 1 − t², ×, + (G), ×(z_i − z_j), + (D)
REG_FACTOR_OPS_PER_PAIR = 7


@dataclass(frozen=True)
class Work:
    flop: int
    bytes: int

    @property
    def flop_ms(self) -> float:
        return 1e3 * self.flop / PEAK_FP32_FLOP_PER_S

    @property
    def bytes_ms(self) -> float:
        return 1e3 * self.bytes / PEAK_BYTES_PER_S

    @property
    def bound_ms(self) -> float:
        return max(self.flop_ms, self.bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.flop_ms >= self.bytes_ms else "bytes"


def gru_chain(T: int, D: int, B: int, H: int, backward: bool = False) -> Work:
    """gi (T,D,B,3H), w_hh (D,H,3H), b_hh (D,3H), h0 (D,B,H) -> outs
    (T,D,B,H); the backward also reads outs and douts and writes dgi,
    dh0, dw_hh and db_hh."""
    flop = 2 * T * D * B * H * 3 * H
    gi, w, b, h0, outs = T * D * B * 3 * H, D * H * 3 * H, D * 3 * H, D * B * H, T * D * B * H
    if not backward:
        return Work(flop, WORD * (gi + w + b + h0 + outs))
    # in: gi, w_hh, b_hh, h0, outs, douts; out: dgi, dw_hh, db_hh, dh0
    return Work(3 * flop, WORD * (2 * (gi + w + b + h0) + 2 * outs))


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
    return Work(3 * flop, WORD * (1 + tb + L * tb * H + tb * V + 2 * floats))


def reg_loss(R: int, B: int, backward: bool = False, factors: bool = True,
             Z: int | None = None) -> Work:
    """Forward: the z and a columns (R, B) and delta (1,) -> the (R,)
    losses and, with ``factors``, G (R, B) and D (R,). Backward: G, D and
    the (R,) cotangent -> the whole (B, Z) gradient of the latents (Z = R
    for stacked columns) and ddelta (1,)."""
    if not backward:
        ops = REG_FWD_OPS_PER_PAIR + (REG_FACTOR_OPS_PER_PAIR if factors else 0)
        out = R + (R * B + R if factors else 0)
        return Work(ops * R * B * B, WORD * (2 * R * B + 1 + out))
    Z = R if Z is None else Z
    return Work(R * B + 2 * R, WORD * (R * B + 2 * R + B * Z + 1))
