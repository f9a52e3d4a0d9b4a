"""The hierarchical decoder's tick loop: hand-written CUDA kernel pair +
plain version.

Replaces the Pallas TPU kernel
``arvae_tpu/ops/hier_decoder_pallas.py::hier_tick_chain``: T sequential
steps of [L-layer tick GRU with per-beat hidden resets → ReLU head →
argmax or Gumbel-max → teacher select → re-embed the fed token], as one
launch forward and one (plus its fixed-order weight-gradient GEMMs)
backward. The JAX kernel runs 2 layers (other depths run on
``lax.scan`` there); these run 1 to ``MAX_LAYERS``.

On a CUDA tensor, :func:`tick_chain` launches the kernels of
``csrc/hier_tick_chain.cu`` or raises: :func:`hier_plans` gives the
forward plan (:func:`hier_plan`: clusters holding the weight slices
where they fit, else one cooperative wave of CTAs) and the backward chain
plan (:func:`chain_plan`), and raises ``ValueError``, naming H and L,
before any launch for a depth outside [1, ``MAX_LAYERS``] or a width no
plan fits. On a CPU tensor it runs :func:`tick_chain_reference`, a
Python loop over T for any number of tick-GRU layers whose backward is
autograd through the loop. There is no fallback from one to the other.

Random bits: neither the TPU's in-kernel PRNG nor ``jax.random`` can be
reproduced here, so both versions draw from one counter-based hash of
``(seed, t, salt, row, col)`` (salt 0 for dropout, 3571 for the Gumbel
noise), written once in CUDA and once below with integer tensor ops:
dropout masks of the kernel and of the plain version are bitwise equal.
``seed`` is an int32 device tensor, drawn per step by the trainer. The
row is the global batch row: a call given ``row_base`` hashes its row b
as ``row_base + b``, so a rank of a data-parallel step that holds rows
``row_base..`` of the global batch draws what one card draws for them.
Both draw the mask of the gap after layer l with salt l.

What bounds it on the card: a 24-step chain of dependent small products
with an argmax and a gather between steps, so latency. Where a cluster
holds the weights (H=128 at up to 3 layers) the forward runs on
thread-block clusters: a cluster owns a tile of batch rows for the whole
measure, each CTA keeping its slice of every weight in shared memory and
exchanging hiddens and per-row argmax partials with its peers through
distributed shared memory. Elsewhere (the reference's H=512, H=256 and
384, 4 layers) it runs the wave layout: one cooperative wave of CTAs,
each holding its units' slices of every weight for the whole call,
multiplying all of its rows on the tensor cores in 3xTF32, exchanging
hiddens and argmax partials through L2 with L + 1 barriers a tick
(:func:`hier_plan` picks the layout and its shape). The backward runs the beats in parallel: the hidden
carries restart at every beat, so each layer is ``n_beats`` independent
chains of ``ticks_per_beat`` ticks, run by ``gru_chain``'s backward
(its cluster kernel, or its wide layout at H=384 and 512, which reads the
chains' hidden-side gates ``gh`` that the wave forward kept for a caller
that trains), and every product that touches no carry runs over all T·B
rows at once on the 3xTF32 tensor-core engine of ``csrc/tc_gemm.cuh``,
as do the weight gradients (:func:`hier_tick_chain_bwd_by_beats` is the
same decomposition in plain PyTorch). The saved hiddens (and ``gh``) use
the chains' layout ``(ticks_per_beat, n_beats·B, H)``. See the source's
header for the design.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.ops.gru import stacked_gru_step_from_gi
from arvae_tpu_torch.ops.gru_kernel import (CLUSTERS_HELD, GEMM_LAUNCHES, MAX_SMEM,
                                            ROWS_PER_THREAD, SMS, THREADS, WIDE_DEPTH,
                                            WIDE_MIN_ROWS, WIDE_STAGES, WIDE_THREADS, ChainPlan,
                                            WidePlan, atb_scratch_floats, atb_splits, best_plan,
                                            gru_gates, gru_plan, records_grad, slice_ld, up4)
from arvae_tpu_torch.utils import profiling

_NAME = "hier_tick_chain"
SALT_DROPOUT = 0
SALT_GUMBEL = 3571
SAMPLING = ("argmax", "multinomial")

# Kernel launches by the wrapper, one per call of each direction; of the
# forward's, those of the wave layout.
LAUNCHES = {"fwd": 0, "bwd": 0}
WAVE_LAUNCHES = {"fwd": 0}
# Launches of gru_chain's backward by the backward: one a layer; of them,
# those of its wide layout.
CHAIN_LAUNCHES = {"bwd": 0, "wide": 0}

# Tick-GRU layers the kernels take (kMaxLayers in the source).
MAX_LAYERS = 4


def reset_launches() -> None:
    for counts in (LAUNCHES, WAVE_LAUNCHES, CHAIN_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Random bits (the same function as csrc/hier_tick_chain.cu)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 tensors holding uint32 values, split in
    16-bit halves so that no product leaves int64's range."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform01(seed: torch.Tensor, t: int, salt: int, rows: int,
              cols: int, row_base: int = 0) -> torch.Tensor:
    """(rows, cols) float32 uniforms in (0, 1) for step t and the
    global rows ``row_base..``: the top 24 bits of the hash, kept away
    from 0 and 1 as ``hier_decoder_pallas._uniform01`` does."""
    dev = seed.device
    h = seed.reshape(1).long() & _M32
    h = _mix32(_mix32(_mix32(h) ^ t) ^ salt)
    r = torch.arange(row_base, row_base + rows, device=dev, dtype=torch.int64)[:, None]
    c = torch.arange(cols, device=dev, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(h[:, None] ^ r) ^ c)
    u = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u * (1.0 - 2.0 / 16777216.0) + 1.0 / 16777216.0


def dropout_mask(seed: torch.Tensor, t: int, rows: int, cols: int,
                 rate: float, salt: int = SALT_DROPOUT, row_base: int = 0) -> torch.Tensor:
    """Keep-and-scale mask of step t: 1/(1-rate) where kept, else 0."""
    keep = 1.0 - rate
    return (uniform01(seed, t, salt, rows, cols, row_base) < keep).float() * (1.0 / keep)


def gumbel(seed: torch.Tensor, t: int, rows: int, cols: int,
           row_base: int = 0) -> torch.Tensor:
    return -torch.log(-torch.log(uniform01(seed, t, SALT_GUMBEL, rows, cols, row_base)))


def argmax_lowest(scores: torch.Tensor) -> torch.Tensor:
    """Row argmax, lowest index on ties, as max + iota-min: a row holding
    a NaN gives V (the caller clamps it to V-1), as the kernels do."""
    v = scores.shape[-1]
    m = scores.amax(dim=-1, keepdim=True)
    iota = torch.arange(v, device=scores.device)
    return torch.where(scores == m, iota, v).amin(dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the golden model on the card)
# ---------------------------------------------------------------------------


def tick_chain_reference(
    train: bool, dropout_rate: float, ticks_per_beat: int, sampling: str,
    teacher: torch.Tensor, seed: torch.Tensor, score: torch.Tensor,
    gi_beat, tick_h0, x0, emb, w_ih0e, layers: Sequence[Dict[str, torch.Tensor]],
    out_w, out_b, hiddens: bool = False, row_base: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The tick loop in Python, for an L-layer tick GRU. score (T, B)
    int; tick_h0 (n_beats, L, B, H); ``layers`` the L layers' parameters
    in the (I, 3H) layout (layer 0's ``w_hh``, ``b_hh``: its input
    projection comes as ``w_ih0e`` and ``gi_beat``; the others' ``w_ih``,
    ``b_ih``, ``w_hh``, ``b_hh``); ``row_base`` the global batch row of
    row 0, for the random bits. Returns (weights (T, B, V) relu
    logits, samples (T, B) int32 fed tokens), and with ``hiddens`` every
    layer's hiddens in the chain layout the kernel saves
    (:func:`to_chain`)."""
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
    T, B = score.shape
    H = layers[0]["w_hh"].shape[0]
    V = emb.shape[0]
    use_teacher = teacher.reshape(()) != 0
    dropout = train and dropout_rate > 0.0
    h = tick_h0[0]
    prev_emb = x0
    weights: List[torch.Tensor] = []
    samples: List[torch.Tensor] = []
    states: List[torch.Tensor] = []
    for t in range(T):
        beat = t // ticks_per_beat
        if t % ticks_per_beat == 0:
            h = tick_h0[beat]
        gi0 = prev_emb @ w_ih0e + gi_beat[beat]
        masks = [dropout_mask(seed, t, B, H, dropout_rate, SALT_DROPOUT + gap, row_base)
                 for gap in range(len(layers) - 1)] if dropout else None
        top, h = stacked_gru_step_from_gi(layers, gi0, h, masks)
        states.append(h)
        logits = torch.relu(top @ out_w + out_b)
        scores = (logits + gumbel(seed, t, B, V, row_base) if sampling == "multinomial"
                  else logits)
        sampled = argmax_lowest(scores.detach())
        tok = torch.where(use_teacher, score[t].long(), sampled).clamp(0, V - 1)
        weights.append(logits)
        samples.append(tok.to(torch.int32))
        prev_emb = F.embedding(tok, emb)
    if hiddens:
        hs = torch.stack(states)  # (T, L, B, H)
        return (torch.stack(weights), torch.stack(samples),
                *(to_chain(hs[:, i], ticks_per_beat) for i in range(len(layers))))
    return torch.stack(weights), torch.stack(samples)



def float_operands(L: int) -> Tuple[str, ...]:
    """Names of the 9 + 4(L-1) float operands of an L-layer tick loop, in
    the kernels' order (the order their backward returns the gradients
    in): layer 0's ``w_hh``, ``b_hh`` (its input projection comes as
    ``w_ih0e`` and ``gi_beat``), then each further layer's ``w_ih``,
    ``b_ih``, ``w_hh``, ``b_hh``."""
    layers = ["w_hh0", "b_hh0"]
    for l in range(1, L):
        layers += [f"w_ih{l}", f"b_ih{l}", f"w_hh{l}", f"b_hh{l}"]
    return ("gi_beat", "tick_h0", "x0", "emb", "w_ih0e", *layers, "out_w", "out_b")


# The 13 float operands of the 2-layer loop, in the JAX signature's order.
FLOAT_OPERANDS = float_operands(2)


def layers_of(floats: Sequence) -> int:
    """L from the count of float operands; ValueError outside [1, MAX_LAYERS]."""
    n = len(floats)
    if n < 9 or (n - 9) % 4 or not 1 <= (n - 9) // 4 + 1 <= MAX_LAYERS:
        raise ValueError(f"{n} float operands: the tick loop takes 9 + 4(L-1) for "
                         f"L in [1, {MAX_LAYERS}]")
    return (n - 9) // 4 + 1


def chain_operands(floats: Sequence[torch.Tensor]) -> Tuple:
    """The float operands in the kernels' order (:func:`float_operands`)
    → the operands :func:`tick_chain` and :func:`tick_chain_reference`
    take after ``score``: (gi_beat, tick_h0, x0, emb, w_ih0e, layers,
    out_w, out_b)."""
    L = layers_of(floats)
    gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0 = floats[:7]
    layers = [{"w_hh": w_hh0, "b_hh": b_hh0}]
    for l in range(1, L):
        w_ih, b_ih, w_hh, b_hh = floats[7 + 4 * (l - 1):11 + 4 * (l - 1)]
        layers.append({"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh})
    return (gi_beat, tick_h0, x0, emb, w_ih0e, layers, *floats[-2:])


def flat_operands(gi_beat, tick_h0, x0, emb, w_ih0e, layers: Sequence[Dict[str, torch.Tensor]],
                  out_w, out_b) -> Tuple[torch.Tensor, ...]:
    """:func:`chain_operands` inverted: the flat float operands."""
    flat = [gi_beat, tick_h0, x0, emb, w_ih0e, layers[0]["w_hh"], layers[0]["b_hh"]]
    for p in layers[1:]:
        flat += [p["w_ih"], p["b_ih"], p["w_hh"], p["b_hh"]]
    return (*flat, out_w, out_b)


def to_chain(x: torch.Tensor, ticks_per_beat: int) -> torch.Tensor:
    """(T, B, W) time-major → the chains' layout (ticks_per_beat,
    n_beats·B, W): row beat·B + b of slab k is tick beat·ticks_per_beat + k;
    the padded ticks of a short last beat are zero rows."""
    T, B, W = x.shape
    nb = -(-T // ticks_per_beat)
    x = torch.cat([x, x.new_zeros(nb * ticks_per_beat - T, B, W)])
    return x.reshape(nb, ticks_per_beat, B, W).transpose(0, 1).reshape(ticks_per_beat, nb * B, W)


def _chain_bwd_plain(gi, w_hh, b_hh, h0, outs, douts):
    """``gru_chain``'s backward over a (T, rows) chain with
    ``gru_chain_reference``'s gate math, written out: → (dgi, dgh, dh0)."""
    dh = torch.zeros_like(h0)
    H = h0.shape[-1]
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    for k in reversed(range(gi.shape[0])):
        hp = outs[k - 1] if k else h0
        gh = hp @ w_hh + b_hh
        r, z, n = gru_gates(gi[k], gh)
        dh = dh + douts[k]
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        dr = da_n * gh[:, 2 * H:] * r * (1.0 - r)
        dz = dh * (hp - n) * z * (1.0 - z)
        dgi[k] = torch.cat([dr, dz, da_n], -1)
        dgh[k] = torch.cat([dr, dz, da_n * r], -1)
        dh = dh * z + dgh[k] @ w_hh.T
    return dgi, dgh, dh


def hier_tick_chain_bwd_by_beats(train, dropout_rate, ticks_per_beat, seed, samples, hiddens,
                                 weights, dweights, *floats, row_base=0):
    """The kernel backward's decomposition in plain PyTorch: products
    over all rows at once, then each layer, from the top down, as n_beats
    independent chains of ``ticks_per_beat`` ticks. ``hiddens`` are the
    L layers' saved hiddens in the chain layout, ``weights`` the
    forward's relu logits (their sign is the ReLU's mask), ``floats`` the
    float operands (:func:`float_operands`), ``row_base`` the global
    batch row of row 0. → their gradients, in that order."""
    gi_beat, tick_h0, x0, emb, w_ih0e, layers, out_w, out_b = chain_operands(floats)
    L = len(layers)
    T, B = samples.shape
    H = hiddens[0].shape[-1]
    tpb = ticks_per_beat
    nb = -(-T // tpb)
    live = to_chain(torch.ones(T, B, 1, device=samples.device), tpb)  # 0 on padded ticks
    fed = torch.cat([x0[None], F.embedding(samples[:-1].long(), emb)])  # (T, B, E)
    pe = to_chain(fed, tpb)
    dropout = train and dropout_rate > 0.0
    masks = [to_chain(torch.stack([dropout_mask(seed, t, B, H, dropout_rate, SALT_DROPOUT + gap,
                                                row_base) for t in range(T)]), tpb) if dropout
             else torch.ones_like(hiddens[0]) for gap in range(L - 1)]
    inters = [None] + [hiddens[l - 1] * masks[l - 1] for l in range(1, L)]
    init = tick_h0.transpose(0, 1).reshape(L, nb * B, H)
    dlog = to_chain(dweights * (weights > 0), tpb)

    def atb(a, x):
        return torch.einsum("kri,krj->ij", a, x)

    def prev(all_, init_):
        return torch.cat([init_[None], all_[:-1]])

    dh = dlog @ out_w.T
    per_layer = [None] * L
    for l in reversed(range(L)):
        p = layers[l]
        if l:
            gi = (inters[l] @ p["w_ih"] + p["b_ih"]) * live
        else:
            gi = (pe @ w_ih0e + gi_beat.reshape(nb * B, -1)) * live
        dgi, dgh, dinit = _chain_bwd_plain(gi, p["w_hh"], p["b_hh"], init[l], hiddens[l], dh)
        grads = [atb(prev(hiddens[l], init[l]), dgh), dgh.sum((0, 1))]
        if l:
            dh = (dgi @ p["w_ih"].T) * masks[l - 1]
            grads = [atb(inters[l], dgi), dgi.sum((0, 1))] + grads
        per_layer[l] = (dgi, dinit, grads)
    dgi0 = per_layer[0][0]
    dpe = dgi0 @ w_ih0e.T
    onehot = F.one_hot(samples[:-1].long(), emb.shape[0]).float()
    fed_tok = to_chain(torch.cat([torch.zeros_like(onehot[:1]), onehot]), tpb)
    dtick_h0 = torch.stack([d for _, d, _ in per_layer]).reshape(L, nb, B, H).transpose(0, 1)
    return (dgi0.sum(0).reshape(nb, B, -1), dtick_h0.contiguous(), dpe[0, :B],
            atb(fed_tok, dpe), atb(pe, dgi0), *(g for _, _, gs in per_layer for g in gs),
            atb(hiddens[-1], dlog), dlog.sum((0, 1)))


# ---------------------------------------------------------------------------
# The forward's launch plan (a pure function of the shapes)
# ---------------------------------------------------------------------------


def fwd_smem_floats(H: int, E: int, V: int, C: int, RB: int, L: int = 2) -> int:
    """Floats of shared memory one CTA of the resident forward uses for a
    tick GRU of L layers: ``fwd_layout`` in ``csrc/hier_tick_chain.cu``,
    term for term."""
    hc, vc = H // C, -(-V // C)
    n3 = 3 * hc
    ldw, ldv, ldh, ldg, lde, ldl = (slice_ld(n3), slice_ld(vc), up4(H), up4(n3), up4(E),
                                    up4(vc))
    weights = E * ldw + (2 * L - 1) * H * ldw + H * ldv
    biases = (2 * L - 1) * ldg + ldl + up4(V * E)
    tile = (2 * L + min(L - 1, 2)) * RB * ldh + RB * lde + 2 * RB * ldg + RB * ldl
    half = up4(max(product_part_floats(RB, E, n3, THREADS // 2),
                   product_part_floats(RB, H, n3, THREADS // 2)))
    part = max(2 * half, up4(product_part_floats(RB, H, vc, THREADS)))
    return weights + biases + tile + part + 2 * up4(C * RB) + up4(RB)


def product_part_floats(rows: int, K: int, N: int, threads: int) -> int:
    """Floats of partial sums one depth-split product of ``gru_common.cuh``
    (``product_part_floats``) needs on ``threads`` threads."""
    items = rows // ROWS_PER_THREAD * -(-N // 2)
    s = 1
    while K % 4 == 0 and s < 8 and items * 2 * s <= threads and K % (8 * s) == 0:
        s *= 2
    return (s - 1) * items * 2 * ROWS_PER_THREAD


# Clusters of C CTAs, one CTA an SM, that an H100 SXM holds at once
# (``gru_kernel.CLUSTERS_HELD``): the resident layout's CTAs take more
# than half an SM's shared memory.
RESIDENT_CLUSTERS = CLUSTERS_HELD[1]

# The wave layout (``hier_wave_fwd``): CTAs of WIDE_THREADS threads (8
# warps), U units a CTA (unit tiles of 8 columns a gate; at U = 4 half a
# tile), passes of P rows; a gate product's warp items are (16-row m-tile,
# unit tile) pairs, at most 8, the depth split over at most
# WAVE_MAX_SPLITS warps an item where there are fewer.
WAVE_UNITS = (32, 16, 8, 4)
WAVE_PASS_ROWS = (128, 64, 32, 16)
WAVE_MAX_SPLITS = 4


@dataclass(frozen=True)
class WavePlan:
    """The wave layout's launch: CTA (g, q) owns hidden units
    [g U, (g + 1) U) of batch rows [q rows, (q + 1) rows), which it
    multiplies in passes of ``pass_rows``, and a share of those rows of
    one slice of the head's columns (:func:`wave_head`)."""
    units: int        # U
    rows: int         # rows of a row group
    pass_rows: int    # P
    smem_bytes: int   # dynamic shared memory of one CTA
    ctas: int         # H / U unit groups x ceil(B / rows) row groups, all on the card at once

    @property
    def unit_tiles(self) -> int:
        return max(1, self.units // 8)

    @property
    def splits(self) -> int:
        """KS: the warps an item's depth is split over."""
        return wave_splits(self.units, self.pass_rows)

    @property
    def passes(self) -> int:
        return -(-self.rows // self.pass_rows)


def wave_splits(U: int, P: int) -> int:
    return min(WAVE_MAX_SPLITS, (WIDE_THREADS // 32) // (P // 16 * max(1, U // 8)))


def wave_head(H: int, V: int, U: int) -> Tuple[int, int]:
    """(Vc, nh): the head's V in nh slices of Vc columns, whole n-tiles
    of 8, each on (H / U) // nh CTAs of a row group, a share of its rows
    each."""
    per_group = -(-V // (H // U))
    vc = -(-per_group // 8) * 8
    return vc, -(-V // vc)


def wave_smem_floats(H: int, E: int, V: int, L: int, U: int, R: int, P: int) -> int:
    """Floats of shared memory one CTA of the wave forward uses:
    ``wave_layout`` in ``csrc/hier_tick_chain.cu``, term for term: the
    slices of w_ih0e and of the 2L - 1 H x 3H matrices (3U columns each,
    the depth in whole chunks + 4), of out_w (Vc columns) and the biases,
    the chunk buffers (or the depth splits' partial sums), the head's
    partials by n-tile and the row group's tokens."""
    def ld(k):
        return -(-k // WIDE_DEPTH) * WIDE_DEPTH + 4

    items = P // 16 * max(1, U // 8)
    vc, _ = wave_head(H, V, U)
    slices = 3 * U * ld(E) + (2 * L - 1) * 3 * U * ld(H) + vc * ld(H)
    biases = (2 * L - 1) * up4(3 * U) + vc
    chunks = max(WIDE_STAGES * P * (WIDE_DEPTH + 4), (wave_splits(U, P) - 1) * items * 12 * 32)
    return slices + biases + chunks + 2 * up4(P * vc // 8) + up4(R)


def wave_plan(B: int, H: int, E: int, V: int, L: int) -> Optional[WavePlan]:
    """The wave layout's plan, or None where none fits: for each U in
    ``WAVE_UNITS`` that divides H, as many row groups (at least 16 rows
    each) as keep every CTA on the card at once (one CTA an SM:
    ``SMS``), and the largest pass of at most 128 / unit tiles rows, no
    more than the row group needs, that fits 227 KB; of those, the plan
    of the most CTAs, then the most units a CTA (the least hidden traffic:
    each unit group reads its row group's whole h), then the largest
    pass."""
    plans = []
    for u in WAVE_UNITS:
        groups = H // u
        if H % u or groups > SMS:
            continue
        row_groups = min(-(-B // WIDE_MIN_ROWS), SMS // groups)
        rows = -(-B // row_groups)
        need = -(-rows // 16) * 16
        for p in WAVE_PASS_ROWS:
            if p * max(1, u // 8) > 128 or (p > need and p > 16):
                continue
            smem = 4 * wave_smem_floats(H, E, V, L, u, rows, p)
            if smem <= MAX_SMEM:
                plan = WavePlan(u, rows, p, smem, groups * -(-B // rows))
                plans.append((plan, (-plan.ctas, -u, -p)))
                break
    return best_plan(plans)


def argmax_by_slices(scores: torch.Tensor, width: int) -> torch.Tensor:
    """``argmax_lowest`` as the wave layout's head takes it: each slice of
    ``width`` columns gives a partial (its max and the lowest index
    holding it; NaN anywhere: (NaN, V)), and the partials are combined in
    slice order by the kernel's ``argmax_combine``: NaN stays, a larger
    max or a NaN replaces, an equal max keeps the lower index."""
    v = scores.shape[-1]
    m = torch.full(scores.shape[:-1], float("-inf"), dtype=scores.dtype, device=scores.device)
    idx = torch.full(scores.shape[:-1], v, dtype=torch.long, device=scores.device)
    for v0 in range(0, v, width):
        part = scores[..., v0:v0 + width]
        pm = part.amax(dim=-1)
        iota = torch.arange(v0, v0 + part.shape[-1], device=scores.device)
        pi = torch.where(part == pm[..., None], iota, v).amin(dim=-1)
        pi = torch.where(torch.isnan(pm), v, pi)
        take = ~torch.isnan(m) & (torch.isnan(pm) | (pm > m))
        tie = ~torch.isnan(m) & (pm == m)
        idx = torch.where(take, pi, torch.where(tie, torch.minimum(idx, pi), idx))
        m = torch.where(take, pm, m)
    return idx


@functools.lru_cache(maxsize=256)
def hier_plan(B: int, H: int, E: int, V: int, L: int = 2):
    """The forward's plan for a tick GRU of L layers: the resident layout
    (a ``ChainPlan``) wherever it fits, else the wave layout (a
    ``WavePlan``, :func:`wave_plan`). Resident, by ``gru_plan``'s rule:
    the fewest waves of the card (clusters over the ones it holds at
    once), then the most CTAs, then the fewest CTAs a cluster (the fewest
    peers to exchange with), then the most rows a cluster; clusters of 2,
    4 or 8 CTAs, a single CTA only where no cluster fits. A resident CTA
    holds its H/C units' gate columns of the 2L - 1 GRU matrices and of
    w_ih0e, its ceil(V/C) columns of ``out_w`` and all of ``emb``. Raises
    ValueError, naming H, V and L, when no plan fits 227 KB."""
    plans = []
    for c in (2, 4, 8, 1):
        for rb in range(32, 0, -ROWS_PER_THREAD):
            if H % c or rb * (H // c) > THREADS:
                continue
            smem = 4 * fwd_smem_floats(H, E, V, c, rb, L)
            if smem > MAX_SMEM:
                continue
            plan = ChainPlan(c, rb, smem, (c * -(-B // rb), 1))
            waves = -(-(plan.grid[0] // c) // RESIDENT_CLUSTERS[c])
            plans.append((plan, (c == 1, waves, -plan.ctas, c, -rb)))
    best = best_plan(plans) or wave_plan(B, H, E, V, L)
    if best is None:
        raise ValueError(f"H={H}, V={V}, L={L} are too wide: neither a cluster of at most 8 "
                         f"CTAs nor a wave of CTAs of {WAVE_UNITS} units holds the weight "
                         "slices in 227 KB of shared memory")
    return best


def chain_plan(T: int, B: int, H: int, ticks_per_beat: int):
    """The backward's chain plan: ``gru_chain``'s backward over n_beats·B
    rows (a ``ChainPlan``, or a ``WidePlan`` where no cluster holds the
    slices)."""
    return gru_plan(1, -(-T // ticks_per_beat) * B, H, True)


def hier_plans(T: int, B: int, H: int, E: int, V: int, L: int, ticks_per_beat: int):
    """(forward plan, backward chain plan) of the tick loop's kernels at
    these shapes; raises ValueError, naming H and L, where the kernels do
    not run them: a tick GRU of other than 1 to ``MAX_LAYERS`` layers, or
    a width no plan fits."""
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"H={H}, L={L}: the tick-loop kernels run a tick GRU of 1 to "
                         f"{MAX_LAYERS} layers")
    return hier_plan(B, H, E, V, L), chain_plan(T, B, H, ticks_per_beat)


def keeps_gh(T: int, B: int, H: int, E: int, V: int, L: int, ticks_per_beat: int) -> bool:
    """Whether a forward that trains keeps the hidden-side pre-activations
    ``gh`` for its backward: where the forward runs the wave layout and the
    backward's chains the wide one (H=384, 512), which read them."""
    fwd, chain = hier_plans(T, B, H, E, V, L, ticks_per_beat)
    return isinstance(fwd, WavePlan) and isinstance(chain, WidePlan)


def gh_shape(T: int, B: int, H: int, L: int, ticks_per_beat: int) -> Tuple[int, ...]:
    """The kept ``gh``: the L layers' (ticks_per_beat, n_beats·B, 3H), the
    chains' layout, zeros on the padded ticks of a short last beat."""
    return (L, ticks_per_beat, -(-T // ticks_per_beat) * B, 3 * H)


def bwd_scratch_floats(T: int, B: int, H: int, E: int, V: int, ticks_per_beat: int,
                       L: int) -> int:
    """Floats of the backward's scratch before the GEMMs' partial sums:
    ``carve`` in ``csrc/hier_tick_chain.cu``, term for term (each region
    rounded up to 16 bytes): the fed tokens and embeddings, dlog, the
    chains' initial hiddens and their gradients, the layer's input, gates,
    incoming gradient, dgi, dgh, dpe, and the wide chains' barrier."""
    bc = -(-T // ticks_per_beat) * B
    R = ticks_per_beat * bc
    regions = [R, R * E, R * V, L * bc * H, L * bc * H, R * H, R * 3 * H, R * H, R * 3 * H,
               R * 3 * H, R * E, 1]
    return sum(up4(n) for n in regions)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.hier_tick_chain_smem_floats.argtypes = [i] * 6
        lib.hier_tick_chain_smem_floats.restype = i
        lib.hier_tick_chain_resident_clusters.argtypes = [i] * 2
        lib.hier_tick_chain_resident_clusters.restype = i
        lib.hier_tick_chain_wave_smem_floats.argtypes = [i] * 7
        lib.hier_tick_chain_wave_smem_floats.restype = i
        lib.hier_tick_chain_wave_resident_ctas.argtypes = [i] * 2
        lib.hier_tick_chain_wave_resident_ctas.restype = i
        lib.hier_tick_chain_wave_scratch_floats.argtypes = [i] * 6
        lib.hier_tick_chain_wave_scratch_floats.restype = ctypes.c_longlong
        lib.hier_tick_chain_bwd_scratch_floats.argtypes = [i] * 7
        lib.hier_tick_chain_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.hier_tick_chain_fwd.argtypes = ([p] * 8 + [pp] * 4 + [p] * 2 + [i] * 8 + [f, f]
                                            + [i] * 7 + [p, p, pp, pp, p, p])
        lib.hier_tick_chain_fwd.restype = i
        lib.hier_tick_chain_bwd.argtypes = ([p, p, pp] + [p] * 7 + [pp] * 4 + [p] * 2
                                            + [i] * 8 + [f, f] + [i] * 5 + [pp] + [p] * 5
                                            + [pp] * 4
                                            + [p] * 3 + [ctypes.POINTER(i), p])
        lib.hier_tick_chain_bwd.restype = i
        _bound = True
    return lib


def _dims(ticks_per_beat: int, score: torch.Tensor,
          floats: Sequence[torch.Tensor]) -> Tuple[int, int, int, int, int, int]:
    """(T, B, H, E, V, L) after checking every operand's shape."""
    if score.ndim != 2:
        raise ValueError(f"score must be (T, B), got {tuple(score.shape)}")
    T, B = score.shape
    L = layers_of(floats)
    x0, emb, w_hh0 = floats[2], floats[3], floats[5]
    H, E, V = w_hh0.shape[0], x0.shape[-1], emb.shape[0]
    if ticks_per_beat < 1:
        raise ValueError(f"ticks_per_beat must be >= 1, got {ticks_per_beat}")
    nb = -(-T // ticks_per_beat)
    gate, bias = (H, 3 * H), (3 * H,)
    want = [(nb, B, 3 * H), (nb, L, B, H), (B, E), (V, E), (E, 3 * H), gate, bias]
    want += [gate, bias, gate, bias] * (L - 1) + [(H, V), (V,)]
    for name, x, shape in zip(float_operands(L), floats, want):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return T, B, H, E, V, L


def _check_device(named, dev: torch.device, dtype: torch.dtype) -> None:
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")


def gemm_shapes(H: int, E: int, V: int, L: int = 2) -> Tuple[Tuple[int, bool, int], ...]:
    """(M, bias row, N) of the backward's 2L + 2 weight-gradient GEMMs,
    in the order the C entry runs them: w_ih_l (+ b_ih_l) and w_hh_l
    (+ b_hh_l) for l = L-1 .. 1, w_hh_0 (+ b_hh_0), w_ih0e, emb, out_w
    (+ out_b)."""
    layer = (H, True, 3 * H)
    return (layer,) * (2 * (L - 1)) + (layer, (E, False, 3 * H), (V, False, E), (H, True, V))


def _rate_args(train: bool, dropout_rate: float) -> Tuple[int, float, float]:
    if train and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        return 1, keep, 1.0 / keep
    return 0, 1.0, 1.0


def _pointers(xs: Sequence) -> ctypes.Array:
    """A host array of MAX_LAYERS device pointers (None: unused)."""
    ptrs = [None if x is None else x.data_ptr() for x in xs]
    return (ctypes.c_void_p * MAX_LAYERS)(*ptrs, *([None] * (MAX_LAYERS - len(ptrs))))


def _operand_args(floats: Sequence[torch.Tensor]) -> Tuple:
    """The float operands as the C entries take them: gi_beat .. w_ih0e,
    the layers' w_hh, b_hh, w_ih, b_ih as pointer arrays, out_w, out_b."""
    gi_beat, tick_h0, x0, emb, w_ih0e, layers, out_w, out_b = chain_operands(floats)
    arrays = [_pointers([p.get(k) for p in layers]) for k in ("w_hh", "b_hh", "w_ih", "b_ih")]
    return (*(x.data_ptr() for x in (gi_beat, tick_h0, x0, emb, w_ih0e)), *arrays,
            out_w.data_ptr(), out_b.data_ptr())


@profiling.spanned("op:hier_tick_chain.fwd")
def hier_tick_chain_fwd_cuda(train, dropout_rate, ticks_per_beat, sampling,
                             teacher, seed, score, *floats, plan=None, row_base=0,
                             keep_gh=False):
    """Launches the forward kernel → (weights, samples, *hiddens), the L
    layers' hiddens in the chain layout (ticks_per_beat, n_beats·B, H).
    ``floats``: the float operands (:func:`float_operands`); ``plan``: the
    launch plan, :func:`hier_plan`'s by default; ``row_base``: the global
    batch row of row 0, for the random bits. Returns (that tuple, gh): with
    ``keep_gh``, where the backward reads them (:func:`keeps_gh`), the
    hidden-side pre-activations (:func:`gh_shape`), else None."""
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
    T, B, H, E, V, L = _dims(ticks_per_beat, score, floats)
    dev = score.device
    _check_device((("teacher", teacher), ("seed", seed), ("score", score)), dev,
                  torch.int32)
    _check_device(zip(float_operands(L), floats), dev, torch.float32)
    if teacher.numel() != 1 or seed.numel() != 1:
        raise ValueError("teacher and seed must be (1,) int32")
    plan = plan or hier_plan(B, H, E, V, L)
    wave = isinstance(plan, WavePlan)
    lib = _library()
    nb = -(-T // ticks_per_beat)
    weights = torch.empty((T, B, V), dtype=torch.float32, device=dev)
    samples = torch.empty((T, B), dtype=torch.int32, device=dev)
    hiddens = [torch.empty((ticks_per_beat, nb * B, H), dtype=torch.float32, device=dev)
               for _ in range(L)]
    scratch = (torch.empty(lib.hier_tick_chain_wave_scratch_floats(B, H, V, L, plan.units,
                                                                     plan.rows),
                           dtype=torch.float32, device=dev) if wave else None)
    gh = None
    if keep_gh and wave and keeps_gh(T, B, H, E, V, L, ticks_per_beat):
        gh = torch.empty(gh_shape(T, B, H, L, ticks_per_beat), dtype=torch.float32, device=dev)
    layout = ((1, plan.units, plan.rows, plan.pass_rows) if wave
              else (0, plan.clusters, plan.rows, 0))
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_fwd(
            teacher.data_ptr(), seed.data_ptr(), score.data_ptr(), *_operand_args(floats),
            T, B, H, E, V, L, ticks_per_beat, dropout, keep, scale,
            int(sampling == "multinomial"), int(row_base), *layout, plan.smem_bytes,
            weights.data_ptr(), samples.data_ptr(), _pointers(hiddens),
            None if gh is None else _pointers(list(gh)),
            None if scratch is None else scratch.data_ptr(), _build.stream_of(score))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_fwd")
    LAUNCHES["fwd"] += 1
    WAVE_LAUNCHES["fwd"] += int(wave)
    return (weights, samples, *hiddens), gh


@profiling.spanned("op:hier_tick_chain.bwd")
def hier_tick_chain_bwd_cuda(train, dropout_rate, ticks_per_beat, seed, samples, hiddens,
                             weights, dweights, *floats, row_base=0, gh=None):
    """Launches the backward kernels → the float operands' gradients.
    ``hiddens`` are the forward's L saved hiddens, ``weights`` its relu
    logits (the ReLU's mask), ``row_base`` the forward's, ``gh`` the
    pre-activations it kept (``keep_gh``), which the wide chains read and
    the cluster chains do not take."""
    T, B, H, E, V, L = _dims(ticks_per_beat, samples, floats)
    dev = samples.device
    _check_device((("seed", seed), ("samples", samples)), dev, torch.int32)
    named = list(zip(float_operands(L), floats)) + [("weights", weights), ("dweights", dweights)]
    _check_device(named + [(f"hiddens[{l}]", h) for l, h in enumerate(hiddens)], dev,
                  torch.float32)
    nb = -(-T // ticks_per_beat)
    saved = (ticks_per_beat, nb * B, H)
    if len(hiddens) != L or any(h.shape != saved for h in hiddens) \
            or weights.shape != (T, B, V) or dweights.shape != (T, B, V):
        raise ValueError(f"hiddens must be {L} of {saved}, weights and dweights {(T, B, V)}")
    chain = chain_plan(T, B, H, ticks_per_beat)
    wide = isinstance(chain, WidePlan)
    if wide != (gh is not None):
        raise ValueError(f"H={H}: the {'wide' if wide else 'cluster'} chains "
                         f"{'read' if wide else 'take no'} gh (the forward's keep_gh)")
    if gh is not None:
        _check_device([("gh", gh)], dev, torch.float32)
        if gh.shape != gh_shape(T, B, H, L, ticks_per_beat):
            raise ValueError(f"gh must be {gh_shape(T, B, H, L, ticks_per_beat)}")
    lib = _library()
    grads = [torch.empty_like(x) for x in floats]
    shapes = gemm_shapes(H, E, V, L)
    terms = ticks_per_beat * nb * B
    splits = [atb_splits(m, n, terms) for m, _, n in shapes]
    partial = max(atb_scratch_floats(m, bias, n, 1, k) for (m, bias, n), k in zip(shapes, splits))
    scratch = torch.empty(
        lib.hier_tick_chain_bwd_scratch_floats(T, B, H, E, V, ticks_per_beat, L)
        + max(1, partial), dtype=torch.float32, device=dev)
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_bwd(
            seed.data_ptr(), samples.data_ptr(), _pointers(hiddens), weights.data_ptr(),
            dweights.data_ptr(), *_operand_args(floats), T, B, H, E, V, L, ticks_per_beat,
            dropout, keep, scale, int(row_base), chain.units if wide else chain.clusters,
            chain.rows, chain.smem_bytes, int(wide), None if gh is None else _pointers(list(gh)),
            *_operand_args(grads), scratch.data_ptr(), (ctypes.c_int * len(splits))(*splits),
            _build.stream_of(samples))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_bwd")
    LAUNCHES["bwd"] += 1
    CHAIN_LAUNCHES["bwd"] += L
    CHAIN_LAUNCHES["wide"] += L * int(wide)
    GEMM_LAUNCHES["atb"] += len(shapes)
    GEMM_LAUNCHES["rows"] += 2 * L + 1
    return tuple(grads)


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


class HierTickChainFn(torch.autograd.Function):
    """The tick loop with the kernel backward (CUDA tensors only). The
    samples carry no gradient; neither do teacher, seed and score. With
    ``keep_gh`` (the caller records a gradient) the forward keeps ``gh``
    for the backward's wide chains (:func:`keeps_gh`)."""

    @staticmethod
    def forward(ctx, train, dropout_rate, ticks_per_beat, sampling, row_base, keep_gh, teacher,
                seed, score, *floats):
        (weights, samples, *hiddens), gh = hier_tick_chain_fwd_cuda(
            train, dropout_rate, ticks_per_beat, sampling, teacher, seed, score, *floats,
            row_base=row_base, keep_gh=keep_gh)
        ctx.cfg = (train, dropout_rate, ticks_per_beat)
        ctx.row_base = row_base
        ctx.layers = len(hiddens)
        ctx.save_for_backward(seed, samples, weights, gh, *hiddens, *floats)
        ctx.mark_non_differentiable(samples)
        return weights, samples

    @staticmethod
    def backward(ctx, dweights, _dsamples):
        seed, samples, weights, gh, *rest = ctx.saved_tensors
        hiddens, floats = rest[:ctx.layers], rest[ctx.layers:]
        grads = hier_tick_chain_bwd_cuda(*ctx.cfg, seed, samples, hiddens, weights,
                                         dweights.contiguous(), *floats, row_base=ctx.row_base,
                                         gh=gh)
        return (None,) * 9 + grads


def tick_chain(seq_len: int, train: bool, dropout_rate: float, ticks_per_beat: int,
               sampling: str, teacher: torch.Tensor, seed: torch.Tensor,
               score: torch.Tensor, gi_beat, tick_h0, x0, emb, w_ih0e,
               layers: Sequence[Dict[str, torch.Tensor]], out_w,
               out_b, row_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused T-step tick loop of an L-layer tick GRU (``layers`` as
    :func:`tick_chain_reference` takes them). ``score`` is time-major
    (T, B); ``teacher`` and ``seed`` are (1,) int32; ``row_base`` is the
    global batch row of row 0 (a data-parallel rank's first row), for the
    random bits. Returns (weights
    (T, B, V) relu logits, samples (T, B) int32 fed tokens): the kernels
    for CUDA tensors, the plain loop for CPU tensors. On a CUDA tensor
    :func:`hier_plans` runs first, so shapes the kernels do not run raise
    before any launch. The forward keeps ``gh`` only where autograd
    records the call (:func:`~arvae_tpu_torch.ops.gru_kernel.records_grad`):
    not under ``no_grad``, as the evaluation and the decodes run it."""
    if score.shape[0] != seq_len:
        raise ValueError(f"score has {score.shape[0]} steps, seq_len is {seq_len}")
    if score.is_cuda:
        T, B = score.shape
        hier_plans(T, B, layers[0]["w_hh"].shape[0], x0.shape[-1], emb.shape[0],
                   len(layers), ticks_per_beat)
        floats = flat_operands(gi_beat, tick_h0, x0, emb, w_ih0e, layers, out_w, out_b)
        ints = (t.to(torch.int32).reshape(-1) for t in (teacher, seed))
        return HierTickChainFn.apply(
            bool(train), float(dropout_rate), int(ticks_per_beat), sampling, int(row_base),
            records_grad(*floats), *ints, score.to(torch.int32).contiguous(),
            *(x.float().contiguous() for x in floats))
    return tick_chain_reference(train, dropout_rate, ticks_per_beat, sampling, teacher,
                                seed, score, gi_beat, tick_h0, x0, emb, w_ih0e, layers,
                                out_w, out_b, row_base=row_base)
