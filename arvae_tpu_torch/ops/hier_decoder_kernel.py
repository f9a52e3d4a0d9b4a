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
forward plan (:func:`hier_plan`: the weight slices resident in shared
memory where they fit, else streamed from L2) and the backward chain
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
``seed`` is an int32 device tensor, drawn per step by the trainer.
Both draw the mask of the gap after layer l with salt l.

What bounds it on the card: a 24-step chain of dependent small products
with an argmax and a gather between steps, so latency. The forward runs
on thread-block clusters: a cluster owns a tile of batch rows for the
whole measure, each CTA keeping its slice of every weight in shared
memory (or reading it from L2 in stages, where it does not fit) and
exchanging hiddens and per-row argmax partials with its peers
through distributed shared memory (:func:`hier_plan` picks the cluster
size and the rows). The backward runs the beats in parallel: the hidden
carries restart at every beat, so each layer is ``n_beats`` independent
chains of ``ticks_per_beat`` ticks, run by ``gru_chain``'s cluster
backward, and every product that touches no carry runs over all T·B rows
at once (:func:`hier_tick_chain_bwd_by_beats` is the same decomposition
in plain PyTorch). The saved hiddens use the chains' layout
``(ticks_per_beat, n_beats·B, H)``. See the source's header for the
design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from arvae_tpu_torch.ops import _build, gru_kernel
from arvae_tpu_torch.ops.gru import stacked_gru_step_from_gi
from arvae_tpu_torch.ops.gru_kernel import (CLUSTERS_HELD, MAX_SMEM, ROWS_PER_THREAD,
                                            STREAM_DEPTH, THREADS, ChainPlan,
                                            atb_scratch_floats, atb_splits, best_plan,
                                            gru_gates, gru_plan, slice_ld, up4)

_NAME = "hier_tick_chain"
SALT_DROPOUT = 0
SALT_GUMBEL = 3571
SAMPLING = ("argmax", "multinomial")

# Kernel launches by the wrapper, one per call of each direction.
LAUNCHES = {"fwd": 0, "bwd": 0}
# Launches of gru_chain's cluster backward by the backward: one a layer.
CHAIN_LAUNCHES = {"bwd": 0}

# Tick-GRU layers the kernels take (kMaxLayers in the source).
MAX_LAYERS = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CHAIN_LAUNCHES["bwd"] = 0


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
              cols: int) -> torch.Tensor:
    """(rows, cols) float32 uniforms in (0, 1) for step t: the top 24
    bits of the hash, kept away from 0 and 1 as
    ``hier_decoder_pallas._uniform01`` does."""
    dev = seed.device
    h = seed.reshape(1).long() & _M32
    h = _mix32(_mix32(_mix32(h) ^ t) ^ salt)
    r = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    c = torch.arange(cols, device=dev, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(h[:, None] ^ r) ^ c)
    u = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u * (1.0 - 2.0 / 16777216.0) + 1.0 / 16777216.0


def dropout_mask(seed: torch.Tensor, t: int, rows: int, cols: int,
                 rate: float, salt: int = SALT_DROPOUT) -> torch.Tensor:
    """Keep-and-scale mask of step t: 1/(1-rate) where kept, else 0."""
    keep = 1.0 - rate
    return (uniform01(seed, t, salt, rows, cols) < keep).float() * (1.0 / keep)


def gumbel(seed: torch.Tensor, t: int, rows: int, cols: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniform01(seed, t, SALT_GUMBEL, rows, cols)))


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
    out_w, out_b, hiddens: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The tick loop in Python, for an L-layer tick GRU. score (T, B)
    int; tick_h0 (n_beats, L, B, H); ``layers`` the L layers' parameters
    in the (I, 3H) layout (layer 0's ``w_hh``, ``b_hh``: its input
    projection comes as ``w_ih0e`` and ``gi_beat``; the others' ``w_ih``,
    ``b_ih``, ``w_hh``, ``b_hh``). Returns (weights (T, B, V) relu
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
        masks = [dropout_mask(seed, t, B, H, dropout_rate, SALT_DROPOUT + gap)
                 for gap in range(len(layers) - 1)] if dropout else None
        top, h = stacked_gru_step_from_gi(layers, gi0, h, masks)
        states.append(h)
        logits = torch.relu(top @ out_w + out_b)
        scores = logits + gumbel(seed, t, B, V) if sampling == "multinomial" else logits
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
                                 weights, dweights, *floats):
    """The kernel backward's decomposition in plain PyTorch: products
    over all rows at once, then each layer, from the top down, as n_beats
    independent chains of ``ticks_per_beat`` ticks. ``hiddens`` are the
    L layers' saved hiddens in the chain layout, ``weights`` the
    forward's relu logits (their sign is the ReLU's mask), ``floats`` the
    float operands (:func:`float_operands`). → their gradients, in that
    order."""
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
    masks = [to_chain(torch.stack([dropout_mask(seed, t, B, H, dropout_rate, SALT_DROPOUT + gap)
                                   for t in range(T)]), tpb) if dropout
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


def fwd_smem_floats(H: int, E: int, V: int, C: int, RB: int, L: int = 2,
                    streamed: bool = False) -> int:
    """Floats of shared memory one CTA of the forward uses for a tick GRU
    of L layers, its weight slices resident or streamed: ``fwd_layout``
    in ``csrc/hier_tick_chain.cu``, term for term."""
    hc, vc = H // C, -(-V // C)
    n3 = 3 * hc
    ldw, ldv, ldh, ldg, lde, ldl = (slice_ld(n3), slice_ld(vc), up4(H), up4(n3), up4(E),
                                    up4(vc))
    if streamed:
        weights = 2 * STREAM_DEPTH * max(ldw, ldv)
    else:
        weights = E * ldw + (2 * L - 1) * H * ldw + H * ldv
    biases = (2 * L - 1) * ldg + ldl + up4(V * E)
    tile = (2 * L + min(L - 1, 2)) * RB * ldh + RB * lde + 2 * RB * ldg + RB * ldl
    if streamed:
        depth = min(STREAM_DEPTH, H)
        part = up4(max(product_part_floats(RB, E, n3, THREADS),
                       product_part_floats(RB, depth, n3, THREADS),
                       product_part_floats(RB, depth, vc, THREADS)))
    else:
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


def held_clusters(plan: ChainPlan) -> int:
    """Clusters of the forward plan's size the card holds at once."""
    return gru_kernel.held_clusters(plan, "hier_fwd")


@functools.lru_cache(maxsize=256)
def hier_plan(B: int, H: int, E: int, V: int, L: int = 2) -> ChainPlan:
    """The forward's plan for a tick GRU of L layers: the resident layout
    wherever it fits, else the streamed one; of each, by ``gru_plan``'s
    rule, the fewest waves of the card (clusters over the ones it holds
    at once), then the most CTAs, then the fewest CTAs a cluster (the
    fewest peers to exchange with), then the most rows a cluster;
    clusters of 2, 4 or 8 CTAs, a single CTA only where no cluster fits.
    A resident CTA holds its H/C units' gate columns of the 2L - 1 GRU
    matrices and of w_ih0e, its ceil(V/C) columns of ``out_w`` and all
    of ``emb``; a streamed one reads the matrices from L2 every tick.
    Raises ValueError, naming H, V and L, when no plan fits 227 KB."""
    for streamed in (False, True):
        plans = []
        for c in (2, 4, 8, 1):
            for rb in range(32, 0, -ROWS_PER_THREAD):
                if H % c or rb * (H // c) > THREADS:
                    continue
                smem = 4 * fwd_smem_floats(H, E, V, c, rb, L, streamed)
                if smem > MAX_SMEM:
                    continue
                plan = ChainPlan(c, rb, smem, (c * -(-B // rb), 1), streamed)
                waves = -(-(plan.grid[0] // c) // held_clusters(plan))
                plans.append((plan, (c == 1, waves, -plan.ctas, c, -rb)))
        best = best_plan(plans)
        if best is not None:
            return best
    raise ValueError(f"H={H}, V={V}, L={L} are too wide: no cluster of at most 8 CTAs gives "
                     "a 4-row tile one thread a unit and fits 227 KB of shared memory")


def chain_plan(T: int, B: int, H: int, ticks_per_beat: int) -> ChainPlan:
    """The backward's chain plan: ``gru_chain``'s cluster backward over
    n_beats·B rows."""
    return gru_plan(1, -(-T // ticks_per_beat) * B, H, True)


def hier_plans(T: int, B: int, H: int, E: int, V: int, L: int,
               ticks_per_beat: int) -> Tuple[ChainPlan, ChainPlan]:
    """(forward plan, backward chain plan) of the tick loop's kernels at
    these shapes; raises ValueError, naming H and L, where the kernels do
    not run them: a tick GRU of other than 1 to ``MAX_LAYERS`` layers, or
    a width no plan fits."""
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"H={H}, L={L}: the tick-loop kernels run a tick GRU of 1 to "
                         f"{MAX_LAYERS} layers")
    return hier_plan(B, H, E, V, L), chain_plan(T, B, H, ticks_per_beat)


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
        lib.hier_tick_chain_smem_floats.argtypes = [i] * 7
        lib.hier_tick_chain_smem_floats.restype = i
        lib.hier_tick_chain_resident_clusters.argtypes = [i] * 3
        lib.hier_tick_chain_resident_clusters.restype = i
        lib.hier_tick_chain_bwd_scratch_floats.argtypes = [i] * 7
        lib.hier_tick_chain_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.hier_tick_chain_fwd.argtypes = ([p] * 8 + [pp] * 4 + [p] * 2 + [i] * 8 + [f, f]
                                            + [i] * 5 + [p, p, pp, p])
        lib.hier_tick_chain_fwd.restype = i
        lib.hier_tick_chain_bwd.argtypes = ([p, p, pp] + [p] * 7 + [pp] * 4 + [p] * 2
                                            + [i] * 8 + [f, f] + [i] * 4 + [p] * 5 + [pp] * 4
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


def hier_tick_chain_fwd_cuda(train, dropout_rate, ticks_per_beat, sampling,
                             teacher, seed, score, *floats, plan=None):
    """Launches the forward kernel → (weights, samples, *hiddens), the L
    layers' hiddens in the chain layout (ticks_per_beat, n_beats·B, H).
    ``floats``: the float operands (:func:`float_operands`); ``plan``: the
    launch plan, :func:`hier_plan`'s by default."""
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
    lib = _library()
    nb = -(-T // ticks_per_beat)
    weights = torch.empty((T, B, V), dtype=torch.float32, device=dev)
    samples = torch.empty((T, B), dtype=torch.int32, device=dev)
    hiddens = [torch.empty((ticks_per_beat, nb * B, H), dtype=torch.float32, device=dev)
               for _ in range(L)]
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_fwd(
            teacher.data_ptr(), seed.data_ptr(), score.data_ptr(), *_operand_args(floats),
            T, B, H, E, V, L, ticks_per_beat, dropout, keep, scale,
            int(sampling == "multinomial"), plan.clusters, plan.rows, plan.smem_bytes,
            int(plan.streamed), weights.data_ptr(), samples.data_ptr(), _pointers(hiddens),
            _build.stream_of(score))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_fwd")
    LAUNCHES["fwd"] += 1
    return (weights, samples, *hiddens)


def hier_tick_chain_bwd_cuda(train, dropout_rate, ticks_per_beat, seed, samples, hiddens,
                             weights, dweights, *floats):
    """Launches the backward kernels → the float operands' gradients.
    ``hiddens`` are the forward's L saved hiddens, ``weights`` its relu
    logits (the ReLU's mask)."""
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
    lib = _library()
    grads = [torch.empty_like(x) for x in floats]
    shapes = gemm_shapes(H, E, V, L)
    terms = ticks_per_beat * nb * B
    splits = [atb_splits(m, bias, n, terms) for m, bias, n in shapes]
    partial = max(atb_scratch_floats(m, bias, n, 1, k) for (m, bias, n), k in zip(shapes, splits))
    scratch = torch.empty(
        lib.hier_tick_chain_bwd_scratch_floats(T, B, H, E, V, ticks_per_beat, L)
        + max(1, partial), dtype=torch.float32, device=dev)
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_bwd(
            seed.data_ptr(), samples.data_ptr(), _pointers(hiddens), weights.data_ptr(),
            dweights.data_ptr(), *_operand_args(floats), T, B, H, E, V, L, ticks_per_beat,
            dropout, keep, scale, chain.clusters, chain.rows, chain.smem_bytes,
            int(chain.streamed), *_operand_args(grads), scratch.data_ptr(),
            (ctypes.c_int * len(splits))(*splits), _build.stream_of(samples))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_bwd")
    LAUNCHES["bwd"] += 1
    CHAIN_LAUNCHES["bwd"] += L
    return tuple(grads)


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


class HierTickChainFn(torch.autograd.Function):
    """The tick loop with the kernel backward (CUDA tensors only). The
    samples carry no gradient; neither do teacher, seed and score."""

    @staticmethod
    def forward(ctx, train, dropout_rate, ticks_per_beat, sampling, teacher, seed,
                score, *floats):
        weights, samples, *hiddens = hier_tick_chain_fwd_cuda(
            train, dropout_rate, ticks_per_beat, sampling, teacher, seed, score,
            *floats)
        ctx.cfg = (train, dropout_rate, ticks_per_beat)
        ctx.layers = len(hiddens)
        ctx.save_for_backward(seed, samples, weights, *hiddens, *floats)
        ctx.mark_non_differentiable(samples)
        return weights, samples

    @staticmethod
    def backward(ctx, dweights, _dsamples):
        seed, samples, weights, *rest = ctx.saved_tensors
        hiddens, floats = rest[:ctx.layers], rest[ctx.layers:]
        grads = hier_tick_chain_bwd_cuda(*ctx.cfg, seed, samples, hiddens, weights,
                                         dweights.contiguous(), *floats)
        return (None,) * 7 + grads


def tick_chain(seq_len: int, train: bool, dropout_rate: float, ticks_per_beat: int,
               sampling: str, teacher: torch.Tensor, seed: torch.Tensor,
               score: torch.Tensor, gi_beat, tick_h0, x0, emb, w_ih0e,
               layers: Sequence[Dict[str, torch.Tensor]], out_w,
               out_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused T-step tick loop of an L-layer tick GRU (``layers`` as
    :func:`tick_chain_reference` takes them). ``score`` is time-major
    (T, B); ``teacher`` and ``seed`` are (1,) int32. Returns (weights
    (T, B, V) relu logits, samples (T, B) int32 fed tokens): the kernels
    for CUDA tensors, the plain loop for CPU tensors. On a CUDA tensor
    :func:`hier_plans` runs first, so shapes the kernels do not run raise
    before any launch."""
    if score.shape[0] != seq_len:
        raise ValueError(f"score has {score.shape[0]} steps, seq_len is {seq_len}")
    if score.is_cuda:
        T, B = score.shape
        hier_plans(T, B, layers[0]["w_hh"].shape[0], x0.shape[-1], emb.shape[0],
                   len(layers), ticks_per_beat)
        floats = flat_operands(gi_beat, tick_h0, x0, emb, w_ih0e, layers, out_w, out_b)
        ints = (t.to(torch.int32).reshape(-1) for t in (teacher, seed))
        return HierTickChainFn.apply(
            bool(train), float(dropout_rate), int(ticks_per_beat), sampling, *ints,
            score.to(torch.int32).contiguous(), *(x.float().contiguous() for x in floats))
    return tick_chain_reference(train, dropout_rate, ticks_per_beat, sampling, teacher,
                                seed, score, gi_beat, tick_h0, x0, emb, w_ih0e, layers,
                                out_w, out_b)
