"""The hierarchical decoder's tick loop: hand-written CUDA kernel pair +
plain version.

Replaces the Pallas TPU kernel
``arvae_tpu/ops/hier_decoder_pallas.py::hier_tick_chain``: T sequential
steps of [2-layer tick GRU with per-beat hidden resets → ReLU head →
argmax or Gumbel-max → teacher select → re-embed the fed token], as one
launch forward and one (plus its fixed-order weight-gradient GEMMs)
backward.

On a CUDA tensor, :func:`tick_chain` launches the kernels of
``csrc/hier_tick_chain.cu`` or raises: the kernels run a tick GRU of 2
layers whose forward plan (:func:`hier_plan`) and backward chain plan
(:func:`chain_plan`) fit 227 KB of shared memory, and
:func:`hier_plans` raises ``ValueError``, naming H and L, before any
launch where they do not. On a CPU tensor it runs
:func:`tick_chain_reference`, a Python loop over T for any number of
tick-GRU layers whose backward is autograd through the loop. There is
no fallback from one to the other.

Random bits: neither the TPU's in-kernel PRNG nor ``jax.random`` can be
reproduced here, so both versions draw from one counter-based hash of
``(seed, t, salt, row, col)`` (salt 0 for dropout, 3571 for the Gumbel
noise), written once in CUDA and once below with integer tensor ops:
dropout masks of the kernel and of the plain version are bitwise equal.
``seed`` is an int32 device tensor, drawn per step by the trainer. A
plain loop of L layers draws the mask of the gap after layer l with
salt l, so that its first gap's mask is the kernel's.

What bounds it on the card: a 24-step chain of dependent small products
with an argmax and a gather between steps, so latency. The forward runs
on thread-block clusters: a cluster owns a tile of batch rows for the
whole measure, each CTA keeping its slice of every weight in shared
memory and exchanging hiddens and per-row argmax partials with its peers
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

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.ops.gru import stacked_gru_step_from_gi
from arvae_tpu_torch.ops.gru_kernel import (MAX_SMEM, ROWS_PER_THREAD, SMS, THREADS,
                                            ChainPlan, atb_scratch_floats, atb_splits,
                                            gru_gates, gru_plan, slice_ld, up4)

_NAME = "hier_tick_chain"
SALT_DROPOUT = 0
SALT_GUMBEL = 3571
SAMPLING = ("argmax", "multinomial")

# Kernel launches by the wrapper, one per call of each direction.
LAUNCHES = {"fwd": 0, "bwd": 0}

# The 13 float operands, in the JAX signature's order.
FLOAT_OPERANDS = ("gi_beat", "tick_h0", "x0", "emb", "w_ih0e", "w_hh0", "b_hh0",
                  "w_ih1", "b_ih1", "w_hh1", "b_hh1", "out_w", "out_b")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def chain_operands(floats: Sequence[torch.Tensor]) -> Tuple:
    """The 13 float operands in the kernel's order (:data:`FLOAT_OPERANDS`,
    the order its backward returns their gradients in) → the operands
    :func:`tick_chain` and :func:`tick_chain_reference` take after
    ``score``: (gi_beat, tick_h0, x0, emb, w_ih0e, layers, out_w, out_b)."""
    gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1, *out = floats
    layers = [{"w_hh": w_hh0, "b_hh": b_hh0},
              {"w_ih": w_ih1, "b_ih": b_ih1, "w_hh": w_hh1, "b_hh": b_hh1}]
    return (gi_beat, tick_h0, x0, emb, w_ih0e, layers, *out)


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


def hier_tick_chain_bwd_by_beats(train, dropout_rate, ticks_per_beat, seed, samples,
                                 h0_all, h1_all, weights, dweights, gi_beat, tick_h0, x0,
                                 emb, w_ih0e, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1,
                                 out_w, out_b):
    """The kernel backward's decomposition in plain PyTorch: products
    over all rows at once, then each layer as n_beats independent chains
    of ``ticks_per_beat`` ticks. ``h0_all``, ``h1_all`` are the saved
    hiddens in the chain layout, ``weights`` the forward's relu logits
    (their sign is the ReLU's mask). → the 13 gradients, in
    :data:`FLOAT_OPERANDS` order."""
    T, B = samples.shape
    tpb = ticks_per_beat
    nb = -(-T // tpb)
    live = to_chain(torch.ones(T, B, 1, device=samples.device), tpb)  # 0 on padded ticks
    fed = torch.cat([x0[None], F.embedding(samples[:-1].long(), emb)])  # (T, B, E)
    pe = to_chain(fed, tpb)
    if train and dropout_rate > 0.0:
        mask = to_chain(torch.stack([dropout_mask(seed, t, B, h0_all.shape[-1], dropout_rate)
                                     for t in range(T)]), tpb)
    else:
        mask = torch.ones_like(h0_all)
    inter = h0_all * mask
    gi0 = (pe @ w_ih0e + gi_beat.reshape(nb * B, -1)) * live
    gi1 = (inter @ w_ih1 + b_ih1) * live
    dlog = to_chain(dweights * (weights > 0), tpb)
    init = tick_h0.transpose(0, 1).reshape(2, nb * B, -1)
    dgi1, dgh1, dinit1 = _chain_bwd_plain(gi1, w_hh1, b_hh1, init[1], h1_all, dlog @ out_w.T)
    dx = (dgi1 @ w_ih1.T) * mask
    dgi0, dgh0, dinit0 = _chain_bwd_plain(gi0, w_hh0, b_hh0, init[0], h0_all, dx)
    dpe = dgi0 @ w_ih0e.T

    def atb(a, x):
        return torch.einsum("kri,krj->ij", a, x)

    def prev(all_, init_):
        return torch.cat([init_[None], all_[:-1]])

    onehot = F.one_hot(samples[:-1].long(), emb.shape[0]).float()
    fed_tok = to_chain(torch.cat([torch.zeros_like(onehot[:1]), onehot]), tpb)
    dtick_h0 = torch.stack([dinit0, dinit1]).reshape(2, nb, B, -1).transpose(0, 1)
    return (dgi0.sum(0).reshape(nb, B, -1), dtick_h0.contiguous(), dpe[0, :B],
            atb(fed_tok, dpe), atb(pe, dgi0), atb(prev(h0_all, init[0]), dgh0),
            dgh0.sum((0, 1)), atb(inter, dgi1), dgi1.sum((0, 1)),
            atb(prev(h1_all, init[1]), dgh1), dgh1.sum((0, 1)), atb(h1_all, dlog),
            dlog.sum((0, 1)))


# ---------------------------------------------------------------------------
# The forward's launch plan (a pure function of the shapes)
# ---------------------------------------------------------------------------


def fwd_smem_floats(H: int, E: int, V: int, C: int, RB: int) -> int:
    """Floats of shared memory one CTA of the forward uses:
    ``fwd_layout`` in ``csrc/hier_tick_chain.cu``, term for term."""
    hc, vc = H // C, -(-V // C)
    n3 = 3 * hc
    ldw, ldv, ldh, ldg, lde, ldl = (slice_ld(n3), slice_ld(vc), up4(H), up4(n3), up4(E),
                                    up4(vc))
    weights = E * ldw + 3 * H * ldw + H * ldv + 3 * ldg + ldl + up4(V * E)
    tile = 4 * RB * ldh + RB * ldh + RB * lde + 2 * RB * ldg + RB * ldl
    half = up4(max(product_part_floats(RB, E, n3, THREADS // 2),
                   product_part_floats(RB, H, n3, THREADS // 2)))
    part = max(2 * half, up4(product_part_floats(RB, H, vc, THREADS)))
    return weights + tile + part + 2 * up4(C * RB) + up4(RB)


def product_part_floats(rows: int, K: int, N: int, threads: int) -> int:
    """Floats of partial sums one depth-split product of ``gru_common.cuh``
    (``product_part_floats``) needs on ``threads`` threads."""
    items = rows // ROWS_PER_THREAD * -(-N // 2)
    s = 1
    while K % 4 == 0 and s < 8 and items * 2 * s <= threads and K % (8 * s) == 0:
        s *= 2
    return (s - 1) * items * 2 * ROWS_PER_THREAD


# Clusters of C CTAs, one CTA an SM, that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, arvae_tpu_torch/utils/plan_probe.py):
# clusters live inside one GPC, and the GPCs' SM counts leave some SMs
# over, so 32 clusters of 4 CTAs (128 SMs) do not fit at once.
RESIDENT_CLUSTERS = {1: SMS, 2: 66, 4: 30, 8: 15}


@functools.lru_cache(maxsize=256)
def hier_plan(B: int, H: int, E: int, V: int) -> ChainPlan:
    """The forward's plan, by ``gru_plan``'s rule: the fewest waves of
    the card (clusters over the ones it holds at once, a CTA an SM), then
    the most CTAs, then the fewest CTAs a cluster (the fewest peers to
    exchange with), then the most rows a cluster; clusters of 2, 4 or 8
    CTAs, a single CTA only where no cluster fits. A CTA holds its H/C
    units' gate columns of the four GRU matrices, its ceil(V/C) columns
    of ``out_w`` and all of ``emb``. Raises ValueError when no plan fits
    227 KB."""
    best, best_key = None, None
    for c in (2, 4, 8, 1):
        for rb in range(32, 0, -ROWS_PER_THREAD):
            if H % c or rb * (H // c) > THREADS:
                continue
            smem = 4 * fwd_smem_floats(H, E, V, c, rb)
            if smem > MAX_SMEM:
                continue
            plan = ChainPlan(c, rb, smem, (c * -(-B // rb), 1))
            waves = -(-(plan.grid[0] // c) // RESIDENT_CLUSTERS[c])
            key = (c == 1, waves, -plan.ctas, c, -rb)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(f"H={H}, V={V} are too wide: no cluster of at most 8 CTAs holds "
                         "the tick loop's weight slices and a 4-row tile in 227 KB of "
                         "shared memory")
    return best


def chain_plan(T: int, B: int, H: int, ticks_per_beat: int) -> ChainPlan:
    """The backward's chain plan: ``gru_chain``'s cluster backward over
    n_beats·B rows."""
    return gru_plan(1, -(-T // ticks_per_beat) * B, H, True)


def hier_plans(T: int, B: int, H: int, E: int, V: int, L: int,
               ticks_per_beat: int) -> Tuple[ChainPlan, ChainPlan]:
    """(forward plan, backward chain plan) of the tick loop's kernels at
    these shapes; raises ValueError, naming H and L, where the kernels do
    not run them: a tick GRU of other than 2 layers, or a width no plan
    fits."""
    if L != 2:
        raise ValueError(f"H={H}, L={L}: the tick-loop kernels run a tick GRU of 2 layers")
    return hier_plan(B, H, E, V), chain_plan(T, B, H, ticks_per_beat)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hier_tick_chain_smem_floats.argtypes = [i] * 5
        lib.hier_tick_chain_smem_floats.restype = i
        lib.hier_tick_chain_resident_clusters.argtypes = [i, i]
        lib.hier_tick_chain_resident_clusters.restype = i
        lib.hier_tick_chain_bwd_scratch_floats.argtypes = [i] * 6
        lib.hier_tick_chain_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.hier_tick_chain_fwd.argtypes = ([p] * 16 + [i] * 7 + [f, f] + [i] * 4
                                            + [p] * 4 + [p])
        lib.hier_tick_chain_fwd.restype = i
        lib.hier_tick_chain_bwd.argtypes = ([p] * 19 + [i] * 7 + [f, f] + [i] * 3
                                            + [p] * 13 + [p, ctypes.POINTER(i), p])
        lib.hier_tick_chain_bwd.restype = i
        _bound = True
    return lib


def _dims(ticks_per_beat: int, score: torch.Tensor,
          floats: Sequence[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    """(T, B, H, E, V) after checking every operand's shape."""
    if score.ndim != 2:
        raise ValueError(f"score must be (T, B), got {tuple(score.shape)}")
    T, B = score.shape
    x0, emb, w_hh0 = floats[2], floats[3], floats[5]
    H, E, V = w_hh0.shape[0], x0.shape[-1], emb.shape[0]
    if ticks_per_beat < 1:
        raise ValueError(f"ticks_per_beat must be >= 1, got {ticks_per_beat}")
    nb = -(-T // ticks_per_beat)
    want = {
        "gi_beat": (nb, B, 3 * H), "tick_h0": (nb, 2, B, H), "x0": (B, E),
        "emb": (V, E), "w_ih0e": (E, 3 * H), "w_hh0": (H, 3 * H), "b_hh0": (3 * H,),
        "w_ih1": (H, 3 * H), "b_ih1": (3 * H,), "w_hh1": (H, 3 * H),
        "b_hh1": (3 * H,), "out_w": (H, V), "out_b": (V,),
    }
    for name, x in zip(FLOAT_OPERANDS, floats):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
    return T, B, H, E, V


def _check_device(named, dev: torch.device, dtype: torch.dtype) -> None:
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")


def gemm_shapes(H: int, E: int, V: int) -> Tuple[Tuple[int, bool, int], ...]:
    """(M, bias row, N) of the backward's six weight-gradient GEMMs, in
    the order the C entry runs them: out_w (+ out_b), w_ih1 (+ b_ih1),
    w_hh1 (+ b_hh1), w_hh0 (+ b_hh0), w_ih0e, emb."""
    return ((H, True, V), (H, True, 3 * H), (H, True, 3 * H), (H, True, 3 * H),
            (E, False, 3 * H), (V, False, E))


def _rate_args(train: bool, dropout_rate: float) -> Tuple[int, float, float]:
    if train and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        return 1, keep, 1.0 / keep
    return 0, 1.0, 1.0


def hier_tick_chain_fwd_cuda(train, dropout_rate, ticks_per_beat, sampling,
                             teacher, seed, score, *floats, plan=None):
    """Launches the forward kernel → (weights, samples, h0_all, h1_all),
    the hiddens in the chain layout (ticks_per_beat, n_beats·B, H).
    ``plan``: the launch plan, :func:`hier_plan`'s by default."""
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
    T, B, H, E, V = _dims(ticks_per_beat, score, floats)
    dev = score.device
    _check_device((("teacher", teacher), ("seed", seed), ("score", score)), dev,
                  torch.int32)
    _check_device(zip(FLOAT_OPERANDS, floats), dev, torch.float32)
    if teacher.numel() != 1 or seed.numel() != 1:
        raise ValueError("teacher and seed must be (1,) int32")
    plan = plan or hier_plan(B, H, E, V)
    lib = _library()
    nb = -(-T // ticks_per_beat)
    weights = torch.empty((T, B, V), dtype=torch.float32, device=dev)
    samples = torch.empty((T, B), dtype=torch.int32, device=dev)
    h0_all = torch.empty((ticks_per_beat, nb * B, H), dtype=torch.float32, device=dev)
    h1_all = torch.empty_like(h0_all)
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_fwd(
            teacher.data_ptr(), seed.data_ptr(), score.data_ptr(),
            *(x.data_ptr() for x in floats), T, B, H, E, V, ticks_per_beat,
            dropout, keep, scale, int(sampling == "multinomial"), plan.clusters,
            plan.rows, plan.smem_bytes, weights.data_ptr(), samples.data_ptr(),
            h0_all.data_ptr(), h1_all.data_ptr(), _build.stream_of(score))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_fwd")
    LAUNCHES["fwd"] += 1
    return weights, samples, h0_all, h1_all


def hier_tick_chain_bwd_cuda(train, dropout_rate, ticks_per_beat, seed, samples,
                             h0_all, h1_all, weights, dweights, *floats):
    """Launches the backward kernels → the 13 float operands' gradients.
    ``weights`` are the forward's relu logits (the ReLU's mask)."""
    T, B, H, E, V = _dims(ticks_per_beat, samples, floats)
    dev = samples.device
    _check_device((("seed", seed), ("samples", samples)), dev, torch.int32)
    _check_device(zip(FLOAT_OPERANDS + ("h0_all", "h1_all", "weights", "dweights"),
                      tuple(floats) + (h0_all, h1_all, weights, dweights)), dev,
                  torch.float32)
    nb = -(-T // ticks_per_beat)
    saved = (ticks_per_beat, nb * B, H)
    if h0_all.shape != saved or h1_all.shape != saved or weights.shape != (T, B, V) \
            or dweights.shape != (T, B, V):
        raise ValueError(f"saved hiddens must be {saved}, weights and dweights {(T, B, V)}")
    chain = chain_plan(T, B, H, ticks_per_beat)
    lib = _library()
    grads = [torch.empty_like(x) for x in floats]
    shapes = gemm_shapes(H, E, V)
    terms = ticks_per_beat * nb * B
    splits = [atb_splits(m, bias, n, terms) for m, bias, n in shapes]
    partial = max(atb_scratch_floats(m, bias, n, 1, k) for (m, bias, n), k in zip(shapes, splits))
    scratch = torch.empty(
        lib.hier_tick_chain_bwd_scratch_floats(T, B, H, E, V, ticks_per_beat) + max(1, partial),
        dtype=torch.float32, device=dev)
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_bwd(
            seed.data_ptr(), samples.data_ptr(), h0_all.data_ptr(),
            h1_all.data_ptr(), weights.data_ptr(), dweights.data_ptr(),
            *(x.data_ptr() for x in floats), T, B, H, E, V, ticks_per_beat,
            dropout, keep, scale, chain.clusters, chain.rows, chain.smem_bytes,
            *(g.data_ptr() for g in grads), scratch.data_ptr(),
            (ctypes.c_int * 6)(*splits), _build.stream_of(samples))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_bwd")
    LAUNCHES["bwd"] += 1
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
        weights, samples, h0_all, h1_all = hier_tick_chain_fwd_cuda(
            train, dropout_rate, ticks_per_beat, sampling, teacher, seed, score,
            *floats)
        ctx.cfg = (train, dropout_rate, ticks_per_beat)
        ctx.save_for_backward(seed, samples, h0_all, h1_all, weights, *floats)
        ctx.mark_non_differentiable(samples)
        return weights, samples

    @staticmethod
    def backward(ctx, dweights, _dsamples):
        seed, samples, h0_all, h1_all, weights, *floats = ctx.saved_tensors
        grads = hier_tick_chain_bwd_cuda(*ctx.cfg, seed, samples, h0_all, h1_all, weights,
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
        l0, l1 = layers
        floats = (gi_beat, tick_h0, x0, emb, w_ih0e, l0["w_hh"], l0["b_hh"], l1["w_ih"],
                  l1["b_ih"], l1["w_hh"], l1["b_hh"], out_w, out_b)
        ints = (t.to(torch.int32).reshape(-1) for t in (teacher, seed))
        return HierTickChainFn.apply(
            bool(train), float(dropout_rate), int(ticks_per_beat), sampling, *ints,
            score.to(torch.int32).contiguous(), *(x.float().contiguous() for x in floats))
    return tick_chain_reference(train, dropout_rate, ticks_per_beat, sampling, teacher,
                                seed, score, gi_beat, tick_h0, x0, emb, w_ih0e, layers,
                                out_w, out_b)
