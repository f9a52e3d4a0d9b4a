"""The hierarchical decoder's tick loop: hand-written CUDA kernel pair +
plain version.

Replaces the Pallas TPU kernel
``arvae_tpu/ops/hier_decoder_pallas.py::hier_tick_chain``: T sequential
steps of [2-layer tick GRU with per-beat hidden resets → ReLU head →
argmax or Gumbel-max → teacher select → re-embed the fed token], as one
launch forward and one (plus its fixed-order weight-gradient GEMMs)
backward.

On a CUDA tensor, :func:`hier_tick_chain` launches the kernels of
``csrc/hier_tick_chain.cu`` or raises; on a CPU tensor it runs
:func:`hier_tick_chain_reference`, a Python loop over T whose backward
is autograd through the loop. There is no fallback from one to the
other.

Random bits: neither the TPU's in-kernel PRNG nor ``jax.random`` can be
reproduced here, so both versions draw from one counter-based hash of
``(seed, t, salt, row, col)`` (salt 0 for dropout, 3571 for the Gumbel
noise), written once in CUDA and once below with integer tensor ops:
dropout masks of the kernel and of the plain version are bitwise equal.
``seed`` is an int32 device tensor, drawn per step by the trainer.

What bounds it on the card: a 24-step chain of dependent small products
with an argmax and a gather between steps, so latency. The kernel keeps
every recurrent quantity of a tile of batch rows in shared memory for
the whole measure; see the source's header for the design.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.ops.gru import stacked_gru_step_from_gi
from arvae_tpu_torch.ops.gru_kernel import atb_scratch_floats, atb_splits

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
                 rate: float) -> torch.Tensor:
    """Keep-and-scale mask of step t: 1/(1-rate) where kept, else 0."""
    keep = 1.0 - rate
    return (uniform01(seed, t, SALT_DROPOUT, rows, cols) < keep).float() * (1.0 / keep)


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


def hier_tick_chain_reference(
    train: bool, dropout_rate: float, ticks_per_beat: int, sampling: str,
    teacher: torch.Tensor, seed: torch.Tensor, score: torch.Tensor,
    gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1,
    out_w, out_b,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tick loop in Python. score (T, B) int; returns (weights
    (T, B, V) relu logits, samples (T, B) int32 fed tokens)."""
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
    T, B = score.shape
    H = w_hh0.shape[0]
    V = emb.shape[0]
    layers = [{"w_hh": w_hh0, "b_hh": b_hh0},
              {"w_ih": w_ih1, "b_ih": b_ih1, "w_hh": w_hh1, "b_hh": b_hh1}]
    use_teacher = teacher.reshape(()) != 0
    dropout = train and dropout_rate > 0.0
    h = tick_h0[0]
    prev_emb = x0
    weights: List[torch.Tensor] = []
    samples: List[torch.Tensor] = []
    for t in range(T):
        beat = t // ticks_per_beat
        if t % ticks_per_beat == 0:
            h = tick_h0[beat]
        gi0 = prev_emb @ w_ih0e + gi_beat[beat]
        masks = [dropout_mask(seed, t, B, H, dropout_rate)] if dropout else None
        top, h = stacked_gru_step_from_gi(layers, gi0, h, masks)
        logits = torch.relu(top @ out_w + out_b)
        scores = logits + gumbel(seed, t, B, V) if sampling == "multinomial" else logits
        sampled = argmax_lowest(scores.detach())
        tok = torch.where(use_teacher, score[t].long(), sampled).clamp(0, V - 1)
        weights.append(logits)
        samples.append(tok.to(torch.int32))
        prev_emb = F.embedding(tok, emb)
    return torch.stack(weights), torch.stack(samples)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hier_tick_chain_rows.argtypes = [i, i, i, i]
        lib.hier_tick_chain_rows.restype = i
        lib.hier_tick_chain_fwd.argtypes = ([p] * 16 + [i] * 7 + [f, f, i]
                                            + [p] * 4 + [p])
        lib.hier_tick_chain_fwd.restype = i
        lib.hier_tick_chain_bwd.argtypes = ([p] * 18 + [i] * 7 + [f, f]
                                            + [p] * 13 + [p] * 9
                                            + [ctypes.POINTER(i), p])
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


def _check_rows(lib: ctypes.CDLL, H: int, E: int, V: int) -> None:
    if lib.hier_tick_chain_rows(0, H, E, V) == 0:
        raise ValueError(
            f"H={H}, E={E}, V={V} are too wide: one batch row of the backward "
            "needs (34·H + E + V)·4 bytes of shared memory, at most 227 KB")


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
                             teacher, seed, score, *floats):
    """Launches the forward kernel → (weights, samples, h0_all, h1_all)."""
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
    T, B, H, E, V = _dims(ticks_per_beat, score, floats)
    dev = score.device
    _check_device((("teacher", teacher), ("seed", seed), ("score", score)), dev,
                  torch.int32)
    _check_device(zip(FLOAT_OPERANDS, floats), dev, torch.float32)
    if teacher.numel() != 1 or seed.numel() != 1:
        raise ValueError("teacher and seed must be (1,) int32")
    lib = _library()
    _check_rows(lib, H, E, V)
    weights = torch.empty((T, B, V), dtype=torch.float32, device=dev)
    samples = torch.empty((T, B), dtype=torch.int32, device=dev)
    h0_all = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    h1_all = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_fwd(
            teacher.data_ptr(), seed.data_ptr(), score.data_ptr(),
            *(x.data_ptr() for x in floats), T, B, H, E, V, ticks_per_beat,
            dropout, keep, scale, int(sampling == "multinomial"),
            weights.data_ptr(), samples.data_ptr(), h0_all.data_ptr(),
            h1_all.data_ptr(), _build.stream_of(score))
    _build.raise_on(lib, _NAME, err, "hier_tick_chain_fwd")
    LAUNCHES["fwd"] += 1
    return weights, samples, h0_all, h1_all


def hier_tick_chain_bwd_cuda(train, dropout_rate, ticks_per_beat, seed, samples,
                             h0_all, h1_all, dweights, *floats):
    """Launches the backward kernels → the 13 float operands' gradients."""
    T, B, H, E, V = _dims(ticks_per_beat, samples, floats)
    dev = samples.device
    _check_device((("seed", seed), ("samples", samples)), dev, torch.int32)
    _check_device(zip(FLOAT_OPERANDS + ("h0_all", "h1_all", "dweights"),
                      tuple(floats) + (h0_all, h1_all, dweights)), dev, torch.float32)
    if h0_all.shape != (T, B, H) or h1_all.shape != (T, B, H) \
            or dweights.shape != (T, B, V):
        raise ValueError("saved hiddens must be (T, B, H) and dweights (T, B, V)")
    lib = _library()
    _check_rows(lib, H, E, V)
    grads = [torch.empty_like(x) for x in floats]

    def scratch(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    shapes = gemm_shapes(H, E, V)
    splits = [atb_splits(m, bias, n, T * B) for m, bias, n in shapes]
    partial = max(atb_scratch_floats(m, bias, n, 1, k) for (m, bias, n), k in zip(shapes, splits))
    work = [scratch(T, B, H), scratch(T, B, E),                    # inter, pe
            scratch(T, B, E), scratch(T, B, V),                    # dpe, dlog
            *(scratch(T, B, 3 * H) for _ in range(4)),             # dgi1 dgh1 dgi0 dgh0
            scratch(max(1, partial))]                              # the GEMMs' partial sums
    dropout, keep, scale = _rate_args(train, dropout_rate)
    with torch.cuda.device(dev):
        err = lib.hier_tick_chain_bwd(
            seed.data_ptr(), samples.data_ptr(), h0_all.data_ptr(),
            h1_all.data_ptr(), dweights.data_ptr(),
            *(x.data_ptr() for x in floats), T, B, H, E, V, ticks_per_beat,
            dropout, keep, scale, *(g.data_ptr() for g in grads),
            *(w.data_ptr() for w in work), (ctypes.c_int * 6)(*splits),
            _build.stream_of(samples))
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
        ctx.save_for_backward(seed, samples, h0_all, h1_all, *floats)
        ctx.mark_non_differentiable(samples)
        return weights, samples

    @staticmethod
    def backward(ctx, dweights, _dsamples):
        seed, samples, h0_all, h1_all, *floats = ctx.saved_tensors
        grads = hier_tick_chain_bwd_cuda(*ctx.cfg, seed, samples, h0_all, h1_all,
                                         dweights.contiguous(), *floats)
        return (None,) * 7 + grads


def hier_tick_chain(seq_len: int, train: bool, dropout_rate: float,
                    ticks_per_beat: int, sampling: str, teacher: torch.Tensor,
                    seed: torch.Tensor, score: torch.Tensor, gi_beat, tick_h0, x0,
                    emb, w_ih0e, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1, out_w,
                    out_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused T-step tick loop, in the JAX signature's operand order.
    ``score`` is time-major (T, B); ``teacher`` and ``seed`` are (1,)
    int32. Returns (weights (T, B, V) relu logits, samples (T, B) int32
    fed tokens): the kernels for CUDA tensors, the plain loop for CPU."""
    if score.shape[0] != seq_len:
        raise ValueError(f"score has {score.shape[0]} steps, seq_len is {seq_len}")
    floats = (gi_beat, tick_h0, x0, emb, w_ih0e, w_hh0, b_hh0, w_ih1, b_ih1,
              w_hh1, b_hh1, out_w, out_b)
    if score.is_cuda:
        ints = (t.to(torch.int32).reshape(-1) for t in (teacher, seed))
        return HierTickChainFn.apply(
            bool(train), float(dropout_rate), int(ticks_per_beat), sampling, *ints,
            score.to(torch.int32).contiguous(),
            *(x.float().contiguous() for x in floats))
    return hier_tick_chain_reference(train, dropout_rate, ticks_per_beat, sampling,
                                     teacher, seed, score, *floats)
