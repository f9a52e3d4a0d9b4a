"""Whole-sequence GRU recurrence: hand-written CUDA kernel pair + plain version.

Replaces the Pallas TPU kernel ``arvae_tpu/ops/gru_pallas.py::gru_chain``.
Layout (directions batched on a leading axis; any time flip for a
backward direction happens in the caller, ``ops/gru.py``)::

    gi   (T, D, B, 3H)  precomputed x @ w_ih + b_ih  (gates r, z, n)
    w_hh (D, H, 3H), b_hh (D, 3H), h0 (D, B, H)
    -> outs (T, D, B, H)     (the final hidden state is outs[-1])

Gate math is torch-exact: ``n = tanh(i_n + r * (h w_hn + b_hn))``.

On a CUDA tensor, :func:`gru_chain` launches the kernels of
``csrc/gru_chain.cu`` (forward in the autograd Function's forward,
backward in its backward) or raises: where :func:`gru_plan` fits no
direction (a width whose 4-row tile takes more than 512 threads even in
clusters of 8) it raises before any launch. On a CPU tensor it runs
:func:`gru_chain_reference`, a Python loop over T whose backward is
autograd through the loop. There is no fallback from one to the other.

What bounds it on the card: a T-long chain of dependent
(rows x H) @ (H x 3H) products, small enough that latency, not bytes or
arithmetic, sets the time. The kernel runs the whole chain in one launch:
a thread-block cluster of C CTAs per tile of RB batch rows loops over t,
each CTA holding its H/C hidden units' gate columns of ``w_hh`` in shared
memory for the whole chain (or, where they do not fit, as at H=384 and
512, reading them from L2 every step in stages of 32 rows: the streamed
layout) and exchanging hidden state (forward) or
partial hidden gradients (backward) with its peers through distributed
shared memory. The backward sums dW_hh / db_hh with the tiled
fixed-order GEMM of ``csrc/gru_common.cuh``, so its results repeat
bitwise. See the source's header for the design.

The launch plans are decided here, in Python, when a kernel is called:
:func:`gru_plan` (C, RB, shared-memory bytes, grid) mirrors the kernel's
shared-memory layout (:func:`chain_smem_floats`), and :func:`atb_splits`
fixes the weight-gradient GEMM's split of the (t, b) terms; the kernels
check the plan and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from arvae_tpu_torch.ops import _build

_NAME = "gru_chain"

# Kernel launches by the wrapper, one per call of each direction.
LAUNCHES = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the golden model on the card)
# ---------------------------------------------------------------------------


def gru_gates(gi: torch.Tensor, gh: torch.Tensor):
    """(r, z, n) from the input- and hidden-side pre-activations, each
    (..., 3H) in gate order (r, z, n)."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return r, z, n


def gru_chain_reference(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                        h0: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over T (same layout as the kernel)."""
    h = h0
    outs = []
    for t in range(gi.shape[0]):
        gh = torch.bmm(h, w_hh) + b_hh[:, None, :]
        r, z, n = gru_gates(gi[t], gh)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# Launch plans (pure functions of the shapes)
# ---------------------------------------------------------------------------

MAX_SMEM = 227 * 1024  # dynamic shared memory a CTA may use on Hopper
SMS = 132              # streaming multiprocessors of an H100 SXM
THREADS = 512          # threads of a cluster kernel's CTA: one a cell unit
ROWS_PER_THREAD = 4    # a tile's rows are a multiple of it
STREAM_DEPTH = 32      # weight rows a stage of the streamed layout holds
GEMM_TILE, GEMM_DEPTH = 64, 32

# Clusters of C CTAs that an H100 SXM holds at once, by the CTAs an SM
# holds (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 at
# 700 W, arvae_tpu_torch/utils/plan_probe.py): clusters live inside one
# GPC, and the GPCs' SM counts leave some SMs over, so 32 clusters of 4
# CTAs (128 SMs) do not fit at once.
CLUSTERS_HELD = {1: {1: SMS, 2: 66, 4: 30, 8: 15}, 2: {1: 2 * SMS, 2: 132, 4: 62, 8: 30}}
# Registers a thread of each streamed kernel, as ptxas builds them for
# sm_90a (CUDA 12.8; chip_smoke.py's build phase prints them): with 64, two
# CTAs of 512 threads share an SM where their shared memory allows.
STREAMED_REGISTERS = {"gru_fwd": 64, "gru_bwd": 128, "hier_fwd": 128}
SM_SMEM = 228 * 1024     # shared memory of an SM
CTA_RESERVED = 1024      # of it, the runtime's reserve for each CTA
SM_REGISTERS = 65536


def up4(n: int) -> int:
    return (n + 3) & ~3


def slice_ld(n: int) -> int:
    ld = up4(n)
    return ld + 4 if ld % 8 == 0 else ld


def chain_smem_floats(backward: bool, H: int, C: int, RB: int, streamed: bool = False) -> int:
    """Floats of shared memory one CTA of ``gru_chain``'s cluster kernels
    uses: ``chain_layout`` in ``csrc/gru_cluster.cuh``, term for term. The
    resident layout holds the CTA's slice of ``w_hh`` (H rows), the
    streamed one two stages of ``STREAM_DEPTH`` rows."""
    hc = H // C
    n3 = 3 * hc
    ldw, ldh, ldg, ldo = slice_ld(n3), up4(H), up4(n3), up4(hc)
    weight_rows = 2 * STREAM_DEPTH if streamed else H
    total = weight_rows * ldw + ldg + 2 * RB * ldh + RB * ldg + THREADS * 2 * ROWS_PER_THREAD
    if backward:
        total += RB * ldg + RB * ldo + 2 * C * RB * ldo
    return total


@dataclass(frozen=True)
class ChainPlan:
    clusters: int     # C, CTAs a cluster: each owns H / C hidden units
    rows: int         # RB, batch rows a cluster owns
    smem_bytes: int   # dynamic shared memory of one CTA
    grid: Tuple[int, int]
    streamed: bool = False  # weight slices read from L2 in stages, not resident

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def ctas_per_sm(smem_bytes: int, registers: int) -> int:
    """CTAs of 512 threads an SM holds at once, by shared memory and
    registers (at most 2: ``CLUSTERS_HELD``'s rows)."""
    return max(1, min(2, SM_SMEM // (smem_bytes + CTA_RESERVED),
                      SM_REGISTERS // (registers * THREADS)))


def held_clusters(plan: ChainPlan, kernel: str) -> int:
    """Clusters of the plan's size the card holds at once: a resident
    plan's CTA takes more than half an SM; a streamed one's may share it,
    as its shared memory and ``kernel``'s registers allow."""
    per_sm = ctas_per_sm(plan.smem_bytes, STREAMED_REGISTERS[kernel]) if plan.streamed else 1
    return CLUSTERS_HELD[per_sm][plan.clusters]


def plan_waves(plan: ChainPlan, kernel: str) -> int:
    """Rounds of the card the plan's clusters take: ``gru_chain``'s
    resident plans count a CTA an SM, as they were designed; the
    streamed ones count the clusters the card holds at once."""
    if not plan.streamed:
        return -(-plan.ctas // SMS)
    return -(-(plan.ctas // plan.clusters) // held_clusters(plan, kernel))


def best_plan(plans):
    """Of (plan, key) pairs, the plan of the least key; None if none."""
    return min(plans, key=lambda pk: pk[1], default=(None, None))[0]


@functools.lru_cache(maxsize=256)
def gru_plan(D: int, B: int, H: int, backward: bool) -> ChainPlan:
    """The resident layout wherever it fits, else the streamed one; of
    each, the plan that runs in the fewest waves of the card, then with
    the most CTAs in them, then with the fewest CTAs a cluster (the
    fewest peers to exchange with), then the most rows a cluster; clusters
    of 2, 4 or 8 CTAs, a single CTA only where no cluster fits. A CTA's
    threads each own one (row, hidden unit) of its tile. Raises
    ValueError, naming H, when no plan fits 227 KB and 512 threads."""
    for streamed in (False, True):
        plans = []
        for c in (2, 4, 8, 1):
            for rb in (16, 8, 4):
                if H % c or rb * (H // c) > THREADS:
                    continue
                smem = 4 * chain_smem_floats(backward, H, c, rb, streamed)
                if smem > MAX_SMEM:
                    continue
                plan = ChainPlan(c, rb, smem, (c * -(-B // rb), D), streamed)
                waves = plan_waves(plan, "gru_bwd" if backward else "gru_fwd")
                plans.append((plan, (c == 1, waves, -plan.ctas, c, -rb)))
        best = best_plan(plans)
        if best is not None:
            return best
    raise ValueError(f"H={H} is too wide: no cluster of at most 8 CTAs gives a 4-row tile "
                     f"one thread a unit and fits 227 KB of shared memory")


@functools.lru_cache(maxsize=256)
def atb_splits(M: int, bias: bool, N: int, K: int, D: int = 1) -> int:
    """Splits of the K = T·B terms for the weight-gradient GEMM of an
    (M (+1 bias row), N) output over D slices: about four 64x64-tile
    blocks an SM, so that the card's SMs end close together, and at
    least one 32-term K tile a split."""
    tiles = D * -(-(M + int(bias)) // GEMM_TILE) * -(-N // GEMM_TILE)
    return max(1, min(-(-K // GEMM_DEPTH), -(-4 * SMS // tiles)))


def atb_scratch_floats(M: int, bias: bool, N: int, D: int, splits: int) -> int:
    """Floats of the GEMM's partial sums (0 for one split)."""
    return D * splits * (M + int(bias)) * N if splits > 1 else 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_chain_smem_floats.argtypes = [i] * 5
        lib.gru_chain_smem_floats.restype = i
        lib.gru_chain_resident_clusters.argtypes = [i] * 4
        lib.gru_chain_resident_clusters.restype = i
        lib.gru_chain_fwd.argtypes = [p] * 4 + [i] * 8 + [p, p]
        lib.gru_chain_fwd.restype = i
        lib.gru_chain_bwd.argtypes = [p] * 6 + [i] * 9 + [p] * 7
        lib.gru_chain_bwd.restype = i
        _bound = True
    return lib


def _check(named, dev: torch.device) -> None:
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")


def _dims(gi, w_hh, b_hh, h0) -> Tuple[int, int, int, int]:
    if gi.ndim != 4 or gi.shape[-1] % 3:
        raise ValueError(f"gi must be (T, D, B, 3H), got {tuple(gi.shape)}")
    t, d, b, h3 = gi.shape
    h = h3 // 3
    want = {"w_hh": (d, h, h3), "b_hh": (d, h3), "h0": (d, b, h)}
    for name, x in (("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
    if not (1 <= d <= 65535 and t >= 1 and b >= 1 and h >= 1):
        raise ValueError(f"unsupported shape (T={t}, D={d}, B={b}, H={h})")
    return t, d, b, h


def gru_chain_fwd_cuda(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       h0: torch.Tensor, plan: Optional[ChainPlan] = None) -> torch.Tensor:
    """Launches the forward kernel → outs (T, D, B, H). ``plan``: the
    launch plan, :func:`gru_plan`'s by default."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)), gi.device)
    plan = plan or gru_plan(d, b, h, backward=False)
    lib = _library()
    outs = torch.empty((t, d, b, h), dtype=torch.float32, device=gi.device)
    with torch.cuda.device(gi.device):
        err = lib.gru_chain_fwd(gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                h0.data_ptr(), t, d, b, h, plan.clusters, plan.rows,
                                plan.smem_bytes, int(plan.streamed), outs.data_ptr(),
                                _build.stream_of(gi))
    _build.raise_on(lib, _NAME, err, "gru_chain_fwd")
    LAUNCHES["fwd"] += 1
    return outs


def gru_chain_bwd_cuda(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
    outs: torch.Tensor, douts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the backward kernels → (dgi, dw_hh, db_hh, dh0)."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0),
            ("outs", outs), ("douts", douts)), gi.device)
    if outs.shape != (t, d, b, h) or douts.shape != (t, d, b, h):
        raise ValueError(f"outs and douts must be {(t, d, b, h)}")
    plan = gru_plan(d, b, h, backward=True)
    splits = atb_splits(h, True, 3 * h, t * b, d)
    lib = _library()
    dgi = torch.empty_like(gi)
    dh0 = torch.empty_like(h0)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    # scratch: dgh_t, and the partial sums of the dW GEMM
    dgh = torch.empty_like(gi)
    red = torch.empty(max(1, atb_scratch_floats(h, True, 3 * h, d, splits)),
                      dtype=torch.float32, device=gi.device)
    with torch.cuda.device(gi.device):
        err = lib.gru_chain_bwd(gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                h0.data_ptr(), outs.data_ptr(), douts.data_ptr(),
                                t, d, b, h, plan.clusters, plan.rows, plan.smem_bytes,
                                int(plan.streamed), splits, dgi.data_ptr(), dh0.data_ptr(),
                                dw.data_ptr(), db.data_ptr(), dgh.data_ptr(),
                                red.data_ptr(), _build.stream_of(gi))
    _build.raise_on(lib, _NAME, err, "gru_chain_bwd")
    LAUNCHES["bwd"] += 1
    return dgi, dw, db, dh0


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


class GruChainFn(torch.autograd.Function):
    """The recurrence with the kernel backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, h0):
        outs = gru_chain_fwd_cuda(gi, w_hh, b_hh, h0)
        ctx.save_for_backward(gi, w_hh, b_hh, h0, outs)
        return outs

    @staticmethod
    def backward(ctx, douts):
        gi, w_hh, b_hh, h0, outs = ctx.saved_tensors
        return gru_chain_bwd_cuda(gi, w_hh, b_hh, h0, outs, douts.contiguous())


def gru_chain(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """Runs the full T-step recurrence → outs (T, D, B, H): the kernels
    for CUDA tensors, the plain loop for CPU tensors. On a CUDA tensor
    both directions' plans are made first, so a width no plan fits raises
    before any launch."""
    if gi.is_cuda:
        _, d, b, h = _dims(gi, w_hh, b_hh, h0)
        gru_plan(d, b, h, backward=False)
        gru_plan(d, b, h, backward=True)
        return GruChainFn.apply(gi.float().contiguous(), w_hh.float().contiguous(),
                                b_hh.float().contiguous(), h0.float().contiguous())
    return gru_chain_reference(gi, w_hh, b_hh, h0)
