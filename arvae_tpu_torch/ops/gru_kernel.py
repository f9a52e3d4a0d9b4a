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
layout (a width whose w_hh slices no plan holds) it raises before any
launch. On a CPU tensor it runs :func:`gru_chain_reference`, a Python
loop over T whose backward is autograd through the loop. There is no
fallback from one to the other.

What bounds it on the card: a T-long chain of dependent
(rows x H) @ (H x 3H) products, small enough that latency, not bytes or
arithmetic, sets the time at the music step's H=128. The kernel runs the
whole chain in one launch. In the resident layout a thread-block
cluster of C CTAs per tile of RB batch rows loops over t, each CTA
holding its H/C hidden units' gate columns of ``w_hh`` in shared memory
for the whole chain and exchanging hidden state (forward) or partial
hidden gradients (backward) with its peers through distributed shared
memory. Where those slices do not fit (H=384 and 512, the reference's
width), the wide layout (``csrc/gru_wide.cuh``) runs one cooperative
wave of CTAs, each keeping a U-unit slice of ``w_hh`` in shared memory
for the whole call and multiplying on the tensor cores in 3xTF32 (about
fp32's accuracy), with a grid barrier a step; its forward keeps the hidden-side
pre-activations ``gh`` for its backward when the caller trains. Both
backwards sum dW_hh / db_hh with the tiled fixed-order GEMM of
``csrc/gru_common.cuh``, so their results repeat bitwise. See the
sources' headers for the designs.

The launch plans are decided here, in Python, when a kernel is called:
:func:`gru_plan` (a :class:`ChainPlan` of C, RB, shared-memory bytes and
grid, or a :class:`WidePlan` of U, rows a CTA and shared memory) mirrors
the kernels' shared-memory layouts (:func:`chain_smem_floats`,
:func:`wide_smem_floats`), and :func:`atb_splits` fixes the
weight-gradient GEMM's split of the (t, b) terms; the kernels check the
plan and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from arvae_tpu_torch.ops import _build

_NAME = "gru_chain"

# Kernel launches by the wrapper, one per call of each direction, and of
# them those of the wide layout.
LAUNCHES = {"fwd": 0, "bwd": 0}
WIDE_LAUNCHES = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, WIDE_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
GEMM_TILE, GEMM_DEPTH = 64, 32

# Clusters of C CTAs that an H100 SXM holds at once, by the CTAs an SM
# holds (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 at
# 700 W, arvae_tpu_torch/utils/plan_probe.py): clusters live inside one
# GPC, and the GPCs' SM counts leave some SMs over, so 32 clusters of 4
# CTAs (128 SMs) do not fit at once.
CLUSTERS_HELD = {1: {1: SMS, 2: 66, 4: 30, 8: 15}, 2: {1: 2 * SMS, 2: 132, 4: 62, 8: 30}}
SM_SMEM = 228 * 1024     # shared memory of an SM
CTA_RESERVED = 1024      # of it, the runtime's reserve for each CTA

# The wide layout (csrc/gru_wide.cuh): CTAs of WIDE_THREADS threads (8
# warps), each warp a 16-row x 16-unit tile of 3xTF32 tensor-core
# products; U units a CTA, so a pass of 2048 / U rows; operands streamed
# in chunks of WIDE_DEPTH terms through WIDE_STAGES buffers. Every plan
# is one CTA an SM, one wave.
WIDE_THREADS = 256
WIDE_WARP_TILE = (16, 16)
WIDE_DEPTH = 32
WIDE_STAGES = 3
WIDE_UNITS = (32, 16)


def up4(n: int) -> int:
    return (n + 3) & ~3


def slice_ld(n: int) -> int:
    ld = up4(n)
    return ld + 4 if ld % 8 == 0 else ld


def chain_smem_floats(backward: bool, H: int, C: int, RB: int) -> int:
    """Floats of shared memory one CTA of ``gru_chain``'s cluster kernels
    uses: ``chain_layout`` in ``csrc/gru_cluster.cuh``, term for term: the
    CTA's slice of ``w_hh`` (H rows), resident."""
    hc = H // C
    n3 = 3 * hc
    ldw, ldh, ldg, ldo = slice_ld(n3), up4(H), up4(n3), up4(hc)
    total = H * ldw + ldg + 2 * RB * ldh + RB * ldg + THREADS * 2 * ROWS_PER_THREAD
    if backward:
        total += RB * ldg + RB * ldo + 2 * C * RB * ldo
    return total


def wide_pass_rows(U: int) -> int:
    """Batch rows a CTA of the wide layout multiplies at once (a pass)."""
    rows, units = WIDE_WARP_TILE
    return rows * (WIDE_THREADS // 32) * units // U


def wide_smem_floats(backward: bool, H: int, U: int) -> int:
    """Floats of shared memory one CTA of the wide layout uses:
    ``wide_layout`` in ``csrc/gru_wide.cuh``, term for term. The forward
    holds the CTA's 3U gate columns of ``w_hh`` (H terms each, padded to
    whole chunks), the backward its U rows (3H terms) or, to recompute
    ``gh`` first, the forward's slice, whichever is larger; then
    ``WIDE_STAGES`` chunks of a pass's rows."""
    def padded(k):
        return -(-k // WIDE_DEPTH) * WIDE_DEPTH + 4

    w = 3 * U * padded(H)
    if backward:
        w = max(w, U * padded(3 * H))
    return w + WIDE_STAGES * wide_pass_rows(U) * (WIDE_DEPTH + 4)


@dataclass(frozen=True)
class ChainPlan:
    clusters: int     # C, CTAs a cluster: each owns H / C hidden units
    rows: int         # RB, batch rows a cluster owns
    smem_bytes: int   # dynamic shared memory of one CTA
    grid: Tuple[int, int]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


@dataclass(frozen=True)
class WidePlan:
    """The wide layout's launch: CTA (d, g, q) owns hidden units
    [g U, (g + 1) U) of direction d for batch rows [q rows, (q + 1) rows),
    which it multiplies in ``passes`` passes of ``pass_rows``."""
    units: int        # U, hidden units a CTA owns (3U gate columns of w_hh)
    rows: int         # batch rows a CTA owns
    smem_bytes: int   # dynamic shared memory of one CTA
    ctas: int         # D * ceil(H / U) * ceil(B / rows), all on the card at once

    @property
    def pass_rows(self) -> int:
        return wide_pass_rows(self.units)

    @property
    def passes(self) -> int:
        return -(-self.rows // self.pass_rows)


def best_plan(plans):
    """Of (plan, key) pairs, the plan of the least key; None if none."""
    return min(plans, key=lambda pk: pk[1], default=(None, None))[0]


# Rows of a wide plan's row group at least: one m16 tile of the products.
WIDE_MIN_ROWS = 16


def wide_plan(D: int, B: int, H: int, backward: bool) -> Optional[WidePlan]:
    """The wide layout's plan, or None where none fits: of U in
    ``WIDE_UNITS`` whose CTA fits 227 KB, as many row groups as keep every
    CTA on the card at once (one CTA an SM: ``SMS``; more row groups cost
    no operand traffic and leave each CTA fewer rows), then the plan of
    the fewest passes a step (each pass is the same work), then the least
    operand traffic a step (D·B·H floats for each of the ceil(H / U)
    unit groups: the most units a CTA)."""
    plans = []
    for u in WIDE_UNITS:
        smem = 4 * wide_smem_floats(backward, H, u)
        groups = D * -(-H // u)
        if smem > MAX_SMEM or groups > SMS:
            continue
        row_groups = min(-(-B // WIDE_MIN_ROWS), SMS // groups)
        rows = -(-B // row_groups)
        plan = WidePlan(u, rows, smem, groups * -(-B // rows))
        plans.append((plan, (plan.passes, -u)))
    return best_plan(plans)


@functools.lru_cache(maxsize=256)
def gru_plan(D: int, B: int, H: int, backward: bool):
    """The resident layout wherever it fits, else the wide one. Resident:
    the plan that runs in the fewest waves of the card (a CTA an SM),
    then with the most CTAs in them, then with the fewest CTAs a cluster
    (the fewest peers to exchange with), then the most rows a cluster;
    clusters of 2, 4 or 8 CTAs, a single CTA only where no cluster fits;
    a CTA's threads each own one (row, hidden unit) of its tile. Wide:
    :func:`wide_plan`. Raises ValueError, naming H, when no plan fits
    227 KB and one wave."""
    plans = []
    for c in (2, 4, 8, 1):
        for rb in (16, 8, 4):
            if H % c or rb * (H // c) > THREADS:
                continue
            smem = 4 * chain_smem_floats(backward, H, c, rb)
            if smem > MAX_SMEM:
                continue
            plan = ChainPlan(c, rb, smem, (c * -(-B // rb), D))
            waves = -(-plan.ctas // SMS)
            plans.append((plan, (c == 1, waves, -plan.ctas, c, -rb)))
    best = best_plan(plans) or wide_plan(D, B, H, backward)
    if best is None:
        raise ValueError(f"H={H} is too wide: neither a cluster of at most 8 CTAs nor a wave "
                         f"of CTAs of {WIDE_UNITS} units holds its slices of w_hh in 227 KB "
                         f"of shared memory")
    return best


@functools.lru_cache(maxsize=256)
def atb_splits(M: int, bias: bool, N: int, K: int, D: int = 1) -> int:
    """Splits of the K = T·B terms for the weight-gradient GEMM of an
    (M (+1 bias row), N) output over D slices: about four 64x64-tile
    blocks an SM, so that the card's SMs end close together, and at
    least one 32-term K tile a split."""
    tiles = D * -(-(M + int(bias)) // GEMM_TILE) * -(-N // GEMM_TILE)
    return max(1, min(-(-K // GEMM_DEPTH), -(-4 * SMS // tiles)))


# The wide layout's weight-gradient GEMMs sum at most this many (t, b)
# terms a split: at (24, 2, 256, 512) two splits of 3,072 terms took the
# GEMM 912 µs, six of 1,024 754 µs (utils/wide_probe.py --atb-splits on
# an NVIDIA H100 80GB HBM3 at 700 W).
WIDE_ATB_TERMS = 1024


def wide_atb_splits(M: int, bias: bool, N: int, K: int, D: int = 1) -> int:
    """:func:`atb_splits` for the wide layout's GEMMs: at least
    K / ``WIDE_ATB_TERMS`` splits."""
    return max(atb_splits(M, bias, N, K, D), -(-K // WIDE_ATB_TERMS))


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
        lib.gru_chain_smem_floats.argtypes = [i] * 4
        lib.gru_chain_smem_floats.restype = i
        lib.gru_chain_resident_clusters.argtypes = [i] * 3
        lib.gru_chain_resident_clusters.restype = i
        lib.gru_chain_wide_smem_floats.argtypes = [i] * 3
        lib.gru_chain_wide_smem_floats.restype = i
        lib.gru_chain_wide_resident_ctas.argtypes = [i] * 3
        lib.gru_chain_wide_resident_ctas.restype = i
        lib.gru_chain_fwd.argtypes = [p] * 4 + [i] * 7 + [p, p]
        lib.gru_chain_fwd.restype = i
        lib.gru_chain_bwd.argtypes = [p] * 6 + [i] * 8 + [p] * 7
        lib.gru_chain_bwd.restype = i
        lib.gru_chain_wide_fwd.argtypes = [p] * 4 + [i] * 7 + [p] * 4
        lib.gru_chain_wide_fwd.restype = i
        lib.gru_chain_wide_bwd.argtypes = [p, p, i] + [p] * 5 + [i] * 8 + [p] * 8
        lib.gru_chain_wide_bwd.restype = i
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


def _barrier(dev: torch.device) -> torch.Tensor:
    """Scratch for the wide layout's grid barrier (zeroed by the entry)."""
    return torch.empty(1, dtype=torch.int32, device=dev)


def gru_chain_fwd_cuda(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       h0: torch.Tensor, plan=None, keep_gh: bool = False):
    """Launches the forward kernel → outs (T, D, B, H). ``plan``: the
    launch plan, :func:`gru_plan`'s by default. With ``keep_gh`` →
    (outs, gh): the wide layout's hidden-side pre-activations
    h_{t-1} w_hh + b_hh (T, D, B, 3H) for its backward, None for the
    resident layout (whose backward recomputes them)."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)), gi.device)
    plan = plan or gru_plan(d, b, h, backward=False)
    wide = isinstance(plan, WidePlan)
    lib = _library()
    outs = torch.empty((t, d, b, h), dtype=torch.float32, device=gi.device)
    gh = torch.empty_like(gi) if wide and keep_gh else None
    with torch.cuda.device(gi.device):
        if wide:
            err = lib.gru_chain_wide_fwd(
                gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), t, d, b, h,
                plan.units, plan.rows, plan.smem_bytes, outs.data_ptr(),
                None if gh is None else gh.data_ptr(), _barrier(gi.device).data_ptr(),
                _build.stream_of(gi))
        else:
            err = lib.gru_chain_fwd(gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                    h0.data_ptr(), t, d, b, h, plan.clusters, plan.rows,
                                    plan.smem_bytes, outs.data_ptr(), _build.stream_of(gi))
    _build.raise_on(lib, _NAME, err, "gru_chain_fwd")
    LAUNCHES["fwd"] += 1
    WIDE_LAUNCHES["fwd"] += int(wide)
    return (outs, gh) if keep_gh else outs


def gru_chain_bwd_cuda(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
    outs: torch.Tensor, douts: torch.Tensor, gh: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the backward kernels → (dgi, dw_hh, db_hh, dh0). ``gh``:
    the wide forward's kept pre-activations; without them the wide
    backward recomputes them for all steps at once before its chain."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0),
            ("outs", outs), ("douts", douts)), gi.device)
    if outs.shape != (t, d, b, h) or douts.shape != (t, d, b, h):
        raise ValueError(f"outs and douts must be {(t, d, b, h)}")
    plan = gru_plan(d, b, h, backward=True)
    wide = isinstance(plan, WidePlan)
    if gh is not None:
        _check((("gh", gh),), gi.device)
        if not wide or gh.shape != gi.shape:
            raise ValueError(f"gh is the wide layout's (T, D, B, 3H) = {tuple(gi.shape)}")
    splits = (wide_atb_splits if wide else atb_splits)(h, True, 3 * h, t * b, d)
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
        if wide:
            recompute = gh is None
            if recompute:
                gh = torch.empty_like(gi)
            err = lib.gru_chain_wide_bwd(
                gi.data_ptr(), gh.data_ptr(), int(recompute), w_hh.data_ptr(),
                b_hh.data_ptr(), h0.data_ptr(), outs.data_ptr(), douts.data_ptr(), t, d, b, h,
                plan.units, plan.rows, plan.smem_bytes, splits, dgi.data_ptr(), dh0.data_ptr(),
                dw.data_ptr(), db.data_ptr(), dgh.data_ptr(), red.data_ptr(),
                _barrier(gi.device).data_ptr(), _build.stream_of(gi))
        else:
            err = lib.gru_chain_bwd(gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                    h0.data_ptr(), outs.data_ptr(), douts.data_ptr(),
                                    t, d, b, h, plan.clusters, plan.rows, plan.smem_bytes,
                                    splits, dgi.data_ptr(), dh0.data_ptr(), dw.data_ptr(),
                                    db.data_ptr(), dgh.data_ptr(), red.data_ptr(),
                                    _build.stream_of(gi))
    _build.raise_on(lib, _NAME, err, "gru_chain_bwd")
    LAUNCHES["bwd"] += 1
    WIDE_LAUNCHES["bwd"] += int(wide)
    return dgi, dw, db, dh0


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


class GruChainFn(torch.autograd.Function):
    """The recurrence with the kernel backward (CUDA tensors only). The
    wide layout's forward keeps ``gh`` for the backward when an input
    needs a gradient."""

    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, h0):
        if any(ctx.needs_input_grad):
            outs, gh = gru_chain_fwd_cuda(gi, w_hh, b_hh, h0, keep_gh=True)
        else:
            outs, gh = gru_chain_fwd_cuda(gi, w_hh, b_hh, h0), None
        ctx.save_for_backward(gi, w_hh, b_hh, h0, outs, gh)
        return outs

    @staticmethod
    def backward(ctx, douts):
        gi, w_hh, b_hh, h0, outs, gh = ctx.saved_tensors
        return gru_chain_bwd_cuda(gi, w_hh, b_hh, h0, outs, douts.contiguous(), gh)


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
