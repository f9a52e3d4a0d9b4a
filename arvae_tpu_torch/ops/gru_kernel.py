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
backwards sum dW_hh / db_hh with the fixed-order 3xTF32 tensor-core
A^T X GEMM of ``csrc/tc_gemm.cuh``, so their results repeat bitwise.
See the sources' headers for the designs. :func:`atb_cuda` launches
that GEMM alone and :func:`rows_cuda` the engine's row product (to hold
them against :func:`atb_reference` and :func:`rows_reference` and time
them; no recurrence calls them).

The launch plans are decided here, in Python, when a kernel is called:
:func:`gru_plan` (a :class:`ChainPlan` of C, RB, shared-memory bytes and
grid, or a :class:`WidePlan` of U, rows a CTA and shared memory) mirrors
the kernels' shared-memory layouts (:func:`chain_smem_floats`,
:func:`wide_smem_floats`), and :func:`atb_tile` and :func:`atb_splits`
fix the weight-gradient GEMM's tile and split of the (t, b) terms
(:func:`tc_smem_bytes` mirrors its shared memory); the kernels check the
plan and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.utils import profiling

_NAME = "gru_chain"

# Kernel launches by the wrapper, one per call of each direction, and of
# them those of the wide layout.
LAUNCHES = {"fwd": 0, "bwd": 0}
WIDE_LAUNCHES = {"fwd": 0, "bwd": 0}
# Launches of the tensor-core GEMM engine (csrc/tc_gemm.cuh): "atb" its
# weight-gradient GEMMs and "rows" its row products, counted by the
# backward wrappers whose C entries launch them (gru_chain's one GEMM a
# call, the tick loop's 2L + 2 GEMMs and 2L + 1 row products), and
# "atb_alone" and "rows_alone" those :func:`atb_cuda` and :func:`rows_cuda`
# launch alone.
GEMM_LAUNCHES = {"atb": 0, "rows": 0, "atb_alone": 0, "rows_alone": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, WIDE_LAUNCHES, GEMM_LAUNCHES):
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

# Clusters of C CTAs that an H100 SXM holds at once, by the CTAs an SM
# holds (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 at
# 700 W; chip_smoke.py's kernels phase prints the card's count beside
# each plan's): clusters live inside one GPC, and the GPCs' SM counts leave some SMs over, so 32 clusters of 4
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
    whole chunks), the backward its U rows (3H terms); then
    ``WIDE_STAGES`` chunks of a pass's rows."""
    def padded(k):
        return -(-k // WIDE_DEPTH) * WIDE_DEPTH + 4

    w = U * padded(3 * H) if backward else 3 * U * padded(H)
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


# The tensor-core GEMM engine (csrc/tc_gemm.cuh): CTAs of TC_THREADS
# threads (8 warps) walk the depth in K tiles of TC_DEPTH terms through
# TC_STAGES shared-memory stages; a CTA's output tile (BM, BN) by name,
# in the order of the source's TcTile.
TC_THREADS, TC_DEPTH, TC_STAGES = 256, 32, 3
# CTAs of the engine an SM holds at once (its kernels' launch bounds; the
# shared memory of two fits an SM's 228 KB)
TC_CTAS_AN_SM = 2
TC_TILES = {"big": (128, 128), "narrow_m": (16, 128), "narrow_n": (128, 16), "mid": (64, 64)}
# Operand tiles of each form: whether A's and B's are held term-major
# ([k][c]), else row by row ([c][k]): A^T X, A W, A W^T.
TC_FORMS = {"atb": (True, True), "a_w": (False, True), "a_wt": (False, False)}
# A split of a weight-gradient GEMM sums at least ATB_MIN_TERMS terms (2 K
# tiles, so that the ring's prologue is a small share), and at most
# ATB_MAX_TERMS.
ATB_MIN_TERMS, ATB_MAX_TERMS = 64, 1024


def atb_tile(M: int, N: int) -> str:
    """The tile of an (M, N) weight gradient: 128 x 16 for at most 16
    columns, 16 x 128 for at most 16 rows, else 128 x 128 (``tc_tile`` in
    the source)."""
    return "narrow_n" if N <= 16 else "narrow_m" if M <= 16 else "big"


def row_tile(M: int, N: int) -> str:
    """The tile of an M-row, N-column row product (``tc_row_tile`` in the
    source): 128 x 16 for at most 16 columns, 64 x 64 where 128 x 128 tiles
    would be fewer than the card's SMs (the products at H=128), else 128 x
    128."""
    if N <= 16:
        return "narrow_n"
    return "mid" if -(-M // 128) * -(-N // 128) < SMS else "big"


def tc_smem_bytes(form: str, tile: str) -> int:
    """Dynamic shared memory of one CTA of the engine: ``tc_smem_bytes``
    in the source, term for term: TC_STAGES stages of an A tile (BM
    columns) and a B tile (BN), a term-major tile TC_DEPTH x (width + 8)
    floats, a row-major one width x (TC_DEPTH + 4)."""
    bm, bn = TC_TILES[tile]

    def floats(term_major, width):
        return TC_DEPTH * (width + 8) if term_major else width * (TC_DEPTH + 4)

    a, b = TC_FORMS[form]
    return 4 * TC_STAGES * (floats(a, bm) + floats(b, bn))


@functools.lru_cache(maxsize=256)
def atb_splits(M: int, N: int, K: int, D: int = 1) -> int:
    """Splits of the K = T·B terms for the weight-gradient GEMM of an
    (M, N) output over D slices (the bias, when there is one, is summed
    from the X tiles and takes no tile): of the split counts that give
    each split between ``ATB_MIN_TERMS`` and ``ATB_MAX_TERMS`` terms (as
    near as K allows), the fewest whose waves of the card
    (``TC_CTAS_AN_SM`` CTAs an SM) a unit of work are within 10% of the
    least: so that the SMs end close together, with the fewest partial
    sums to add."""
    bm, bn = TC_TILES[atb_tile(M, N)]
    tiles = D * -(-M // bm) * -(-N // bn)
    lo = -(-K // ATB_MAX_TERMS)
    # every split holds terms (the chunks are whole K tiles)
    counts = [s for s in range(lo, max(lo, -(-K // ATB_MIN_TERMS)) + 1)
              if (s - 1) * atb_chunk(K, s) < K] or [1]

    def waves_a_split(s):
        return -(-tiles * s // (SMS * TC_CTAS_AN_SM)) / s

    best = min(waves_a_split(s) for s in counts)
    return next(s for s in counts if waves_a_split(s) <= 1.1 * best)


def atb_chunk(K: int, splits: int) -> int:
    """Terms each split of the GEMM sums, the last the rest: whole K tiles
    (``gemm_chunk`` in the source)."""
    return -(-(-(-K // splits)) // TC_DEPTH) * TC_DEPTH


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
        lib.gru_chain_wide_bwd.argtypes = [p] * 6 + [i] * 8 + [p] * 8
        lib.gru_chain_wide_bwd.restype = i
        lib.gru_chain_atb.argtypes = [p, p, p, i, i, p] + [i] * 5 + [p] * 4
        lib.gru_chain_atb.restype = i
        lib.gru_chain_rows.argtypes = [p, i, p] + [i] * 5 + [p, p]
        lib.gru_chain_rows.restype = i
        lib.gru_chain_tc_smem_bytes.argtypes = [i, i]
        lib.gru_chain_tc_smem_bytes.restype = i
        lib.gru_chain_atb_ctas_an_sm.argtypes = [i]
        lib.gru_chain_atb_ctas_an_sm.restype = i
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


def fwd_plan(D: int, B: int, H: int, keep_gh: bool = False):
    """The forward's plan: :func:`gru_plan`'s, except where the forward
    keeps ``gh`` for a backward that runs the wide layout while a cluster
    holds only the forward's slices (H=252, 360): there the wide one, so
    that the wide backward reads the gh it keeps."""
    plan = gru_plan(D, B, H, False)
    if keep_gh and not isinstance(plan, WidePlan) \
            and isinstance(gru_plan(D, B, H, True), WidePlan):
        return wide_plan(D, B, H, False)
    return plan


@profiling.spanned("op:gru_chain.fwd")
def gru_chain_fwd_cuda(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       h0: torch.Tensor, plan=None, keep_gh: bool = False):
    """Launches the forward kernel → outs (T, D, B, H). ``plan``: the
    launch plan, :func:`fwd_plan`'s by default. With ``keep_gh`` →
    (outs, gh): the wide layout's hidden-side pre-activations
    h_{t-1} w_hh + b_hh (T, D, B, 3H), which its backward reads, None for
    the resident layout (whose backward recomputes them step by step)."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)), gi.device)
    plan = plan or fwd_plan(d, b, h, keep_gh)
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


@profiling.spanned("op:gru_chain.bwd")
def gru_chain_bwd_cuda(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
    outs: torch.Tensor, douts: torch.Tensor, gh: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the backward kernels → (dgi, dw_hh, db_hh, dh0). ``gh``:
    the pre-activations the forward kept (``keep_gh``), which the wide
    backward reads and the resident one does not take."""
    t, d, b, h = _dims(gi, w_hh, b_hh, h0)
    _check((("gi", gi), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0),
            ("outs", outs), ("douts", douts)), gi.device)
    if outs.shape != (t, d, b, h) or douts.shape != (t, d, b, h):
        raise ValueError(f"outs and douts must be {(t, d, b, h)}")
    plan = gru_plan(d, b, h, backward=True)
    wide = isinstance(plan, WidePlan)
    if wide != (gh is not None):
        raise ValueError(f"H={h}: the {'wide' if wide else 'resident'} backward "
                         f"{'reads' if wide else 'takes no'} gh (the forward's keep_gh)")
    if gh is not None:
        _check((("gh", gh),), gi.device)
        if gh.shape != gi.shape:
            raise ValueError(f"gh is the wide layout's (T, D, B, 3H) = {tuple(gi.shape)}")
    splits = atb_splits(h, 3 * h, t * b, d)
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
            err = lib.gru_chain_wide_bwd(
                gi.data_ptr(), gh.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), outs.data_ptr(),
                douts.data_ptr(), t, d, b, h,
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
    GEMM_LAUNCHES["atb"] += 1
    return dgi, dw, db, dh0


# ---------------------------------------------------------------------------
# The weight-gradient GEMM alone
# ---------------------------------------------------------------------------


def atb_operand(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                a0: Optional[torch.Tensor] = None, tokens: Optional[torch.Tensor] = None,
                tok_shift: int = 0, M: Optional[int] = None) -> torch.Tensor:
    """The A operand (T, D, B, M) of :func:`atb_reference` in full: ``a``
    itself; with ``a0`` (D, B, M) the state one step back (``a0`` at t = 0,
    ``a[t - 1]`` after); with ``tokens`` the one-hot (M columns) of token
    ``tokens[s - tok_shift]`` at term s = t·B + b (none for the first
    ``tok_shift`` terms and for a token of -1)."""
    T, D, B, _ = x.shape
    if tokens is not None:
        tok = torch.full((T * B,), -1, dtype=torch.long, device=x.device)
        tok[tok_shift:] = tokens.reshape(-1)[:T * B - tok_shift].long()
        hot = tok[:, None] == torch.arange(M, device=x.device)
        return hot.to(x.dtype).reshape(T, D, B, M)
    if a0 is not None:
        return torch.cat([a0[None], a[:-1]])
    return a


def atb_reference(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                  a0: Optional[torch.Tensor] = None, tokens: Optional[torch.Tensor] = None,
                  tok_shift: int = 0, M: Optional[int] = None, bias: bool = False):
    """Plain version of the weight-gradient GEMM: x (T, D, B, N) and the
    A operand (:func:`atb_operand`) → (out (D, M, N) = sum over (t, b) of
    A^T x, the bias (D, N) = sum over (t, b) of x, or None)."""
    A = atb_operand(x, a, a0, tokens, tok_shift, M)
    out = torch.einsum("tdbm,tdbn->dmn", A, x)
    return out, (x.sum((0, 2)) if bias else None)


@profiling.spanned("op:gemm.atb")
def atb_cuda(x: torch.Tensor, a: Optional[torch.Tensor] = None,
             a0: Optional[torch.Tensor] = None, tokens: Optional[torch.Tensor] = None,
             tok_shift: int = 0, M: Optional[int] = None, bias: bool = False):
    """Launches the engine's A^T X GEMM alone on the operands of
    :func:`atb_reference` (float32 on one card, contiguous; tokens int32,
    D = 1), in :func:`atb_splits`'s splits → (out, bias or None)."""
    if x.ndim != 4:
        raise ValueError(f"x must be (T, D, B, N), got {tuple(x.shape)}")
    T, D, B, N = x.shape
    if (a is None) == (tokens is None):
        raise ValueError("give exactly one of a (with or without a0) and tokens")
    named = [("x", x)] + [(n, v) for n, v in (("a", a), ("a0", a0)) if v is not None]
    _check(named, x.device)
    if tokens is not None:
        if D != 1 or M is None or tokens.dtype != torch.int32 or not tokens.is_contiguous() \
                or tokens.device != x.device or tokens.numel() < T * B - tok_shift:
            raise ValueError("tokens: contiguous int32 on x's card, T·B - tok_shift of them, "
                             "with M and D = 1")
    else:
        M = a.shape[-1]
        if a.shape != (T, D, B, M) or (a0 is not None and a0.shape != (D, B, M)):
            raise ValueError(f"a must be (T, D, B, M) = {(T, D, B, M)}, a0 (D, B, M)")
    splits = atb_splits(M, N, T * B, D)
    lib = _library()
    out = torch.empty((D, M, N), dtype=torch.float32, device=x.device)
    db = torch.empty((D, N), dtype=torch.float32, device=x.device) if bias else None
    red = torch.empty(max(1, atb_scratch_floats(M, bias, N, D, splits)), dtype=torch.float32,
                      device=x.device)
    ptr = (lambda v: None if v is None else v.data_ptr())
    with torch.cuda.device(x.device):
        err = lib.gru_chain_atb(ptr(a), ptr(a0), ptr(tokens), tok_shift, M, x.data_ptr(), N,
                                T, D, B, splits, out.data_ptr(), ptr(db), red.data_ptr(),
                                _build.stream_of(x))
    _build.raise_on(lib, _NAME, err, "gru_chain_atb")
    GEMM_LAUNCHES["atb_alone"] += 1
    return out, db


def rows_reference(a: torch.Tensor, w: torch.Tensor, trans: bool) -> torch.Tensor:
    """Plain version of the engine's row product: a (M, K) times w (K, N),
    or with ``trans`` times w^T (w (N, K))."""
    return a @ (w.T if trans else w)


@profiling.spanned("op:gemm.rows")
def rows_cuda(a: torch.Tensor, w: torch.Tensor, trans: bool) -> torch.Tensor:
    """Launches the engine's row product alone (the tick loop's backward
    runs it with its own epilogues) → :func:`rows_reference`'s (M, N)."""
    _check((("a", a), ("w", w)), a.device)
    if a.ndim != 2 or w.ndim != 2 or (w.shape[1] if trans else w.shape[0]) != a.shape[1]:
        raise ValueError(f"a (M, K) and w ({'(N, K)' if trans else '(K, N)'}) do not chain: "
                         f"{tuple(a.shape)}, {tuple(w.shape)}")
    (M, K), N = a.shape, w.shape[0] if trans else w.shape[1]
    lib = _library()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.gru_chain_rows(a.data_ptr(), K, w.data_ptr(), w.shape[1], M, K, N, int(trans),
                                 out.data_ptr(), _build.stream_of(a))
    _build.raise_on(lib, _NAME, err, "gru_chain_rows")
    GEMM_LAUNCHES["rows_alone"] += 1
    return out


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs: grad mode on and
    one of them requiring a gradient. (Inside an autograd Function's
    forward grad mode is off, and ``ctx.needs_input_grad`` holds under
    ``no_grad`` too, so the caller decides.)"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class GruChainFn(torch.autograd.Function):
    """The recurrence with the kernel backward (CUDA tensors only). With
    ``keep_gh`` (the caller records a gradient) the wide layout's forward
    keeps ``gh`` for the backward."""

    @staticmethod
    def forward(ctx, keep_gh, gi, w_hh, b_hh, h0):
        out = gru_chain_fwd_cuda(gi, w_hh, b_hh, h0, keep_gh=keep_gh)
        outs, gh = out if keep_gh else (out, None)
        ctx.save_for_backward(gi, w_hh, b_hh, h0, outs, gh)
        return outs

    @staticmethod
    def backward(ctx, douts):
        gi, w_hh, b_hh, h0, outs, gh = ctx.saved_tensors
        return (None, *gru_chain_bwd_cuda(gi, w_hh, b_hh, h0, outs, douts.contiguous(), gh))


def gru_chain(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """Runs the full T-step recurrence → outs (T, D, B, H): the kernels
    for CUDA tensors, the plain loop for CPU tensors. On a CUDA tensor
    both directions' plans are made first, so a width no plan fits raises
    before any launch; the forward keeps ``gh`` only where autograd
    records the call (:func:`records_grad`), on the wide layout wherever
    the backward runs it (:func:`fwd_plan`)."""
    if gi.is_cuda:
        _, d, b, h = _dims(gi, w_hh, b_hh, h0)
        gru_plan(d, b, h, backward=False)
        gru_plan(d, b, h, backward=True)
        return GruChainFn.apply(records_grad(gi, w_hh, b_hh, h0), gi.float().contiguous(),
                                w_hh.float().contiguous(), b_hh.float().contiguous(),
                                h0.float().contiguous())
    return gru_chain_reference(gi, w_hh, b_hh, h0)
