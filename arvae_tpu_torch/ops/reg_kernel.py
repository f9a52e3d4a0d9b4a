"""AR pairwise regulariser: hand-written CUDA kernel pair + plain versions.

Replaces the Pallas TPU kernel ``arvae_tpu/ops/reg_pallas.py::fused_reg_loss``.
Per regularised dim r, over the latent column z = z_tilde[:, zc_r] and
the attribute column a = labels[:, ac_r] of a batch of B::

    loss_r = 1/B² Σ_ij | tanh(δ(z_i − z_j)) − sign(a_i − a_j) |

The cotangent of a per-dim loss is one scalar ct_r, so the forward also
computes, from the same t = tanh(δ(z_i − z_j)) and s = sign(a_i − a_j),
the factors the gradient needs::

    G[r, i] = 2δ/B² Σ_j sign(t − s)(1 − t²)
    D[r]    = 1/B² Σ_ij sign(t − s)(1 − t²)(z_i − z_j)

and the backward is a scale: dz_tilde[:, zc_r] += ct_r G[r, :] (r
ascending, so a column named twice gets the sum), dδ = Σ_r ct_r D[r].

:func:`reg_losses` is the entry the trainers call (through
``ops/losses.py::total_reg_loss``): it reads the columns of ``z_tilde``
(B, Z) and ``labels`` (B, L) in place through their strides, and its
backward writes the whole (B, Z) gradient of ``z_tilde``.
:func:`fused_reg_loss` keeps the Pallas kernel's (R, B) signature and
runs the same kernels on the stacked columns' transposed view.

On a CUDA tensor the autograd Function launches ``csrc/reg_loss.cu``'s
forward (one launch; the factors only when a gradient is wanted) and its
backward (one launch), or raises; on a CPU tensor it runs the same
decomposition through the plain PyTorch versions below. There is no
fallback from one to the other. Without a gradient (the trainers' eval
steps run under ``torch.no_grad()``) the forward skips the factors.

What bounds it on the card: at the training shapes a call is 82k-262k
pairs over a few kilobytes, so it is launch-bound. The forward spreads
the pairs over a thread-block cluster a dim (:func:`reg_plan`), adds
partial sums in a fixed order through distributed shared memory, and
needs no scratch buffer or second launch; results repeat bitwise. The
wrappers allocate only their outputs, sync nothing and keep no host
state between the two launches, so a CUDA graph could capture them.

The library is built on first use by ``ops/_build.py`` (``nvcc`` for
``sm_90a``, bound with ``ctypes``); importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.ops.hier_decoder_kernel import RESIDENT_CLUSTERS
from arvae_tpu_torch.utils import profiling

# Kernel launches by the wrappers, one per forward and one per backward.
LAUNCHES = {"fwd": 0, "bwd": 0}

MAX_DIMS = 32        # regularised dims a call: the kernel takes their columns by value
THREADS, MAX_THREADS = 256, 1024

Dims = Tuple[Tuple[int, int], ...]  # (latent column, attribute column) a dim


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the golden model on the card)
# ---------------------------------------------------------------------------


def reg_loss_fwd_reference(z: torch.Tensor, a: torch.Tensor,
                           delta: torch.Tensor | float) -> torch.Tensor:
    """(R, B) z, a → (R,) per-dim losses, through B×B matrices."""
    z = z.float()
    a = a.float()
    dz = z[:, :, None] - z[:, None, :]
    da = a[:, :, None] - a[:, None, :]
    b = z.shape[1]
    return torch.abs(torch.tanh(delta * dz) - torch.sign(da)).sum(dim=(1, 2)) / (b * b)


def reg_loss_bwd_reference(
    z: torch.Tensor, a: torch.Tensor, delta: torch.Tensor | float,
    ct: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dz (R, B), ddelta ()) for cotangent ct (R,), written out with the
    antisymmetry g_ji = −g_ij: dz_i = 2 ct/B² Σ_j sign(t−s)(1−t²)δ."""
    z = z.float()
    a = a.float()
    b = z.shape[1]
    d = z[:, :, None] - z[:, None, :]
    t = torch.tanh(delta * d)
    s = torch.sign(a[:, :, None] - a[:, None, :])
    core = torch.sign(t - s) * (1.0 - t * t)
    scale = ct / (b * b)
    dz = 2.0 * (core * delta).sum(dim=2) * scale[:, None]
    ddelta = torch.sum(scale * (core * d).sum(dim=(1, 2)))
    return dz, ddelta


def reg_fwd_factors_reference(
    z: torch.Tensor, a: torch.Tensor, delta: torch.Tensor | float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, B) z, a → (loss (R,), G (R, B), D (R,)) through B×B matrices;
    the loss is computed as :func:`reg_loss_fwd_reference` computes it."""
    z = z.float()
    a = a.float()
    b = z.shape[1]
    d = z[:, :, None] - z[:, None, :]
    t = torch.tanh(delta * d)
    e = t - torch.sign(a[:, :, None] - a[:, None, :])
    core = torch.sign(e) * (1.0 - t * t)
    loss = torch.abs(e).sum(dim=(1, 2)) / (b * b)
    g = 2.0 * delta * core.sum(dim=2) / (b * b)
    return loss, g, (core * d).sum(dim=(1, 2)) / (b * b)


def reg_bwd_scale_reference(g: torch.Tensor, d: torch.Tensor,
                            ct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dz (R, B), ddelta ()) = (ct_r G[r, :], Σ_r ct_r D[r])."""
    return ct[:, None] * g, torch.sum(ct * d)


def stack_columns(z: torch.Tensor, labels: torch.Tensor,
                  dims: Dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, B) latent and attribute columns that ``dims`` names."""
    return (torch.stack([z[:, c] for c, _ in dims]),
            torch.stack([labels[:, c] for _, c in dims]))


def scatter_columns(dz: torch.Tensor, dims: Dims, z_dims: int) -> torch.Tensor:
    """(R, B) column gradients → the (B, Z) gradient: zero in the columns
    no dim names, the sum over r (ascending) in a column named twice."""
    out = dz.new_zeros((dz.shape[1], z_dims))
    for r, (c, _) in enumerate(dims):
        out[:, c] += dz[r]
    return out


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RegPlan:
    clusters: int   # C, CTAs a cluster; one cluster a regularised dim
    rows: int       # RB, rows i a CTA owns
    slices: int     # S, threads a row: each walks every S-th column j
    threads: int    # a power of two, a multiple of S
    grid: Tuple[int, int]  # (C, R)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def waves(self) -> int:
        return -(-self.grid[1] // RESIDENT_CLUSTERS[self.clusters])


@functools.lru_cache(maxsize=256)
def reg_plan(R: int, B: int) -> RegPlan:
    """The forward's plan, by ``hier_plan``'s rule: the fewest waves of
    the card (R clusters over the ``RESIDENT_CLUSTERS`` of C CTAs it
    holds at once), then the most CTAs, with no CTA left without rows.
    A CTA owns RB = ceil(B/C) rows and runs RB·S (row, slice) items, S
    the largest power of two (at most B) that fits 256 threads, or 1024
    once RB exceeds 256; a CTA with more items than threads runs them in
    passes of whole rows."""
    if not (1 <= R <= MAX_DIMS and B >= 1):
        raise ValueError(f"the reg kernel takes 1 to {MAX_DIMS} dims of a batch of at "
                         f"least 1, got R={R}, B={B}")
    best, best_key = None, None
    for c in (8, 4, 2, 1):
        rows = -(-B // c)
        if (c - 1) * rows >= B:
            continue  # a CTA without rows
        key = (-(-R // RESIDENT_CLUSTERS[c]), -R * c)
        if best_key is None or key < best_key:
            best, best_key = (c, rows), key
    c, rows = best
    target = MAX_THREADS if rows > THREADS else THREADS
    s = 1
    while 2 * s <= B and rows * 2 * s <= target:
        s *= 2
    threads = max(32, min(target, 1 << (rows * s - 1).bit_length()))
    return RegPlan(c, rows, s, threads, (c, R))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_NAME = "reg_loss"
_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i, ll, ip = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(
            ctypes.c_int)
        lib.reg_loss_max_dims.argtypes = []
        lib.reg_loss_max_dims.restype = i
        lib.reg_loss_resident_clusters.argtypes = [i, i]
        lib.reg_loss_resident_clusters.restype = i
        lib.reg_loss_fwd.argtypes = ([p, ll, ll, ip, p, ll, ll, ip, p] + [i] * 6
                                     + [p, p, p, p])
        lib.reg_loss_fwd.restype = i
        lib.reg_loss_bwd.argtypes = [p, p, p, ll, ip, i, i, i, p, ll, ll, p, p]
        lib.reg_loss_bwd.restype = i
        if lib.reg_loss_max_dims() != MAX_DIMS:
            raise RuntimeError("csrc/reg_loss.cu and ops/reg_kernel.py disagree on MAX_DIMS")
        _bound = True
    return lib


def resident_clusters(clusters: int, threads: int) -> int:
    """Clusters of the forward kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = _library().reg_loss_resident_clusters(clusters, threads)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed ({-n})")
    return n


@functools.lru_cache(maxsize=64)
def _col_arrays(dims: Dims, z_dims: int, a_dims: Optional[int]):
    """ctypes arrays of the latent and attribute columns of ``dims``;
    raises on a column out of range."""
    if not 1 <= len(dims) <= MAX_DIMS:
        raise ValueError(f"the reg kernel takes 1 to {MAX_DIMS} dims, got {len(dims)}")
    zc, ac = [int(p[0]) for p in dims], [int(p[1]) for p in dims]
    if not all(0 <= c < z_dims for c in zc) or (
            a_dims is not None and not all(0 <= c < a_dims for c in ac)):
        raise ValueError(f"dims {dims} name columns outside ({z_dims}, {a_dims})")
    arr = ctypes.c_int * len(dims)
    return arr(*zc), arr(*ac)


def _on_card(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must lie on a CUDA device ({dev}), got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")


@profiling.spanned("op:reg.fwd")
def reg_fwd_cuda(z: torch.Tensor, labels: torch.Tensor, dims: Dims,
                 delta: torch.Tensor, factors: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launches the forward on (B, Z) ``z`` and (B, L) ``labels``, read
    in place: → (loss (R,), G (R, B), D (R,)), G and D None without
    ``factors``."""
    dev = z.device
    for name, t in (("z", z), ("labels", labels), ("delta", delta)):
        _on_card(name, t, dev)
    if z.ndim != 2 or labels.ndim != 2 or z.shape[0] != labels.shape[0]:
        raise ValueError(f"expected (B, Z) latents and (B, L) labels, got "
                         f"{tuple(z.shape)} and {tuple(labels.shape)}")
    if delta.numel() != 1:
        raise ValueError("delta must be a scalar")
    zcols, acols = _col_arrays(dims, z.shape[1], labels.shape[1])
    r, b = len(dims), z.shape[0]
    plan = reg_plan(r, b)
    lib = _library()
    loss = torch.empty((r,), dtype=torch.float32, device=dev)
    g = torch.empty((r, b), dtype=torch.float32, device=dev) if factors else None
    d = torch.empty((r,), dtype=torch.float32, device=dev) if factors else None
    with torch.cuda.device(dev):
        err = lib.reg_loss_fwd(
            z.data_ptr(), z.stride(0), z.stride(1), zcols,
            labels.data_ptr(), labels.stride(0), labels.stride(1), acols,
            delta.data_ptr(), r, b, plan.clusters, plan.rows, plan.slices, plan.threads,
            loss.data_ptr(), g.data_ptr() if factors else None,
            d.data_ptr() if factors else None, _build.stream_of(z))
    _build.raise_on(lib, _NAME, err, "reg_loss_fwd")
    LAUNCHES["fwd"] += 1
    return loss, g, d


@profiling.spanned("op:reg.bwd")
def reg_bwd_cuda(g: torch.Tensor, d: torch.Tensor, ct: torch.Tensor, dims: Dims,
                 z_dims: int, col_major: bool = False, ddelta: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launches the backward: the (B, z_dims) gradient of the latents
    (column-major storage when ``col_major``, as the latents were) and
    ddelta (1,), or None without ``ddelta``."""
    dev = g.device
    for name, t in (("G", g), ("D", d), ("ct", ct)):
        _on_card(name, t, dev)
    r, b = g.shape
    if not g.is_contiguous() or d.shape != (r,) or not d.is_contiguous() \
            or ct.shape != (r,):
        raise ValueError(f"expected contiguous G ({r}, {b}), D ({r},) and a ({r},) "
                         f"cotangent, got {tuple(d.shape)} and {tuple(ct.shape)}")
    if len(dims) != r:
        raise ValueError(f"{len(dims)} dims for {r} rows of G")
    zcols = _col_arrays(dims, z_dims, None)[0]
    lib = _library()
    dz = (torch.empty((z_dims, b), dtype=torch.float32, device=dev).t() if col_major
          else torch.empty((b, z_dims), dtype=torch.float32, device=dev))
    dd = torch.empty((1,), dtype=torch.float32, device=dev) if ddelta else None
    with torch.cuda.device(dev):
        err = lib.reg_loss_bwd(g.data_ptr(), d.data_ptr(), ct.data_ptr(), ct.stride(0),
                               zcols, r, b, z_dims, dz.data_ptr(), dz.stride(0),
                               dz.stride(1), dd.data_ptr() if ddelta else None,
                               _build.stream_of(g))
    _build.raise_on(lib, _NAME, err, "reg_loss_bwd")
    LAUNCHES["bwd"] += 1
    return dz, dd


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def _forward(z, labels, dims, delta, factors):
    if z.is_cuda:
        return reg_fwd_cuda(z, labels, dims, delta, factors)
    zc, ac = stack_columns(z, labels, dims)
    if factors:
        return reg_fwd_factors_reference(zc, ac, delta)
    return reg_loss_fwd_reference(zc, ac, delta), None, None


class RegLossFn(torch.autograd.Function):
    """Per-dim AR losses of columns read in place. ``z`` gets its whole
    (B, Z) gradient, ``labels`` none (``sign`` is flat almost
    everywhere), ``delta`` its true one; the factors are computed only
    when ``z`` or ``delta`` needs a gradient."""

    @staticmethod
    def forward(ctx, z, labels, delta, dims):
        factors = ctx.needs_input_grad[0] or ctx.needs_input_grad[2]
        loss, g, d = _forward(z, labels, dims, delta, factors)
        ctx.save_for_backward(g, d)
        ctx.dims, ctx.z_dims, ctx.delta_shape = dims, z.shape[1], delta.shape
        ctx.col_major = z.stride(0) < z.stride(1)
        return loss

    @staticmethod
    def backward(ctx, ct):
        g, d = ctx.saved_tensors
        if g is None:
            return None, None, None, None
        want_dd = ctx.needs_input_grad[2]
        if g.is_cuda:
            dz, dd = reg_bwd_cuda(g, d, ct, ctx.dims, ctx.z_dims, ctx.col_major, want_dd)
        else:
            dz_cols, dd = reg_bwd_scale_reference(g, d, ct)
            dz = scatter_columns(dz_cols, ctx.dims, ctx.z_dims)
        return (dz if ctx.needs_input_grad[0] else None, None,
                dd.reshape(ctx.delta_shape) if want_dd else None, None)


def reg_losses(z_tilde: torch.Tensor, labels: torch.Tensor,
               dims: Sequence[Tuple[int, int]],
               delta: torch.Tensor | float) -> torch.Tensor:
    """Per-dim AR losses (R,) of the ``(latent column, attribute column)``
    pairs ``dims`` of (B, Z) ``z_tilde`` and (B, L) ``labels``, read in
    place; a column may be named more than once.

    Labels of another dtype than float32 are cast once here, outside the
    autograd Function. ``delta`` may be a Python float or a scalar
    tensor; a tensor already on the device (as the trainers keep it)
    costs no host-to-device copy per call."""
    if z_tilde.dtype != torch.float32:
        z_tilde = z_tilde.float()
    if labels.dtype != torch.float32:
        labels = labels.float()
    if not isinstance(dims, tuple):
        dims = tuple(tuple(p) for p in dims)
    _col_arrays(dims, z_tilde.shape[1], labels.shape[1])  # checks the columns (cached)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=z_tilde.device)
    if torch.is_grad_enabled() and (z_tilde.requires_grad or labels.requires_grad
                                    or delta.requires_grad):
        return RegLossFn.apply(z_tilde, labels, delta, dims)
    return _forward(z_tilde, labels, dims, delta, False)[0]


@functools.lru_cache(maxsize=MAX_DIMS)
def _stacked_dims(r: int) -> Dims:
    return tuple((i, i) for i in range(r))


def fused_reg_loss(z_cols: torch.Tensor, a_cols: torch.Tensor,
                   delta: torch.Tensor | float) -> torch.Tensor:
    """Per-dim AR reg losses. z_cols, a_cols: (R, B) → (R,) float32, the
    Pallas kernel's signature; the same kernels on the (B, R) views."""
    if z_cols.ndim != 2 or z_cols.shape != a_cols.shape:
        raise ValueError(f"expected matching (R, B) columns, got "
                         f"{tuple(z_cols.shape)} and {tuple(a_cols.shape)}")
    return reg_losses(z_cols.t(), a_cols.t(), _stacked_dims(z_cols.shape[0]), delta)
