"""AR pairwise regulariser: hand-written CUDA kernel pair + plain version.

Replaces the Pallas TPU kernel ``arvae_tpu/ops/reg_pallas.py::fused_reg_loss``.
Per regularised dim r of stacked (R, B) columns::

    loss_r = 1/B² Σ_ij | tanh(δ(z_i − z_j)) − sign(a_i − a_j) |

On a CUDA tensor, :func:`fused_reg_loss` always launches the kernels of
``csrc/reg_loss.cu`` (forward in the autograd Function's forward,
backward in its backward) or raises; on a CPU tensor it runs the plain
PyTorch versions below. There is no fallback from one to the other.

What bounds it on the card: at the training shape (R=5, B=128) a call
is 82k pairs over O(R·B) bytes of input, so it is launch-bound; neither
HBM traffic nor arithmetic is close to a limit. The kernel keeps the B²
pair block out of device memory (one thread per row i, j columns staged
in shared memory) and reduces across blocks through a per-(r, block)
scratch buffer summed in a fixed order by a second small launch, so a
call is two launches and its result is bitwise repeatable (no float
atomics).

The library is built on first use by ``ops/_build.py`` (``nvcc`` for
``sm_90a``, bound with ``ctypes``); importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from arvae_tpu_torch.ops import _build

# Kernel launches by the wrapper, one per call of each direction.
LAUNCHES = {"fwd": 0, "bwd": 0}


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


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_NAME = "reg_loss"
_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.reg_loss_threads.argtypes = []
        lib.reg_loss_threads.restype = i
        lib.reg_loss_fwd.argtypes = [p, p, p, i, i, p, p, p]
        lib.reg_loss_fwd.restype = i
        lib.reg_loss_bwd.argtypes = [p, p, p, p, i, i, p, p, p, p]
        lib.reg_loss_bwd.restype = i
        _bound = True
    return lib


def _check_inputs(z: torch.Tensor, a: torch.Tensor, delta: torch.Tensor) -> None:
    if z.ndim != 2 or z.shape != a.shape:
        raise ValueError(f"expected matching (R, B) columns, got "
                         f"{tuple(z.shape)} and {tuple(a.shape)}")
    for name, t in (("z", z), ("a", a), ("delta", delta)):
        if not t.is_cuda or t.device != z.device:
            raise ValueError(f"{name} must lie on {z.device}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if delta.numel() != 1:
        raise ValueError("delta must be a scalar")
    r, b = z.shape
    if not (1 <= r <= 65535 and 1 <= b):
        raise ValueError(f"unsupported shape (R={r}, B={b})")


def _scratch(lib: ctypes.CDLL, z: torch.Tensor) -> torch.Tensor:
    r, b = z.shape
    threads = lib.reg_loss_threads()
    return torch.empty((r, (b + threads - 1) // threads),
                       dtype=torch.float32, device=z.device)


def reg_loss_fwd_cuda(z: torch.Tensor, a: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
    """Launches the forward kernel: (R, B) z, a and (1,) delta → (R,)."""
    _check_inputs(z, a, delta)
    lib = _library()
    r, b = z.shape
    out = torch.empty((r,), dtype=torch.float32, device=z.device)
    partials = _scratch(lib, z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.reg_loss_fwd(z.data_ptr(), a.data_ptr(), delta.data_ptr(),
                               r, b, partials.data_ptr(), out.data_ptr(),
                               stream)
    _build.raise_on(lib, _NAME, err, "reg_loss_fwd")
    LAUNCHES["fwd"] += 1
    return out


def reg_loss_bwd_cuda(z: torch.Tensor, a: torch.Tensor, delta: torch.Tensor,
                      ct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the backward kernel: → (dz (R, B), ddelta (1,))."""
    _check_inputs(z, a, delta)
    r, b = z.shape
    if ct.shape != (r,) or ct.dtype != torch.float32 or ct.device != z.device \
            or not ct.is_contiguous():
        raise ValueError(f"ct must be contiguous float32 ({r},) on {z.device}")
    lib = _library()
    dz = torch.empty_like(z)
    ddelta = torch.empty((1,), dtype=torch.float32, device=z.device)
    partials = _scratch(lib, z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.reg_loss_bwd(z.data_ptr(), a.data_ptr(), delta.data_ptr(),
                               ct.data_ptr(), r, b, dz.data_ptr(),
                               partials.data_ptr(), ddelta.data_ptr(), stream)
    _build.raise_on(lib, _NAME, err, "reg_loss_bwd")
    LAUNCHES["bwd"] += 1
    return dz, ddelta


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


class RegLossFn(torch.autograd.Function):
    """Per-dim AR losses with the kernel backward; ``a`` gets no gradient
    (``sign`` is flat almost everywhere) and ``delta`` its true one."""

    @staticmethod
    def forward(ctx, z, a, delta):
        ctx.save_for_backward(z, a, delta)
        if z.is_cuda:
            return reg_loss_fwd_cuda(z, a, delta)
        return reg_loss_fwd_reference(z, a, delta)

    @staticmethod
    def backward(ctx, ct):
        z, a, delta = ctx.saved_tensors
        ct = ct.contiguous()
        if z.is_cuda:
            dz, ddelta = reg_loss_bwd_cuda(z, a, delta, ct)
        else:
            dz, ddelta = reg_loss_bwd_reference(z, a, delta, ct)
        ddelta = ddelta.reshape(delta.shape) if ctx.needs_input_grad[2] else None
        return dz, None, ddelta


def fused_reg_loss(z_cols: torch.Tensor, a_cols: torch.Tensor,
                   delta: torch.Tensor | float) -> torch.Tensor:
    """Per-dim AR reg losses. z_cols, a_cols: (R, B) → (R,) float32.

    Integer attribute labels are cast to float32 here, outside the
    autograd Function. ``delta`` may be a Python float or a scalar
    tensor; a tensor already on the device (as the trainer keeps it)
    costs no host-to-device copy per call."""
    z = z_cols.float().contiguous()
    a = a_cols.float().contiguous()
    delta = torch.as_tensor(delta, dtype=torch.float32, device=z.device).reshape(1)
    return RegLossFn.apply(z, a, delta)
