"""Weight gradient of the image models' 4x4 convolutions: a hand-written
CUDA kernel and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
It exists because cuDNN's deterministic weight gradient
(``wgrad2d_grouped_direct_kernel``), which the image trainers select with
``torch.backends.cudnn.deterministic`` so that a step repeats bitwise,
ran the dSprites VAE's weight gradients at about 1% of their fp32 bound
(3.97 ms of a 5.93 ms step on an H100).

A ``Conv2d``'s and a ``ConvTranspose2d``'s weight gradient are one
contraction. With the small map S (B, M, Hs, Ws), the large map L (B, C,
Hl, Wl), stride s and padding p::

    dW[m, c, kh, kw] = Σ_{b,i,j} S[b, m, i, j] · L[b, c, i·s − p + kh, j·s − p + kw]

with L read as 0 outside its bounds. A convolution's S is its output's
gradient and L its input; a transposed convolution's S is its input and L
its output's gradient. Either way dW has the layer's weight shape (M, C,
4, 4).

:func:`conv_layer` is the entry the image models call at float32
(``models/image_vae.py::_ComputeDtype._apply_layer``): a layer on a CUDA
tensor whose weight wants a gradient and whose shape
:func:`conv_wgrad_plan` accepts runs through :class:`Conv2dWgrad` or
:class:`ConvTranspose2dWgrad`; every other call is ``layer(h)`` as
before, counted in ``ROUTES`` by its reason. The Functions' forward is
the layer's own ``F.conv2d`` / ``F.conv_transpose2d`` call, and their
backward takes the input and bias gradients from the same
``aten.convolution_backward`` call autograd makes (cuDNN's deterministic
dgrad and the bias's sum), the weight mask off, and the weight gradient
from :func:`conv_wgrad_cuda`, the kernel of ``csrc/conv_wgrad.cu``, or a
raise: there is no fallback. :func:`conv_wgrad_reference`, the plain
version, is what the tests and ``chip_smoke.py`` hold the kernel to.

What bounds it on the card, and the design: the source note of
``csrc/conv_wgrad.cu``. The plan (:func:`conv_wgrad_plan`) is a function
of the shape alone, filling the ``SMS`` of an H100 whatever card runs
it, so the order of every sum, and so every bit of dW, depends on the
inputs alone. The wrapper allocates dW and the partials' scratch,
syncs nothing and keeps no host state, so a CUDA graph can capture it.

The library is built on first use by ``ops/_build.py`` (``nvcc`` for
``sm_90a``, bound with ``ctypes``); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as nn_module

from arvae_tpu_torch.ops import _build
from arvae_tpu_torch.utils import profiling

# Kernel calls by the wrapper, one a weight gradient (each is two
# launches: the partial sums, then their sum; one where a split is all).
LAUNCHES = {"wgrad": 0}
# Convolution calls of the image models at float32, by route: through
# the kernel's Functions, or ``layer(h)`` because the tensor is on the
# CPU, no weight gradient is wanted, the layer has a hook, a tensor is
# not float32, or the plan refuses the layer's shape.
ROUTES = {"kernel": 0, "cpu": 0, "no_grad": 0, "hook": 0, "dtype": 0, "plan": 0}

SMS = 132               # an H100 SXM's SMs: the split fills them, whatever card runs it
THREADS = 512           # a CTA of pass 1
BLOCK = 64              # a thread's 8 x 8 block of the tile
TAPS = 16               # a 4 x 4 window
STAGING_BYTES = THREADS * BLOCK * 4  # the staging ring's budget: the groups' blocks' room
MAX_SMEM = 232448       # bytes of shared memory a block can use
MAX_ROWS = 8            # rows of positions a chunk
MAX_STAGES = 8          # staging buffers in flight
INT_LIMIT = 2 ** 31     # the kernel indexes a map's plane and the units in int

Shape = Tuple[int, int, int, int]


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the golden model of the tests and the smoke run)
# ---------------------------------------------------------------------------


def conv_wgrad_reference(small: torch.Tensor, large: torch.Tensor, stride, padding,
                         chunk: int = 16) -> torch.Tensor:
    """dW (M, C, 4, 4) of the small map (B, M, Hs, Ws) against the large
    map (B, C, Hl, Wl): the large map's patches unfolded under each small
    position, multiplied ``chunk`` images at a time and the chunks added
    in order."""
    (s, _), (p, _) = _pair(stride), _pair(padding)
    b, m, hs, ws = small.shape
    c, hl, wl = large.shape[1:]
    # rows and columns past the large map that the last windows reach read 0
    large = F.pad(large, (0, max(0, (ws - 1) * s + 4 - 2 * p - wl),
                          0, max(0, (hs - 1) * s + 4 - 2 * p - hl)))
    cols = F.unfold(large, 4, padding=p, stride=s)
    hu, wu = (large.shape[2] + 2 * p - 4) // s + 1, (large.shape[3] + 2 * p - 4) // s + 1
    cols = cols.view(b, c * TAPS, hu, wu)[:, :, :hs, :ws].reshape(b, c * TAPS, hs * ws)
    sm = small.reshape(b, m, hs * ws)
    dw = small.new_zeros((m, c * TAPS))
    for i in range(0, b, chunk):
        a = sm[i:i + chunk].permute(1, 0, 2).reshape(m, -1)
        x = cols[i:i + chunk].permute(0, 2, 1).reshape(-1, c * TAPS)
        dw = dw + a @ x
    return dw.view(m, c, 4, 4)


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvWgradPlan:
    m_tile: int   # mt, rows m a tile: 8, 16 or 32
    c_tile: int   # ct, channels c a tile: a power of two up to 32
    groups: int   # G, copies of the tile a CTA holds, each over every G-th position
    rows: int     # R, rows of positions a chunk
    stages: int   # staging buffers in flight
    splits: int   # runs of the B·Hs rows of positions, one a CTA of each tile
    smem: int     # bytes of shared memory a CTA of pass 1
    grid: Tuple[int, int, int]  # (splits, C / ct, M / mt)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def buffer_bytes(ws: int, stride: int, mt: int, ct: int, rows: int) -> int:
    """A staging buffer of pass 1 in bytes, as ``csrc/conv_wgrad.cu``'s
    ``layout`` counts it: the chunk's S rows (position-major, ``mt + 4``
    floats a position) and its L rows (``ct`` channels of ``(rows − 1)·s
    + 4`` rows of ``(ws − 1)·s + 4`` columns, made odd)."""
    lw, lr = (ws - 1) * stride + 4, (rows - 1) * stride + 4
    return 4 * ((rows * ws * (mt + 4) + ct * ((lr * lw) | 1) + 3) & ~3)


def layout_smem(ws: int, stride: int, mt: int, ct: int, rows: int, stages: int) -> int:
    """Pass 1's shared memory in bytes: the staging ring, or the G copies'
    blocks (G ≥ 2: a tile has at most 256 blocks), the larger."""
    return max(stages * buffer_bytes(ws, stride, mt, ct, rows), 4 * THREADS * BLOCK)


def plan_refusal(small: Shape, large: Shape, stride, padding, kernel_size=(4, 4),
                 groups: int = 1, dilation=(1, 1)) -> Optional[str]:
    """Why the kernel does not take this weight gradient, or None."""
    (s, s2), (p, p2) = _pair(stride), _pair(padding)
    if _pair(kernel_size) != (4, 4):
        return f"a {kernel_size} window (the kernel takes 4x4)"
    if groups != 1 or _pair(dilation) != (1, 1):
        return f"groups {groups}, dilation {dilation} (the kernel takes 1 and 1)"
    if s != s2 or p != p2 or s < 1 or not 0 <= p <= 3:
        return f"stride {stride}, padding {padding} (equal in both dims, padding 0-3)"
    if len(small) != 4 or len(large) != 4 or small[0] != large[0] or min(*small, *large) < 1:
        return f"maps {small} and {large} (two NCHW maps of one batch)"
    b, m, hs, ws = small
    c, hl, wl = large[1:]
    if not (m in (8, 16, 32) or m % 32 == 0):
        return f"{m} rows of dW (8, 16, 32 or a multiple of 32)"
    if not (c <= 32 and c & (c - 1) == 0 or c % 32 == 0):
        return f"{c} channels of the large map (a power of two up to 32, or a multiple of 32)"
    if max(b * m * hs * ws, b * c * hl * wl) >= INT_LIMIT:
        return f"maps {small} and {large} (beyond int indexing)"
    if buffer_bytes(ws, s, min(m, 32), 1, 1) > MAX_SMEM:
        return f"rows of {ws} positions (a chunk's buffers exceed shared memory)"
    return None


@functools.lru_cache(maxsize=256)
def conv_wgrad_plan(small: Shape, large: Shape, stride, padding, kernel_size=(4, 4),
                    groups: int = 1, dilation=(1, 1)) -> ConvWgradPlan:
    """The plan for the small map ``small`` and the large map ``large``
    (shapes), or ValueError with :func:`plan_refusal`'s reason.

    mt = min(M, 32). A CTA's shared memory (at least the groups' 128 KB)
    takes a whole SM, so a wave is ``SMS`` CTAs: a channel tile ct (a
    power of two up to min(C, 32) that divides C) gives (M/mt)·(C/ct)
    tiles and as many splits as one wave holds over them (at least 1, at
    most one a row of positions). Of the ct whose CTAs fill the wave, or
    else of all, the one that moves the fewest floats: the partials
    written and read again, S read once a channel tile and L once a row
    tile; the larger ct on a tie. A CTA holds G = 512 / (mt/8 · 2 · ct)
    copies of its tile. Of the most rows (up to ``MAX_ROWS``, the image's rows and a
    CTA's share) of which two staging buffers fit ``STAGING_BYTES`` (or 1),
    R is the fewest that cut an image's rows into as few chunks; the ring
    holds as many buffers as fit, up to ``MAX_STAGES`` and the chunks a
    CTA can have."""
    refusal = plan_refusal(small, large, stride, padding, kernel_size, groups, dilation)
    if refusal is not None:
        raise ValueError(f"the conv_wgrad kernel does not take {refusal}")
    s = _pair(stride)[0]
    b, m, hs, ws = small
    c = large[1]
    mt, units = min(m, 32), b * hs
    n = c * TAPS
    s_floats, l_floats = b * m * hs * ws, b * c * large[2] * large[3]
    best, best_key = None, None
    for ct in (32, 16, 8, 4, 2, 1):
        if ct > c or c % ct:
            continue
        tiles = (m // mt) * (c // ct)
        splits = max(1, min(units, SMS // tiles))
        moved = (2 * splits * m * n if splits > 1 else 0) + (c // ct) * s_floats \
            + (m // mt) * l_floats
        key = (splits * tiles < SMS, moved, -ct)
        if best_key is None or key < best_key:
            best, best_key = (ct, splits), key
    ct, splits = best
    g = THREADS // (mt // 8 * 2 * ct)
    share = -(-units // splits)
    most = 1
    for r in range(min(MAX_ROWS, hs, share), 0, -1):
        if 2 * buffer_bytes(ws, s, mt, ct, r) <= STAGING_BYTES:
            most = r
            break
    rows = -(-hs // -(-hs // most))  # an image's rows in chunks of near one size
    buf = buffer_bytes(ws, s, mt, ct, rows)
    stages = max(1, min(MAX_STAGES, STAGING_BYTES // buf, -(-share // rows) + 1))
    return ConvWgradPlan(mt, ct, g, rows, stages, splits,
                         layout_smem(ws, s, mt, ct, rows, stages),
                         (splits, c // ct, m // mt))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_NAME = "conv_wgrad"
_bound = False


def _library() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_NAME)
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_wgrad_threads.argtypes = []
        lib.conv_wgrad_threads.restype = i
        lib.conv_wgrad_smem_bytes.argtypes = [i] * 6
        lib.conv_wgrad_smem_bytes.restype = i
        lib.conv_wgrad.argtypes = [p, p, p, p] + [i] * 15 + [p]
        lib.conv_wgrad.restype = i
        if lib.conv_wgrad_threads() != THREADS:
            raise RuntimeError("csrc/conv_wgrad.cu and ops/conv_wgrad_kernel.py disagree "
                               "on THREADS")
        _bound = True
    return lib


def smem_bytes(ws: int, stride: int, plan: ConvWgradPlan) -> int:
    """The library's own count of pass 1's shared memory under ``plan``."""
    return _library().conv_wgrad_smem_bytes(ws, stride, plan.m_tile, plan.c_tile, plan.rows,
                                            plan.stages)


@profiling.spanned("op:conv.wgrad")
def conv_wgrad_cuda(small: torch.Tensor, large: torch.Tensor, stride, padding) -> torch.Tensor:
    """Launches the kernel on the small and large maps (float32 on one
    card, made contiguous): → dW (M, C, 4, 4)."""
    dev = small.device
    for name, t in (("small", small), ("large", large)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"the {name} map must lie on a CUDA device ({dev}), got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the {name} map must be float32, got {t.dtype}")
    small, large = small.contiguous(), large.contiguous()
    stride, padding = _pair(stride), _pair(padding)
    plan = conv_wgrad_plan(tuple(small.shape), tuple(large.shape), stride, padding)
    (s, _), (p, _) = _pair(stride), _pair(padding)
    b, m, hs, ws = small.shape
    c, hl, wl = large.shape[1:]
    lib = _library()
    dw = torch.empty((m, c, 4, 4), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.splits, m, c * TAPS), dtype=torch.float32, device=dev)
            if plan.splits > 1 else None)
    with torch.cuda.device(dev):
        err = lib.conv_wgrad(small.data_ptr(), large.data_ptr(),
                             part.data_ptr() if part is not None else None, dw.data_ptr(),
                             b, m, hs, ws, c, hl, wl, s, p, plan.m_tile, plan.c_tile,
                             plan.groups, plan.rows, plan.stages, plan.splits,
                             _build.stream_of(small))
    _build.raise_on(lib, _NAME, err, "conv_wgrad")
    LAUNCHES["wgrad"] += 1
    return dw


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def _backward(ctx, gy: torch.Tensor, transposed: bool):
    """The input and bias gradients from ``aten.convolution_backward`` (its
    weight mask off), the weight gradient from :func:`conv_wgrad_cuda`."""
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    gx = gb = gw = None
    if need_x or need_b:
        bias_sizes = [weight.shape[1 if transposed else 0]] if ctx.has_bias else None
        gx, _, gb = torch.ops.aten.convolution_backward(
            gy, x, weight, bias_sizes, list(ctx.stride), list(ctx.padding), [1, 1], transposed,
            list(ctx.output_padding), 1, [need_x, False, need_b])
    if need_w:
        gw = conv_wgrad_cuda(x, gy, ctx.stride, ctx.padding) if transposed else \
            conv_wgrad_cuda(gy, x, ctx.stride, ctx.padding)
    return (gx, gw, gb, None, None) + ((None,) if transposed else ())


def _save(ctx, x, weight, bias, stride, padding, output_padding) -> None:
    ctx.save_for_backward(x, weight)
    ctx.stride, ctx.padding = _pair(stride), _pair(padding)
    ctx.output_padding, ctx.has_bias = _pair(output_padding), bias is not None


class Conv2dWgrad(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, stride, padding)``, its weight gradient
    from :func:`conv_wgrad_cuda` (the small map is the output's gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        _save(ctx, x, weight, bias, stride, padding, 0)
        return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        return _backward(ctx, gy, False)


class ConvTranspose2dWgrad(torch.autograd.Function):
    """``F.conv_transpose2d(x, weight, bias, stride, padding,
    output_padding)``, its weight gradient from :func:`conv_wgrad_cuda`
    (the small map is the input)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, output_padding):
        _save(ctx, x, weight, bias, stride, padding, output_padding)
        return F.conv_transpose2d(x, weight, bias, stride, padding, output_padding)

    @staticmethod
    def backward(ctx, gy):
        return _backward(ctx, gy, True)


def _maps(transposed: bool, x_shape: Shape, out_channels: int, kernel_size, stride, padding,
          dilation, output_padding) -> Tuple[Shape, Shape]:
    b, _, h, w = x_shape
    k, s, p, d = (_pair(v) for v in (kernel_size, stride, padding, dilation))
    if transposed:
        op = _pair(output_padding)
        out = tuple((n - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + op[i] + 1
                    for i, n in enumerate((h, w)))
        return tuple(x_shape), (b, out_channels, *out)
    out = tuple((n + 2 * p[i] - d[i] * (k[i] - 1) - 1) // s[i] + 1 for i, n in enumerate((h, w)))
    return (b, out_channels, *out), tuple(x_shape)


def _layer_args(layer: nn.Module):
    return (isinstance(layer, nn.ConvTranspose2d), layer.out_channels, layer.kernel_size,
            layer.stride, layer.padding, layer.dilation, getattr(layer, "output_padding", 0))


def layer_maps(layer: nn.Module, x_shape: Shape) -> Tuple[Shape, Shape]:
    """(small, large) map shapes of the layer's weight gradient on an
    input of ``x_shape``: (output, input) of a ``Conv2d``, (input,
    output) of a ``ConvTranspose2d``."""
    transposed, out_channels, *rest = _layer_args(layer)
    return _maps(transposed, tuple(x_shape), out_channels, *rest)


@functools.lru_cache(maxsize=256)
def _layer_refusal(x_shape: Shape, groups: int, padding_mode: str, transposed: bool,
                   out_channels: int, kernel_size, stride, padding, dilation,
                   output_padding) -> Optional[str]:
    if padding_mode != "zeros" or isinstance(padding, str):
        return f"padding {padding!r}, mode {padding_mode!r}"
    small, large = _maps(transposed, x_shape, out_channels, kernel_size, stride, padding,
                         dilation, output_padding)
    return plan_refusal(small, large, stride, padding, kernel_size, groups, dilation)


def _hooks(layer: nn.Module) -> bool:
    return bool(layer._forward_hooks or layer._forward_pre_hooks or layer._backward_hooks
                or layer._backward_pre_hooks or nn_module._global_forward_hooks
                or nn_module._global_forward_pre_hooks or nn_module._global_backward_hooks
                or nn_module._global_backward_pre_hooks)


def conv_route(layer: nn.Module, h: torch.Tensor) -> str:
    """The route of ``layer(h)`` for a ``Conv2d`` or ``ConvTranspose2d``:
    a key of ``ROUTES``."""
    if not h.is_cuda:
        return "cpu"
    if not (torch.is_grad_enabled() and layer.weight.requires_grad):
        return "no_grad"
    if _hooks(layer):
        return "hook"
    if h.dtype != torch.float32 or layer.weight.dtype != torch.float32:
        return "dtype"
    refusal = _layer_refusal(tuple(h.shape), layer.groups, layer.padding_mode,
                             *_layer_args(layer))
    return "plan" if refusal is not None else "kernel"


def conv_layer(layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """``layer(h)`` for a ``Conv2d`` or ``ConvTranspose2d``, its weight
    gradient from the kernel where :func:`conv_route` says ``kernel``."""
    route = conv_route(layer, h)
    ROUTES[route] += 1
    if route != "kernel":
        return layer(h)
    if isinstance(layer, nn.ConvTranspose2d):
        return ConvTranspose2dWgrad.apply(h, layer.weight, layer.bias, layer.stride,
                                          layer.padding, layer.output_padding)
    return Conv2dWgrad.apply(h, layer.weight, layer.bias, layer.stride, layer.padding)


def conv_inputs(model: nn.Module, *inputs) -> list:
    """[(name, layer, input shape)] of each ``Conv2d`` and
    ``ConvTranspose2d`` of ``model`` in the order a no-grad forward on
    ``inputs`` runs them (a probe's and a test's list of the shapes)."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: seen.append((name, mod, tuple(args[0].shape))))
        for name, m in model.named_modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return seen
