"""The AR regulariser's forward-with-factors / scale-backward
decomposition and its in-place entry, on the CPU, against the Pallas
``fused_reg_loss`` (interpret mode), autograd through the plain forward,
the stacked path and the JAX package's ``total_reg_loss``.

Tolerances as ``tests/test_reg_pallas.py`` and ``test_torch_losses.py``
state them: losses rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-6 (float32 sums of B² terms in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops import losses as jl
from arvae_tpu.ops.reg_pallas import fused_reg_loss as jax_fused_reg_loss
from arvae_tpu_torch.ops import losses as tl
from arvae_tpu_torch.ops import reg_kernel as rk

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(want, got, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tied_inputs(r, b):
    rng = np.random.RandomState(r * 7 + b)
    z = rng.randn(r, b).astype(np.float32)
    # discrete labels: ties are common, as with dSprites factors
    a = rng.randint(0, 4, (r, b)).astype(np.float32)
    ct = rng.randn(r).astype(np.float32)
    return z, a, ct


@pytest.mark.parametrize("delta", [1.0, 10.0])
@pytest.mark.parametrize("r,b", [(5, 128), (4, 256), (5, 100), (3, 700)])
def test_factors_match_pallas_and_autograd(r, b, delta):
    z, a, ct = _tied_inputs(r, b)
    tz, ta, tct = (torch.from_numpy(x) for x in (z, a, ct))
    loss, g, d = rk.reg_fwd_factors_reference(tz, ta, delta)
    dz, dd = rk.reg_bwd_scale_reference(g, d, tct)
    assert torch.equal(loss, rk.reg_loss_fwd_reference(tz, ta, delta))

    # the Pallas kernel (interpret mode) and its custom VJP
    def jax_obj(zz, dl):
        return jnp.sum(jax_fused_reg_loss(zz, jnp.asarray(a), dl) * ct)

    _close(jax_fused_reg_loss(jnp.asarray(z), jnp.asarray(a), delta), loss, FWD)
    jdz, jdd = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(z), jnp.float32(delta))
    _close(jdz, dz, BWD)
    _close(jdd, dd, BWD)

    # autograd through the plain forward, and the golden VJP
    zg = tz.clone().requires_grad_(True)
    dg = torch.tensor(delta, requires_grad=True)
    auto = torch.autograd.grad((rk.reg_loss_fwd_reference(zg, ta, dg) * tct).sum(), (zg, dg))
    _close(auto[0], dz, BWD)
    _close(auto[1], dd, BWD)
    gold = rk.reg_loss_bwd_reference(tz, ta, delta, tct)
    _close(gold[0], dz, BWD)
    _close(gold[1], dd, BWD)


# (B, Z) latents read through a strided view, (B, L) labels, and dims
# that name latent column 1 twice and skip columns 2 and 4-7
B, Z, L = 96, 8, 6
DIMS = ((1, 1), (3, 2), (1, 4), (0, 0), (5, 5))
GAMMA, DELTA = 10.0, 1.0


def _column_inputs(label_dtype):
    rng = np.random.RandomState(11)
    wide = rng.randn(B, 2 * Z).astype(np.float32)  # z_tilde = wide[:, ::2]
    labels = rng.randint(0, 3, (B, L))
    return wide, labels.astype(np.float32), torch.from_numpy(labels).to(label_dtype)


@pytest.mark.parametrize("label_dtype", [torch.float32, torch.int64], ids=["f32", "i64"])
def test_in_place_entry_matches_stacked_path_and_jax(label_dtype):
    wide, labels_np, labels = _column_inputs(label_dtype)
    z_np = np.ascontiguousarray(wide[:, ::2])
    ct = np.random.RandomState(12).randn(len(DIMS)).astype(np.float32)
    tct = torch.from_numpy(ct)

    # in place: a strided view of the latents, labels of either dtype
    wg = torch.from_numpy(wide).requires_grad_(True)
    z_tilde = wg[:, ::2]
    assert not z_tilde.is_contiguous()
    losses = rk.reg_losses(z_tilde, labels, DIMS, DELTA)
    (losses * tct).sum().backward()

    # stacked columns through the (R, B) entry
    zs = torch.from_numpy(z_np).requires_grad_(True)
    z_cols, a_cols = rk.stack_columns(zs, torch.from_numpy(labels_np), DIMS)
    stacked = rk.fused_reg_loss(z_cols, a_cols, DELTA)
    (stacked * tct).sum().backward()
    _close(stacked, losses, FWD)
    _close(zs.grad, wg.grad[:, ::2], BWD)
    assert torch.equal(wg.grad[:, 1::2], torch.zeros(B, Z))  # the view's gaps
    for c in (2, 4, 6, 7):  # latent columns no dim names
        assert torch.equal(wg.grad[:, 2 * c], torch.zeros(B))

    # the JAX package's total_reg_loss, XLA and Pallas, and its gradient
    jz, ja = jnp.asarray(z_np), jnp.asarray(labels_np)
    total = tl.total_reg_loss(torch.from_numpy(z_np), labels, DIMS, GAMMA, DELTA)
    for use_pallas in (False, True):
        _close(jl.total_reg_loss(jz, ja, DIMS, GAMMA, DELTA, use_pallas=use_pallas),
               total, FWD)
    zt = torch.from_numpy(z_np).requires_grad_(True)
    tl.total_reg_loss(zt, labels, DIMS, GAMMA, DELTA).backward()
    jgrad = jax.grad(lambda zz: jl.total_reg_loss(zz, ja, DIMS, GAMMA, DELTA,
                                                  use_pallas=True))(jz)
    _close(jgrad, zt.grad, BWD)


def test_function_backward_is_the_scaled_factors_scattered():
    wide, labels_np, _ = _column_inputs(torch.float32)
    z = torch.from_numpy(np.ascontiguousarray(wide[:, :Z])).requires_grad_(True)
    labels = torch.from_numpy(labels_np)
    dl = torch.tensor(DELTA, requires_grad=True)
    ct = torch.from_numpy(np.random.RandomState(13).randn(len(DIMS)).astype(np.float32))
    (rk.reg_losses(z, labels, DIMS, dl) * ct).sum().backward()

    _, g, d = rk.reg_fwd_factors_reference(*rk.stack_columns(z.detach(), labels, DIMS), DELTA)
    dz_cols, dd = rk.reg_bwd_scale_reference(g, d, ct)
    want = torch.zeros(B, Z)
    for r, (c, _) in enumerate(DIMS):  # column 1 twice: r = 0 then r = 2
        want[:, c] += dz_cols[r]
    assert torch.equal(z.grad, want)
    assert torch.equal(dl.grad, dd)
    assert dl.grad.shape == dl.shape


def test_no_grad_forward_equals_grad_forward():
    wide, labels_np, _ = _column_inputs(torch.float32)
    z = torch.from_numpy(np.ascontiguousarray(wide[:, :Z])).requires_grad_(True)
    labels = torch.from_numpy(labels_np)
    with_grad = rk.reg_losses(z, labels, DIMS, DELTA)
    assert with_grad.grad_fn is not None
    with torch.no_grad():
        without = rk.reg_losses(z, labels, DIMS, DELTA)
    assert without.grad_fn is None
    assert torch.equal(with_grad.detach(), without)
    # total_reg_loss under no_grad, as the trainers' eval steps run it
    with torch.no_grad():
        total = tl.total_reg_loss(z, labels, DIMS, GAMMA, DELTA)
    assert torch.equal(total, GAMMA * without.sum())


def test_in_place_entry_refuses_bad_dims():
    z, labels = torch.randn(16, 4), torch.randn(16, 3)
    with pytest.raises(ValueError):  # no such latent column
        rk.reg_losses(z.requires_grad_(True), labels, ((4, 0),), 1.0).sum().backward()
    with pytest.raises(ValueError):
        rk.reg_plan(rk.MAX_DIMS + 1, 16)
