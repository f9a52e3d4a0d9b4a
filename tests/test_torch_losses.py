"""The port's loss library against ``arvae_tpu.ops.losses``, and the AR
regulariser's plain forward/backward against the Pallas kernel (which
runs in interpret mode on the CPU).

Tolerances: the plain losses do the same float32 arithmetic in the same
order up to reduction order, so rtol 1e-6; the reg op follows
``tests/test_reg_pallas.py`` (fwd rtol 1e-5 / atol 1e-6, grads rtol
1e-4 / atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops import losses as jl
from arvae_tpu.ops.reg_pallas import fused_reg_loss as jax_fused_reg_loss
from arvae_tpu_torch.ops import losses as tl
from arvae_tpu_torch.ops import reg_kernel as rk

RTOL = 1e-6


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _close(jax_val, torch_val, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(torch_val.detach().numpy(), np.asarray(jax_val),
                               rtol=rtol, atol=atol)


def test_recon_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(4, 1, 8, 8) * 3).astype(np.float32)
    targets = (rng.rand(4, 1, 8, 8) > 0.5).astype(np.float32)
    jx, tx = _both(logits)
    jt, tt = _both(targets)
    for dist in ("bernoulli", "gaussian"):
        _close(jl.reconstruction_loss(jx, jt, dist),
               tl.reconstruction_loss(tx, tt, dist))
    _close(jl.bce_logits_recon_loss(jx, jt), tl.bce_logits_recon_loss(tx, tt))
    _close(jl.gaussian_recon_loss(jx, jt), tl.gaussian_recon_loss(tx, tt))
    with pytest.raises(AttributeError):
        tl.reconstruction_loss(tx, tt, "laplace")


def test_token_losses_match_jax_with_clip():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, 7).astype(np.float32)
    # out-of-vocab ids on both sides clamp into [0, V-1]
    targets = rng.randint(-2, 10, (3, 5)).astype(np.int32)
    jx, tx = _both(logits)
    _close(jl.token_cross_entropy_loss(jx, jnp.asarray(targets)),
           tl.token_cross_entropy_loss(tx, torch.from_numpy(targets)))
    ok = np.clip(targets, 0, 6)
    _close(jl.token_accuracy(jx, jnp.asarray(ok)),
           tl.token_accuracy(tx, torch.from_numpy(ok)))


def test_alt_and_rnn_losses_match_jax():
    rng = np.random.RandomState(2)
    logits4 = rng.randn(2, 3, 4, 6).astype(np.float32)
    tgt3 = rng.randint(0, 6, (2, 3, 4)).astype(np.int32)
    jx, tx = _both(logits4)
    _close(jl.token_cross_entropy_loss_alt(jx, jnp.asarray(tgt3)),
           tl.token_cross_entropy_loss_alt(tx, torch.from_numpy(tgt3)))
    _close(jl.token_accuracy_alt(jx, jnp.asarray(tgt3)),
           tl.token_accuracy_alt(tx, torch.from_numpy(tgt3)))
    w = rng.randn(2, 5, 3).astype(np.float32)
    t = rng.randn(2, 5, 3).astype(np.float32)
    (jw, tw), (jt, tt) = _both(w), _both(t)
    _close(jl.mean_l1_loss_rnn(jw, jt), tl.mean_l1_loss_rnn(tw, tt))
    _close(jl.mean_mse_loss_rnn(jw, jt), tl.mean_mse_loss_rnn(tw, tt))
    with pytest.raises(ValueError):
        tl.mean_l1_loss_rnn(tw, tt[:, :4])
    with pytest.raises(ValueError):
        tl.token_accuracy_alt(tx[0], torch.from_numpy(tgt3))


def test_pixel_accuracy_and_kld_match_jax():
    rng = np.random.RandomState(3)
    probs = rng.rand(4, 1, 8, 8).astype(np.float32)
    targets = (rng.rand(4, 1, 8, 8) > 0.5).astype(np.float32)
    (jp, tp), (jt, tt) = _both(probs), _both(targets)
    _close(jl.pixel_accuracy(jp, jt), tl.pixel_accuracy(tp, tt))
    mu = rng.randn(8, 10).astype(np.float32)
    log_s = (rng.randn(8, 10) * 0.3).astype(np.float32)
    (jm, tm), (js, ts) = _both(mu), _both(log_s)
    for beta, c in ((1.0, 0.0), (4.0, 25.0)):
        _close(jl.kld_loss(jm, js, beta, c), tl.kld_loss(tm, ts, beta, c))


def test_total_reg_loss_matches_jax():
    rng = np.random.RandomState(4)
    z = rng.randn(32, 10).astype(np.float32)
    labels = rng.randint(0, 3, (32, 6)).astype(np.float32)
    pairs = tuple((d, d) for d in (1, 2, 3, 4, 5))
    (jz, tz), (ja, ta) = _both(z), _both(labels)
    for use_pallas in (False, True):
        want = jl.total_reg_loss(jz, ja, pairs, 10.0, 1.0, use_pallas=use_pallas)
        _close(want, tl.total_reg_loss(tz, ta, pairs, 10.0, 1.0),
               rtol=1e-5, atol=1e-6)
    assert float(tl.total_reg_loss(tz, ta, (), 10.0, 1.0)) == 0.0


REG_CASES = [(1, 128, 1.0), (5, 128, 1.0), (3, 100, 0.5), (2, 700, 2.0),
             (4, 256, 10.0)]


def _reg_inputs(r, b, tied):
    rng = np.random.RandomState(r * 1000 + b)
    z = rng.randn(r, b).astype(np.float32)
    if tied:
        # discrete integer labels: ties are common, as with dSprites
        a = rng.randint(0, 4, (r, b)).astype(np.int32)
    else:
        a = rng.randn(r, b).astype(np.float32)
    ct = rng.randn(r).astype(np.float32)
    return z, a, ct


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("r,b,delta", REG_CASES)
def test_reg_forward_matches_pallas_and_xla(r, b, delta, tied):
    z, a, _ = _reg_inputs(r, b, tied)
    got = rk.fused_reg_loss(torch.from_numpy(z), torch.from_numpy(a), delta)
    pallas = jax_fused_reg_loss(jnp.asarray(z), jnp.asarray(a), delta)
    xla = jax.vmap(jl.attribute_reg_loss, in_axes=(0, 0, None))(
        jnp.asarray(z), jnp.asarray(a), delta)
    _close(pallas, got, rtol=1e-5, atol=1e-6)
    _close(xla, got, rtol=1e-5, atol=1e-6)
    per_dim = torch.stack([tl.attribute_reg_loss(torch.from_numpy(z[i]),
                                                 torch.from_numpy(a[i]), delta)
                           for i in range(r)])
    _close(xla, per_dim, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r,b,delta", [(2, 128, 1.5), (3, 100, 0.5),
                                       (5, 128, 1.0)])
def test_reg_backward_matches_pallas_grad_and_autograd(r, b, delta):
    z, a, ct = _reg_inputs(r, b, tied=True)

    def jax_obj(zz, dd):
        return jnp.sum(jax_fused_reg_loss(zz, jnp.asarray(a), dd) * ct)

    jdz, jdd = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(z),
                                                 jnp.float32(delta))
    tz, ta, tct = (torch.from_numpy(x) for x in (z, a, ct))
    dz, dd = rk.reg_loss_bwd_reference(tz, ta, delta, tct)
    _close(jdz, dz, rtol=1e-4, atol=1e-6)
    _close(jdd, dd, rtol=1e-4, atol=1e-6)

    # autograd of the plain forward, and the Function's own backward
    zg = tz.clone().requires_grad_(True)
    dg = torch.tensor(delta, requires_grad=True)
    auto = torch.autograd.grad((rk.reg_loss_fwd_reference(zg, ta, dg) * tct).sum(),
                               (zg, dg))
    np.testing.assert_allclose(dz.numpy(), auto[0].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dd.numpy(), auto[1].numpy(), rtol=1e-4, atol=1e-6)
    zf = tz.clone().requires_grad_(True)
    df = torch.tensor(delta, requires_grad=True)
    (rk.fused_reg_loss(zf, ta, df) * tct).sum().backward()
    np.testing.assert_allclose(zf.grad.numpy(), dz.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(df.grad.numpy(), dd.numpy(), rtol=1e-4, atol=1e-6)


def test_reg_sign_of_zero_and_no_label_or_delta_grad():
    # all-tied labels and equal latents: every pair is |tanh(0) - sign(0)| = 0
    z = torch.zeros(2, 16, requires_grad=True)
    a = torch.ones(2, 16, dtype=torch.int64)
    loss = rk.fused_reg_loss(z, a, 1.0)
    assert torch.equal(loss, torch.zeros(2))
    loss.sum().backward()
    assert torch.equal(z.grad, torch.zeros(2, 16))
    # a constant delta takes no gradient; float labels get none either
    af = torch.ones(2, 16, requires_grad=True)
    zz = torch.randn(2, 16, requires_grad=True)
    rk.fused_reg_loss(zz, af, 1.0).sum().backward()
    assert af.grad is None and zz.grad is not None


def test_cpu_path_launches_no_kernel():
    rk.reset_launches()
    z = torch.randn(3, 20, requires_grad=True)
    rk.fused_reg_loss(z, torch.randn(3, 20), 1.0).sum().backward()
    assert rk.LAUNCHES == {"fwd": 0, "bwd": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.randn(8, 2)
    d = torch.ones(1)
    dims = ((0, 0), (1, 1))
    with pytest.raises(ValueError):
        rk.reg_fwd_cuda(z, z, dims, d)
    with pytest.raises(ValueError):
        rk.reg_bwd_cuda(z.t().contiguous(), torch.ones(2), torch.ones(2), dims, 2)
