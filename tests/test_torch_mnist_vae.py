"""The port's ``MnistVAE`` and its MNIST train step against the JAX
package's, from the same weights and draws.

- ``mnist_vae_from_flax`` is the exact inverse of ``convert_mnist_vae``
  (the reference module's ``state_dict`` layout), and the Flax decoder's
  pad(3) + Conv is the port's stride-1 transposed conv.
- The forward: logits, mean, log-std and ``z_tilde`` within atol 1e-5
  (float32 convolutions summed in another order) with the same ε, in
  eval mode at dropout 0.5 (no dropout either side) and in train mode
  at dropout 0, where the parameter gradients of the loss match within
  rtol 1e-4 and 1e-5 of each gradient's largest magnitude. The two
  packages draw dropout bits differently, so the port's own dropout is
  tested apart: about half the entries zeroed, the survivors doubled,
  and a re-seeded train step bitwise the same.
- Five Adam steps of the port's trainer with ``-r all`` (the AR term on
  latent dims 1-6 against morphometry columns 1-6) against JAX's
  ``ImageVAETrainer`` with ``MnistVAE(dropout_rate=0.0)``, its ε
  injected: losses within rtol 1e-4 (KLD atol 1e-6), and each
  parameter's change within lr/10, as in the music step tests, for all
  but ``AMPLIFIED_SHARE`` of the parameters. Adam moves a parameter by
  lr·m/√v, about ±lr whatever the gradient's size, so where m nears 0
  the packages' last bits decide the step: those few are held within
  lr (one step's worth), and within the 2·5·lr two Adam trajectories
  can part by where the gradient itself passed within float32 rounding
  of 0 (below ``NEAR_ZERO`` of its leaf's largest: one element of
  ``enc_dense``'s 739,328, moved 1.96·lr apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arvae_tpu.models.image_vae as jax_image_vae
from arvae_tpu.models.image_vae import MnistVAE as FlaxMnistVAE
from arvae_tpu.ops.losses import kld_loss, reconstruction_loss
from arvae_tpu.training.image_trainer import ImageVAETrainer as JaxImageVAETrainer
from arvae_tpu.utils.torch_convert import convert_mnist_vae, torch_state_dict_to_numpy
from arvae_tpu_torch.data.morphomnist.measure import measure_batch
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set
from arvae_tpu_torch.models.image_vae import MnistVAE
from arvae_tpu_torch.ops.losses import kld_loss as t_kld
from arvae_tpu_torch.ops.losses import reconstruction_loss as t_recon
from arvae_tpu_torch.training.image_trainer import MNIST_REG_TYPES, ImageVAETrainer
from arvae_tpu_torch.utils.convert import mnist_vae_from_flax

ATOL = 1e-5
LR, B, STEPS, Z = 1e-4, 8, 5, 16
HYPER = {"beta": 1.0, "capacity": 0.0, "gamma": 10.0, "delta": 1.0}
REG_DIMS = (1, 2, 3, 4, 5, 6)
# A gradient below this share of its leaf's largest is within float32
# rounding of 0 (the packages' gradients agree to ~1e-5 of it)
NEAR_ZERO = 1e-4
# The share of all parameters whose change may part from JAX's by more
# than lr/10 (measured: 2 and 81 of 1,648,389, with XLA's and Pallas's
# AR term on the JAX side)
AMPLIFIED_SHARE = 1e-4


def _flax_params(seed=0, dropout_rate=0.5):
    model = FlaxMnistVAE(dropout_rate=dropout_rate)
    rngs = {"params": jax.random.key(seed), "dropout": jax.random.key(1),
            "sample": jax.random.key(2)}
    params = model.init(rngs, jnp.zeros((1, 1, 28, 28), jnp.float32), train=True)["params"]
    # zero biases would hide a misplaced one: give them random values
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed + 1)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.05 * rng.randn(*np.shape(x)).astype(np.float32)) for x in leaves]
    return model, jax.tree_util.tree_unflatten(tree, leaves)


def _port_from(params, dropout_rate=0.5):
    model = MnistVAE(dropout_rate=dropout_rate)
    model.load_state_dict(mnist_vae_from_flax(params))
    return model


def _inputs(n, seed=5):
    imgs, _ = generate_digit_set(n, seed=seed)
    rng = np.random.RandomState(seed)
    return imgs, rng.randn(n, Z).astype(np.float32), rng.randn(n, Z).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_flax_round_trip_is_exact(seed):
    _, params = _flax_params(seed)
    sd = _port_from(params).state_dict()
    back = convert_mnist_vae(torch_state_dict_to_numpy(sd))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(w))
    # and the reference-layout state_dict through both converters
    again = mnist_vae_from_flax(convert_mnist_vae(torch_state_dict_to_numpy(sd)))
    assert sorted(again) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


def test_forward_matches_flax_in_eval_mode():
    model, params = _flax_params(0, dropout_rate=0.5)
    port = _port_from(params).eval()
    x, eps, eps_prior = _inputs(B)
    mean, log_std = model.apply({"params": params}, jnp.asarray(x), train=False,
                                method="encode")
    z_tilde = mean + jnp.exp(log_std) * jnp.asarray(eps)
    logits = model.apply({"params": params}, z_tilde, train=False, method="decode")
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(eps_prior))
    for want, got in ((logits, out.logits), (mean, out.z_mean), (log_std, out.z_log_std),
                      (z_tilde, out.z_tilde)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out.z_prior.numpy(), eps_prior)
    assert out.logits.shape == (B, 1, 28, 28)


def test_gradients_match_flax_in_train_mode():
    model, params = _flax_params(1, dropout_rate=0.0)
    port = _port_from(params, dropout_rate=0.0)
    x, eps, eps_prior = _inputs(B, seed=6)

    def loss_fn(p):
        mean, log_std = model.apply({"params": p}, jnp.asarray(x), train=True,
                                    method="encode")
        z = mean + jnp.exp(log_std) * jnp.asarray(eps)
        logits = model.apply({"params": p}, z, train=True, method="decode")
        return (reconstruction_loss(logits, jnp.asarray(x), "bernoulli")
                + kld_loss(mean, log_std, 1.0, 0.0))

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    port.train()
    assert port.dropout_masks(B, torch.Generator(), torch.device("cpu")) is None
    out = port(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(eps_prior))
    loss = t_recon(out.logits, torch.from_numpy(x)) + t_kld(out.z_mean, out.z_log_std, 1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = mnist_vae_from_flax(grads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want[name].abs().max()), err_msg=name)


def test_dropout_zeroes_half_and_doubles_the_rest():
    port = MnistVAE(dropout_rate=0.5, seed=2)
    masks = port.dropout_masks(64, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert [tuple(m.shape[1:]) for m in masks] == [(64, 25, 25), (64, 22, 22), (8, 19, 19),
                                                   (64, 22, 22), (64, 25, 25)]
    kept = torch.cat([m.flatten() for m in masks]).float().mean()
    assert abs(float(kept) - 0.5) < 0.01
    x = torch.randn(4, 8, 19, 19)
    keep = masks[2][:4]
    y = port.enc_conv[8](x, keep)
    assert torch.equal(y[keep], 2 * x[keep]) and not y[~keep].any()
    assert torch.equal(port.enc_conv[8](x, None), x)
    # the masks change the train forward but not an eval one
    imgs, eps, eps_prior = (torch.from_numpy(a) for a in _inputs(4))
    with torch.no_grad():
        drop = port(imgs, eps, eps_prior,
                    port.dropout_masks(4, torch.Generator().manual_seed(1), "cpu")).logits
        plain = port(imgs, eps, eps_prior).logits
    assert not torch.allclose(drop, plain)


def _batches():
    imgs, digits = generate_digit_set(B * STEPS, seed=7)
    morpho = measure_batch((imgs[:, 0] * 255).astype(np.uint8)).astype(np.float32)
    labels = np.concatenate([digits[:, None].astype(np.float32), morpho], 1)
    rng = np.random.RandomState(1)
    eps = rng.randn(STEPS, B, Z).astype(np.float32)
    eps_prior = rng.randn(STEPS, B, Z).astype(np.float32)
    return [(imgs[i * B:(i + 1) * B], labels[i * B:(i + 1) * B], eps[i], eps_prior[i])
            for i in range(STEPS)]


class MorphoMnistDataset:
    """Only its class name: how JAX's trainer tells MNIST apart."""


@pytest.mark.parametrize("use_pallas", [False, True])
def test_five_adam_steps_match_jax_trainer(use_pallas, monkeypatch):
    jt = JaxImageVAETrainer(MorphoMnistDataset(), FlaxMnistVAE(dropout_rate=0.0), lr=LR,
                            reg_type=("all",), reg_dim=REG_DIMS, rand=0,
                            use_pallas=use_pallas, **HYPER)
    assert jt.model_repr() == "MnistVAE_r_0_b_1.0_g_10.0_d_1.0_all_"
    state = jt.ensure_state()
    params0 = state.params

    # the JAX model draws ε from its key: hand it the test's instead
    injected = {}
    monkeypatch.setattr(jax_image_vae, "reparametrize", lambda rng, mean, log_std: (
        mean + jnp.exp(log_std) * injected["eps"], injected["eps_prior"]))

    @jax.jit
    def step(state, inputs, labels, eps, eps_prior):
        injected.update(eps=eps, eps_prior=eps_prior)  # traced: this call's
        batch, key = (inputs, labels), jax.random.key(0)
        grads = jax.grad(lambda p: jt._loss_fn(p, batch, key, True, state.hyper)[0])(
            state.params)
        return (*jt._train_step_core(state, batch, key), grads)

    port = _port_from(params0, dropout_rate=0.0)
    trainer = ImageVAETrainer(None, port, torch.device("cpu"), lr=LR, reg_type=("all",),
                              reg_dim=REG_DIMS, rand=0, **HYPER)
    assert trainer.dataset_type == "mnist" and trainer.attr_dict == MNIST_REG_TYPES
    assert trainer.model_repr() == jt.model_repr()
    # each element's smallest gradient over the steps, relative to its
    # leaf's largest: where it comes within float32 rounding of 0, Adam's
    # g/sqrt(v) turns the two packages' last bits into updates of ±lr
    near_zero = None
    for imgs, labels, eps, eps_prior in _batches():
        state, jm, grads = step(state, *(jnp.asarray(a) for a in
                                         (imgs, labels, eps, eps_prior)))
        rel = jax.tree_util.tree_map(lambda g: np.abs(g) / np.abs(g).max(), grads)
        near_zero = rel if near_zero is None else jax.tree_util.tree_map(
            np.minimum, near_zero, rel)
        tm = trainer.train_step((torch.from_numpy(imgs), torch.from_numpy(labels)),
                                noise=(torch.from_numpy(eps), torch.from_numpy(eps_prior),
                                       None))
        for k in ("loss", "recons_loss", "dist_loss", "reg_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert trainer.step == STEPS == int(state.step)

    got = convert_mnist_vae(torch_state_dict_to_numpy(port.state_dict()))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    start = dict(jax.tree_util.tree_leaves_with_path(params0))
    nz = dict(jax.tree_util.tree_leaves_with_path(near_zero))
    beyond, total = 0, 0
    for path, w in jax.tree_util.tree_leaves_with_path(state.params):
        want = np.asarray(w) - np.asarray(start[path])
        assert np.abs(want).max() > LR / 2, f"{path} did not move in JAX"
        err = np.abs(np.asarray(got[path]) - np.asarray(start[path]) - want)
        assert err.max() <= 2 * STEPS * LR, (str(path), err.max())
        assert np.all(err[nz[path] >= NEAR_ZERO] <= LR), (str(path), err.max())
        beyond += int((err > LR / 10).sum())
        total += err.size
    assert beyond <= AMPLIFIED_SHARE * total, (beyond, total)


def test_reseeded_train_step_repeats_bitwise():
    imgs, labels, _, _ = _batches()[0]
    batch = (torch.from_numpy(imgs), torch.from_numpy(labels))
    runs = []
    for _ in range(2):
        trainer = ImageVAETrainer(None, MnistVAE(seed=4), torch.device("cpu"), lr=LR,
                                  reg_type=("all",), reg_dim=REG_DIMS, rand=3, **HYPER)
        metrics = trainer.train_step(batch)  # masks and ε from the trainer's generator
        runs.append((metrics, trainer.model.state_dict()))
    (m1, s1), (m2, s2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    other = ImageVAETrainer(None, MnistVAE(seed=4), torch.device("cpu"), lr=LR,
                            reg_type=("all",), reg_dim=REG_DIMS, rand=4, **HYPER)
    assert not torch.equal(other.train_step(batch)["loss"], m1["loss"])
