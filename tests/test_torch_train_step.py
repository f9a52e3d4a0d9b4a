"""The port's dSprites AR-VAE train step against the JAX package's, as
a whole, plus the port's CLI end to end on the CPU.

From the same converted weights, the same five B=16 batches of packed
dSprites rows and the same reparametrisation noise, five Adam(1e-4)
steps of ``ImageVAETrainer.train_step`` are held against a JAX step
composed from the package's public pieces the way
``arvae_tpu/training/image_trainer.py`` composes them (encode,
reparametrise, decode, recon + KLD + AR reg, ``optax.adam``).

Tolerances: per-step losses within rtol 1e-4 (float32 convolutions and
sums in another order), plus atol 1e-6 for the KLD: near the prior it
is a cancellation of O(1) terms (−log s + (s² + μ²)/2 − ½ ≈ 3e-4 at
init), so its float32 rounding error is absolute, not relative. Final
params within atol 5·lr: Adam divides each gradient by its own running
RMS, so a gradient that is ~0 in both packages but differs in its last
bits still moves a parameter by up to lr per step, in either
direction."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arvae_tpu.data.dsprites import generate_dsprites
from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.ops.losses import (kld_loss, pixel_accuracy,
                                  reconstruction_loss, total_reg_loss)
from arvae_tpu.utils.torch_convert import (convert_dsprites_vae,
                                           torch_state_dict_to_numpy)
from arvae_tpu_torch import train_image_vae
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.utils.convert import dsprites_vae_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (1, 3, 2, 2, 4, 4)
LR = 1e-4
B, STEPS = 16, 5
HYPER = {"beta": 1.0, "capacity": 0.0, "gamma": 10.0, "delta": 1.0}
REG_DIMS = (1, 2, 3, 4, 5)


def _batches():
    packed, latents = generate_dsprites(TINY)
    order = np.random.RandomState(0).permutation(len(packed))[: B * STEPS]
    imgs = np.unpackbits(packed[order], axis=1).reshape(-1, 1, 64, 64)
    imgs = imgs.astype(np.float32)
    rng = np.random.RandomState(1)
    eps = rng.randn(STEPS, B, 10).astype(np.float32)
    eps_prior = rng.randn(STEPS, B, 10).astype(np.float32)
    return [(imgs[i * B:(i + 1) * B], latents[order][i * B:(i + 1) * B],
             eps[i], eps_prior[i]) for i in range(STEPS)]


def _jax_step(use_pallas):
    model = FlaxDspritesVAE()
    optimizer = optax.adam(LR)
    reg_pairs = tuple((d, d) for d in REG_DIMS)

    def loss_fn(params, inputs, labels, eps):
        z_mean, z_log_std = model.apply({"params": params}, inputs,
                                        train=True, method="encode")
        z_tilde = z_mean + jnp.exp(z_log_std) * eps
        logits = model.apply({"params": params}, z_tilde, train=True,
                             method="decode")
        recons_loss = reconstruction_loss(logits, inputs, "bernoulli")
        dist_loss = kld_loss(z_mean, z_log_std, HYPER["beta"],
                             HYPER["capacity"])
        reg_loss = total_reg_loss(z_tilde, labels, reg_pairs, HYPER["gamma"],
                                  HYPER["delta"], use_pallas=use_pallas)
        loss = recons_loss + dist_loss + reg_loss
        return loss, {"recons_loss": recons_loss, "dist_loss": dist_loss,
                      "reg_loss": reg_loss, "loss": loss,
                      "accuracy": pixel_accuracy(jax.nn.sigmoid(logits), inputs)}

    @jax.jit
    def step(params, opt_state, inputs, labels, eps):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, inputs, labels, eps)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    return model, optimizer, step


@pytest.mark.parametrize("use_pallas", [False, True])
def test_five_adam_steps_match_jax(use_pallas):
    model, optimizer, step = _jax_step(use_pallas)
    params = model.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                        jnp.zeros((1, 1, 64, 64), jnp.float32),
                        train=True)["params"]
    port = DspritesVAE()
    port.load_state_dict(dsprites_vae_from_flax(params))
    trainer = ImageVAETrainer(None, port, torch.device("cpu"), lr=LR,
                              reg_type=("all",), reg_dim=REG_DIMS,
                              rand=0, **HYPER)
    opt_state = optimizer.init(params)
    for imgs, labels, eps, eps_prior in _batches():
        params, opt_state, jm = step(params, opt_state, jnp.asarray(imgs),
                                     jnp.asarray(labels), jnp.asarray(eps))
        tm = trainer.train_step(
            (torch.from_numpy(imgs), torch.from_numpy(labels)),
            noise=(torch.from_numpy(eps), torch.from_numpy(eps_prior)))
        for k in ("loss", "recons_loss", "dist_loss", "reg_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert trainer.step == STEPS

    got = convert_dsprites_vae(torch_state_dict_to_numpy(port.state_dict()))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in want:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                   atol=5 * LR, rtol=0, err_msg=str(path))


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    # seed the --short cache with a tiny grid so one epoch takes seconds
    ds_root = tmp_path / "datasets"
    (ds_root / "dsprites").mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(ds_root / "dsprites" / "dsprites_synth_1x3x3x10x16x16.npz",
                        packed=packed, latents=latents)
    # one OpenMP thread, as test_torch_suite_settings.py gives the
    # in-process tests
    env = dict(os.environ, ARVAE_DATASETS_DIR=str(ds_root),
               ARVAE_MODELS_DIR=str(tmp_path / "models"), PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "arvae_tpu_torch.train_image_vae",
           "--device", "cpu", "-d", "dsprites", "--short", "--rand", "0",
           "-r", "all", "--beta", "1.0", "--batch_size", "16",
           "--num_epochs", "1"]
    first = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "Train Epoch: 1/1" in first.stdout
    loss = float(first.stdout.split("Train Loss: ")[1].split()[0])
    assert np.isfinite(loss)
    run = tmp_path / "models" / "torch" / "DspritesVAE_r_0_b_1.0_g_10.0_d_1.0_all_"
    ckpt = torch.load(run / "ckpt.pt", weights_only=True)
    n_steps = int(0.7 * len(packed)) // 16
    assert ckpt["step"] == n_steps
    assert ckpt["protocol"]["num_epochs"] == 1
    assert ckpt["protocol"]["factor_sizes"] == [1, 3, 3, 10, 16, 16]

    second = subprocess.run(cmd + ["--resume"], env=env, cwd=str(tmp_path),
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert f"resumed from {run} at step {n_steps}" in second.stdout
    assert torch.load(run / "ckpt.pt", weights_only=True)["step"] == 2 * n_steps


def test_cli_refuses_mnist_and_missing_cuda(monkeypatch):
    # MNIST is ported and the default dataset (tests/test_torch_mnist_cli.py);
    # without a card the CLI refuses to start on either dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["-d", "mnist"], ["-d", "dsprites", "--rand", "0"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_image_vae.main(argv)
