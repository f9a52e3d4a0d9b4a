"""The port's image CLI flags that the root ``train_image_vae.py`` has:
``--dec_dist`` (through ``ImageVAETrainer`` into the loss), ``--train`` /
``--test``, ``--log`` / ``--no_log`` and ``--resume`` / ``--no_resume``.

The gaussian decoder's train step is held against a JAX step composed
from the package's public pieces the way
``arvae_tpu/training/image_trainer.py`` composes it, with
``reconstruction_loss(..., "gaussian")``, from the same converted
weights, one B=16 batch of a tiny dSprites grid and the same noise.
Tolerances as in ``tests/test_torch_train_step.py``: the step's losses
rtol 1e-4 / atol 1e-6; and each parameter's gradient rtol 1e-4 with an
absolute floor of 1e-5 times the leaf's largest magnitude (float32
convolutions summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arvae_tpu.data.dsprites import generate_dsprites
from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.ops.losses import kld_loss, reconstruction_loss, total_reg_loss
from arvae_tpu_torch import train_image_vae
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.utils.convert import dsprites_vae_from_flax

TINY = (1, 3, 2, 2, 4, 4)
B = 16
HYPER = {"beta": 1.0, "capacity": 0.0, "gamma": 10.0, "delta": 1.0}
REG_DIMS = (1, 2, 3, 4, 5)


def test_gaussian_step_matches_jax():
    packed, latents = generate_dsprites(TINY)
    order = np.random.RandomState(0).permutation(len(packed))[:B]
    imgs = np.unpackbits(packed[order], axis=1).reshape(-1, 1, 64, 64).astype(np.float32)
    labels = latents[order]
    rng = np.random.RandomState(1)
    eps, eps_prior = rng.randn(2, B, 10).astype(np.float32)

    model = FlaxDspritesVAE()
    params = model.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                        jnp.zeros((1, 1, 64, 64), jnp.float32), train=True)["params"]
    reg_pairs = tuple((d, d) for d in REG_DIMS)

    def loss_fn(p):
        z_mean, z_log_std = model.apply({"params": p}, jnp.asarray(imgs), train=True,
                                        method="encode")
        z_tilde = z_mean + jnp.exp(z_log_std) * jnp.asarray(eps)
        logits = model.apply({"params": p}, z_tilde, train=True, method="decode")
        recons_loss = reconstruction_loss(logits, jnp.asarray(imgs), "gaussian")
        dist_loss = kld_loss(z_mean, z_log_std, HYPER["beta"], HYPER["capacity"])
        reg_loss = total_reg_loss(z_tilde, jnp.asarray(labels), reg_pairs, HYPER["gamma"],
                                  HYPER["delta"])
        loss = recons_loss + dist_loss + reg_loss
        return loss, {"recons_loss": recons_loss, "dist_loss": dist_loss,
                      "reg_loss": reg_loss, "loss": loss}

    (_, jm), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    port = DspritesVAE()
    port.load_state_dict(dsprites_vae_from_flax(params))
    trainer = ImageVAETrainer(None, port, torch.device("cpu"), reg_type=("all",),
                              reg_dim=REG_DIMS, rand=0, dec_dist="gaussian", **HYPER)
    assert trainer.hparams.dec_dist == "gaussian"
    tm = trainer.train_step((torch.from_numpy(imgs), torch.from_numpy(labels)),
                            noise=(torch.from_numpy(eps), torch.from_numpy(eps_prior)))
    for k in ("loss", "recons_loss", "dist_loss", "reg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the gaussian loss is not the bernoulli one at these logits
    bern = reconstruction_loss(jnp.zeros((B, 1, 64, 64)), jnp.asarray(imgs), "bernoulli")
    assert abs(float(jm["recons_loss"]) - float(bern)) > 1.0
    want = dsprites_vae_from_flax(grads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want[name].abs().max()), err_msg=name)


def test_cli_dec_dist_and_test_restore(tmp_path, monkeypatch):
    ds_root = tmp_path / "datasets"
    (ds_root / "dsprites").mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(ds_root / "dsprites" / "dsprites_synth_1x3x3x10x16x16.npz",
                        packed=packed, latents=latents)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(ds_root))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    argv = ["--device", "cpu", "-d", "dsprites", "--short", "--rand", "0", "-r", "all",
            "--beta", "1.0", "--batch_size", "16", "--num_epochs", "1",
            "--dec_dist", "gaussian", "--no_log", "--no_resume"]
    (trainer,) = train_image_vae.main(argv)
    assert trainer.hparams.dec_dist == "gaussian"
    n_steps = int(0.7 * len(packed)) // 16
    assert trainer.step == n_steps and len(trainer.history) == 1
    (tested,) = train_image_vae.main(argv + ["--test", "--log"])
    assert tested.history == [] and tested.step == n_steps  # restored, not trained
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(tested.model.state_dict()[k], v), k
