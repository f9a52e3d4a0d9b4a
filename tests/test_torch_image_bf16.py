"""The image VAEs' ``compute_dtype`` (the image CLI's ``--bf16``) against
the JAX models built with ``compute_dtype=jnp.bfloat16``.

From the same converted weights (random biases, so a misplaced one
shows) and the same ε, in eval mode (MnistVAE at dropout 0.5): the
logits, ``z_mean`` and ``z_log_std`` leave as float32 and agree within
2e-2 of the largest magnitude of each (measured at weight seeds 0-2:
at most 1.02% on MNIST's logits, 0.90% on dSprites' ``z_log_std``, the
mean difference 0.08-0.30%; both packages round each bfloat16 layer's
output, but a sum that lands next to a rounding boundary rounds the
other way in another summation order, and the flip carries through the
later layers). Flax's SELU rounds its constants to
bfloat16: the port computes it the same way, bitwise (an ATen SELU is
0.4% above it, 2.6-3.7% on MNIST's logits after eight layers). The float32
default is bitwise the module-by-module forward and backward that the
models ran before ``compute_dtype`` existed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.models.image_vae import MnistVAE as FlaxMnistVAE
from arvae_tpu_torch import train_image_vae
from arvae_tpu_torch.data.dsprites import generate_dsprites
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE, _selu_as_flax
from arvae_tpu_torch.utils.convert import dsprites_vae_from_flax, mnist_vae_from_flax

BF16_RTOL = 2e-2
B = 16
MODELS = {
    "dsprites": (FlaxDspritesVAE, DspritesVAE, dsprites_vae_from_flax, 64, 10),
    "mnist": (FlaxMnistVAE, MnistVAE, mnist_vae_from_flax, 28, 16),
}


def _setup(kind, seed=0):
    flax_cls, port_cls, convert, side, z = MODELS[kind]
    rngs = {"params": jax.random.key(seed), "dropout": jax.random.key(1),
            "sample": jax.random.key(2)}
    params = flax_cls().init(rngs, jnp.zeros((1, 1, side, side)), train=True)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed + 1)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.05 * rng.randn(*np.shape(x)).astype(np.float32)) for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    rng = np.random.RandomState(5)
    x = (rng.rand(B, 1, side, side) > 0.5).astype(np.float32)
    eps = rng.randn(B, z).astype(np.float32)
    return flax_cls, port_cls, convert(params), params, x, eps


@pytest.mark.parametrize("kind", list(MODELS))
def test_bf16_forward_matches_flax_bf16(kind):
    flax_cls, port_cls, sd, params, x, eps = _setup(kind)
    fm = flax_cls(compute_dtype=jnp.bfloat16)
    mean, log_std = fm.apply({"params": params}, jnp.asarray(x), train=False, method="encode")
    z_tilde = mean + jnp.exp(log_std) * jnp.asarray(eps)
    logits = fm.apply({"params": params}, z_tilde, train=False, method="decode")
    port = port_cls(compute_dtype=torch.bfloat16)
    port.load_state_dict(sd)
    port.eval()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(eps))
    for name, want, got in (("logits", logits, out.logits), ("z_mean", mean, out.z_mean),
                            ("z_log_std", log_std, out.z_log_std)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=BF16_RTOL * np.abs(want).max(), err_msg=name)
    # and it is a bf16 computation: float32's logits are further off
    f32 = port_cls()
    f32.load_state_dict(sd)
    f32.eval()
    with torch.no_grad():
        plain = f32(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(eps)).logits
    assert not torch.equal(plain, out.logits)


def test_bf16_selu_is_flax_bitwise():
    x = jnp.asarray(np.linspace(-6, 3, 20001, dtype=np.float32)).astype(jnp.bfloat16)
    want = np.asarray(flax_nn.selu(x).astype(jnp.float32))
    got = _selu_as_flax(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _plain_forward(model, x, eps, masks):
    """The float32 forward module by module, as the models ran it before
    they took a compute dtype: each Sequential called as it is."""
    if isinstance(model, MnistVAE):
        def stack(seq, h, ms):
            layers = list(seq)
            for j, i in enumerate(range(0, len(layers), 3)):
                h = layers[i](h)
                if i + 2 < len(layers):
                    h = layers[i + 2](layers[i + 1](h), ms[j] if ms else None)
            return h
        h = model.enc_lin(stack(model.enc_conv, x, masks and masks[:3]).flatten(1))
        mean, log_std = model.enc_mean(h), model.enc_log_std(h)
        z = mean + torch.exp(log_std) * eps
        return stack(model.dec_conv, model.dec_lin(z).view(-1, 8, 19, 19),
                     masks and masks[3:]), mean, log_std
    h = model.enc_lin(model.enc_conv(x).flatten(1))
    mean, log_std = model.enc_mean(h), model.enc_log_std(h)
    z = mean + torch.exp(log_std) * eps
    return model.dec_conv(model.dec_lin(z).view(-1, 32, 4, 4)), mean, log_std


@pytest.mark.parametrize("kind", list(MODELS))
def test_f32_default_is_bitwise_the_plain_forward_and_backward(kind):
    _, port_cls, sd, _, x, eps = _setup(kind, seed=3)
    x, eps = torch.from_numpy(x), torch.from_numpy(eps)
    grads = []
    for run in ("model", "plain"):
        model = port_cls()
        assert model.compute_dtype == torch.float32
        model.load_state_dict(sd)
        model.train()
        masks = (model.dropout_masks(B, torch.Generator().manual_seed(0), "cpu")
                 if kind == "mnist" else None)
        if run == "model":
            out = model(x, eps, eps, *([masks] if kind == "mnist" else []))
            outs = out.logits, out.z_mean, out.z_log_std
        else:
            outs = _plain_forward(model, x, eps, masks)
        sum(o.square().sum() for o in outs).backward()
        grads.append((outs, {n: p.grad for n, p in model.named_parameters()}))
    (got, dgot), (want, dwant) = grads
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(dgot[n], dwant[n]) for n in dwant)


def test_cli_bf16_trains_in_bf16_in_the_same_run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    root = tmp_path / "datasets" / "dsprites"
    root.mkdir(parents=True)
    packed, latents = generate_dsprites((1, 3, 2, 2, 4, 4))
    np.savez_compressed(root / "dsprites_synth_1x3x3x10x16x16.npz", packed=packed,
                        latents=latents)
    argv = ["--device", "cpu", "-d", "dsprites", "--short", "--rand", "0", "-r", "all",
            "--beta", "1.0", "--batch_size", "16", "--num_epochs", "1"]
    assert not train_image_vae.parse_args(argv).bf16
    assert train_image_vae.parse_args(argv + ["--bf16", "--f32"]).bf16 is False
    (trainer,) = train_image_vae.main(argv + ["--bf16"])
    assert trainer.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert trainer.run_dir.endswith("DspritesVAE_r_0_b_1.0_g_10.0_d_1.0_all_")
    assert np.isfinite(trainer.history[0]["train_loss"])
    assert np.isfinite(trainer.metrics["test_loss"])
