"""The port's ``DspritesVAE`` against the Flax one, from the same weights.

Flax params from ``model.init(seed)`` go through
``dsprites_vae_from_flax`` into the port; ``convert_dsprites_vae`` must
map the port's ``state_dict`` back to exactly the same params, and the
same input and noise must give the same outputs within atol 1e-5
(float32 convolutions summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.utils.torch_convert import (convert_dsprites_vae,
                                           torch_state_dict_to_numpy)
from arvae_tpu_torch.models.image_vae import DspritesVAE, draw_noise
from arvae_tpu_torch.utils.convert import dsprites_vae_from_flax

ATOL = 1e-5


def _flax_params(seed):
    x = jnp.zeros((1, 1, 64, 64), jnp.float32)
    rngs = {"params": jax.random.key(seed), "dropout": jax.random.key(1),
            "sample": jax.random.key(2)}
    return FlaxDspritesVAE().init(rngs, x, train=True)["params"]


def _port_from(params):
    model = DspritesVAE()
    model.load_state_dict(dsprites_vae_from_flax(params))
    return model.eval()


@pytest.mark.parametrize("seed", [0, 3])
def test_flax_round_trip_is_exact(seed):
    params = _flax_params(seed)
    back = convert_dsprites_vae(
        torch_state_dict_to_numpy(_port_from(params).state_dict()))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]),
                                      np.asarray(want))


def test_forward_matches_flax_with_injected_noise():
    params = _flax_params(0)
    model = _port_from(params)
    rng = np.random.RandomState(5)
    x = (rng.rand(8, 1, 64, 64) > 0.5).astype(np.float32)
    eps = rng.randn(8, 10).astype(np.float32)
    eps_prior = rng.randn(8, 10).astype(np.float32)

    flax_model = FlaxDspritesVAE()
    mean, log_std = flax_model.apply({"params": params}, jnp.asarray(x),
                                     train=False, method="encode")
    z_tilde = mean + jnp.exp(log_std) * jnp.asarray(eps)
    logits = flax_model.apply({"params": params}, z_tilde, train=False,
                              method="decode")

    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(eps),
                    torch.from_numpy(eps_prior))
    for want, got in ((logits, out.logits), (mean, out.z_mean),
                      (log_std, out.z_log_std), (z_tilde, out.z_tilde)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(out.z_prior.numpy(), eps_prior)


def test_init_and_noise_are_seeded():
    a, b = DspritesVAE(seed=4), DspritesVAE(seed=4)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith(".bias"):
            assert not va.any()
    assert not torch.equal(DspritesVAE(seed=5).enc_mean.weight,
                           a.enc_mean.weight)
    cpu = torch.device("cpu")
    n1 = draw_noise(4, 10, torch.Generator().manual_seed(0), cpu)
    n2 = draw_noise(4, 10, torch.Generator().manual_seed(0), cpu)
    assert all(torch.equal(p, q) for p, q in zip(n1, n2))
    assert n1[0].shape == (4, 10) and not torch.equal(n1[0], n1[1])
