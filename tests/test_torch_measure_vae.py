"""The port's MeasureVAE against the JAX package's, from the same weights.

``measure_vae_from_flax`` must be the exact inverse of
``convert_measure_vae``. Then the port, loaded with converted weights,
runs one forward with the draws the JAX model makes for itself: the test
splits JAX's key as ``MeasureVAE.__call__`` and
``HierarchicalDecoder.__call__`` split it (``k_enc, k_rep, k_prior,
k_dec``, then ``k_tf, k_drop, k_samp``) and hands the port ε, ε_prior
and the teacher-forcing coin. Both dropout rates are 0: the two packages
draw dropout bits differently (``tests/test_torch_hier_decoder.py``
checks the port's own). The JAX side runs its XLA scan decoder.

Tolerances: rtol 1e-5 / atol 1e-5 on the weights, latents and priors
(a biGRU encoder, a beat GRU and 24 tick steps, sums in another order);
samples exactly. Widths are cut to H=32, z=8, B=8 (V=34, the synthetic
folk vocabulary), so the test runs in seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.utils.torch_convert import (convert_measure_vae,
                                           torch_state_dict_to_numpy)
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

V, E, H, Z, B, T = 34, 10, 32, 8, 8, 24
WIDTHS = dict(num_notes=V, note_embedding_dim=E, num_encoder_layers=2,
              encoder_hidden_size=H, encoder_dropout_prob=0.0, latent_space_dim=Z,
              num_decoder_layers=2, decoder_hidden_size=H, decoder_dropout_prob=0.0)


def _flax_params(seed=0):
    model = FlaxMeasureVAE(**WIDTHS)
    k = jax.random.split(jax.random.key(seed), 3)
    params = model.init({"params": k[0], "sample": k[1], "dropout": k[2]},
                        jnp.zeros((1, T), jnp.int32), train=True)["params"]
    # zero-initialised biases and learned inputs would hide a misplaced
    # bias: give them random values (the weights keep their Xavier init)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed + 1)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.1 * rng.randn(*np.shape(x)).astype(np.float32))
              for x in leaves]
    return model, jax.tree_util.tree_unflatten(tree, leaves)


def _jax_draws(key, train):
    """ε, ε_prior and the teacher coin as the JAX model draws them."""
    _, k_rep, k_prior, k_dec = jax.random.split(key, 4)
    eps = jax.random.normal(k_rep, (B, Z), jnp.float32)
    eps_prior = jax.random.normal(k_prior, (B, Z), jnp.float32)
    k_tf = jax.random.split(k_dec, 3)[0]
    teacher = bool(jax.random.uniform(k_tf, ()) < 0.5) if train else False
    return MeasureNoise(torch.tensor(np.asarray(eps)), torch.tensor(np.asarray(eps_prior)),
                        torch.tensor([int(teacher)], dtype=torch.int32),
                        torch.tensor([7], dtype=torch.int32)), teacher


def test_measure_vae_from_flax_inverts_convert_exactly():
    _, params = _flax_params()
    port = MeasureVAE(**WIDTHS)
    sd = measure_vae_from_flax(params)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    back = convert_measure_vae(torch_state_dict_to_numpy(port.state_dict()))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        assert np.array_equal(np.asarray(got[path]), np.asarray(w)), path


@pytest.mark.parametrize("train,key_seed", [(True, 3), (True, 1), (False, 0)],
                         ids=["train_teacher", "train_free", "eval"])
def test_forward_matches_jax_with_injected_draws(train, key_seed):
    model, params = _flax_params()
    score = np.random.RandomState(4).randint(0, V, (B, T)).astype(np.int32)
    key = jax.random.key(key_seed)
    noise, teacher = _jax_draws(key, train)
    if train:  # each id covers one decoder path
        assert teacher == (key_seed == 3)
    want = model.apply({"params": params}, jnp.asarray(score), train=train, rng_key=key)

    port = MeasureVAE(**WIDTHS)
    port.load_state_dict(measure_vae_from_flax(params))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(score), noise)
    for name in ("z_mean", "z_log_std", "z_tilde", "z_prior", "weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.samples.numpy(), np.asarray(want.samples))
    if teacher:
        np.testing.assert_array_equal(got.samples.numpy(), score)


def test_out_of_range_ids_clamp_and_sr_decoders_wait():
    port = MeasureVAE(**WIDTHS).eval()
    noise = MeasureNoise(torch.zeros(2, Z), torch.zeros(2, Z),
                         torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    score = torch.full((2, T), V - 1)
    with torch.no_grad():
        want = port(score, noise)
        score[:, 3] = V + 5  # clamps to the last table row, as take(mode="clip")
        got = port(score, noise)
    torch.testing.assert_close(got.z_mean, want.z_mean, rtol=0, atol=0)
    # both SR decoders build and run, on the clamped ids too, in both modes
    for kind in ("sr", "sr-no-input"):
        sr = MeasureVAE(**dict(WIDTHS, decoder_type=kind))
        for train in (True, False):
            with torch.no_grad():
                out = sr.train(train)(score, noise)
            assert out.weights.shape == (2, T, V) and out.samples.shape == (2, T)
            assert bool(torch.isfinite(out.weights).all())
            assert int(out.samples.min()) >= 0 and int(out.samples.max()) < V
    with pytest.raises(ValueError, match="decoder_type"):
        MeasureVAE(**dict(WIDTHS, decoder_type="rnn"))
