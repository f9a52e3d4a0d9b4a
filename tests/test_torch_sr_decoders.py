"""The port's SR decoders (``SRDecoder``, ``SRDecoderNoInput``) against the
JAX package's, from the same weights.

The JAX ``MeasureVAE`` with ``decoder_type`` ``sr`` or ``sr-no-input`` is
initialised, its biases and learned inputs given random values (a zero
bias would hide a misplaced one), and ``measure_vae_from_flax`` loads
the same parameters into the port. Both decoders run through
``decode`` in three modes: training teacher-forced, training
free-running and eval (free-running argmax, no dropout); the teacher
coin is the one JAX draws from the key (``SRDecoder`` splits its key as
``k_tf, k_drop, k_samp``). Both dropout rates are 0: the packages draw
dropout bits differently. On the CPU the JAX decoders take their
``lax.scan`` route, as the package's own tests run them. Then one
``MeasureVAE`` forward per decoder type, with JAX's draws injected.

Widths are cut to H=32, z=8, B=8, V=20 (two layers; three for one case
of each decoder), so the file runs in seconds.

Tolerances: weights, latents and priors rtol 1e-5 / atol 1e-5 (24
recurrent steps, sums in another order); samples exactly; the
gradients of the decoder's parameters and of z under a random
cotangent rtol 1e-4 / atol 1e-5, as ``tests/test_torch_measure_vae.py``
and ``tests/test_torch_hier_decoder.py`` hold them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

V, E, H, Z, B, T = 20, 10, 32, 8, 8, 24
KINDS = ("sr", "sr-no-input")
# (train, key seed): the seeds give a teacher-forced and a free-running coin
MODES = {"train_teacher": (True, 3), "train_free": (True, 1), "eval": (False, 0)}


def _widths(kind, layers=2):
    return dict(num_notes=V, note_embedding_dim=E, num_encoder_layers=2,
                encoder_hidden_size=H, encoder_dropout_prob=0.0, latent_space_dim=Z,
                num_decoder_layers=layers, decoder_hidden_size=H,
                decoder_dropout_prob=0.0, decoder_type=kind)


def _models(kind, layers=2, seed=0):
    """The JAX model and params, and the port loaded with the same."""
    model = FlaxMeasureVAE(**_widths(kind, layers))
    k = jax.random.split(jax.random.key(seed), 3)
    params = model.init({"params": k[0], "sample": k[1], "dropout": k[2]},
                        jnp.zeros((1, T), jnp.int32), train=True)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed + 1)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.1 * rng.randn(*np.shape(x)).astype(np.float32))
              for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    port = MeasureVAE(**_widths(kind, layers))
    port.load_state_dict(measure_vae_from_flax(params))
    return model, params, port


def _coin(key, kind, train):
    """The teacher coin the JAX decoder draws from its key."""
    if kind != "sr" or not train:
        return False
    return bool(jax.random.uniform(jax.random.split(key, 3)[0], ()) < 0.5)


def _noise(teacher, eps=None, eps_prior=None):
    zeros = torch.zeros(B, Z)
    return MeasureNoise(zeros if eps is None else eps, zeros if eps_prior is None else eps_prior,
                        torch.tensor([int(teacher)], dtype=torch.int32),
                        torch.tensor([7], dtype=torch.int32))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Z).astype(np.float32),
            rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randn(B, T, V).astype(np.float32))


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_from_flax_fills_every_parameter(kind, layers):
    _, params, port = _models(kind, layers)
    sd = measure_vae_from_flax(params)
    assert set(sd) == set(port.state_dict())
    dec = params["decoder"]
    # spot checks of the layouts: (in, out) kernels transposed, GRU (I, 3H)
    got = port.state_dict()
    np.testing.assert_array_equal(got["decoder.out.weight"].numpy(), np.asarray(dec["out_w"]).T)
    np.testing.assert_array_equal(got[f"decoder.gru.weight_hh_l{layers - 1}"].numpy(),
                                  np.asarray(dec["gru"][layers - 1]["w_hh"]).T)
    if kind == "sr":
        np.testing.assert_array_equal(got["decoder.z2in2.bias"].numpy(),
                                      np.asarray(dec["z2in2_b"]))
        np.testing.assert_array_equal(got["decoder.embedding.weight"].numpy(),
                                      np.asarray(dec["embedding"]))
    else:
        np.testing.assert_array_equal(got["decoder.z2in.weight"].numpy(),
                                      np.asarray(dec["z2in_w"]).T)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_decode_weights_samples_and_grads_match_jax(kind, mode):
    train, key_seed = MODES[mode]
    model, params, port = _models(kind)
    z, score, ct = _inputs(key_seed + 10)
    key = jax.random.key(key_seed)
    teacher = _coin(key, kind, train)
    if kind == "sr" and train:  # each id covers one decoder path
        assert teacher == (mode == "train_teacher")

    def jax_decode(p, zz):
        return model.apply({"params": p}, zz, jnp.asarray(score), train=train, key=key,
                           method="decode")

    (w_jax, s_jax), vjp = jax.vjp(jax_decode, params, jnp.asarray(z))
    g_params, g_z = vjp((jnp.asarray(ct), np.zeros((B, T), jax.dtypes.float0)))

    port.eval()  # decode runs in the mode asked for, whatever the module's
    zt = torch.from_numpy(z).requires_grad_(True)
    w, s = port.decode(zt, torch.from_numpy(score), _noise(teacher), train=train)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))
    if teacher:
        np.testing.assert_array_equal(s.numpy(), score)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_jax), rtol=1e-5, atol=1e-5)

    (w * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_z), rtol=1e-4, atol=1e-5)
    want = measure_vae_from_flax(g_params)
    for name, p in port.named_parameters():
        if name.startswith("decoder."):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_three_layer_decoder_matches_jax(kind):
    model, params, port = _models(kind, layers=3)
    z, score, _ = _inputs(5)
    for train, teacher in ((True, True), (False, False)):
        key = jax.random.key(3)  # a teacher-forced coin for sr in training
        assert _coin(key, kind, train) == (teacher and kind == "sr")
        w_jax, s_jax = model.apply({"params": params}, jnp.asarray(z), jnp.asarray(score),
                                   train=train, key=key, method="decode")
        with torch.no_grad():
            w, s = port.decode(torch.from_numpy(z), torch.from_numpy(score),
                               _noise(teacher and kind == "sr"), train=train)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_jax), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_measure_vae_forward_matches_jax_with_injected_draws(kind, mode):
    train, key_seed = MODES[mode]
    model, params, port = _models(kind)
    score = np.random.RandomState(4).randint(0, V, (B, T)).astype(np.int32)
    key = jax.random.key(key_seed)
    # MeasureVAE.__call__ splits its key as (k_enc, k_rep, k_prior, k_dec)
    _, k_rep, k_prior, k_dec = jax.random.split(key, 4)
    eps = torch.tensor(np.asarray(jax.random.normal(k_rep, (B, Z), jnp.float32)))
    eps_prior = torch.tensor(np.asarray(jax.random.normal(k_prior, (B, Z), jnp.float32)))
    teacher = _coin(k_dec, kind, train)
    want = model.apply({"params": params}, jnp.asarray(score), train=train, rng_key=key)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(score), _noise(teacher, eps, eps_prior))
    for name in ("z_mean", "z_log_std", "z_tilde", "z_prior", "weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.samples.numpy(), np.asarray(want.samples))


def test_sr_no_input_multinomial_draws_from_the_generator():
    _, _, port = _models("sr-no-input")
    port.decoder.sampling = "multinomial"
    z, score, _ = _inputs(6)
    noise = _noise(False)._replace(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        w, s1 = port.decode(torch.from_numpy(z), torch.from_numpy(score), noise, train=True)
        _, s2 = port.decode(torch.from_numpy(z), torch.from_numpy(score), noise, train=True)
        _, s_eval = port.decode(torch.from_numpy(z), torch.from_numpy(score), noise)
    assert not torch.equal(s1, s2)  # a new draw a call from the generator
    assert torch.equal(s_eval, w.argmax(-1).to(torch.int32))  # eval: argmax
    assert s1.dtype == torch.int32 and int(s1.min()) >= 0 and int(s1.max()) < V
