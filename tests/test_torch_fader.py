"""The port's fader networks and ``ImageFaderTrainer`` against the JAX
package's, from the same weights and batches.

- ``fader_from_flax`` and ``fader_discriminator_from_flax`` are exact
  inverses of the other direction, written here (the JAX package has no
  fader converter): the VAE converters of ``utils/torch_convert.py``
  without ``enc_log_std``. The port's networks hold exactly the Flax
  init's leaves: no ``enc_log_std``, a decoder input of 22 (MNIST, 16 +
  6) or 15 (dSprites, 10 + 5).
- The forward, ``encode_deterministic`` and the discriminator in eval
  mode within atol 1e-5 (float32 convolutions summed in another order,
  as ``tests/test_torch_mnist_vae.py``).
- Five steps of the port's trainer against JAX's ``ImageFaderTrainer``
  with both networks at dropout 0: ``loss``, ``recons_loss``,
  ``adv_loss`` and ``disc_loss`` within rtol 1e-4, atol 1e-6, and each
  parameter's change, of both networks, by the rule of
  ``tests/test_torch_mnist_vae.py``: within lr/10 for all but
  ``AMPLIFIED_SHARE`` of the parameters, within lr where the gradient
  is not within float32 rounding of 0, within 2·5·lr everywhere. A
  trainer that steps the fader before the discriminator fails that
  comparison.
- The port's own dropout apart: the discriminator's Dense → Dropout →
  SELU order, about half the entries zeroed, a re-seeded step bitwise.
- ``normalize_labels`` bitwise JAX's; the harvest (z within atol 1e-5,
  the attributes within one float32 rounding, ``ATTR_RTOL``) and
  ``results_dict.json`` (the same keys, no test pass; the metrics within
  1e-12 of JAX's on the same arrays) from the same weights and eval
  split; the CLI with ``--device cpu``
  for one epoch, ``--resume`` and ``--test``.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.data.dsprites import DspritesDataset as JaxDsprites
from arvae_tpu.data.dsprites import generate_dsprites
from arvae_tpu.models import DspritesFaderNetwork as FlaxDspritesFader
from arvae_tpu.models import ImageFaderDiscriminator as FlaxDisc
from arvae_tpu.models import MnistFaderNetwork as FlaxMnistFader
from arvae_tpu.parallel import create_mesh
from arvae_tpu.training.fader_trainer import ImageFaderTrainer as JaxFaderTrainer
from arvae_tpu.utils.torch_convert import (convert_dsprites_vae, convert_mnist_vae,
                                           torch_state_dict_to_numpy)
from arvae_tpu_torch import train_image_fader
from arvae_tpu_torch.data.dsprites import DspritesDataset
from arvae_tpu_torch.data.morphomnist.measure import measure_batch
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set
from arvae_tpu_torch.models.image_fader import (DspritesFaderNetwork, ImageFaderDiscriminator,
                                               MnistFaderNetwork)
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.utils.convert import fader_discriminator_from_flax, fader_from_flax

ATOL = 1e-5
LR, B, STEPS = 1e-4, 8, 5
NEAR_ZERO = 1e-4
AMPLIFIED_SHARE = 1e-4
# XLA turns the jitted harvest's division by the constant span into a
# product with its reciprocal: one float32 rounding apart (3.75% of the
# entries measured); eager, JAX's normalize_labels is the port's bitwise
ATTR_RTOL = 2e-7
CPU = torch.device("cpu")


class MorphoMnistDataset:
    """Only its class name: how JAX's trainer tells MNIST apart."""


class _DspritesName:
    pass


_DspritesName.__name__ = "DspritesDataset"

KINDS = {
    "mnist": dict(flax=FlaxMnistFader, port=MnistFaderNetwork, dataset=MorphoMnistDataset,
                  convert=convert_mnist_vae, side=28, z=16, a=6, dec_in=22),
    "dsprites": dict(flax=FlaxDspritesFader, port=DspritesFaderNetwork,
                     dataset=_DspritesName, convert=convert_dsprites_vae, side=64, z=10, a=5,
                     dec_in=15),
}


def fader_to_flax(sd, kind):
    """The port's fader ``state_dict`` → Flax params: the JAX VAE
    converter given a stand-in log-std head, which is then dropped."""
    sd = torch_state_dict_to_numpy(sd)
    sd.update({"enc_log_std.weight": sd["enc_mean.weight"],
               "enc_log_std.bias": sd["enc_mean.bias"]})
    params = dict(KINDS[kind]["convert"](sd))
    del params["enc_log_std"]
    return params


def disc_to_flax(sd):
    sd = torch_state_dict_to_numpy(sd)
    return {f"Dense_{i}": {"kernel": sd[f"layers.{idx}.weight"].T,
                           "bias": sd[f"layers.{idx}.bias"]}
            for i, idx in enumerate((0, 3, 6))}


def _randomize_biases(tree, seed):
    """Zero biases would hide a misplaced one."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.RandomState(seed)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.05 * rng.randn(*np.shape(x)).astype(np.float32)) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _jax_trainer(kind, dropout_rate=0.0, rand=0, dataset=None, mesh=None):
    k = KINDS[kind]
    model = (k["flax"](dropout_rate=dropout_rate) if kind == "mnist" else k["flax"]())
    jt = JaxFaderTrainer(dataset or k["dataset"](), model,
                         disc_model=FlaxDisc(k["a"], dropout_rate=dropout_rate), lr=LR,
                         beta=1.0, rand=rand, mesh=mesh)
    state = jt.ensure_state()
    state = state.replace(params=_randomize_biases(state.params, rand + 1),
                          disc_params=_randomize_biases(state.disc_params, rand + 2))
    jt.state = state
    return jt, state


def _port_from(kind, state, dropout_rate=0.0):
    k = KINDS[kind]
    model = (k["port"](dropout_rate=dropout_rate) if kind == "mnist" else k["port"]())
    model.load_state_dict(fader_from_flax(state.params))
    disc = ImageFaderDiscriminator(k["a"], k["z"], dropout_rate=dropout_rate)
    disc.load_state_dict(fader_discriminator_from_flax(state.disc_params))
    return model, disc


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_is_exact_and_the_leaves_are_flax_init(kind):
    k = KINDS[kind]
    _, state = _jax_trainer(kind, rand=3)
    model, disc = _port_from(kind, state)
    for got, want in ((fader_to_flax(model.state_dict(), kind), state.params),
                      (disc_to_flax(disc.state_dict()), state.disc_params)):
        want = jax.tree_util.tree_leaves_with_path(want)
        got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert sorted(map(str, got)) == sorted(str(p) for p, _ in want)
        for path, w in want:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(w))
    assert "enc_log_std" not in state.params
    assert not any(n.startswith("enc_log_std") for n in model.state_dict())
    assert state.params["dec_denses_0"]["kernel"].shape == (k["dec_in"], 256)
    assert model.dec_lin[0].in_features == k["dec_in"]
    # the port's own init holds the same leaves
    fresh = k["port"]()
    assert {n: tuple(v.shape) for n, v in fresh.state_dict().items()} == \
        {n: tuple(v.shape) for n, v in model.state_dict().items()}
    assert sorted(disc.state_dict()) == [f"layers.{i}.{w}" for i in (0, 3, 6)
                                         for w in ("bias", "weight")]


def _images(kind, n, seed):
    if kind == "mnist":
        imgs, digits = generate_digit_set(n, seed=seed)
        morpho = measure_batch((imgs[:, 0] * 255).astype(np.uint8)).astype(np.float32)
        return imgs, np.concatenate([digits[:, None].astype(np.float32), morpho], 1)
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, 1, 64, 64) > 0.7).astype(np.float32)
    values = [np.ones(1), np.arange(1, 4.0), np.linspace(0.5, 1.0, 6),
              np.linspace(0, 2 * np.pi, 40), np.linspace(0, 1, 32), np.linspace(0, 1, 32)]
    labels = np.stack([rng.choice(v, n) for v in values], 1).astype(np.float32)
    return imgs, labels


@pytest.mark.parametrize("kind", list(KINDS))
def test_eval_forward_matches_flax(kind):
    k = KINDS[kind]
    jt, state = _jax_trainer(kind, dropout_rate=0.5, rand=1)
    model, disc = _port_from(kind, state, dropout_rate=0.5)
    model.eval()
    imgs, labels = _images(kind, B, seed=4)
    norm = np.array(jt.normalize_labels(jnp.asarray(labels)))
    x = jnp.asarray(imgs)
    logits, z = jt.model.apply({"params": state.params}, x, jnp.asarray(norm), train=False)
    z_det = jt.model.apply({"params": state.params}, x, train=False,
                           method="encode_deterministic")
    pred = jt.disc_model.apply({"params": state.disc_params}, z_det, train=False)
    with torch.no_grad():
        got_logits, got_z = model(torch.from_numpy(imgs), torch.from_numpy(norm))
        got_det = model.encode_deterministic(torch.from_numpy(imgs))
        got_pred = disc(got_det)
    assert got_logits.shape == (B, 1, k["side"], k["side"]) and got_pred.shape == (B, k["a"])
    for want, got in ((logits, got_logits), (z, got_z), (z_det, got_det), (pred, got_pred)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_normalize_labels_is_jax_bitwise(kind):
    jt, _ = _jax_trainer(kind)
    tr = ImageFaderTrainer(None, KINDS[kind]["port"](), CPU)
    _, labels = _images(kind, 64, seed=2)
    got = tr.normalize_labels(torch.from_numpy(labels))
    want = np.asarray(jt.normalize_labels(jnp.asarray(labels)))
    assert got.dtype == torch.float32 and got.shape == (64, KINDS[kind]["a"])
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "dsprites":  # factors on their grids (morphometry may leave its range)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


class FaderFirst(ImageFaderTrainer):
    """Steps the fader (against the discriminator as it stands), then the
    discriminator: the order the comparison must catch."""

    def train_step(self, batch, noise=None):
        inputs, labels = batch
        self.model.train()
        self.disc.train()
        norm = self.normalize_labels(labels)
        loss, metrics = self._fader_losses(inputs, norm)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=self._fader_params)
        self.optimizer.step()
        with torch.no_grad():
            z = self.model.encode_deterministic(inputs)
        disc_loss = self.compute_disc_loss(self.disc(z), norm)
        self.disc_optimizer.zero_grad(set_to_none=True)
        disc_loss.backward()
        self.disc_optimizer.step()
        self.step += 1
        metrics["disc_loss"] = disc_loss
        return {k: v.detach() for k, v in metrics.items()}


def _jax_step(jt):
    """JAX's train step, and the gradients each of its updates took."""

    @jax.jit
    def step(state, inputs, labels):
        batch, key = (inputs, labels), jax.random.key(0)
        new, metrics = jt._train_step_core(state, batch, key)
        norm = jt.normalize_labels(labels)
        z = jt.model.apply({"params": state.params}, inputs, train=True,
                           rngs={"dropout": key}, method="encode_deterministic")
        disc_grads = jax.grad(lambda dp: jt.compute_disc_loss(
            jt.disc_model.apply({"params": dp}, z, train=True), norm))(state.disc_params)
        grads = jax.grad(lambda p: jt._fader_losses(p, new.disc_params, batch, key, True)[0])(
            state.params)
        return new, metrics, grads, disc_grads

    return step


def _changes_disagree(start, end, got, near_zero):
    """The parameter-change rule of ``tests/test_torch_mnist_vae.py`` →
    the reasons it fails (empty when it holds)."""
    start = dict(jax.tree_util.tree_leaves_with_path(start))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    nz = dict(jax.tree_util.tree_leaves_with_path(near_zero))
    out, beyond, total = [], 0, 0
    for path, w in jax.tree_util.tree_leaves_with_path(end):
        want = np.asarray(w) - np.asarray(start[path])
        assert np.abs(want).max() > LR / 2, f"{path} did not move in JAX"
        err = np.abs(np.asarray(got[path]) - np.asarray(start[path]) - want)
        if err.max() > 2 * STEPS * LR:
            out.append(f"{path}: {err.max()} > {2 * STEPS * LR}")
        if not np.all(err[nz[path] >= NEAR_ZERO] <= LR):
            out.append(f"{path}: {err[nz[path] >= NEAR_ZERO].max()} > lr")
        beyond += int((err > LR / 10).sum())
        total += err.size
    if beyond > AMPLIFIED_SHARE * total:
        out.append(f"{beyond} of {total} changes beyond lr/10")
    return out


def _five_steps_against_jax(kind, trainer_cls):
    """Five steps of ``trainer_cls`` and of JAX's trainer from the same
    weights → the reasons they disagree (empty when they agree)."""
    jt, state = _jax_trainer(kind)
    model, disc = _port_from(kind, state)
    trainer = trainer_cls(None, model, CPU, disc_model=disc, lr=LR, beta=1.0, rand=0)
    assert trainer.model_repr() == jt.model_repr() == \
        f"{KINDS[kind]['flax'].__name__[:-7]}_r_0_b_1.0_"
    step = _jax_step(jt)
    start, disc_start = state.params, state.disc_params
    near = [None, None]
    failures = []
    imgs, labels = _images(kind, B * STEPS, seed=7)
    for i in range(STEPS):
        x, y = imgs[i * B:(i + 1) * B], labels[i * B:(i + 1) * B]
        state, jm, grads, disc_grads = step(state, jnp.asarray(x), jnp.asarray(y))
        for j, g in enumerate((grads, disc_grads)):
            rel = jax.tree_util.tree_map(lambda a: np.abs(a) / np.abs(a).max(), g)
            near[j] = rel if near[j] is None else jax.tree_util.tree_map(np.minimum, near[j],
                                                                         rel)
        tm = trainer.train_step((torch.from_numpy(x), torch.from_numpy(y)))
        assert list(tm) == ["loss", "accuracy", "recons_loss", "adv_loss", "disc_loss"]
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "recons_loss", "adv_loss", "disc_loss"):
            if not np.isclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6):
                failures.append(f"step {i} {k}: {float(tm[k])} vs JAX {float(jm[k])}")
    assert trainer.step == STEPS == int(state.step)
    failures += _changes_disagree(start, state.params,
                                  fader_to_flax(trainer.model.state_dict(), kind), near[0])
    failures += _changes_disagree(disc_start, state.disc_params,
                                  disc_to_flax(trainer.disc.state_dict()), near[1])
    return failures


@pytest.mark.parametrize("kind", list(KINDS))
def test_five_steps_match_jax_trainer(kind):
    assert _five_steps_against_jax(kind, ImageFaderTrainer) == []


@pytest.mark.parametrize("kind", list(KINDS))
def test_fader_before_discriminator_fails_the_comparison(kind):
    assert _five_steps_against_jax(kind, FaderFirst)


def test_discriminator_dropout_comes_before_selu():
    disc = ImageFaderDiscriminator(6, 16, seed=2)
    masks = disc.dropout_masks(4096, torch.Generator().manual_seed(0), CPU)
    assert [tuple(m.shape) for m in masks] == [(4096, 64), (4096, 32)]
    kept = torch.cat([m.flatten() for m in masks]).float().mean()
    assert abs(float(kept) - 0.5) < 0.01
    z = torch.randn(4096, 16)
    lin = disc.layers
    with torch.no_grad():
        got = disc(z, masks)
        h = z
        for j, i in enumerate((0, 3)):
            h = torch.nn.functional.selu(torch.where(masks[j], 2 * lin[i](h), 0.0))
        want = torch.sigmoid(lin[6](h))
        h = z
        for j, i in enumerate((0, 3)):
            h = torch.where(masks[j], 2 * torch.nn.functional.selu(lin[i](h)), 0.0)
        swapped = torch.sigmoid(lin[6](h))
    assert torch.equal(got, want)
    assert not torch.allclose(got, swapped, atol=1e-3)
    assert not torch.allclose(got, disc(z), atol=1e-3)


def test_step_draws_the_jax_number_of_masks_and_repeats_bitwise():
    imgs, labels = _images("mnist", B, seed=3)
    batch = (torch.from_numpy(imgs), torch.from_numpy(labels))
    tr = ImageFaderTrainer(None, MnistFaderNetwork(seed=4), CPU, rand=3)
    noise = tr.draw_train_noise(B, torch.Generator().manual_seed(0))
    assert [len(m) for m in noise] == [3, 2, 5, 2]
    assert [tuple(m.shape[1:]) for m in noise.enc] == [(64, 25, 25), (64, 22, 22), (8, 19, 19)]
    dsp = ImageFaderTrainer(None, DspritesFaderNetwork(), CPU)
    assert [m is None or len(m) for m in dsp.draw_train_noise(B)] == [True, 2, True, 2]
    runs = []
    for _ in range(2):
        tr = ImageFaderTrainer(None, MnistFaderNetwork(seed=4), CPU, rand=3)
        metrics = tr.train_step(batch)
        runs.append((metrics, tr.model.state_dict(), tr.disc.state_dict()))
    (m1, s1, d1), (m2, s2, d2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    other = ImageFaderTrainer(None, MnistFaderNetwork(seed=4), CPU, rand=4)
    assert not torch.equal(other.train_step(batch)["loss"], m1["loss"])


def test_fader_gradient_does_not_reach_the_discriminator():
    imgs, labels = _images("dsprites", B, seed=5)
    tr = ImageFaderTrainer(None, DspritesFaderNetwork(), CPU, rand=0)
    before = {k: v.clone() for k, v in tr.disc.state_dict().items()}
    tr.train_step((torch.from_numpy(imgs), torch.from_numpy(labels)))
    # the discriminator's gradients are its own step's: recompute them
    after = {k: v.clone() for k, v in tr.disc.state_dict().items()}
    dgrads = {n: p.grad.clone() for n, p in tr.disc.named_parameters()}
    tr2 = ImageFaderTrainer(None, DspritesFaderNetwork(), CPU, rand=0)
    tr2.disc.load_state_dict(before)
    noise = tr2.draw_train_noise(B)
    with torch.no_grad():
        z = tr2.model.encode_deterministic(torch.from_numpy(imgs))
    norm = tr2.normalize_labels(torch.from_numpy(labels))
    tr2.compute_disc_loss(tr2.disc(z, noise.disc), norm).backward()
    for n, p in tr2.disc.named_parameters():
        assert torch.equal(p.grad, dgrads[n]), n
    assert any(not torch.equal(before[k], after[k]) for k in before)


# -- the evaluation ---------------------------------------------------------------

TINY = (1, 3, 2, 2, 4, 4)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    return tmp_path


def _dsprites_pair(root, n_rows):
    """A JAX and a port DspritesDataset holding the same random rows."""
    rng = np.random.RandomState(n_rows)
    packed = rng.randint(0, 256, (n_rows, 512)).astype(np.uint8)
    _, latents = _images("dsprites", n_rows, seed=n_rows)
    order = rng.permutation(n_rows)
    pair = JaxDsprites(root=root, factor_sizes=TINY), DspritesDataset(root=root,
                                                                      factor_sizes=TINY)
    for ds in pair:
        ds.packed, ds.latents, ds._order = packed, latents, order
    return pair


def test_harvest_and_results_dict_match_jax(dirs):
    jds, ds = _dsprites_pair(str(dirs / "dsp"), 4200)
    jt, state = _jax_trainer("dsprites", dataset=jds, mesh=create_mesh(jax.devices()[:1]))
    model, disc = _port_from("dsprites", state)
    tr = ImageFaderTrainer(ds, model, CPU, disc_model=disc, beta=1.0, rand=0)
    assert tr.eval_split().n == 210
    # B=128: one whole batch of 210 rows, the tail left out; B=1: the 201-batch cap
    for bs, rows in ((128, 128), (1, 201)):
        jz, jattrs, jnames = jt.compute_representations(None, batch_size=bs)
        z, attrs, names = tr.compute_representations(batch_size=bs)
        assert names == jnames == ["shape", "scale", "orientation", "posx", "posy"]
        assert z.shape == jz.shape == (rows, 10) and z.dtype == np.float32
        np.testing.assert_allclose(z, jz, rtol=0, atol=ATOL)
        np.testing.assert_allclose(attrs, jattrs, rtol=ATTR_RTOL, atol=0)

    for t in (jt, tr):
        t._train_protocol = {"num_epochs": 1, "batch_size": 16}
    # the two packages' suites on the same arrays, each writing its own file
    tr.compute_representations = lambda: (jz, jattrs, jnames)
    jt.compute_representations = lambda *a, **k: (jz, jattrs, jnames)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.random.seed(0)
        want = json.loads(json.dumps(jt.compute_eval_metrics(batch_size=16)))
        got = tr.compute_eval_metrics(batch_size=16)
    assert os.path.basename(jt.run_dir) == os.path.basename(tr.run_dir)
    assert jt.run_dir != tr.run_dir
    with open(tr.results_path) as fh:
        on_disk = json.load(fh)
    assert on_disk == json.loads(json.dumps(got))
    assert list(on_disk) == list(want) == ["interpretability", "Corr_score",
                                           "modularity_score", "mig", "SAP_score", "protocol"]
    assert on_disk["protocol"] == want["protocol"]
    assert list(on_disk["interpretability"]) == list(want["interpretability"])
    for k, v in want["interpretability"].items():
        assert on_disk["interpretability"][k][0] == v[0]
        assert on_disk["interpretability"][k][1] == pytest.approx(v[1], abs=1e-12)
    for k in ("Corr_score", "modularity_score", "mig", "SAP_score"):
        assert on_disk[k] == pytest.approx(want[k], abs=1e-12), k
    assert tr.compute_eval_metrics() == on_disk  # the cache, as it is


def test_cli_trains_resumes_and_tests(dirs, capsys):
    root = dirs / "datasets" / "dsprites"
    root.mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(root / "dsprites_synth_1x3x3x10x16x16.npz", packed=packed,
                        latents=latents)
    argv = ["--device", "cpu", "-d", "dsprites", "--short", "--batch_size", "16",
            "--num_epochs", "1", "--beta", "1.0"]
    args = train_image_fader.parse_args([])
    assert (args.dataset_type, args.batch_size, args.num_epochs, args.lr, args.beta,
            args.do_train, args.log, args.resume, args.rand, args.short, args.device) == (
        "mnist", 128, 100, 1e-4, 4.0, True, False, False, 0, False, "cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = train_image_fader.main(argv)
        steps = first.step
        assert first.run_dir.endswith("DspritesFader_r_0_b_1.0_")
        res = json.loads(capsys.readouterr().out.split("Valid Accuracy:")[-1].split("\n", 1)[1])
        assert list(res) == ["interpretability", "Corr_score", "modularity_score", "mig",
                             "SAP_score", "protocol"]
        assert res["protocol"]["num_epochs"] == 1 and np.isfinite(res["mig"])
        ckpt = torch.load(os.path.join(first.run_dir, "ckpt.pt"), weights_only=True)
        assert {"model", "optimizer", "disc", "disc_optimizer", "step"} <= set(ckpt)
        assert ckpt["disc_optimizer"]["state"] and ckpt["step"] == steps
        h = first.history[0]
        assert np.isfinite(h["train_loss"]) and steps == h["train_steps"] > 0

        resumed = train_image_fader.main(argv + ["--resume"])
        assert resumed.step == 2 * steps
        for a, b in ((first.disc, resumed.disc),):
            assert not all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                             b.state_dict().values()))
        os.remove(resumed.results_path)
        tested = train_image_fader.main(argv + ["--test"])
    assert tested.history == [] and tested.step == resumed.step
    for n, p in tested.disc.state_dict().items():
        assert torch.equal(p, resumed.disc.state_dict()[n])
    again = tested.metrics
    assert again["protocol"]["num_epochs"] is None
    assert {k: v for k, v in again.items() if k != "protocol"} == \
        {k: v for k, v in resumed.metrics.items() if k != "protocol"}
