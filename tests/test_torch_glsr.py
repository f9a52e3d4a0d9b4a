"""The port's GLSR trainer against the JAX package's, from the same weights.

``MeasureVAETrainerGLSR`` of both packages is built on the ``--short``
synthetic folk corpus (V=34) at H=32, z=8, both dropout rates 0 (the
packages draw dropout bits differently). The JAX side's loss is its
trainer's own ``_loss_fn`` / ``compute_glsr_loss``; the port gets the
draws JAX makes from each key: the forward's ε, ε_prior and teacher coin
(``k_fwd``), and the perturbations' U(0, 1) (``k_glsr``), as
``GLSRNoise``. Checked: the surrogate attribute, the GLSR term for both
surrogates, three Adam(1e-4) steps, the run directory and the CLI's
``-r`` rules under ``--glsr``.

Tolerances. The GLSR term is a finite difference: the surrogate of the
two eval decodes, (softmax(w₊) − softmax(w₋)) summed, is divided by
2δ with δ = (1 + U)·1e-3, so the float32 rounding of the two decodes
is multiplied by 250-500, and −log N(g | 100, 1) then scales an error
of g by |g − 100| ≈ 100. The term itself keeps little of it, since the
two decodes round alike: it is held to rtol 1e-6 of its ~5,000, and the
largest gap measured at these widths is 9.8e-8 relative (one float32
ulp). Its gradient keeps more: the difference of the two decodes'
gradients, each with ~1e-6 relative rounding, is divided by 2δ, so each
parameter's gradient is held to JAX's within atol 2e-3 of the leaf's
largest magnitude (the largest gap measured is 9.7e-4, ``x_0``; the AR
trainer's are ~1e-5). The three Adam(1e-4) steps each start from the
JAX side's parameters and Adam moments. A trajectory cannot be
compared: at the first step one update in 73,701 has a gradient whose
sign the rounding does not resolve, Adam moves it by lr either way, and
the GLSR objective's curvature turns that into thousands of differing
updates by the third step (measured: 22% of the elements more than
lr/10 apart, while JAX against itself from parameters perturbed by
1e-7 keeps 0.001%). So each step's new parameters are held to JAX's
within atol lr/10 wherever the two gradients agree within half of
JAX's; the elements where they do not are at most 1e-3 of all (26 of
73,701 measured, 3.5e-4). The other terms keep the AR trainer's rtol
1e-4 / atol 1e-6 (``tests/test_torch_measure_train_step.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolk
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.training.glsr_trainer import MeasureVAETrainerGLSR as JaxGLSR
from arvae_tpu_torch import train_measure_vae
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.training.glsr_trainer import GLSRNoise, MeasureVAETrainerGLSR
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

LR, B, H, Z, T = 1e-4, 8, 32, 8, 24
GLSR_RTOL = 1e-6
GRAD_ATOL_FRAC = 2e-3
UNRESOLVED = 1e-3
STEP_KEYS = (0, 1, 3)


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no folk_raw_data/ here
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    ds = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
    ds.get_dataset()
    return ds


def _widths(v):
    return dict(num_notes=v, note_embedding_dim=10, num_encoder_layers=2,
                encoder_hidden_size=H, encoder_dropout_prob=0.0, latent_space_dim=Z,
                num_decoder_layers=2, decoder_hidden_size=H, decoder_dropout_prob=0.0)


def _trainers(corpus, reg_type="rhy_complexity", reg_dim=0):
    """Both packages' GLSR trainers over the same weights."""
    v = len(corpus.note2index_dicts)
    model = FlaxMeasureVAE(**_widths(v))
    k = jax.random.split(jax.random.key(0), 3)
    params = model.init({"params": k[0], "sample": k[1], "dropout": k[2]},
                        jnp.zeros((1, T), jnp.int32), train=True)["params"]
    jds = JaxFolk(dataset_type="train", is_short=True, num_bars=1)
    jtr = JaxGLSR(jds, model, lr=LR, reg_type=reg_type, reg_dim=reg_dim, rand=0)
    port = MeasureVAE(**_widths(v))
    port.load_state_dict(measure_vae_from_flax(params))
    tr = MeasureVAETrainerGLSR(corpus, port, torch.device("cpu"), lr=LR,
                               reg_type=reg_type, reg_dim=reg_dim, rand=0)
    return jtr, params, tr


def _draws(key):
    """The step's draws as JAX makes them: ``k_fwd`` split as
    ``MeasureVAE.__call__`` and the hierarchical decoder split it, and
    the perturbations' uniforms from ``k_glsr``."""
    k_fwd, k_glsr = jax.random.split(key)
    _, k_rep, k_prior, k_dec = jax.random.split(k_fwd, 4)
    teacher = bool(jax.random.uniform(jax.random.split(k_dec, 3)[0], ()) < 0.5)
    u = jax.random.uniform(jax.random.split(k_glsr, 3)[0], (B,))
    measure = MeasureNoise(torch.tensor(np.asarray(jax.random.normal(k_rep, (B, Z)))),
                           torch.tensor(np.asarray(jax.random.normal(k_prior, (B, Z)))),
                           torch.tensor([int(teacher)], dtype=torch.int32),
                           torch.tensor([0], dtype=torch.int32))
    return GLSRNoise(measure, torch.tensor(np.asarray(u))), teacher


def _rows(corpus, start):
    rows = np.asarray(corpus.get_dataset()[0], np.int32)
    order = np.random.RandomState(0).permutation(len(rows))
    return rows[order[start * B:(start + 1) * B]]


def test_grad_attr_surrogates_match_jax(corpus):
    for reg_type in ("rhy_complexity", "num_notes"):
        jtr, _, tr = _trainers(corpus, reg_type)
        sw = np.random.RandomState(1).randn(B, T, len(corpus.note2index_dicts))
        sw = np.array(jax.nn.softmax(jnp.asarray(sw, jnp.float32), -1))
        np.testing.assert_allclose(tr.compute_grad_attr(torch.from_numpy(sw)).numpy(),
                                   np.asarray(jtr.compute_grad_attr(jnp.asarray(sw))),
                                   rtol=1e-6, atol=1e-7, err_msg=reg_type)


@pytest.mark.parametrize("reg_type,reg_dim", [("rhy_complexity", 0), ("num_notes", 2)])
def test_glsr_term_matches_jax(corpus, reg_type, reg_dim):
    jtr, params, tr = _trainers(corpus, reg_type, reg_dim)
    z = np.random.RandomState(2).randn(B, Z).astype(np.float32)
    key = jax.random.key(7)
    want = float(jtr.compute_glsr_loss(params, jnp.asarray(z), key))
    u = jax.random.uniform(jax.random.split(key, 3)[0], (B,))
    noise = GLSRNoise(_draws(key)[0].measure, torch.tensor(np.asarray(u)))
    with torch.no_grad():
        got = float(tr.compute_glsr_loss(torch.from_numpy(z), noise))
    np.testing.assert_allclose(got, want, rtol=GLSR_RTOL)
    assert want > 4000  # the N(100, 1) prior is far from the initial gradient


def _load_state(tr, params, opt_state):
    """The port's parameters and Adam moments set to the JAX side's."""
    tr.model.load_state_dict(measure_vae_from_flax(params))
    adam = opt_state[0]
    mu, nu = measure_vae_from_flax(adam.mu), measure_vae_from_flax(adam.nu)
    for name, p in tr.model.named_parameters():
        tr.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                 "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def test_three_adam_steps_match_jax(corpus):
    jtr, params, tr = _trainers(corpus)
    optimizer = optax.adam(LR)

    @jax.jit
    def step(p, opt_state, score, key):
        (_, metrics), grads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            p, (score, None), key, True)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, metrics, grads

    opt_state = optimizer.init(params)
    teachers = []
    for i, key_seed in enumerate(STEP_KEYS):
        score = _rows(corpus, i)
        key = jax.random.key(key_seed)
        noise, teacher = _draws(key)
        teachers.append(teacher)
        # each step starts from the JAX side's parameters and Adam state:
        # a trajectory of the GLSR objective amplifies one sign-ambiguous
        # update into many by the next step (module docstring)
        _load_state(tr, params, opt_state)
        params, opt_state, jm, grads = step(params, opt_state, jnp.asarray(score), key)
        s = torch.from_numpy(score)
        tm = tr.train_step((s, s), noise=noise)
        for name in ("loss", "recons_loss", "dist_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {name}")
        np.testing.assert_allclose(float(tm["reg_loss"]), float(jm["reg_loss"]),
                                   rtol=GLSR_RTOL, err_msg=f"step {i} reg_loss")
        want_g, want_p = measure_vae_from_flax(grads), measure_vae_from_flax(params)
        flips = total = 0
        for name, p in tr.model.named_parameters():
            g, wg = p.grad, want_g[name]
            g_atol = GRAD_ATOL_FRAC * float(wg.abs().max())
            np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=0, atol=g_atol,
                                       err_msg=f"step {i} grad {name}")
            # Adam moves an element by up to lr whatever its gradient's
            # size, so where the two gradients differ by half of JAX's,
            # the update's size and sign are not resolved
            agree = ((g - wg).abs() < 0.5 * wg.abs()) | (g == wg)
            flips += int((~agree).sum())
            total += agree.numel()
            np.testing.assert_allclose((p.detach() * agree).numpy(),
                                       (want_p[name] * agree).numpy(), rtol=0,
                                       atol=LR / 10, err_msg=f"step {i} {name}")
        assert flips <= UNRESOLVED * total, f"step {i}: {flips} updates unresolved"
    assert teachers == [True, False, True] and tr.step == 3


def test_run_dir_is_the_jax_model_repr(corpus, tmp_path):
    for reg_type, reg_dim in (("rhy_complexity", 0), ("num_notes", 2)):
        jtr, _, tr = _trainers(corpus, reg_type, reg_dim)
        assert tr.model_repr() == jtr.model_repr()
        assert tr.run_dir == str(tmp_path / "models" / "torch" / jtr.model_repr())
        # the JAX package's run dir has the same name, outside the port's
        assert os.path.basename(tr.run_dir) == os.path.basename(jtr.run_dir)
        assert tr.run_dir != jtr.run_dir
    assert tr.model_repr() == "folk_MeasureVAE_r_0_b_0.001_g_1.0_d_10.0_num_notes_GLSR"


@pytest.mark.parametrize("reg,want", [(None, "rhy_complexity"), (["all"], "rhy_complexity"),
                                      (["rhy_complexity"], "rhy_complexity"),
                                      (["note_density"], "note_density")])
def test_cli_glsr_picks_one_attribute(reg, want, capsys):
    assert train_measure_vae.glsr_reg_type(tuple(reg or ())) == want
    said = "defaulting to rhy_complexity" in capsys.readouterr().out
    assert said == (reg in (None, ["all"]))


@pytest.mark.parametrize("reg", [["pitch_range"], ["rhy_complexity", "note_density"],
                                 ["all", "rhy_complexity"]])
def test_cli_glsr_refuses_other_attributes(reg):
    with pytest.raises(ValueError, match="--glsr"):
        train_measure_vae.glsr_reg_type(tuple(reg))


def test_cli_trains_glsr_one_epoch(corpus, tmp_path):
    argv = ["--device", "cpu", "--short", "--num_epochs", "1", "--batch_size", "256",
            "--rand", "0", "--glsr", "-r", "note_density", "--encoder_hidden_size", "32",
            "--decoder_hidden_size", "32"]
    (trainer,) = train_measure_vae.main(argv)
    assert isinstance(trainer, MeasureVAETrainerGLSR)
    assert (trainer.glsr_reg_type, trainer.glsr_reg_dim) == ("num_notes", 2)
    hist = trainer.history
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    run = (tmp_path / "models" / "torch"
           / "folk_MeasureVAE_r_0_b_0.001_g_1.0_d_10.0_num_notes_GLSR")
    assert (run / "ckpt.pt").is_file()
    # the GLSR run is evaluated into a results_dict.json of its own run dir
    assert trainer.results_path == str(run / "results_dict.json")
    assert (run / "results_dict.json").is_file()
