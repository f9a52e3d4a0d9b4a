"""The port's MeasureVAE train step against the JAX package's, plus the
port's music CLI end to end on the CPU.

From the same converted weights, the same three B=8 batches of the
``--short`` synthetic folk corpus (V=34) and the same draws, three
Adam(1e-4) steps of ``MeasureVAETrainer.train_step`` (``-r all``: the
four music attributes, labels computed from the score) are held against
a JAX step composed from the package's public pieces the way
``arvae_tpu/training/measure_trainer.py`` composes them (``apply`` with
an rng key, token CE + β·|KLD − c| + γ·Σ AR-reg, ``optax.adam``). The
port gets the JAX side's ε, ε_prior and teacher coin, reproduced from
each step's key; the keys give a teacher-forced, a free-running and a
teacher-forced step. Widths are cut to H=32, z=8 and both dropout rates
to 0 (the packages draw dropout bits differently).

Tolerances: per-step losses rtol 1e-4 / atol 1e-6 (float sums in
another order). Each parameter's change over the three steps is held to
JAX's within atol lr/10: Adam moves a parameter by up to lr a step, so
a port that skipped an update or moved a leaf the wrong way fails, and
the largest gap measured at these widths is ~2e-7 (0.002·lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arvae_tpu.data.attributes import MusicAttributes as JaxAttributes
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.ops.losses import (kld_loss, token_cross_entropy_loss,
                                  total_reg_loss)
from arvae_tpu.utils.torch_convert import (convert_measure_vae,
                                           torch_state_dict_to_numpy)
from arvae_tpu_torch import train_measure_vae
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

LR, B, H, Z, T = 1e-4, 8, 32, 8, 24
HYPER = {"beta": 0.001, "capacity": 0.0, "gamma": 1.0, "delta": 10.0}
REG_DIMS = (0, 1, 2, 3)
STEP_KEYS = (2, 0, 3)  # teacher coin: forced, free-running, forced


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


def _draws(key):
    """ε, ε_prior and the teacher coin, split from the key as the JAX
    model splits it."""
    _, k_rep, k_prior, k_dec = jax.random.split(key, 4)
    teacher = bool(jax.random.uniform(jax.random.split(k_dec, 3)[0], ()) < 0.5)
    return MeasureNoise(torch.tensor(np.asarray(jax.random.normal(k_rep, (B, Z)))),
                        torch.tensor(np.asarray(jax.random.normal(k_prior, (B, Z)))),
                        torch.tensor([int(teacher)], dtype=torch.int32),
                        torch.tensor([0], dtype=torch.int32)), teacher


def test_three_adam_steps_match_jax(corpus):
    v = len(corpus.note2index_dicts)
    assert v == 34
    model = FlaxMeasureVAE(**_widths(v))
    k = jax.random.split(jax.random.key(0), 3)
    params = model.init({"params": k[0], "sample": k[1], "dropout": k[2]},
                        jnp.zeros((1, T), jnp.int32), train=True)["params"]
    attrs = JaxAttributes(corpus.index2note_dicts)
    optimizer = optax.adam(LR)
    reg_pairs = tuple((d, d) for d in REG_DIMS)

    def loss_fn(p, score, key):
        out = model.apply({"params": p}, score, train=True, rng_key=key)
        recons_loss = token_cross_entropy_loss(out.weights, score)
        dist_loss = kld_loss(out.z_mean, out.z_log_std, HYPER["beta"], HYPER["capacity"])
        reg_loss = total_reg_loss(out.z_tilde, attrs.compute_labels(score), reg_pairs,
                                  HYPER["gamma"], HYPER["delta"])
        loss = recons_loss + dist_loss + reg_loss
        return loss, {"recons_loss": recons_loss, "dist_loss": dist_loss,
                      "reg_loss": reg_loss, "loss": loss}

    @jax.jit
    def step(p, opt_state, score, key):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, score, key)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, metrics

    port = MeasureVAE(**_widths(v))
    port.load_state_dict(measure_vae_from_flax(params))
    trainer = MeasureVAETrainer(corpus, port, torch.device("cpu"), lr=LR,
                                reg_type=("all",), reg_dim=REG_DIMS, rand=0, **HYPER)
    rows = np.asarray(corpus.get_dataset()[0], np.int32)
    order = np.random.RandomState(0).permutation(len(rows))
    opt_state = optimizer.init(params)
    params0 = params
    teachers = []
    for i, key_seed in enumerate(STEP_KEYS):
        score = rows[order[i * B:(i + 1) * B]]
        key = jax.random.key(key_seed)
        noise, teacher = _draws(key)
        teachers.append(teacher)
        params, opt_state, jm = step(params, opt_state, jnp.asarray(score), key)
        s = torch.from_numpy(score)
        tm = trainer.train_step((s, s), noise=noise)
        for name in ("loss", "recons_loss", "dist_loss", "reg_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {name}")
    assert teachers == [True, False, True] and trainer.step == 3

    # Both sides start from params0, so each leaf's change is compared:
    # every leaf moved by more than lr/2 in JAX, and the port moved it
    # the same way within lr/10 (the largest gap measured is ~2e-7).
    got = convert_measure_vae(torch_state_dict_to_numpy(port.state_dict()))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    start = dict(jax.tree_util.tree_leaves_with_path(params0))
    for path, w in jax.tree_util.tree_leaves_with_path(params):
        want = np.asarray(w) - np.asarray(start[path])
        assert np.abs(want).max() > LR / 2, f"{path} did not move in JAX"
        np.testing.assert_allclose(np.asarray(got[path]) - np.asarray(start[path]), want,
                                   atol=LR / 10, rtol=0, err_msg=str(path))


def test_cli_trains_checkpoints_and_resumes(corpus, tmp_path, capsys):
    # the CLI's flags, with the widths cut to H=32 so an epoch takes seconds
    argv = ["--device", "cpu", "--short", "--num_epochs", "1", "--batch_size", "64",
            "--rand", "0", "-r", "all", "--encoder_hidden_size", "32",
            "--decoder_hidden_size", "32"]
    (trainer,) = train_measure_vae.main(argv)
    n_steps = int(0.7 * len(corpus.get_dataset()[0])) // 64
    hist = trainer.history
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert hist[0]["train_steps"] == n_steps
    run = tmp_path / "models" / "torch" / "folk_MeasureVAE_r_0_b_0.001_g_1.0_d_10.0_all_"
    assert trainer.run_dir == str(run)
    ckpt = torch.load(run / "ckpt.pt", weights_only=True)
    assert ckpt["step"] == n_steps
    assert ckpt["protocol"] == {"num_epochs": 1, "batch_size": 64,
                                "dataset": "FolkNBarDataset", "is_short": True,
                                "class_name": "4by4_FolkNBarDataset_1_"}
    capsys.readouterr()

    (again,) = train_measure_vae.main(argv + ["--resume"])
    assert f"resumed from {run} at step {n_steps}" in capsys.readouterr().out
    assert torch.load(run / "ckpt.pt", weights_only=True)["step"] == 2 * n_steps == again.step


def test_cli_refuses_what_is_not_ported(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_measure_vae.main(["--rand", "0"])
