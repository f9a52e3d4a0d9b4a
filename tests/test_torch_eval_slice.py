"""The port's evaluation slice against the JAX package's: the eval
splits, ``interval_entropy`` and the attribute getters, both trainers'
latent harvest and test pass, the ``results_dict.json`` cache and its
protocol stamp, and both CLIs' ``--skip_cached`` and ``--test``.

The harvest and the test pass run from weights converted by
``arvae_tpu_torch/utils/convert.py`` with the JAX trainers' own draws
injected: the test replays the keys the JAX trainers fold for each batch
(``_device_harvest_scan``: the key of ``7_000_000``, folded with the
batch index; ``_device_test_sweep``: the key of ``9_000_000``, folded
with the batch index, the tail batch's with the count of whole batches)
and draws from them as the models do (flax's ``make_rng("sample")`` and
a split for the DspritesVAE, ``MeasureVAE``'s four-way split). The JAX
trainers run on a one-device mesh. Splits are cut to tens or hundreds of
rows (random bit-packed images for dSprites, the ``--short`` synthetic
folk corpus for music) and the MeasureVAE to H=32, z=8, dropout 0.

Tolerances: the parity tolerances of the model tests, ``z`` within atol
1e-5 for the DspritesVAE (``tests/test_torch_image_vae.py``) and rtol /
atol 1e-5 for the MeasureVAE (``tests/test_torch_measure_vae.py``); the
test loss within the train-step tests' rtol 1e-4 (each batch's loss sums
4096 float32 pixel terms a row, in another order: 1.2e-5 apart measured
on random images, ``tests/test_torch_train_step.py``); dSprites
labels exactly, music labels within 1e-6 (the rhythm weights' dot
product sums in another order); the test accuracy within 1e-6.
The metric suites are compared on the same arrays only: a KSG estimate
jumps with any rounding of ``z``.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arvae_tpu.eval.metrics as jmetrics
from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolk
from arvae_tpu.data.dsprites import DspritesDataset as JaxDsprites
from arvae_tpu.data.dsprites import generate_dsprites
from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.parallel import create_mesh
from arvae_tpu.training.image_trainer import ImageVAETrainer as JaxImageTrainer
from arvae_tpu.training.measure_trainer import MeasureVAETrainer as JaxMeasureTrainer
from arvae_tpu_torch import train_image_vae, train_measure_vae
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
from arvae_tpu_torch.data.dsprites import DspritesDataset
from arvae_tpu_torch.eval.metrics import compute_all
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils.convert import dsprites_vae_from_flax, measure_vae_from_flax

TINY = (1, 3, 2, 2, 4, 4)
REG = dict(reg_type=("all",), reg_dim=(1, 2, 3, 4, 5), beta=1.0, gamma=10.0, delta=1.0,
           rand=0)
H, Z = 32, 8
CPU = torch.device("cpu")


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no folk_raw_data/ here
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    return tmp_path


@pytest.fixture
def corpus(dirs):
    ds = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
    ds.get_dataset()
    return ds


def _mesh():
    return create_mesh(jax.devices()[:1])


def _jax_split_arrays(sp):
    labels = None if sp.labels is None else np.asarray(sp.labels)[:sp.n]
    return np.asarray(sp.images)[:sp.n], labels


def _port_split_arrays(sp):
    return sp.images.numpy(), None if sp.labels is None else sp.labels.numpy()


# -- the data -------------------------------------------------------------------


def test_dsprites_eval_split_is_the_jax_split(dirs):
    root = str(dirs / "dsp")
    jsp = JaxDsprites(root=root, factor_sizes=TINY).device_eval_split(_mesh())
    sp = DspritesDataset(root=root, factor_sizes=TINY).device_eval_split(CPU)
    assert sp.n == jsp.n == 192 - int(0.95 * 192) and sp.kind == "packed"
    for got, want in zip(_port_split_arrays(sp), _jax_split_arrays(jsp)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_music_eval_split_is_the_jax_split(corpus):
    jds = JaxFolk(dataset_type="train", is_short=True, num_bars=1)
    jsp, sp = jds.device_eval_split(_mesh()), corpus.device_eval_split(CPU)
    n = len(corpus.get_dataset()[0])
    assert sp.n == jsp.n == n - int(0.95 * n) and sp.kind == "tokens" and sp.labels is None
    got, want = sp.images.numpy(), np.asarray(jsp.images)[:jsp.n]
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


GETTERS = ("get_note_density_in_measure", "get_pitch_range_in_measure",
           "get_rhy_complexity", "get_contour", "get_beat_strength",
           "get_rhythmic_entropy", "get_interval_entropy")


def test_interval_entropy_and_getters_match_jax(corpus):
    jds = JaxFolk(dataset_type="train", is_short=True, num_bars=1)
    rows = np.asarray(corpus.get_dataset()[0], np.int64).reshape(-1, 24)
    v = len(corpus.note2index_dicts)
    # edge rows: no note, one note, ids past the table and negative ids
    edge = np.zeros((4, 24), np.int64)
    edge[1, 5] = rows.max()
    edge[2] = np.resize([v + 3, rows.max(), -1, 7], 24)
    edge[3] = np.resize([rows.max(), v + 40, 9, -v], 24)
    rows = np.concatenate([rows, edge])
    for name in GETTERS:
        got, want = getattr(corpus, name)(rows), getattr(jds, name)(rows)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    ent = corpus.get_interval_entropy(rows)
    assert (ent[:-4] > 0).any() and ent[-4] == ent[-3] == 0.0
    labels = corpus.attrs().compute_labels(torch.from_numpy(rows),
                                           ["interval_entropy", "contour"]).numpy()
    np.testing.assert_allclose(labels[:, 0], ent, rtol=0, atol=0)


# -- the harvest and the test pass ----------------------------------------------


def _dsprites_pair(root, n_rows):
    """A JAX and a port DspritesDataset holding the same random rows."""
    rng = np.random.RandomState(n_rows)
    packed = rng.randint(0, 256, (n_rows, 512)).astype(np.uint8)
    values = [np.ones(1), np.arange(1, 4.0), np.linspace(0.5, 1.0, 6),
              np.linspace(0, 2 * np.pi, 40), np.linspace(0, 1, 32), np.linspace(0, 1, 32)]
    latents = np.stack([rng.choice(v, n_rows) for v in values], 1).astype(np.float32)
    order = rng.permutation(n_rows)
    pair = JaxDsprites(root=root, factor_sizes=TINY), DspritesDataset(root=root,
                                                                      factor_sizes=TINY)
    for ds in pair:
        ds.packed, ds.latents, ds._order = packed, latents, order
    return pair


def _image_trainers(root, n_rows):
    jds, ds = _dsprites_pair(root, n_rows)
    jtr = JaxImageTrainer(jds, FlaxDspritesVAE(), mesh=_mesh(), use_pallas=False, **REG)
    params = jtr.ensure_state().params
    model = DspritesVAE()
    model.load_state_dict(dsprites_vae_from_flax(params))
    return jtr, params, ImageVAETrainer(ds, model, CPU, **REG)


def _image_draws(jtr, params, offset, counts):
    """(eps, eps_prior) of each batch as the JAX image trainer draws
    them: flax's make_rng("sample") from the batch's key, then split."""
    key = jax.random.fold_in(jtr._base_key, offset)

    def draw(i, b):
        rng = jtr.model.apply({"params": params}, rngs={"sample": jax.random.fold_in(key, i)},
                              method=lambda m: m.make_rng("sample"))
        k1, k2 = jax.random.split(rng)
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, (b, 10))))
                     for k in (k1, k2))

    return [draw(i, b) for i, b in enumerate(counts)]


def _batches(n, bs, whole=None, tail=True):
    """Row counts of the batches a pass runs over n rows at batch bs."""
    whole = n // bs if whole is None else whole
    return [bs] * whole + ([n - whole * bs] if tail and n > whole * bs else [])


# (eval rows, harvest B, num_batches, test B): the batch clamp (B > n) with
# a partial test tail; the 201-batch cap at the default num_batches
IMAGE_CASES = {"clamp": (10, 128, 200, 4), "cap_201": (210, 1, 200, 64)}


@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_image_harvest_and_test_pass_match_jax(dirs, case):
    n, hb, nb, tb = IMAGE_CASES[case]
    n_rows = {10: 200, 210: 4200}[n]
    jtr, params, tr = _image_trainers(str(dirs / "dsp"), n_rows)
    assert tr.eval_split().n == n
    hbs = min(hb, n)
    steps = min(n // hbs, nb + 1)
    assert steps == {"clamp": 1, "cap_201": 201}[case]
    jz, jattrs, jnames = jtr.compute_representations(None, num_batches=nb, batch_size=hb)
    noise = _image_draws(jtr, params, 7_000_000, [hbs] * steps)
    z, attrs, names = tr.compute_representations(num_batches=nb, batch_size=hb, noise=noise)
    assert names == jnames == ["shape", "scale", "orientation", "posx", "posy"]
    assert z.shape == jz.shape == (steps * hbs, 10) and z.dtype == np.float32
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(attrs, jattrs)

    counts = _batches(n, min(tb, n))
    assert (len(counts), counts[-1]) == {"clamp": (3, 2), "cap_201": (4, 18)}[case]
    noise = _image_draws(jtr, params, 9_000_000, counts)
    got, want = tr.test_model(batch_size=tb, noise=noise), jtr.test_model(batch_size=tb)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=1e-4)
    assert got["test_acc"] == pytest.approx(want["test_acc"], abs=1e-6)

    # the metric suites on the same (JAX) harvest
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.random.seed(0)
        want = {"interpretability": jmetrics.compute_interpretability_metric(
            jz, jattrs, jnames)}
        for fn in (jmetrics.compute_correlation_score, jmetrics.compute_modularity,
                   jmetrics.compute_mig, jmetrics.compute_sap_score):
            want.update(fn(jz, jattrs))
        got = compute_all(jz, jattrs, jnames, np.random.RandomState(0))
    assert json.dumps(got) == json.dumps(want)


def _music_trainers(corpus):
    v = len(corpus.note2index_dicts)
    widths = dict(num_notes=v, note_embedding_dim=10, num_encoder_layers=2,
                  encoder_hidden_size=H, encoder_dropout_prob=0.0, latent_space_dim=Z,
                  num_decoder_layers=2, decoder_hidden_size=H, decoder_dropout_prob=0.0)
    jds = JaxFolk(dataset_type="train", is_short=True, num_bars=1)
    jtr = JaxMeasureTrainer(jds, FlaxMeasureVAE(**widths), reg_type=("all",),
                            reg_dim=(0, 1, 2, 3), rand=0, mesh=_mesh())
    params = jtr.ensure_state().params
    model = MeasureVAE(**widths)
    model.load_state_dict(measure_vae_from_flax(params))
    return jtr, MeasureVAETrainer(corpus, model, CPU, reg_type=("all",),
                                  reg_dim=(0, 1, 2, 3), rand=0)


def _measure_draws(jtr, offset, counts):
    """ε and ε_prior of each batch as MeasureVAE draws them from the key
    the JAX trainer folds for it (eval: no teacher, no dropout)."""
    key = jax.random.fold_in(jtr._base_key, offset)
    out = []
    for i, b in enumerate(counts):
        _, k_rep, k_prior, _ = jax.random.split(jax.random.fold_in(key, i), 4)
        eps, eps_prior = (torch.from_numpy(np.array(jax.random.normal(k, (b, Z))))
                          for k in (k_rep, k_prior))
        zero = torch.zeros(1, dtype=torch.int32)
        out.append(MeasureNoise(eps, eps_prior, zero, zero))
    return out


# (harvest B, num_batches, test B): the batch clamp at the CLI's B=256, a
# test pass with no tail; a harvest of 2 whole batches with the tail left
# out, and a test pass over the 2 whole batches and the partial tail
MUSIC_CASES = {"clamp": (256, 200, 256), "skipped_tail": (50, 200, 50)}


@pytest.mark.parametrize("case", list(MUSIC_CASES))
def test_music_harvest_and_test_pass_match_jax(corpus, case):
    hb, nb, tb = MUSIC_CASES[case]
    jtr, tr = _music_trainers(corpus)
    n = tr.eval_split().n
    hbs = min(hb, n)
    steps = min(n // hbs, nb + 1)
    assert 100 < n < 150 and steps == (1 if case == "clamp" else 2)
    jz, jattrs, jnames = jtr.compute_representations(None, num_batches=nb, batch_size=hb)
    z, attrs, names = tr.compute_representations(
        num_batches=nb, batch_size=hb, noise=_measure_draws(jtr, 7_000_000, [hbs] * steps))
    assert names == jnames and z.shape == jz.shape == (steps * hbs, Z)
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attrs, jattrs, rtol=1e-6, atol=1e-6)

    counts = _batches(n, min(tb, n))
    assert len(counts) == (1 if case == "clamp" else 3)
    got = tr.test_model(batch_size=tb, noise=_measure_draws(jtr, 9_000_000, counts))
    want = jtr.test_model(batch_size=tb)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=1e-4)
    assert got["test_acc"] == pytest.approx(want["test_acc"], abs=1e-6)


# -- the cache ------------------------------------------------------------------


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def test_results_dict_matches_the_jax_schema_and_stamp(dirs):
    jtr, params, tr = _image_trainers(str(dirs / "dsp"), 200)
    for t in (jtr, tr):
        t._train_protocol = {"num_epochs": 1, "batch_size": 4}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtr.compute_eval_metrics(batch_size=4)
        got = tr.compute_eval_metrics(batch_size=4)
    # each package writes its own file, in run dirs of one name
    assert tr.run_dir != jtr.run_dir
    assert os.path.basename(tr.run_dir) == os.path.basename(jtr.run_dir)
    with open(tr.results_path) as fh:
        on_disk = json.load(fh)
    with open(os.path.join(jtr.run_dir, "results_dict.json")) as fh:
        want = json.load(fh)  # the JAX trainer's file
    assert _key_tree(on_disk) == _key_tree(want) == _key_tree(json.loads(json.dumps(got)))
    assert list(on_disk) == list(want)
    assert list(on_disk["interpretability"]) == list(want["interpretability"])
    assert on_disk["protocol"] == want["protocol"] == {
        "num_epochs": 1, "batch_size": 4, "dataset": "DspritesDataset",
        "factor_sizes": list(TINY)}
    for k in ("Corr_score", "modularity_score", "mig", "SAP_score", "test_loss", "test_acc"):
        assert np.isfinite(on_disk[k]), k
    # a second call returns the cache as it is
    assert tr.compute_eval_metrics(batch_size=4) == on_disk


# The CLI's and the sweep cell's protocol stamp on the seeded --short grid
SHORT_STAMP = {"num_epochs": 1, "batch_size": 16, "dataset": "DspritesDataset",
               "factor_sizes": [1, 3, 3, 10, 16, 16]}


@pytest.mark.parametrize("reader", ["compute_eval_metrics", "skip_cached", "run_cell"])
def test_the_port_ignores_a_jax_results_dict(dirs, reader, capsys):
    """A results_dict.json the JAX trainer wrote at <models_root>/<repr>/,
    stamped with the very protocol the port's reader asks for, is neither
    read nor removed: the port's compute_eval_metrics writes its own, the
    CLI's --skip_cached trains, and the sweep's run_cell under --test
    finds no finished cell."""
    from arvae_tpu_torch import script_hyper_param_exp as sweep

    _seed_short_dsprites(dirs)
    jtr, _, tr = _image_trainers(str(dirs / "dsp"), 200)
    jtr._train_protocol = {"num_epochs": 1, "batch_size": 16}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtr.compute_eval_metrics(batch_size=16)
    jax_path = dirs / "models" / tr.model_repr() / "results_dict.json"
    with open(jax_path) as fh:
        jax_results = json.load(fh)
    tr._train_protocol = {"num_epochs": 1, "batch_size": 16}
    jax_results["protocol"] = (tr.protocol_dict() if reader == "compute_eval_metrics"
                               else SHORT_STAMP)
    jax_path.write_text(json.dumps(jax_results, indent=2))
    jax_bytes = jax_path.read_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if reader == "compute_eval_metrics":
            assert not tr.has_protocol_cache(1, 16)
            tr.train_model(batch_size=16, num_epochs=1)
            got = json.loads(json.dumps(tr.compute_eval_metrics(batch_size=16)))
            assert got != jax_results and got["protocol"] == jax_results["protocol"]
            with open(tr.results_path) as fh:
                assert json.load(fh) == got
        elif reader == "skip_cached":
            argv = ["--device", "cpu", "-d", "dsprites", "--short", "--rand", "0", "-r",
                    "all", "--beta", "1.0", "--batch_size", "16", "--num_epochs", "1",
                    "--skip_cached"]
            (trainer,) = train_image_vae.main(argv)
            assert trainer.model_repr() == tr.model_repr() and len(trainer.history) == 1
            assert "skip seed" not in capsys.readouterr().out
            with open(trainer.results_path) as fh:
                assert json.load(fh)["protocol"] == SHORT_STAMP
        else:
            trainer, row = sweep.run_cell(*sweep.sweep_data("dsprites", True), 10.0, 1.0,
                                          device=CPU, batch_size=16, num_epochs=1,
                                          do_train=False)
            assert trainer.model_repr() == tr.model_repr() and row is None
            assert "skip gamma=10.0 delta=1.0 (no finished cell)" in capsys.readouterr().out
            assert not os.path.exists(trainer.run_dir)
    assert jax_path.read_bytes() == jax_bytes


def test_music_stamp_matches_jax(corpus):
    jds = JaxFolk(dataset_type="train", is_short=True, num_bars=1)
    jtr = JaxMeasureTrainer(jds, FlaxMeasureVAE(num_notes=len(corpus.note2index_dicts)),
                            rand=0, mesh=_mesh())
    tr = MeasureVAETrainer(corpus, MeasureVAE(num_notes=len(corpus.note2index_dicts),
                                              encoder_hidden_size=H, decoder_hidden_size=H),
                           CPU, rand=0)
    for t in (jtr, tr):
        t._train_protocol = {"num_epochs": 2, "batch_size": 256}
    assert tr.protocol_dict() == jtr.protocol_dict() == {
        "num_epochs": 2, "batch_size": 256, "dataset": "FolkNBarDataset", "is_short": True,
        "class_name": "4by4_FolkNBarDataset_1_"}


def test_train_model_deletes_a_stale_cache_and_the_stamp_gates_skips(dirs):
    _, _, tr = _image_trainers(str(dirs / "dsp"), 200)
    os.makedirs(tr.run_dir)
    with open(tr.results_path, "w") as fh:
        json.dump({"stale": True}, fh)
    assert not tr.has_protocol_cache(1, 64)
    tr.train_model(batch_size=64, num_epochs=1)
    assert not os.path.exists(tr.results_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr.compute_eval_metrics(batch_size=64)
    assert tr.has_protocol_cache(1, 64)
    assert not tr.has_protocol_cache(2, 64) and not tr.has_protocol_cache(1, 32)
    # the same run dir asked for by a trainer over the --full grid
    _, full = _dsprites_pair(str(dirs / "dsp"), 200)
    full.factor_sizes = (1, 3, 6, 40, 32, 32)
    other = ImageVAETrainer(full, DspritesVAE(), CPU, **REG)
    assert other.run_dir == tr.run_dir == str(dirs / "models" / "torch" / tr.model_repr())
    assert not other.has_protocol_cache(1, 64)


def test_music_stamp_rejects_short_against_full(corpus):
    tr = MeasureVAETrainer(corpus, MeasureVAE(num_notes=len(corpus.note2index_dicts),
                                              encoder_hidden_size=H, decoder_hidden_size=H),
                           CPU, rand=0)
    tr._train_protocol = {"num_epochs": 1, "batch_size": 256}
    os.makedirs(tr.run_dir)
    with open(tr.results_path, "w") as fh:
        json.dump({"protocol": tr.protocol_dict()}, fh)
    assert tr.has_protocol_cache(1, 256)
    corpus.is_short = False
    assert not tr.has_protocol_cache(1, 256)


# -- the CLIs ---------------------------------------------------------------------


def _seed_short_dsprites(dirs):
    """The --short cache holding the tiny grid, so an epoch takes seconds."""
    root = dirs / "datasets" / "dsprites"
    root.mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(root / "dsprites_synth_1x3x3x10x16x16.npz",
                        packed=packed, latents=latents)


def _check_results(run_dir, epochs, batch_size):
    with open(os.path.join(run_dir, "results_dict.json")) as fh:
        res = json.load(fh)
    assert list(res) == ["interpretability", "Corr_score", "modularity_score", "mig",
                         "SAP_score", "test_loss", "test_acc", "protocol"]
    assert res["interpretability"]["mean"][0] == -1
    for k in ("Corr_score", "modularity_score", "mig", "SAP_score", "test_acc"):
        assert 0.0 <= res[k] <= 1.0, k
    assert np.isfinite(res["test_loss"])
    assert (res["protocol"]["num_epochs"], res["protocol"]["batch_size"]) == (epochs,
                                                                              batch_size)
    return res


def _cli_round(main, argv, batch_size, capsys):
    """Train and evaluate; skip under --skip_cached; re-evaluate under
    --test from the checkpoint with the cache removed."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (trainer,) = main(argv + ["--skip_cached"])
        res = _check_results(trainer.run_dir, 1, batch_size)
        assert json.loads(capsys.readouterr().out.split("Test Accuracy:")[1]
                          .split("\n", 1)[1]) == res
        assert main(argv + ["--skip_cached"]) == []
        assert f"skip seed 0: protocol-stamped cache in {trainer.run_dir}" in \
            capsys.readouterr().out
        os.remove(trainer.results_path)
        (tested,) = main(argv + ["--test"])
    assert tested.history == [] and tested.step == trainer.step
    again = _check_results(tested.run_dir, None, None)
    assert {k: v for k, v in again.items() if k != "protocol"} == \
        {k: v for k, v in res.items() if k != "protocol"}


def test_image_cli_evaluates_skips_and_tests(dirs, capsys):
    _seed_short_dsprites(dirs)
    argv = ["--device", "cpu", "-d", "dsprites", "--short", "--rand", "0", "-r", "all",
            "--beta", "1.0", "--batch_size", "16", "--num_epochs", "1"]
    _cli_round(train_image_vae.main, argv, 16, capsys)


def test_music_cli_evaluates_skips_and_tests(corpus, capsys):
    argv = ["--device", "cpu", "--short", "--num_epochs", "1", "--batch_size", "64",
            "--rand", "0", "-r", "all", "--encoder_hidden_size", "32",
            "--decoder_hidden_size", "32"]
    _cli_round(train_measure_vae.main, argv, 64, capsys)
