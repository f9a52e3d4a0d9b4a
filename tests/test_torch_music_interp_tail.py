"""The music CLI's tail against the JAX package's: after the evaluation,
a harvest of 20 batches of the eval split, then for each attribute the
MIDI of the first codes and of their 5-point traversals of that
attribute's interpretability dim
(``MeasureVAETrainer.plot_latent_interpolations``).

The models are tiny (H=32, z=16, two GRU layers on the ``--short``
synthetic folk corpus). The JAX trainer holds the port's weights
(``convert_measure_vae``) and reads the same ``results_dict.json``; its
pianoroll plot is replaced inside the test by a stand-in that keeps the
attribute labels it is handed (JAX's code stays as it is). Held exactly:
every MIDI file byte for byte, the files' names, the decoded tokens and
the harvest's row count against JAX's ``compute_representations`` on the
device eval split (JAX's harvest ignores the root CLI's ``batch_size=1``
loader whenever that split has rows). On two gloo ranks the CLI ends,
rank 0 alone running the tail (it takes no collective) and the other
rank waiting for it. The attribute labels of the
traversals and of the harvest within 1e-6: the same tokens, but the
extractors' float32 arithmetic rounds apart by an ulp (as
``tests/test_torch_eval_slice.py`` holds the harvest's attributes).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arvae_tpu.utils.plotting as jax_plotting
import torch_parallel_ranks as ranks
from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolk
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.parallel import create_mesh
from arvae_tpu.training.measure_trainer import MeasureVAETrainer as JaxMeasureTrainer
from arvae_tpu.utils.torch_convert import convert_measure_vae, torch_state_dict_to_numpy
from arvae_tpu_torch import train_measure_vae
from arvae_tpu_torch.data.attributes import MUSIC_REG_TYPE
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils.midi import read_midi

H, Z = 32, 16
CPU = torch.device("cpu")
LABEL_ATOL = 1e-6
FLAGS = ["--device", "cpu", "--short", "--rand", "0", "--encoder_hidden_size", str(H),
         "--decoder_hidden_size", str(H), "--latent_space_dim", str(Z)]


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


@pytest.fixture
def jax_labels(monkeypatch):
    """The attribute labels JAX's plot_latent_interpolations hands its
    pianoroll plot, by file; no image is drawn."""
    seen = {}

    def keep(roll, attr_labels, attr_str, path):
        seen[os.path.basename(path)] = np.asarray(attr_labels)

    monkeypatch.setattr(jax_plotting, "plot_pianoroll", keep)
    return seen


def _widths(corpus):
    return dict(num_notes=len(corpus.note2index_dicts), encoder_hidden_size=H,
                decoder_hidden_size=H, latent_space_dim=Z)


def _jax_twin(corpus, model):
    """A JAX trainer holding ``model``'s weights, with the port's
    results_dict.json in its run dir."""
    jtr = JaxMeasureTrainer(JaxFolk(dataset_type="train", is_short=True, num_bars=1),
                            FlaxMeasureVAE(**_widths(corpus)), reg_type=("all",),
                            reg_dim=(0, 1, 2, 3), rand=0, mesh=create_mesh(jax.devices()[:1]))
    state = jtr.ensure_state()
    params = convert_measure_vae(torch_state_dict_to_numpy(model.state_dict()))
    jtr.state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    return jtr


def _share_results(trainer, jtr, results=None):
    """The port's results (or ``results``) as the JAX trainer's cache."""
    os.makedirs(jtr.run_dir, exist_ok=True)
    if results is not None:
        os.makedirs(trainer.run_dir, exist_ok=True)
        with open(trainer.results_path, "w") as fh:
            json.dump(results, fh)
    shutil.copy(trainer.results_path, os.path.join(jtr.run_dir, "results_dict.json"))


def _midi_files(run_dir):
    folder = os.path.join(run_dir, "results")
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder)) if name.endswith(".mid")}


def _expected_names(n):
    return sorted([f"original_{i}.mid" for i in range(n)]
                  + [f"latent_interpolations_{a}_{i}.mid" for a in MUSIC_REG_TYPE
                     for i in range(n)])


def test_plot_latent_interpolations_matches_jax(corpus, jax_labels):
    model = MeasureVAE(**_widths(corpus))
    tr = MeasureVAETrainer(corpus, model, CPU, reg_type=("all",), reg_dim=(0, 1, 2, 3),
                           rand=0)
    jtr = _jax_twin(corpus, model)
    dims = {"rhy_complexity": [3, 0.5], "pitch_range": [7, 0.4], "note_density": [0, 0.3],
            "contour": [12, 0.2]}
    _share_results(tr, jtr, {"interpretability": dims})
    codes = 2 * np.random.RandomState(8).randn(7, Z).astype(np.float32)
    for attr in MUSIC_REG_TYPE:
        got = tr.plot_latent_interpolations(codes, attr, num_points=5)
        jtr.plot_latent_interpolations(codes, attr, num_points=5)
        want = np.stack([jax_labels[f"latent_interpolations_{attr}_{i}.png"]
                         for i in range(5)])
        assert got.shape == (5, 5)
        np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    port_files, jax_files = _midi_files(tr.run_dir), _midi_files(jtr.run_dir)
    assert list(port_files) == _expected_names(5)
    assert port_files == jax_files
    # fewer codes than points: one file set a code
    assert tr.plot_latent_interpolations(codes[:2], "contour", num_points=5).shape == (2, 5)


@pytest.mark.parametrize("reg", [["-r", "all"], ["--glsr", "-r", "rhy_complexity"]],
                         ids=["ar", "glsr"])
def test_cli_tail_writes_jaxs_midi(corpus, jax_labels, reg):
    (trainer,) = train_measure_vae.main(FLAGS + reg + ["--num_epochs", "1",
                                                       "--batch_size", "256"])
    files = _midi_files(trainer.run_dir)
    assert list(files) == _expected_names(5)
    for name, data in files.items():
        assert data[:4] == b"MThd"
        assert read_midi(os.path.join(trainer.run_dir, "results", name)) is not None
    # the harvest the tail took: the port's rows, JAX's count and attributes
    codes, attrs, names = trainer.compute_representations(num_batches=20)
    jtr = _jax_twin(corpus, trainer.model)
    _, jattrs, jnames = jtr.compute_representations(None, num_batches=20)
    assert names == jnames and codes.shape == (len(jattrs), Z)
    np.testing.assert_allclose(attrs, np.asarray(jattrs), rtol=0, atol=LABEL_ATOL)
    # JAX's tail on the same codes, from the same results: the same bytes
    _share_results(trainer, jtr)
    for attr in MUSIC_REG_TYPE:
        jtr.plot_latent_interpolations(codes, attr, num_points=5)
        got = trainer.plot_latent_interpolations(codes, attr, num_points=5)
        want = np.stack([jax_labels[f"latent_interpolations_{attr}_{i}.png"]
                         for i in range(5)])
        np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    assert _midi_files(jtr.run_dir) == files


def test_cli_tail_on_two_ranks(tmp_path):
    """``torchrun``'s data-parallel run of the CLI on two CPU ranks ends
    within the harness's limit: rank 0 writes the 25 files, the other
    rank calls the tail not at all, and both read the same results."""
    env = {"ARVAE_DATASETS_DIR": str(tmp_path / "datasets"),
           "ARVAE_MODELS_DIR": str(tmp_path / "models")}
    with open(tmp_path / "music_cli.json", "w") as fh:
        json.dump(FLAGS + ["-r", "all", "--num_epochs", "1", "--batch_size", "256"], fh)
    out = ranks.run_ranks(2, "music_cli_body", str(tmp_path), env=env)
    assert out[0]["calls"] == list(MUSIC_REG_TYPE) and out[1]["calls"] == []
    assert out[0]["run_dir"] == out[1]["run_dir"]
    # rank 0's results as it wrote them (tuples become lists), rank 1's as it read them
    assert json.loads(json.dumps(out[0]["metrics"])) == out[1]["metrics"]
    assert list(_midi_files(out[0]["run_dir"])) == _expected_names(5)
