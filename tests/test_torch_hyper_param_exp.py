"""The port's γ×δ sweep (``arvae_tpu_torch/script_hyper_param_exp.py``)
against the root script's rules, on a 192-row dSprites grid at B=16.

- A 2×2 grid (γ ∈ {0.01, 100}, δ ∈ {100, 0.01}: the full grid's
  corners) writes caches stamped with the protocol; a rerun reuses them
  without training.
- A cell that raises mid-training (after its first epoch's checkpoint)
  is moved to ``<run_dir>.failed`` and the grid goes on.
- ``--test`` skips the cells without a finished cache.
- The grid, the flags' defaults and a row's columns are the root
  script's (its DataFrame's columns from the JAX package's
  ``EVAL_METRIC_DICT``).
- ``scripts/aggregate_results.py`` needs no port: its ``collect()``
  reads the sweep's ``results_dict.json`` files as they are.
"""

import importlib.util
import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

from arvae_tpu.eval import EVAL_METRIC_DICT as JAX_EVAL_METRIC_DICT
from arvae_tpu_torch import script_hyper_param_exp as sweep
from arvae_tpu_torch.data.dsprites import generate_dsprites
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

TINY = (1, 3, 2, 2, 4, 4)
ARGV = ["--device", "cpu", "-d", "dsprites", "--short", "--batch_size", "16",
        "--num_epochs", "2"]
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def grid(tmp_path, monkeypatch):
    """The 2×2 grid of the full grid's corner values, on the tiny dSprites
    grid saved where ``--short`` reads its cache."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    root = tmp_path / "datasets" / "dsprites"
    root.mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(root / "dsprites_synth_1x3x3x10x16x16.npz", packed=packed,
                        latents=latents)
    monkeypatch.setattr(sweep, "GAMMAS", [0.01, 100.0])
    monkeypatch.setattr(sweep, "DELTAS", [100.0, 0.01])
    return tmp_path / "models" / "torch"  # the port's run dirs


def _run(argv):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sweep.main(argv)


def _run_dir(models, gamma, delta):
    return models / f"DspritesVAE_r_0_b_1.0_g_{gamma}_d_{delta}_all_"


def test_grid_writes_stamped_caches_and_a_rerun_reuses_them(grid, capsys, monkeypatch):
    rows = _run(ARGV)
    assert [r[:2] for r in rows] == [[0.01, 100.0], [0.01, 0.01], [100.0, 100.0],
                                     [100.0, 0.01]]
    assert all(np.isfinite(r).all() and len(r) == len(sweep.COLUMNS) for r in rows)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"columns": sweep.COLUMNS, "rows": rows}
    for g, d in ((0.01, 100.0), (100.0, 0.01)):
        with open(_run_dir(grid, g, d) / "results_dict.json") as fh:
            stamp = json.load(fh)["protocol"]
        assert stamp == {"num_epochs": 2, "batch_size": 16, "dataset": "DspritesDataset",
                         "factor_sizes": [1, 3, 3, 10, 16, 16]}  # the --short grid's name

    def no_training(*a, **k):
        raise AssertionError("a cached cell trained again")

    monkeypatch.setattr(ImageVAETrainer, "train_model", no_training)
    assert _run(ARGV) == rows


def test_a_cell_that_raises_is_quarantined_and_the_grid_goes_on(grid, capsys, monkeypatch):
    real = ImageVAETrainer.train_step
    calls = {"n": 0}

    def failing_step(self, batch, noise=None):
        calls["n"] += 1
        if self.hparams.gamma == 0.01 and self.hparams.delta == 100.0 and calls["n"] > 10:
            raise FloatingPointError("diverged")  # in the second epoch (8 steps each)
        return real(self, batch, noise)

    monkeypatch.setattr(ImageVAETrainer, "train_step", failing_step)
    rows = _run(ARGV)
    assert [r[:2] for r in rows] == [[0.01, 0.01], [100.0, 100.0], [100.0, 0.01]]
    out = capsys.readouterr().out
    bad = _run_dir(grid, 0.01, 100.0)
    assert "CELL-FAILED gamma=0.01 delta=100.0: FloatingPointError('diverged')" in out
    assert f"quarantined partial cell -> {bad}.failed" in out
    assert not bad.exists() and (pathlib.Path(f"{bad}.failed") / "ckpt.pt").exists()
    assert (_run_dir(grid, 0.01, 0.01) / "results_dict.json").exists()


def test_test_mode_skips_cells_without_a_cache(grid, capsys):
    _, row = sweep.run_cell(*sweep.sweep_data("dsprites", True), 100.0, 0.01,
                            device=torch.device("cpu"), batch_size=16, num_epochs=2)
    capsys.readouterr()
    rows = _run(ARGV + ["--test"])
    assert rows == [row]
    out = capsys.readouterr().out
    for g, d in ((0.01, 100.0), (0.01, 0.01), (100.0, 100.0)):
        assert f"skip gamma={g} delta={d} (no finished cell)" in out
        assert not _run_dir(grid, g, d).exists()
    # none at all: the root script's message
    assert _run(ARGV + ["--test", "--num_epochs", "3"]) == []
    assert "no cached results for any (gamma, delta) cell" in capsys.readouterr().out


def test_grid_flags_and_row_are_the_root_scripts():
    assert sweep.GAMMAS == [0.01, 0.1, 1.0, 2.0, 5.0, 10.0, 100.0]
    assert sweep.DELTAS == [100.0, 10.0, 1.0, 0.1, 0.01]
    args = sweep.parse_args([])
    assert (args.dataset_type, args.batch_size, args.num_epochs, args.lr, args.capacity,
            args.dec_dist, args.do_train, args.log, args.short, args.device) == (
        "mnist", 128, 100, 1e-4, 0.0, "bernoulli", True, False, False, "cuda")
    # the root script's DataFrame columns and row
    assert sweep.COLUMNS == (["$\\gamma$", "$\\delta$"]
                             + [JAX_EVAL_METRIC_DICT[k] for k in JAX_EVAL_METRIC_DICT]
                             + ["Reconstruction Accuracy (in %)"])
    r = {"interpretability": {"shape": [3, 0.5], "mean": [-1, 0.25]}, "mig": 0.1,
         "modularity_score": 0.2, "SAP_score": 0.3, "Corr_score": 0.4, "test_acc": 0.875}
    want = [2.0, 0.1]
    for k in JAX_EVAL_METRIC_DICT:
        want.append(r[k]["mean"][1] if k == "interpretability" else r[k])
    want.append(r["test_acc"] * 100)
    assert sweep.cell_row(2.0, 0.1, r) == want == [2.0, 0.1, 0.25, 0.2, 0.1, 0.3, 0.4, 87.5]


def test_aggregate_results_collects_the_sweeps_files(grid):
    rows = _run(ARGV)
    spec = importlib.util.spec_from_file_location(
        "aggregate_results", REPO / "scripts" / "aggregate_results.py")
    agg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(agg)
    n, mets, excluded = agg.collect(str(grid / "DspritesVAE_r_0_b_1.0_g_*"), epochs=2)
    assert n == 4 and excluded == []
    by_dir = sorted(rows, key=lambda r: (str(r[0]), str(r[1])))  # glob's sorted run dirs
    assert mets["interp"] == [r[2] for r in by_dir]
    assert mets["test_acc"] == pytest.approx([r[-1] / 100 for r in by_dir], rel=1e-15)
    assert agg.collect(str(grid / "DspritesVAE_r_0_*"), epochs=3)[0] == 0
