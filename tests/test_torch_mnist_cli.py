"""The port's MNIST CLIs on the CPU at tiny sizes (``--device cpu``, the
synthetic sets cut to 48 and 16 digits, B=16): the image CLI's ``-d``
defaults to ``mnist`` and trains ``MnistVAE`` on ``MorphoMnistDataset``
into the JAX package's run dir; without a judge its
``results_dict.json`` has the JAX schema and no ``digit_pred_acc``;
``test_mnist`` trains the judge and writes ``models/MnistRESNET/ckpt.pt``;
the image CLI then reports ``digit_pred_acc`` (before the stamp, as the
JAX trainer writes it), ``--skip_cached`` skips the stamped seed and
``--test`` restores the run and re-evaluates it to the same results."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from arvae_tpu_torch import test_mnist, train_image_vae
from arvae_tpu_torch.data import mnist
from arvae_tpu_torch.training.resnet_judge import load_judge

N_TRAIN, N_TEST, B = 48, 16, 16
ARGV = ["--device", "cpu", "--rand", "0", "-r", "all", "--beta", "1.0", "--batch_size",
        str(B), "--num_epochs", "1"]
RUN = "MnistVAE_r_0_b_1.0_g_10.0_d_1.0_all_"
KEYS = ["interpretability", "Corr_score", "modularity_score", "mig", "SAP_score",
        "test_loss", "test_acc"]
ATTRS = ["area", "length", "thickness", "slant", "width", "height", "mean"]


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setattr(mnist, "SYNTH_TRAIN", N_TRAIN)
    monkeypatch.setattr(mnist, "SYNTH_TEST", N_TEST)
    return tmp_path


def _results(trainer):
    with open(trainer.results_path) as fh:
        return json.load(fh)


def _main(argv):
    with warnings.catch_warnings():  # the metric suite's on a tiny harvest
        warnings.simplefilter("ignore")
        return train_image_vae.main(argv)


def test_mnist_is_the_default_and_runs_without_a_judge(dirs, capsys):
    (trainer,) = _main(ARGV)
    assert trainer.dataset_type == "mnist" and type(trainer.model).__name__ == "MnistVAE"
    assert trainer.run_dir == str(dirs / "models" / "torch" / RUN)
    assert trainer.reg_pairs == tuple((d, d) for d in range(1, 7))
    hist = trainer.history
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert hist[0]["train_steps"] == N_TRAIN // B and hist[0]["val_steps"] == N_TEST // B
    res = _results(trainer)
    assert list(res) == KEYS + ["protocol"]
    assert list(res["interpretability"]) == ATTRS
    assert res["protocol"] == {"num_epochs": 1, "batch_size": B,
                               "dataset": "MorphoMnistDataset"}
    out = capsys.readouterr().out
    assert "No MnistRESNET checkpoint found - skipping digit_pred_acc" in out
    assert os.path.exists(dirs / "datasets" / "mnist_data" / "plain" / "t10k-morpho.csv")


def test_judge_cli_then_digit_pred_acc_skip_and_test(dirs, capsys):
    assert load_judge(torch.device("cpu")) is None
    judge, hist = test_mnist.main(["--device", "cpu", "--batch_size", str(B),
                                   "--num_epochs", "2", "--augment"])
    out = capsys.readouterr().out
    assert "epoch 2/2" in out and "accuracy" in out and len(hist) == 2
    for h in hist:
        assert set(h) == {"loss", "precision", "recall", "f1", "accuracy"}
        assert np.isfinite(h["loss"]) and 0.0 <= h["accuracy"] <= 1.0
    loaded = load_judge(torch.device("cpu"))
    assert not loaded.training
    for k, v in judge.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    (trainer,) = _main(ARGV)
    res = _results(trainer)
    assert list(res) == KEYS + ["digit_pred_acc", "protocol"]
    assert set(res["digit_pred_acc"]) == {"inputs", "recons", "interp"}
    assert all(0.0 <= v <= 1.0 for v in res["digit_pred_acc"].values())
    assert res == json.loads(json.dumps(trainer.metrics))

    capsys.readouterr()
    assert _main(ARGV + ["--skip_cached"]) == []
    assert f"skip seed 0: protocol-stamped cache in {trainer.run_dir}" in \
        capsys.readouterr().out
    os.remove(trainer.results_path)
    (tested,) = _main(ARGV + ["--test"])
    assert tested.history == [] and tested.step == trainer.step == N_TRAIN // B
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(tested.model.state_dict()[k], v), k
    again = _results(tested)
    assert {k: v for k, v in again.items() if k != "protocol"} == \
        {k: v for k, v in res.items() if k != "protocol"}


def test_dataset_and_reg_type_checks(dirs):
    with pytest.raises(ValueError, match="Invalid dataset_type"):
        train_image_vae.main(["--device", "cpu", "-d", "cifar"])
    with pytest.raises(ValueError, match=r"unknown reg_type \['posx'\]"):
        train_image_vae.main(["--device", "cpu", "--rand", "0", "-r", "posx"])
    # named attributes, the digit too; --short is dSprites' grid, ignored
    (trainer,) = _main(["--device", "cpu", "--rand", "1", "-r", "slant", "-r",
                        "digit_identity", "--short", "--batch_size", str(B),
                        "--num_epochs", "1"])
    assert trainer.hparams.reg_dim == (4, 0)
    assert trainer.run_dir == str(
        dirs / "models" / "torch" / "MnistVAE_r_1_b_4.0_g_10.0_d_1.0_slant_digit_identity_")
    assert trainer.history[0]["train_steps"] == N_TRAIN // B
