"""The image CLI under ``torchrun`` on the CPU: two gloo ranks
(``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
arvae_tpu_torch.train_image_vae --device cpu``) on the tiny dSprites
grid of ``tests/test_torch_train_step.py``, one epoch at a global batch
of 16 (8 rows a rank).

Checked: rank 0 alone prints the epoch's stats and the results and
writes the checkpoint and ``results_dict.json`` (the others only wait
at the barriers); ``--resume`` restores on both ranks and goes on
counting steps; and the two-rank run's train and val losses equal a
one-process run's within the step tolerance of
``tests/test_torch_parallel_steps.py`` (rtol 1e-5): the epoch means of
steps that hold to it, whose parameters stay within 5·lr of the
one-card run's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arvae_tpu.data.dsprites import generate_dsprites

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (1, 3, 2, 2, 4, 4)
B = 16
RUN = "DspritesVAE_r_0_b_1.0_g_10.0_d_1.0_all_"
ARGS = ["-m", "arvae_tpu_torch.train_image_vae", "--device", "cpu", "-d", "dsprites",
        "--short", "--rand", "0", "-r", "all", "--beta", "1.0", "--batch_size", str(B),
        "--num_epochs", "1"]
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2"]
LOSS_RTOL = 1e-5


def _losses(stdout):
    train = [float(x.split()[0]) for x in stdout.split("Train Loss: ")[1:]]
    val = [float(x.split()[0]) for x in stdout.split("Valid Loss: ")[1:]]
    return train, val


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(2-rank run, its --resume, a one-process run) → (stdout, run dir,
    the run dir's files and checkpoint just after the run)."""
    root = tmp_path_factory.mktemp("parallel_cli")
    ds_root = root / "datasets"
    (ds_root / "dsprites").mkdir(parents=True)
    packed, latents = generate_dsprites(TINY)
    np.savez_compressed(ds_root / "dsprites" / "dsprites_synth_1x3x3x10x16x16.npz",
                        packed=packed, latents=latents)

    def run(prefix, models, extra=()):
        env = dict(os.environ, ARVAE_DATASETS_DIR=str(ds_root),
                   ARVAE_MODELS_DIR=str(root / models), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(var, None)
        out = subprocess.run(prefix + ARGS + list(extra), env=env, cwd=str(root),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        run_dir = root / models / "torch" / RUN
        return (out.stdout, run_dir, sorted(os.listdir(run_dir)),
                torch.load(run_dir / "ckpt.pt", weights_only=True))

    two = run(TORCHRUN, "two")
    resumed = run(TORCHRUN, "two", ["--resume"])
    one = run([sys.executable], "one")
    return {"two": two, "resumed": resumed, "one": one, "steps": int(0.7 * len(packed)) // B}


def test_rank_zero_alone_prints_and_writes(runs):
    stdout, run_dir, files, ckpt = runs["two"]
    assert stdout.count("Train Epoch: 1/1") == 1
    assert stdout.count("Num Train Batches: ") == 1
    assert stdout.count('"protocol"') == 1
    assert files == ["ckpt.pt", "results_dict.json"]
    assert ckpt["step"] == runs["steps"]
    assert ckpt["protocol"]["batch_size"] == B
    with open(run_dir / "results_dict.json") as fh:
        results = json.load(fh)
    assert results["protocol"]["num_epochs"] == 1
    assert np.isfinite(results["test_loss"])


def test_resume_restores_on_every_rank(runs):
    stdout, run_dir, _, ckpt = runs["resumed"]
    n = runs["steps"]
    assert stdout.count(f"resumed from {run_dir} at step {n}") == 1
    assert ckpt["step"] == 2 * n


def test_two_ranks_train_as_one_process(runs):
    got, want = _losses(runs["two"][0]), _losses(runs["one"][0])
    assert len(got[0]) == len(got[1]) == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)
