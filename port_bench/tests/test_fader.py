"""The dSprites fader cell on the CPU at a tiny size: the plain reference
follows the port's two updates through the harness's whole run, a planted
fault of ``faults.py`` or a discriminator that never steps comes out not
correct, the FLOPs a step equal a count by hand at the cell's shapes, and
the reference loads nothing of the port and runs with TF32 off."""

import json
import subprocess
import sys
import time

import pytest

from port_bench import faults, harness
from port_bench.tests.conftest import tiny_cell

CELL = "fader_dsprites_train"
SEED = 2 ** 31 + 977  # past 32 signed bits, as a benchmark run's seed may be


def test_the_reference_follows_the_fader_step():
    out = harness.run_cell(tiny_cell(CELL), SEED, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"], out["check_lines"]
    values = harness.compare.readings(out["program"], out["reference"], out["start"])
    assert values["loss_gap"] <= 1e-6
    assert values["grad_gap"] <= 1e-5 and values["grad_gap_median"] <= 1e-5
    assert values["update_gap"] <= 1e-5 and values["update_gap_median"] <= 1e-5
    assert out["attempted"] >= 1 and out["failed"] == 0
    metrics = harness.read_metrics(out["run"], trace=False)
    assert set(metrics) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct_in_the_fader_cell(fault):
    out = harness.run_cell(tiny_cell(CELL), 41, 0.2, False, "cpu", time.perf_counter(),
                           fault=fault)
    assert not out["correct"], (fault, out["check_lines"])


def test_a_discriminator_that_never_steps_is_not_correct(monkeypatch):
    """The fader's loss and gradient are taken against the updated
    discriminator: one left at its start leaves the fader's readings off."""
    programs = harness.load_cell(CELL).module("programs")
    build = programs.build

    def frozen_disc(*args, **kw):
        trainer, split = build(*args, **kw)
        monkeypatch.setattr(trainer.disc_optimizer, "step", lambda *a, **k: None)
        return trainer, split

    monkeypatch.setattr(programs, "build", frozen_disc)
    out = harness.run_cell(tiny_cell(CELL), 41, 0.2, False, "cpu", time.perf_counter())
    assert not out["correct"], out["check_lines"]


def test_fader_step_flops_at_the_cell():
    cell = harness.load_cell(CELL)
    # a row: the encoder's 4 convolutions 64→32→16→8→4 and dense 512-256-256-10
    # (the mean head alone); the decoder's dense (10+5)-256-256-512 and 4
    # transposed convolutions 4→8→16→32→64 (the last to 1 channel); the
    # discriminator 10-64-32-5
    convs = 2 * 32 * 16 * (1 * 32 * 32 + 32 * 16 * 16 + 32 * 8 * 8 + 32 * 4 * 4)
    encoder = convs + 2 * (512 * 256 + 256 * 256 + 256 * 10)
    decoder = 2 * (15 * 256 + 256 * 256 + 256 * 512) + convs
    disc = 2 * (10 * 64 + 64 * 32 + 32 * 5)
    first_conv, first_disc = 2 * 32 * 16 * 32 * 32, 2 * 10 * 64
    # the discriminator's update: a no-grad encode, the discriminator forward
    # and backward but for the code's gradient
    disc_update = encoder + 3 * disc - first_disc
    # the fader's: encoder and decoder forward and backward but for the data's
    # gradient, the discriminator's forward and its input gradients
    fader_update = 3 * (encoder + decoder) - first_conv + 2 * disc
    assert (encoder, decoder, disc) == (12_456_960, 12_459_520, 5_696)
    assert disc_update + fader_update == 86_185_024
    assert cell.module("work").step_flops(cell.cfg, cell.traffic) == \
        128 * (disc_update + fader_update)


_REFERENCE = """
import json, sys, torch
import torch.nn.functional as F
from port_bench import data, weights
from port_bench.reference import dsprites_fader as ref
from port_bench.tests.conftest import tiny_cell
seen = []
for name in ("conv2d", "conv_transpose2d", "linear"):
    def wrapped(*args, _f=getattr(F, name), **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return _f(*args, **kw)
    setattr(F, name, wrapped)
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
cell = tiny_cell("fader_dsprites_train")
w = weights.init_weights(ref.param_spec(cell.cfg), 5, "cpu")
ref.run_steps(cell.cfg, cell.traffic, 5, data.make_inputs(cell.traffic, cell.cfg, 5, "cpu"), w, 2)
print(json.dumps({"loaded": sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None}),
                  "switches": sorted(set(map(tuple, seen))),
                  "after": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}))
"""


def test_the_fader_reference_loads_nothing_of_the_port_and_runs_with_tf32_off():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "flax", "optax", "arvae_tpu", "arvae_tpu_torch"}
    assert not set(got["loaded"]) & forbidden
    assert got["switches"] == [[False, False]]  # every product of the run
    assert got["after"] == [True, True]  # the caller's switches are restored
