"""On a card: the control (the fader reference in TF32, put in the
program's place) comes out not correct at the fader cell's own size, on
three seeds. Skips without a card; run on the card with
``python3 -m pytest port_bench/tests/test_fader_control.py``."""

import pytest
import torch

from port_bench import compare, data, harness, weights

pytestmark = pytest.mark.gpu


def test_the_fader_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which the CPU has not")
    cell, dev = harness.load_cell("fader_dsprites_train"), torch.device("cuda", 0)
    ref = cell.module("reference")
    n = cell.traffic["checked_steps"]
    for seed in (7, 2 ** 31 + 11, 90210):
        inputs = data.make_inputs(cell.traffic, cell.cfg, seed, dev)
        start = weights.init_weights(ref.param_spec(cell.cfg), seed, dev)
        fp32 = ref.run_steps(cell.cfg, cell.traffic, seed, inputs, start, n)
        tf32 = ref.run_steps(cell.cfg, cell.traffic, seed, inputs, start, n, tf32=True)
        correct, lines = compare.judge(compare.readings(tf32, fp32, start), cell.cfg["limits"])
        assert not correct, (seed, lines)
