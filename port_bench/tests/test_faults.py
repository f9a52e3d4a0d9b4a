"""A run with its timed path broken underneath comes out not correct,
for each fault a training cell can have (one card: no exchange between
cards to leave out). The run's look for a card is skipped: the port
runs on the CPU at a tiny size."""

import time

import pytest

from port_bench import faults, harness
from port_bench.tests.conftest import tiny_cell


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", ["measure_h512_train", "dsprites_b128_train"])
def test_a_planted_fault_is_not_correct(name, fault):
    out = harness.run_cell(tiny_cell(name), 41, 0.2, False, "cpu", time.perf_counter(),
                           fault=fault)
    assert not out["correct"], (fault, out["check_lines"])
