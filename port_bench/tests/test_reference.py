"""The plain reference agrees with the port's CPU path at a tiny size,
through the harness's whole run (no card: the port runs its plain
versions)."""

import time

import pytest

from port_bench import harness
from port_bench.tests.conftest import tiny_cell

SEED = 2 ** 31 + 977  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("name", ["measure_h512_train", "dsprites_b128_train"])
def test_reference_follows_the_port(name):
    out = harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"], out["check_lines"]
    values = harness.compare.readings(out["program"], out["reference"], out["start"])
    assert values["loss_gap"] <= 1e-6
    assert values["grad_gap"] <= 1e-5 and values["grad_gap_median"] <= 1e-5
    assert values["update_gap"] <= 1e-5 and values["update_gap_median"] <= 1e-5
    assert out["attempted"] >= 1 and out["failed"] == 0
    metrics = harness.read_metrics(out["run"], trace=False)
    assert set(metrics) == {"train_samples_per_s", "setup_s"}
