"""Every reader of BENCHMARK.json reads a synthetic run of each cell: a
traced run reports each per-layer metric its cell lists, an untraced
one each end-to-end metric, and each value is the arithmetic of its
records."""

import pytest

from port_bench import harness, trace
from port_bench.tests.test_stats import _events

H100 = "NVIDIA H100 80GB HBM3"


def _run(name, stretch=None):
    cell = harness.load_cell(name)
    window = harness.Window(steps=100, seconds=2.0, batch=cell.traffic["batch"],
                            intervals_ms=[20.0] * 95 + [30.0] * 5, nonfinite=0,
                            host_s=1.5)
    return harness.Run(cell, H100, 12.5, window, stretch)


def _expected(run):
    """What every reader should read of the synthetic run, by metric."""
    flops = run.cell.module("work").step_flops(run.cell.cfg, run.cell.traffic)
    return {"train_samples_per_s": 100 * run.cell.traffic["batch"] / 2.0, "setup_s": 12.5,
            "step_ms_p95": 20.0 + 0.05 * 10.0,  # the window's 95 + 5 steps
            "mfu_pct": 100 * flops * 100 / 2.0 / 495e12, "device_idle_pct": 60.0,
            "host_issue_ms": 15.0}  # 1.5 s of spans over 100 steps


@pytest.mark.parametrize("name", ["measure_h512_train", "dsprites_b128_train"])
def test_end_to_end_readings(name):
    run = _run(name)
    got = {k: v["value"] for k, v in harness.read_metrics(run, trace=False).items()}
    listed = {m["name"] for m in harness.metric_entries(name, trace=False)}
    assert set(got) == listed
    assert got == pytest.approx({k: _expected(run)[k] for k in listed})


@pytest.mark.parametrize("name", ["measure_h512_train", "dsprites_b128_train"])
def test_per_layer_readings(name):
    stretch, _ = trace.parse(_events(), 2, host_s=80e-6)
    run = _run(name, stretch)
    got = {k: v["value"] for k, v in harness.read_metrics(run, trace=True).items()}
    listed = {m["name"] for m in harness.metric_entries(name, trace=True)}
    assert set(got) == listed
    want = _expected(run)
    for k in listed & set(want):
        assert got[k] == pytest.approx(want[k]), k
    if "kernel_roofline_pct.recurrence" in got:
        # the set's kernels ran 45 µs (gru_wide_fwd 20, atb_tc 25) for 2 steps
        reader = harness.reader("kernel_roofline_pct.recurrence")
        assert got["kernel_roofline_pct.recurrence"] > 0
        assert reader(run, "recurrence") == got["kernel_roofline_pct.recurrence"]


def test_no_reading_without_the_card_or_the_trace():
    run = _run("measure_h512_train")
    run.device_kind = "cpu"
    assert harness.reader("mfu_pct")(run) is None
    assert harness.reader("device_idle_pct")(run) is None
    assert harness.reader("kernel_roofline_pct.recurrence")(run, "recurrence") is None
