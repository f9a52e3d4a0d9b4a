"""The port's ``utils/profiling.py`` against the JAX package's:
``StepTimer`` reads the same clock the same way (``time.perf_counter``
patched to a clock the test sets, so both meters see the same times;
the rates must be equal, NaN where JAX's is NaN), and ``trace`` writes a
Chrome trace of the enclosed work on the CPU."""

import glob
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from arvae_tpu.utils.profiling import StepTimer as JaxStepTimer
from arvae_tpu_torch.utils.profiling import StepTimer, assert_tensors_finite, trace


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_jax(monkeypatch, warmup):
    clock = _Clock(100.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    port, jax_timer = StepTimer(warmup=warmup), JaxStepTimer(warmup=warmup)
    gaps = np.random.RandomState(warmup).uniform(0.01, 0.5, 7)
    start = clock.t  # when the warmup ends: construction for 0
    for n, gap in enumerate(gaps, start=1):
        clock.t += gap
        port.tick()
        jax_timer.tick()
        if n == warmup:
            start = clock.t
        clock.t += 0.125  # the meter is read a while after the tick
        got, want = port.steps_per_sec, jax_timer.steps_per_sec
        if n <= warmup:
            assert math.isnan(got) and math.isnan(want)
            continue
        assert got == want
        # the steps after the warmup over the time since it ended
        assert got == pytest.approx((n - warmup) / (clock.t - start), rel=1e-12)


def test_step_timer_is_nan_before_any_tick():
    assert math.isnan(StepTimer(warmup=0).steps_per_sec)
    assert math.isnan(StepTimer(warmup=2).steps_per_sec)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    with trace(log_dir) as prof:
        c = a @ b
    np.testing.assert_allclose(c.numpy(), a.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul") for e in prof.key_averages())


def test_assert_tensors_finite_names_the_bad_tensor():
    assert_tensors_finite({"w": torch.ones(3), "steps": torch.tensor([1, 2])})
    with pytest.raises(ValueError, match=r"\['b'\]"):
        assert_tensors_finite({"a": torch.ones(2), "b": torch.tensor([1.0, float("nan")])})
