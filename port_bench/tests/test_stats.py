"""The p95, the intervals, the stretch's idle and busy arithmetic on
synthetic records, and the driver's host spans."""

import pytest

from port_bench import harness, stats, trace


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([10.0, 0.0], 95) == pytest.approx(9.5)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_clip_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9)]
    assert stats.union(iv) == [(0, 3), (5, 9)]
    assert stats.covered(iv) == 7
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (9, 10)]
    assert stats.covered(stats.clip(iv, 1, 6)) == 3


def _events():
    """Opening spin kernels end at 0, the closing one starts at 100 µs;
    device work 10-30 (gru_wide_fwd) and 50-60 + 55-70 (atb_tc,
    overlapping); runtime calls tied to them by correlation ids."""
    def X(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    return [X("kernel", "void spin_kernel(long)", -50, 40, 1),
            X("kernel", "void spin_kernel(long)", -10, 10, 2),
            X("kernel", "void spin_kernel(long)", 100, 50, 9),
            X("kernel", "void arvae::gru_wide_fwd<32>(float const*)", 10, 20, 5),
            X("kernel", "void arvae::atb_tc<Tile>(float*)", 50, 10, 6),
            X("kernel", "void arvae::atb_tc<Tile>(float*)", 55, 15, 7),
            X("cuda_runtime", "cudaLaunchKernel", -60, 2, 1),
            X("cuda_runtime", "cudaLaunchKernel", -58, 2, 2),
            X("cuda_runtime", "cudaDeviceSynchronize", -56, 60, 3),  # before the stretch
            X("cuda_runtime", "cudaLaunchKernel", 6, 2, 5),
            X("cuda_runtime", "cudaLaunchKernel", 20, 2, 10),
            X("cuda_runtime", "cudaLaunchKernel", 46, 12, 6),
            X("cuda_driver", "cuLaunchKernel", 72, 2, 7),
            X("cuda_runtime", "cudaStreamSynchronize", 80, 5, 8),
            X("cuda_runtime", "cudaLaunchKernel", 90, 2, 9)]


def test_stretch_readings():
    s, spins = trace.parse(_events(), 2, host_s=80e-6)
    assert spins == 3
    assert (s.start, s.end) == (0, 100)
    assert [c[0] for c in s.runtime] == ["cudaLaunchKernel"] * 3 + ["cuLaunchKernel",
                                                                   "cudaStreamSynchronize"]
    assert s.busy_s == pytest.approx(40e-6)  # 10-30 and 50-70
    assert s.window_s == pytest.approx(100e-6)
    assert s.device_time_s({"atb_tc"}) == pytest.approx(25e-6)
    ops = dict(s.device_ops())
    assert ops["atb_tc<Tile>"] == pytest.approx(25e-6)
    gaps = dict(s.idle_gaps())
    # idle 0-10 (issuing gru_wide_fwd), 30-50 (issuing atb_tc), 70-100 (no
    # call open at 70, no operation after it)
    assert gaps["host: issuing gru_wide_fwd<32>"] == pytest.approx(10e-6)
    assert gaps["host: issuing atb_tc<Tile>"] == pytest.approx(20e-6)
    assert gaps["host: issuing nothing"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_a_stretch_without_its_spin_kernels_reads_nothing():
    s, spins = trace.parse([e for e in _events() if "spin" not in e["name"]], 2, 1.0)
    assert spins == 0 and not s.device and not s.runtime


def test_the_driver_sums_the_host_spans_of_the_steps_it_takes(monkeypatch):
    """Each taken step's span is its gather and its call; the gather of
    the step the driver stops at counts nothing."""
    clock = iter(range(100))
    monkeypatch.setattr(harness.time, "perf_counter", lambda: float(next(clock)))
    driver = harness.Driver(lambda batch: {"loss": batch})
    gather = driver.gather(lambda i: i)
    driver.phase(limit=2)
    for i in range(3):
        batch = gather(i)  # 1 s on the fake clock
        try:
            driver(batch)  # 1 s
        except harness.Stop:
            break
    assert driver.taken == 2
    assert driver.host_s == 4.0
    driver.phase(limit=1)
    assert driver.host_s == 0.0
