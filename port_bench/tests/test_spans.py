"""The span readings of ``spans.py``: their arithmetic on a synthetic run
(two completed steps, the one ``harness.Stop`` ended, a shuffle, an op span
on autograd's thread), a synthetic profiler trace charged to the right
spans, the stretch's clock anchors and thread ids from synthetic trace
events, and the recorder on only in the two span phases: off through
``run.py``'s window and stretch."""

import pytest
import torch

from arvae_tpu_torch.utils import profiling
from arvae_tpu_torch.utils.profiling import SpanRecord
from port_bench import harness, spans, trace
from port_bench.spans import Charges, Timeline, charge_trace, clock_offset
from port_bench.tests.conftest import tiny_cell

MAIN, GRAD = 11, 22


def _step(base, first, step, failed=False):
    """One step's spans from ``base`` ns, its first record's index ``first``."""
    if failed:
        return [SpanRecord("step", base, base + 1_000, None, step, MAIN, True),
                SpanRecord("gather", base + 100, base + 500, first, step, MAIN, False),
                SpanRecord("train_step", base + 500, base + 1_000, first, step, MAIN, True)]
    f = first
    return [SpanRecord("step", base, base + 10_000, None, step, MAIN, False),
            SpanRecord("gather", base + 100, base + 1_000, f, step, MAIN, False),
            SpanRecord("train_step", base + 1_000, base + 9_000, f, step, MAIN, False),
            SpanRecord("forward", base + 1_100, base + 3_000, f + 2, step, MAIN, False),
            SpanRecord("loss", base + 3_000, base + 4_000, f + 2, step, MAIN, False),
            SpanRecord("labels", base + 3_100, base + 3_600, f + 4, step, MAIN, False),
            SpanRecord("optimizer", base + 4_000, base + 4_200, f + 2, step, MAIN, False),
            SpanRecord("backward", base + 4_200, base + 8_000, f + 2, step, MAIN, False),
            SpanRecord("op:gru_chain.bwd", base + 5_000, base + 7_000, f + 7, step, GRAD, False),
            SpanRecord("optimizer", base + 8_000, base + 8_900, f + 2, step, MAIN, False),
            SpanRecord("accumulate", base + 9_000, base + 10_000, f, step, MAIN, False)]


def _records():
    return ([SpanRecord("shuffle", 0, 1_000, None, -1, MAIN, False)] + _step(1_000, 1, 0)
            + _step(11_000, 12, 1) + _step(21_000, 23, 2, failed=True))


def _charges():
    """Per completed step: randperm once (shuffle), then index_select 3 µs
    (gather), a GEMM 10 (forward), CE 4 (loss), the chain 20 and a memset
    1 (op span), elementwise 6 (backward), Adam 5, the sums 1; the
    stopped step's gather 3; 2 µs launched outside every span. Idle: 4
    µs before the forward's GEMM, 2 before the backward's elementwise, 3
    before the gather, 1 before the stopped gather, 5 at the end."""
    ops, gaps = [("randperm", 2.0, 0)], []
    for f in (1, 12):
        ops += [("index_select", 3.0, f + 1), ("gemm", 10.0, f + 3), ("ce", 4.0, f + 4),
                ("gru_wide_bwd", 20.0, f + 8), ("Memset", 1.0, f + 8),
                ("elementwise", 6.0, f + 7), ("multi_tensor_apply", 5.0, f + 9),
                ("add", 1.0, f + 10)]
        gaps += [(4.0, f + 3), (2.0, f + 7), (3.0, f + 1)]
    ops += [("index_select", 3.0, 24), ("stray", 2.0, None)]
    gaps += [(1.0, 24), (5.0, None)]
    return Charges(ops, gaps, [("cudaStreamSynchronize", 10), ("cudaMemcpy", None)])


def _run(offsets=((100.0, 1.0), (110.0, 1.5))):
    stretch = spans.SpanStretch(40, _records(), _charges(), list(offsets), True)
    return spans.SpanRun(stretch, _records(), 9.5, 10.0)


def test_readings_are_the_arithmetic_of_the_spans():
    got = spans.readings(_run())
    ms = 1e-6  # ns to ms
    want = {"host_ms.input": (900 * 2 + 1_000) / 2 * ms,  # the shuffle over 2 steps
            "host_ms.forward": (1_900 + 1_000) * ms, "host_ms.backward": 3_800 * ms,
            "host_ms.optimizer": (200 + 900) * ms,
            "device_ms.input": (2.0 + 2 * 3.0) / 2e3, "device_ms.forward": 14.0 / 1e3,
            "device_ms.backward": 27.0 / 1e3, "device_ms.optimizer": 5.0 / 1e3,
            "idle_ms.input": 3.0 / 1e3, "idle_ms.forward": 4.0 / 1e3,
            "idle_ms.backward": 2.0 / 1e3, "idle_ms.optimizer": 0.0,
            "op_device_ms.recurrence": 21.0 / 1e3}
    assert set(got) == set(want)
    assert got == pytest.approx(want)
    # the phases and the remainder make up the stretch
    busy = sum(us for _, us, _ in _charges().ops) / 2e3
    remainder = busy - sum(got[f"device_ms.{p}"] for p in spans.PHASE_NAMES)
    assert remainder == pytest.approx((2 * 1.0 + 3.0 + 2.0) / 2e3)  # sums, stopped gather, stray


def test_no_device_reading_where_the_anchors_disagree():
    got = spans.readings(_run(((100.0, 1.0), (100.0 + spans.CLOCK_TOLERANCE_US + 1, 1.0))))
    assert set(got) == {f"host_ms.{p}" for p in spans.PHASE_NAMES}


def test_the_report_itemises_spans_syncs_and_the_kernel_set():
    cost = {"off_span": 60.0, "off_call": 90.0, "on_span": 900.0, "on_call": 1000.0}
    result, lines = spans.report(_run(), 9.0, 10.0, cost, {"gru_wide_bwd"})
    assert result["spans_a_step"] == pytest.approx((1 + 2 * 11) / 2)
    assert result["host"]["step"] == {"host_ms": pytest.approx(0.01),
                                      "self_ms": pytest.approx(0.0001)}  # 10 - 0.9 - 8 - 1 µs
    assert result["host"]["loss"]["self_ms"] == pytest.approx(0.0005)
    assert result["syncs_a_step"] == {"cudaStreamSynchronize in optimizer": 0.5,
                                      "cudaMemcpy in (none)": 0.5}
    assert result["recurrence"] == {"kernel_set_ms": pytest.approx(0.02),
                                    "beyond_set_ms": {"Memset": pytest.approx(0.001)}}
    assert result["under_step_pct"] == pytest.approx(100 * 100 / 107)  # all but randperm, the stopped gather, the stray
    assert any(line.startswith("clock: ") and "agree" in line for line in lines)


class _Rec:
    main_tid, threads = 7, {7: 140311806145280, 9: 140002}

    def records(self):
        return [SpanRecord("step", 1_000_000, 2_000_000, None, 0, 7, False)]


@pytest.mark.parametrize("tid,known", [(480447744, True), (7, False), (5, False)])
def test_read_stretch_anchors_the_clock_and_names_the_threads(tid, known):
    """Two opening spins and the closing one; the last opening spin's
    launch was bracketed by [900, 960] µs on the spans' clock and
    recorded at 5900.0, the closing one's by [2000, 2003] and recorded
    at 7001.0: offsets 5000.0 ± 60 and 5001.0 ± 3."""
    ev = []
    for corr, (ts, launch) in enumerate([(100.0, 800.0), (140.0, 5900.0), (3100.0, 7001.0)]):
        ev.append({"ph": "X", "cat": "kernel", "name": trace.SPIN, "ts": ts, "dur": 30.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 2.0, "tid": tid, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1000.0, "dur": 50.0,
               "args": {"correlation": 9}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6500.0,
               "dur": 2.0, "tid": tid, "args": {"correlation": 9}})
    st = spans.read_stretch(ev, _Rec(), ((900_000, 960_000), (2_000_000, 2_003_000)), 1,
                            opening=1)
    assert st.offsets == [pytest.approx((5000.0, 60.0)), pytest.approx((5001.0, 3.0))]
    assert st.clock_agrees and st.threads_known == known
    # gemm launched at 6500 - 5000.5 = 1499.5 µs on the spans' clock: inside the step
    assert st.charges.ops == [("gemm", 50.0, 0)]
    assert st.charges.gaps == [(1000.0 - 170.0, 0), (3100.0 - 1050.0, None)]
    assert spans.read_stretch(ev, _Rec(), ((0, 1), (2, 3)), 1, opening=2) is None


def test_the_recorder_is_on_only_in_the_span_phases(monkeypatch):
    """Through a run's phases (checked, warm-up, window, the profiled
    stretch) the recorder is off; in :func:`spans.measure`'s two phases
    it is on at every step (the stretch's profiler stood in for on the
    CPU)."""
    seen = []
    call = harness.Driver.__call__

    def noted(self, batch, **kw):
        seen.append(profiling.active() is not None)
        return call(self, batch, **kw)

    monkeypatch.setattr(harness.Driver, "__call__", noted)

    def stretch_without_profiler(run_steps, steps):
        run_steps()

    monkeypatch.setattr(trace, "profile_stretch", stretch_without_profiler)
    cell = tiny_cell("dsprites_b128_train")
    cell.traffic.update(trace_steps=2)
    harness.run_cell(cell, 5, 0.05, True, "cpu", 0.0)
    assert seen and not any(seen)

    seen.clear()
    runner, driver = spans._program(cell, 5, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def stretch_recorded(run_steps, steps):
        with profiling.recording():
            run_steps()

    monkeypatch.setattr(spans, "profile_stretch", stretch_recorded)
    run = spans.measure(runner, driver, cell.traffic)
    # each phase's last call raises harness.Stop, which the recorder also sees
    assert seen == [True] * (2 + 1 + spans.SPANS_ONLY_FACTOR * 2 + 1)
    assert len(spans.completed(run.records)) == spans.SPANS_ONLY_FACTOR * 2
    assert profiling.active() is None


def test_clock_offset_is_the_launch_less_the_brackets_start():
    assert clock_offset((2_000_000, 2_003_000), 5_002.5) == pytest.approx((3_002.5, 3.0))


def _synthetic(offset):
    """A recording of one step and the trace of its launches, the trace's
    host clock ``offset`` µs ahead of the spans' (ns): the main thread (1)
    gathers, runs the forward and the backward (where autograd's thread
    (2) launches inside an op span and outside one), then Adam, which
    waits on the stream; a kernel of the forward leaves the card idle."""
    main, grad = 1, 2
    recs = [SpanRecord("step", 0, 100_000, None, 0, main, False),
            SpanRecord("gather", 1_000, 10_000, 0, 0, main, False),
            SpanRecord("train_step", 11_000, 99_000, 0, 0, main, False),
            SpanRecord("forward", 12_000, 40_000, 2, 0, main, False),
            SpanRecord("backward", 41_000, 80_000, 2, 0, main, False),
            SpanRecord("op:k.bwd", 50_000, 60_000, 4, 0, grad, False),
            SpanRecord("optimizer", 81_000, 98_000, 2, 0, main, False)]
    launches = [("gather_k", 5_000, main, 1000.0, 10.0), ("fwd_k", 20_000, main, 1030.0, 20.0),
                ("bwd_k", 55_000, grad, 1050.0, 30.0), ("bwd_elementwise", 70_000, grad, 1078.0, 5.0),
                ("adam", 85_000, main, 1085.0, 15.0)]
    events = [{"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 990.0, "dur": 10.0,
               "args": {"correlation": 99}}]
    for corr, (name, t, tid, ts, dur) in enumerate(launches):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": t / 1e3 + offset, "dur": 1.0, "tid": tid,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                       "args": {"correlation": corr}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                   "ts": 90_000 / 1e3 + offset, "dur": 3.0, "tid": main, "args": {}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                   "ts": 30_000 / 1e3 + offset, "dur": 1.0, "tid": main, "args": {}})
    return recs, main, events


@pytest.mark.parametrize("tids", [{}, None], ids=["threads_known", "threads_unknown"])
def test_charge_trace_puts_ops_gaps_and_syncs_to_their_spans(tids):
    offset = 123_456.75
    recs, main, events = _synthetic(offset)
    got = charge_trace(events, Timeline(recs, main), offset, (1000.0, 1110.0),
                       (offset, offset + 100.0), tids)
    names = [r.name for r in recs]
    spans = {n: (names[s] if s is not None else None) for n, _, s in got.ops}
    assert spans == {"gather_k": "gather", "fwd_k": "forward", "bwd_k": "op:k.bwd",
                     "bwd_elementwise": "backward", "adam": "optimizer"}
    # bwd_elementwise overlaps bwd_k by 2 µs: it adds 3 µs to busy time
    assert [us for _, us, _ in got.ops] == pytest.approx([10.0, 20.0, 30.0, 3.0, 15.0])
    # idle: 1010-1030 before fwd_k, 1083-1085 before adam, 1100-1110 to the end
    gaps = [(round(us, 6), names[s] if s is not None else None) for us, s in got.gaps]
    assert gaps == [(20.0, "forward"), (2.0, "optimizer"), (10.0, None)]
    assert [(n, names[s]) for n, s in got.syncs] == [("cudaStreamSynchronize", "optimizer")]


def test_timeline_charges_the_deepest_span_and_falls_back_to_the_main_thread():
    recs, main, _ = _synthetic(0.0)
    line = Timeline(recs, main)
    assert recs[line.at(55_000)].name == "op:k.bwd"  # deepest on any thread
    assert recs[line.at(55_000, main)].name == "backward"
    assert recs[line.at(70_000, 2)].name == "backward"  # thread 2 has none open
    assert line.at(100_001) is None and line.at(-1) is None and line.at(500) == 0
