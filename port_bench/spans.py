"""The port's step-phase spans read against the card.

The port records spans (``arvae_tpu_torch.utils.profiling``: ``step``,
``gather``, ``forward``, ``backward``, ``op:<kernel>.<pass>`` and the
rest) only while code turns its recorder on; nothing in a run of
``run.py`` does. :func:`measure` runs two phases after a cell's steps
have warmed up, with the recorder on in each, (b) first: steps after a
profiled stretch issue slower (the profiler's cost stays on the launches
after it), so (b) is run before any profiler of the process:

(a) a profiled stretch of the traffic's ``trace_steps`` steps, profiled
    as ``trace.py`` profiles its own (CUDA activity only, between spin
    kernels) and read with each operation's correlation id. The spans
    are put on the trace's clock by two anchors, the launches of the
    last opening and of the closing spin kernel, each bracketed by
    ``time.perf_counter_ns()``: the launch record's ``ts`` less the
    bracket's start is the offset, the bracket's width its error. Where
    the two offsets differ by more than ``CLOCK_TOLERANCE_US`` nothing of
    the stretch is read. Each kernel, copy or memset is charged to the
    deepest span open at its launch, each idle gap of the card to the
    span that launched the operation ending it (the card waited on the
    host's issue of that work), each blocking runtime call to the span
    it ran in. Where the trace's runtime records name the threads as
    :func:`kineto_tid` gives them (as on the card), the launching
    thread's spans are the ones looked at;
(b) ``SPANS_ONLY_FACTOR`` × ``trace_steps`` steps with no profiler: the
    host time of each span without CUPTI's cost a step.

A phase's last step, which ``harness.Driver``'s ``Stop`` ends inside its span,
is left out, and so is what it launched. The phases of a step
(``PHASES``): input (``gather``, and the epoch's ``shuffle`` over the
steps), forward (``forward`` and ``loss``), backward, optimizer. What no
phase holds (the ``step``, ``train_step`` and ``accumulate`` spans' own
work, the left-out step, the last idle gap) is the remainder.

    python3 -m port_bench.spans --workload <cell> --seed <n> [--seconds <s>]

runs a cell's set-up and warm-up as ``run.py`` does, a window of
``--seconds`` with the recorder off (the host's issue a step without
spans), the recorder's cost a span, (b) and (a), and a second window
like the first (the steps after a profiler), and prints ``[spans]``
lines on standard error and one JSON line: the readings of
:func:`readings`, each span's host, device and idle ms a step, the
syncs, and the recorder's cost. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

from port_bench import harness, stats, trace

SPANS_ONLY_FACTOR = 5
CLOCK_TOLERANCE_US = 50.0
PHASES = {"shuffle": "input", "gather": "input", "forward": "forward", "loss": "forward",
          "backward": "backward", "optimizer": "optimizer"}
PHASE_NAMES = ("input", "forward", "backward", "optimizer")
# the op spans of the recurrence kernels' wrappers (``op_device_ms.recurrence``)
RECURRENCE_OPS = ("op:gru_chain.", "op:hier_tick_chain.", "op:gemm.")
# spans timed to price the recorder, off and on
COST_SPANS_OFF, COST_SPANS_ON = 200_000, 5_000
# runtime calls that block the host until the card has done work
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


class Timeline:
    """The spans of a recording by host time: on each thread, which span
    was open innermost at an instant (``time.perf_counter_ns()``)."""

    def __init__(self, records: Sequence, main_tid: int):
        self.main_tid = main_tid
        self.depth: List[int] = []
        for r in records:
            self.depth.append(0 if r.parent is None else self.depth[r.parent] + 1)
        by_tid: Dict[int, list] = defaultdict(list)
        for i, r in enumerate(records):
            if r.end is not None:
                by_tid[r.tid] += [(r.start, 1, i), (r.end, 0, i)]
        self._lines: Dict[int, Tuple[List[int], List[Optional[int]]]] = {}
        for tid, marks in by_tid.items():
            times, inner, stack = [], [], []
            for t, opens, i in sorted(marks):  # at one instant a span closes before one opens
                if opens:
                    stack.append(i)
                else:
                    stack.remove(i)
                times.append(t)
                inner.append(stack[-1] if stack else None)
            self._lines[tid] = (times, inner)

    def innermost(self, tid: int, t: int) -> Optional[int]:
        """The innermost span open on thread ``tid`` at ``t``."""
        line = self._lines.get(tid)
        if line is None:
            return None
        k = bisect.bisect_right(line[0], t) - 1
        return line[1][k] if k >= 0 else None

    def at(self, t: int, tid: Optional[int] = None) -> Optional[int]:
        """The span to charge with host time ``t``: with ``tid`` the
        innermost open on that thread, or on the main thread where that
        one has none open; without, the deepest open on any thread."""
        if tid is not None:
            i = self.innermost(tid, t)
            return self.innermost(self.main_tid, t) if i is None else i
        found = [i for i in (self.innermost(th, t) for th in self._lines) if i is not None]
        return max(found, key=self.depth.__getitem__, default=None)


class Charges(NamedTuple):
    """What :func:`charge_trace` charged to spans (None: to no span)."""

    ops: List[Tuple[str, float, Optional[int]]]  # (device op, µs it adds to busy, span)
    gaps: List[Tuple[float, Optional[int]]]  # (idle µs, span)
    syncs: List[Tuple[str, Optional[int]]]  # (blocking runtime call, span)


def clock_offset(bracket: Tuple[int, int], launch_ts: float) -> Tuple[float, float]:
    """(offset, error), µs, of a trace's host clock ahead of
    ``time.perf_counter_ns()``, from one launch bracketed by that clock
    (``bracket``, ns before and after) and its runtime record's ``ts``
    (µs): the record's time less the bracket's start, the bracket's
    width its error."""
    start, end = bracket
    return launch_ts - start / 1e3, (end - start) / 1e3


def charge_trace(events: Sequence[dict], timeline: Timeline, offset_us: float,
                 device: Tuple[float, float], host: Tuple[float, float],
                 tids: Optional[Mapping[int, int]] = None) -> Charges:
    """Charges a Chrome trace's device operations run inside ``device``
    (µs, the card's span), the card's idle gaps there, and the blocking
    runtime calls made inside ``host`` (µs, the trace's host clock), to
    the spans of ``timeline``. A runtime record's time less ``offset_us``
    (:func:`clock_offset`) is its time on the spans' clock. ``tids`` maps
    a runtime record's ``tid`` to the spans' thread id (an id it lacks
    stands for itself); None where the trace's ids are not the threads',
    and the deepest span on any thread is charged. An operation adds to busy time only what earlier
    operations did not cover; a gap (``stats.gaps``) goes to the span
    that launched the operation ending it, the last one to none."""
    xs = [e for e in events if e.get("ph") == "X"]
    runtime = [e for e in xs if e.get("cat") in trace.HOST_CATS]
    launch = {e["args"]["correlation"]: e for e in runtime
              if "correlation" in e.get("args", {})}

    def charged(call: Optional[dict]) -> Optional[int]:
        if call is None:
            return None
        tid = None if tids is None else tids.get(call.get("tid"), call.get("tid"))
        return timeline.at(round((call["ts"] - offset_us) * 1e3), tid)

    lo, hi = device
    inside = sorted((e for e in xs if e.get("cat") in trace.DEVICE_CATS
                     and lo <= e["ts"] and e["ts"] + e["dur"] <= hi), key=lambda e: e["ts"])
    owners = [charged(launch.get(e.get("args", {}).get("correlation"))) for e in inside]
    ops, covered = [], lo
    for e, owner in zip(inside, owners):
        start, end = e["ts"], e["ts"] + e["dur"]
        ops.append((e["name"], max(0.0, end - max(start, covered)), owner))
        covered = max(covered, end)
    starts = [e["ts"] for e in inside]
    gaps = []
    for g0, g1 in stats.gaps([(e["ts"], e["ts"] + e["dur"]) for e in inside], lo, hi):
        j = bisect.bisect_left(starts, g1)
        gaps.append((g1 - g0, owners[j] if j < len(inside) else None))
    syncs = [(e["name"], charged(e)) for e in runtime
             if e["name"] in SYNC_CALLS and host[0] <= e["ts"] <= host[1]]
    return Charges(ops, gaps, syncs)


@dataclass
class SpanStretch:
    """Phase (a): the spans of ``steps`` profiled steps and what the
    trace charged to them (µs)."""

    steps: int
    records: list
    charges: Charges
    offsets: List[Tuple[float, float]]  # (offset, error) µs of each anchor
    threads_known: bool  # the trace's runtime tids named the spans' threads

    @property
    def clock_agrees(self) -> bool:
        (a, _), (b, _) = self.offsets
        return abs(a - b) <= CLOCK_TOLERANCE_US


@dataclass
class SpanRun:
    """Both phases: (a), and (b)'s spans, and host issue
    (``Driver.host_s``) and host-clock step, ms a step."""

    stretch: Optional[SpanStretch]
    records: list
    host_issue_ms: float
    step_ms: float


def completed(records) -> set:
    """The steps whose ``step`` span no exception closed."""
    return {r.step for r in records if r.name == "step" and not r.failed}


def counted(records, i: Optional[int], done: set) -> Optional[int]:
    """Span ``i`` where it belongs to a completed step or is a shuffle,
    else None."""
    if i is None:
        return None
    r = records[i]
    return i if r.step in done or r.name == "shuffle" else None


def phase_of(records, i: Optional[int], done: set) -> Optional[str]:
    """The phase of span ``i``: that of its nearest span named in ``PHASES``."""
    while i is not None and records[i].name not in PHASES:
        i = records[i].parent
    i = counted(records, i, done)
    return None if i is None else PHASES[records[i].name]


def _ms(r) -> float:
    return (r.end - r.start) / 1e6


def host_table(records) -> Dict[str, Dict[str, float]]:
    """{span name: {"host_ms", "self_ms"}} a completed step: each span's
    host time and the part no child span covers."""
    done = completed(records)
    children = [0.0] * len(records)
    for r in records:
        if r.parent is not None:
            children[r.parent] += _ms(r)
    out: Dict[str, Dict[str, float]] = {}
    for i, r in enumerate(records):
        if counted(records, i, done) is None:
            continue
        row = out.setdefault(r.name, {"host_ms": 0.0, "self_ms": 0.0})
        row["host_ms"] += _ms(r) / len(done)
        row["self_ms"] += (_ms(r) - children[i]) / len(done)
    return out


def device_table(st: SpanStretch) -> Dict[str, Dict[str, float]]:
    """{span name: {"device_ms", "idle_ms"}} a completed step of the
    stretch: the operations and gaps charged to each span."""
    done, recs = completed(st.records), st.records
    out: Dict[str, Dict[str, float]] = {}
    items = [(s, us, "device_ms") for _, us, s in st.charges.ops] + \
            [(s, us, "idle_ms") for us, s in st.charges.gaps]
    for s, us, key in items:
        s = counted(recs, s, done)
        name = "(none)" if s is None else recs[s].name
        row = out.setdefault(name, {"device_ms": 0.0, "idle_ms": 0.0})
        row[key] += us / 1e3 / len(done)
    return out


def recurrence_ms(st: SpanStretch) -> float:
    """Device ms a completed step of the operations launched inside the
    recurrence kernels' op spans."""
    done, recs = completed(st.records), st.records
    total = 0.0
    for _, us, s in st.charges.ops:
        while s is not None and not recs[s].name.startswith(RECURRENCE_OPS):
            s = recs[s].parent
        if counted(recs, s, done) is not None:
            total += us
    return total / 1e3 / len(done)


def readings(run: SpanRun) -> Dict[str, float]:
    """The per-layer readings, ms a completed step: ``host_ms.<phase>``
    from (b); ``device_ms.<phase>``, ``idle_ms.<phase>`` and
    ``op_device_ms.recurrence`` from (a), where its anchors agree
    (the last only where an op span launched anything)."""
    done = completed(run.records)
    out = {f"host_ms.{p}": 0.0 for p in PHASE_NAMES}
    for i, r in enumerate(run.records):
        if r.name in PHASES and counted(run.records, i, done) is not None:
            out[f"host_ms.{PHASES[r.name]}"] += _ms(r) / len(done)
    st = run.stretch
    if st is None or not st.clock_agrees:
        return out
    done = completed(st.records)
    for p in PHASE_NAMES:
        out[f"device_ms.{p}"] = out[f"idle_ms.{p}"] = 0.0
    for _, us, s in st.charges.ops:
        p = phase_of(st.records, s, done)
        if p is not None:
            out[f"device_ms.{p}"] += us / 1e3 / len(done)
    for us, s in st.charges.gaps:
        p = phase_of(st.records, s, done)
        if p is not None:
            out[f"idle_ms.{p}"] += us / 1e3 / len(done)
    rec = recurrence_ms(st)
    if rec > 0:
        out["op_device_ms.recurrence"] = rec
    return out


def kineto_tid(ident: int) -> int:
    """A pthread id as the profiler's runtime records give it: its low 32
    bits read as a signed integer, without the sign."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def thread_ids(events, host: Tuple[float, float], main_tid: int, threads: Dict[int, int]
               ) -> Optional[Dict[int, int]]:
    """The ``tids`` of :func:`charge_trace`: where the trace's runtime
    records name the recording's main thread by :func:`kineto_tid` of
    its pthread id (``threads`` maps the recorder's OS ids to them), a
    map from those ids to the OS ids; else None."""
    seen = {e.get("tid") for e in events if e.get("ph") == "X"
            and e.get("cat") in trace.HOST_CATS and host[0] <= e["ts"] <= host[1]}
    if kineto_tid(threads[main_tid]) not in seen:
        return None
    return {kineto_tid(ident): native for native, ident in threads.items()}


def read_stretch(events: List[dict], rec, brackets, steps: int,
                 opening: int) -> Optional[SpanStretch]:
    """Phase (a) from one profiled stretch's trace events and recorder;
    None where the trace lost an opening kernel or an anchor's launch."""
    xs = [e for e in events if e.get("ph") == "X"]
    spins = sorted((e for e in xs if e.get("cat") in trace.DEVICE_CATS
                    and trace.SPIN in e["name"]), key=lambda e: e["ts"])
    if len(spins) != 2 + opening:
        return None
    launch = {e.get("args", {}).get("correlation"): e for e in xs
              if e.get("cat") in trace.HOST_CATS}
    calls = [launch.get(e.get("args", {}).get("correlation")) for e in spins[-2:]]
    if None in calls:
        return None
    offsets = [clock_offset(b, c["ts"]) for b, c in zip(brackets, calls)]
    host = (calls[0]["ts"], calls[1]["ts"])
    device = (max(e["ts"] + e["dur"] for e in spins[:-1]), spins[-1]["ts"])
    tids = thread_ids(events, host, rec.main_tid, rec.threads)
    records = rec.records()
    offset = (offsets[0][0] + offsets[1][0]) / 2
    charges = charge_trace(events, Timeline(records, rec.main_tid), offset, device, host, tids)
    return SpanStretch(steps, records, charges, offsets, tids is not None)


def _bracket(cycles: int) -> Tuple[int, int]:
    """Launches a spin kernel between two readings of the spans' clock."""
    import torch

    t0 = time.perf_counter_ns()
    torch.cuda._sleep(cycles)
    return t0, time.perf_counter_ns()


def profile_stretch(run_steps, steps: int) -> SpanStretch:
    """Phase (a): profiles ``run_steps()`` (``steps`` steps) with the
    recorder on, between spin kernels as ``trace.profile_stretch`` does,
    with four times as many opening kernels after a stretch that lost one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arvae_tpu_torch.utils import profiling

    opening = trace.OPENING_KERNELS
    for _ in range(trace.ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(trace.PAD_CYCLES)
            for _ in range(opening - 1):
                torch.cuda._sleep(trace.OPENING_CYCLES)
            first = _bracket(trace.OPENING_CYCLES)
            torch.cuda.synchronize()
            with profiling.recording() as rec:
                run_steps()
            last = _bracket(trace.PAD_CYCLES)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        stretch = read_stretch(events, rec, (first, last), steps, opening)
        if stretch is not None:
            return stretch
        opening *= 4
    raise RuntimeError(f"no profiled stretch of {trace.ATTEMPTS} recorded every opening "
                       "kernel and both anchors' launches")


def measure(runner, driver: harness.Driver, traffic: dict) -> Optional[SpanRun]:
    """Phases (a) and (b) on warmed-up steps of ``runner`` (the epoch
    runner of ``driver``); None for a program without the recorder."""
    import torch

    from arvae_tpu_torch.utils import profiling

    if not hasattr(profiling, "recording"):
        return None
    steps = traffic["trace_steps"]
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        t0 = time.perf_counter()
        taken = harness.run_phase(runner, driver, limit=SPANS_ONLY_FACTOR * steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    issue_ms = 1e3 * driver.host_s / taken
    stretch = profile_stretch(lambda: harness.run_phase(runner, driver, limit=steps), steps)
    return SpanRun(stretch, rec.records(), issue_ms, 1e3 * seconds / taken)


def span_cost_ns() -> Dict[str, float]:
    """Host ns of one span site: a ``with span()`` and a ``spanned``
    call over a plain call, recording off and on (best of three loops)."""
    from arvae_tpu_torch.utils import profiling

    span = profiling.span

    @profiling.spanned("op:cost")
    def wrapped():
        pass

    def plain():
        pass

    def per(n, body):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            body(n)
            best = min(best, time.perf_counter_ns() - t0)
        return best / n

    def loop(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span("cost"):
                pass

    def calls(fn):
        def body(n):
            for _ in range(n):
                fn()
        return body

    out = {"off_span": per(COST_SPANS_OFF, spans) - per(COST_SPANS_OFF, loop),
           "off_call": per(COST_SPANS_OFF, calls(wrapped)) - per(COST_SPANS_OFF, calls(plain))}
    with profiling.recording():
        out["on_span"] = per(COST_SPANS_ON, spans) - per(COST_SPANS_ON, loop)
        out["on_call"] = per(COST_SPANS_ON, calls(wrapped)) - per(COST_SPANS_ON, calls(plain))
    return out


def _program(cell: harness.Cell, seed: int, device):
    """(epoch runner, driver) of the cell's program, built as ``harness.run_cell`` builds it."""
    from arvae_tpu_torch.data.device_data import DeviceEpochRunner

    from port_bench import data, weights

    tr, cfg = cell.traffic, cell.cfg
    trainer, split = cell.module("programs").build(cfg, tr, seed, device,
                                                   data.make_inputs(tr, cfg, seed, device))
    harness.load_weights(trainer, weights.init_weights(
        cell.module("reference").param_spec(cfg), seed, device))
    driver = harness.Driver(trainer.train_step)
    split.gather_batch = driver.gather(split.gather_batch)
    return DeviceEpochRunner(split, split, tr["batch"], driver, trainer.eval_step,
                             trainer.perm_generator), driver


def report(run: SpanRun, window_issue_ms: float, window_step_ms: float,
           cost: Dict[str, float], kernel_set: set) -> Tuple[dict, List[str]]:
    """(the JSON result, the ``[spans]`` lines) of one measured run."""
    from port_bench.trace import base_name, short_name

    got = readings(run)
    host = host_table(run.records)
    per_step = sum(1 for i in range(len(run.records))
                   if counted(run.records, i, completed(run.records)) is not None)
    per_step /= len(completed(run.records))
    step_ms = host.get("step", {}).get("host_ms", 0.0)
    phases_host = sum(got[f"host_ms.{p}"] for p in PHASE_NAMES)
    off_ns = max(cost["off_span"], cost["off_call"])
    lines = [f"host ms a step (b, {SPANS_ONLY_FACTOR}x trace_steps): "
             + ", ".join(f"{p} {got[f'host_ms.{p}']:.4f}" for p in PHASE_NAMES)
             + f"; sum {phases_host:.4f} of the step span's {step_ms:.4f} "
             f"({100 * phases_host / step_ms:.2f}%)" if step_ms else "no completed step",
             "spans by name, ms a step (b): " + ", ".join(
                 f"{n} {v['host_ms']:.4f} (self {v['self_ms']:.4f})" for n, v in host.items()),
             f"spans a step {per_step:.2f}; cost a span site: off {cost['off_span']:.1f} ns "
             f"(with) / {cost['off_call']:.1f} ns (decorated call), on {cost['on_span']:.1f} / "
             f"{cost['on_call']:.1f} ns; off a step {off_ns * per_step / 1e3:.3f} µs = "
             f"{100 * off_ns * per_step / 1e6 / window_step_ms:.4f}% of the window's step "
             f"{window_step_ms:.4f} ms",
             f"host issue a step: window (off) {window_issue_ms:.4f} ms, phase b (on) "
             f"{run.host_issue_ms:.4f} ms; host-clock step {window_step_ms:.4f} vs "
             f"{run.step_ms:.4f} ms"]
    result = {"readings": got, "host": host, "spans_a_step": per_step, "cost_ns": cost,
              "host_issue_ms": {"off": window_issue_ms, "on": run.host_issue_ms},
              "step_ms": {"off": window_step_ms, "on": run.step_ms}}
    st = run.stretch
    if st is None:
        return result, lines
    (a, ea), (b, eb) = st.offsets
    lines.append(f"clock: anchors' offsets {a:.3f} µs (±{ea:.3f}) and {b:.3f} µs (±{eb:.3f}), "
                 f"differ {abs(a - b):.3f} µs (limit {CLOCK_TOLERANCE_US:.0f}): "
                 + ("agree" if st.clock_agrees else "DISAGREE, the stretch is not read"))
    lines.append("threads: the trace's runtime tids " + (
        "are the threads' pthread ids as kineto_tid gives them" if st.threads_known
        else "name no recorded thread; the deepest span on any thread is charged"))
    done = completed(st.records)
    n = len(done)
    busy = sum(us for _, us, _ in st.charges.ops) / 1e3 / n
    idle = sum(us for us, _ in st.charges.gaps) / 1e3 / n
    dev = device_table(st)
    under_step = sum(us for _, us, s in st.charges.ops
                     if counted(st.records, s, done) is not None
                     and st.records[s].step in done) / 1e3 / n
    result.update(clock={"offsets_us": st.offsets, "agree": st.clock_agrees},
                  threads_known=st.threads_known, device=dev, busy_ms=busy, idle_ms=idle,
                  under_step_pct=100 * under_step / busy if busy else None)
    if st.clock_agrees:
        d = sum(got[f"device_ms.{p}"] for p in PHASE_NAMES)
        i = sum(got[f"idle_ms.{p}"] for p in PHASE_NAMES)
        lines.append(f"stretch (a), {n} steps, ms a step: busy {busy:.4f} ({100 * under_step / busy:.2f}% "
                     f"under a step span), idle {idle:.4f}; device "
                     + ", ".join(f"{p} {got[f'device_ms.{p}']:.4f}" for p in PHASE_NAMES)
                     + f", remainder {busy - d:.4f}; idle "
                     + ", ".join(f"{p} {got[f'idle_ms.{p}']:.4f}" for p in PHASE_NAMES)
                     + f", remainder {idle - i:.4f}")
        result["remainder_ms"] = {"busy": busy - d, "idle": idle - i}
    lines.append("device/idle ms a step by deepest span (a): " + ", ".join(
        f"{k} {v['device_ms']:.4f}/{v['idle_ms']:.4f}" for k, v in
        sorted(dev.items(), key=lambda kv: -kv[1]["device_ms"] - kv[1]["idle_ms"])))
    by_span: Dict[str, float] = {}
    for name, s in st.charges.syncs:
        s = counted(st.records, s, done)
        key = f"{name} in {'(none)' if s is None else st.records[s].name}"
        by_span[key] = by_span.get(key, 0.0) + 1.0 / n
    lines.append(f"syncs a step (a): {sum(by_span.values()):.3f}"
                 + (" (" + ", ".join(f"{k} {v:.3f}" for k, v in by_span.items()) + ")"
                    if by_span else ""))
    result["syncs_a_step"] = by_span
    if kernel_set:
        named = sum(us for name, us, _ in st.charges.ops
                    if base_name(name) in kernel_set) / 1e3 / n
        extra: Dict[str, float] = {}
        for name, us, s in st.charges.ops:
            top = s
            while top is not None and not st.records[top].name.startswith(RECURRENCE_OPS):
                top = st.records[top].parent
            if counted(st.records, top, done) is not None and base_name(name) not in kernel_set:
                extra[short_name(name)] = extra.get(short_name(name), 0.0) + us / 1e3 / n
        lines.append(f"recurrence: op spans {got.get('op_device_ms.recurrence', 0.0):.4f} ms a "
                     f"step, the kernel set's kernels {named:.4f}; beyond the set: "
                     + (", ".join(f"{k} {v:.4f}" for k, v in sorted(extra.items(),
                                                                     key=lambda kv: -kv[1]))
                        or "nothing"))
        result["recurrence"] = {"kernel_set_ms": named, "beyond_set_ms": extra}
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    import torch

    from port_bench.metrics.kernel_roofline_pct import kernel_names
    from port_bench.run import card_line

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench.spans: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runner, driver = _program(cell, args.seed, device)
    tr = cell.traffic
    harness.run_phase(runner, driver, limit=tr["checked_steps"] + tr["warmup_steps"])

    def window():
        """(steps, host-clock ms a step, host issue ms a step) of ``--seconds``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = harness.run_phase(runner, driver, deadline=t0 + args.seconds)
        torch.cuda.synchronize()
        return steps, 1e3 * (time.perf_counter() - t0) / steps, 1e3 * driver.host_s / steps

    steps, step_ms, issue_ms = window()
    cost = span_cost_ns()
    run = measure(runner, driver, tr)
    after = window()
    has_set = (harness.BENCH / "work" / "recurrence" / f"{cell.family}.py").exists()
    result, lines = report(run, issue_ms, step_ms, cost,
                           kernel_names("recurrence") if has_set else set())
    lines.append(f"after the profiler, recorder off: host-clock step {after[1]:.4f} ms, host "
                 f"issue {after[2]:.4f} ms ({after[0]} steps; before it {step_ms:.4f} and "
                 f"{issue_ms:.4f}, {steps} steps)")
    for line in lines:
        print(f"[spans] {line}", file=sys.stderr)
    result.update(workload=args.workload, seed=args.seed, card=card_line(), window_steps=steps,
                  after_profiler={"steps": after[0], "step_ms": after[1], "issue_ms": after[2]})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
