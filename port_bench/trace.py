"""The profiled stretch of a ``--trace 1`` run, and what is read from it.

The stretch is profiled with ``torch.profiler`` recording CUDA activity
only (the kernels, copies and memsets, and the CUDA runtime and driver
calls that launched them): recording every CPU operation as well slows the host
enough to leave the card idle half the time, so the stretch would not
be the window's steps. Its device records are the kernel, memcpy and
memset intervals of the exported Chrome trace (the port's
``utils/step_probe.device_events``).

The steps run between spin kernels: a long one and short ones queued
behind it open the stretch (``utils/step_probe.open_window``: late in a
process CUPTI may drop the records of the first kernels launched in a
profiled window, and these take the loss), a long one closes it. The
stretch on the device runs from the end of the last opening kernel to
the start of the closing one; its runtime calls are those between the
launches of the two, found by the correlation ids that tie each
kernel to its launch. A stretch whose records lack any opening kernel
lost records, and is profiled again with four times as many, up to
three times.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

from port_bench import stats

# Device cycles of the spin kernels that open and close a stretch (about
# 25 ms on an H100), and of the short ones queued behind the opening one
# (about 11 µs each).
PAD_CYCLES = 50_000_000
OPENING_KERNELS, OPENING_CYCLES = 64, 20_000
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SPIN = "spin_kernel"
TOP = 10


def short_name(name: str) -> str:
    """'hier_bwd_prep' from a demangled kernel name, cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("arvae::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:60]


def base_name(name: str) -> str:
    """A kernel's short name without its template arguments."""
    return short_name(name).split("<")[0]


@dataclass
class Stretch:
    """What one profiled stretch of ``steps`` steps recorded (µs)."""

    steps: int
    start: float
    end: float
    host_s: float  # host clock over the stretch's steps (the tracer's cost shows in it)
    device: List[Tuple[str, float, float]]  # (name, start, end) of device operations
    runtime: List[Tuple[str, float, float]]  # the stretch's CUDA runtime calls

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return stats.covered([(s, e) for _, s, e in self.device]) / 1e6

    def device_time_s(self, names) -> float:
        """Summed device seconds of the operations whose base name is in ``names``."""
        return sum(e - s for n, s, e in self.device if base_name(n) in names) / 1e6

    def device_ops(self) -> List[List]:
        """[[short name, seconds]] of the device operations that took most time."""
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[short_name(n)] = by.get(short_name(n), 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """[[what the host was doing, seconds]]: the card's idle time in
        the stretch, by the runtime call the host was in when each gap
        began, or else by the device operation the host was issuing,
        the one that ended the gap ('host: issuing <op>')."""
        calls = sorted(self.runtime, key=lambda c: c[1])
        starts = [s for _, s, _ in calls]
        ops = sorted(self.device, key=lambda d: d[1])
        op_starts = [s for _, s, _ in ops]
        by: Dict[str, float] = {}
        for g0, g1 in stats.gaps([(s, e) for _, s, e in self.device], self.start, self.end):
            i = bisect.bisect_right(starts, g0) - 1
            if i >= 0 and calls[i][2] > g0:
                label = calls[i][0]
            else:
                j = bisect.bisect_left(op_starts, g1)
                label = "host: issuing " + (short_name(ops[j][0]) if j < len(ops) else "nothing")
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def parse(events: List[dict], steps: int, host_s: float) -> Tuple[Stretch, int]:
    """(the stretch, the spin kernels recorded) from the trace events of
    one profiled stretch."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    spins = sorted((e for e in device if SPIN in e["name"]), key=lambda e: e["ts"])
    if len(spins) < 2:
        return Stretch(steps, 0.0, 0.0, host_s, [], []), len(spins)
    opening, closing = spins[:-1], spins[-1]
    lo, hi = max(e["ts"] + e["dur"] for e in opening), closing["ts"]
    inside = [e for e in device
              if SPIN not in e["name"] and e["ts"] >= lo and e["ts"] + e["dur"] <= hi]
    dev = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in inside]
    runtime = [e for e in spans if e.get("cat") in HOST_CATS]
    launch = {e.get("args", {}).get("correlation"): e["ts"] for e in runtime}
    first = [launch.get(e.get("args", {}).get("correlation")) for e in inside]
    first = [t for t in first if t is not None]
    last = launch.get(closing.get("args", {}).get("correlation"))
    calls = []
    if first and last is not None:
        # from the launch of the stretch's first operation to the closing kernel's
        t0 = min(first)
        calls = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in runtime
                 if t0 <= e["ts"] < last]
    return Stretch(steps, lo, hi, host_s, dev, calls), len(spins)


def profile_stretch(run_steps, steps: int) -> Stretch:
    """Profiles ``run_steps()``, which runs ``steps`` steps; see the
    module's docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    opening = OPENING_KERNELS
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PAD_CYCLES)
            for _ in range(opening):
                torch.cuda._sleep(OPENING_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_steps()
            host_s = time.perf_counter() - t0
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        stretch, spins = parse(events, steps, host_s)
        if spins == 2 + opening and stretch.device and stretch.runtime:
            return stretch
        opening *= 4
    raise RuntimeError(f"no profiled stretch of {ATTEMPTS} recorded every opening kernel "
                       "and the runtime calls")
