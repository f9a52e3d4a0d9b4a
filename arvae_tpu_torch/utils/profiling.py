"""Profiling and numerics utilities, the counterparts of
``arvae_tpu/utils/profiling.py``: a profiler trace around a window of
work (``torch.profiler`` in place of ``jax.profiler``), a steps/sec meter
that leaves out warmup, and a finite-check of a set of tensors."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Mapping, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work and write a Chrome trace,
    ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir`` (made if
    missing; view it with Perfetto or TensorBoard's profile plugin). The host's activity is
    recorded, and the card's too where CUDA is available. Yields the
    profiler, whose ``key_averages()`` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Steps/sec meter with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._n = 0
        # warmup=0 counts from construction: tick() starts the clock only
        # when the count reaches warmup, which it never does for 0.
        self._t0: Optional[float] = time.perf_counter() if warmup == 0 else None

    def tick(self) -> None:
        self._n += 1
        if self._n == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        """Steps after the warmup over the seconds since it ended; NaN
        until more than ``warmup`` ticks."""
        if self._t0 is None or self._n <= self.warmup:
            return float("nan")
        return (self._n - self.warmup) / (time.perf_counter() - self._t0)


def assert_tensors_finite(tensors: Mapping[str, torch.Tensor],
                          what: str = "parameters") -> None:
    """Raises ValueError if any floating tensor holds NaN/Inf.

    One device-side reduction and one host read for the whole mapping,
    so a once-per-epoch call costs a single sync."""
    flags = [torch.isfinite(t).all() for t in tensors.values()
             if t.is_floating_point()]
    if flags and not bool(torch.stack(flags).all()):
        bad = [k for k, t in tensors.items()
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        raise ValueError(f"{what} contain non-finite values: {bad}")
