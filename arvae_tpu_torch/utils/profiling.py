"""Profiling and numerics utilities, the counterparts of
``arvae_tpu/utils/profiling.py``: a profiler trace around a window of
work (``torch.profiler`` in place of ``jax.profiler``), a steps/sec meter
that leaves out warmup, and a finite-check of a set of tensors.

Beside them, the port's own spans, which the JAX package has not.
:func:`span` (:func:`spanned` for a whole call) marks a stretch of host
work by name. It does nothing until code turns recording on, ``with
recording() as rec:``. Off, a span is one shared object that does nothing: one
module-global check, no clock read, no allocation. On, each span keeps
in memory, until ``rec.records()``, its name, its start and end
(``time.perf_counter_ns()``), the span it nests in, its step (that of
the enclosing ``step`` span), its OS thread and whether an exception
closed it. A span opened on a thread with no open span of its own nests
in the innermost span open at that moment on the thread that turned
recording on: PyTorch runs a CUDA backward on autograd's device thread,
and what is launched there nests under the main thread's ``backward``.

The spans the port opens: an epoch's ``shuffle``, and a ``step`` a
training step holding ``gather``, ``train_step`` and ``accumulate``
(``data/device_data.py``); inside ``train_step`` ``forward`` (the
step's draws and the model), ``loss`` (the objective, holding ``labels``
where the music step computes them), ``backward`` (holding
``sync_grads`` over a process group) and ``optimizer`` (``zero_grad``,
then Adam's step) (``training/``; the fader's step opens the four for
each of its two updates, with ``encode``, its no-grad encode, and
``disc``, each discriminator forward, inside ``forward``), each opened
by an eager step or by the capture of a CUDA graph; ``graph_replay``
around each replay of a captured step, its input copy and its launch
(``training/base.py``), which holds all of a replayed step's device work;
``op:<kernel>.<pass>`` around each CUDA wrapper (``ops/``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, Iterator, List, Mapping, NamedTuple, Optional

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


# -- spans -------------------------------------------------------------------


class SpanRecord(NamedTuple):
    """One span of a recording. ``start`` and ``end`` are
    ``time.perf_counter_ns()`` (``end`` None while it is open),
    ``parent`` the index of the span it nests in, ``step`` the index of
    its ``step`` span (-1 outside one), ``tid`` its OS thread
    (``threading.get_native_id()``), ``failed`` whether an exception
    closed it."""

    name: str
    start: int
    end: Optional[int]
    parent: Optional[int]
    step: int
    tid: int
    failed: bool


class _Off:
    """The span while recording is off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_RECORDER: Optional["Recorder"] = None  # the recording that is on, if one is


class _Span:
    __slots__ = ("rec", "name", "start", "end", "parent", "step", "ident", "failed")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name, self.end, self.failed = rec, name, None, False

    def __enter__(self) -> "_Span":
        rec = self.rec
        # the pthread id, read without a system call (the OS id is looked
        # up once a thread, in _new_thread)
        self.ident = ident = threading.get_ident()
        stack = rec._stacks.get(ident)
        if stack is None:
            stack = rec._new_thread(ident)
        self.parent = parent = stack[-1] if stack else rec._main_innermost()
        if self.name == "step":
            self.step = rec._next_step()
        else:
            self.step = -1 if parent is None else parent.step
        stack.append(self)
        rec._spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter_ns()
        self.failed = exc_type is not None
        self.rec._stacks[self.ident].pop()
        return False


class Recorder:
    """The spans of one recording (:func:`recording`).
    ``main_tid`` is the thread that turned it on; ``threads`` maps the
    OS id of each thread that opened a span to its ``threading.get_ident()``
    (the pthread id, which some tracers give in its place)."""

    def __init__(self):
        self.main_tid = threading.get_native_id()
        self._main = threading.get_ident()
        self.threads: Dict[int, int] = {self.main_tid: self._main}
        self._native: Dict[int, int] = {self._main: self.main_tid}
        self._stacks: Dict[int, List[_Span]] = {self._main: []}
        self._spans: List[_Span] = []
        self._steps = 0

    def _new_thread(self, ident: int) -> List[_Span]:
        native = threading.get_native_id()
        self._native[ident], self.threads[native] = native, ident
        stack = self._stacks[ident] = []
        return stack

    def _main_innermost(self) -> Optional[_Span]:
        main = self._stacks[self._main]
        try:
            return main[-1] if main else None
        except IndexError:  # the main thread closed it in between
            return None

    def _next_step(self) -> int:
        self._steps += 1
        return self._steps - 1

    def records(self) -> List[SpanRecord]:
        """The spans in the order they opened (a parent before its children)."""
        spans = list(self._spans)
        at = {id(s): i for i, s in enumerate(spans)}
        return [SpanRecord(s.name, s.start, s.end, None if s.parent is None else at[id(s.parent)],
                           s.step, self._native[s.ident], s.failed) for s in spans]


def span(name: str):
    """A context manager marking the enclosed host work as span ``name``
    while recording is on; the shared no-op otherwise."""
    rec = _RECORDER
    if rec is None:
        return _OFF
    return _Span(rec, name)


def spanned(name: str):
    """Decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            rec = _RECORDER
            if rec is None:
                return fn(*args, **kw)
            with _Span(rec, name):
                return fn(*args, **kw)
        return call
    return wrap


def active() -> Optional[Recorder]:
    """The recording that is on, or None."""
    return _RECORDER


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Turns spans on for the enclosed code, on every thread;
    yields the :class:`Recorder` that keeps them."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("spans are being recorded already")
    rec = Recorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
