"""One run of one cell: set-up, the checked steps, the measured window,
the profiled stretch, the reference, and the result line.

The program's own epoch runner (``DeviceEpochRunner.train_epoch``) drives
every step, built as ``BaseTrainer.train_model`` builds it, with the
trainer's own ``train_step`` wrapped by :class:`Driver`: the driver ends
a phase by raising :class:`Stop` at the step it should not take (inside
an epoch; the next phase starts a new one), keeps the host's span of
each step it takes (its gather and its call, ``host_s``), and in the
measured window records each step's end on the device (a CUDA event,
no synchronise).

Phases, each from a fresh epoch:

1. checked: the traffic's ``checked_steps`` (3) steps from the
   benchmark's weights; their losses, the first gradient as Adam holds
   it after step 1, the parameters after the last and, for a model that
   feeds its own samples back (``programs/<family>.py``'s
   ``record_outputs``), the tokens each step fed and its output head
   are kept;
2. warm-up: ``warmup_steps`` more, so every shape has run before timing;
3. window: a synchronise, then steps until ``seconds`` have passed on
   the host clock, then a synchronise;
4. with ``trace``: ``trace_steps`` more under the profiler (``trace.py``).

Then the peak memory is read, the program is freed, and the reference
(``reference/<family>.py``) follows the checked steps from the same
inputs and weights, made again from the seed, feeding back the tokens
the program fed and judging them (an argmax that rounding flips would
otherwise send the two down different paths).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from port_bench import compare, data, faults, weights
from port_bench.reference.common import Steps

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


class Stop(Exception):
    """Raised by the driver at the first step a phase must not take."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    cfg: dict
    traffic: dict

    @property
    def family(self) -> str:
        return self.cfg["family"]

    def module(self, kind: str):
        """``port_bench.<kind>.<family>``: programs, reference or work."""
        return importlib.import_module(f"port_bench.{kind}.{self.family}")


def load_cell(name: str) -> Cell:
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    return Cell(name, workload, load_json(BENCH / "configs" / f"{workload['config']}.json"),
                load_json(BENCH / "traffic" / f"{workload['traffic']}.json"))


class Driver:
    """The callable the epoch runner takes for ``train_step``.

    ``host_s`` sums, over the steps of the phase, the host seconds of
    each step's gather (the split's ``gather_batch``, wrapped by
    :meth:`gather`) and of its ``train_step`` call: the host's span of
    issuing the step, with any wait for a full launch queue in it."""

    def __init__(self, step):
        self.step = step
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.after = None
        self.taken = 0
        self.host_s = 0.0
        self._gathered = 0.0

    def phase(self, limit=None, deadline=None, after=None) -> None:
        self.limit, self.deadline, self.after, self.taken = limit, deadline, after, 0
        self.host_s = self._gathered = 0.0

    def gather(self, fn):
        """``fn``, the split's gather, keeping its span for the step it feeds."""
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            self._gathered = time.perf_counter() - t
            return out
        return timed

    def __call__(self, batch, **kw):
        if self.limit is not None and self.taken >= self.limit:
            raise Stop
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise Stop
        t = time.perf_counter()
        metrics = self.step(batch, **kw)
        self.host_s += self._gathered + time.perf_counter() - t
        self._gathered = 0.0
        self.taken += 1
        if self.after is not None:
            self.after(self.taken, metrics)
        return metrics


def run_phase(runner, driver: Driver, **phase) -> int:
    """Steps until the driver stops; returns the steps taken."""
    driver.phase(**phase)
    while True:
        try:
            runner.train_epoch()
        except Stop:
            return driver.taken


class StepClock:
    """Each window step's end: a CUDA event recorded on the stream (no
    synchronise) on a card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        """Milliseconds between consecutive marks (read after a synchronise)."""
        pairs = zip(self.marks[:-1], self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


@dataclass
class Window:
    steps: int
    seconds: float
    batch: int
    intervals_ms: List[float]
    nonfinite: int
    host_s: float = 0.0  # the steps' host spans, summed (Driver.host_s)


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: Cell
    device_kind: str
    setup_s: float
    window: Window
    stretch: object = None  # trace.Stretch of a traced run
    checks: Dict[str, float] = field(default_factory=dict)

    @property
    def peaks(self) -> Optional[dict]:
        return load_json(BENCH / "peaks.json").get(self.device_kind)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _named(trainer) -> Dict[str, torch.nn.Parameter]:
    return dict(trainer.model.named_parameters())


def load_weights(trainer, start: Dict[str, torch.Tensor]) -> None:
    params = _named(trainer)
    if {k: tuple(v.shape) for k, v in params.items()} != {k: tuple(v.shape)
                                                           for k, v in start.items()}:
        raise ValueError("the program's parameters are not the reference's leaves: "
                         f"{sorted(set(params) ^ set(start))}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])


def first_gradient(trainer) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient at step 1 from Adam's state after it: the
    first moment over (1 − β1); zero for a leaf Adam has no state of."""
    opt = trainer.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in _named(trainer).items():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if m is None else m.detach() / (1.0 - beta1)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
             fault: Optional[str] = None, log=None) -> dict:
    """One run; returns the result line's fields (``metrics`` by reader).
    ``log(phase, seconds)`` hears when each phase of the set-up ended."""
    from arvae_tpu_torch.data.device_data import DeviceEpochRunner

    log = log or (lambda phase, at: None)
    device = torch.device(device)
    tr, cfg = cell.traffic, cell.cfg
    reference, programs = cell.module("reference"), cell.module("programs")
    spec = reference.param_spec(cfg)
    log("imports", time.perf_counter() - started)
    inputs = data.make_inputs(tr, cfg, seed, device)
    log("inputs", time.perf_counter() - started)
    trainer, split = programs.build(cfg, tr, seed, device, inputs)
    del inputs
    log("trainer and split", time.perf_counter() - started)
    load_weights(trainer, weights.init_weights(spec, seed, device))
    log("weights", time.perf_counter() - started)
    step = trainer.train_step if fault is None else faults.plant(
        fault, trainer, lambda x: programs.alter_row(cfg, x))
    driver = Driver(step)
    split.gather_batch = driver.gather(split.gather_batch)
    runner = DeviceEpochRunner(split, split, tr["batch"], driver, trainer.eval_step,
                               trainer.perm_generator)

    losses, grad1 = [], {}

    def checked(i, metrics):
        losses.append(metrics["loss"].detach().clone())
        if i == 1:
            grad1.update(first_gradient(trainer))

    outputs, hook = (programs.record_outputs(trainer) if hasattr(programs, "record_outputs")
                     else ({}, None))
    run_phase(runner, driver, limit=tr["checked_steps"], after=checked)
    if hook is not None:
        hook.remove()
    program = Steps([float(v) for v in losses], grad1,
                    {k: v.detach().clone() for k, v in _named(trainer).items()},
                    outputs.get("fed"), logits=outputs.get("logits"))
    log("checked steps", time.perf_counter() - started)
    run_phase(runner, driver, limit=tr["warmup_steps"])

    clock = StepClock(device)
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def timed(i, metrics):
        nonfinite.add_(~torch.isfinite(metrics["loss"]))
        clock.mark()

    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - started
    log("warm-up steps", setup_s)
    clock.mark()
    steps = run_phase(runner, driver, deadline=t0 + seconds, after=timed)
    _sync(device)
    window = Window(steps, time.perf_counter() - t0, tr["batch"], clock.intervals_ms(),
                    int(nonfinite), driver.host_s)

    stretch = None
    if trace:
        from port_bench import trace as tracing

        stretch = tracing.profile_stretch(
            lambda: run_phase(runner, driver, limit=tr["trace_steps"]), tr["trace_steps"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del runner, driver, step, trainer, split
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    start = weights.init_weights(spec, seed, device)
    ref = reference.run_steps(cfg, tr, seed, data.make_inputs(tr, cfg, seed, device), start,
                              tr["checked_steps"], fed=program.fed)
    values = compare.readings(program, ref, start)
    correct, lines = compare.judge(values, cfg["limits"])
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cell, kind, setup_s, window, stretch,
              {n: values[n] for n in cfg["limits"]})
    return {"correct": correct and window.nonfinite == 0, "attempted": window.steps,
            "failed": window.nonfinite, "run": run, "peak": peak, "check_lines": lines,
            "limits": cfg["limits"], "program": program, "reference": ref, "start": start}


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<prefix>.py`` for ``<prefix>.<suffix>``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_entries(cell: str, trace: bool) -> List[dict]:
    """The entries of BENCHMARK.json that a run of ``cell`` reports:
    end-to-end without ``trace``, per-layer with it."""
    bench = load_json(REPO / "BENCHMARK.json")
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(run: Run, trace: bool) -> Dict[str, dict]:
    out = {}
    for m in metric_entries(run.cell.name, trace):
        suffix = m["name"].split(".", 1)[1] if "." in m["name"] else None
        value = reader(m["name"])(run, suffix)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
