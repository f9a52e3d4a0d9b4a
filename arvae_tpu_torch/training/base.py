"""Abstract trainer: the epoch loop over training steps replayed as one
CUDA graph, and the evaluation that follows it.

Counterpart of ``arvae_tpu/training/base.py``: the same epoch loop
(train pass, val pass, stdout stats, numerics guard, per-epoch
checkpoint), run directory and protocol stamp. Where the JAX trainer
threads PRNG keys, this one holds two ``torch.Generator``s on its
device, both seeded from ``rand``: one draws each epoch's permutation,
the other the reparametrisation noise. The loss-scale hyperparameters
live on the device as 0-d tensors, so a step reads none of them from
the host.

On a card, :meth:`BaseTrainer.train_step` records its whole step (the
draws, the forward, the loss, ``zero_grad``, the backward and Adam's
update) into a ``torch.cuda.CUDAGraph`` once ``WARMUP_STEPS`` eager steps
of the batch's shape have run, and from then on copies each batch into
the graph's input and replays it: the host issues one launch a step in
place of a few hundred. Adam is ``fused`` and ``capturable`` on a card
(one kernel updates every parameter; its step count on the device), in
eager steps too, so both paths run one update. The noise generator, the
one a step draws from, is registered with the graph, so a replay draws
what an eager step would draw at that point of its stream. A step
runs eagerly where the code can see that a graph cannot stand for it
(:meth:`BaseTrainer.eager_reason`): off a card, over a process group,
with injected draws or a share, while a module of the step has a hook,
or for a batch of another shape than the graph's. ``GRAPH_STEPS`` and
``EAGER_STEPS`` count the steps each way. The kernels' launch counters
count what their wrappers launch: an eager step's kernels and the
capture's, none on a replay, whose kernels only the profiler's records
show. Restoring a state drops the graph, whose nodes hold the replaced
tensors by address.

The evaluation runs over the dataset's device-resident eval split: the
latent harvest (at most ``num_batches + 1`` whole batches, in order,
the tail left out), the test pass (every batch at equal weight, a
partial tail batch included), the five-metric suite on the host, and
the ``results_dict.json`` cache with its protocol stamp. Both passes
draw their noise from a generator made for the pass and seeded from
``rand``, so a second evaluation of the same weights draws the same
noise; each keeps its results on the device until one host read.

Data parallelism (``ctx``, a :class:`~arvae_tpu_torch.parallel.DataContext`,
by default ``init_data_parallel``'s: a world of 1 with no process group
unless ``torchrun`` started the program). Over a process group the
parameters must start equal on every rank (the models' init is seeded;
checked bitwise), each step works on this rank's rows of the global
batch and sums the gradients over the ranks before Adam
(:func:`~arvae_tpu_torch.parallel.all_reduce_grads`), so every rank
takes the step one card takes on the whole batch. Rank 0 alone prints,
writes the checkpoint and the results, and runs the evaluation over the
whole eval split on its card while the others wait; ``--resume``
restores on every rank.
"""

from __future__ import annotations

import abc
import json
import os
import time
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from arvae_tpu_torch.core.checkpoint import Checkpointer
from arvae_tpu_torch.core.config import TrainerHParams, run_dir
from arvae_tpu_torch.data.device_data import DeviceEpochRunner, DeviceSplit, Metrics
from arvae_tpu_torch.eval.metrics import compute_all
from arvae_tpu_torch.parallel import (DataContext, RowShare, all_reduce_grads,
                                      check_replicated, init_data_parallel)
from arvae_tpu_torch.parallel.collectives import differs_from_main
from arvae_tpu_torch.utils import profiling
from arvae_tpu_torch.utils.profiling import assert_tensors_finite

# Offset of the permutation generator's seed from the noise generator's.
_PERM_SEED_OFFSET = 1 << 30
# Offsets of the harvest's and the test pass's seeds from ``rand`` (the
# constants the JAX trainers fold into their key for the same passes).
_HARVEST_SEED_OFFSET = 7_000_000
_TEST_SEED_OFFSET = 9_000_000

# Training steps by how train_step ran them: recorded into the trainer's
# CUDA graph ("captured"), run as a replay of it ("replayed", the
# captured step's own replay included), or eagerly, by the reason
# (BaseTrainer.eager_reason; "warmup": the eager steps of a batch's
# shape before its capture).
GRAPH_STEPS = {"captured": 0, "replayed": 0}
EAGER_STEPS = {"distributed": 0, "injected": 0, "hook": 0, "cpu": 0, "shape": 0, "warmup": 0}
# Eager steps of a batch's shape before the step is captured: they build
# the kernels' libraries, cuBLAS's and cuDNN's plans and Adam's state.
WARMUP_STEPS = 2


def reset_step_counts() -> None:
    for counts in (GRAPH_STEPS, EAGER_STEPS):
        for k in counts:
            counts[k] = 0


def make_adam(params: Iterable[torch.nn.Parameter], lr: float,
              device: torch.device) -> torch.optim.Adam:
    """``torch.optim.Adam(lr)``; on a CUDA device ``fused`` (one kernel
    updates every parameter, its bias corrections in double as the host
    computes them) and ``capturable``, so that a CUDA graph can hold its
    update."""
    if torch.device(device).type != "cuda":
        return torch.optim.Adam(params, lr=lr)
    return torch.optim.Adam(params, lr=lr, fused=True, capturable=True)


def load_adam_state(optimizer: torch.optim.Adam, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    ``fused`` and ``capturable`` (a state saved with other settings holds
    its step count on another device)."""
    kept = [{k: g[k] for k in ("fused", "capturable")} for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, own in zip(optimizer.param_groups, kept):
        group.update(own)
        if not (own["fused"] or own["capturable"]):
            continue  # a step count on the parameters' device serves as well
        for p in group["params"]:
            slot = optimizer.state.get(p)
            if slot and "step" in slot:
                slot["step"] = slot["step"].to(p.device, torch.float32)


def _hooked(modules: Iterable[torch.nn.Module]) -> bool:
    """Whether a module hook (forward or backward, global or on any
    submodule of ``modules``) would run Python in a step."""
    from torch.nn.modules import module as nn_module
    if (nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks
            or nn_module._global_backward_hooks or nn_module._global_backward_pre_hooks):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for root in modules for m in root.modules())


def _signature(batch: Sequence[torch.Tensor]) -> Tuple:
    """What a graph fixes of a batch: each tensor's shape, dtype and
    device, and which earlier entry it is (music steps take (score,
    score))."""
    first = {}
    return tuple((tuple(x.shape), x.dtype, x.device, first.setdefault(id(x), i))
                 for i, x in enumerate(batch))


class _StepGraph(NamedTuple):
    """A captured training step."""

    graph: torch.cuda.CUDAGraph
    signature: Tuple  # _signature of the batches it takes
    inputs: Tuple[torch.Tensor, ...]  # its static batch, entry for entry
    outputs: Metrics  # its static metrics, detached
    step_outputs: Metrics  # its static BaseTrainer.step_outputs


def _means(totals: Optional[Metrics], n: int) -> Tuple[float, float]:
    """(mean loss, mean accuracy) from device sums; 0.0 for an empty pass."""
    if totals is None:
        return 0.0, 0.0
    return float(totals["loss"]) / n, float(totals["accuracy"]) / n


class BaseTrainer(abc.ABC):
    """Owns dataset + model + Adam + generators on one device; drives
    epochs, over the data axis ``ctx``."""

    def __init__(self, dataset, model: torch.nn.Module,
                 hparams: TrainerHParams, device: torch.device,
                 ctx: Optional[DataContext] = None):
        self.dataset = dataset
        self.ctx = init_data_parallel(device) if ctx is None else ctx
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # generators compare devices with their index
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.ctx.distributed and self.device != self.ctx.device:
            raise ValueError(f"device {self.device} is not the data context's "
                             f"{self.ctx.device}")
        self.model = model.to(self.device)
        self.check_replicated(self.model.state_dict().values(), "the initial parameters")
        # steps whose per-step draws differed from rank 0's (note_draws)
        self._draw_faults = torch.zeros((), dtype=torch.int64, device=self.device)
        self.hparams = hparams
        self.optimizer = make_adam(self.model.parameters(), hparams.lr, self.device)
        self.step = 0
        self.noise_generator = torch.Generator(self.device).manual_seed(hparams.rand)
        self.perm_generator = torch.Generator(self.device).manual_seed(
            hparams.rand + _PERM_SEED_OFFSET)
        self.hyper = {
            k: torch.tensor(getattr(hparams, k), dtype=torch.float32,
                            device=self.device)
            for k in ("beta", "capacity", "gamma", "delta")
        }
        self.history: List[Dict[str, Any]] = []
        # Set by train_model; None for a trainer that never trained.
        self._train_protocol: Optional[Dict[str, int]] = None
        self._eval_split: Optional[DeviceSplit] = None
        # The last evaluation's results (compute_eval_metrics)
        self.metrics: Dict[str, Any] = {}
        # The last training step's outputs beyond its metrics, for a check
        # that judges them without a hook (the music trainers' decoder:
        # ``samples``, the tokens it fed back, and ``weights``, its ReLU
        # head); a replayed step's are the graph's, which the next replay
        # overwrites
        self.step_outputs: Metrics = {}
        # The captured training step, and the shape and count of the eager
        # steps that warm up its capture
        self._graph: Optional[_StepGraph] = None
        self._warm: Tuple[Optional[Tuple], int] = (None, 0)

    @abc.abstractmethod
    def model_repr(self) -> str:
        """e.g. 'DspritesVAE_r_0_b_1.0_...' — keys all run artifacts."""

    @property
    def run_dir(self) -> str:
        return run_dir(self.model_repr())

    @property
    def results_path(self) -> str:
        return os.path.join(self.run_dir, "results_dict.json")

    # -- data parallelism ---------------------------------------------------------

    def check_replicated(self, tensors: Iterable[torch.Tensor], what: str) -> None:
        """Over a process group, raises unless ``tensors`` are bitwise
        rank 0's on every rank."""
        if self.ctx.distributed:
            check_replicated(tensors, self.ctx.group, what)

    def check_share(self, share: Optional[RowShare]) -> None:
        """A step gets its rank's share over a process group, and none
        without one."""
        if self.ctx.distributed != (share is not None):
            raise ValueError("a step over a process group takes its rank's share of the "
                             "global batch (share=ctx.share(B)), and no share without one")

    def sync_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Over a process group, sums the gradients of ``params`` over the
        ranks (each rank's holds its rows' part of the global loss's)."""
        if self.ctx.distributed:
            with profiling.span("sync_grads"):
                all_reduce_grads(params, self.ctx.group)

    def update(self, loss: torch.Tensor, optimizer: Optional[torch.optim.Optimizer] = None,
               params: Optional[Iterable[torch.nn.Parameter]] = None,
               inputs: Optional[Sequence[torch.Tensor]] = None) -> None:
        """One update from ``loss``: ``zero_grad``, the backward (the
        gradients of ``params`` summed over a process group), Adam's step.
        ``optimizer`` and ``params`` are the model's Adam and parameters
        unless given; ``inputs`` limits the backward to those leaves (the
        fader's update reaches no discriminator weight)."""
        optimizer = self.optimizer if optimizer is None else optimizer
        with profiling.span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with profiling.span("backward"):
            loss.backward(inputs=inputs)
            self.sync_grads(self.model.parameters() if params is None else params)
        with profiling.span("optimizer"):
            optimizer.step()

    def note_draws(self, draws: Iterable[torch.Tensor]) -> None:
        """Over a process group, counts on the device (no host read) a
        step whose per-step draws, which the shared generator makes equal
        on every rank, differ from rank 0's; :meth:`check_draws` raises."""
        if self.ctx.distributed:
            self._draw_faults += differs_from_main(draws, self.ctx.group)

    def check_draws(self) -> None:
        """Raises on every rank if any rank noted a step whose draws
        differed from rank 0's (one host read; train_model calls it each
        epoch)."""
        if self.ctx.distributed:
            faults = self._draw_faults.clone()
            dist.all_reduce(faults, group=self.ctx.group)
            if int(faults):
                raise RuntimeError(f"{int(faults)} steps drew other per-step draws than "
                                   "rank 0 (the noise generators are out of step)")

    def say(self, *args) -> None:
        """``print`` on rank 0 only."""
        if self.ctx.is_main:
            print(*args, flush=True)

    # -- training steps ---------------------------------------------------------

    def train_step(self, batch, noise=None, share: Optional[RowShare] = None) -> Metrics:
        """One optimizer step on (inputs, labels); returns detached
        metrics. ``noise`` (the trainer's draws of a step) overrides the
        generator's draws (tests inject the JAX side's). Over a process
        group ``batch`` is this rank's rows of the global batch, ``share``
        says which, and ``noise`` is the global batch's.

        Replayed from the trainer's CUDA graph unless :meth:`eager_reason`
        gives a reason (the module's docstring); a replayed step's metrics
        are the graph's outputs, which the next replay overwrites."""
        self.model.train()
        reason = self.eager_reason(batch, noise, share)
        if reason is None:
            metrics = self._replay(batch)
        else:
            EAGER_STEPS[reason] += 1
            metrics = {k: v.detach() for k, v in self._step(batch, noise, share).items()}
        self.step += 1
        return metrics

    @abc.abstractmethod
    def _step(self, batch, noise, share: Optional[RowShare]) -> Metrics:
        """The step's work, as one eager call or one capture: its draws
        (``noise`` if given), forward, loss and update → its metrics."""

    def step_modules(self) -> Tuple[torch.nn.Module, ...]:
        """The modules a training step runs (whose hooks keep it eager)."""
        return (self.model,)

    def eager_reason(self, batch, noise, share: Optional[RowShare]) -> Optional[str]:
        """Why this step runs eagerly (a key of ``EAGER_STEPS``), or None
        to replay it; a step that warms up a capture counts towards it."""
        if self.ctx.distributed:
            return "distributed"
        if noise is not None or share is not None:
            return "injected"
        if _hooked(self.step_modules()):
            return "hook"
        if self.device.type != "cuda" or not all(x.is_cuda for x in batch):
            return "cpu"
        sig = _signature(batch)
        if self._graph is not None:
            return None if sig == self._graph.signature else "shape"
        shape, count = self._warm if self._warm[0] == sig else (sig, 0)
        if count < WARMUP_STEPS:
            self._warm = (shape, count + 1)
            return "warmup"
        return None

    def _replay(self, batch) -> Metrics:
        """Copies ``batch`` into the graph's input (capturing the graph
        first if there is none) and replays it."""
        if self._graph is None:
            self._graph = self._capture(batch)
            GRAPH_STEPS["captured"] += 1
        g = self._graph
        with profiling.span("graph_replay"):
            for i, (dst, src) in enumerate(zip(g.inputs, batch)):
                if g.signature[i][3] == i:  # not an alias of an earlier entry
                    dst.copy_(src)
            g.graph.replay()
        GRAPH_STEPS["replayed"] += 1
        self.step_outputs = g.step_outputs
        return g.outputs

    def _capture(self, batch) -> _StepGraph:
        """Records one step on ``batch``'s shape into a CUDA graph; the
        device runs nothing of it until the graph is replayed."""
        first: Dict[int, torch.Tensor] = {}
        inputs = tuple(first.setdefault(id(x), x.clone()) for x in batch)
        graph = torch.cuda.CUDAGraph()
        # a replay draws on from the generator's state as it then stands (the
        # epoch's permutation is drawn outside the step)
        graph.register_generator_state(self.noise_generator)
        with torch.cuda.graph(graph):
            outputs = {k: v.detach() for k, v in self._step(inputs, None, None).items()}
        return _StepGraph(graph, _signature(batch), inputs, outputs, dict(self.step_outputs))

    @abc.abstractmethod
    def eval_step(self, batch) -> Metrics:
        """Metrics of (images, labels) without a parameter update."""

    # -- epoch loop -----------------------------------------------------------

    def train_model(self, batch_size: int, num_epochs: int) -> List[Dict[str, Any]]:
        """Trains ``num_epochs`` epochs; returns the per-epoch history."""
        # compute_eval_metrics returns a cached results_dict.json as it
        # is: one from an earlier run must not stand for this one
        if self.ctx.is_main and os.path.exists(self.results_path):
            os.remove(self.results_path)
        self.ctx.barrier()
        self._train_protocol = {
            "num_epochs": int(num_epochs),
            "batch_size": int(batch_size),
        }
        train_split, val_split = self.dataset.device_splits(
            self.device, split=(0.70, 0.20), ctx=self.ctx)
        runner = DeviceEpochRunner(train_split, val_split, batch_size,
                                   self.train_step, self.eval_step,
                                   self.perm_generator)
        self.say("Num Train Batches: ", train_split.num_batches(batch_size))
        self.say("Num Valid Batches: ", val_split.num_batches(batch_size))

        ckpt = Checkpointer(self.run_dir)
        for epoch_index in range(num_epochs):
            t0 = time.time()
            totals, n = runner.train_epoch()
            vtot, vn = runner.eval_epoch()
            # the epoch's one host read of the device-side sums
            loss_train, acc_train = _means(totals, n)
            loss_val, acc_val = _means(vtot, vn)
            self.check_draws()
            dt = time.time() - t0
            if self.ctx.is_main:
                self.print_epoch_stats(epoch_index, num_epochs, loss_train,
                                       acc_train, loss_val, acc_val, dt)
            assert_tensors_finite(self.model.state_dict(), "model parameters")
            if self.ctx.is_main:
                ckpt.save(self.checkpoint_state())
            self.ctx.barrier()
            self.history.append({
                "epoch": epoch_index + 1,
                "train_loss": loss_train,
                "train_acc": acc_train,
                "val_loss": loss_val,
                "val_acc": acc_val,
                "train_steps": n,
                "val_steps": vn,
                "seconds": dt,
                "step": self.step,
            })
        return self.history

    # -- checkpoints ------------------------------------------------------------

    def checkpoint_state(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "protocol": self.protocol_dict(),
        }

    def load_model(self) -> None:
        """Restores model, Adam state and step from the run checkpoint."""
        self.restore_state(Checkpointer(self.run_dir).restore(self.device))

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Model, Adam state and step from a ``checkpoint_state`` dict;
        drops the captured step (Adam's state tensors are replaced), so
        the next steps warm up a new one."""
        if self._graph is not None:
            torch.cuda.synchronize(self.device)  # no replay may still run
        self._graph, self._warm = None, (None, 0)
        self.model.load_state_dict(state["model"])
        load_adam_state(self.optimizer, state["optimizer"])
        self.step = int(state["step"])

    def maybe_resume(self) -> bool:
        """Restores the run's checkpoint if one exists; returns whether
        training resumes from it."""
        if not Checkpointer(self.run_dir).exists():
            self.say(f"no checkpoint under {self.run_dir}; training fresh")
            return False
        self.load_model()
        self.say(f"resumed from {self.run_dir} at step {self.step}")
        return True

    def protocol_dict(self) -> Dict[str, Any]:
        """Training-protocol provenance: epochs and batch size (None when
        this trainer never trained) and the dataset's identity fields."""
        p: Dict[str, Any] = dict(
            self._train_protocol or {"num_epochs": None, "batch_size": None})
        ds = self.dataset
        p["dataset"] = type(ds).__name__
        for attr in ("factor_sizes", "num_bars", "is_short", "class_name"):
            v = getattr(ds, attr, None)
            if v is not None:
                p[attr] = list(v) if isinstance(v, tuple) else v
        return p

    def has_protocol_cache(self, num_epochs: int, batch_size: int) -> bool:
        """True iff the run dir holds a ``results_dict.json`` stamped with
        this training protocol: the epochs, the batch size and the
        dataset's identity fields (``--skip_cached``)."""
        try:
            with open(self.results_path) as fh:
                stamped = json.load(fh).get("protocol") or {}
        except (OSError, ValueError):
            return False
        want = dict(self.protocol_dict(), num_epochs=int(num_epochs),
                    batch_size=int(batch_size))
        return all(stamped.get(k) == v for k, v in want.items())

    # -- evaluation -------------------------------------------------------------

    EVAL_BATCH_SIZE = 128

    @abc.abstractmethod
    def draw_eval_noise(self, batch: int, generator: torch.Generator):
        """The draws of one eval batch of ``batch`` rows."""

    @abc.abstractmethod
    def compute_representations(self, num_batches: int = 200,
                                batch_size: Optional[int] = None,
                                noise: Optional[Sequence] = None
                                ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """(latent codes, attribute columns, attribute names) of the harvest."""

    @abc.abstractmethod
    def test_model(self, batch_size: Optional[int] = None,
                   noise: Optional[Sequence] = None) -> Dict[str, float]:
        """{"test_loss", "test_acc"} over the eval split."""

    def eval_split(self) -> DeviceSplit:
        """The dataset's eval split on the trainer's device (made once)."""
        if self._eval_split is None:
            self._eval_split = self.dataset.device_eval_split(self.device)
            if self._eval_split.n == 0:
                raise ValueError("the eval split is empty")
        return self._eval_split

    def _eval_draws(self, noise: Optional[Sequence], count: int, offset: int):
        """``count`` batches' draws: the injected ones, or a generator for
        the pass seeded from ``rand`` + ``offset``."""
        if noise is not None:
            if len(noise) != count:
                raise ValueError(f"{len(noise)} injected draws for {count} batches")
            return lambda i, b: noise[i]
        gen = torch.Generator(self.device).manual_seed(self.hparams.rand + offset)
        return lambda i, b: self.draw_eval_noise(b, gen)

    @torch.no_grad()
    def _harvest(self, batch_size: Optional[int], num_batches: int,
                 encode_batch: Callable, noise: Optional[Sequence]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(z, labels) of the first ``min(n // B, num_batches + 1)`` whole
        batches of the eval split, B (``EVAL_BATCH_SIZE`` by default)
        clamped to the split's size. ``encode_batch(batch, draws) -> (z,
        labels)``."""
        sp = self.eval_split()
        bs = min(batch_size or self.EVAL_BATCH_SIZE, sp.n)
        steps = min(sp.num_batches(bs), num_batches + 1)
        draws = self._eval_draws(noise, steps, _HARVEST_SEED_OFFSET)
        self.model.eval()
        rows = []
        for i in range(steps):
            idx = torch.arange(i * bs, (i + 1) * bs, device=sp.device)
            z, labels = encode_batch(sp.gather_batch(idx), draws(i, bs))
            rows.append(torch.cat([z, labels.float()], dim=1))
        out = torch.cat(rows).cpu().numpy()  # the harvest's one host read
        zd = z.shape[1]
        return np.ascontiguousarray(out[:, :zd]), np.ascontiguousarray(out[:, zd:])

    @torch.no_grad()
    def _test_pass(self, batch_size: Optional[int], batch_metrics: Callable,
                   noise: Optional[Sequence]) -> Dict[str, float]:
        """Mean (loss, accuracy) over the eval split's batches of B
        (``EVAL_BATCH_SIZE`` by default) in order, the final partial batch
        at the same weight as a whole one. ``batch_metrics(batch, draws)
        -> (loss, accuracy)``."""
        sp = self.eval_split()
        bs = min(batch_size or self.EVAL_BATCH_SIZE, sp.n)
        steps = sp.num_batches(bs)
        bounds = [(i * bs, (i + 1) * bs) for i in range(steps)]
        if sp.n > steps * bs:
            bounds.append((steps * bs, sp.n))
        draws = self._eval_draws(noise, len(bounds), _TEST_SEED_OFFSET)
        self.model.eval()
        vals = []
        for i, (a, b) in enumerate(bounds):
            idx = torch.arange(a, b, device=sp.device)
            vals.append(torch.stack(batch_metrics(sp.gather_batch(idx), draws(i, b - a))))
        vals = torch.stack(vals).cpu().numpy()  # the pass's one host read
        # the whole batches' float32 values, the tail's as a Python float,
        # averaged as the JAX trainer averages them
        loss, acc = ([*v[:steps], *map(float, v[steps:])] for v in vals.T)
        mean_loss, mean_acc = float(np.mean(loss)), float(np.mean(acc))
        print("Test Epoch:")
        print("\tTest Loss: ", mean_loss, "\n\tTest Accuracy: ", mean_acc * 100)
        return {"test_loss": mean_loss, "test_acc": mean_acc}

    def extra_eval_metrics(self) -> Dict[str, Any]:
        """Results a trainer adds after the test pass (MNIST's judge)."""
        return {}

    def compute_eval_metrics(self, batch_size: Optional[int] = None) -> Dict[str, Any]:
        """The evaluation's results (:meth:`evaluation_results`) and the
        protocol stamp, cached as ``results_dict.json`` in the run dir (a
        cache there is returned as it is) and kept as ``self.metrics``.
        Over a process group rank 0 evaluates and writes, on its card,
        while the others wait, then read its file."""
        if not self.ctx.is_main:
            self.ctx.barrier()
            return self._read_results()
        try:
            if os.path.exists(self.results_path):
                return self._read_results()
            self.metrics = self.evaluation_results(batch_size)
            return self._write_results()
        finally:
            self.ctx.barrier()

    def evaluation_results(self, batch_size: Optional[int] = None) -> Dict[str, Any]:
        """The five metrics of the harvest, the test pass and the
        trainer's extra results, gathered in ``self.metrics`` (the judge
        reads the interpretability there). The metrics' jitter is drawn
        from ``np.random.RandomState(rand)``."""
        self.metrics = self._metric_suite()
        self.metrics.update(self.test_model(batch_size=batch_size))
        self.metrics.update(self.extra_eval_metrics())
        return self.metrics

    def _metric_suite(self) -> Dict[str, Any]:
        """The five metrics of the harvest, jitter from RandomState(rand)."""
        return compute_all(*self.compute_representations(),
                           np.random.RandomState(self.hparams.rand))

    def _read_results(self) -> Dict[str, Any]:
        """The cached ``results_dict.json`` as it is, kept as ``self.metrics``."""
        with open(self.results_path) as fh:
            self.metrics = json.load(fh)
        return self.metrics

    def _write_results(self) -> Dict[str, Any]:
        """Stamps ``self.metrics`` with the protocol and caches it."""
        self.metrics["protocol"] = self.protocol_dict()
        os.makedirs(self.run_dir, exist_ok=True)
        with open(self.results_path, "w") as fh:
            json.dump(self.metrics, fh, indent=2)
        return self.metrics

    @staticmethod
    def print_epoch_stats(epoch_index, num_epochs, mean_loss_train,
                          mean_accuracy_train, mean_loss_val,
                          mean_accuracy_val, seconds=None):
        extra = f"  [{seconds:.1f}s]" if seconds is not None else ""
        print(f"Train Epoch: {epoch_index + 1}/{num_epochs}{extra}")
        print(f"\tTrain Loss: {mean_loss_train}"
              f"\tTrain Accuracy: {mean_accuracy_train * 100} %")
        print(f"\tValid Loss: {mean_loss_val}"
              f"\tValid Accuracy: {mean_accuracy_val * 100} %")
