"""The fader's training step opens the port's phase spans: each of its two
updates a ``forward`` (the step's draws and the networks; ``encode``
around the discriminator update's no-grad encode, ``disc`` around each
discriminator forward), a ``loss`` and ``BaseTrainer.update``'s
``optimizer``, ``backward``, ``optimizer``; and the step with the
recorder on computes bitwise what it computes with the recorder off.
Both fader networks, through the epoch runner on the CPU."""

import contextlib

import numpy as np
import pytest
import torch

from arvae_tpu_torch.data.device_data import DeviceEpochRunner, DeviceSplit
from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork, MnistFaderNetwork
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.utils import profiling

CPU = torch.device("cpu")
STEPS = 2


def _runner(family):
    """A fader trainer of ``family`` and an epoch runner of ``STEPS`` steps of 4 rows."""
    rng = np.random.RandomState(0)
    if family == "dsprites":
        model, size, cols = DspritesFaderNetwork(seed=1), 64, 6
    else:
        model, size, cols = MnistFaderNetwork(seed=1), 28, 7
    trainer = ImageFaderTrainer(None, model, CPU, beta=4.0, rand=5)
    rows = rng.randint(0, 256, (4 * STEPS, size * size // 8)).astype(np.uint8)
    labels = rng.uniform(0, 1, (4 * STEPS, cols)).astype(np.float32)
    split = DeviceSplit(rows, labels, (1, size, size), "packed", CPU)
    runner = DeviceEpochRunner(split, split, 4, trainer.train_step, trainer.eval_step,
                               trainer.perm_generator)
    return trainer, runner


def _tree(records, parent=None):
    """The records as nested (name, children) tuples under ``parent``."""
    return tuple((r.name, _tree(records, i)) for i, r in enumerate(records)
                 if r.parent == parent)


def _update(forward):
    return (("forward", forward), ("loss", ()), ("optimizer", ()), ("backward", ()),
            ("optimizer", ()))


@pytest.mark.parametrize("family", ["dsprites", "mnist"])
def test_a_fader_step_opens_the_phase_spans_of_both_updates(family):
    _, runner = _runner(family)
    with profiling.recording() as rec:
        totals, steps = runner.train_epoch()
    assert steps == STEPS and bool(torch.isfinite(totals["loss"]))
    train = _update((("encode", ()), ("disc", ()))) + _update((("disc", ()),))
    step = ("step", (("gather", ()), ("train_step", train), ("accumulate", ())))
    recs = rec.records()
    assert _tree(recs) == (("shuffle", ()),) + (step,) * STEPS
    assert not any(r.failed for r in recs)


@pytest.mark.parametrize("family", ["dsprites", "mnist"])
def test_the_recorder_leaves_the_fader_step_bitwise_unchanged(family):
    def run(record):
        trainer, runner = _runner(family)
        metrics = []

        def step(batch, **kw):
            out = trainer.train_step(batch, **kw)
            metrics.append({k: v.clone() for k, v in out.items()})
            return out

        runner.train_step = step
        with profiling.recording() if record else contextlib.nullcontext():
            runner.train_epoch()
        params = [p.detach().clone() for net in (trainer.model, trainer.disc)
                  for p in net.parameters()]
        return metrics, params

    (on_metrics, on_params), (off_metrics, off_params) = run(True), run(False)
    assert len(on_metrics) == len(off_metrics) == STEPS
    for a, b in zip(on_metrics, off_metrics):
        assert a.keys() == b.keys() == {"loss", "accuracy", "recons_loss", "adv_loss",
                                         "disc_loss"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(on_params) == len(off_params)
    assert all(torch.equal(a, b) for a, b in zip(on_params, off_params))
    # the step moved both networks
    trainer, _ = _runner(family)
    start = [p.detach() for net in (trainer.model, trainer.disc) for p in net.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(start, on_params))
