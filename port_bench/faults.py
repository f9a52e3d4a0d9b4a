"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_faults.py`` on the CPU, ``calibrate.py --fault`` on
the card at the cells' sizes). Each wraps a trainer's ``train_step``:

- ``frozen``: the step runs its forward and backward but leaves the
  parameters and Adam's state unchanged;
- ``half_batch``: the step sees the first half of its rows only, and
  takes its means over them;
- ``altered_row``: one row of the batch is altered where the gather
  produces it, by the family's ``programs/<family>.py`` ``alter_row``
  (a token moved to the next id; an image's pixels inverted).
"""

from __future__ import annotations

from typing import Callable, Optional

FAULTS = ("frozen", "half_batch", "altered_row")


def plant(name: str, trainer, alter_row: Optional[Callable] = None) -> Callable:
    """``trainer.train_step`` with the fault ``name`` in it;
    ``alter_row(x)`` alters ``x``'s first row in place (``altered_row``)."""
    step = trainer.train_step
    if name == "frozen":
        def frozen(batch, **kw):
            opt_step, trainer.optimizer.step = trainer.optimizer.step, lambda *a, **k: None
            try:
                return step(batch, **kw)
            finally:
                trainer.optimizer.step = opt_step
        return frozen
    if name == "half_batch":
        return lambda batch, **kw: step(tuple(x[:x.shape[0] // 2] for x in batch), **kw)
    if name == "altered_row":
        def altered(batch, **kw):
            x, y = batch
            bad = x.clone()
            alter_row(bad)
            return step((bad, bad if y is x else y), **kw)
        return altered
    raise ValueError(f"unknown fault {name!r}; choose from {FAULTS}")

