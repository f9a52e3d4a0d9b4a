"""The benchmark of ``arvae_tpu_torch``, the PyTorch + CUDA port.

One run trains one cell (``workloads/<name>.json``: a configuration
from ``configs/`` under a traffic mix from ``traffic/``) on one card
through the port's own epoch runner and train step, times a window of
steps, optionally profiles a stretch after it, and checks the steps it
took against the plain reference under ``reference/``. Everything that
belongs to one configuration, traffic mix, metric or kernel set is a
file of its own, found by name:

- ``configs/<config>.json``: sizes, objective, ``family``, ``limits``;
- ``traffic/<traffic>.json``: what ``data.py`` generates and the steps
  each phase of a run takes; its ``kind`` names the generator,
  ``traffic_kinds/<kind>.py``;
- ``workloads/<cell>.json``: a cell's configuration, traffic and why;
- ``programs/<family>.py``: builds the port's trainer and split, and
  alters a row for the ``altered_row`` fault;
- ``reference/<family>.py``: the plain PyTorch reference of its steps;
- ``work/<family>.py``: model FLOPs a step, for ``mfu_pct``;
- ``metrics/<name>.py`` (or ``metrics/<prefix>.py`` for
  ``<prefix>.<suffix>``): the reader of one metric;
- ``kernel_sets/<set>/*.txt``: the kernel names of a set;
- ``work/<set>/<family>.py``: a kernel set's least time a step in a family.

Nothing here imports ``jax`` or the JAX package, and ``reference/``
imports nothing of the port.
"""
