"""The settings the test suite's processes run under, applied when this
module is collected. Every pytest-xdist worker collects every module, so
they hold in every worker, and in a serial run from collection on.

- **torch on one intra-op thread.** Each worker would otherwise start
  one OpenMP thread per core for torch, and six workers oversubscribe
  the cores: the port's test files took 742 s under six workers with
  torch's default threads and 70 s with one thread each, the same tests
  passing. Only torch's own pool is set; JAX's tests do not use it.
- **Worker pools start by forkserver** (``ARVAE_TEST_POOL_START``, default
  ``forkserver``; set it to ``fork`` to run the pools as the CLIs do).
  The JAX package's morphometry pools (``arvae_tpu/data/mnist.py``,
  ``arvae_tpu/data/morphomnist/measure.py``) use the platform's default,
  fork. A pool forked after JAX has started its threads in the same
  process can deadlock: its children inherit locks those threads held.
  ``pytest tests/test_losses.py tests/test_data_sweep2.py`` hangs so
  under fork, and the suite's workers pair those two files whenever the
  schedule puts them in one worker in that order. ROADMAP.md records the
  deadlock as an open defect of the JAX package; a forkserver forks each
  child from a process in which JAX never ran.
"""

import multiprocessing
import os

import torch

POOL_START = os.environ.get("ARVAE_TEST_POOL_START", "forkserver")

torch.set_num_threads(1)
multiprocessing.set_start_method(POOL_START, force=True)


def test_torch_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1


def test_worker_pools_start_by_the_suite_setting():
    assert multiprocessing.get_start_method() == POOL_START
    with multiprocessing.get_context().Pool(1) as pool:
        assert pool.map(abs, [-3]) == [3]
