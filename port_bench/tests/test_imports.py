"""Nothing the harness loads is the JAX package or a library it rests on
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the port."""

import subprocess
import sys

from port_bench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "arvae_tpu")

_HARNESS = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None  # importing any of these now raises
import glob, time
from port_bench import calibrate, harness, run, trace
from port_bench.tests.conftest import tiny_cell
for path in sorted(glob.glob("port_bench/metrics/*.py")):
    name = path.split("/")[-1][:-3]
    harness.reader(name if "." in name else name)
for name in ("measure_h512_train", "dsprites_b128_train"):
    harness.run_cell(tiny_cell(name), 5, 0.1, False, "cpu", time.perf_counter())
print(sorted({{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}))
"""

_REFERENCE = """
import sys, torch
from port_bench import data, weights
from port_bench.reference import dsprites_vae, measure_vae
from port_bench.tests.conftest import tiny_cell
for name, ref in (("measure_h512_train", measure_vae), ("dsprites_b128_train", dsprites_vae)):
    cell = tiny_cell(name)
    w = weights.init_weights(ref.param_spec(cell.cfg), 5, "cpu")
    ref.run_steps(cell.cfg, cell.traffic, 5, data.make_inputs(cell.traffic, cell.cfg, 5, "cpu"),
                  w, 2)
print(sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None}))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = _top_level(_HARNESS.format(forbidden=FORBIDDEN))
    assert not loaded & set(FORBIDDEN)
    assert "arvae_tpu_torch" in loaded  # the port is what it runs


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(_REFERENCE)
    assert not loaded & (set(FORBIDDEN) | {"arvae_tpu_torch"})
