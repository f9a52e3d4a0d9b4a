"""The port imports on a machine without jax: every ``arvae_tpu_torch``
module imports in a subprocess where ``import jax`` fails, and no
module of the port, nor ``chip_smoke.py``, nor the cases it shares with
the card tests (``tests/torch_card_cases.py``), names jax or the JAX
package in an import. The probe also blocks scikit-learn, pandas, click,
matplotlib and music21, which the card's machine lacks too, so an import
of any of them in the port (a plot creeping into the tester, say) fails
here and not first on the card."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "arvae_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "arvae_tpu", "sklearn",
             "pandas", "click", "matplotlib", "music21"):
    sys.modules[name] = None  # any import of these now raises ImportError
import arvae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(arvae_tpu_torch.__path__,
                                               "arvae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _module_files():
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    expected = len(_module_files()) - 1  # the package __init__ itself
    assert int(out.stdout.strip().splitlines()[-1]) == expected


def test_no_jax_or_reference_package_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|arvae_tpu)\b",
                     re.M)
    files = _module_files() + [REPO / "chip_smoke.py", REPO / "tests" / "torch_card_cases.py"]
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders


def test_the_data_parallel_layer_and_its_rank_bodies_import_no_jax():
    """``parallel/`` is among the modules the probe imports without jax,
    and the rank bodies the spawned gloo ranks import
    (``tests/torch_parallel_ranks.py``) name neither jax nor the JAX
    package."""
    parallel = sorted(p.name for p in (PKG / "parallel").glob("*.py"))
    assert parallel == ["__init__.py", "collectives.py", "mesh.py"]
    probe = _PROBE.replace("print(len(names))", "print(sorted(n for n in names if "
                           "n.startswith('arvae_tpu_torch.parallel')))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "'arvae_tpu_torch.parallel.collectives', 'arvae_tpu_torch.parallel.mesh'" in out.stdout
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|arvae_tpu)\b", re.M)
    assert not pat.search((REPO / "tests" / "torch_parallel_ranks.py").read_text())
