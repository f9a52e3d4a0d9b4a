"""Experiment configuration and run naming.

A copy of ``arvae_tpu/core/config.py`` (pure Python; the JAX package's
``core`` imports orbax, so the port carries its own). Hyperparameters
are serialized into ``trainer_config`` with the same string semantics,
so a run's name (``model_repr``) is the JAX package's. The port keeps
its runs under ``<models_root>/torch/<model_repr>/``, beside the JAX
package's ``<models_root>/<model_repr>/``: neither reads or removes the
other's checkpoint or ``results_dict.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Tuple


def models_root() -> str:
    """Directory holding all run artifacts (checkpoints, results caches)."""
    return os.environ.get(
        "ARVAE_MODELS_DIR",
        os.path.join(os.getcwd(), "models"),
    )


@dataclasses.dataclass(frozen=True)
class TrainerHParams:
    """Hyperparameters shared by every AR-VAE trainer."""

    lr: float = 1e-4
    beta: float = 4.0
    capacity: float = 0.0
    gamma: float = 10.0
    delta: float = 1.0
    dec_dist: str = "bernoulli"
    rand: int = 0
    reg_type: Tuple[str, ...] = ()
    reg_dim: Tuple[int, ...] = ()

    @property
    def use_reg_loss(self) -> bool:
        return len(self.reg_type) != 0


def trainer_config_string(h: TrainerHParams) -> str:
    """The run-dir fragment, e.g. ``_r_0_b_1.0_g_10.0_d_1.0_all_``."""
    s = f"_r_{h.rand}_b_{h.beta}_"
    if h.capacity != 0.0:
        s += f"c_{h.capacity}_"
    if h.use_reg_loss:
        s += f"g_{h.gamma}_d_{h.delta}_"
        s += "_".join(h.reg_type) + "_"
    return s


def run_dir(model_repr: str) -> str:
    """<models_root>/torch/<repr>/ — the port's per-run artifact directory."""
    return os.path.join(models_root(), "torch", model_repr)


def normalize_reg_dim(reg_dim, reg_type) -> Tuple[int, ...]:
    """Latent-dim spec → tuple, scalar-safe.

    A bare int means one dim (``tuple(reg_dim or ())`` would silently
    turn ``reg_dim=0`` into "no regularization" while the run dir still
    claims the reg config). Empty when ``reg_type`` is empty."""
    if not len(tuple(reg_type or ())):
        return ()
    if isinstance(reg_dim, (int,)):
        return (int(reg_dim),)
    return tuple(int(d) for d in (reg_dim or ()))


def expand_reg_dims(
    reg_type: Tuple[str, ...], attr_dict: dict, skip=("digit_identity", "color")
) -> Tuple[int, ...]:
    """'all' expansion + name→dim mapping."""
    if len(reg_type) == 0:
        return ()
    if len(reg_type) == 1 and reg_type[0] == "all":
        return tuple(v for k, v in attr_dict.items() if k not in skip)
    return tuple(attr_dict[r] for r in reg_type)


def add_switch(p: argparse.ArgumentParser, on: str, off: str, dest: str,
               default: bool, help: str) -> None:
    """A ``--on/--off`` pair of CLI flags, as click writes one."""
    p.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    p.add_argument(off, dest=dest, action="store_false")
