"""Numerics guard, the counterpart of ``assert_tree_finite`` in
``arvae_tpu/utils/profiling.py``."""

from __future__ import annotations

from typing import Mapping

import torch


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
