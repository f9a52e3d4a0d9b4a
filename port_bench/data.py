"""The cells' inputs: one general generator, parametrised by a traffic file.

Every input is made on the device from the run's seed, in a few large
calls, so the same seed gives the same inputs on every run and to both
the port and the reference. A traffic file names its ``kind``; the
inputs of a kind are made by ``traffic_kinds/<kind>.py``, found by name.
"""

from __future__ import annotations

import hashlib
import importlib
from typing import Dict

import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one purpose of the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(derive(seed, purpose))


def make_inputs(traffic: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's data set on ``device``, from ``seed``."""
    device = torch.device(device)
    name = f"port_bench.traffic_kinds.{traffic['kind']}"
    try:
        kind = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}") from e
    return kind.make(traffic, cfg, generator(seed, "inputs", device), device)
