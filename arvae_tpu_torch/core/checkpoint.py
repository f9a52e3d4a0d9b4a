"""Checkpointing: the full train state in one ``torch.save`` file.

Counterpart of ``arvae_tpu/core/checkpoint.py`` (orbax there). A
checkpoint holds the model's ``state_dict``, the Adam state, the step
count and the training protocol, under ``<run_dir>/ckpt.pt``, so
``--resume`` continues the optimizer trajectory.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


class Checkpointer:
    """Save/restore full train state under <models_root>/torch/<repr>/ckpt.pt."""

    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        self.path = os.path.join(self.run_dir, "ckpt.pt")

    def save(self, state: Dict[str, Any]) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        # write-then-rename: a run cut mid-save keeps the previous epoch
        tmp = self.path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path)

    def exists(self) -> bool:
        return os.path.isfile(self.path)

    def restore(self, device: torch.device) -> Dict[str, Any]:
        return torch.load(self.path, map_location=device, weights_only=True)
