"""The port's image AR-VAE trainer with ``DspritesVAE`` on a packed split."""

from __future__ import annotations

from typing import Dict

import torch

from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer


def alter_row(cfg: dict, x: torch.Tensor) -> None:
    """Inverts the pixels of ``x``'s first image (a fault of ``faults.py``)."""
    x[0] = 1.0 - x[0]


def build(cfg: dict, traffic: dict, seed: int, device, inputs: Dict[str, torch.Tensor]):
    """(trainer, training split): ``ImageVAETrainer`` with the
    configuration's objective, ``rand`` = ``seed``."""
    o = cfg["objective"]
    trainer = ImageVAETrainer(None, DspritesVAE(), device, lr=o["lr"],
                              reg_type=tuple(o["reg_type"]), reg_dim=tuple(o["reg_dim"]),
                              beta=o["beta"], gamma=o["gamma"], capacity=o["capacity"],
                              rand=seed, delta=o["delta"], dec_dist=o["dec_dist"])
    size = cfg["model"]["image_size"]
    split = DeviceSplit(inputs["packed"].cpu().numpy(), inputs["labels"].cpu().numpy(),
                        (1, size, size), "packed", trainer.device, trainer.ctx)
    return trainer, split
