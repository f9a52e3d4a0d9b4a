"""The port's fader trainer with ``DspritesFaderNetwork`` on a packed split."""

from __future__ import annotations

from typing import Dict

import torch

from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork, ImageFaderDiscriminator
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from port_bench.reference.dsprites_fader import disc_start


def alter_row(cfg: dict, x: torch.Tensor) -> None:
    """Inverts the pixels of ``x``'s first image (a fault of ``faults.py``)."""
    x[0] = 1.0 - x[0]


def build(cfg: dict, traffic: dict, seed: int, device, inputs: Dict[str, torch.Tensor]):
    """(trainer, training split): ``ImageFaderTrainer`` with the
    configuration's objective, ``rand`` = ``seed``, its discriminator
    starting from ``disc_start``'s weights (the harness loads the
    fader's)."""
    m, o = cfg["model"], cfg["objective"]
    disc = ImageFaderDiscriminator(m["num_attributes"], m["latent_space_dim"],
                                   dropout_rate=m["disc_dropout"])
    disc.load_state_dict(disc_start(cfg, seed, device))  # raises unless the leaves match
    trainer = ImageFaderTrainer(None, DspritesFaderNetwork(), device, disc_model=disc,
                                lr=o["lr"], beta=o["beta"], rand=seed, dec_dist=o["dec_dist"])
    size = m["image_size"]
    split = DeviceSplit(inputs["packed"].cpu().numpy(), inputs["labels"].cpu().numpy(),
                        (1, size, size), "packed", trainer.device, trainer.ctx)
    return trainer, split
