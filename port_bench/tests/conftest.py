"""CPU tests of the benchmark: ``python -m pytest port_bench/tests -q``
from the repository's root. They need no card; ``test_control.py``
runs on one and skips here."""

import copy

import pytest
import torch

from port_bench import harness


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def tiny_cell(name: str) -> harness.Cell:
    """A cell at a size a CPU test holds: few rows, B=8, the music
    model at H=16, z=8 (the dSprites model is small at its own widths)."""
    cell = harness.load_cell(name)
    cfg, tr = copy.deepcopy(cell.cfg), copy.deepcopy(cell.traffic)
    if cfg["family"] == "measure_vae":
        cfg["model"].update(encoder_hidden_size=16, decoder_hidden_size=16, latent_space_dim=8)
    tr.update(rows=64, batch=8, warmup_steps=2)
    return harness.Cell(name, cell.workload, cfg, tr)
