"""The γ×δ sweep with the PyTorch port: AR-VAE runs over the 7×5 grid
``GAMMAS × DELTAS`` at β=1.0, ``reg_type=("all",)`` on every
regularisable latent dim, ``rand=0``.

Flag names and defaults follow the root ``script_hyper_param_exp.py``,
plus ``--device`` (default ``cuda``; without a card the script raises
unless ``--device cpu`` is given). Run as a module:

    python -m arvae_tpu_torch.script_hyper_param_exp -d dsprites --short --num_epochs 1

Each cell (:func:`run_cell`) trains and evaluates one run, or reuses it
when its run dir holds a ``results_dict.json`` stamped with this
protocol (never a bare checkpoint: a cell cut mid-protocol leaves one).
A cell that raises is reported and skipped, the grid goes on, and a cell
that raised before it had trained in full has its run dir moved to
``<run_dir>.failed``. Under ``--test`` a cell without a finished cache is
skipped. Each cell's row holds γ, δ, the mean interpretability, the
other four metrics and the reconstruction accuracy in %: the columns of
the root script's DataFrame (:data:`COLUMNS`). The rows are printed as
one JSON object; the root script's seaborn scatter PDF is left out, as
the card's machine has no pandas, matplotlib or seaborn.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import traceback
from typing import List, Optional, Sequence, Tuple

import torch

from arvae_tpu_torch.core.checkpoint import Checkpointer
from arvae_tpu_torch.core.config import add_switch, expand_reg_dims
from arvae_tpu_torch.data.dsprites import (FULL_FACTOR_SIZES, SHORT_FACTOR_SIZES,
                                           DspritesDataset)
from arvae_tpu_torch.data.mnist import MorphoMnistDataset
from arvae_tpu_torch.eval.metrics import EVAL_METRIC_DICT
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE
from arvae_tpu_torch.training.image_trainer import (DSPRITES_REG_TYPE, MNIST_REG_TYPES,
                                                    ImageVAETrainer)

GAMMAS = [0.01, 0.1, 1.0, 2.0, 5.0, 10.0, 100.0]
DELTAS = [100.0, 10.0, 1.0, 0.1, 0.01]
COLUMNS = (["$\\gamma$", "$\\delta$"] + list(EVAL_METRIC_DICT.values())
           + ["Reconstruction Accuracy (in %)"])


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_type", "-d", default="mnist")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--capacity", type=float, default=0.0)
    p.add_argument("--dec_dist", default="bernoulli", choices=("bernoulli", "gaussian"))
    add_switch(p, "--train", "--test", "do_train", True,
               "train the cells without a finished cache (default) or, with --test, "
               "skip them")
    add_switch(p, "--log", "--no_log", "log", False,
               "log the results for tensorboard (unused, API parity)")
    add_switch(p, "--short", "--full", "short", False,
               "use the reduced dSprites factor grid for quick runs")
    p.add_argument("--device", default="cuda",
                   help="torch device; `cpu` must be asked for explicitly")
    return p.parse_args(argv)


def sweep_data(dataset_type: str, short: bool):
    """(dataset, model class, attribute dict) of ``-d``."""
    if dataset_type == "mnist":
        return MorphoMnistDataset(), MnistVAE, MNIST_REG_TYPES
    if dataset_type == "dsprites":
        dataset = DspritesDataset(factor_sizes=SHORT_FACTOR_SIZES if short
                                  else FULL_FACTOR_SIZES)
        return dataset, DspritesVAE, DSPRITES_REG_TYPE
    raise ValueError("Invalid dataset_type")


def cell_row(gamma: float, delta: float, results: dict) -> List[float]:
    """The cell's row under :data:`COLUMNS`."""
    row = [gamma, delta]
    for k in EVAL_METRIC_DICT:
        row.append(results[k]["mean"][1] if k == "interpretability" else results[k])
    row.append(results["test_acc"] * 100)
    return row


def run_cell(dataset, model_type, attr_dict, gamma: float, delta: float, *,
             device: torch.device, batch_size: int, num_epochs: int, lr: float = 1e-4,
             capacity: float = 0.0, dec_dist: str = "bernoulli", do_train: bool = True
             ) -> Tuple[ImageVAETrainer, Optional[List[float]]]:
    """Trains (or reuses) and evaluates the cell (γ, δ) → (its trainer, its
    row), the row None when the cell was skipped or failed."""
    trainer = ImageVAETrainer(
        dataset=dataset, model=model_type(seed=0), device=device, lr=lr,
        reg_type=("all",), reg_dim=expand_reg_dims(("all",), attr_dict), beta=1.0,
        capacity=capacity, gamma=gamma, delta=delta, dec_dist=dec_dist, rand=0)
    trained_full = False
    try:
        if trainer.has_protocol_cache(num_epochs, batch_size):
            trainer.load_model()
        elif not do_train:
            print(f"skip gamma={gamma} delta={delta} (no finished cell)")
            return trainer, None
        else:
            trainer.train_model(batch_size=batch_size, num_epochs=num_epochs)
        trained_full = True
        results = trainer.compute_eval_metrics(batch_size=batch_size)
    except Exception as e:  # one cell's failure costs one point, not the grid
        print(f"CELL-FAILED gamma={gamma} delta={delta}: {e!r}"[:500], flush=True)
        traceback.print_exc(file=sys.stderr)
        if not trained_full and Checkpointer(trainer.run_dir).exists():
            failed_dir = trainer.run_dir.rstrip(os.sep) + ".failed"
            shutil.rmtree(failed_dir, ignore_errors=True)
            os.rename(trainer.run_dir, failed_dir)
            print(f"quarantined partial cell -> {failed_dir}", flush=True)
        return trainer, None
    print(json.dumps(results, indent=2))
    return trainer, cell_row(gamma, delta, results)


def main(argv: Optional[Sequence[str]] = None) -> List[List[float]]:
    """Runs the grid; returns the rows of the cells that have results."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    dataset, model_type, attr_dict = sweep_data(args.dataset_type, args.short)
    rows = []
    for g in GAMMAS:
        for d in DELTAS:
            _, row = run_cell(dataset, model_type, attr_dict, g, d, device=device,
                              batch_size=args.batch_size, num_epochs=args.num_epochs,
                              lr=args.lr, capacity=args.capacity,
                              dec_dist=args.dec_dist, do_train=args.do_train)
            if row is not None:
                rows.append(row)
    if not rows:
        print("no cached results for any (gamma, delta) cell - "
              "run without --test first")
        return rows
    print(json.dumps({"columns": COLUMNS, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
