"""Train a fader-network baseline (Morpho-MNIST or dSprites) with the
PyTorch port.

Flag names and defaults follow the root ``train_image_fader.py``. Run as
a module:

    python -m arvae_tpu_torch.train_image_fader --num_epochs 2   # MNIST
    python -m arvae_tpu_torch.train_image_fader -d dsprites --short --num_epochs 2

MNIST trains ``MnistFaderNetwork`` on ``MorphoMnistDataset`` (the
synthetic digit set while no real archives are present; ``--short``
applies to dSprites only), dSprites ``DspritesFaderNetwork``; each
against an ``ImageFaderDiscriminator`` with its own Adam. ``--device``
defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given. After training (``--resume`` first restores
both networks, both Adam states and the step), or after restoring the
run's checkpoint under ``--test``, the run is evaluated: the five
disentanglement metrics and the protocol stamp are written to
``<run_dir>/results_dict.json`` and printed (a results file already in
the run dir is printed as it is). ``--log`` is accepted for the root
CLI's sake and does nothing. Under ``torchrun --nproc_per_node N -m
arvae_tpu_torch.train_image_fader ...`` the ranks train data-parallel,
one card each, with ``--batch_size`` the global batch (as
``train_image_vae``'s docstring says).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from arvae_tpu_torch.core.config import add_switch
from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork, MnistFaderNetwork
from arvae_tpu_torch.parallel import init_data_parallel
from arvae_tpu_torch.train_image_vae import dataset_of
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_type", "-d", default="mnist",
                   help="dataset to be used, `mnist` or `dsprites`")
    p.add_argument("--batch_size", type=int, default=128, help="training batch size")
    p.add_argument("--num_epochs", type=int, default=100, help="number of training epochs")
    p.add_argument("--lr", type=float, default=1e-4, help="learning rate")
    p.add_argument("--beta", type=float, default=4.0,
                   help="weight of the adversarial (discriminator) loss")
    add_switch(p, "--train", "--test", "do_train", True,
               "train (default) or, with --test, restore the run's checkpoint")
    add_switch(p, "--log", "--no_log", "log", False,
               "log the results for tensorboard (unused, API parity)")
    add_switch(p, "--resume", "--no_resume", "resume", False,
               "restore the run's checkpoint (both networks' parameters and Adam "
               "states, the step) before training")
    p.add_argument("--rand", type=int, default=0, help="random seed")
    add_switch(p, "--short", "--full", "short", False,
               "use the reduced dSprites factor grid for quick runs (default: full; "
               "MNIST ignores it)")
    p.add_argument("--device", default="cuda",
                   help="torch device; `cpu` must be asked for explicitly")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> ImageFaderTrainer:
    """Runs the CLI; returns the trainer."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    ctx = init_data_parallel(device)
    try:
        return _train(args, ctx)
    finally:
        ctx.close()


def _train(args: argparse.Namespace, ctx) -> ImageFaderTrainer:
    if args.dataset_type not in ("mnist", "dsprites"):
        raise ValueError("Invalid dataset_type. Choose between mnist and dsprites")
    dataset = ctx.main_first(lambda: dataset_of(args))
    model = (MnistFaderNetwork if args.dataset_type == "mnist"
             else DspritesFaderNetwork)(seed=args.rand)

    trainer = ImageFaderTrainer(dataset, model, ctx.device, lr=args.lr, beta=args.beta,
                                rand=args.rand, ctx=ctx)
    if args.resume:
        trainer.maybe_resume()
    if args.do_train:
        trainer.train_model(batch_size=args.batch_size, num_epochs=args.num_epochs)
    else:
        trainer.load_model()
    metrics = trainer.compute_eval_metrics(batch_size=args.batch_size)
    trainer.say(json.dumps(metrics, indent=2))
    return trainer


if __name__ == "__main__":
    main()
