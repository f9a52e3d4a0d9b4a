"""Train an image AR-VAE (Morpho-MNIST or dSprites) with the PyTorch port.

Flag names and defaults follow the root ``train_image_vae.py`` for what
the port supports. Run as a module:

    python -m arvae_tpu_torch.train_image_vae -r all --beta 1.0 --rand 0 \\
        --num_epochs 2                      # MNIST, the default
    python -m arvae_tpu_torch.train_image_vae -d dsprites --short --rand 0 \\
        -r all --beta 1.0 --num_epochs 2 --batch_size 128

MNIST trains ``MnistVAE`` on ``MorphoMnistDataset`` (the synthetic digit
set and its measured morphometrics while no real archives are present;
``--short`` applies to dSprites only) and its evaluation adds the
digit judge's ``digit_pred_acc`` when ``python -m
arvae_tpu_torch.test_mnist`` has trained one.

``--device`` defaults to ``cuda``; without a card the script raises
unless ``--device cpu`` is given. After training, or after restoring the
run's checkpoint under ``--test``, each seed is evaluated: the five
disentanglement metrics, the test loss and accuracy and the protocol
stamp are written to ``<run_dir>/results_dict.json`` and printed (a
results file already in the run dir is printed as it is).
``--skip_cached`` skips a seed whose run dir holds results stamped with
the same epochs, batch size and dataset. ``--bf16`` runs the models'
convolutions and hidden linear layers in bfloat16, as the root CLI's
does (``--f32``, float32 throughout, is the default). The latent GIFs
that follow in the root CLI are left out: they need seaborn, pandas and
PIL. ``--log`` is accepted for the root CLI's sake and does nothing.

On N cards, under ``torchrun``, one process a card::

    torchrun --nproc_per_node N -m arvae_tpu_torch.train_image_vae \\
        -d dsprites --short --rand 0 -r all --batch_size 128 --num_epochs 2

each rank takes ``cuda:LOCAL_RANK`` and the ranks train data-parallel
over NCCL (``arvae_tpu_torch.parallel``); ``--batch_size`` stays the
global batch, split over the ranks. Rank 0 alone prints and writes the
run's files, and evaluates on its card. ``--device cpu`` under torchrun
runs the ranks on the CPU over gloo (for tests). Without torchrun the
CLI trains on one card, as it always has.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import torch

from arvae_tpu_torch.core.config import add_switch, expand_reg_dims
from arvae_tpu_torch.data.dsprites import (FULL_FACTOR_SIZES,
                                           SHORT_FACTOR_SIZES, DspritesDataset)
from arvae_tpu_torch.data.mnist import MorphoMnistDataset
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE
from arvae_tpu_torch.parallel import init_data_parallel
from arvae_tpu_torch.training.image_trainer import (DSPRITES_REG_TYPE, MNIST_REG_TYPES,
                                                    ImageVAETrainer)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_type", "-d", default="mnist",
                   help="dataset to be used, `mnist` or `dsprites`")
    p.add_argument("--batch_size", type=int, default=128,
                   help="training batch size")
    p.add_argument("--num_epochs", type=int, default=100,
                   help="number of training epochs")
    p.add_argument("--lr", type=float, default=1e-4, help="learning rate")
    p.add_argument("--beta", type=float, default=4.0,
                   help="parameter for weighting KLD loss")
    p.add_argument("--capacity", type=float, default=0.0,
                   help="parameter for beta-VAE capacity")
    p.add_argument("--gamma", type=float, default=10.0,
                   help="parameter for weighting regularization loss")
    p.add_argument("--delta", type=float, default=1.0,
                   help="parameter for controlling the spread")
    p.add_argument("--dec_dist", default="bernoulli", choices=("bernoulli", "gaussian"),
                   help="distribution of the decoder")
    add_switch(p, "--train", "--test", "do_train", True,
            "train (default) or, with --test, restore the run's checkpoint")
    add_switch(p, "--log", "--no_log", "log", False,
            "log the results for tensorboard (unused, API parity)")
    add_switch(p, "--resume", "--no_resume", "resume", False,
            "restore the run's checkpoint (params, optimizer state, step) "
            "before training")
    p.add_argument("--rand", type=int, default=None,
                   help="random seed; without it seeds 0-9 are trained")
    p.add_argument("--reg_type", "-r", action="append", default=None,
                   help="attribute name to regularize (repeatable), or `all`")
    add_switch(p, "--short", "--full", "short", False,
            "use the reduced dSprites factor grid for quick runs (default: full; "
            "MNIST ignores it)")
    add_switch(p, "--bf16", "--f32", "bf16", False,
               "run the conv and dense stacks in bfloat16 (parameters, the "
               "distribution heads and the logits stay float32; the run dir is "
               "the same)")
    add_switch(p, "--skip_cached", "--no_skip_cached", "skip_cached", False,
            "skip seeds whose run dir holds results stamped with this protocol")
    p.add_argument("--device", default="cuda",
                   help="torch device; `cpu` must be asked for explicitly")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[ImageVAETrainer]:
    """Runs the CLI; returns the trainers, one per seed not skipped."""
    args = parse_args(argv)
    if args.dataset_type not in ("mnist", "dsprites"):
        raise ValueError("Invalid dataset_type. Choose between mnist and dsprites")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    ctx = init_data_parallel(device)
    try:
        return _train(args, ctx)
    finally:
        ctx.close()


def dataset_of(args: argparse.Namespace):
    """The dataset of ``-d`` and ``--short``, its cache built or read."""
    if args.dataset_type == "mnist":
        return MorphoMnistDataset()
    dataset = DspritesDataset(
        factor_sizes=SHORT_FACTOR_SIZES if args.short else FULL_FACTOR_SIZES)
    dataset.load_dataset()
    return dataset


def _train(args: argparse.Namespace, ctx) -> List[ImageVAETrainer]:
    dataset = ctx.main_first(lambda: dataset_of(args))
    if args.dataset_type == "mnist":
        model_type, attr_dict = MnistVAE, MNIST_REG_TYPES
    else:
        model_type, attr_dict = DspritesVAE, DSPRITES_REG_TYPE
    reg_type = tuple(args.reg_type or ())
    if reg_type:
        unknown = [r for r in reg_type if r != "all" and r not in attr_dict]
        if unknown or ("all" in reg_type and len(reg_type) != 1):
            raise ValueError(
                f"unknown reg_type {unknown or list(reg_type)}; choose from "
                f"{sorted(attr_dict)} or 'all' (alone)")
        reg_dim = expand_reg_dims(reg_type, attr_dict)
    else:
        reg_dim = (0,)

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    seeds = range(0, 10) if args.rand is None else [args.rand]
    trainers = []
    for r in seeds:
        trainer = ImageVAETrainer(
            dataset=dataset,
            model=model_type(seed=r, compute_dtype=compute_dtype),
            device=ctx.device,
            lr=args.lr,
            reg_type=reg_type,
            reg_dim=reg_dim,
            beta=args.beta,
            gamma=args.gamma,
            capacity=args.capacity,
            delta=args.delta,
            dec_dist=args.dec_dist,
            rand=r,
            ctx=ctx,
        )
        if (args.skip_cached and args.do_train
                and trainer.has_protocol_cache(args.num_epochs, args.batch_size)):
            trainer.say(f"skip seed {r}: protocol-stamped cache in {trainer.run_dir}")
            continue
        if args.resume:
            trainer.maybe_resume()
        if args.do_train:
            trainer.train_model(batch_size=args.batch_size,
                                num_epochs=args.num_epochs)
        else:
            trainer.load_model()
        metrics = trainer.compute_eval_metrics(batch_size=args.batch_size)
        trainer.say(json.dumps(metrics, indent=2))
        trainers.append(trainer)
    return trainers


if __name__ == "__main__":
    main()
