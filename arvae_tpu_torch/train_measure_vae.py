"""Train the music AR-VAE (MeasureVAE) with the PyTorch port.

Flag names and defaults follow the root ``train_measure_vae.py``. Run as
a module:

    python -m arvae_tpu_torch.train_measure_vae --rand 0 -r all --num_epochs 2

``--decoder_type`` picks the decoder (``hier``, ``sr``, ``sr-no-input``)
and ``--glsr`` trains with the GLSR regulariser in place of the AR term,
on one attribute with a differentiable surrogate (``rhy_complexity`` or
``note_density``; ``-r all`` or none picks ``rhy_complexity``), as the
root CLI does. ``--device`` defaults to ``cuda``; without a card the
script raises unless ``--device cpu`` is given. After training, or after
restoring the run's checkpoint under ``--test``, each seed is evaluated
at B=256: the five disentanglement metrics, the test loss and accuracy
and the protocol stamp are written to ``<run_dir>/results_dict.json``
and printed (a results file already in the run dir is printed as it
is). ``--skip_cached`` skips a seed whose run dir holds results stamped
with the same epochs, batch size and dataset. After the evaluation, as in
the root CLI, a harvest of 20 batches of the eval split (B=256) feeds,
for each of the four attributes, the MIDI of the first five codes and of
their 5-point traversals (``MeasureVAETrainer.plot_latent_interpolations``,
under ``<run_dir>/results/``; the root CLI's pianoroll PNGs need
matplotlib and are left out); each decode is one row on the recurrence
kernels. ``--log`` is accepted for the root CLI's sake and does
nothing. Under ``torchrun --nproc_per_node N -m
arvae_tpu_torch.train_measure_vae ...`` the ranks train data-parallel,
one card each, with ``--batch_size`` the global batch (as
``train_image_vae``'s docstring says); rank 0 writes the MIDI files.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import torch

from arvae_tpu_torch.core.config import add_switch, expand_reg_dims
from arvae_tpu_torch.data.attributes import MUSIC_REG_TYPE
from arvae_tpu_torch.data.bar_dataset import ChoraleNBarDataset, FolkNBarDataset
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.parallel import DataContext, init_data_parallel
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

# GLSR's differentiable surrogates, by the CLI's attribute name
GLSR_SUPPORTED = {"rhy_complexity": "rhy_complexity", "note_density": "num_notes"}


def _bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes"):
        return True
    if s.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def arg_parser(description: str = __doc__.splitlines()[0]) -> argparse.ArgumentParser:
    """The CLI's flags (``run_tester_sweep`` reads a run by the same ones)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset_type", "-d", default="folk", choices=("folk", "bach"),
                   help="dataset to be used, `bach` or `folk`")
    p.add_argument("--note_embedding_dim", type=int, default=10,
                   help="size of the note embeddings")
    p.add_argument("--metadata_embedding_dim", type=int, default=2,
                   help="size of the metadata embeddings (unused, API parity)")
    p.add_argument("--num_encoder_layers", type=int, default=2,
                   help="number of layers in encoder RNN")
    p.add_argument("--encoder_hidden_size", type=int, default=128,
                   help="hidden size of the encoder RNN")
    p.add_argument("--encoder_dropout_prob", type=float, default=0.5,
                   help="dropout prob between encoder RNN layers")
    p.add_argument("--has_metadata", type=_bool, default=False,
                   help="bool, True if data contains metadata (unused, API parity)")
    p.add_argument("--latent_space_dim", type=int, default=32,
                   help="dimension of latent space")
    p.add_argument("--num_decoder_layers", type=int, default=2,
                   help="number of layers in decoder RNN")
    p.add_argument("--decoder_hidden_size", type=int, default=128,
                   help="hidden size of the decoder RNN")
    p.add_argument("--decoder_dropout_prob", type=float, default=0.5,
                   help="dropout prob between decoder RNN layers")
    p.add_argument("--decoder_type", default="hier", choices=("hier", "sr", "sr-no-input"),
                   help="decoder variant")
    p.add_argument("--batch_size", type=int, default=256, help="training batch size")
    p.add_argument("--num_epochs", type=int, default=30, help="number of training epochs")
    p.add_argument("--lr", type=float, default=1e-4, help="learning rate")
    p.add_argument("--beta", type=float, default=0.001, help="weight for the KLD loss")
    p.add_argument("--capacity", type=float, default=0.0, help="beta-VAE capacity")
    p.add_argument("--gamma", type=float, default=1.0, help="weight for the reg loss")
    p.add_argument("--delta", type=float, default=10.0, help="spread parameter")
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
                   help="attribute name(s) used for regularization, or `all`")
    add_switch(p, "--short", "--full", "short", False,
            "use the small synthetic corpus for quick runs")
    p.add_argument("--sampling", default="argmax", choices=("argmax", "multinomial"),
                   help="free-running feedback sampling in the decoder")
    add_switch(p, "--glsr", "--no_glsr", "use_glsr", False,
            "train with GLSR instead of the AR reg loss")
    add_switch(p, "--skip_cached", "--no_skip_cached", "skip_cached", False,
            "skip seeds whose run dir holds results stamped with this protocol")
    p.add_argument("--device", default="cuda",
                   help="torch device; `cpu` must be asked for explicitly")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return arg_parser().parse_args(argv)


def glsr_reg_type(reg_type: Sequence[str]) -> str:
    """The one attribute ``--glsr`` regularises, by the root CLI's rules:
    a single name with a surrogate; ``-r all`` or none means
    ``rhy_complexity``."""
    if reg_type and reg_type[0] != "all" and (len(reg_type) > 1
                                              or reg_type[0] not in GLSR_SUPPORTED):
        raise ValueError("--glsr takes a single reg type with a differentiable "
                         f"surrogate: {sorted(GLSR_SUPPORTED)}")
    if reg_type and reg_type[0] == "all" and len(reg_type) > 1:
        raise ValueError("--glsr: pass either -r all or a single supported reg type, "
                         "not both")
    if not reg_type or reg_type[0] == "all":
        print("--glsr regularizes one attribute; defaulting to rhy_complexity")
        return "rhy_complexity"
    return reg_type[0]


def device_of(args: argparse.Namespace) -> torch.device:
    """``--device``; a CUDA device without a card raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    return device


def dataset_of(args: argparse.Namespace):
    """The corpus of ``-d`` and ``--short``, finalized: building it can
    grow the vocabulary past a cached dict file, so it comes before the
    model is sized."""
    cls = FolkNBarDataset if args.dataset_type == "folk" else ChoraleNBarDataset
    dataset = cls(dataset_type="train", is_short=args.short, num_bars=1)
    dataset.get_dataset()
    return dataset


def reg_settings(args: argparse.Namespace) -> Tuple[Tuple[str, ...], Tuple[int, ...],
                                                     Optional[str]]:
    """(reg_type, reg_dim, the attribute --glsr regularises or None) of ``-r``."""
    reg_type = tuple(args.reg_type or ())
    if reg_type:
        unknown = [r for r in reg_type if r != "all" and r not in MUSIC_REG_TYPE]
        if unknown or ("all" in reg_type and len(reg_type) != 1):
            raise ValueError(
                f"unknown reg_type {unknown or list(reg_type)}; choose from "
                f"{sorted(MUSIC_REG_TYPE)} or 'all' (alone)")
        reg_dim = expand_reg_dims(reg_type, MUSIC_REG_TYPE)
    else:
        reg_dim = (0,)
    return reg_type, reg_dim, glsr_reg_type(reg_type) if args.use_glsr else None


def model_of(args: argparse.Namespace, dataset, seed: int) -> MeasureVAE:
    return MeasureVAE(
        num_notes=len(dataset.note2index_dicts),
        note_embedding_dim=args.note_embedding_dim,
        num_encoder_layers=args.num_encoder_layers,
        encoder_hidden_size=args.encoder_hidden_size,
        encoder_dropout_prob=args.encoder_dropout_prob,
        latent_space_dim=args.latent_space_dim,
        num_decoder_layers=args.num_decoder_layers,
        decoder_hidden_size=args.decoder_hidden_size,
        decoder_dropout_prob=args.decoder_dropout_prob,
        decoder_type=args.decoder_type,
        sampling=args.sampling,
        seed=seed,
    )


def trainer_of(args: argparse.Namespace, dataset, device: torch.device, seed: int,
               settings, ctx: Optional[DataContext] = None) -> MeasureVAETrainer:
    """The trainer of one seed, its model freshly initialised, over the
    data axis ``ctx`` (``init_data_parallel``'s by default)."""
    reg_type, reg_dim, glsr_type = settings
    model = model_of(args, dataset, seed)
    if glsr_type is not None:
        return MeasureVAETrainerGLSR(
            dataset=dataset,
            model=model,
            device=device,
            lr=args.lr,
            reg_type=GLSR_SUPPORTED[glsr_type],
            reg_dim=MUSIC_REG_TYPE[glsr_type],
            beta=args.beta,
            gamma=args.gamma,
            rand=seed,
            ctx=ctx,
        )
    return MeasureVAETrainer(
        dataset=dataset,
        model=model,
        device=device,
        lr=args.lr,
        reg_type=reg_type,
        reg_dim=reg_dim,
        beta=args.beta,
        capacity=args.capacity,
        gamma=args.gamma,
        delta=args.delta,
        rand=seed,
        ctx=ctx,
    )


def main(argv: Optional[Sequence[str]] = None) -> List[MeasureVAETrainer]:
    """Runs the CLI; returns the trainers, one per seed not skipped."""
    args = parse_args(argv)
    ctx = init_data_parallel(device_of(args))
    try:
        return _train(args, ctx)
    finally:
        ctx.close()


def _train(args: argparse.Namespace, ctx: DataContext) -> List[MeasureVAETrainer]:
    dataset = ctx.main_first(lambda: dataset_of(args))
    settings = reg_settings(args)

    seeds = range(0, 10) if args.rand is None else [args.rand]
    trainers = []
    for r in seeds:
        trainer = trainer_of(args, dataset, ctx.device, r, settings, ctx)
        trainer.say("run_dir:", trainer.run_dir)
        if (args.skip_cached and args.do_train
                and trainer.has_protocol_cache(args.num_epochs, args.batch_size)):
            trainer.say(f"skip seed {r}: protocol-stamped cache in {trainer.run_dir}")
            continue
        if args.resume:
            trainer.maybe_resume()
        if args.do_train:
            trainer.train_model(batch_size=args.batch_size, num_epochs=args.num_epochs)
        else:
            trainer.load_model()
        metrics = trainer.compute_eval_metrics()
        trainer.say(json.dumps(metrics, indent=2))
        if ctx.is_main:  # rank 0 writes the MIDI files alone, with no collective
            latent_codes, _, _ = trainer.compute_representations(num_batches=20)
            for attr in trainer.attr_dict:
                trainer.plot_latent_interpolations(latent_codes, attr_str=attr, num_points=5)
        ctx.barrier()  # the other ranks wait for it before the next seed or the end
        trainers.append(trainer)
    return trainers


if __name__ == "__main__":
    main()
