"""Rank bodies of the port's data-parallel tests, on the CPU over gloo.

Imported by the spawned rank processes, so it imports no ``jax`` and
nothing of the JAX package (tests/test_torch_parallel_*.py do, in the
parent). Each rank joins a gloo group through a ``file://`` store under
the test's directory (no ports to clash among pytest workers), with a
60 s timeout on every collective, runs a body and writes its results to
``<dir>/<body>_<rank>.pt``; :func:`run_ranks` starts the ranks by spawn
(never fork: JAX may have run in the parent), joins each within a limit
and kills what is left, so a hung rank fails its test instead of the
suite.

The step cases (:func:`run_case`) run three Adam steps of a trainer on
this rank's rows of three global batches, gathered from a row-sharded
``DeviceSplit`` of the case's rows, with the global draws; the same
function with ``ctx=None`` is the one-card run the ranks are held to.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

TIMEOUT_S = 60
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------


def _entry(rank: int, world: int, workdir: str, body: str, env: Dict[str, str]) -> None:
    os.environ.update(env)
    os.chdir(workdir)  # no folk_raw_data/ here: the corpus is the synthetic one
    torch.set_num_threads(1)
    from arvae_tpu_torch.parallel import init_data_parallel

    ctx = init_data_parallel("cpu", rank=rank, world_size=world,
                             init_method=f"file://{os.path.join(workdir, 'store')}",
                             timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = globals()[body](ctx, workdir)
        torch.save(out, os.path.join(workdir, f"{body}_{rank}.pt"))
    finally:
        ctx.close()


def run_ranks(world: int, body: str, workdir: str, limit_s: float = 240.0,
              env: Optional[Dict[str, str]] = None) -> list:
    """Runs ``body(ctx, workdir)`` on ``world`` spawned gloo ranks → each
    rank's result, in rank order. Raises if a rank fails or outlives
    ``limit_s``."""
    os.makedirs(workdir, exist_ok=True)
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_entry, args=(r, world, workdir, body, dict(env or {})))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=limit_s)
    try:
        for p in procs:
            p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        raise RuntimeError(f"{body}: ranks {hung} of {world} still ran after {limit_s} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{body}: rank exit codes {codes}")
    return [torch.load(os.path.join(workdir, f"{body}_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# The step cases
# ---------------------------------------------------------------------------


def _trainer(case: Dict[str, Any], ctx):
    from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
    from arvae_tpu_torch.models.image_fader import (DspritesFaderNetwork,
                                                   ImageFaderDiscriminator)
    from arvae_tpu_torch.models.image_vae import DspritesVAE
    from arvae_tpu_torch.models.measure_vae import MeasureVAE
    from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
    from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    kind, lr = case["kind"], case["lr"]
    if kind == "dsprites":
        model = DspritesVAE()
        model.load_state_dict(case["weights"])
        return ImageVAETrainer(None, model, CPU, lr=lr, reg_type=("all",),
                               reg_dim=case["reg_dim"], rand=0, ctx=ctx, **case["hyper"])
    if kind == "fader":
        model, disc = DspritesFaderNetwork(), ImageFaderDiscriminator(5, 10, dropout_rate=0.0)
        model.load_state_dict(case["weights"])
        disc.load_state_dict(case["disc_weights"])

        class DspritesDataset:  # the trainer tells the dataset by its class name
            pass

        return ImageFaderTrainer(DspritesDataset(), model, CPU, disc_model=disc, lr=lr,
                                 beta=1.0, rand=0, ctx=ctx)
    corpus = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
    corpus.get_dataset()
    model = MeasureVAE(**case["widths"])
    model.load_state_dict(case["weights"])
    if kind == "glsr":
        return MeasureVAETrainerGLSR(corpus, model, CPU, lr=lr, reg_type="rhy_complexity",
                                     reg_dim=0, rand=0, ctx=ctx)
    return MeasureVAETrainer(corpus, model, CPU, lr=lr, reg_type=("all",),
                             reg_dim=case["reg_dim"], rand=0, ctx=ctx, **case["hyper"])


def _noise(case: Dict[str, Any], step: int):
    """Step ``step``'s global draws: None (the trainer's generator) or the
    case's injected ones."""
    from arvae_tpu_torch.models.measure_vae import MeasureNoise
    from arvae_tpu_torch.training.glsr_trainer import GLSRNoise

    draws = case["noise"][step]
    if draws is None:
        return None
    draws = [np.array(x) for x in draws]  # writable copies
    if case["kind"] == "dsprites":
        return tuple(torch.from_numpy(x) for x in draws)
    eps, eps_prior, teacher, seed = (torch.from_numpy(x) for x in draws[:4])
    measure = MeasureNoise(eps, eps_prior, teacher, seed)
    return GLSRNoise(measure, torch.from_numpy(draws[4])) if case["kind"] == "glsr" else measure


def _split(case: Dict[str, Any], ctx):
    from arvae_tpu_torch.data.device_data import DeviceSplit

    if case["kind"] in ("dsprites", "fader"):
        return DeviceSplit(case["rows"], case["labels"], (1, 64, 64), "packed", CPU, ctx)
    return DeviceSplit(case["rows"], None, (24,), "tokens", CPU, ctx)


def run_case(case: Dict[str, Any], ctx=None) -> Dict[str, Any]:
    """Three Adam steps of the case's trainer, each on this rank's rows of
    one global batch (``case["idx"][i]``, gathered from a row-sharded
    split over a group) → each step's metrics, the first step's gradients
    (after the sum over the ranks), the parameters after the last step."""
    trainer = _trainer(case, ctx)
    split = _split(case, ctx)
    nets = {"model": trainer.model}
    if case["kind"] == "fader":
        nets["disc"] = trainer.disc
    metrics, grads = [], None
    for i, idx in enumerate(case["idx"]):
        idx = torch.from_numpy(idx)
        share = {"share": ctx.share(len(idx))} if ctx is not None else {}
        kw = {} if case["kind"] == "fader" else {"noise": _noise(case, i)}
        m = trainer.train_step(split.gather_batch(idx), **kw, **share)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {f"{n}.{k}": p.grad.clone() for n, net in nets.items()
                     for k, p in net.named_parameters()}
    trainer.check_draws()
    params = {f"{n}.{k}": v.clone() for n, net in nets.items()
              for k, v in net.state_dict().items()}
    return {"metrics": metrics, "grads": grads, "params": params, "step": trainer.step}


def steps_body(ctx, workdir: str) -> Dict[str, Any]:
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    return {name: run_case(case, ctx) for name, case in cases.items()
            if ctx.n_data in case["worlds"]}


def loss_terms_body(ctx, workdir: str) -> Dict[str, Any]:
    """The AR term's and the capacity KLD's gradients on this rank's rows,
    through the port's gather and through a gather whose backward sums
    over the ranks (``torch.distributed.nn.functional.all_gather``)."""
    import torch.distributed.nn.functional as dnf

    from arvae_tpu_torch.ops.losses import kld_loss, total_reg_loss

    data = torch.load(os.path.join(workdir, "terms.pt"), weights_only=False)
    share = ctx.share(data["z"].shape[0])
    out = {"start": share.start, "stop": share.stop}
    z = share.take(data["z"]).clone().requires_grad_(True)
    labels = share.take(data["labels"])
    reg = total_reg_loss(z, labels, data["dims"], 10.0, 1.0, share)
    reg.backward()
    out["reg"], out["reg_grad"] = float(reg), z.grad.clone()
    # the all-gather that sums in its backward, then each rank's sum
    z2 = share.take(data["z"]).clone().requires_grad_(True)
    gathered = torch.cat(dnf.all_gather(z2, group=ctx.group))[:share.total]
    total_reg_loss(gathered, share.gather_constant(labels), data["dims"], 10.0, 1.0
                   ).backward()
    out["reg_grad_summed_gather"] = z2.grad.clone()
    mu = share.take(data["mu"]).clone().requires_grad_(True)
    log_s = share.take(data["log_s"])
    kld = kld_loss(mu, log_s, 1.0, data["capacity"], share)
    kld.backward()
    out["kld"], out["kld_grad"] = float(kld), mu.grad.clone()
    # each rank's own |KLD − c| over its rows
    out["kld_own"] = float(kld_loss(share.take(data["mu"]), log_s, 1.0, data["capacity"]))
    return out


def gather_body(ctx, workdir: str) -> Dict[str, Any]:
    """This rank's batches from the row-sharded split of each kind and,
    as the reference, this rank's rows of one process's whole-split
    gather; ``masked_mean`` over padded shards."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.parallel import masked_mean, shard_batch_padded

    data = torch.load(os.path.join(workdir, "gather.pt"), weights_only=False)
    out: Dict[str, Any] = {}
    for kind, (rows, labels, shape) in data["splits"].items():
        sharded = DeviceSplit(rows, labels, shape, kind, CPU, ctx)
        whole = DeviceSplit(rows, labels, shape, kind, CPU)
        batches = []
        for i in data["idx"]:
            idx, share = torch.from_numpy(i), ctx.share(len(i))
            batches.append((tuple(sharded.gather_batch(idx)),
                            tuple(share.take(x) for x in whole.gather_batch(idx)),
                            share.start, share.stop))
        out[kind] = {"local_rows": sharded.images.shape[0], "row_sharded": sharded.row_sharded,
                     "batches": batches}
    values = data["values"]
    (v,), mask = shard_batch_padded(ctx, (values,))
    out["masked_mean"] = float(masked_mean(v, mask, ctx))
    return out


if __name__ == "__main__":
    sys.exit("a module of rank bodies for tests/test_torch_parallel_*.py")


def music_cli_body(ctx, workdir: str) -> Dict[str, Any]:
    """The music CLI (``music_cli.json``'s flags, one seed) on this rank,
    in the group the harness made, with the MIDI tail's calls counted."""
    import json

    from arvae_tpu_torch import train_measure_vae
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    with open(os.path.join(workdir, "music_cli.json")) as fh:
        argv = json.load(fh)
    calls = []
    plot = MeasureVAETrainer.plot_latent_interpolations

    def counted(self, latent_codes, attr_str, num_points=10):
        calls.append(attr_str)
        return plot(self, latent_codes, attr_str, num_points)

    MeasureVAETrainer.plot_latent_interpolations = counted
    (trainer,) = train_measure_vae.main(argv)
    return {"calls": calls, "run_dir": trainer.run_dir, "metrics": trainer.metrics}
