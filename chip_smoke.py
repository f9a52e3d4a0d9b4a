#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and the script
exits non-zero:

1. device: requires CUDA (never falls back to the CPU); prints the
   card's name and power limit and the two TF32 flags;
2. build: compiles ``arvae_tpu_torch/csrc/reg_loss.cu`` for sm_90a;
3. kernels: the AR-reg forward and backward kernels against their plain
   PyTorch versions on the card, at the shapes below, twice each, with
   bitwise-equal repeats required;
4. slice: the port's training CLI in-process (dSprites short grid,
   B=128, 2 epochs); the loss must be finite and fall, the reg kernels
   must have launched once per forward and once per backward, and the
   trained model's loss on one batch must match the CPU plain path;
5. times: kernel vs plain (CUDA events) at R=5, B=128, and warm train
   steps/s at B=128 on a 516,096-row random packed split.

The line before the last is the card's name and power limit as
``nvidia-smi`` prints them; the last line is a JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

R_TRAIN, B_TRAIN = 5, 128
KERNEL_CASES = [(5, 128), (5, 100), (3, 700), (2, 8192)]
DELTAS = (1.0, 10.0)
FWD_RTOL, BWD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
# At B=8192 each loss sums 67M pair terms in float32, in one order in
# the kernel (a sequential row per thread, then a fixed tree) and in
# another in torch's reduction; the rounding of such long sums reaches
# ~1e-5 relative, so the forward there is held to 1e-4.
FWD_RTOL_LARGE_B = 1e-4
# One eval step of the trained model on the card against the same step
# on the CPU (plain reg path): float32 convolutions and sums in another
# order, so 1e-4 relative.
SLICE_RTOL = 1e-4
SLICE_ARGS = ["-d", "dsprites", "--short", "--rand", "0", "-r", "all",
              "--beta", "1.0", "--gamma", "10", "--delta", "1",
              "--batch_size", "128", "--num_epochs", "2"]
BENCH_ROWS = 516_096


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    line = card()
    print(f"[device] {line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"TF32 defaults: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (the trainer sets both False)")
    return line


def phase_build():
    from arvae_tpu_torch.ops import reg_kernel

    path, seconds, log = reg_kernel.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {path} in {seconds:.2f} s; ptxas: {' | '.join(ptxas)}")


def _case_inputs(r, b, seed, dev):
    rng = np.random.RandomState(seed)
    z = torch.tensor(rng.randn(r, b), dtype=torch.float32, device=dev)
    # discrete labels: ties are common, as with dSprites factors
    a = torch.tensor(rng.randint(0, 4, (r, b)), dtype=torch.float32, device=dev)
    ct = torch.tensor(rng.randn(r), dtype=torch.float32, device=dev)
    return z, a, ct


def _check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_kernels():
    from arvae_tpu_torch.ops import reg_kernel as rk

    dev = torch.device("cuda")
    fwd_err = bwd_err = 0.0
    for r, b in KERNEL_CASES:
        for delta in DELTAS:
            z, a, ct = _case_inputs(r, b, r * 100_003 + b, dev)
            d = torch.tensor([delta], dtype=torch.float32, device=dev)
            runs = []
            for _ in range(2):
                f = rk.reg_loss_fwd_cuda(z, a, d)
                torch.cuda.synchronize()
                dz, dd = rk.reg_loss_bwd_cuda(z, a, d, ct)
                torch.cuda.synchronize()
                runs.append((f, dz, dd))
            for x, y in zip(runs[0], runs[1]):
                if not torch.equal(x, y):
                    raise AssertionError(f"(R={r}, B={b}, delta={delta}): "
                                         "repeat is not bitwise equal")
            f, dz, dd = runs[0]
            f_ref = rk.reg_loss_fwd_reference(z, a, d)
            dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, d, ct)
            tag = f"(R={r}, B={b}, delta={delta})"
            frtol = FWD_RTOL_LARGE_B if b > 1024 else FWD_RTOL
            fwd_err = max(fwd_err, _check_close(f"fwd {tag}", f, f_ref, frtol, ATOL))
            bwd_err = max(bwd_err,
                          _check_close(f"dz {tag}", dz, dz_ref, BWD_RTOL, ATOL),
                          _check_close(f"ddelta {tag}", dd.reshape(()), dd_ref,
                                       BWD_RTOL, ATOL))
            print(f"[kernels] {tag} fwd and bwd match the plain version, "
                  f"bitwise repeatable")

    # the autograd Function end to end: forward and backward kernels
    z, a, ct = _case_inputs(R_TRAIN, B_TRAIN, 7, dev)
    zg = z.clone().requires_grad_(True)
    dg = torch.tensor(1.0, device=dev, requires_grad=True)
    (rk.fused_reg_loss(zg, a.long(), dg) * ct).sum().backward()
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, torch.tensor([1.0], device=dev), ct)
    _check_close("autograd dz", zg.grad, dz_ref, BWD_RTOL, ATOL)
    _check_close("autograd ddelta", dg.grad, dd_ref, BWD_RTOL, ATOL)
    print(f"[kernels] autograd Function matches; fwd max abs err "
          f"{fwd_err:.3e}, bwd max abs err {bwd_err:.3e}")
    return fwd_err, bwd_err


def phase_slice():
    from arvae_tpu_torch import train_image_vae
    from arvae_tpu_torch.models.image_vae import draw_noise
    from arvae_tpu_torch.ops import reg_kernel as rk
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    with tempfile.TemporaryDirectory() as models_dir:
        os.environ["ARVAE_MODELS_DIR"] = models_dir
        rk.reset_launches()
        t0 = time.perf_counter()
        (trainer,) = train_image_vae.main(SLICE_ARGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES)
        ckpt_ok = os.path.isfile(os.path.join(trainer.run_dir, "ckpt.pt"))
    print(f"[slice] TF32 flags: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    hist = trainer.history
    losses = [h["train_loss"] for h in hist]
    if len(hist) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected 2 finite epochs, got {hist}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    if not ckpt_ok:
        raise AssertionError("no checkpoint written")
    n_train = sum(h["train_steps"] for h in hist)
    n_val = sum(h["val_steps"] for h in hist)
    if launches["bwd"] != n_train or launches["fwd"] != n_train + n_val:
        raise AssertionError(f"reg kernel launches {launches} != train "
                             f"{n_train} / train+val {n_train + n_val} steps")
    print(f"[slice] 2 epochs in {seconds:.1f} s; train loss "
          f"{losses[0]:.4f} -> {losses[1]:.4f}; val loss "
          f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f}; "
          f"reg launches fwd={launches['fwd']} bwd={launches['bwd']} "
          f"(train steps {n_train}, val steps {n_val})")

    # the trained model on one val batch: card (kernel) vs CPU (plain)
    _, val = trainer.dataset.device_splits(trainer.device)
    batch = val.gather_batch(torch.arange(B_TRAIN, device=trainer.device))
    noise = draw_noise(B_TRAIN, trainer.model.z_dim,
                       torch.Generator(trainer.device).manual_seed(1),
                       trainer.device)
    cpu = ImageVAETrainer(trainer.dataset, type(trainer.model)(), "cpu",
                          reg_type=("all",), reg_dim=trainer.hparams.reg_dim,
                          beta=1.0, gamma=10.0, delta=1.0, rand=0)
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    got = trainer.eval_step(batch, noise)
    want = cpu.eval_step(tuple(t.cpu() for t in batch), tuple(t.cpu() for t in noise))
    for k in ("loss", "recons_loss", "dist_loss", "reg_loss"):
        _check_close(f"slice {k}", got[k].cpu(), want[k], SLICE_RTOL, ATOL)
    print(f"[slice] trained model, one batch, card vs CPU plain path: loss "
          f"{float(got['loss']):.6f} vs {float(want['loss']):.6f}, reg "
          f"{float(got['reg_loss']):.6f} vs {float(want['reg_loss']):.6f}")
    return launches


def _event_ms(fn, iters=1000, warmup=50):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(card_line):
    from arvae_tpu_torch.data.device_data import DeviceEpochRunner, DeviceSplit
    from arvae_tpu_torch.models.image_vae import DspritesVAE
    from arvae_tpu_torch.ops import reg_kernel as rk
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    dev = torch.device("cuda")
    z, a, ct = _case_inputs(R_TRAIN, B_TRAIN, 11, dev)
    d = torch.tensor([1.0], dtype=torch.float32, device=dev)
    times = {
        "fwd": _event_ms(lambda: rk.reg_loss_fwd_cuda(z, a, d)),
        "fwd_plain": _event_ms(lambda: rk.reg_loss_fwd_reference(z, a, d)),
        "bwd": _event_ms(lambda: rk.reg_loss_bwd_cuda(z, a, d, ct)),
        "bwd_plain": _event_ms(lambda: rk.reg_loss_bwd_reference(z, a, d, ct)),
    }
    print(f"[times] reg kernel at R={R_TRAIN}, B={B_TRAIN} (ms per call, CUDA "
          f"events over 1000 calls): fwd {times['fwd']:.5f} vs plain "
          f"{times['fwd_plain']:.5f}; bwd {times['bwd']:.5f} vs plain "
          f"{times['bwd_plain']:.5f} | {card_line}")

    rng = np.random.RandomState(0)
    packed = rng.randint(0, 256, (BENCH_ROWS, 512)).astype(np.uint8)
    labels = rng.rand(BENCH_ROWS, 6).astype(np.float32)
    split = DeviceSplit(packed, labels, (1, 64, 64), "packed", dev)
    trainer = ImageVAETrainer(None, DspritesVAE(seed=0), dev,
                              reg_type=("all",), reg_dim=(1, 2, 3, 4, 5),
                              beta=1.0, gamma=10.0, delta=1.0, rand=0)
    runner = DeviceEpochRunner(split, split, B_TRAIN, trainer.train_step,
                               trainer.eval_step, trainer.perm_generator)
    warm = torch.arange(B_TRAIN, device=dev)
    for _ in range(50):
        trainer.train_step(split.gather_batch(warm))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals, steps = runner.train_epoch()
    loss = float(totals["loss"]) / steps
    seconds = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise AssertionError(f"bench epoch loss {loss}")
    rate = steps / seconds
    print(f"[times] warm train steps/s at B={B_TRAIN}: {rate:.1f} "
          f"({steps} steps in {seconds:.3f} s, {1e3 * seconds / steps:.4f} ms/step, "
          f"{BENCH_ROWS}-row random packed split) | {card_line}")
    return times


def main() -> int:
    card_line = phase_device()
    phase_build()
    fwd_err, bwd_err = phase_kernels()
    launches = phase_slice()
    times = phase_times(card_line)
    src = "arvae_tpu_torch/csrc/reg_loss.cu"
    print(json.dumps({"kernels": [
        {"name": "reg_loss_fwd", "route": "cuda", "source": src,
         "replaces": "arvae_tpu/ops/reg_pallas.py:83",
         "launches": launches["fwd"], "max_abs_err": fwd_err,
         "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "reg_loss_bwd", "route": "cuda", "source": src,
         "replaces": "arvae_tpu/ops/reg_pallas.py:113",
         "launches": launches["bwd"], "max_abs_err": bwd_err,
         "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
