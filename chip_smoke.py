#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds; any failure raises
and the script exits non-zero:

1. device: requires CUDA (never falls back to the CPU); prints the
   card's name and power limit and the two TF32 flags;
2. build: compiles the three CUDA sources in ``arvae_tpu_torch/csrc/``
   for sm_90a, one ``nvcc`` each, all started together, and prints
   ptxas's registers and spills for every kernel;
3. kernels: every kernel against its plain PyTorch version on the card,
   twice each with bitwise-equal repeats required: the AR-reg forward
   (losses and gradient factors in one launch, and the losses alone,
   which must be bitwise equal) and backward (one launch) at both
   slices' shapes and ragged and large batches, then its in-place entry
   on (B, Z) latents and (B, L) labels at both slices' shapes, with a
   latent column named twice on a strided view, and with int64 labels;
   the reg cluster plans against the clusters the card holds at once;
   ``gru_chain`` forward and backward at the music slice's shapes, a
   ragged batch, a second hidden width (H=64), SRDecoderNoInput's
   (24, 1, 256, 128), and the reference's widths, whose weight slices
   the kernels stream from L2 (``WIDE_GRU_CASES``: H=512 and 384);
   ``hier_tick_chain`` forward and backward at V=34 (the music CLI's
   corpus) and V=130 (the step-rate cell), teacher-forced, free-running
   (teacher trick), training with dropout 0.5 (the case matches only if
   the masks are bitwise equal to the plain version's) and multinomial
   (in distribution), then teacher-forced at a ragged B=100, with one
   beat of T ticks and with 5 ticks a beat (a padded last beat), in eval
   mode (``train=False``, as GLSR's decodes run it) at 6 and 24 ticks a
   beat, where a dropout rate must change nothing, and two argmax edges
   (a tie across two CTAs' vocabulary slices, a NaN logit); then at the
   widths and depths of ``WIDE_DEEP_HIER`` (H=256 and 512 with 2
   layers, H=128 with 1, 3 and 4): teacher-forced, free-running with
   dropout 0.5 (every gap's mask bitwise), eval, and the SR decoder's
   one beat of 24 ticks; every plan is printed with the clusters the
   card holds at once beside the count the plan assumes;
4. slice 1: the dSprites training CLI in-process (short grid, B=128, 2
   epochs), twice: the loss must be finite and fall, the reg kernels
   must have launched once per forward and once per backward, the two
   runs must give the same val losses to the last digit, one train step
   repeated from the same state must be bitwise equal (and the
   gradients that differ with cuDNN free to pick nondeterministic
   algorithms are printed), and the trained model's loss on one batch
   must match the CPU plain path;
5. slice 2: the music training CLI in-process (the ``--full`` synthetic
   folk corpus, B=256, H=128, latent 32, ``-r all``, 2 epochs): the loss
   must be finite and fall, a checkpoint must be written, every kernel
   of the path must have launched once per forward (``gru_chain`` four
   times) and once per backward, one train step run twice from the same
   parameters, Adam state and draws must give bitwise-equal gradients
   and parameters, and the trained model on one val batch,
   teacher-forced with injected draws, must match the CPU plain path;
6. slice 3: the music training CLI in-process with ``--decoder_type sr``,
   ``--decoder_type sr-no-input`` (both ``-r all``) and ``--glsr -r
   rhy_complexity``, each on the ``--full`` corpus for 2 epochs at the
   CLI's default width: the loss must be finite and fall, a checkpoint
   must be written, every kernel must have launched the counts a step
   the code gives (``VARIANT_LAUNCHES``), one train step run twice from
   the same state and draws must repeat bitwise; each variant's train
   step is timed and profiled, and then the model the CLI trained, on
   one val batch, teacher-forced, must match the CPU plain path (for
   GLSR also its term row by row within ``GLSR_ROW_RTOL``); the
   encoder's embedding gradient, as ``nn.Embedding`` and as the one-hot
   product the encoder uses, is run five times (the product must repeat
   bitwise);
7. times: each kernel against its plain version (CUDA events) at the
   slices' shapes and the new widths and depths, with each one's bound,
   and each reg direction's device time from ``torch.profiler`` (the
   events follow the host there), also at (R, B) = (2, 8192); the AR
   term's device launches a train and an eval step on both slices
   (profiler: one reg kernel each way, no stack, cast or scatter left);
   warm music train steps/s at B=256 on a 65,536-row random token
   corpus with V=130, then the music step's device busy time and
   largest kernels from ``torch.profiler`` over 50 steps; the tick loop
   backward's device time by kernel (profiler); the library yardstick
   for ``gru_chain``: each of the music step's four GRU layers as the
   port computes it and as cuDNN's ``torch.nn.GRU`` does (same weights,
   TF32 off, outputs held within rtol 1e-4), device time from the
   profiler, at H=128, at H=512 and SRDecoderNoInput's layer at H=384;
   warm dSprites train steps/s at B=128 over 1,000 steps and the
   dSprites step's device busy time, with cuDNN free to pick its
   algorithms and as the trainer sets it (deterministic). Each kernel's
   bound (``arvae_tpu_torch/utils/kernel_work.py``) and launches per
   step are printed beside its time;
8. slice 4: the music CLI at the reference's widths
   (``--encoder_hidden_size 512 --decoder_hidden_size 512``) and with
   ``--num_decoder_layers 3``, 2 epochs each on the ``--full`` corpus
   (``WIDE_DEEP_ARGS``): the loss finite and falling, every recurrence
   call of every step on a kernel (the launch counters), a train step
   repeated bitwise, its device busy time and largest kernels, and the
   trained model against the CPU on a val batch.

Launch counts are set to 0 just before each slice (and each variant of
slices 3 and 4) and read just after it; the comparisons of phase 3 do not
count. The line before the last
is the card's name and power limit as ``nvidia-smi`` prints them, the
one before it a JSON object listing every kernel; the last line is a
JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

LIBRARIES = ("reg_loss", "gru_chain", "hier_tick_chain")

R_TRAIN, B_TRAIN = 5, 128
# (R, B): the dSprites step's (5, 128), the music step's (4, 256), then
# ragged and large batches
KERNEL_CASES = [(5, 128), (4, 256), (5, 100), (3, 700), (2, 8192)]
DELTAS = (1.0, 10.0)
FWD_RTOL, BWD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
# At B=8192 each loss sums 67M pair terms in float32, in one order in
# the kernel (a sequential slice of a row per thread, then fixed trees)
# and in another in torch's reduction; the rounding of such long sums
# reaches ~1e-5 relative, so the forward there is held to 1e-4.
FWD_RTOL_LARGE_B = 1e-4
# The in-place entry (z_tilde shape, label columns, dims, label dtype,
# z_tilde a strided view): the dSprites step's (latents 1-5 of 10), the
# music step's (0-3 of 32), a latent column named twice on a strided
# view, and int64 labels (cast once by the wrapper)
REG_COLUMN_CASES = {
    "dSprites": ((B_TRAIN, 10), 6, tuple((c, c) for c in range(1, 6)), torch.float32, False),
    "music": ((256, 32), 4, tuple((c, c) for c in range(4)), torch.float32, False),
    "repeated dim, strided z_tilde": ((B_TRAIN, 10), 6, ((1, 1), (3, 2), (1, 4)),
                                      torch.float32, True),
    "int64 labels": ((B_TRAIN, 10), 6, tuple((c, c) for c in range(1, 6)), torch.int64,
                     False),
}

# The recurrence kernels: a chain of 24 dependent steps whose products
# sum in another order than cuBLAS's, so forward rtol 1e-4 with an
# absolute floor of 1e-5. Gradients rtol 1e-4 with an absolute floor of
# 1e-5 times the plain gradient's largest magnitude: weight gradients
# sum T·B terms with cancellation.
SEQ_FWD_RTOL, SEQ_FWD_ATOL = 1e-4, 1e-5
SEQ_GRAD_RTOL, SEQ_GRAD_ATOL_FRAC = 1e-4, 1e-5
# the encoder layer's and the beat GRU layer's shapes, SRDecoderNoInput's
# layer (one direction over 24 steps), a ragged batch, and a second hidden
# width (the cluster kernels split H over their CTAs)
GRU_CASES = [(24, 2, 256, 128), (4, 1, 256, 128), (24, 1, 256, 128), (24, 2, 100, 128),
             (24, 2, 256, 64), (4, 1, 256, 64)]
# the reference's own widths, whose w_hh slices the kernels stream from
# L2: the 512-wide encoder layer and beat GRU layer, SRDecoderNoInput's
# layer at H=384, and a ragged batch
WIDE_GRU_CASES = [(24, 2, 256, 512), (4, 1, 256, 512), (24, 1, 256, 384), (24, 2, 100, 512)]
# V=34 is the music CLI's synthetic folk corpus, V=130 the step-rate
# cell's vocabulary: V sets the kernels' shared-memory layout, the argmax
# loop and the output-layer and embedding weight-gradient GEMM tiles.
HIER_B, HIER_H, HIER_E, HIER_T, HIER_TPB = 256, 128, 10, 24, 6
HIER_VS = (34, 130)
# a ragged batch (not a multiple of any row tile), one beat of T ticks
# (the SR decoder's use), and 5 ticks a beat (T is no multiple of it: the
# backward's chains pad the last beat): the GEMMs' term indexing, the
# tick_h0 resets and the chain layout
HIER_RAGGED_B = 100
HIER_PADDED_TPB = 5
# (H, tick-GRU layers) beyond the music step's (128, 2): the widths the
# JAX package runs (256 fused on the TPU, 512 the reference's) and the
# depths its lax.scan runs
WIDE_DEEP_HIER = ((256, 2), (512, 2), (128, 1), (128, 3), (128, 4))

# One eval step of a trained model on the card against the same step on
# the CPU (plain paths): float32 products and sums in another order, so
# 1e-4 relative.
SLICE_RTOL = 1e-4
SLICE_ARGS = ["-d", "dsprites", "--short", "--rand", "0", "-r", "all",
              "--beta", "1.0", "--gamma", "10", "--delta", "1",
              "--batch_size", "128", "--num_epochs", "2"]
MUSIC_ARGS = ["--rand", "0", "-r", "all", "--num_epochs", "2"]
MUSIC_B = 256
BENCH_ROWS = 128_000  # 1,000 steps at B=128
MUSIC_BENCH_ROWS, MUSIC_BENCH_V = 65_536, 130


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
          f"{torch.backends.cudnn.allow_tf32} (the trainers set both False)")
    return line


def _kernel_name(mangled: str) -> str:
    """'hier_fwd<1, 2>' from an Itanium-mangled entry name: the last name
    of the nesting, and its template arguments where they are ints or
    bools."""
    rest, parts = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], []
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        n = len(digits) + int(digits)
        parts.append(rest[len(digits):n])
        rest = rest[n:]
    tmpl = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    args = re.findall(r"L[ib](\d+)E", tmpl.group(1)) if tmpl else []
    return (parts[-1] if parts else mangled) + (f"<{', '.join(args)}>" if args else "")


def _ptxas_summary(log: str) -> str:
    """'kernel: N regs, spill S/L B[, static smem M B]' for each entry nvcc
    compiled (the cluster kernels' shared memory is dynamic: their plans
    are printed by the kernels phase)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name}: {m.group(1)} regs, {spill}"
                       + (f", static smem {smem.group(1)} B" if smem else ""))
            name = None
    return "; ".join(out)


def phase_build():
    from arvae_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(_build.build, LIBRARIES))
    for name, (path, seconds, log) in zip(LIBRARIES, built):
        print(f"[build] {name}: {path} in {seconds:.2f} s; ptxas: {_ptxas_summary(log)}")
    print(f"[build] {len(LIBRARIES)} libraries, nvcc in parallel: "
          f"{time.perf_counter() - t0:.2f} s")


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


def _check_grad(name, got, want):
    atol = SEQ_GRAD_ATOL_FRAC * float(want.abs().max())
    return _check_close(name, got, want, SEQ_GRAD_RTOL, atol)


def _bits(x):
    """The tensor's bits, so that a NaN repeats equal to itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _check_repeat(tag, first, second):
    for x, y in zip(first, second):
        if not torch.equal(_bits(x), _bits(y)):
            raise AssertionError(f"{tag}: repeat is not bitwise equal")


def _reg_stacked_case(rk, r, b, delta, dev):
    """The kernels on stacked (R, B) columns, through their (B, R) views."""
    z, a, ct = _case_inputs(r, b, r * 100_003 + b, dev)
    d = torch.tensor([delta], dtype=torch.float32, device=dev)
    dims = tuple((i, i) for i in range(r))
    tag = f"reg (R={r}, B={b}, delta={delta})"
    runs = []
    for _ in range(2):
        loss, g, dd = rk.reg_fwd_cuda(z.t(), a.t(), dims, d)
        alone = rk.reg_fwd_cuda(z.t(), a.t(), dims, d, factors=False)[0]
        dz, ddelta = rk.reg_bwd_cuda(g, dd, ct, dims, r, col_major=True)
        torch.cuda.synchronize()
        runs.append((loss, alone, g, dd, dz.t(), ddelta.reshape(())))
    _check_repeat(tag, *runs)
    loss, alone, g, dd, dz, ddelta = runs[0]
    if not torch.equal(_bits(alone), _bits(loss)):
        raise AssertionError(f"{tag}: the forward without factors gives other losses")
    loss_ref, g_ref, d_ref = rk.reg_fwd_factors_reference(z, a, d)
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, d, ct)
    dz_scale, dd_scale = rk.reg_bwd_scale_reference(g, dd, ct)
    frtol = FWD_RTOL_LARGE_B if b > 1024 else FWD_RTOL
    fwd_err = _check_close(f"loss {tag}", loss, loss_ref, frtol, ATOL)
    bwd_err = max(_check_close(f"G {tag}", g, g_ref, BWD_RTOL, ATOL),
                  _check_close(f"D {tag}", dd, d_ref, BWD_RTOL, ATOL),
                  _check_close(f"dz {tag}", dz, dz_ref, BWD_RTOL, ATOL),
                  _check_close(f"ddelta {tag}", ddelta, dd_ref, BWD_RTOL, ATOL),
                  _check_close(f"dz vs scale {tag}", dz, dz_scale, BWD_RTOL, ATOL),
                  _check_close(f"ddelta vs scale {tag}", ddelta, dd_scale, BWD_RTOL, ATOL))
    print(f"[kernels] {tag}: loss, G, D (one forward launch), the loss without factors "
          f"(bitwise equal) and dz, ddelta (one backward launch) match the plain versions, "
          f"bitwise repeatable; plan {rk.reg_plan(r, b)}")
    return fwd_err, bwd_err


def _reg_column_case(rk, name, delta, dev):
    """The in-place entry on a (B, Z) z_tilde and (B, L) labels, forward
    and backward through the autograd Function, against the stacked
    plain path."""
    (b, zd), nl, dims, ldtype, strided = REG_COLUMN_CASES[name]
    rng = np.random.RandomState(b + zd + nl)
    wide = torch.tensor(rng.randn(b, 2 * zd), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(0, 4, (b, nl)), device=dev).to(ldtype)
    ct = torch.tensor(rng.randn(len(dims)), dtype=torch.float32, device=dev)
    d = torch.tensor(delta, device=dev)
    tag = f"reg in place, {name} (z_tilde {b}x{zd}, dims {dims}, delta={delta})"
    runs = []
    for _ in range(2):
        leaf = (wide if strided else wide[:, :zd].contiguous()).clone().requires_grad_(True)
        z = leaf[:, ::2] if strided else leaf
        losses = rk.reg_losses(z, labels, dims, d)
        (losses * ct).sum().backward()
        torch.cuda.synchronize()
        runs.append((losses.detach(), leaf.grad[:, ::2] if strided else leaf.grad))
    _check_repeat(tag, *runs)
    losses, dz = runs[0]
    z_cols, a_cols = rk.stack_columns(z.detach(), labels.float(), dims)
    dz_cols, _ = rk.reg_loss_bwd_reference(z_cols, a_cols, d, ct)
    fwd_err = _check_close(f"loss {tag}", losses, rk.reg_loss_fwd_reference(z_cols, a_cols, d),
                           FWD_RTOL, ATOL)
    bwd_err = _check_close(f"dz {tag}", dz, rk.scatter_columns(dz_cols, dims, zd),
                           BWD_RTOL, ATOL)
    print(f"[kernels] {tag}: matches the stacked plain path, bitwise repeatable")
    return fwd_err, bwd_err


def _reg_kernels(dev):
    from arvae_tpu_torch.ops import reg_kernel as rk

    errs = [_reg_stacked_case(rk, r, b, delta, dev)
            for r, b in KERNEL_CASES for delta in DELTAS]
    errs += [_reg_column_case(rk, name, delta, dev)
             for name in REG_COLUMN_CASES for delta in DELTAS]
    fwd_err, bwd_err = max(e[0] for e in errs), max(e[1] for e in errs)

    # the autograd Function end to end through the (R, B) entry
    z, a, ct = _case_inputs(R_TRAIN, B_TRAIN, 7, dev)
    zg = z.clone().requires_grad_(True)
    dg = torch.tensor(1.0, device=dev, requires_grad=True)
    (rk.fused_reg_loss(zg, a.long(), dg) * ct).sum().backward()
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, torch.tensor([1.0], device=dev), ct)
    _check_close("autograd dz", zg.grad, dz_ref, BWD_RTOL, ATOL)
    _check_close("autograd ddelta", dg.grad, dd_ref, BWD_RTOL, ATOL)
    for r, b in KERNEL_CASES:
        plan = rk.reg_plan(r, b)
        held = rk.resident_clusters(plan.clusters, plan.threads)
        if r > held:
            raise AssertionError(f"reg plan {plan}: the card holds only {held} clusters")
        print(f"[kernels] reg plan at R={r}, B={b}: {plan}, {plan.ctas} CTAs; the card holds "
              f"{held} such clusters at once")
    print(f"[kernels] reg autograd Function matches; fwd max abs err "
          f"{fwd_err:.3e}, bwd max abs err {bwd_err:.3e}")
    return fwd_err, bwd_err


def _gru_inputs(t, d, b, h, dev, seed):
    rng = np.random.RandomState(seed)

    def f(*shape, s):
        return torch.tensor(rng.randn(*shape) * s, dtype=torch.float32, device=dev)

    return (f(t, d, b, 3 * h, s=0.5), f(d, h, 3 * h, s=1 / np.sqrt(h)),
            f(d, 3 * h, s=0.1), f(d, b, h, s=0.3)), f(t, d, b, h, s=1.0)


def _plan_line(p, held, assumed):
    """A launch plan: its layout, clusters, shared memory, and the clusters
    the card holds at once beside the count the plan assumes."""
    return (f"{'streamed' if p.streamed else 'resident'}, clusters of {p.clusters} CTAs x "
            f"{p.rows} rows, {p.ctas} CTAs, {p.smem_bytes} B dynamic shared memory each; the "
            f"card holds {held} such clusters at once (the plan assumes {assumed})")


def _gru_kernels(dev):
    from arvae_tpu_torch.ops import gru_kernel as gk

    lib = gk._library()
    fwd_err = bwd_err = 0.0
    for t, d, b, h in GRU_CASES + WIDE_GRU_CASES:
        for backward in (False, True):
            p = gk.gru_plan(d, b, h, backward)
            held = lib.gru_chain_resident_clusters(int(backward), int(p.streamed), p.clusters,
                                                   p.smem_bytes)
            assumed = gk.held_clusters(p, "gru_bwd" if backward else "gru_fwd")
            print(f"[kernels] gru_chain {'bwd' if backward else 'fwd'} plan at (T={t}, D={d}, "
                  f"B={b}, H={h}): {_plan_line(p, held, assumed)}")
        args, ct = _gru_inputs(t, d, b, h, dev, seed=t * 1000 + b)
        runs = []
        for _ in range(2):
            outs = gk.gru_chain_fwd_cuda(*args)
            runs.append((outs,) + gk.gru_chain_bwd_cuda(*args, outs, ct))
        torch.cuda.synchronize()
        tag = f"gru_chain (T={t}, D={d}, B={b}, H={h})"
        _check_repeat(tag, *runs)
        leaves = [a.clone().requires_grad_(True) for a in args]
        want = gk.gru_chain_reference(*leaves)
        (want * ct).sum().backward()
        fwd_err = max(fwd_err, _check_close(f"outs {tag}", runs[0][0], want.detach(),
                                            SEQ_FWD_RTOL, SEQ_FWD_ATOL))
        for g, leaf, name in zip(runs[0][1:], leaves, ("dgi", "dw_hh", "db_hh", "dh0")):
            bwd_err = max(bwd_err, _check_grad(f"{name} {tag}", g, leaf.grad))
        print(f"[kernels] {tag} fwd and bwd match the plain version, bitwise repeatable")
    return fwd_err, bwd_err


def _hier_inputs(dev, seed, v, zero=False, b=HIER_B, tpb=HIER_TPB, h=HIER_H, layers=2):
    """(score (T, B), the float operands of an L-layer tick loop, a
    cotangent (T, B, V))."""
    rng = np.random.RandomState(seed)
    nb, e = -(-HIER_T // tpb), HIER_E

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(0 * x if zero else x, dtype=torch.float32, device=dev)

    floats = [w(nb, b, 3 * h, s=0.5), w(nb, layers, b, h, s=0.5), w(b, e, s=0.5),
              w(v, e, s=1.0), w(e, 3 * h), w(h, 3 * h), w(3 * h, s=0.1)]
    for _ in range(layers - 1):
        floats += [w(h, 3 * h), w(3 * h, s=0.1), w(h, 3 * h), w(3 * h, s=0.1)]
    floats += [w(h, v), w(v, s=0.1)]
    score = torch.tensor(rng.randint(0, v, (HIER_T, b)), dtype=torch.int32, device=dev)
    ct = torch.tensor(rng.randn(HIER_T, b, v), dtype=torch.float32, device=dev)
    return score, floats, ct


def _ints(teacher, seed, dev):
    return (torch.tensor([teacher], dtype=torch.int32, device=dev),
            torch.tensor([seed], dtype=torch.int32, device=dev))


def _hier_kernel_run(tag, cfg, teacher, seed, score, floats, ct=None):
    """Forward (and, with ``ct``, backward) kernels twice, bitwise.
    cfg: (train, dropout rate, sampling[, ticks per beat])."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    train, rate, sampling, tpb = (*cfg, HIER_TPB)[:4]
    runs = []
    for _ in range(2):
        weights, samples, *hiddens = hk.hier_tick_chain_fwd_cuda(
            train, rate, tpb, sampling, teacher, seed, score, *floats)
        grads = () if ct is None else hk.hier_tick_chain_bwd_cuda(
            train, rate, tpb, seed, samples, hiddens, weights, ct, *floats)
        runs.append((weights, samples) + tuple(grads))
    torch.cuda.synchronize()
    _check_repeat(tag, *runs)
    return runs[0]


def _hier_plain_run(cfg, teacher, seed, score, floats, ct=None):
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    train, rate, sampling, tpb = (*cfg, HIER_TPB)[:4]
    leaves = [f.clone().requires_grad_(ct is not None) for f in floats]
    weights, samples = hk.tick_chain_reference(train, rate, tpb, sampling, teacher, seed,
                                               score, *hk.chain_operands(leaves))
    if ct is None:
        return weights, samples
    (weights * ct).sum().backward()
    return (weights.detach(), samples) + tuple(x.grad for x in leaves)


def _hier_compare(tag, cfg, kernel_in, plain_in, floats, ct):
    """Kernel against plain: samples equal, weights and the 13 gradients
    within tolerance. A logit within rounding of the ReLU kink can fall
    on either side in the two versions and route a row's gradient
    differently, so the cotangent is zeroed where the two forwards
    disagree on a logit's sign (at most 1e-4 of the entries)."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    w_k = _hier_kernel_run(tag, cfg, *kernel_in, floats)[0]
    w_p = _hier_plain_run(cfg, *plain_in, floats)[0]
    agree = (w_k > 0) == (w_p > 0)
    flips = int((~agree).sum())
    if flips > 1e-4 * agree.numel():
        raise AssertionError(f"{tag}: {flips} logits change sign between kernel and plain")
    ct = ct * agree
    kernel = _hier_kernel_run(tag, cfg, *kernel_in, floats, ct)
    plain = _hier_plain_run(cfg, *plain_in, floats, ct)
    if not torch.equal(kernel[1], plain[1]):
        raise AssertionError(f"{tag}: samples differ from the plain version")
    fwd_err = _check_close(f"weights {tag}", kernel[0], plain[0], SEQ_FWD_RTOL, SEQ_FWD_ATOL)
    names = hk.float_operands(hk.layers_of(floats))
    bwd_err = max(_check_grad(f"d{name} {tag}", g, want)
                  for g, want, name in zip(kernel[2:], plain[2:], names))
    print(f"[kernels] {tag} fwd and bwd match the plain version, bitwise repeatable "
          f"({flips} ReLU-kink sign flips masked)")
    return kernel, fwd_err, bwd_err


def _hier_plans():
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    lib = hk._library()
    for v in HIER_VS:
        for b in (HIER_B, HIER_RAGGED_B):
            p = hk.hier_plan(b, HIER_H, HIER_E, v)
            held = lib.hier_tick_chain_resident_clusters(int(p.streamed), p.clusters,
                                                         p.smem_bytes)
            print(f"[kernels] hier_tick_chain fwd plan at (B={b}, H={HIER_H}, E={HIER_E}, "
                  f"V={v}): clusters of {p.clusters} CTAs x {p.rows} rows, {p.ctas} CTAs, "
                  f"{p.smem_bytes} B dynamic shared memory each; the card holds {held} such "
                  f"clusters at once (the plan assumes "
                  f"{hk.RESIDENT_CLUSTERS[p.clusters]})")
    for v in HIER_VS:
        fwd, bwd = hk.hier_plans(HIER_T, HIER_B, HIER_H, HIER_E, v, 2, HIER_T)
        print(f"[kernels] SRDecoder's tick loop (B={HIER_B}, H={HIER_H}, E={HIER_E}, V={v}, one "
              f"beat of {HIER_T} ticks): fwd plan {fwd}, bwd chain plan {bwd}")
    for tpb in (HIER_TPB, HIER_T, HIER_PADDED_TPB):
        p = hk.chain_plan(HIER_T, HIER_B, HIER_H, tpb)
        print(f"[kernels] hier_tick_chain bwd chain plan at (T={HIER_T}, B={HIER_B}, "
              f"H={HIER_H}, {tpb} ticks a beat, so {-(-HIER_T // tpb)} x {HIER_B} rows "
              f"a chain of {tpb} ticks): clusters of {p.clusters} CTAs x {p.rows} rows, {p.ctas} CTAs, "
              f"{p.smem_bytes} B dynamic shared memory each")


def _hier_wide_deep(dev, h, layers):
    """The tick loop at a width or depth beyond the music step's, V=130:
    training teacher-forced, training free-running with dropout 0.5 (the
    teacher trick on the kernel's own samples with the same seed, so it
    matches only with bitwise-equal masks at every gap), eval free-running
    (teacher trick), and the SR decoder's one beat of 24 ticks
    → [(fwd, bwd) max abs err]."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    v = HIER_VS[-1]
    lib = hk._library()
    p = hk.hier_plan(HIER_B, h, HIER_E, v, layers)
    held = lib.hier_tick_chain_resident_clusters(int(p.streamed), p.clusters, p.smem_bytes)
    print(f"[kernels] hier_tick_chain fwd plan at (B={HIER_B}, H={h}, L={layers}, E={HIER_E}, "
          f"V={v}): {_plan_line(p, held, hk.held_clusters(p))}; bwd chain plan "
          f"{hk.chain_plan(HIER_T, HIER_B, h, 6)}")
    shape = f"B={HIER_B}, H={h}, L={layers}, E={HIER_E}, V={v}, T={HIER_T}"
    errs = []
    score, floats, ct = _hier_inputs(dev, 30 + layers, v, h=h, layers=layers)
    forced = _ints(1, 3, dev) + (score,)
    errs.append(_hier_compare(f"hier_tick_chain train teacher-forced ({shape})",
                              (True, 0.0, "argmax"), forced, forced, floats, ct)[1:])
    seed = torch.tensor([123457], dtype=torch.int32, device=dev)
    free = (torch.zeros(1, dtype=torch.int32, device=dev), seed, score)
    w_free, s_free = _hier_kernel_run("hier sampled", (True, 0.5, "argmax"), *free, floats)[:2]
    if not torch.equal(s_free, hk.argmax_lowest(w_free).clamp(0, v - 1).to(torch.int32)):
        raise AssertionError(f"{shape}: free-running samples are not the argmax of their logits")
    errs.append(_hier_compare(
        f"hier_tick_chain train free-running, dropout 0.5, masks bitwise ({shape})",
        (True, 0.5, "argmax"), free, (torch.ones_like(free[0]), seed, s_free), floats, ct)[1:])
    free = _ints(0, 3, dev) + (score,)
    s_eval = _hier_kernel_run("hier eval", (False, 0.5, "argmax"), *free, floats)[1]
    errs.append(_hier_compare(f"hier_tick_chain eval, free-running, teacher trick ({shape})",
                              (False, 0.5, "argmax"), free, _ints(1, 3, dev) + (s_eval,),
                              floats, ct)[1:])
    score, floats, ct = _hier_inputs(dev, 40 + layers, v, h=h, layers=layers, tpb=HIER_T)
    forced = _ints(1, 3, dev) + (score,)
    errs.append(_hier_compare(f"hier_tick_chain SR one beat of {HIER_T} ticks ({shape})",
                              (True, 0.0, "argmax", HIER_T), forced, forced, floats, ct)[1:])
    return errs


def _hier_kernels(dev):
    _hier_plans()
    errs = [_hier_kernels_at(dev, v) for v in HIER_VS]
    for h, layers in WIDE_DEEP_HIER:
        errs += _hier_wide_deep(dev, h, layers)
    v = HIER_VS[-1]
    for b, tpb in ((HIER_RAGGED_B, HIER_TPB), (HIER_B, HIER_T), (HIER_B, HIER_PADDED_TPB)):
        score, floats, ct = _hier_inputs(dev, 5, v, b=b, tpb=tpb)
        forced = _ints(1, 3, dev) + (score,)
        shape = f"B={b}, H={HIER_H}, E={HIER_E}, V={v}, T={HIER_T}, {tpb} ticks a beat"
        _, *e = _hier_compare(f"hier_tick_chain teacher-forced ({shape})",
                              (True, 0.0, "argmax", tpb), forced, forced, floats, ct)
        errs.append(e)
    # eval mode (train=False: free-running argmax, no dropout), as GLSR
    # differentiates its decodes: the hierarchical decoder's and the SR
    # decoder's ticks a beat
    for v in HIER_VS:
        for tpb in (HIER_TPB, HIER_T):
            errs.append(_hier_eval_case(dev, v, tpb))
    _hier_argmax_edges(dev, v)
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _hier_eval_case(dev, v, tpb):
    """The kernels with ``train=False`` and a dropout rate of 0.5, which
    eval must ignore: bitwise equal to rate 0, samples the argmax of their
    own logits, and the plain version by the teacher trick."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    score, floats, ct = _hier_inputs(dev, 11, v, tpb=tpb)
    shape = f"B={HIER_B}, H={HIER_H}, E={HIER_E}, V={v}, T={HIER_T}, {tpb} ticks a beat"
    free = _ints(0, 3, dev) + (score,)
    kernel = _hier_kernel_run("hier eval", (False, 0.5, "argmax", tpb), *free, floats, ct)
    no_rate = _hier_kernel_run("hier eval", (False, 0.0, "argmax", tpb), *free, floats, ct)
    _check_repeat(f"hier eval, rate 0.5 vs 0 ({shape})", kernel, no_rate)
    w_k, s_k = kernel[:2]
    if not torch.equal(s_k, hk.argmax_lowest(w_k).clamp(0, v - 1).to(torch.int32)):
        raise AssertionError(f"hier eval ({shape}): samples are not the argmax of the logits")
    _, *e = _hier_compare(f"hier_tick_chain eval mode, free-running, teacher trick ({shape})",
                          (False, 0.5, "argmax", tpb), free, _ints(1, 3, dev) + (s_k,),
                          floats, ct)
    print(f"[kernels] hier_tick_chain eval mode ({shape}): a dropout rate of 0.5 gives the "
          f"rate-0 launches bitwise; max abs err fwd {e[0]:.3e}, bwd {e[1]:.3e}")
    return e


def _hier_argmax_edges(dev, v):
    """Free-running argmax on flat logits (zero weights, so every row's
    logits are out_b): a tie across two CTAs' vocabulary slices takes the
    lower index, and a NaN logit gives V, clamped to V-1."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    edge = -(-v // hk.hier_plan(HIER_B, HIER_H, HIER_E, v).clusters)  # CTA 1's first column
    cfg = (True, 0.0, "argmax")
    free = _ints(0, 3, dev)
    for tag, peaks, nan, want in (("tie across CTAs", (edge - 1, edge), None, edge - 1),
                                  ("NaN logit", (3,), 7, v - 1)):
        score, floats, _ = _hier_inputs(dev, 10, v, zero=True)
        for col in peaks:
            floats[-1][col] = 5.0
        if nan is not None:
            floats[-1][nan] = float("nan")
        w_k, s_k = _hier_kernel_run(f"hier {tag}", cfg, *free, score, floats)[:2]
        w_p, s_p = _hier_plain_run(cfg, *free, score, floats)
        if not (bool((s_k == want).all()) and torch.equal(s_k, s_p)):
            raise AssertionError(f"hier_tick_chain {tag}: samples {s_k.unique().tolist()}, "
                                 f"want {want} everywhere, as the plain version")
        torch.testing.assert_close(w_k, w_p, rtol=SEQ_FWD_RTOL, atol=SEQ_FWD_ATOL,
                                   equal_nan=True)
        print(f"[kernels] hier_tick_chain {tag} (V={v}, out_b peaks at {list(peaks)}"
              f"{f', NaN at {nan}' if nan is not None else ''}): every sample is {want}, "
              f"as the plain version")


def _hier_kernels_at(dev, v):
    """The four cases at vocabulary size v → (fwd, bwd) max abs err."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk

    errs = []
    shape = f"B={HIER_B}, H={HIER_H}, E={HIER_E}, V={v}, T={HIER_T}"
    score, floats, ct = _hier_inputs(dev, 1, v)
    forced = _ints(1, 3, dev) + (score,)
    kernel, *e = _hier_compare(f"hier_tick_chain teacher-forced ({shape})",
                               (True, 0.0, "argmax"), forced, forced, floats, ct)
    errs.append(e)
    if not torch.equal(kernel[1], score):
        raise AssertionError("teacher-forced samples are not the score")

    score, floats, ct = _hier_inputs(dev, 2, v)
    free = _ints(0, 3, dev) + (score,)
    w_free, s_free = _hier_kernel_run("hier free-running", (True, 0.0, "argmax"),
                                      *free, floats)[:2]
    if not torch.equal(s_free, hk.argmax_lowest(w_free).clamp(0, v - 1).to(torch.int32)):
        raise AssertionError("free-running samples are not the argmax of their logits")
    _, *e = _hier_compare(f"hier_tick_chain free-running, teacher trick ({shape})",
                          (True, 0.0, "argmax"), free, _ints(1, 3, dev) + (s_free,),
                          floats, ct)
    errs.append(e)

    # The masks are bitwise equal if this case matches: a keep bit that
    # differs moves a layer-1 input by 2·h0, far outside the tolerance.
    seed = torch.tensor([123457], dtype=torch.int32, device=dev)
    score, floats, ct = _hier_inputs(dev, 4, v)
    forced = (torch.ones(1, dtype=torch.int32, device=dev), seed, score)
    _, *e = _hier_compare(f"hier_tick_chain train, dropout 0.5, masks bitwise ({shape})",
                          (True, 0.5, "argmax"), forced, forced, floats, ct)
    errs.append(e)

    score, floats, _ = _hier_inputs(dev, 6, v, zero=True)
    free = _ints(0, 9, dev) + (score,)
    peak = v // 2
    floats[-1][peak] = 1e4  # peaked logits: Gumbel-max is the argmax
    s_peak = _hier_kernel_run("hier multinomial", (True, 0.0, "multinomial"),
                              *free, floats)[1]
    floats[-1].zero_()  # uniform logits: the samples spread over V
    s_flat = _hier_kernel_run("hier multinomial", (True, 0.0, "multinomial"),
                              *free, floats)[1]
    counts = torch.bincount(s_flat.flatten().long(), minlength=v)
    n = HIER_T * HIER_B
    if not (bool((s_peak == peak).all()) and int((counts > 0).sum()) == v
            and int(counts.max()) < 2 * n // v):
        raise AssertionError(f"multinomial out of distribution: counts {counts.tolist()}")
    print(f"[kernels] hier_tick_chain multinomial (V={v}): peaked logits sample the "
          f"peak; uniform logits use all {v} tokens over {n} draws, at most "
          f"{int(counts.max())} each ({n / v:.1f} expected)")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_kernels():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"reg": _reg_kernels(dev), "gru": _gru_kernels(dev), "hier": _hier_kernels(dev)}


def _launch_counters():
    from arvae_tpu_torch.ops import gru_kernel, hier_decoder_kernel, reg_kernel

    return {"reg": reg_kernel, "gru": gru_kernel, "hier": hier_decoder_kernel}


def _reset_launches():
    for mod in _launch_counters().values():
        mod.reset_launches()


def _read_launches():
    return {k: dict(mod.LAUNCHES) for k, mod in _launch_counters().items()}


def _check_history(tag, hist, ckpt_ok):
    losses = [h["train_loss"] for h in hist]
    if len(hist) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: expected 2 finite epochs, got {hist}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"{tag}: train loss did not fall: {losses}")
    if not ckpt_ok:
        raise AssertionError(f"{tag}: no checkpoint written")
    return sum(h["train_steps"] for h in hist), sum(h["val_steps"] for h in hist)


def _check_float_labels(tag, labels):
    """The AR term reads float32 labels in place; any other dtype would
    cost a cast a step."""
    if labels.dtype != torch.float32:
        raise AssertionError(f"{tag}: the trainer hands the AR term {labels.dtype} labels")
    print(f"[{tag}] the AR term's labels on the card: {tuple(labels.shape)} {labels.dtype}")


def _check_launches(tag, launches, want):
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != {want}")


def _image_cli_run():
    """The dSprites CLI, 2 epochs → (trainer, launches, seconds, checkpoint written)."""
    from arvae_tpu_torch import train_image_vae

    with tempfile.TemporaryDirectory() as models_dir:
        os.environ["ARVAE_MODELS_DIR"] = models_dir
        _reset_launches()
        t0 = time.perf_counter()
        (trainer,) = train_image_vae.main(SLICE_ARGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        ckpt_ok = os.path.isfile(os.path.join(trainer.run_dir, "ckpt.pt"))
    return trainer, launches, seconds, ckpt_ok


def _image_step_repeats(trainer):
    """One dSprites train step twice from the same state and draws, first
    with cuDNN free to pick nondeterministic algorithms (the parameters
    whose gradients differ are printed), then as the trainer sets it,
    ``torch.backends.cudnn.deterministic``, where every bit must repeat."""
    dev = trainer.device
    train_split, _ = trainer.dataset.device_splits(dev)
    batch = train_split.gather_batch(torch.arange(B_TRAIN, device=dev))
    chosen = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    differ = _step_repeats("slice 1 (dSprites), cuDNN free", trainer, batch, must=False)
    print(f"[repeat] slice 1 (dSprites) with torch.backends.cudnn.deterministic=False: "
          f"the gradients that differ between two runs: {differ or 'none this time'}")
    torch.backends.cudnn.deterministic = chosen
    if not chosen:
        raise AssertionError("the image trainer leaves cuDNN free to pick nondeterministic "
                             "algorithms")
    _step_repeats("slice 1 (dSprites), torch.backends.cudnn.deterministic=True", trainer, batch)


def phase_slice():
    from arvae_tpu_torch.models.image_vae import draw_noise
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    trainer, launches, seconds, ckpt_ok = _image_cli_run()
    print(f"[slice] TF32 flags: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; "
          f"torch.backends.cudnn.deterministic={torch.backends.cudnn.deterministic}")
    hist = trainer.history
    n_train, n_val = _check_history("slice", hist, ckpt_ok)
    _check_launches("slice", launches, {
        "reg": {"fwd": n_train + n_val, "bwd": n_train},
        "gru": {"fwd": 0, "bwd": 0}, "hier": {"fwd": 0, "bwd": 0}})
    print(f"[slice] 2 epochs in {seconds:.1f} s; train loss "
          f"{hist[0]['train_loss']:.4f} -> {hist[1]['train_loss']:.4f}; val loss "
          f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f}; "
          f"reg launches fwd={launches['reg']['fwd']} bwd={launches['reg']['bwd']} "
          f"(train steps {n_train}, val steps {n_val})")
    # a second run of the CLI in this call: the same trained model, so
    # the same val losses to the last bit
    again = _image_cli_run()[0].history
    if [h["val_loss"] for h in again] != [h["val_loss"] for h in hist]:
        raise AssertionError(f"slice 1: two runs of the CLI trained other models: val loss "
                             f"{[h['val_loss'] for h in hist]} vs {[h['val_loss'] for h in again]}")
    print(f"[repeat] slice 1 (dSprites): a second run of the CLI gives the trained val loss "
          f"{hist[-1]['val_loss']!r} again, to the last digit")
    _image_step_repeats(trainer)

    # the trained model on one val batch: card (kernel) vs CPU (plain)
    _, val = trainer.dataset.device_splits(trainer.device)
    batch = val.gather_batch(torch.arange(B_TRAIN, device=trainer.device))
    _check_float_labels("slice", batch[1])
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
    return launches, {"fwd": n_train + n_val, "bwd": n_train}


def _teacher_forced_metrics(trainer, batch, noise):
    """The trainer's loss and metrics in training mode (teacher-forced by
    ``noise``) with every dropout rate set to 0, without a step."""
    from arvae_tpu_torch.ops.gru import GRU

    model = trainer.model
    for m in model.modules():
        if isinstance(m, GRU):
            m.dropout = 0.0
    model.decoder.dropout = 0.0
    model.train()
    with torch.no_grad():
        return trainer._loss_fn(batch, noise)[1]


def _trainer_state(trainer):
    """A copy of the trainer's parameters, Adam state and step count."""
    return copy.deepcopy({"model": trainer.model.state_dict(),
                          "optimizer": trainer.optimizer.state_dict(), "step": trainer.step})


def _load_trainer_state(trainer, state):
    trainer.model.load_state_dict(state["model"])
    # a copy: Adam then updates its moments in place, and would update
    # the ones in ``state``
    trainer.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
    trainer.step = state["step"]


def _step_repeats(tag, trainer, batch, must=True):
    """One train step twice from the same parameters, Adam state and
    draws: the loss, every gradient and every updated parameter must be
    bitwise equal (with ``must``; else the names that differ are
    returned). Leaves the trainer as it found it."""
    from arvae_tpu_torch.models.image_vae import draw_noise
    from arvae_tpu_torch.models.measure_vae import draw_measure_noise
    from arvae_tpu_torch.training.glsr_trainer import GLSRNoise, MeasureVAETrainerGLSR
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    dev, b = trainer.device, batch[0].shape[0]
    state = _trainer_state(trainer)
    runs = []
    for _ in range(2):
        _load_trainer_state(trainer, state)
        gen = torch.Generator(dev).manual_seed(11)
        if isinstance(trainer, ImageVAETrainer):
            noise = draw_noise(b, trainer.model.z_dim, gen, dev)
        else:
            noise = draw_measure_noise(b, trainer.model.latent_space_dim, gen, dev)
        if isinstance(trainer, MeasureVAETrainerGLSR):
            noise = GLSRNoise(noise, torch.rand(b, generator=gen, device=dev))
        out = {"loss": trainer.train_step(batch, noise)["loss"]}
        for n, p in trainer.model.named_parameters():
            out[f"d{n}"] = p.grad.clone()
            out[n] = p.detach().clone()
        runs.append(out)
    _load_trainer_state(trainer, state)
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    if not must:
        return differ
    if differ:
        raise AssertionError(f"{tag}: one train step from the same state gave other bits "
                             f"in a second run: {differ}")
    print(f"[repeat] {tag}: one train step from the same parameters, Adam state and draws, "
          f"twice: the loss, all {(len(runs[0]) - 1) // 2} gradients and updated parameters "
          f"bitwise equal")


def _embedding_repeats(dev, num_notes):
    """The encoder's embedding at the music step's shape, (B, 24) ids into
    a (V, 10) table, backward five times under one cotangent, as
    nn.Embedding computes it and as the one-hot product the encoder uses:
    whether each gradient repeats bitwise. The one-hot product must."""
    rng = np.random.RandomState(13)
    ids = torch.tensor(rng.randint(0, num_notes, (MUSIC_B, HIER_T)), device=dev)
    table = torch.tensor(rng.randn(num_notes, HIER_E), dtype=torch.float32, device=dev)
    ct = torch.tensor(rng.randn(MUSIC_B, HIER_T, HIER_E), dtype=torch.float32, device=dev)
    forms = {"nn.Embedding": lambda w: torch.nn.functional.embedding(ids, w),
             "one-hot product": lambda w: torch.nn.functional.one_hot(ids, num_notes).float() @ w}
    repeats = {}
    for name, fn in forms.items():
        grads = []
        for _ in range(5):
            w = table.clone().requires_grad_(True)
            (fn(w) * ct).sum().backward()
            grads.append(w.grad)
        repeats[name] = all(torch.equal(g, grads[0]) for g in grads)
    if not repeats["one-hot product"]:
        raise AssertionError("the one-hot embedding's gradient does not repeat bitwise")
    print(f"[repeat] embedding gradient at (B={MUSIC_B}, T={HIER_T}, V={num_notes}, "
          f"E={HIER_E}), five backward runs bitwise equal: "
          + ", ".join(f"{n} {r}" for n, r in repeats.items()))


def phase_music_slice():
    from arvae_tpu_torch import train_measure_vae
    from arvae_tpu_torch.models.measure_vae import draw_measure_noise
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    with tempfile.TemporaryDirectory() as models_dir:
        os.environ["ARVAE_MODELS_DIR"] = models_dir
        _reset_launches()
        t0 = time.perf_counter()
        (trainer,) = train_measure_vae.main(MUSIC_ARGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        ckpt_ok = os.path.isfile(os.path.join(trainer.run_dir, "ckpt.pt"))
    hist = trainer.history
    n_train, n_val = _check_history("music slice", hist, ckpt_ok)
    _check_launches("music slice", launches, {
        "reg": {"fwd": n_train + n_val, "bwd": n_train},
        "gru": {"fwd": 4 * (n_train + n_val), "bwd": 4 * n_train},
        "hier": {"fwd": n_train + n_val, "bwd": n_train}})
    print(f"[music] 2 epochs in {seconds:.1f} s (corpus build included); train loss "
          f"{hist[0]['train_loss']:.4f} -> {hist[1]['train_loss']:.4f}; val loss "
          f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f}; train steps "
          f"{n_train}, val steps {n_val}; launches gru {launches['gru']} hier "
          f"{launches['hier']} reg {launches['reg']}")

    # the trained model on one val batch, teacher-forced with injected
    # draws: card (kernels) vs CPU (plain loops)
    dev = trainer.device
    train_split, val = trainer.dataset.device_splits(dev)
    _step_repeats("music", trainer, train_split.gather_batch(torch.arange(MUSIC_B, device=dev)))
    batch = val.gather_batch(torch.arange(MUSIC_B, device=dev))
    _check_float_labels("music", trainer.attrs.compute_labels(batch[0]))
    noise = draw_measure_noise(MUSIC_B, trainer.model.latent_space_dim,
                               torch.Generator(dev).manual_seed(1), dev)
    noise = noise._replace(teacher=torch.ones_like(noise.teacher), generator=None)
    cpu = MeasureVAETrainer(trainer.dataset, copy.deepcopy(trainer.model).cpu(), "cpu",
                            reg_type=("all",), reg_dim=trainer.hparams.reg_dim, rand=0)
    got = _teacher_forced_metrics(trainer, batch, noise)
    want = _teacher_forced_metrics(
        cpu, tuple(t.cpu() for t in batch),
        noise._replace(**{k: getattr(noise, k).cpu()
                          for k in ("eps", "eps_prior", "teacher", "seed")}))
    for k in ("loss", "recons_loss", "dist_loss", "reg_loss", "accuracy"):
        _check_close(f"music {k}", got[k].cpu(), want[k], SLICE_RTOL, ATOL)
    print(f"[music] trained model, one val batch teacher-forced, card vs CPU plain "
          f"path: loss {float(got['loss']):.6f} vs {float(want['loss']):.6f}, recons "
          f"{float(got['recons_loss']):.6f} vs {float(want['recons_loss']):.6f}, reg "
          f"{float(got['reg_loss']):.6f} vs {float(want['reg_loss']):.6f}")
    return launches, {"fwd": n_train + n_val, "bwd": n_train}


# Slice 3: the music CLI with each other decoder and with GLSR, at its
# default width (B=256, H=128, z=32, E=10, dropout 0.5, 2 layers) on the
# --full corpus: --short gives 6 train steps an epoch, too few for the
# epoch-mean loss to fall reliably.
VARIANT_ARGS = {
    "sr": ["--decoder_type", "sr", "-r", "all"],
    "sr-no-input": ["--decoder_type", "sr-no-input", "-r", "all"],
    "glsr": ["--glsr", "-r", "rhy_complexity"],
}
# Launches a train step of each variant, by the code: the encoder's two
# biGRU layers; SR's one tick loop of 24 ticks; SR-no-input's two GRU
# layers; GLSR's three hierarchical decodes (the training one and the two
# eval decodes of z ± δ), each a beat GRU of two layers and a tick loop,
# and no AR term. A val step launches the forward counts.
VARIANT_LAUNCHES = {"sr": {"gru": 2, "hier": 1, "reg": 1},
                    "sr-no-input": {"gru": 4, "hier": 0, "reg": 1},
                    "glsr": {"gru": 8, "hier": 3, "reg": 0}}
# The GLSR term, card against CPU, row by row: a finite difference of the
# two eval decodes over 2δ, δ = (1 + U)·1e-3, so the decodes' float32
# rounding (card kernels vs CPU loops, summed in other orders, ~1e-6) is
# multiplied by 250-500, and −log N(g | 100, 1) scales an error of g by
# |g − 100| ≈ 100; the term (~4,400 after training) keeps ~1e-6 of it.
# Measured on the card over five runs of 256 rows: 3.9e-7 to 6.5e-6 at
# most, medians 1e-7 to 7e-7.
GLSR_ROW_RTOL = 1e-4
# Rows whose z ± δ decodes take another token path on the card than on
# the CPU (an argmax within rounding of a tie) are left out of the GLSR
# comparison: at most 1% of the rows.
GLSR_PATH_FLIPS = 0.01
# The music CLI at the reference's own widths (SURVEY: a 2-layer biGRU(512)
# encoder; ROADMAP Queue B: a 512-wide decoder) and with a 3-layer tick GRU
WIDE_DEEP_ARGS = {
    "512-wide": ["--encoder_hidden_size", "512", "--decoder_hidden_size", "512"],
    "3-layer decoder": ["--num_decoder_layers", "3"],
}


def _variant_run(name):
    """The music CLI with one variant, 2 epochs → (trainer, launches)."""
    from arvae_tpu_torch import train_measure_vae

    with tempfile.TemporaryDirectory() as models_dir:
        os.environ["ARVAE_MODELS_DIR"] = models_dir
        _reset_launches()
        t0 = time.perf_counter()
        (trainer,) = train_measure_vae.main(["--rand", "0", "--num_epochs", "2"]
                                            + VARIANT_ARGS[name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        ckpt_ok = os.path.isfile(os.path.join(trainer.run_dir, "ckpt.pt"))
        run_dir = os.path.basename(trainer.run_dir)
    hist = trainer.history
    n_train, n_val = _check_history(f"variant {name}", hist, ckpt_ok)
    per_step = VARIANT_LAUNCHES[name]
    want = {k: {"fwd": n * (n_train + n_val), "bwd": n * n_train} for k, n in per_step.items()}
    _check_launches(f"variant {name}", launches, want)
    print(f"[variants] {name} ({run_dir}): 2 epochs in {seconds:.1f} s; train loss "
          f"{hist[0]['train_loss']:.4f} -> {hist[1]['train_loss']:.4f}; val loss "
          f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f}; train steps {n_train}, val "
          f"steps {n_val}; launches {launches}")
    return trainer, launches


def _variant_vs_cpu(name, trainer):
    """The trained model on one val batch, card against the CPU plain
    path, teacher-forced with every dropout rate 0; for GLSR also each
    row's GLSR term from the same latents and perturbations."""
    from arvae_tpu_torch.models.measure_vae import draw_measure_noise
    from arvae_tpu_torch.training.glsr_trainer import GLSRNoise, MeasureVAETrainerGLSR
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    dev = trainer.device
    _, val = trainer.dataset.device_splits(dev)
    batch = val.gather_batch(torch.arange(MUSIC_B, device=dev))
    gen = torch.Generator(dev).manual_seed(1)
    noise = draw_measure_noise(MUSIC_B, trainer.model.latent_space_dim, gen, dev)
    noise = noise._replace(teacher=torch.ones_like(noise.teacher), generator=None)
    cpu_noise = noise._replace(**{k: getattr(noise, k).cpu()
                                  for k in ("eps", "eps_prior", "teacher", "seed")})
    glsr = isinstance(trainer, MeasureVAETrainerGLSR)
    if glsr:
        u = torch.rand(MUSIC_B, generator=gen, device=dev)
        noise, cpu_noise = GLSRNoise(noise, u), GLSRNoise(cpu_noise, u.cpu())
    h = trainer.hparams
    model = copy.deepcopy(trainer.model).cpu()
    if glsr:
        cpu = MeasureVAETrainerGLSR(trainer.dataset, model, "cpu", lr=h.lr,
                                    reg_type=trainer.glsr_reg_type,
                                    reg_dim=trainer.glsr_reg_dim, gamma=h.gamma, beta=h.beta)
    else:
        cpu = MeasureVAETrainer(trainer.dataset, model, "cpu", lr=h.lr, reg_type=h.reg_type,
                                reg_dim=h.reg_dim, beta=h.beta, gamma=h.gamma,
                                capacity=h.capacity, delta=h.delta)
    got = _teacher_forced_metrics(trainer, batch, noise)
    want = _teacher_forced_metrics(cpu, tuple(t.cpu() for t in batch), cpu_noise)
    # GLSR's loss and reg_loss hold the GLSR term of each side's own
    # latents: it is compared below, row by row, from the same latents
    keys = ["recons_loss", "dist_loss", "accuracy"] + ([] if glsr else ["loss", "reg_loss"])
    for k in keys:
        _check_close(f"variant {name} {k}", got[k].cpu(), want[k], SLICE_RTOL, ATOL)
    line = (f"[variants] {name}: trained model, one val batch teacher-forced, card vs CPU "
            f"plain path: loss {float(got['loss']):.6f} vs {float(want['loss']):.6f}, recons "
            f"{float(got['recons_loss']):.6f} vs {float(want['recons_loss']):.6f}")
    if not glsr:
        print(line + f", reg {float(got['reg_loss']):.6f} vs {float(want['reg_loss']):.6f} "
              f"(rtol {SLICE_RTOL})")
        return
    with torch.no_grad():
        z = cpu.model.encoder(batch[0].cpu())[0]
        rows_k, sp_k, sm_k = trainer.glsr_rows(z.to(dev), noise)
        rows_p, sp_p, sm_p = cpu.glsr_rows(z, cpu_noise)
    same = ((sp_k.cpu() == sp_p) & (sm_k.cpu() == sm_p)).all(1)
    flips = int((~same).sum())
    if flips > GLSR_PATH_FLIPS * MUSIC_B:
        raise AssertionError(f"GLSR: {flips} rows decode another token path on the card")
    rel = ((rows_k.cpu() - rows_p).abs() / rows_p.abs())[same]
    if float(rel.max()) > GLSR_ROW_RTOL:
        raise AssertionError(f"GLSR rows: max rel err {float(rel.max()):.3e} > {GLSR_ROW_RTOL}")
    print(line + f"; the GLSR term by row ({MUSIC_B - flips} rows on the same token paths, "
          f"{flips} left out): max rel err {float(rel.max()):.3e}, median "
          f"{float(rel.median()):.3e} (rtol {GLSR_ROW_RTOL}); mean term "
          f"{float(rows_k.mean()):.4f} vs {float(rows_p.mean()):.4f}")


def _wide_deep_run(name, card_line):
    """The music CLI at a width or depth beyond its default, 2 epochs on
    the --full corpus: the loss finite and falling, every recurrence call
    of every step on a kernel (the launch counters), one train step
    repeated bitwise, and the trained model against the CPU on a val
    batch → (trainer, launches, device busy ms a train step)."""
    from arvae_tpu_torch import train_measure_vae

    flags = WIDE_DEEP_ARGS[name]
    with tempfile.TemporaryDirectory() as models_dir:
        os.environ["ARVAE_MODELS_DIR"] = models_dir
        _reset_launches()
        t0 = time.perf_counter()
        (trainer,) = train_measure_vae.main(MUSIC_ARGS + ["--full"] + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        ckpt_ok = os.path.isfile(os.path.join(trainer.run_dir, "ckpt.pt"))
    hist = trainer.history
    n_train, n_val = _check_history(f"music {name}", hist, ckpt_ok)
    model = trainer.model
    # the encoder's biGRU layers (one launch a layer, both directions)
    # and the beat GRU's layers; one tick loop; one AR term
    grus = model.encoder.lstm.num_layers + model.decoder.rnn_beat.num_layers
    per_step = {"gru": grus, "hier": 1, "reg": 1}
    want = {k: {"fwd": n * (n_train + n_val), "bwd": n * n_train} for k, n in per_step.items()}
    _check_launches(f"music {name}", launches, want)
    print(f"[wide] music CLI {' '.join(flags)} (H enc {model.encoder.lstm.hidden_size}, "
          f"dec {model.decoder.rnn_tick.hidden_size}, {model.decoder.rnn_tick.num_layers} "
          f"tick-GRU layers): 2 epochs in {seconds:.1f} s; train loss "
          f"{hist[0]['train_loss']:.4f} -> {hist[1]['train_loss']:.4f}; val loss "
          f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f}; launches a train step "
          f"gru {grus} fwd + {grus} bwd, hier 1 + 1, reg 1 + 1, every one a kernel "
          f"({launches} over {n_train} train and {n_val} val steps)")
    dev = trainer.device
    train_split, _ = trainer.dataset.device_splits(dev)
    _step_repeats(f"music {name}", trainer,
                  train_split.gather_batch(torch.arange(MUSIC_B, device=dev)))
    trained = _trainer_state(trainer)
    busy = _device_busy(f"music {name}", trainer, train_split, MUSIC_B, card_line)
    _load_trainer_state(trainer, trained)
    _variant_vs_cpu(name, trainer)
    return trainer, launches, busy


def phase_music_variants(card_line):
    """→ {variant: its launches}."""
    dev = torch.device("cuda")
    launches = {}
    for name in VARIANT_ARGS:
        trainer, launches[name] = _variant_run(name)
        train_split, _ = trainer.dataset.device_splits(dev)
        rows = train_split.gather_batch(torch.arange(MUSIC_B, device=dev))
        _step_repeats(f"variant {name}", trainer, rows)
        trained = _trainer_state(trainer)
        _device_busy(f"music {name}", trainer, train_split, MUSIC_B, card_line)
        # the timing trains on: the comparison is of the model the CLI
        # trained, and sets every dropout rate to 0, so it comes last
        _load_trainer_state(trainer, trained)
        _variant_vs_cpu(name, trainer)
    _embedding_repeats(dev, trainer.model.num_notes)
    return launches


def phase_wide_deep(card_line):
    """The music CLI at the reference's widths and with a 3-layer tick GRU
    → {run: (its launches, train steps, device busy ms a train step)}."""
    wide = {}
    for name in WIDE_DEEP_ARGS:
        trainer, counts, busy = _wide_deep_run(name, card_line)
        wide[name] = (counts, sum(h["train_steps"] for h in trainer.history), busy)
    return wide


def _event_ms(fn, iters, warmup=10):
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


def _kernel_times(dev, card_line):
    from arvae_tpu_torch.ops import gru_kernel as gk
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk
    from arvae_tpu_torch.ops import reg_kernel as rk
    from arvae_tpu_torch.utils import kernel_work as kw
    from arvae_tpu_torch.utils import step_probe

    times = {}
    for name, ((b, zd), nl, dims) in step_probe.AR_SHAPES.items():
        # the AR term's shapes on the step: z_tilde and labels read in place
        rng = np.random.RandomState(11)
        z = torch.tensor(rng.randn(b, zd), dtype=torch.float32, device=dev)
        labels = torch.tensor(rng.randint(0, 4, (b, nl)), dtype=torch.float32, device=dev)
        ct = torch.tensor(rng.randn(len(dims)), dtype=torch.float32, device=dev)
        d = torch.tensor(1.0, device=dev)
        _, g, dd = rk.reg_fwd_cuda(z, labels, dims, d)
        fns = {
            "fwd": lambda: rk.reg_fwd_cuda(z, labels, dims, d),
            "fwd_plain": lambda: rk.reg_fwd_factors_reference(
                *rk.stack_columns(z, labels, dims), d),
            "bwd": lambda: rk.reg_bwd_cuda(g, dd, ct, dims, zd),
            "bwd_plain": lambda: rk.scatter_columns(
                rk.reg_bwd_scale_reference(g, dd, ct)[0], dims, zd),
        }
        row = {k: _event_ms(fn, 1000, 50) for k, fn in fns.items()}
        for direction in ("fwd", "bwd"):
            # the kernel's own duration: one device kernel a call
            split = _kernel_split(fns[direction])
            if len(split) != 1 or split[0][1][0] != 1:
                raise AssertionError(f"reg {direction} at {name}: device kernels {split}")
            row[f"{direction}_events"] = row[direction]
            row[direction] = split[0][1][1] / 1e3
            row[f"{direction}_work"] = kw.reg_loss(len(dims), b, direction == "bwd", Z=zd)
        times.setdefault("reg", row)  # the dSprites step's shape goes into the JSON
        print(f"[times] reg at the {name} step's shape (R={len(dims)}, B={b}, z_tilde "
              f"{b}x{zd}), ms per call: fwd {row['fwd']:.5f} device (profiler), "
              f"{row['fwd_events']:.5f} CUDA events over 1000 calls, plain "
              f"{row['fwd_plain']:.5f}, bound {row['fwd_work'].bound_ms:.7f}; bwd "
              f"{row['bwd']:.5f} device, {row['bwd_events']:.5f} events, plain "
              f"{row['bwd_plain']:.5f}, bound {row['bwd_work'].bound_ms:.7f} | {card_line}")
    z, a, _ = _case_inputs(2, 8192, 11, dev)
    d = torch.tensor([1.0], device=dev)
    (name, (_, us)), = _kernel_split(lambda: rk.reg_fwd_cuda(z.t(), a.t(), ((0, 0), (1, 1)), d))
    print(f"[times] reg fwd with factors at (R, B) = (2, 8192), off the path: {us / 1e3:.5f} "
          f"ms device ({name}, plan {rk.reg_plan(2, 8192)}) | {card_line}")

    for t, dd, b, h in GRU_CASES + WIDE_GRU_CASES:
        args, ct = _gru_inputs(t, dd, b, h, dev, seed=17)
        outs = gk.gru_chain_fwd_cuda(*args)
        leaves = [x.clone().requires_grad_(True) for x in args]
        ref = gk.gru_chain_reference(*leaves)
        n = 200 if h <= 128 else 20  # the wide chains take milliseconds a call
        row = {
            "fwd": _event_ms(lambda: gk.gru_chain_fwd_cuda(*args), n),
            "fwd_plain": _event_ms(lambda: gk.gru_chain_reference(*args), 50),
            "bwd": _event_ms(lambda: gk.gru_chain_bwd_cuda(*args, outs, ct), n),
            "bwd_plain": _event_ms(
                lambda: torch.autograd.grad(ref, leaves, ct, retain_graph=True), 50),
        }
        times.setdefault("gru", row)  # the encoder's shape goes into the JSON
        if (t, dd, b, h) in WIDE_GRU_CASES:
            row["shape"] = (t, dd, b, h)
            row["fwd_work"], row["bwd_work"] = (kw.gru_chain(t, dd, b, h, backward=bwd)
                                                for bwd in (False, True))
            times.setdefault("gru_wide", []).append(row)
        print(f"[times] gru_chain at T={t}, D={dd}, B={b}, H={h} (ms per call): fwd "
              f"{row['fwd']:.5f} vs plain {row['fwd_plain']:.5f}, bound "
              f"{kw.gru_chain(t, dd, b, h).bound_ms:.5f}; bwd {row['bwd']:.5f} vs plain "
              f"(autograd through the loop) {row['bwd_plain']:.5f}, bound "
              f"{kw.gru_chain(t, dd, b, h, backward=True).bound_ms:.5f} | {card_line}")

    for h, layers in WIDE_DEEP_HIER:
        row = _hier_times(dev, h, layers)
        times.setdefault("hier_wide", []).append(row)
        print(f"[times] hier_tick_chain at B={HIER_B}, H={h}, L={layers}, E={HIER_E}, "
              f"V={MUSIC_BENCH_V}, T={HIER_T}, train with dropout 0.5, free-running (ms per "
              f"call): fwd {row['fwd']:.5f} vs plain {row['fwd_plain']:.5f}, bound "
              f"{row['fwd_work'].bound_ms:.5f}; bwd {row['bwd']:.5f} vs plain "
              f"{row['bwd_plain']:.5f}, bound {row['bwd_work'].bound_ms:.5f} | {card_line}")

    score, floats, ct = _hier_inputs(dev, 8, MUSIC_BENCH_V)
    teacher, seed = _ints(0, 5, dev)
    cfg = (True, 0.5, HIER_TPB, "argmax")
    weights, samples, h0_all, h1_all = hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score,
                                                                   *floats)
    leaves = [x.clone().requires_grad_(True) for x in floats]
    ref = hk.tick_chain_reference(*cfg, teacher, seed, score, *hk.chain_operands(leaves))[0]
    times["hier"] = {
        "fwd": _event_ms(lambda: hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score,
                                                             *floats), 200),
        "fwd_plain": _event_ms(lambda: hk.tick_chain_reference(
            *cfg, teacher, seed, score, *hk.chain_operands(floats)), 10, 2),
        "bwd": _event_ms(lambda: hk.hier_tick_chain_bwd_cuda(
            True, 0.5, HIER_TPB, seed, samples, (h0_all, h1_all), weights, ct, *floats), 100),
        "bwd_plain": _event_ms(
            lambda: torch.autograd.grad(ref, leaves, ct, retain_graph=True), 10, 2),
    }
    row = times["hier"]
    print(f"[times] hier_tick_chain at B={HIER_B}, H={HIER_H}, E={HIER_E}, V={MUSIC_BENCH_V}, "
          f"T={HIER_T}, train with dropout 0.5, free-running (ms per call): fwd "
          f"{row['fwd']:.5f} vs plain {row['fwd_plain']:.5f}; bwd {row['bwd']:.5f} vs "
          f"plain (autograd through the loop) {row['bwd_plain']:.5f} | {card_line}")
    split = _kernel_split(lambda: hk.hier_tick_chain_bwd_cuda(
        True, 0.5, HIER_TPB, seed, samples, (h0_all, h1_all), weights, ct, *floats))
    print("[times] hier_tick_chain bwd, device µs a call by kernel (profiler, 20 calls): "
          + "; ".join(f"{n} x{k:g} {us:.1f}" for n, (k, us) in split))
    return times


def _hier_times(dev, h, layers):
    """The tick loop's ms a call at B=256, V=130, 6 ticks a beat, training
    with dropout 0.5, free-running: kernels (CUDA events) and plain loop,
    with each direction's work."""
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk
    from arvae_tpu_torch.utils import kernel_work as kw

    score, floats, ct = _hier_inputs(dev, 8, MUSIC_BENCH_V, h=h, layers=layers)
    teacher, seed = _ints(0, 5, dev)
    cfg = (True, 0.5, HIER_TPB, "argmax")
    weights, samples, *hiddens = hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score,
                                                             *floats)
    leaves = [x.clone().requires_grad_(True) for x in floats]
    ref = hk.tick_chain_reference(*cfg, teacher, seed, score, *hk.chain_operands(leaves))[0]
    n = 100 if h <= 128 else 20
    shape = dict(T=HIER_T, B=HIER_B, H=h, E=HIER_E, V=MUSIC_BENCH_V, ticks_per_beat=HIER_TPB,
                 L=layers)
    return {
        "shape": (h, layers),
        "fwd": _event_ms(lambda: hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score,
                                                             *floats), n),
        "fwd_plain": _event_ms(lambda: hk.tick_chain_reference(
            *cfg, teacher, seed, score, *hk.chain_operands(floats)), 5, 1),
        "bwd": _event_ms(lambda: hk.hier_tick_chain_bwd_cuda(
            True, 0.5, HIER_TPB, seed, samples, hiddens, weights, ct, *floats), n),
        "bwd_plain": _event_ms(
            lambda: torch.autograd.grad(ref, leaves, ct, retain_graph=True), 5, 1),
        "fwd_work": kw.hier_tick_chain(**shape), "bwd_work": kw.hier_tick_chain(**shape,
                                                                               backward=True),
    }


def _kernel_split(fn, iters=20):
    """[(kernel, (launches a call, device µs a call))], largest first, from
    a profiled run whose records of the port's kernels match the launch
    counters (``step_probe.call_events``)."""
    from arvae_tpu_torch.utils.step_probe import call_events, short_name

    by_name = {}
    for e in call_events(fn, iters):
        k, us = by_name.get(short_name(e["name"]), (0, 0.0))
        by_name[short_name(e["name"])] = (k + 1, us + e["dur"])
    return sorted(((n, (k / iters, us / iters)) for n, (k, us) in by_name.items()),
                  key=lambda kv: -kv[1][1])


# The music step's four GRU layers (input width, T, bidirectional) at
# hidden width H: the encoder's two biGRU layers and the beat GRU's two
# layers, at B=256. Each is timed as the port computes it (cuBLAS input
# projection + gru_chain) and as cuDNN does (torch.nn.GRU, the library
# yardstick, which the port never calls), with the same weights and TF32
# off; at H=384 SRDecoderNoInput's layer (input width H, 24 steps).
def gru_layers(h):
    return (("encoder layer 0", 10, 24, True), ("encoder layer 1", 2 * h, 24, True),
            ("beat layer 0", 1, 4, False), ("beat layer 1", h, 4, False))


GRU_LAYERS = gru_layers(HIER_H)
SR_NO_INPUT_LAYER = (("sr-no-input layer", 384, 24, False),)


def _device_ms(fn, iters=20, warmup=5):
    """Device time per call: the union of the device intervals that
    ``torch.profiler`` records over ``iters`` calls. A call whose host
    work outlasts its device work (an autograd backward of many small
    launches) has gaps that CUDA events would count; this does not."""
    from arvae_tpu_torch.utils.step_probe import call_events, union_us

    for _ in range(warmup):
        fn()
    events = call_events(fn, iters)
    return union_us([(e["ts"], e["ts"] + e["dur"]) for e in events]) / 1e3 / iters


def _gru_layer_times(dev, card_line, h=HIER_H, layers=GRU_LAYERS):
    """{layer: {port_fwd, port_bwd, cudnn_fwd, cudnn_bwd}} at hidden width
    h: device ms per call (profiler), the forward with autograd
    recording, as in a train step, and the backward alone (the graph
    retained); the host-clock (CUDA event) ms per call beside them under
    ``*_wall``."""
    from arvae_tpu_torch.ops.gru import GRU

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(23)
    out = {}
    for tag, width, t, bidir in layers:
        port = GRU(width, h, 1, bidirectional=bidir)
        with torch.no_grad():
            for p in port.parameters():
                p.copy_(torch.tensor(rng.randn(*p.shape) / np.sqrt(h), dtype=torch.float32))
        port = port.to(dev)
        lib = torch.nn.GRU(width, h, 1, batch_first=True, bidirectional=bidir).to(dev)
        lib.load_state_dict(port.state_dict())
        lib.flatten_parameters()
        dirs = 2 if bidir else 1
        xs = torch.tensor(rng.randn(MUSIC_B, t, width), dtype=torch.float32, device=dev)
        h0 = torch.tensor(rng.randn(dirs, MUSIC_B, h) * 0.3, dtype=torch.float32, device=dev)
        ct = torch.tensor(rng.randn(MUSIC_B, t, dirs * h), dtype=torch.float32, device=dev)
        xs.requires_grad_(True)
        row = {}
        for name, mod in (("port", port), ("cudnn", lib)):
            leaves = [xs, *mod.parameters()]
            y = mod(xs, h0)[0]

            def fwd():
                return mod(xs, h0)

            def bwd():
                return torch.autograd.grad(y, leaves, ct, retain_graph=True)

            row[f"{name}_fwd"] = _device_ms(fwd)
            row[f"{name}_bwd"] = _device_ms(bwd)
            row[f"{name}_fwd_wall"] = _event_ms(fwd, 50)
            row[f"{name}_bwd_wall"] = _event_ms(bwd, 50)
            row[f"{name}_out"] = y.detach()
        _check_close(f"cuDNN vs port, {tag}", row.pop("cudnn_out"), row.pop("port_out"),
                     SEQ_FWD_RTOL, SEQ_FWD_ATOL)
        out[tag] = row
        print(f"[times] GRU {tag} (I={width}, T={t}, B={MUSIC_B}, H={h}, "
              f"{'bi' if bidir else 'uni'}directional), device ms per call: port fwd "
              f"{row['port_fwd']:.5f} bwd {row['port_bwd']:.5f}; cuDNN fwd "
              f"{row['cudnn_fwd']:.5f} bwd {row['cudnn_bwd']:.5f} (host clock: port "
              f"{row['port_fwd_wall']:.5f} / {row['port_bwd_wall']:.5f}, cuDNN "
              f"{row['cudnn_fwd_wall']:.5f} / {row['cudnn_bwd_wall']:.5f}); outputs agree "
              f"within rtol {SEQ_FWD_RTOL} | {card_line}")
    total = {k: sum(r[k] for r in out.values()) for k in next(iter(out.values()))}
    print(f"[times] GRU layers at H={h} ({', '.join(out)}), device ms summed: port fwd "
          f"{total['port_fwd']:.5f} bwd {total['port_bwd']:.5f}; cuDNN fwd "
          f"{total['cudnn_fwd']:.5f} bwd {total['cudnn_bwd']:.5f} | {card_line}")
    return out


def _steps_per_second(trainer, split, batch, tag, card_line):
    from arvae_tpu_torch.data.device_data import DeviceEpochRunner

    runner = DeviceEpochRunner(split, split, batch, trainer.train_step,
                               trainer.eval_step, trainer.perm_generator)
    warm = torch.arange(batch, device=split.device)
    for _ in range(50):
        trainer.train_step(split.gather_batch(warm))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals, steps = runner.train_epoch()
    loss = float(totals["loss"]) / steps
    seconds = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise AssertionError(f"{tag} bench loss {loss}")
    print(f"[times] {tag}: {steps / seconds:.1f} warm train steps/s at B={batch} "
          f"({steps} steps in {seconds:.3f} s, {1e3 * seconds / steps:.4f} ms/step) "
          f"| {card_line}")


def _device_busy(tag, trainer, split, batch, card_line):
    """Device busy per train step (``step_probe.step_profile``: the union
    of the profiler's kernel, memcpy and memset intervals over 50 warm
    steps) against the host-clock time of 50 unprofiled steps just
    before; prints the busy time, the idle share and the largest kernels."""
    from arvae_tpu_torch.utils.step_probe import step_profile

    rows = split.gather_batch(torch.arange(batch, device=split.device))
    busy_ms, events, step_ms, by_name = step_profile(lambda: trainer.train_step(rows))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[times] {tag} step, profiled: device busy {busy_ms:.3f} ms a step over 50 "
          f"steps ({events:.0f} device events a step); 50 unprofiled steps just before: "
          f"{step_ms:.3f} ms a step, device idle {100 * (1 - busy_ms / step_ms):.1f}% "
          f"| {card_line}")
    print(f"[times] {tag} step, device µs a step by kernel: "
          + "; ".join(f"{n} {us:.1f}" for n, us in top))
    return busy_ms


def _ar_term_launches(dev, card_line):
    """The device kernels the AR term (``total_reg_loss``) launches in a
    train and an eval step at each slice's shapes (profiler): one reg
    kernel each way, and no stack, cast or slice-scatter left."""
    from arvae_tpu_torch.utils.step_probe import AR_SHAPES, ar_term_profile

    out = {}
    for name, (shape, nl, dims) in AR_SHAPES.items():
        for kind, (events, names, dev_us, host_us) in ar_term_profile(
                dev, shape, nl, dims).items():
            fwd = sum(k for n, k in names.items() if "reg_fwd" in n)
            bwd = sum(k for n, k in names.items() if "reg_bwd" in n)
            if (fwd, bwd) != ((1, 1) if kind == "train" else (1, 0)):
                raise AssertionError(f"AR term, {name} {kind} step: reg kernels {names}")
            left = [n for n in names if re.search(r"Cat|[Cc]opy|Fill|[Ss]catter|[Ii]ndex", n)]
            if left:
                raise AssertionError(f"AR term, {name} {kind} step launches {left}")
            out[(name, kind)] = events
            print(f"[times] AR term, {name} {kind} step: {events:g} device launches a call "
                  f"({', '.join(f'{n} x{k:g}' for n, k in sorted(names.items()))}); device "
                  f"{dev_us:.2f} µs, host {host_us:.2f} µs a call | {card_line}")
    return out


def phase_times(card_line):
    from arvae_tpu_torch.utils import step_probe

    dev = torch.device("cuda")
    times = _kernel_times(dev, card_line)
    times["ar_launches"] = _ar_term_launches(dev, card_line)

    rng = np.random.RandomState(0)
    rows = rng.randint(0, MUSIC_BENCH_V, (MUSIC_BENCH_ROWS, 24)).astype(np.int32)
    trainer, split = step_probe.music_trainer(dev, rows)
    _steps_per_second(trainer, split, MUSIC_B,
                      f"MeasureVAE (H=128, z=32, V={MUSIC_BENCH_V}, -r all, "
                      f"{MUSIC_BENCH_ROWS}-row random token corpus)", card_line)
    times["music_busy_ms"] = _device_busy("music", trainer, split, MUSIC_B, card_line)
    times["gru_layers"] = _gru_layer_times(dev, card_line)
    times["gru_layers_512"] = _gru_layer_times(dev, card_line, 512, gru_layers(512))
    times["gru_layers_384"] = _gru_layer_times(dev, card_line, 384, SR_NO_INPUT_LAYER)

    packed = rng.randint(0, 256, (BENCH_ROWS, 512)).astype(np.uint8)
    labels = rng.rand(BENCH_ROWS, 6).astype(np.float32)
    trainer, split = step_probe.dsprites_trainer(dev, packed, labels)
    _steps_per_second(trainer, split, B_TRAIN,
                      f"DspritesVAE ({BENCH_ROWS}-row random packed split)", card_line)
    # the dSprites step's device busy with cuDNN free to pick its fastest,
    # nondeterministic convolution algorithms, then as the trainer sets it
    torch.backends.cudnn.deterministic = False
    times["dsprites_busy_free_ms"] = _device_busy(
        "dSprites (torch.backends.cudnn.deterministic=False)", trainer, split, B_TRAIN,
        card_line)
    torch.backends.cudnn.deterministic = True
    times["dsprites_busy_ms"] = _device_busy(
        "dSprites (torch.backends.cudnn.deterministic=True)", trainer, split, B_TRAIN,
        card_line)
    return times


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    t0 = time.perf_counter()
    card_line = _timed("device", phase_device)
    _timed("build", phase_build)
    errs = _timed("kernels", phase_kernels)
    image = _timed("slice 1 (dSprites)", phase_slice)
    music = _timed("slice 2 (music)", phase_music_slice)
    variants = _timed("slice 3 (music variants)", phase_music_variants, card_line)
    times = _timed("times", phase_times, card_line)
    wide = _timed("slice 4 (the reference's widths, a 3-layer tick GRU)", phase_wide_deep,
                  card_line)
    print(f"[phase] total: {time.perf_counter() - t0:.1f} s")

    from arvae_tpu_torch.utils import kernel_work as kw

    hier_shape = dict(T=HIER_T, B=HIER_B, H=HIER_H, E=HIER_E, V=MUSIC_BENCH_V,
                      ticks_per_beat=HIER_TPB)
    # the work of each kernel at the shape its "ms" was timed at
    work = {"reg": lambda bwd: times["reg"]["bwd_work" if bwd else "fwd_work"],
            "gru": lambda bwd: kw.gru_chain(*GRU_CASES[0], backward=bwd),
            "hier": lambda bwd: kw.hier_tick_chain(**hier_shape, backward=bwd)}
    # cuDNN's GRU layer whose projection is smallest (I=10) beside gru_chain
    cudnn = times["gru_layers"]["encoder layer 0"]

    def entry(name, key, direction, source, replaces, slice_run):
        t = times[key]
        launches, steps = slice_run[0][key][direction], slice_run[1][direction]
        w = work[key](direction == "bwd")
        by_variant = {v: counts[key][direction] for v, counts in variants.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_per_step": launches / steps,
                "slice3_launches": by_variant,
                "max_abs_err": errs[key][direction == "bwd"],
                "ms": t[direction], "plain_ms": t[f"{direction}_plain"],
                "bound_ms": w.bound_ms, "bound_by": w.bound_by,
                "library_ms": cudnn[f"cudnn_{direction}"] if key == "gru" else None,
                **({"events_ms": t[f"{direction}_events"]} if key == "reg" else {}),
                **({"wide_deep_shapes": shapes(key, direction)} if key != "reg" else {})}

    # the new shapes: the reference's widths and the tick GRU's depths,
    # each with its launches a train step in the wide or deep CLI run
    # that reaches it (None where no CLI run does)
    cudnn_at = {(24, 2, 256, 512): times["gru_layers_512"]["encoder layer 0"],
                (4, 1, 256, 512): times["gru_layers_512"]["beat layer 0"],
                (24, 1, 256, 384): times["gru_layers_384"]["sr-no-input layer"]}
    run_of = {(512, 2): "512-wide", (128, 3): "3-layer decoder"}

    def per_train_step(run, key):
        if run is None:
            return None
        counts, steps, _ = wide[run]
        return counts[key]["bwd"] / steps

    def shapes(key, direction):
        rows = []
        for row in times[f"{key}_wide"]:
            w = row[f"{direction}_work"]
            if key == "gru":
                lib = cudnn_at.get(row["shape"])
                run = "512-wide" if row["shape"][-1] == 512 and row["shape"][2] == 256 else None
            else:
                lib, run = None, run_of.get(row["shape"])
            rows.append({"shape": row["shape"], "ms": row[direction],
                         "plain_ms": row[f"{direction}_plain"], "bound_ms": w.bound_ms,
                         "bound_by": w.bound_by,
                         "library_ms": lib[f"cudnn_{direction}"] if lib else None,
                         "cli_run": run,
                         "cli_launches_per_train_step": per_train_step(run, key)})
        return rows

    csrc = "arvae_tpu_torch/csrc/"
    kernels = [
        entry("reg_loss_fwd", "reg", "fwd", csrc + "reg_loss.cu",
              "arvae_tpu/ops/reg_pallas.py:83", image),
        entry("reg_loss_bwd", "reg", "bwd", csrc + "reg_loss.cu",
              "arvae_tpu/ops/reg_pallas.py:113", image),
        entry("gru_chain_fwd", "gru", "fwd", csrc + "gru_chain.cu",
              "arvae_tpu/ops/gru_pallas.py:144", music),
        entry("gru_chain_bwd", "gru", "bwd", csrc + "gru_chain.cu",
              "arvae_tpu/ops/gru_pallas.py:218", music),
        entry("hier_tick_chain_fwd", "hier", "fwd", csrc + "hier_tick_chain.cu",
              "arvae_tpu/ops/hier_decoder_pallas.py:475", music),
        entry("hier_tick_chain_bwd", "hier", "bwd", csrc + "hier_tick_chain.cu",
              "arvae_tpu/ops/hier_decoder_pallas.py:563", music),
    ]
    for k in kernels:
        print(f"[times] {k['name']}: {k['ms']:.5f} ms, bound {k['bound_ms']:.3g} ms "
              f"({k['bound_by']}, {100 * k['bound_ms'] / k['ms']:.1f}% of it), "
              f"{k['launches_per_step']:g} launches a step | {card_line}")
    for name, (counts, steps, busy) in wide.items():
        print(f"[times] music {name} run: launches {counts} over {steps} train steps; device "
              f"busy {busy:.3f} ms a train step | {card_line}")
    print(f"[times] dSprites step device busy: {times['dsprites_busy_free_ms']:.3f} ms with "
          f"cuDNN free to pick nondeterministic algorithms, {times['dsprites_busy_ms']:.3f} ms "
          f"with torch.backends.cudnn.deterministic=True | {card_line}")
    print("[times] the AR term's device launches a call (profiler): " + "; ".join(
        f"{name} {kind} {n:g}" for (name, kind), n in times["ar_launches"].items())
        + f" | {card_line}")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
