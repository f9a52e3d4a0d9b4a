"""Device launches, device busy time and host time of the AR term and of
the two train steps on one card, to compare two checkouts of the port.

Run on the card from a checkout's root, against that checkout, or
against another one put first on the path:

    python arvae_tpu_torch/utils/step_probe.py --tag change
    PYTHONPATH=<other checkout> python arvae_tpu_torch/utils/step_probe.py --tag parent

It reaches the port only through entry points every version of it has
(``ops/losses.py::total_reg_loss``, the two trainers, ``DeviceSplit``),
so one file measures both sides. ``chip_smoke.py`` imports its helpers.
Every line it prints ends with the card's name and power limit:

- the AR term (``total_reg_loss``) at the dSprites step's shapes
  (``z_tilde`` (128, 10), 6 label columns, dims 1-5), the music
  step's (``z_tilde`` (256, 32), 4 label columns, dims 0-3) and the
  MNIST step's (``z_tilde`` (128, 16), 7 label columns, dims 1-6): the device
  kernels a call launches by name, its device µs (the union of the
  profiler's device intervals) and its host µs (host clock over 200
  back-to-back calls), as a train step runs it (forward, and backward
  from ``z_tilde`` with a given seed gradient) and as an eval step runs
  it (forward under ``torch.no_grad()``);
- the reg kernel wrappers this version has, forward and backward on
  stacked (R, B) columns at (5, 128), (4, 256) and (2, 8192): device µs
  a call (profiler) and host µs a call (1000 back-to-back calls);
- each train step (dSprites at B=128 on a random packed split, music at
  B=256, V=130 on a random token corpus): device events and busy ms a
  step over 50 profiled steps, the host-clock ms a step of 50
  unprofiled steps just before, and the device's idle share.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

# (z_tilde shape, label columns, dims) of the AR term on each slice
AR_SHAPES = {"dSprites": ((128, 10), 6, tuple((c, c) for c in range(1, 6))),
             "music": ((256, 32), 4, tuple((c, c) for c in range(4))),
             "MNIST": ((128, 16), 7, tuple((c, c) for c in range(1, 7)))}
DSPRITES_B, MUSIC_B, MUSIC_V = 128, 256, 130


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """The kernel, memcpy and memset intervals of a ``torch.profiler``
    run, from its exported trace (empty when CUPTI delivered none)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def union_us(intervals):
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def short_name(name):
    """'hier_bwd<8>' from a demangled kernel name, cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("arvae::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:60]


# The port's kernels by short name, each launched a fixed number of
# times by one call of a wrapper: (ops module, its launch counter's key,
# kernels a count), summed. The tick loop's backward runs each of its
# layers through the GRU chain's backward (its ``CHAIN_LAUNCHES``); the
# wide layout's calls (``WIDE_LAUNCHES``, ``CHAIN_LAUNCHES["wide"]``)
# launch its kernels instead of the cluster kernels, and the tick loop's
# wave layout's (``WAVE_LAUNCHES``) its forward instead of ``hier_fwd``.
# The backwards' tensor-core engine counts its GEMMs and row products
# (``GEMM_LAUNCHES``), launched within or without a backward. The
# convolutions' weight gradient counts its first pass (its second runs
# only where the plan splits the sum).
ENTRY_KERNELS = {
    "reg_fwd": (("reg_kernel", "fwd", 1),),
    "reg_bwd": (("reg_kernel", "bwd", 1),),
    "gru_fwd": (("gru_kernel", "fwd", 1), ("gru_kernel", "wide_fwd", -1)),
    "gru_bwd": (("gru_kernel", "bwd", 1), ("gru_kernel", "wide_bwd", -1),
                ("hier_decoder_kernel", "chains", 1), ("hier_decoder_kernel", "chains_wide", -1)),
    "gru_wide_fwd": (("gru_kernel", "wide_fwd", 1),),
    "gru_wide_bwd": (("gru_kernel", "wide_bwd", 1), ("hier_decoder_kernel", "chains_wide", 1)),
    "hier_fwd": (("hier_decoder_kernel", "fwd", 1), ("hier_decoder_kernel", "wave_fwd", -1)),
    "hier_wave_fwd": (("hier_decoder_kernel", "wave_fwd", 1),),
    "hier_bwd_prep": (("hier_decoder_kernel", "bwd", 1),),
    "atb_tc": (("gru_kernel", "gemm_atb", 1), ("gru_kernel", "gemm_atb_alone", 1)),
    "rows_tc": (("gru_kernel", "gemm_rows", 1), ("gru_kernel", "gemm_rows_alone", 1)),
    "conv_wgrad_partial": (("conv_wgrad_kernel", "wgrad", 1),),
}


def _launch_counts():
    """{(module, key): count} of the port's wrapper launch counters (an
    earlier checkout's lack the wide and wave layouts' and the engine's: 0)."""
    import importlib

    counts = {(m, k): v for m in ("reg_kernel", "gru_kernel", "hier_decoder_kernel")
              for k, v in importlib.import_module(f"arvae_tpu_torch.ops.{m}").LAUNCHES.items()}
    gk = importlib.import_module("arvae_tpu_torch.ops.gru_kernel")
    for k in ("fwd", "bwd"):
        counts[("gru_kernel", f"wide_{k}")] = getattr(gk, "WIDE_LAUNCHES", {}).get(k, 0)
    for k in ("atb", "rows", "atb_alone", "rows_alone"):
        counts[("gru_kernel", f"gemm_{k}")] = getattr(gk, "GEMM_LAUNCHES", {}).get(k, 0)
    hk = importlib.import_module("arvae_tpu_torch.ops.hier_decoder_kernel")
    counts[("hier_decoder_kernel", "chains")] = hk.CHAIN_LAUNCHES["bwd"]
    counts[("hier_decoder_kernel", "chains_wide")] = hk.CHAIN_LAUNCHES.get("wide", 0)
    counts[("hier_decoder_kernel", "wave_fwd")] = getattr(hk, "WAVE_LAUNCHES", {}).get("fwd", 0)
    cw = importlib.import_module("arvae_tpu_torch.ops.conv_wgrad_kernel")
    counts[("conv_wgrad_kernel", "wgrad")] = cw.LAUNCHES["wgrad"]
    return counts


# Device cycles of the spin kernel that opens and closes each profiled
# window (about 25 ms on an H100): the profiler keeps a device record
# only if it falls inside the host clock's window once converted, and a
# kernel that ends just before the closing sync can land past it.
PAD_CYCLES = 50_000_000
# Short spin kernels (about 11 µs each) queued behind the opening one:
# after a process has profiled for a while, CUPTI drops the records of
# the first few kernels launched in each window (none in a fresh
# process; ``utils/window_probe.py`` counts them on a card); these take
# the loss in place of the calls'.
OPENING_KERNELS, OPENING_CYCLES = 64, 20_000


def open_window(kernels=OPENING_KERNELS):
    """Opens a profiled window: the spin kernel and ``kernels`` short
    ones, waited for. Their records are named ``spin_kernel``."""
    torch.cuda._sleep(PAD_CYCLES)
    for _ in range(kernels):
        torch.cuda._sleep(OPENING_CYCLES)
    torch.cuda.synchronize()


def _replays():
    """Training steps replayed from a CUDA graph so far (an earlier
    checkout's trainers replay none: 0)."""
    from arvae_tpu_torch.training import base

    return getattr(base, "GRAPH_STEPS", {}).get("replayed", 0)


def call_events(fn, calls, attempts=5):
    """The device events of ``calls`` calls of ``fn`` after two warm ones
    and a traced warm-up step, from a profiled run whose records of the
    port's kernels (``ENTRY_KERNELS``) equal, kernel by kernel, what the
    wrappers' ``LAUNCHES`` counters say they launched in the same window,
    plus, where training steps were replayed from a CUDA graph (whose
    kernels no wrapper launches), the same count of each kernel in every
    replay: a whole multiple of the replays.
    The calls run between two spin kernels (``PAD_CYCLES``), left out of
    the events, so that none of theirs sits at an edge of the window; the
    opening one is followed by short ones and waited for
    (``open_window``). CUPTI loses records but never adds one, so a run
    that disagrees is profiled again with four times as many short
    kernels, up to ``attempts`` runs; raises if none agrees."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    seen, opening = [], OPENING_KERNELS
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before, replays = _launch_counts(), _replays()
            open_window(opening)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            after, replays = _launch_counts(), _replays() - replays
            prof.step()
        events = [e for e in device_events(prof) if "spin_kernel" not in e["name"]]
        recorded = {}
        for e in events:
            base = short_name(e["name"]).split("<")[0]
            if base in ENTRY_KERNELS:
                recorded[base] = recorded.get(base, 0) + 1
        expected = {n: sum(c * (after[(m, k)] - before[(m, k)]) for m, k, c in parts)
                    for n, parts in ENTRY_KERNELS.items()}
        expected = {n: c for n, c in expected.items() if c}
        rest = {n: recorded.get(n, 0) - expected.get(n, 0) for n in ENTRY_KERNELS}
        if events and all(v == 0 if not replays else v >= 0 and v % replays == 0
                          for v in rest.values()):
            return events
        seen.append((recorded, expected, replays))
        opening *= 4
    raise AssertionError(f"no profiled run of {calls} calls recorded the port's kernels the "
                         f"launch counters count (recorded, counted, replays): {seen}")


def profile_calls(fn, calls):
    """(device events a call, {kernel: launches a call}, device µs a call)
    over ``calls`` calls of ``fn`` (``call_events``)."""
    events = call_events(fn, calls)
    names = {}
    for e in events:
        names[short_name(e["name"])] = names.get(short_name(e["name"]), 0) + 1
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in events]) / calls
    return len(events) / calls, {n: k / calls for n, k in names.items()}, busy


def host_us(fn, calls=200):
    """Host-clock µs a call over back-to-back calls ending in a sync."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def ar_term_profile(dev, shape, n_labels, dims, calls=50):
    """{"train": ..., "eval": ...}, each (device events a call, {kernel:
    launches a call}, device µs a call, host µs a call)."""
    from arvae_tpu_torch.ops.losses import total_reg_loss

    rng = np.random.RandomState(shape[0] + shape[1])
    z = torch.tensor(rng.randn(*shape), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(0, 4, (shape[0], n_labels)), dtype=torch.float32,
                          device=dev)
    gamma, delta = (torch.tensor(v, device=dev) for v in (10.0, 1.0))
    seed = torch.ones((), device=dev)  # the step's loss seeds the AR term's backward
    zg = z.clone().requires_grad_(True)

    def train():
        zg.grad = None
        torch.autograd.backward(total_reg_loss(zg, labels, dims, gamma, delta), seed)

    def evaluate():
        with torch.no_grad():
            total_reg_loss(z, labels, dims, gamma, delta)

    return {k: (*profile_calls(fn, calls), host_us(fn))
            for k, fn in (("train", train), ("eval", evaluate))}


def reg_pair(dev, r, b):
    """(forward, backward) callables of the reg kernel wrappers this
    version of the port has, on (R, B) columns: the one-launch forward
    with factors and the scale backward, or the older two-launch pair."""
    from arvae_tpu_torch.ops import reg_kernel as rk

    rng = np.random.RandomState(r * 1000 + b)
    z = torch.tensor(rng.randn(r, b), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.randint(0, 4, (r, b)), dtype=torch.float32, device=dev)
    ct = torch.tensor(rng.randn(r), dtype=torch.float32, device=dev)
    d = torch.ones(1, device=dev)
    if not hasattr(rk, "reg_fwd_cuda"):
        return (lambda: rk.reg_loss_fwd_cuda(z, a, d),
                lambda: rk.reg_loss_bwd_cuda(z, a, d, ct))
    zt, at, dims = z.t(), a.t(), tuple((i, i) for i in range(r))
    _, g, dd = rk.reg_fwd_cuda(zt, at, dims, d)
    return (lambda: rk.reg_fwd_cuda(zt, at, dims, d),
            lambda: rk.reg_bwd_cuda(g, dd, ct, dims, r, col_major=True))


def step_profile(step, steps=50):
    """(device busy ms a step, device events a step, host-clock ms a step
    of ``steps`` unprofiled steps just before, {kernel: device µs a
    step}) over ``steps`` profiled steps (``call_events``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    device = call_events(step, steps)
    busy_ms = union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e3 / steps
    by_name = {}
    for e in device:
        by_name[short_name(e["name"])] = by_name.get(short_name(e["name"]), 0.0) + e["dur"] / steps
    return busy_ms, len(device) / steps, step_ms, by_name


def bench_vocab(n):
    """Specials and chromatic pitch names from MIDI 36 up: the vocabulary
    of ``scripts/bench_measure_vae.py``."""
    names = ["__", "START", "END", "rest"]
    spell = ["C", "C#", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]
    midi = 36
    while len(names) < n:
        names.append(f"{spell[midi % 12]}{midi // 12 - 1}")
        midi += 1
    return {i: s for i, s in enumerate(names)}


class TokenCorpus:
    """Random measures over a V-token vocabulary, with what the music
    trainer reads of a dataset."""

    class_name = "4by4_FolkNBarDataset_1_"
    beat_subdivisions, time_sig_num, time_sig_den = 6, 4, 4

    def __init__(self, rows, index2note):
        self.rows = rows
        self.index2note_dicts = index2note
        self.note2index_dicts = {v: k for k, v in index2note.items()}

    def get_dataset(self):
        return self.rows, self.rows

    def attrs(self, device):
        from arvae_tpu_torch.data.attributes import MusicAttributes

        return MusicAttributes(self.index2note_dicts, device)


def music_trainer(dev, rows, ctx=None, hidden=128):
    """The music step's trainer (H=128, or ``hidden`` for the encoder and
    the decoder, z=32, V=130, ``-r all``) and its split, on ``rows`` (N,
    24) random tokens, over the data axis ``ctx`` (the trainer's default:
    ``init_data_parallel``'s)."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.models.measure_vae import MeasureVAE
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    corpus = TokenCorpus(rows, bench_vocab(MUSIC_V))
    trainer = MeasureVAETrainer(
        corpus, MeasureVAE(MUSIC_V, encoder_hidden_size=hidden, latent_space_dim=32,
                           decoder_hidden_size=hidden, seed=0),
        dev, reg_type=("all",), reg_dim=(0, 1, 2, 3), rand=0, ctx=ctx)
    return trainer, DeviceSplit(rows, None, (24,), "tokens", dev, trainer.ctx)


def dsprites_trainer(dev, packed, labels, ctx=None):
    """The dSprites step's trainer (``-r all``, β 1, γ 10, δ 1) and its
    packed split, over the data axis ``ctx`` (as :func:`music_trainer`)."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.models.image_vae import DspritesVAE
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    trainer = ImageVAETrainer(None, DspritesVAE(seed=0), dev, reg_type=("all",),
                              reg_dim=(1, 2, 3, 4, 5), beta=1.0, gamma=10.0, delta=1.0,
                              rand=0, ctx=ctx)
    return trainer, DeviceSplit(packed, labels, (1, 64, 64), "packed", dev, trainer.ctx)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_probe needs a CUDA card")
    dev, line = torch.device("cuda"), card()
    import arvae_tpu_torch

    print(f"[{args.tag}] arvae_tpu_torch from {os.path.dirname(arvae_tpu_torch.__file__)} "
          f"| {line}")
    for slice_name, (shape, n_labels, dims) in AR_SHAPES.items():
        for kind, (events, names, dev_us, h_us) in ar_term_profile(
                dev, shape, n_labels, dims).items():
            print(f"[{args.tag}] AR term, {slice_name} {kind} step: {events:g} device "
                  f"launches a call, device {dev_us:.2f} µs, host {h_us:.2f} µs a call; "
                  + ", ".join(f"{n} x{k:g}" for n, k in sorted(names.items()))
                  + f" | {line}")

    for r, b in ((5, 128), (4, 256), (2, 8192)):
        fwd, bwd = reg_pair(dev, r, b)
        us = {k: profile_calls(fn, 20)[2] for k, fn in (("fwd", fwd), ("bwd", bwd))}
        host = {k: host_us(fn, 1000) for k, fn in (("fwd", fwd), ("bwd", bwd))}
        print(f"[{args.tag}] reg kernel wrappers at (R, B) = ({r}, {b}): device µs a call "
              f"fwd {us['fwd']:.2f}, bwd {us['bwd']:.2f}; host µs a call (1000 back to "
              f"back) fwd {host['fwd']:.2f}, bwd {host['bwd']:.2f} | {line}")

    rng = np.random.RandomState(0)
    packed = rng.randint(0, 256, (4096, 512)).astype(np.uint8)
    trainer, split = dsprites_trainer(dev, packed, rng.rand(4096, 6).astype(np.float32))
    tokens = rng.randint(0, MUSIC_V, (4096, 24)).astype(np.int32)
    music, music_split = music_trainer(dev, tokens)
    for slice_name, tr, sp, b in (("dSprites", trainer, split, DSPRITES_B),
                                  ("music", music, music_split, MUSIC_B)):
        rows = sp.gather_batch(torch.arange(b, device=dev))
        for _ in range(30):
            tr.train_step(rows)
        busy, events, step_ms, by_name = step_profile(lambda: tr.train_step(rows))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"[{args.tag}] {slice_name} train step: {events:g} device events, device busy "
              f"{busy:.4f} ms a step; unprofiled {step_ms:.4f} ms a step, device idle "
              f"{100 * (1 - busy / step_ms):.1f}%; top: "
              + "; ".join(f"{n} {us:.1f}" for n, us in top) + f" | {line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
