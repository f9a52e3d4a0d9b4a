"""Times the GRU recurrences at the reference's widths (and the music
step's H=128) on one card, and splits each call's device time by kernel,
to compare two checkouts of the port.

Run on the card from a checkout's root, against that checkout, or
against another one put first on the path:

    python arvae_tpu_torch/utils/wide_probe.py --tag change
    PYTHONPATH=<other checkout> python arvae_tpu_torch/utils/wide_probe.py --tag parent

It reaches the port only through entry points every version of it has
(``gru_chain_fwd_cuda`` and ``gru_chain_bwd_cuda``,
``hier_tick_chain_fwd_cuda`` and ``hier_tick_chain_bwd_cuda``,
``step_probe.call_events``). Where the version's forward keeps the
hidden-side pre-activations for its backward (``keep_gh``), the
backward is timed with them, as a train step runs it. For each
``gru_chain`` shape (T, D, B, H): ms a call by CUDA events over
back-to-back calls, and the device µs a call of each kernel
(``torch.profiler``, 5 calls). For the tick loop (B=256, E=10, V=130,
T=24, 6 ticks a beat, dropout 0.5, free-running) at each (H, L) of
``HIER_SHAPES``, the shapes where no cluster holds its weights: the
forward's ms, its device µs by kernel and its fp32 and 3xTF32 bounds
(``kernel_work``); at H=512 and at H=128, L=2 also the backward's. With
``--step`` it profiles the music train step at H=512 and at H=128 (B=256,
V=130, ``-r all``; ``step_probe.step_profile``, 50 steps) for the device
µs a step by kernel. With ``--atb-splits`` it times the backward instead
under each split count of its weight-gradient GEMM
(``gru_kernel.atb_splits`` replaced for the run), at the reference's
widths, and the GEMMs of ``FEW_CTA_GEMMS`` alone under the plan's
splits and under one 32-term K tile a split. Every line ends with the
card's name and power limit; ``--json`` also writes the rows to a file.
"""

from __future__ import annotations

import argparse
import inspect
import json

import numpy as np
import torch

from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.utils import kernel_work as kw
from arvae_tpu_torch.utils.step_probe import call_events, card, short_name

GRU_SHAPES = ((24, 2, 256, 128), (4, 1, 256, 128), (24, 1, 256, 128), (24, 2, 256, 512),
              (4, 1, 256, 512), (24, 1, 256, 384), (6, 1, 1024, 512))
HIER = dict(B=256, E=10, V=130, T=24, tpb=6)
HIER_SHAPES = ((512, 2), (384, 2), (256, 2), (128, 4), (128, 2))
HIER_BACKWARD = ((512, 2), (128, 2))
# The weight-gradient GEMMs of the music steps at H=64-256 and V=34/130
# whose least split (``gru_kernel.ATB_MIN_TERMS`` terms) still leaves
# fewer than 100 CTAs: (name, A's form, T, D, B, M, N, bias), T·B terms.
FEW_CTA_GEMMS = (("beat dW_hh H=64", "prev", 4, 1, 256, 64, 192, True),
                 ("beat dW_hh H=128", "prev", 4, 1, 256, 128, 384, True),
                 ("demb V=34", "tokens", 6, 1, 1024, 34, 10, False),
                 ("dout_w H=64 V=34", "dense", 6, 1, 1024, 64, 34, True),
                 ("dout_w H=128 V=34", "dense", 6, 1, 1024, 128, 34, True))


def _ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _split(fn, calls=5):
    """{kernel: device µs a call} from a profiled run of ``calls`` calls."""
    out = {}
    for e in call_events(fn, calls):
        name = short_name(e["name"])
        out[name] = out.get(name, 0.0) + e["dur"] / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gru_inputs(t, d, b, h, dev, seed=17):
    rng = np.random.RandomState(seed)

    def f(*shape, s):
        return torch.tensor(rng.randn(*shape) * s, dtype=torch.float32, device=dev)

    return (f(t, d, b, 3 * h, s=0.5), f(d, h, 3 * h, s=1 / np.sqrt(h)),
            f(d, 3 * h, s=0.1), f(d, b, h, s=0.3)), f(t, d, b, h, s=1.0)


def gru_row(shape, dev):
    args, ct = gru_inputs(*shape, dev)
    keeps = "keep_gh" in inspect.signature(gk.gru_chain_fwd_cuda).parameters
    if keeps:
        outs, gh = gk.gru_chain_fwd_cuda(*args, keep_gh=True)
        fwd = lambda: gk.gru_chain_fwd_cuda(*args, keep_gh=True)  # noqa: E731
        bwd = lambda: gk.gru_chain_bwd_cuda(*args, outs, ct, gh=gh)  # noqa: E731
    else:
        outs = gk.gru_chain_fwd_cuda(*args)
        fwd = lambda: gk.gru_chain_fwd_cuda(*args)  # noqa: E731
        bwd = lambda: gk.gru_chain_bwd_cuda(*args, outs, ct)  # noqa: E731
    iters = 50 if shape[-1] > 128 else 200
    return {"shape": shape, "keeps_gh": keeps, "fwd_ms": _ms(fwd, iters),
            "bwd_ms": _ms(bwd, iters), "fwd_us_by_kernel": _split(fwd),
            "bwd_us_by_kernel": _split(bwd)}


def hier_inputs(dev, B, H, E, V, T, tpb, L, seed=8):
    rng = np.random.RandomState(seed)
    nb = -(-T // tpb)

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(x, dtype=torch.float32, device=dev)

    floats = [w(nb, B, 3 * H, s=0.5), w(nb, L, B, H, s=0.5), w(B, E, s=0.5), w(V, E, s=1.0),
              w(E, 3 * H)]
    for layer in range(L):
        floats += [w(H, 3 * H), w(3 * H, s=0.1)]
        if layer:
            floats += [w(H, 3 * H), w(3 * H, s=0.1)]
    floats += [w(H, V), w(V, s=0.1)]
    score = torch.tensor(rng.randint(0, V, (T, B)), dtype=torch.int32, device=dev)
    ct = torch.tensor(rng.randn(T, B, V), dtype=torch.float32, device=dev)
    return score, floats, ct


def hier_row(dev, h, layers, backward):
    p = dict(HIER, H=h, L=layers)
    score, floats, ct = hier_inputs(dev, **p)
    teacher = torch.zeros(1, dtype=torch.int32, device=dev)
    seed = torch.full((1,), 5, dtype=torch.int32, device=dev)
    cfg = (True, 0.5, p["tpb"], "argmax")
    # a version whose forward keeps gh for the backward's wide chains runs
    # both as a train step does
    keeps = "keep_gh" in inspect.signature(hk.hier_tick_chain_fwd_cuda).parameters
    kept = {"keep_gh": True} if keeps else {}
    out = hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score, *floats, **kept)
    (weights, samples, *hiddens), gh = out if keeps else (out, None)

    def bwd():
        return hk.hier_tick_chain_bwd_cuda(True, 0.5, p["tpb"], seed, samples, hiddens,
                                           weights, ct, *floats, **({"gh": gh} if keeps else {}))

    fwd = lambda: hk.hier_tick_chain_fwd_cuda(*cfg, teacher, seed, score, *floats, **kept)  # noqa
    work = kw.hier_tick_chain(p["T"], p["B"], h, p["E"], p["V"], p["tpb"], L=layers)
    row = {"shape": p, "plan": str(hk.hier_plan(p["B"], h, p["E"], p["V"], layers)),
           "fwd_ms": _ms(fwd, 20), "fwd_us_by_kernel": _split(fwd),
           "fwd_bound_ms": work.bound_ms, "fwd_tf32x3_bound_ms": work.tf32x3_bound_ms}
    if backward:
        row.update(bwd_ms=_ms(bwd, 20), bwd_us_by_kernel=_split(bwd))
    return row


def atb_split_rows(dev, line, tag):
    """The backward at each split count of its weight-gradient GEMM."""
    rows, chosen = [], {}
    for shape in ((24, 2, 256, 512), (24, 1, 256, 384), (6, 1, 1024, 512)):
        args, ct = gru_inputs(*shape, dev)
        outs, gh = gk.gru_chain_fwd_cuda(*args, keep_gh=True)
        chosen[shape] = gk.atb_splits(shape[3], 3 * shape[3], shape[0] * shape[2], shape[1])
        real = gk.atb_splits
        for splits in (2, 4, 6, 8, 11, 16):
            gk.atb_splits = lambda *a, s=splits: s  # noqa: E731
            try:
                def bwd():
                    return gk.gru_chain_bwd_cuda(*args, outs, ct, gh=gh)

                ms, by_kernel = _ms(bwd, 30), _split(bwd)
            finally:
                gk.atb_splits = real
            rows.append({"shape": shape, "splits": splits, "bwd_ms": ms,
                         "bwd_us_by_kernel": by_kernel})
            print(f"[{tag}] gru_chain {shape} backward, GEMM in {splits} splits (the plan "
                  f"takes {chosen[shape]}): {ms:.5f} ms; device µs by kernel {by_kernel} "
                  f"| {line}", flush=True)
    return rows


def few_cta_rows(dev, line, tag):
    """The GEMMs of ``FEW_CTA_GEMMS`` alone (``atb_cuda``): ms a call under
    the plan's splits and under splits of one 32-term K tile each."""
    rows = []
    real = gk.atb_splits
    for name, form, t, d, b, m, n, bias in FEW_CTA_GEMMS:
        rng = np.random.RandomState(m + n)

        def f(*shape):
            return torch.tensor(rng.randn(*shape) * 0.5, dtype=torch.float32, device=dev)

        x = f(t, d, b, n)
        if form == "tokens":
            a = {"tokens": torch.tensor(rng.randint(-1, m, t * b), dtype=torch.int32,
                                        device=dev), "M": m}
        else:
            a = {"a": f(t, d, b, m), **({"a0": f(d, b, m)} if form == "prev" else {})}
        tiles = d * np.prod([-(-k // w) for k, w in zip(
            (m, n), gk.TC_TILES[gk.atb_tile(m, n)])])
        plan = real(m, n, t * b, d)
        for splits in (plan, -(-t * b // gk.TC_DEPTH)):
            gk.atb_splits = lambda *args, s=splits: s  # noqa: E731
            try:
                ms = _ms(lambda: gk.atb_cuda(x, **a, bias=bias), 200)
            finally:
                gk.atb_splits = real
            rows.append({"name": name, "shape": (m, n, t * b, d), "splits": splits,
                         "ctas": int(tiles * splits), "ms": ms})
            print(f"[{tag}] weight-gradient GEMM alone, {name} {(m, n, t * b, d)}: {splits} "
                  f"splits ({int(tiles * splits)} CTAs; the plan takes {plan}): {ms:.5f} ms "
                  f"| {line}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    ap.add_argument("--atb-splits", action="store_true",
                    help="time the backward at each split count of its GEMM instead")
    ap.add_argument("--step", action="store_true",
                    help="also profile the music train step at H=512 and H=128")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wide_probe: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    line = card()
    if args.atb_splits:
        rows = atb_split_rows(dev, line, args.tag) + few_cta_rows(dev, line, args.tag)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"tag": args.tag, "card": line, "rows": rows}, f, default=str)
        return
    rows = []
    for shape in GRU_SHAPES:
        row = gru_row(shape, dev)
        rows.append(row)
        print(f"[{args.tag}] gru_chain {shape}: fwd {row['fwd_ms']:.5f} ms, bwd "
              f"{row['bwd_ms']:.5f} ms (gh kept: {row['keeps_gh']}); device µs a call by "
              f"kernel, fwd {row['fwd_us_by_kernel']}, bwd {row['bwd_us_by_kernel']} | {line}",
              flush=True)
    for h, layers in HIER_SHAPES:
        row = hier_row(dev, h, layers, (h, layers) in HIER_BACKWARD)
        rows.append(row)
        bwd = (f"; bwd {row['bwd_ms']:.5f} ms, device µs a call by kernel "
               f"{row['bwd_us_by_kernel']}" if "bwd_ms" in row else "")
        print(f"[{args.tag}] hier_tick_chain {row['shape']}: fwd {row['fwd_ms']:.5f} ms "
              f"(bound {row['fwd_bound_ms']:.4f} fp32, {row['fwd_tf32x3_bound_ms']:.4f} "
              f"3xTF32), device µs a call by kernel {row['fwd_us_by_kernel']}, plan "
              f"{row['plan']}{bwd} | {line}", flush=True)
    for hidden in (512, 128) if args.step else ():
        row = step_row(dev, hidden)
        rows.append(row)
        print(f"[{args.tag}] music train step at H={hidden}: device busy {row['busy_ms']:.3f} "
              f"ms a step ({row['events']:.0f} events), {row['step_ms']:.3f} ms unprofiled; "
              f"device µs a step by kernel {row['us_by_kernel']} | {line}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tag": args.tag, "card": line, "rows": rows}, f, default=str)


def step_row(dev, hidden):
    """The music train step (B=256, H = ``hidden`` for the encoder and the
    decoder, z=32, V=130, ``-r all``, a 4,096-row random token corpus)
    profiled over 50 warm steps: device busy, events and µs by kernel."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.models.measure_vae import MeasureVAE
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
    from arvae_tpu_torch.utils.step_probe import TokenCorpus, bench_vocab, step_profile

    rows = np.random.RandomState(0).randint(0, 130, (4096, 24)).astype(np.int32)
    model = MeasureVAE(130, encoder_hidden_size=hidden, latent_space_dim=32,
                       decoder_hidden_size=hidden, seed=0)
    trainer = MeasureVAETrainer(TokenCorpus(rows, bench_vocab(130)), model, dev,
                                reg_type=("all",), reg_dim=(0, 1, 2, 3), rand=0)
    batch = DeviceSplit(rows, None, (24,), "tokens", dev, trainer.ctx).gather_batch(
        torch.arange(256, device=dev))
    busy_ms, events, step_ms, by_name = step_profile(lambda: trainer.train_step(batch))
    return {"step": hidden, "busy_ms": busy_ms, "events": events, "step_ms": step_ms,
            "us_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}


if __name__ == "__main__":
    main()
