"""Whether a profiled window records every kernel it launched, under two
ways of opening it, late in a long process on one card.

Run on the card from a checkout's root:

    python arvae_tpu_torch/utils/window_probe.py --runs 20

It first runs ``chip_smoke.py``'s kernel checks and slices 1-3 in this
process (the state in which CUPTI was seen to drop the first records of
a window), then profiles ``--runs`` windows of 20 calls of the reg
kernel's forward at the dSprites step's shape under each opening, in
turns:

- ``queued``: one spin kernel (``step_probe.PAD_CYCLES``), the calls
  queued behind it;
- ``padded``: ``step_probe.open_window``, ``call_events``'s first
  opening: the spin kernel and ``OPENING_KERNELS`` short ones, waited
  for before the calls.

Both close with a spin kernel and a sync. For each opening it prints how
many windows recorded fewer reg kernels than the wrapper's counter
counted, and the fewest and most kernel records a window lost, beside
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def _window(fn, calls, opening):
    from torch.profiler import ProfilerActivity, profile, schedule

    from arvae_tpu_torch.ops import reg_kernel as rk
    from arvae_tpu_torch.utils import step_probe as sp

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = rk.LAUNCHES["fwd"]
        if opening == "padded":
            sp.open_window()
        else:
            torch.cuda._sleep(sp.PAD_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(sp.PAD_CYCLES)
        torch.cuda.synchronize()
        counted = rk.LAUNCHES["fwd"] - before
        prof.step()
    names = [e["name"] for e in sp.device_events(prof)]
    spins = sum("spin_kernel" in n for n in names)
    opened = 2 + (sp.OPENING_KERNELS if opening == "padded" else 0)
    return sum("reg_fwd" in n for n in names), counted, opened - spins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_probe.py needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from arvae_tpu_torch.ops import reg_kernel as rk
    from arvae_tpu_torch.utils import step_probe as sp

    card_line = cs.phase_device()
    cs.phase_build()
    cs.phase_kernels()
    with tempfile.TemporaryDirectory() as kept:
        cs.phase_slice(os.path.join(kept, "dsprites"))
        cs.phase_music_slice(os.path.join(kept, "music"))
        cs.phase_music_variants(card_line)
    dev = torch.device("cuda")
    (b, zd), nl, dims = sp.AR_SHAPES["dSprites"]
    rng = np.random.RandomState(11)
    z = torch.tensor(rng.randn(b, zd), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(0, 4, (b, nl)), dtype=torch.float32, device=dev)
    d = torch.tensor(1.0, device=dev)

    def fn():
        rk.reg_fwd_cuda(z, labels, dims, d)

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    short = {"queued": 0, "padded": 0}
    lost = {"queued": [], "padded": []}
    for _ in range(args.runs):
        for opening in short:
            recorded, counted, spins_lost = _window(fn, args.calls, opening)
            short[opening] += recorded < counted
            lost[opening].append(spins_lost + counted - recorded)
    for opening in short:
        print(f"[window] {opening}: {short[opening]} of {args.runs} windows of {args.calls} "
              f"reg_fwd calls recorded fewer reg_fwd kernels than counted; kernel records "
              f"lost a window (spin and reg) {min(lost[opening])}-{max(lost[opening])} "
              f"| {card_line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
