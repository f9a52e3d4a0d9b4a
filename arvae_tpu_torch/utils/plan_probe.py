"""Times ``hier_tick_chain``'s forward under several launch plans on one
card, beside how many clusters of each size the card holds at once, and
reports the clusters each kernel layout's plans assume against the card's
own count.

Run on the card from the repository root:

    python -m arvae_tpu_torch.utils.plan_probe

At B=256, H=128, E=10, V=130, T=24, 6 ticks a beat, training with
dropout 0.5, free-running: for each plan (C CTAs a cluster, RB rows a
cluster) the clusters it launches, the clusters of C CTAs with its
shared memory that the card holds at once
(``cudaOccupancyMaxActiveClusters``), and its ms per call (CUDA events
over 200 calls after 10 warm). Each plan's weights must match the
default plan's within rtol 1e-4 / atol 1e-5 and its samples equal.
Then :func:`held_report`: for every kernel and layout, at one and at two
CTAs an SM, the clusters of each size the card holds, beside
``gru_kernel.CLUSTERS_HELD``, and the plans of the wide and deep shapes
with the clusters they assume. Prints the card's name and power limit
on every line."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.ops.gru_kernel import ChainPlan

B, H, E, V, T, TPB = 256, 128, 10, 130, 24, 6
PLANS = ((4, 8), (8, 16), (8, 20), (8, 24), (8, 32))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _inputs(dev):
    rng = np.random.RandomState(8)
    nb = -(-T // TPB)

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(x, dtype=torch.float32, device=dev)

    floats = [w(nb, B, 3 * H, s=0.5), w(nb, 2, B, H, s=0.5), w(B, E, s=0.5),
              w(V, E, s=1.0), w(E, 3 * H), w(H, 3 * H), w(3 * H, s=0.1),
              w(H, 3 * H), w(3 * H, s=0.1), w(H, 3 * H), w(3 * H, s=0.1),
              w(H, V), w(V, s=0.1)]
    score = torch.tensor(rng.randint(0, V, (T, B)), dtype=torch.int32, device=dev)
    return score, floats


def _ms(fn, iters=200, warmup=10):
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


# The wide and deep shapes' plans: gru_chain (D, B, H), among them the
# tick loop's backward chains at H=512 (4 beats x 256 rows, one
# direction), and the tick loop's forward (B, H, E, V, L)
GRU_SHAPES = ((2, 256, 512), (1, 256, 512), (1, 256, 384), (2, 100, 512), (1, 1024, 512))
HIER_SHAPES = ((256, 256, 10, 130, 2), (256, 512, 10, 130, 2), (256, 128, 10, 130, 1),
               (256, 128, 10, 130, 3), (256, 128, 10, 130, 4))


def held_report():
    """Lines: the clusters of C CTAs each kernel layout can keep on the
    card at once (cudaOccupancyMaxActiveClusters) at one CTA an SM
    (200,000 B of shared memory) and at two (100,000 B, where the
    kernel's registers allow it), beside ``CLUSTERS_HELD``; then each
    wide or deep shape's plan, the clusters it assumes and the card's."""
    glib, hlib = gk._library(), hk._library()
    kernels = {  # name: (registers key, held(stream, C, smem))
        "gru_chain fwd": lambda st, c, b: glib.gru_chain_resident_clusters(0, st, c, b),
        "gru_chain bwd": lambda st, c, b: glib.gru_chain_resident_clusters(1, st, c, b),
        "hier_tick_chain fwd": hlib.hier_tick_chain_resident_clusters,
    }
    lines = []
    for name, held in kernels.items():
        for stream in (0, 1):
            for smem in (200_000, 100_000):
                got = {c: held(stream, c, smem) for c in (1, 2, 4, 8)}
                lines.append(f"{name}, {'streamed' if stream else 'resident'}, {smem} B a CTA: "
                             f"the card holds clusters of C CTAs {got}")
    lines.append(f"the plans assume, by CTAs an SM: {gk.CLUSTERS_HELD}")
    for d, b, h in GRU_SHAPES:
        for backward in (False, True):
            p = gk.gru_plan(d, b, h, backward)
            got = glib.gru_chain_resident_clusters(int(backward), int(p.streamed), p.clusters,
                                                   p.smem_bytes)
            held = gk.held_clusters(p, "gru_bwd" if backward else "gru_fwd")
            lines.append(f"gru_chain {'bwd' if backward else 'fwd'} (D={d}, B={b}, H={h}): "
                         f"{p}; the plan assumes {held} clusters at once, the card holds "
                         f"{got}")
    for b, h, e, v, layers in HIER_SHAPES:
        p = hk.hier_plan(b, h, e, v, layers)
        got = hlib.hier_tick_chain_resident_clusters(int(p.streamed), p.clusters, p.smem_bytes)
        lines.append(f"hier_tick_chain fwd (B={b}, H={h}, E={e}, V={v}, L={layers}): {p}; "
                     f"the plan assumes {hk.held_clusters(p)} clusters at once, the card "
                     f"holds {got}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("plan_probe needs a CUDA card")
    dev, card = torch.device("cuda"), _card()
    score, floats = _inputs(dev)
    ints = [torch.tensor([k], dtype=torch.int32, device=dev) for k in (0, 5)]
    cfg = (True, 0.5, TPB, "argmax")
    lib = hk._library()
    default = hk.hier_plan(B, H, E, V)
    want = hk.hier_tick_chain_fwd_cuda(*cfg, *ints, score, *floats)
    print(f"default plan {default} | {card}")
    for line in held_report():
        print(f"{line} | {card}")
    for c, rb in PLANS:
        smem = 4 * hk.fwd_smem_floats(H, E, V, c, rb)
        if smem > hk.MAX_SMEM or rb * (H // c) > hk.THREADS:
            print(f"C={c} RB={rb}: {smem} B does not fit | {card}")
            continue
        plan = ChainPlan(c, rb, smem, (c * -(-B // rb), 1))
        got = hk.hier_tick_chain_fwd_cuda(*cfg, *ints, score, *floats, plan=plan)
        torch.cuda.synchronize()
        ok = torch.equal(got[1], want[1]) and torch.allclose(got[0], want[0], 1e-4, 1e-5)
        ms = _ms(lambda: hk.hier_tick_chain_fwd_cuda(*cfg, *ints, score, *floats, plan=plan))
        held = lib.hier_tick_chain_resident_clusters(0, c, smem)
        print(f"C={c} RB={rb}: {plan.grid[0] // c} clusters, {plan.ctas} CTAs, {smem} B; "
              f"the card holds {held} such clusters at once; fwd {ms:.5f} ms; "
              f"matches the default plan: {ok} | {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
