"""Times ``hier_tick_chain``'s forward under several launch plans on one
card, beside how many clusters of each size the card holds at once.

Run on the card from the repository root:

    python -m arvae_tpu_torch.utils.plan_probe

At B=256, H=128, E=10, V=130, T=24, 6 ticks a beat, training with
dropout 0.5, free-running: for each plan (C CTAs a cluster, RB rows a
cluster) the clusters it launches, the clusters of C CTAs with its
shared memory that the card holds at once
(``cudaOccupancyMaxActiveClusters``), and its ms per call (CUDA events
over 200 calls after 10 warm). Each plan's weights must match the
default plan's within rtol 1e-4 / atol 1e-5 and its samples equal.
Prints the card's name and power limit on every line."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

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
    for c in (1, 2, 4, 8):  # one CTA an SM: more than half its shared memory
        print(f"clusters of {c} CTA(s) of 200,000 B the card holds at once: "
              f"{lib.hier_tick_chain_resident_clusters(c, 200_000)} | {card}")
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
        held = lib.hier_tick_chain_resident_clusters(c, smem)
        print(f"C={c} RB={rb}: {plan.grid[0] // c} clusters, {plan.ctas} CTAs, {smem} B; "
              f"the card holds {held} such clusters at once; fwd {ms:.5f} ms; "
              f"matches the default plan: {ok} | {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
