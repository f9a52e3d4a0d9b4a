"""The recurrence kernels' outputs at the music step's H=128 shapes,
bitwise against another checkout of the port.

Run on the card from each checkout's root, the other checkout first:

    PYTHONPATH=. python arvae_tpu_torch/utils/bits_probe.py save /tmp/bits.pt
    PYTHONPATH=. python arvae_tpu_torch/utils/bits_probe.py compare /tmp/bits.pt

``save`` runs ``gru_chain`` at (24, 2, 256, 128), (4, 1, 256, 128) and
(24, 1, 256, 128) and ``hier_tick_chain`` at B=256, H=128, E=10, V=130,
T=24, training with dropout 0.5, free-running, at 6 and 24 ticks a beat,
forward and backward, on inputs drawn from fixed seeds, and saves every
output. ``compare`` runs the same here and prints which outputs are not
bitwise equal; each backward runs on the saved forward's outputs, so
that a forward's difference does not hide the backward's. It reaches
the kernels through their wrappers' 2-layer signatures, which every
version of the port has."""

from __future__ import annotations

import inspect
import sys

import numpy as np
import torch

from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops import hier_decoder_kernel as hk


def _inputs(dev):
    out = {}
    for t, d, b, h in ((24, 2, 256, 128), (4, 1, 256, 128), (24, 1, 256, 128)):
        rng = np.random.RandomState(t * 7 + d)

        def f(*shape, s):
            return torch.tensor(rng.randn(*shape) * s, dtype=torch.float32, device=dev)

        out[f"gru_chain {(t, d, b, h)}"] = [
            f(t, d, b, 3 * h, s=0.5), f(d, h, 3 * h, s=1 / np.sqrt(h)), f(d, 3 * h, s=0.1),
            f(d, b, h, s=0.3), f(t, d, b, h, s=1.0)]
    rng = np.random.RandomState(5)
    B, H, E, V, T = 256, 128, 10, 130, 24

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(x, dtype=torch.float32, device=dev)

    for tpb in (6, 24):
        nb = -(-T // tpb)
        out[f"hier_tick_chain tpb={tpb}"] = [
            w(nb, B, 3 * H, s=0.5), w(nb, 2, B, H, s=0.5), w(B, E, s=0.5), w(V, E, s=1.0),
            w(E, 3 * H), w(H, 3 * H), w(3 * H, s=0.1), w(H, 3 * H), w(3 * H, s=0.1),
            w(H, 3 * H), w(3 * H, s=0.1), w(H, V), w(V, s=0.1), w(T, B, V, s=1.0),
            torch.tensor(rng.randint(0, V, (T, B)), dtype=torch.int32, device=dev)]
    return out


def _hier_bwd(cfg, seed, samples, hiddens, weights, ct, floats):
    if "hiddens" in inspect.signature(hk.hier_tick_chain_bwd_cuda).parameters:
        return hk.hier_tick_chain_bwd_cuda(*cfg, seed, samples, hiddens, weights, ct, *floats)
    return hk.hier_tick_chain_bwd_cuda(*cfg, seed, samples, *hiddens, weights, ct, *floats)


def run(dev, saved=None):
    """{case: outputs}; the backwards from ``saved``'s forwards if given."""
    res = {}
    for name, v in _inputs(dev).items():
        if name.startswith("gru_chain"):
            *args, ct = v
            outs = gk.gru_chain_fwd_cuda(*args)
            src = outs if saved is None else saved[name][0]
            res[name] = [outs, *gk.gru_chain_bwd_cuda(*args, src, ct)]
            continue
        tpb = int(name.split("=")[1])
        *floats, ct, score = v
        teacher = torch.zeros(1, dtype=torch.int32, device=dev)
        seed = torch.tensor([77], dtype=torch.int32, device=dev)
        fwd = hk.hier_tick_chain_fwd_cuda(True, 0.5, tpb, "argmax", teacher, seed, score,
                                          *floats)
        src = fwd if saved is None else saved[name][:4]
        res[name] = [*fwd, *_hier_bwd((True, 0.5, tpb), seed, src[1], list(src[2:4]), src[0],
                                      ct, floats)]
    torch.cuda.synchronize()
    return res


def main(argv) -> int:
    mode, path = argv
    dev = torch.device("cuda")
    if mode == "save":
        torch.save({k: [x.cpu() for x in v] for k, v in run(dev).items()}, path)
        print(f"saved {path}")
        return 0
    saved = {k: [x.to(dev) for x in v] for k, v in torch.load(path).items()}
    differ = [f"{name}[{i}]" for name, outs in run(dev, saved).items()
              for i, (x, y) in enumerate(zip(outs, saved[name]))
              if not torch.equal(x.view(torch.int32), y.view(torch.int32))]
    print("bitwise equal to the other checkout's outputs (backwards from its forwards): "
          + ("all" if not differ else f"all but {differ}"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
