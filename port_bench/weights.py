"""Initial weights from the seed, made on the device and handed to both sides.

Every leaf of two or more dimensions is Xavier-normal, std
``sqrt(2 / (fan_in + fan_out))`` with the fans ``torch.nn.init`` computes
(``fan_in = shape[1]·rf``, ``fan_out = shape[0]·rf``, ``rf`` the product
of the trailing dimensions), drawn from one standard-normal call; every
other leaf (biases, learned inputs) is zero. That is the port's and the
JAX package's initialisation, with the numbers drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from port_bench.data import generator

Spec = Sequence[Tuple[str, Tuple[int, ...]]]


def xavier_std(shape: Tuple[int, ...]) -> float:
    rf = math.prod(shape[2:])
    return math.sqrt(2.0 / (shape[1] * rf + shape[0] * rf))


def init_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec``, in its order."""
    device = torch.device(device)
    mats = [(name, tuple(shape)) for name, shape in spec if len(shape) >= 2]
    total = sum(math.prod(shape) for _, shape in mats)
    draws = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, shape in spec:
        shape = tuple(shape)
        if len(shape) >= 2:
            n = math.prod(shape)
            out[name] = (draws[at:at + n] * xavier_std(shape)).reshape(shape)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
