"""Plain PyTorch reference of the dSprites fader network's training step.

The networks are the reference implementation's (ashispati/ar-vae,
``imagefader/image_fader.py``). ``DspritesFaderNetwork``: the
``DspritesVAE`` encoder (four convolutions, kernel 4, stride 2, padding
1, 32 channels, ReLU; 512 → 256 → 256 dense layers, ReLU) with its mean
head only, so the code ``z`` is deterministic, and the VAE's decoder
(3 dense layers, four transposed convolutions, ReLU between, none
after the last) taking ``[z ‖ the 5 normalised attributes]``.
``ImageFaderDiscriminator``: z → 64 → 32 → 5, each hidden layer Linear,
then Dropout, then SELU, and a sigmoid on the output.

A step, after ``image_fader_trainer.py``:

1. the batch is the bit-packed rows the epoch permutation picks,
   unpacked MSB first into 0/1 pixels; the attributes are the label
   columns after the first (colour), each mapped onto [0, 1] by its
   bounds;
2. the step's dropout masks are drawn, in this order, from a generator
   seeded as the trainer seeds its noise generator: the discriminator's
   two for its own update, then its two for the fader's update (each
   entry kept where a uniform draw is at least the rate; a kept entry
   divided by 1 − rate);
3. the discriminator's update: ``z`` of the batch without a gradient,
   the loss Σ(pred − attributes)² / B, its gradient and one Adam step;
4. the fader's update against the updated discriminator: the
   reconstruction loss (Σ BCE-with-logits over the batch size) plus β
   times the discriminator's loss on the flipped attributes ``1 − a``,
   its gradient with respect to the fader's parameters only, and one
   Adam step of the fader's own Adam.

Departures from the reference's code, which the port shares:

- the reference raises for dSprites' normalisation factors
  (``image_fader_trainer.py:239-240``); the configuration's
  ``label_bounds``, the dSprites grid's bounds, stand in;
- its discriminator's first layer is 16 wide (``image_fader.py:13``,
  MNIST's z); here it takes the dSprites fader's z of 10;
- the dropout masks are drawn by the caller from the step's generator
  (Flax's order of the layers, Dropout before SELU), not by
  ``nn.Dropout``;
- the discriminator starts from weights drawn from the run's seed under
  a purpose of its own (:func:`disc_start`), as the fader does from the
  benchmark's weights, not from PyTorch's default initialisation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.data import derive
from port_bench.reference.common import (PERM_SEED_OFFSET, Adam, Steps, bernoulli_recon,
                                         leaves, precision)
from port_bench.reference.dsprites_vae import CONV, unpack
from port_bench.reference.dsprites_vae import param_spec as vae_spec
from port_bench.weights import init_weights

DISC_LAYERS = ("0", "3", "6")


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The fader's leaves: ``DspritesVAE``'s without ``enc_log_std``, its
    decoder's first layer taking z plus the attributes."""
    m = cfg["model"]
    wide = m["latent_space_dim"] + m["num_attributes"]
    spec = []
    for name, shape in vae_spec(cfg):
        if name.startswith("enc_log_std."):
            continue
        if name == "dec_lin.0.weight":
            shape = (shape[0], wide)
        spec.append((name, shape))
    return spec


def disc_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The discriminator's leaves, named as the port's ``layers.{0,3,6}``."""
    m = cfg["model"]
    widths = [m["latent_space_dim"], *m["disc_hidden"], m["num_attributes"]]
    spec = []
    for name, fan_in, fan_out in zip(DISC_LAYERS, widths, widths[1:]):
        spec += [(f"layers.{name}.weight", (fan_out, fan_in)), (f"layers.{name}.bias", (fan_out,))]
    return spec


def disc_start(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The discriminator's initial weights, drawn as the fader's are
    (``weights.init_weights``) from the run's seed under a purpose of
    their own."""
    return init_weights(disc_spec(cfg), derive(seed, "discriminator"), device)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The deterministic code: the encoder's mean head."""
    h = x
    for name in CONV:
        h = F.relu(F.conv2d(h, p[f"enc_conv.{name}.weight"], p[f"enc_conv.{name}.bias"],
                            stride=2, padding=1))
    h = h.flatten(1)
    for name in ("0", "2"):
        h = F.relu(F.linear(h, p[f"enc_lin.{name}.weight"], p[f"enc_lin.{name}.bias"]))
    return F.linear(h, p["enc_mean.weight"], p["enc_mean.bias"])


def decode(p: Dict[str, torch.Tensor], cfg: dict, za: torch.Tensor) -> torch.Tensor:
    """The logits of ``[z ‖ attributes]``."""
    S, C = cfg["model"]["image_size"], cfg["model"]["channels"]
    d = za
    for name in ("0", "2", "4"):
        d = F.relu(F.linear(d, p[f"dec_lin.{name}.weight"], p[f"dec_lin.{name}.bias"]))
    d = d.view(za.shape[0], C, S // 16, S // 16)
    for i, name in enumerate(CONV):
        d = F.conv_transpose2d(d, p[f"dec_conv.{name}.weight"], p[f"dec_conv.{name}.bias"],
                               stride=2, padding=1)
        if i < len(CONV) - 1:
            d = F.relu(d)
    return d


def discriminate(q: Dict[str, torch.Tensor], z: torch.Tensor, masks, rate: float
                 ) -> torch.Tensor:
    """The attribute predictions in (0, 1): Linear, Dropout (``masks``),
    SELU for each hidden layer, then Linear and a sigmoid."""
    h = z
    for name, keep in zip(DISC_LAYERS, masks):
        h = F.linear(h, q[f"layers.{name}.weight"], q[f"layers.{name}.bias"])
        h = F.selu(torch.where(keep, h / (1.0 - rate), 0.0))
    last = DISC_LAYERS[-1]
    return torch.sigmoid(F.linear(h, q[f"layers.{last}.weight"], q[f"layers.{last}.bias"]))


def disc_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Σ(pred − target)² over the batch size."""
    return torch.sum(torch.square(pred - target)) / pred.shape[0]


def run_steps(cfg: dict, traffic: dict, seed: int, inputs: Dict[str, torch.Tensor],
              weights: Dict[str, torch.Tensor], steps: int, tf32: bool = False,
              fed=None) -> Steps:
    """The first ``steps`` training steps of both networks, the fader
    from ``weights`` and the discriminator from :func:`disc_start`, on
    ``inputs``; the fader's loss, first gradient and parameters are
    returned (the model feeds nothing back: ``fed`` is None)."""
    m, o = cfg["model"], cfg["objective"]
    packed, labels = inputs["packed"], inputs["labels"]
    dev, B, S = packed.device, traffic["batch"], m["image_size"]
    rate, hidden = m["disc_dropout"], m["disc_hidden"]
    perm = torch.randperm(packed.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(seed + PERM_SEED_OFFSET))
    gen = torch.Generator(dev).manual_seed(seed)
    lo, hi = (torch.tensor(c, dtype=torch.float32, device=dev) for c in zip(*o["label_bounds"]))

    p, q = leaves(weights), leaves(disc_start(cfg, seed, dev))
    adam_p, adam_q = Adam(p, o["lr"]), Adam(q, o["lr"])
    losses, grad1 = [], {}
    with precision(tf32):
        for i in range(steps):
            idx = perm[i * B:(i + 1) * B]
            x = unpack(packed[idx], S * S).view(B, 1, S, S)
            a = (labels[idx][:, 1:] - lo) / (hi - lo)
            draws = [torch.rand(B, h, generator=gen, device=dev) >= rate
                     for _ in range(2) for h in hidden]
            with torch.no_grad():
                z = encode(p, x)
            d_loss = disc_loss(discriminate(q, z, draws[:2], rate), a)
            adam_q.step(dict(zip(q, torch.autograd.grad(d_loss, list(q.values())))))

            z = encode(p, x)
            logits = decode(p, cfg, torch.cat([z, a], dim=1))
            adv = disc_loss(discriminate(q, z, draws[2:], rate), 1.0 - a)
            loss = bernoulli_recon(logits, x) + o["beta"] * adv
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            if i == 0:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            adam_p.step(grads)
    return Steps(losses, grad1, {k: v.detach().clone() for k, v in p.items()})
