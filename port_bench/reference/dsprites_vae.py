"""Plain PyTorch reference of the dSprites AR-VAE training step.

The model is the reference implementation's ``DspritesVAE``
(ashispati/ar-vae, ``imagevae/dsprites_vae.py``): four convolutions
(kernel 4, stride 2, padding 1, 32 channels, ReLU), 512 → 256 → 256
dense layers (ReLU), the mean and log-std heads to z; the decoder
mirrors it with 3 dense layers and four transposed convolutions (ReLU
between, none after the last). A batch is the bit-packed rows the epoch
permutation picks, unpacked MSB first into 0/1 pixels. The loss is the
Bernoulli reconstruction (Σ BCE-with-logits over the batch size) plus
β·|KLD − c| plus γ·Σ_r of the AR term of latent dim r against label
column r. The draws are ε and ε_prior (each B × z standard normal)
from a generator seeded as the trainer seeds its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.common import (PERM_SEED_OFFSET, Steps, ar_term, bernoulli_recon,
                                         kld, precision, train)

CONV = ("0", "2", "4", "6")


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    m = cfg["model"]
    C, K, Z, (h1, h2) = m["channels"], m["kernel"], m["latent_space_dim"], m["dense"]
    flat = C * (m["image_size"] // 16) ** 2
    spec = []
    for i, name in enumerate(CONV):
        spec += [(f"enc_conv.{name}.weight", (C, 1 if i == 0 else C, K, K)),
                 (f"enc_conv.{name}.bias", (C,))]
    spec += [("enc_lin.0.weight", (h1, flat)), ("enc_lin.0.bias", (h1,)),
             ("enc_lin.2.weight", (h2, h1)), ("enc_lin.2.bias", (h2,)),
             ("enc_mean.weight", (Z, h2)), ("enc_mean.bias", (Z,)),
             ("enc_log_std.weight", (Z, h2)), ("enc_log_std.bias", (Z,)),
             ("dec_lin.0.weight", (h2, Z)), ("dec_lin.0.bias", (h2,)),
             ("dec_lin.2.weight", (h1, h2)), ("dec_lin.2.bias", (h1,)),
             ("dec_lin.4.weight", (flat, h1)), ("dec_lin.4.bias", (flat,))]
    for i, name in enumerate(CONV):
        out = 1 if i == len(CONV) - 1 else C
        spec += [(f"dec_conv.{name}.weight", (C, out, K, K)),
                 (f"dec_conv.{name}.bias", (out,))]
    return spec


def unpack(rows: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """(B, D) uint8 → (B, n_pixels) float32 bits, the high bit of each
    byte first."""
    shifts = torch.arange(7, -1, -1, device=rows.device)
    bits = (rows.long()[:, :, None] >> shifts) & 1
    return bits.reshape(rows.shape[0], -1)[:, :n_pixels].float()


def forward_loss(p: Dict[str, torch.Tensor], cfg: dict, rows: torch.Tensor,
                 labels: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    m, o = cfg["model"], cfg["objective"]
    S, C, Z = m["image_size"], m["channels"], m["latent_space_dim"]
    B, dev = rows.shape[0], rows.device
    x = unpack(rows, S * S).view(B, 1, S, S)
    eps = torch.randn(B, Z, generator=gen, device=dev)
    torch.randn(B, Z, generator=gen, device=dev)  # ε_prior: drawn, unused by the loss

    h = x
    for name in CONV:
        h = F.relu(F.conv2d(h, p[f"enc_conv.{name}.weight"], p[f"enc_conv.{name}.bias"],
                            stride=2, padding=1))
    h = h.flatten(1)
    for name in ("0", "2"):
        h = F.relu(h @ p[f"enc_lin.{name}.weight"].t() + p[f"enc_lin.{name}.bias"])
    z_mean = h @ p["enc_mean.weight"].t() + p["enc_mean.bias"]
    z_log_std = h @ p["enc_log_std.weight"].t() + p["enc_log_std.bias"]
    z = z_mean + torch.exp(z_log_std) * eps

    d = z
    for name in ("0", "2", "4"):
        d = F.relu(d @ p[f"dec_lin.{name}.weight"].t() + p[f"dec_lin.{name}.bias"])
    d = d.view(B, C, S // 16, S // 16)
    for i, name in enumerate(CONV):
        d = F.conv_transpose2d(d, p[f"dec_conv.{name}.weight"], p[f"dec_conv.{name}.bias"],
                               stride=2, padding=1)
        if i < len(CONV) - 1:
            d = F.relu(d)

    loss = bernoulli_recon(d, x) + kld(z_mean, z_log_std, o["beta"], o["capacity"])
    if o["reg_dim"]:
        loss = loss + ar_term(z, labels, o["reg_dim"], o["gamma"], o["delta"])
    return loss


def run_steps(cfg: dict, traffic: dict, seed: int, inputs: Dict[str, torch.Tensor],
              weights: Dict[str, torch.Tensor], steps: int, tf32: bool = False,
              fed=None) -> Steps:
    """The first ``steps`` training steps from ``weights`` on ``inputs``
    (the model feeds nothing back: ``fed`` is None)."""
    packed, labels = inputs["packed"], inputs["labels"]
    dev, B = packed.device, traffic["batch"]
    perm = torch.randperm(packed.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(seed + PERM_SEED_OFFSET))
    gen = torch.Generator(dev).manual_seed(seed)

    def loss_fn(p, i):
        idx = perm[i * B:(i + 1) * B]
        return forward_loss(p, cfg, packed[idx], labels[idx], gen), {}

    with precision(tf32):
        return train(loss_fn, weights, cfg["objective"]["lr"], steps)
