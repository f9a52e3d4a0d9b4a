"""dSprites convolutional VAE in native NCHW.

Counterpart of ``DspritesVAE`` in ``arvae_tpu/models/image_vae.py``, at
its published width: encoder 4×(Conv k4 s2 p1 → ReLU) with 32
channels, 512 → 256 → 256 → (mean, log_std) heads, z_dim 10; mirrored
ConvTranspose decoder. Layer names and ``Sequential`` indices are the
reference PyTorch module's (``enc_conv.{0,2,4,6}``, ``enc_lin.{0,2}``,
``dec_lin.{0,2,4}``, ``dec_conv.{0,2,4,6}``), so
``utils/convert.py`` maps Flax parameters onto it one to one.

The reparametrisation (:func:`reparametrize`, shared with the
MeasureVAE) takes its noise as tensors (``eps``, ``eps_prior``), so a
test can hand both packages the same draws; :func:`draw_noise` makes
them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn


class VAEOutput(NamedTuple):
    logits: torch.Tensor  # decoder output, (B, 1, 64, 64)
    z_mean: torch.Tensor  # (B, z_dim)
    z_log_std: torch.Tensor  # (B, z_dim)
    z_tilde: torch.Tensor  # reparametrised sample, (B, z_dim)
    z_prior: torch.Tensor  # sample from N(0, I), (B, z_dim)


def reparametrize(z_mean: torch.Tensor, z_log_std: torch.Tensor,
                  eps: torch.Tensor, eps_prior: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one reparametrisation convention, shared by every model
    family (``reparametrize_keys`` in the JAX package): z̃ = μ + exp(log σ)·ε,
    and the prior sample z_prior = ε_prior. Returns (z_tilde, z_prior)."""
    return z_mean + torch.exp(z_log_std) * eps, eps_prior


def draw_noise(batch: int, z_dim: int, generator: torch.Generator,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eps, eps_prior), each (batch, z_dim) standard normal."""
    eps = torch.randn(batch, z_dim, generator=generator, device=device)
    eps_prior = torch.randn(batch, z_dim, generator=generator, device=device)
    return eps, eps_prior


class DspritesVAE(nn.Module):
    """64×64 single-channel conv VAE."""

    z_dim = 10

    def __init__(self, seed: int = 0):
        super().__init__()
        z_dim = self.z_dim
        self.enc_conv = nn.Sequential(
            nn.Conv2d(1, 32, 4, 2, 1), nn.ReLU(),
            nn.Conv2d(32, 32, 4, 2, 1), nn.ReLU(),
            nn.Conv2d(32, 32, 4, 2, 1), nn.ReLU(),
            nn.Conv2d(32, 32, 4, 2, 1), nn.ReLU(),
        )
        self.enc_lin = nn.Sequential(
            nn.Linear(512, 256), nn.ReLU(),
            nn.Linear(256, 256), nn.ReLU(),
        )
        self.enc_mean = nn.Linear(256, z_dim)
        self.enc_log_std = nn.Linear(256, z_dim)
        self.dec_lin = nn.Sequential(
            nn.Linear(z_dim, 256), nn.ReLU(),
            nn.Linear(256, 256), nn.ReLU(),
            nn.Linear(256, 512), nn.ReLU(),
        )
        self.dec_conv = nn.Sequential(
            nn.ConvTranspose2d(32, 32, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(32, 32, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(32, 32, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(32, 1, 4, 2, 1),
        )
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-normal weights and zero biases, the JAX package's init
        (drawn from ``generator``, so not the same numbers)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.xavier_normal_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.enc_conv(x).flatten(1)
        h = self.enc_lin(h)
        return self.enc_mean(h), self.enc_log_std(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_lin(z).view(z.shape[0], 32, 4, 4)
        return self.dec_conv(h)

    def forward(self, x: torch.Tensor, eps: torch.Tensor,
                eps_prior: torch.Tensor) -> VAEOutput:
        z_mean, z_log_std = self.encode(x)
        z_tilde, z_prior = reparametrize(z_mean, z_log_std, eps, eps_prior)
        return VAEOutput(
            logits=self.decode(z_tilde),
            z_mean=z_mean,
            z_log_std=z_log_std,
            z_tilde=z_tilde,
            z_prior=z_prior,
        )
