"""The fader-network baseline: the counterpart of
``arvae_tpu/models/image_fader.py``.

- ``MnistFaderNetwork`` / ``DspritesFaderNetwork``: the image VAE's
  encoder with its mean head only (a deterministic code ``z``) and its
  decoder conditioned on ``[z ‖ attributes]`` (6 morphometry columns for
  MNIST, 5 factors for dSprites), so its first linear layer takes
  ``z_dim + num_attributes`` inputs. The parameters are exactly the Flax
  fader's: the VAE's, ``enc_log_std`` left out.
- ``ImageFaderDiscriminator``: Linear(z → 64) → Dropout → SELU →
  Linear(64 → 32) → Dropout → SELU → Linear(32 → A) → sigmoid. Dropout
  comes before the activation here (the Flax module's order), unlike the
  VAE's SELU → Dropout; its keep masks, like the VAE's, are tensors drawn
  by the caller (:meth:`ImageFaderDiscriminator.dropout_masks`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from arvae_tpu_torch.models.image_vae import (DspritesVAE, MaskedDropout, MnistVAE,
                                             init_weights, keep_masks)


class ImageFaderDiscriminator(nn.Module):
    """Latent attribute discriminator; layer names ``layers.{0,3,6}``."""

    HIDDEN = (64, 32)

    def __init__(self, num_attributes: int, z_dim: int, dropout_rate: float = 0.5,
                 seed: int = 0):
        super().__init__()
        self.num_attributes = num_attributes
        self.dropout_rate = dropout_rate
        h1, h2 = self.HIDDEN
        self.layers = nn.Sequential(
            nn.Linear(z_dim, h1), MaskedDropout(dropout_rate), nn.SELU(),
            nn.Linear(h1, h2), MaskedDropout(dropout_rate), nn.SELU(),
            nn.Linear(h2, num_attributes),
        )
        init_weights(self, torch.Generator().manual_seed(seed))

    def dropout_masks(self, batch: int, generator: torch.Generator,
                      device) -> Optional[Tuple[torch.Tensor, ...]]:
        """The two keep masks of a training forward; None at rate 0."""
        return keep_masks(batch, [(h,) for h in self.HIDDEN], self.dropout_rate,
                          generator, device)

    def forward(self, z: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Attribute predictions in (0, 1); ``masks`` None: no dropout."""
        layers, h = self.layers, z
        for j, i in enumerate((0, 3)):
            h = layers[i + 2](layers[i + 1](layers[i](h), masks[j] if masks else None))
        return torch.sigmoid(layers[6](h))


class _FaderForward:
    """The fader forward shared by both datasets: a deterministic encode
    (the mean head) and a label-conditioned decode. ``masks`` are the
    VAE's keep masks: the encoder's (first three) and the decoder's (last
    two) for MNIST, None for dSprites and in eval mode."""

    def encode_deterministic(self, x: torch.Tensor,
                             masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        return self.enc_mean(self._enc_hidden(x, masks))

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, z)."""
        z = self.encode_deterministic(x, masks)
        return self.decode(torch.cat([z, labels], dim=1), masks), z


class MnistFaderNetwork(_FaderForward, MnistVAE):
    """MnistVAE's widths; 6 attributes (the morphometry, digit left out)."""

    num_attributes = 6

    def __init__(self, dropout_rate: float = 0.5, seed: int = 0):
        super().__init__(dropout_rate=dropout_rate, seed=seed,
                         decoder_in=self.z_dim + self.num_attributes)
        del self.enc_log_std


class DspritesFaderNetwork(_FaderForward, DspritesVAE):
    """DspritesVAE's widths; 5 attributes (the factors, colour left out)."""

    num_attributes = 5

    def __init__(self, seed: int = 0):
        super().__init__(seed=seed, decoder_in=self.z_dim + self.num_attributes)
        del self.enc_log_std
