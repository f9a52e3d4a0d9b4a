"""The convolutional image VAEs in native NCHW.

Counterparts of ``arvae_tpu/models/image_vae.py``, each at its
published width:

- ``MnistVAE``: encoder 3×(Conv k4 s1 VALID → SELU → Dropout 0.5) with
  channels 1→64→64→8, flatten 19·19·8 = 2888 → Linear 256 (SELU) →
  (mean, log_std) heads, z_dim 16; decoder Linear 256 → Linear 2888
  (SELU each) and 3 stride-1 ConvTranspose (SELU and Dropout after the
  first two). Layer names ``enc_conv.{0,3,6}``, ``enc_lin.0``,
  ``dec_lin.{0,2}``, ``dec_conv.{0,3,6}``.
- ``DspritesVAE``: encoder 4×(Conv k4 s2 p1 → ReLU) with 32 channels,
  512 → 256 → 256 → heads, z_dim 10; mirrored ConvTranspose decoder.
  Layer names ``enc_conv.{0,2,4,6}``, ``enc_lin.{0,2}``,
  ``dec_lin.{0,2,4}``, ``dec_conv.{0,2,4,6}``.

The names and ``Sequential`` indices are the reference PyTorch
modules', so ``utils/convert.py`` maps Flax parameters onto them one to
one. The reparametrisation (:func:`reparametrize`, shared with the
MeasureVAE) takes its noise as tensors (``eps``, ``eps_prior``), and
``MnistVAE`` its dropout masks too, so a test can hand both packages the
same draws and a train step repeats bitwise from one generator;
:func:`draw_noise` and :meth:`MnistVAE.dropout_masks` make them from a
``torch.Generator``.

Both take the JAX models' ``compute_dtype`` (the image CLI's ``--bf16``):
at ``torch.bfloat16`` each convolution and hidden linear layer casts its
input, weight and bias to bfloat16 and computes in it, as a Flax module
with ``dtype=jnp.bfloat16`` does, layer by layer (``torch.autocast``
would pick other ops); the parameters stay float32, the ``enc_mean`` and
``enc_log_std`` heads compute in float32 on the promoted hidden state,
and the logits leave as float32. At the default float32 every layer is
called as it is, a convolution on a card with its weight gradient from
the hand-written kernel of ``ops/conv_wgrad_kernel.py`` (the same
forward, input and bias gradients). ``decoder_in`` widens the decoder's
first linear layer (default ``z_dim``): the fader networks decode
``[z ‖ attributes]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arvae_tpu_torch.ops import conv_wgrad_kernel


class VAEOutput(NamedTuple):
    logits: torch.Tensor  # decoder output, (B, 1, 28, 28) or (B, 1, 64, 64)
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


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Xavier-normal weights and zero biases, the JAX package's init
    (drawn from ``generator``, so not the same numbers)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.xavier_normal_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)


def keep_masks(batch: int, shapes: Sequence[Tuple[int, ...]], rate: float,
               generator: torch.Generator, device) -> Optional[Tuple[torch.Tensor, ...]]:
    """Dropout keep masks of (batch, *shape) for each of ``shapes``, each
    entry kept with probability 1 − rate, drawn from ``generator`` in
    order; None at rate 0."""
    if rate == 0.0:
        return None
    return tuple(torch.rand(batch, *shape, generator=generator, device=device) >= rate
                 for shape in shapes)


_CONV_LAYERS = (nn.Conv2d, nn.ConvTranspose2d)
_COMPUTE_LAYERS = (nn.Linear, *_CONV_LAYERS)
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _selu_as_flax(h: torch.Tensor) -> torch.Tensor:
    """SELU as Flax computes it in ``h``'s dtype below float32: its two
    constants rounded to that dtype (scale 1.046875 in bfloat16), each
    operation rounded. ATen's SELU computes in float32 and rounds once,
    0.4% above it in bfloat16."""
    alpha, scale = (float(torch.tensor(c, dtype=h.dtype)) for c in (_SELU_ALPHA, _SELU_SCALE))
    return scale * torch.where(h > 0, h, alpha * torch.expm1(h))


class _ComputeDtype(nn.Module):
    """Runs the conv and hidden linear layers in ``self.compute_dtype``."""

    def _apply_layer(self, layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """``layer(h)``; at float32 a conv layer through
        ``conv_wgrad_kernel.conv_layer`` (its weight gradient from the
        hand-written kernel on a card, where the layer's shape allows);
        below float32, a conv or linear layer computes in
        ``compute_dtype`` with its input, weight and bias cast to it, and
        SELU as Flax computes it there."""
        dt = self.compute_dtype
        if dt == torch.float32:
            if isinstance(layer, _CONV_LAYERS):
                return conv_wgrad_kernel.conv_layer(layer, h)
            return layer(h)
        if isinstance(layer, nn.SELU):
            return _selu_as_flax(h)
        if not isinstance(layer, _COMPUTE_LAYERS):
            return layer(h)
        w, b, h = layer.weight.to(dt), layer.bias.to(dt), h.to(dt)
        if isinstance(layer, nn.Linear):
            return F.linear(h, w, b)
        if isinstance(layer, nn.ConvTranspose2d):
            return F.conv_transpose2d(h, w, b, layer.stride, layer.padding)
        return F.conv2d(h, w, b, layer.stride, layer.padding)

    def _run(self, seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        """``seq(h)``, each layer through :meth:`_apply_layer`."""
        for layer in seq:
            h = self._apply_layer(layer, h)
        return h


class DspritesVAE(_ComputeDtype):
    """64×64 single-channel conv VAE. It has no dropout: the ``masks`` its
    encoder's hidden state and decoder take (for the fader networks'
    sake) are None."""

    z_dim = 10
    dropout_rate = 0.0
    MASK_SHAPES = ()

    def __init__(self, seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                 decoder_in: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
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
            nn.Linear(decoder_in or z_dim, 256), nn.ReLU(),
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

    init_weights = init_weights

    def _enc_hidden(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """The encoder's hidden state, promoted to float32 for the heads."""
        h = self._run(self.enc_conv, x).flatten(1)
        return self._run(self.enc_lin, h).float()

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self._enc_hidden(x)
        return self.enc_mean(h), self.enc_log_std(h)

    def decode(self, z: torch.Tensor, masks=None) -> torch.Tensor:
        h = self._run(self.dec_lin, z).view(z.shape[0], 32, 4, 4)
        return self._run(self.dec_conv, h).float()

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


class MaskedDropout(nn.Module):
    """Dropout by a given keep mask: ``x / (1 − rate)`` where the mask is
    true, 0 elsewhere (Flax's ``nn.Dropout``); no mask, no dropout."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def _selu_drop(rate: float):
    return nn.SELU(), MaskedDropout(rate)


class MnistVAE(_ComputeDtype):
    """28×28 single-channel conv VAE with SELU and dropout.

    ``forward(x, eps, eps_prior, masks)``: ``masks`` are the five keep
    masks of :meth:`dropout_masks` (training), or None (no dropout: eval
    mode, or a rate of 0)."""

    z_dim = 16
    inter_dim = 19
    inter_channels = 8

    def __init__(self, dropout_rate: float = 0.5, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 decoder_in: Optional[int] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        z_dim, c, n = self.z_dim, self.inter_channels, self.inter_dim
        self.enc_conv = nn.Sequential(
            nn.Conv2d(1, 64, 4, 1), *_selu_drop(dropout_rate),
            nn.Conv2d(64, 64, 4, 1), *_selu_drop(dropout_rate),
            nn.Conv2d(64, c, 4, 1), *_selu_drop(dropout_rate),
        )
        self.enc_lin = nn.Sequential(nn.Linear(n * n * c, 256), nn.SELU())
        self.enc_mean = nn.Linear(256, z_dim)
        self.enc_log_std = nn.Linear(256, z_dim)
        self.dec_lin = nn.Sequential(
            nn.Linear(decoder_in or z_dim, 256), nn.SELU(),
            nn.Linear(256, n * n * c), nn.SELU(),
        )
        self.dec_conv = nn.Sequential(
            nn.ConvTranspose2d(c, 64, 4, 1), *_selu_drop(dropout_rate),
            nn.ConvTranspose2d(64, 64, 4, 1), *_selu_drop(dropout_rate),
            nn.ConvTranspose2d(64, 1, 4, 1),
        )
        init_weights(self, torch.Generator().manual_seed(seed))

    # (channels, side, side) of each dropout's input: the encoder's three,
    # the decoder's two
    MASK_SHAPES = ((64, 25, 25), (64, 22, 22), (8, 19, 19), (64, 22, 22), (64, 25, 25))

    def dropout_masks(self, batch: int, generator: torch.Generator,
                      device: torch.device) -> Optional[Tuple[torch.Tensor, ...]]:
        """The five keep masks of a training forward (each entry kept with
        probability 1 − rate), drawn from ``generator``; None at rate 0."""
        return keep_masks(batch, self.MASK_SHAPES, self.dropout_rate, generator, device)

    def _stack(self, seq: nn.Sequential, h: torch.Tensor,
               masks: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """Runs a Sequential of (layer, SELU, dropout) triples, a bare last
        layer allowed, the j-th dropout with ``masks[j]``."""
        layers = list(seq)
        for j, i in enumerate(range(0, len(layers), 3)):
            h = self._apply_layer(layers[i], h)
            if i + 2 < len(layers):
                h = layers[i + 2](self._apply_layer(layers[i + 1], h),
                                  masks[j] if masks else None)
        return h

    def _enc_hidden(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """The encoder's hidden state (the first three of ``masks``),
        promoted to float32 for the heads."""
        h = self._stack(self.enc_conv, x, masks and masks[:3])
        return self._run(self.enc_lin, h.flatten(1)).float()

    def encode(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self._enc_hidden(x, masks)
        return self.enc_mean(h), self.enc_log_std(h)

    def decode(self, z: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """Logits from ``z`` (the last two of five ``masks``)."""
        n = self.inter_dim
        h = self._run(self.dec_lin, z).view(z.shape[0], self.inter_channels, n, n)
        return self._stack(self.dec_conv, h, masks and masks[3:]).float()

    def forward(self, x: torch.Tensor, eps: torch.Tensor, eps_prior: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> VAEOutput:
        z_mean, z_log_std = self.encode(x, masks)
        z_tilde, z_prior = reparametrize(z_mean, z_log_std, eps, eps_prior)
        return VAEOutput(
            logits=self.decode(z_tilde, masks),
            z_mean=z_mean,
            z_log_std=z_log_std,
            z_tilde=z_tilde,
            z_prior=z_prior,
        )
