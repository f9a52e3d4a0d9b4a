"""The fader-network trainer: the counterpart of
``arvae_tpu/training/fader_trainer.py``.

One step is two Adam updates, in the JAX step's order:

1. the fader encodes the batch (its encoder's dropout on) and the code
   ``z`` is detached;
2. the discriminator takes one step on ``Σ(pred − y)² / B`` against the
   true attributes ``y``, normalised to [0, 1];
3. the fader takes one step against the **updated** discriminator: the
   reconstruction loss plus β times the discriminator loss on the
   flipped attributes ``1 − y``, from a second encode with fresh dropout.
   Its gradient reaches the fader's parameters only.

Each step's dropout masks are drawn from the trainer's noise generator
as one :class:`FaderNoise`: as many independent masks as the JAX step
draws from its keys (the encoder's and the discriminator's in step 1;
the encoder's, the discriminator's and the decoder's in step 3). The
fader has no AR term, so its step launches no reg kernel; on a card its
convolutions' weight gradients (step 3's backward) take the kernel of
``ops/conv_wgrad_kernel.py``.

The evaluation harvests the deterministic codes (the mean head, eval
mode) of the eval split with the normalised attributes and writes the
five metrics and the protocol stamp: no test pass and no judge, as the
JAX fader's ``results_dict.json`` has neither. A label traversal
(:meth:`ImageFaderTrainer.compute_latent_interpolations`) decodes a code
beside one attribute swept from 0 to 1; its TensorBoard hook is not
ported.

Each update opens the phase spans the other trainers open (``forward``,
``loss``, then :meth:`BaseTrainer.update`'s ``optimizer``, ``backward``,
``optimizer``); inside the forward, ``encode`` holds step 1's no-grad
encode and ``disc`` each discriminator forward.

On a rank of a data-parallel step the masks are drawn for the global
batch and the rank's rows taken, both losses are the global batch's,
and each of the two updates sums its own network's gradients over the
ranks before its Adam step. The normalised labels use fixed bounds, not
batch statistics, so they need no collective.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.core.config import trainer_config_string
from arvae_tpu_torch.data.device_data import Metrics
from arvae_tpu_torch.models.image_fader import (DspritesFaderNetwork,
                                               ImageFaderDiscriminator, MnistFaderNetwork)
from arvae_tpu_torch.models.image_vae import keep_masks
from arvae_tpu_torch.ops.losses import pixel_accuracy, reconstruction_loss
from arvae_tpu_torch.parallel import DataContext, RowShare
from arvae_tpu_torch.training.base import load_adam_state, make_adam
from arvae_tpu_torch.training.image_trainer import MNIST_NORMALIZATION_FACTORS, ImageVAETrainer
from arvae_tpu_torch.utils import profiling
from arvae_tpu_torch.utils.plotting import make_grid

# Each dSprites factor's (low, high)
DSPRITES_NORMALIZATION_FACTORS = {
    "shape": (1.0, 3.0),
    "scale": (0.5, 1.0),
    "orientation": (0.0, 2.0 * np.pi),
    "posx": (0.0, 1.0),
    "posy": (0.0, 1.0),
}

Masks = Optional[Tuple[torch.Tensor, ...]]


class FaderNoise(NamedTuple):
    """One train step's keep masks (None where a network has no dropout)."""

    enc: Masks  # step 1: the encoder's three (MNIST)
    disc: Masks  # step 1: the discriminator's two
    fader: Masks  # step 3: the encoder's three and the decoder's two (MNIST)
    fader_disc: Masks  # step 3: the discriminator's two


class ImageFaderTrainer(ImageVAETrainer):

    def __init__(
        self,
        dataset,
        fader_model: MnistFaderNetwork | DspritesFaderNetwork,
        device: torch.device,
        disc_model: Optional[ImageFaderDiscriminator] = None,
        lr: float = 1e-4,
        beta: float = 1.0,
        rand: int = 0,
        dec_dist: str = "bernoulli",
        ctx: Optional[DataContext] = None,
    ):
        super().__init__(dataset, fader_model, device, lr=lr, beta=beta, reg_type=(),
                         reg_dim=(), dec_dist=dec_dist, rand=rand, ctx=ctx)
        if disc_model is None:
            disc_model = ImageFaderDiscriminator(fader_model.num_attributes,
                                                 fader_model.z_dim, seed=rand)
        self.disc = disc_model.to(self.device)
        self.check_replicated(self.disc.state_dict().values(),
                              "the discriminator's initial parameters")
        self.disc_optimizer = make_adam(self.disc.parameters(), lr, self.device)
        self._fader_params = list(self.model.parameters())
        if self.dataset_type == "mnist":
            factors = [v for k, v in MNIST_NORMALIZATION_FACTORS.items()
                       if k != "digit_identity"]
        else:
            factors = list(DSPRITES_NORMALIZATION_FACTORS.values())
        lo, hi = (torch.tensor(c, dtype=torch.float32, device=self.device)
                  for c in zip(*factors))
        self._norm_lo, self._norm_span = lo, hi - lo

    def model_repr(self) -> str:
        base = "MnistFader" if self.dataset_type == "mnist" else "DspritesFader"
        return base + trainer_config_string(self.hparams)

    def normalize_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """The attributes in [0, 1]: label column 0 (the digit or the
        colour) dropped, the rest mapped by the normalisation factors."""
        return (labels[:, 1:] - self._norm_lo) / self._norm_span

    @staticmethod
    def compute_disc_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Σ(pred − target)² / B."""
        return torch.sum(torch.square(pred - target)) / pred.shape[0]

    def draw_train_noise(self, batch: int,
                         generator: Optional[torch.Generator] = None) -> FaderNoise:
        """A train step's keep masks from ``generator`` (the trainer's
        noise generator by default)."""
        gen = self.noise_generator if generator is None else generator
        m, dev = self.model, self.device
        return FaderNoise(
            enc=keep_masks(batch, m.MASK_SHAPES[:3], m.dropout_rate, gen, dev),
            disc=self.disc.dropout_masks(batch, gen, dev),
            fader=keep_masks(batch, m.MASK_SHAPES, m.dropout_rate, gen, dev),
            fader_disc=self.disc.dropout_masks(batch, gen, dev))

    def _fader_losses(self, inputs: torch.Tensor, norm_labels: torch.Tensor,
                      masks: Masks = None, disc_masks: Masks = None,
                      share: Optional[RowShare] = None) -> Tuple[torch.Tensor, Metrics]:
        """The fader's loss (reconstruction + β·disc loss on the flipped
        attributes) and its metrics, the global batch's given a rank's
        ``share``."""
        with profiling.span("forward"):
            logits, z = self.model(inputs, norm_labels, masks)
            with profiling.span("disc"):
                pred = self.disc(z, disc_masks)
        with profiling.span("loss"):
            recons_loss = reconstruction_loss(logits, inputs, self.hparams.dec_dist)
            disc_loss = self.compute_disc_loss(pred, 1.0 - norm_labels)
            accuracy = pixel_accuracy(torch.sigmoid(logits), inputs)
            if share is not None:
                recons_loss, disc_loss, accuracy = (share.mean(x) for x in
                                                    (recons_loss, disc_loss, accuracy))
            adv_loss = self.hyper["beta"] * disc_loss
            loss = recons_loss + adv_loss
        return loss, {"loss": loss, "accuracy": accuracy,
                      "recons_loss": recons_loss, "adv_loss": adv_loss}

    def step_modules(self):
        return (self.model, self.disc)

    def _step(self, batch, noise: Optional[FaderNoise], share: Optional[RowShare]) -> Metrics:
        """The discriminator's step, then the fader's; ``noise``:
        ``draw_train_noise``'s."""
        inputs, labels = batch
        self.disc.train()
        with profiling.span("forward"):
            noise = self._noise(batch, noise, share, self.draw_train_noise)
            norm_labels = self.normalize_labels(labels)
            with profiling.span("encode"), torch.no_grad():
                z = self.model.encode_deterministic(inputs, noise.enc)
            with profiling.span("disc"):
                pred = self.disc(z, noise.disc)
        with profiling.span("loss"):
            disc_loss = self.compute_disc_loss(pred, norm_labels)
            if share is not None:
                disc_loss = share.mean(disc_loss)
        self.update(disc_loss, self.disc_optimizer, self.disc.parameters())

        loss, metrics = self._fader_losses(inputs, norm_labels, noise.fader,
                                           noise.fader_disc, share)
        self.update(loss, params=self._fader_params, inputs=self._fader_params)
        metrics["disc_loss"] = disc_loss
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, share: Optional[RowShare] = None) -> Metrics:
        """The fader's loss and metrics without dropout (``share`` as for
        :meth:`train_step`)."""
        inputs, labels = batch
        self.model.eval()
        self.disc.eval()
        self.check_share(share)
        return self._fader_losses(inputs, self.normalize_labels(labels), share=share)[1]

    # -- checkpoints ------------------------------------------------------------

    def checkpoint_state(self) -> Dict:
        return dict(super().checkpoint_state(), disc=self.disc.state_dict(),
                    disc_optimizer=self.disc_optimizer.state_dict())

    def restore_state(self, state: Dict) -> None:
        super().restore_state(state)
        self.disc.load_state_dict(state["disc"])
        load_adam_state(self.disc_optimizer, state["disc_optimizer"])

    # -- evaluation ---------------------------------------------------------------

    def draw_eval_noise(self, batch: int, generator: torch.Generator) -> None:
        """None: the deterministic encoder draws nothing."""
        return None

    def compute_representations(self, num_batches: int = 200,
                                batch_size: Optional[int] = None,
                                noise: Optional[Sequence] = None):
        """The deterministic codes of the eval split and its normalised
        attributes (the digit or colour column dropped)."""

        def encode_batch(batch, draws):
            imgs, labels = batch
            return self.model.encode_deterministic(imgs), self.normalize_labels(labels)

        latent_codes, attributes = self._harvest(batch_size, num_batches, encode_batch,
                                                 noise)
        names = [a for a in self.attr_dict if a not in ("digit_identity", "color")]
        return latent_codes, attributes, names

    def evaluation_results(self, batch_size: Optional[int] = None) -> Dict:
        """The five metrics of the harvest. No test pass and no judge:
        ``batch_size`` is unused."""
        return self._metric_suite()

    def compute_latent_interpolations(self, latent_code, labels, dim1: int = 1,
                                      num_points: int = 11) -> np.ndarray:
        """The decodes of the first code of ``latent_code`` beside its
        normalised ``labels`` with attribute ``dim1`` swept from 0 to 1 in
        ``num_points`` steps, tiled in one column."""
        x1 = np.linspace(0.0, 1.0, num_points)
        z = np.repeat(np.asarray(latent_code[:1]), num_points, axis=0)
        l = np.repeat(np.asarray(labels[:1]), num_points, axis=0)
        l[:, dim1] = x1
        # the decoder takes [z ‖ labels]
        outputs = self.decode(np.concatenate([z.astype(np.float32), l.astype(np.float32)],
                                             axis=1))
        return make_grid(outputs, nrow=1, pad_value=1.0)
