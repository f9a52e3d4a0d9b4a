"""Image AR-VAE trainer for dSprites.

Counterpart of ``ImageVAETrainer`` in
``arvae_tpu/training/image_trainer.py``: the same objective
recon + β·|KLD − c| + γ·Σ_r AR-reg, with the AR term on the stacked
(R, B) columns through the reg kernel, and ``torch.optim.Adam(lr)``,
whose defaults (0.9, 0.999, 1e-8, eps outside the sqrt) equal
``optax.adam``'s. MNIST, the eval-metric suite and the artifact
plots are not ported yet.

Precision: float32 throughout, as the JAX package declares. TF32 is
turned off for matmuls and cuDNN convolutions (cuDNN would otherwise
run float32 convolutions in TF32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from arvae_tpu_torch.core.config import (TrainerHParams, normalize_reg_dim,
                                         trainer_config_string)
from arvae_tpu_torch.data.device_data import Metrics
from arvae_tpu_torch.models.image_vae import DspritesVAE, draw_noise
from arvae_tpu_torch.ops.losses import (kld_loss, pixel_accuracy,
                                        reconstruction_loss, total_reg_loss)
from arvae_tpu_torch.training.base import BaseTrainer

DSPRITES_REG_TYPE = {
    "color": 0,
    "shape": 1,
    "scale": 2,
    "orientation": 3,
    "posx": 4,
    "posy": 5,
}

Noise = Tuple[torch.Tensor, torch.Tensor]


class ImageVAETrainer(BaseTrainer):

    def __init__(
        self,
        dataset,
        model: DspritesVAE,
        device: torch.device,
        lr: float = 1e-4,
        reg_type: Tuple[str, ...] = (),
        reg_dim: Tuple[int, ...] = (),
        beta: float = 4.0,
        gamma: float = 10.0,
        capacity: float = 0.0,
        rand: int = 0,
        delta: float = 1.0,
        dec_dist: str = "bernoulli",
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's fastest convolution backward algorithms add partial sums
        # in an order that changes from run to run; these repeat bitwise
        torch.backends.cudnn.deterministic = True
        hp = TrainerHParams(
            lr=lr,
            beta=beta,
            capacity=capacity,
            gamma=gamma,
            delta=delta,
            dec_dist=dec_dist,
            rand=rand,
            reg_type=tuple(reg_type or ()),
            reg_dim=normalize_reg_dim(reg_dim, reg_type),
        )
        super().__init__(dataset, model, hp, device)
        self.reg_pairs = tuple((d, d) for d in hp.reg_dim)

    def model_repr(self) -> str:
        return "DspritesVAE" + trainer_config_string(self.hparams)

    # -- loss ---------------------------------------------------------------------

    def _loss_fn(self, batch, noise: Optional[Noise] = None):
        inputs, labels = batch
        h, hy = self.hparams, self.hyper
        if noise is None:
            noise = draw_noise(inputs.shape[0], self.model.z_dim,
                               self.noise_generator, self.device)
        out = self.model(inputs, *noise)
        recons_loss = reconstruction_loss(out.logits, inputs, h.dec_dist)
        dist_loss = kld_loss(out.z_mean, out.z_log_std, hy["beta"],
                             hy["capacity"])
        loss = recons_loss + dist_loss
        metrics = {"recons_loss": recons_loss, "dist_loss": dist_loss}
        if h.use_reg_loss:
            reg_loss = total_reg_loss(out.z_tilde, labels, self.reg_pairs,
                                      hy["gamma"], hy["delta"])
            loss = loss + reg_loss
            metrics["reg_loss"] = reg_loss
        metrics["loss"] = loss
        metrics["accuracy"] = pixel_accuracy(torch.sigmoid(out.logits), inputs)
        return loss, metrics

    # -- steps --------------------------------------------------------------------

    def train_step(self, batch, noise: Optional[Noise] = None) -> Metrics:
        """One Adam step; ``noise`` = (eps, eps_prior) overrides the
        generator's draw (tests inject the JAX side's noise)."""
        self.model.train()
        loss, metrics = self._loss_fn(batch, noise)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch, noise: Optional[Noise] = None) -> Metrics:
        self.model.eval()
        return self._loss_fn(batch, noise)[1]
