"""GLSR baseline trainer for the MeasureVAE.

Counterpart of ``arvae_tpu/training/glsr_trainer.py`` (reference
``measurevae/vae_trainer_glsr.py``): geodesic latent-space
regularisation. Each step perturbs the latent column ``reg_dim`` by
±δ, δ = (1 + U)·ε with U ~ U(0, 1) a row, decodes z + δ and z − δ in
eval mode (free-running argmax, no dropout), forms a differentiable
surrogate of the attribute from the two softmaxes, and penalises its
finite-difference gradient under a N(100, 1) prior:
token CE + β·|KLD − c| + γ·(−log N(∂a/∂z | 100, 1)). The surrogate
exists for ``rhy_complexity`` and ``num_notes``. As in the JAX package,
the column (not the rows) is perturbed, and the gradient reaches the
encoder through both decodes.

Every draw of a step comes from the trainer's noise generator on the
device, or from an injected :class:`GLSRNoise`, so a test can hand both
packages the same draws. On a rank of a data-parallel step they are the
global batch's (the rank's rows taken), the finite-difference decodes
run on the rank's rows, and the term is the mean over the global rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from arvae_tpu_torch.models.measure_vae import (MEASURE_SEQ_LEN, MeasureNoise,
                                                MeasureVAE, draw_measure_noise)
from arvae_tpu_torch.ops.losses import kld_loss, token_accuracy, token_cross_entropy_loss
from arvae_tpu_torch.parallel import DataContext, RowShare
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils import profiling

GLSR_REG_TYPES = ("rhy_complexity", "num_notes")
PRIOR_MEAN = 100.0


class GLSRNoise(NamedTuple):
    """The randomness of one GLSR step."""

    measure: MeasureNoise  # the forward's draws
    u: torch.Tensor  # (B,) U(0, 1): the perturbation is (1 + u)·epsilon


class MeasureVAETrainerGLSR(MeasureVAETrainer):

    def __init__(self, dataset, model: MeasureVAE, device: torch.device,
                 lr: float = 1e-4, reg_type: str = "rhy_complexity", reg_dim: int = 0,
                 gamma: float = 1.0, beta: float = 0.001, rand: int = 0,
                 ctx: Optional[DataContext] = None):
        if reg_type not in GLSR_REG_TYPES:
            raise ValueError(f"GLSR has a differentiable surrogate for {GLSR_REG_TYPES}, "
                             f"not {reg_type!r}")
        super().__init__(dataset, model, device, lr=lr, reg_type=(reg_type,),
                         reg_dim=(reg_dim,), beta=beta, gamma=gamma, rand=rand, ctx=ctx)
        self.glsr_reg_type = reg_type
        self.glsr_reg_dim = reg_dim
        self._note_mask = self.attrs.is_note_table.float()  # (V,)

    def model_repr(self) -> str:
        return super().model_repr() + "GLSR"

    # -- the differentiable surrogate attribute --------------------------------

    def compute_grad_attr(self, softmax_weights: torch.Tensor) -> torch.Tensor:
        """softmax_weights (B, T, V) → (B,) surrogate attribute."""
        masked = softmax_weights * self._note_mask
        if self.glsr_reg_type == "rhy_complexity":
            coeffs = self.attrs.rhy_coeffs
            return (masked * coeffs[None, :, None]).sum((1, 2)) / coeffs.sum()
        return masked.sum((1, 2)) / softmax_weights.shape[1]

    def glsr_rows(self, z: torch.Tensor, noise: GLSRNoise, epsilon: float = 1e-3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Each row's −log N(∂a/∂z | 100, 1), from the finite difference
        of the surrogate attribute between the eval decodes of z ± δ →
        (reg (B,), samples of z + δ, samples of z − δ)."""
        deltas = (1.0 + noise.u) * epsilon
        d_z = torch.zeros_like(z)
        d_z[:, self.glsr_reg_dim] = deltas
        dummy = torch.zeros((z.shape[0], MEASURE_SEQ_LEN), dtype=torch.int32, device=z.device)
        w_plus, s_plus = self.model.decode(z + d_z, dummy, noise.measure, train=False)
        w_minus, s_minus = self.model.decode(z - d_z, dummy, noise.measure, train=False)
        grad_softmax = torch.softmax(w_plus, -1) - torch.softmax(w_minus, -1)
        grad_attr = self.compute_grad_attr(grad_softmax) / (2.0 * deltas)
        reg = 0.5 * (grad_attr - PRIOR_MEAN) ** 2 + 0.5 * math.log(2.0 * math.pi)
        return reg, s_plus, s_minus

    def compute_glsr_loss(self, z: torch.Tensor, noise: GLSRNoise,
                          share: Optional[RowShare] = None) -> torch.Tensor:
        """The GLSR term: :meth:`glsr_rows` averaged over the batch (the
        global batch, given a rank's ``share``)."""
        term = self.glsr_rows(z, noise)[0].mean()
        return term if share is None else share.mean(term)

    # -- loss -------------------------------------------------------------------

    def _loss_fn(self, batch, noise: Optional[GLSRNoise] = None,
                 share: Optional[RowShare] = None):
        score, _ = batch
        hy = self.hyper
        with profiling.span("forward"):
            if noise is None:
                rows = score.shape[0] if share is None else share.total
                measure = draw_measure_noise(rows, self.model.latent_space_dim,
                                             self.noise_generator, self.device)
                u = torch.rand(rows, generator=self.noise_generator, device=self.device)
                noise = GLSRNoise(measure, u)
            measure = self.step_noise(score, noise.measure, share)
            noise = GLSRNoise(measure, noise.u if share is None else share.take(noise.u))
            out = self.model(score, noise.measure)
            self.keep_outputs(out)
        with profiling.span("loss"):
            recons_loss = token_cross_entropy_loss(out.weights, score)
            accuracy = token_accuracy(out.weights, score)
            if share is not None:
                recons_loss, accuracy = share.mean(recons_loss), share.mean(accuracy)
            dist_loss = kld_loss(out.z_mean, out.z_log_std, hy["beta"], hy["capacity"], share)
            glsr_loss = hy["gamma"] * self.compute_glsr_loss(out.z_tilde, noise, share)
            loss = recons_loss + dist_loss + glsr_loss
        return loss, {"loss": loss, "recons_loss": recons_loss, "dist_loss": dist_loss,
                      "reg_loss": glsr_loss, "accuracy": accuracy}
