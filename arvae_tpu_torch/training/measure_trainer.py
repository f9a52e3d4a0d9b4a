"""Music AR-VAE trainer for the MeasureVAE.

Counterpart of ``MeasureVAETrainer`` in
``arvae_tpu/training/measure_trainer.py``: the objective
token CE + β·|KLD − c| + γ·Σ_r AR-reg, where the attribute labels
(rhy_complexity, pitch_range, note_density, contour) are computed on the
device from the score inside the step, and ``torch.optim.Adam(lr)``.
Every draw of a step (ε, ε_prior, the teacher-forcing coin, the tick
loop's dropout seed, the GRUs' inter-layer dropout) comes from the
trainer's noise generator on the device, or from an injected
:class:`~arvae_tpu_torch.models.measure_vae.MeasureNoise`. Eval is
free-running argmax with dropout off. The evaluation harvests the
encoder's sampled ``z_tilde`` of the eval split against the four
attributes computed from the score on the device, and tests the token
cross-entropy and accuracy of the eval-mode decode. Latent codes decode
to token rows and a :class:`~arvae_tpu_torch.data.bar_dataset.Score`
(``decode_latent_codes``, ``compute_latent_interpolations``), and
``plot_latent_interpolations`` writes a code's traversal as MIDI with its
attribute labels; the plots are not ported.

On a rank of a data-parallel step the draws are the global batch's: ε
and ε_prior drawn for it and the rank's rows taken, the coin and the
tick loop's seed one a step (the shared generator gives every rank the
same, which the step checks), and the GRUs' dropout drawn for the
global batch inside the forward (``MeasureNoise.rows``). The labels are
computed from this rank's scores and gathered for the AR term.

Precision: float32 throughout; TF32 is turned off for matmuls and cuDNN.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.core.config import (TrainerHParams, normalize_reg_dim,
                                         trainer_config_string)
from arvae_tpu_torch.data.attributes import MUSIC_REG_TYPE
from arvae_tpu_torch.data.device_data import Metrics
from arvae_tpu_torch.models.image_vae import reparametrize
from arvae_tpu_torch.models.measure_vae import (MEASURE_SEQ_LEN, MeasureNoise,
                                                MeasureVAE, draw_measure_noise)
from arvae_tpu_torch.ops.losses import (kld_loss, token_accuracy,
                                        token_cross_entropy_loss, total_reg_loss)
from arvae_tpu_torch.parallel import DataContext, RowShare, sharded
from arvae_tpu_torch.training.base import BaseTrainer
from arvae_tpu_torch.utils import profiling

# The run-dir tag of each decoder type.
DECODER_TAGS = {"hier": "", "sr": "_SRDecoder", "sr-no-input": "_SRDecoderNoInput"}
# Offset of the decodes' seed from ``rand`` (the constant the JAX
# trainer folds into its key for them).
_DECODE_SEED_OFFSET = 42


class MeasureVAETrainer(BaseTrainer):

    EVAL_BATCH_SIZE = 256

    def __init__(
        self,
        dataset,
        model: MeasureVAE,
        device: torch.device,
        lr: float = 1e-4,
        reg_type: Tuple[str, ...] = (),
        reg_dim: Tuple[int, ...] = (),
        beta: float = 0.001,
        gamma: float = 1.0,
        capacity: float = 0.0,
        rand: int = 0,
        delta: float = 10.0,
        ctx: Optional[DataContext] = None,
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = dataset.class_name[5:9]
        if kind not in ("Chor", "Folk"):
            raise ValueError("Dataset Type not recognized")
        self.dataset_type = "bach" if kind == "Chor" else "folk"
        self.attr_dict = MUSIC_REG_TYPE
        hp = TrainerHParams(
            lr=lr,
            beta=beta,
            capacity=capacity,
            gamma=gamma,
            delta=delta,
            rand=rand,
            reg_type=tuple(reg_type or ()),
            reg_dim=normalize_reg_dim(reg_dim, reg_type),
        )
        # Finalize the corpus first: building it can grow the vocabulary
        # past a stale dict file, and an embedding lookup clamps rather
        # than raising, so an undersized model must be caught here.
        dataset.get_dataset()
        ticks = dataset.beat_subdivisions * dataset.time_sig_num
        if ticks != MEASURE_SEQ_LEN:
            raise ValueError(
                f"dataset measures span {ticks} ticks ({dataset.time_sig_num}/"
                f"{dataset.time_sig_den} × {dataset.beat_subdivisions} "
                f"subdivisions) but MeasureVAE is built on {MEASURE_SEQ_LEN}-tick "
                "measures")
        if model.num_notes < len(dataset.note2index_dicts):
            raise ValueError(
                f"model num_notes={model.num_notes} is smaller than the finalized "
                f"vocabulary ({len(dataset.note2index_dicts)}); size the model "
                "after dataset.get_dataset()")
        super().__init__(dataset, model, hp, device, ctx)
        self.attrs = dataset.attrs(self.device)
        self.reg_pairs = tuple((d, d) for d in hp.reg_dim)

    def model_repr(self) -> str:
        # decoder variants and sampling modes get run dirs of their own,
        # as in the JAX package
        tag = DECODER_TAGS[self.model.decoder_type]
        if self.model.sampling != "argmax":
            tag += "_" + self.model.sampling
        return (self.dataset_type + "_MeasureVAE" + tag
                + trainer_config_string(self.hparams))

    # -- loss ---------------------------------------------------------------------

    def step_noise(self, score: torch.Tensor, noise: Optional[MeasureNoise],
                   share: Optional[RowShare]) -> MeasureNoise:
        """The step's draws for its rows: ``noise`` (the global batch's
        over a process group) or the generator's, with this rank's rows
        taken and the share attached."""
        self.check_share(share)
        if noise is None:
            noise = draw_measure_noise(score.shape[0] if share is None else share.total,
                                       self.model.latent_space_dim, self.noise_generator,
                                       self.device)
        if share is None:
            return noise
        # the coin and the seed must be the same on every rank
        self.note_draws((noise.teacher, noise.seed))
        return sharded(noise, share)._replace(rows=share)

    def keep_outputs(self, out) -> None:
        """A training forward's decoder outputs, as ``step_outputs``: the
        tokens it fed back (``samples``) and its ReLU head (``weights``)."""
        if self.model.training:
            self.step_outputs = {"samples": out.samples.detach(),
                                 "weights": out.weights.detach()}

    def _loss_fn(self, batch, noise: Optional[MeasureNoise] = None,
                 share: Optional[RowShare] = None):
        score, _ = batch
        hy = self.hyper
        with profiling.span("forward"):
            noise = self.step_noise(score, noise, share)
            out = self.model(score, noise)
            self.keep_outputs(out)
        with profiling.span("loss"):
            recons_loss = token_cross_entropy_loss(out.weights, score)
            accuracy = token_accuracy(out.weights, score)
            if share is not None:
                recons_loss, accuracy = share.mean(recons_loss), share.mean(accuracy)
            dist_loss = kld_loss(out.z_mean, out.z_log_std, hy["beta"], hy["capacity"], share)
            loss = recons_loss + dist_loss
            metrics = {"recons_loss": recons_loss, "dist_loss": dist_loss}
            if self.hparams.use_reg_loss:
                with profiling.span("labels"):
                    labels = self.attrs.compute_labels(score)
                reg_loss = total_reg_loss(out.z_tilde, labels, self.reg_pairs,
                                          hy["gamma"], hy["delta"], share)
                loss = loss + reg_loss
                metrics["reg_loss"] = reg_loss
            metrics["loss"] = loss
            metrics["accuracy"] = accuracy
        return loss, metrics

    # -- steps --------------------------------------------------------------------

    def _step(self, batch, noise: Optional[MeasureNoise],
              share: Optional[RowShare]) -> Metrics:
        """One Adam step on (score, score); ``noise``: a MeasureNoise."""
        loss, metrics = self._loss_fn(batch, noise, share)
        self.update(loss)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, noise: Optional[MeasureNoise] = None,
                  share: Optional[RowShare] = None) -> Metrics:
        self.model.eval()
        return self._loss_fn(batch, noise, share)[1]

    # -- evaluation ---------------------------------------------------------------

    def draw_eval_noise(self, batch: int, generator: torch.Generator) -> MeasureNoise:
        return draw_measure_noise(batch, self.model.latent_space_dim, generator,
                                  self.device)

    def compute_representations(self, num_batches: int = 200,
                                batch_size: Optional[int] = None,
                                noise: Optional[Sequence[MeasureNoise]] = None):
        """The encoder's sampled ``z_tilde`` of the eval split and the
        attributes of its scores; ``noise`` = one MeasureNoise a batch
        overrides the draws."""

        def encode_batch(batch, draws):
            score, _ = batch
            z_mean, z_log_std = self.model.encoder(score, draws.generator)
            z_tilde = reparametrize(z_mean, z_log_std, draws.eps, draws.eps_prior)[0]
            return z_tilde, self.attrs.compute_labels(score)

        latent_codes, attributes = self._harvest(batch_size, num_batches,
                                                 encode_batch, noise)
        return latent_codes, attributes, list(self.attr_dict)

    def test_model(self, batch_size: Optional[int] = None,
                   noise: Optional[Sequence[MeasureNoise]] = None) -> Dict[str, float]:
        """Token cross-entropy and accuracy of the eval-mode decode."""

        def batch_metrics(batch, draws):
            score, _ = batch
            weights = self.model(score, draws).weights
            return (token_cross_entropy_loss(weights, score),
                    token_accuracy(weights, score))

        return self._test_pass(batch_size, batch_metrics, noise)

    # -- decoding latent codes ------------------------------------------------------

    @torch.no_grad()
    def decode_latent_codes(self, latent_codes, noise: Optional[MeasureNoise] = None):
        """Latent codes (n, z) → (Score, samples (n, 24) int32): one
        eval-mode decode (free-running argmax, no dropout) against a zero
        score, on the trainer's device. No draw changes an eval decode;
        ``noise`` overrides the draws as on the training path, which
        otherwise come from a generator seeded from ``rand``."""
        z = torch.as_tensor(np.asarray(latent_codes, np.float32), device=self.device)
        n = z.shape[0]
        dummy = torch.zeros((n, self.dataset.beat_subdivisions * 4), dtype=torch.int32,
                            device=self.device)
        if noise is None:
            gen = torch.Generator(self.device).manual_seed(
                self.hparams.rand + _DECODE_SEED_OFFSET)
            noise = self.draw_eval_noise(n, gen)
        self.model.eval()
        samples = self.model.decode(z, dummy, noise, train=False)[1].cpu().numpy()
        return self.dataset.tensor_to_m21score(samples), samples

    def compute_latent_interpolations(self, latent_code, original_score, dim1: int = 0,
                                      num_points: int = 5):
        """A traversal of ``dim1`` over [-4, 4] in ``num_points`` codes,
        each decoded alone, the middle measure replaced by
        ``original_score`` → (the measures concatenated as one Score, the
        decoded samples (num_points, 24))."""
        if num_points % 2 != 1:
            raise ValueError(f"num_points must be odd, got {num_points}")
        z = np.repeat(np.asarray(latent_code, np.float32), num_points, axis=0)
        z[:, dim1] = np.linspace(-4.0, 4.0, num_points)
        scores, tensors = [], []
        for n in range(num_points):
            score, tensor = self.decode_latent_codes(z[n:n + 1])
            scores.append(score)
            tensors.append(tensor)
        scores[num_points // 2] = original_score
        return self.dataset.concatenate_scores(scores), np.concatenate(tensors, 0)

    def plot_latent_interpolations(self, latent_codes, attr_str: str,
                                   num_points: int = 10) -> np.ndarray:
        """For each of the first ``min(num_points, n)`` codes of
        ``latent_codes`` (n, z): the code's decode written as
        ``original_{i}.mid`` and its 5-point traversal of ``attr_str``'s
        interpretability dim as
        ``latent_interpolations_{attr_str}_{i}.mid``, both into the run
        dir's ``results/`` → the traversals' ``attr_str`` labels
        (codes, 5), computed on the device from the decoded tokens. No
        pianoroll image is written (the JAX method's PNG needs
        matplotlib).

        The dims come from the last evaluation (``self.metrics``), else
        from the run dir's ``results_dict.json``, and are read without a
        collective, so one rank of a process group may call this alone
        (a single process with neither evaluates first)."""
        n = min(num_points, latent_codes.shape[0])
        metrics = self.metrics
        if "interpretability" not in metrics:
            metrics = (self._read_results() if self.ctx.distributed
                       else self.compute_eval_metrics())
        dim = metrics["interpretability"][attr_str][0]
        save_dir = os.path.join(self.run_dir, "results")
        os.makedirs(save_dir, exist_ok=True)
        labels = []
        for i in range(n):
            original_score, _ = self.decode_latent_codes(latent_codes[i:i + 1])
            original_score.write_midi(os.path.join(save_dir, f"original_{i}.mid"))
            score, tensor_score = self.compute_latent_interpolations(
                latent_codes[i:i + 1], original_score, dim, num_points=5)
            tokens = torch.as_tensor(tensor_score, device=self.device)
            labels.append(self.attrs.compute_labels(tokens, [attr_str]).cpu().numpy()
                          .flatten())
            score.write_midi(os.path.join(save_dir,
                                          f"latent_interpolations_{attr_str}_{i}.mid"))
        return np.stack(labels)
