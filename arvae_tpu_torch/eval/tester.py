"""Offline analysis of a trained MeasureVAE with its decoder frozen.

Counterpart of ``VAETester`` and ``VAETesterGLSR`` in
``arvae_tpu/eval/tester.py`` without the plots (matplotlib, PCA and
t-SNE are not on the card's machine):

- ``test_interpretability``: the encoder's sampled latents of the test
  split against one attribute; each latent dim quantile-binned into
  ``max(2, min(20, n // 20))`` bins, the discrete mutual information of
  each with the attribute, then the R² of a line on the dim of most;
- ``test_model``: the token cross-entropy and accuracy of the eval-mode
  decode, the per-batch means averaged over the whole test split;
- ``decode_mid_point``, ``test_interpolation``, ``test_interp`` and
  ``test_attr_reg_interpolations``: latent interpolations decoded in one
  batch and written as MIDI files.

The test split is the JAX tester's: the rows past 2% of the corpus
(``data_loaders(split=(0.01, 0.01))[2]`` there,
``device_eval_split(split=(0.01, 0.01))`` here), in whole batches only,
the partial tail left out as the JAX loader drops it; the harvest stops
after 201 batches. The interpolations pick rows of JAX's
``data_loaders(1, split=(0.01, 0.5))`` val and test splits with
``random.Random(0)``. Encodes and decodes run on the trainer's device,
under ``no_grad``, through the model's kernels on the card. The sampled
latents draw ε from a generator seeded 1 (the harvest) or 2 (the test
pass), one draw a batch, or take injected
:class:`~arvae_tpu_torch.models.measure_vae.MeasureNoise`, one a batch.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.data.bar_dataset import Score
from arvae_tpu_torch.eval.metrics import discrete_mutual_info, linear_r2
from arvae_tpu_torch.models.image_vae import reparametrize
from arvae_tpu_torch.models.measure_vae import MEASURE_SEQ_LEN, MeasureNoise
from arvae_tpu_torch.ops.losses import token_accuracy, token_cross_entropy_loss
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR

# The tester's attribute names → the MusicAttributes function of each
TESTER_ATTRIBUTES = {"rhy_complexity": "rhy_complexity", "num_notes": "note_density",
                     "note_range": "pitch_range", "rhy_entropy": "rhythmic_entropy",
                     "beat_strength": "beat_strength"}
# (train, val) fractions of the corpus before the test split
TEST_SPLIT = (0.01, 0.01)
INTERP_SPLIT = (0.01, 0.5)
# Seeds of the harvest's and the test pass's generators (the JAX tester
# folds the batch index into key(1) and key(2))
HARVEST_SEED, TEST_SEED = 1, 2


class VAETester:
    """Frozen-decoder analysis around a trained MeasureVAETrainer."""

    def __init__(self, trainer, plots_dir: Optional[str] = None):
        self.trainer = trainer
        self.dataset = trainer.dataset
        self.model = trainer.model
        self.device = trainer.device
        self.z_dim = trainer.model.latent_space_dim
        self.plots_dir = plots_dir or os.path.join(trainer.run_dir, "plots")
        os.makedirs(self.plots_dir, exist_ok=True)
        self._rng = random.Random(0)
        self._split = None

    # -- the test split ----------------------------------------------------------

    def test_split(self):
        """The test split on the trainer's device, as 24-tick measures (made once)."""
        if self._split is None:
            self._split = self.dataset.device_eval_split(self.device, split=TEST_SPLIT)
        return self._split

    def whole_batches(self, batch_size: int, cap: Optional[int] = None) -> Tuple[int, int]:
        """(measures a batch, whole batches) of the test split at
        ``batch_size`` corpus rows a batch, at most ``cap`` batches."""
        per_row = self.dataset.get_dataset()[0].shape[1] // MEASURE_SEQ_LEN
        rows = batch_size * per_row
        steps = self.test_split().n // rows
        return rows, steps if cap is None else min(steps, cap)

    def _draws(self, noise: Optional[Sequence[MeasureNoise]], count: int, seed: int,
               rows: int):
        if noise is not None:
            if len(noise) != count:
                raise ValueError(f"{len(noise)} injected draws for {count} batches")
            return lambda i: noise[i]
        gen = torch.Generator(self.device).manual_seed(seed)
        return lambda i: self.trainer.draw_eval_noise(rows, gen)

    def _batch(self, i: int, rows: int) -> torch.Tensor:
        sp = self.test_split()
        return sp.gather_batch(torch.arange(i * rows, (i + 1) * rows, device=sp.device))[0]

    @torch.no_grad()
    def _encode_batches(self, batch_size: int, attr_type: Optional[str], sample: bool,
                        max_batches: int = 200,
                        noise: Optional[Sequence[MeasureNoise]] = None):
        """(latents, attribute or None) of the first ``max_batches + 1``
        whole batches of the test split: ``z_tilde`` when ``sample``,
        else ``z_mean``; one host read."""
        rows, steps = self.whole_batches(batch_size, max_batches + 1)
        if steps == 0:
            raise ValueError(f"the test split of {self.test_split().n} measures holds no "
                             f"whole batch of {rows}")
        draws = self._draws(noise, steps, HARVEST_SEED, rows)
        attr = getattr(self.trainer.attrs, TESTER_ATTRIBUTES[attr_type]) if attr_type else None
        self.model.eval()
        cols = []
        for i in range(steps):
            score, d = self._batch(i, rows), draws(i)
            z_mean, z_log_std = self.model.encoder(score, d.generator)
            z = reparametrize(z_mean, z_log_std, d.eps, d.eps_prior)[0] if sample else z_mean
            cols.append(z if attr is None else torch.cat([z, attr(score).float()[:, None]], 1))
        out = torch.cat(cols).cpu().numpy()
        z_all = np.ascontiguousarray(out[:, :self.z_dim])
        return z_all, None if attr is None else np.ascontiguousarray(out[:, self.z_dim])

    # -- the interpretability probe ----------------------------------------------

    def test_interpretability(self, batch_size: int, attr_type: str,
                              noise: Optional[Sequence[MeasureNoise]] = None
                              ) -> Tuple[int, float]:
        """(the latent dim of most mutual information with ``attr_type``,
        the R² of a line on it)."""
        z_all, attr_all = self._encode_batches(batch_size, attr_type, sample=True, noise=noise)
        mutual_info = np.zeros(self.z_dim)
        n_bins = max(2, min(20, len(z_all) // 20))
        for i in range(self.z_dim):
            edges = np.quantile(z_all[:, i], np.linspace(0, 1, n_bins + 1))
            binned = np.clip(np.searchsorted(edges[1:-1], z_all[:, i]), 0, n_bins - 1)
            mutual_info[i] = discrete_mutual_info(binned, attr_all)
        dim = int(np.argmax(mutual_info))
        return dim, linear_r2(z_all[:, dim:dim + 1], attr_all)

    # -- the test loss -------------------------------------------------------------

    @torch.no_grad()
    def test_model(self, batch_size: int,
                   noise: Optional[Sequence[MeasureNoise]] = None) -> Tuple[float, float]:
        """(mean token cross-entropy, mean accuracy) of the eval-mode
        model over every whole batch of the test split; one host read."""
        rows, steps = self.whole_batches(batch_size)
        draws = self._draws(noise, steps, TEST_SEED, rows)
        self.model.eval()
        vals = []
        for i in range(steps):
            score = self._batch(i, rows)
            weights = self.model(score, draws(i)).weights
            vals.append(torch.stack([token_cross_entropy_loss(weights, score),
                                     token_accuracy(weights, score)]))
        mean_loss = mean_acc = 0.0
        if vals:
            for loss, acc in torch.stack(vals).cpu().numpy():
                mean_loss += float(loss)
                mean_acc += float(acc)
        n = max(steps, 1)
        print("Test Epoch:")
        print("\tTest Loss: ", mean_loss / n, "\n\tTest Accuracy: ", mean_acc / n * 100)
        return mean_loss / n, mean_acc / n

    # -- interpolations --------------------------------------------------------------

    def decode_mid_point(self, z1: np.ndarray, z2: np.ndarray, n: int) -> np.ndarray:
        """z1, n points evenly between, z2, decoded in one batch of n + 2
        → one (1, (n + 2) * 24) token row."""
        if n < 1:
            raise ValueError(f"n must be at least 1, got {n}")
        zs = [z1] + [z1 + (z2 - z1) * (i + 1) / (n + 1) for i in range(n)] + [z2]
        z_batch = np.concatenate([np.asarray(z, np.float32).reshape(1, -1) for z in zs], 0)
        _, samples = self.trainer.decode_latent_codes(z_batch)
        return np.asarray(samples).reshape(1, -1)

    @torch.no_grad()
    def test_interpolation(self, tensor_score1, tensor_score2, n: int = 1) -> Score:
        """The latent interpolation between two measures (each encoded
        alone, ``z_mean``) → Score."""
        self.model.eval()
        z1, z2 = (self.model.encoder(torch.as_tensor(np.asarray(s, np.int32),
                                                     device=self.device))[0].cpu().numpy()
                  for s in (tensor_score1, tensor_score2))
        return self.dataset.tensor_to_m21score(self.decode_mid_point(z1, z2, n))

    def _interp_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """The corpus rows of JAX's ``data_loaders(1, split=(0.01, 0.5))``
        val and test splits."""
        score, _ = self.dataset.get_dataset()
        n = len(score)
        i0, i1 = int(INTERP_SPLIT[0] * n), int(sum(INTERP_SPLIT) * n)
        return score[i0:i1], score[i1:]

    def test_interp(self, n: int = 10) -> Score:
        """Interpolates a random test row to a random val row, written as
        ``interp_two_point.mid``."""
        val_rows, test_rows = self._interp_rows()

        def pick(rows):
            row = rows[self._rng.randint(0, len(rows) - 1)]
            return np.asarray(row, np.int32).reshape(-1, MEASURE_SEQ_LEN)

        score = self.test_interpolation(pick(test_rows), pick(val_rows), n)
        score.write_midi(os.path.join(self.plots_dir, "interp_two_point.mid"))
        return score

    def test_attr_reg_interpolations(self, num_points: int = 10, dim: int = 0,
                                     num_interps: int = 20) -> Dict[str, Score]:
        """Traversals of ``dim`` from -3 to 3 about ``num_points`` codes
        drawn from ``RandomState(0)``, each written as
        ``attr_interp_d{dim}_{i}.mid`` → {path: its Score}."""
        rng = np.random.RandomState(0)
        written = {}
        for i in range(num_points):
            z = rng.randn(1, self.z_dim).astype(np.float32)
            z1, z2 = z.copy(), z.copy()
            z1[:, dim] = -3.0
            z2[:, dim] = 3.0
            score = self.dataset.tensor_to_m21score(self.decode_mid_point(z1, z2, num_interps))
            path = os.path.join(self.plots_dir, f"attr_interp_d{dim}_{i}.mid")
            score.write_midi(path)
            written[path] = score
        return written


class VAETesterGLSR(VAETester):
    """The tester on a GLSR run: builds ``MeasureVAETrainerGLSR`` around
    the dataset and model (its run dir named by γ and the ``GLSR``
    suffix) and restores that run's checkpoint unless ``load`` is
    False."""

    def __init__(self, dataset, model, device: torch.device = torch.device("cuda"),
                 reg_type: str = "rhy_complexity", reg_dim: int = 0, gamma: float = 1.0,
                 rand: int = 0, plots_dir: Optional[str] = None, load: bool = True,
                 beta: float = 0.001):
        trainer = MeasureVAETrainerGLSR(dataset, model, device, reg_type=reg_type,
                                        reg_dim=reg_dim, gamma=gamma, beta=beta, rand=rand)
        if not trainer.model_repr().endswith("GLSR"):
            raise ValueError(f"{trainer.model_repr()} is not a GLSR run")
        if load:
            trainer.load_model()
        super().__init__(trainer, plots_dir=plots_dir)
