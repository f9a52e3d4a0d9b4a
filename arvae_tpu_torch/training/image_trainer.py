"""Image AR-VAE trainer for Morpho-MNIST and dSprites.

Counterpart of ``ImageVAETrainer`` in
``arvae_tpu/training/image_trainer.py``: the same objective
recon + β·|KLD − c| + γ·Σ_r AR-reg, with the AR term on the columns of
``z_tilde`` and the labels read in place by the reg kernel, and
``torch.optim.Adam(lr)``, whose defaults (0.9, 0.999, 1e-8, eps outside
the sqrt) equal ``optax.adam``'s. The dataset's class name picks the
attributes: MNIST's labels are its 7 morphometry columns (the digit,
then area, length, thickness, slant, width, height), dSprites' its 6
factors. ``MnistVAE``'s dropout masks come from the trainer's noise
generator with the reparametrisation's draws. The evaluation harvests
the sampled ``z_tilde`` of the eval split against the attributes
(``digit_identity`` and ``color`` left out) and tests the
reconstruction loss and pixel accuracy; for MNIST it adds the ResNet
judge's ``digit_pred_acc`` when a trained judge exists. Latent codes
decode to images (:meth:`ImageVAETrainer.decode`), the traversal grids
of one or two dims come back as ``make_grid`` arrays, and decoded MNIST
digits are measured again (``compute_mnist_morpho_labels``). The plots,
the latent GIFs and the TensorBoard hook are not ported (matplotlib,
PIL).

On a rank of a data-parallel step the draws (ε, ε_prior, MnistVAE's
dropout masks) are made for the global batch from the shared noise
generator and the rank's rows taken, so W ranks draw what one card
draws; the losses are the global batch's (``ops/losses.py``).

Precision: float32 throughout, as the JAX package declares. TF32 is
turned off for matmuls and cuDNN convolutions (cuDNN would otherwise
run float32 convolutions in TF32).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.core.config import (TrainerHParams, normalize_reg_dim,
                                         trainer_config_string)
from arvae_tpu_torch.data.device_data import Metrics
from arvae_tpu_torch.data.mnist import measure_images
from arvae_tpu_torch.models.image_vae import (DspritesVAE, MnistVAE, draw_noise,
                                             reparametrize)
from arvae_tpu_torch.ops.losses import (kld_loss, pixel_accuracy,
                                        reconstruction_loss, total_reg_loss)
from arvae_tpu_torch.parallel import DataContext, RowShare, sharded
from arvae_tpu_torch.training.base import BaseTrainer
from arvae_tpu_torch.training.resnet_judge import judge_accuracy, load_judge
from arvae_tpu_torch.utils import profiling
from arvae_tpu_torch.utils.plotting import make_grid

MNIST_REG_TYPES = {
    "digit_identity": 0,
    "area": 1,
    "length": 2,
    "thickness": 3,
    "slant": 4,
    "width": 5,
    "height": 6,
}

# Each attribute's (low, high) for normalising labels (the fader's)
MNIST_NORMALIZATION_FACTORS = {
    "digit_identity": (0, 9),
    "area": (0, 350),
    "length": (0, 100),
    "thickness": (0, 15),
    "slant": (-1.2, 1.2),
    "width": (0, 30),
    "height": (0, 30),
}

DSPRITES_REG_TYPE = {
    "color": 0,
    "shape": 1,
    "scale": 2,
    "orientation": 3,
    "posx": 4,
    "posy": 5,
}

DATASET_REG_TYPE_DICT = {"mnist": MNIST_REG_TYPES, "dsprites": DSPRITES_REG_TYPE}
_DATASET_TYPES = {"MorphoMnistDataset": "mnist", "MnistDataset": "mnist",
                  "DspritesDataset": "dsprites"}
_MODEL_NAMES = {"mnist": "MnistVAE", "dsprites": "DspritesVAE"}

# (eps, eps_prior), and for MnistVAE in training its dropout masks
Noise = Tuple


class ImageVAETrainer(BaseTrainer):

    def __init__(
        self,
        dataset,
        model: DspritesVAE | MnistVAE,
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
        ctx: Optional[DataContext] = None,
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
        super().__init__(dataset, model, hp, device, ctx)
        self.dataset_type = self._dataset_type(dataset, model)
        self.attr_dict = DATASET_REG_TYPE_DICT[self.dataset_type]
        self.reg_pairs = tuple((d, d) for d in hp.reg_dim)

    @staticmethod
    def _dataset_type(dataset, model) -> str:
        """By the dataset's class name; a trainer built without a dataset
        (a test's, a probe's) by its model."""
        if dataset is None:
            return "mnist" if isinstance(model, MnistVAE) else "dsprites"
        name = type(dataset).__name__
        if name not in _DATASET_TYPES:
            raise ValueError(f"Dataset type not recognized: {name}")
        return _DATASET_TYPES[name]

    def model_repr(self) -> str:
        return _MODEL_NAMES[self.dataset_type] + trainer_config_string(self.hparams)

    def draw_train_noise(self, batch: int,
                         generator: Optional[torch.Generator] = None) -> Noise:
        """A train step's draws from ``generator`` (the trainer's noise
        generator by default): (eps, eps_prior) and, for MnistVAE, its
        dropout masks."""
        gen = self.noise_generator if generator is None else generator
        eps, eps_prior = draw_noise(batch, self.model.z_dim, gen, self.device)
        if isinstance(self.model, MnistVAE):
            return eps, eps_prior, self.model.dropout_masks(batch, gen, self.device)
        return eps, eps_prior

    # -- loss ---------------------------------------------------------------------

    def _loss_fn(self, batch, noise: Optional[Noise], share: Optional[RowShare], draw):
        """(loss, metrics) of a batch; the draws are ``noise`` or
        ``draw(rows)``'s (:meth:`_noise`)."""
        inputs, labels = batch
        h, hy = self.hparams, self.hyper
        with profiling.span("forward"):
            noise = self._noise(batch, noise, share, draw)
            out = self.model(inputs, *noise)
        with profiling.span("loss"):
            recons_loss = reconstruction_loss(out.logits, inputs, h.dec_dist)
            accuracy = pixel_accuracy(torch.sigmoid(out.logits), inputs)
            if share is not None:
                recons_loss, accuracy = share.mean(recons_loss), share.mean(accuracy)
            dist_loss = kld_loss(out.z_mean, out.z_log_std, hy["beta"],
                                 hy["capacity"], share)
            loss = recons_loss + dist_loss
            metrics = {"recons_loss": recons_loss, "dist_loss": dist_loss}
            if h.use_reg_loss:
                reg_loss = total_reg_loss(out.z_tilde, labels, self.reg_pairs,
                                          hy["gamma"], hy["delta"], share)
                loss = loss + reg_loss
                metrics["reg_loss"] = reg_loss
            metrics["loss"] = loss
            metrics["accuracy"] = accuracy
        return loss, metrics

    def _noise(self, batch, noise, share: Optional[RowShare], draw):
        """The step's draws for its rows: ``noise`` (the global batch's
        over a process group) or ``draw(rows)``'s, this rank's rows taken."""
        self.check_share(share)
        if noise is None:
            noise = draw(batch[0].shape[0] if share is None else share.total)
        return noise if share is None else sharded(noise, share)

    # -- steps --------------------------------------------------------------------

    def _step(self, batch, noise: Optional[Noise], share: Optional[RowShare]) -> Metrics:
        """One Adam step; ``noise``: ``draw_train_noise``'s tuple."""
        loss, metrics = self._loss_fn(batch, noise, share, self.draw_train_noise)
        self.update(loss)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, noise: Optional[Noise] = None,
                  share: Optional[RowShare] = None) -> Metrics:
        """The loss and metrics without dropout; ``noise`` = (eps,
        eps_prior) overrides the generator's draws (``share`` as for
        :meth:`train_step`)."""
        self.model.eval()
        return self._loss_fn(batch, noise, share, lambda b: draw_noise(
            b, self.model.z_dim, self.noise_generator, self.device))[1]

    # -- evaluation ---------------------------------------------------------------

    def draw_eval_noise(self, batch: int, generator: torch.Generator) -> Noise:
        return draw_noise(batch, self.model.z_dim, generator, self.device)

    def _extract_relevant_attributes(self, attributes: np.ndarray
                                     ) -> Tuple[np.ndarray, List[str]]:
        attr_list = [a for a in self.attr_dict if a not in ("digit_identity", "color")]
        return attributes[:, [self.attr_dict[a] for a in attr_list]], attr_list

    def compute_representations(self, num_batches: int = 200,
                                batch_size: Optional[int] = None,
                                noise: Optional[Sequence[Noise]] = None):
        """The sampled ``z_tilde`` of the eval split and its attributes;
        ``noise`` = one (eps, eps_prior) a batch overrides the draws."""

        def encode_batch(batch, draws):
            imgs, labels = batch
            return reparametrize(*self.model.encode(imgs), *draws)[0], labels

        latent_codes, attributes = self._harvest(batch_size, num_batches,
                                                 encode_batch, noise)
        return (latent_codes, *self._extract_relevant_attributes(attributes))

    def test_model(self, batch_size: Optional[int] = None,
                   noise: Optional[Sequence[Noise]] = None) -> Dict[str, float]:
        """Reconstruction loss and pixel accuracy of the sigmoid."""

        def batch_metrics(batch, draws):
            imgs, _ = batch
            logits = self.model(imgs, *draws).logits
            return (reconstruction_loss(logits, imgs, self.hparams.dec_dist),
                    pixel_accuracy(torch.sigmoid(logits), imgs))

        return self._test_pass(batch_size, batch_metrics, noise)

    def extra_eval_metrics(self) -> Dict:
        """MNIST's ``digit_pred_acc`` from the trained judge, when one exists."""
        return (self.get_resnet_accuracy() or {}) if self.dataset_type == "mnist" else {}

    def get_resnet_accuracy(self) -> Optional[Dict]:
        """Digit identity kept in reconstructions and traversals, as the
        ResNet judge sees it (``resnet_judge.judge_accuracy``); None, with
        the JAX package's message, when no trained judge exists."""
        judge = load_judge(self.device)
        if judge is None:
            print("No MnistRESNET checkpoint found - skipping digit_pred_acc "
                  "(train one with test_mnist.py)")
            return None
        return judge_accuracy(self, judge)

    # -- decoding latent codes ------------------------------------------------------

    @torch.no_grad()
    def decode(self, z) -> np.ndarray:
        """The sigmoid of the decoder for latent codes (n, decoder inputs)
        → (n, 1, H, W) float32: eval mode on the trainer's device, each
        layer in the model's ``compute_dtype``."""
        self.model.eval()
        z = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        return torch.sigmoid(self.model.decode(z)).cpu().numpy()

    def compute_latent_interpolations(self, latent_code, dim1: int = 0,
                                      num_points: int = 10) -> np.ndarray:
        """The decodes of ``latent_code`` (1, z) with ``dim1`` swept over
        [-4, 4] in ``num_points`` steps, tiled in one row."""
        x1 = np.linspace(-4.0, 4.0, num_points)
        z = np.repeat(np.asarray(latent_code), num_points, axis=0)
        z[:, dim1] = x1
        outputs = self.decode(z)
        return make_grid(outputs, nrow=num_points, pad_value=1.0)

    def compute_latent_interpolations2d(self, latent_code, dim1: int = 0, dim2: int = 1,
                                        num_points: int = 10) -> np.ndarray:
        """The decodes of ``latent_code`` (1, z) over the [-4, 4]² grid of
        ``dim1`` (rows) and ``dim2`` (columns), ``num_points`` a side."""
        x = np.linspace(-4.0, 4.0, num_points)
        z1, z2 = np.meshgrid(x, x, indexing="ij")
        total = num_points * num_points
        z = np.repeat(np.asarray(latent_code), total, axis=0)
        z[:, dim1] = z1.reshape(-1)
        z[:, dim2] = z2.reshape(-1)
        outputs = self.decode(z)
        return make_grid(outputs, nrow=num_points, pad_value=1.0)

    def compute_mnist_morpho_labels(self, outputs, morpho_attr_str: Optional[str] = None
                                    ) -> np.ndarray:
        """The six morphometrics of decoded digits (n, 1, 28, 28), measured
        on the host (``data/mnist.py::measure_images``: spawn workers) →
        (n, 6) float64, or the column of ``morpho_attr_str``."""
        labels = measure_images(np.asarray(outputs).squeeze(axis=1))
        if morpho_attr_str is not None:
            labels = labels[:, self.attr_dict[morpho_attr_str] - 1]
        return labels
