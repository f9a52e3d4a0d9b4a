"""Abstract trainer: the epoch loop over eager PyTorch steps.

Counterpart of ``arvae_tpu/training/base.py``: the same epoch loop
(train pass, val pass, stdout stats, numerics guard, per-epoch
checkpoint), run directory and protocol stamp. Where the JAX trainer
threads PRNG keys, this one holds two ``torch.Generator``s on its
device, both seeded from ``rand``: one draws each epoch's permutation,
the other the reparametrisation noise. The loss-scale hyperparameters
live on the device as 0-d tensors, so a step reads none of them from
the host.
"""

from __future__ import annotations

import abc
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from arvae_tpu_torch.core.checkpoint import Checkpointer
from arvae_tpu_torch.core.config import TrainerHParams, run_dir
from arvae_tpu_torch.data.device_data import DeviceEpochRunner, Metrics
from arvae_tpu_torch.utils.profiling import assert_tensors_finite

# Offset of the permutation generator's seed from the noise generator's.
_PERM_SEED_OFFSET = 1 << 30


def _means(totals: Optional[Metrics], n: int) -> Tuple[float, float]:
    """(mean loss, mean accuracy) from device sums; 0.0 for an empty pass."""
    if totals is None:
        return 0.0, 0.0
    return float(totals["loss"]) / n, float(totals["accuracy"]) / n


class BaseTrainer(abc.ABC):
    """Owns dataset + model + Adam + generators on one device; drives epochs."""

    def __init__(self, dataset, model: torch.nn.Module,
                 hparams: TrainerHParams, device: torch.device):
        self.dataset = dataset
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # generators compare devices with their index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model.to(self.device)
        self.hparams = hparams
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=hparams.lr)
        self.step = 0
        self.noise_generator = torch.Generator(self.device).manual_seed(hparams.rand)
        self.perm_generator = torch.Generator(self.device).manual_seed(
            hparams.rand + _PERM_SEED_OFFSET)
        self.hyper = {
            k: torch.tensor(getattr(hparams, k), dtype=torch.float32,
                            device=self.device)
            for k in ("beta", "capacity", "gamma", "delta")
        }
        self.history: List[Dict[str, Any]] = []
        # Set by train_model; None for a trainer that never trained.
        self._train_protocol: Optional[Dict[str, int]] = None

    @abc.abstractmethod
    def model_repr(self) -> str:
        """e.g. 'DspritesVAE_r_0_b_1.0_...' — keys all run artifacts."""

    @property
    def run_dir(self) -> str:
        return run_dir(self.model_repr())

    @abc.abstractmethod
    def train_step(self, batch) -> Metrics:
        """One optimizer step on (images, labels); returns detached metrics."""

    @abc.abstractmethod
    def eval_step(self, batch) -> Metrics:
        """Metrics of (images, labels) without a parameter update."""

    # -- epoch loop -----------------------------------------------------------

    def train_model(self, batch_size: int, num_epochs: int) -> List[Dict[str, Any]]:
        """Trains ``num_epochs`` epochs; returns the per-epoch history."""
        self._train_protocol = {
            "num_epochs": int(num_epochs),
            "batch_size": int(batch_size),
        }
        train_split, val_split = self.dataset.device_splits(
            self.device, split=(0.70, 0.20))
        runner = DeviceEpochRunner(train_split, val_split, batch_size,
                                   self.train_step, self.eval_step,
                                   self.perm_generator)
        print("Num Train Batches: ", train_split.num_batches(batch_size))
        print("Num Valid Batches: ", val_split.num_batches(batch_size))

        ckpt = Checkpointer(self.run_dir)
        for epoch_index in range(num_epochs):
            t0 = time.time()
            totals, n = runner.train_epoch()
            vtot, vn = runner.eval_epoch()
            # the epoch's one host read of the device-side sums
            loss_train, acc_train = _means(totals, n)
            loss_val, acc_val = _means(vtot, vn)
            dt = time.time() - t0
            self.print_epoch_stats(epoch_index, num_epochs, loss_train,
                                   acc_train, loss_val, acc_val, dt)
            assert_tensors_finite(self.model.state_dict(), "model parameters")
            ckpt.save(self.checkpoint_state())
            self.history.append({
                "epoch": epoch_index + 1,
                "train_loss": loss_train,
                "train_acc": acc_train,
                "val_loss": loss_val,
                "val_acc": acc_val,
                "train_steps": n,
                "val_steps": vn,
                "seconds": dt,
                "step": self.step,
            })
        return self.history

    # -- checkpoints ------------------------------------------------------------

    def checkpoint_state(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "protocol": self.protocol_dict(),
        }

    def load_model(self) -> None:
        """Restores model, Adam state and step from the run checkpoint."""
        state = Checkpointer(self.run_dir).restore(self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def maybe_resume(self) -> bool:
        """Restores the run's checkpoint if one exists; returns whether
        training resumes from it."""
        if not Checkpointer(self.run_dir).exists():
            print(f"no checkpoint under {self.run_dir}; training fresh")
            return False
        self.load_model()
        print(f"resumed from {self.run_dir} at step {self.step}")
        return True

    def protocol_dict(self) -> Dict[str, Any]:
        """Training-protocol provenance: epochs and batch size (None when
        this trainer never trained) and the dataset's identity fields."""
        p: Dict[str, Any] = dict(
            self._train_protocol or {"num_epochs": None, "batch_size": None})
        ds = self.dataset
        p["dataset"] = type(ds).__name__
        for attr in ("factor_sizes", "is_short", "n_bars", "class_name"):
            v = getattr(ds, attr, None)
            if v is not None:
                p[attr] = list(v) if isinstance(v, tuple) else v
        return p

    @staticmethod
    def print_epoch_stats(epoch_index, num_epochs, mean_loss_train,
                          mean_accuracy_train, mean_loss_val,
                          mean_accuracy_val, seconds=None):
        extra = f"  [{seconds:.1f}s]" if seconds is not None else ""
        print(f"Train Epoch: {epoch_index + 1}/{num_epochs}{extra}")
        print(f"\tTrain Loss: {mean_loss_train}"
              f"\tTrain Accuracy: {mean_accuracy_train * 100} %")
        print(f"\tValid Loss: {mean_loss_val}"
              f"\tValid Accuracy: {mean_accuracy_val * 100} %")
