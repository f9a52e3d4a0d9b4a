"""Device-resident datasets: the whole split lives in device memory.

Counterpart of ``arvae_tpu/data/device_data.py``. A split is uploaded
once in its compact form (dSprites bit-packed uint8: 264 MB for the
full 516k-row train split), and every step gathers its batch, unpacks
bits and casts to float32 on the device; the epoch permutation is drawn
on the device too. Steady-state epochs make no host↔device transfer
until the epoch's metric sums are read, once, at its end.

Epochs drop the final partial batch. The TPU package's 64-step
dispatch chunk, scan unroll and row sharding have no counterpart here:
PyTorch dispatches each step eagerly on one device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Metrics = Dict[str, torch.Tensor]


def unpack_bits(rows: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(B, D) uint8 → (B, D*8)[..., :n_bits] float32, MSB first like
    ``np.unpackbits``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=rows.device)
    bits = (rows[:, :, None] >> shifts) & 1
    return bits.reshape(rows.shape[0], rows.shape[1] * 8)[:, :n_bits].float()


class DeviceSplit:
    """One split resident on ``device``, with an on-device batch gather.

    ``kind``:
    - ``'packed'``: rows are bit-packed uint8 → float32 images of
      ``image_shape``;
    - ``'bytes'``: rows are raw uint8 pixels → /255 float32 images;
    - ``'tokens'``: rows are int token sequences with no labels (the
      music splits), and a batch is ``(score, score)``: the labels ARE
      the score.
    """

    def __init__(self, rows: np.ndarray, labels: Optional[np.ndarray],
                 image_shape: Tuple[int, ...], kind: str,
                 device: torch.device):
        if kind not in ("packed", "bytes", "tokens"):
            raise ValueError(f"unknown split kind {kind!r}")
        if (labels is None) != (kind == "tokens"):
            raise ValueError("a 'tokens' split takes no labels; the others need them")
        if labels is not None and len(rows) != len(labels):
            raise ValueError(f"{len(rows)} rows but {len(labels)} labels")
        self.n = len(rows)
        self.image_shape = tuple(image_shape)
        self.kind = kind
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        self.labels = (None if labels is None else
                       torch.from_numpy(np.ascontiguousarray(labels)).to(self.device))

    def num_batches(self, batch_size: int) -> int:
        return self.n // batch_size

    def gather_batch(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images (B, *image_shape) float32, labels (B, L)) for row ids
        idx; (score, score) for a 'tokens' split."""
        rows = self.images.index_select(0, idx)
        if self.kind == "tokens":
            return rows, rows
        labs = self.labels.index_select(0, idx)
        n_px = int(np.prod(self.image_shape))
        if self.kind == "packed":
            imgs = unpack_bits(rows, n_px)
        else:
            imgs = rows.float() / 255.0
        return imgs.reshape((idx.shape[0],) + self.image_shape), labs


def _accumulate(totals: Optional[Metrics], metrics: Metrics) -> Metrics:
    if totals is None:
        return {k: v.detach().clone() for k, v in metrics.items()}
    for k, v in metrics.items():
        totals[k] += v.detach()
    return totals


class DeviceEpochRunner:
    """Runs train/eval epochs against device-resident splits.

    ``train_step(batch) -> metrics`` updates the trainer's model in
    place; ``eval_step(batch) -> metrics`` does not. Metrics are 0-d
    device tensors, summed on the device.
    """

    def __init__(
        self,
        train_split: DeviceSplit,
        val_split: DeviceSplit,
        batch_size: int,
        train_step: Callable[[Tuple[torch.Tensor, torch.Tensor]], Metrics],
        eval_step: Callable[[Tuple[torch.Tensor, torch.Tensor]], Metrics],
        perm_generator: torch.Generator,
    ):
        self.train_split = train_split
        self.val_split = val_split
        self.batch_size = batch_size
        self.train_step = train_step
        self.eval_step = eval_step
        self.perm_generator = perm_generator

    def train_epoch(self) -> Tuple[Optional[Metrics], int]:
        """(metric sums, steps) over one shuffled pass; the sums stay on
        the device."""
        sp, b = self.train_split, self.batch_size
        steps = sp.num_batches(b)
        perm = torch.randperm(sp.n, generator=self.perm_generator,
                              device=sp.device)
        totals = None
        for i in range(steps):
            metrics = self.train_step(sp.gather_batch(perm[i * b:(i + 1) * b]))
            totals = _accumulate(totals, metrics)
        return totals, steps

    def eval_epoch(self) -> Tuple[Optional[Metrics], int]:
        """(metric sums, steps) over the val split in order."""
        sp, b = self.val_split, self.batch_size
        steps = sp.num_batches(b)
        totals = None
        for i in range(steps):
            idx = torch.arange(i * b, (i + 1) * b, device=sp.device)
            totals = _accumulate(totals, self.eval_step(sp.gather_batch(idx)))
        return totals, steps
