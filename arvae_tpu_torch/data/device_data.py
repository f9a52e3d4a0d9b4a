"""Device-resident datasets: the whole split lives in device memory.

Counterpart of ``arvae_tpu/data/device_data.py``. A split is uploaded
once in its compact form (dSprites bit-packed uint8: 264 MB for the
full 516k-row train split), and every step gathers its batch, unpacks
bits and casts to float32 on the device; the epoch permutation is drawn
on the device too. Steady-state epochs make no host↔device transfer
until the epoch's metric sums are read, once, at its end.

Epochs drop the final partial batch. The TPU package's 64-step
dispatch chunk and scan unroll have no counterpart here: PyTorch
dispatches each step eagerly.

Over a data axis of W ranks (:class:`~arvae_tpu_torch.parallel.DataContext`
with a process group) every rank draws the same global permutation
from its permutation generator (the same seed on every rank) and
gathers *its* rows of each global batch (``DataContext.share``). A split
is then row-sharded, as the JAX package's by default: each rank stores
``⌈N/W⌉`` rows (zero rows pad the last), contributes the requested rows
it owns (zeros elsewhere) and a ``reduce_scatter`` sums the
contributions and deals each rank its rows, bit for bit the rows a
replicated ``index_select`` gives. A batch that does not divide W is
padded with its last index and the padding dropped; a rank left with no
rows holds the batch's last row, at weight 0 in the losses.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from arvae_tpu_torch.parallel import DataContext
from arvae_tpu_torch.utils import profiling

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

    ``ctx`` is the data axis (a world of 1 on ``device`` by default);
    over W > 1 ranks each rank stores ``⌈N/W⌉`` rows.
    """

    def __init__(self, rows: np.ndarray, labels: Optional[np.ndarray],
                 image_shape: Tuple[int, ...], kind: str,
                 device: torch.device, ctx: Optional[DataContext] = None):
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
        self.ctx = ctx or DataContext(device=self.device)
        self.row_sharded = self.ctx.n_data > 1
        if self.row_sharded:
            # rank k stores rows [k·local_n, (k+1)·local_n); the epoch
            # permutation emits no index ≥ n, so no pad row is gathered
            self.local_n = self.ctx.pad_batch(self.n) // self.ctx.n_data
            lo = self.ctx.rank * self.local_n
            rows = _padded(rows[lo:lo + self.local_n], self.local_n)
            labels = None if labels is None else _padded(labels[lo:lo + self.local_n],
                                                         self.local_n)
        self.images = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        self.labels = (None if labels is None else
                       torch.from_numpy(np.ascontiguousarray(labels)).to(self.device))

    def num_batches(self, batch_size: int) -> int:
        return self.n // batch_size

    def gather_batch(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images (B, *image_shape) float32, labels (B, L)) for row ids
        idx; (score, score) for a 'tokens' split. Over a process group,
        idx is the global batch's and the result this rank's rows of it
        (``ctx.share(len(idx))``)."""
        if not self.row_sharded:  # a world of 1, with a process group or without
            return self._finish(self.images.index_select(0, idx),
                                None if self.labels is None else self.labels.index_select(0, idx))
        share = self.ctx.share(idx.shape[0])
        # pad idx to the data axis with its last index, gather, then keep
        # this rank's rows (the padding, for a rank with none)
        chunk = self.ctx.pad_batch(share.total) // self.ctx.n_data
        pad = chunk * self.ctx.n_data - share.total
        idx_p = torch.cat([idx, idx[-1:].expand(pad)]) if pad else idx
        li = idx_p - self.ctx.rank * self.local_n
        ok = (li >= 0) & (li < self.local_n)
        li = li.clamp(0, self.local_n - 1)
        keep = slice(0, share.rows) if share.n else slice(chunk - 1, chunk)
        rows = self._sharded_take(self.images, li, ok, chunk)[keep]
        labs = None if self.labels is None else self._sharded_take(self.labels, li, ok,
                                                                   chunk)[keep]
        return self._finish(rows, labs)

    def _sharded_take(self, table: torch.Tensor, li: torch.Tensor, ok: torch.Tensor,
                      chunk: int) -> torch.Tensor:
        """The requested rows this rank owns, zeros elsewhere, summed over
        the ranks by one ``reduce_scatter``: rank k receives rows
        ``[k·chunk, (k+1)·chunk)`` of the padded batch."""
        g = table.index_select(0, li)
        dt = g.dtype
        # sub-word integers ride the collective as int32; 64-bit integers
        # keep their width (int32 would truncate them)
        if dt.is_floating_point:
            wide = dt
        else:
            wide = torch.int64 if dt.itemsize == 8 else torch.int32
        g = torch.where(ok.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0).to(wide)
        out = g.new_empty((chunk,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, g.contiguous(), group=self.ctx.group)
        return out.to(dt)

    def _finish(self, rows: torch.Tensor, labs: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kind == "tokens":
            return rows, rows
        n_px = int(np.prod(self.image_shape))
        if self.kind == "packed":
            imgs = unpack_bits(rows, n_px)
        else:
            imgs = rows.float() / 255.0
        return imgs.reshape((rows.shape[0],) + self.image_shape), labs


def _padded(x: np.ndarray, n: int) -> np.ndarray:
    """``x`` with zero rows appended up to ``n`` rows."""
    if len(x) == n:
        return x
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def _share(split: DeviceSplit, batch: int) -> dict:
    """A step's ``share=`` keyword over a process group, none without."""
    return {"share": split.ctx.share(batch)} if split.ctx.distributed else {}


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
    device tensors, summed on the device. Over a process group each step
    gets this rank's rows and ``share=``, the rank's share of the global
    batch; its metrics are the global batch's, equal on every rank, so
    the epoch's sums need no reduction.
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
        with profiling.span("shuffle"):
            perm = torch.randperm(sp.n, generator=self.perm_generator,
                                  device=sp.device)
        totals = None
        for i in range(steps):
            with profiling.span("step"):
                with profiling.span("gather"):
                    batch = sp.gather_batch(perm[i * b:(i + 1) * b])
                with profiling.span("train_step"):
                    metrics = self.train_step(batch, **_share(sp, b))
                with profiling.span("accumulate"):
                    totals = _accumulate(totals, metrics)
        return totals, steps

    def eval_epoch(self) -> Tuple[Optional[Metrics], int]:
        """(metric sums, steps) over the val split in order."""
        sp, b = self.val_split, self.batch_size
        steps = sp.num_batches(b)
        totals = None
        for i in range(steps):
            idx = torch.arange(i * b, (i + 1) * b, device=sp.device)
            totals = _accumulate(totals, self.eval_step(sp.gather_batch(idx), **_share(sp, b)))
        return totals, steps
