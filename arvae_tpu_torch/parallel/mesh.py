"""Data parallelism over cards: the counterpart of
``arvae_tpu/parallel/mesh.py``.

The JAX package lays a ('data', 'model') mesh over every chip, shards
the batch over ``data``, replicates the parameters and lets XLA insert
the gradient sum. Here one process drives one card, and a
``torch.distributed`` process group joins the processes: a
:class:`DataContext` holds the data axis's size (the world), this
process's rank, its device and the group. ``init_data_parallel`` reads
the variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), takes ``cuda:LOCAL_RANK`` and NCCL on the card, gloo
only where the caller asks for the CPU; without them it gives a world of
1 with no group, and nothing runs differently from a single-card run.

The rule the trainers keep: a step over W ranks with a global batch of B
rows computes the step one card computes on those B rows (the same
losses, the same gradients to float32 summation order, parameters equal
on every rank). Rank k holds rows ``[k·⌈B/W⌉, (k+1)·⌈B/W⌉) ∩ [0, B)``
of the batch: the JAX package's layout for a batch padded to the data
axis with the padding dropped (``arvae_tpu/data/device_data.py:189-199``),
so the last ranks may hold fewer rows, or none. A rank with none still
runs its step, on the batch's last row at weight 0, and joins every
collective (:class:`~arvae_tpu_torch.parallel.collectives.RowShare`).

The model axis is not ported: the JAX package replicates parameters
over it and shards nothing on it (``mesh.py:10-15``), so a context has a
data axis only.

``shard_batch``, ``shard_batch_padded``, ``masked_mean`` and
``shard_batch_truncated`` keep the JAX helpers' rules (the raises, the
zero padding and its mask, ``None`` for a batch truncated to no rows)
and return *this rank's* rows of a host batch, on the context's device.
No trainer calls them (the splits are device-resident and gather their
own rows); they are the JAX package's host-batch API, held against it
by the tests.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from arvae_tpu_torch.parallel.collectives import RowShare, global_sum, tree_map


@dataclasses.dataclass(frozen=True)
class DataContext:
    """The data axis: ``n_data`` processes, this one ``rank``, on
    ``device``, joined by ``group`` (None for a world of 1 without a
    process group)."""

    n_data: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None
    owns_group: bool = False  # made by init_data_parallel, destroyed by close

    @property
    def distributed(self) -> bool:
        """Whether a process group joins the ranks (also at a world of 1)."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints, writes the run's files and evaluates."""
        return self.rank == 0

    def pad_batch(self, n: int) -> int:
        """Rounds ``n`` up so it divides evenly over the data axis."""
        d = self.n_data
        return ((n + d - 1) // d) * d

    def share(self, total: int) -> RowShare:
        """This rank's rows of a global batch of ``total`` rows."""
        if total < 1:
            raise ValueError(f"a global batch needs rows, got {total}")
        chunk = self.pad_batch(total) // self.n_data
        start = min(self.rank * chunk, total)
        return RowShare(self, start, min(start + chunk, total), total)

    def main_first(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on rank 0, then, after a barrier, on the other ranks:
        a dataset cache that rank 0 builds, the others read."""
        out = fn() if self.is_main else None
        self.barrier()
        return out if self.is_main else fn()

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Destroys the process group, if this context made one."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def init_data_parallel(device=None, *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout: Optional[datetime.timedelta] = None) -> DataContext:
    """The data axis over the processes that run this program.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``). A process group already made is
    joined as it is. Without one and without a world size, the context is
    a world of 1 with no group on ``device`` (default ``cuda``). A CUDA
    ``device`` without an index becomes ``cuda:LOCAL_RANK`` (made the
    current device) and the group NCCL; a CPU ``device`` gets gloo, which
    the caller must ask for."""
    device = torch.device("cuda" if device is None else device)
    owns = not dist.is_initialized()
    if not owns:
        world_size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
        if world_size is None:
            return DataContext(1, 0, device, None)
        rank = _env_int("RANK") if rank is None else rank
        if rank is None:
            raise ValueError("a world size without a rank: set RANK (torchrun does)")
        group = None
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(device)
    if group is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kwargs)
        group = dist.group.WORLD
    return DataContext(world_size, rank, device, group, owns)


# ---------------------------------------------------------------------------
# Host batches: this rank's rows
# ---------------------------------------------------------------------------


def _leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _leading_dim(batch: Any) -> int:
    """The common leading-axis size of every leaf, or raises."""
    sizes = {np.asarray(x).shape[0] for x in _leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent leading dims in batch: {sizes}")
    (n,) = sizes
    return n


def _rows(ctx: DataContext, x, n_pad: int) -> torch.Tensor:
    """This rank's ``n_pad / n_data`` rows of ``x``, zero-padded to n_pad rows."""
    x = np.asarray(x)
    if n_pad != x.shape[0]:
        x = np.concatenate([x, np.zeros((n_pad - x.shape[0],) + x.shape[1:], x.dtype)])
    k = n_pad // ctx.n_data
    return torch.from_numpy(np.ascontiguousarray(x[ctx.rank * k:(ctx.rank + 1) * k])).to(
        ctx.device)


def shard_batch(ctx: DataContext, batch: Any) -> Any:
    """This rank's rows of a host batch whose leading dim divides the data
    axis; raises otherwise (silent padding biases any mean downstream):
    ``shard_batch_padded`` (mask) or ``shard_batch_truncated`` (drop the
    remainder) choose other semantics."""

    def _put(x):
        n = np.asarray(x).shape[0]
        if n % ctx.n_data != 0:
            raise ValueError(
                f"batch leading dim {n} does not divide the data axis ({ctx.n_data}); use "
                "shard_batch_padded (mask) or shard_batch_truncated (drop remainder)")
        return _rows(ctx, x, n)

    return tree_map(_put, batch)


def shard_batch_padded(ctx: DataContext, batch: Any) -> Tuple[Any, torch.Tensor]:
    """Zero-pads each leaf's leading axis up to a multiple of the data
    axis → (this rank's rows, this rank's rows of the float32 (N_padded,)
    mask, 1.0 on real rows). ``masked_mean`` keeps means over them exact."""
    n = _leading_dim(batch)
    n_pad = ctx.pad_batch(n)
    mask = np.zeros((n_pad,), np.float32)
    mask[:n] = 1.0
    return tree_map(lambda x: _rows(ctx, x, n_pad), batch), _rows(ctx, mask, n_pad)


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                ctx: Optional[DataContext] = None) -> torch.Tensor:
    """Mean over the elements of ``values`` on rows where ``mask`` is 1,
    over every rank's rows when ``ctx`` has a group (unbiased under
    ``shard_batch_padded``'s padding)."""
    mask = mask.reshape((mask.shape[0],) + (1,) * (values.ndim - 1))
    n_per_row = values[0].numel() if values.shape[0] else 0
    num = torch.sum(values * mask)
    den = torch.sum(mask) * n_per_row
    if ctx is not None and ctx.distributed:
        num, den = global_sum(torch.stack([num, den.to(num.dtype)]), ctx.group)
    return num / torch.clamp_min(den, 1.0)


def shard_batch_truncated(ctx: DataContext, batch: Any) -> Optional[Any]:
    """Drops up to ``n_data - 1`` trailing rows so the leading axis divides
    the data axis → this rank's rows; a no-op on a world of 1. ``None``
    when truncation would leave no rows (per-batch means would be 0/0)."""
    d = ctx.n_data
    if _leading_dim(batch) // d == 0:
        return None

    def _put(x):
        x = np.asarray(x)
        keep = (x.shape[0] // d) * d
        return _rows(ctx, x[:keep], keep)

    return tree_map(_put, batch)
