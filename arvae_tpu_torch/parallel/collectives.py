"""The collectives of a data-parallel step, and a rank's share of a batch.

The losses of a step over W ranks are written so that every rank holds
the **global** value of each term, and each term's backward reaches only
this rank's rows; the parameters' gradients are then summed over the
ranks (:func:`all_reduce_grads`), which gives each rank the gradient one
card computes on the whole batch. So:

- :func:`global_sum` sums a tensor over the ranks, and its backward
  passes the incoming gradient through unchanged (every rank holds the
  same sum, and this rank's addend reaches the sum with weight 1);
- :func:`gather_rows` concatenates the ranks' rows in rank order, and
  its backward returns this rank's rows of the incoming gradient with no
  reduction: every rank computes the same global loss from the gathered
  tensor. (``torch.distributed.nn.functional.all_gather`` sums the
  gradient over the ranks in its backward, and with the sum of
  :func:`all_reduce_grads` after it a W-rank step would take W times the
  gradient.)

A :class:`RowShare` is this rank's rows ``[start, stop)`` of a global
batch of ``total`` rows, with the means and gathers over that batch.
At a world of 1 with a group every collective returns its input's
values, and a share's weight is 1.0, so a step there is bitwise the
step without a group.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Iterable, List

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from arvae_tpu_torch.parallel.mesh import DataContext


class _GlobalSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; the gradient reaches
    this rank's ``x`` unchanged."""
    return _GlobalSum.apply(x, group)


def _gather(x: torch.Tensor, share: "RowShare") -> torch.Tensor:
    """Every rank's real rows of ``x`` (this rank's local rows), in rank
    order: (share.total, *x.shape[1:])."""
    ctx = share.ctx
    chunk = ctx.pad_batch(share.total) // ctx.n_data
    local = x.new_zeros((chunk,) + x.shape[1:])
    local[:share.n] = x[:share.n]
    out = x.new_empty((chunk * ctx.n_data,) + x.shape[1:])
    dist.all_gather_into_tensor(out, local, group=ctx.group)
    return out[:share.total]


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, share):
        ctx.share, ctx.rows = share, x.shape[0]
        return _gather(x.contiguous(), share)

    @staticmethod
    def backward(ctx, g):
        share = ctx.share
        dx = g.new_zeros((ctx.rows,) + g.shape[1:])
        dx[:share.n] = g[share.start:share.stop]
        return dx, None


def gather_rows(x: torch.Tensor, share: "RowShare") -> torch.Tensor:
    """The global batch's rows of ``x`` (this rank's local rows), in rank
    order; the gradient reaches this rank's rows only, unreduced."""
    return _GatherRows.apply(x, share)


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``
    rows (``DataContext.share``). A rank whose range is empty holds the
    batch's last row at weight 0, so that every rank runs a step."""

    ctx: "DataContext"
    start: int
    stop: int
    total: int

    @property
    def n(self) -> int:
        """The real rows this rank holds (0 for an empty range)."""
        return self.stop - self.start

    @property
    def first(self) -> int:
        """The global row of this rank's first local row."""
        return self.start if self.n else self.total - 1

    @property
    def rows(self) -> int:
        """The local batch's rows: the real ones, or the one stand-in row."""
        return max(self.n, 1)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's local rows of a global-batch tensor (leading dim
        ``total``)."""
        if x.shape[0] != self.total:
            raise ValueError(f"expected {self.total} global rows, got {x.shape[0]}")
        return x[self.first:self.first + self.rows]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's mean of a per-row quantity, from ``x``, its
        mean over this rank's local rows: each rank adds its mean at the
        weight of its real rows (0 for the stand-in row, whose gradient is
        then 0)."""
        return global_sum(x * (self.n / self.total), self.ctx.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`gather_rows` of ``x``."""
        return gather_rows(x, self)

    @torch.no_grad()
    def gather_constant(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` for a tensor that carries no gradient (labels)."""
        return _gather(x.contiguous(), self)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sums the parameters' gradients over the ranks: one flattened buffer
    in the parameters' order, one ``all_reduce``, written back (a missing
    gradient counts as zeros and is set)."""
    params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.numel()
        g = flat[offset:offset + n].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        offset += n


@torch.no_grad()
def differs_from_main(tensors: Iterable[torch.Tensor], group) -> torch.Tensor:
    """A device bool: whether ``tensors`` differ from rank 0's (one
    broadcast, no host read)."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0, group=group)
    return (flat != ref).any()


def check_replicated(tensors: Iterable[torch.Tensor], group, what: str) -> None:
    """Raises, on every rank, unless ``tensors`` hold rank 0's values
    bitwise on every rank."""
    tensors = list(tensors)
    if not tensors:
        return
    differs = differs_from_main(tensors, group).to(torch.int64)
    dist.all_reduce(differs, op=dist.ReduceOp.MAX, group=group)
    if int(differs):
        raise RuntimeError(f"{what} differ across the ranks")


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, tuples (named too) and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def sharded(noise: Any, share: "RowShare") -> Any:
    """``take`` on every tensor of (nested) global-batch draws whose
    leading dim is the batch; tensors of another leading dim (a step's
    coin and seed) and other leaves are kept."""
    return tree_map(lambda x: share.take(x) if isinstance(x, torch.Tensor) and x.ndim
                    and x.shape[0] == share.total else x, noise)
