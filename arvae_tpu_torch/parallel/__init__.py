"""Data parallelism over cards (``torch.distributed``): the counterpart of
``arvae_tpu/parallel``."""

from arvae_tpu_torch.parallel.collectives import (RowShare, all_reduce_grads,
                                                  check_replicated, gather_rows, global_sum,
                                                  sharded)
from arvae_tpu_torch.parallel.mesh import (DataContext, init_data_parallel, masked_mean,
                                           shard_batch, shard_batch_padded,
                                           shard_batch_truncated)

__all__ = ["DataContext", "RowShare", "all_reduce_grads", "check_replicated", "gather_rows",
           "global_sum", "init_data_parallel", "masked_mean", "shard_batch",
           "shard_batch_padded", "shard_batch_truncated", "sharded"]
