"""Online ragged training for DLRM: the row-wise sparse optimizer
(``sparse_optim``) and the ``OnlineTrainer`` with its live hot-row cache
and broadcast artifacts, and ``OnlineGroupTrainer``, its per-table
sibling for heterogeneous table groups (``online``)."""
from repro_torch.core.embedding_source import VersionedSource
from repro_torch.training.online import (OnlineCacheConfig,
                                         OnlineGroupTrainer, OnlineTrainer,
                                         VersionedHotCache,
                                         make_drifting_zipf)
from repro_torch.training.sparse_optim import (SparseOptimizer,
                                               group_row_grads,
                                               group_rowwise_adagrad,
                                               ragged_row_grads,
                                               shard_local_rows,
                                               source_row_grads,
                                               sparse_rowwise_adagrad,
                                               unique_padded)

__all__ = ["OnlineCacheConfig", "OnlineGroupTrainer", "OnlineTrainer",
           "SparseOptimizer",
           "VersionedHotCache", "VersionedSource", "group_row_grads",
           "group_rowwise_adagrad", "make_drifting_zipf", "ragged_row_grads",
           "shard_local_rows", "source_row_grads", "sparse_rowwise_adagrad", "unique_padded"]
