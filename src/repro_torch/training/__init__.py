"""Online ragged training for DLRM: the row-wise sparse optimizer
(``sparse_optim``) and the uncached ``OnlineTrainer`` (``online``)."""
from repro_torch.training.online import OnlineTrainer
from repro_torch.training.sparse_optim import (SparseOptimizer,
                                               ragged_row_grads,
                                               source_row_grads,
                                               sparse_rowwise_adagrad,
                                               unique_padded)

__all__ = ["OnlineTrainer", "SparseOptimizer", "ragged_row_grads",
           "source_row_grads", "sparse_rowwise_adagrad", "unique_padded"]
