"""Optimizers: the DLRM subset of the reference's ``repro.optim``."""
from repro_torch.optim.optimizers import (Optimizer, adamw, partitioned,
                                          rowwise_adagrad, tree_leaves,
                                          tree_map)

__all__ = ["Optimizer", "adamw", "partitioned", "rowwise_adagrad",
           "tree_leaves", "tree_map"]
