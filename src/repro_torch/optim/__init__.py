"""Optimizers, the counterpart of the reference's ``repro.optim``."""
from repro_torch.optim.optimizers import (Layout, Optimizer, adafactor,
                                          adamw,
                                          clip_by_global_norm, from_config,
                                          global_norm, layerwise,
                                          partitioned, rowwise_adagrad, sgd,
                                          tree_leaves, tree_map, tree_paths,
                                          warmup_cosine)

__all__ = ["Layout", "Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "from_config", "global_norm", "layerwise", "partitioned",
           "rowwise_adagrad", "sgd", "tree_leaves", "tree_map", "tree_paths",
           "warmup_cosine"]
