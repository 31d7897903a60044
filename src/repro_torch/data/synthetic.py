"""Synthetic DLRM traffic (deterministic, seeded).

Zipfian sparse index streams (production embedding access skew), gaussian
dense features, bernoulli click labels correlated with a hidden linear
model. The draws are numpy's and follow the reference generator call for
call, so one seed gives bit-identical batches in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import DLRMConfig


class DLRMSynthetic:
    def __init__(self, cfg: DLRMConfig, seed: int = 0, alpha: float = 1.05):
        if cfg.heterogeneous:
            raise NotImplementedError(
                "heterogeneous table inventories are not ported yet "
                "(ROADMAP Queue 1, item 8)")
        self.cfg = cfg
        self.alpha = alpha
        self.rng = np.random.RandomState(seed)
        # hidden ground-truth model for label signal
        self._w = self.rng.randn(cfg.dense_features).astype(np.float32)

    def _labels(self, dense: np.ndarray) -> np.ndarray:
        logit = dense @ self._w * 0.5
        return (self.rng.rand(len(dense))
                < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Fixed-length batch: {dense, indices (B, T, L), labels}."""
        c = self.cfg
        dense = self.rng.randn(batch_size, c.dense_features).astype(np.float32)
        raw = self.rng.zipf(self.alpha, size=(batch_size, c.n_tables,
                                              c.lookups_per_table))
        indices = ((raw - 1) % c.rows_per_table).astype(np.int32)
        return {"dense": dense, "indices": indices,
                "labels": self._labels(dense)}

    def ragged_batch(self, batch_size: int, dist: str = "poisson",
                     mean_l: Optional[int] = None,
                     max_l: Optional[int] = None,
                     pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Variable bag-length batch, the ragged production format.

        Per-(sample, table) bag lengths come from `dist`: 'fixed' (every
        bag has mean_l lookups), 'uniform' (on [0, max_l], empty bags
        included) or 'poisson' (Poisson(mean_l) clipped to [0, max_l]).

        Returns {dense, indices (flat per-table ids), offsets (B*T+1,),
        lengths, labels, max_l}. `pad_to` pads the flat index stream with
        zeros past offsets[-1] to a static size; padded positions are inert
        in every ragged consumer.
        """
        c = self.cfg
        mean_l = mean_l if mean_l is not None else c.lookups_per_table
        n_bags = batch_size * c.n_tables
        if dist == "fixed":
            max_l = max_l if max_l is not None else mean_l
            lens = np.full(n_bags, mean_l, np.int32)
        elif dist == "uniform":
            max_l = max_l if max_l is not None else 2 * mean_l
            lens = self.rng.randint(0, max_l + 1, n_bags).astype(np.int32)
        elif dist == "poisson":
            max_l = max_l if max_l is not None else 2 * mean_l
            lens = np.clip(self.rng.poisson(mean_l, n_bags),
                           0, max_l).astype(np.int32)
        else:
            raise ValueError(f"unknown length distribution: {dist}")
        if mean_l > max_l:
            raise ValueError(f"mean_l {mean_l} exceeds max_l {max_l}")

        offsets = np.zeros(n_bags + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        n = int(offsets[-1])
        raw = self.rng.zipf(self.alpha, size=n)
        indices = ((raw - 1) % c.rows_per_table).astype(np.int32)
        if pad_to is not None:
            if pad_to < n:
                raise ValueError(f"pad_to {pad_to} is below the {n} ids")
            indices = np.concatenate(
                [indices, np.zeros(pad_to - n, np.int32)])

        dense = self.rng.randn(batch_size,
                               c.dense_features).astype(np.float32)
        return {"dense": dense, "indices": indices, "offsets": offsets,
                "lengths": lens, "labels": self._labels(dense),
                "max_l": max_l}
