"""Synthetic data generators (deterministic, seeded).

DLRM: Zipfian sparse index streams (production embedding access skew),
gaussian dense features, bernoulli click labels correlated with a hidden
linear model. On a heterogeneous config table t draws Zipf(table_alphas[t])
ids folded into its own [0, table_rows[t]).

LM: token streams with a power-law unigram distribution plus a bank of
repeated 8-token phrases, so cross-entropy falls during training.

The draws are numpy's and follow the reference generators call for call,
so one seed gives bit-identical batches in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import DLRMConfig, ModelConfig


class DLRMSynthetic:
    def __init__(self, cfg: DLRMConfig, seed: int = 0, alpha: float = 1.05):
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
        if c.heterogeneous:
            indices = np.empty((batch_size, c.n_tables,
                                c.lookups_per_table), np.int32)
            for t in range(c.n_tables):
                raw = self.rng.zipf(self._alpha_of(t),
                                    size=(batch_size, c.lookups_per_table))
                indices[:, t, :] = (raw - 1) % c.resolved_table_rows[t]
        else:
            raw = self.rng.zipf(self.alpha, size=(batch_size, c.n_tables,
                                                  c.lookups_per_table))
            indices = ((raw - 1) % c.rows_per_table).astype(np.int32)
        return {"dense": dense, "indices": indices,
                "labels": self._labels(dense)}

    def _alpha_of(self, t: int) -> float:
        alphas = self.cfg.table_alphas
        return self.alpha if alphas is None else alphas[t]

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
        if c.heterogeneous:
            # position p belongs to bag seg(p), of table seg(p) % T
            seg = np.searchsorted(offsets[1:], np.arange(n), side="right")
            table = seg % c.n_tables
            indices = np.empty(n, np.int32)
            for t in range(c.n_tables):
                m = table == t
                raw = self.rng.zipf(self._alpha_of(t), size=int(m.sum()))
                indices[m] = (raw - 1) % c.resolved_table_rows[t]
        else:
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

    @staticmethod
    def ragged_per_table(batch: Dict[str, np.ndarray], n_tables: int,
                         pad_to: Union[None, int, Sequence[int]] = None
                         ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Split one interleaved ragged batch into per-table streams.

        Returns (indices_list, offsets_list): table t's flat id stream
        (its bags in sample order) and its own (B+1,) offsets, the layout
        ``lookup_bags_per_table`` and the per-table ``forward_ragged``
        consume. `pad_to` (an int or one per table) pads each stream with
        zeros to a static size.
        """
        off = batch["offsets"]
        idx = batch["indices"]
        n_bags = len(off) - 1
        idx_t, off_t = [], []
        for t in range(n_tables):
            bags = [idx[off[k]:off[k + 1]]
                    for k in range(t, n_bags, n_tables)]
            o = np.zeros(len(bags) + 1, np.int32)
            np.cumsum([len(x) for x in bags], out=o[1:])
            stream = (np.concatenate(bags).astype(np.int32) if o[-1]
                      else np.zeros(0, np.int32))
            if pad_to is not None:
                p = pad_to[t] if isinstance(pad_to, (tuple, list)) \
                    else pad_to
                if p < o[-1]:
                    raise ValueError(f"table {t}: pad_to {p} is below its "
                                     f"{int(o[-1])} ids")
                stream = np.concatenate(
                    [stream, np.zeros(p - len(stream), np.int32)])
            idx_t.append(stream)
            off_t.append(o)
        return idx_t, off_t


class LMSynthetic:
    """Token batches of an LM (the reference's ``LMSynthetic``): a ``vlm``
    model's patch embeddings before its tokens, an encoder-decoder's
    frame embeddings (B, enc_memory_len, D) beside its target tokens,
    each drawn before the tokens, as the reference draws them."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        v = cfg.vocab_size
        # power-law unigram distribution
        p = 1.0 / np.arange(1, v + 1) ** 1.1
        self._p = p / p.sum()
        # a small bank of "phrases" injected for learnable structure
        self._phrases = [
            self.rng.choice(v, size=8, p=self._p) for _ in range(32)]

    def tokens(self, batch: int, seq: int) -> np.ndarray:
        out = self.rng.choice(self.cfg.vocab_size, size=(batch, seq),
                              p=self._p)
        # inject phrases at random offsets (~25% of tokens)
        n_inject = max(1, seq // 32)
        for b in range(batch):
            for _ in range(n_inject):
                ph = self._phrases[self.rng.randint(len(self._phrases))]
                off = self.rng.randint(0, max(1, seq - len(ph)))
                out[b, off:off + len(ph)] = ph
        return out.astype(np.int32)

    def batch(self, batch: int, seq: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.is_encdec:
            return {"frames": self.rng.randn(batch, cfg.enc_memory_len,
                                             cfg.d_model).astype(np.float32),
                    "tokens": self.tokens(batch, seq)}
        if cfg.family == "vlm":
            # the patches are drawn first, as the reference draws them
            p = cfg.n_frontend_tokens
            return {"patches": self.rng.randn(batch, p, cfg.d_model)
                    .astype(np.float32),
                    "tokens": self.tokens(batch, max(2, seq - p))}
        return {"tokens": self.tokens(batch, seq)}
