"""Embedding sources: one ragged lookup entry point over swappable backends.

Every way of materialising a reduced embedding bag is an
``EmbeddingSource``, and the ragged sparse stage is one call,
``lookup_bags(source, spec, indices, offsets, *, max_l)``: (N,) flat
per-table ids + (B*T+1,) offsets -> (B, T, D).

This slice ports the base protocol and the full-precision ``FpArena``.
The other sources (int8, sharded, hot-cached, table groups) are ROADMAP
Queue 1, items 8 and 13.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.core import sparse_engine as se
from repro_torch.kernels import ops

__all__ = ["EmbeddingSource", "FpArena", "lookup_bags"]


class EmbeddingSource:
    """Base protocol for embedding sources.

    ``reduce_bags`` relayouts the ragged stream once into a static
    (n_bags, max_l) id matrix (``se.ragged_dense_ids``) and hands it to
    ``reduce_dense``, the fused gather + per-bag sum each source
    implements.
    """

    @property
    def out_dtype(self) -> torch.dtype:
        raise NotImplementedError

    def reduce_bags(self, spec: se.ArenaSpec, indices: torch.Tensor,
                    offsets: torch.Tensor, *, max_l: int) -> torch.Tensor:
        """(N,) per-table row ids + (n_bags+1,) offsets -> f32
        (n_bags, D): flatten into the uniform arena layout, relayout
        once, reduce fused."""
        flat = se.flatten_ragged_indices(spec, indices, offsets)
        dense = se.ragged_dense_ids(flat, offsets, max_l=max_l,
                                    fill=spec.null_row)
        return self.reduce_dense(spec, dense)

    def reduce_dense(self, spec: se.ArenaSpec,
                     dense: torch.Tensor) -> torch.Tensor:
        """(n_bags, max_l) arena row ids (short/padded slots point at the
        zero null row) -> f32 (n_bags, D)."""
        raise NotImplementedError


@dataclass(frozen=True)
class FpArena(EmbeddingSource):
    """The plain full-precision row arena, the reference source every
    other composition must agree with."""
    arena: torch.Tensor                  # (rows, D)

    @property
    def out_dtype(self) -> torch.dtype:
        return self.arena.dtype

    def reduce_dense(self, spec, dense):
        return ops.fused_segment_sum(self.arena, dense,
                                     null_row=spec.null_row)


def lookup_bags(source: EmbeddingSource, spec: se.ArenaSpec,
                indices: torch.Tensor, offsets: torch.Tensor, *,
                max_l: int) -> torch.Tensor:
    """The ragged sparse stage: flat per-table ids + offsets -> (B, T, D)
    in the source's dtype."""
    with record_function("emb_lookup"):
        n_bags = offsets.shape[0] - 1
        out = source.reduce_bags(spec, indices, offsets, max_l=max_l)
        return out.reshape(n_bags // spec.n_tables, spec.n_tables,
                           spec.dim).to(source.out_dtype)
