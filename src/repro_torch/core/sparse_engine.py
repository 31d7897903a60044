"""The Centaur sparse engine: the embedding arena and its ragged layout.

Every embedding table lives at a base offset inside one flat row *arena*
``(n_tables * rows_per_table + 1, D)`` (the paper's BPregs: base pointer
+ row). The final arena row is an always-zero null row: masked lookups, short bags
and the padded tail of a ragged stream all point at it, so the reduction
kernel needs no mask.

Ragged batch layout: bags are ordered (sample, table) row-major -- bag k
holds sample k // n_tables, table k % n_tables. ``indices`` is the flat
stream of per-table row ids of all bags, possibly padded past
``offsets[-1]`` (padding is inert); ``offsets`` has B*T+1 entries. Ids
and offsets are int32 throughout, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ArenaSpec:
    """Static description of the embedding arena (the BPregs contents)."""
    n_tables: int
    rows_per_table: int
    dim: int
    dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        # +1: trailing always-zero null row for masked lookups
        return self.n_tables * self.rows_per_table + 1

    @property
    def null_row(self) -> int:
        return self.n_tables * self.rows_per_table


def init_arena(generator: torch.Generator, spec: ArenaSpec,
               scale: float = 0.01) -> torch.Tensor:
    """Arena of all tables with the null row zeroed, drawn from
    ``generator`` on its device. (Row padding for shards comes with the
    sharded sources, ROADMAP Queue 1, item 13.)"""
    arena = torch.randn((spec.total_rows, spec.dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
    arena.mul_(scale)
    arena[spec.null_row] = 0.0
    return arena.to(getattr(torch, spec.dtype))


def ragged_segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Bag id per index position; positions >= offsets[-1] get n_bags."""
    pos = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets[1:], pos, right=True,
                              out_int32=offsets.dtype == torch.int32)


def ragged_position_tables(offsets: torch.Tensor, n: int,
                           n_tables: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owning table, validity) per flat stream position: the single
    encoding of the (sample, table) row-major bag convention."""
    n_bags = offsets.shape[0] - 1
    seg = ragged_segment_ids(offsets, n)
    table = torch.clamp(seg, max=n_bags - 1) % n_tables
    return table, seg < n_bags


def ragged_dense_ids(indices: torch.Tensor, offsets: torch.Tensor, *,
                     max_l: int, fill: int) -> torch.Tensor:
    """Relayout a ragged id stream into a static (n_bags, max_l) matrix.

    ``dense[b, j] = indices[offsets[b] + j]`` for j inside bag b, `fill`
    elsewhere (short bags and the padded tail). Done once per batch, it
    turns the reduction into a mask-free gather + per-bag sum. `max_l`
    must bound every bag's length; with `fill` pointing at an always-zero
    row the result needs no masking.
    """
    n = indices.shape[0]
    n_bags = offsets.shape[0] - 1
    if n == 0 or max_l == 0:
        return torch.full((n_bags, max_l), fill, dtype=indices.dtype,
                          device=indices.device)
    pos = offsets[:-1, None] + torch.arange(max_l, dtype=offsets.dtype,
                                            device=offsets.device)
    valid = pos < offsets[1:, None]
    safe = torch.clamp(torch.where(valid, pos, 0), max=n - 1)
    return torch.where(valid, indices[safe],
                       torch.tensor(fill, dtype=indices.dtype,
                                    device=indices.device))


def flatten_ragged_indices(spec: ArenaSpec, indices: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """Per-table row ids (N,) -> arena row ids (N,) (base + offset).

    The owning table of each position follows from its bag id; padded
    tail positions are routed to the always-zero null row.
    """
    table, valid = ragged_position_tables(offsets, indices.shape[0],
                                          spec.n_tables)
    flat = indices + table.to(indices.dtype) * spec.rows_per_table
    return torch.where(valid, flat,
                       torch.tensor(spec.null_row, dtype=indices.dtype,
                                    device=indices.device))
