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

Fixed layout: (B, T, L) per-table ids, every bag exactly L long,
flattened into arena rows by ``flatten_indices``; ``null_indices`` is
the all-null stream that pipeline tails reduce.

Also here: the int8 row-wise quantization rule and the hot-row cache
(``HotRowCache``, its host-side build from a trace histogram, the
hot/cold split of a flat stream, hit accounting) that
``embedding_source`` composes into sources.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


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


def flatten_indices(spec: ArenaSpec, indices: torch.Tensor) -> torch.Tensor:
    """(B, T, L) per-table row ids -> (B*T, L) arena row ids (base +
    offset)."""
    b, t, l = indices.shape
    base = torch.arange(t, dtype=indices.dtype,
                        device=indices.device) * spec.rows_per_table
    return (indices + base[None, :, None]).reshape(b * t, l)


def null_indices(spec: ArenaSpec, shape, *,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-table ids of shape (..., T, L) that all flatten to the null
    (always-zero) arena row: id (T - t) * rows_per_table for table t.

    Gathering them is a zero-contribution reduction over one row that
    stays in the cache: the no-op stream for pipeline tails.
    """
    if shape[-2] != spec.n_tables:
        raise ValueError(f"shape {tuple(shape)} has {shape[-2]} tables, "
                         f"the arena {spec.n_tables}")
    ids = (spec.n_tables - torch.arange(spec.n_tables, dtype=torch.int32,
                                        device=device)) \
        * spec.rows_per_table
    return ids[:, None].expand(tuple(shape)).contiguous()


def quantize_arena(arena: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 quantization of the arena: (q int8 (R, D),
    scales f32 (R, 1)). A zero row gets a zero scale, which keeps the null
    row inert."""
    return _rowwise_quantize(arena.float())


def _rowwise_quantize(a32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-wise int8 rule, shared by the full build and the
    incremental ``quantize_rows`` patch, so a patch equals a rebuild. Its
    steps are the reference's: divide (not multiply by a reciprocal) and
    round half to even, as ``jnp.round`` does, so q and scales match it
    exactly."""
    amax = a32.abs().amax(dim=-1, keepdim=True)
    scales = amax / 127.0
    q = torch.where(scales > 0,
                    torch.clamp(torch.round(a32 / torch.clamp(scales,
                                                              min=1e-30)),
                                -127, 127), 0.0).to(torch.int8)
    return q, scales


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
    # a Python scalar, not a device tensor: copying one to the card
    # would wait for the stream
    return torch.where(valid, indices[safe], fill)


def flatten_ragged_indices(spec: ArenaSpec, indices: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """Per-table row ids (N,) -> arena row ids (N,) (base + offset).

    The owning table of each position follows from its bag id; padded
    tail positions are routed to the always-zero null row.
    """
    table, valid = ragged_position_tables(offsets, indices.shape[0],
                                          spec.n_tables)
    flat = indices + table.to(indices.dtype) * spec.rows_per_table
    return torch.where(valid, flat, spec.null_row)


# ---------------------------------------------------------------------------
# Hot-row cache: the top-K rows by trace frequency pinned in a small
# replicated arena (K + 1 rows, slot K the zero miss slot). A lookup
# splits into hot slots (misses -> slot K) and cold ids (hits -> the null
# row), and the hot plus the cold reduction is exactly the uncached one.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HotRowCache:
    hot_rows: torch.Tensor   # (K+1, D), slot K always zero
    slot_of: torch.Tensor    # (arena_rows,) int32: slot, or K when cold
    hot_ids: torch.Tensor    # (K,) int32 pinned arena rows

    @property
    def k(self) -> int:
        return self.hot_rows.shape[0] - 1


def trace_row_counts(spec: ArenaSpec, indices, offsets=None,
                     rows: Optional[int] = None) -> np.ndarray:
    """Arena-row touch histogram of an access trace, on the host (numpy).

    indices: fixed-shape (B, T, L) per-table ids, or, with ``offsets``,
    the flat ragged stream (its padded tail ignored).
    """
    rows = rows or spec.total_rows
    idx = np.asarray(indices)
    if offsets is None:
        base = np.arange(idx.shape[1], dtype=idx.dtype) * spec.rows_per_table
        flat = (idx + base[None, :, None]).ravel()
    else:
        off = np.asarray(offsets)
        n_valid = int(off[-1])
        seg = np.searchsorted(off[1:], np.arange(n_valid), side="right")
        flat = idx[:n_valid] + (seg % spec.n_tables) * spec.rows_per_table
    return np.bincount(flat, minlength=rows)


def build_hot_cache(arena: torch.Tensor, spec: ArenaSpec, counts,
                    k: int) -> HotRowCache:
    """Pin the top-k arena rows by trace frequency. The ranking runs on
    the host exactly as the reference's (among equal counts the highest
    row id comes first); the hot copies are gathered on the arena's
    device."""
    counts = np.asarray(counts)[:spec.null_row]     # real rows only
    k = int(min(k, counts.size))
    hot_ids = np.argsort(counts, kind="stable")[::-1][:k].astype(np.int32)
    slot_of = np.full((arena.shape[0],), k, np.int32)
    slot_of[hot_ids] = np.arange(k, dtype=np.int32)
    ids = torch.from_numpy(hot_ids).to(arena.device)
    hot_rows = torch.cat([arena[ids],
                          arena.new_zeros((1, arena.shape[1]))])
    return HotRowCache(hot_rows=hot_rows,
                       slot_of=torch.from_numpy(slot_of).to(arena.device),
                       hot_ids=ids)


def cache_split_flat(cache: HotRowCache, null_row: int, flat: torch.Tensor,
                     offsets: torch.Tensor, max_l: int):
    """The hot/cold split over flattened arena row ids: the hot pass
    reduces cache slots (a miss reads the zero slot K) with
    ``sparse_lengths_sum``, and the cold ids redirect cached rows to the
    arena's null row, so any cold reduction over them is exactly the
    complement. Returns (hot sum (n_bags, D) f32, cold ids (N,))."""
    slots = cache.slot_of[flat]
    hot = ops.sparse_lengths_sum(cache.hot_rows, slots, offsets,
                                 max_l=max_l).float()
    # a Python scalar, not a device tensor: copying one to the card
    # would wait for the stream
    cold_idx = torch.where(slots < cache.k, null_row, flat)
    return hot, cold_idx


def cache_split(cache: HotRowCache, spec: ArenaSpec, indices: torch.Tensor,
                offsets: torch.Tensor, max_l: int):
    """``cache_split_flat`` over per-table ids (flattens first). Returns
    (hot sum (n_bags, D) f32, cold ids (N,), n_bags)."""
    n_bags = offsets.shape[0] - 1
    flat = flatten_ragged_indices(spec, indices, offsets)
    hot, cold_idx = cache_split_flat(cache, spec.null_row, flat, offsets,
                                     max_l)
    return hot, cold_idx, n_bags


def cache_hits(cache: HotRowCache, spec: ArenaSpec, indices: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """Lookups of a ragged batch served from the hot arena, an int64
    0-dim tensor on the batch's device (no host sync). The padded tail
    flattens to the null row, which is never pinned, so it counts as a
    miss without a mask."""
    flat = flatten_ragged_indices(spec, indices, offsets)
    return (cache.slot_of[flat] < cache.k).sum()


def cache_hit_rate(cache: HotRowCache, spec: ArenaSpec, indices: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Fraction of the (valid) lookups served from the hot arena."""
    return cache_hits(cache, spec, indices, offsets) \
        / torch.clamp(offsets[-1], min=1)
