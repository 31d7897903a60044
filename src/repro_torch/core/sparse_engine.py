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
from repro_torch.launch.mesh import Mesh


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

    def padded_rows(self, shards: int) -> int:
        """Arena rows padded so the row dim divides the model axis."""
        r = self.total_rows
        return ((r + shards - 1) // shards) * shards


def init_arena(generator: torch.Generator, spec: ArenaSpec, shards: int = 1,
               scale: float = 0.01) -> torch.Tensor:
    """Arena of all tables, drawn from ``generator`` on its device, with
    the null row and the padding rows for ``shards`` row-shards zero
    (``spec.padded_rows(shards)`` rows)."""
    arena = torch.randn((spec.padded_rows(shards), spec.dim),
                        generator=generator, dtype=torch.float32,
                        device=generator.device)
    arena.mul_(scale)
    arena[spec.null_row:] = 0.0
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
# The row-sharded arena (a mesh axis of N ranks, "model" by default; on a
# (data, model) mesh the block is replicated over the data axes).
# Rank r owns the contiguous rows [r * vlocal, (r + 1) * vlocal) of the
# arena padded to ``spec.padded_rows(N)`` rows, and holds them as its
# *block*: those rows, then one always-zero sentinel row (local row
# vlocal). A shard-local reduce redirects every id it does not own (and
# the null row) to the sentinel, so the port's gather kernels run over the
# block unmasked, and each bag still sums in order of j from 0.f; the
# rank's f32 partials are then summed over the axis by one all-reduce
# (``distributed.collectives.psum``), which the halves here leave to
# their caller. The sentinel's gradient is pinned to zero, it is never
# trained and never saved.
# ---------------------------------------------------------------------------

def mesh_shards(mesh, axis: str = "model") -> int:
    """Number of row shards a (mesh, axis) pair implies (1 = replicated).
    A ``mesh`` that is not the port's ``launch.mesh.Mesh`` is refused."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if axis not in mesh.axis_names:
        return 1
    return mesh.size(axis)


def shard_block(arena: torch.Tensor, shard: int, shards: int,
                vlocal: Optional[int] = None) -> torch.Tensor:
    """Rank ``shard``'s block of an unsharded arena (any rows x ...): its
    ``vlocal`` rows (default ceil(rows / shards)), zero past the arena's
    end, then the zero sentinel row; a new tensor."""
    rows = arena.shape[0]
    if vlocal is None:
        vlocal = -(-rows // shards)
    lo = shard * vlocal
    block = arena.new_zeros((vlocal + 1,) + tuple(arena.shape[1:]))
    mine = arena[lo:min(lo + vlocal, rows)]
    block[:mine.shape[0]] = mine
    return block


def shard_row_range(block: torch.Tensor, shard: int) -> Tuple[int, int]:
    """(lo, vlocal) of the contiguous row block rank ``shard`` owns."""
    vlocal = block.shape[0] - 1
    return shard * vlocal, vlocal


def shard_local_ids(ids: torch.Tensor, lo: int, vlocal: int,
                    null_row: Optional[int] = None) -> torch.Tensor:
    """Global arena row ids -> the block's local ids: an owned row keeps
    its offset from ``lo``, anything else (a foreign row, a -1 fill slot
    and, when given, the null row) points at the sentinel ``vlocal``."""
    rel = ids - lo
    mine = (rel >= 0) & (rel < vlocal)
    if null_row is not None:
        mine = mine & (ids != null_row)
    # a Python scalar, not a device tensor: copying one to the card
    # would wait for the stream
    return torch.where(mine, rel, vlocal).to(torch.int32)


def dense_partial_reduce(block: torch.Tensor, dense: torch.Tensor,
                         shard: int, *,
                         null_row: Optional[int] = None) -> torch.Tensor:
    """Shard-local half of the fused dense reduce: rank ``shard``'s f32
    (n_bags, D) partials of a (n_bags, max_l) global id matrix, one
    ``fused_segment_sum`` over the block with every id the rank does not
    own on the sentinel (whose gradient is pinned to zero). Pass
    ``null_row`` so the always-zero null row the relayout's fill slots
    point at goes to the sentinel too: the forward is the same (the row
    is zero), and its gradient is then zero on the rank that owns it."""
    lo, vlocal = shard_row_range(block, shard)
    local = shard_local_ids(dense, lo, vlocal, null_row)
    return ops.fused_segment_sum(block, local, null_row=vlocal)


def fixed_partial_reduce(block: torch.Tensor, flat: torch.Tensor,
                         shard: int, *,
                         null_row: Optional[int] = None) -> torch.Tensor:
    """Shard-local half of the fixed-L reduce: rank ``shard``'s f32
    (B*T, D) partials of (B*T, L) global ids, one ``embedding_bag`` over
    the block with foreign ids (and ``null_row``) on the sentinel, whose
    gradient is pinned to zero."""
    lo, vlocal = shard_row_range(block, shard)
    local = shard_local_ids(flat, lo, vlocal, null_row)
    return ops.embedding_bag(block, local, null_row=vlocal).float()


def ragged_partial_reduce(block: torch.Tensor, flat: torch.Tensor,
                          offsets: torch.Tensor, shard: int, *,
                          max_l: int) -> torch.Tensor:
    """Shard-local half of a ragged reduce over flattened arena row ids:
    the stream relayouted once (``max_l`` bounds every bag; the fill
    slots are -1, foreign to every rank), then ``dense_partial_reduce``.
    Returns rank ``shard``'s f32 (n_bags, D) partials."""
    dense = ragged_dense_ids(flat, offsets, max_l=max_l, fill=-1)
    return dense_partial_reduce(block, dense, shard)


def dense_partial_reduce_q(q_block: torch.Tensor, scales_block: torch.Tensor,
                           dense: torch.Tensor, shard: int, *,
                           null_row: Optional[int] = None) -> torch.Tensor:
    """``dense_partial_reduce`` over an int8 block: owned rows are
    dequantized on the rank (rows x per-row scale) and summed per bag, so
    raw int8 rows never leave it. The sentinel's zero scale keeps every
    redirect inert. Torch ops, as the replicated int8 reduce: the
    reference has no Pallas kernel for it."""
    lo, vlocal = shard_row_range(q_block, shard)
    local = shard_local_ids(dense, lo, vlocal, null_row)
    return (q_block[local].float() * scales_block[local]).sum(dim=1)


def ragged_partial_reduce_q(q_block: torch.Tensor,
                            scales_block: torch.Tensor, flat: torch.Tensor,
                            offsets: torch.Tensor, shard: int, *,
                            max_l: int) -> torch.Tensor:
    """``ragged_partial_reduce`` over an int8 block."""
    dense = ragged_dense_ids(flat, offsets, max_l=max_l, fill=-1)
    return dense_partial_reduce_q(q_block, scales_block, dense, shard)


def _masked_partial_reduce(gather_f32, lo: int, vlocal: int,
                           flat: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """The reference's ownership protocol over a flat stream, without its
    psum: foreign rows gathered as local row 0 and zero-masked, partial
    bags segment-summed. ``gather_f32(local_rows)`` loads rows as f32.
    The plain version the sentinel redirect is held against; its
    ``index_add_`` adds with float atomics on the card."""
    n = flat.shape[0]
    n_bags = offsets.shape[0] - 1
    seg = ragged_segment_ids(offsets, n)
    rel = flat - lo
    mine = (rel >= 0) & (rel < vlocal) & (seg < n_bags)
    rows = torch.where(mine[:, None], gather_f32(torch.where(mine, rel, 0)),
                       0.0)
    out = rows.new_zeros((n_bags, rows.shape[1]))
    return out.index_add_(0, torch.clamp(seg, max=n_bags - 1), rows)


def _masked_fixed_partial_reduce(gather_f32, lo: int, vlocal: int,
                                 flat: torch.Tensor, *,
                                 null_row: Optional[int] = None
                                 ) -> torch.Tensor:
    """Fixed-L sibling of ``_masked_partial_reduce`` over (B*T, L) ids
    (the reference's, without its psum), the null row masked too when
    given. Returns f32 (B*T, D)."""
    rel = flat - lo
    mine = (rel >= 0) & (rel < vlocal)
    if null_row is not None:
        mine = mine & (flat != null_row)
    rows = gather_f32(torch.where(mine, rel, 0))
    return torch.where(mine[..., None], rows, 0.0).sum(dim=1)


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
                    k: int, *, mesh=None, axis: str = "model") -> HotRowCache:
    """Pin the top-k arena rows by trace frequency. The ranking runs on
    the host exactly as the reference's (among equal counts the highest
    row id comes first); the hot copies are gathered on the arena's
    device. With a mesh of N > 1 shards on ``axis`` ``arena`` is this
    rank's block, the hot copies are brought from their owners by
    broadcast (``collectives.gather_rows``, bit for bit; every rank calls
    this with the same counts), and ``slot_of`` covers the N * vlocal
    global rows."""
    counts = np.asarray(counts)[:spec.null_row]     # real rows only
    k = int(min(k, counts.size))
    hot_ids = np.argsort(counts, kind="stable")[::-1][:k].astype(np.int32)
    shards = mesh_shards(mesh, axis)
    rows = arena.shape[0] if shards == 1 else shards * (arena.shape[0] - 1)
    slot_of = np.full((rows,), k, np.int32)
    slot_of[hot_ids] = np.arange(k, dtype=np.int32)
    ids = torch.from_numpy(hot_ids).to(arena.device)
    if shards == 1:
        pinned = arena[ids]
    else:
        from repro_torch.distributed import collectives
        pinned = collectives.gather_rows(arena, ids, mesh, axis)
    hot_rows = torch.cat([pinned, arena.new_zeros((1, arena.shape[1]))])
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
