"""Embedding sources: two lookup entry points over swappable backends.

Every way of materialising a reduced embedding bag is an
``EmbeddingSource``. The sparse stage is one call for each batch layout:

    lookup_bags(source, spec, indices, offsets, *, max_l)   ragged:
        (N,) flat per-table ids + (B*T+1,) offsets -> (B, T, D)
    lookup_fixed(source, spec, indices)                     fixed:
        (B, T, L) per-table ids -> (B, T, D)

Ported sources::

    FpArena(arena)                     full-precision row arena
    QuantizedArena(q, scales)          int8 rows + per-row f32 scale
    ShardedArena(inner, mesh, axis)    either of those two row-sharded
                                       over a mesh axis: ``inner`` holds
                                       this rank's block, and one
                                       all-reduce of reduced D-vectors
                                       combines the ranks' partials
    CachedSource(hot, cold)            replicated top-K hot rows + any of
                                       these as the cold source
    TableGroupSource(members, specs)   heterogeneous per-table members
                                       (own vocab + dim each), composed
                                       per table through ``TablePlan``

and, registered by ``repro_torch.storage``, the tiered sources
(``TieredSource``, ``Int4Arena``, ``HostTier``), with the declarative
plan that builds them (``SourceSpec``) and the versioned broadcast
artifact (``VersionedSource``, the reference's
``CSA1`` layout, so a blob written by either package decodes in the
other). The hot/cold law holds bit for bit: a coherent ``CachedSource``
over an ``FpArena`` reduces to exactly the ``FpArena`` lookup; and a
``TableGroupSource`` lookup is, table by table, its members' own lookups
(``lookup_bags_per_table``). A ``ShardedArena`` agrees with the
replicated lookup within rounding (a bag whose rows lie on several ranks
is summed in another association), exactly at one shard, where bags lie
on one rank, and between ranks (one all-reduce hands every rank the same
bits).

A table group's member may be any of these, a tiered source included.
A ``ShardedArena`` shards over any named mesh axis; on a mesh with other
axes too (the (data, model) mesh) the fixed-L bags split over those, as
the reference's do. A tiered source does not row-shard, in the reference
either: a sharded tiered plan raises its ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sparse_engine as se
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.obs.tracing import stage as obs_stage

__all__ = ["CachedSource", "EmbeddingSource", "FpArena", "QuantizedArena",
           "ShardedArena", "SourceSpec", "TableGroupSource", "TablePlan",
           "VersionedSource", "adopt_source", "clone_source",
           "describe_source", "fmt_bytes", "group_hit_counts",
           "group_trace_counts", "hot_cache_of", "lookup_bags",
           "lookup_bags_per_table", "lookup_fixed", "rebind_arena",
           "register_meta_type", "register_source", "replace_member",
           "resolve_source", "source_bytes", "source_structure",
           "with_hot_cache"]


class EmbeddingSource:
    """Base protocol for embedding sources.

    A source implements ``reduce_flat`` (the ragged reduction over
    flattened arena row ids) and ``out_dtype``. The entry points route
    through ``reduce_dense``: ``reduce_bags`` relayouts the ragged stream
    once into a static (n_bags, max_l) id matrix
    (``se.ragged_dense_ids``), and a fixed-L batch already is one
    (``reduce_fixed``). ``reduce_dense`` falls back to ``reduce_flat``
    with uniform offsets, so a new source is still one dataclass
    implementing ``reduce_flat``; the built-in sources override it with
    their fused forms. ``reduce_bags`` and ``reduce_fixed_ids`` are the
    per-table-id halves of the two entry points, flattening against the
    uniform arena layout; only ``TableGroupSource``, whose tables share no
    layout, overrides them. The shard-local hooks (``shard_reduce_flat``,
    ``shard_reduce_dense``, ``shard_reduce_fixed``) are asked only of the
    sources that can sit inside ``ShardedArena``: each returns rank
    ``shard``'s f32 partials over its block, before the all-reduce.
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

    def reduce_fixed_ids(self, spec: se.ArenaSpec,
                         indices: torch.Tensor) -> torch.Tensor:
        """(B, T, L) per-table row ids -> f32 (B*T, D)."""
        return self.reduce_fixed(spec, se.flatten_indices(spec, indices))

    def reduce_flat(self, spec: se.ArenaSpec, flat: torch.Tensor,
                    offsets: torch.Tensor, *, max_l: int) -> torch.Tensor:
        """(N,) arena row ids + (n_bags+1,) offsets -> f32 (n_bags, D),
        each bag at most ``max_l`` long."""
        raise NotImplementedError(
            f"{type(self).__name__} implements neither reduce_flat nor "
            "reduce_dense")

    def reduce_dense(self, spec: se.ArenaSpec,
                     dense: torch.Tensor) -> torch.Tensor:
        """(n_bags, max_l) arena row ids (short/padded slots point at the
        zero null row) -> f32 (n_bags, D). Default: the ragged reduction
        with uniform offsets, so a ``reduce_flat``-only source works
        unchanged."""
        n_bags, l = dense.shape
        offsets = torch.arange(n_bags + 1, dtype=torch.int32,
                               device=dense.device) * l
        return self.reduce_flat(spec, dense.reshape(-1), offsets, max_l=l)

    def reduce_fixed(self, spec: se.ArenaSpec,
                     flat: torch.Tensor) -> torch.Tensor:
        """(B*T, L) arena row ids -> f32 (B*T, D). A fixed-L batch is
        already a dense id matrix, so this is the fused hook."""
        return self.reduce_dense(spec, flat)

    def _not_shardable(self):
        return NotImplementedError(
            f"{type(self).__name__} cannot be row-sharded; wrap a leaf "
            f"source (FpArena / QuantizedArena) in ShardedArena instead")

    def shard_reduce_flat(self, spec: se.ArenaSpec, flat: torch.Tensor,
                          offsets: torch.Tensor, shard: int, *,
                          max_l: int) -> torch.Tensor:
        """Shard-local half of ``reduce_flat`` (the source holds rank
        ``shard``'s block): f32 (n_bags, D) partials."""
        raise self._not_shardable()

    def shard_reduce_dense(self, spec: se.ArenaSpec, dense: torch.Tensor,
                           shard: int) -> torch.Tensor:
        """Shard-local half of ``reduce_dense``."""
        raise self._not_shardable()

    def shard_reduce_fixed(self, spec: se.ArenaSpec, flat: torch.Tensor,
                           shard: int) -> torch.Tensor:
        """Shard-local half of ``reduce_fixed``."""
        raise self._not_shardable()


@dataclass(frozen=True)
class FpArena(EmbeddingSource):
    """The plain full-precision row arena, the reference source every
    other composition must agree with."""
    arena: torch.Tensor                  # (rows, D)

    @property
    def out_dtype(self) -> torch.dtype:
        return self.arena.dtype

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        return ops.sparse_lengths_sum(self.arena, flat, offsets,
                                      max_l=max_l).float()

    def reduce_dense(self, spec, dense):
        return ops.fused_segment_sum(self.arena, dense,
                                     null_row=spec.null_row)

    def reduce_fixed(self, spec, flat):
        # one embedding_bag pass over all tables: the fixed layout has no
        # fill slots, so no null row to pin
        return ops.embedding_bag(self.arena, flat).float()

    def shard_reduce_flat(self, spec, flat, offsets, shard, *, max_l):
        return se.ragged_partial_reduce(self.arena, flat, offsets, shard,
                                        max_l=max_l)

    def shard_reduce_dense(self, spec, dense, shard):
        return se.dense_partial_reduce(self.arena, dense, shard,
                                       null_row=spec.null_row)

    def shard_reduce_fixed(self, spec, flat, shard):
        return se.fixed_partial_reduce(self.arena, flat, shard,
                                       null_row=spec.null_row)


@dataclass(frozen=True)
class QuantizedArena(EmbeddingSource):
    """int8 rows + one f32 scale per row, dequantized in the gather. The
    null row's zero scale keeps every redirect inert. The reference
    reduces it in XLA, with no Pallas kernel; here it is torch ops."""
    q: torch.Tensor                      # (rows, D) int8
    scales: torch.Tensor                 # (rows, 1) f32

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32

    @classmethod
    def from_arena(cls, arena: torch.Tensor) -> "QuantizedArena":
        q, scales = se.quantize_arena(arena)
        return cls(q=q, scales=scales)

    def quantize_rows(self, arena: torch.Tensor,
                      rows: torch.Tensor) -> "QuantizedArena":
        """A new ``QuantizedArena`` with only ``rows`` re-quantized from
        ``arena``: the incremental maintenance patch, equal to a full
        ``from_arena`` rebuild when only ``rows`` changed. This one is
        left as it was, as the reference's is, so an engine serving it
        keeps its version. Duplicate rows write equal values, so the
        order in which their writes land does not matter."""
        qr, scales = se._rowwise_quantize(arena[rows].float())
        q, s = self.q.clone(), self.scales.clone()
        q[rows] = qr
        s[rows] = scales
        return QuantizedArena(q=q, scales=s)

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        # the reference segment-sums the stream in XLA; on the card a
        # scatter (index_add_) would add with float atomics, so the port
        # relayouts the stream (max_l bounds every bag) and takes the
        # one-pass dequantizing sum, deterministic on both devices
        return self.reduce_dense(spec, se.ragged_dense_ids(
            flat, offsets, max_l=max_l, fill=spec.null_row))

    def reduce_dense(self, spec, dense):
        rows = self.q[dense].float() * self.scales[dense]
        return rows.sum(dim=1)

    def shard_reduce_flat(self, spec, flat, offsets, shard, *, max_l):
        return se.ragged_partial_reduce_q(self.q, self.scales, flat, offsets,
                                          shard, max_l=max_l)

    def shard_reduce_dense(self, spec, dense, shard):
        return se.dense_partial_reduce_q(self.q, self.scales, dense, shard,
                                         null_row=spec.null_row)

    def shard_reduce_fixed(self, spec, flat, shard):
        return self.shard_reduce_dense(spec, flat, shard)


@dataclass(frozen=True)
class ShardedArena(EmbeddingSource):
    """A leaf source (``FpArena`` / ``QuantizedArena``) row-sharded over
    ``axis`` of ``mesh``: the port's form of the reference's
    ``shard_map``. ``inner`` holds this rank's block (its rows, then the
    zero sentinel; ``se.shard_block``), which is what ``shard_map`` hands
    the reference's body; the block is replicated over the mesh's other
    axes (the data axes).

    Each reduce runs the inner source's shard-local half over the block
    (ids the rank does not own, and the null row, sit on the sentinel)
    and sums the ranks' f32 (n_bags, D) partials over the row axis with
    one all-reduce (``collectives.psum``, whose backward is the identity):
    only reduced vectors cross ranks, never raw rows. The sum is rounded
    through the inner dtype and back to f32, as the reference's is. With
    one shard the inner source reduces on its own. Every rank calls each
    reduce with the same batch.

    The ragged reduces stay replicated over the data axes (a flat
    stream's offsets are global bag boundaries, so it cannot split);
    ``reduce_fixed`` splits its (B*T, L) bags over them, as the
    reference's ``batch_spec`` does: each data group reduces its own
    rows' partials, ``psum`` sums them over the row axis, and
    ``all_gather`` over the data axes hands every rank the whole
    (B*T, D) result, which is the reference's global array. The block's
    gradient is then summed over the data axes
    (``collectives.replicated``): each data group's backward sees only
    its own bags.
    """
    inner: EmbeddingSource
    mesh: object
    axis: str = "model"

    @property
    def out_dtype(self) -> torch.dtype:
        return self.inner.out_dtype

    @property
    def n_shards(self) -> int:
        return se.mesh_shards(self.mesh, self.axis)

    @property
    def shard(self) -> int:
        return self.mesh.rank(self.axis) if self.n_shards > 1 else 0

    def _data_axes(self) -> Tuple[str, ...]:
        """The non-row mesh axes: the fixed-path batch partitions over
        them (each data group reduces only its own samples)."""
        return tuple(a for a in self.mesh.axis_names if a != self.axis)

    def _combine(self, part: torch.Tensor) -> torch.Tensor:
        return collectives.psum(part, self.mesh, self.axis) \
            .to(self.inner.out_dtype).float()

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        if self.n_shards == 1:
            return self.inner.reduce_flat(spec, flat, offsets, max_l=max_l)
        return self._combine(self.inner.shard_reduce_flat(
            spec, flat, offsets, self.shard, max_l=max_l))

    def reduce_dense(self, spec, dense):
        if self.n_shards == 1:
            return self.inner.reduce_dense(spec, dense)
        return self._combine(self.inner.shard_reduce_dense(spec, dense,
                                                           self.shard))

    def reduce_fixed(self, spec, flat):
        if self.n_shards == 1:
            return self.inner.reduce_fixed(spec, flat)
        data = self._data_axes()
        n_data = collectives.axes_size(self.mesh, data)
        if n_data == 1:
            return self._combine(self.inner.shard_reduce_fixed(
                spec, flat, self.shard))
        n = flat.shape[0]
        rows = -(-n // n_data)
        if rows * n_data != n:
            # bags of null rows (zero, and cut off below) fill the last
            # group: the reference's shard_map needs B*T to divide
            flat = torch.cat([flat, flat.new_full(
                (rows * n_data - n, flat.shape[1]), spec.null_row)])
        mine = flat.narrow(0, collectives.axes_index(self.mesh, data) * rows,
                           rows)
        part = _replicated_over(self.inner, self.mesh, data) \
            .shard_reduce_fixed(spec, mine, self.shard)
        return collectives.all_gather(self._combine(part), self.mesh,
                                      data)[:n]


def _replicated_over(source: EmbeddingSource, mesh, axes) -> EmbeddingSource:
    """``source`` with each tensor field that takes a gradient wrapped in
    ``collectives.replicated`` over ``axes``: its gradient summed over
    them (the transpose of a ``shard_map`` input replicated over the
    data axes). The source itself when no field takes one."""
    fields = {f.name: collectives.replicated(getattr(source, f.name), mesh,
                                             axes)
              for f in dataclasses.fields(source)
              if isinstance(getattr(source, f.name), torch.Tensor)
              and getattr(source, f.name).requires_grad}
    return dataclasses.replace(source, **fields) if fields else source


@dataclass(frozen=True)
class CachedSource(EmbeddingSource):
    """Replicated top-K hot rows + a cold source for the tail.

    The hot pass reduces cache slots (misses hit the zero miss slot) and
    the cold ids redirect cached rows to the arena's null row, so any
    cold reduction over them is exactly the complement: hot + cold ==
    uncached, for every cold source.

    ``coherent=True`` declares that the hot copies equal their cold rows
    at serve time (a plan built from the live arena, a write-through
    boundary). In the reference it lets XLA serve an fp cold straight
    from the arena; the port takes the two-table walk either way, so on
    the port the flag only travels with the source's structure.
    """
    hot: se.HotRowCache
    cold: EmbeddingSource
    coherent: bool = False

    @property
    def out_dtype(self) -> torch.dtype:
        return self.cold.out_dtype

    @property
    def k(self) -> int:
        return self.hot.k

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        hot, cold_idx = se.cache_split_flat(self.hot, spec.null_row, flat,
                                            offsets, max_l)
        return hot + self.cold.reduce_flat(spec, cold_idx, offsets,
                                           max_l=max_l)

    def reduce_dense(self, spec, dense):
        # one pass with the hit test folded into the walk: per position
        # exactly one of hot_rows[slot] and cold[cold_id] is nonzero. Over
        # an fp arena the stage op makes the split inside its kernel
        cold = self.cold
        if isinstance(cold, FpArena):
            return ops.fused_cached_segment_stage(
                self.hot.hot_rows, self.hot.slot_of, cold.arena, dense,
                null_row=spec.null_row)
        slots, cold_ids = kref.cached_split(self.hot.slot_of, dense, self.k,
                                            spec.null_row)
        if isinstance(cold, QuantizedArena):
            rows = self.hot.hot_rows[slots].float() \
                + cold.q[cold_ids].float() * cold.scales[cold_ids]
            return rows.sum(dim=1)
        # any other cold source (a nested cache): the hot pass on the
        # fused kernel + the cold source's own pass over the redirects
        hot = ops.fused_segment_sum(self.hot.hot_rows, slots,
                                    null_row=self.k)
        return hot + cold.reduce_dense(spec, cold_ids)


_NO_LAYOUT = ("TableGroupSource has no shared arena layout to reduce over: "
              "call lookup_bags / lookup_fixed (per-table ids) or "
              "lookup_bags_per_table (per-table streams) instead")


@dataclass(frozen=True)
class TableGroupSource(EmbeddingSource):
    """Heterogeneous per-table sources behind the one entry point: the
    workload Centaur characterizes, where vocab sizes and access skew vary
    by orders of magnitude per table, so each table is its own
    gather-reduce stream over its own arena.

    ``members[t]`` is any ported source (``FpArena``, ``QuantizedArena``,
    ``ShardedArena``, ``CachedSource``, ``storage.TieredSource``) over
    table t's private arena ``(vocab_t + 1, dim_t)`` (its own trailing
    null row); ``specs[t]`` is its single-table ``ArenaSpec(1, vocab_t,
    dim_t)``. Sharded members serve; the group train steps refuse a mesh,
    as the reference's do.

    The grouped reduction relayouts the one interleaved (sample, table)
    row-major stream once, with -1 in the short and padded slots, and
    hands each member its own (B, max_l) bag slice with those slots
    redirected to the member's always-zero null row. Each result is
    rounded through the member's dtype, as its own ``lookup_bags`` would,
    and padded with zeros to ``dmax = max(dim_t)``: table t's slice
    ``[:, t, :dim_t]`` is bit for bit the member's own lookup.
    """
    members: Tuple[EmbeddingSource, ...]
    specs: Tuple[se.ArenaSpec, ...]

    @property
    def dmax(self) -> int:
        return max(sp.dim for sp in self.specs)

    @property
    def out_dtype(self) -> torch.dtype:
        return functools.reduce(torch.promote_types,
                                [m.out_dtype for m in self.members])

    @property
    def envelope_spec(self) -> se.ArenaSpec:
        """The uniform ArenaSpec a group serves under: n_tables tables, the
        largest vocab and the largest dim (the entry points read only
        n_tables and dim of it)."""
        return se.ArenaSpec(len(self.members),
                            max(sp.rows_per_table for sp in self.specs),
                            self.dmax)

    @classmethod
    def from_arenas(cls, arenas: Sequence[torch.Tensor],
                    specs: Sequence[se.ArenaSpec],
                    mesh: Optional[object] = None) -> "TableGroupSource":
        """The default group over raw per-table arenas: one fp member a
        table, row-sharded when a mesh of more than one shard is given
        (each arena then being this rank's block of its table)."""
        if len(arenas) != len(specs):
            raise ValueError(f"{len(arenas)} arenas for {len(specs)} specs")
        return cls(members=tuple(resolve_source(a, mesh) for a in arenas),
                   specs=tuple(specs))

    def reduce_bags(self, spec, indices, offsets, *, max_l):
        t_count = len(self.members)
        if spec.n_tables != t_count or spec.dim != self.dmax:
            raise ValueError(f"spec of {spec.n_tables} tables of dim "
                             f"{spec.dim} for a group of {t_count} tables "
                             f"of dmax {self.dmax}")
        n_bags = offsets.shape[0] - 1
        if n_bags % t_count:
            raise ValueError(
                f"lookup_bags over a TableGroupSource needs the bag count "
                f"to cover whole (sample, table) rows: got n_bags={n_bags} "
                f"bags for t_count={t_count} tables (n_bags % t_count == "
                f"{n_bags % t_count}). Pass offsets with B*t_count+1 "
                f"entries (one bag per sample per table, row-major).")
        b = n_bags // t_count
        # one relayout of the interleaved stream; each member reduces only
        # its own (B, max_l) slice, with the -1 slots sent to its own null
        # row
        dense = se.ragged_dense_ids(indices, offsets, max_l=max_l, fill=-1)
        dense = dense.reshape(b, t_count, max_l)
        cols = []
        for t, (m, sp) in enumerate(zip(self.members, self.specs)):
            ids_t = dense[:, t, :]
            ids_t = torch.where(ids_t >= 0, ids_t, sp.null_row)
            red = m.reduce_dense(sp, ids_t).to(m.out_dtype).float()
            if sp.dim < spec.dim:
                red = torch.nn.functional.pad(red, (0, spec.dim - sp.dim))
            cols.append(red)
        return torch.stack(cols, dim=1).reshape(n_bags, spec.dim)

    def reduce_fixed_ids(self, spec, indices):
        b, t, l = indices.shape
        offsets = torch.arange(b * t + 1, dtype=torch.int32,
                               device=indices.device) * l
        return self.reduce_bags(spec, indices.reshape(-1), offsets, max_l=l)

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        raise TypeError(_NO_LAYOUT)

    def reduce_dense(self, spec, dense):
        raise TypeError(_NO_LAYOUT)


def lookup_bags(source: EmbeddingSource, spec: se.ArenaSpec,
                indices: torch.Tensor, offsets: torch.Tensor, *,
                max_l: int) -> torch.Tensor:
    """The ragged sparse stage: flat per-table ids + offsets -> (B, T, D)
    in the source's dtype. For a ``TableGroupSource`` D is the group's
    ``dmax``, and table t's slice ``[..., :dim_t]`` holds its bags (the
    tail is zero)."""
    with obs_stage("emb_lookup"):
        n_bags = offsets.shape[0] - 1
        out = source.reduce_bags(spec, indices, offsets, max_l=max_l)
        return out.reshape(n_bags // spec.n_tables, spec.n_tables,
                           spec.dim).to(source.out_dtype)


def lookup_fixed(source: EmbeddingSource, spec: se.ArenaSpec,
                 indices: torch.Tensor) -> torch.Tensor:
    """The fixed-L sparse stage: (B, T, L) per-table ids -> (B, T, D) in
    the source's dtype."""
    with obs_stage("emb_lookup"):
        b, t, _ = indices.shape
        out = source.reduce_fixed_ids(spec, indices)
        return out.reshape(b, t, spec.dim).to(source.out_dtype)


def lookup_bags_per_table(source: TableGroupSource,
                          indices: Sequence[torch.Tensor],
                          offsets: Sequence[torch.Tensor], *,
                          max_l: Union[int, Sequence[int]]) -> torch.Tensor:
    """The per-table-stream sibling of ``lookup_bags`` for table groups.

    ``indices[t]`` / ``offsets[t]`` are table t's own flat id stream and
    (B+1,) bag boundaries (``DLRMSynthetic.ragged_per_table``); ``max_l``
    is one bound or one a table. Returns (B, T, dmax), bit for bit
    ``lookup_bags`` over the interleaved stream of the same bags: each
    member reduces the same per-bag id runs in the same order either way.
    """
    if not isinstance(source, TableGroupSource):
        raise TypeError(f"lookup_bags_per_table needs a TableGroupSource, "
                        f"got {type(source).__name__}")
    t_count = len(source.members)
    if len(indices) != t_count or len(offsets) != t_count:
        raise ValueError(f"{len(indices)} id streams and {len(offsets)} "
                         f"offsets for {t_count} tables")
    if not isinstance(max_l, (tuple, list)):
        max_l = (max_l,) * t_count
    dmax = source.dmax
    cols = []
    for t, (m, sp) in enumerate(zip(source.members, source.specs)):
        out = lookup_bags(m, sp, indices[t], offsets[t], max_l=max_l[t])
        out = out.reshape(-1, sp.dim).float()
        if sp.dim < dmax:
            out = torch.nn.functional.pad(out, (0, dmax - sp.dim))
        cols.append(out)
    return torch.stack(cols, dim=1).to(source.out_dtype)


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def resolve_source(arena: torch.Tensor, mesh: Optional[object] = None,
                   axis: str = "model") -> EmbeddingSource:
    """The default source for a raw arena: replicated fp, row-sharded
    over ``axis`` when a mesh of more than one shard is given (``arena``
    then being this rank's block)."""
    src: EmbeddingSource = FpArena(arena)
    if se.mesh_shards(mesh, axis) > 1:
        src = ShardedArena(src, mesh, axis)
    return src


def hot_cache_of(source) -> Optional[se.HotRowCache]:
    """The hot cache a source serves from, or None (non-cached source)."""
    return source.hot if isinstance(source, CachedSource) else None


def with_hot_cache(source: CachedSource,
                   cache: se.HotRowCache) -> CachedSource:
    """Same cold source, new hot cache: the write-through/rebuild swap."""
    if not isinstance(source, CachedSource):
        raise TypeError(f"with_hot_cache needs a CachedSource, got "
                        f"{type(source).__name__}")
    return CachedSource(hot=cache, cold=source.cold,
                        coherent=source.coherent)


def replace_member(source: TableGroupSource, t: int,
                   member: EmbeddingSource) -> TableGroupSource:
    """Same group, member t swapped: the per-table refresh (a new hot
    cache for one skewed table, a re-quantized arena for one huge table).
    Of the same structure when ``member`` has the old one's, so
    ``RecEngine.update_source`` copies it in place and captures
    nothing."""
    members = list(source.members)
    members[t] = member
    return TableGroupSource(members=tuple(members), specs=source.specs)


def rebind_arena(source: EmbeddingSource, arena) -> EmbeddingSource:
    """``source`` with every fp-arena leaf replaced by ``arena`` (for a
    ``TableGroupSource``, the sequence of per-table arenas). A quantized
    arena is a frozen representation of some arena version and is left
    alone (rebuild it with ``quantize_rows`` / ``from_arena``)."""
    if isinstance(source, TableGroupSource):
        if len(arena) != len(source.members):
            raise ValueError(f"{len(arena)} arenas for a group of "
                             f"{len(source.members)} tables")
        return TableGroupSource(
            members=tuple(rebind_arena(m, a)
                          for m, a in zip(source.members, arena)),
            specs=source.specs)
    if isinstance(source, FpArena):
        return FpArena(arena)
    if isinstance(source, ShardedArena):
        return ShardedArena(rebind_arena(source.inner, arena), source.mesh,
                            source.axis)
    if isinstance(source, CachedSource):
        return CachedSource(source.hot, rebind_arena(source.cold, arena),
                            coherent=source.coherent)
    if hasattr(source, "_rebind_arena"):
        # the hook of the tiered source, which refreshes its fp hot tier
        return source._rebind_arena(arena)
    return source


def fmt_bytes(n: int) -> str:
    """Human byte label for describe/stats lines: 512 B, 4.0 KB, 5.1 MB."""
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GB"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def source_bytes(source) -> int:
    """Total device bytes of a source's tensors (slot maps and scales
    included): the denominator of every capacity claim. A host tier
    counts its device tensors only; its host rows are host bytes."""
    if hasattr(source, "device_bytes"):
        return int(source.device_bytes())
    return sum(_nbytes(t) for t in source_structure(source)[1])


def describe_source(source, *, multiline: bool = False) -> str:
    """Stats label: 'fp', 'int8', 'int4', 'sharded(4,fp)', 'cached(fp)',
    'cached(int8)', 'tiered(int4)', 'tiered(host)', 'group[...]'. With
    ``multiline=True`` every nested source renders on its own indented
    line with its dtype and byte size (a group: one line a table with its
    vocab and dim, then its member's)."""
    if multiline:
        return "\n".join(_describe_lines(source, 0))
    if isinstance(source, FpArena):
        return "fp"
    if isinstance(source, QuantizedArena):
        return "int8"
    if isinstance(source, ShardedArena):
        return f"sharded({source.n_shards},{describe_source(source.inner)})"
    if isinstance(source, CachedSource):
        return f"cached({describe_source(source.cold)})"
    if isinstance(source, TableGroupSource):
        inner = ",".join(describe_source(m) for m in source.members)
        return f"group[{inner}]"
    if hasattr(source, "_describe"):
        # the hook of the sources registered from outside this module
        return source._describe()
    return type(source).__name__


def _describe_lines(source, depth: int) -> List[str]:
    pad = "  " * depth
    if isinstance(source, FpArena):
        r, d = source.arena.shape
        return [f"{pad}fp arena ({r}x{d}, "
                f"{str(source.arena.dtype).replace('torch.', '')}, "
                f"{fmt_bytes(_nbytes(source.arena))})"]
    if isinstance(source, QuantizedArena):
        r, d = source.q.shape
        nb = _nbytes(source.q) + _nbytes(source.scales)
        return [f"{pad}int8 arena ({r}x{d} + f32 row scales, "
                f"{fmt_bytes(nb)})"]
    if isinstance(source, ShardedArena):
        return [f"{pad}sharded over {source.n_shards} x '{source.axis}' "
                f"(this rank's block)"] \
            + _describe_lines(source.inner, depth + 1)
    if isinstance(source, CachedSource):
        hot = source.hot
        nb = _nbytes(hot.hot_rows) + _nbytes(hot.slot_of) \
            + _nbytes(hot.hot_ids)
        return [f"{pad}cached (k={source.k} hot rows, "
                f"{str(hot.hot_rows.dtype).replace('torch.', '')}, "
                f"{fmt_bytes(nb)})"] \
            + _describe_lines(source.cold, depth + 1)
    if isinstance(source, TableGroupSource):
        lines = [f"{pad}group ({len(source.members)} tables, "
                 f"dmax={source.dmax}, "
                 f"{fmt_bytes(source_bytes(source))} on device)"]
        for t, (m, sp) in enumerate(zip(source.members, source.specs)):
            lines.append(f"{pad}  table[{t}] vocab={sp.rows_per_table} "
                         f"dim={sp.dim}")
            lines += _describe_lines(m, depth + 2)
        return lines
    if hasattr(source, "_describe_lines"):
        return source._describe_lines(depth)
    return [f"{pad}{type(source).__name__}"]


# ---------------------------------------------------------------------------
# Structure: the port's form of the reference's pytree treedef
# ---------------------------------------------------------------------------

# name -> (cls, data_fields, meta_fields): drives the structure check of a
# source swap and the artifact codec, as the reference's registry does;
# repro_torch.storage registers its sources on import
_SOURCE_REGISTRY = {
    "FpArena": (FpArena, ("arena",), ()),
    "QuantizedArena": (QuantizedArena, ("q", "scales"), ()),
    "ShardedArena": (ShardedArena, ("inner",), ("mesh", "axis")),
    "CachedSource": (CachedSource, ("hot", "cold"), ("coherent",)),
    "HotRowCache": (se.HotRowCache, ("hot_rows", "slot_of", "hot_ids"), ()),
    "TableGroupSource": (TableGroupSource, ("members",), ("specs",)),
}

# frozen dataclasses that may sit in a source's meta fields and round-trip
# through the codec by name (repro_torch.storage registers TierPolicy)
_META_TYPES: Dict[str, type] = {}


def register_source(cls, data_fields: tuple, meta_fields: tuple) -> None:
    """Add a source type (under its class name, as the reference's blobs
    name it) to the structure check and the artifact codec. A meta field
    listed in the class's ``__ephemeral_meta__`` is host state: it enters
    the structure by its ``_signature()`` and is left out of a blob."""
    _SOURCE_REGISTRY[cls.__name__] = (cls, tuple(data_fields),
                                      tuple(meta_fields))


def register_meta_type(cls):
    """Let a frozen dataclass sit in a source's meta fields and round-trip
    through the artifact codec."""
    _META_TYPES[cls.__name__] = cls
    return cls


def _registered(name: str):
    if name not in _SOURCE_REGISTRY:
        # the storage sources register on import: a blob that holds one
        # must not need the consumer to have imported the package first
        import repro_torch.storage  # noqa: F401
    return _SOURCE_REGISTRY.get(name)


def _meta_key(obj, field: str):
    v = getattr(obj, field)
    if field in getattr(obj, "__ephemeral_meta__", ()):
        return None if v is None else v._signature()
    return v


def source_structure(source) -> Tuple[tuple, List[torch.Tensor]]:
    """(structure, tensors): the nesting of source types with their meta
    fields (a group's members as a sequence), and the tensors in order.
    Two sources with equal structures and tensors of equal shape, dtype
    and device can replace each other on a live engine without changing
    what the serve step is shaped for."""
    leaves: List[torch.Tensor] = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            leaves.append(obj)
            return "tensor"
        if isinstance(obj, (tuple, list)):
            return ("seq", tuple(walk(x) for x in obj))
        name = type(obj).__name__
        if _SOURCE_REGISTRY.get(name, (None,))[0] is not type(obj):
            raise TypeError(f"{name} is not a source type of the port "
                            f"({sorted(_SOURCE_REGISTRY)})")
        _, data, meta = _SOURCE_REGISTRY[name]
        return (name, tuple(_meta_key(obj, f) for f in meta),
                tuple(walk(getattr(obj, f)) for f in data))

    return walk(source), leaves


# ---------------------------------------------------------------------------
# The snapshot rule: an engine's own copy of a source, swapped in place
# ---------------------------------------------------------------------------

def clone_source(source):
    """A copy of ``source`` that shares no tensor with it, and no host
    store: what a serving engine holds, so that a swap copied into it
    never writes a tensor the engine was handed. A source type with its
    own host state supplies ``_clone`` (the host tier: a new store over
    copies of the rows and mapping, nothing staged yet)."""
    if isinstance(source, torch.Tensor):
        return source.detach().clone()
    if isinstance(source, (tuple, list)):
        return type(source)(clone_source(x) for x in source)
    if hasattr(source, "_clone"):
        return source._clone()
    entry = _registered(type(source).__name__)
    if entry is None or entry[0] is not type(source):
        raise TypeError(f"{type(source).__name__} is not a source type of "
                        f"the port ({sorted(_SOURCE_REGISTRY)})")
    return dataclasses.replace(source, **{f: clone_source(getattr(source, f))
                                          for f in entry[1]})


def adopt_source(dst, src) -> None:
    """Copy ``src`` into ``dst``'s own tensors, in place, so that every
    tensor of ``dst`` keeps its address: a forward captured over ``dst``
    serves ``src``'s values from then on. A source type with host state
    supplies ``_adopt`` (the host tier's store adopts ``src``'s rows,
    ``HostStore.adopt``). The two must have the same structure and
    tensor shapes (``source_structure``); a leaf that already is
    ``src``'s is left alone."""
    def walk(d, s):
        if isinstance(d, torch.Tensor):
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)
        elif isinstance(d, (tuple, list)):
            for a, b in zip(d, s):
                walk(a, b)
        elif hasattr(d, "_adopt"):
            d._adopt(s)
        else:
            for f in _SOURCE_REGISTRY[type(d).__name__][1]:
                walk(getattr(d, f), getattr(s, f))

    with torch.no_grad():
        walk(dst, src)


# ---------------------------------------------------------------------------
# Group accounting: per-table hit counts and trace histograms
# ---------------------------------------------------------------------------

def group_hit_counts(source: TableGroupSource, indices: torch.Tensor,
                     offsets: torch.Tensor, *, max_l: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-table (hits, lookups) over one interleaved ragged batch: two
    (T,) int32 tensors, computed on the device with no host wait. A table
    whose member serves no hot cache reports 0 hits. With ``max_l`` (the
    lookup's bound) the stream is relayouted once and each table scans
    only its own (B, max_l) slice, as the lookup does; without it every
    table walks the whole stream."""
    t_count = len(source.members)
    if max_l is not None:
        n_bags = offsets.shape[0] - 1
        dense = se.ragged_dense_ids(indices, offsets, max_l=max_l, fill=-1)
        dense = dense.reshape(n_bags // t_count, t_count, max_l)
        mine = dense >= 0
        looks = mine.sum(dim=(0, 2))
        ids, owned = dense.unbind(1), mine.unbind(1)
    else:
        table, valid = se.ragged_position_tables(offsets, indices.shape[0],
                                                 t_count)
        owned = [valid & (table == t) for t in range(t_count)]
        looks = torch.stack([m.sum() for m in owned])
        ids = [indices] * t_count
    zero = torch.zeros((), dtype=looks.dtype, device=looks.device)
    hits = []
    for m, ids_t, mine_t in zip(source.members, ids, owned):
        cache = hot_cache_of(m)
        if cache is None:
            hits.append(zero)
            continue
        slots = cache.slot_of[torch.where(mine_t, ids_t, 0)]
        hits.append((mine_t & (slots < cache.k)).sum())
    return torch.stack(hits).to(torch.int32), looks.to(torch.int32)


def group_trace_counts(specs: Sequence[se.ArenaSpec], indices,
                       offsets) -> List[np.ndarray]:
    """Per-table row-touch histograms of an interleaved ragged trace
    (host numpy; the group sibling of ``se.trace_row_counts``): the hot
    rankings of a group plan."""
    idx = np.asarray(indices)
    off = np.asarray(offsets)
    t_count = len(specs)
    n_valid = int(off[-1])
    seg = np.searchsorted(off[1:], np.arange(n_valid), side="right")
    table = seg % t_count
    return [np.bincount(idx[:n_valid][table == t], minlength=sp.total_rows)
            for t, sp in enumerate(specs)]


# ---------------------------------------------------------------------------
# SourceSpec: the declarative serving plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TablePlan:
    """One table of a group plan: its shape and its own composition, a
    hot cache for the skewed tables (``cache_k``), int8 for the huge ones
    (``quantize``), tiers for the ones bigger than memory (``tiers``, a
    ``storage.TierPolicy``). A tuple of these in ``SourceSpec.tables``
    declares a ``TableGroupSource``."""
    rows: int                            # vocab (real rows, null excluded)
    dim: int
    cache_k: int = 0                     # >0: pin this table's top-K hot
    quantize: bool = False               # int8 this table's (cold) arena
    tiers: Optional[object] = None       # storage.TierPolicy

    def __post_init__(self):
        if self.tiers is not None and (self.cache_k or self.quantize):
            raise ValueError(
                "a tiered table is its own caching and quantization: "
                "TierPolicy.hot replaces cache_k and the warm/cold tiers "
                "replace quantize; drop cache_k/quantize on this TablePlan")

    @property
    def arena_spec(self) -> se.ArenaSpec:
        return se.ArenaSpec(1, self.rows, self.dim)

@dataclass(frozen=True)
class SourceSpec:
    """Declarative serving plan: which source to build, not how. A
    ``RecEngine`` takes one and calls ``build(arena, spec, counts)``. The
    path strings map onto plans through ``from_path``. With ``tables`` (a
    tuple of ``TablePlan``) the plan is a table group: ``build`` takes the
    sequence of per-table arenas and of per-table trace histograms, and
    composes each member on its own. With a ``mesh`` of more than one
    shard on ``axis`` every arena handed to ``build`` is this rank's
    block, and the (cold) arenas are row-sharded; ``require_mesh`` (the
    'sharded' path) refuses to build without one."""
    layout: str = "ragged"               # 'ragged' | 'fixed' batch layout
    cache_k: int = 0                     # >0: pin top-K rows hot
    quantize_cold: bool = False          # int8 cold/uncached arena
    mesh: Optional[object] = None
    axis: str = "model"
    require_mesh: bool = False           # 'sharded': no silent fallback
    tables: Optional[tuple] = None       # heterogeneous group
    tiers: Optional[object] = None       # storage.TierPolicy

    PATH_NAMES = ("fixed", "ragged", "cached", "sharded")

    def __post_init__(self):
        if self.layout not in ("ragged", "fixed"):
            raise ValueError(f"layout {self.layout!r} is neither 'ragged' "
                             "nor 'fixed'")
        if self.layout == "fixed" and (self.cache_k or self.quantize_cold
                                       or self.tables is not None
                                       or self.tiers is not None):
            raise ValueError(
                "layout='fixed' serves the fp arena through the fixed-L "
                "step and cannot take a cached/quantized/grouped/tiered "
                "source; drop cache_k/quantize_cold/tables/tiers or use "
                "the ragged layout")
        if self.require_mesh and se.mesh_shards(self.mesh, self.axis) < 2:
            raise ValueError(
                "require_mesh=True (path 'sharded') needs a mesh with a "
                f">1 {self.axis!r} axis: a misconfigured replica must not "
                "silently fall back to the replicated arena")
        if self.tables is not None and (self.cache_k or self.quantize_cold
                                        or self.tiers is not None):
            raise ValueError(
                "a table-group plan carries cache_k/quantize/tiers on each "
                "TablePlan; the top-level knobs would apply to no table")
        if self.tiers is not None and (self.cache_k or self.quantize_cold):
            raise ValueError(
                "a tiered plan is its own caching and quantization: "
                "TierPolicy.hot replaces cache_k and the warm/cold tiers "
                "replace quantize_cold; drop cache_k/quantize_cold")
        if self.tiers is not None \
                and se.mesh_shards(self.mesh, self.axis) > 1:
            raise ValueError(
                "TieredSource does not row-shard (the staging/slot "
                "protocol is replicated-only, as the reference's) — drop "
                "the mesh or the tiers")

    @staticmethod
    def from_path(path: Union[str, "SourceSpec"], *, cache_k: int = 0,
                  quantize_cold: bool = False, mesh: Optional[object] = None,
                  axis: str = "model") -> "SourceSpec":
        """Path string -> plan ('cached' consumes cache_k and
        quantize_cold)."""
        if isinstance(path, SourceSpec):
            return path
        if path not in SourceSpec.PATH_NAMES:
            raise ValueError(f"unknown path {path!r}; one of "
                             f"{SourceSpec.PATH_NAMES}")
        if path != "cached" and (cache_k or quantize_cold):
            # an operator who asked for a cache or int8 must pick the
            # 'cached' path (or pass a SourceSpec) to get them
            raise ValueError(f"path {path!r} ignores cache_k/quantize_cold;"
                             " use path 'cached' or a SourceSpec")
        if path == "fixed":
            return SourceSpec(layout="fixed", mesh=mesh, axis=axis)
        if path == "ragged":
            return SourceSpec(mesh=mesh, axis=axis)
        if path == "sharded":
            return SourceSpec(mesh=mesh, axis=axis, require_mesh=True)
        if cache_k <= 0:
            raise ValueError("the cached path needs cache_k > 0")
        return SourceSpec(cache_k=cache_k, quantize_cold=quantize_cold,
                          mesh=mesh, axis=axis)

    @property
    def cached(self) -> bool:
        if self.tables is not None:
            return any(tp.cache_k > 0 for tp in self.tables)
        return self.cache_k > 0

    def path_name(self) -> str:
        """The nearest path string (for stats labels)."""
        if self.tables is not None:
            return "grouped"
        if self.tiers is not None:
            return "tiered"
        if self.layout == "fixed":
            return "fixed"
        if self.cached:
            return "cached"
        return "sharded" if self.require_mesh else "ragged"

    def build(self, arena, spec: Optional[se.ArenaSpec],
              counts=None) -> EmbeddingSource:
        """Materialise the plan for an arena; ``counts`` is the trace
        histogram that ranks the hot rows, or the tiers (uniform when
        omitted). A group plan takes the sequence of per-table arenas and
        the list of per-table histograms instead, and no ``spec``. On a
        sharded plan every rank builds together (the hot rows come from
        their owners) with the same ``counts``."""
        if self.tables is not None:
            return self._build_group(arena, counts)
        if self.tiers is not None:
            return self.tiers.build_source(arena, spec, counts)
        cold: EmbeddingSource = (QuantizedArena.from_arena(arena)
                                 if self.quantize_cold else FpArena(arena))
        if se.mesh_shards(self.mesh, self.axis) > 1:
            cold = ShardedArena(cold, self.mesh, self.axis)
        if not self.cached:
            return cold
        if counts is None:
            counts = np.ones(spec.total_rows)
        hot = se.build_hot_cache(arena, spec, counts, self.cache_k,
                                 mesh=self.mesh, axis=self.axis)
        # built from the live arena right here, so the plan declares
        # coherence
        return CachedSource(hot=hot, cold=cold, coherent=True)

    def _build_group(self, arenas, counts=None) -> TableGroupSource:
        if len(arenas) != len(self.tables):
            raise ValueError(f"{len(arenas)} arenas for "
                             f"{len(self.tables)} table plans")
        if counts is None:
            counts = [None] * len(self.tables)
        sharded = se.mesh_shards(self.mesh, self.axis) > 1
        members, specs = [], []
        for tp, arena, c in zip(self.tables, arenas, counts):
            sp = tp.arena_spec
            if tp.tiers is not None:
                if sharded:
                    raise ValueError(
                        "TieredSource does not row-shard — drop the mesh "
                        "or this table's tiers")
                members.append(tp.tiers.build_source(arena, sp, c))
                specs.append(sp)
                continue
            member: EmbeddingSource = (QuantizedArena.from_arena(arena)
                                       if tp.quantize else FpArena(arena))
            if sharded:
                member = ShardedArena(member, self.mesh, self.axis)
            if tp.cache_k > 0:
                if c is None:
                    c = np.ones(sp.total_rows)
                hot = se.build_hot_cache(arena, sp, c, tp.cache_k,
                                         mesh=self.mesh, axis=self.axis)
                member = CachedSource(hot=hot, cold=member, coherent=True)
            members.append(member)
            specs.append(sp)
        return TableGroupSource(members=tuple(members), specs=tuple(specs))


# ---------------------------------------------------------------------------
# Versioned broadcast artifact: any source + a monotone version
# ---------------------------------------------------------------------------

def _encode_meta(v):
    """A meta value as JSON: plain scalars pass through, arena specs,
    table plans, registered dataclasses and sequences get the reference's
    self-describing wrappers."""
    if isinstance(v, se.ArenaSpec):
        return {"__arena_spec__": dataclasses.asdict(v)}
    if isinstance(v, TablePlan):
        return {"__table_plan__": {f.name: _encode_meta(getattr(v, f.name))
                                   for f in dataclasses.fields(v)}}
    if type(v).__name__ in _META_TYPES:
        return {"__meta_dc__": type(v).__name__,
                "fields": {f.name: _encode_meta(getattr(v, f.name))
                           for f in dataclasses.fields(v)}}
    if isinstance(v, (tuple, list)):
        return {"__seq__": [_encode_meta(x) for x in v]}
    return v


def _decode_meta(v):
    if isinstance(v, dict) and "__arena_spec__" in v:
        return se.ArenaSpec(**v["__arena_spec__"])
    if isinstance(v, dict) and "__table_plan__" in v:
        return TablePlan(**{k: _decode_meta(x)
                            for k, x in v["__table_plan__"].items()})
    if isinstance(v, dict) and "__meta_dc__" in v:
        name = v["__meta_dc__"]
        if name not in _META_TYPES:
            import repro_torch.storage  # noqa: F401  (registers its types)
        return _META_TYPES[name](**{k: _decode_meta(x)
                                    for k, x in v["fields"].items()})
    if isinstance(v, dict) and "__seq__" in v:
        return tuple(_decode_meta(x) for x in v["__seq__"])
    return v


def _unsharded(source: ShardedArena) -> EmbeddingSource:
    """The inner source of a ``ShardedArena`` with each block replaced by
    the whole arena, gathered through host memory from every rank (a
    collective): a blob holds the unsharded rows, as the reference's
    does."""
    inner = source.inner
    return dataclasses.replace(inner, **{
        f: collectives.gather_blocks(getattr(inner, f), source.mesh,
                                     source.axis)
        for f in _SOURCE_REGISTRY[type(inner).__name__][1]})


def _encode(obj, arrays: Dict[str, np.ndarray], counter: list):
    if isinstance(obj, ShardedArena) and obj.n_shards > 1:
        obj = dataclasses.replace(obj, inner=_unsharded(obj))
    if isinstance(obj, torch.Tensor):
        key = f"a{counter[0]}"
        counter[0] += 1
        arrays[key] = obj.detach().cpu().numpy()
        return {"kind": "array", "key": key}
    if isinstance(obj, (tuple, list)):
        # lists keep their list-ness, so a decoded dense head has the
        # container types of the params it replaces
        node = {"kind": "seq",
                "items": [_encode(x, arrays, counter) for x in obj]}
        if isinstance(obj, list):
            node["list"] = True
        return node
    if isinstance(obj, dict):
        return {"kind": "dict",
                "items": {k: _encode(v, arrays, counter)
                          for k, v in obj.items()}}
    if obj is None:
        return {"kind": "none"}
    name = type(obj).__name__
    if name not in _SOURCE_REGISTRY:
        raise TypeError(f"cannot serialize {name}: not a source type of "
                        f"the port ({sorted(_SOURCE_REGISTRY)})")
    _, data_fields, meta_fields = _SOURCE_REGISTRY[name]
    node = {"kind": "node", "type": name, "fields": {}}
    for f in data_fields:
        node["fields"][f] = _encode(getattr(obj, f), arrays, counter)
    for f in meta_fields:
        if isinstance(obj, ShardedArena) and f == "mesh":
            # a mesh is the process's topology, not state: the consumer
            # binds its own at deserialize time
            node["fields"][f] = {"kind": "mesh"}
        elif f in getattr(obj, "__ephemeral_meta__", ()):
            # host-process state (a HostStore): the consumer binds its
            # own; the decoded source serves its staged snapshot
            node["fields"][f] = {"kind": "ephemeral"}
        else:
            node["fields"][f] = {"kind": "meta",
                                 "value": _encode_meta(getattr(obj, f))}
    return node


def _decode(node, z, device: torch.device, mesh):
    kind = node["kind"]
    if kind == "array":
        return torch.from_numpy(np.array(z[node["key"]])).to(device)
    if kind == "seq":
        items = [_decode(x, z, device, mesh) for x in node["items"]]
        return items if node.get("list") else tuple(items)
    if kind == "dict":
        return {k: _decode(v, z, device, mesh)
                for k, v in node["items"].items()}
    if kind == "none":
        return None
    if kind != "node":
        raise ValueError(f"unknown node kind {kind!r}")
    name = node["type"]
    if _registered(name) is None:
        raise ValueError(f"unknown source type {name!r}")
    cls, data_fields, meta_fields = _SOURCE_REGISTRY[name]
    kw = {}
    for f in data_fields + meta_fields:
        sub = node["fields"][f]
        if sub["kind"] == "mesh":
            kw[f] = mesh
        elif sub["kind"] == "ephemeral":
            kw[f] = None
        elif sub["kind"] == "meta":
            kw[f] = _decode_meta(sub["value"])
        else:
            kw[f] = _decode(sub, z, device, mesh)
    if cls is ShardedArena:
        shards = se.mesh_shards(mesh, kw["axis"])
        if shards == 1:
            # no mesh on the consumer: serve the inner source replicated
            return kw["inner"]
        inner = kw["inner"]
        rank = mesh.rank(kw["axis"])
        kw["inner"] = dataclasses.replace(inner, **{
            f: se.shard_block(getattr(inner, f), rank, shards)
            for f in _SOURCE_REGISTRY[type(inner).__name__][1]})
    return cls(**kw)


@dataclass(frozen=True)
class VersionedSource:
    """Any source plus the monotone version that produced it: the fleet
    broadcast artifact for a whole serving source (hot rows and the cold
    arena), optionally with the dense MLP head. ``serialize`` and
    ``deserialize`` round-trip one self-describing blob, in the
    reference's layout; ``apply`` adopts it into an engine iff it is
    strictly newer."""
    source: EmbeddingSource
    version: int
    head: Optional[Dict] = None

    MAGIC = b"CSA1"              # Centaur source artifact, format v1

    def serialize(self) -> bytes:
        arrays, counter = {}, [0]
        tree = _encode(self.source, arrays, counter)
        extra = {}
        if self.head is not None:
            head_tree = _encode(dict(self.head), arrays, counter)
            extra["head_structure"] = np.frombuffer(
                json.dumps(head_tree).encode(), np.uint8)
        buf = io.BytesIO()
        np.savez(buf,
                 magic=np.frombuffer(self.MAGIC, np.uint8),
                 version=np.asarray(self.version, np.int64),
                 structure=np.frombuffer(
                     json.dumps(tree).encode(), np.uint8),
                 **extra, **arrays)
        return buf.getvalue()

    @staticmethod
    def deserialize(blob: bytes, mesh: Optional[object] = None, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> "VersionedSource":
        """Rebuild the artifact's tensors on ``device`` (the card unless
        told otherwise). A recorded ``ShardedArena`` gives this rank its
        block of ``mesh`` (``se.shard_block``), or unwraps to its
        replicated inner source when ``mesh`` has one shard or is None."""
        device = resolve_device(device)
        try:
            with np.load(io.BytesIO(blob)) as z:
                if z["magic"].tobytes() != VersionedSource.MAGIC:
                    raise ValueError("bad magic")
                tree = json.loads(z["structure"].tobytes().decode())
                source = _decode(tree, z, device, mesh)
                head = None
                if "head_structure" in z:
                    head = _decode(json.loads(
                        z["head_structure"].tobytes().decode()), z, device,
                        mesh)
                return VersionedSource(source=source,
                                       version=int(z["version"]), head=head)
        except Exception as e:
            raise ValueError(
                f"not a versioned-source artifact: {e}") from e

    def apply(self, engine) -> bool:
        """Adopt into a RecEngine iff strictly newer; same-or-older
        artifacts are absorbed, so a reordered delivery is safe. A carried
        dense head lands before the source swap, so the pair is one
        adoption."""
        if engine.source_version >= self.version:
            return False
        if self.head is not None:
            engine.params = {**engine.params, **self.head}
        engine.update_source(self.source, version=self.version)
        return True
