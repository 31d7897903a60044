"""Frequency-tiered embedding storage: hot fp / warm int8 / cold int4 or
host.

A decayed row-frequency histogram (the online trainer's, or a warm
trace) partitions the arena's rows into

* **hot**: the top rows, full precision, equal to ``FpArena`` bit for
  bit;
* **warm**: the next rows, int8 with a per-row scale (4x denser);
* **cold**: the tail, either nibble-packed int4 on the device (8x
  denser, ``Int4Arena`` on the ``fused_int4_segment_sum`` kernel) or a
  host-resident block behind a bounded staging arena (``HostTier``,
  ``storage.host_store``).

One device-side ``tier_slot`` map (arena row -> a slot in the
concatenated [hot | warm | cold] slot space) routes every gathered
position to exactly one tier; the other two read their zero null slot
there, so the three per-tier reductions add up to the composition with
no mask. Hot rows agree with the fp arena bit for bit, warm and cold
rows within their quantization bounds, and gradients reach the hot rows
through the fused op the fp path trains with.

The port of ``repro/storage/tiered.py``; the walks cover the sources the
port has, a table group's tiered members included. A tiered source does
not row-shard, as the reference's does not.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import ops
from repro_torch.storage.host_store import HostStore, HostTier

__all__ = ["Int4Arena", "TierPolicy", "TieredSource", "build_tiered",
           "host_stores_of", "migrate", "refresh_host_tiers", "tier_bytes"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rows(a: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    return a[torch.from_numpy(np.asarray(ids, np.int64)).to(a.device)]


@dataclass(frozen=True)
class Int4Arena(es.EmbeddingSource):
    """Nibble-packed int4 rows + one f32 scale per row. An all-zero (null)
    row packs to zero codes with a zero scale, so every redirect to it
    stays inert. ``dim`` is meta: the packed axis holds ceil(dim/2)
    bytes."""
    packed: torch.Tensor                 # (rows, ceil(dim/2)) uint8
    scales: torch.Tensor                 # (rows, 1) f32
    dim: int = 0

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32

    @classmethod
    def from_arena(cls, arena: torch.Tensor) -> "Int4Arena":
        packed, scales = ops.int4_pack(arena.float())
        return cls(packed=packed, scales=scales, dim=int(arena.shape[1]))

    def dequantize(self) -> torch.Tensor:
        return ops.int4_unpack(self.packed, self.scales, self.dim)

    def reduce_dense(self, spec, dense):
        return ops.fused_int4_segment_sum(self.packed, self.scales, dense,
                                          dim=self.dim)

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        return self.reduce_dense(spec, se.ragged_dense_ids(
            flat, offsets, max_l=max_l, fill=spec.null_row))

    def _describe(self) -> str:
        return "int4"

    def _describe_lines(self, depth: int) -> List[str]:
        pad = "  " * depth
        return [f"{pad}int4 arena ({self.packed.shape[0]}x{self.dim} "
                f"nibble-packed + f32 row scales, "
                f"{es.fmt_bytes(self.device_bytes())})"]

    def device_bytes(self) -> int:
        return int(_nbytes(self.packed) + _nbytes(self.scales))


@dataclass(frozen=True)
class TierPolicy:
    """The declarative tiering plan: ``hot``/``warm`` are row counts (the
    ranking's top slices), everything else is cold. ``cold="int4"`` keeps
    the tail on the device at 4 bits a value; ``cold="host"`` keeps it in
    host memory behind a ``staging_rows``-slot arena, fed in chunks of at
    most ``max_stage_per_batch`` rows."""
    hot: int
    warm: int
    cold: str = "int4"                   # 'int4' | 'host'
    staging_rows: int = 256
    max_stage_per_batch: int = 64

    def __post_init__(self):
        if self.hot < 0 or self.warm < 0:
            raise ValueError(f"tier sizes must be >= 0, got hot {self.hot}"
                             f", warm {self.warm}")
        if self.cold not in ("int4", "host"):
            raise ValueError(f"cold tier {self.cold!r} is neither 'int4' "
                             "nor 'host'")

    def partition(self, counts: np.ndarray, null_row: int):
        """Rank rows by frequency (stable argsort, descending: among equal
        counts the highest row id first, as ``build_hot_cache`` ranks) and
        slice into (hot_ids, warm_ids, cold_ids); the null row joins no
        tier. Host numpy, equal to the reference's ranking."""
        order = np.argsort(np.asarray(counts), kind="stable")[::-1]
        order = order[order != null_row]
        h = min(self.hot, order.size)
        w = min(self.warm, order.size - h)
        return (order[:h].astype(np.int64),
                order[h:h + w].astype(np.int64),
                order[h + w:].astype(np.int64))

    def build_source(self, arena: torch.Tensor, spec: se.ArenaSpec,
                     counts: Optional[np.ndarray] = None, *,
                     store: Optional[HostStore] = None,
                     telemetry=None) -> "TieredSource":
        """Materialise the plan for one arena (the ``SourceSpec.build``
        hook); ``counts`` defaults to uniform, ``store`` re-tiers around
        an existing host store."""
        return build_tiered(arena, spec, self, counts, store=store,
                            telemetry=telemetry)


@dataclass(frozen=True)
class TieredSource(es.EmbeddingSource):
    """Three tiers behind the one ``reduce_dense`` hook.

    ``tier_slot[row]`` lands in exactly one of three slot ranges, [0, H)
    hot, [H, H+W) warm and [H+W, H+W+C] cold (the top value is the cold
    null), and each tier's reduction redirects the positions outside its
    range to its own zero null slot. The null arena row maps to the cold
    null slot, so every tier reads zero there.

    hot_rows (H+1, D) f32 with slot H zero; warm a slot-indexed
    ``QuantizedArena`` (W+1 rows, zero-scale null); cold an ``Int4Arena``
    (C+1 compact rows) or a ``HostTier`` (a staging arena over C compact
    host rows). H, W and C are fixed by the policy, so a migration
    republishes the same structure and shapes.
    """
    hot_rows: torch.Tensor               # (H+1, D) f32, slot H zero
    tier_slot: torch.Tensor              # (total_rows,) int32
    hot_ids: torch.Tensor                # (H,) int32 arena rows of slots
    warm: es.QuantizedArena              # (W+1, D) slot-indexed
    cold: Union[Int4Arena, HostTier]     # (C+1,) compact-slot-indexed

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def n_hot(self) -> int:
        return self.hot_rows.shape[0] - 1

    @property
    def n_warm(self) -> int:
        return self.warm.q.shape[0] - 1

    @property
    def n_cold(self) -> int:
        if isinstance(self.cold, HostTier):
            return self.cold.slot_of.shape[0] - 1
        return self.cold.packed.shape[0] - 1

    def reduce_dense(self, spec, dense):
        h, w, c = self.n_hot, self.n_warm, self.n_cold
        ts = self.tier_slot[dense]
        # Python scalars, not device tensors: copying one to the card
        # would wait for the stream
        hot_ids = torch.where(ts < h, ts, h)
        warm_ids = torch.where((ts >= h) & (ts < h + w), ts - h, w)
        cold_ids = torch.where(ts >= h + w,
                               torch.clamp(ts - (h + w), max=c), c)
        out = ops.fused_segment_sum(self.hot_rows, hot_ids, null_row=h)
        out = out + self.warm.reduce_dense(spec, warm_ids)
        return out + self.cold.reduce_dense(spec, cold_ids)

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        return self.reduce_dense(spec, se.ragged_dense_ids(
            flat, offsets, max_l=max_l, fill=spec.null_row))

    def _rebind_arena(self, arena: torch.Tensor) -> "TieredSource":
        """Fresh hot copies from a swapped arena (the ``rebind_arena``
        hook), as a new tensor. Warm and cold are frozen representations
        of an arena version: re-tier them with ``migrate``."""
        fresh = torch.cat([arena[self.hot_ids.long()].float(),
                           arena.new_zeros((1, self.hot_rows.shape[1]),
                                           dtype=torch.float32)])
        return replace(self, hot_rows=fresh)

    def _describe(self) -> str:
        return f"tiered({self.cold._describe()})"

    def _describe_lines(self, depth: int) -> List[str]:
        pad = "  " * depth
        b = tier_bytes(self)
        lines = [f"{pad}tiered (hot={self.n_hot} warm={self.n_warm} "
                 f"cold={self.n_cold}; "
                 f"{es.fmt_bytes(b['device_total'])} on device)"]
        lines.append(f"{pad}  hot  fp {self.hot_rows.shape[0]}x"
                     f"{self.hot_rows.shape[1]} "
                     f"({str(self.hot_rows.dtype).replace('torch.', '')}, "
                     f"{es.fmt_bytes(b['hot'])})")
        lines.append(f"{pad}  warm int8 {self.warm.q.shape[0]}x"
                     f"{self.warm.q.shape[1]} (+f32 scales, "
                     f"{es.fmt_bytes(b['warm'])})")
        lines += self.cold._describe_lines(depth + 1)
        return lines


def _tier_slot(total: int, null_row: int, hot_ids, warm_ids,
               cold_ids) -> np.ndarray:
    h, w, c = hot_ids.size, warm_ids.size, cold_ids.size
    tier_slot = np.full(total, h + w + c, np.int32)   # default: cold null
    tier_slot[hot_ids] = np.arange(h)
    tier_slot[warm_ids] = h + np.arange(w)
    tier_slot[cold_ids] = h + w + np.arange(c)
    tier_slot[null_row] = h + w + c
    return tier_slot


def _hot_rows(a32: torch.Tensor, hot_ids: np.ndarray) -> torch.Tensor:
    return torch.cat([_rows(a32, hot_ids),
                      a32.new_zeros((1, a32.shape[1]))])


def _compact_of(total: int, cold_ids: np.ndarray) -> np.ndarray:
    compact_of = np.full(total, cold_ids.size, np.int64)
    compact_of[cold_ids] = np.arange(cold_ids.size)
    return compact_of


def build_tiered(arena: torch.Tensor, spec: se.ArenaSpec,
                 policy: TierPolicy, counts: Optional[np.ndarray] = None, *,
                 store: Optional[HostStore] = None,
                 telemetry=None) -> TieredSource:
    """Partition ``arena`` by ``counts`` under ``policy`` into a
    ``TieredSource`` on the arena's device. A host cold tier gets a new
    ``HostStore`` bound to ``telemetry``, or retargets ``store`` in
    place."""
    total, d = arena.shape
    if counts is None:
        counts = np.ones(total)
    hot_ids, warm_ids, cold_ids = policy.partition(counts, spec.null_row)
    c = cold_ids.size
    a32 = arena.float()
    q, scales = se._rowwise_quantize(_rows(a32, warm_ids))
    warm = es.QuantizedArena(
        q=torch.cat([q, q.new_zeros((1, d))]),
        scales=torch.cat([scales, scales.new_zeros((1, 1))]))
    tier_slot = _tier_slot(total, spec.null_row, hot_ids, warm_ids,
                           cold_ids)
    if policy.cold == "int4":
        packed, cscales = ops.int4_pack(torch.cat(
            [_rows(a32, cold_ids), a32.new_zeros((1, d))]))
        cold: es.EmbeddingSource = Int4Arena(packed=packed, scales=cscales,
                                             dim=d)
    else:
        host_rows = _rows(a32, cold_ids).cpu().numpy()
        compact_of = _compact_of(total, cold_ids)
        if store is None:
            store = HostStore(host_rows, staging_rows=policy.staging_rows,
                              compact_of=compact_of,
                              max_stage_per_batch=policy.max_stage_per_batch,
                              telemetry=telemetry, device=arena.device)
        else:
            store.retarget(host_rows, compact_of)
        cold = store.tier()
    return TieredSource(
        hot_rows=_hot_rows(a32, hot_ids),
        tier_slot=torch.from_numpy(tier_slot).to(arena.device),
        hot_ids=torch.from_numpy(hot_ids.astype(np.int32)).to(arena.device),
        warm=warm, cold=cold)


def migrate(old: TieredSource, arena: torch.Tensor, spec: se.ArenaSpec,
            policy: TierPolicy, counts: np.ndarray,
            dirty: Optional[np.ndarray] = None):
    """Promotion and demotion at the rebuild cadence: re-partition by the
    fresh histogram and rebuild the tiers incrementally.

    A warm or cold row whose tier slot range and arena values are
    unchanged (not ``dirty``) keeps its old quantized representation (a
    gather, not a requantize), so a migration costs O(moved + dirtied)
    quantization instead of O(V); with a correct dirty mask the result
    equals ``build_tiered`` bit for bit. Hot rows are refreshed from the
    live arena. Tier sizes are fixed by the policy, so the result has
    ``old``'s structure and shapes. A host cold tier is retargeted in
    place (same store; its residency resets). ``old`` itself is left as
    it was, but for the retargeted store.

    Returns ``(new_source, stats)``: promotions, demotions and
    requantized rows per tier.
    """
    total, d = arena.shape
    dirty = (np.zeros(total, bool) if dirty is None
             else np.asarray(dirty, bool))
    hot_ids, warm_ids, cold_ids = policy.partition(counts, spec.null_row)
    h, w, c = hot_ids.size, warm_ids.size, cold_ids.size
    if (h, w, c) != (old.n_hot, old.n_warm, old.n_cold):
        raise ValueError(f"tiers of {(h, w, c)} rows for a source of "
                         f"{(old.n_hot, old.n_warm, old.n_cold)}: tier sizes "
                         f"are fixed by the policy")
    a32 = arena.float()
    dev = arena.device
    ts_old = old.tier_slot.cpu().numpy()

    # warm: keep the old quantized rows that stayed warm and clean
    old_wslot = ts_old[warm_ids] - h
    stay = (old_wslot >= 0) & (old_wslot < w) & ~dirty[warm_ids]
    gather = torch.from_numpy(np.where(stay, old_wslot, w)).to(dev)
    q, sc = old.warm.q[gather], old.warm.scales[gather]
    moved_w = np.nonzero(~stay)[0]
    if moved_w.size:
        qr, sr = se._rowwise_quantize(_rows(a32, warm_ids[moved_w]))
        at = torch.from_numpy(moved_w).to(dev)
        q[at] = qr
        sc[at] = sr
    warm = es.QuantizedArena(q=torch.cat([q, q.new_zeros((1, d))]),
                             scales=torch.cat([sc, sc.new_zeros((1, 1))]))

    if isinstance(old.cold, HostTier):
        store = old.cold.store
        if store is None:
            raise ValueError("cannot migrate a decoded HostTier: it has no "
                             "host store")
        store.retarget(_rows(a32, cold_ids).cpu().numpy(),
                       _compact_of(total, cold_ids))
        cold: es.EmbeddingSource = store.tier()
        requant_c = 0
    else:
        old_cslot = ts_old[cold_ids] - (h + w)
        stay_c = (old_cslot >= 0) & (old_cslot < c) & ~dirty[cold_ids]
        gather_c = torch.from_numpy(np.where(stay_c, old_cslot, c)).to(dev)
        packed = old.cold.packed[gather_c]
        csc = old.cold.scales[gather_c]
        moved_c = np.nonzero(~stay_c)[0]
        if moved_c.size:
            pr, sr = ops.int4_pack(_rows(a32, cold_ids[moved_c]))
            at = torch.from_numpy(moved_c).to(dev)
            packed[at] = pr
            csc[at] = sr
        # the null row packs as build_tiered packs it (biased zero codes,
        # zero scale), so the incremental result equals a full rebuild
        zp, zs = ops.int4_pack(a32.new_zeros((1, d)))
        cold = Int4Arena(packed=torch.cat([packed, zp]),
                         scales=torch.cat([csc, zs]), dim=d)
        requant_c = int(moved_c.size)

    new = TieredSource(
        hot_rows=_hot_rows(a32, hot_ids),
        tier_slot=torch.from_numpy(_tier_slot(
            total, spec.null_row, hot_ids, warm_ids, cold_ids)).to(dev),
        hot_ids=torch.from_numpy(hot_ids.astype(np.int32)).to(dev),
        warm=warm, cold=cold)
    old_hot = old.hot_ids.cpu().numpy()
    stats = {"promoted_hot": int((~np.isin(hot_ids, old_hot)).sum()),
             "demoted_hot": int((~np.isin(old_hot, hot_ids)).sum()),
             "warm_requant": int(moved_w.size),
             "cold_requant": requant_c}
    return new, stats


# ---------------------------------------------------------------------------
# Source-tree walks: what the engine and the trainer need
# ---------------------------------------------------------------------------

def host_stores_of(source) -> List[HostStore]:
    """Every ``HostStore`` reachable from a source tree, each once, in a
    stable order: what an engine stages against."""
    out, seen = [], set()

    def walk(s):
        if isinstance(s, TieredSource):
            walk(s.cold)
        elif isinstance(s, HostTier):
            if s.store is not None and id(s.store) not in seen:
                seen.add(id(s.store))
                out.append(s.store)
        elif isinstance(s, es.TableGroupSource):
            for m in s.members:
                walk(m)
        elif isinstance(s, es.CachedSource):
            walk(s.cold)

    walk(source)
    return out


def refresh_host_tiers(source):
    """Every ``HostTier`` re-taken from its live store. The port's stores
    update their tensors in place, so a tier taken from its store is
    already current and comes back as it is; the walk keeps the
    reference's protocol (stage, then refresh)."""
    if isinstance(source, HostTier) and source.store is not None:
        st = source.store
        if source.staging is st.staging and source.slot_of is st.slot_of:
            return source
        return st.tier()
    if isinstance(source, (TieredSource, es.CachedSource)):
        cold = refresh_host_tiers(source.cold)
        return source if cold is source.cold else replace(source, cold=cold)
    if isinstance(source, es.TableGroupSource):
        members = tuple(refresh_host_tiers(m) for m in source.members)
        return (source if all(a is b for a, b in
                              zip(members, source.members))
                else replace(source, members=members))
    return source


def tier_bytes(source: TieredSource) -> dict:
    """Device bytes per tier of one ``TieredSource``: ``device_total``
    includes the routing maps; ``host`` counts the bytes kept off the
    device."""
    if not isinstance(source, TieredSource):
        raise TypeError(f"tier_bytes needs a TieredSource, got "
                        f"{type(source).__name__}")
    hot = _nbytes(source.hot_rows)
    warm = _nbytes(source.warm.q) + _nbytes(source.warm.scales)
    maps = _nbytes(source.tier_slot) + _nbytes(source.hot_ids)
    cold = source.cold.device_bytes()
    host = (source.cold.host_bytes() if isinstance(source.cold, HostTier)
            else 0)
    return {"hot": hot, "warm": warm, "cold": cold, "maps": maps,
            "host": host, "device_total": hot + warm + cold + maps}


es.register_source(Int4Arena, ("packed", "scales"), ("dim",))
es.register_source(TieredSource,
                   ("hot_rows", "tier_slot", "hot_ids", "warm", "cold"), ())
es.register_meta_type(TierPolicy)
