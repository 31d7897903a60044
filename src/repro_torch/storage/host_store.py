"""Host-resident cold tier: rows that never live in device memory.

Centaur's sparse side serves gathers from capacity memory while the dense
side computes: cold embedding rows sit in cheap, large memory and cross
to the accelerator only when a batch touches them. ``HostStore`` is that
tier. The cold rows stay in one fp32 block in host memory (pinned when
the store serves a card, so copies from it run asynchronously), and a
small bounded **staging arena** on the device receives exactly the rows
the next batches need.

The contract with the serve path, as in the reference
(``repro/storage/host_store.py``):

* the device footprint is fixed: ``staging`` is ``(S+1, D)`` with slot S
  the always-zero null slot, and ``slot_of`` maps every compact cold id
  to its staging slot (or S when not resident);
* ``stage(comp_ids)`` is the residency guarantee the engine calls per
  batch before its forward: afterwards every cold row the batch touches
  has a staging slot. A row already resident is a **hit**, one staged on
  demand a **miss**, and ``hits + misses == touches`` (unique per batch);
* ``prefetch(comp_ids)`` stages ahead without counting, and never evicts
  the rows the current batch pinned.

On the card, where the reference relies on immutable arrays and
``device_put`` futures, the port updates the staging arena in place and
keeps three rules instead:

* **no race on pinned memory.** A flush fills a pinned chunk buffer from
  the host block, issues its copy to the card ``non_blocking`` and
  scatters it into ``staging`` and ``slot_of`` on the current stream.
  Each chunk size has a ring of pinned buffers, each guarded by a CUDA
  event recorded after its copy; a buffer is refilled only once its
  event has completed. Nothing on this path copies from pageable memory,
  which would end in a stream synchronize;
* **stream order stands in for immutability.** The scatter and the
  serving gather run on the same stream, so a forward enqueued before a
  flush reads the arena as it was, and one enqueued after reads it
  complete;
* **the snapshot rule.** A store belongs to one owner. An engine never
  shares one with a trainer: it ``adopt``s the published rows and
  mapping into its own store, whose tensors keep their addresses.

Staged rows are exact fp32 copies of the host block, so a cold row
served through the staging arena equals the fp arena row bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import embedding_source as es
from repro_torch.kernels import ops

__all__ = ["HostStore", "HostTier"]

# pinned chunk buffers per chunk size: a flush refills one only after the
# copy out of it has completed (its event)
_RING = 2


@dataclass(frozen=True)
class HostTier(es.EmbeddingSource):
    """The device-visible face of a ``HostStore``: the bounded staging
    arena plus the residency map, as an ``EmbeddingSource`` over compact
    cold ids (0..C-1, C the compact null id).

    ``store`` is ephemeral host state: it is left out of a broadcast blob,
    and a decoded ``HostTier`` (``store=None``) serves exactly its staged
    snapshot. With a store, ``staging`` and ``slot_of`` are the store's
    live tensors, which its flushes update in place.
    """
    staging: torch.Tensor                # (S+1, D) f32, slot S zero
    slot_of: torch.Tensor                # (C+1,) int32 -> slot or S
    store: Optional["HostStore"] = None

    __ephemeral_meta__ = ("store",)

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def staging_rows(self) -> int:
        return self.staging.shape[0] - 1

    def reduce_dense(self, spec, dense):
        # the residency indirection, then the plain fused reduce: with the
        # engine's stage() guarantee every touched cold row is resident,
        # so only fill slots read the zero null slot
        slots = self.slot_of[dense]
        return ops.fused_segment_sum(self.staging, slots,
                                     null_row=self.staging_rows)

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        # the reference segment-sums whole bags in XLA; on the card a
        # scatter would add with float atomics, so the port takes the
        # deterministic ragged kernel over the staging slots. It walks
        # min(len, max_l) positions a bag, so a bound of the stream's
        # length sums every bag whole, as the reference does, and on bags
        # within max_l it equals reduce_dense bit for bit
        return ops.sparse_lengths_sum(self.staging, self.slot_of[flat],
                                      offsets,
                                      max_l=flat.shape[0]).float()

    def _describe(self) -> str:
        return "host"

    def _describe_lines(self, depth: int) -> List[str]:
        pad = "  " * depth
        s, d = self.staging.shape
        total = (self.store.host_rows.shape[0] if self.store is not None
                 else "?")
        return [f"{pad}host tier ({total} rows on host; staging "
                f"{s - 1}x{d} f32, {es.fmt_bytes(self.device_bytes())} "
                f"on device)"]

    def device_bytes(self) -> int:
        return int(self.staging.numel() * self.staging.element_size()
                   + self.slot_of.numel() * self.slot_of.element_size())

    def host_bytes(self) -> int:
        return (int(self.store.host_rows.nbytes)
                if self.store is not None else 0)

    def _clone(self) -> "HostTier":
        """``es.clone_source``'s hook: a tier of a new store over copies
        of the rows and mapping, nothing staged yet."""
        if self.store is None:
            return HostTier(staging=self.staging.clone(),
                            slot_of=self.slot_of.clone())
        st = self.store
        mine = HostStore(st.host_rows, staging_rows=st.staging_rows,
                         compact_of=st.compact_of,
                         max_stage_per_batch=st.max_stage, device=st.device)
        mine._origin = st.generation
        return mine.tier()

    def _adopt(self, src: "HostTier") -> None:
        """``es.adopt_source``'s hook: ``src``'s rows and mapping into this
        tier's store, whose staging arena and slot map keep their
        addresses; a storeless tier copies its snapshot."""
        if self.store is not None:
            self.store.adopt(src.store)
            return
        for mine, new in ((self.staging, src.staging),
                          (self.slot_of, src.slot_of)):
            if mine.data_ptr() != new.data_ptr():
                mine.copy_(new)


class HostStore:
    """Host-side owner of a cold-row block and its staging residency.

    ``host_rows`` (C, D) fp32 is indexed by compact cold id;
    ``compact_of`` maps arena row ids to compact ids (C for rows that are
    not cold). The staging arena and the residency map live on
    ``device`` (the card unless told otherwise).
    """

    def __init__(self, host_rows: np.ndarray, *, staging_rows: int,
                 compact_of: Optional[np.ndarray] = None,
                 max_stage_per_batch: int = 64,
                 telemetry: Optional[obs.Telemetry] = None,
                 device: Optional[Union[str, torch.device]] = None):
        host_rows = np.ascontiguousarray(host_rows, np.float32)
        if host_rows.ndim != 2:
            raise ValueError(f"host_rows must be (C, D), got "
                             f"{host_rows.shape}")
        if staging_rows < 1:
            raise ValueError(f"staging_rows {staging_rows} < 1")
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        c, d = host_rows.shape
        # one pinned block; host_rows is its numpy view, so the chunk
        # gathers of a flush and a retarget's copy write pinned memory
        self._host = torch.empty((c, d), dtype=torch.float32,
                                 pin_memory=self._pinned)
        self.host_rows = self._host.numpy()
        self.host_rows[...] = host_rows
        self.n_cold = c
        self.null_id = c                     # compact null id
        self.compact_of = (np.array(compact_of, np.int64)
                           if compact_of is not None
                           else np.arange(c, dtype=np.int64))
        self.staging_rows = int(staging_rows)
        self.max_stage = max(1, int(max_stage_per_batch))
        # live device state (a HostTier holds these very tensors)
        self.staging = torch.zeros((self.staging_rows + 1, d),
                                   dtype=torch.float32, device=self.device)
        self.slot_of = torch.full((c + 1,), self.staging_rows,
                                  dtype=torch.int32, device=self.device)
        # residency bookkeeping, vectorized numpy as in the reference: a
        # host mirror of the slot map, an LRU stamp per compact id, the
        # pin epochs of the batch in flight, the slot owners and the free
        # stack
        self._slot_np = np.full(c + 1, self.staging_rows, np.int32)
        self._stamp = np.zeros(c + 1, np.int64)
        self._pin_epoch = np.zeros(c + 1, np.int64)
        self._epoch = 0
        self._owner = np.full(self.staging_rows, c, np.int32)
        self._free = np.arange(self.staging_rows - 1, -1, -1, np.int32)
        self._n_free = self.staging_rows
        self._clock = 0
        self.hits = 0
        self.misses = 0
        # chunk size -> [(rows, ids/slots/evicted, event or None)] and
        # the ring position of the next flush
        self._ring: Dict[int, list] = {}
        self._ring_next: Dict[int, int] = {}
        # which rows this store holds: a fresh token per retarget, and the
        # token of the store whose rows it adopted
        self.generation = object()
        self._origin = self.generation
        self.bind_telemetry(telemetry if telemetry is not None
                            else obs.Telemetry())

    def _signature(self) -> tuple:
        """What the serve step is shaped by: two stores with equal
        signatures can replace each other in a served source."""
        return (tuple(self.host_rows.shape), self.staging_rows)

    def bind_telemetry(self, telemetry: obs.Telemetry) -> None:
        """Adopt a consumer's telemetry bundle (the engine rebinds the
        stores it discovers in its source; registration is idempotent)."""
        self.telemetry = telemetry
        reg = telemetry.registry
        self._c_hit = reg.counter(
            "rec_prefetch_hit",
            "cold rows already staged when their batch arrived")
        self._c_miss = reg.counter(
            "rec_prefetch_miss",
            "cold rows staged on demand at batch-stage time")

    def retarget(self, host_rows: np.ndarray,
                 compact_of: np.ndarray) -> None:
        """Adopt a new cold partition in place (tier migration): fresh
        rows and arena -> compact mapping, residency reset. The host
        block, ``staging`` and ``slot_of`` keep their addresses, so a
        source holding this store's tier is unchanged in structure and
        storage."""
        host_rows = np.asarray(host_rows, np.float32)
        compact_of = np.asarray(compact_of, np.int64)
        if host_rows.shape != self.host_rows.shape:
            raise ValueError(f"host rows {host_rows.shape} for a store of "
                             f"{self.host_rows.shape}: tier sizes are fixed "
                             f"by the policy")
        if compact_of.shape != self.compact_of.shape:
            raise ValueError(f"compact_of {compact_of.shape} for a store "
                             f"of {self.compact_of.shape}")
        np.copyto(self.host_rows, host_rows)
        np.copyto(self.compact_of, compact_of)
        # in place and in stream order: forwards enqueued before read the
        # old arena, later ones the reset one
        self.staging.zero_()
        self.slot_of.fill_(self.staging_rows)
        self._slot_np[:] = self.staging_rows
        self._stamp[:] = 0
        self._pin_epoch[:] = 0
        self._epoch = 0
        self._owner[:] = self.null_id
        self._free = np.arange(self.staging_rows - 1, -1, -1, np.int32)
        self._n_free = self.staging_rows
        self._clock = 0
        self.generation = object()
        self._origin = self.generation

    def adopt(self, other: "HostStore") -> bool:
        """Take ``other``'s rows and mapping into this store's own buffers
        (the engine's side of the snapshot rule): a ``retarget`` with
        copies, skipped when this store already holds that generation of
        ``other``'s rows, so residency survives a republish without a
        migration. Returns True when it retargeted."""
        if other is self or self._origin is other.generation:
            return False
        self.retarget(other.host_rows, other.compact_of)
        self._origin = other.generation
        return True

    # -- residency ---------------------------------------------------------

    def tier(self) -> HostTier:
        """The device-visible face of this store."""
        return HostTier(staging=self.staging, slot_of=self.slot_of,
                        store=self)

    def _unique_cold(self, arena_ids) -> np.ndarray:
        ids = np.asarray(arena_ids, np.int64).reshape(-1)
        comp = self.compact_of[ids]
        return np.unique(comp[comp < self.n_cold])

    def cold_ids_of(self, arena_ids) -> np.ndarray:
        """Raw arena row ids -> this store's unique compact cold ids (the
        form ``stage``/``prefetch`` take), so a caller staging ahead can
        compute a future batch's cold set once and replay it."""
        return self._unique_cold(arena_ids)

    def stage_arena(self, arena_ids) -> Tuple[int, int]:
        """Per-batch entry over raw arena row ids: filter to this store's
        cold rows, uniquify, guarantee residency."""
        return self.stage(self._unique_cold(arena_ids))

    def prefetch_arena(self, arena_ids) -> int:
        """Prefetch entry over raw arena row ids."""
        return self.prefetch(self._unique_cold(arena_ids))

    def stage_arena_with_prefetch(self, arena_ids,
                                  next_arena_ids) -> Tuple[int, int]:
        """Residency for the batch in flight and best-effort prefetch of
        the next one, as one flush; only the batch in flight is
        counted."""
        return self.stage(self._unique_cold(arena_ids),
                          ahead=self._unique_cold(next_arena_ids))

    def stage(self, comp_ids: np.ndarray,
              ahead: Optional[np.ndarray] = None) -> Tuple[int, int]:
        """Residency guarantee for one batch's compact cold ids.

        Returns (hits, misses) for this batch and re-pins the working
        set. ``ahead`` (the next batch's ids) rides the same flush,
        uncounted and best-effort: when the arena cannot fit both, the
        lookahead is truncated, never the guarantee.
        """
        comp_ids = np.unique(np.asarray(comp_ids, np.int64).reshape(-1))
        resident = self._slot_np[comp_ids] < self.staging_rows
        hits = int(resident.sum())
        need = comp_ids[~resident]
        self._clock += 1
        self._stamp[comp_ids] = self._clock
        # re-pin the working set: a prefetch must never evict the rows
        # the batch in flight reads
        self._epoch += 1
        self._pin_epoch[comp_ids] = self._epoch
        want = need
        if ahead is not None and len(ahead):
            self._clock += 1
            self._stamp[ahead] = self._clock
            amiss = ahead[self._slot_np[ahead] == self.staging_rows]
            if len(amiss):
                want = np.concatenate(
                    (need, np.setdiff1d(amiss, need, assume_unique=True)))
        self._flush(*self._plan(want, min_required=len(need)))
        self.hits += hits
        self.misses += len(need)
        if self.telemetry.enabled:
            if hits:
                self._c_hit.inc(hits)
            if len(need):
                self._c_miss.inc(len(need))
        return hits, len(need)

    def prefetch(self, comp_ids: np.ndarray) -> int:
        """Stage ahead without touching the hit/miss accounting; returns
        the number of rows transferred."""
        comp_ids = np.unique(np.asarray(comp_ids, np.int64).reshape(-1))
        self._clock += 1
        self._stamp[comp_ids] = self._clock
        miss = self._slot_np[comp_ids] == self.staging_rows
        return self._assign(comp_ids[miss], best_effort=True)

    def _assign(self, need: np.ndarray, best_effort: bool) -> int:
        plan = self._plan(need, min_required=0 if best_effort
                          else len(need))
        self._flush(*plan)
        return len(plan[0])

    def _plan(self, need: np.ndarray, *, min_required: int) -> tuple:
        """Assign slots, free ones first, then by evicting the least
        recently used unpinned rows. Returns ``(ids, slots, victims)``.
        The first ``min_required`` ids are the residency guarantee: if
        they cannot all get slots, the batch's unique cold rows exceed
        the arena, which raises; the rest is best-effort and truncated."""
        none = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
        k = len(need)
        if k == 0:
            return none
        take = min(k, self._n_free)
        victims = np.empty(0, np.int64)
        if k > take:
            m = k - take
            res = self._owner[self._owner != self.null_id]
            cand = res[self._pin_epoch[res] != self._epoch]
            if len(cand) < m:
                if take + len(cand) < min_required:
                    raise ValueError(
                        f"staging arena too small: batch needs more than "
                        f"{self.staging_rows} unique cold rows "
                        f"(TierPolicy.staging_rows)")
                m = len(cand)
                k = take + m
                need = need[:k]
                if k == 0:
                    return none
            if m:
                sel = (np.argpartition(self._stamp[cand], m - 1)[:m]
                       if m < len(cand) else np.arange(len(cand)))
                victims = cand[sel]
        new_slots = np.empty(k, np.int32)
        if take:
            new_slots[:take] = self._free[self._n_free - take:self._n_free]
            self._n_free -= take
        if len(victims):
            new_slots[take:k] = self._slot_np[victims]
            self._slot_np[victims] = self.staging_rows
        self._slot_np[need] = new_slots
        self._owner[new_slots] = need
        return need, new_slots, victims

    @property
    def _chunk_sizes(self) -> tuple:
        """The flush chunk ladder, as the reference's: 32, 64, ... below
        ``max_stage``, then ``max_stage``. A steady-state flush of a few
        rows pads to a small chunk, a burst to ``max_stage``."""
        sizes = []
        c = 32
        while c < self.max_stage:
            sizes.append(c)
            c *= 2
        return tuple(sizes) + (self.max_stage,)

    def warm_compile(self) -> None:
        """Run one all-pad flush at every chunk size, off the serve clock:
        it allocates the pinned ring and the device blocks the flushes
        use. Every pad write rewrites an invariant value (null id -> null
        slot, zero rows into the null slot), so residency is untouched."""
        empty_i = np.zeros(0, np.int64)
        for m in self._chunk_sizes:
            for _ in range(_RING):
                self._apply_stage(m, empty_i, empty_i, empty_i)

    def _buffers(self, m: int):
        """The next pinned (rows, index) buffers of chunk size ``m``,
        once the copy out of them has completed."""
        ring = self._ring.get(m)
        if ring is None:
            d = self.host_rows.shape[1]
            ring = self._ring[m] = [
                (torch.empty((m, d), dtype=torch.float32,
                             pin_memory=self._pinned),
                 torch.empty((3, m), dtype=torch.int64,
                             pin_memory=self._pinned),
                 torch.cuda.Event() if self._pinned else None)
                for _ in range(_RING)]
            self._ring_next[m] = 0
        i = self._ring_next[m]
        self._ring_next[m] = (i + 1) % len(ring)
        rows, idx, event = ring[i]
        if event is not None and not event.query():
            event.synchronize()
        return rows, idx, event

    def _apply_stage(self, m: int, ids: np.ndarray, slots: np.ndarray,
                     evicted: np.ndarray) -> None:
        """One fixed-size chunk: fill pinned buffers, copy them to the
        device without blocking, then evict, remap and write on the
        current stream. Pads carry the null id and the null slot, so
        their writes rewrite invariant values."""
        rows, idx, event = self._buffers(m)
        rows_np, idx_np = rows.numpy(), idx.numpy()
        k = len(ids)
        if k:
            np.take(self.host_rows, ids, axis=0, out=rows_np[:k])
        rows_np[k:] = 0.0
        idx_np[0] = self.null_id
        idx_np[0, :k] = ids
        idx_np[1] = self.staging_rows
        idx_np[1, :len(slots)] = slots
        idx_np[2] = self.null_id
        idx_np[2, :len(evicted)] = evicted
        rows_dev = rows.to(self.device, non_blocking=True)
        idx_dev = idx.to(self.device, non_blocking=True)
        if event is not None:
            event.record(torch.cuda.current_stream(self.device))
        self.slot_of.index_fill_(0, idx_dev[2], self.staging_rows)
        self.slot_of.index_copy_(0, idx_dev[0],
                                 idx_dev[1].to(torch.int32))
        self.staging.index_copy_(0, idx_dev[1], rows_dev)

    def _flush(self, ids, slots, evicted) -> None:
        n = max(len(ids), len(evicted))
        if n == 0:
            return
        m = next((c for c in self._chunk_sizes if n <= c), self.max_stage)
        for i in range(0, n, m):
            self._apply_stage(m, ids[i:i + m], slots[i:i + m],
                              evicted[i:i + m])

    # -- accounting --------------------------------------------------------

    @property
    def touches(self) -> int:
        """Unique cold rows demanded by batches so far: hits + misses."""
        return self.hits + self.misses

    def hit_rate(self) -> float:
        t = self.touches
        return self.hits / t if t else 1.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "touches": self.touches, "hit_rate": self.hit_rate(),
                "resident": int(self.staging_rows - self._n_free),
                "staging_rows": self.staging_rows,
                "host_rows": self.n_cold,
                "host_bytes": int(self.host_rows.nbytes)}


es.register_source(HostTier, ("staging", "slot_of"), ("store",))
