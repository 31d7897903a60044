"""Online trainer: the ragged training loop and the live hot-row cache.

``OnlineTrainer`` consumes ragged numpy batches and advances the model
and optimizer state with ``dlrm.make_train_step_ragged``. With a
``cache_cfg`` it keeps the serving hot cache exact while the model
learns, as the reference's protocol does:

* a host-side, exponentially decayed row histogram of the live index
  stream (``observe``), the ranking the rebuilds follow;
* write-through after every step: the hot copies of the rows the step
  touched are refreshed from the new arena (``_patch_hot_rows``);
* a rebuild every ``refresh_every`` steps under a bumped version, with
  the int8 cold arena re-quantized in the rows dirtied since the last one;
* publication: the hot cache as a ``VersionedHotCache`` blob (the
  reference's ``CHC1`` layout), the whole serving source as a
  ``VersionedSource`` blob, or ``sync_engine`` in process.

With ``OnlineCacheConfig(k=0, tiers=TierPolicy(...))`` the trainer keeps a
frequency-tiered source instead (``repro_torch.storage``): the fp hot
tier is written through after every step (``_patch_tiered_hot``), and the
rebuild cadence becomes a tier migration (``retier``, an incremental
``migrate`` over the rows dirtied since the last one).

The train step works in place, so the port's sync copies: an engine never
aliases a tensor the trainer updates (``RecEngine.params``), nor shares
the trainer's host store.

With ``mesh`` (one process a rank, every rank fed the same batches) the
trainer is one rank of a row-sharded run: ``params`` are the rank's
(``dlrm.shard_params``), the step is the sharded sparse one, the
histogram and the touched rows are global and equal on every rank, the
hot copies of rows other ranks own come from their owners by broadcast
(``collectives.gather_rows``, bit for bit), the int8 mirror is the
rank's block, and the published source is the cached one over a
``ShardedArena`` cold. A tiered trainer does not shard: the reference's
accepts a mesh but fails at its first ``retier()`` on an arena padded for
shards (ROADMAP Queue 3, recorded and pinned).

Telemetry is a ``repro_torch.obs.Telemetry`` bundle, as the reference's:
the gauges ``train_loss``, ``train_cache_version``, ``train_rebuild_hot_k``
and ``train_requant_rows`` (and ``rec_tier_bytes`` a tier when tiered),
the counters ``train_steps_total`` and ``train_rebuilds_total``, and the
events ``hot_cache_rebuild``, ``quantized_refresh``, ``tier_migration``
and ``publish``.

``OnlineGroupTrainer`` is the same protocol per table for a heterogeneous
table group: one decayed histogram, hot cache, int8 mirror or tiered
source a table, as its ``TablePlan`` says, and one version for the whole
group, published as one ``VersionedSource`` of the ``TableGroupSource``.
"""
from __future__ import annotations

import dataclasses
import io
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.core.embedding_source import VersionedSource
from repro_torch.distributed import collectives
from repro_torch.optim import tree_map
from repro_torch.storage import tiered as st

_BATCH_KEYS = ("dense", "indices", "offsets", "labels")


def _dense_head(params: Dict) -> Optional[Dict]:
    """The dense-stage parameters a broadcast artifact ships beside the
    sparse source: the bottom and top MLPs and, on a heterogeneous model,
    the per-table projections. The artifact codec keeps their container
    types, so an engine adopts the decoded head in place."""
    head = {k: params[k] for k in ("bottom", "top", "proj") if k in params}
    return head or None


@dataclass(frozen=True)
class OnlineCacheConfig:
    k: int                       # hot rows pinned per rebuild
    refresh_every: int = 50      # steps between re-rank + rebuild
    decay: float = 0.98          # per-step histogram decay
    quantize_cold: bool = False  # maintain an int8 cold arena beside the
    #                              fp one, re-quantizing only touched rows
    tiers: Optional[object] = None   # storage.TierPolicy: maintain a
    #                              tiered serving source instead of the hot
    #                              cache and the int8 mirror; the rebuild
    #                              cadence becomes the migration cadence

    def __post_init__(self):
        if self.tiers is not None and (self.k or self.quantize_cold):
            raise ValueError(
                "a tiered maintenance plan replaces the hot cache and the "
                "int8 mirror (TierPolicy.hot is the hot set; the warm and "
                "cold tiers are the quantized ones): set k=0 and "
                "quantize_cold=False")


@dataclass(frozen=True)
class VersionedHotCache:
    """A hot cache plus the monotone version of the rebuild that made it:
    the fleet broadcast artifact. ``serialize`` writes one blob (the
    reference's npz layout), ``deserialize`` rebuilds it on a serving
    host, and ``apply`` adopts it into a ``RecEngine`` iff it is strictly
    newer, so a reordered delivery is safe."""
    cache: se.HotRowCache
    version: int

    MAGIC = b"CHC1"          # Centaur hot-cache artifact, format v1

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf,
                 magic=np.frombuffer(self.MAGIC, np.uint8),
                 version=np.asarray(self.version, np.int64),
                 hot_rows=self.cache.hot_rows.detach().cpu().numpy(),
                 slot_of=self.cache.slot_of.cpu().numpy(),
                 hot_ids=self.cache.hot_ids.cpu().numpy())
        return buf.getvalue()

    @staticmethod
    def deserialize(blob: bytes, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> "VersionedHotCache":
        """Rebuild on ``device`` (the card unless told otherwise)."""
        device = resolve_device(device)
        try:
            with np.load(io.BytesIO(blob)) as z:
                if z["magic"].tobytes() != VersionedHotCache.MAGIC:
                    raise ValueError("bad magic")
                cache = se.HotRowCache(
                    **{k: torch.from_numpy(np.array(z[k])).to(device)
                       for k in ("hot_rows", "slot_of", "hot_ids")})
                return VersionedHotCache(cache=cache,
                                         version=int(z["version"]))
        except Exception as e:
            raise ValueError(
                f"not a hot-cache broadcast artifact: {e}") from e

    def apply(self, engine) -> bool:
        """Adopt into a RecEngine iff strictly newer; returns True when the
        engine swapped. Same-or-older versions are absorbed (a direct
        ``update_cache`` with an older one raises)."""
        if engine.cache_version >= self.version:
            return False
        engine.update_cache(self.cache, version=self.version)
        return True


def _batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch's training keys as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in _BATCH_KEYS}


def _patch_hot_rows(cache: se.HotRowCache, arena: torch.Tensor,
                    null_row: int, rows: torch.Tensor, *,
                    mesh: Any = None) -> se.HotRowCache:
    """Write-through: a new cache whose hot copies of ``rows`` are
    refreshed from ``arena``; the one given is left as it was, so an
    engine serving it keeps its version. With a sharded ``mesh``,
    ``arena`` is this rank's block and the rows come from their owners
    (``collectives.gather_rows``: a collective, bit for bit).

    Rows that are not pinned map to the miss slot K, whose source is
    forced to the always-zero null row, so slot K is only ever rewritten
    with zeros. Those are the only duplicate slots (``rows`` are unique
    but for null-row padding), and ``index_put_`` on the card applies
    duplicates in no fixed order: that is harmless only because every
    duplicate write carries the same zeros.
    """
    k = cache.k
    slots = cache.slot_of[rows]
    src = torch.where(slots < k, rows, null_row)
    hot_rows = cache.hot_rows.clone()
    fresh = (arena[src] if se.mesh_shards(mesh) == 1
             else collectives.gather_rows(arena, src, mesh))
    hot_rows[slots] = fresh.to(hot_rows.dtype)
    return se.HotRowCache(hot_rows=hot_rows, slot_of=cache.slot_of,
                          hot_ids=cache.hot_ids)


def _patch_tiered_hot(tiered: st.TieredSource, arena: torch.Tensor,
                      null_row: int, rows: torch.Tensor) -> st.TieredSource:
    """Write-through for a ``TieredSource``'s fp hot tier: a new source
    whose hot copies of ``rows`` are refreshed from ``arena``; warm and
    cold rows wait, dirty-masked, for the migration. The source given is
    left as it was. Rows that are not hot map to the null slot H, whose
    source is forced to the always-zero null row, so slot H is only ever
    rewritten with zeros (duplicate writes carry equal values)."""
    h = tiered.n_hot
    ts = tiered.tier_slot[rows]
    slots = torch.where(ts < h, ts, h)
    src = torch.where(ts < h, rows, null_row)
    hot_rows = tiered.hot_rows.clone()
    hot_rows[slots] = arena[src].to(hot_rows.dtype)
    return dataclasses.replace(tiered, hot_rows=hot_rows)


class OnlineTrainer:
    """Consume ragged batches on the card (or wherever ``device`` says);
    with ``cache_cfg``, keep the serving hot cache live and exact.

    The train step works in place: ``params`` is moved to ``device`` once
    and from then on the trainer's tensors are updated step by step. With
    a ``mesh`` of more than one shard, ``params`` are this rank's (the
    module docstring says how a sharded trainer runs).
    """

    def __init__(self, cfg: DLRMConfig, params: Dict, *, max_l: int,
                 lr: float = 1e-3, sparse: bool = True,
                 cache_cfg: Optional[OnlineCacheConfig] = None,
                 mesh: Any = None,
                 telemetry: Optional[obs.Telemetry] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.heterogeneous:
            raise ValueError(
                "a heterogeneous config trains its table group through "
                "OnlineGroupTrainer, one plan a table")
        self.device = resolve_device(device)
        self.telemetry = (telemetry if telemetry is not None
                          else obs.Telemetry())
        reg = self.telemetry.registry
        self._g_loss = reg.gauge("train_loss", "last optimizer-step loss")
        self._g_version = reg.gauge("train_cache_version",
                                    "last published rebuild version")
        self._g_hot_k = reg.gauge("train_rebuild_hot_k",
                                  "hot rows pinned by the last rebuild")
        self._g_requant = reg.gauge(
            "train_requant_rows",
            "rows re-quantized by the last incremental refresh")
        self._c_steps = reg.counter("train_steps_total",
                                    "optimizer steps taken")
        self._c_rebuilds = reg.counter("train_rebuilds_total",
                                       "hot-cache rebuilds")
        self.cfg = cfg
        self.spec = dlrm.arena_spec(cfg)
        self.mesh = mesh
        self.sharded = se.mesh_shards(mesh) > 1
        if self.sharded and cache_cfg is not None \
                and cache_cfg.tiers is not None:
            raise NotImplementedError(
                "a tiered trainer does not row-shard: the reference's "
                "fails at its first retier() on an arena padded for shards "
                "(ROADMAP Queue 3, recorded and pinned)")
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_l = max_l
        self.cache_cfg = cache_cfg
        opt, self._step = dlrm.make_train_step_ragged(
            cfg, max_l=max_l, lr=lr, sparse=sparse, mesh=mesh)
        self.opt_state = opt.init(self.params)
        self.hist = np.zeros(self.spec.total_rows, np.float64)
        self.steps = 0
        self.version = 0
        self.cache: Optional[se.HotRowCache] = None
        self.losses: list = []
        # incremental int8 maintenance: an int8 mirror of the arena and a
        # mask of the rows dirtied since the last refresh, kept on the
        # device so that marking them costs no copy to the host
        self.cold_q: Optional[es.QuantizedArena] = None
        self._dirty_q: Optional[torch.Tensor] = None
        if cache_cfg is not None and cache_cfg.quantize_cold:
            self.cold_q = es.QuantizedArena.from_arena(self.params["arena"])
            self._dirty_q = torch.zeros(self.params["arena"].shape[0],
                                        dtype=torch.bool, device=self.device)
        # tiered maintenance: the source is built at once (uniform
        # histogram) so its structure is fixed from step 0, and the dirty
        # mask feeds the incremental migration
        self.tiered: Optional[st.TieredSource] = None
        self.last_migration: Optional[dict] = None   # migrate's stats
        if cache_cfg is not None and cache_cfg.tiers is not None:
            self.tiered = cache_cfg.tiers.build_source(
                self.params["arena"], self.spec, None,
                telemetry=self.telemetry)
            self._dirty_q = torch.zeros(self.params["arena"].shape[0],
                                        dtype=torch.bool, device=self.device)
            self._g_tier_bytes = {
                tier: reg.gauge("rec_tier_bytes",
                                "device bytes held by this storage tier",
                                labels={"tier": tier})
                for tier in ("hot", "warm", "cold", "maps", "host")}
            self._set_tier_gauges()

    def _set_tier_gauges(self) -> None:
        for tier, nb in st.tier_bytes(self.tiered).items():
            if tier in self._g_tier_bytes:
                self._g_tier_bytes[tier].set(nb)

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return _batch_to(batch, self.device)

    # -- histogram ---------------------------------------------------------

    def observe(self, batch: Dict) -> None:
        """Fold one batch's index stream into the decayed histogram, on
        the host from the numpy batch (never from device tensors). No-op
        without a ``cache_cfg``: the histogram only ranks rebuilds."""
        if self.cache_cfg is None:
            return
        counts = se.trace_row_counts(self.spec, np.asarray(batch["indices"]),
                                     np.asarray(batch["offsets"]))
        self.hist = self.cache_cfg.decay * self.hist + counts

    # -- training ----------------------------------------------------------

    def train_step(self, batch: Dict) -> float:
        """One optimizer step on a numpy batch; returns its loss and keeps
        the cache protocol as a side effect."""
        self.observe(batch)
        self.params, self.opt_state, loss, rows = self._step(
            self.params, self.opt_state, self._to_device(batch))
        self.steps += 1
        if self._dirty_q is not None:
            # the null row rides along harmlessly: re-quantizing a zero
            # row is an exact no-op (so is the sentinel of a block, where
            # the rows other ranks own land)
            self._dirty_q[self._local(rows)] = True
        if self.cache is not None:
            # values never go stale: refresh the touched hot copies
            self.cache = _patch_hot_rows(self.cache, self.params["arena"],
                                         self.spec.null_row, rows,
                                         mesh=self.mesh)
        if self.tiered is not None:
            # the same for the fp hot tier; warm and cold rows wait for
            # the migration, dirty-masked
            self.tiered = _patch_tiered_hot(self.tiered, self.params["arena"],
                                            self.spec.null_row, rows)
        if self.cache_cfg is not None \
                and self.steps % self.cache_cfg.refresh_every == 0:
            self.rebuild_cache()
        loss = float(loss)
        self.losses.append(loss)
        if self.telemetry.enabled:
            self._c_steps.inc()
            self._g_loss.set(loss)
        return loss

    def train(self, batches: Iterable[Dict]) -> list:
        for batch in batches:
            self.train_step(batch)
        return self.losses

    def _local(self, rows: torch.Tensor) -> torch.Tensor:
        """Global arena rows -> rows of the trainer's arena (a sharded
        rank's block: rows it does not own on its sentinel)."""
        if not self.sharded:
            return rows
        lo, vlocal = se.shard_row_range(self.params["arena"],
                                        self.mesh.rank("model"))
        return se.shard_local_ids(rows, lo, vlocal)

    # -- cache publication -------------------------------------------------

    def rebuild_cache(self) -> VersionedHotCache:
        """Re-rank from the decayed histogram and publish a fresh cache
        under a bumped version; the int8 mirror, when kept, is patched in
        the same version."""
        if self.cache_cfg is None:
            raise ValueError("no cache_cfg configured")
        if self.tiered is not None:
            self.version += 1
            self._c_rebuilds.inc()
            self._g_version.set(self.version)
            self.retier()
            # tiered serving has no hot-cache artifact: publish_source()
            # is the blob
            return self.snapshot()
        self.cache = se.build_hot_cache(self.params["arena"], self.spec,
                                        self.hist, self.cache_cfg.k,
                                        mesh=self.mesh)
        if self.cold_q is not None:
            self.refresh_quantized()
        self.version += 1
        self._c_rebuilds.inc()
        self._g_version.set(self.version)
        self._g_hot_k.set(self.cache_cfg.k)
        self.telemetry.emit("hot_cache_rebuild", version=self.version,
                            step=self.steps, k=self.cache_cfg.k)
        return self.snapshot()

    def refresh_quantized(self) -> es.QuantizedArena:
        """Re-quantize exactly the rows dirtied since the last refresh
        (O(touched), not O(V)); equal to a full ``from_arena`` rebuild,
        as row-wise quantization has no cross-row state. Finding the
        dirty rows reads their count on the host, once per refresh."""
        if self.cold_q is None:
            raise ValueError("no int8 cold arena is maintained "
                             "(OnlineCacheConfig.quantize_cold)")
        rows = self._dirty_q.nonzero().reshape(-1).to(torch.int32)
        if rows.numel():
            self.cold_q = self.cold_q.quantize_rows(self.params["arena"],
                                                    rows)
            self._dirty_q.zero_()
        self._g_requant.set(rows.numel())
        self.telemetry.emit("quantized_refresh", version=self.version,
                            step=self.steps, rows=rows.numel())
        return self.cold_q

    def retier(self) -> st.TieredSource:
        """Tier migration at the rebuild cadence: re-rank from the decayed
        histogram and move rows across the fixed-size tiers. Incremental
        as ``refresh_quantized``: rows that kept their tier and were not
        dirtied keep their quantized values; the dirty mask is read on
        the host once per migration."""
        if self.tiered is None:
            raise ValueError("no tiered source is maintained "
                             "(OnlineCacheConfig.tiers)")
        self.tiered, self.last_migration = st.migrate(
            self.tiered, self.params["arena"], self.spec,
            self.cache_cfg.tiers, self.hist, self._dirty_q.cpu().numpy())
        self._dirty_q.zero_()
        self._set_tier_gauges()
        stats = self.last_migration
        self._g_requant.set(stats["warm_requant"] + stats["cold_requant"])
        self.telemetry.emit("tier_migration", version=self.version,
                            step=self.steps, **stats)
        return self.tiered

    def snapshot(self) -> Optional[VersionedHotCache]:
        if self.cache is None:
            return None
        return VersionedHotCache(cache=self.cache, version=self.version)

    def serving_source(self) -> es.EmbeddingSource:
        """The source a replica should serve now: the live hot cache over
        the maintained cold arena (int8 when ``quantize_cold``, else the
        trainer's fp arena). Its structure is the same at every version.
        It aliases the trainer's arena: serialize it or hand it to
        ``sync_engine``, which copies. A tiered trainer serves its
        ``TieredSource``; a sharded one a ``ShardedArena`` cold, the
        structure of ``RecEngine(source="cached", mesh=...)``."""
        if self.tiered is not None:
            return self.tiered
        cold = (self.cold_q if self.cold_q is not None
                else es.FpArena(self.params["arena"]))
        if self.sharded:
            cold = es.ShardedArena(cold, self.mesh)
        if self.cache is None:
            return cold
        # published at a write-through or rebuild boundary, where the hot
        # copies equal their arena rows
        return es.CachedSource(hot=self.cache, cold=cold, coherent=True)

    def publish_source(self, include_head: bool = False) -> Optional[bytes]:
        """The whole serving source (hot rows and the entire cold arena)
        as a ``VersionedSource`` blob, None before the first rebuild;
        ``include_head=True`` adds the dense MLP head, so a remote replica
        adopts everything it serves from one blob. A tiered trainer's blob
        carries the whole ``TieredSource``: a host cold tier ships its
        staged snapshot, its store being process-local. A sharded
        trainer's holds the unsharded cold arena, gathered from every
        rank: every rank calls this together."""
        if self.cache is None and self.tiered is None:
            return None
        blob = VersionedSource(source=self.serving_source(),
                               version=self.version,
                               head=({k: self.params[k]
                                      for k in ("bottom", "top")}
                                     if include_head else None)).serialize()
        self.telemetry.emit("publish", version=self.version,
                            artifact="source", bytes=len(blob))
        return blob

    def publish(self) -> Optional[bytes]:
        """The current hot cache as a broadcast blob (None before the
        first rebuild): every replica calls
        ``VersionedHotCache.deserialize(blob).apply(engine)``."""
        snap = self.snapshot()
        if snap is None:
            return None
        blob = snap.serialize()
        self.telemetry.emit("publish", version=snap.version,
                            artifact="hot_cache", bytes=len(blob))
        return blob

    def sync_engine(self, engine) -> bool:
        """Publish the trained state into a RecEngine if it is behind;
        returns True when a swap happened.

        Params and cache swap together: hot copies are snapshots of arena
        rows, so one without the other would serve two arena versions at
        once. The gate is the trainer's step, so between rebuilds every
        step's (params, patched cache) pair reaches the engine. The
        params are copied into the engine's own tensors, and the source
        is rebuilt to the engine's structure over the engine's arena, so
        later in-place steps do not reach the engine before the next
        sync. A tiered source is copied into the engine's own tiered
        source, whose host store adopts the trainer's rows
        (``RecEngine.update_source``).
        """
        if self.tiered is not None:
            # the pair that swaps together is (params, TieredSource)
            if getattr(engine, "_trainer_step", -1) >= self.steps \
                    and engine.source_version >= self.version:
                return False
            engine.params = self.params
            engine.update_source(self.tiered, version=self.version)
            engine._trainer_step = self.steps
            return True
        snap = self.snapshot()
        if snap is None:
            return False
        if getattr(engine, "_trainer_step", -1) >= self.steps \
                and engine.cache_version >= snap.version:
            return False
        engine.params = self.params
        new_source = es.rebind_arena(
            self._match_structure(engine.source, snap.cache),
            engine.params["arena"])
        engine.update_source(new_source, version=snap.version)
        engine._trainer_step = self.steps
        return True

    def _match_structure(self, engine_source,
                         cache: se.HotRowCache) -> es.EmbeddingSource:
        """The engine's source shape, rebuilt from live trainer state."""
        def cold_like(c):
            if isinstance(c, es.ShardedArena):
                return es.ShardedArena(cold_like(c.inner), c.mesh, c.axis)
            if isinstance(c, es.QuantizedArena):
                if self.cold_q is None:
                    raise ValueError(
                        "the engine serves an int8 cold arena but the "
                        "trainer maintains none; set "
                        "OnlineCacheConfig(quantize_cold=True)")
                return self.cold_q
            if isinstance(c, es.FpArena):
                return es.FpArena(self.params["arena"])
            raise TypeError(f"cannot sync cold source {type(c).__name__}")
        if isinstance(engine_source, es.CachedSource):
            return es.CachedSource(hot=cache,
                                   cold=cold_like(engine_source.cold),
                                   coherent=engine_source.coherent)
        return cold_like(engine_source)


class OnlineGroupTrainer:
    """Per-table online trainer of a heterogeneous table group.

    The group sibling of ``OnlineTrainer``: every piece of protocol state
    is per table. One decayed row histogram a table; a hot cache for the
    tables whose ``TablePlan.cache_k`` > 0, an int8 mirror for the
    ``quantize`` tables and a ``TieredSource`` for the tiered ones; one
    row-wise Adagrad accumulator a table arena (inside the group train
    step). Publication is one ``VersionedSource`` of the whole
    ``TableGroupSource`` under one version, so a replica adopts every
    table's refresh in one swap.

    Caches, int8 mirrors and tiered sources are built at construction
    (uniform histogram), so ``serving_source()`` has one structure from
    step 0 and a swap into an engine never recaptures a graph.

    The train step works in place, and ``serving_source()`` aliases the
    trainer's tensors: every consumer copies (``VersionedSource.serialize``,
    ``RecEngine.update_source``) or is the trainer itself. Dirty masks
    stay on the device, so marking a step's rows costs no host copy.
    Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, cfg: DLRMConfig, params: Dict, *, max_l: int,
                 plans, lr: float = 1e-3, refresh_every: int = 50,
                 decay: float = 0.98,
                 telemetry: Optional[obs.Telemetry] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if not cfg.heterogeneous:
            raise ValueError("OnlineGroupTrainer needs a heterogeneous "
                             "config; a uniform one trains through "
                             "OnlineTrainer")
        if len(plans) != cfg.n_tables:
            raise ValueError(f"{len(plans)} table plans for "
                             f"{cfg.n_tables} tables")
        self.device = resolve_device(device)
        self.telemetry = (telemetry if telemetry is not None
                          else obs.Telemetry())
        reg = self.telemetry.registry
        self._g_loss = reg.gauge("train_loss", "last optimizer-step loss")
        self._g_version = reg.gauge("train_cache_version",
                                    "last published rebuild version")
        self._c_steps = reg.counter("train_steps_total",
                                    "optimizer steps taken")
        self._c_rebuilds = reg.counter("train_rebuilds_total",
                                       "hot-cache rebuilds")
        self.cfg = cfg
        self.spec = dlrm.arena_spec(cfg)
        self.specs = dlrm.member_specs(cfg)
        self.plans = tuple(plans)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_l = max_l
        self.refresh_every = refresh_every
        self.decay = decay
        opt, self._step = dlrm.make_train_step_ragged(cfg, max_l=max_l,
                                                      lr=lr, sparse=True)
        self.opt_state = opt.init(self.params)
        self.hists = [np.zeros(sp.total_rows, np.float64)
                      for sp in self.specs]
        self.steps = 0
        self.version = 0
        self.losses: list = []
        self.caches: List[Optional[se.HotRowCache]] = []
        self.cold_q: List[Optional[es.QuantizedArena]] = []
        self.tiered: List[Optional[st.TieredSource]] = []
        self._dirty_q: List[Optional[torch.Tensor]] = []
        for plan, sp, arena in zip(self.plans, self.specs,
                                   self.params["tables"]):
            self.caches.append(
                se.build_hot_cache(arena, sp, np.ones(sp.total_rows),
                                   plan.cache_k)
                if plan.cache_k > 0 else None)
            self.cold_q.append(es.QuantizedArena.from_arena(arena)
                               if plan.quantize else None)
            self.tiered.append(
                plan.tiers.build_source(arena, sp, None,
                                        telemetry=self.telemetry)
                if plan.tiers is not None else None)
            self._dirty_q.append(
                torch.zeros(arena.shape[0], dtype=torch.bool,
                            device=self.device)
                if plan.quantize or plan.tiers is not None else None)

    # -- histogram ---------------------------------------------------------

    def observe(self, batch: Dict) -> None:
        """Fold one interleaved batch into the per-table histograms, on
        the host from the numpy batch."""
        counts = es.group_trace_counts(self.specs, batch["indices"],
                                       batch["offsets"])
        for t, c in enumerate(counts):
            self.hists[t] = self.decay * self.hists[t] + c

    # -- training ----------------------------------------------------------

    def train_step(self, batch: Dict) -> float:
        """One optimizer step on a numpy batch; the per-table
        write-through and dirty marks ride along."""
        self.observe(batch)
        self.params, self.opt_state, loss, touched = self._step(
            self.params, self.opt_state, _batch_to(batch, self.device))
        self.steps += 1
        tables = self.params["tables"]
        for t, rows in enumerate(touched):
            if self._dirty_q[t] is not None:
                self._dirty_q[t][rows] = True
            if self.caches[t] is not None:
                self.caches[t] = _patch_hot_rows(
                    self.caches[t], tables[t], self.specs[t].null_row, rows)
            if self.tiered[t] is not None:
                self.tiered[t] = _patch_tiered_hot(
                    self.tiered[t], tables[t], self.specs[t].null_row, rows)
        if self.steps % self.refresh_every == 0:
            self.rebuild()
        loss = float(loss)
        self.losses.append(loss)
        if self.telemetry.enabled:
            self._c_steps.inc()
            self._g_loss.set(loss)
        return loss

    def train(self, batches: Iterable[Dict]) -> list:
        for batch in batches:
            self.train_step(batch)
        return self.losses

    # -- publication -------------------------------------------------------

    def rebuild(self) -> int:
        """Re-rank every cached table from its histogram, re-quantize the
        rows of each int8 mirror dirtied since the last rebuild, migrate
        each tiered table, and bump one version for the whole group:
        tables refresh together or not at all. Reads each dirty count on
        the host, once a rebuild."""
        requant, migrated = {}, {}
        tables = self.params["tables"]
        for t, (plan, sp) in enumerate(zip(self.plans, self.specs)):
            if plan.cache_k > 0:
                self.caches[t] = se.build_hot_cache(
                    tables[t], sp, self.hists[t], plan.cache_k)
            if self.cold_q[t] is not None:
                rows = self._dirty_q[t].nonzero().reshape(-1).to(
                    torch.int32)
                requant[str(t)] = int(rows.numel())
                if rows.numel():
                    self.cold_q[t] = self.cold_q[t].quantize_rows(tables[t],
                                                                  rows)
                    self._dirty_q[t].zero_()
            if self.tiered[t] is not None:
                self.tiered[t], stats = st.migrate(
                    self.tiered[t], tables[t], sp, plan.tiers,
                    self.hists[t], self._dirty_q[t].cpu().numpy())
                self._dirty_q[t].zero_()
                migrated[str(t)] = stats
        self.version += 1
        self._c_rebuilds.inc()
        self._g_version.set(self.version)
        self.telemetry.emit(
            "hot_cache_rebuild", version=self.version, step=self.steps,
            cached_tables=[t for t, c in enumerate(self.caches)
                           if c is not None],
            requant_rows=requant)
        if migrated:
            self.telemetry.emit("tier_migration", version=self.version,
                                step=self.steps, tables=migrated)
        return self.version

    def serving_source(self) -> es.TableGroupSource:
        """The group a replica should serve now, of the same structure at
        every step. It aliases the trainer's tensors (the class
        docstring's rule)."""
        members = []
        for t in range(len(self.plans)):
            if self.tiered[t] is not None:
                members.append(self.tiered[t])
                continue
            cold = (self.cold_q[t] if self.cold_q[t] is not None
                    else es.FpArena(self.params["tables"][t]))
            members.append(es.CachedSource(hot=self.caches[t], cold=cold,
                                           coherent=True)
                           if self.caches[t] is not None else cold)
        return es.TableGroupSource(members=tuple(members),
                                   specs=self.specs)

    def publish_source(self, include_head: bool = False) -> bytes:
        """One ``VersionedSource`` blob of every table's sparse state
        under the group's one version; ``include_head=True`` adds the
        dense head (MLPs and projections), so a remote replica adopts
        everything it serves from the blob."""
        blob = VersionedSource(source=self.serving_source(),
                               version=self.version,
                               head=(_dense_head(self.params)
                                     if include_head else None)
                               ).serialize()
        self.telemetry.emit("publish", version=self.version,
                            artifact="group_source", bytes=len(blob))
        return blob

    def sync_engine(self, engine) -> bool:
        """Push the live group into a RecEngine if it is behind (the
        step gate of ``OnlineTrainer.sync_engine``); params and source
        are copied into the engine's own tensors together."""
        if getattr(engine, "_trainer_step", -1) >= self.steps \
                and engine.source_version >= self.version:
            return False
        engine.params = self.params
        engine.update_source(self.serving_source(), version=self.version)
        engine._trainer_step = self.steps
        return True


def make_drifting_zipf(cfg: DLRMConfig, *, batch_size: int, mean_l: int,
                       max_l: int, drift_per_batch: int = 0,
                       alpha: float = 1.05, seed: int = 0):
    """Ragged-batch generator whose hot set rotates over time.

    Zipf rank r maps to row (r + t * drift_per_batch) % rows at batch t, so
    the most popular rows shift by `drift_per_batch` every batch. Yields
    batches shaped exactly like DLRMSynthetic.ragged_batch, padded to a
    static stream length. The numpy draws are the reference's, call for
    call, so one seed gives the same batches in both packages.
    """
    rng = np.random.RandomState(seed)
    w = rng.randn(cfg.dense_features).astype(np.float32)
    n_bags = batch_size * cfg.n_tables
    pad_to = n_bags * max_l
    t = 0
    while True:
        lens = np.clip(rng.poisson(mean_l, n_bags), 0, max_l).astype(np.int32)
        offsets = np.zeros(n_bags + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        n = int(offsets[-1])
        raw = rng.zipf(alpha, size=n)
        shifted = (raw - 1) + t * drift_per_batch
        if cfg.heterogeneous:
            # fold each position into its own table's vocab
            seg = np.searchsorted(offsets[1:], np.arange(n), side="right")
            rows = np.asarray(cfg.resolved_table_rows)
            indices = (shifted % rows[seg % cfg.n_tables]).astype(np.int32)
        else:
            indices = (shifted % cfg.rows_per_table).astype(np.int32)
        indices = np.concatenate([indices, np.zeros(pad_to - n, np.int32)])
        dense = rng.randn(batch_size, cfg.dense_features).astype(np.float32)
        logit = dense @ w * 0.5
        labels = (rng.rand(batch_size)
                  < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
        yield {"dense": dense, "indices": indices, "offsets": offsets,
               "lengths": lens, "labels": labels, "max_l": max_l}
        t += 1
