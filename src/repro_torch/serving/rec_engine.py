"""Recommendation serving engine over the ragged production sparse path.

* ``RecRequest``: one user impression, dense features + per-table ragged
  sparse id lists (the SparseLengthsSum format of paper Fig. 2);
* ``RecBatcher``: admission queue with (max_batch, max_wait_ms)
  micro-batching on the monotonic clock;
* ``RecEngine``: drains the batcher, pads each micro-batch to a static
  *bucket* shape (batch rounded up to a bucket size with empty-bag dummy
  rows, flat index stream padded to bucket*T*max_l) and serves one ragged
  forward on the device, under ``torch.inference_mode``, whose embedding
  stage is one ``embedding_source.lookup_bags`` over the engine's source.
  On the fixed layout every bag holds exactly ``lookups_per_table`` ids,
  a micro-batch is one (bucket, T, L) id block, and the forward is
  ``dlrm.forward`` over the fp arena (one ``embedding_bag`` launch).

Which source serves is a plan: ``source=`` takes a path string
(``"ragged"``, the fp arena; ``"fixed"``, the fp arena on the fixed
layout; ``"cached"``, the hot-row cache over an fp or int8 cold arena),
a ``SourceSpec`` (``SourceSpec(tiers=TierPolicy(...))`` is the tiered
plan: hot fp, warm int8 and an int4 or host-resident cold tier;
``SourceSpec(tables=dlrm.table_plans(cfg, ...))`` the table group of a
heterogeneous config over ``params["tables"]``, each table's member
composed on its own) or a built ``EmbeddingSource``. With a host cold
tier the engine stages each micro-batch's cold rows into its staging
arena before the forward, and
the admission queue's next micro-batch in the same flush (the
prefetcher); ``stats()["prefetch"]`` counts the hits and misses.
``update_source``/``update_cache`` swap it atomically under a monotone
version, refusing stale versions and any change of structure, shapes or
dtypes. Hit accounting runs on the device and is read only by
``stats()``; a group's is per table (``es.group_hit_counts``).

The engine never aliases tensors that a trainer updates in place: the
params it is given, or assigned through ``engine.params = ...``, are
copied into its own tensors (in place when the shapes match), and the
source it serves is its own (built from its params, or a clone of a
built source it was handed). Every swap copies into those tensors in
place (``es.adopt_source``; a host tier's rows go into the engine's own
``HostStore``), so their addresses never move and nothing the engine
was handed is ever written.

On the card every micro-batch replays a captured CUDA graph of its
(path, bucket) pair (``serve_graph.ServeGraph``), the counterpart of the
reference's one ``jax.jit`` executable per bucket: ``warmup()`` captures
every pair off the SLA clock (the warm pool), a pair's first dispatch
otherwise (``cold_compiles`` counts those), and a swap of the same
structure and shapes is never a recapture. ``dispatch``/``settle`` split
a micro-batch into its enqueue and its one host wait (continuous
batching; ``step`` is both), ``tune_buckets``/``retune_buckets`` re-pick
the buckets from the observed batch sizes, and ``enable_downgrade``
builds the int8 source that overloaded batches serve from. On the CPU
the same calls run the serve step eagerly through the plain versions.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the sharded plans and telemetry.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.core.embedding_source import SourceSpec
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving.serve_graph import ServeGraph, Slot
from repro_torch.storage import tiered as st


@dataclass
class RecRequest:
    rid: int
    dense: np.ndarray                   # (dense_features,) float32
    sparse_ids: List[np.ndarray]        # per table: (l_t,) int32, l_t<=max_l
    # wall-clock stamps are user-facing only; every deadline and latency
    # runs on submitted_mono, so a clock step cannot corrupt either
    submitted_at: float = field(default_factory=time.time)
    submitted_mono: float = field(default_factory=time.monotonic)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    prob: Optional[float] = None        # predicted CTR, set when served
    downgraded: bool = False            # served on the int8 downgrade path
    # (per-table ids, table) streams, extracted at admission when the
    # engine serves a host cold tier
    cold_streams: Optional[tuple] = None


class RecBatcher:
    """Admission queue: release a micro-batch when it is full or when the
    oldest request has waited max_wait_ms (the SLA knob). ``clock`` is
    injectable for tests."""

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 clock=time.monotonic):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._clock = clock
        self._queue: List[RecRequest] = []

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, req: RecRequest):
        self._queue.append(req)

    def take(self, force: bool = False) -> List[RecRequest]:
        if not self._queue:
            return []
        oldest = self._clock() - self._queue[0].submitted_mono
        if force or len(self._queue) >= self.max_batch \
                or oldest * 1e3 >= self.max_wait_ms:
            batch = self._queue[:self.max_batch]
            self._queue = self._queue[self.max_batch:]
            return batch
        return []


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def tune_buckets(sizes: Sequence[int], max_batch: int,
                 n_buckets: int = 6) -> tuple:
    """Pick pad-bucket boundaries from an observed micro-batch-size
    histogram instead of fixed powers of two.

    Boundaries are the ceil-quantiles of the observed sizes (equal traffic
    mass per bucket), deduplicated, with max_batch always present as the
    catch-all. Fewer distinct observed sizes than n_buckets simply yields
    fewer buckets — each observed size then pads to itself (zero waste).
    Observed sizes above max_batch clip to it: the batcher never releases
    more than max_batch, so a larger bucket would only be compiled, never
    hit.
    """
    if len(sizes) == 0:
        return tuple(sorted({1, max_batch}))
    arr = np.sort(np.minimum(np.asarray(sizes, np.int64), max_batch))
    qs = [arr[min(len(arr) - 1, int(np.ceil((i + 1) / n_buckets * len(arr)))
                 - 1)] for i in range(n_buckets)]
    out = sorted({int(q) for q in qs if q >= 1} | {max_batch})
    return tuple(out)


@dataclass
class InflightBatch:
    """A dispatched, unsettled micro-batch: its result, not yet waited
    for, and the host context to account for it at settle time. On the
    card ``probs`` is the ring slot of the pair's graph (pinned output and
    the event after its copy back); on the CPU the probabilities."""
    reqs: List[RecRequest]
    probs: Union[Slot, torch.Tensor]
    bucket: int
    downgraded: bool
    dispatched_mono: float


_NUMPY = {torch.float32: np.float32, torch.int32: np.int32}


def _own_copy(tree: Dict) -> Dict:
    return tree_map(lambda t: t.detach().clone(), tree)


def _same_layout(a: Dict, b: Dict) -> bool:
    """Same tree, and tensors of equal shape, dtype and device."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return (set(a) == set(b) and len(la) == len(lb)
            and all(x.shape == y.shape and x.dtype == y.dtype
                    and x.device == y.device for x, y in zip(la, lb)))


class RecEngine:
    """Batcher-fed DLRM inference; the embedding stage is one
    ``lookup_bags`` over a swappable ``EmbeddingSource``.

    ``source`` accepts a path string (``"ragged"``, ``"fixed"`` or
    ``"cached"``; the last takes ``cache_k``, ``cache_trace`` and
    ``quantize_cold``), a ``SourceSpec`` built against the engine's copy
    of ``params["arena"]`` (a tiered plan ranks its tiers by
    ``cache_trace``; a table-group plan is built against
    ``params["tables"]``, its ``cache_trace`` one histogram a table), or a
    built ``EmbeddingSource``, served as it is on the ragged layout, as
    the engine's own copy. A heterogeneous config serves a table group.
    A fixed-layout engine serves ``params["arena"]`` and takes requests
    whose every bag holds exactly ``cfg.lookups_per_table`` ids.
    ``auto_tune_after`` retunes the buckets once, after that many
    micro-batches.

    ``device`` defaults to the card, where every micro-batch replays the
    captured graph of its (path, bucket) pair; pass ``device="cpu"``
    (with params on the CPU) to serve eagerly through the plain PyTorch
    path. Latencies are kept over a bounded ring of the last
    ``LATENCY_RING`` requests.
    """

    LATENCY_RING = 4096

    def __init__(self, cfg: DLRMConfig, params: Dict, *,
                 source: Union[str, SourceSpec, es.EmbeddingSource,
                               None] = None,
                 max_l: Optional[int] = None,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 cache_k: int = 0, cache_trace=None,
                 quantize_cold: bool = False,
                 auto_tune_after: Optional[int] = None,
                 mesh: Optional[object] = None,
                 telemetry: Optional[object] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if telemetry is not None:
            raise NotImplementedError(
                "serving telemetry needs the port's copy of repro.obs, not "
                "ported yet (ROADMAP Queue 1, item 6)")
        self.device = resolve_device(device)
        self._graphed = self.device.type == "cuda"
        for name, tree in params.items():
            for t in tree_leaves(tree):
                self._check_device(t, f"params[{name!r}]")
        self.cfg = cfg
        self.source: Optional[es.EmbeddingSource] = None
        self._down_source: Optional[es.EmbeddingSource] = None
        # the warm pool: (path kind, bucket) pairs whose serve entry has
        # been triggered (warmup() or a first dispatch), as the
        # reference's; on the card the captured graphs of the live
        # buckets, one memory pool for all, and the captures so far
        self._warm: set = set()
        self._graphs: Dict[tuple, ServeGraph] = {}
        self._pool = None
        self.captures = 0
        # dispatches that found their pair cold: zero after warmup() is
        # the warm-pool claim (the reference's rec_cold_compiles_total)
        self.cold_compiles = 0
        self._params: Optional[Dict] = None
        self.params = params
        self.spec = dlrm.arena_spec(cfg)
        self.max_l = max_l if max_l is not None else cfg.lookups_per_table
        self.batcher = RecBatcher(max_batch, max_wait_ms)
        self.max_batch = max_batch
        self.buckets = tuple(sorted(set(buckets) | {max_batch}))
        self.auto_tune_after = auto_tune_after
        self._retuned = False
        # the tuner never reads more than this many batch sizes
        self._batch_ring: deque = deque(
            maxlen=max(1024, auto_tune_after or 0))
        self._batches_seen = 0
        self.served = 0
        self.batches = 0
        self.source_version = 0
        self._lat_ms: deque = deque(maxlen=self.LATENCY_RING)

        if source is None:
            source = "ragged"
        if isinstance(source, (str, SourceSpec)):
            self.plan: Optional[SourceSpec] = SourceSpec.from_path(
                source, cache_k=cache_k, quantize_cold=quantize_cold,
                mesh=mesh)
            self.path = self.plan.path_name()
            if cfg.heterogeneous != (self.plan.tables is not None):
                raise ValueError(
                    "a heterogeneous config serves a table-group plan "
                    "(SourceSpec(tables=dlrm.table_plans(cfg))) or a built "
                    "TableGroupSource, and a table-group plan needs one")
            # built over the engine's own arena (or per-table arenas):
            # every tensor is new or the engine's
            self.source = self.plan.build(
                self._params["arena" if self.plan.tables is None
                             else "tables"], self.spec, cache_trace)
        elif isinstance(source, es.EmbeddingSource):
            if cache_k or cache_trace is not None or quantize_cold \
                    or mesh is not None:
                raise ValueError(
                    "cache_k/cache_trace/quantize_cold/mesh are SourceSpec "
                    "plan inputs; a built EmbeddingSource is served as it "
                    "is")
            for t in es.source_structure(source)[1]:
                self._check_device(t, "source")
            self.plan = None
            self.path = es.describe_source(source)
            self.source = es.clone_source(source)
        else:
            raise TypeError(f"source must be a path string, a SourceSpec or "
                            f"an EmbeddingSource, got {type(source)}")
        self.layout = ("fixed" if self.plan is not None
                       and self.plan.layout == "fixed" else "ragged")
        if self.layout == "fixed":
            self._serve = dlrm.make_serve_step(cfg)
        else:
            self._serve = dlrm.make_ragged_serve_step(cfg, max_l=self.max_l)
        # hits accumulate on the device, in place (a probe captured in a
        # graph keeps its address), and are read only by stats(); the
        # lookups are counted on the host from the numpy bag lengths. A
        # group counts both per table.
        shape = (len(self.source.members),) if self.grouped else ()
        self._hits = torch.zeros(shape, dtype=torch.int64,
                                 device=self.device)
        self._lookups = np.zeros(shape, np.int64) if self.grouped else 0
        self._bind_host_stores()

    @property
    def grouped(self) -> bool:
        """Serving a heterogeneous ``TableGroupSource``?"""
        return isinstance(self.source, es.TableGroupSource)

    def _served_arenas(self):
        """What the served source's fp leaves are rebound to: the arena,
        or a group's per-table arenas."""
        return self._params["tables" if self.grouped else "arena"]

    def _check_device(self, t: torch.Tensor, what: str) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"{what} on {t.device}, engine on "
                             f"{self.device}")

    @property
    def batch_sizes(self) -> List[int]:
        """The most recent micro-batch sizes (a ring of max(1024,
        auto_tune_after): all the tuner reads)."""
        return list(self._batch_ring)

    # -- the swap boundary --------------------------------------------------

    @property
    def params(self) -> Dict:
        return self._params

    @params.setter
    def params(self, params: Dict) -> None:
        """Copy ``params`` into the engine's own tensors and the served
        source's fp-arena leaves (a group's, member by member), in place
        when the layout matches, so every address stays fixed and no graph
        is recaptured; the downgrade source is re-quantized into its own
        tensors. A trainer that then steps in place does not reach what
        the engine serves until the next assignment. Params of another
        layout are copied into new tensors, and every captured graph is
        dropped."""
        if self._params is not None and _same_layout(self._params, params):
            with torch.no_grad():
                for mine, new in zip(tree_leaves(self._params),
                                     tree_leaves(params)):
                    mine.copy_(new)
            if self.source is not None:
                es.adopt_source(self.source, es.rebind_arena(
                    self.source, self._served_arenas()))
        else:
            self._params = _own_copy(params)
            self._graphs.clear()
            if self.source is not None:
                self.source = es.rebind_arena(self.source,
                                              self._served_arenas())
        if self._down_source is not None:
            es.adopt_source(self._down_source,
                            self._build_downgrade_source())

    @property
    def cache(self) -> Optional[se.HotRowCache]:
        """The hot cache currently served (None on non-cached sources)."""
        return es.hot_cache_of(self.source)

    @property
    def cache_version(self) -> int:
        """Alias of ``source_version``."""
        return self.source_version

    def _reset_hit_counters(self) -> None:
        self._hits.zero_()
        self._lookups = np.zeros_like(self._lookups) if self.grouped else 0

    def _hit_snapshot(self) -> Dict:
        """Host numbers of the live version's hit accounting: totals, and
        on a group (hits, lookups) per table. Reads the device counter."""
        hits = self._hits.cpu().numpy()
        if self.grouped:
            return {"hits": float(hits.sum()),
                    "lookups": float(self._lookups.sum()),
                    "per_table": {str(t): (float(hits[t]),
                                           float(self._lookups[t]))
                                  for t in range(len(hits))}}
        return {"hits": float(hits), "lookups": float(self._lookups)}

    def update_source(self, source: es.EmbeddingSource,
                      version: Optional[int] = None) -> None:
        """Swap the served source atomically (hot cache, int8 cold arena,
        fp arena: any component), by copying it into the engine's own
        source in place: the captured graphs serve it from their next
        replay, with no recapture.

        A version below the served one is refused (a reordered broadcast
        would roll rows back); an equal one is a republish. The new
        source must have the old one's structure and tensors of the same
        shapes, dtypes and devices: the serve step and its captured
        graphs are shaped for it. A version bump resets the hit counters,
        so the reported rate is the live cache's. On the plans built over
        the fp arena the served arena is ``params["arena"]`` (a group's,
        ``params["tables"]``), which a swap of the fp arena therefore
        rewrites too. A group swap of one member (``es.replace_member``)
        copies that member alone: the others are the engine's own.
        """
        if self.layout == "fixed":
            raise ValueError(
                "a fixed-layout engine serves params['arena'] and never "
                "reads engine.source; a swap would bump the version while "
                "serving the old embeddings")
        if version is not None and version < self.source_version:
            raise ValueError(
                f"stale source broadcast: version {version} < served "
                f"version {self.source_version}; refusing to roll the "
                f"serving source back")
        old_struct, old_leaves = es.source_structure(self.source)
        new_struct, new_leaves = es.source_structure(source)
        if old_struct != new_struct:
            raise ValueError(f"source swap changed the structure: "
                             f"{old_struct} -> {new_struct}")
        for a, b in zip(old_leaves, new_leaves):
            if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
                raise ValueError(
                    f"source swap changed a tensor: {tuple(a.shape)} "
                    f"{a.dtype} on {a.device} -> {tuple(b.shape)} "
                    f"{b.dtype} on {b.device}; keep trainer and engine "
                    f"cache_k and arena shapes equal")
        new_version = (version if version is not None
                       else self.source_version + 1)
        es.adopt_source(self.source, source)
        self._bind_host_stores()
        if new_version > self.source_version:
            self._reset_hit_counters()
        self.source_version = new_version

    def update_cache(self, cache: se.HotRowCache,
                     version: Optional[int] = None) -> None:
        """Swap only the hot cache, keeping the cold source (the online
        refresh; see ``update_source`` for the rules)."""
        if not isinstance(self.source, es.CachedSource):
            raise TypeError("update_cache needs a cached source")
        self.update_source(es.with_hot_cache(self.source, cache),
                           version=version)

    # -- the int8 downgrade path --------------------------------------------

    @property
    def downgrade_source(self) -> Optional[es.EmbeddingSource]:
        """The int8 source overloaded batches serve from (None until
        ``enable_downgrade``)."""
        return self._down_source

    def enable_downgrade(self) -> es.EmbeddingSource:
        """Build (once) the int8 downgrade source,
        ``QuantizedArena.from_arena(params["arena"])`` (on a group, one
        such member a table arena), served through the same ragged serve
        step as its own path: ``warmup()`` captures its pairs too, and a
        params assignment re-quantizes into its tensors."""
        if self.layout == "fixed":
            raise ValueError(
                "the downgrade path serves through the ragged lookup_bags "
                "step; the fixed layout reads params['arena'] directly")
        if self._down_source is None:
            self._down_source = self._build_downgrade_source()
        return self._down_source

    def _build_downgrade_source(self) -> es.EmbeddingSource:
        if self.grouped:
            return es.TableGroupSource(
                members=tuple(es.QuantizedArena.from_arena(a)
                              for a in self._params["tables"]),
                specs=self.source.specs)
        return es.QuantizedArena.from_arena(self._params["arena"])

    # -- host cold tier: staging and prefetch --------------------------------

    def _bind_host_stores(self) -> None:
        """The host stores behind the served source: the engine's own
        (see ``update_source``), staged before every primary forward."""
        self._host_stores: List = ([] if self.layout == "fixed"
                                   else st.host_stores_of(self.source))
        self._stream_cache = None

    def _req_streams(self, r: RecRequest) -> tuple:
        """One request's (per-table id, table) streams, extracted once:
        ``submit`` does it at admission, so the serve path only
        concatenates."""
        s = r.cold_streams
        if s is None:
            t = self.cfg.n_tables
            lens = np.fromiter(map(len, r.sparse_ids), np.int64, count=t)
            per_id = (np.concatenate(r.sparse_ids).astype(
                np.int64, copy=False) if int(lens.sum())
                else np.zeros(0, np.int64))
            tbl = np.repeat(np.arange(t, dtype=np.int64), lens)
            s = r.cold_streams = (per_id, tbl)
        return s

    def _host_ids(self, reqs: List[RecRequest]) -> np.ndarray:
        """The arena row ids of a micro-batch (per-table id + table base),
        from the requests' numpy streams: staging never reads a device
        tensor."""
        if not reqs:
            return np.zeros(0, np.int64)
        parts = [self._req_streams(r) for r in reqs]
        per_id = np.concatenate([p[0] for p in parts])
        tbl = np.concatenate([p[1] for p in parts])
        return per_id + tbl * self.spec.rows_per_table

    def _stage_batch(self, reqs: List[RecRequest], *,
                     ahead: bool = False) -> None:
        """Residency guarantee (``ahead=False``, counted as hits and
        misses) or prefetch (``ahead=True``, uncounted) for one
        micro-batch's cold rows.

        The batch path folds the admission queue's next micro-batch into
        the same flush and remembers its cold sets: when that batch
        arrives, its rows are already resident and its extraction done.
        That is the prefetcher: misses become hits one step ahead of
        their batch. The copies and scatters are enqueued on the serving
        stream before the forward (outside its graph), with no host
        synchronisation, into the tensors the served source holds, whose
        addresses stay fixed (the reference refreshes its source's
        snapshot here; the port's stores update in place).
        """
        if not self._host_stores or not reqs:
            return
        if ahead:
            ids = self._host_ids(reqs)
            for store in self._host_stores:
                store.prefetch_arena(ids)
            return
        cache, self._stream_cache = self._stream_cache, None
        if cache is not None and cache[0] == [r.rid for r in reqs]:
            cur_cold = cache[1]
        else:
            ids = self._host_ids(reqs)
            cur_cold = [store.cold_ids_of(ids) for store in self._host_stores]
        nxt = list(self.batcher._queue[:self.max_batch])
        nxt_cold = None
        if nxt:
            ids = self._host_ids(nxt)
            nxt_cold = [store.cold_ids_of(ids) for store in self._host_stores]
        for i, store in enumerate(self._host_stores):
            store.stage(cur_cold[i],
                        ahead=None if nxt_cold is None else nxt_cold[i])
        if nxt_cold is not None:
            self._stream_cache = ([r.rid for r in nxt], nxt_cold)

    def prefetch(self, reqs: List[RecRequest]) -> None:
        """Stage a future micro-batch's cold rows ahead of its forward
        (uncounted: they count as hits when their batch arrives; rows
        pinned by the batch in flight are never evicted). The engine
        already prefetches the queue's next micro-batch in every step;
        this is for lookahead the queue cannot see yet."""
        self._stage_batch(reqs, ahead=True)

    # -- the warm pool: one serve entry per (path, bucket) -------------------

    def _forward(self, kind: str) -> Callable[[Dict], torch.Tensor]:
        """The eager serve step of one path over a batch dict: what the
        card captures as the pair's graph and the CPU runs. The primary
        path of a cached source (a group with a cached member) adds its
        hit probe after the forward, on the device, so that it adds no
        host wait."""
        if kind == "downgrade":
            return lambda batch: self._serve(self._params, batch,
                                             self._down_source)
        if self.layout == "fixed":
            return lambda batch: self._serve(self._params, batch)
        if self.grouped and any(es.hot_cache_of(m) is not None
                                for m in self.source.members):
            def grouped(batch: Dict) -> torch.Tensor:
                probs = self._serve(self._params, batch, self.source)
                hits, _ = es.group_hit_counts(
                    self.source, batch["indices"], batch["offsets"],
                    max_l=self.max_l)
                self._hits += hits
                return probs
            return grouped
        cache = self.cache
        if cache is None:
            return lambda batch: self._serve(self._params, batch,
                                             self.source)

        def primary(batch: Dict) -> torch.Tensor:
            probs = self._serve(self._params, batch, self.source)
            self._hits += se.cache_hits(cache, self.spec, batch["indices"],
                                        batch["offsets"])
            return probs
        return primary

    def _input_shapes(self, bucket: int) -> Dict[str, tuple]:
        """A bucket's static input shapes and dtypes."""
        t = self.cfg.n_tables
        out = {"dense": ((bucket, self.cfg.dense_features), torch.float32)}
        if self.layout == "fixed":
            out["indices"] = ((bucket, t, self.cfg.lookups_per_table),
                              torch.int32)
        else:
            out["indices"] = ((bucket * t * self.max_l,), torch.int32)
            out["offsets"] = ((bucket * t + 1,), torch.int32)
        return out

    def _graph(self, kind: str, bucket: int) -> ServeGraph:
        """The captured graph of a pair, captured now if it has none (the
        largest bucket first keeps the shared pool one size)."""
        g = self._graphs.get((kind, bucket))
        if g is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[(kind, bucket)] = ServeGraph(
                self._forward(kind), self._input_shapes(bucket),
                self.device, self._pool)
            self.captures += 1
        return g

    def warmup(self) -> None:
        """Trigger every (path, bucket) pair's serve entry off the SLA
        clock, the warm pool: on the card capture each pair's graph (the
        primary path's, and the downgrade path's once ``enable_downgrade``
        has run), largest bucket first; on the CPU serve one dummy
        request through each. Every host store first runs one flush at
        each chunk size."""
        n_l = self.cfg.lookups_per_table if self.layout == "fixed" else 0
        dummy = [RecRequest(
            rid=-1, dense=np.zeros(self.cfg.dense_features, np.float32),
            sparse_ids=[np.zeros(n_l, np.int32)] * self.cfg.n_tables)]
        kinds = ("primary",) + (("downgrade",) if self._down_source
                                is not None else ())
        for store in self._host_stores:
            store.warm_compile()
        for bucket in sorted(self.buckets, reverse=True):
            for kind in kinds:
                if self._graphed:
                    self._graph(kind, bucket)
                else:
                    batch, _ = self._assemble(dummy, bucket)
                    self._forward(kind)(batch)
                self._warm.add((kind, bucket))

    def retune_buckets(self, n_buckets: int = 6,
                       warmup: bool = True) -> tuple:
        """Re-pick the buckets from the observed batch sizes
        (``tune_buckets``), free the graphs of the buckets dropped, and
        (``warmup``) capture the new ones."""
        self.buckets = tune_buckets(self.batch_sizes, self.max_batch,
                                    n_buckets)
        self._graphs = {p: g for p, g in self._graphs.items()
                        if p[1] in self.buckets}
        if warmup:
            self.warmup()
        return self.buckets

    # -- request plumbing ---------------------------------------------------

    def submit(self, req: RecRequest) -> None:
        if len(req.sparse_ids) != self.cfg.n_tables:
            raise ValueError(f"request {req.rid} has {len(req.sparse_ids)} "
                             f"id lists for {self.cfg.n_tables} tables")
        if self._host_stores:
            self._req_streams(req)       # admission-time extraction
        self.batcher.submit(req)

    def _fill(self, reqs: List[RecRequest], arrays: Dict[str, np.ndarray]
              ) -> np.ndarray:
        """Pad a micro-batch into its bucket's host arrays, in place (the
        padding rows zero, their bags empty). Returns the real bags'
        lengths in (sample, table) order, so hit accounting never reads a
        device tensor to learn the lookups. The bags of a micro-batch, in
        that order, are its flat id stream."""
        n, t = len(reqs), self.cfg.n_tables
        dense = arrays["dense"]
        np.stack([r.dense for r in reqs], out=dense[:n])
        dense[n:] = 0.0
        bags = [ids for r in reqs for ids in r.sparse_ids]
        lens = np.fromiter(map(len, bags), np.int32, count=n * t)
        idx = arrays["indices"]
        if self.layout == "fixed":
            n_l = self.cfg.lookups_per_table
            bad = np.flatnonzero(lens != n_l)
            if bad.size:
                i, j = divmod(int(bad[0]), t)
                raise ValueError(
                    f"request {reqs[i].rid} table {j}: the fixed layout "
                    f"takes bags of exactly {n_l} ids, got {lens[bad[0]]}")
            # padding rows gather row 0: harmless, their outputs are
            # dropped, and every kernel computes each row on its own
            idx[:n] = np.concatenate(bags).reshape(n, t, n_l)
            idx[n:] = 0
            return lens
        bad = np.flatnonzero(lens > self.max_l)
        if bad.size:
            i, j = divmod(int(bad[0]), t)
            raise ValueError(f"request {reqs[i].rid} table {j}: bag of "
                             f"{lens[bad[0]]} > max_l {self.max_l}")
        offsets = arrays["offsets"]
        offsets[0] = 0
        np.cumsum(lens, out=offsets[1:n * t + 1])
        n_valid = int(offsets[n * t])
        offsets[n * t + 1:] = n_valid
        if n_valid:
            np.concatenate(bags, out=idx[:n_valid], casting="same_kind")
        idx[n_valid:] = 0                 # the static cap's padded tail
        return lens

    def _assemble(self, reqs: List[RecRequest], bucket: int):
        """A micro-batch padded to its bucket's static shapes, as a batch
        dict on the engine's device, and its bags' lengths (``_fill``)."""
        arrays = {k: np.empty(s, _NUMPY[dt])
                  for k, (s, dt) in self._input_shapes(bucket).items()}
        lens = self._fill(reqs, arrays)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}, lens

    # -- serving: dispatch / settle -----------------------------------------

    def dispatch(self, reqs: List[RecRequest], *,
                 downgraded: bool = False) -> InflightBatch:
        """Stage, pad and enqueue one micro-batch without waiting for it.

        On the card the forward is the pair's graph replay, and the
        result stays in flight (its ring slot and event), so the caller
        can assemble the next micro-batch while this one computes:
        continuous batching with in-flight refill. ``downgraded=True``
        serves from the int8 downgrade source (``enable_downgrade``
        first), its own pair of graphs. A pair not yet warm is captured
        here and counted in ``cold_compiles``."""
        return self._dispatch(reqs, downgraded, count_cold=True)

    def _dispatch(self, reqs: List[RecRequest], downgraded: bool, *,
                  count_cold: bool) -> InflightBatch:
        if not reqs:
            raise ValueError("dispatch needs a non-empty micro-batch")
        if downgraded and self._down_source is None:
            raise ValueError("call enable_downgrade() before dispatching a "
                             "downgraded micro-batch")
        # retune before the SLA clocks start: capturing the new buckets
        # must not land on this micro-batch's latency
        if self.auto_tune_after is not None and not self._retuned \
                and self._batches_seen >= self.auto_tune_after:
            self._retuned = True
            self.retune_buckets()
        now, now_m = time.time(), time.monotonic()
        self._batches_seen += 1
        self._batch_ring.append(len(reqs))
        bucket = _bucket(len(reqs), self.buckets)
        kind = "downgrade" if downgraded else "primary"
        pair = (kind, bucket)
        if count_cold and pair not in (self._graphs if self._graphed
                                       else self._warm):
            self.cold_compiles += 1
        self._warm.add(pair)
        for r in reqs:
            r.started_at = now
            r.downgraded = downgraded
        if not downgraded:
            self._stage_batch(reqs)      # host-cold residency guarantee
        if self._graphed:
            graph = self._graph(kind, bucket)
            probs = graph.acquire()
            lens = self._fill(reqs, probs.arrays)
            graph.replay(probs)
        else:
            batch, lens = self._assemble(reqs, bucket)
            probs = self._forward(kind)(batch)
        if not downgraded:
            if self.grouped:
                self._lookups += lens.reshape(-1, self.cfg.n_tables).sum(
                    axis=0)
            elif self.cache is not None:
                self._lookups += int(lens.sum())
        return InflightBatch(reqs=reqs, probs=probs, bucket=bucket,
                             downgraded=downgraded, dispatched_mono=now_m)

    def settle(self, ib: InflightBatch) -> int:
        """Wait for an in-flight micro-batch's probabilities and respond:
        the one host wait of the dispatch/settle pair, a read by then in a
        pipeline deep enough. Records each request's latency on the
        monotonic clock."""
        if isinstance(ib.probs, Slot):
            probs = ib.probs.result()
        else:
            probs = ib.probs.numpy()
        done, done_m = time.time(), time.monotonic()
        for i, r in enumerate(ib.reqs):
            r.prob = float(probs[i])
            r.finished_at = done
            self._lat_ms.append((done_m - r.submitted_mono) * 1e3)
        if isinstance(ib.probs, Slot):
            ib.probs.release()
        self.served += len(ib.reqs)
        self.batches += 1
        return len(ib.reqs)

    def step(self, force: bool = False) -> int:
        """Serve one micro-batch (dispatch, then settle); returns the
        number of requests served."""
        reqs = self.batcher.take(force=force)
        if not reqs:
            return 0
        return self.settle(self._dispatch(reqs, False, count_cold=False))

    def drain(self) -> int:
        """Serve everything still queued (end-of-stream flush)."""
        n = 0
        while len(self.batcher):
            n += self.step(force=True)
        return n

    def stats(self) -> Dict:
        """Requests served, latency percentiles over the ring, the source,
        the live cache version's hit rate (None without a cache or before
        its first lookup, never a fake 0.0; on a group one a table, None
        for the members without a cache) and buckets."""
        if not self._lat_ms:
            return {"n": 0}
        lat = np.fromiter(self._lat_ms, np.float64, count=len(self._lat_ms))
        out = {"n": self.served,
               "path": self.path,
               "source": es.describe_source(self.source),
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)),
               "mean_ms": float(lat.mean())}
        if self.grouped:
            snap = self._hit_snapshot()["per_table"]
            out["cache_hit_rate"] = {
                t: (snap[str(t)][0] / snap[str(t)][1]
                    if snap[str(t)][1] else None)
                if es.hot_cache_of(m) is not None else None
                for t, m in enumerate(self.source.members)}
            out["cache_version"] = self.source_version
        elif self.cache is None:
            out["cache_hit_rate"] = None
        else:
            snap = self._hit_snapshot()
            out["cache_hit_rate"] = (snap["hits"] / snap["lookups"]
                                     if snap["lookups"] else None)
            out["cache_version"] = self.source_version
        out["buckets"] = self.buckets
        if self._host_stores:
            hs = [store.stats() for store in self._host_stores]
            hits = sum(s["hits"] for s in hs)
            touches = sum(s["touches"] for s in hs)
            out["prefetch"] = {
                "hits": hits,
                "misses": sum(s["misses"] for s in hs),
                "touches": touches,
                "hit_rate": hits / touches if touches else 1.0,
                "staged_resident": sum(s["resident"] for s in hs),
                "host_bytes": sum(s["host_bytes"] for s in hs)}
        return out


def requests_from_ragged_batch(batch: Dict[str, np.ndarray], n_tables: int,
                               rid0: int = 0) -> List[RecRequest]:
    """Explode a DLRMSynthetic.ragged_batch into individual requests."""
    off = batch["offsets"]
    b = (len(off) - 1) // n_tables
    out = []
    for i in range(b):
        ids = [batch["indices"][off[i * n_tables + j]:
                                off[i * n_tables + j + 1]]
               for j in range(n_tables)]
        out.append(RecRequest(rid=rid0 + i, dense=batch["dense"][i],
                              sparse_ids=ids))
    return out
