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
``HostStore``, one a tiered member of a group), so their addresses never
move and nothing the engine was handed is ever written.

On the card every micro-batch replays a captured CUDA graph of its
(path, bucket) pair (``serve_graph.ServeGraph``), the counterpart of the
reference's one ``jax.jit`` executable per bucket: ``warmup()`` captures
every pair off the SLA clock (the warm pool), a pair's first dispatch
otherwise (``rec_cold_compiles_total`` counts those), and a swap of the
same structure and shapes is never a recapture. ``dispatch``/``settle``
split a micro-batch into its enqueue and its one host wait (continuous
batching, driven by ``serving.scheduler.SlaScheduler``),
``tune_buckets``/``retune_buckets`` re-pick the buckets from the observed
batch sizes, and ``enable_downgrade`` builds the int8 source that
overloaded batches serve from. On the CPU the same calls run the serve
step eagerly through the plain versions.

Telemetry is the port's ``repro_torch.obs`` bundle, as the reference's:
bounded latency, queue-wait and batch-size histograms (cumulative
percentiles exact while the stream fits the ring, a bucket estimate
after, plus the ``since_swap`` and ``rolling`` windows), the reference's
counters and gauges, spans (``enqueue``; ``serve_step`` over ``batch``,
``bucket_pad``, ``forward`` and ``respond``; ``dispatch`` over
``bucket_pad``; ``settle``) and the swap events, each carrying the
outgoing version's hits and lookups. ``Telemetry.disabled()`` records
nothing and counts no lookups, and its graphs are captured without the
hit probe. ``Telemetry(device_stages=True)`` is the live Fig-5 mode:
``step()`` serves through the three stages of
``dlrm.make_ragged_serve_stages`` eagerly, not through a graph, with a
synchronize after each, and ``live_fig5()`` reports the split.

Sharded plans: with ``mesh`` (``launch.mesh.make_mesh((n,), ("model",))``,
one process a rank) the engine is one rank of an SPMD server. Its params'
arena is the rank's block (``dlrm.shard_params``); ``source="sharded"``
(the mesh is required, no silent fallback) serves a ``ShardedArena``, and
``"cached"``/``"ragged"``/``"fixed"`` with a mesh shard their (cold)
arena the same way, the hot rows replicated. Every rank must serve the
same request stream, micro-batch for micro-batch: each sharded lookup is
one all-reduce that all ranks join, and all ranks get the same
probabilities. A CUDA graph cannot capture a gloo collective, so an
engine over a sharded source serves eagerly on the card too, decided when
it is built, never after a failed capture; ``stats()`` says so
(``"graphed": False, "why": "sharded source"``). Swaps copy into the
rank's own block.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.core.embedding_source import SourceSpec
from repro_torch.optim import tree_leaves, tree_map, tree_paths
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
    shed: bool = False                  # dropped at admission (SLA)
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
_STAGE_NAMES = ("sparse_lookup", "interaction", "mlp")


def _own_copy(tree: Dict) -> Dict:
    return tree_map(lambda t: t.detach().clone(), tree)


def _paired_leaves(a: Dict, b: Dict) -> Optional[list]:
    """(a's tensor, b's tensor) pairs matched by tree path, dict keys
    sorted at every level, so the order in which either tree holds its
    keys does not matter (a group train step returns its head before its
    tables); ``None`` if the two trees' paths differ."""
    pa, pb = tree_paths(a), tree_paths(b)
    if [p for p, _ in pa] != [p for p, _ in pb]:
        return None
    return [(x, y) for (_, x), (_, y) in zip(pa, pb)]


def _same_layout(pairs: Optional[list]) -> bool:
    """Paired trees, and tensors of equal shape, dtype and device."""
    return pairs is not None and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in pairs)


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

    ``telemetry`` is the ``repro_torch.obs.Telemetry`` bundle (default:
    metrics on, tracing off); ``obs.Telemetry.disabled()`` serves
    uninstrumented. The latency histogram keeps the last ``LATENCY_RING``
    raw samples.

    ``device`` defaults to the card, where every micro-batch replays the
    captured graph of its (path, bucket) pair (eagerly, through the
    stages, under ``device_stages``); pass ``device="cpu"`` (with params
    on the CPU) to serve eagerly through the plain PyTorch path.
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
                 telemetry: Optional[obs.Telemetry] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.telemetry = (telemetry if telemetry is not None
                          else obs.Telemetry())
        # the live Fig-5 mode serves eagerly, stage by stage (and so does
        # a sharded source, below)
        self._graphed = (self.device.type == "cuda"
                         and not self.telemetry.device_stages)
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
        self._init_metrics()
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
            # a mesh reaches only a plan's source, as in the reference: a
            # built source (sharded or not) is served as it is
            if cache_k or cache_trace is not None or quantize_cold:
                raise ValueError(
                    "cache_k/cache_trace/quantize_cold are SourceSpec plan "
                    "inputs; a built EmbeddingSource is served as it is")
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
        if self.plan is not None:
            self._sharding = ((self.plan.mesh, self.plan.axis)
                              if se.mesh_shards(self.plan.mesh,
                                                self.plan.axis) > 1
                              else None)
        else:
            self._sharding = _sharding_of(self.source)
        self.sharded = self._sharding is not None
        if self.sharded:
            # a gloo all-reduce cannot be captured in a CUDA graph: serve
            # eagerly, by construction
            self._graphed = False
        if self.layout == "fixed":
            self._serve = dlrm.make_serve_step(cfg, self.plan.mesh)
        else:
            self._serve = dlrm.make_ragged_serve_step(cfg, max_l=self.max_l)
        self._staged = None
        if self.telemetry.device_stages:
            if self.layout == "fixed":
                raise ValueError(
                    "device_stages (live Fig-5) characterizes the ragged "
                    "pipeline; the fixed layout has no staged serve path")
            self._staged = dlrm.make_ragged_serve_stages(cfg,
                                                         max_l=self.max_l)
        # hits accumulate on the device, in place (a probe captured in a
        # graph keeps its address), and are read only by stats(); the
        # lookups are counted on the host from the numpy bag lengths. A
        # group counts both per table.
        shape = (len(self.source.members),) if self.grouped else ()
        self._hits = torch.zeros(shape, dtype=torch.int64,
                                 device=self.device)
        self._lookups = np.zeros(shape, np.int64) if self.grouped else 0
        self._bind_host_stores()
        self._g_version.set(self.source_version)

    def _init_metrics(self) -> None:
        """The reference's instruments, by its names, in the bundle's
        registry."""
        reg = self.telemetry.registry
        self._lat_hist = reg.histogram(
            "rec_request_latency_ms", "end-to-end request latency",
            lo=1e-3, hi=1e5, ring=self.LATENCY_RING)
        self._batch_hist = reg.histogram(
            "rec_batch_size", "released micro-batch sizes",
            lo=1.0, hi=4096.0, growth=1.25, ring=256)
        self._c_served = reg.counter("rec_requests_total",
                                     "requests served")
        self._c_batches = reg.counter("rec_batches_total",
                                      "micro-batches served")
        self._c_swaps = reg.counter("rec_source_swaps_total",
                                    "accepted source/cache swaps")
        self._c_stale = reg.counter("rec_stale_rejected_total",
                                    "rejected stale broadcasts")
        self._g_version = reg.gauge("rec_source_version",
                                    "currently served source version")
        self._g_queue = reg.gauge("rec_queue_depth",
                                  "admission-queue depth (set on enqueue "
                                  "and after every serve/drain)")
        self._qwait_hist = reg.histogram(
            "rec_queue_wait_ms", "admission-to-dispatch queue wait",
            lo=1e-3, hi=1e5, ring=4096)
        self._c_cold = reg.counter(
            "rec_cold_compiles_total",
            "dispatches that hit a cold (path, bucket) compile-cache "
            "entry — zero after warmup() is the warm-pool claim")
        # rec_service_ms{path=...}, registered at a path's first settle
        self._service_hist: Dict[str, obs.Histogram] = {}

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

    @property
    def latencies(self) -> List[float]:
        """The most recent per-request latencies in seconds (the latency
        histogram's ring)."""
        return [v / 1e3 for v in self._lat_hist.ring_values()]

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
        pairs = (None if self._params is None
                 else _paired_leaves(self._params, params))
        if _same_layout(pairs):
            with torch.no_grad():
                for mine, new in pairs:
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
        on a group (hits, lookups) per table. Reads the device counter,
        a copy that the engine's stream orders after every replay
        enqueued before it."""
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
        would roll rows back) with a ``stale_rejected`` event; an equal
        one is a republish. The new source must have the old one's
        structure and tensors of the same shapes, dtypes and devices: the
        serve step and its captured graphs are shaped for it. A version
        bump resets the hit counters, so the reported rate is the live
        cache's: the outgoing version's hits and lookups, read before the
        copy, go into the swap event (``hit_rate_by_version``), and the
        since-swap latency window restarts. On the plans built over the
        fp arena the served arena is ``params["arena"]`` (a group's,
        ``params["tables"]``), which a swap of the fp arena therefore
        rewrites too. A group swap of one member (``es.replace_member``)
        copies that member alone: the others are the engine's own.
        """
        self._swap(source, version, "source_swap")

    def update_cache(self, cache: se.HotRowCache,
                     version: Optional[int] = None) -> None:
        """Swap only the hot cache, keeping the cold source (the online
        refresh; see ``update_source`` for the rules)."""
        if not isinstance(self.source, es.CachedSource):
            raise TypeError("update_cache needs a cached source")
        self._swap(es.with_hot_cache(self.source, cache), version,
                   "cache_swap")

    def _swap(self, source: es.EmbeddingSource, version: Optional[int],
              kind: str) -> None:
        if self.layout == "fixed":
            raise ValueError(
                "a fixed-layout engine serves params['arena'] and never "
                "reads engine.source; a swap would bump the version while "
                "serving the old embeddings")
        tel = self.telemetry
        if version is not None and version < self.source_version:
            self._c_stale.inc()
            tel.emit("stale_rejected", version=version,
                     served_version=self.source_version, swap_kind=kind)
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
        bump = new_version > self.source_version
        # the outgoing version's hits: read after every replay enqueued
        # so far (they served it) and before the copy below
        snap = self._hit_snapshot() if bump and tel.enabled else None
        es.adopt_source(self.source, source)
        self._bind_host_stores()
        if bump:
            if snap is not None:
                tel.emit(kind, version=new_version,
                         prev_version=self.source_version, **snap)
                self._lat_hist.reset_window()
            self._c_swaps.inc()
            self._reset_hit_counters()
        else:
            tel.emit(kind, version=new_version, republish=True)
        self.source_version = new_version
        self._g_version.set(new_version)

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
        def int8(arena: torch.Tensor) -> es.EmbeddingSource:
            q = es.QuantizedArena.from_arena(arena)
            if self.sharded:
                q = es.ShardedArena(q, *self._sharding)
            return q

        if self.grouped:
            return es.TableGroupSource(
                members=tuple(int8(a) for a in self._params["tables"]),
                specs=self.source.specs)
        return int8(self._params["arena"])

    # -- host cold tier: staging and prefetch --------------------------------

    def _bind_host_stores(self) -> None:
        """The host stores behind the served source: the engine's own
        (see ``update_source``), staged before every primary forward and
        bound to the engine's telemetry. A group keeps each member's
        stores beside the member's table (``_host_tables``): such a store
        stages its table's own ids."""
        self._host_stores: List = []
        self._host_tables: List[Optional[int]] = []
        if self.layout != "fixed":
            members = (enumerate(self.source.members) if self.grouped
                       else [(None, self.source)])
            for t, m in members:
                for store in st.host_stores_of(m):
                    self._host_stores.append(store)
                    self._host_tables.append(t)
        for store in self._host_stores:
            store.bind_telemetry(self.telemetry)
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

    def _streams(self, reqs: List[RecRequest]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """A micro-batch's (per-table id, table) streams, the requests'
        numpy streams end to end: staging never reads a device tensor."""
        parts = [self._req_streams(r) for r in reqs]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def _host_ids(self, reqs: List[RecRequest]) -> np.ndarray:
        """The arena row ids of a micro-batch (per-table id + table
        base)."""
        if not reqs:
            return np.zeros(0, np.int64)
        per_id, tbl = self._streams(reqs)
        return per_id + tbl * self.spec.rows_per_table

    def _store_ids(self, reqs: List[RecRequest]) -> List[np.ndarray]:
        """Each host store's row ids of a micro-batch: its table's own ids
        for a group member's store, the arena row ids otherwise."""
        if not self.grouped:
            return [self._host_ids(reqs)] * len(self._host_stores)
        per_id, tbl = self._streams(reqs)
        return [per_id[tbl == t] for t in self._host_tables]

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
            for store, ids in zip(self._host_stores, self._store_ids(reqs)):
                store.prefetch_arena(ids)
            return
        cache, self._stream_cache = self._stream_cache, None
        if cache is not None and cache[0] == [r.rid for r in reqs]:
            cur_cold = cache[1]
        else:
            cur_cold = [store.cold_ids_of(ids) for store, ids in
                        zip(self._host_stores, self._store_ids(reqs))]
        nxt = list(self.batcher._queue[:self.max_batch])
        nxt_cold = None
        if nxt:
            nxt_cold = [store.cold_ids_of(ids) for store, ids in
                        zip(self._host_stores, self._store_ids(nxt))]
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

    def _hit_probe(self) -> Optional[Callable[[Dict], None]]:
        """The primary path's hit probe over a batch dict: adds the
        micro-batch's hot-cache hits (a group's, per table) to the device
        counter, with no host wait. None without a hot cache, or with
        telemetry off, whose graphs are captured without it."""
        if not self.telemetry.enabled or self.layout == "fixed":
            return None
        if self.grouped:
            if all(es.hot_cache_of(m) is None for m in self.source.members):
                return None

            def grouped(batch: Dict) -> None:
                hits, _ = es.group_hit_counts(
                    self.source, batch["indices"], batch["offsets"],
                    max_l=self.max_l)
                self._hits += hits
            return grouped
        cache = self.cache
        if cache is None:
            return None

        def probe(batch: Dict) -> None:
            self._hits += se.cache_hits(cache, self.spec, batch["indices"],
                                        batch["offsets"])
        return probe

    def _forward(self, kind: str) -> Callable[[Dict], torch.Tensor]:
        """The eager serve step of one path over a batch dict: what the
        card captures as the pair's graph and the CPU runs. The primary
        path adds its hit probe after the forward (``_hit_probe``)."""
        if kind == "downgrade":
            return lambda batch: self._serve(self._params, batch,
                                             self._down_source)
        if self.layout == "fixed":
            return lambda batch: self._serve(self._params, batch)
        probe = self._hit_probe()

        def primary(batch: Dict) -> torch.Tensor:
            probs = self._serve(self._params, batch, self.source)
            if probe is not None:
                probe(batch)
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

    def _dummy(self) -> List[RecRequest]:
        """One request of empty bags (the fixed layout's: of id 0): it
        looks up no row, and a hit probe over it adds nothing."""
        n_l = self.cfg.lookups_per_table if self.layout == "fixed" else 0
        return [RecRequest(
            rid=-1, dense=np.zeros(self.cfg.dense_features, np.float32),
            sparse_ids=[np.zeros(n_l, np.int32)] * self.cfg.n_tables)]

    def warmup(self) -> None:
        """Trigger every (path, bucket) pair's serve entry off the SLA
        clock, the warm pool: on the card capture each pair's graph (the
        primary path's, and the downgrade path's once ``enable_downgrade``
        has run), largest bucket first; on the CPU, and under
        ``device_stages``, serve one dummy request through each (the
        stages, untimed, on the primary path). Every host store first
        runs one flush at each chunk size."""
        dummy = self._dummy()
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
                    if self._staged is not None and kind == "primary":
                        self._run_stages(batch, timed=False)
                    else:
                        self._forward(kind)(batch)
                self._warm.add((kind, bucket))

    def _serve_once(self, kind: str, bucket: int,
                    reqs: List[RecRequest]) -> None:
        """Serve ``reqs`` once on a warm (path, bucket) pair and wait: the
        scheduler's calibration probe. On the card it acquires a ring
        slot of the pair's graph, fills it, replays, waits and releases
        it. It touches no counter, histogram, ring or request, as the
        reference's probes bypass dispatch/settle: the hits that the
        primary graph's probe adds are taken back, in stream order."""
        if self._graphed:
            graph = self._graph(kind, bucket)
            slot = graph.acquire()
            self._fill(reqs, slot.arrays)
            hits = self._hits.clone()
            graph.replay(slot)
            self._hits.copy_(hits)
            slot.result()
            slot.release()
            return
        batch, _ = self._assemble(reqs, bucket)
        source = self._down_source if kind == "downgrade" else self.source
        self._serve(self._params, batch, source).cpu()

    def retune_buckets(self, n_buckets: int = 6,
                       warmup: bool = True) -> tuple:
        """Re-pick the buckets from the observed batch sizes
        (``tune_buckets``), free the graphs of the buckets dropped, emit
        a ``retune`` event, and (``warmup``) capture the new ones."""
        old = self.buckets
        self.buckets = tune_buckets(self.batch_sizes, self.max_batch,
                                    n_buckets)
        self._graphs = {p: g for p, g in self._graphs.items()
                        if p[1] in self.buckets}
        self.telemetry.emit("retune", version=self.source_version,
                            old_buckets=list(old),
                            new_buckets=list(self.buckets))
        if warmup:
            self.warmup()
        return self.buckets

    # -- request plumbing ---------------------------------------------------

    def submit(self, req: RecRequest) -> None:
        if len(req.sparse_ids) != self.cfg.n_tables:
            raise ValueError(f"request {req.rid} has {len(req.sparse_ids)} "
                             f"id lists for {self.cfg.n_tables} tables")
        with self.telemetry.span("enqueue", {"rid": req.rid}):
            if self._host_stores:
                self._req_streams(req)   # admission-time extraction
            self.batcher.submit(req)
        if self.telemetry.enabled:
            # live on enqueue: a stalled serve loop shows its backlog
            self._g_queue.set(len(self.batcher))

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

    # -- serving: step, dispatch / settle ------------------------------------

    def _admit(self, reqs: List[RecRequest], kind: str, *,
               count_cold: bool) -> tuple:
        """The host bookkeeping of a released micro-batch, before its SLA
        clocks start: the one-off retune, the batch-size ring, its bucket,
        the warm pool (a cold pair counted in ``rec_cold_compiles_total``
        when ``count_cold``), each request's start stamp and queue wait.
        Returns (bucket, the monotonic start)."""
        # retune before the SLA clocks start: capturing the new buckets
        # must not land on this micro-batch's latency
        if self.auto_tune_after is not None and not self._retuned \
                and self._batches_seen >= self.auto_tune_after:
            self._retuned = True
            self.retune_buckets()
        tel = self.telemetry
        now, now_m = time.time(), time.monotonic()
        self._batches_seen += 1
        self._batch_ring.append(len(reqs))
        bucket = _bucket(len(reqs), self.buckets)
        pair = (kind, bucket)
        if count_cold and tel.enabled and pair not in (
                self._graphs if self._graphed else self._warm):
            self._c_cold.inc()
        self._warm.add(pair)
        for r in reqs:
            r.started_at = now
            r.downgraded = kind == "downgrade"
        if tel.enabled:
            self._qwait_hist.record_many(
                (now_m - self._submitted(reqs)) * 1e3)
        return bucket, now_m

    @staticmethod
    def _submitted(reqs: List[RecRequest]) -> np.ndarray:
        return np.array([r.submitted_mono for r in reqs], np.float64)

    def _pad(self, reqs: List[RecRequest], kind: str, bucket: int):
        """The micro-batch padded into its bucket's inputs, and its bags'
        lengths: on the card a ring slot of the pair's graph, filled in
        place; else a batch dict on the engine's device."""
        if self._graphed:
            graph = self._graph(kind, bucket)
            slot = graph.acquire()
            return (graph, slot), self._fill(reqs, slot.arrays)
        return self._assemble(reqs, bucket)

    def _run(self, kind: str, padded) -> Union[Slot, torch.Tensor]:
        """Enqueue the forward of a padded micro-batch without waiting:
        on the card the pair's graph replay, whose result is the slot."""
        if self._graphed:
            graph, slot = padded
            graph.replay(slot)
            return slot
        return self._forward(kind)(padded)

    @staticmethod
    def _result(probs: Union[Slot, torch.Tensor]) -> np.ndarray:
        """Wait for a forward's probabilities (a slot's: a view of its
        pinned output, valid until ``release``)."""
        if isinstance(probs, Slot):
            return probs.result()
        return probs.cpu().numpy()

    def _count_lookups(self, lens: np.ndarray) -> None:
        """Add a primary micro-batch's lookups (a group's, per table) to
        the host counter of a cached source, from the numpy lengths."""
        if not self.telemetry.enabled:
            return
        if self.grouped:
            self._lookups += lens.reshape(-1, self.cfg.n_tables).sum(axis=0)
        elif self.cache is not None:
            self._lookups += int(lens.sum())

    def _respond(self, reqs: List[RecRequest], probs: np.ndarray) -> float:
        """Hand each request its probability and record the latencies on
        the monotonic clock, all in one pass. Returns the monotonic
        time of the response."""
        done, done_m = time.time(), time.monotonic()
        for r, p in zip(reqs, probs[:len(reqs)].tolist()):
            r.prob = p
            r.finished_at = done
        if self.telemetry.enabled:
            self._lat_hist.record_many((done_m - self._submitted(reqs))
                                       * 1e3)
        return done_m

    def _account(self, n: int) -> None:
        self.served += n
        self.batches += 1
        if self.telemetry.enabled:
            self._c_served.inc(n)
            self._c_batches.inc()
            self._batch_hist.record(n)

    def step(self, force: bool = False) -> int:
        """Serve one micro-batch from the batcher, waiting for it; returns
        the number of requests served. Under ``device_stages`` the
        forward runs through the three stages, each timed."""
        tel = self.telemetry
        t_take0 = time.perf_counter()
        reqs = self.batcher.take(force=force)
        t_take1 = time.perf_counter()
        if not reqs:
            return 0
        bucket, _ = self._admit(reqs, "primary", count_cold=False)
        with tel.span("serve_step", {"batch_size": len(reqs),
                                     "bucket": bucket}):
            tel.tracer.record("batch", t_take0, t_take1)
            self._stage_batch(reqs)      # host-cold residency guarantee
            with tel.span("bucket_pad"):
                padded, lens = self._pad(reqs, "primary", bucket)
            self._count_lookups(lens)
            if self._staged is not None:
                # the stages' spans stand in for "forward", as the
                # reference's do
                probs = out = self._run_stages(padded, timed=True)
            else:
                with tel.span("forward"):
                    out = self._run("primary", padded)
                    probs = self._result(out)
            with tel.span("respond"):
                self._respond(reqs, probs)
                if isinstance(out, Slot):
                    out.release()
        self._account(len(reqs))
        if tel.enabled:
            self._g_queue.set(len(self.batcher))
        return len(reqs)

    def drain(self) -> int:
        """Serve everything still queued (end-of-stream flush)."""
        n = 0
        while len(self.batcher):
            n += self.step(force=True)
        if self.telemetry.enabled:
            self._g_queue.set(len(self.batcher))
        self.telemetry.emit("drain", version=self.source_version,
                            served=n, queue_depth=len(self.batcher))
        return n

    def dispatch(self, reqs: List[RecRequest], *,
                 downgraded: bool = False) -> InflightBatch:
        """Stage, pad and enqueue one micro-batch without waiting for it.

        On the card the forward is the pair's graph replay, and the
        result stays in flight (its ring slot and event), so the caller
        can assemble the next micro-batch while this one computes:
        continuous batching with in-flight refill. ``downgraded=True``
        serves from the int8 downgrade source (``enable_downgrade``
        first), its own pair of graphs. A pair not yet warm is captured
        here and counted in ``rec_cold_compiles_total``. Refused under
        ``device_stages``, which synchronizes between stages."""
        if not reqs:
            raise ValueError("dispatch needs a non-empty micro-batch")
        if self._staged is not None:
            raise ValueError(
                "device_stages (live Fig-5) synchronizes between stages, "
                "which defeats in-flight refill; characterize through "
                "step()")
        if downgraded and self._down_source is None:
            raise ValueError("call enable_downgrade() before dispatching a "
                             "downgraded micro-batch")
        tel = self.telemetry
        kind = "downgrade" if downgraded else "primary"
        bucket, now_m = self._admit(reqs, kind, count_cold=True)
        with tel.span("dispatch", {"batch_size": len(reqs),
                                   "bucket": bucket, "path": kind}):
            if not downgraded:
                self._stage_batch(reqs)  # host-cold residency guarantee
            with tel.span("bucket_pad"):
                padded, lens = self._pad(reqs, kind, bucket)
            probs = self._run(kind, padded)
            if not downgraded:
                self._count_lookups(lens)
        return InflightBatch(reqs=reqs, probs=probs, bucket=bucket,
                             downgraded=downgraded, dispatched_mono=now_m)

    def settle(self, ib: InflightBatch) -> int:
        """Wait for an in-flight micro-batch's probabilities and respond:
        the one host wait of the dispatch/settle pair, a read by then in a
        pipeline deep enough. Records each request's latency and the
        dispatch-to-settle service time of its path on the monotonic
        clock."""
        tel = self.telemetry
        with tel.span("settle", {"batch_size": len(ib.reqs)}):
            done_m = self._respond(ib.reqs, self._result(ib.probs))
            if isinstance(ib.probs, Slot):
                ib.probs.release()
        self._account(len(ib.reqs))
        if tel.enabled:
            path = "downgrade" if ib.downgraded else "primary"
            hist = self._service_hist.get(path)
            if hist is None:
                hist = self._service_hist[path] = tel.registry.histogram(
                    "rec_service_ms", "dispatch-to-settle service time",
                    labels={"path": path})
            hist.record((done_m - ib.dispatched_mono) * 1e3)
        return len(ib.reqs)

    # -- the live Fig-5 mode ---------------------------------------------------

    def _mark(self):
        """A stage boundary: on the card an event recorded on the engine's
        stream and waited for, else the host clock."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return ev

    @staticmethod
    def _between_ms(a, b) -> float:
        return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
            else (b - a) * 1e3

    def _run_stages(self, batch: Dict, *, timed: bool) -> np.ndarray:
        """The primary forward through the three stages, eagerly, with a
        synchronize after each (the reference syncs there); ``timed``
        records each stage's time between its boundaries on the engine's
        stream (the device's, on the card) into ``rec_stage_ms``. The
        hit probe follows, untimed."""
        sp, it, tp = self._staged
        tel = self.telemetry
        t0 = self._mark()
        with tel.span("sparse_lookup"):
            emb = sp(self._params, batch, self.source)
            t1 = self._mark()
        with tel.span("interaction"):
            x = it(self._params, batch, emb)
            t2 = self._mark()
        with tel.span("mlp"):
            probs = tp(self._params, x)
            t3 = self._mark()
        probe = self._hit_probe()
        if probe is not None:
            probe(batch)
        if timed:
            reg = tel.registry
            for name, a, b in zip(_STAGE_NAMES, (t0, t1, t2), (t1, t2, t3)):
                reg.histogram("rec_stage_ms", "per-stage device time",
                              labels={"stage": name}).record(
                                  self._between_ms(a, b))
        return probs.cpu().numpy()

    def live_fig5(self) -> Dict[str, float]:
        """The live Fig-5 characterization: mean time of each stage and
        the embedding fraction, from the traffic served. Needs
        ``Telemetry(device_stages=True)``."""
        if self._staged is None:
            raise ValueError("live_fig5 needs Telemetry(device_stages=True)")
        reg = self.telemetry.registry
        means = {n: reg.histogram("rec_stage_ms",
                                  labels={"stage": n}).mean
                 for n in _STAGE_NAMES}
        total = sum(means.values())
        return {**{f"{n}_ms": means[n] for n in _STAGE_NAMES},
                "total_ms": total,
                "emb_frac": (means["sparse_lookup"] / total
                             if total else 0.0)}

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict:
        """Requests served and their latency percentiles from the latency
        histogram (cumulative: exact while the stream fits its ring, a
        bucket estimate after; ``since_swap`` since the last version bump;
        ``rolling`` over the ring), the source (``source_tree`` one line a
        nested source), the live cache version's hit rate (None without a
        cache or before its first lookup, never a fake 0.0; on a group one
        a table, None for the members without a cache), buckets, a host
        tier's prefetch counts and, under ``device_stages``,
        ``live_fig5()``. ``{"n": 0}`` before the first recorded request,
        and always with telemetry off."""
        h = self._lat_hist
        if h.count == 0:
            return {"n": 0}
        out = {"n": h.count,
               "path": self.path,
               "source": es.describe_source(self.source),
               "source_tree": es.describe_source(self.source,
                                                 multiline=True),
               "p50_ms": h.percentile(50),
               "p95_ms": h.percentile(95),
               "p99_ms": h.percentile(99),
               "mean_ms": h.mean}
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
        if self.sharded:
            out["graphed"] = False
            out["why"] = "sharded source"
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
        out["since_swap"] = {"n": h.window_count,
                             "p50_ms": h.percentile(50, "window"),
                             "p95_ms": h.percentile(95, "window"),
                             "p99_ms": h.percentile(99, "window")}
        out["rolling"] = {"n": min(h.count, h.ring_size),
                          "p50_ms": h.percentile(50, "rolling"),
                          "p95_ms": h.percentile(95, "rolling"),
                          "p99_ms": h.percentile(99, "rolling")}
        if self._staged is not None:
            out["stages"] = self.live_fig5()
        return out


def _sharding_of(source) -> Optional[tuple]:
    """(mesh, axis) of the first arena a built source row-shards over
    more than one rank, or None."""
    if isinstance(source, es.ShardedArena):
        return (source.mesh, source.axis) if source.n_shards > 1 else None
    if isinstance(source, es.CachedSource):
        return _sharding_of(source.cold)
    if isinstance(source, es.TableGroupSource):
        for m in source.members:
            found = _sharding_of(m)
            if found is not None:
                return found
    return None


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
