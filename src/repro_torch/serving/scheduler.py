"""SLA-aware continuous batching for the recommendation engine.

The synchronous serve loop (``RecEngine.step``) releases lockstep
waves: admit, pad, forward, respond — the host idles while the device
computes and vice versa, and under overload the queue (and p99) grows
without bound because every arriving request is eventually served, no
matter how stale. This module is the ROADMAP's serving plane:

* ``plan_batch`` — the admission decision as a PURE function of
  (queue waits, SLA policy, service estimates): shed the hopeless
  prefix, downgrade the batch to the int8 source when the
  full-precision path would blow the SLA, serve the rest. Pure means
  hypothesis-testable: same inputs, same plan, every time.
* ``ServiceEstimator`` — deterministic EWMA service-time model per
  (path, bucket), corrected by every settled batch.
* ``SlaScheduler`` — the continuous-batching loop itself: a FIFO
  admission queue, a pipeline of in-flight (dispatched, unsettled)
  ``InflightBatch``es so the next micro-batch is assembled while the
  previous one computes (refill, no wave barrier), and shed/downgrade
  decisions from ``plan_batch`` at every ``pump()``.

Overload behavior is explicit, not emergent: a request that cannot
make its deadline even on the cheapest path is shed AT ADMISSION — it
never touches the device, and a ``shed`` event accounts for it; a
batch whose full-precision prediction crosses the downgrade margin
serves from the engine's int8 source (``RecEngine.enable_downgrade``)
— the same serve step over another source, whose graphs the warm pool
captured, so per-batch path selection never recaptures.

The per-slot machinery (dispatch/settle futures + a wait-ordered
queue) is deliberately engine-shape-agnostic so ``DecodeEngine``'s
aligned-wave loop can adopt it next.

The port's copy of ``repro.serving.scheduler``: the planner and the
estimator are the reference's numpy, decision for decision. On the card
every dispatch replays the (path, bucket) pair's captured CUDA graph,
and ``warmup(calibrate=True)`` times replays of the warm graphs.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Sequence

import numpy as np

from repro_torch.serving.rec_engine import (InflightBatch, RecEngine,
                                            RecRequest, _bucket)

__all__ = ["BatchPlan", "ServiceEstimator", "SlaPolicy", "SlaScheduler",
           "plan_batch"]


@dataclass(frozen=True)
class SlaPolicy:
    """The serving SLA contract the scheduler enforces.

    * ``sla_ms`` — the p99 latency target.
    * ``shed_margin`` — shed a request once even the cheapest available
      path would land it past ``sla_ms * shed_margin`` (1.0 = shed at
      the SLA itself; >1 tolerates a grace band).
    * ``downgrade_margin`` — serve the batch on the int8 path once the
      full-precision prediction crosses ``sla_ms * downgrade_margin``.
      Keep it <= ``shed_margin``: downgrade is the escape hatch BEFORE
      shedding, and the planner's admitted-head-makes-the-deadline
      invariant is only guaranteed under that ordering.
    * ``max_queue`` — hard admission cap: beyond this depth ``submit``
      sheds immediately (None = unbounded, deadline shedding only).
    * ``default_service_ms`` — the estimator's cold-start prior; until a
      batch settles, plans assume this per-batch service time.
    """
    sla_ms: float = 50.0
    shed_margin: float = 1.0
    downgrade_margin: float = 0.7
    allow_shed: bool = True
    allow_downgrade: bool = True
    max_queue: Optional[int] = None
    default_service_ms: float = 5.0


@dataclass(frozen=True)
class BatchPlan:
    """One admission decision: drop ``shed`` requests from the queue
    head, dispatch the next ``serve`` (on the downgrade path when
    ``downgraded``). ``predicted_ms`` is the planned completion latency
    of the admitted head (0.0 when nothing is served)."""
    shed: int
    serve: int
    downgraded: bool
    predicted_ms: float


def plan_batch(waits_ms: Sequence[float], *, slots: int,
               policy: SlaPolicy, est_full_ms: float,
               est_cheap_ms: float, inflight_ms: float = 0.0) -> BatchPlan:
    """Decide one dispatch from the queue head — a pure function.

    ``waits_ms`` is the FIFO queue's per-request wait, head (oldest)
    first — non-increasing by construction. ``inflight_ms`` is the
    estimated device time still owed to already-dispatched batches (the
    new batch queues behind them). Decisions, in order:

    1. SHED the head prefix that cannot make ``sla_ms * shed_margin``
       even on the cheapest path (waits only grow between here and the
       device). Non-increasing waits mean the hopeless requests are
       exactly a prefix, so shedding never reorders FIFO.
    2. SERVE the next ``min(slots, remaining)`` requests.
    3. DOWNGRADE the batch to the int8 path when the admitted head's
       full-precision prediction crosses ``sla_ms * downgrade_margin``
       (and the estimator says the cheap path actually is cheaper).

    Deterministic given (queue state, policy, estimates): no clocks, no
    randomness — the hypothesis property the tests pin. When
    ``allow_shed`` and ``downgrade_margin <= shed_margin``, the
    admitted head's ``predicted_ms`` never exceeds the shed deadline.
    """
    deadline = policy.sla_ms * policy.shed_margin
    cheapest = (min(est_full_ms, est_cheap_ms) if policy.allow_downgrade
                else est_full_ms)
    n = len(waits_ms)
    shed = 0
    if policy.allow_shed:
        while shed < n and \
                waits_ms[shed] + inflight_ms + cheapest > deadline:
            shed += 1
    serve = min(int(slots), n - shed)
    if serve <= 0:
        return BatchPlan(shed=shed, serve=0, downgraded=False,
                         predicted_ms=0.0)
    head = waits_ms[shed]
    downgraded = bool(
        policy.allow_downgrade and est_cheap_ms < est_full_ms
        and head + inflight_ms + est_full_ms
        > policy.sla_ms * policy.downgrade_margin)
    predicted = head + inflight_ms + (est_cheap_ms if downgraded
                                      else est_full_ms)
    return BatchPlan(shed=shed, serve=serve, downgraded=downgraded,
                     predicted_ms=predicted)


class ServiceEstimator:
    """Deterministic EWMA service-time model per (path kind, bucket).

    Unobserved pairs fall back, in order: the nearest observed bucket
    on the same path (bucket cost is mostly fixed overhead at serving
    batch sizes, so no rescaling); an unobserved ``downgrade`` path
    borrows the primary estimate (the safe, conservative prior — the
    planner then only downgrades once a real settle shows the int8
    path cheaper); a cold estimator returns ``default_ms``.
    """

    def __init__(self, default_ms: float = 5.0, alpha: float = 0.25):
        self.default_ms = float(default_ms)
        self.alpha = float(alpha)
        self._ewma: Dict[tuple, float] = {}

    def observe(self, kind: str, bucket: int, ms: float) -> None:
        key = (kind, int(bucket))
        prev = self._ewma.get(key)
        self._ewma[key] = float(ms) if prev is None \
            else (1.0 - self.alpha) * prev + self.alpha * float(ms)

    def estimate(self, kind: str, bucket: int) -> float:
        key = (kind, int(bucket))
        if key in self._ewma:
            return self._ewma[key]
        same = [(abs(b - bucket), b) for k, b in self._ewma if k == kind]
        if same:
            return self._ewma[(kind, min(same)[1])]
        if kind == "downgrade":
            return self.estimate("primary", bucket)
        return self.default_ms


class SlaScheduler:
    """Continuous-batching admission in front of a ``RecEngine``.

    ``submit`` enqueues FIFO (or sheds on the hard queue cap); ``pump``
    is one scheduling turn — settle in-flight batches past
    ``pipeline_depth``, plan against the live queue, dispatch at most
    one micro-batch; ``drain`` settles and serves everything left (the
    end-of-stream flush — deadline shedding still applies). Invariant
    at every point: ``submitted == served + shed + queued + inflight``.

    Telemetry rides the engine's bundle: counters ``rec_shed_total`` /
    ``rec_downgraded_total`` / ``rec_refills_total``, the shared
    ``rec_queue_depth`` gauge, and ``shed`` / ``downgrade`` / ``drain``
    events — every shed request is accounted for by exactly one event.
    """

    def __init__(self, engine: RecEngine,
                 policy: Optional[SlaPolicy] = None, *,
                 pipeline_depth: int = 2,
                 estimator: Optional[ServiceEstimator] = None,
                 clock: Callable[[], float] = time.monotonic):
        policy = policy if policy is not None else SlaPolicy()
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth {pipeline_depth} < 1")
        if engine.layout == "fixed":
            raise ValueError(
                "continuous batching serves the ragged production path")
        self.engine = engine
        self.policy = policy
        self.pipeline_depth = pipeline_depth
        self.telemetry = engine.telemetry
        self._clock = clock
        self.estimator = (estimator if estimator is not None
                          else ServiceEstimator(
                              default_ms=policy.default_service_ms))
        if policy.allow_downgrade:
            engine.enable_downgrade()
        reg = self.telemetry.registry
        self._c_shed = reg.counter(
            "rec_shed_total", "requests shed at admission (SLA)")
        self._c_down = reg.counter(
            "rec_downgraded_total",
            "requests served on the int8 downgrade path")
        self._c_refill = reg.counter(
            "rec_refills_total",
            "micro-batches dispatched while another was in flight")
        self._g_queue = reg.gauge(
            "rec_queue_depth",
            "admission-queue depth (set on enqueue "
            "and after every serve/drain)")
        self._queue: Deque[RecRequest] = deque()
        self._inflight: Deque[InflightBatch] = deque()
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.downgraded = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def inflight(self) -> int:
        """Requests dispatched but not yet settled."""
        return sum(len(ib.reqs) for ib in self._inflight)

    def warmup(self, calibrate: bool = True) -> None:
        """Capture every (path, bucket) pair's graph off the SLA clock —
        with downgrade enabled this covers BOTH sources per bucket, so
        refill never stalls on a capture.

        ``calibrate`` additionally times each warmed (path, bucket)
        pair (already captured, so these are honest execution samples:
        on the card a replay of its graph on a dummy micro-batch, waited
        for) and seeds the estimator — without it the planner would sit
        on the cold-start prior, and in particular could never discover
        the int8 path is cheaper until it had already downgraded once.
        The probes bypass dispatch/settle (``RecEngine._serve_once``), so
        none of the engine's serving counters or histograms see warmup
        traffic.
        """
        eng = self.engine
        eng.warmup()
        if not calibrate:
            return
        dummy = eng._dummy()
        kinds = ("primary",) + (("downgrade",)
                                if eng.downgrade_source is not None else ())
        for bucket in eng.buckets:
            samples = {kind: [] for kind in kinds}
            for _ in range(3):          # interleaved: share clock drift
                for kind in kinds:
                    t0 = self._clock()
                    eng._serve_once(kind, bucket, dummy)
                    samples[kind].append((self._clock() - t0) * 1e3)
            for kind, ms in samples.items():
                self.estimator.observe(kind, bucket,
                                       float(np.median(ms)))

    # -- admission ----------------------------------------------------------

    def submit(self, req: RecRequest) -> bool:
        """Enqueue FIFO; returns False when the hard queue cap shed it."""
        self.submitted += 1
        if self.policy.max_queue is not None and self.policy.allow_shed \
                and len(self._queue) >= self.policy.max_queue:
            self._shed_one(req, reason="queue_full")
            return False
        self._queue.append(req)
        if self.telemetry.enabled:
            self._g_queue.set(len(self._queue))
        return True

    def _shed_one(self, req: RecRequest, reason: str) -> None:
        req.shed = True
        req.finished_at = time.time()
        self.shed += 1
        if self.telemetry.enabled:
            self._c_shed.inc()
        self.telemetry.emit(
            "shed", version=self.engine.source_version, rid=req.rid,
            reason=reason,
            waited_ms=(self._clock() - req.submitted_mono) * 1e3)

    # -- the scheduling turn ------------------------------------------------

    def _plan(self) -> BatchPlan:
        now = self._clock()
        waits = [(now - r.submitted_mono) * 1e3 for r in self._queue]
        slots = self.engine.max_batch
        bucket = _bucket(min(len(waits), slots), self.engine.buckets)
        est_full = self.estimator.estimate("primary", bucket)
        est_cheap = (self.estimator.estimate("downgrade", bucket)
                     if self.policy.allow_downgrade else est_full)
        inflight_ms = 0.0
        for ib in self._inflight:
            kind = "downgrade" if ib.downgraded else "primary"
            est = self.estimator.estimate(kind, ib.bucket)
            inflight_ms += max(
                0.0, est - (now - ib.dispatched_mono) * 1e3)
        return plan_batch(waits, slots=slots, policy=self.policy,
                          est_full_ms=est_full, est_cheap_ms=est_cheap,
                          inflight_ms=inflight_ms)

    def _apply(self, plan: BatchPlan) -> None:
        for _ in range(plan.shed):
            self._shed_one(self._queue.popleft(), reason="deadline")
        if plan.serve > 0:
            reqs = [self._queue.popleft() for _ in range(plan.serve)]
            if plan.downgraded:
                self.downgraded += plan.serve
                if self.telemetry.enabled:
                    self._c_down.inc(plan.serve)
                self.telemetry.emit(
                    "downgrade", version=self.engine.source_version,
                    n=plan.serve, rid0=reqs[0].rid,
                    predicted_ms=plan.predicted_ms)
            if self._inflight and self.telemetry.enabled:
                self._c_refill.inc()
            self._inflight.append(
                self.engine.dispatch(reqs, downgraded=plan.downgraded))
        if self.telemetry.enabled:
            self._g_queue.set(len(self._queue))

    def _settle_one(self) -> int:
        ib = self._inflight.popleft()
        n = self.engine.settle(ib)
        self.served += n
        self.estimator.observe(
            "downgrade" if ib.downgraded else "primary", ib.bucket,
            (self._clock() - ib.dispatched_mono) * 1e3)
        return n

    def pump(self) -> int:
        """One scheduling turn; returns requests settled this turn.

        Settles any batch past the pipeline depth (its device work
        finished while newer batches were assembled), then plans and
        dispatches at most one refill micro-batch. Idle turns (empty
        queue) settle one in-flight batch early so responses never wait
        for the next arrival.
        """
        settled = 0
        while len(self._inflight) >= self.pipeline_depth:
            settled += self._settle_one()
        if self._queue:
            self._apply(self._plan())
        elif self._inflight:
            settled += self._settle_one()
        return settled

    def drain(self) -> int:
        """Settle every in-flight batch and serve the remaining queue;
        emits the final ``drain`` event. Returns requests served here."""
        n = 0
        while self._queue or self._inflight:
            if self._queue:
                self._apply(self._plan())
            if self._inflight:
                n += self._settle_one()
        if self.telemetry.enabled:
            self._g_queue.set(0)
        self.telemetry.emit(
            "drain", version=self.engine.source_version,
            served=self.served, shed=self.shed,
            downgraded=self.downgraded)
        return n

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict:
        """Engine latency stats plus the scheduler's admission ledger
        (shed/downgrade fractions are of all submitted requests)."""
        out = dict(self.engine.stats())
        denom = self.submitted or 1
        out.update(
            submitted=self.submitted, served=self.served,
            shed=self.shed, downgraded=self.downgraded,
            queued=len(self._queue), inflight=self.inflight,
            shed_frac=self.shed / denom,
            downgrade_frac=self.downgraded / denom)
        if self.telemetry.enabled:
            qw = self.telemetry.registry.histogram(
                "rec_queue_wait_ms",
                "admission-to-dispatch queue wait")
            if qw.count:
                out["queue_wait_p50_ms"] = qw.percentile(50)
                out["queue_wait_p99_ms"] = qw.percentile(99)
        return out
