"""The port's serving plane (``repro_torch.serving.scheduler`` and
``repro_torch.serving.loadgen``) against the reference's
(``repro.serving.scheduler``, ``benchmarks/loadgen.py``) on the CPU.

* ``plan_batch`` and ``ServiceEstimator`` equal the reference's on many
  seeded queue states, and the admitted head makes the shed deadline;
* the port's ``SlaScheduler`` and the reference's, each driven by the same
  fake engine (tests/test_scheduler.py's, copied) and fake clock: the same
  dispatch sequence, shed and downgrade counts, events and ledger
  (``submitted == served + shed + queued + inflight`` at every turn);
* the port's scheduler on a CPU ``RecEngine`` against the reference's on a
  JAX ``RecEngine``, the same trace under a fake clock: the same
  decisions, and the probabilities within the tolerance below;
* ``loadgen``'s arrivals and request bodies equal the reference's for the
  same seeds.

Tolerances: decisions, counts, events and arrivals are exact (the same
numpy on the same floats); served probabilities against the JAX engine
atol=1e-5 (fp32 logits of O(1) through sigmoid, XLA and torch sum in other
orders; the downgrade path's int8 codes are the same on both sides); the
downgrade path against the primary within 0.05, the reference's bound.
"""
import time

import jax
import numpy as np
import pytest
import torch

from benchmarks import loadgen as j_loadgen
from repro import obs as j_obs
from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.serving import InflightBatch as JInflightBatch
from repro.serving import RecEngine as JRecEngine
from repro.serving import scheduler as j_sched
from repro_torch import obs
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.serving import (InflightBatch, RecEngine, RecRequest,
                                 ServiceEstimator, SlaPolicy, SlaScheduler,
                                 loadgen, plan_batch)
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving.rec_engine import _bucket

torch.set_num_threads(1)

MAX_L = 6
ATOL = 1e-5
DOWNGRADE_ATOL = 0.05


class FakeClock:
    """A monotonic clock the test advances by hand (seconds)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class FakeEngine:
    """The narrow engine surface ``SlaScheduler`` drives, with service
    time modeled on the fake clock (tests/test_scheduler.py's), built over
    one package's ``InflightBatch`` and ``Telemetry``."""

    layout = "ragged"

    def __init__(self, clock, inflight_cls, telemetry, service_s=0.004,
                 max_batch=8, buckets=(2, 8)):
        self.clock = clock
        self.inflight_cls = inflight_cls
        self.service_s = service_s
        self.max_batch = max_batch
        self.buckets = tuple(buckets)
        self.telemetry = telemetry
        self.source_version = 0
        self.downgrade_source = None
        self.dispatched = []            # [(rids tuple, downgraded)]

    def enable_downgrade(self):
        self.downgrade_source = object()
        return self.downgrade_source

    def dispatch(self, reqs, *, downgraded=False):
        self.dispatched.append((tuple(r.rid for r in reqs), downgraded))
        for r in reqs:
            r.downgraded = downgraded
        return self.inflight_cls(reqs=list(reqs), probs=None,
                                 bucket=_bucket(len(reqs), self.buckets),
                                 downgraded=downgraded,
                                 dispatched_mono=self.clock())

    def settle(self, ib):
        done = max(ib.dispatched_mono + self.service_s, self.clock())
        self.clock.t = done
        for r in ib.reqs:
            r.prob = 0.5
            r.finished_at = time.time()
        return len(ib.reqs)

    def _collect_pending(self):
        pass


# ---------------------------------------------------------------------------
# plan_batch and ServiceEstimator
# ---------------------------------------------------------------------------

def _policy_args(rng) -> dict:
    return dict(sla_ms=float(rng.integers(1, 101)),
                shed_margin=float(rng.choice([1.0, 1.5])),
                downgrade_margin=float(rng.choice([0.5, 0.7, 1.0])),
                allow_shed=bool(rng.integers(2)),
                allow_downgrade=bool(rng.integers(2)))


@pytest.mark.parametrize("seed", range(8))
def test_plan_batch_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(250):
        pol = _policy_args(rng)
        waits = sorted(rng.uniform(0, 200, rng.integers(0, 13)).tolist(),
                       reverse=True)       # FIFO: the head is the oldest
        kw = dict(slots=int(rng.integers(1, 9)),
                  est_full_ms=float(rng.uniform(0.5, 50)),
                  est_cheap_ms=float(rng.uniform(0.5, 50)),
                  inflight_ms=float(rng.choice([0.0, rng.uniform(0, 100)])))
        plan = plan_batch(waits, policy=SlaPolicy(**pol), **kw)
        want = j_sched.plan_batch(waits, policy=j_sched.SlaPolicy(**pol),
                                  **kw)
        assert (plan.shed, plan.serve, plan.downgraded, plan.predicted_ms) \
            == (want.shed, want.serve, want.downgraded, want.predicted_ms)
        deadline = pol["sla_ms"] * pol["shed_margin"]
        if pol["allow_shed"] and plan.serve > 0 \
                and pol["downgrade_margin"] <= pol["shed_margin"]:
            assert plan.predicted_ms <= deadline + 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_service_estimator_equals_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    default, alpha = float(rng.uniform(1, 10)), float(rng.uniform(0.1, 0.9))
    ours = ServiceEstimator(default_ms=default, alpha=alpha)
    theirs = j_sched.ServiceEstimator(default_ms=default, alpha=alpha)
    for _ in range(200):
        kind = str(rng.choice(["primary", "downgrade"]))
        bucket = int(rng.choice([1, 2, 4, 8, 16, 32]))
        if rng.random() < 0.4:
            ms = float(rng.uniform(0.1, 20))
            ours.observe(kind, bucket, ms)
            theirs.observe(kind, bucket, ms)
        assert ours.estimate(kind, bucket) == theirs.estimate(kind, bucket)


# ---------------------------------------------------------------------------
# the scheduler against the reference's, on the same fake engine
# ---------------------------------------------------------------------------

def _req(mod_request, rid, clock, n_tables=2):
    return mod_request(rid=rid, dense=np.zeros(2, np.float32),
                       sparse_ids=[np.zeros(1, np.int32)] * n_tables,
                       submitted_mono=clock())


def _events(tel) -> list:
    return [(e.kind, e.version, e.attrs) for e in tel.events.events]


SCHEDULE_CASES = [
    # (sla_ms, downgrade_margin, max_queue, allow_downgrade, seed)
    (2.0, 0.7, 16, True, 0), (20.0, 0.5, 16, True, 1),
    (20.0, 0.5, None, False, 2), (1000.0, 0.7, 4, True, 3),
    (8.0, 1.0, 32, True, 4), (12.0, 0.5, 8, True, 5)]


@pytest.mark.parametrize("sla,margin,max_queue,allow_down,seed",
                         SCHEDULE_CASES)
def test_scheduler_equals_the_reference_on_a_fake_engine(
        sla, margin, max_queue, allow_down, seed):
    from repro.serving import RecRequest as JRecRequest

    rng = np.random.default_rng(seed)
    bursts = rng.integers(0, 7, size=12).tolist()
    gaps = rng.uniform(0.0, 0.006, size=sum(bursts) + len(bursts)).tolist()
    runs = []
    for sched_mod, request, inflight, tel in (
            (t_sched, RecRequest, InflightBatch, obs.Telemetry()),
            (j_sched, JRecRequest, JInflightBatch, j_obs.Telemetry())):
        clock = FakeClock()
        eng = FakeEngine(clock, inflight, tel)
        sched = sched_mod.SlaScheduler(eng, sched_mod.SlaPolicy(
            sla_ms=sla, downgrade_margin=margin, max_queue=max_queue,
            allow_downgrade=allow_down, default_service_ms=4.0),
            clock=clock)
        sched.estimator.observe("primary", 8, 4.0)
        sched.estimator.observe("downgrade", 8, 2.0)
        ledger, reqs, g = [], [], iter(gaps)
        for burst in bursts:
            for _ in range(burst):
                r = _req(request, len(reqs), clock)
                reqs.append(r)
                sched.submit(r)
                clock.advance(next(g))
                ledger.append((sched.submitted, sched.served, sched.shed,
                               len(sched), sched.inflight))
            sched.pump()
            clock.advance(next(g))
            ledger.append((sched.submitted, sched.served, sched.shed,
                           len(sched), sched.inflight))
        drained = sched.drain()
        for sub, served, shed, queued, inflight_n in ledger:
            assert sub == served + shed + queued + inflight_n
        assert len(sched) == 0 and sched.inflight == 0
        assert sched.served + sched.shed == sched.submitted == len(reqs)
        assert sum(r.shed for r in reqs) == sched.shed == int(
            sched._c_shed.value) == len(tel.events.query("shed"))
        runs.append((eng.dispatched, ledger, drained, _events(tel),
                     (sched.submitted, sched.served, sched.shed,
                      sched.downgraded),
                     [(r.shed, r.downgraded, r.prob) for r in reqs],
                     sched._c_down.value, sched._c_refill.value))
    assert runs[0] == runs[1]


def test_scheduler_refuses_what_it_cannot_drive():
    clock = FakeClock()
    eng = FakeEngine(clock, InflightBatch, obs.Telemetry())
    with pytest.raises(ValueError, match="pipeline_depth"):
        SlaScheduler(eng, pipeline_depth=0, clock=clock)
    eng.layout = "fixed"
    with pytest.raises(ValueError, match="ragged"):
        SlaScheduler(eng, clock=clock)


# ---------------------------------------------------------------------------
# the scheduler on the real engines, under a fake clock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(0), J_CFG))


def _trace_bodies(cfg, n, seed):
    return (loadgen.zipf_requests(cfg, n, mean_l=3, max_l=MAX_L, seed=seed),
            j_loadgen.zipf_requests(J_CFG, n, mean_l=3, max_l=MAX_L,
                                    seed=seed))


@pytest.mark.parametrize("sla,rate,pipeline_depth", [
    (2.0, 8000.0, 1), (9.0, 2000.0, 2), (250.0, 2000.0, 2)])
def test_scheduler_on_the_cpu_engine_equals_the_reference(
        np_params, monkeypatch, sla, rate, pipeline_depth):
    """Both engines read ``time.monotonic`` for their stamps, so the fake
    clock stands in for it: every decision is then a function of the
    trace alone."""
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    t_reqs, j_reqs = _trace_bodies(CFG, 40, seed=5)
    arrivals = loadgen.poisson_arrivals(rate, 40, seed=6)
    kw = dict(source="ragged", max_l=MAX_L, max_batch=8, buckets=(2, 8))
    engines = (RecEngine(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                         device="cpu", **kw),
               JRecEngine(J_CFG, np_params, **kw))
    runs = []
    for eng, sched_mod, reqs in zip(engines, (t_sched, j_sched),
                                    (t_reqs, j_reqs)):
        clock.t = 1000.0
        sched = sched_mod.SlaScheduler(eng, sched_mod.SlaPolicy(
            sla_ms=sla, downgrade_margin=0.5, max_queue=16,
            default_service_ms=4.0), pipeline_depth=pipeline_depth,
            clock=clock)
        sched.warmup(calibrate=False)
        for b in (2, 8):
            sched.estimator.observe("primary", b, 4.0)
            sched.estimator.observe("downgrade", b, 2.0)
        t0 = clock()
        for t_arr, r in zip(arrivals, reqs):
            while clock() < t0 + t_arr:
                sched.pump()
                clock.advance(0.0005)
            r.submitted_mono = clock()
            sched.submit(r)
        sched.drain()
        assert sched.served + sched.shed == 40
        assert eng.telemetry.registry.counter(
            "rec_cold_compiles_total").value == 0
        runs.append((sched, [(r.shed, r.downgraded) for r in reqs],
                     _events(eng.telemetry), np.array(
                         [np.nan if r.prob is None else r.prob
                          for r in reqs])))
    (t_s, t_dec, t_ev, t_p), (j_s, j_dec, j_ev, j_p) = runs
    assert t_dec == j_dec
    assert [e[:2] for e in t_ev] == [e[:2] for e in j_ev]
    for a, b in zip(t_ev, j_ev):
        assert set(a[2]) == set(b[2])
    assert (t_s.served, t_s.shed, t_s.downgraded) == \
        (j_s.served, j_s.shed, j_s.downgraded)
    np.testing.assert_allclose(t_p, j_p, rtol=0, atol=ATOL)
    t_st, j_st = t_s.stats(), j_s.stats()
    for k in ("submitted", "served", "shed", "downgraded", "queued",
              "inflight", "shed_frac", "downgrade_frac", "n"):
        assert t_st[k] == j_st[k], k
    if sla == 2.0:                      # overload: both shed and downgrade
        assert t_s.shed and t_s.downgraded
    if sla == 250.0:                    # slack: full precision throughout
        assert not t_s.shed and not t_s.downgraded


def test_calibration_touches_no_counter(np_params):
    """``warmup(calibrate=True)`` times the warm pairs through
    ``RecEngine._serve_once``: the estimator learns both paths, and no
    counter, histogram, ring or request sees the probes."""
    eng = RecEngine(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                    device="cpu", source="cached", cache_k=16,
                    cache_trace=np.ones(t_dlrm.arena_spec(CFG).total_rows),
                    max_l=MAX_L, max_batch=8, buckets=(2, 8))
    sched = SlaScheduler(eng, SlaPolicy(sla_ms=50.0))
    sched.warmup(calibrate=True)
    assert {k for k in sched.estimator._ewma} == {
        (p, b) for p in ("primary", "downgrade") for b in (2, 8)}
    snap = eng.telemetry.registry.snapshot()
    assert all(v == 0 for v in snap["counters"].values())
    assert all(h["count"] == 0 for h in snap["histograms"].values())
    assert eng.batch_sizes == [] and eng.served == 0
    assert int(eng._hits) == 0 and eng._lookups == 0


def test_downgraded_batches_serve_within_the_int8_bound(np_params):
    eng = RecEngine(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                    device="cpu", source="ragged", max_l=MAX_L,
                    max_batch=8, buckets=(8,))
    eng.enable_downgrade()
    t_reqs, _ = _trace_bodies(CFG, 8, seed=9)
    eng.settle(eng.dispatch(t_reqs))
    full = [r.prob for r in t_reqs]
    eng.settle(eng.dispatch(t_reqs, downgraded=True))
    assert all(r.downgraded for r in t_reqs)
    np.testing.assert_allclose([r.prob for r in t_reqs], full, rtol=0,
                               atol=DOWNGRADE_ATOL)
    reg = eng.telemetry.registry
    assert reg.histogram("rec_service_ms",
                         labels={"path": "downgrade"}).count == 1


# ---------------------------------------------------------------------------
# loadgen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 17])
def test_arrivals_equal_the_reference(seed):
    np.testing.assert_array_equal(
        loadgen.poisson_arrivals(1234.5, 300, seed=seed),
        j_loadgen.poisson_arrivals(1234.5, 300, seed=seed))
    np.testing.assert_array_equal(
        loadgen.diurnal_arrivals(600.0, 1500.0, 0.2, 300, seed=seed),
        j_loadgen.diurnal_arrivals(600.0, 1500.0, 0.2, 300, seed=seed))


@pytest.mark.parametrize("kind,drift", [("poisson", 0), ("diurnal", 5)])
def test_traces_equal_the_reference(kind, drift):
    kw = dict(kind=kind, rate_qps=800.0, peak_ratio=2.5, period_s=0.1,
              mean_l=3, max_l=MAX_L, drift_per_chunk=drift, seed=17)
    ours = loadgen.make_trace(CFG, 150, **kw)
    theirs = j_loadgen.make_trace(J_CFG, 150, **kw)
    assert isinstance(ours.requests[0], RecRequest)
    np.testing.assert_array_equal(ours.arrivals_s, theirs.arrivals_s)
    assert ours.offered_qps == theirs.offered_qps
    assert ours.duration_s == theirs.duration_s
    for a, b in zip(ours.requests, theirs.requests):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.dense, b.dense)
        assert len(a.sparse_ids) == len(b.sparse_ids) == CFG.n_tables
        for x, y in zip(a.sparse_ids, b.sparse_ids):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_replay_submits_at_the_arrivals_and_pumps_between():
    clock = FakeClock()
    trace = loadgen.make_trace(CFG, 20, rate_qps=1000.0, mean_l=3,
                               max_l=MAX_L, seed=3)
    submitted, pumps = [], []

    def pump():
        pumps.append(clock())
        clock.advance(0.0002)

    elapsed = loadgen.replay(trace, lambda r: submitted.append(
        (r.rid, r.submitted_mono)), pump, clock=clock)
    assert [rid for rid, _ in submitted] == list(range(20))
    for (_, stamp), t_arr in zip(submitted, trace.arrivals_s):
        assert 1000.0 + t_arr <= stamp < 1000.0 + t_arr + 0.0002 + 1e-9
    assert pumps and elapsed == pytest.approx(submitted[-1][1] - 1000.0)
    with pytest.raises(ValueError, match="unknown arrival kind"):
        loadgen.make_trace(CFG, 4, kind="burst")
