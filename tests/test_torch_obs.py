"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs`` on the same inputs, and its wiring through the port's
``RecEngine``, host store and ``OnlineTrainer`` against the JAX ones.

Mirrors tests/test_obs.py where it applies:

* histograms: the three percentile views, ``fraction_leq``, the summary,
  the snapshot and the exposition text equal the reference's exactly; the
  vectorised ``record_many`` leaves the state of sequential ``record``
  calls (counts, window counts, ring, ring position, count, total), a
  wrap of the ring included;
* tracing: nesting, pre-timed spans, the bounds on spans and events,
  ``hit_rate_by_version``, the shared null context when disabled;
* the engine: ``stats()`` keys and windows, swap, stale and retune events,
  the spans of one micro-batch, ``Telemetry.disabled()``, the live Fig-5
  mode and its refusals, the cumulative percentiles past the ring (the
  repair of the port's ring-only p99);
* the trainer's counters, gauges and events against the reference
  trainer's on the same batches.

Tolerances:
  * histogram numbers, exposition text, events and counters: exact (the
    same numpy on the same floats);
  * engine probabilities against the JAX engine: atol=1e-5 (fp32 logits of
    O(1) through sigmoid, XLA and torch sum in other orders);
  * hit counts against the JAX engine: rtol=1e-6 (it folds each batch in
    as a float32 rate times its lookups; the port counts integers, held
    exactly against a numpy recount);
  * the staged forward against the fused one, in the port: exact (the
    same eager ops, split at the stage boundaries); against the
    reference's stages: atol=1e-5 as above;
  * trainer losses against the JAX trainer: rtol=1e-5, as
    tests/test_torch_online_cache.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.configs.dlrm import DLRM_HET_SMOKE as J_HET
from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.data import DLRMSynthetic
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro.training import OnlineCacheConfig as JCacheConfig
from repro.training import OnlineTrainer as JOnlineTrainer
from repro_torch import obs
from repro_torch.configs.dlrm import DLRM_HET_SMOKE as HET
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.tracing import _NULL, Tracer
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.storage import TierPolicy
from repro_torch.training import OnlineCacheConfig, OnlineTrainer

torch.set_num_threads(1)

MAX_L = 6
K = 32
ATOL = 1e-5
HIT_RTOL = 1e-6
LOSS_RTOL = 1e-5


# ---------------------------------------------------------------------------
# histograms, against the reference's on the same samples
# ---------------------------------------------------------------------------

def _samples(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.lognormal(mean=1.0, sigma=1.2, size=n)


def _pair(**kw):
    return Histogram("h", "help", **kw), j_obs.Histogram("h", "help", **kw)


def _state(h) -> tuple:
    return (h._counts.tolist(), h._window_counts.tolist(), h._ring.tolist(),
            h._ring_pos, h.count, h.window_count, h.total)


# (samples, ring, growth): inside the ring, past it, and values outside
# [lo, hi] that clamp into the edge buckets
HIST_CASES = [(500, 2048, 1.08), (5000, 64, 1.08), (300, 32, 1.25),
              (4200, 4096, 1.08)]


@pytest.mark.parametrize("n,ring,growth", HIST_CASES)
def test_histogram_views_equal_the_reference(n, ring, growth):
    vals = _samples(n, n)
    vals[::97] *= 1e9                  # above hi: the last bucket
    vals[::89] *= 1e-9                 # below lo: the first bucket
    t, j = _pair(ring=ring, growth=growth)
    for v in vals[:n // 2]:
        t.record(v)
        j.record(v)
    t.reset_window()
    j.reset_window()
    for v in vals[n // 2:]:
        t.record(v)
        j.record(v)
    assert _state(t) == _state(j)
    for window in ("cumulative", "window", "rolling"):
        for q in (0, 1, 50, 90, 95, 99, 99.9, 100):
            assert t.percentile(q, window) == j.percentile(q, window)
        for cut in (0.5, 2.0, 3.7, 50.0, 1e12):
            assert t.fraction_leq(cut, window) == j.fraction_leq(cut, window)
    assert t.summary() == j.summary()
    assert t.ring_values().tolist() == j.ring_values().tolist()
    if n <= ring:                      # exact while the stream fits the ring
        assert t.percentile(99) == float(np.percentile(vals, 99))


def test_histogram_refuses_an_unknown_window():
    with pytest.raises(ValueError, match="unknown percentile window"):
        Histogram("h").percentile(50, "daily")


# (samples before, batch, ring): empty, inside, exactly a ring, past the
# ring's end (a wrap), longer than the ring, into a full ring
RECORD_MANY_CASES = [(0, 0, 8), (0, 5, 8), (3, 5, 8), (0, 8, 8), (6, 5, 8),
                     (5, 20, 8), (1, 17, 8), (4090, 32, 4096),
                     (4100, 32, 4096)]


@pytest.mark.parametrize("before,n,ring", RECORD_MANY_CASES)
def test_record_many_equals_sequential_records(before, n, ring):
    vals = _samples(before + n, before + n)
    seq, vec = Histogram("h", ring=ring), Histogram("h", ring=ring)
    ref = j_obs.Histogram("h", ring=ring)
    for v in vals[:before]:
        seq.record(v)
        vec.record(v)
        ref.record(v)
    vec.record_many(vals[before:])
    for v in vals[before:]:
        seq.record(v)
        ref.record(v)
    assert _state(vec) == _state(seq) == _state(ref)


def test_record_many_adds_the_total_in_order():
    """np.sum would group these; sequential records add left to right."""
    vals = np.array([1e16, 1.0, -1e16, 1.0] * 3)
    seq, vec = Histogram("h", ring=4), Histogram("h", ring=4)
    for v in vals:
        seq.record(v)
    vec.record_many(vals)
    assert vec.total == seq.total == 1.0


def _registry(mod, seed: int):
    reg = mod.MetricsRegistry()
    reg.counter("req_total", "requests", {"path": "cached"}).inc(3)
    reg.counter("req_total", "requests", {"path": "fp"}).inc(2.5)
    reg.gauge("ver", "version").set(2)
    reg.gauge("depth").set(0.125)
    h = reg.histogram("lat_ms", "latency", lo=1.0, hi=100.0, growth=2.0,
                      ring=8)
    for v in _samples(seed, 20):
        h.record(v)
    s = reg.histogram("stage_ms", labels={"stage": "mlp"})
    s.record(1.5)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_exposition_equal_the_reference(seed):
    t, j = _registry(obs, seed), _registry(j_obs, seed)
    assert t.exposition() == j.exposition()
    assert t.snapshot() == j.snapshot()
    assert json.loads(json.dumps(t.snapshot())) == t.snapshot()
    assert set(t.histograms("stage_ms")) == {'stage_ms{stage="mlp"}'}


def test_exposition_golden():
    """tests/test_obs.py's golden text, from the port."""
    reg = MetricsRegistry()
    reg.counter("req_total", "requests", {"path": "cached"}).inc(3)
    reg.gauge("ver", "version").set(2)
    h = reg.histogram("lat_ms", "latency", lo=1.0, hi=100.0, growth=2.0,
                      ring=8)
    for v in (1.0, 2.0, 4.0):
        h.record(v)
    assert reg.exposition() == """\
# HELP req_total requests
# TYPE req_total counter
req_total{path="cached"} 3
# HELP ver version
# TYPE ver gauge
ver 2
# HELP lat_ms latency
# TYPE lat_ms summary
lat_ms{quantile="0.5"} 2
lat_ms{quantile="0.95"} 3.8
lat_ms{quantile="0.99"} 3.96
lat_ms_sum 7
lat_ms_count 3
"""


def test_counter_is_monotone_and_registry_gets_or_creates():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5 and reg.counter("c") is c
    with pytest.raises(AssertionError):
        c.inc(-1)
    a = reg.histogram("stage_ms", labels={"stage": "emb"})
    assert a is reg.histogram("stage_ms", labels={"stage": "emb"})
    assert a is not reg.histogram("stage_ms", labels={"stage": "mlp"})


# ---------------------------------------------------------------------------
# tracing and events
# ---------------------------------------------------------------------------

def _tree(tracer) -> list:
    ids = {s.span_id: i for i, s in enumerate(tracer.spans())}
    return [(s.name, s.trace_id, ids.get(s.parent_id), s.attrs)
            for s in tracer.spans()]


def _traced(mod):
    tr = mod.Tracer(max_spans=6)
    with tr.span("outer", {"k": 1}):
        with tr.span("inner"):
            pass
        tr.record("pre", 1.0, 2.0)
        with tr.span("inner2"):
            pass
    with tr.span("next"):
        pass
    for _ in range(3):
        with tr.span("s"):
            pass
    return tr


def test_span_nesting_and_bound_equal_the_reference():
    t, j = _traced(obs), _traced(j_obs)
    assert _tree(t) == _tree(j)
    # finish order inner, pre, inner2, outer, next, s, s, s; the bound
    # drops the oldest two
    assert [s.name for s in t.spans()] == ["inner2", "outer", "next", "s",
                                           "s", "s"]
    full = obs.Tracer()
    with full.span("outer"):
        with full.span("inner"):
            pass
        pre = full.record("pre", 1.0, 2.0)
    inner, outer = full.spans("inner")[0], full.spans("outer")[0]
    assert inner.parent_id == pre.parent_id == outer.span_id
    assert pre.duration_ms == pytest.approx(1000.0)
    assert set(full.traces()) == {outer.trace_id}


def _events(mod):
    log = mod.EventLog(max_events=5)
    log.emit("source_swap", version=2, prev_version=1, hits=30.0,
             lookups=40.0)
    log.emit("cache_swap", version=3, prev_version=2, hits=0.0,
             lookups=0.0)
    log.emit("hot_cache_rebuild", version=3, k=64)
    log.emit("cache_swap", version=4, prev_version=3, hits=7.0,
             lookups=9.0)
    return log


def test_event_log_and_hit_rate_by_version_equal_the_reference():
    t, j = _events(obs), _events(j_obs)
    assert t.hit_rate_by_version() == j.hit_rate_by_version() == {
        1: 0.75, 2: None, 3: 7.0 / 9.0}
    assert [(e.kind, e.version, e.attrs) for e in t.query("cache_swap")] \
        == [(e.kind, e.version, e.attrs) for e in j.query("cache_swap")]
    assert t.query(version=3)[0].kind == "cache_swap"
    for line in t.to_jsonl().splitlines():
        json.loads(line)
    bounded = obs.EventLog(max_events=4)
    for i in range(10):
        bounded.emit("publish", version=i)
    assert len(bounded) == 4
    assert [e.version for e in bounded.events] == [6, 7, 8, 9]


def test_disabled_tracer_and_stage_return_the_shared_null():
    tr = Tracer(enabled=False)
    assert tr.span("x") is tr.span("y") is _NULL
    assert tr.record("x", 0.0, 1.0) is None and not tr.spans()
    assert not obs.stage_annotations_enabled()
    assert obs.stage("sparse_lookup") is obs.stage("mlp") is _NULL
    assert obs.step_annotation(3) is _NULL
    tel = obs.Telemetry.disabled()
    assert tel.span("x") is _NULL and tel.emit("publish") is None
    assert not tel.device_stages
    assert not obs.Telemetry(metrics=False, device_stages=True).device_stages
    assert obs.__all__ == j_obs.__all__


def test_stage_annotations_name_the_stages_and_change_no_result():
    """On, ``stage`` opens a record_function the profiler sees by name;
    the forward's result is the same bits either way."""
    params = t_dlrm.init(torch.Generator().manual_seed(0), CFG,
                         device="cpu")
    batch = _t_batch(_rb(4, seed=2))
    step = t_dlrm.make_ragged_serve_step(CFG, max_l=MAX_L)
    off = step(params, batch)
    obs.enable_stage_annotations(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = step(params, batch)
            with obs.step_annotation(7):
                pass
    finally:
        obs.enable_stage_annotations(False)
    names = {e.key for e in prof.key_averages()}
    assert {"sparse_lookup", "emb_lookup", "interaction", "mlp",
            "serve_step#7"} <= names
    assert torch.equal(on, off)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(0), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


def _rb(n, seed=9):
    return DLRMSynthetic(J_CFG, seed=seed).ragged_batch(
        n, dist="poisson", mean_l=3, max_l=MAX_L)


def _t_batch(rb) -> dict:
    return {k: torch.from_numpy(np.asarray(rb[k]))
            for k in ("dense", "indices", "offsets")}


@pytest.fixture(scope="module")
def counts():
    rb = _rb(8)
    return se.trace_row_counts(t_dlrm.arena_spec(CFG), rb["indices"],
                               rb["offsets"])


def _kw(source, counts):
    kw = {"source": source, "max_l": MAX_L, "max_batch": 4,
          "max_wait_ms": 0.0, "buckets": (4,)}
    if source == "cached":
        kw.update(cache_k=K, cache_trace=counts)
    return kw


def _engines(np_params, params, counts, source="cached", j_tel=None,
             t_tel=None):
    kw = _kw(source, counts)
    return (JRecEngine(J_CFG, np_params, telemetry=j_tel, **kw),
            RecEngine(CFG, params, telemetry=t_tel, device="cpu", **kw))


def _serve(engine, requests, rb):
    reqs = requests(rb, engine.cfg.n_tables, rid0=engine.served)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    return reqs


def _probs(reqs) -> np.ndarray:
    return np.array([r.prob for r in reqs])


def _recount(engine, rb) -> tuple:
    """Hits and lookups of the served ids against the engine's live cache,
    in numpy."""
    spec = engine.spec
    off = rb["offsets"]
    seg = np.searchsorted(off[1:], np.arange(off[-1]), side="right")
    flat = rb["indices"][:off[-1]] + (seg % spec.n_tables) \
        * spec.rows_per_table
    return int((engine.cache.slot_of.numpy()[flat] < K).sum()), flat.size


STATS_KEYS = ("n", "path", "source", "source_tree", "p50_ms", "p95_ms",
              "p99_ms", "mean_ms", "cache_hit_rate", "cache_version",
              "buckets", "since_swap", "rolling")


@pytest.mark.parametrize("source", ["cached", "ragged"])
def test_engine_stats_keys_and_windows_match_the_reference(np_params, params,
                                                           counts, source):
    j_eng, t_eng = _engines(np_params, params, counts, source)
    rb = _rb(8)
    np.testing.assert_allclose(_probs(_serve(t_eng, t_requests, rb)),
                               _probs(_serve(j_eng, j_requests, rb)),
                               rtol=0, atol=ATOL)
    j_st, t_st = j_eng.stats(), t_eng.stats()
    want = set(STATS_KEYS) - ({"cache_version"} if source == "ragged"
                              else set())
    assert set(t_st) == set(j_st) == want
    for k in ("n", "path", "source", "source_tree", "buckets"):
        assert t_st[k] == j_st[k], k
    assert t_st["n"] == t_st["since_swap"]["n"] == t_st["rolling"]["n"] == 8
    # exact while the ring holds the stream
    lat = np.asarray(t_eng.latencies) * 1e3
    assert t_st["p50_ms"] == float(np.percentile(lat, 50))
    assert t_st["p99_ms"] == t_st["rolling"]["p99_ms"]
    assert t_eng.batch_sizes == j_eng.batch_sizes == [4, 4]
    reg, j_reg = t_eng.telemetry.registry, j_eng.telemetry.registry
    for name in ("rec_requests_total", "rec_batches_total",
                 "rec_source_swaps_total", "rec_stale_rejected_total",
                 "rec_cold_compiles_total"):
        assert reg.counter(name).value == j_reg.counter(name).value, name
    for name in ("rec_source_version", "rec_queue_depth"):
        assert reg.gauge(name).value == j_reg.gauge(name).value, name
    assert t_eng._qwait_hist.count == j_eng._qwait_hist.count == 8
    assert t_eng._batch_hist.summary() == j_eng._batch_hist.summary()
    if source == "ragged":
        assert t_st["cache_hit_rate"] is j_st["cache_hit_rate"] is None


def test_swap_events_attribute_the_outgoing_version(np_params, params,
                                                    counts):
    j_eng, t_eng = _engines(np_params, params, counts)
    rb, rb2 = _rb(8), _rb(4, seed=4)
    _serve(j_eng, j_requests, rb)
    _serve(t_eng, t_requests, rb)
    hits, lookups = _recount(t_eng, rb)
    fresh = se.trace_row_counts(t_eng.spec, rb2["indices"], rb2["offsets"])
    t_eng.update_cache(se.build_hot_cache(params["arena"], t_eng.spec,
                                          fresh, K), version=1)
    j_eng.update_cache(j_se.build_hot_cache(jnp.asarray(np_params["arena"]),
                                            j_eng.spec, fresh, K), version=1)
    (t_ev,), (j_ev,) = (e.telemetry.events.query("cache_swap")
                        for e in (t_eng, j_eng))
    assert (t_ev.version, t_ev.attrs["prev_version"]) == (1, 0)
    assert (t_ev.attrs["hits"], t_ev.attrs["lookups"]) == (hits, lookups)
    assert t_ev.attrs["lookups"] == j_ev.attrs["lookups"]
    np.testing.assert_allclose(t_ev.attrs["hits"], j_ev.attrs["hits"],
                               rtol=HIT_RTOL)
    rates = t_eng.telemetry.events.hit_rate_by_version()
    assert rates == {0: hits / lookups}
    # counters reset with the version; the since-swap window restarts
    st = t_eng.stats()
    assert st["since_swap"]["n"] == 0 and st["n"] == 8
    assert st["cache_hit_rate"] is None
    _serve(t_eng, t_requests, rb2)
    st = t_eng.stats()
    assert st["since_swap"]["n"] == 4 and st["n"] == 12
    assert st["rolling"]["n"] == 12
    assert st["cache_hit_rate"] == _recount(t_eng, rb2)[0] / \
        _recount(t_eng, rb2)[1]
    # a republish of the same version: an event, no reset, no attribution
    t_eng.update_source(t_eng.source, version=1)
    (rep,) = [e for e in t_eng.telemetry.events.query("source_swap")]
    assert rep.attrs == {"republish": True}
    assert t_eng.stats()["since_swap"]["n"] == 4
    reg = t_eng.telemetry.registry
    assert reg.counter("rec_source_swaps_total").value == 1
    assert reg.gauge("rec_source_version").value == 1
    snap = json.loads(json.dumps(t_eng.telemetry.snapshot(), default=str))
    assert snap["hit_rate_by_version"]["0"] == pytest.approx(hits / lookups)
    assert any(e["kind"] == "cache_swap" for e in snap["events"])


def test_stale_swap_is_rejected_with_an_event(np_params, params, counts):
    j_eng, t_eng = _engines(np_params, params, counts)
    cache = t_eng.cache
    t_eng.update_cache(cache, version=5)
    j_eng.update_cache(j_eng.cache, version=5)
    for eng, c in ((t_eng, cache), (j_eng, j_eng.cache)):
        with pytest.raises(ValueError, match="stale"):
            eng.update_cache(c, version=3)
    (t_ev,), (j_ev,) = (e.telemetry.events.query("stale_rejected")
                        for e in (t_eng, j_eng))
    assert (t_ev.version, t_ev.attrs) == (j_ev.version, j_ev.attrs) == (
        3, {"served_version": 5, "swap_kind": "cache_swap"})
    with pytest.raises(ValueError, match="stale"):
        t_eng.update_source(t_eng.source, version=4)
    assert t_eng.telemetry.events.query("stale_rejected")[-1].attrs[
        "swap_kind"] == "source_swap"
    reg = t_eng.telemetry.registry
    assert reg.counter("rec_stale_rejected_total").value == 2
    assert reg.gauge("rec_source_version").value == 5


def test_retune_and_drain_events_match_the_reference(np_params, params,
                                                     counts):
    j_eng, t_eng = _engines(np_params, params, counts)
    assert t_eng._batch_ring.maxlen == j_eng._batch_ring.maxlen == 1024
    rb = _rb(6)
    _serve(j_eng, j_requests, rb)
    _serve(t_eng, t_requests, rb)
    assert t_eng.retune_buckets(warmup=False) == \
        j_eng.retune_buckets(warmup=False)
    for kind in ("retune", "drain"):
        t_evs = [(e.version, e.attrs)
                 for e in t_eng.telemetry.events.query(kind)]
        j_evs = [(e.version, e.attrs)
                 for e in j_eng.telemetry.events.query(kind)]
        assert t_evs == j_evs and t_evs, kind
    assert t_eng.telemetry.events.query("retune")[0].attrs[
        "old_buckets"] == [4]


def test_spans_of_one_micro_batch_match_the_reference(np_params, params,
                                                      counts):
    j_eng, t_eng = _engines(np_params, params, counts,
                            j_tel=j_obs.Telemetry(tracing=True),
                            t_tel=obs.Telemetry(tracing=True))
    rb = _rb(4)
    for eng, requests in ((j_eng, j_requests), (t_eng, t_requests)):
        _serve(eng, requests, rb)

    def shape(eng):
        tr = eng.telemetry.tracer
        (step,) = tr.spans("serve_step")
        kids = sorted(s.name for s in tr.spans()
                      if s.parent_id == step.span_id)
        return step.attrs, kids, len(tr.spans("enqueue"))
    assert shape(t_eng) == shape(j_eng) == (
        {"batch_size": 4, "bucket": 4},
        ["batch", "bucket_pad", "forward", "respond"], 4)
    # dispatch over bucket_pad, then settle
    reqs = t_requests(_rb(3, seed=5), CFG.n_tables)
    t_eng.settle(t_eng.dispatch(reqs))
    tr = t_eng.telemetry.tracer
    (disp,) = tr.spans("dispatch")
    assert disp.attrs == {"batch_size": 3, "bucket": 4, "path": "primary"}
    assert [s.name for s in tr.spans() if s.parent_id == disp.span_id] \
        == ["bucket_pad"]
    (settle,) = tr.spans("settle")
    assert settle.attrs == {"batch_size": 3} and settle.parent_id is None
    assert t_eng.telemetry.registry.histogram(
        "rec_service_ms", labels={"path": "primary"}).count == 1


@pytest.mark.parametrize("source", ["cached", "ragged"])
def test_disabled_telemetry_serves_uninstrumented(np_params, params, counts,
                                                  source):
    fused = RecEngine(CFG, params, device="cpu", **_kw(source, counts))
    eng = RecEngine(CFG, params, telemetry=obs.Telemetry.disabled(),
                    device="cpu", **_kw(source, counts))
    rb = _rb(8)
    want = _probs(_serve(fused, t_requests, rb))
    reqs = _serve(eng, t_requests, rb)
    np.testing.assert_array_equal(_probs(reqs), want)
    assert eng.served == 8 and eng.stats() == {"n": 0}
    assert eng.latencies == [] and eng._lookups == 0
    assert int(eng._hits) == 0 and eng._hit_probe() is None
    assert not eng.telemetry.tracer.spans()
    reg = eng.telemetry.registry
    assert reg.snapshot()["histograms"]["rec_request_latency_ms"][
        "count"] == 0
    assert reg.counter("rec_requests_total").value == 0
    eng.settle(eng.dispatch(t_requests(_rb(4, seed=3), CFG.n_tables)))
    assert reg.counter("rec_cold_compiles_total").value == 0
    if source == "cached":
        eng.update_cache(eng.cache, version=1)
    eng.retune_buckets(warmup=False)
    assert len(eng.telemetry.events) == 0


def test_cumulative_percentiles_follow_the_reference_past_the_ring(
        np_params, params, counts):
    """The port once reported p50/p99 over a ring of the last 4,096
    latencies. Past the ring the reference's cumulative percentiles come
    from the histogram's buckets: 4,200 synthetic latencies recorded
    through each engine's recording call must give the same numbers, and
    here they differ from the ring's."""
    j_eng, t_eng = _engines(np_params, params, counts, "ragged")
    lat = np.concatenate([np.full(200, 500.0), _samples(3, 4000)])
    for v in lat:
        j_eng._lat_hist.record(v)
    for lo in range(0, len(lat), 32):
        t_eng._lat_hist.record_many(lat[lo:lo + 32])
    j_st, t_st = j_eng.stats(), t_eng.stats()
    assert t_st["n"] == j_st["n"] == 4200 > RecEngine.LATENCY_RING
    for k in ("p50_ms", "p95_ms", "p99_ms", "mean_ms"):
        assert t_st[k] == j_st[k], k
    for window in ("since_swap", "rolling"):
        assert t_st[window] == j_st[window], window
    ring_only = float(np.percentile(lat[-RecEngine.LATENCY_RING:], 99))
    assert t_st["p99_ms"] != ring_only
    assert t_st["rolling"]["p99_ms"] == ring_only


@pytest.mark.parametrize("cfg,j_cfg", [(CFG, J_CFG), (HET, J_HET)])
def test_serve_stages_compose_to_the_serve_step(cfg, j_cfg):
    np_p = jax.tree.map(np.asarray,
                        j_dlrm.init(jax.random.PRNGKey(2), j_cfg))
    params = t_dlrm.params_from_numpy(np_p, "cpu")
    rb = DLRMSynthetic(j_cfg, seed=4).ragged_batch(
        5, dist="poisson", mean_l=3, max_l=MAX_L,
        pad_to=5 * cfg.n_tables * MAX_L)
    batch = _t_batch(rb)
    src = t_dlrm._default_source(params, cfg)
    sp, it, tp = t_dlrm.make_ragged_serve_stages(cfg, max_l=MAX_L)
    staged = tp(params, it(params, batch, sp(params, batch, src)))
    fused = t_dlrm.make_ragged_serve_step(cfg, max_l=MAX_L)(params, batch,
                                                            src)
    assert torch.equal(staged, fused)
    j_sp, j_it, j_tp = j_dlrm.make_ragged_serve_stages(j_cfg, max_l=MAX_L)
    j_batch = {k: np.asarray(rb[k]) for k in ("dense", "indices", "offsets")}
    j_src = (j_es.TableGroupSource.from_arenas(
        np_p["tables"], j_dlrm.member_specs(j_cfg)) if cfg.heterogeneous
        else j_es.FpArena(np_p["arena"]))
    j_emb = j_sp(np_p, j_batch, j_src)
    emb = sp(params, batch, src)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), rtol=0,
                               atol=ATOL)
    want = j_tp(np_p, j_it(np_p, j_batch, j_emb))
    np.testing.assert_allclose(staged.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("source", ["ragged", "cached"])
def test_device_stages_match_fused_and_report_live_fig5(np_params, params,
                                                        counts, source):
    fused = RecEngine(CFG, params, device="cpu", **_kw(source, counts))
    staged = RecEngine(CFG, params, device="cpu",
                       telemetry=obs.Telemetry(device_stages=True),
                       **_kw(source, counts))
    j_staged = JRecEngine(J_CFG, np_params,
                          telemetry=j_obs.Telemetry(device_stages=True),
                          **_kw(source, counts))
    staged.warmup()
    rb = _rb(8, seed=21)
    want = _probs(_serve(fused, t_requests, rb))
    got = _probs(_serve(staged, t_requests, rb))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _probs(_serve(j_staged, j_requests, rb)),
                               rtol=0, atol=ATOL)
    fig5 = staged.live_fig5()
    assert set(fig5) == set(j_staged.live_fig5()) == {
        "sparse_lookup_ms", "interaction_ms", "mlp_ms", "total_ms",
        "emb_frac"}
    assert 0.0 < fig5["emb_frac"] < 1.0
    assert fig5["total_ms"] == pytest.approx(
        fig5["sparse_lookup_ms"] + fig5["interaction_ms"] + fig5["mlp_ms"])
    assert staged.stats()["stages"] == staged.live_fig5()
    fam = staged.telemetry.registry.histograms("rec_stage_ms")
    assert len(fam) == 3 and all(h.count == 2 for h in fam.values())
    if source == "cached":
        assert (int(staged._hits), staged._lookups) == _recount(staged, rb)
    with pytest.raises(ValueError, match="live_fig5"):
        fused.live_fig5()


def test_staged_spans_match_the_reference(np_params, params, counts):
    j_eng, t_eng = _engines(
        np_params, params, counts, "ragged",
        j_tel=j_obs.Telemetry(tracing=True, device_stages=True),
        t_tel=obs.Telemetry(tracing=True, device_stages=True))

    def kids(eng):
        tr = eng.telemetry.tracer
        (step,) = tr.spans("serve_step")
        return sorted(s.name for s in tr.spans()
                      if s.parent_id == step.span_id)
    for eng, requests in ((j_eng, j_requests), (t_eng, t_requests)):
        _serve(eng, requests, _rb(4))
    assert kids(t_eng) == kids(j_eng) == [
        "batch", "bucket_pad", "interaction", "mlp", "respond",
        "sparse_lookup"]


def test_device_stages_refused_on_fixed_layout_and_by_dispatch(params,
                                                               counts):
    with pytest.raises(ValueError, match="device_stages"):
        RecEngine(CFG, params, source="fixed", device="cpu",
                  telemetry=obs.Telemetry(device_stages=True))
    staged = RecEngine(CFG, params, device="cpu",
                       telemetry=obs.Telemetry(device_stages=True),
                       **_kw("ragged", counts))
    with pytest.raises(ValueError, match="device_stages"):
        staged.dispatch(t_requests(_rb(2), CFG.n_tables))


def test_host_store_counters_equal_the_prefetch_stats(params, counts):
    tel = obs.Telemetry()
    pol = TierPolicy(hot=24, warm=120, cold="host", staging_rows=256,
                     max_stage_per_batch=32)
    eng = RecEngine(CFG, params, source=es.SourceSpec(tiers=pol),
                    cache_trace=counts, telemetry=tel, device="cpu",
                    **{k: v for k, v in _kw("ragged", counts).items()
                       if k != "source"})
    assert all(s.telemetry is tel for s in eng._host_stores)
    _serve(eng, t_requests, _rb(12, seed=6))
    pre = eng.stats()["prefetch"]
    reg = tel.registry
    assert pre["misses"] > 0
    assert reg.counter("rec_prefetch_hit").value == pre["hits"]
    assert reg.counter("rec_prefetch_miss").value == pre["misses"]
    assert json.loads(json.dumps(tel.snapshot())) == tel.snapshot()


# ---------------------------------------------------------------------------
# the trainer against the reference trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize_cold", [False, True])
def test_online_trainer_events_match_the_reference(np_params,
                                                   quantize_cold):
    data = DLRMSynthetic(J_CFG, seed=3)
    pad = 16 * CFG.n_tables * MAX_L
    batches = [data.ragged_batch(16, dist="poisson", mean_l=3, max_l=MAX_L,
                                 pad_to=pad) for _ in range(9)]
    j_tel, t_tel = j_obs.Telemetry(), obs.Telemetry()
    j_tr = JOnlineTrainer(J_CFG, jax.tree.map(jnp.asarray, np_params),
                          max_l=MAX_L, lr=1e-2,
                          cache_cfg=JCacheConfig(k=K, refresh_every=4,
                                                 quantize_cold=quantize_cold),
                          telemetry=j_tel)
    t_tr = OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                         max_l=MAX_L, lr=1e-2,
                         cache_cfg=OnlineCacheConfig(
                             k=K, refresh_every=4,
                             quantize_cold=quantize_cold),
                         telemetry=t_tel, device="cpu")
    for b in batches:
        j_tr.train_step(b)
        t_tr.train_step(b)
    j_tr.publish()
    t_tr.publish()
    t_tr.publish_source()
    j_tr.publish_source()
    np.testing.assert_allclose(t_tr.losses, j_tr.losses, rtol=LOSS_RTOL)

    def evs(tel):
        return [(e.kind, e.version, {k: v for k, v in e.attrs.items()
                                     if k not in ("rows", "bytes")})
                for e in tel.events.events]
    assert evs(t_tel) == evs(j_tel)
    assert [e.kind for e in t_tel.events.events].count(
        "hot_cache_rebuild") == 2
    reg, j_reg = t_tel.registry, j_tel.registry
    for name in ("train_steps_total", "train_rebuilds_total"):
        assert reg.counter(name).value == j_reg.counter(name).value
    assert reg.counter("train_steps_total").value == 9
    for name in ("train_cache_version", "train_rebuild_hot_k"):
        assert reg.gauge(name).value == j_reg.gauge(name).value
    assert reg.gauge("train_loss").value == t_tr.losses[-1]
    if quantize_cold:
        t_rows = [e.attrs["rows"] for e in t_tel.events.query(
            "quantized_refresh")]
        j_rows = [e.attrs["rows"] for e in j_tel.events.query(
            "quantized_refresh")]
        assert t_rows == j_rows and all(r > 0 for r in t_rows)
        assert reg.gauge("train_requant_rows").value == t_rows[-1]
    assert json.loads(json.dumps(t_tel.snapshot())) == t_tel.snapshot()


def test_tiered_trainer_emits_migrations_and_tier_gauges(np_params):
    data = DLRMSynthetic(J_CFG, seed=5)
    pad = 16 * CFG.n_tables * MAX_L
    tel = obs.Telemetry()
    tr = OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                       max_l=MAX_L, telemetry=tel, device="cpu",
                       cache_cfg=OnlineCacheConfig(
                           k=0, refresh_every=3,
                           tiers=TierPolicy(hot=24, warm=120, cold="int4")))
    for _ in range(6):
        tr.train_step(data.ragged_batch(16, dist="poisson", mean_l=3,
                                        max_l=MAX_L, pad_to=pad))
    migs = tel.events.query("tier_migration")
    assert [e.version for e in migs] == [1, 2]
    assert migs[-1].attrs == {"step": 6, **tr.last_migration}
    reg = tel.registry
    assert reg.counter("train_rebuilds_total").value == 2
    from repro_torch.storage import tier_bytes
    for tier, nb in tier_bytes(tr.tiered).items():
        if tier != "device_total":
            assert reg.gauge("rec_tier_bytes",
                             labels={"tier": tier}).value == nb
