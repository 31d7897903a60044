"""The port's RecEngine on the "ragged" fp plan against the JAX RecEngine:
the same requests, the same params, per-request probabilities; plus the
batcher, bucketing, stats and the plans that are not ported yet. The
cached plan has its own file, ``test_torch_cached_serving.py``.

Tolerance: probabilities atol=1e-5 (fp32 logits of O(1) through
sigmoid, XLA and torch summing in different orders).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.data import DLRMSynthetic
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro.serving.rec_engine import _bucket as j_bucket
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.serving import RecBatcher, RecEngine, RecRequest
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.serving.rec_engine import _bucket as t_bucket

torch.set_num_threads(1)

MAX_L = 6


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(1), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


def _batch(n, seed=9, dist="poisson"):
    return DLRMSynthetic(J_CFG, seed=seed).ragged_batch(
        n, dist=dist, mean_l=3, max_l=MAX_L)


def _engine(params, **kw):
    kw = {"max_l": MAX_L, "max_batch": 8, "max_wait_ms": 0.0,
          "buckets": (2, 4, 8), "device": "cpu", **kw}
    return RecEngine(CFG, params, **kw)


def _serve(engine, reqs, step_each):
    for r in reqs:
        engine.submit(r)
        if step_each:
            engine.step()
    engine.drain()


@pytest.mark.parametrize("n,buckets,dist", [(13, (2, 4, 8), "poisson"),
                                            (21, (8,), "uniform")])
def test_engine_matches_reference_engine(np_params, params, n, buckets,
                                         dist):
    rb = _batch(n, dist=dist)
    j_engine = JRecEngine(J_CFG, np_params, source="ragged", max_l=MAX_L,
                          max_batch=8, max_wait_ms=0.0, buckets=buckets)
    t_engine = _engine(params, buckets=buckets)
    j_reqs, t_reqs = j_requests(rb, J_CFG.n_tables), t_requests(rb,
                                                                CFG.n_tables)
    _serve(j_engine, j_reqs, step_each=True)
    _serve(t_engine, t_reqs, step_each=True)
    assert t_engine.served == j_engine.served == n
    got = np.array([r.prob for r in t_reqs])
    want = np.array([r.prob for r in j_reqs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ((got > 0) & (got < 1)).all()


def test_probabilities_do_not_depend_on_batching(params):
    rb = _batch(11, seed=4)
    probs = []
    for step_each in (True, False):
        reqs = t_requests(rb, CFG.n_tables)
        _serve(_engine(params), reqs, step_each)
        probs.append([r.prob for r in reqs])
    np.testing.assert_allclose(probs[0], probs[1], rtol=0, atol=1e-6)


def test_requests_from_ragged_batch_match_reference():
    rb = _batch(6, seed=2, dist="uniform")
    for j, t in zip(j_requests(rb, J_CFG.n_tables, rid0=5),
                    t_requests(rb, CFG.n_tables, rid0=5)):
        assert t.rid == j.rid
        np.testing.assert_array_equal(t.dense, j.dense)
        for a, b in zip(t.sparse_ids, j.sparse_ids):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 40])
def test_bucket_matches_reference(n):
    assert t_bucket(n, (2, 4, 8)) == j_bucket(n, (2, 4, 8))


def _req(rid, mono):
    return RecRequest(rid=rid, dense=np.zeros(CFG.dense_features, np.float32),
                      sparse_ids=[np.zeros(1, np.int32)] * CFG.n_tables,
                      submitted_mono=mono)


def test_batcher_releases_on_full_batch():
    b = RecBatcher(max_batch=4, max_wait_ms=1e9, clock=lambda: 0.0)
    for i in range(3):
        b.submit(_req(i, 0.0))
    assert b.take() == []
    b.submit(_req(3, 0.0))
    assert [r.rid for r in b.take()] == [0, 1, 2, 3]
    assert len(b) == 0


def test_batcher_releases_on_the_monotonic_deadline():
    now = [0.0]
    b = RecBatcher(max_batch=64, max_wait_ms=5.0, clock=lambda: now[0])
    b.submit(_req(0, 0.0))
    assert b.take() == []
    now[0] = 0.004
    assert b.take() == []
    now[0] = 0.005
    assert [r.rid for r in b.take()] == [0]


def test_stats_and_warmup(params):
    engine = _engine(params)
    assert engine.stats() == {"n": 0}
    engine.warmup()
    assert engine.served == 0 and engine.batches == 0
    reqs = t_requests(_batch(10, seed=6), CFG.n_tables)
    _serve(engine, reqs, step_each=False)
    s = engine.stats()
    assert s["n"] == 10 and s["path"] == "ragged"
    assert s["cache_hit_rate"] is None
    assert s["buckets"] == (2, 4, 8)
    assert 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert s["mean_ms"] > 0
    assert engine.batches == 2
    for r in reqs:
        assert r.finished_at >= r.started_at >= r.submitted_at


def test_latency_ring_is_bounded(params, monkeypatch):
    monkeypatch.setattr(RecEngine, "LATENCY_RING", 4)
    engine = _engine(params)
    _serve(engine, t_requests(_batch(9, seed=7), CFG.n_tables), False)
    assert engine.stats()["n"] == 9
    assert len(engine._lat_hist.ring_values()) == len(engine.latencies) == 4


@pytest.mark.parametrize("plan,item", [("sharded", "item 13")])
def test_unported_plans_name_their_roadmap_item(params, plan, item):
    """The sharded plan is ported (item 13); without a mesh it refuses to
    fall back to the replicated arena, a tiered plan on it too, with the
    reference's ValueError."""
    from repro_torch.core import embedding_source as es
    from repro_torch.storage import TierPolicy
    with pytest.raises(ValueError, match="require_mesh"):
        _engine(params, source=plan)
    with pytest.raises(ValueError, match="require_mesh"):
        es.SourceSpec(tiers=TierPolicy(hot=2, warm=4), require_mesh=True)


def test_engine_refuses_the_cpu_unasked(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecEngine(CFG, params, max_l=MAX_L)


def test_engine_refuses_params_on_another_device(params):
    with pytest.raises(ValueError, match="engine on meta"):
        RecEngine(CFG, params, max_l=MAX_L, device="meta")


def test_bags_longer_than_max_l_are_refused(params):
    engine = _engine(params)
    engine.submit(RecRequest(
        rid=1, dense=np.zeros(CFG.dense_features, np.float32),
        sparse_ids=[np.zeros(MAX_L + 1, np.int32)] * CFG.n_tables))
    with pytest.raises(ValueError, match="max_l"):
        engine.drain()
