"""The port's continuous-batching engine parts against the JAX RecEngine:
``dispatch``/``settle`` and ``InflightBatch``, the int8 downgrade source,
``tune_buckets``, ``retune_buckets`` and ``auto_tune_after``, the warm
pool (``_warm`` and ``rec_cold_compiles_total``), two micro-batches in flight
settled out of order, and the snapshot rule of every swap: the engine
copies into its own tensors, whose addresses never move (what a captured
CUDA graph needs), and never writes a tensor it was handed.

These run the CPU path, which has the same buffers and the same adopt
logic as the card's, with no graph: on the card each micro-batch replays
its pair's captured graph (``chip_smoke.py`` phase 11).

Tolerances:
  * probabilities against the JAX engine, fp or int8 downgrade:
    atol=1e-5 (fp32 logits of O(1) through sigmoid; XLA and torch sum in
    other orders; the int8 codes are the same on both sides);
  * the downgrade path against the primary: 0.05, the reference's bound
    (tests/test_scheduler.py);
  * int8 codes and scales of the downgrade source: exact;
  * bucket choices, ``_warm``, cold counts, batch sizes: exact;
  * within the port, settle order and dispatch against step: exact,
    the same CPU arithmetic on the same rows;
  * retuned buckets against fixed ones: rtol=1e-5, atol=1e-6, the
    reference's (tests/test_rec_serving.py): the CPU's matrix product
    groups its sums by the padded batch, so a row's bits depend on its
    bucket (the card's gemm computes each row on its own).
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
from repro.serving.rec_engine import tune_buckets as j_tune_buckets
from repro_torch import storage as t_st
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import InflightBatch, RecEngine, tune_buckets
from repro_torch.serving import requests_from_ragged_batch as t_requests

torch.set_num_threads(1)

MAX_L = 6
ATOL = 1e-5
DOWNGRADE_ATOL = 0.05
RETUNE_RTOL, RETUNE_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(0), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


@pytest.fixture(scope="module")
def rb():
    """The reference's fixture (tests/test_scheduler.py): 24 poisson
    requests, max_l 6."""
    return DLRMSynthetic(J_CFG, seed=9).ragged_batch(24, dist="poisson",
                                                     mean_l=3, max_l=MAX_L)


@pytest.fixture(scope="module")
def counts(rb):
    return se.trace_row_counts(t_dlrm.arena_spec(CFG), rb["indices"],
                               rb["offsets"])


def _engines(np_params, params, **kw):
    kw = {"source": "ragged", "max_l": MAX_L, "max_batch": 8,
          "buckets": (2, 8), **kw}
    return (JRecEngine(J_CFG, np_params, **kw),
            RecEngine(CFG, params, device="cpu", **kw))


def _probs(reqs) -> np.ndarray:
    return np.array([r.prob for r in reqs])


def test_dispatch_settle_matches_the_reference(np_params, params, rb):
    j_eng, t_eng = _engines(np_params, params)
    j_reqs, t_reqs = j_requests(rb, J_CFG.n_tables), t_requests(rb,
                                                                CFG.n_tables)
    for lo, hi in ((0, 8), (8, 10), (10, 15), (15, 23)):
        j_ib = j_eng.dispatch(j_reqs[lo:hi])
        t_ib = t_eng.dispatch(t_reqs[lo:hi])
        assert isinstance(t_ib, InflightBatch)
        assert t_ib.bucket == j_ib.bucket
        assert [r.rid for r in t_ib.reqs] == [r.rid for r in j_ib.reqs]
        assert not t_ib.downgraded
        assert t_eng.settle(t_ib) == j_eng.settle(j_ib) == hi - lo
    np.testing.assert_allclose(_probs(t_reqs[:23]), _probs(j_reqs[:23]), rtol=0,
                               atol=ATOL)
    assert t_eng.served == j_eng.served == 23
    assert t_eng.batch_sizes == j_eng.batch_sizes == [8, 2, 5, 8]
    assert all(r.started_at is not None and r.finished_at is not None
               for r in t_reqs[:23])


def test_downgrade_path_matches_the_reference(np_params, params, rb):
    j_eng, t_eng = _engines(np_params, params)
    j_down, t_down = j_eng.enable_downgrade(), t_eng.enable_downgrade()
    assert t_eng.downgrade_source is t_down
    assert t_eng.enable_downgrade() is t_down          # built once
    np.testing.assert_array_equal(t_down.q.numpy(), np.asarray(j_down.q))
    np.testing.assert_array_equal(t_down.scales.numpy(),
                                  np.asarray(j_down.scales))
    j_reqs, t_reqs = j_requests(rb, J_CFG.n_tables), t_requests(rb,
                                                                CFG.n_tables)
    t_eng.settle(t_eng.dispatch(t_reqs[:8]))
    full = _probs(t_reqs[:8])
    j_eng.settle(j_eng.dispatch(j_reqs[:8], downgraded=True))
    ib = t_eng.dispatch(t_reqs[:8], downgraded=True)
    assert ib.downgraded and all(r.downgraded for r in t_reqs[:8])
    t_eng.settle(ib)
    down = _probs(t_reqs[:8])
    np.testing.assert_allclose(down, _probs(j_reqs[:8]), rtol=0, atol=ATOL)
    assert np.abs(down - full).max() < DOWNGRADE_ATOL
    assert not np.array_equal(down, full)
    # a params assignment re-quantizes into the downgrade source's own
    # tensors, as the reference rebuilds it from the new arena
    ptrs = [t_down.q.data_ptr(), t_down.scales.data_ptr()]
    new = dict(np_params, arena=np_params["arena"] * 1.5)
    j_eng.params = jax.tree.map(jax.numpy.asarray, new)
    t_eng.params = t_dlrm.params_from_numpy(new, "cpu")
    assert [t_down.q.data_ptr(), t_down.scales.data_ptr()] == ptrs
    np.testing.assert_array_equal(t_down.q.numpy(),
                                  np.asarray(j_eng.downgrade_source.q))
    np.testing.assert_array_equal(
        t_down.scales.numpy(), np.asarray(j_eng.downgrade_source.scales))


@pytest.mark.parametrize("sizes,max_batch,n_buckets", [
    ([3] * 40 + [7] * 40 + [12] * 3, 32, 4),
    ([], 16, 6), ([], 8, 1), ([5] * 100, 32, 6), ([16] * 10, 16, 6),
    ([40] * 50 + [64] * 50, 32, 6), ([2, 40, 70], 32, 6)])
def test_tune_buckets_matches_the_reference_cases(sizes, max_batch,
                                                  n_buckets):
    assert tune_buckets(sizes, max_batch, n_buckets) \
        == j_tune_buckets(sizes, max_batch, n_buckets)


@pytest.mark.parametrize("seed", range(6))
def test_tune_buckets_matches_the_reference_on_histograms(seed):
    rng = np.random.RandomState(seed)
    max_batch = int(rng.choice([8, 32, 64]))
    sizes = rng.poisson(rng.uniform(1, max_batch), rng.randint(1, 300))
    n_buckets = int(rng.randint(1, 9))
    got = tune_buckets(sizes.tolist(), max_batch, n_buckets)
    assert got == j_tune_buckets(sizes.tolist(), max_batch, n_buckets)
    assert got[-1] == max_batch and list(got) == sorted(set(got))


def test_retune_with_no_traffic_matches_the_reference(np_params, params,
                                                      rb):
    j_eng, t_eng = _engines(np_params, params, buckets=(1, 2, 4, 8),
                            max_wait_ms=0.0)
    assert t_eng.retune_buckets(warmup=False) \
        == j_eng.retune_buckets(warmup=False) == (1, 8)
    for eng, reqs in ((j_eng, j_requests(rb, J_CFG.n_tables)[:3]),
                      (t_eng, t_requests(rb, CFG.n_tables)[:3])):
        for r in reqs:
            eng.submit(r)
            eng.step()
        eng.drain()
        assert all(r.prob is not None for r in reqs)
        if eng is j_eng:
            want = _probs(reqs)
    np.testing.assert_allclose(_probs(reqs), want, rtol=0, atol=ATOL)


def test_auto_tune_after_matches_the_reference(np_params, params, rb):
    """Bursts of 3 with auto_tune_after=4: the retune fires on the fifth
    micro-batch, to the reference's buckets, and changes padding only."""
    out = {}
    for tuned in (None, 4):
        j_eng, t_eng = _engines(np_params, params, max_wait_ms=0.0,
                                buckets=(1, 2, 4, 8), auto_tune_after=tuned)
        for eng, reqs in ((j_eng, j_requests(rb, J_CFG.n_tables)),
                          (t_eng, t_requests(rb, CFG.n_tables))):
            for j in range(0, len(reqs), 3):
                for r in reqs[j:j + 3]:
                    eng.submit(r)
                eng.step(force=True)
            out[(eng is t_eng, tuned)] = (eng.buckets, _probs(reqs))
    for tuned in (None, 4):
        (t_b, t_p), (j_b, j_p) = out[(True, tuned)], out[(False, tuned)]
        assert t_b == j_b
        np.testing.assert_allclose(t_p, j_p, rtol=0, atol=ATOL)
    assert 3 in out[(True, 4)][0] and out[(True, 4)][0] != out[(True, None)][0]
    np.testing.assert_allclose(out[(True, 4)][1], out[(True, None)][1],
                               rtol=RETUNE_RTOL, atol=RETUNE_ATOL)


def test_warm_pool_and_cold_count_match_the_reference(np_params, params,
                                                      rb):
    j_eng, t_eng = _engines(np_params, params)
    j_reqs, t_reqs = j_requests(rb, J_CFG.n_tables), t_requests(rb,
                                                                CFG.n_tables)

    def both(call):
        call(j_eng, j_reqs)
        call(t_eng, t_reqs)
        assert t_eng._warm == j_eng._warm
        assert t_eng._c_cold.value == j_eng._c_cold.value
        assert t_eng.buckets == j_eng.buckets

    both(lambda e, r: e.settle(e.dispatch(r[:2])))        # cold: (p, 2)
    both(lambda e, r: e.settle(e.dispatch(r[2:7])))       # cold: (p, 8)
    both(lambda e, r: e.settle(e.dispatch(r[7:9])))       # warm
    both(lambda e, r: e.enable_downgrade())
    both(lambda e, r: e.settle(e.dispatch(r[9:11], downgraded=True)))
    assert t_eng._c_cold.value == 3
    both(lambda e, r: e.retune_buckets(n_buckets=2))      # (2, 5, 8)
    assert t_eng.buckets == (2, 5, 8)
    both(lambda e, r: e.settle(e.dispatch(r[11:16])))     # warm: (p, 5)
    both(lambda e, r: e.settle(e.dispatch(r[16:21], downgraded=True)))
    assert t_eng._c_cold.value == 3
    # step() triggers a pair without counting it, as the reference's does

    def step3(e, reqs):
        for q in reqs:
            e.submit(q)
        e.step(force=True)
    both(lambda e, r: step3(e, r[21:24]))                 # warm: (p, 5)
    both(lambda e, r: e.retune_buckets(warmup=False))     # (2, 3, 5, 8)
    assert t_eng.buckets == (2, 3, 5, 8)
    both(lambda e, r: step3(e, r[:3]))
    assert ("primary", 3) in t_eng._warm and t_eng._c_cold.value == 3


def test_cold_count_is_zero_after_warmup_and_one_without(np_params, params,
                                                         rb):
    for warm in (True, False):
        j_eng, t_eng = _engines(np_params, params, buckets=(8,))
        if warm:
            j_eng.enable_downgrade()
            t_eng.enable_downgrade()
            j_eng.warmup()
            t_eng.warmup()
            assert t_eng._warm == j_eng._warm == {
                ("primary", 8), ("downgrade", 8)}
        t_eng.settle(t_eng.dispatch(t_requests(rb, CFG.n_tables)[:8]))
        j_eng.settle(j_eng.dispatch(j_requests(rb, J_CFG.n_tables)[:8]))
        assert t_eng._c_cold.value == j_eng._c_cold.value == (0 if warm
                                                              else 1)


def test_two_batches_in_flight_settle_out_of_order(params, rb):
    by_step = _engines_port(params)
    reqs = t_requests(rb, CFG.n_tables)
    for group in (reqs[:8], reqs[8:13]):
        for r in group:
            by_step.submit(r)
        by_step.step(force=True)
    want = _probs(reqs[:13])
    inflight = _engines_port(params)
    reqs = t_requests(rb, CFG.n_tables)
    a = inflight.dispatch(reqs[:8])
    b = inflight.dispatch(reqs[8:13])
    assert (a.bucket, b.bucket) == (8, 8)
    assert inflight.settle(b) == 5 and reqs[0].prob is None
    assert inflight.settle(a) == 8
    np.testing.assert_array_equal(_probs(reqs[:13]), want)
    assert inflight.served == 13 and inflight.batches == 2


def _engines_port(params, **kw):
    kw = {"source": "ragged", "max_l": MAX_L, "max_batch": 8,
          "buckets": (2, 8), "max_wait_ms": 0.0, **kw}
    return RecEngine(CFG, params, device="cpu", **kw)


def _tiers(cold):
    return t_st.TierPolicy(hot=24, warm=120, cold=cold, staging_rows=256,
                           max_stage_per_batch=32)


PLANS = {
    "fp": dict(source="ragged"),
    "cached": dict(source="cached", cache_k=32),
    "int8": dict(source="cached", cache_k=32, quantize_cold=True),
    "tiered_int4": dict(source=es.SourceSpec(tiers=_tiers("int4"))),
    "tiered_host": dict(source=es.SourceSpec(tiers=_tiers("host")))}


def _trainer_source(engine, arena, counts):
    """What a trainer would publish for the engine's plan, built from its
    own arena."""
    spec = engine.spec
    if engine.plan.tiers is not None:
        return t_st.build_tiered(arena, spec, engine.plan.tiers, counts)
    return engine.plan.build(arena, spec, counts)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_swaps_adopt_into_the_engine_tensors(np_params, params, counts, rb,
                                             plan):
    engine = _engines_port(params, cache_trace=counts, **PLANS[plan])
    engine.enable_downgrade()
    own = engine.source
    leaves = es.source_structure(own)[1] \
        + es.source_structure(engine.downgrade_source)[1] \
        + tree_leaves(engine.params)
    ptrs = [t.data_ptr() for t in leaves]
    rng = np.random.RandomState(5)
    new = tree_map(lambda a: a + rng.uniform(-0.1, 0.1, a.shape).astype(
        np.float32), np_params)
    new["arena"][engine.spec.null_row:] = 0.0
    trainer_params = t_dlrm.params_from_numpy(new, "cpu")
    handed = _trainer_source(engine, trainer_params["arena"] * 1.25,
                             counts[::-1].copy())
    before = [t.clone() for t in es.source_structure(handed)[1]
              + tree_leaves(trainer_params)]
    engine.params = trainer_params
    engine.update_source(handed, version=1)
    if engine.cache is not None:
        fresh = se.build_hot_cache(trainer_params["arena"], engine.spec,
                                   counts, engine.cache.k)
        before += [t.clone() for t in es.source_structure(fresh)[1]]
        engine.update_cache(fresh, version=2)
        handed_leaves = es.source_structure(es.with_hot_cache(handed,
                                                              fresh))[1]
    else:
        handed_leaves = es.source_structure(handed)[1]
    # the engine holds the handed values, in its own tensors; on the fp
    # plans the served fp arena is params["arena"], so a swap of it lands
    # there too
    for mine, theirs in zip(es.source_structure(own)[1], handed_leaves):
        assert torch.equal(mine, theirs)
        assert mine.data_ptr() != theirs.data_ptr()
    for name in ("bottom", "top"):
        for mine, theirs in zip(tree_leaves(engine.params[name]),
                                tree_leaves(trainer_params[name])):
            assert torch.equal(mine, theirs)
    stores = t_st.host_stores_of(handed)
    rows = [s.host_rows.copy() for s in stores]
    reqs = t_requests(rb, CFG.n_tables)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    engine.settle(engine.dispatch(reqs[:8], downgraded=True))
    assert all(r.prob is not None for r in reqs)
    assert engine.source is own
    assert [t.data_ptr() for t in leaves] == ptrs
    # and it never wrote what it was handed
    after = es.source_structure(handed)[1] + tree_leaves(trainer_params)
    if engine.cache is not None:
        after += es.source_structure(fresh)[1]
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    for s, r in zip(stores, rows):
        assert s not in engine._host_stores
        np.testing.assert_array_equal(s.host_rows, r)
