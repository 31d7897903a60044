"""The port's RecEngine on the cached plan against the JAX RecEngine: the
same requests and params, per-request probabilities and the hit rate;
plus the swap boundary (stale versions, structure and shape changes,
hit counters per version), pre-built sources, the params copy and the
plan's refusals.

Tolerances:
  * probabilities against the JAX engine, cached fp or cached int8:
    atol=1e-5 (fp32 logits of O(1) through sigmoid; XLA and torch sum in
    other orders; the int8 codes are the same on both sides);
  * the port's cached plan against its fp plan: exact (the hot/cold law);
  * int8 against fp: 0.05, the reference's stated bound
    (tests/test_rec_serving.py, int8 tail with fp hot rows);
  * hit rate against the JAX engine: rtol=1e-6 (the JAX engine folds each
    batch in as float32 rate x lookups; the port counts integers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import sparse_engine as j_se
from repro.data import DLRMSynthetic
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro_torch.configs.dlrm import DLRM_HET_SMOKE
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.storage import TierPolicy

torch.set_num_threads(1)

MAX_L = 6
K = 32


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(1), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


@pytest.fixture(scope="module")
def counts():
    rb = DLRMSynthetic(J_CFG, seed=3).ragged_batch(64, mean_l=3, max_l=MAX_L)
    return se.trace_row_counts(t_dlrm.arena_spec(CFG), rb["indices"],
                               rb["offsets"])


def _batch(n, seed=9):
    return DLRMSynthetic(J_CFG, seed=seed).ragged_batch(n, mean_l=3,
                                                        max_l=MAX_L)


def _engine(params, **kw):
    kw = {"max_l": MAX_L, "max_batch": 8, "max_wait_ms": 0.0,
          "buckets": (2, 4, 8), "device": "cpu", **kw}
    return RecEngine(CFG, params, **kw)


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
        engine.step()
    engine.drain()
    return np.array([r.prob for r in reqs])


@pytest.mark.parametrize("quantize_cold", [False, True])
def test_cached_engine_matches_reference_engine(np_params, params, counts,
                                                quantize_cold):
    rb = _batch(13)
    kw = dict(source="cached", cache_k=K, cache_trace=counts,
              quantize_cold=quantize_cold)
    j_engine = JRecEngine(J_CFG, np_params, max_l=MAX_L, max_batch=8,
                          max_wait_ms=0.0, buckets=(2, 4, 8), **kw)
    t_engine = _engine(params, **kw)
    want = _serve(j_engine, j_requests(rb, J_CFG.n_tables))
    got = _serve(t_engine, t_requests(rb, CFG.n_tables))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    j_stats, t_stats = j_engine.stats(), t_engine.stats()
    assert t_stats["path"] == j_stats["path"] == "cached"
    assert t_stats["source"] == j_stats["source"]
    assert t_stats["cache_version"] == j_stats["cache_version"] == 0
    assert 0 < t_stats["cache_hit_rate"] < 1
    np.testing.assert_allclose(t_stats["cache_hit_rate"],
                               j_stats["cache_hit_rate"], rtol=1e-6)
    for f in ("hot_ids", "slot_of", "hot_rows"):
        np.testing.assert_array_equal(getattr(t_engine.cache, f).numpy(),
                                      np.asarray(getattr(j_engine.cache, f)))


def test_hit_rate_is_a_recount_of_the_served_ids(params, counts):
    rb = _batch(11, seed=5)
    engine = _engine(params, source="cached", cache_k=K, cache_trace=counts)
    _serve(engine, t_requests(rb, CFG.n_tables))
    spec = engine.spec
    slot_of = engine.cache.slot_of.numpy()
    off = rb["offsets"]
    seg = np.searchsorted(off[1:], np.arange(off[-1]), side="right")
    flat = rb["indices"][:off[-1]] + (seg % spec.n_tables) \
        * spec.rows_per_table
    assert engine.stats()["cache_hit_rate"] == \
        (slot_of[flat] < K).sum() / flat.size
    assert engine._hits.dtype == torch.int64 and engine._lookups == flat.size


def test_cached_plan_equals_fp_plan_exactly(params, counts):
    rb = _batch(17, seed=6)
    fp = _serve(_engine(params), t_requests(rb, CFG.n_tables))
    for k in (1, K, 10_000):
        cached = _engine(params, source="cached", cache_k=k,
                         cache_trace=counts)
        np.testing.assert_array_equal(
            _serve(cached, t_requests(rb, CFG.n_tables)), fp)
    q = _serve(_engine(params, source="cached", cache_k=K,
                       cache_trace=counts, quantize_cold=True),
               t_requests(rb, CFG.n_tables))
    assert np.abs(q - fp).max() < 0.05       # int8 tail, fp hot rows


def test_hit_rate_is_none_without_a_cache_and_resets_on_a_bump(params,
                                                               counts):
    rb = _batch(6, seed=4)
    fp = _engine(params)
    _serve(fp, t_requests(rb, CFG.n_tables))
    assert fp.stats()["cache_hit_rate"] is None
    assert "cache_version" not in fp.stats()
    engine = _engine(params, source="cached", cache_k=16, cache_trace=counts)
    _serve(engine, t_requests(rb, CFG.n_tables))
    assert engine.stats()["cache_hit_rate"] > 0 and engine._lookups > 0
    fresh = se.build_hot_cache(engine.params["arena"], engine.spec, counts,
                               16)
    engine.update_cache(fresh, version=5)
    assert engine._lookups == 0 and int(engine._hits) == 0
    assert engine.stats()["cache_hit_rate"] is None   # no post-swap data
    _serve(engine, t_requests(rb, CFG.n_tables))
    n, hits = engine._lookups, int(engine._hits)
    engine.update_cache(engine.cache, version=5)      # a republish
    assert engine._lookups == n and int(engine._hits) == hits
    assert engine.stats()["cache_version"] == 5


def test_stale_and_reshaped_swaps_are_refused(params, counts):
    engine = _engine(params, source="cached", cache_k=16, cache_trace=counts)
    spec = engine.spec
    fresh = se.build_hot_cache(engine.params["arena"], spec, counts, 16)
    engine.update_cache(fresh, version=5)
    served = engine.source
    with pytest.raises(ValueError, match="stale"):
        engine.update_cache(fresh, version=3)
    with pytest.raises(ValueError, match="stale"):
        engine.update_source(served, version=4)
    with pytest.raises(ValueError, match="changed a tensor"):
        engine.update_cache(se.build_hot_cache(engine.params["arena"], spec,
                                               counts, 8), version=6)
    with pytest.raises(ValueError, match="structure"):
        engine.update_source(es.FpArena(engine.params["arena"]), version=6)
    with pytest.raises(ValueError, match="structure"):
        engine.update_source(es.CachedSource(fresh, served.cold,
                                             coherent=False), version=6)
    with pytest.raises(ValueError, match="changed a tensor"):
        engine.update_source(es.CachedSource(
            fresh, es.FpArena(engine.params["arena"].double()),
            coherent=True), version=6)
    assert engine.source is served and engine.cache_version == 5
    engine.update_cache(fresh, version=5)             # equal: allowed
    engine.update_source(served)                      # no version: bump
    assert engine.source_version == 6
    with pytest.raises(TypeError, match="cached source"):
        _engine(params).update_cache(fresh)


def test_cache_swap_tracks_new_params(np_params, params, counts):
    """Params then cache, the online refresh at the engine boundary: the
    engine serves the new arena's forward."""
    rb = _batch(6, seed=12)
    engine = _engine(params, source="cached", cache_k=16, cache_trace=counts)
    spec = engine.spec
    new = dict(np_params)
    new["arena"] = np_params["arena"] + 0.25
    new["arena"][spec.null_row:] = 0.0
    t_new = t_dlrm.params_from_numpy(new, "cpu")
    engine.params = t_new
    engine.update_cache(se.build_hot_cache(t_new["arena"], spec, counts, 16),
                        version=7)
    got = _serve(engine, t_requests(rb, CFG.n_tables))
    want = np.asarray(jax.nn.sigmoid(j_dlrm.forward_ragged(
        new, J_CFG, jnp.asarray(rb["dense"]), jnp.asarray(rb["indices"]),
        jnp.asarray(rb["offsets"]), max_l=MAX_L)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_engine_copies_its_params(params, counts):
    """The engine never aliases the params it is given; a later
    assignment copies in place when the layout matches, so the engine's
    tensors keep their addresses."""
    mine = {k: (v.clone() if k == "arena"
                else [(w.clone(), b.clone()) for w, b in v])
            for k, v in params.items()}
    engine = _engine(mine, source="cached", cache_k=16, cache_trace=counts)
    arena = engine.params["arena"]
    assert arena.data_ptr() != mine["arena"].data_ptr()
    assert engine.source.cold.arena is arena
    mine["arena"] += 1.0
    assert not torch.equal(engine.params["arena"], mine["arena"])
    engine.params = mine
    assert engine.params["arena"] is arena and torch.equal(arena,
                                                           mine["arena"])
    assert engine.source.cold.arena is arena
    assert engine.params["bottom"][0][0].data_ptr() \
        != mine["bottom"][0][0].data_ptr()


def test_prebuilt_source_is_served_as_it_is(params, counts):
    spec = t_dlrm.arena_spec(CFG)
    src = es.CachedSource(se.build_hot_cache(params["arena"], spec, counts,
                                             K),
                          es.QuantizedArena.from_arena(params["arena"]))
    rb = _batch(9, seed=2)
    got = _serve(_engine(params, source=src), t_requests(rb, CFG.n_tables))
    plan = _serve(_engine(params, source="cached", cache_k=K,
                          cache_trace=counts, quantize_cold=True),
                  t_requests(rb, CFG.n_tables))
    np.testing.assert_array_equal(got, plan)
    engine = _engine(params, source=src)
    assert engine.path == "cached(int8)" and engine.plan is None
    with pytest.raises(ValueError, match="plan inputs"):
        _engine(params, source=src, cache_k=4)
    with pytest.raises(TypeError, match="SourceSpec"):
        _engine(params, source=3)


def test_source_spec_plan_is_accepted(params, counts):
    plan = es.SourceSpec(cache_k=8)
    engine = _engine(params, source=plan, cache_trace=counts)
    assert engine.plan is plan and engine.path == "cached"
    assert engine.cache.k == 8


@pytest.mark.parametrize("source,call,match", [
    ("fixed", lambda e: e.enable_downgrade(), "fixed layout"),
    ("ragged", lambda e: e.dispatch([]), "non-empty"),
    ("ragged", lambda e: e.dispatch(t_requests(_batch(2), CFG.n_tables),
                                    downgraded=True), "enable_downgrade")])
def test_engine_parts_refuse_what_they_cannot_serve(params, source, call,
                                                    match):
    with pytest.raises(ValueError, match=match):
        call(_engine(params, source=source))


def test_unported_engine_arguments_name_their_item(params):
    # sharded engines are ported (item 13): a mesh is the port's Mesh,
    # and a tiered plan on the 'sharded' path raises the reference's
    # ValueError (no mesh to shard over; a tiered source does not shard)
    with pytest.raises(TypeError, match="Mesh"):
        _engine(params, mesh=object())
    with pytest.raises(ValueError, match="require_mesh"):
        _engine(params, source=es.SourceSpec(
            tiers=TierPolicy(hot=2, warm=4), require_mesh=True))
    # a table-group plan is ported, and so are its tiered members: the
    # engine builds one TieredSource a table
    het = DLRM_HET_SMOKE
    tiered = tuple(es.TablePlan(rows=tp.rows, dim=tp.dim,
                                tiers=TierPolicy(hot=2, warm=4))
                   for tp in t_dlrm.table_plans(het))
    engine = RecEngine(het, t_dlrm.init(torch.Generator().manual_seed(0),
                                        het, device="cpu"),
                       source=es.SourceSpec(tables=tiered), max_l=MAX_L,
                       device="cpu")
    assert engine.path == "grouped"
    assert all(type(m).__name__ == "TieredSource"
               for m in engine.source.members)


def test_reference_hot_rows_serve_in_the_port(np_params, params, counts):
    """A cache built by the reference, carried as numpy, serves in the
    port exactly as the port's own build."""
    spec = t_dlrm.arena_spec(CFG)
    j_cache = j_se.build_hot_cache(jnp.asarray(np_params["arena"]),
                                   j_dlrm.arena_spec(J_CFG), counts, K)
    cache = se.HotRowCache(**{f: torch.from_numpy(np.array(
        getattr(j_cache, f))) for f in ("hot_rows", "slot_of", "hot_ids")})
    engine = _engine(params, source="cached", cache_k=K,
                     cache_trace=np.ones(spec.total_rows))
    engine.update_cache(cache, version=1)
    rb = _batch(7, seed=13)
    got = _serve(engine, t_requests(rb, CFG.n_tables))
    want = _serve(_engine(params), t_requests(rb, CFG.n_tables))
    np.testing.assert_array_equal(got, want)
