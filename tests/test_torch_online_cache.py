"""The port's caching OnlineTrainer against the JAX trainer on the same
drifting-Zipf batches and params: the decayed histogram, the rebuild
versions and rankings, the write-through hot rows and the int8 mirror;
the snapshot rule between a trainer that steps in place and the engines
it publishes to; and the broadcast blobs, which decode across packages.

Tolerances:
  * histogram, versions, hot_ids, slot_of, losses' count: exact (host
    numpy on equal batches; the ranking depends on the histogram only);
  * losses rtol=1e-5; hot rows and arena atol=5e-6: as
    tests/test_torch_training.py states for K <= 5 steps at lr 1e-2 on
    DLRM_SMOKE (row-wise Adagrad moves a row by up to ~0.1 a step, and
    two summation orders change that move by a few 1e-6 of itself);
  * int8 mirror against the reference's: dequantized values within one
    code step (scale) + 5e-6, since arenas ~1e-6 apart may round a value
    near a code boundary either way; against the port's own full
    requantization: exact;
  * within the port: served probabilities equal the uncached forward
    bit for bit (the hot/cold law, params copied exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.training import OnlineCacheConfig as JOnlineCacheConfig
from repro.training import OnlineTrainer as JOnlineTrainer
from repro.training import VersionedHotCache as JVersionedHotCache
from repro.training import make_drifting_zipf as j_make_drifting_zipf
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch
from repro_torch.training import (OnlineCacheConfig, OnlineTrainer,
                                  VersionedHotCache, VersionedSource,
                                  make_drifting_zipf)
from repro_torch.training.online import _patch_hot_rows

torch.set_num_threads(1)

MAX_L = 6
LR = 1e-2
K = 16
R = 3


def _np_params(seed=0):
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(seed),
                                                J_CFG))


def _gen(seed=7, **kw):
    kw = {"batch_size": 8, "mean_l": 3, "max_l": MAX_L,
          "drift_per_batch": 1, "seed": seed, **kw}
    return make_drifting_zipf(CFG, **kw)


def _trainer(np_params, **cache_kw):
    return OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                         max_l=MAX_L, lr=LR, device="cpu",
                         cache_cfg=OnlineCacheConfig(k=K, refresh_every=R,
                                                     **cache_kw))


def _engine(trainer, **kw):
    return RecEngine(CFG, trainer.params, source="cached", cache_k=K,
                     cache_trace=np.ones(trainer.spec.total_rows),
                     max_l=MAX_L, max_batch=8, max_wait_ms=0.0,
                     buckets=(8,), device="cpu", **kw)


def _serve(engine, batch):
    reqs = requests_from_ragged_batch(batch, CFG.n_tables)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    return np.array([r.prob for r in reqs], np.float32)


def _forward(params, batch, source=None):
    """The forward over ``source`` (default: uncached, as the fp plan
    serves it)."""
    step = t_dlrm.make_ragged_serve_step(CFG, max_l=MAX_L)
    return step(params, {k: torch.from_numpy(np.asarray(batch[k]))
                         for k in ("dense", "indices", "offsets")},
                source).numpy()


def test_drifting_zipf_is_the_reference_stream():
    for seed, drift in ((0, 0), (5, 3)):
        ours = _gen(seed=seed, drift_per_batch=drift)
        theirs = j_make_drifting_zipf(J_CFG, batch_size=8, mean_l=3,
                                      max_l=MAX_L, drift_per_batch=drift,
                                      seed=seed)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("quantize_cold", [False, True])
def test_caching_trainer_matches_reference_trainer(quantize_cold):
    np_params = _np_params()
    j_trainer = JOnlineTrainer(
        J_CFG, jax.tree.map(jnp.asarray, np_params), max_l=MAX_L, lr=LR,
        cache_cfg=JOnlineCacheConfig(k=K, refresh_every=R,
                                     quantize_cold=quantize_cold))
    trainer = _trainer(np_params, quantize_cold=quantize_cold)
    ours, theirs = _gen(), _gen()
    for step in range(R + 2):
        loss = trainer.train_step(next(ours))
        j_loss = j_trainer.train_step(next(theirs))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        np.testing.assert_array_equal(trainer.hist, j_trainer.hist)
        assert trainer.version == j_trainer.version == (step + 1) // R
        assert (trainer.cache is None) == (j_trainer.cache is None)
        if trainer.cache is not None:
            for f in ("hot_ids", "slot_of"):
                np.testing.assert_array_equal(
                    getattr(trainer.cache, f).numpy(),
                    np.asarray(getattr(j_trainer.cache, f)))
            np.testing.assert_allclose(trainer.cache.hot_rows.numpy(),
                                       np.asarray(j_trainer.cache.hot_rows),
                                       rtol=0, atol=5e-6)
            assert not trainer.cache.hot_rows[-1].any()
    np.testing.assert_allclose(trainer.params["arena"].numpy(),
                               np.asarray(j_trainer.params["arena"]),
                               rtol=0, atol=5e-6)
    if quantize_cold:
        full = es.QuantizedArena.from_arena(trainer.params["arena"])
        trainer.refresh_quantized()
        assert torch.equal(trainer.cold_q.q, full.q)
        assert torch.equal(trainer.cold_q.scales, full.scales)
        assert not trainer._dirty_q.any()
        assert trainer._dirty_q.device == trainer.params["arena"].device
        j_trainer.refresh_quantized()
        j_q = j_trainer.cold_q
        deq = (trainer.cold_q.q.float() * trainer.cold_q.scales).numpy()
        j_deq = np.asarray(j_q.q, np.float32) * np.asarray(j_q.scales)
        step = np.asarray(j_q.scales)
        assert (np.abs(deq - j_deq) <= step + 5e-6).all()
        assert isinstance(trainer.serving_source().cold, es.QuantizedArena)


@pytest.mark.parametrize("sparse", [True, False])
def test_write_through_keeps_the_null_slot_zero_and_the_law(sparse):
    """After every step the miss slot is zero and a lookup through the
    live cache equals the uncached lookup bit for bit, in both modes."""
    np_params = _np_params(1)
    trainer = OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                            max_l=MAX_L, lr=LR, sparse=sparse, device="cpu",
                            cache_cfg=OnlineCacheConfig(k=K, refresh_every=2))
    gen = _gen(seed=3)
    for _ in range(7):
        trainer.train_step(next(gen))
        if trainer.cache is None:
            continue
        assert not trainer.cache.hot_rows[-1].any()
        b = next(gen)
        idx, off = torch.from_numpy(b["indices"]), torch.from_numpy(
            b["offsets"])
        arena = trainer.params["arena"]
        got = es.lookup_bags(es.CachedSource(trainer.cache,
                                             es.FpArena(arena)),
                             trainer.spec, idx, off, max_l=MAX_L)
        want = es.lookup_bags(es.FpArena(arena), trainer.spec, idx, off,
                              max_l=MAX_L)
        assert torch.equal(got, want)


def test_patch_hot_rows_matches_reference_and_leaves_the_old_cache():
    spec = se.ArenaSpec(2, 20, 8)
    j_spec = j_se.ArenaSpec(2, 20, 8)
    rng = np.random.RandomState(0)
    arena = rng.randn(spec.total_rows, 8).astype(np.float32)
    arena[spec.null_row] = 0.0
    counts = rng.randint(0, 9, spec.total_rows)
    cache = se.build_hot_cache(torch.from_numpy(arena), spec, counts, 6)
    j_cache = j_se.build_hot_cache(jnp.asarray(arena), j_spec, counts, 6)
    hot_ids = cache.hot_ids.numpy()
    cold = [r for r in range(spec.null_row) if r not in set(hot_ids)][:3]
    rows = np.sort(np.concatenate([hot_ids[:2], cold])).astype(np.int32)
    rows = np.concatenate([rows, [spec.null_row] * 4]).astype(np.int32)
    arena2 = arena.copy()
    arena2[rows[:-4]] += 1.5
    before = cache.hot_rows.clone()
    patched = _patch_hot_rows(cache, torch.from_numpy(arena2),
                              spec.null_row, torch.from_numpy(rows))
    from repro.training.online import _patch_hot_rows as j_patch
    j_patched = j_patch(j_cache, jnp.asarray(arena2), j_spec.null_row,
                        jnp.asarray(rows))
    np.testing.assert_array_equal(patched.hot_rows.numpy(),
                                  np.asarray(j_patched.hot_rows))
    assert torch.equal(cache.hot_rows, before)      # a new cache
    assert not patched.hot_rows[-1].any()           # slot K stays zero
    assert patched.slot_of is cache.slot_of


def test_sync_engine_follows_every_step_and_copies():
    """Between rebuilds every step publishes (params, patched cache); the
    engine gets copies, not the trainer's tensors."""
    trainer = _trainer(_np_params(2))
    engine = _engine(trainer)
    gen = _gen(seed=11)
    assert not trainer.sync_engine(engine)          # nothing built yet
    synced = 0
    for _ in range(8):
        trainer.train_step(next(gen))
        if trainer.sync_engine(engine):
            synced += 1
            # the engine's own cache, at its own addresses, holds the
            # trainer's rows
            for a, b in zip(es.source_structure(engine.cache)[1],
                            es.source_structure(trainer.cache)[1]):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
            for a, b in zip(tree_leaves(engine.params),
                            tree_leaves(trainer.params)):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
            assert engine.source.cold.arena is engine.params["arena"]
        assert not trainer.sync_engine(engine)      # idempotent per step
    assert synced == 8 - R + 1
    assert engine.cache_version == trainer.version


@pytest.mark.parametrize("quantize_cold", [False, True])
def test_snapshot_rule(quantize_cold):
    """After a sync the engine serves the uncached forward on the
    trainer's params; after two more in-place steps without a sync it
    still serves the forward as of the sync."""
    trainer = _trainer(_np_params(3), quantize_cold=quantize_cold)
    engine = _engine(trainer, quantize_cold=quantize_cold)
    gen = _gen(seed=5)
    for _ in range(R):
        trainer.train_step(next(gen))
    assert trainer.sync_engine(engine)
    at_sync = tree_map(lambda t: t.clone(), trainer.params)
    # the int8 mirror is replaced, never patched, so it needs no copy
    src = trainer.serving_source() if quantize_cold else None
    b = next(gen)
    served = _serve(engine, b)
    np.testing.assert_array_equal(served, _forward(at_sync, b, src))
    for _ in range(2):
        trainer.train_step(next(gen))
    assert not torch.equal(trainer.params["arena"], at_sync["arena"])
    again = _serve(engine, b)
    np.testing.assert_array_equal(again, served)
    if not quantize_cold:
        assert not np.array_equal(_forward(trainer.params, b), served)
        assert trainer.sync_engine(engine)
        np.testing.assert_array_equal(_serve(engine, b),
                                      _forward(trainer.params, b))


def test_publish_apply_and_stale_artifacts():
    trainer = _trainer(_np_params(4))
    engine = _engine(trainer)
    gen = _gen(seed=9)
    for _ in range(R):
        trainer.train_step(next(gen))
    first = trainer.publish()
    for _ in range(R):
        trainer.train_step(next(gen))
    blob = trainer.publish()
    art = VersionedHotCache.deserialize(blob, device="cpu")
    assert art.version == trainer.version == 2
    engine.params = trainer.params
    assert art.apply(engine) and engine.cache_version == 2
    assert not art.apply(engine)                    # idempotent
    b = next(gen)
    np.testing.assert_array_equal(_serve(engine, b),
                                  _forward(trainer.params, b))
    old = VersionedHotCache.deserialize(first, device="cpu")
    assert not old.apply(engine)                    # reordered: absorbed
    with pytest.raises(ValueError, match="stale"):
        engine.update_cache(old.cache, version=old.version)
    with pytest.raises(ValueError, match="artifact"):
        VersionedHotCache.deserialize(b"junk", device="cpu")


def test_publish_source_adopted_by_a_fresh_engine():
    trainer = _trainer(_np_params(5))
    gen = _gen(seed=13)
    assert trainer.publish_source() is None
    for _ in range(R + 1):
        trainer.train_step(next(gen))
    blob = trainer.publish_source(include_head=True)
    fresh = RecEngine(CFG, t_dlrm.params_from_numpy(_np_params(99), "cpu"),
                      source="cached", cache_k=K, max_l=MAX_L, max_batch=8,
                      buckets=(8,), device="cpu")
    art = VersionedSource.deserialize(blob, device="cpu")
    assert art.apply(fresh) and fresh.source_version == trainer.version
    b = next(gen)
    np.testing.assert_array_equal(_serve(fresh, b),
                                  _forward(trainer.params, b))


def _leaves_equal(a_leaves, b_leaves):
    a_leaves, b_leaves = list(a_leaves), list(b_leaves)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hot_cache_blobs_decode_across_packages():
    np_params = _np_params()
    spec = t_dlrm.arena_spec(CFG)
    counts = np.random.RandomState(1).randint(0, 5, spec.total_rows)
    j_cache = j_se.build_hot_cache(jnp.asarray(np_params["arena"]),
                                   j_dlrm.arena_spec(J_CFG), counts, K)
    arena = torch.from_numpy(np.array(np_params["arena"]))
    cache = se.build_hot_cache(arena, spec, counts, K)
    fields = ("hot_rows", "slot_of", "hot_ids")
    mine = VersionedHotCache.deserialize(
        JVersionedHotCache(j_cache, 3).serialize(), device="cpu")
    theirs = JVersionedHotCache.deserialize(
        VersionedHotCache(cache, 4).serialize())
    assert (mine.version, theirs.version) == (3, 4)
    _leaves_equal((getattr(mine.cache, f) for f in fields),
                  (getattr(j_cache, f) for f in fields))
    _leaves_equal((getattr(cache, f) for f in fields),
                  (getattr(theirs.cache, f) for f in fields))


def test_source_blobs_decode_across_packages():
    np_params = _np_params()
    spec, j_spec = t_dlrm.arena_spec(CFG), j_dlrm.arena_spec(J_CFG)
    counts = np.ones(spec.total_rows)
    ja = jnp.asarray(np_params["arena"])
    ta = torch.from_numpy(np.array(np_params["arena"]))
    j_cache = j_se.build_hot_cache(ja, j_spec, counts, K)
    cache = se.build_hot_cache(ta, spec, counts, K)
    jq = j_es.QuantizedArena.from_arena(ja)
    q = es.QuantizedArena.from_arena(ta)
    j_head = {k: np_params[k] for k in ("bottom", "top")}
    head = {k: v for k, v in t_dlrm.params_from_numpy(np_params, "cpu")
            .items() if k != "arena"}
    pairs = [(es.FpArena(ta), j_es.FpArena(ja)), (q, jq),
             (es.CachedSource(cache, es.FpArena(ta), coherent=True),
              j_es.CachedSource(j_cache, j_es.FpArena(ja), coherent=True)),
             (es.CachedSource(cache, q), j_es.CachedSource(j_cache, jq))]
    for src, j_src in pairs:
        mine = VersionedSource.deserialize(
            j_es.VersionedSource(j_src, 7, head=j_head).serialize(),
            device="cpu")
        theirs = j_es.VersionedSource.deserialize(
            VersionedSource(src, 8, head=head).serialize())
        assert (mine.version, theirs.version) == (7, 8)
        assert type(mine.source).__name__ == type(j_src).__name__
        assert type(theirs.source).__name__ == type(src).__name__
        assert es.source_structure(mine.source)[0] \
            == es.source_structure(src)[0]
        _leaves_equal(es.source_structure(mine.source)[1],
                      jax.tree_util.tree_leaves(j_src))
        _leaves_equal(es.source_structure(src)[1],
                      jax.tree_util.tree_leaves(theirs.source))
        assert isinstance(mine.head["bottom"], list)
        assert isinstance(mine.head["bottom"][0], tuple)
        _leaves_equal(tree_leaves(mine.head),
                      jax.tree_util.tree_leaves(j_head))
        _leaves_equal(tree_leaves(head),
                      jax.tree_util.tree_leaves(theirs.head))
        if isinstance(src, es.CachedSource):
            assert mine.source.coherent == j_src.coherent
            assert theirs.source.coherent == src.coherent


def test_unported_sources_in_a_blob_name_their_item():
    # table groups and sharded sources decode since they are ported: a
    # reference ShardedArena blob holds the unsharded rows, and without a
    # mesh the port serves its inner source replicated
    from repro.launch.mesh import make_mesh
    arena = jnp.arange(44.0).reshape(11, 4)
    sharded = j_es.ShardedArena(j_es.FpArena(arena),
                                make_mesh((1,), ("model",)))
    src = VersionedSource.deserialize(
        j_es.VersionedSource(sharded, 1).serialize(), device="cpu").source
    assert isinstance(src, es.FpArena)
    np.testing.assert_array_equal(src.arena.numpy(), np.asarray(arena))
    with pytest.raises(ValueError, match="artifact"):
        VersionedSource.deserialize(b"junk", device="cpu")


def test_trainer_refusals_and_host_side_histogram():
    np_params = _np_params()
    plain = OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                          max_l=MAX_L, device="cpu")
    with pytest.raises(ValueError, match="cache_cfg"):
        plain.rebuild_cache()
    with pytest.raises(ValueError, match="quantize_cold"):
        plain.refresh_quantized()
    assert plain.publish() is None and plain.snapshot() is None
    b = next(_gen())
    plain.observe(b)
    assert not plain.hist.any()                     # no cache, no counting
    trainer = _trainer(np_params)
    trainer.observe(b)
    np.testing.assert_array_equal(
        trainer.hist, se.trace_row_counts(trainer.spec, b["indices"],
                                          b["offsets"]).astype(np.float64))
    engine = _engine(trainer, quantize_cold=True)
    for _ in range(R):
        trainer.train_step(next(_gen()))
    with pytest.raises(ValueError, match="quantize_cold"):
        trainer.sync_engine(engine)
