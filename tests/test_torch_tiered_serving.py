"""The port's tiered serving path against the JAX package: ``RecEngine``
on a ``SourceSpec(tiers=TierPolicy(...))`` plan (int4 or host cold)
against the JAX engine on the same requests, with the host tier's
staging counts; the swap boundary of a tiered engine; the tiered
``OnlineTrainer`` against the JAX trainer over 5 steps and a migration;
and the snapshot rule for an engine fed by a trainer.

Tolerances:
  * probabilities against the JAX engine: atol=1e-5 (fp32 logits of O(1)
    through sigmoid, summed in other orders; the int8 and int4 codes are
    the same on both sides);
  * staging counts (``stats()["prefetch"]``): exact, the same numpy
    bookkeeping over the same requests;
  * trainer: histogram, versions, ``tier_slot`` and ``hot_ids`` exact
    (host numpy on equal batches); losses rtol=1e-5 and hot rows, arena
    and warm/cold values within the bounds of
    tests/test_torch_online_cache.py (5e-6; a dequantized value within
    one code step + 5e-6, since arenas ~1e-6 apart may round a value at
    a code boundary either way);
  * within the port: the write-through law (hot rows equal the arena's
    rows, ``torch.equal``) and post-sync probabilities equal to the
    forward over the trainer's serving source bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import storage as j_st
from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.data import DLRMSynthetic
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro.training import OnlineCacheConfig as JOnlineCacheConfig
from repro.training import OnlineTrainer as JOnlineTrainer
from repro_torch import storage as t_st
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.training import (OnlineCacheConfig, OnlineTrainer,
                                  make_drifting_zipf)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

MAX_L = 6
LR = 1e-2
R = 3


def _pols(cold, **kw):
    kw = {"hot": 24, "warm": 120, "cold": cold, "staging_rows": 256,
          "max_stage_per_batch": 32, **kw}
    return t_st.TierPolicy(**kw), j_st.TierPolicy(**kw)


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


def _drive(engine, reqs, group=8):
    """Submit a group, then serve one step: the queue's next group is
    what the engine prefetches."""
    for i in range(0, len(reqs), group):
        for r in reqs[i:i + group]:
            engine.submit(r)
        engine.step()
    engine.drain()
    return np.array([r.prob for r in reqs])


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_tiered_engine_matches_reference_engine(np_params, params, counts,
                                                cold):
    pol, j_pol = _pols(cold)
    rb = _batch(40)
    engine = _engine(params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    j_engine = JRecEngine(J_CFG, jax.tree.map(jnp.asarray, np_params),
                          source=j_es.SourceSpec(tiers=j_pol),
                          cache_trace=counts, max_l=MAX_L, max_batch=8,
                          max_wait_ms=0.0, buckets=(2, 4, 8))
    engine.warmup()
    j_engine.warmup()
    got = _drive(engine, t_requests(rb, CFG.n_tables))
    want = _drive(j_engine, j_requests(rb, J_CFG.n_tables))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    stats, j_stats = engine.stats(), j_engine.stats()
    assert stats["path"] == j_stats["path"] == "tiered"
    assert stats["source"] == j_stats["source"] == f"tiered({cold})"
    assert stats["cache_hit_rate"] is None
    if cold == "host":
        assert stats["prefetch"] == j_stats["prefetch"]
        p = stats["prefetch"]
        assert p["hits"] + p["misses"] == p["touches"] > 0
        assert p["hits"] > 0                     # the lookahead landed
    else:
        assert "prefetch" not in stats and "prefetch" not in j_stats


def test_tiered_plan_bags_of_hot_rows_equal_the_fp_plan(params, counts):
    pol, _ = _pols("int4")
    engine = _engine(params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    hot = engine.source.hot_ids.numpy()
    t, v = CFG.n_tables, CFG.rows_per_table
    rows = [hot[hot // v == j] % v for j in range(t)]
    rb = {"dense": _batch(4)["dense"],
          "indices": np.concatenate([rows[j][:3] for _ in range(4)
                                     for j in range(t)]).astype(np.int32)}
    rb["offsets"] = np.concatenate([[0], np.cumsum(
        [len(rows[j][:3]) for _ in range(4) for j in range(t)])]
    ).astype(np.int32)
    got = _drive(engine, t_requests(rb, t))
    want = _drive(_engine(params), t_requests(rb, t))
    np.testing.assert_array_equal(got, want)


def test_host_engine_prefetch_and_stage_sequence(params, counts):
    pol, _ = _pols("host", hot=0, warm=0, staging_rows=128)
    engine = _engine(params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    store = engine._host_stores[0]
    reqs = t_requests(_batch(16, seed=2), CFG.n_tables)
    engine.prefetch(reqs[:8])                    # uncounted
    assert store.touches == 0 and store.stats()["resident"] > 0
    got = _drive(engine, reqs)
    p = engine.stats()["prefetch"]
    assert p["hits"] + p["misses"] == p["touches"]
    assert p["host_bytes"] == store.host_rows.nbytes
    # warm = 0 and host rows are exact fp32: the fp plan's bits
    np.testing.assert_array_equal(
        got, _drive(_engine(params), t_requests(_batch(16, seed=2),
                                                CFG.n_tables)))


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_tiered_swap_keeps_the_engine_tensors(params, counts, cold):
    pol, _ = _pols(cold)
    engine = _engine(params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    spec = engine.spec
    own = engine.source
    ptrs = [t.data_ptr() for t in es.source_structure(own)[1]]
    store = engine._host_stores[0] if cold == "host" else None
    rb = _batch(8, seed=5)
    hist = se.trace_row_counts(spec, rb["indices"], rb["offsets"])
    built = t_st.build_tiered(engine.params["arena"] + 0.0, spec, pol, hist)
    engine.update_source(built, version=3)
    assert engine.source is own and engine.source_version == 3
    assert [t.data_ptr() for t in es.source_structure(own)[1]] == ptrs
    for x, y in zip(es.source_structure(own)[1][:5],
                    es.source_structure(built)[1][:5]):
        assert torch.equal(x, y)
    if cold == "host":
        assert engine._host_stores == [store]
        assert store is not built.cold.store
        np.testing.assert_array_equal(store.host_rows,
                                      built.cold.store.host_rows)
    got = _drive(engine, t_requests(rb, CFG.n_tables))
    ref = _engine(params, source=built)          # its own clone of built
    np.testing.assert_array_equal(got, _drive(ref, t_requests(
        rb, CFG.n_tables)))
    with pytest.raises(ValueError, match="stale"):
        engine.update_source(built, version=2)
    other, _ = _pols(cold, hot=12)
    # int4: hot_rows change shape; host: the store's rows too (structure)
    with pytest.raises(ValueError, match="changed"):
        engine.update_source(t_st.build_tiered(engine.params["arena"], spec,
                                               other, hist), version=4)
    with pytest.raises(ValueError, match="structure"):
        engine.update_source(es.FpArena(engine.params["arena"]), version=4)


def test_fixed_layout_keeps_refusing_tiers():
    pol, _ = _pols("int4")
    with pytest.raises(ValueError, match="fixed"):
        es.SourceSpec(layout="fixed", tiers=pol)


# ---------------------------------------------------------------------------
# the tiered online trainer
# ---------------------------------------------------------------------------

def _gen(seed=7):
    return make_drifting_zipf(CFG, batch_size=8, mean_l=3, max_l=MAX_L,
                              drift_per_batch=1, seed=seed)


def _trainer(np_params, pol):
    return OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                         max_l=MAX_L, lr=LR, device="cpu",
                         cache_cfg=OnlineCacheConfig(k=0, refresh_every=R,
                                                     tiers=pol))


def _dequant_close(a, s, b, j_s):
    """Dequantized values within one code step (the larger scale of the
    row) + 5e-6."""
    step = np.maximum(s.numpy(), np.asarray(j_s))
    assert (np.abs(a.numpy() - np.asarray(b)) <= step + 5e-6).all()


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_tiered_trainer_matches_reference_trainer(np_params, cold):
    pol, j_pol = _pols(cold)
    trainer = _trainer(np_params, pol)
    j_trainer = JOnlineTrainer(
        J_CFG, jax.tree.map(jnp.asarray, np_params), max_l=MAX_L, lr=LR,
        cache_cfg=JOnlineCacheConfig(k=0, refresh_every=R, tiers=j_pol))
    ours, theirs = _gen(), _gen()
    for step in range(R + 2):
        loss = trainer.train_step(next(ours))
        j_loss = j_trainer.train_step(next(theirs))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        np.testing.assert_array_equal(trainer.hist, j_trainer.hist)
        assert trainer.version == j_trainer.version == (step + 1) // R
        src, j_src = trainer.tiered, j_trainer.tiered
        for f in ("tier_slot", "hot_ids"):
            np.testing.assert_array_equal(getattr(src, f).numpy(),
                                          np.asarray(getattr(j_src, f)))
        np.testing.assert_allclose(src.hot_rows.numpy(),
                                   np.asarray(j_src.hot_rows), rtol=0,
                                   atol=5e-6)
        # the write-through law, within the port
        arena = trainer.params["arena"]
        assert torch.equal(src.hot_rows[:-1], arena[src.hot_ids.long()])
        assert not src.hot_rows[-1].any()
        _dequant_close(src.warm.q.float() * src.warm.scales,
                       src.warm.scales,
                       np.asarray(j_src.warm.q, np.float32)
                       * np.asarray(j_src.warm.scales), j_src.warm.scales)
        if cold == "int4":
            _dequant_close(src.cold.dequantize(), src.cold.scales,
                           j_src.cold.dequantize(), j_src.cold.scales)
        else:
            np.testing.assert_allclose(src.cold.store.host_rows,
                                       j_src.cold.store.host_rows, rtol=0,
                                       atol=5e-6)
    assert trainer.last_migration is not None
    assert trainer.serving_source() is trainer.tiered
    assert trainer.snapshot() is None and trainer.publish() is None
    blob = trainer.publish_source()
    v = j_es.VersionedSource.deserialize(blob)
    assert v.version == trainer.version == j_trainer.version
    assert isinstance(v.source, j_st.TieredSource)


def test_migration_equals_a_rebuild_from_the_same_arena(np_params):
    """The trainer's incremental retier against ``build_tiered`` from its
    arena and histogram: equal, with the dirty mask keeping it exact."""
    pol, _ = _pols("int4")
    trainer = _trainer(np_params, pol)
    gen = _gen(seed=3)
    for _ in range(2 * R):
        trainer.train_step(next(gen))
        if trainer.steps % R == 0:
            full = t_st.build_tiered(trainer.params["arena"], trainer.spec,
                                     pol, trainer.hist)
            for x, y in zip(es.source_structure(trainer.tiered)[1],
                            es.source_structure(full)[1]):
                assert torch.equal(x, y)


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_sync_engine_serves_the_trainer_source(np_params, counts, cold):
    pol, _ = _pols(cold)
    trainer = _trainer(np_params, pol)
    engine = _engine(trainer.params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    own = engine.source
    ptrs = [t.data_ptr() for t in es.source_structure(own)[1]]
    arena_ptr = engine.params["arena"].data_ptr()
    gen, traffic = _gen(seed=5), _gen(seed=6)
    step = t_dlrm.make_ragged_serve_step(CFG, max_l=MAX_L)
    for i in range(1, 2 * R + 1):
        trainer.train_step(next(gen))
        assert trainer.sync_engine(engine)
        assert not trainer.sync_engine(engine)   # nothing new
        assert engine.source is own and engine.source_version \
            == trainer.version
        assert [t.data_ptr() for t in es.source_structure(own)[1]] == ptrs
        assert engine.params["arena"].data_ptr() == arena_ptr
        rb = next(traffic)
        reqs = t_requests(rb, CFG.n_tables)
        got = _drive(engine, reqs)
        # the forward over the trainer's own source, staged with the
        # same rows: the engine's copy serves its bits
        src = trainer.serving_source()
        for store in t_st.host_stores_of(src):
            store.stage_arena(engine._host_ids(reqs))
        batch, _ = engine._assemble(reqs, 8)
        want = step(trainer.params, batch, src).numpy()[:len(reqs)]
        np.testing.assert_array_equal(got.astype(np.float32), want)


def test_host_snapshot_rule(np_params, counts):
    """An engine fed by a host-cold trainer has its own store: the
    trainer's migration (which resets its store) and later steps do not
    reach the engine before the next sync."""
    pol, _ = _pols("host")
    trainer = _trainer(np_params, pol)
    engine = _engine(trainer.params, source=es.SourceSpec(tiers=pol),
                     cache_trace=counts)
    gen = _gen(seed=8)
    trainer.train_step(next(gen))
    trainer.sync_engine(engine)
    mine = engine._host_stores[0]
    theirs = trainer.tiered.cold.store
    assert mine is not theirs
    rb = _batch(8, seed=21)
    first = _drive(engine, t_requests(rb, CFG.n_tables))
    staging = mine.staging.clone()
    for _ in range(R):                           # a migration among them
        trainer.train_step(next(gen))
    assert trainer.version == 1 and theirs.stats()["resident"] == 0
    assert torch.equal(mine.staging, staging)
    np.testing.assert_array_equal(
        _drive(engine, t_requests(rb, CFG.n_tables)), first)
    trainer.sync_engine(engine)
    assert engine._host_stores == [mine] and mine._origin is theirs.generation
    np.testing.assert_array_equal(mine.host_rows, theirs.host_rows)


# ---------------------------------------------------------------------------
# prefetch accounting with several engines per trainer (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def _prefetch_counts(np_params, counts, n_engines):
    """One host-cold trainer on each side and ``n_engines`` engines; engine
    i is synced after train step i and serves 16 requests of its own.
    Returns each side's (hits, misses, touches) per engine."""
    pol, j_pol = _pols("host")
    trainer = _trainer(np_params, pol)
    j_trainer = JOnlineTrainer(
        J_CFG, jax.tree.map(jnp.asarray, np_params), max_l=MAX_L, lr=LR,
        cache_cfg=JOnlineCacheConfig(k=0, refresh_every=R, tiers=j_pol))
    engines = [_engine(trainer.params, source=es.SourceSpec(tiers=pol),
                       cache_trace=counts) for _ in range(n_engines)]
    j_engines = [JRecEngine(J_CFG, jax.tree.map(jnp.asarray, np_params),
                            source=j_es.SourceSpec(tiers=j_pol),
                            cache_trace=counts, max_l=MAX_L, max_batch=8,
                            max_wait_ms=0.0, buckets=(2, 4, 8))
                 for _ in range(n_engines)]
    gen, j_gen = _gen(seed=8), _gen(seed=8)
    for i, (engine, j_engine) in enumerate(zip(engines, j_engines)):
        trainer.train_step(next(gen))
        j_trainer.train_step(next(j_gen))
        trainer.sync_engine(engine)
        j_trainer.sync_engine(j_engine)
        rb = _batch(16, seed=21 + i)
        _drive(engine, t_requests(rb, CFG.n_tables))
        _drive(j_engine, j_requests(rb, J_CFG.n_tables))

    def counts_of(e):
        p = e.stats()["prefetch"]
        return [p["hits"], p["misses"], p["touches"]]
    return ([counts_of(e) for e in engines],
            [counts_of(e) for e in j_engines])


@pytest.mark.parametrize("n_engines", [1, 2])
def test_prefetch_accounting_with_engines_sharing_a_trainer(n_engines):
    """The snapshot rule gives each engine its own ``HostStore``
    (``HostStore.adopt``), where a reference engine synced from a
    host-cold trainer stages into, and reads, the trainer's store.

    * One engine per trainer: the two count the same, exactly.
    * Two engines: the reference reports the shared store's totals on
      both engines; the port reports each engine's own counts, whose
      touches sum to the reference's total (each touch is counted once,
      by the engine that served it). Hits differ: in the shared store a
      row staged for one engine is a hit for the other.

    Each case runs in a fresh process: in one process the reference's
    counts for a second trainer and engine were seen to continue from an
    earlier pair's (888 touches where a fresh process counts 137)."""
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]\n"
            "import jax, numpy as np\n"
            "import test_torch_tiered_serving as t\n"
            "np_params = jax.tree.map(np.asarray, t.j_dlrm.init("
            "jax.random.PRNGKey(1), t.J_CFG))\n"
            "rb = t.DLRMSynthetic(t.J_CFG, seed=3).ragged_batch("
            "64, mean_l=3, max_l=t.MAX_L)\n"
            "counts = t.se.trace_row_counts(t.t_dlrm.arena_spec(t.CFG), "
            "rb['indices'], rb['offsets'])\n"
            f"print(json.dumps(t._prefetch_counts(np_params, counts, "
            f"{n_engines})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    ours, theirs = json.loads(run.stdout.strip().splitlines()[-1])
    if n_engines == 1:
        assert ours == theirs
        return
    assert theirs[0] == theirs[1]                 # one shared store
    assert sum(t for _, _, t in ours) == theirs[0][2]
    for hits, misses, touches in ours:
        assert hits + misses == touches
    assert ours[0] != ours[1]                     # each engine its own
    assert sum(h for h, _, _ in ours) < theirs[0][0]
