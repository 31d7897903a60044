"""The port's OnlineGroupTrainer and tiered group members against the JAX
reference.

``OnlineGroupTrainer`` against the reference's on ``DLRM_HET_SMOKE``
(params carried across through ``params_from_numpy``, the same
drifting-Zipf batches) under three mixes of per-table plans: cached,
int8 and fp members; host-tiered, int4-tiered and cached members; an
int8 member beside a host-tiered one. Per step: the losses, the decayed
histograms, the hot sets, the versions, the dirty masks and the
trainer's events; after the run the params. Blobs that either trainer
publishes decode in the other package. Within the port: the
write-through law, the int8 mirror against a full requantization, the
snapshot rule of ``sync_engine`` and a replica's adoption of a published
blob. Item 8: a group with a tiered member served by ``RecEngine``
against the reference's engine (a host store a tiered member, staging
per-table ids), and the grouped lookup against the per-table lookups
with a tiered member (the port of ``tests/test_storage.py``'s case).

Tolerances:
  * histograms, versions, hot_ids, slot_of, tier_slot, dirty masks,
    events, staging counts: exact (host numpy on equal batches; a
    ranking depends on the histogram only);
  * losses rtol=1e-5, hot rows and params atol=5e-6 over 7 steps at lr
    1e-2, as tests/test_torch_table_group.py states for the group step
    (row-wise Adagrad moves a row by up to ~0.1 a step, and two
    summation orders change that move by a few 1e-6 of itself);
  * int8 and int4 values: dequantized within one code step + 5e-6 of the
    reference's (arenas ~1e-6 apart may round a value at a code boundary
    either way); against the port's own full rebuild: exact;
  * served probabilities against the JAX engine: atol=1e-5 (fp32 logits
    of O(1) through sigmoid, summed in other orders);
  * within the port: torch.equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import storage as j_st
from repro.configs import dlrm as j_cfgs
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro.training import OnlineGroupTrainer as JOnlineGroupTrainer
from repro_torch import storage as t_st
from repro_torch.configs import dlrm as t_cfgs
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.optim import tree_leaves
from repro_torch.serving import RecEngine
from repro_torch.serving.rec_engine import _paired_leaves, _same_layout
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.training import (OnlineGroupTrainer, OnlineTrainer,
                                  VersionedSource, make_drifting_zipf)

torch.set_num_threads(1)

HET, J_HET = t_cfgs.DLRM_HET_SMOKE, j_cfgs.DLRM_HET_SMOKE
MAX_L = 6
LR = 1e-2
R = 3
STEPS = 7


def _pol(mod, **kw):
    return mod.TierPolicy(**kw)


def _plans(kind, es_mod, st_mod):
    """One mix of per-table plans over DLRM_HET_SMOKE's three tables
    (2,000 x 16, 150 x 8, 9 x 4), built with either package's types."""
    tp = es_mod.TablePlan
    if kind == "mixed":
        return (tp(rows=2000, dim=16, cache_k=16, quantize=True),
                tp(rows=150, dim=8, cache_k=8), tp(rows=9, dim=4))
    if kind == "tiered":
        return (tp(rows=2000, dim=16,
                   tiers=_pol(st_mod, hot=32, warm=200, cold="host",
                              staging_rows=256, max_stage_per_batch=32)),
                tp(rows=150, dim=8, tiers=_pol(st_mod, hot=8, warm=40)),
                tp(rows=9, dim=4, cache_k=3))
    return (tp(rows=2000, dim=16, quantize=True),
            tp(rows=150, dim=8,
               tiers=_pol(st_mod, hot=8, warm=20, cold="host",
                          staging_rows=64, max_stage_per_batch=16)),
            tp(rows=9, dim=4))


KINDS = ("mixed", "tiered", "int8_host")


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(0),
                                                J_HET))


def _gen(seed=7):
    return make_drifting_zipf(HET, batch_size=8, mean_l=3, max_l=MAX_L,
                              drift_per_batch=1, seed=seed)


def _trainer(np_params, kind, **kw):
    return OnlineGroupTrainer(HET, t_dlrm.params_from_numpy(np_params, "cpu"),
                              max_l=MAX_L, plans=_plans(kind, es, t_st),
                              lr=LR, refresh_every=R, device="cpu", **kw)


def _j_trainer(np_params, kind):
    return JOnlineGroupTrainer(J_HET, jax.tree.map(jnp.asarray, np_params),
                               max_l=MAX_L,
                               plans=_plans(kind, j_es, j_st), lr=LR,
                               refresh_every=R)


def _dequant_close(a, s, b, j_s):
    """Dequantized values within one code step (the larger scale of the
    row) + 5e-6."""
    step = np.maximum(s.numpy(), np.asarray(j_s))
    assert (np.abs(a.numpy() - np.asarray(b)) <= step + 5e-6).all()


def _events(tel):
    return [(e.kind, e.version, e.attrs) for e in tel.events.query()
            if e.kind in ("hot_cache_rebuild", "tier_migration")]


@pytest.fixture(scope="module", params=KINDS)
def run(request, np_params):
    """Both trainers through STEPS steps on the same batches; the per-step
    observations compared by the tests below."""
    kind = request.param
    tr, j_tr = _trainer(np_params, kind), _j_trainer(np_params, kind)
    ours, theirs = _gen(), _gen()
    steps = []
    for _ in range(STEPS):
        loss, j_loss = tr.train_step(next(ours)), j_tr.train_step(
            next(theirs))
        steps.append({
            "loss": (loss, j_loss),
            "hists": [(a.copy(), b.copy())
                      for a, b in zip(tr.hists, j_tr.hists)],
            "version": (tr.version, j_tr.version),
            "dirty": [(None if a is None else a.numpy().copy(),
                       None if b is None else b.copy())
                      for a, b in zip(tr._dirty_q, j_tr._dirty_q)],
            "caches": [(c, jc) for c, jc in zip(tr.caches, j_tr.caches)],
            "tiered": [(x, jx) for x, jx in zip(tr.tiered, j_tr.tiered)],
            "cold_q": [(x, jx) for x, jx in zip(tr.cold_q, j_tr.cold_q)],
        })
    return kind, tr, j_tr, steps


def test_losses_histograms_and_versions(run):
    _, tr, j_tr, steps = run
    for i, s in enumerate(steps):
        np.testing.assert_allclose(*s["loss"], rtol=1e-5)
        for a, b in s["hists"]:
            np.testing.assert_array_equal(a, b)
        assert s["version"][0] == s["version"][1] == (i + 1) // R
    assert tr.steps == j_tr.steps == STEPS
    assert len(tr.losses) == STEPS


def test_hot_sets_and_rows(run):
    _, _, _, steps = run
    for s in steps:
        for c, jc in s["caches"]:
            assert (c is None) == (jc is None)
            if c is None:
                continue
            for f in ("hot_ids", "slot_of"):
                np.testing.assert_array_equal(getattr(c, f).numpy(),
                                              np.asarray(getattr(jc, f)))
            np.testing.assert_allclose(c.hot_rows.numpy(),
                                       np.asarray(jc.hot_rows), rtol=0,
                                       atol=5e-6)
        for x, jx in s["tiered"]:
            assert (x is None) == (jx is None)
            if x is None:
                continue
            for f in ("tier_slot", "hot_ids"):
                np.testing.assert_array_equal(getattr(x, f).numpy(),
                                              np.asarray(getattr(jx, f)))
            np.testing.assert_allclose(x.hot_rows.numpy(),
                                       np.asarray(jx.hot_rows), rtol=0,
                                       atol=5e-6)
            _dequant_close(x.warm.q.float() * x.warm.scales, x.warm.scales,
                           np.asarray(jx.warm.q, np.float32)
                           * np.asarray(jx.warm.scales), jx.warm.scales)
            if isinstance(x.cold, t_st.Int4Arena):
                _dequant_close(x.cold.dequantize(), x.cold.scales,
                               jx.cold.dequantize(), jx.cold.scales)
            else:
                np.testing.assert_allclose(x.cold.store.host_rows,
                                           jx.cold.store.host_rows, rtol=0,
                                           atol=5e-6)
        for x, jx in s["cold_q"]:
            assert (x is None) == (jx is None)
            if x is not None:
                _dequant_close(x.q.float() * x.scales, x.scales,
                               np.asarray(jx.q, np.float32)
                               * np.asarray(jx.scales), jx.scales)


def test_dirty_masks_and_events(run):
    _, tr, j_tr, steps = run
    for s in steps:
        for a, b in s["dirty"]:
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    ours, theirs = _events(tr.telemetry), _events(j_tr.telemetry)
    assert len(ours) >= STEPS // R and ours == theirs


def test_params_after_the_run(run):
    _, tr, j_tr, _ = run
    for key in ("bottom", "top", "proj", "tables"):
        for got, want in zip(tree_leaves(tr.params[key]),
                             jax.tree.leaves(j_tr.params[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=5e-6)


def test_blobs_decode_across_packages(run):
    """The port's published group (with its head) decodes in the
    reference, and the reference's in the port, tensor for tensor."""
    _, tr, j_tr, _ = run
    blob = tr.publish_source(include_head=True)
    j_back = j_es.VersionedSource.deserialize(blob)
    assert j_back.version == tr.version
    assert isinstance(j_back.source, j_es.TableGroupSource)
    assert sorted(j_back.head) == ["bottom", "proj", "top"]
    for a, b in zip(es.source_structure(tr.serving_source())[1],
                    jax.tree_util.tree_leaves(j_back.source)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = VersionedSource.deserialize(j_tr.publish_source(
        include_head=True), device="cpu")
    assert back.version == j_tr.version
    assert [type(m).__name__ for m in back.source.members] == \
        [type(m).__name__ for m in j_tr.serving_source().members]
    for a, b in zip(es.source_structure(back.source)[1],
                    jax.tree_util.tree_leaves(j_tr.serving_source())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tree_leaves(back.head["proj"])[0].shape == (16, 16)
    ev = tr.telemetry.events.query("publish")[-1]
    assert ev.attrs == {"artifact": "group_source", "bytes": len(blob)}


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_write_through_and_mirror_laws(np_params, kind):
    """After every step each hot copy equals its arena row (the hot slot
    of a tiered member too) and the null slots stay zero; after a
    rebuild every int8 mirror and tiered source equals a full rebuild
    from the live arena and histogram."""
    tr = _trainer(np_params, kind)
    gen = _gen(seed=3)
    for _ in range(2 * R):
        tr.train_step(next(gen))
        for t, arena in enumerate(tr.params["tables"]):
            c, x = tr.caches[t], tr.tiered[t]
            if c is not None:
                assert torch.equal(c.hot_rows[:-1],
                                   arena[c.hot_ids.long()])
                assert not c.hot_rows[-1].any()
            if x is not None:
                assert torch.equal(x.hot_rows[:-1],
                                   arena[x.hot_ids.long()])
                assert not x.hot_rows[-1].any()
        if tr.steps % R:
            continue
        for t, (plan, sp) in enumerate(zip(tr.plans, tr.specs)):
            arena = tr.params["tables"][t]
            if tr.cold_q[t] is not None:
                full = es.QuantizedArena.from_arena(arena)
                assert torch.equal(tr.cold_q[t].q, full.q)
                assert torch.equal(tr.cold_q[t].scales, full.scales)
            if tr.tiered[t] is not None:
                full = t_st.build_tiered(arena, sp, plan.tiers,
                                         tr.hists[t])
                for a, b in zip(es.source_structure(tr.tiered[t])[1],
                                es.source_structure(full)[1]):
                    if a.shape == b.shape:
                        assert torch.equal(a, b)


def _serve(engine, batch):
    reqs = t_requests(batch, HET.n_tables)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    return np.array([r.prob for r in reqs], np.float32)


def _engine(trainer):
    return RecEngine(HET, trainer.params, source=trainer.serving_source(),
                     max_l=MAX_L, max_batch=8, max_wait_ms=0.0,
                     buckets=(8,), device="cpu")


def test_sync_engine_serves_the_trainer_and_copies(np_params):
    """``sync_engine`` copies params and group into the engine's own
    tensors (their addresses fixed), gated on the trainer's step; served
    probabilities equal the forward over the trainer's serving source
    bit for bit, and a later in-place step does not reach the engine."""
    tr = _trainer(np_params, "mixed")
    gen = _gen(seed=5)
    tr.train_step(next(gen))
    eng = _engine(tr)
    ptrs = [t.data_ptr() for t in es.source_structure(eng.source)[1]]
    mine = {t.data_ptr() for t in tree_leaves(tr.params)} | \
        {t.data_ptr() for t in es.source_structure(tr.serving_source())[1]}
    step = t_dlrm.make_ragged_serve_step(HET, max_l=MAX_L)
    probe = next(gen)
    dev = {k: torch.from_numpy(probe[k]) for k in ("dense", "indices",
                                                     "offsets")}
    for i in range(2 * R):
        tr.train_step(next(gen))
        assert tr.sync_engine(eng) and not tr.sync_engine(eng)
        assert eng.source_version == tr.version
        want = step(tr.params, dev, tr.serving_source()).numpy()
        np.testing.assert_array_equal(_serve(eng, probe),
                                      want.astype(np.float32))
        assert [t.data_ptr() for t in es.source_structure(eng.source)[1]] \
            == ptrs
        assert not mine & {t.data_ptr()
                           for t in es.source_structure(eng.source)[1]}
    before = _serve(eng, probe)
    tr.train_step(next(gen))
    np.testing.assert_array_equal(_serve(eng, probe), before)


def test_replica_adopts_a_published_blob_with_tiered_members(np_params):
    """A remote replica: a fresh engine over a placeholder init adopts
    the trainer's blob (head and group: an int4-tiered, a cached and an
    int8 member) and serves what an engine synced in process serves, bit
    for bit. A host tier's blob carries its staged snapshot without its
    store, a structure the engine's own store does not have: as in the
    reference, the swap is refused."""
    plans = (es.TablePlan(rows=2000, dim=16,
                          tiers=t_st.TierPolicy(hot=32, warm=200)),
             es.TablePlan(rows=150, dim=8, cache_k=8),
             es.TablePlan(rows=9, dim=4, quantize=True))

    def trainer(kind_plans):
        return OnlineGroupTrainer(
            HET, t_dlrm.params_from_numpy(np_params, "cpu"), max_l=MAX_L,
            plans=kind_plans, lr=LR, refresh_every=R, device="cpu")

    tr = trainer(plans)
    gen = _gen(seed=11)
    for _ in range(R + 1):
        tr.train_step(next(gen))
    synced = _engine(tr)
    tr.sync_engine(synced)
    vs = VersionedSource.deserialize(tr.publish_source(include_head=True),
                                     device="cpu")
    other = t_dlrm.init(torch.Generator().manual_seed(9), HET, device="cpu")
    remote = RecEngine(HET, other, source=trainer(plans).serving_source(),
                       max_l=MAX_L, max_batch=8, max_wait_ms=0.0,
                       buckets=(8,), device="cpu")
    assert vs.apply(remote) and remote.source_version == tr.version
    assert not vs.apply(remote)
    probe = next(gen)
    np.testing.assert_array_equal(_serve(remote, probe),
                                  _serve(synced, probe))

    host = _trainer(np_params, "tiered")
    host.train_step(next(gen))
    blob = VersionedSource.deserialize(host.publish_source(), device="cpu")
    assert blob.source.members[0].cold.store is None
    eng = _engine(host)
    assert eng._host_tables == [0]
    assert eng._host_stores[0] is not host.tiered[0].cold.store
    with pytest.raises(ValueError, match="structure"):
        eng.update_source(blob.source, version=blob.version + 1)


def test_engine_takes_stepped_params_in_place(np_params):
    """A group train step returns its head before its tables, so the
    trainer's params hold their keys in another order than ``dlrm.init``
    gave them. An engine built from the init's params takes the stepped
    ones in place, key by key: every tensor keeps its address (on the
    card, no graph is captured again) and holds the trainer's values."""
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    eng = RecEngine(HET, params,
                    source=es.SourceSpec(tables=_plans("mixed", es, t_st)),
                    max_l=MAX_L, max_batch=8, buckets=(8,), device="cpu")

    def ptrs():
        return ([t.data_ptr() for t in tree_leaves(eng.params)]
                + [t.data_ptr() for t in es.source_structure(eng.source)[1]])

    before = ptrs()
    tr = _trainer(np_params, "mixed")
    tr.train_step(next(_gen()))
    assert list(tr.params) != list(eng.params)
    eng.params = tr.params
    assert ptrs() == before
    for k in tr.params:
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(eng.params[k]), tree_leaves(tr.params[k])))


def test_params_pair_by_path_at_every_level():
    """The engine pairs its tensors with the assigned ones by tree path,
    dict keys sorted at every level: a nested dict that holds its keys in
    another order still pairs each tensor with its namesake, also where
    the shapes are equal; trees of other paths do not pair."""
    g = torch.Generator().manual_seed(0)
    a = {"x": {"u": torch.randn(2, 3, generator=g),
               "v": torch.randn(2, 3, generator=g)},
         "w": [torch.randn(4, generator=g)]}
    b = {"w": [a["w"][0] + 1],
         "x": {"v": a["x"]["v"] + 2, "u": a["x"]["u"] + 3}}
    pairs = _paired_leaves(a, b)
    assert _same_layout(pairs)
    want = [(a["w"][0], b["w"][0]), (a["x"]["u"], b["x"]["u"]),
            (a["x"]["v"], b["x"]["v"])]
    assert len(pairs) == 3 and all(x is p and y is q for (x, y), (p, q)
                                   in zip(pairs, want))
    other = {"w": b["w"], "x": {"v": b["x"]["v"], "z": b["x"]["u"]}}
    assert _paired_leaves(a, other) is None and not _same_layout(None)
    assert not _same_layout(_paired_leaves(
        a, {"w": [torch.zeros(5)], "x": b["x"]}))


def test_group_trainer_refusals_and_telemetry(np_params):
    with pytest.raises(ValueError, match="heterogeneous"):
        OnlineGroupTrainer(t_cfgs.DLRM_SMOKE, {}, max_l=MAX_L, plans=(),
                           device="cpu")
    with pytest.raises(ValueError, match="table plans"):
        OnlineGroupTrainer(HET, t_dlrm.params_from_numpy(np_params, "cpu"),
                           max_l=MAX_L, plans=_plans("mixed", es, t_st)[:2],
                           device="cpu")
    with pytest.raises(ValueError, match="OnlineGroupTrainer"):
        OnlineTrainer(HET, t_dlrm.params_from_numpy(np_params, "cpu"),
                      max_l=MAX_L, device="cpu")
    tr = _trainer(np_params, "mixed")
    tr.train([next(_gen()) for _ in range(R)])
    snap = tr.telemetry.snapshot()
    assert snap["counters"]["train_steps_total"] == R
    assert snap["counters"]["train_rebuilds_total"] == 1
    assert snap["gauges"]["train_cache_version"] == 1


def test_group_trainer_runs_on_the_card_unless_asked(np_params,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineGroupTrainer(HET, t_dlrm.params_from_numpy(np_params, "cpu"),
                           max_l=MAX_L, plans=_plans("mixed", es, t_st))


# ---------------------------------------------------------------------------
# item 8: tiered members of a group, served
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def counts():
    b = next(make_drifting_zipf(HET, batch_size=64, mean_l=3, max_l=MAX_L,
                                seed=2))
    return es.group_trace_counts(t_dlrm.member_specs(HET), b["indices"],
                                 b["offsets"])


def _drive(engine, reqs, group=8):
    """Submit a group, then serve one step: the queue's next group is
    what the engine prefetches."""
    for i in range(0, len(reqs), group):
        for r in reqs[i:i + group]:
            engine.submit(r)
        engine.step()
    engine.drain()
    return np.array([r.prob for r in reqs])


@pytest.mark.parametrize("kind", ["tiered", "int8_host"])
def test_tiered_group_engine_matches_reference_engine(np_params, counts,
                                                      kind):
    """The group plan with tiered members served by both engines on the
    same requests: probabilities within 1e-5, and each host store's
    staging counts (per-table ids) exactly the reference's."""
    kw = dict(max_l=MAX_L, max_batch=8, max_wait_ms=0.0, buckets=(2, 4, 8))
    eng = RecEngine(HET, t_dlrm.params_from_numpy(np_params, "cpu"),
                    source=es.SourceSpec(tables=_plans(kind, es, t_st)),
                    cache_trace=counts, device="cpu", **kw)
    j_eng = JRecEngine(J_HET, jax.tree.map(jnp.asarray, np_params),
                       source=j_es.SourceSpec(
                           tables=_plans(kind, j_es, j_st)),
                       cache_trace=counts, **kw)
    assert len(eng._host_stores) == 1
    batch = next(make_drifting_zipf(HET, batch_size=40, mean_l=3,
                                    max_l=MAX_L, seed=4))
    got = _drive(eng, t_requests(batch, HET.n_tables))
    want = _drive(j_eng, j_requests(batch, HET.n_tables))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert eng.stats()["prefetch"] == j_eng.stats()["prefetch"]
    s = eng.stats()["prefetch"]
    assert s["touches"] > 0 and s["hits"] + s["misses"] == s["touches"]


@pytest.mark.parametrize("cold", ["host", "int4"])
def test_grouped_equals_per_table_with_tiered_member(cold):
    """The port of the reference's case: a group of a tiered member and
    an fp member gives, table by table, the members' own lookups bit
    for bit."""
    vocabs, dims = (60, 40), (8, 4)
    pol = t_st.TierPolicy(hot=6, warm=20, cold=cold, staging_rows=40)
    plans = (es.TablePlan(rows=60, dim=8, tiers=pol),
             es.TablePlan(rows=40, dim=4))
    specs = tuple(tp.arena_spec for tp in plans)
    arenas = []
    for t, sp in enumerate(specs):
        a = torch.randn(sp.total_rows, sp.dim,
                        generator=torch.Generator().manual_seed(10 + t))
        a[sp.null_row] = 0
        arenas.append(a)
    group = es.SourceSpec(tables=plans).build(arenas, None)
    assert isinstance(group.members[0], t_st.TieredSource)

    rng = np.random.RandomState(5)
    b, max_l, t_count = 6, 4, 2
    lens = rng.randint(0, max_l + 1, b * t_count).astype(np.int32)
    off = np.zeros(b * t_count + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    idx = np.concatenate([
        rng.randint(0, vocabs[i % t_count], lens[i]).astype(np.int32)
        for i in range(b * t_count)])
    idx_t, off_t = [], []
    for t in range(t_count):
        bags = [idx[off[i]:off[i + 1]]
                for i in range(t, b * t_count, t_count)]
        idx_t.append(torch.from_numpy(np.concatenate(bags)))
        off_t.append(torch.from_numpy(np.cumsum(
            [0] + [len(x) for x in bags]).astype(np.int32)))
    for store in t_st.host_stores_of(group):
        store.stage_arena(idx_t[0].numpy())
    group = t_st.refresh_host_tiers(group)

    got = es.lookup_bags(group, group.envelope_spec, torch.from_numpy(idx),
                         torch.from_numpy(off), max_l=max_l)
    for t, (m, sp) in enumerate(zip(group.members, group.specs)):
        own = es.lookup_bags(m, sp, idx_t[t], off_t[t], max_l=max_l)[:, 0]
        assert torch.equal(got[:, t, :sp.dim], own.to(got.dtype))
        assert not got[:, t, sp.dim:].any()
    assert torch.equal(got, es.lookup_bags_per_table(
        group, idx_t, off_t, max_l=max_l))


def test_host_stores_of_a_group_and_their_tables():
    """A group's host stores, each once and in member order, with the
    member's table: what the engine stages per table."""
    plans = _plans("tiered", es, t_st)[:1] + (
        es.TablePlan(rows=150, dim=8,
                     tiers=t_st.TierPolicy(hot=4, warm=8, cold="host",
                                           staging_rows=16)),
        es.TablePlan(rows=9, dim=4))
    params = t_dlrm.init(torch.Generator().manual_seed(1), HET,
                         device="cpu")
    group = es.SourceSpec(tables=plans).build(params["tables"], None)
    stores = t_st.host_stores_of(group)
    assert stores == [group.members[0].cold.store,
                      group.members[1].cold.store]
    assert t_st.refresh_host_tiers(group) is group
    eng = RecEngine(HET, params, source=es.SourceSpec(tables=plans),
                    max_l=MAX_L, max_batch=8, buckets=(8,), device="cpu")
    assert eng._host_tables == [0, 1]
    assert not set(map(id, eng._host_stores)) & set(map(id, stores))
    reqs = t_requests(next(_gen(seed=1)), HET.n_tables)
    ids = eng._store_ids(reqs)
    for t, got in enumerate(ids):
        want = np.concatenate([r.sparse_ids[t] for r in reqs])
        np.testing.assert_array_equal(got, want)
