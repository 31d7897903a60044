"""The port's tiered storage against the JAX reference on shared numpy
inputs: the int4 codec and the ``fused_int4_segment_sum`` op (its plain
version, as a CPU tensor runs it) with its scale gradient, the tier
partition, ``build_tiered`` for both cold kinds, ``TieredSource``
lookups and gradients, ``migrate``, the ``HostStore`` residency
protocol, the byte accounting, the plan conflicts and the broadcast
blobs, which decode across packages.

Tolerances:
  * exact (no tolerance): int4 codes and scales, int8 codes and scales,
    the tier partition (host numpy on equal counts), ``tier_slot``,
    ``hot_ids``, the hot copies and host rows (gathers), the residency
    bookkeeping of the same stage/prefetch sequence, byte counts, and
    within the port the laws: the int4 op equals ``fused_segment_sum``
    over ``int4_unpack`` (each term the same rounded product, summed in
    the same order), hot-only bags equal ``FpArena``, incremental
    ``migrate`` equals a full rebuild, ``HostTier.reduce_flat`` equals
    ``reduce_dense``;
  * op and lookups against JAX: atol=1e-5, fp32 sums of <= 9 terms of
    O(1) in another order (the Pallas kernel in interpret mode and XLA);
  * the scale gradient: each element sums <= b * l dot products of D
    O(1) terms -> atol=1e-4;
  * lookups against the fp arena: the reference's per-bag bound, max_l x
    (amax/254 + amax/14) (tests/test_storage.py).
"""
import dataclasses
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
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.kernels import fused_dispatch as j_fd
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import storage as t_st
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import fused_dispatch as t_fd
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


def _arena(spec, seed=0):
    """An arena of O(1) rows with the zero null row, as numpy."""
    rng = np.random.RandomState(seed)
    a = rng.randn(spec.total_rows, spec.dim).astype(np.float32)
    a[spec.null_row] = 0.0
    return a


def _ragged(rng, spec, n_bags, max_l):
    lens = rng.randint(0, max_l + 1, n_bags).astype(np.int32)
    off = np.zeros(n_bags + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    idx = rng.randint(0, spec.total_rows - 1, off[-1]).astype(np.int32)
    return idx, off


def _policy(cold, hot=15, warm=60, staging_rows=64, max_stage=32):
    kw = dict(hot=hot, warm=warm, cold=cold, staging_rows=staging_rows,
              max_stage_per_batch=max_stage)
    return t_st.TierPolicy(**kw), j_st.TierPolicy(**kw)


def _both(spec, cold, counts, seed=1, **pol_kw):
    """(port source, JAX source) built from one numpy arena and counts."""
    a = _arena(spec, seed)
    pol, j_pol = _policy(cold, **pol_kw)
    return (t_st.build_tiered(_t(a), spec, pol, counts),
            j_st.build_tiered(jnp.asarray(a), j_spec(spec), j_pol, counts),
            a)


def j_spec(spec):
    return j_se.ArenaSpec(spec.n_tables, spec.rows_per_table, spec.dim)


def _stage_both(t_src, j_src, flat):
    for s in t_st.host_stores_of(t_src):
        s.stage_arena(flat)
    for s in j_st.host_stores_of(j_src):
        s.stage_arena(flat)
    return (t_st.refresh_host_tiers(t_src),
            j_st.refresh_host_tiers(j_src))


# ---------------------------------------------------------------------------
# the int4 codec and the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 7, 8, 32])
def test_int4_codes_and_scales_equal_jax(dim):
    rng = np.random.RandomState(dim)
    a = rng.randn(40, dim).astype(np.float32)
    a[5] = 0.0                                   # a zero row
    # scale 1: halves that round to even (3.5 -> 4, -2.5 -> -2)
    a[6] = np.resize([7.0, 3.5, -2.5, 0.5, 1.5, -6.5, 2.0, 5.5], dim)
    packed, scales = ops.int4_pack(_t(a))
    j_packed, j_scales = j_ops.int4_pack(jnp.asarray(a))
    assert packed.dtype == torch.uint8 and packed.shape == (40,
                                                            (dim + 1) // 2)
    np.testing.assert_array_equal(packed.numpy(), _n(j_packed))
    np.testing.assert_array_equal(scales.numpy(), _n(j_scales))
    back = ops.int4_unpack(packed, scales, dim)
    np.testing.assert_array_equal(
        back.numpy(), _n(j_ops.int4_unpack(j_packed, j_scales, dim)))
    np.testing.assert_array_equal(ref._int4_codes(packed, dim).numpy(),
                                  _n(j_ref._int4_codes(j_packed, dim)))
    # round to nearest at 4 bits: |err| <= scale / 2 = amax / 14
    bound = np.abs(a).max(axis=1, keepdims=True) / 14.0 + 1e-6
    assert (np.abs(back.numpy() - a) <= bound).all()
    assert float(scales[5]) == 0.0 and not back[5].any()
    assert (packed[5] == 0x88).all()             # biased zero codes


@pytest.mark.parametrize("v,d,b,l", [(60, 8, 4, 5), (33, 7, 3, 9),
                                     (120, 32, 6, 4), (20, 16, 3, 0)])
def test_int4_op_matches_jax(v, d, b, l):
    rng = np.random.RandomState(v + d + b + l)
    a = rng.randn(v, d).astype(np.float32)
    a[v - 1] = 0.0
    packed, scales = (x.numpy() for x in ops.int4_pack(_t(a)))
    ids = rng.randint(0, v, (b, l)).astype(np.int32)
    ids[0, l // 2:] = v - 1                      # fill slots
    got = ops.fused_int4_segment_sum(_t(packed), _t(scales), _t(ids), dim=d)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    for want in (j_fd.fused_int4_segment_sum(
                     jnp.asarray(packed), jnp.asarray(scales),
                     jnp.asarray(ids), dim=d, interpret=True),
                 j_ref.fused_int4_segment_sum(
                     jnp.asarray(packed), jnp.asarray(scales),
                     jnp.asarray(ids), d)):
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)
    # within the port: the same rounded products, summed in order of j
    unpacked = ops.int4_unpack(_t(packed), _t(scales), d)
    assert torch.equal(got, ref.fused_segment_sum(unpacked, _t(ids)))


def test_int4_scale_gradient_matches_jax_grad():
    rng = np.random.RandomState(3)
    v, d, b, l = 50, 8, 5, 6
    a = rng.randn(v, d).astype(np.float32)
    a[v - 1] = 0.0
    packed, scales = (x.numpy() for x in ops.int4_pack(_t(a)))
    ids = rng.randint(0, v, (b, l)).astype(np.int32)
    ids[1, 3:] = v - 1
    g = rng.randn(b, d).astype(np.float32)
    ts = _t(scales).requires_grad_()
    out = ops.fused_int4_segment_sum(_t(packed), ts, _t(ids), dim=d)
    (out * _t(g)).sum().backward()
    j_grad = jax.grad(lambda s: (j_ops.fused_int4_segment_sum(
        jnp.asarray(packed), s, jnp.asarray(ids), dim=d)
        * jnp.asarray(g)).sum())(jnp.asarray(scales))
    np.testing.assert_allclose(ts.grad.numpy(), _n(j_grad), rtol=0,
                               atol=1e-4)
    untouched = np.setdiff1d(np.arange(v), ids)
    assert not ts.grad[untouched].any() and float(ts.grad[v - 1]) == 0.0


@pytest.mark.parametrize("ids_dtype,match", [(torch.int64, "int32"),
                                             (torch.int32, "CUDA device")])
def test_int4_wrapper_guards(ids_dtype, match):
    """The wrapper takes CUDA tensors and int32 ids only; a CPU tensor
    belongs to the plain version (through ``ops``)."""
    packed = torch.zeros((4, 2), dtype=torch.uint8)
    ids = torch.zeros((2, 3), dtype=ids_dtype)
    with pytest.raises(ValueError, match=match):
        t_fd.fused_int4_segment_sum(packed, torch.zeros(4, 1), ids, dim=4)


# ---------------------------------------------------------------------------
# the partition and the build
# ---------------------------------------------------------------------------

def test_partition_equals_jax_with_ties_and_the_null_row():
    rng = np.random.RandomState(5)
    counts = rng.randint(0, 4, 101).astype(np.float64)   # many ties
    counts[100] = 99.0                                    # the null row
    pol, j_pol = _policy("int4", hot=10, warm=30)
    for got, want in zip(pol.partition(counts, 100),
                         j_pol.partition(counts, 100)):
        np.testing.assert_array_equal(got, want)
    assert 100 not in np.concatenate(pol.partition(counts, 100))


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_build_tiered_equals_jax(cold):
    spec = se.ArenaSpec(2, 60, 8)
    counts = np.random.RandomState(2).rand(spec.total_rows)
    src, j_src, a = _both(spec, cold, counts)
    for f in ("hot_rows", "tier_slot", "hot_ids"):
        np.testing.assert_array_equal(getattr(src, f).numpy(),
                                      _n(getattr(j_src, f)), f)
    np.testing.assert_array_equal(src.warm.q.numpy(), _n(j_src.warm.q))
    np.testing.assert_array_equal(src.warm.scales.numpy(),
                                  _n(j_src.warm.scales))
    assert (src.n_hot, src.n_warm, src.n_cold) \
        == (j_src.n_hot, j_src.n_warm, j_src.n_cold)
    if cold == "int4":
        np.testing.assert_array_equal(src.cold.packed.numpy(),
                                      _n(j_src.cold.packed))
        np.testing.assert_array_equal(src.cold.scales.numpy(),
                                      _n(j_src.cold.scales))
        assert src.cold.dim == j_src.cold.dim == spec.dim
    else:
        store, j_store = src.cold.store, j_src.cold.store
        np.testing.assert_array_equal(store.host_rows, j_store.host_rows)
        np.testing.assert_array_equal(store.compact_of, j_store.compact_of)
        assert store.staging.shape == j_store.staging.shape
        assert not store.staging.any()


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_tiered_lookup_matches_jax(cold):
    spec = se.ArenaSpec(1, 150, 8)
    rng = np.random.RandomState(11)
    counts = rng.rand(spec.total_rows)
    src, j_src, a = _both(spec, cold, counts)
    idx, off = _ragged(rng, spec, n_bags=12, max_l=5)
    src, j_src = _stage_both(src, j_src, idx)
    got = es.lookup_bags(src, spec, _t(idx), _t(off), max_l=5)
    want = j_es.lookup_bags(j_src, j_spec(spec), jnp.asarray(idx),
                            jnp.asarray(off), max_l=5)
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)
    # the composition against the fp arena, within the reference's bound
    fp = es.lookup_bags(es.FpArena(_t(a)), spec, _t(idx), _t(off), max_l=5)
    amax = float(np.abs(a).max())
    per_row = amax / 254.0 + (amax / 14.0 if cold == "int4" else 0.0)
    assert (got - fp).abs().max() <= 5 * per_row + 1e-5
    # hot-only bags: the fp arena's bits
    hidx = src.hot_ids[:10].clone()
    hoff = torch.arange(0, 11, dtype=torch.int32)
    assert torch.equal(es.lookup_bags(src, spec, hidx, hoff, max_l=5),
                       es.lookup_bags(es.FpArena(_t(a)), spec, hidx, hoff,
                                      max_l=5))


def test_host_tier_flat_form_equals_dense_form():
    spec = se.ArenaSpec(1, 90, 8)
    rng = np.random.RandomState(4)
    src, _, _ = _both(spec, "host", rng.rand(spec.total_rows), hot=0,
                      warm=0)
    idx, off = _ragged(rng, spec, n_bags=9, max_l=4)
    src = t_st.refresh_host_tiers(src)
    src.cold.store.stage_arena(idx)
    comp = torch.from_numpy(src.cold.store.compact_of[idx].astype(np.int32))
    tier = src.cold
    dense = se.ragged_dense_ids(comp, _t(off), max_l=4,
                                fill=tier.slot_of.shape[0] - 1)
    assert torch.equal(tier.reduce_flat(spec, comp, _t(off), max_l=4),
                       tier.reduce_dense(spec, dense))
    # every row is fp32 here: the host tier serves the fp arena's bits
    flat = _t(idx)
    fp = es.FpArena(src.cold.staging.new_tensor(_arena(spec, 1)))
    assert torch.equal(src.reduce_flat(spec, flat, _t(off), max_l=4),
                       fp.reduce_flat(spec, flat, _t(off), max_l=4))


def test_host_tier_flat_form_sums_over_long_bags_whole():
    """A bag longer than ``max_l``: the reference's ``HostTier.reduce_flat``
    segment-sums the whole bag, and so does the port's (ROADMAP Queue 3's
    smallest input, the one that pins ``sparse_lengths_sum``)."""
    staging = np.zeros((11, 4), np.float32)          # slot 10: the zero slot
    staging[:10] = np.arange(40, dtype=np.float32).reshape(10, 4)
    slot_of = np.arange(11, dtype=np.int32)           # compact id -> slot
    ids = np.array([1, 2, 3, 4, 5, 6, 0, 0], np.int32)
    off = np.array([0, 5, 6], np.int32)
    spec = se.ArenaSpec(1, 10, 4)
    got = t_st.HostTier(_t(staging), _t(slot_of)).reduce_flat(
        spec, _t(ids), _t(off), max_l=2)
    want = j_st.HostTier(jnp.asarray(staging), jnp.asarray(slot_of)
                         ).reduce_flat(j_spec(spec), jnp.asarray(ids),
                                       jnp.asarray(off), max_l=2)
    np.testing.assert_array_equal(_n(want), [[60, 65, 70, 75],
                                             [24, 25, 26, 27]])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _n(want))


def test_tiered_grads_reach_only_touched_hot_slots():
    spec = se.ArenaSpec(1, 120, 8)
    rng = np.random.RandomState(12)
    src, j_src, _ = _both(spec, "int4", rng.rand(spec.total_rows), hot=20,
                          warm=40)
    idx, off = _ragged(rng, spec, n_bags=10, max_l=5)
    g = rng.randn(10, 1, spec.dim).astype(np.float32)
    hot = src.hot_rows.clone().requires_grad_()
    out = es.lookup_bags(dataclasses.replace(src, hot_rows=hot), spec,
                         _t(idx), _t(off), max_l=5)
    (out * _t(g)).sum().backward()

    def f(h):
        s = dataclasses.replace(j_src, hot_rows=h)
        return (j_es.lookup_bags(s, j_spec(spec), jnp.asarray(idx),
                                 jnp.asarray(off), max_l=5)
                * jnp.asarray(g)).sum()
    j_grad = jax.grad(f)(j_src.hot_rows)
    np.testing.assert_allclose(hot.grad.numpy(), _n(j_grad), rtol=0,
                               atol=1e-5)
    slot = src.tier_slot.numpy()[idx]
    touched = np.unique(slot[slot < src.n_hot])
    untouched = np.setdiff1d(np.arange(src.n_hot + 1), touched)
    assert not hot.grad[untouched].any()          # the null slot included
    assert hot.grad[touched].abs().sum(dim=1).gt(0).all()


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def test_migrate_incremental_equals_full_rebuild_and_jax_stats():
    spec = se.ArenaSpec(1, 120, 6)
    rng = np.random.RandomState(9)
    counts0 = rng.rand(spec.total_rows)
    src, j_src, a0 = _both(spec, "int4", counts0, seed=4, hot=12, warm=50)
    touched = rng.choice(spec.total_rows - 1, 20, replace=False)
    a1 = a0.copy()
    a1[touched] += 0.5
    dirty = np.zeros(spec.total_rows, bool)
    dirty[touched] = True
    counts1 = rng.rand(spec.total_rows)
    pol, j_pol = _policy("int4", hot=12, warm=50)
    mig, stats = t_st.migrate(src, _t(a1), spec, pol, counts1, dirty)
    full = t_st.build_tiered(_t(a1), spec, pol, counts1)
    for f in ("hot_rows", "tier_slot", "hot_ids"):
        assert torch.equal(getattr(mig, f), getattr(full, f)), f
    for x, y in ((mig.warm.q, full.warm.q), (mig.warm.scales,
                                             full.warm.scales),
                 (mig.cold.packed, full.cold.packed),
                 (mig.cold.scales, full.cold.scales)):
        assert torch.equal(x, y)
    _, j_stats = j_st.migrate(j_src, jnp.asarray(a1), j_spec(spec), j_pol,
                              counts1, dirty)
    assert stats == j_stats
    assert stats["promoted_hot"] == stats["demoted_hot"]
    # the old source is left as it was
    assert torch.equal(src.hot_rows, t_st.build_tiered(
        _t(a0), spec, pol, counts0).hot_rows)


def test_migrate_host_cold_retargets_in_place():
    spec = se.ArenaSpec(1, 90, 4)
    rng = np.random.RandomState(2)
    src, _, a = _both(spec, "host", rng.rand(spec.total_rows), seed=6,
                      hot=8, warm=20)
    store = src.cold.store
    store.stage_arena(np.arange(50))
    assert store.stats()["resident"] > 0
    ptrs = (store.staging.data_ptr(), store.slot_of.data_ptr(),
            store.host_rows.ctypes.data)
    pol, _ = _policy("host", hot=8, warm=20)
    mig, stats = t_st.migrate(src, _t(a), spec, pol,
                              rng.rand(spec.total_rows))
    assert mig.cold.store is store and stats["cold_requant"] == 0
    assert store.stats()["resident"] == 0 and not store.staging.any()
    assert (store.staging.data_ptr(), store.slot_of.data_ptr(),
            store.host_rows.ctypes.data) == ptrs
    assert es.source_structure(mig)[0] == es.source_structure(src)[0]
    cold = np.nonzero(store.compact_of < store.n_cold)[0]
    np.testing.assert_array_equal(store.host_rows[store.compact_of[cold]],
                                  a[cold])


# ---------------------------------------------------------------------------
# HostStore residency, against the reference's store
# ---------------------------------------------------------------------------

def _stores(c=40, d=4, s=16, max_stage=8):
    rows = np.arange(c * d, dtype=np.float32).reshape(c, d) + 1.0
    return (t_st.HostStore(rows, staging_rows=s, max_stage_per_batch=max_stage,
                           device="cpu"),
            j_st.HostStore(rows, staging_rows=s,
                           max_stage_per_batch=max_stage), rows)


def _same_residency(st, j_st_):
    np.testing.assert_array_equal(st.slot_of.numpy(), _n(j_st_.slot_of))
    np.testing.assert_array_equal(st.staging.numpy(), _n(j_st_.staging))
    assert st.stats() == j_st_.stats()


def test_store_sequence_equals_the_reference_store():
    st, j_store, rows = _stores(c=60, s=12, max_stage=4)
    rng = np.random.RandomState(8)
    for i in range(12):
        cur = rng.randint(0, 60, rng.randint(1, 8))
        nxt = rng.randint(0, 60, rng.randint(0, 8))
        if i % 3 == 2:
            assert st.prefetch(nxt) == j_store.prefetch(nxt)
        else:
            assert st.stage(cur, ahead=nxt) == j_store.stage(cur, ahead=nxt)
        _same_residency(st, j_store)
    slot = st.slot_of.numpy()
    res = np.nonzero(slot[:-1] < st.staging_rows)[0]
    np.testing.assert_array_equal(st.staging.numpy()[slot[res]], rows[res])
    assert not st.staging[-1].any()
    assert st.touches == st.hits + st.misses


def test_pinned_rows_never_evicted_by_prefetch():
    st, _, _ = _stores(c=40, s=8)
    st.stage(np.arange(8))                       # pins the full arena
    assert st.prefetch(np.arange(8, 20)) == 0    # nothing evictable
    assert (st._slot_np[np.arange(8)] < st.staging_rows).all()
    st.stage(np.array([0, 1]))                   # unpins the others
    assert st.prefetch(np.arange(8, 12)) == 4
    assert (st._slot_np[[0, 1]] < st.staging_rows).all()


def test_staging_too_small_raises_then_recovers():
    st, _, rows = _stores(c=40, s=8)
    with pytest.raises(ValueError, match="staging arena too small"):
        st.stage(np.arange(12))                  # 12 > 8 slots
    assert st.stage(np.array([1, 2]))[1] == 2    # still serving
    np.testing.assert_array_equal(
        st.staging[st.slot_of[1]].numpy(), rows[1])


def test_lru_eviction_prefers_oldest_unpinned():
    st, j_store, _ = _stores(c=40, s=8, max_stage=8)
    for ids in (np.arange(0, 4), np.arange(4, 8), np.arange(8, 11)):
        st.stage(ids)
        j_store.stage(ids)
    assert (st._slot_np[8:11] < st.staging_rows).all()
    assert (st._slot_np[4:8] < st.staging_rows).all()
    assert (st._slot_np[0:4] == st.staging_rows).sum() == 3
    _same_residency(st, j_store)


def test_warm_compile_keeps_residency():
    st, _, rows = _stores()
    st.stage(np.array([5, 6]))
    before = st.slot_of.clone()
    st.warm_compile()
    assert torch.equal(st.slot_of, before)
    np.testing.assert_array_equal(st.staging[before[5]].numpy(), rows[5])
    assert set(st._ring) == set(st._chunk_sizes)


def test_store_adopts_rows_once_per_generation():
    a, _, rows = _stores(c=40, s=8)
    b = t_st.HostStore(rows[::-1].copy(), staging_rows=8, device="cpu")
    a.stage(np.arange(4))
    ptr = a.host_rows.ctypes.data
    assert a.adopt(b) and a.stats()["resident"] == 0
    np.testing.assert_array_equal(a.host_rows, b.host_rows)
    assert a.host_rows.ctypes.data == ptr
    a.stage(np.arange(4))
    assert not a.adopt(b) and a.stats()["resident"] == 4
    b.retarget(rows, b.compact_of)               # a new generation
    assert a.adopt(b) and a.stats()["resident"] == 0


# ---------------------------------------------------------------------------
# accounting, plans, blobs, imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cold", ["int4", "host"])
def test_describe_and_bytes_equal_jax(cold):
    spec = se.ArenaSpec(1, 100, 8)
    src, j_src, _ = _both(spec, cold, np.arange(spec.total_rows), hot=10,
                          warm=40, staging_rows=16)
    assert es.describe_source(src) == j_es.describe_source(j_src) \
        == f"tiered({cold})"
    assert es.describe_source(src, multiline=True) \
        == j_es.describe_source(j_src, multiline=True)
    assert t_st.tier_bytes(src) == j_st.tier_bytes(j_src)
    assert es.source_bytes(src) == j_es.source_bytes(j_src)
    assert es.source_bytes(src.cold) == j_es.source_bytes(j_src.cold)
    b = t_st.tier_bytes(src)
    assert b["device_total"] == b["hot"] + b["warm"] + b["cold"] + b["maps"]
    assert b["host"] == (src.n_cold * spec.dim * 4 if cold == "host" else 0)


def test_plan_and_config_conflicts_raise_as_in_the_reference():
    from repro_torch.training import OnlineCacheConfig
    pol, _ = _policy("int4")
    for kw in ({"cache_k": 8}, {"quantize_cold": True},
               {"layout": "fixed"}):
        with pytest.raises(ValueError):
            es.SourceSpec(tiers=pol, **kw)
    with pytest.raises(TypeError, match="Mesh"):
        es.SourceSpec(tiers=pol, mesh=object())
    with pytest.raises(ValueError):
        t_st.TierPolicy(hot=4, warm=4, cold="float8")
    with pytest.raises(ValueError):
        t_st.TierPolicy(hot=-1, warm=4)
    for kw in ({"k": 4}, {"k": 0, "quantize_cold": True}):
        with pytest.raises(ValueError, match="k=0"):
            OnlineCacheConfig(tiers=pol, **kw)
    plan = es.SourceSpec(tiers=pol)
    assert plan.path_name() == "tiered"
    spec = se.ArenaSpec(1, 100, 8)
    src = plan.build(_t(_arena(spec)), spec, np.arange(spec.total_rows))
    assert isinstance(src, t_st.TieredSource) and src.n_hot == pol.hot


@pytest.mark.parametrize("cold", ["int4", "host"])
def test_versioned_source_blobs_decode_across_packages(cold):
    spec = se.ArenaSpec(1, 80, 4)
    rng = np.random.RandomState(4)
    src, j_src, _ = _both(spec, cold, rng.rand(spec.total_rows), hot=8,
                          warm=30, staging_rows=32)
    idx, off = _ragged(rng, spec, n_bags=10, max_l=4)
    src, j_src = _stage_both(src, j_src, idx)
    ours = es.VersionedSource(source=src, version=7).serialize()
    theirs = j_es.VersionedSource(source=j_src, version=7).serialize()
    for blob in (ours, theirs):
        got = es.VersionedSource.deserialize(blob, device="cpu")
        j_got = j_es.VersionedSource.deserialize(blob)
        assert got.version == j_got.version == 7
        assert type(got.source.cold).__name__ == type(j_got.source.cold
                                                      ).__name__
        if cold == "host":
            assert got.source.cold.store is None
        want = es.lookup_bags(src, spec, _t(idx), _t(off), max_l=4)
        assert torch.equal(es.lookup_bags(got.source, spec, _t(idx),
                                          _t(off), max_l=4), want)
        np.testing.assert_allclose(
            _n(j_es.lookup_bags(j_got.source, j_spec(spec),
                                jnp.asarray(idx), jnp.asarray(off),
                                max_l=4)), want.numpy(), rtol=0, atol=1e-5)


def test_tier_policy_round_trips_through_the_meta_codec():
    pol, j_pol = _policy("host", hot=3, warm=5)
    assert es._decode_meta(es._encode_meta(pol)) == pol
    # the reference's encoding of its own TierPolicy decodes in the port
    assert es._decode_meta(j_es._encode_meta(j_pol)) == pol


def test_storage_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.storage, repro_torch.storage.tiered\n"
            "import repro_torch.storage.host_store\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_clone_and_adopt_keep_the_snapshot_rule():
    spec = se.ArenaSpec(1, 90, 4)
    rng = np.random.RandomState(3)
    for cold in ("int4", "host"):
        src, _, a = _both(spec, cold, rng.rand(spec.total_rows), hot=8,
                          warm=20)
        mine = es.clone_source(src)
        ptrs = [t.data_ptr() for t in es.source_structure(mine)[1]]
        assert not set(ptrs) & {t.data_ptr()
                                for t in es.source_structure(src)[1]}
        pol, _ = _policy(cold, hot=8, warm=20)
        mig, _ = t_st.migrate(src, _t(a) + 1.0, spec, pol,
                              rng.rand(spec.total_rows))
        es.adopt_source(mine, mig)
        assert [t.data_ptr() for t in es.source_structure(mine)[1]] == ptrs
        for x, y in zip(es.source_structure(mine)[1][:5],
                        es.source_structure(mig)[1][:5]):
            assert torch.equal(x, y)
        if cold == "host":
            assert mine.cold.store is not mig.cold.store
            np.testing.assert_array_equal(mine.cold.store.host_rows,
                                          mig.cold.store.host_rows)
