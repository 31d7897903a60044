"""The port's hot-row cache against the JAX reference on shared numpy
inputs: the ``fused_cached_segment_sum`` op (its plain version, as a CPU
tensor runs it) and its gradients, the cache build and hit accounting,
int8 quantization, ``CachedSource`` / ``QuantizedArena`` lookups and
``SourceSpec`` plans; plus the bitwise hot + cold == uncached law within
the port and the guards of the new kernel's wrapper.

Tolerances (fp32 everywhere):
  * op forward against the Pallas kernel (interpret) and XLA: <= 9 terms
    of O(1), summed in another order -> atol=1e-5;
  * gradients: each element is a sum of <= b * l upstream values of O(1)
    -> atol=1e-5;
  * lookups over sources: arena rows of scale 1.0, bags of <= 5 -> 1e-5;
  * exact (no tolerance): the cache ranking (``hot_ids``, ``slot_of``,
    the copied ``hot_rows``), trace counts, hit counts, int8 codes and
    scales, and the law within the port (``torch.equal``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.kernels import fused_dispatch as j_fd
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import fused_dispatch as t_fd
from repro_torch.kernels import ops, ref
from repro_torch.storage import TierPolicy

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


def _dense_case(rng, v, b, l, null=None):
    """(b, l) ids; with ``null``, short bags are filled with it."""
    ids = rng.randint(0, v if null is None else v - 1, (b, l))
    if null is not None:
        lens = rng.randint(0, l + 1, b)
        for i in range(b):
            ids[i, lens[i]:] = null
    return ids.astype(np.int32)


def _split(rng, v, b, l, k):
    """A coherent cache over a (v, d) arena: the k most frequent ids of a
    dense case hot (never the null row v - 1), returned as (ids, hot_ids,
    slot_of, slots, cold_ids)."""
    null = v - 1
    ids = _dense_case(rng, v, b, l, null=null)
    counts = np.bincount(ids.ravel(), minlength=v)
    counts[null] = -1
    hot_ids = np.argsort(counts, kind="stable")[-k:]
    slot_of = np.full(v, k, np.int32)
    slot_of[hot_ids] = np.arange(k)
    slots = slot_of[ids]
    cold = np.where(slots < k, null, ids).astype(np.int32)
    return ids, hot_ids, slot_of, slots, cold


# ---------------------------------------------------------------------------
# the op against the Pallas kernel and the XLA oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,k,d,b,l", [(120, 9, 8, 4, 5), (64, 1, 16, 3, 3),
                                       (256, 33, 32, 6, 7), (40, 4, 8, 3, 0)])
def test_cached_op_matches_jax_on_any_tables(v, k, d, b, l):
    """Arbitrary (stale) hot rows and cold ids: the two-term sum itself."""
    rng = np.random.RandomState(v + k + d + b + l)
    arena = rng.randn(v, d).astype(np.float32)
    hot = rng.randn(k + 1, d).astype(np.float32)
    slots = _dense_case(rng, k + 1, b, l)
    cold = _dense_case(rng, v, b, l)
    got = ops.fused_cached_segment_sum(_t(hot), _t(arena), _t(slots),
                                       _t(cold))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    for want in (j_fd.fused_cached_segment_sum(
                     jnp.asarray(hot), jnp.asarray(arena), jnp.asarray(slots),
                     jnp.asarray(cold), interpret=True),
                 j_ref.fused_cached_segment_sum(
                     jnp.asarray(hot), jnp.asarray(arena), jnp.asarray(slots),
                     jnp.asarray(cold))):
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("coherent", [False, True])
def test_cached_op_and_grads_match_jax(coherent):
    """The op and the gradients of both tables against jax.grad of the
    reference op in both its forms (with and without dense_ids, its
    coherent lowering), with the miss slot and the null row pinned to
    zero. The port has one form: the card takes the two-table walk
    either way."""
    rng = np.random.RandomState(7)
    v, d, b, l, k = 90, 16, 6, 5, 12
    null = v - 1
    arena = rng.randn(v, d).astype(np.float32)
    arena[null] = 0.0
    ids, hot_ids, _, slots, cold = _split(rng, v, b, l, k)
    hot = np.concatenate([arena[hot_ids], np.zeros((1, d), np.float32)])
    g_out = rng.randn(b, d).astype(np.float32)
    dense_kw = {"dense_ids": ids} if coherent else {}

    th, ta = _t(hot).requires_grad_(), _t(arena).requires_grad_()
    out = ops.fused_cached_segment_sum(th, ta, _t(slots), _t(cold),
                                       null_row=null)
    (out * _t(g_out)).sum().backward()

    def f(h, a):
        return j_ops.fused_cached_segment_sum(
            h, a, jnp.asarray(slots), jnp.asarray(cold), null_row=null,
            **{k_: jnp.asarray(x) for k_, x in dense_kw.items()})

    want = f(jnp.asarray(hot), jnp.asarray(arena))
    gh, ga = jax.grad(lambda h, a: jnp.sum(f(h, a) * jnp.asarray(g_out)),
                      argnums=(0, 1))(jnp.asarray(hot), jnp.asarray(arena))
    np.testing.assert_allclose(out.detach().numpy(), _n(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), _n(gh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), _n(ga), rtol=0, atol=1e-5)
    assert (th.grad[k] == 0).all() and (ta.grad[null] == 0).all()
    assert th.grad[:k].abs().max() > 0


def test_cached_op_max_l_zero_gives_zeros():
    hot, arena = torch.ones(3, 4), torch.ones(5, 4)
    empty = torch.zeros(2, 0, dtype=torch.int32)
    got = ops.fused_cached_segment_sum(hot, arena, empty, empty)
    assert got.shape == (2, 4) and not got.any()
    np.testing.assert_array_equal(got.numpy(), _n(
        j_fd.fused_cached_segment_sum(jnp.ones((3, 4)), jnp.ones((5, 4)),
                                      jnp.zeros((2, 0), jnp.int32),
                                      jnp.zeros((2, 0), jnp.int32),
                                      interpret=True)))


# ---------------------------------------------------------------------------
# within the port: hot + cold == uncached, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 79])
def test_one_pass_equals_uncached_bitwise(k):
    """Forward bit for bit (k = 79: every real row hot), and the hot
    gradient scattered back onto its rows plus the arena gradient equals
    the uncached gradient exactly."""
    rng = np.random.RandomState(k)
    v, d, b, l = 80, 8, 5, 6
    null = v - 1
    arena = rng.randn(v, d).astype(np.float32)
    arena[null] = 0.0
    ids, hot_ids, _, slots, cold = _split(rng, v, b, l, k)
    hot = np.concatenate([arena[hot_ids], np.zeros((1, d), np.float32)])
    th, ta = _t(hot).requires_grad_(), _t(arena).requires_grad_()
    got = ops.fused_cached_segment_sum(th, ta, _t(slots), _t(cold),
                                       null_row=null)
    tu = _t(arena).requires_grad_()
    want = ops.fused_segment_sum(tu, _t(ids), null_row=null)
    assert torch.equal(got, want)
    assert torch.equal(ref.fused_cached_segment_sum(
        _t(hot), _t(arena), _t(slots), _t(cold)),
        ref.fused_segment_sum(_t(arena), _t(ids)))
    got.sum().backward()
    want.sum().backward()
    recomb = ta.grad.clone()
    recomb[torch.from_numpy(hot_ids)] += th.grad[:k]
    assert torch.equal(recomb, tu.grad)


def _ragged(rng, spec, b, max_l, pad=3):
    n_bags = b * spec.n_tables
    lens = rng.randint(0, max_l + 1, n_bags).astype(np.int32)
    lens[0], lens[-1] = 0, max_l
    off = np.zeros(n_bags + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    idx = rng.randint(0, spec.rows_per_table, int(off[-1]) + pad)
    return idx.astype(np.int32), off


@pytest.mark.parametrize("k", [1, 8, 10_000])
def test_lookup_bags_cached_equals_fp_bitwise(k):
    """``lookup_bags`` over a coherent ``CachedSource`` equals the
    ``FpArena`` lookup with ``torch.equal``; k beyond the arena pins
    every real row."""
    spec = se.ArenaSpec(3, 20, 8)
    rng = np.random.RandomState(k % 97)
    arena = torch.from_numpy(rng.randn(spec.total_rows, 8)
                             .astype(np.float32))
    arena[spec.null_row] = 0.0
    idx, off = _ragged(rng, spec, b=4, max_l=5)
    counts = se.trace_row_counts(spec, idx, off)
    cache = se.build_hot_cache(arena, spec, counts, k)
    assert cache.k == min(k, spec.null_row)
    for coherent in (False, True):
        got = es.lookup_bags(es.CachedSource(cache, es.FpArena(arena),
                                             coherent=coherent),
                             spec, _t(idx), _t(off), max_l=5)
        want = es.lookup_bags(es.FpArena(arena), spec, _t(idx), _t(off),
                              max_l=5)
        assert torch.equal(got, want)


def test_stale_cache_is_served_as_it_is():
    """The two-table walk serves the hot copies even when they are stale,
    with or without the coherence flag: the write-through protocol must
    be observable."""
    spec = se.ArenaSpec(2, 15, 4)
    rng = np.random.RandomState(4)
    arena = torch.from_numpy(rng.randn(spec.total_rows, 4)
                             .astype(np.float32))
    arena[spec.null_row] = 0.0
    idx, off = _ragged(rng, spec, b=3, max_l=3)
    cache = se.build_hot_cache(arena, spec,
                               se.trace_row_counts(spec, idx, off), k=4)
    arena2 = arena.clone()
    arena2[:spec.null_row] += 0.5
    fresh = es.lookup_bags(es.FpArena(arena2), spec, _t(idx), _t(off),
                           max_l=3)
    for coherent in (False, True):
        stale = es.lookup_bags(es.CachedSource(cache, es.FpArena(arena2),
                                               coherent=coherent),
                               spec, _t(idx), _t(off), max_l=3)
        assert not torch.allclose(stale, fresh)


# ---------------------------------------------------------------------------
# sparse engine and sources against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    """A shared arena and ragged trace: spec, numpy arena, idx, off."""
    spec = se.ArenaSpec(3, 30, 8)
    j_spec = j_se.ArenaSpec(3, 30, 8)
    arena = _n(j_se.init_arena(jax.random.PRNGKey(4), j_spec, scale=1.0))
    rng = np.random.RandomState(8)
    idx, off = _ragged(rng, spec, b=5, max_l=5)
    idx[: idx.size // 2] = idx[: idx.size // 2] % 4     # skew: ties and hits
    return spec, j_spec, arena, idx, off


def test_trace_row_counts_match_jax(case):
    spec, j_spec, _, idx, off = case
    np.testing.assert_array_equal(
        se.trace_row_counts(spec, idx, off),
        j_se.trace_row_counts(j_spec, idx, off))
    fixed = np.random.RandomState(1).randint(0, 30, (2, 3, 4)).astype(
        np.int32)
    np.testing.assert_array_equal(se.trace_row_counts(spec, fixed),
                                  j_se.trace_row_counts(j_spec, fixed))
    np.testing.assert_array_equal(
        se.flatten_indices(spec, _t(fixed)).numpy(),
        _n(j_se.flatten_indices(j_spec, jnp.asarray(fixed))))


@pytest.mark.parametrize("k", [1, 5, 16, 200])
def test_build_hot_cache_matches_jax_exactly(case, k):
    """Ties included (among equal counts the highest row id first)."""
    spec, j_spec, arena, idx, off = case
    counts = se.trace_row_counts(spec, idx, off)
    got = se.build_hot_cache(_t(arena), spec, counts, k)
    want = j_se.build_hot_cache(jnp.asarray(arena), j_spec, counts, k)
    for f in ("hot_rows", "slot_of", "hot_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _n(getattr(want, f)))
    assert got.slot_of.dtype == got.hot_ids.dtype == torch.int32
    assert got.k == want.k
    assert not got.hot_rows[-1].any()


def test_cache_hit_rate_matches_jax(case):
    spec, j_spec, arena, idx, off = case
    counts = se.trace_row_counts(spec, idx, off)
    got = se.build_hot_cache(_t(arena), spec, counts, 6)
    want = j_se.build_hot_cache(jnp.asarray(arena), j_spec, counts, 6)
    hits = se.cache_hits(got, spec, _t(idx), _t(off))
    rate = se.cache_hit_rate(got, spec, _t(idx), _t(off))
    j_rate = float(j_se.cache_hit_rate(want, j_spec, jnp.asarray(idx),
                                       jnp.asarray(off)))
    flat = _n(j_se.flatten_ragged_indices(j_spec, jnp.asarray(idx),
                                          jnp.asarray(off)))[:off[-1]]
    assert int(hits) == int((_n(want.slot_of)[flat] < 6).sum())
    assert float(rate) == j_rate and 0 < j_rate < 1


def test_quantization_matches_jax_exactly(case):
    """q and scales equal the reference's bit for bit; the incremental
    patch equals a full rebuild, duplicates and the null row included."""
    spec, _, arena, _, _ = case
    rng = np.random.RandomState(3)
    arena = arena.copy()
    arena[5] = 0.0                       # an all-zero real row
    arena[6, :] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, 0.0, -1.0]  # halves
    q = es.QuantizedArena.from_arena(_t(arena))
    jq = j_es.QuantizedArena.from_arena(jnp.asarray(arena))
    np.testing.assert_array_equal(q.q.numpy(), _n(jq.q))
    np.testing.assert_array_equal(q.scales.numpy(), _n(jq.scales))
    assert q.q.dtype == torch.int8 and q.scales.dtype == torch.float32
    rows = np.unique(rng.randint(0, spec.null_row, 9))
    rows = np.concatenate([rows, rows[:1], [spec.null_row]]).astype(np.int32)
    arena2 = arena.copy()
    arena2[rows[:-1]] += rng.randn(rows.size - 1, 8).astype(np.float32)
    patched = q.quantize_rows(_t(arena2), _t(rows))
    full = es.QuantizedArena.from_arena(_t(arena2))
    j_patched = jq.quantize_rows(jnp.asarray(arena2), jnp.asarray(rows))
    for a, b, c in ((patched.q, full.q, j_patched.q),
                    (patched.scales, full.scales, j_patched.scales)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), _n(c))
    assert torch.equal(q.q, es.QuantizedArena.from_arena(_t(arena)).q)


def test_lookups_over_sources_match_jax(case):
    """fp, int8, cached fp and cached int8 lookups against the reference's
    on the same arena and trace."""
    spec, j_spec, arena, idx, off = case
    counts = se.trace_row_counts(spec, idx, off)
    ta, ja = _t(arena), jnp.asarray(arena)
    cache = se.build_hot_cache(ta, spec, counts, 8)
    j_cache = j_se.build_hot_cache(ja, j_spec, counts, 8)
    q = es.QuantizedArena.from_arena(ta)
    jq = j_es.QuantizedArena.from_arena(ja)
    pairs = [(es.FpArena(ta), j_es.FpArena(ja)), (q, jq),
             (es.CachedSource(cache, es.FpArena(ta)),
              j_es.CachedSource(j_cache, j_es.FpArena(ja))),
             (es.CachedSource(cache, q), j_es.CachedSource(j_cache, jq)),
             (es.CachedSource(cache, es.FpArena(ta), coherent=True),
              j_es.CachedSource(j_cache, j_es.FpArena(ja), coherent=True))]
    for src, j_src in pairs:
        got = es.lookup_bags(src, spec, _t(idx), _t(off), max_l=5)
        want = j_es.lookup_bags(j_src, j_spec, jnp.asarray(idx),
                                jnp.asarray(off), max_l=5)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)


def test_nested_cache_keeps_the_law(case):
    """A cache over a cached cold source (the generic branch: a hot pass
    on fused_segment_sum plus the cold source's own pass) still equals
    the uncached lookup."""
    spec, _, arena, idx, off = case
    counts = se.trace_row_counts(spec, idx, off)
    ta = _t(arena)
    inner = es.CachedSource(se.build_hot_cache(ta, spec, counts, 12),
                            es.FpArena(ta))
    outer = es.CachedSource(se.build_hot_cache(ta, spec, counts, 4), inner)
    got = es.lookup_bags(outer, spec, _t(idx), _t(off), max_l=5)
    want = es.lookup_bags(es.FpArena(ta), spec, _t(idx), _t(off), max_l=5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("path,kw", [("ragged", {}),
                                     ("cached", {"cache_k": 4}),
                                     ("cached", {"cache_k": 4,
                                                 "quantize_cold": True})])
def test_source_spec_matches_jax(case, path, kw):
    spec, j_spec, arena, idx, off = case
    counts = se.trace_row_counts(spec, idx, off)
    plan = es.SourceSpec.from_path(path, **kw)
    j_plan = j_es.SourceSpec.from_path(path, **kw)
    for f in ("layout", "cache_k", "quantize_cold", "cached"):
        assert getattr(plan, f) == getattr(j_plan, f)
    assert plan.path_name() == j_plan.path_name()
    assert es.SourceSpec.from_path(plan) is plan
    src = plan.build(_t(arena), spec, counts)
    j_src = j_plan.build(jnp.asarray(arena), j_spec, counts)
    assert type(src).__name__ == type(j_src).__name__
    assert es.describe_source(src) == j_es.describe_source(j_src)
    assert es.source_bytes(src) == j_es.source_bytes(j_src)
    for a, b in zip(es.source_structure(src)[1],
                    jax.tree_util.tree_leaves(j_src)):
        np.testing.assert_array_equal(a.numpy(), _n(b))
    if plan.cached:
        assert src.coherent and j_src.coherent


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "Queue 1, item 13"),
    ({"require_mesh": True}, "Queue 1, item 13")])
def test_source_spec_refuses_what_is_not_ported(kw, item):
    """Sharded plans are ported (ROADMAP item 13); a tiered one is
    refused as the reference refuses it: a mesh must be the port's
    ``Mesh``, and the 'sharded' path's require_mesh needs one."""
    want = {"mesh": (TypeError, "Mesh"),
            "require_mesh": (ValueError, "require_mesh")}[next(iter(kw))]
    with pytest.raises(want[0], match=want[1]):
        es.SourceSpec(tiers=TierPolicy(hot=2, warm=4), **kw).build(
            torch.zeros(11, 4), es.TablePlan(rows=10, dim=4).arena_spec)


def test_source_spec_builds_a_tiered_group_member():
    """A table group's tiered member, once refused, is built by its
    ``TierPolicy`` as a lone table's tiered plan is."""
    arena = torch.arange(44.0).reshape(11, 4)
    arena[-1] = 0
    src = es.SourceSpec(tables=(es.TablePlan(
        rows=10, dim=4, tiers=TierPolicy(hot=2, warm=4)),)).build(
        [arena], None)
    own = TierPolicy(hot=2, warm=4).build_source(
        arena, es.TablePlan(rows=10, dim=4).arena_spec)
    assert isinstance(src, es.TableGroupSource)
    for a, b in zip(es.source_structure(src.members[0])[1],
                    es.source_structure(own)[1]):
        assert torch.equal(a, b)


def test_source_spec_from_path_refusals():
    # 'sharded' needs a mesh of more than one shard: no silent fallback
    with pytest.raises(ValueError, match="require_mesh"):
        es.SourceSpec.from_path("sharded")
    with pytest.raises(ValueError, match="cache_k"):
        es.SourceSpec.from_path("cached", cache_k=0)
    with pytest.raises(ValueError, match="ignores"):
        es.SourceSpec.from_path("ragged", cache_k=4)
    with pytest.raises(ValueError, match="unknown path"):
        es.SourceSpec.from_path("hybrid")


def test_describe_and_rebind(case):
    spec, j_spec, arena, idx, off = case
    ta = _t(arena)
    counts = se.trace_row_counts(spec, idx, off)
    cache = se.build_hot_cache(ta, spec, counts, 4)
    q = es.QuantizedArena.from_arena(ta)
    j_cache = j_se.build_hot_cache(jnp.asarray(arena), j_spec, counts, 4)
    j_q = j_es.QuantizedArena.from_arena(jnp.asarray(arena))
    for src, j_src in ((es.CachedSource(cache, q),
                        j_es.CachedSource(j_cache, j_q)),
                       (es.CachedSource(cache, es.FpArena(ta)),
                        j_es.CachedSource(j_cache,
                                          j_es.FpArena(jnp.asarray(arena))))):
        assert es.describe_source(src, multiline=True) == \
            j_es.describe_source(j_src, multiline=True)
    assert es.fmt_bytes(512) == j_es.fmt_bytes(512) == "512 B"
    assert es.fmt_bytes(5 << 20) == j_es.fmt_bytes(5 << 20)
    other = ta + 1.0
    rebound = es.rebind_arena(es.CachedSource(cache, es.FpArena(ta)), other)
    assert rebound.cold.arena is other and rebound.hot is cache
    assert es.rebind_arena(q, other) is q
    assert es.hot_cache_of(rebound) is cache and es.hot_cache_of(q) is None
    swapped = es.with_hot_cache(rebound, cache)
    assert swapped.cold is rebound.cold
    with pytest.raises(TypeError):
        es.with_hot_cache(q, cache)


# ---------------------------------------------------------------------------
# the new kernel's wrapper: CUDA tensors only, checked before any build
# ---------------------------------------------------------------------------

def _cached_args(**over):
    args = {"hot_rows": torch.zeros(3, 4), "arena": torch.zeros(5, 4),
            "slots": torch.zeros(2, 3, dtype=torch.int32),
            "cold_ids": torch.zeros(2, 3, dtype=torch.int32)}
    args.update(over)
    return args


@pytest.mark.parametrize("over,msg", [
    ({}, "CUDA device"),
    ({"slots": torch.zeros(2, 3, dtype=torch.int64)}, "int32"),
    ({"slots": torch.zeros(2, 3)}, "int32"),
    ({"slots": torch.zeros(2, 3, 1, dtype=torch.int32)}, "dims"),
    ({"slots": torch.zeros(3, 2, dtype=torch.int32).t()}, "contiguous")])
def test_cached_wrapper_refuses_what_the_kernel_does_not_take(over, msg):
    """Checked in order from the ids; here, with no card, every call
    stops at the first tensor's check and nothing is built."""
    before = t_fd.cached_launches
    with pytest.raises(ValueError, match=msg):
        t_fd.fused_cached_segment_sum(**_cached_args(**over))
    assert t_fd.cached_launches == before


def test_cached_op_refuses_mixed_and_other_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_cached_segment_sum(
            **_cached_args(arena=torch.zeros(5, 4, device="meta")))
