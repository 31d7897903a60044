"""The port's fixed-layout slice against the JAX reference: the
``embedding_bag`` / ``gather_rows`` and ``sparse_lengths_sum`` ops and
their gradients, ``null_indices`` and the cache split, the ``reduce_flat``
and ``reduce_fixed`` forms of every source, ``lookup_fixed``, the
fixed-L forward, loss, train and serve steps, ``RecEngine``'s fixed plan
and the two launchers, on the same numpy inputs with the reference's
params carried across.

The CUDA kernels run only on the card (``chip_smoke.py`` holds
``embedding_bag`` and ``sparse_lengths_sum`` against their plain
versions there); here every op runs its plain version, and the Pallas
kernels run in interpret mode.

Tolerances (fp32; XLA and torch sum in different orders):
  * ids, offsets and single-row gathers: exact;
  * bag sums and their gradients: <= ~10 terms of O(1) -> atol=1e-5;
  * logits and probabilities through the MLPs: fp32 sums of O(1) over
    K <= 64 -> rtol=atol=1e-5;
  * the train step, 5 steps on DLRM_SMOKE at lr 1e-2: per-step loss
    rtol=1e-5, params atol=5e-6, for the reason stated in
    ``test_torch_training.py`` (row-wise Adagrad moves a row by up to
    ~0.1 a step, and two summation orders change that by a few 1e-6 of
    itself).
Within the port, on the CPU, the laws hold bit for bit: a bag summed by
``embedding_bag``, ``sparse_lengths_sum`` or ``fused_segment_sum`` (with
trailing null-row fill) gives the same bits, so the fixed plan equals the
ragged fp plan on equal-length bags, and the fixed train step equals the
ragged dense-gradient step.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.data import DLRMSynthetic
from repro.kernels import embedding_gather as j_eg
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import embedding_gather as t_eg
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch as t_requests

torch.set_num_threads(1)

L = CFG.lookups_per_table
LR = 1e-2
K_STEPS = 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(4), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


def _ragged_case(rng, v, b, max_l, pad=3):
    """A ragged stream over a (v, d) table: empty bags, lengths up to
    max_l, a padded tail of real-looking ids."""
    lens = rng.randint(0, max_l + 1, b)
    lens[0] = 0
    off = np.zeros(b + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    idx = rng.randint(0, v, int(off[-1]) + pad).astype(np.int32)
    return idx, off


# ---------------------------------------------------------------------------
# the ops: plain versions against the Pallas kernels and the reference ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,b,l", [(50, 32, 6, 4), (30, 16, 3, 1),
                                     (200, 48, 4, 20), (9, 8, 5, 7)])
def test_embedding_bag_matches_jax(v, d, b, l):
    rng = np.random.RandomState(v + d + b + l)
    table = rng.randn(v, d).astype(np.float32)
    idx = rng.randint(0, v, (b, l)).astype(np.int32)
    got = ops.embedding_bag(_t(table), _t(idx))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    assert torch.equal(got, ref.embedding_bag(_t(table), _t(idx)))
    for want in (j_eg.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                    interpret=True),
                 j_ref.embedding_bag(jnp.asarray(table), jnp.asarray(idx)),
                 j_ops.embedding_bag(jnp.asarray(table), jnp.asarray(idx))):
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)


def test_embedding_bag_keeps_the_table_dtype():
    # a seeded draw: with the global generator the table depended on the
    # tests run before in the same process
    table = torch.randn(10, 4, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([[1, 2], [3, 3]], dtype=torch.int32)
    got = ops.embedding_bag(table, idx)
    assert got.dtype == torch.float64
    # accumulated in f32, as the reference's embedding_bag does
    np.testing.assert_allclose(got.numpy(), table[idx.long()].sum(1).numpy(),
                               rtol=1e-6)
    empty = ops.embedding_bag(table, idx[:, :0])
    assert empty.shape == (2, 4) and not empty.any()


def test_gather_rows_matches_jax_exactly():
    rng = np.random.RandomState(7)
    table = rng.randn(40, 16).astype(np.float32)
    idx = rng.randint(0, 40, 11).astype(np.int32)
    got = ops.gather_rows(_t(table), _t(idx))
    np.testing.assert_array_equal(got.numpy(), table[idx])
    assert torch.equal(got, ref.gather_rows(_t(table), _t(idx)))
    for want in (j_eg.gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                  interpret=True),
                 j_ops.gather_rows(jnp.asarray(table), jnp.asarray(idx))):
        np.testing.assert_array_equal(got.numpy(), _n(want))


@pytest.mark.parametrize("v,d,b,max_l", [(50, 32, 7, 5), (20, 16, 4, 1),
                                         (100, 8, 9, 12)])
def test_sparse_lengths_sum_matches_jax(v, d, b, max_l):
    rng = np.random.RandomState(v * b + max_l)
    table = rng.randn(v, d).astype(np.float32)
    idx, off = _ragged_case(rng, v, b, max_l)
    got = ops.sparse_lengths_sum(_t(table), _t(idx), _t(off), max_l=max_l)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    assert torch.equal(got, ref.sparse_lengths_sum(_t(table), _t(idx),
                                                   _t(off), max_l))
    assert not got[0].any()                        # the empty bag
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off))
    for want in (j_eg.sparse_lengths_sum(*args, max_l=max_l, interpret=True),
                 j_ref.sparse_lengths_sum(*args),
                 j_ops.sparse_lengths_sum(*args, max_l=max_l)):
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)


def test_sparse_lengths_sum_over_long_bags_follows_the_pallas_kernel():
    """Bags longer than max_l lie outside the contract, and there the
    reference's two versions differ: the Pallas kernel sums a bag's first
    max_l rows, its XLA oracle the whole bag. The port follows the
    kernel (ROADMAP Queue 3)."""
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    idx = np.array([1, 2, 3, 4, 5, 6, 0, 0], np.int32)
    off = np.array([0, 5, 6], np.int32)
    got = ops.sparse_lengths_sum(_t(table), _t(idx), _t(off), max_l=2)
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off))
    pallas = _n(j_eg.sparse_lengths_sum(*args, max_l=2, interpret=True))
    oracle = _n(j_ref.sparse_lengths_sum(*args))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got[0].numpy(), [12, 14, 16, 18])
    np.testing.assert_array_equal(oracle[0], [60, 65, 70, 75])
    np.testing.assert_array_equal(got[1].numpy(), table[6])


def test_sparse_lengths_sum_edges():
    table = torch.randn(6, 4)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    off = torch.tensor([0, 0, 0], dtype=torch.int32)
    assert not ops.sparse_lengths_sum(table, idx, off, max_l=3).any()
    assert ops.sparse_lengths_sum(table, idx[:0], off, max_l=3).shape == (2, 4)
    assert not ops.sparse_lengths_sum(table, idx, off[:1], max_l=3).numel()


def _grad_case(kind, rng):
    table = rng.randn(30, 8).astype(np.float32)
    if kind == "bag":
        idx = rng.randint(0, 30, (5, 6)).astype(np.int32)
        idx[1, :3] = idx[0, 0]                     # duplicates in and across
        return table, (idx,), rng.randn(5, 8).astype(np.float32)
    idx, off = _ragged_case(rng, 30, 6, 5)
    idx[1:4] = idx[0]
    return table, (idx, off), rng.randn(6, 8).astype(np.float32)


@pytest.mark.parametrize("kind", ["bag", "sls"])
def test_gradients_match_jax_grad(kind):
    table, ids, w = _grad_case(kind, np.random.RandomState(11))
    tt = _t(table).requires_grad_()
    if kind == "bag":
        out = ops.embedding_bag(tt, _t(ids[0]))

        def j_loss(tab):
            return jnp.sum(j_ops.embedding_bag(tab, jnp.asarray(ids[0]))
                           * w)
    else:
        out = ops.sparse_lengths_sum(tt, _t(ids[0]), _t(ids[1]), max_l=5)

        def j_loss(tab):
            return jnp.sum(j_ops.sparse_lengths_sum(
                tab, jnp.asarray(ids[0]), jnp.asarray(ids[1]), max_l=5) * w)
    (out * _t(w)).sum().backward()
    want = jax.grad(j_loss)(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), _n(want), rtol=0, atol=1e-5)
    j_ops.set_impl("interpret")
    try:
        want_pallas = jax.grad(j_loss)(jnp.asarray(table))
    finally:
        j_ops.set_impl("auto")
    np.testing.assert_allclose(tt.grad.numpy(), _n(want_pallas), rtol=0,
                               atol=1e-5)


def test_one_bag_gives_the_same_bits_in_every_form():
    """embedding_bag over (B, L), sparse_lengths_sum over the same bags
    and fused_segment_sum over them with null-row fill agree bit for
    bit: each adds the bag's rows in order, and the fill adds +0.0."""
    rng = np.random.RandomState(3)
    table = torch.from_numpy((0.01 * rng.randn(500, 32)).astype(np.float32))
    table[-1] = 0.0
    ids = torch.from_numpy(rng.randint(0, 499, (40, 20)).astype(np.int32))
    fill = torch.full((40, 20), 499, dtype=torch.int32)
    off = torch.arange(41, dtype=torch.int32) * 20
    bag = ops.embedding_bag(table, ids)
    assert torch.equal(bag, ops.fused_segment_sum(
        table, torch.cat([ids, fill], 1), null_row=499))
    assert torch.equal(bag, ops.sparse_lengths_sum(table, ids.reshape(-1),
                                                   off, max_l=40))


@pytest.mark.parametrize("over,msg", [
    ({"ids": torch.zeros(2, 3, dtype=torch.int64)}, "int32"),
    ({"table": torch.ones(5, 4, dtype=torch.float64)}, "float32"),
    ({"table": torch.ones(5, 4, dtype=torch.bfloat16)}, "float32")])
def test_new_wrappers_refuse_what_the_kernels_do_not_take(over, msg):
    table = over.get("table", torch.ones(5, 4))
    ids = over.get("ids", torch.zeros(2, 3, dtype=torch.int32))
    off = torch.tensor([0, 3, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        t_eg.embedding_bag(table, ids)
    with pytest.raises(ValueError, match=msg):
        t_eg.sparse_lengths_sum(table, ids.reshape(-1), off, max_l=3)


# ---------------------------------------------------------------------------
# the sparse engine and the sources
# ---------------------------------------------------------------------------

SPEC = se.ArenaSpec(3, 30, 8)
J_SPEC = j_se.ArenaSpec(3, 30, 8)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(5)
    arena = _n(j_se.init_arena(jax.random.PRNGKey(2), J_SPEC, scale=1.0))
    fixed = rng.randint(0, 30, (4, 3, 5)).astype(np.int32)
    lens = rng.randint(0, 6, 4 * 3)
    off = np.zeros(13, np.int32)
    np.cumsum(lens, out=off[1:])
    idx = rng.randint(0, 30, int(off[-1]) + 4).astype(np.int32)
    counts = j_se.trace_row_counts(J_SPEC, idx, off)
    return arena, fixed, idx, off, counts


def test_null_indices_match_jax():
    got = se.null_indices(SPEC, (2, 3, 4))
    want = j_se.null_indices(J_SPEC, (2, 3, 4))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _n(want))
    assert (se.flatten_indices(SPEC, got) == SPEC.null_row).all()
    with pytest.raises(ValueError, match="tables"):
        se.null_indices(SPEC, (2, 4, 4))


def test_cache_split_matches_jax(case):
    arena, _, idx, off, counts = case
    cache = se.build_hot_cache(_t(arena), SPEC, counts, 6)
    j_cache = j_se.build_hot_cache(jnp.asarray(arena), J_SPEC, counts, 6)
    hot, cold, n_bags = se.cache_split(cache, SPEC, _t(idx), _t(off), 5)
    j_hot, j_cold, j_n = j_se.cache_split(j_cache, J_SPEC, jnp.asarray(idx),
                                          jnp.asarray(off), 5)
    assert n_bags == j_n and hot.dtype == torch.float32
    np.testing.assert_allclose(hot.numpy(), _n(j_hot), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cold.numpy(), _n(j_cold))


def _sources(arena, counts, mod, spec):
    """fp, int8, cached over fp and cached over int8, from one package."""
    t = _t(arena) if mod is es else jnp.asarray(arena)
    cache = mod.se.build_hot_cache(t, spec, counts, 6)
    q = mod.QuantizedArena.from_arena(t)
    return {"fp": mod.FpArena(t), "int8": q,
            "cached_fp": mod.CachedSource(cache, mod.FpArena(t),
                                          coherent=True),
            "cached_int8": mod.CachedSource(cache, q)}


SOURCES = ["fp", "int8", "cached_fp", "cached_int8"]


@pytest.mark.parametrize("name", SOURCES)
def test_lookup_fixed_matches_jax(case, name):
    arena, fixed, _, _, counts = case
    src = _sources(arena, counts, es, SPEC)[name]
    j_src = _sources(arena, counts, j_es, J_SPEC)[name]
    got = es.lookup_fixed(src, SPEC, _t(fixed))
    want = j_es.lookup_fixed(j_src, J_SPEC, jnp.asarray(fixed))
    assert got.shape == (4, 3, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", SOURCES)
def test_reduce_flat_matches_jax(case, name):
    arena, _, idx, off, counts = case
    src = _sources(arena, counts, es, SPEC)[name]
    j_src = _sources(arena, counts, j_es, J_SPEC)[name]
    flat = se.flatten_ragged_indices(SPEC, _t(idx), _t(off))
    j_flat = j_se.flatten_ragged_indices(J_SPEC, jnp.asarray(idx),
                                         jnp.asarray(off))
    got = src.reduce_flat(SPEC, flat, _t(off), max_l=5)
    want = j_src.reduce_flat(J_SPEC, j_flat, jnp.asarray(off), max_l=5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=0, atol=1e-5)
    # and the ragged entry point over the fused form agrees
    fused = src.reduce_bags(SPEC, _t(idx), _t(off), max_l=5)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=0,
                               atol=1e-5)


@dataclasses.dataclass(frozen=True)
class FlatOnly(es.EmbeddingSource):
    """A new source as the protocol allows: ``reduce_flat`` alone."""
    arena: torch.Tensor

    @property
    def out_dtype(self):
        return self.arena.dtype

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        return ops.sparse_lengths_sum(self.arena, flat, offsets,
                                      max_l=max_l).float()


def test_reduce_flat_only_source_serves_every_entry_point(case):
    """The base class's fallbacks route both entry points of a
    reduce_flat-only source through sparse_lengths_sum, bit for bit
    equal to the fp arena's fused forms."""
    arena, fixed, idx, off, _ = case
    fp, flat_only = es.FpArena(_t(arena)), FlatOnly(_t(arena))
    assert torch.equal(
        es.lookup_bags(flat_only, SPEC, _t(idx), _t(off), max_l=5),
        es.lookup_bags(fp, SPEC, _t(idx), _t(off), max_l=5))
    assert torch.equal(es.lookup_fixed(flat_only, SPEC, _t(fixed)),
                       es.lookup_fixed(fp, SPEC, _t(fixed)))


def test_base_source_without_reductions_raises(case):
    class Empty(es.EmbeddingSource):
        out_dtype = torch.float32
    with pytest.raises(NotImplementedError, match="reduce_flat"):
        es.lookup_fixed(Empty(), SPEC, _t(case[1]))


def test_lookup_fixed_equals_lookup_bags_bitwise(case):
    """A fixed batch is a uniform ragged batch: lookup_fixed over the fp
    arena (embedding_bag) equals lookup_bags over the same bags with room
    for fill (fused_segment_sum), bit for bit."""
    arena, fixed, _, _, _ = case
    b, t, l = fixed.shape
    off = torch.arange(b * t + 1, dtype=torch.int32) * l
    src = es.FpArena(_t(arena))
    got = es.lookup_fixed(src, SPEC, _t(fixed))
    for max_l in (l, 2 * l + 1):
        assert torch.equal(got, es.lookup_bags(
            src, SPEC, _t(fixed).reshape(-1), off, max_l=max_l))


def test_fixed_source_spec_matches_jax(case):
    arena = case[0]
    plan = es.SourceSpec.from_path("fixed")
    j_plan = j_es.SourceSpec.from_path("fixed")
    assert plan.layout == j_plan.layout == "fixed"
    assert plan.path_name() == j_plan.path_name() == "fixed"
    src = plan.build(_t(arena), SPEC)
    assert isinstance(src, es.FpArena) and torch.equal(src.arena,
                                                        _t(arena))
    for kw in ({"cache_k": 4}, {"quantize_cold": True}):
        with pytest.raises(ValueError, match="fixed"):
            es.SourceSpec(layout="fixed", **kw)


# ---------------------------------------------------------------------------
# the model: forward, loss, train and serve steps
# ---------------------------------------------------------------------------

def _fixed_batch(n, seed):
    return DLRMSynthetic(J_CFG, seed=seed).batch(n)


def test_forward_and_serve_step_match_jax(np_params, params):
    b = _fixed_batch(12, seed=2)
    got = t_dlrm.forward(params, CFG, _t(b["dense"]), _t(b["indices"]))
    want = j_dlrm.forward(np_params, J_CFG, jnp.asarray(b["dense"]),
                          jnp.asarray(b["indices"]))
    np.testing.assert_allclose(got.detach().numpy(), _n(want), rtol=1e-5,
                               atol=1e-5)
    probs = t_dlrm.make_serve_step(CFG)(params, {
        "dense": _t(b["dense"]), "indices": _t(b["indices"])})
    j_probs = j_dlrm.make_serve_step(J_CFG)(np_params, {
        "dense": jnp.asarray(b["dense"]),
        "indices": jnp.asarray(b["indices"])})
    assert probs.is_inference()
    np.testing.assert_allclose(probs.numpy(), _n(j_probs), rtol=1e-5,
                               atol=1e-5)
    # a mesh is the port's launch.mesh.Mesh (the sharded forward runs
    # across ranks in tests/test_torch_sharded_dist.py)
    with pytest.raises(TypeError, match="Mesh"):
        t_dlrm.forward(params, CFG, _t(b["dense"]), _t(b["indices"]),
                       mesh=object())


def test_loss_and_its_gradients_match_jax(np_params, params):
    b = _fixed_batch(8, seed=3)
    p = {**params, "arena": params["arena"].clone().requires_grad_()}
    loss = t_dlrm.loss_fn(p, CFG, _t(b["dense"]), _t(b["indices"]),
                          _t(b["labels"]))
    loss.backward()
    j_loss, j_g = jax.value_and_grad(j_dlrm.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), J_CFG,
        jnp.asarray(b["dense"]), jnp.asarray(b["indices"]),
        jnp.asarray(b["labels"]))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(p["arena"].grad.numpy(), _n(j_g["arena"]),
                               rtol=1e-5, atol=1e-6)


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def test_train_step_matches_jax_over_five_steps(np_params):
    data = DLRMSynthetic(J_CFG, seed=6)
    batches = [data.batch(16) for _ in range(K_STEPS)]
    j_opt, j_step = j_dlrm.make_train_step(
        J_CFG, optimizer=j_dlrm.make_optimizer(J_CFG, LR))
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_state = j_opt.init(j_params)
    opt, step = t_dlrm.make_train_step(CFG,
                                       optimizer=t_dlrm.make_optimizer(CFG,
                                                                       LR))
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    state = opt.init(params)
    keys = ("dense", "indices", "labels")
    for b in batches:
        j_params, j_state, j_loss = jax.jit(j_step)(
            j_params, j_state, {k: jnp.asarray(b[k]) for k in keys})
        params, state, loss = step(params, state,
                                   {k: _t(b[k]) for k in keys})
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        for name in ("bottom", "top", "arena"):
            for a, w in zip(tree_leaves(params[name]),
                            jax.tree_util.tree_leaves(j_params[name])):
                np.testing.assert_allclose(a.numpy(), _n(w), rtol=0,
                                           atol=5e-6)
    assert not params["arena"][CFG.n_tables * CFG.rows_per_table].any()


def test_fixed_train_step_equals_ragged_dense_step_bitwise(np_params):
    """On equal-length bags with max_l = L the fixed step and the ragged
    dense-gradient step add the same terms in the same order."""
    rb = [DLRMSynthetic(J_CFG, seed=s).ragged_batch(8, dist="fixed")
          for s in (8, 9, 10)]
    opt, fixed_step = t_dlrm.make_train_step(
        CFG, optimizer=t_dlrm.make_optimizer(CFG, LR))
    _, ragged_step = t_dlrm.make_train_step_ragged(CFG, max_l=L, lr=LR,
                                                   sparse=False)
    p1 = t_dlrm.params_from_numpy(np_params, "cpu")
    p2 = _copy(p1)
    s1, s2 = opt.init(p1), opt.init(p2)
    for b in rb:
        fixed_ids = DLRMSynthetic.ragged_to_fixed(b, CFG.n_tables)
        p1, s1, l1 = fixed_step(p1, s1, {"dense": _t(b["dense"]),
                                         "indices": _t(fixed_ids),
                                         "labels": _t(b["labels"])})
        p2, s2, l2, _ = ragged_step(p2, s2, {
            k: _t(b[k]) for k in ("dense", "indices", "offsets", "labels")})
        assert torch.equal(l1, l2)
        assert all(torch.equal(a, c) for a, c in zip(tree_leaves(p1),
                                                     tree_leaves(p2)))


# ---------------------------------------------------------------------------
# RecEngine's fixed plan
# ---------------------------------------------------------------------------

def _engine(params, **kw):
    kw = {"max_batch": 8, "max_wait_ms": 0.0, "buckets": (2, 4, 8),
          "device": "cpu", **kw}
    return RecEngine(CFG, params, **kw)


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
        engine.step()
    engine.drain()
    return np.array([r.prob for r in reqs])


@pytest.mark.parametrize("n", [13, 8])
def test_fixed_engine_matches_reference_engine(np_params, params, n):
    rb = DLRMSynthetic(J_CFG, seed=12).ragged_batch(n, dist="fixed")
    j_engine = JRecEngine(J_CFG, np_params, source="fixed", max_batch=8,
                          max_wait_ms=0.0, buckets=(2, 4, 8))
    engine = _engine(params, source="fixed")
    engine.warmup()
    want = _serve(j_engine, j_requests(rb, J_CFG.n_tables))
    got = _serve(engine, t_requests(rb, CFG.n_tables))
    assert engine.served == j_engine.served == n
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    stats = engine.stats()
    assert stats["path"] == "fixed" and stats["cache_hit_rate"] is None


def test_fixed_engine_equals_ragged_engine_bitwise(params):
    """The fixed plan serves the ragged fp plan's exact probabilities on
    equal-length bags, the ragged plan with room for longer bags."""
    rb = DLRMSynthetic(J_CFG, seed=13).ragged_batch(11, dist="fixed")
    fixed = _serve(_engine(params, source="fixed"),
                   t_requests(rb, CFG.n_tables))
    ragged = _serve(_engine(params, source="ragged", max_l=2 * L),
                    t_requests(rb, CFG.n_tables))
    assert np.array_equal(fixed, ragged)


def test_fixed_engine_refusals(params):
    engine = _engine(params, source="fixed")
    with pytest.raises(ValueError, match="fixed-layout engine"):
        engine.update_source(es.FpArena(params["arena"]))
    engine.submit(t_requests(DLRMSynthetic(J_CFG, seed=1).ragged_batch(
        1, dist="fixed", mean_l=L - 1), CFG.n_tables)[0])
    with pytest.raises(ValueError, match=f"exactly {L} ids"):
        engine.drain()
    with pytest.raises(ValueError, match="fixed"):
        _engine(params, source=es.SourceSpec(layout="fixed", cache_k=4))


# ---------------------------------------------------------------------------
# the launchers on the CPU
# ---------------------------------------------------------------------------

def test_train_launcher_trains_the_fixed_layout_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_train.main(["--smoke", "--device", "cpu", "--steps", "4",
                             "--log-every", "2", "--batch-size", "8"])
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"],
                                                    ["step", "2"]]
    assert lines[-1] == f"final loss {loss:.4f}" and np.isfinite(loss)


@pytest.mark.parametrize("argv", [["--ckpt-dir", "x", "--ckpt-every", "0"],
                                  ["--resume"]])
def test_train_launcher_refuses_checkpoints(argv):
    """Checkpoints are ported (tests/test_torch_checkpoint.py); what the
    launcher refuses of them is a save cadence below one step and
    ``--resume`` without ``--ckpt-dir``."""
    err = io.StringIO()
    with pytest.raises(SystemExit), redirect_stdout(err):
        t_train.main(["--smoke", "--device", "cpu", *argv])


@pytest.mark.parametrize("pipelined", [False, True])
def test_serve_launcher_on_cpu(pipelined):
    argv = ["--smoke", "--device", "cpu", "--requests", "32",
            "--batch-size", "8"] + (["--pipelined", "--microbatches", "2"]
                                    if pipelined else [])
    out = io.StringIO()
    with redirect_stdout(out):
        stats = t_serve.main(argv)
    assert stats["steps"] == 4 and 0 < stats["p50_ms"] <= stats["p99_ms"]
    assert out.getvalue().startswith("dlrm serve: 32 reqs, batch 8")


@pytest.mark.parametrize("argv,item", [(["--mesh", "pod"], "item 13"),
                                       (["--arch", "gpt-2"],
                                        "unknown arch")])
def test_serve_launcher_refuses_what_is_not_ported(argv, item, capsys):
    if argv[0] == "--mesh":
        # the production meshes are ported (item 13): on one process
        # --mesh pod reaches make_production_mesh, which raises the
        # reference's RuntimeError below 256 ranks
        with pytest.raises(RuntimeError, match="need 256 ranks"):
            t_serve.main(["--smoke", "--device", "cpu", *argv])
        return
    with pytest.raises(SystemExit):
        t_serve.main(["--smoke", "--device", "cpu", *argv])
    assert item in capsys.readouterr().err


def test_serve_launcher_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--smoke"])
