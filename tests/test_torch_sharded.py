"""The port's row-sharded embedding subsystem in one process, against the
JAX reference on shared numpy inputs.

Each shard-local half (rank s's f32 partials over its block, the zero
sentinel holding every id the rank does not own) is summed over the
shards here, and held against the reference's composition under
``jax.vmap(..., axis_name="x")``, whose ``axis_index`` and ``psum``
behave as under ``shard_map`` (the pattern of
``tests/test_sharded_sparse.py``): the fp, int8 and cached-cold reduces,
``shard_local_rows`` and the rank's Adagrad. Shard counts 1, 2, 4 and 8
over ``rows_per_table`` 29, 30 and 37, so the arena's padded rows are in
play at every count above one; every case holds an empty bag, a full
bag, a duplicate id, an all-null bag and a padded tail. Also: padded
arenas and blocks, the one-shard source against the replicated one, the
masked plain versions, the sentinel's pinned gradient, the codec's
``ShardedArena`` with a blob the reference wrote, a checkpoint restored
onto 2 ranks of a 4-rank save, the mesh and plan refusals, and
``distributed.compression`` against the reference. The collectives
themselves run across gloo ranks in ``test_torch_sharded_dist.py``.

Tolerances: sharded against replicated is not bit-equal in general (a
bag's rows on several shards are summed in another association), so the
reference's own bound holds, ``rtol=1e-5, atol=1e-6``; the optimizer
against the reference ``rtol=1e-6, atol=1e-7`` (its test's). Exact: one
shard against the replicated path, bags whose rows lie on one shard,
the projection, the sentinel, the codec's rows, the restored blocks, and
the int8 codes of the compression.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.dlrm import DLRM_SMOKE as J_SMOKE
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.distributed import compression as j_comp
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.training import sparse_optim as j_so
from repro_torch.checkpoint import (CheckpointManager, reshard_checkpoint,
                                    row_shardings)
from repro_torch.configs.dlrm import DLRM_SMOKE
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.distributed import compression
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.storage import TierPolicy
from repro_torch.training import sparse_optim as so

torch.set_num_threads(1)

SHARD_COUNTS = (1, 2, 4, 8)
# 3 * r + 1 never divides 8: the padded rows are in play at shards > 1
UNEVEN_ROWS = (29, 30, 37)
RTOL, ATOL = 1e-5, 1e-6
MAX_L = 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _ragged_case(rng, spec, b, max_l, pad=0):
    """The reference test's case: a ragged batch with an empty bag, a full
    bag, a duplicate id, an all-null bag and a padded tail."""
    n_bags = b * spec.n_tables
    lens = rng.randint(0, max_l + 1, n_bags).astype(np.int32)
    lens[0] = 0
    lens[-1] = max_l
    lens[1] = max(lens[1], 1)
    off = np.zeros(n_bags + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    n = int(off[-1])
    idx = rng.randint(0, spec.rows_per_table, n + pad).astype(np.int32)
    if n >= 2:
        idx[off[-2]] = idx[0] if lens[0] else idx[n - 1]
    t1 = 1 % spec.n_tables
    idx[off[1]:off[2]] = spec.null_row - t1 * spec.rows_per_table
    return idx, off


def _case(shards, rpt, seed, scale=0.01):
    """(spec, padded arena (numpy), ids, offsets) of one case."""
    rng = np.random.RandomState(seed)
    spec = j_se.ArenaSpec(3, rpt, 8)
    arena = np.asarray(j_se.init_arena(jax.random.PRNGKey(seed), spec,
                                       shards, scale=scale))
    idx, off = _ragged_case(rng, spec, b=3, max_l=MAX_L, pad=4)
    return spec, arena, idx, off


def _t_spec(spec):
    return se.ArenaSpec(spec.n_tables, spec.rows_per_table, spec.dim)


def _blocks(arena_t, shards):
    return [se.shard_block(arena_t, s, shards) for s in range(shards)]


def _shard_view(x, shards):
    return x.reshape(shards, -1, *x.shape[1:])


def _summed(parts):
    """The ranks' partials summed in rank order, as one all-reduce
    would (up to association)."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _flat_dense(spec, idx, off):
    """(flat arena ids, the (n_bags, MAX_L) relayout) as numpy, by the
    reference's functions."""
    flat = j_se.flatten_ragged_indices(spec, jnp.asarray(idx),
                                       jnp.asarray(off))
    dense = j_se.ragged_dense_ids(flat, jnp.asarray(off), max_l=MAX_L,
                                  fill=spec.null_row)
    return np.asarray(flat), np.asarray(dense)


# ---------------------------------------------------------------------------
# the arena's padding and the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("rpt", UNEVEN_ROWS)
def test_padded_rows_and_blocks(shards, rpt):
    j_spec = j_se.ArenaSpec(3, rpt, 8)
    spec = _t_spec(j_spec)
    assert spec.padded_rows(shards) == j_spec.padded_rows(shards)
    arena = se.init_arena(torch.Generator().manual_seed(rpt), spec, shards)
    assert arena.shape == (j_spec.padded_rows(shards), 8)
    assert not arena[spec.null_row:].any()
    assert arena[:spec.null_row].abs().sum() > 0
    blocks = _blocks(arena, shards)
    vlocal = arena.shape[0] // shards
    for s, blk in enumerate(blocks):
        assert blk.shape == (vlocal + 1, 8)
        assert torch.equal(blk[:-1], arena[s * vlocal:(s + 1) * vlocal])
        assert not blk[-1].any()
        assert se.shard_row_range(blk, s) == (s * vlocal, vlocal)
    assert torch.equal(torch.cat([b[:-1] for b in blocks]), arena)


def test_init_shards_and_params_from_numpy_of_a_padded_arena():
    """``dlrm.init(..., shards)`` pads as the reference's; the reference's
    padded params carry across, and ``shard_params`` takes a rank's
    block of them (one shard: the params as they are)."""
    for shards in (1, 4):
        j_params = jax.tree.map(np.asarray, j_dlrm.init(
            jax.random.PRNGKey(0), J_SMOKE, shards))
        params = dlrm.params_from_numpy(j_params, device="cpu")
        want = dlrm.arena_spec(DLRM_SMOKE).padded_rows(shards)
        assert params["arena"].shape[0] == want \
            == j_params["arena"].shape[0]
        own = dlrm.init(torch.Generator().manual_seed(0), DLRM_SMOKE,
                        shards, device="cpu")
        assert own["arena"].shape == params["arena"].shape
        if shards == 1:
            assert dlrm.shard_params(params, make_mesh((1,),
                                                       ("model",))) \
                is params
            continue
        for r in range(shards):
            mesh = Mesh((("model", None, r, shards),))
            mine = dlrm.shard_params(params, mesh)
            vlocal = want // shards
            assert torch.equal(mine["arena"][:-1],
                               params["arena"][r * vlocal:(r + 1) * vlocal])
            assert not mine["arena"][-1].any()
            assert mine["bottom"] is params["bottom"]
        with pytest.raises(ValueError, match="pad it"):
            dlrm.shard_params(dlrm.init(torch.Generator().manual_seed(0),
                                        DLRM_SMOKE, 1, device="cpu"),
                              Mesh((("model", None, 0, 4),)))


# ---------------------------------------------------------------------------
# the shard-local halves against the reference's vmap composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("rpt", UNEVEN_ROWS)
def test_fp_partial_reduces_match_the_reference(shards, rpt):
    """The flat, dense and fixed-L halves of ``FpArena``: summed over the
    shards, within the reference's bound of its shard_map composition
    and of the replicated lookup."""
    j_spec, arena, idx, off = _case(shards, rpt, seed=rpt * 10 + shards)
    spec = _t_spec(j_spec)
    flat, dense = _flat_dense(j_spec, idx, off)
    j_arena = jnp.asarray(arena)
    view = _shard_view(j_arena, shards)
    want_flat = np.asarray(jax.vmap(
        lambda a: j_es.FpArena(a).shard_reduce_flat(
            j_spec, jnp.asarray(flat), jnp.asarray(off), "x"),
        axis_name="x")(view))
    want_dense = np.asarray(jax.vmap(
        lambda a: j_es.FpArena(a).shard_reduce_fixed(
            j_spec, jnp.asarray(dense), "x"), axis_name="x")(view))
    plain = np.asarray(j_es.lookup_bags(
        j_es.FpArena(j_arena), j_spec, jnp.asarray(idx), jnp.asarray(off),
        max_l=MAX_L)).reshape(-1, spec.dim)
    blocks = [es.FpArena(b) for b in _blocks(_t(arena), shards)]
    got_flat = _summed([b.shard_reduce_flat(spec, _t(flat), _t(off), s,
                                            max_l=MAX_L)
                        for s, b in enumerate(blocks)]).numpy()
    got_dense = _summed([b.shard_reduce_dense(spec, _t(dense), s)
                         for s, b in enumerate(blocks)]).numpy()
    got_fixed = _summed([b.shard_reduce_fixed(spec, _t(dense), s)
                         for s, b in enumerate(blocks)]).numpy()
    for s in range(shards):
        np.testing.assert_allclose(got_flat, want_flat[s], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got_dense, want_dense[s], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got_fixed, want_dense[s], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got_dense, plain, rtol=RTOL, atol=ATOL)
    # the dense and fixed halves read the same rows in the same order
    assert np.array_equal(got_dense, got_fixed)


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("rpt", UNEVEN_ROWS)
def test_int8_partial_reduces_match_the_reference(shards, rpt):
    """``QuantizedArena``'s halves over int8 blocks (a zero-scale
    sentinel) against the reference's ``ragged_partial_reduce_q`` and
    its fixed half under vmap."""
    j_spec, arena, idx, off = _case(shards, rpt, seed=rpt + shards,
                                    scale=1.0)
    spec = _t_spec(j_spec)
    flat, dense = _flat_dense(j_spec, idx, off)
    q, scales = j_se.quantize_arena(jnp.asarray(arena))
    want_flat = np.asarray(jax.vmap(
        lambda qq, ss: j_se.ragged_partial_reduce_q(
            qq, ss, jnp.asarray(flat), jnp.asarray(off), "x"),
        axis_name="x")(_shard_view(q, shards), _shard_view(scales, shards)))
    want_dense = np.asarray(jax.vmap(
        lambda qq, ss: j_es.QuantizedArena(qq, ss).shard_reduce_fixed(
            j_spec, jnp.asarray(dense), "x"),
        axis_name="x")(_shard_view(q, shards), _shard_view(scales, shards)))
    t_q = es.QuantizedArena.from_arena(_t(arena))
    assert np.array_equal(t_q.q.numpy(), np.asarray(q))
    blocks = [es.QuantizedArena(*(se.shard_block(x, s, shards)
                                  for x in (t_q.q, t_q.scales)))
              for s in range(shards)]
    got_flat = _summed([b.shard_reduce_flat(spec, _t(flat), _t(off), s,
                                            max_l=MAX_L)
                        for s, b in enumerate(blocks)]).numpy()
    got_dense = _summed([b.shard_reduce_dense(spec, _t(dense), s)
                         for s, b in enumerate(blocks)]).numpy()
    for s in range(shards):
        np.testing.assert_allclose(got_flat, want_flat[s], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got_dense, want_dense[s], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("rpt", UNEVEN_ROWS)
def test_cached_over_sharded_cold_matches_the_reference(shards, rpt):
    """The hot pass (``fused_segment_sum`` over the slots, the miss slot
    pinned) plus the cold partials over the redirected ids, against the
    reference's replicated hot pass + vmapped cold reduce and its plain
    lookup."""
    j_spec, arena, idx, off = _case(shards, rpt, seed=rpt * 7 + shards)
    spec = _t_spec(j_spec)
    j_idx, j_off = jnp.asarray(idx), jnp.asarray(off)
    j_arena = jnp.asarray(arena)
    counts = j_se.trace_row_counts(j_spec, idx, off)
    cache = j_se.build_hot_cache(j_arena, j_spec, counts, k=8)
    hot, cold_idx, n_bags = j_se.cache_split(cache, j_spec, j_idx, j_off,
                                             MAX_L)
    colds = np.asarray(jax.vmap(
        lambda a: j_se.ragged_partial_reduce(a, cold_idx, j_off, "x"),
        axis_name="x")(_shard_view(j_arena, shards)))
    want = np.asarray(hot)[None] + colds
    plain = np.asarray(j_es.lookup_bags(j_es.FpArena(j_arena), j_spec,
                                        j_idx, j_off, max_l=MAX_L)
                       ).reshape(-1, spec.dim)

    t_cache = se.build_hot_cache(_t(arena), spec, counts, 8)
    assert np.array_equal(t_cache.hot_ids.numpy(), np.asarray(cache.hot_ids))
    _, dense = _flat_dense(j_spec, idx, off)
    slots = t_cache.slot_of[_t(dense)]
    cold_ids = torch.where(slots < t_cache.k, spec.null_row, _t(dense))
    got_hot = ops.fused_segment_sum(t_cache.hot_rows, slots,
                                    null_row=t_cache.k)
    blocks = [es.FpArena(b) for b in _blocks(_t(arena), shards)]
    got = (got_hot + _summed([b.shard_reduce_dense(spec, cold_ids, s)
                              for s, b in enumerate(blocks)])).numpy()
    for s in range(shards):
        np.testing.assert_allclose(got, want[s], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shards", (2, 4, 8))
def test_partials_are_exact_where_each_bag_lies_on_one_shard(shards):
    """Every bag's rows owned by one rank: the other ranks add exact
    zeros, so the sum of the partials is the replicated reduce bit for
    bit."""
    spec = se.ArenaSpec(3, 37, 8)
    arena = se.init_arena(torch.Generator().manual_seed(shards), spec,
                          shards, scale=1.0)
    vlocal = arena.shape[0] // shards
    rng = np.random.RandomState(shards)
    owner = rng.randint(0, shards, 12)
    dense = np.stack([rng.randint(o * vlocal, min((o + 1) * vlocal,
                                                  spec.null_row), MAX_L)
                      for o in owner]).astype(np.int32)
    dense[0, 3:] = spec.null_row
    want = es.FpArena(arena).reduce_dense(spec, _t(dense))
    blocks = [es.FpArena(b) for b in _blocks(arena, shards)]
    got = _summed([b.shard_reduce_dense(spec, _t(dense), s)
                   for s, b in enumerate(blocks)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("shards", (2, 4))
def test_sentinel_redirect_against_the_masked_plain_versions(shards):
    """The kernels' sentinel redirect against the reference's masked
    take-and-sum, ported as the plain versions (``_masked_partial_reduce``
    over a flat stream, ``_masked_fixed_partial_reduce`` over a dense
    matrix with the null row masked)."""
    j_spec, arena, idx, off = _case(shards, 30, seed=shards)
    spec = _t_spec(j_spec)
    flat, dense = _flat_dense(j_spec, idx, off)
    arena_t = _t(arena)
    for s, blk in enumerate(_blocks(arena_t, shards)):
        lo, vlocal = se.shard_row_range(blk, s)
        gather = lambda rows, b=blk: b[rows].float()  # noqa: E731
        plain_flat = se._masked_partial_reduce(gather, lo, vlocal, _t(flat),
                                               _t(off))
        plain_dense = se._masked_fixed_partial_reduce(
            gather, lo, vlocal, _t(dense), null_row=spec.null_row)
        torch.testing.assert_close(
            se.ragged_partial_reduce(blk, _t(flat), _t(off), s,
                                     max_l=MAX_L), plain_flat,
            rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(
            se.dense_partial_reduce(blk, _t(dense), s,
                                    null_row=spec.null_row), plain_dense,
            rtol=RTOL, atol=ATOL)


def test_the_sentinel_takes_no_gradient():
    """Foreign ids and the null row sit on the sentinel; the fused and
    fixed-L halves pin its gradient to zero, and an owned row's gradient
    is the replicated one."""
    spec = se.ArenaSpec(2, 13, 4)
    arena = se.init_arena(torch.Generator().manual_seed(0), spec, 4)
    dense = torch.tensor([[0, 7, 26, 3], [12, 12, 5, 26]], dtype=torch.int32)
    g = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    full = arena.clone().requires_grad_()
    (ops.fused_segment_sum(full, dense, null_row=26) * g).sum().backward()
    for s, blk in enumerate(_blocks(arena, 4)):
        lo, vlocal = se.shard_row_range(blk, s)
        for half in (se.dense_partial_reduce, se.fixed_partial_reduce):
            b = blk.clone().requires_grad_()
            (half(b, dense, s, null_row=26) * g).sum().backward()
            assert not b.grad[-1].any()
            assert torch.equal(b.grad[:-1], full.grad[lo:lo + vlocal])


# ---------------------------------------------------------------------------
# shard-local row updates against the replicated sparse optimizer
# ---------------------------------------------------------------------------

def test_shard_local_rows_projection_matches_the_reference():
    rows = np.asarray([3, 7, 10, 12, 26], np.int32)     # 26: the null row
    g = np.ones((5, 2), np.float32)
    for lo in (7, 21, 0):
        want = j_so.shard_local_rows(jnp.asarray(rows), jnp.asarray(g),
                                     lo=lo, vlocal=7, null_row=26)
        got = so.shard_local_rows(_t(rows), _t(g), lo=lo, vlocal=7,
                                  null_row=26)
        assert got[0].dtype == torch.int32
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("steps", (1, 3))
def test_shard_local_adagrad_matches_the_replicated_reference(shards, steps):
    """Each block's row-wise Adagrad over its projected slice, against the
    reference's replicated ``sparse_rowwise_adagrad`` on the same row
    gradients (the arena and the accumulator, several accumulating
    steps); the null row and every sentinel stay zero."""
    rng = np.random.RandomState(shards * 10 + steps)
    j_spec = j_se.ArenaSpec(2, 13, 4)          # 27 rows: pads at 2/4/8
    spec = _t_spec(j_spec)
    arena = np.asarray(j_se.init_arena(jax.random.PRNGKey(shards), j_spec,
                                       shards))
    j_opt, opt = j_so.sparse_rowwise_adagrad(0.1), so.sparse_rowwise_adagrad(
        0.1)
    repl, repl_state = jnp.asarray(arena), j_opt.init(jnp.asarray(arena))
    blocks = _blocks(_t(arena), shards)
    states = [opt.init(b) for b in blocks]
    vlocal = arena.shape[0] // shards
    for _ in range(steps):
        idx, off = _ragged_case(rng, j_spec, b=2, max_l=4, pad=2)
        flat = j_se.flatten_ragged_indices(j_spec, jnp.asarray(idx),
                                           jnp.asarray(off))
        d_bags = jnp.asarray(rng.randn(off.shape[0] - 1, 4), jnp.float32)
        rows, row_g = j_so.ragged_row_grads(d_bags, flat, jnp.asarray(off),
                                            fill_row=j_spec.null_row)
        repl, repl_state = j_opt.update(repl, repl_state, rows, row_g)
        t_rows, t_g = so.source_row_grads(spec, _t(d_bags), _t(idx),
                                          _t(off))
        assert np.array_equal(t_rows.numpy(), np.asarray(rows))
        for s in range(shards):
            lrows, lg = so.shard_local_rows(t_rows, t_g, lo=s * vlocal,
                                            vlocal=vlocal,
                                            null_row=spec.null_row)
            blocks[s], states[s] = opt.update(blocks[s], states[s], lrows,
                                              lg)
    got = torch.cat([b[:-1] for b in blocks]).numpy()
    np.testing.assert_allclose(got, np.asarray(repl), rtol=1e-6, atol=1e-7)
    got_acc = torch.cat([st["acc"][:-1] for st in states]).numpy()
    np.testing.assert_allclose(got_acc, np.asarray(repl_state["acc"]),
                               rtol=1e-6, atol=1e-7)
    assert not got[spec.null_row:].any()
    assert all(not b[-1].any() and not st["acc"][-1].any()
               for b, st in zip(blocks, states))


# ---------------------------------------------------------------------------
# one shard, the codec, checkpoints
# ---------------------------------------------------------------------------

def test_one_shard_is_the_replicated_path_bit_for_bit():
    spec = se.ArenaSpec(3, 30, 8)
    arena = se.init_arena(torch.Generator().manual_seed(0), spec, 1)
    idx, off = _ragged_case(np.random.RandomState(0), spec, 3, MAX_L, 4)
    mesh = make_mesh((1,), ("model",))
    assert se.mesh_shards(mesh) == 1
    assert isinstance(es.resolve_source(arena, mesh), es.FpArena)
    sharded = es.ShardedArena(es.FpArena(arena), mesh)
    plain = es.FpArena(arena)
    for fn in (lambda s: es.lookup_bags(s, spec, _t(idx), _t(off),
                                        max_l=MAX_L),
               lambda s: es.lookup_fixed(s, spec, _t(idx[:24]).reshape(
                   2, 3, 4))):
        assert torch.equal(fn(sharded), fn(plain))
    assert es.describe_source(sharded) == "sharded(1,fp)"


def test_codec_decodes_a_reference_sharded_blob():
    """A blob the reference wrote with a ``ShardedArena`` holds the
    unsharded rows: decoded without a mesh (or on one shard) it is the
    replicated inner source, on a rank of a mesh that rank's block."""
    j_spec = j_se.ArenaSpec(3, 30, 8)
    arena = j_se.init_arena(jax.random.PRNGKey(3), j_spec, 1)
    blob = j_es.VersionedSource(
        j_es.ShardedArena(j_es.FpArena(arena), j_make_mesh((1,),
                                                           ("model",))),
        5).serialize()
    for mesh in (None, make_mesh((1,), ("model",))):
        art = es.VersionedSource.deserialize(blob, mesh, device="cpu")
        assert art.version == 5 and isinstance(art.source, es.FpArena)
        assert np.array_equal(art.source.arena.numpy(), np.asarray(arena))
    art = es.VersionedSource.deserialize(
        blob, Mesh((("model", None, 2, 4),)), device="cpu")
    assert isinstance(art.source, es.ShardedArena)
    assert art.source.shard == 2 and art.source.n_shards == 4
    want = se.shard_block(_t(arena), 2, 4)
    assert torch.equal(art.source.inner.arena, want)
    assert art.source.inner.arena.shape[0] == -(-91 // 4) + 1


def test_a_four_rank_checkpoint_restores_at_two_ranks(tmp_path):
    """A train state saved unsharded from 4 ranks (here by the reference,
    whose layout the port writes) restored onto each rank of a 2-rank
    mesh: the rank's block of the arena and of its accumulator, the
    padding the 4-rank arena has past the 2-rank one dropped, the
    replicated leaves whole; and the reference restores the same file."""
    j_params = j_dlrm.init(jax.random.PRNGKey(0), J_SMOKE, 4)
    j_state = {"arena": j_params["arena"],
               "acc": jnp.arange(j_params["arena"].shape[0],
                                 dtype=jnp.float32)[:, None],
               "w": j_params["bottom"][0][0]}
    j_state["acc"] = j_state["acc"].at[J_SMOKE.n_tables
                                       * J_SMOKE.rows_per_table:].set(0.0)
    JCheckpointManager(tmp_path).save(3, j_state)
    spec = dlrm.arena_spec(DLRM_SMOKE)
    full = {k: np.asarray(v) for k, v in j_state.items()}
    vlocal = spec.padded_rows(2) // 2
    for r in range(2):
        mesh = Mesh((("model", None, r, 2),))
        template = {"arena": torch.zeros(vlocal + 1, spec.dim),
                    "acc": torch.zeros(vlocal + 1, 1),
                    "w": torch.zeros(full["w"].shape)}
        shardings = {"arena": mesh, "acc": mesh, "w": None}
        for restore in (
                lambda: CheckpointManager(tmp_path, device="cpu").restore(
                    template, shardings=shardings),
                lambda: reshard_checkpoint(tmp_path, template, shardings,
                                           device="cpu")):
            got, manifest = restore()
            assert manifest["step"] == 3
            for k in ("arena", "acc"):
                assert np.array_equal(got[k][:-1].numpy(),
                                      full[k][r * vlocal:(r + 1) * vlocal])
                assert not got[k][-1].any()
            assert np.array_equal(got["w"].numpy(), full["w"])
    j_back, _ = JCheckpointManager(tmp_path).restore(j_state)
    assert np.array_equal(np.asarray(j_back["arena"]), full["arena"])
    # rows past the new shard count's that are not padding are refused
    bad = dict(j_state, arena=j_state["arena"].at[-1].set(1.0))
    JCheckpointManager(tmp_path).save(4, bad)
    mesh = Mesh((("model", None, 0, 2),))
    with pytest.raises(ValueError, match="zero padding"):
        CheckpointManager(tmp_path, device="cpu").restore(
            {"arena": torch.zeros(vlocal + 1, spec.dim),
             "acc": torch.zeros(vlocal + 1, 1),
             "w": torch.zeros(full["w"].shape)},
            shardings={"arena": mesh, "acc": mesh, "w": None})


def test_row_shardings_marks_the_arena_leaves():
    mesh = Mesh((("model", None, 0, 2),))
    params = dlrm.init(torch.Generator().manual_seed(0), DLRM_SMOKE, 2,
                       device="cpu")
    opt, _ = dlrm.make_train_step_ragged(DLRM_SMOKE, max_l=4)
    state = (params, opt.init(params))
    marks = row_shardings(state, mesh)
    assert marks[0]["arena"] is mesh and marks[1]["arena"]["acc"] is mesh
    assert marks[1]["arena"]["step"] is None
    assert marks[0]["bottom"][0][0] is None


# ---------------------------------------------------------------------------
# refusals: the mesh, the plan, the steps
# ---------------------------------------------------------------------------

def test_mesh_refusals():
    # any shape over any axes is a mesh once its ranks have joined (the
    # (data, model) mesh runs across gloo ranks in test_torch_mesh2d.py);
    # without a process group only a mesh of one rank is
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((2,), ("model",))
    one = make_mesh((1, 1), ("data", "model"))
    assert one.shape == {"data": 1, "model": 1} and one.group("data") is None
    with pytest.raises(TypeError, match="Mesh"):
        se.mesh_shards(object())
    assert se.mesh_shards(None) == 1
    assert se.mesh_shards(Mesh((("model", None, 1, 4),)), "data") == 1


def test_plan_refusals():
    with pytest.raises(ValueError, match="require_mesh"):
        es.SourceSpec.from_path("sharded")
    with pytest.raises(ValueError, match="require_mesh"):
        es.SourceSpec.from_path("sharded", mesh=make_mesh((1,), ("model",)))
    mesh4 = Mesh((("model", None, 0, 4),))
    plan = es.SourceSpec.from_path("sharded", mesh=mesh4)
    assert plan.path_name() == "sharded" and plan.require_mesh
    # a tiered plan does not row-shard, as the reference's does not
    with pytest.raises(ValueError, match="does not row-shard"):
        es.SourceSpec(tiers=TierPolicy(hot=4, warm=8, cold="int4"),
                      mesh=mesh4)
    # any row axis: 'data' is not an axis of mesh4 (no shards there), and
    # is one of a (data, model) mesh
    with pytest.raises(ValueError, match="require_mesh"):
        es.SourceSpec.from_path("sharded", mesh=mesh4, axis="data")
    mesh2d = Mesh((("data", None, 1, 2), ("model", None, 0, 2)))
    plan = es.SourceSpec.from_path("sharded", mesh=mesh2d, axis="data")
    assert plan.require_mesh and se.mesh_shards(mesh2d, "data") == 2
    with pytest.raises(ValueError, match="must be sharded"):
        dlrm.make_train_step_ragged(DLRM_SMOKE, max_l=4, mesh=mesh4,
                                    sharded=False)
    with pytest.raises(ValueError, match="sparse-optimizer path"):
        dlrm.make_train_step_ragged(DLRM_SMOKE, max_l=4, mesh=mesh4,
                                    sparse=False, sharded=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        dlrm.make_train_step_ragged(DLRM_SMOKE, max_l=4, sharded=True)


# ---------------------------------------------------------------------------
# gradient compression against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (5,), (4, 7), (2, 3, 16)])
def test_int8_quantize_matches_the_reference(shape):
    x = np.asarray(np.random.RandomState(len(shape)).randn(*shape),
                   np.float32)
    if shape == (4, 7):
        x[1] = 0.0                      # a zero row: the 1e-12 floor
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(_t(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(j_comp.dequantize_int8(jq, js)), rtol=1e-6, atol=1e-9)


def test_error_feedback_and_wire_bytes_match_the_reference():
    """Five steps of error-feedback compression on a nested tree, the
    bf16 cast and the wire-byte counts, against the reference; and the
    reference's property, the cumulative sent gradient tracking the true
    one within one step's residual."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(6, 5).astype(np.float32),
            "b": [rng.randn(5).astype(np.float32)]}
    j_err = j_comp.init_error_feedback(jax.tree.map(jnp.asarray, tree))
    err = compression.init_error_feedback(
        {"w": _t(tree["w"]), "b": [_t(tree["b"][0])]})
    total, sent = np.zeros((6, 5)), np.zeros((6, 5))
    for step in range(5):
        g = {"w": rng.randn(6, 5).astype(np.float32),
             "b": [rng.randn(5).astype(np.float32)]}
        j_deq, j_err = j_comp.compress_grads(jax.tree.map(jnp.asarray, g),
                                             j_err)
        deq, err = compression.compress_grads(
            {"w": _t(g["w"]), "b": [_t(g["b"][0])]}, err)
        np.testing.assert_allclose(deq["w"].numpy(), np.asarray(j_deq["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(err["b"][0].numpy(),
                                   np.asarray(j_err["b"][0]), rtol=1e-5,
                                   atol=1e-7)
        total += g["w"]
        sent += deq["w"].numpy()
    np.testing.assert_allclose(sent + err["w"].numpy(), total, atol=1e-5)
    bf = compression.bf16_cast_grads({"w": _t(tree["w"])})
    assert bf["w"].dtype == torch.bfloat16
    params = {"a": torch.zeros(10, 100)}
    for scheme in ("f32", "bf16", "int8"):
        assert compression.wire_bytes(params, scheme) == j_comp.wire_bytes(
            {"a": jnp.zeros((10, 100))}, scheme)


def test_the_sharded_modules_import_no_jax():
    """The modules this slice adds import neither ``jax`` nor ``repro``."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys\n"
            "import repro_torch.distributed.collectives\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.spawn\n"
            "import repro_torch.launch.mesh, repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(src)))
