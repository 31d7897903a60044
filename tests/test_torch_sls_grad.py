"""``sls_grad_table``'s kernel plan and schedule, on the CPU.

The CUDA kernel (``csrc/sls_grad_table.cu``) runs only on the card, where
``chip_smoke.py`` phase 4 holds it bit for bit against the plain version
on the CPU. Here: the rules of ``grad_plan`` at the training path's
shapes; a numpy model of the kernel's schedule (blocks owning granules
of rows, chunks of kept positions sorted by (row, position), tiles whose
runs carry their sums, chunks that carry theirs through the output,
``skip_row`` and the padded tail) that must equal ``ref.sls_grad_table``
bit for bit whatever the plan; the wrapper's guards; and the sparse
step's row gradients against the JAX reference.

Tolerances: the model against the plain version is exact (both add a
row's terms in position order from +0.0, in fp32); row gradients against
the JAX reference rtol = atol = 1e-5 (XLA's segment sum adds in another
order, <= ~10 terms of O(1)).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.data import DLRMSynthetic as JSynthetic
from repro.training import sparse_optim as j_so
from repro_torch.configs.dlrm import DLRM_CONFIGS
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ops, ref
from repro_torch.training import sparse_optim as t_so
from test_torch_training import _SCATTER_CASES, _scatter_case

torch.set_num_threads(1)

# The path's shapes (n positions, n_rows, dim): the dense-gradient
# backward over DLRM(1)'s dense ids at batch 32 and 2048, the sparse
# step's row gradients (n_rows = N), the int4 scales' one-position bags,
# no positions at all, and a one-row table.
_DLRM1_ROWS = 5 * 200_000 + 1
PATH_SHAPES = [(6_400, _DLRM1_ROWS, 32), (409_600, _DLRM1_ROWS, 32),
               (6_400, 6_400, 32), (6_400, _DLRM1_ROWS, 1),
               (0, _DLRM1_ROWS, 32), (5, 1, 32), (1, 1, 1)]


def owner(plan, rows):
    """(block, local row) of each row under the plan's granule map."""
    gran = rows // plan.granule
    local = gran // plan.blocks * plan.granule + rows % plan.granule
    return gran % plan.blocks, local


def global_row(plan, block, local):
    gran = local // plan.granule * plan.blocks + block
    return gran * plan.granule + local % plan.granule


# ---------------------------------------------------------------------------
# the plan's rules
# ---------------------------------------------------------------------------

def test_dlrm1_rows_are_the_path_shape():
    cfg = DLRM_CONFIGS["dlrm1"]
    assert t_dlrm.arena_spec(cfg).total_rows == _DLRM1_ROWS


@pytest.mark.parametrize("n,n_rows,dim", PATH_SHAPES)
def test_every_row_has_exactly_one_owner(n, n_rows, dim):
    """Each row maps to one (block, local row) inside the block's set,
    and back; the blocks' sets cover the table."""
    p = eg.grad_plan(n, n_rows, dim)
    rows = np.arange(n_rows, dtype=np.int64)
    block, local = owner(p, rows)
    assert block.min() >= 0 and block.max() < p.blocks
    assert local.min() >= 0 and local.max() < p.rows_per_block
    np.testing.assert_array_equal(global_row(p, block, local), rows)
    # one row per (block, local row) pair: no two rows share a slot
    slot = block * p.rows_per_block + local
    assert np.unique(slot).size == n_rows
    assert p.blocks * p.rows_per_block >= n_rows


@pytest.mark.parametrize("n,n_rows,dim", PATH_SHAPES)
def test_granules_are_contiguous_and_ascending(n, n_rows, dim):
    """A block's set is whole granules of consecutive rows, in ascending
    order of local row, each at most GRANULE_BYTES of the output."""
    p = eg.grad_plan(n, n_rows, dim)
    assert p.granule & (p.granule - 1) == 0
    assert p.granule * dim * 4 <= max(eg.GRANULE_BYTES, dim * 4)
    assert p.rows_per_block % p.granule == 0
    for b in {0, p.blocks - 1}:
        local = np.arange(p.rows_per_block, dtype=np.int64)
        rows = global_row(p, b, local)
        rows = rows[rows < n_rows]
        assert np.all(np.diff(rows) > 0)
        within = np.diff(rows.reshape(-1, p.granule)
                         if rows.size % p.granule == 0
                         else rows[:rows.size // p.granule * p.granule]
                         .reshape(-1, p.granule), axis=1)
        assert np.all(within == 1)


@pytest.mark.parametrize("n,n_rows,dim", PATH_SHAPES)
def test_plan_fits_the_card_and_the_keys(n, n_rows, dim):
    p = eg.grad_plan(n, n_rows, dim)
    assert p.smem_bytes == eg.smem_bytes(dim, p.chunk, p.tile,
                                         p.rows_per_block)
    assert p.smem_bytes <= 227 * 1024
    assert p.blocks & (p.blocks - 1) == 0 and p.blocks >= 1
    assert p.chunk & (p.chunk - 1) == 0
    assert eg.MIN_CHUNK <= p.chunk <= eg.MAX_CHUNK
    assert 1 <= p.tile <= min(eg.COMPUTE_THREADS, p.chunk)
    # a partition tile's entries for one block always fit a chunk
    assert p.chunk >= min(n, eg.TILE)
    assert p.blocks <= eg.MAX_BLOCKS
    assert p.partition == (n > eg.SCAN_MAX)
    assert p.work_words == (2 * n + 2 * -(-n // eg.TILE) * p.blocks
                            if p.partition else 0)
    assert p.tile * dim <= eg.STAGE_FLOATS
    assert p.rows_per_block <= eg.MAX_ROWS_PER_BLOCK
    # a block's local rows are two digits of the chunk's radix sort
    assert p.rows_per_block <= eg.SORT_DIGITS ** 2


def test_plan_depends_on_the_shapes_only():
    assert list(inspect.signature(eg.grad_plan).parameters) == [
        "n", "n_rows", "dim"]
    for shape in PATH_SHAPES:
        assert eg.grad_plan(*shape) == eg.grad_plan(*shape)


def test_plan_at_the_path_shapes():
    """One block an SM at DLRM(1)'s table, granules of 4 rows (512
    bytes); the partition only past SCAN_MAX positions; a small table
    gets 13 granules a block; the int4 scales' granule is 128 rows."""
    p = eg.grad_plan(6_400, _DLRM1_ROWS, 32)
    assert (p.blocks, p.granule, p.chunk, p.tile) == (128, 4, 4096, 256)
    assert p.rows_per_block == 7_816 and not p.partition
    big = eg.grad_plan(409_600, _DLRM1_ROWS, 32)
    assert big[:5] == p[:5] and big.partition
    assert eg.grad_plan(6_400, 6_400, 32).rows_per_block == 52
    assert eg.grad_plan(6_400, _DLRM1_ROWS, 1).granule == 128
    assert eg.grad_plan(5, 1, 32).blocks == 1


def test_plan_grows_the_grid_for_a_huge_table():
    p = eg.grad_plan(10, 2 ** 31 // 32 - 1, 32)
    assert p.rows_per_block <= eg.MAX_ROWS_PER_BLOCK
    assert p.blocks * p.rows_per_block >= 2 ** 31 // 32 - 1


@pytest.mark.parametrize("args", [(-1, 5, 4), (3, 0, 4), (3, 5, 0)])
def test_plan_refuses_empty_shapes(args):
    with pytest.raises(ValueError, match="grad_plan"):
        eg.grad_plan(*args)


def test_plan_refuses_a_table_past_its_blocks():
    """2^28 rows of D = 1 would need 8,192 blocks of 2^15 rows."""
    with pytest.raises(ValueError, match="blocks"):
        eg.grad_plan(10, 2 ** 28, 1)


def test_plan_refuses_rows_wider_than_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        eg.grad_plan(10, 100, 20_000)


# ---------------------------------------------------------------------------
# a numpy model of the kernel's schedule
# ---------------------------------------------------------------------------

def kernel_model(g, ids, offsets, n_rows, skip_row, plan, tile=eg.TILE):
    """What the two kernels compute, step by step, with the plan's
    blocks, granules, chunks and g tiles and partition tiles of `tile`
    positions (any sizes, not only the card's). Rows nobody writes stay
    NaN."""
    g = np.asarray(g, np.float32)
    d = g.shape[1]
    n, n_bags = len(ids), len(offsets) - 1
    assert plan.chunk >= min(n, tile)
    out = np.full((n_rows, d), np.nan, np.float32)
    n_valid = max(0, min(n, int(offsets[-1]))) if n_bags > 0 else 0
    ids = np.asarray(ids, np.int64)
    # the partition: each valid position's owner, local row and bag
    pos = np.arange(n_valid)
    valid = (ids[:n_valid] >= 0) & (ids[:n_valid] < n_rows)
    if skip_row is not None:
        valid &= ids[:n_valid] != skip_row
    block, local = owner(plan, np.where(valid, ids[:n_valid], 0))
    bag = np.minimum(np.searchsorted(offsets[1:], pos, side="right"),
                     n_bags - 1)
    for q in range(plan.blocks):
        kept = np.nonzero(valid & (block == q))[0]   # position order
        # chunks of whole partition tiles, as many as fit
        per_tile = np.bincount(kept // tile, minlength=-(-n // tile) or 1)
        chunks, first, size = [], 0, 0
        for cnt in per_tile:
            if size + cnt > plan.chunk:
                chunks.append(kept[first:first + size])
                first, size = first + size, 0
            size += cnt
        chunks.append(kept[first:first + size])
        for c, mine in enumerate(chunks):
            if c > 0 and mine.size == 0:
                break
            lr, bg = local[mine], bag[mine]
            if c == 0:
                # the sweep: zeros to every row of the set the chunk
                # leaves alone
                all_local = np.arange(plan.rows_per_block)
                rows = global_row(plan, q, all_local)
                untouched = ~np.isin(all_local, lr) & (rows < n_rows)
                out[rows[untouched]] = 0.0
            order = np.lexsort((np.arange(mine.size), lr))
            lr, bg = lr[order], bg[order]
            # g tiles; a run carries its sum across tiles in `carry`,
            # across chunks through the output
            carry = None
            for t0 in range(0, mine.size, plan.tile):
                t1 = min(mine.size, t0 + plan.tile)
                j = t0
                while j < t1:
                    j1 = j + 1
                    while j1 < t1 and lr[j1] == lr[j]:
                        j1 += 1
                    row = global_row(plan, q, lr[j])
                    if j == t0 and t0 > 0 and lr[t0 - 1] == lr[j]:
                        acc = carry
                    elif c > 0:
                        acc = out[row].copy()
                    else:
                        acc = np.zeros(d, np.float32)
                    for k in range(j, j1):
                        acc = acc + g[bg[k]]
                    if j1 == t1 and t1 < mine.size and lr[t1] == lr[j]:
                        carry = acc
                    else:
                        out[row] = acc
                    j = j1
    return out


def plain(g, ids, offsets, n_rows, skip_row):
    want = ref.sls_grad_table(torch.from_numpy(g), torch.from_numpy(ids),
                              torch.from_numpy(offsets), n_rows).numpy()
    if skip_row is not None:
        want[skip_row] = 0.0
    return want


def plans_for(n, n_rows, dim):
    """(plan, partition tile): the card's plan, and plans with P = 1, 2,
    4, tiny granules, chunks, g tiles and partition tiles, so that runs
    cross g tiles, chunks and granule boundaries."""
    p = eg.grad_plan(n, n_rows, dim)
    out = [(p, eg.TILE)]
    for blocks, granule, chunk, tile in ((1, 1, 4, 3), (2, 2, 8, 2),
                                         (4, 1, 5, 1), (2, 4, 64, 7)):
        out.append((custom(p, n_rows, blocks, granule, chunk, tile), chunk))
    return out


def custom(p, n_rows, blocks, granule, chunk, tile):
    gran = -(-n_rows // granule)
    return p._replace(blocks=blocks, granule=granule, chunk=chunk, tile=tile,
                      rows_per_block=-(-gran // blocks) * granule)


@pytest.mark.parametrize("name", _SCATTER_CASES)
@pytest.mark.parametrize("skip", [False, True])
def test_model_equals_plain_on_the_scatter_cases(name, skip):
    g, idx, off, n_rows = _scatter_case(name)
    skip_row = int(idx[0]) if skip and len(idx) else None
    want = plain(g, idx, off, n_rows, skip_row)
    for p, tile in plans_for(len(idx), n_rows, g.shape[1]):
        got = kernel_model(g, idx, off, n_rows, skip_row, p, tile)
        np.testing.assert_array_equal(got, want, err_msg=str(p))


def _long_run_case(seed, n=300, hot=3, n_rows=40, n_bags=25):
    """A hot row that takes most positions, with a padded tail."""
    rng = np.random.RandomState(seed)
    idx = np.where(rng.rand(n) < 0.8, hot,
                   rng.randint(0, n_rows, n)).astype(np.int32)
    off = np.sort(rng.randint(0, n - 10, n_bags + 1)).astype(np.int32)
    off[0] = 0
    g = rng.randn(n_bags, 6).astype(np.float32)
    return g, idx, off, n_rows


@pytest.mark.parametrize("blocks,granule,chunk,tile", [
    (1, 8, 32, 5), (2, 4, 16, 16), (4, 2, 7, 3), (8, 1, 64, 1)])
def test_model_run_spans_several_chunks(blocks, granule, chunk, tile):
    """The hot run (~240 positions) crosses many chunks and tiles of one
    block and no granule boundary; each crossing carries the sum on."""
    g, idx, off, n_rows = _long_run_case(1)
    p = custom(eg.grad_plan(len(idx), n_rows, 6), n_rows, blocks, granule,
               chunk, tile)
    got = kernel_model(g, idx, off, n_rows, None, p, tile=chunk)
    np.testing.assert_array_equal(got, plain(g, idx, off, n_rows, None))


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_model_skip_row_inside_a_long_run(blocks):
    g, idx, off, n_rows = _long_run_case(2)
    p = custom(eg.grad_plan(len(idx), n_rows, 6), n_rows, blocks, 2, 16, 4)
    got = kernel_model(g, idx, off, n_rows, 3, p, tile=16)
    want = plain(g, idx, off, n_rows, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()


@pytest.mark.parametrize("blocks", [2, 4, 16])
def test_model_block_with_no_touched_row(blocks):
    """Every id lies in granule 0, so every other block only writes
    zeros; runs on both sides of granule boundaries 1|2 and 3|4."""
    rng = np.random.RandomState(blocks)
    idx = rng.choice([0, 1, 2, 3, 4], 50).astype(np.int32)
    off = np.arange(0, 51, 5, dtype=np.int32)
    g = rng.randn(10, 4).astype(np.float32)
    p = custom(eg.grad_plan(50, 64, 4), 64, blocks, 2, 8, 3)
    got = kernel_model(g, idx, off, 64, None, p, tile=8)
    np.testing.assert_array_equal(got, plain(g, idx, off, 64, None))
    assert not got[5:].any()


def test_model_n_rows_smaller_than_a_granule():
    g = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    idx = np.array([2, 0, 2, 2, 1, 2], np.int32)
    off = np.array([0, 2, 4, 6], np.int32)
    p = eg.grad_plan(6, 3, 32)
    assert p.granule > 3 and p.blocks == 1
    got = kernel_model(g, idx, off, 3, 1, p)
    np.testing.assert_array_equal(got, plain(g, idx, off, 3, 1))


def test_model_at_the_sparse_step_shape():
    """The sparse step's row gradients (n_rows = N over unique-row ids)
    through the card's plan: 128 blocks of 52 rows."""
    rb = JSynthetic(J_CFG, seed=3).ragged_batch(
        16, max_l=2 * CFG.lookups_per_table,
        pad_to=16 * CFG.n_tables * 2 * CFG.lookups_per_table)
    spec = t_dlrm.arena_spec(CFG)
    idx, off = torch.from_numpy(rb["indices"]), torch.from_numpy(
        rb["offsets"])
    from repro_torch.core import sparse_engine as se
    flat = se.flatten_ragged_indices(spec, idx, off)
    _, inv = t_so.unique_padded(flat, spec.null_row)
    inv = inv.to(torch.int32).numpy()
    g = np.random.RandomState(4).randn(len(rb["offsets"]) - 1,
                                       CFG.emb_dim).astype(np.float32)
    n = inv.size
    got = kernel_model(g, inv, rb["offsets"], n, None,
                       eg.grad_plan(n, n, CFG.emb_dim))
    np.testing.assert_array_equal(got, plain(g, inv, rb["offsets"], n,
                                             None))


# ---------------------------------------------------------------------------
# the wrapper's guards
# ---------------------------------------------------------------------------

def _args(**kw):
    a = dict(g=torch.ones(2, 4), indices=torch.zeros(3, dtype=torch.int32),
             offsets=torch.tensor([0, 1, 3], dtype=torch.int32), n_rows=5)
    a.update(kw)
    return a


@pytest.mark.parametrize("ids,msg", [
    (torch.zeros(3, dtype=torch.int64), "int32"),
    (torch.zeros(3, dtype=torch.float32), "int32"),
    (torch.zeros(3, 1, dtype=torch.int32), "1 dims"),
    (torch.zeros(6, dtype=torch.int32)[::2], "contiguous"),
])
def test_wrapper_refuses_ids_the_kernel_does_not_take(ids, msg):
    """int32 ids only (int64 would double the id bytes read), 1-D and
    contiguous; checked before anything is allocated or launched."""
    before = eg.launches
    with pytest.raises(ValueError, match=msg):
        eg.sls_grad_table(**_args(indices=ids))
    assert eg.launches == before


def test_wrapper_refuses_cpu_tensors():
    """It launches the kernel or raises; the CPU's plain version is
    ``ops.sls_grad_table``'s, never the wrapper's."""
    before = eg.launches
    with pytest.raises(ValueError, match="CUDA device"):
        eg.sls_grad_table(**_args())
    assert eg.launches == before


def test_ops_route_cpu_tensors_to_the_plain_version():
    a = _args()
    got = ops.sls_grad_table(a["g"], a["indices"], a["offsets"], n_rows=5,
                             skip_row=0)
    assert got.shape == (5, 4) and not got.any()


# ---------------------------------------------------------------------------
# the sparse step's row gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6])
def test_ragged_row_grads_match_jax(seed):
    max_l = 2 * CFG.lookups_per_table
    rb = JSynthetic(J_CFG, seed=seed).ragged_batch(
        8, max_l=max_l, pad_to=8 * CFG.n_tables * max_l)
    d_bags = np.random.RandomState(seed).randn(
        len(rb["offsets"]) - 1, CFG.emb_dim).astype(np.float32)
    spec_t = t_dlrm.arena_spec(CFG)
    from repro.core import dlrm as j_dlrm
    rows, grads = t_so.source_row_grads(
        spec_t, torch.from_numpy(d_bags), torch.from_numpy(rb["indices"]),
        torch.from_numpy(rb["offsets"]))
    jrows, jgrads = j_so.source_row_grads(
        j_dlrm.arena_spec(J_CFG), jnp.asarray(d_bags),
        jnp.asarray(rb["indices"]), jnp.asarray(rb["offsets"]))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-5,
                               atol=1e-5)
