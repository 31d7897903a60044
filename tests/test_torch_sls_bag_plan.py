"""What ``embedding_bag``'s and ``sparse_lengths_sum``'s launch plans, walks
and wrappers add to ``fused_segment_sum``'s, on the CPU.

The CUDA kernels (``csrc/embedding_bag.cu``, ``csrc/sparse_lengths_sum.cu``)
run only on the card, where ``chip_smoke.py`` phase 2 holds them bit for
bit against ``fused_segment_sum`` and their plain versions. For bags of
more than one row ``bag_plan`` is ``segment_plan`` itself, and
``sls_plan`` is ``segment_plan`` at a bound capped at ``SLS_DEPTH``:
``tests/test_torch_segment_plan.py`` holds that plan's ownership and
order at these paths' shapes. Here:

* the sources are built for every depth the plans pick, and no other;
* ``gather_rows``' plan (L = 1): a depth of one on blocks of up to
  ``GATHER_WARPS_PER_BLOCK`` warps, every row one owner, within the
  kernel's launch bound;
* ``sparse_lengths_sum``'s depth at the host tier's loose bound
  (``max_l`` = the stream's length);
* a numpy model of each kernel's walk under its plan: a chunk's ids
  loaded only inside the bag, every row of the chunk read (rows past the
  bag's end on row 0) before the first add, the reads past the end never
  added, the stream's padded tail never loaded as an id. On a table whose
  row 0 is 1e6 and is never a bag's id, each model must equal an
  in-order float32 sum bit for bit and the JAX function
  (``repro.kernels.embedding_gather``, the Pallas kernel in interpret
  mode) within the tolerance of ``tests/test_torch_fixed.py``;
* the wrappers' refusal of an empty table (reads past a bag's end fall
  on row 0), reached by a fixture that lifts ``_build.require``'s CUDA
  check, with no launch counted.

Tolerances: none against the in-order sums (float32 adds in order of
position from +0.0 on both sides); against the JAX functions atol 1e-5,
as in ``tests/test_torch_fixed.py`` (bags of O(1) values).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_gather as j_eg
from repro_torch.kernels import _build
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import fused_dispatch as fd

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
SMS = [H100_SXM_SMS, H100_PCIE_SMS]
HOST_TIER_DEPTH = 40              # the depth chosen on the card (PERF.md)
BIG_ROW_ZERO = 1e6
ATOL_JAX = 1e-5


def _built_depths(source: str, macro: str) -> set:
    text = (_build.CSRC / source).read_text()
    return {int(m) for m in re.findall(rf"{macro}\((\d+)\)", text)
            if f"#define {macro}({m})" not in text}


def _max_threads(source: str) -> int:
    text = (_build.CSRC / source).read_text()
    return int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))


def chunks(depth: int, length: int) -> list:
    """A bag's walk: chunks of ``depth`` slots from 0 while inside the
    bag, each a list of (slot, position or None past the end)."""
    return [[(r, j0 + r if j0 + r < length else None) for r in range(depth)]
            for j0 in range(0, length, depth)]


def sls_length(off: np.ndarray, b: int, n: int, max_l: int) -> int:
    """The kernel's law for bag b's length."""
    end = min(int(off[b + 1]), int(off[-1]), n)
    return max(0, min(end - int(off[b]), max_l))


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def test_sources_are_built_for_every_depth_the_plans_pick():
    """embedding_bag: 1 for single rows and segment_plan's 8 to 64;
    sparse_lengths_sum: 8 to SLS_DEPTH, the deepest its plan sizes."""
    assert _built_depths("embedding_bag.cu", "EB_DEPTH") == {
        1, *range(8, 65, 8)}
    assert _built_depths("sparse_lengths_sum.cu", "SLS_DEPTH") == set(
        range(8, eg.SLS_DEPTH + 1, 8))
    for sms in SMS:
        picked = {eg.bag_plan(160, n_l, 32, sms).depth
                  for n_l in range(1, 300)}
        assert picked == _built_depths("embedding_bag.cu", "EB_DEPTH")
        picked = {eg.sls_plan(160, max_l, 32, sms).depth
                  for max_l in (*range(1, 300), 2 ** 31 - 1)}
        assert picked == _built_depths("sparse_lengths_sum.cu", "SLS_DEPTH")
    assert 32 * fd.MAX_WARPS_PER_BLOCK <= _max_threads(
        "sparse_lengths_sum.cu")


def test_serving_shapes_take_the_gathers_plan():
    """DLRM(1)'s 160 fixed bags of 20 on 80 blocks of two warps, one
    chunk of 24 (4 reads a bag on row 0); DLRM(3)'s 80 rows in two chunks
    of 40; the flat route's bound of 40 in one chunk of 40; and at batch
    2048 blocks of four warps."""
    assert eg.bag_plan(160, 20, 32, H100_SXM_SMS) == fd.SegmentPlan(80, 2, 24)
    assert eg.bag_plan(160, 80, 32, H100_SXM_SMS).depth == 40
    assert eg.sls_plan(160, 40, 32, H100_SXM_SMS) == fd.SegmentPlan(80, 2, 40)
    assert eg.bag_plan(10_240, 20, 32, H100_SXM_SMS) == fd.SegmentPlan(
        2_560, 4, 24)
    assert eg.sls_plan(264, 40, 32, H100_PCIE_SMS).blocks == 88


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n_bags", [160, 10_240, 1])
def test_single_row_bags_take_a_depth_of_their_own(n_bags, sms):
    """gather_rows (L = 1) reads one row a bag, not a chunk of eight, on
    blocks of up to GATHER_WARPS_PER_BLOCK warps, within the kernel's
    launch bound; every row has exactly one owning warp and no block is
    all idle."""
    p = eg.bag_plan(n_bags, 1, 32, sms)
    assert p.depth == 1
    assert p.warps_per_block == min(eg.GATHER_WARPS_PER_BLOCK,
                                    -(-n_bags // sms))
    assert 32 * p.warps_per_block <= _max_threads("embedding_bag.cu")
    assert p.blocks * p.warps_per_block >= n_bags
    assert (p.blocks - 1) * p.warps_per_block < n_bags
    if n_bags <= fd.MAX_WARPS_PER_BLOCK * sms:
        assert p._replace(depth=8) == fd.segment_plan(n_bags, 1, 32, sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n_bags", [160, 10_240])
def test_host_tier_bound_takes_the_chosen_depth(n_bags, sms):
    """The host tier passes the stream's length as max_l; the wrapper
    does not read the offsets, so the depth comes from min(max_l,
    SLS_DEPTH): the depth chosen by timing the host tier's flat form at
    40 and 64 on the card (PERF.md, section 6). Longer bags take more
    chunks; a bound under SLS_DEPTH keeps segment_plan's chunk."""
    assert eg.SLS_DEPTH == HOST_TIER_DEPTH
    p = eg.sls_plan(n_bags, n_bags * 40, 32, sms)
    assert p.depth == HOST_TIER_DEPTH
    assert p == eg.sls_plan(n_bags, 2 ** 31 - 1, 32, sms)
    assert p == fd.segment_plan(n_bags, 40, 32, sms)
    for max_l in (1, 9, 20, 39):
        assert (eg.sls_plan(n_bags, max_l, 32, sms)
                == fd.segment_plan(n_bags, max_l, 32, sms))


# ---------------------------------------------------------------------------
# numpy models of the walks
# ---------------------------------------------------------------------------

def bag_walk(table: np.ndarray, ids: np.ndarray, depth: int):
    """embedding_bag's walk: per chunk, ids loaded at l < n_l (id 0
    past the end), every row read before the first add, the first n
    added. Returns the sums and how many reads fell past the ends."""
    b, n_l = ids.shape
    acc = np.zeros((b, table.shape[1]), np.float32)
    past = 0
    for chunk in chunks(depth, n_l):
        rows = np.stack([ids[:, pos] if pos is not None
                         else np.zeros(b, ids.dtype) for _, pos in chunk], 1)
        v = table[rows]                              # every read first
        for r, pos in chunk:
            if pos is not None:
                acc = acc + v[:, r]
            else:
                past += b
    return acc, past


def sls_walk(table: np.ndarray, ids: np.ndarray, off: np.ndarray,
             max_l: int, depth: int):
    """sparse_lengths_sum's walk over the stream: a bag's length by the
    kernel's law, ids loaded only at positions inside it (every position
    loaded is recorded), rows past its end read on row 0, never added."""
    n = ids.shape[0]
    out = np.zeros((off.shape[0] - 1, table.shape[1]), np.float32)
    loaded = set()
    for b in range(out.shape[0]):
        start = int(off[b])
        acc = np.zeros(table.shape[1], np.float32)
        for chunk in chunks(depth, sls_length(off, b, n, max_l)):
            rows = []
            for _, pos in chunk:
                if pos is None:
                    rows.append(0)
                else:
                    loaded.add(start + pos)
                    rows.append(ids[start + pos])
            v = table[np.array(rows)]                # every read first
            for r, pos in chunk:
                if pos is not None:
                    acc = acc + v[r]
        out[b] = acc
    return out, loaded


def sequential_bags(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    acc = np.zeros((ids.shape[0], table.shape[1]), np.float32)
    for j in range(ids.shape[1]):
        acc = acc + table[ids[:, j]]
    return acc


def sequential_stream(table, ids, off, max_l):
    n = ids.shape[0]
    out = np.zeros((off.shape[0] - 1, table.shape[1]), np.float32)
    for b in range(out.shape[0]):
        for p in range(sls_length(off, b, n, max_l)):
            out[b] = out[b] + table[ids[int(off[b]) + p]]
    return out


def _table(rng, v: int, d: int) -> np.ndarray:
    """Rows of O(1) with row 0 at 1e6: never a bag's id below, so a read
    past a bag's end that was added would show."""
    table = rng.randn(v, d).astype(np.float32)
    table[0] = BIG_ROW_ZERO
    return table


def _stream(rng, v: int, b: int, max_l: int, tail: int):
    """Poisson-length bags (mean max_l / 2, some empty, some longer than
    max_l) of ids in 1 .. v-1, and a padded tail of out-of-range ids."""
    lens = np.minimum(rng.poisson(max_l / 2, b), 2 * max_l)
    lens[::5] = 0
    lens[1] = max_l + 3
    off = np.zeros(b + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    ids = rng.randint(1, v, int(off[-1])).astype(np.int32)
    pad = np.array([-1, v + 7] * tail, np.int32)[:tail]
    return np.concatenate([ids, pad]), off


@pytest.mark.parametrize("n_bags,max_l,dim,tail", [
    (12, 40, 32, 9), (6, 5, 48, 4), (9, 3, 16, 2), (4, 97, 8, 7),
    (3, 200, 6, 1), (8, 1, 32, 3)])
@pytest.mark.parametrize("loose", [False, True])
def test_sls_walk_loads_no_id_outside_the_bags(n_bags, max_l, dim, tail,
                                               loose):
    """The padded tail holds -1 and V + 7: never loaded. A bag longer
    than max_l sums its first max_l rows. With ``loose``, max_l is the
    stream's length, as the host tier passes it (and the bags are cut at
    max_l beforehand, as the serving path's are)."""
    rng = np.random.RandomState(n_bags * 37 + max_l + dim)
    table = _table(rng, 97, dim)
    ids, off = _stream(rng, 97, n_bags, max_l, tail)
    bound = ids.shape[0] if loose else max_l
    p = eg.sls_plan(n_bags, bound, dim, H100_SXM_SMS)
    got, loaded = sls_walk(table, ids, off, bound, p.depth)
    np.testing.assert_array_equal(got, sequential_stream(table, ids, off,
                                                         bound))
    assert all(0 <= q < int(off[-1]) for q in loaded)
    want_loaded = {int(off[b]) + j for b in range(n_bags)
                   for j in range(sls_length(off, b, ids.shape[0], bound))}
    assert loaded == want_loaded
    assert np.abs(got).max() < BIG_ROW_ZERO / 10


@pytest.mark.parametrize("n_bags,n_l,dim", [(6, 20, 16), (5, 1, 8),
                                            (3, 12, 48), (2, 65, 8)])
def test_bag_walk_matches_the_jax_kernel(n_bags, n_l, dim):
    """The walk reads every chunk's slots past the bag's end on row 0
    (1e6) and adds none of them: bit for bit the in-order sum, and the
    Pallas kernel's within its tolerance (65 rows take two chunks of
    40)."""
    rng = np.random.RandomState(n_bags + 3 * n_l + dim)
    table = _table(rng, 50, dim)
    ids = rng.randint(1, 50, (n_bags, n_l)).astype(np.int32)
    depth = eg.bag_plan(n_bags, n_l, dim, H100_SXM_SMS).depth
    got, past = bag_walk(table, ids, depth)
    np.testing.assert_array_equal(got, sequential_bags(table, ids))
    assert past == n_bags * (-(-n_l // depth) * depth - n_l)
    want = j_eg.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_JAX)
    if n_l == 1:
        want = j_eg.gather_rows(jnp.asarray(table), jnp.asarray(ids[:, 0]),
                                interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=ATOL_JAX)


@pytest.mark.parametrize("n_bags,max_l,dim", [(6, 8, 16), (5, 3, 32),
                                              (4, 12, 8)])
def test_sls_walk_matches_the_jax_kernel(n_bags, max_l, dim):
    """Over bags longer than max_l and a padded tail of out-of-range ids
    too: the Pallas kernel masks the grid steps past max_l, as the walk
    stops there, and never adds a position past a bag's end."""
    rng = np.random.RandomState(n_bags * 5 + max_l + dim)
    table = _table(rng, 40, dim)
    ids, off = _stream(rng, 40, n_bags, max_l, 3)
    got, _ = sls_walk(table, ids, off, max_l,
                      eg.sls_plan(n_bags, max_l, dim, H100_SXM_SMS).depth)
    want = j_eg.sparse_lengths_sum(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(off), max_l=max_l,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_JAX)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

@pytest.fixture
def past_the_device_check(monkeypatch):
    """``_build.require`` without its CUDA check (the last before the
    size), so that the guards behind it are reached on the CPU."""
    require = _build.require

    def no_device(t, name, **kw):
        try:
            require(t, name, **kw)
        except ValueError as e:
            if "CUDA device" not in str(e):
                raise
    monkeypatch.setattr(_build, "require", no_device)


@pytest.mark.parametrize("call", ["embedding_bag", "gather_rows",
                                  "sparse_lengths_sum"])
def test_wrappers_refuse_an_empty_table(past_the_device_check, call):
    """Reads past a bag's end fall on row 0, so a table without rows is
    refused before any launch."""
    table = torch.zeros(0, 4)
    before = eg.bag_launches, eg.sls_launches
    with pytest.raises(ValueError, match="empty table"):
        if call == "embedding_bag":
            eg.embedding_bag(table, torch.zeros(2, 3, dtype=torch.int32))
        elif call == "gather_rows":
            eg.gather_rows(table, torch.zeros(2, dtype=torch.int32))
        else:
            eg.sparse_lengths_sum(table, torch.zeros(6, dtype=torch.int32),
                                  torch.tensor([0, 3, 6], dtype=torch.int32),
                                  max_l=3)
    assert (eg.bag_launches, eg.sls_launches) == before
