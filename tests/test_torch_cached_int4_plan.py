"""The cached and int4 gathers' launch plans, walks and wrappers, and the
cached plan's stage op, on the CPU.

The CUDA kernels (``csrc/fused_cached_segment_sum.cu``,
``csrc/fused_int4_segment_sum.cu``) run only on the card, where
``chip_smoke.py`` phases 2 and 9 hold them bit for bit against an
in-order loop and ``fused_segment_sum``. Here:

* the plan: both kernels run ``segment_plan``, whose ownership rules
  ``test_torch_segment_plan.py`` holds at these kernels' shapes too;
  here, that the sources are built for the depths it picks and that its
  blocks follow the card's SM count;
* a numpy model of each kernel's walk under the plan: chunks of the
  plan's depth, every read of a chunk made before its first add, the
  cached kernel's per-position hit test in both entries (reads past a
  bag's end on slot K and arena row 0, or in the stage form on
  ``slot_of[0]`` and the row it names, never added; a stale cache served
  as the reference's two-term sum), the int4 kernel's rounded product
  code * scale before each rounded add. Each model must equal a
  sequential float32 sum bit for bit;
* ``ops.fused_cached_segment_stage`` against the JAX reference's
  ``CachedSource.reduce_dense`` with ``fused_cached_segment_sum`` run in
  interpret mode, on the same numpy inputs; its gradients against the
  two-matrix op's; ``CachedSource`` routing its fp branch to it;
* the wrappers' guards: empty tables, int64 ids, mixed devices.

Tolerances: none for the models (float32 adds in the same order from
+0.0), the gradients (the same scatter over the same split) and the
port's stage against its own two-matrix path; against the JAX reference
1e-5 (bags of <= 40 rows of O(1) values, summed in another order).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.kernels import ops as j_ops
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import fused_dispatch as fd

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
BUILT_DEPTHS = set(range(8, 65, 8))


def _built_depths(source: str, macro: str) -> set:
    text = (_build.CSRC / source).read_text()
    return {int(m) for m in re.findall(rf"{macro}\((\d+)\)", text)
            if f"#define {macro}({m})" not in text}


def sequential(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    acc = np.zeros((ids.shape[0], table.shape[1]), np.float32)
    for j in range(ids.shape[1]):
        acc = acc + table[ids[:, j]]
    return acc


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def test_kernels_are_built_for_the_plans_depths():
    """The depths the sources instantiate are the ones the plans pick."""
    assert _built_depths("fused_cached_segment_sum.cu",
                         "FCSS_DEPTH") == BUILT_DEPTHS
    assert _built_depths("fused_int4_segment_sum.cu",
                         "FISS_DEPTH") == BUILT_DEPTHS


def test_blocks_follow_the_cards_sm_count():
    """160 bags (batch 32) on 80 blocks of two warps; 264 bags fill 132
    SMs with two warps a block and 114 SMs with three."""
    assert fd.segment_plan(160, 40, 32, H100_SXM_SMS).blocks == 80
    assert fd.segment_plan(264, 40, 32, H100_SXM_SMS).blocks == 132
    assert fd.segment_plan(264, 40, 32, H100_PCIE_SMS).blocks == 88


# ---------------------------------------------------------------------------
# numpy models of the walks
# ---------------------------------------------------------------------------

def chunk_reads(ids: np.ndarray, depth: int, j0: int, fill: int):
    """A chunk's (B, depth) positions as the lanes load them: the bag's
    ids at j < n, ``fill`` past the bag's end (unpredicated reads), and
    the number n of positions to add."""
    n = min(depth, ids.shape[1] - j0)
    cols = j0 + np.arange(depth)
    got = np.where(cols[None, :] < ids.shape[1],
                   ids[:, np.minimum(cols, ids.shape[1] - 1)], fill)
    return got, n


def cached_walk(hot, arena, first, second, depth, stage):
    """The cached kernel's walk. (a) first = slots, second = cold ids;
    (b, stage) first = dense ids, second = slot_of. Returns the sums and
    the rows read past the bags' ends, as (table, row) pairs."""
    k = hot.shape[0] - 1
    b, max_l = first.shape
    acc = np.zeros((b, arena.shape[1]), np.float32)
    past = set()
    for j0 in range(0, max_l, depth):
        if stage:
            rows, n = chunk_reads(first, depth, j0, 0)
            slots = second[rows]                     # slot_of[id]
        else:
            slots, n = chunk_reads(first, depth, j0, k)
            rows, _ = chunk_reads(second, depth, j0, 0)
        hit = slots < k                              # warp-uniform test
        v = np.where(hit[..., None], hot[np.where(hit, slots, 0)],
                     arena[rows])                    # every read first
        for r in range(depth):
            if r < n:
                acc = acc + v[:, r]
            else:
                past |= {("hot", s) if h else ("arena", c) for s, c, h in
                         zip(slots[:, r], rows[:, r], hit[:, r])}
    return acc, past


def _coherent_case(seed, v, b, max_l, k, d, hot_zero=False):
    """A (v, d) arena with its zero null row v - 1, poisson-length bags
    padded with the null row, and a cache of the k most frequent rows
    (with ``hot_zero``, row 0 among them)."""
    rng = np.random.RandomState(seed)
    null = v - 1
    arena = rng.randn(v, d).astype(np.float32)
    arena[null] = 0.0
    ids = rng.zipf(1.3, (b, max_l)) % null
    lens = rng.randint(0, max_l + 1, b)
    ids[np.arange(max_l)[None, :] >= lens[:, None]] = null
    ids = ids.astype(np.int32)
    counts = np.bincount(ids.ravel(), minlength=v)
    if hot_zero:
        counts[0] = counts.max() + 1
    cache = se.build_hot_cache(torch.from_numpy(arena),
                               se.ArenaSpec(1, null, d), counts, k)
    return arena, ids, cache, null


@pytest.mark.parametrize("hot_zero", [False, True])
@pytest.mark.parametrize("stage", [False, True])
def test_cached_walk_reads_past_the_end_on_row_zero(stage, hot_zero):
    """Bags of 70 rows in the plan's two chunks of 40: the ten reads past
    the end fall on slot K and arena row 0 in the TPU kernel's form, and
    on ``slot_of[0]`` in the stage form, so on a hot copy when row 0 is
    hot; none is added, and on a coherent cache either entry equals a
    sequential sum over the arena bit for bit."""
    arena, ids, cache, null = _coherent_case(5, 300, 23, 70, 20, 6,
                                             hot_zero=hot_zero)
    depth = fd.segment_plan(23, 70, 6, H100_SXM_SMS).depth
    assert depth == 40
    hot, slot_of = cache.hot_rows.numpy(), cache.slot_of.numpy()
    k = cache.k
    assert (slot_of[0] < k) == hot_zero
    slots = slot_of[ids]
    cold = np.where(slots < k, null, ids).astype(np.int32)
    first, second = (ids, slot_of) if stage else (slots, cold)
    got, past = cached_walk(hot, arena, first, second, depth, stage)
    np.testing.assert_array_equal(got, sequential(arena, ids))
    assert past == {("hot", slot_of[0]) if stage and hot_zero
                    else ("arena", 0)}


@pytest.mark.parametrize("stage", [False, True])
def test_cached_walk_serves_a_stale_cache_as_the_two_term_sum(stage):
    """Hot copies that drifted from the arena: the walk adds the hot copy
    for a hit and the arena row for a miss, the reference's two-term sum
    per position (the other term is a zero row), in order of j."""
    arena, ids, cache, null = _coherent_case(3, 200, 17, 45, 30, 8)
    hot = cache.hot_rows.numpy() + 0.5
    hot[-1] = 0.0
    slot_of = cache.slot_of.numpy()
    slots = slot_of[ids]
    cold = np.where(slots < cache.k, null, ids).astype(np.int32)
    got, _ = cached_walk(hot, arena, *((ids, slot_of) if stage
                                       else (slots, cold)), 24, stage)
    terms = hot[slots] + arena[cold]
    want = np.zeros_like(got)
    for j in range(ids.shape[1]):
        want = want + terms[:, j]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, sequential(arena, ids))


def int4_codes(packed: np.ndarray, rows: np.ndarray,
               dim: int) -> np.ndarray:
    """(..., dim) unbiased codes of ``rows`` as the kernel extracts them:
    lane d reads byte d >> 1 and its nibble 4 (d & 1)."""
    d = np.arange(dim)
    raw = (packed[rows][..., d >> 1] >> (4 * (d & 1))) & 0xF
    return raw.astype(np.int32) - 8


def int4_walk(packed, scales, ids, dim, depth):
    """The int4 kernel's walk: a chunk's ids and scales loaded by the
    lanes, every row's code read, then per position the rounded product
    float(code) * scale and a rounded add, in order of j; reads past the
    bag's end on row 0, never added."""
    acc = np.zeros((ids.shape[0], dim), np.float32)
    for j0 in range(0, ids.shape[1], depth):
        rows, n = chunk_reads(ids, depth, j0, 0)
        s = scales[rows, 0]                          # (B, depth) f32
        codes = int4_codes(packed, rows, dim).astype(np.float32)
        for r in range(n):
            acc = acc + codes[:, r] * s[:, r, None]  # f32 * f32, rounded
    return acc


@pytest.mark.parametrize("dim", [7, 16, 31, 32, 48])
@pytest.mark.parametrize("max_l", [1, 40, 70, 130])
def test_int4_walk_equals_the_sum_over_the_unpacked_table(dim, max_l):
    """At every depth the kernel is built for, the walk equals a sequential float32 sum over
    ``int4_unpack`` bit for bit: the same rounded products, added in the
    same order."""
    rng = np.random.RandomState(dim * 1000 + max_l)
    table = (rng.randn(90, dim) * 0.05).astype(np.float32)
    table[89] = 0.0                                  # the null row
    packed, scales = ref.int4_pack(torch.from_numpy(table))
    unpacked = ref.int4_unpack(packed, scales, dim).numpy()
    packed, scales = packed.numpy(), scales.numpy()
    ids = rng.randint(0, 90, (11, max_l)).astype(np.int32)
    ids[0] = 89
    want = sequential(unpacked, ids)
    for depth in sorted(BUILT_DEPTHS):
        np.testing.assert_array_equal(
            int4_walk(packed, scales, ids, dim, depth), want)
    assert not want[0].any()


def test_order_and_rounding_are_visible_in_the_bits():
    """The checks above can fail: a fused multiply-add in place of the
    rounded product, or the reverse order, changes the bits."""
    rng = np.random.RandomState(0)
    table = (rng.randn(97, 32) * 0.05).astype(np.float32)
    packed, scales = ref.int4_pack(torch.from_numpy(table))
    unpacked = ref.int4_unpack(packed, scales, 32).numpy()
    ids = rng.randint(0, 97, (7, 200)).astype(np.int32)
    want = sequential(unpacked, ids)
    assert not np.array_equal(sequential(unpacked, ids[:, ::-1]), want)
    codes = int4_codes(packed.numpy(), ids, 32)
    fused = np.zeros((7, 32), np.float64)
    for j in range(200):
        fused = (fused + codes[:, j] * scales.numpy()[ids[:, j]].astype(
            np.float64)).astype(np.float32)
    assert not np.array_equal(fused, want)


# ---------------------------------------------------------------------------
# the stage op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,k,d,b,max_l", [(90, 12, 16, 6, 5),
                                           (300, 33, 32, 9, 40),
                                           (64, 1, 8, 3, 7),
                                           (120, 9, 8, 4, 0)])
@pytest.mark.parametrize("coherent", [False, True])
def test_stage_op_matches_the_jax_reference(v, k, d, b, max_l, coherent):
    """The stage op and the port's ``CachedSource.reduce_dense`` against
    the reference's ``CachedSource.reduce_dense``, its
    ``fused_cached_segment_sum`` in interpret mode; and equal bit for bit
    to the port's two-matrix op over the split."""
    arena, ids, cache, null = _coherent_case(v + k + max_l, v, b, max_l, k,
                                             d)
    ta, tids = torch.from_numpy(arena), torch.from_numpy(ids)
    got = ops.fused_cached_segment_stage(cache.hot_rows, cache.slot_of, ta,
                                         tids, null_row=null)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    source = es.CachedSource(cache, es.FpArena(ta), coherent=coherent)
    spec = se.ArenaSpec(1, null, d)
    assert torch.equal(source.reduce_dense(spec, tids), got)
    slots, cold = ref.cached_split(cache.slot_of, tids, cache.k, null)
    assert torch.equal(ops.fused_cached_segment_sum(
        cache.hot_rows, ta, slots, cold, null_row=null), got)
    j_cache = j_se.build_hot_cache(
        jnp.asarray(arena), j_se.ArenaSpec(1, null, d),
        np.bincount(ids.ravel(), minlength=v), k)
    np.testing.assert_array_equal(np.asarray(j_cache.slot_of),
                                  cache.slot_of.numpy())
    j_source = j_es.CachedSource(j_cache, j_es.FpArena(jnp.asarray(arena)),
                                 coherent=coherent)
    j_ops.set_impl("interpret")
    try:
        want = np.asarray(j_source.reduce_dense(j_se.ArenaSpec(1, null, d),
                                                jnp.asarray(ids)))
    finally:
        j_ops.set_impl("auto")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_stage_op_gradients_equal_the_two_matrix_ops(stale, needs):
    """The stage op's backward recomputes the split from the saved slot
    map and ids: both tables' gradients equal the two-matrix op's bit
    for bit, the miss slot's and the null row's pinned to zero."""
    arena, ids, cache, null = _coherent_case(11, 150, 8, 12, 10, 16)
    gen = torch.Generator().manual_seed(5)
    hot = cache.hot_rows.clone()
    if stale:
        hot[:-1] += torch.randn(hot[:-1].shape, generator=gen)
    g = torch.randn((8, 16), generator=gen)
    tids = torch.from_numpy(ids)
    slots, cold = ref.cached_split(cache.slot_of, tids, cache.k, null)
    grads = []
    for stage in (True, False):
        th = hot.clone().requires_grad_(needs[0])
        ta = torch.from_numpy(arena).requires_grad_(needs[1])
        out = (ops.fused_cached_segment_stage(th, cache.slot_of, ta, tids,
                                              null_row=null) if stage else
               ops.fused_cached_segment_sum(th, ta, slots, cold,
                                            null_row=null))
        (out * g).sum().backward()
        grads.append((out.detach(), th.grad, ta.grad))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    _, d_hot, d_arena = grads[0]
    if needs[0]:
        assert not d_hot[cache.k].any() and d_hot[:cache.k].abs().max() > 0
    if needs[1]:
        assert not d_arena[null].any() and d_arena.abs().max() > 0


def test_cached_source_routes_the_fp_branch_to_the_stage_op(monkeypatch):
    """Over an fp arena ``reduce_dense`` hands the slot map and the dense
    ids to the stage op and makes no split itself; over an int8 arena it
    keeps the split and the torch ops."""
    arena, ids, cache, null = _coherent_case(2, 80, 5, 6, 7, 8)
    ta, tids = torch.from_numpy(arena), torch.from_numpy(ids)
    spec = se.ArenaSpec(1, null, 8)
    seen = []
    real = ops.fused_cached_segment_stage

    def stage(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(ops, "fused_cached_segment_stage", stage)
    got = es.CachedSource(cache, es.FpArena(ta)).reduce_dense(spec, tids)
    (hot, slot_of, a, dense), kw = seen[0]
    assert hot is cache.hot_rows and slot_of is cache.slot_of
    assert a is ta and dense is tids and kw == {"null_row": null}
    assert torch.equal(got, ops.fused_segment_sum(ta, tids))
    es.CachedSource(cache, es.QuantizedArena.from_arena(ta)).reduce_dense(
        spec, tids)
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the wrappers' guards: checked before any build
# ---------------------------------------------------------------------------

def _counts():
    return (fd.launches, fd.cached_launches, fd.cached_stage_launches,
            fd.int4_launches)


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


def _stage_args(**over):
    args = {"hot_rows": torch.zeros(3, 4),
            "slot_of": torch.full((5,), 2, dtype=torch.int32),
            "arena": torch.zeros(5, 4),
            "dense_ids": torch.zeros(2, 3, dtype=torch.int32)}
    args.update(over)
    return args


def _int4_args(**over):
    args = {"packed": torch.zeros(5, 2, dtype=torch.uint8),
            "scales": torch.ones(5, 1),
            "dense_ids": torch.zeros(2, 3, dtype=torch.int32)}
    args.update(over)
    return args


META = "meta"


@pytest.mark.parametrize("kernel,over,msg", [
    ("stage", {}, "CUDA device"),
    ("stage", {"dense_ids": torch.zeros(2, 3, dtype=torch.int64)}, "int32"),
    ("int4", {}, "CUDA device"),
    ("int4", {"dense_ids": torch.zeros(2, 3, dtype=torch.int64)}, "int32"),
    ("cached", {"slots": torch.zeros(2, 3, dtype=torch.int64)}, "int32")])
def test_wrappers_refuse_what_the_kernels_do_not_take(kernel, over, msg):
    before = _counts()
    with pytest.raises(ValueError, match=msg):
        if kernel == "stage":
            fd.fused_cached_segment_stage(**_stage_args(**over))
        elif kernel == "int4":
            fd.fused_int4_segment_sum(**_int4_args(**over), dim=4)
        else:
            fd.fused_cached_segment_sum(
                torch.zeros(3, 4), torch.zeros(5, 4), over["slots"],
                torch.zeros(2, 3, dtype=torch.int32))
    assert _counts() == before


@pytest.mark.parametrize("kernel,over,msg", [
    ("stage", {"slot_of": torch.zeros(5, dtype=torch.int64)}, "int32"),
    ("stage", {"slot_of": torch.zeros(5, 1, dtype=torch.int32)}, "dims"),
    ("stage", {"arena": torch.zeros(0, 4),
               "slot_of": torch.zeros(0, dtype=torch.int32)},
     "empty arena"),
    ("stage", {"hot_rows": torch.zeros(0, 4)}, "miss slot"),
    ("stage", {"slot_of": torch.zeros(0, dtype=torch.int32)},
     "slot for each"),
    ("stage", {"hot_rows": torch.zeros(3, 5)}, "differ in D"),
    ("stage", {"arena": torch.zeros(5, 4, device=META)},
     r"on \['cpu', 'meta'\]"),
    ("stage", {"slot_of": torch.zeros(5, dtype=torch.int32, device=META)},
     r"on \['cpu', 'meta'\]"),
    ("cached", {"cold_ids": torch.zeros(2, 3, dtype=torch.int64)},
     "int32"),
    ("cached", {"arena": torch.zeros(0, 4)}, "empty arena"),
    ("cached", {"hot_rows": torch.zeros(0, 4)}, "miss slot"),
    ("int4", {"packed": torch.zeros(0, 2, dtype=torch.uint8),
              "scales": torch.ones(0, 1)}, "empty packed"),
    ("int4", {"dense_ids": torch.zeros(2, 3, dtype=torch.int32,
                                       device=META)},
     r"on \['cpu', 'meta'\]")])
def test_wrappers_refuse_empty_tables_and_mixed_devices(
        past_the_device_check, kernel, over, msg):
    """The slot map's type, and, since reads past a bag's end fall on row
    0 of each table, an empty table; every tensor on one device."""
    before = _counts()
    with pytest.raises(ValueError, match=msg):
        if kernel == "stage":
            fd.fused_cached_segment_stage(**_stage_args(**over))
        elif kernel == "int4":
            fd.fused_int4_segment_sum(**_int4_args(**over), dim=4)
        else:
            args = _stage_args(**over)
            fd.fused_cached_segment_sum(
                args["hot_rows"], args["arena"], args["dense_ids"],
                args.get("cold_ids", args["dense_ids"]))
    assert _counts() == before


def test_stage_op_refuses_mixed_and_other_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_cached_segment_stage(
            **_stage_args(arena=torch.zeros(5, 4, device=META)), null_row=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_cached_segment_stage(
            **{k: v.to(META) for k, v in _stage_args().items()}, null_row=4)


def test_stage_op_max_l_zero_gives_zeros():
    got = ops.fused_cached_segment_stage(
        **_stage_args(dense_ids=torch.zeros(2, 0, dtype=torch.int32)),
        null_row=4)
    assert got.shape == (2, 4) and not got.any()
