"""``fused_segment_sum``'s launch plan and schedule, on the CPU.

The CUDA kernel (``csrc/fused_segment_sum.cu``) runs only on the card,
where ``chip_smoke.py`` phase 2 holds it bit for bit against an in-order
plain loop. Here: the rules of ``segment_plan`` at the serving path's
shapes (every bag one owner, a block and its tile within what the kernel
is built for, the plan a function of its arguments alone, the bags
spread over at least 80 SMs at batch 32, the tile sized to the bags) and
a numpy model of the kernel's walk under the plan (warp w of the grid
owns bag w; a bag in chunks of the plan's depth, each chunk's rows added
in order, the sum carried across chunks), which must add every position
of every bag once, in order of j, and so equal a sequential float32 sum
bit for bit. (The plain version, torch's ``sum`` over the bag dim, does
not add strictly in order of j on the CPU, so it is no model of the
order.)

The kernel keeps a chunk's rows in registers, so there is no shared
memory to fit; the tile's depth is what the plan sizes.

Tolerances: none; the model and the sequential sum both add a bag's rows
in order of j from +0.0 in float32, so they must agree exactly.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_dispatch as fd

torch.set_num_threads(1)

MAX_THREADS = 256                 # the kernel's launch bound
BUILT_DEPTHS = range(8, 65, 8)    # the tile depths the kernel is built for
H100_SXM_SMS = 132
H100_PCIE_SMS = 114
# (n_bags, max_l, dim): DLRM(1)'s bags at batch 32 and 2048 (5 tables,
# max_l 40, D 32), the hot tier and staging shapes, no rows, one row,
# bags longer than one tile (65, 70, 80, 97, 130, 200), widths past 32
# columns and not a multiple of 4; the cached and int4 kernels run the
# same plan. Then embedding_bag's (bag_plan: segment_plan for L > 1) at
# DLRM(1)'s fixed bags (L = 20) at batch 32 and 2048, DLRM(3)'s L = 80
# and long bags, and sparse_lengths_sum's (sls_plan: segment_plan at
# min(max_l, 40)) at short and one-row bounds
PATH_SHAPES = [(160, 40, 32), (10_240, 40, 32), (9, 7, 16), (1, 200, 32),
               (300, 45, 48), (2_112, 40, 32), (2_113, 40, 32), (1, 1, 1),
               (5, 0, 32), (100_000, 40, 32), (3_000, 80, 6), (0, 40, 32),
               (9, 1, 32), (7, 200, 32), (37, 45, 6), (3, 64, 33),
               (64, 65, 32), (3_000, 70, 6), (7, 130, 31), (64, 97, 32),
               (160, 20, 32), (10_240, 20, 32), (2_113, 20, 32),
               (0, 20, 32), (160, 80, 32), (9, 45, 48), (37, 200, 32),
               (3_000, 130, 6), (6, 5, 48), (160, 1, 32)]


def owned_bags(plan) -> np.ndarray:
    """The bag of each warp of the grid, as the kernel computes it from
    (block, warp in block)."""
    w = np.arange(plan.blocks * plan.warps_per_block)
    return (w // plan.warps_per_block) * plan.warps_per_block + (
        w % plan.warps_per_block)


def chunk_order(plan, max_l: int) -> list:
    """The positions j an owner adds, in order: chunks of ``plan.depth``
    slots from j0 = 0, the first min(depth, max_l - j0) of each added."""
    order = []
    for j0 in range(0, max_l, plan.depth):
        order.extend(j0 + r for r in range(min(plan.depth, max_l - j0)))
    return order


def sequential(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    acc = np.zeros((ids.shape[0], table.shape[1]), np.float32)
    for j in range(ids.shape[1]):
        acc = acc + table[ids[:, j]]
    return acc


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("n_bags,max_l,dim", PATH_SHAPES)
def test_every_bag_has_one_owner_that_adds_it_in_order(n_bags, max_l, dim,
                                                       sms):
    """Each bag is owned by exactly one warp of the grid, no block is all
    idle, and the owner's chunks add positions 0 .. max_l-1 once each, in
    order; summed in that order the bags equal a sequential float32 sum
    bit for bit (``max_l == 0`` is the wrapper's zeros, no launch)."""
    p = fd.segment_plan(n_bags, max_l, dim, sms)
    bags = owned_bags(p)
    np.testing.assert_array_equal(
        np.bincount(bags[bags < n_bags], minlength=n_bags), 1)
    assert (p.blocks - 1) * p.warps_per_block < max(n_bags, 1)
    order = chunk_order(p, max_l)
    assert order == list(range(max_l))
    if n_bags * max_l * dim > 4_000_000:
        return      # the order is the same walk; spare the sum
    rng = np.random.RandomState(n_bags * 7 + max_l + dim)
    v = 97
    table = rng.randn(v, dim).astype(np.float32)
    table[v - 1] = 0.0
    ids = rng.randint(0, v, (n_bags, max_l)).astype(np.int32)
    got = np.zeros((n_bags, dim), np.float32)
    for j in order:
        got = got + table[ids[:, j]]
    np.testing.assert_array_equal(got, sequential(table, ids))


@pytest.mark.parametrize("n_bags,max_l,dim", PATH_SHAPES)
def test_plan_fits_the_kernel(n_bags, max_l, dim):
    """Blocks within the launch bound, a tile depth the kernel is built
    for, and under DEPTH_STEP reads a chunk past the bag's end (no bag
    rows, no launch)."""
    p = fd.segment_plan(n_bags, max_l, dim, H100_SXM_SMS)
    assert 1 <= p.warps_per_block <= fd.MAX_WARPS_PER_BLOCK
    assert 32 * p.warps_per_block <= MAX_THREADS
    assert p.blocks >= 1
    assert p.depth in BUILT_DEPTHS and p.depth <= fd.DEPTH
    chunks = -(-max_l // p.depth)
    assert max_l == 0 or chunks * p.depth - max_l < chunks * fd.DEPTH_STEP


def test_plan_is_a_function_of_its_arguments():
    """The shapes and the card's SM count, nothing of the data."""
    assert list(inspect.signature(fd.segment_plan).parameters) == [
        "n_bags", "max_l", "dim", "sms"]
    for shape in PATH_SHAPES:
        assert (fd.segment_plan(*shape, H100_SXM_SMS)
                == fd.segment_plan(*shape, H100_SXM_SMS))


def test_serving_batch_spreads_over_80_sms_with_its_bag_in_one_tile():
    """160 bags (batch 32 x 5 tables), max_l 40: a warp a bag on 80 blocks
    of two warps, all 40 reads of a bag in flight at once."""
    p = fd.segment_plan(160, 40, 32, H100_SXM_SMS)
    assert p == fd.SegmentPlan(blocks=80, warps_per_block=2, depth=40)


def test_batch_2048_takes_blocks_of_four_warps():
    p = fd.segment_plan(10_240, 40, 32, H100_SXM_SMS)
    assert p == fd.SegmentPlan(blocks=2_560, warps_per_block=4, depth=40)


def test_blocks_follow_the_cards_sm_count():
    """264 bags fill 132 SMs with blocks of two warps; on 114 SMs they
    take blocks of three."""
    assert fd.segment_plan(264, 40, 32, H100_SXM_SMS).blocks == 132
    assert fd.segment_plan(264, 40, 32, H100_PCIE_SMS).blocks == 88


@pytest.mark.parametrize("max_l,depth", [(1, 8), (40, 40), (64, 64),
                                         (65, 40), (200, 56)])
def test_long_bags_split_into_equal_chunks(max_l, depth):
    assert fd.segment_plan(160, max_l, 32, H100_SXM_SMS).depth == depth


def test_order_is_visible_in_the_bits():
    """The check above can fail: over 200 rows of N(0, 1), the sum in
    reverse order differs from the in-order sum."""
    rng = np.random.RandomState(0)
    table = rng.randn(97, 32).astype(np.float32)
    ids = rng.randint(0, 97, (7, 200)).astype(np.int32)
    assert not np.array_equal(sequential(table, ids[:, ::-1]),
                              sequential(table, ids))
