"""The EB-Streamer on Hopper: the ``embedding_bag`` (and ``gather_rows``),
``sparse_lengths_sum`` and ``sls_grad_table`` kernels.

``embedding_bag`` replaces the Pallas kernel
``repro/kernels/embedding_gather.py:57 embedding_bag`` (body
``_bag_kernel``, :40), and ``gather_rows`` (:93) is its L = 1 case: the
embedding stage of the fixed (B, T, L) layout (``FpArena.reduce_fixed``).
``sparse_lengths_sum`` replaces ``:125 sparse_lengths_sum`` (body
``_ragged_kernel``, :103): the ragged reduction over an (indices,
offsets) stream, the ``reduce_flat`` half of the source protocol. Both
are bound by bytes, one gathered row per step, and at the serving
path's sizes by the issue of the reads. Their CUDA kernels
(``csrc/embedding_bag.cu``, ``csrc/sparse_lengths_sum.cu``) take
``fused_segment_sum``'s walk: a warp a bag with lanes over D, the bag in
chunks whose reads are all in flight before the first add, reads past
the bag's end on row 0 and never added, the sum in order of position
from 0.f. So every form of one bag gives the same bits. ``bag_plan`` and
``sls_plan`` size the chunk and the blocks through
``fused_dispatch.segment_plan``: ``gather_rows`` gets a depth of one,
and ``sparse_lengths_sum`` sizes its chunk by ``min(max_l,
SLS_DEPTH)``, since ``max_l`` may be a loose bound (the host tier passes
the stream's length) and the wrapper never reads the offsets to learn
the longest bag. Each kernel has its own launch counter, so a run can
show which of the embedding kernels a path went through.

``sls_grad_table`` replaces ``:188 sls_grad_table`` (body
``_grad_kernel``, :164): the table gradient of every gather-reduce. On
the training path it is the backward of ``fused_segment_sum`` and
``embedding_bag`` in the dense-gradient steps and of
``sparse_lengths_sum``, it sums the touched rows' gradients in the
sparse step (``training.sparse_optim``), and it is the int4 scales'
backward. The TPU kernel walks the argsorted positions in one
sequential grid, carries a run's sum in VMEM, flushes it once, and
aliases a zero table onto the output so that it writes only the rows a
run visits.

What bounds it on the card: bytes, and at the training path's shapes
the output write alone -- a (1,000,001, 32) f32 table is 128 MB, against
a few MB of ids and g rows. So the kernel writes every row exactly once
and nothing else does: no zero fill, no sort, no bag search outside the
kernel (``grad_plan`` and ``csrc/sls_grad_table.cu``). Blocks on Hopper
run in no order, so the kernel cannot carry a sum from block to block as
the TPU's grid does; each block instead owns a fixed set of rows --
granules of 512 bytes, dealt round-robin -- and is their only writer:
it zeroes the rows no position touches and sums each touched row's
positions in ascending order, with no float atomics. That order is the
CPU's ``index_add_``'s, from +0.0, so the card's gradient equals the CPU
plain version bit for bit, and two launches give the same bits. Past
SCAN_MAX positions a partition kernel first splits the positions by
owner, so that no block reads every id.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU
tensors to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_dispatch as _fd

# launches of each CUDA kernel in this process (not of the plain
# version): sls_grad_table, embedding_bag (gather_rows included),
# sparse_lengths_sum
launches = 0
bag_launches = 0
sls_launches = 0

_ARGS = (*(ctypes.c_void_p,) * 5, *(ctypes.c_int,) * 12)
# the pointers, the sizes, then the plan (blocks, warps a block, depth)
_BAG_ARGS = (*(ctypes.c_void_p,) * 3, *(ctypes.c_int,) * 6)
_SLS_ARGS = (*(ctypes.c_void_p,) * 4, *(ctypes.c_int,) * 7)

# the deepest chunk sparse_lengths_sum's plan sizes, and the deepest its
# kernel is built for: a chunk of min(max_l, SLS_DEPTH) rows, since max_l
# may be far above the bags. At the host tier's bound (the stream's
# length) over the serving path's bags (mean 20, max 40), a chunk of 40
# beat one of 64 on the card at 160 and at 10,240 bags (PERF.md,
# section 6)
SLS_DEPTH = 40


# blocks of single-row bags: a warp reads one row and leaves, so at many
# rows the blocks' own launch, not the reads, is what fewer blocks save
GATHER_WARPS_PER_BLOCK = 8


# the plans are asked for on every call and depend on a few ints alone:
# on the H100's host a plan took 1.5-4.1 us a call and 0.5-1.2 through
# the cache, of a wrapper's 20-41 us (examples/torch_sls_bag_check.py,
# plan_us against plan_cached_us; PERF.md, section 6)
@functools.lru_cache(maxsize=256)
def bag_plan(n_bags: int, n_l: int, dim: int, sms: int) -> _fd.SegmentPlan:
    """``embedding_bag``'s launch: ``segment_plan``'s, but single-row bags
    (``gather_rows``) take a depth of their own, one read a bag, where the
    smallest chunk of eight would issue seven reads a row to no use, and
    blocks of up to GATHER_WARPS_PER_BLOCK warps."""
    if n_l != 1:
        return _fd.segment_plan(n_bags, n_l, dim, sms)
    n = max(1, n_bags)
    per_block = min(GATHER_WARPS_PER_BLOCK, -(-n // sms))
    return _fd.SegmentPlan(blocks=-(-n // per_block),
                           warps_per_block=per_block, depth=1)


@functools.lru_cache(maxsize=256)
def sls_plan(n_bags: int, max_l: int, dim: int, sms: int) -> _fd.SegmentPlan:
    """``sparse_lengths_sum``'s launch: ``segment_plan``'s for bags of at
    most ``min(max_l, SLS_DEPTH)`` rows. The kernel stops each bag at its
    own length, so a longer bag takes more chunks; the cap keeps a loose
    bound (the host tier's, the stream's length) from sizing a chunk far
    past the bags."""
    return _fd.segment_plan(n_bags, min(max_l, SLS_DEPTH), dim, sms)


def _fp32_rows(table: torch.Tensor) -> None:
    if isinstance(table, torch.Tensor) and table.dtype != torch.float32:
        raise ValueError(f"table must be torch.float32, got {table.dtype}: "
                         "the kernel reads fp32 rows (the plain version, "
                         "for a CPU tensor, keeps any dtype)")


def _has_row_zero(table: torch.Tensor) -> None:
    # the kernels' reads past a bag's end fall on row 0, a real row here
    if table.shape[0] == 0:
        raise ValueError("an empty table has no row for the ids")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Fixed-lookup SparseLengthsSum: ``out[b] = sum_l table[indices[b,
    l]]``, summed in order of l.

    table (V, D) f32, V >= 1; indices (B, L) int32, any in-range row (no
    null-row assumption). Returns (B, D) in the table's dtype (f32);
    L == 0 gives zeros.
    """
    global bag_launches
    _fp32_rows(table)
    # ids stay int32: widening to int64 would double the id bytes read
    _build.require(indices, "indices", dtype=torch.int32, ndim=2)
    _build.require(table, "table", dtype=torch.float32, ndim=2)
    if indices.device != table.device:
        raise ValueError(f"indices on {indices.device}, table on "
                         f"{table.device}")
    b, n_l = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    if n_l == 0:
        return out.zero_()
    _has_row_zero(table)
    fn = _build.function("embedding_bag", "embedding_bag_f32", _BAG_ARGS)
    p = bag_plan(b, n_l, d, _build.sm_count(table.device))
    _build.launch(fn, "embedding_bag", table.device, table.data_ptr(),
                  indices.data_ptr(), out.data_ptr(), b, n_l, d, p.blocks,
                  p.warps_per_block, p.depth)
    bag_launches += 1
    return out


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain row gather: ``out[t] = table[indices[t]]``, the L = 1 bags of
    ``embedding_bag`` (one launch of its kernel, at depth 1)."""
    _build.require(indices, "indices", dtype=torch.int32, ndim=1)
    return embedding_bag(table, indices[:, None])


def sparse_lengths_sum(table: torch.Tensor, indices: torch.Tensor,
                       offsets: torch.Tensor, *, max_l: int) -> torch.Tensor:
    """Ragged SparseLengthsSum: bag b sums ``table[indices[p]]`` over its
    first ``min(offsets[b+1] - offsets[b], max_l)`` positions, in order.

    table (V, D) f32, V >= 1; indices (N,) int32, padded past offsets[-1]
    (never read); offsets (B+1,) int32. Returns (B, D) in the table's
    dtype (f32); an empty bag sums to zeros. The kernel reads the offsets
    on the card, so the wrapper never waits for the stream to check them.
    """
    global sls_launches
    _fp32_rows(table)
    _build.require(indices, "indices", dtype=torch.int32, ndim=1)
    _build.require(offsets, "offsets", dtype=torch.int32, ndim=1)
    _build.require(table, "table", dtype=torch.float32, ndim=2)
    if indices.device != table.device or offsets.device != table.device:
        raise ValueError(f"table on {table.device}, indices on "
                         f"{indices.device}, offsets on {offsets.device}")
    if offsets.shape[0] < 1:
        raise ValueError("offsets needs B + 1 >= 1 entries")
    if max_l < 0:
        raise ValueError(f"max_l {max_l} < 0")
    n = indices.shape[0]
    n_bags = offsets.shape[0] - 1
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if n_bags == 0 or d == 0:
        return out
    if n == 0 or max_l == 0:
        return out.zero_()
    _has_row_zero(table)
    max_l = min(int(max_l), 2 ** 31 - 1)
    fn = _build.function("sparse_lengths_sum", "sparse_lengths_sum_f32",
                         _SLS_ARGS)
    p = sls_plan(n_bags, max_l, d, _build.sm_count(table.device))
    _build.launch(fn, "sparse_lengths_sum", table.device, table.data_ptr(),
                  indices.data_ptr(), offsets.data_ptr(), out.data_ptr(), n,
                  n_bags, max_l, d, p.blocks, p.warps_per_block, p.depth)
    sls_launches += 1
    return out


class GradPlan(NamedTuple):
    """How ``sls_grad_table``'s two kernels cut their work.

    The output rows are cut into granules of ``granule`` rows (about 512
    bytes each); block q of ``blocks`` owns the granules g with g % blocks ==
    q, ``rows_per_block`` rows at most, and is the only writer of them.
    With ``partition``, a first kernel splits each tile of TILE positions
    by owner; without it (N <= SCAN_MAX) every block tests every id
    itself. A block of the main kernel sorts at most ``chunk`` of its
    positions at a time and streams their g rows through STAGES
    shared-memory tiles of ``tile`` rows. ``smem_bytes`` is the main
    kernel's dynamic shared memory a block, ``work_words`` the int32
    scratch the partition writes and the main kernel reads.
    """
    blocks: int
    granule: int
    rows_per_block: int
    chunk: int
    tile: int
    smem_bytes: int
    partition: bool
    work_words: int


# the kernels' shape (csrc/sls_grad_table.cu): positions a partition
# block, the main kernel's compute threads, tiles in flight, words of
# scratch, and the shared memory a block may use
TILE = 4096
COMPUTE_THREADS = 384
STAGES = 4
SORT_DIGITS = 256                     # the chunk sort's radix
SCRATCH_WORDS = 40
MAX_SMEM = 232448
# one block an SM of the H100 (132), rounded down to a power of two so
# that the owner of a granule is its low bits
BLOCKS = 128
MAX_BLOCKS = 2048                     # the partition's counters, 164 KB
GRANULE_BYTES = 512
MIN_CHUNK = 32
MAX_CHUNK = 4096                      # = TILE: a tile's entries fit a chunk
SCAN_MAX = 8192                       # N that every block scans whole
MAX_ROWS_PER_BLOCK = 1 << 15          # two 4 KB bitmaps of rows
STAGE_FLOATS = 8192                   # 32 KB a tile
MAX_POSITIONS = 2 ** 31 - 1 - TILE    # positions in the kernels' int range


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def smem_bytes(dim: int, chunk: int, tile: int, rows_per_block: int) -> int:
    """The main kernel's shared memory: STAGES tiles of g rows, two
    carried rows, the keys and bags of a chunk twice (the sort's two
    buffers), the sort's counters, the bitmaps of touched and written
    rows, the gathered tiles' offsets and the scratch words."""
    return 4 * (STAGES * tile * dim + 2 * dim + 4 * chunk
                + COMPUTE_THREADS // 32 * SORT_DIGITS
                + 2 * -(-rows_per_block // 32) + 2 * COMPUTE_THREADS
                + SCRATCH_WORDS)


def grad_plan(n: int, n_rows: int, dim: int) -> GradPlan:
    """The kernels' plan for N positions into an (n_rows, dim) table.

    It depends on these three sizes only, never on the ids, so two calls
    of one shape run the same schedule; and no choice it makes changes a
    bit of the result, since every row is summed in position order by
    the one block that owns it. Granules of GRANULE_BYTES (4 rows at D =
    32, 128 at D = 1: a table's hottest rows, its first, spread over
    more blocks); BLOCKS blocks, fewer for a small table (a power of
    two no larger than its granules), more when a block would own more
    than MAX_ROWS_PER_BLOCK rows; a chunk of the next power of two >= N,
    between MIN_CHUNK and MAX_CHUNK; tiles of STAGE_FLOATS floats, at
    most COMPUTE_THREADS rows and at most a chunk; the partition kernel
    only past SCAN_MAX positions, where each block reading every id
    would cost more than one kernel that reads them once.
    """
    if n < 0 or n_rows < 1 or dim < 1:
        raise ValueError(f"grad_plan: n {n}, n_rows {n_rows}, dim {dim}")
    granule = _pow2_floor(max(1, GRANULE_BYTES // (4 * dim)))
    granules = -(-n_rows // granule)
    blocks = min(BLOCKS, _pow2_floor(granules))
    while -(-granules // blocks) * granule > MAX_ROWS_PER_BLOCK:
        blocks *= 2
    if blocks > MAX_BLOCKS:
        raise ValueError(f"sls_grad_table: {n_rows} rows need {blocks} "
                         f"blocks, more than {MAX_BLOCKS}")
    rows_per_block = -(-granules // blocks) * granule
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, _pow2_ceil(n)))
    tile = max(1, min(COMPUTE_THREADS, chunk, STAGE_FLOATS // dim))
    smem = smem_bytes(dim, chunk, tile, rows_per_block)
    if smem > MAX_SMEM:
        raise ValueError(f"sls_grad_table: dim {dim} needs {smem} bytes of "
                         f"shared memory a block, more than {MAX_SMEM}")
    partition = n > SCAN_MAX
    work = 2 * n + 2 * -(-n // TILE) * blocks if partition else 0
    return GradPlan(blocks, granule, rows_per_block, chunk, tile, smem,
                    partition, work)


def sls_grad_table(g: torch.Tensor, indices: torch.Tensor,
                   offsets: torch.Tensor, *, n_rows: int,
                   skip_row: Optional[int] = None) -> torch.Tensor:
    """Fused segment scatter-add: the VJP of ragged SparseLengthsSum.

    g (n_bags, D) f32 upstream bag gradients; indices (N,) int32
    destination rows (may be padded past offsets[-1]); offsets
    (n_bags+1,) int32. Returns d_table (n_rows, D) f32 with
    ``d_table[r] = sum over valid p with indices[p] == r of g[bag(p)]``,
    each row summed in ascending position order. ``skip_row`` names a
    row left at zero without walking its run (the null row of the dense
    id form, whose gradient the reference pins to zero).

    One launch up to SCAN_MAX positions, else two (a partition of the
    positions by the block that owns their row first): the main kernel
    writes every row of the output, zeros included (``grad_plan``,
    ``csrc/sls_grad_table.cu``).
    """
    global launches
    # ids stay int32: widening to int64 would double the id bytes read
    _build.require(indices, "indices", dtype=torch.int32, ndim=1)
    _build.require(offsets, "offsets", dtype=torch.int32, ndim=1)
    _build.require(g, "g", dtype=torch.float32, ndim=2)
    if indices.device != g.device or offsets.device != g.device:
        raise ValueError(f"g on {g.device}, indices on {indices.device}, "
                         f"offsets on {offsets.device}")
    n = indices.shape[0]
    n_bags, d = g.shape
    if offsets.shape[0] != n_bags + 1:
        raise ValueError(f"{offsets.shape[0]} offsets for {n_bags} bags")
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError(f"n_rows {n_rows} outside the kernel's int32 range")
    if n > MAX_POSITIONS:
        raise ValueError(f"{n} positions; the kernels take at most "
                         f"{MAX_POSITIONS}")
    if n_rows * d >= 2 ** 31:
        raise ValueError(f"a ({n_rows}, {d}) table has {n_rows * d} "
                         "elements; the kernel takes 32-bit sizes")
    out = torch.empty((n_rows, d), dtype=torch.float32, device=g.device)
    if n_rows == 0 or d == 0:
        return out
    p = grad_plan(n, n_rows, d)
    work = torch.empty(p.work_words, dtype=torch.int32, device=g.device)
    fn = _build.function("sls_grad_table", "sls_grad_table_f32", _ARGS)
    _build.launch(fn, "sls_grad_table", g.device, g.data_ptr(),
                  indices.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                  work.data_ptr(), n, n_bags, n_rows, d,
                  -1 if skip_row is None else int(skip_row), p.blocks,
                  p.granule, p.chunk, p.tile, p.rows_per_block, p.smem_bytes,
                  int(p.partition))
    launches += 1
    return out
