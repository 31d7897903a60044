"""Fused segmented dispatch on Hopper: the ``fused_segment_sum``,
``fused_cached_segment_sum`` and ``fused_int4_segment_sum`` kernels.

``fused_segment_sum`` replaces the Pallas kernel
``repro/kernels/fused_dispatch.py:61 fused_segment_sum`` (body
``_fused_kernel``, :43), the embedding stage of the ragged serving path
(``FpArena.reduce_dense``). ``fused_cached_segment_sum`` replaces
``:116 fused_cached_segment_sum`` (body ``_cached_kernel``, :95), the
embedding stage of the hot-row cached path (``CachedSource`` over an fp
arena). ``fused_int4_segment_sum`` replaces ``:183
fused_int4_segment_sum`` (body ``_int4_kernel``, :159), the int4 cold
tier of tiered storage (``storage.tiered.Int4Arena``).

What bounds all three on the card: bytes, and at the serving path's
sizes the issue of the reads. Every position reads one gathered row at a
data-dependent address and adds it. The three CUDA kernels share one
walk (``csrc/fused_segment_sum.cu``): a bag's lanes span its row, all
reads of a chunk of the bag in flight before its first add, the sum in
order of j from 0.f. ``segment_plan`` sizes the chunk to the bags (40
rows at ``max_l`` 40) and the blocks to the card's SMs (batch 32's 160
bags on 80 blocks), for all three.

The cached kernel (``csrc/fused_cached_segment_sum.cu``) tests slot < K
per position and reads the one nonzero row, a hot copy (the hot arena
stays in the 50 MB L2) or a cold arena row, so on a coherent cache it
equals ``fused_segment_sum`` bit for bit; the lane that holds a
position makes the test and hands the row's address to the others. Its
stage form (``fused_cached_segment_stage``) takes the dense ids and the
cache's slot map and makes the hit split inside the kernel, where the
serving path otherwise runs three torch launches for it. The int4 kernel
(``csrc/fused_int4_segment_sum.cu``) reads an eighth of the fp32 row
bytes plus a 4-byte scale a position and keeps each term the rounded
product code * scale, so it equals ``fused_segment_sum`` over the
unpacked table bit for bit.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# launches of each CUDA kernel in this process (not of the plain version):
# fused_segment_sum, fused_cached_segment_sum (both entries), its stage
# entry alone, fused_int4_segment_sum
launches = 0
cached_launches = 0
cached_stage_launches = 0
int4_launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int)
# both cached entries: four tables, the output, then n_bags, max_l, dim,
# K and the plan
_CACHED_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
_INT4_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7


# the three gathers' tile: at most DEPTH rows of a bag in flight, in
# steps of DEPTH_STEP (the depths the kernels are built for); blocks of at
# most MAX_WARPS_PER_BLOCK warps, a warp a bag
DEPTH = 64
DEPTH_STEP = 8
MAX_WARPS_PER_BLOCK = 4


class SegmentPlan(NamedTuple):
    """The launch of the three gathers: ``blocks`` of ``warps_per_block``
    warps, warp w the owner of bag w, each bag read in chunks of
    ``depth`` rows."""
    blocks: int
    warps_per_block: int
    depth: int


def segment_plan(n_bags: int, max_l: int, dim: int, sms: int) -> SegmentPlan:
    """The launch of a call from its shapes and the card's ``sms``: blocks
    of as few warps as spread the bags over the SMs, at most
    ``MAX_WARPS_PER_BLOCK``; a bag split into equal chunks of at most
    ``DEPTH`` rows, rounded up to ``DEPTH_STEP``, all of a chunk's reads
    in flight before its first add. The reads past a bag's end are issued
    too (unpredicated reads stay in flight; PERF.md), so the depth follows
    ``max_l``. ``dim`` leaves the plan as it is: wider rows go through in
    passes of 32 columns."""
    n = max(1, n_bags)
    per_block = min(MAX_WARPS_PER_BLOCK, -(-n // sms))
    chunks = max(1, -(-max_l // DEPTH))
    rows = max(1, -(-max_l // chunks))     # the longest chunk
    depth = -(-rows // DEPTH_STEP) * DEPTH_STEP
    return SegmentPlan(blocks=-(-n // per_block), warps_per_block=per_block,
                       depth=depth)


def fused_segment_sum(table: torch.Tensor,
                      dense_ids: torch.Tensor) -> torch.Tensor:
    """Segmented gather-reduce over a ``ragged_dense_ids`` matrix.

    table (V, D) f32; dense_ids (B, max_l) int32 with short/padded slots
    pointing at an always-zero row. Returns f32 (B, D):
    ``out[b] = sum_j table[dense_ids[b, j]]``; ``max_l == 0`` gives zeros.
    """
    global launches
    # ids stay int32: widening to int64 would double the id bytes read
    _build.require(dense_ids, "dense_ids", dtype=torch.int32, ndim=2)
    _build.require(table, "table", dtype=torch.float32, ndim=2)
    if dense_ids.device != table.device:
        raise ValueError(f"dense_ids on {dense_ids.device}, table on "
                         f"{table.device}")
    b, max_l = dense_ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if max_l == 0:
        return out.zero_()
    if table.shape[0] == 0:
        # the kernel's reads past a bag's end fall on row 0
        raise ValueError("an empty table has no row for the ids")
    fn = _build.function("fused_segment_sum", "fused_segment_sum_f32", _ARGS)
    p = segment_plan(b, max_l, d, _build.sm_count(table.device))
    _build.launch(fn, "fused_segment_sum", table.device, table.data_ptr(),
                  dense_ids.data_ptr(), out.data_ptr(), b, max_l, d,
                  p.blocks, p.warps_per_block, p.depth)
    launches += 1
    return out


def _check_cached_tables(hot_rows: torch.Tensor,
                         arena: torch.Tensor) -> None:
    _build.require(hot_rows, "hot_rows", dtype=torch.float32, ndim=2)
    _build.require(arena, "arena", dtype=torch.float32, ndim=2)
    if hot_rows.shape[1] != arena.shape[1]:
        raise ValueError(f"hot_rows {tuple(hot_rows.shape)} and arena "
                         f"{tuple(arena.shape)} differ in D")
    # the kernel's reads past a bag's end fall on row 0 of each table
    if hot_rows.shape[0] < 1:
        raise ValueError("hot_rows needs its zero miss slot (K + 1 rows)")
    if arena.shape[0] < 1:
        raise ValueError("an empty arena has no row for the ids")


def _same_device(names: str, *tensors: torch.Tensor) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{names} on {sorted(map(str, devices))}")


def _launch_cached(stage: bool, hot_rows: torch.Tensor, first: torch.Tensor,
                   second: torch.Tensor, third: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """One launch of either cached entry over the (B, max_l) matrix
    ``ids``'s shape; the pointers in the entry's order."""
    global cached_launches, cached_stage_launches
    b, max_l = ids.shape
    d = hot_rows.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=ids.device)
    if b == 0 or d == 0:
        return out
    if max_l == 0:
        return out.zero_()
    fn = _build.function("fused_cached_segment_sum",
                         "fused_cached_segment_stage_f32" if stage
                         else "fused_cached_segment_sum_f32", _CACHED_ARGS)
    p = segment_plan(b, max_l, d, _build.sm_count(ids.device))
    _build.launch(fn, "fused_cached_segment_sum", ids.device,
                  hot_rows.data_ptr(), first.data_ptr(), second.data_ptr(),
                  third.data_ptr(), out.data_ptr(), b, max_l, d,
                  hot_rows.shape[0] - 1, p.blocks, p.warps_per_block,
                  p.depth)
    cached_launches += 1
    cached_stage_launches += stage
    return out


def fused_cached_segment_sum(hot_rows: torch.Tensor, arena: torch.Tensor,
                             slots: torch.Tensor,
                             cold_ids: torch.Tensor) -> torch.Tensor:
    """One-pass hot/cold segmented reduce with the hit test in the kernel.

    hot_rows (K+1, D) f32 with slot K always zero; arena (V, D) f32 with
    the null row always zero; slots and cold_ids (B, max_l) int32 over
    the same bags, a hit's cold id redirected to the null row. Returns
    f32 (B, D): ``out[b] = sum_j hot_rows[slots[b, j]] +
    arena[cold_ids[b, j]]``; ``max_l == 0`` gives zeros.
    """
    _build.require(slots, "slots", dtype=torch.int32, ndim=2)
    _build.require(cold_ids, "cold_ids", dtype=torch.int32, ndim=2)
    _check_cached_tables(hot_rows, arena)
    _same_device("hot_rows, arena, slots and cold_ids", hot_rows, arena,
                 slots, cold_ids)
    if slots.shape != cold_ids.shape:
        raise ValueError(f"slots {tuple(slots.shape)} and cold_ids "
                         f"{tuple(cold_ids.shape)} differ")
    return _launch_cached(False, hot_rows, arena, slots, cold_ids, slots)


def fused_cached_segment_stage(hot_rows: torch.Tensor, slot_of: torch.Tensor,
                               arena: torch.Tensor,
                               dense_ids: torch.Tensor) -> torch.Tensor:
    """The cached plan's embedding stage in one launch: the hit split and
    the one-pass reduce.

    hot_rows (K+1, D) f32 with slot K always zero; slot_of (V,) int32,
    each arena row's hot slot or K; arena (V, D) f32 with the null row
    always zero; dense_ids (B, max_l) int32 into the arena. Returns f32
    (B, D): ``out[b] = sum_j hot_rows[s] if s < K else arena[id]``, with
    ``id = dense_ids[b, j]`` and ``s = slot_of[id]``: the value of
    ``fused_cached_segment_sum`` over the split (slots ``slot_of[dense]``,
    a hit's cold id the null row), bit for bit. ``max_l == 0`` gives
    zeros.
    """
    _build.require(dense_ids, "dense_ids", dtype=torch.int32, ndim=2)
    _build.require(slot_of, "slot_of", dtype=torch.int32, ndim=1)
    _check_cached_tables(hot_rows, arena)
    _same_device("hot_rows, slot_of, arena and dense_ids", hot_rows, slot_of,
                 arena, dense_ids)
    # every id indexes both; reads past a bag's end read slot_of[0]
    if slot_of.shape[0] != arena.shape[0]:
        raise ValueError(f"slot_of {tuple(slot_of.shape)} needs a slot for "
                         f"each of the arena's {arena.shape[0]} rows")
    return _launch_cached(True, hot_rows, slot_of, arena, dense_ids,
                          dense_ids)


def fused_int4_segment_sum(packed: torch.Tensor, scales: torch.Tensor,
                           dense_ids: torch.Tensor, *,
                           dim: int) -> torch.Tensor:
    """Int4 dequantize-in-the-gather segmented reduce.

    packed (V, P) uint8 nibble pairs and scales (V, 1) f32 from
    ``int4_pack``, with ``2P >= dim > 2(P - 1)``; dense_ids (B, max_l)
    int32 with short/padded slots pointing at a zero-scale row. Returns
    f32 (B, dim): ``out[b] = sum_j unpack(packed)[dense_ids[b, j]]``;
    ``max_l == 0`` gives zeros without a launch.
    """
    global int4_launches
    _build.require(dense_ids, "dense_ids", dtype=torch.int32, ndim=2)
    _build.require(packed, "packed", dtype=torch.uint8, ndim=2)
    _build.require(scales, "scales", dtype=torch.float32, ndim=2)
    _same_device("packed, scales and dense_ids", packed, scales, dense_ids)
    v, p = packed.shape
    if tuple(scales.shape) != (v, 1):
        raise ValueError(f"scales {tuple(scales.shape)} for packed "
                         f"{tuple(packed.shape)}: one f32 scale per row")
    dim = int(dim)
    if not 2 * p >= dim > 2 * (p - 1):
        raise ValueError(f"dim {dim} does not fit {p} packed bytes a row "
                         f"(2P >= dim > 2(P - 1))")
    if v == 0:
        # the kernel's reads past a bag's end fall on row 0
        raise ValueError("an empty packed table has no row for the ids")
    b, max_l = dense_ids.shape
    out = torch.empty((b, dim), dtype=torch.float32, device=packed.device)
    if b == 0 or dim == 0:
        return out
    if max_l == 0:
        return out.zero_()
    fn = _build.function("fused_int4_segment_sum",
                         "fused_int4_segment_sum_f32", _INT4_ARGS)
    plan = segment_plan(b, max_l, dim, _build.sm_count(packed.device))
    _build.launch(fn, "fused_int4_segment_sum", packed.device,
                  packed.data_ptr(), scales.data_ptr(), dense_ids.data_ptr(),
                  out.data_ptr(), b, max_l, dim, p, plan.blocks,
                  plan.warps_per_block, plan.depth)
    int4_launches += 1
    return out
