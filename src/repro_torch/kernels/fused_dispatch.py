"""Fused segmented dispatch on Hopper: the ``fused_segment_sum``,
``fused_cached_segment_sum`` and ``fused_int4_segment_sum`` kernels.

``fused_segment_sum`` replaces the Pallas kernel
``repro/kernels/fused_dispatch.py:61 fused_segment_sum`` (body
``_fused_kernel``, :43), the embedding stage of the ragged serving path
(``FpArena.reduce_dense``). ``fused_cached_segment_sum`` replaces
``:116 fused_cached_segment_sum`` (body ``_cached_kernel``, :95), the
embedding stage of the hot-row cached path (``CachedSource`` over an fp
arena).

What bounds both on the card: bytes, and at the serving path's sizes
the issue of the row reads. Every position reads one gathered table row
at a data-dependent address and adds it. The CUDA kernel
(``csrc/fused_segment_sum.cu``) gives each bag a warp whose lanes span D,
so each row is one coalesced 128-byte read, issues all of a chunk's
reads before its first add, and sums in order of j from 0.f.
``segment_plan`` sizes the chunk to the bags (40 rows at ``max_l`` 40)
and the blocks to the card's SMs (batch 32's 160 bags on 80 blocks).
The cached kernel (``csrc/fused_cached_segment_sum.cu``) walks a warp a bag with the hit
test inside: per position it reads the one nonzero row, a hot copy (the
hot arena stays in the 50 MB L2) or a cold arena row, so on a coherent
cache it equals ``fused_segment_sum`` bit for bit.

``fused_int4_segment_sum`` replaces ``:183 fused_int4_segment_sum`` (body
``_int4_kernel``, :159), the int4 cold tier of tiered storage
(``storage.tiered.Int4Arena``). Its kernel
(``csrc/fused_int4_segment_sum.cu``) walks the same way over nibble-packed
rows, an eighth of the fp32 row bytes plus a 4-byte scale per position,
and keeps each term the rounded product code * scale, so it equals
``fused_segment_sum`` over the unpacked table bit for bit.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# launches of each CUDA kernel in this process (not of the plain version):
# fused_segment_sum, fused_cached_segment_sum, fused_int4_segment_sum
launches = 0
cached_launches = 0
int4_launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int)
_CACHED_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_INT4_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int)


# fused_segment_sum's tile: at most DEPTH rows of a bag in flight, in
# steps of DEPTH_STEP (the depths the kernel is built for); blocks of at
# most MAX_WARPS_PER_BLOCK warps, a warp a bag
DEPTH = 64
DEPTH_STEP = 8
MAX_WARPS_PER_BLOCK = 4


class SegmentPlan(NamedTuple):
    """fused_segment_sum's launch: ``blocks`` of ``warps_per_block``
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
    global cached_launches
    _build.require(slots, "slots", dtype=torch.int32, ndim=2)
    _build.require(cold_ids, "cold_ids", dtype=torch.int32, ndim=2)
    _build.require(hot_rows, "hot_rows", dtype=torch.float32, ndim=2)
    _build.require(arena, "arena", dtype=torch.float32, ndim=2)
    devices = {t.device for t in (hot_rows, arena, slots, cold_ids)}
    if len(devices) != 1:
        raise ValueError(f"hot_rows, arena, slots and cold_ids on "
                         f"{sorted(map(str, devices))}")
    if hot_rows.shape[1] != arena.shape[1]:
        raise ValueError(f"hot_rows {tuple(hot_rows.shape)} and arena "
                         f"{tuple(arena.shape)} differ in D")
    if slots.shape != cold_ids.shape:
        raise ValueError(f"slots {tuple(slots.shape)} and cold_ids "
                         f"{tuple(cold_ids.shape)} differ")
    if hot_rows.shape[0] < 1:
        raise ValueError("hot_rows needs its zero miss slot (K + 1 rows)")
    b, max_l = slots.shape
    d = arena.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=arena.device)
    if b == 0 or d == 0:
        return out
    if max_l == 0:
        return out.zero_()
    fn = _build.function("fused_cached_segment_sum",
                         "fused_cached_segment_sum_f32", _CACHED_ARGS)
    _build.launch(fn, "fused_cached_segment_sum", arena.device,
                  hot_rows.data_ptr(), arena.data_ptr(), slots.data_ptr(),
                  cold_ids.data_ptr(), out.data_ptr(), b, max_l, d,
                  hot_rows.shape[0] - 1)
    cached_launches += 1
    return out


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
    devices = {t.device for t in (packed, scales, dense_ids)}
    if len(devices) != 1:
        raise ValueError(f"packed, scales and dense_ids on "
                         f"{sorted(map(str, devices))}")
    v, p = packed.shape
    if tuple(scales.shape) != (v, 1):
        raise ValueError(f"scales {tuple(scales.shape)} for packed "
                         f"{tuple(packed.shape)}: one f32 scale per row")
    dim = int(dim)
    if not 2 * p >= dim > 2 * (p - 1):
        raise ValueError(f"dim {dim} does not fit {p} packed bytes a row "
                         f"(2P >= dim > 2(P - 1))")
    b, max_l = dense_ids.shape
    out = torch.empty((b, dim), dtype=torch.float32, device=packed.device)
    if b == 0 or dim == 0:
        return out
    if max_l == 0:
        return out.zero_()
    fn = _build.function("fused_int4_segment_sum",
                         "fused_int4_segment_sum_f32", _INT4_ARGS)
    _build.launch(fn, "fused_int4_segment_sum", packed.device,
                  packed.data_ptr(), scales.data_ptr(), dense_ids.data_ptr(),
                  out.data_ptr(), b, max_l, dim, p)
    int4_launches += 1
    return out
