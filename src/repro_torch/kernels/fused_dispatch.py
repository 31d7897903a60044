"""Fused segmented dispatch on Hopper: the ``fused_segment_sum``,
``fused_cached_segment_sum`` and ``fused_int4_segment_sum`` kernels.

``fused_segment_sum`` replaces the Pallas kernel
``repro/kernels/fused_dispatch.py:61 fused_segment_sum`` (body
``_fused_kernel``, :43), the embedding stage of the ragged serving path
(``FpArena.reduce_dense``). ``fused_cached_segment_sum`` replaces
``:116 fused_cached_segment_sum`` (body ``_cached_kernel``, :95), the
embedding stage of the hot-row cached path (``CachedSource`` over an fp
arena).

What bounds both on the card: bytes. Every step reads one gathered table
row at a data-dependent address and adds it, so the time is the row
reads. The CUDA kernel (``csrc/fused_segment_sum.cu``) gives each bag one
warp whose lanes span D, so each step is one coalesced 128-byte row at
D = 32, and it sums in order of j. The cached kernel
(``csrc/fused_cached_segment_sum.cu``) walks the same way with the hit
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

import torch

from repro_torch.kernels import _build

# launches of each CUDA kernel in this process (not of the plain version):
# fused_segment_sum, fused_cached_segment_sum, fused_int4_segment_sum
launches = 0
cached_launches = 0
int4_launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int)
_CACHED_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_INT4_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int)


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
    fn = _build.function("fused_segment_sum", "fused_segment_sum_f32", _ARGS)
    _build.launch(fn, "fused_segment_sum", table.device, table.data_ptr(),
                  dense_ids.data_ptr(), out.data_ptr(), b, max_l, d)
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
