"""Fused segmented dispatch on Hopper: the ``fused_segment_sum`` kernel.

Replaces the Pallas kernel ``repro/kernels/fused_dispatch.py:61
fused_segment_sum`` (body ``_fused_kernel``, :43), the embedding stage of
the ragged serving path (``FpArena.reduce_dense``).

What bounds it on the card: bytes. Every step reads one gathered table
row at a data-dependent address and adds it, so the time is the row
reads. The CUDA kernel (``csrc/fused_segment_sum.cu``) gives each bag one
warp whose lanes span D, so each step is one coalesced 128-byte row at
D = 32, and it sums in order of j, the order the later hot/cold kernel
must match bit for bit.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int)


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
