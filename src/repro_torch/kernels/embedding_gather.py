"""Segment scatter-add on Hopper: the ``sls_grad_table`` kernel.

Replaces the Pallas kernel ``repro/kernels/embedding_gather.py:188
sls_grad_table`` (body ``_grad_kernel``, :164): the table gradient of
every ragged gather-reduce. On the training path it is the backward of
``fused_segment_sum`` in the dense-gradient step, and it sums the touched
rows' gradients in the sparse step (``training.sparse_optim``).

What bounds it on the card: bytes. Each step reads one upstream gradient
row at a data-dependent address and adds it; the (n_rows, D) zero output
costs more than the kernel whenever the table is much larger than the
index stream. The CUDA kernel (``csrc/sls_grad_table.cu``) gives each
run of equal destinations one warp, which sums it in ascending position
order and writes the row once: no float atomics, so it is deterministic
and equals the CPU's ``index_add_`` bit for bit. The sort, the bag id of
each position and the validity mask stay torch ops here, as they stay
XLA ops in the reference's wrapper.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)


def sort_by_destination(indices: torch.Tensor, offsets: torch.Tensor,
                        n_rows: int):
    """(dst, bag): the destination row and the bag of every position,
    stably sorted by destination; padded positions (>= offsets[-1]) get
    the destination n_rows, which the kernel skips. Both int32."""
    n = indices.shape[0]
    n_bags = offsets.shape[0] - 1
    pos = torch.arange(n, dtype=torch.int32, device=indices.device)
    seg = torch.searchsorted(offsets[1:], pos, right=True, out_int32=True)
    # a Python scalar, not a device tensor: copying one to the card
    # would wait for the stream
    key = torch.where(pos < offsets[-1], indices, n_rows)
    dst, order = torch.sort(key, stable=True)
    bag = torch.clamp(seg, max=n_bags - 1)[order]
    return dst.contiguous(), bag.contiguous()


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
    out = torch.zeros((n_rows, d), dtype=torch.float32, device=g.device)
    if n == 0 or n_bags == 0 or d == 0 or n_rows == 0:
        return out
    dst, bag = sort_by_destination(indices, offsets, n_rows)
    fn = _build.function("sls_grad_table", "sls_grad_table_f32", _ARGS)
    _build.launch(fn, "sls_grad_table", g.device, g.data_ptr(),
                  dst.data_ptr(), bag.data_ptr(), out.data_ptr(), n, n_rows,
                  d, -1 if skip_row is None else int(skip_row))
    launches += 1
    return out
