"""The EB-Streamer on Hopper: the ``embedding_bag`` (and ``gather_rows``),
``sparse_lengths_sum`` and ``sls_grad_table`` kernels.

``embedding_bag`` replaces the Pallas kernel
``repro/kernels/embedding_gather.py:57 embedding_bag`` (body
``_bag_kernel``, :40), and ``gather_rows`` (:93) is its L = 1 case: the
embedding stage of the fixed (B, T, L) layout (``FpArena.reduce_fixed``).
``sparse_lengths_sum`` replaces ``:125 sparse_lengths_sum`` (body
``_ragged_kernel``, :103): the ragged reduction over an (indices,
offsets) stream, the ``reduce_flat`` half of the source protocol. Both
are bound by bytes, one gathered row per step; their CUDA kernels
(``csrc/embedding_bag.cu``, ``csrc/sparse_lengths_sum.cu``) give each bag
one warp with lanes over D and sum in order of position, as
``fused_segment_sum`` does, so every form of one bag gives the same bits.
Each kernel has its own launch counter, so a run can show which of the
embedding kernels a path went through.

``sls_grad_table`` replaces ``:188 sls_grad_table`` (body
``_grad_kernel``, :164): the table gradient of every gather-reduce. On
the training path it is the backward of ``fused_segment_sum`` and
``embedding_bag`` in the dense-gradient steps and of
``sparse_lengths_sum``, and it sums the touched rows' gradients in the
sparse step (``training.sparse_optim``).

What bounds it on the card: bytes. Each step reads one upstream gradient
row at a data-dependent address and adds it; the (n_rows, D) zero output
costs more than the kernel whenever the table is much larger than the
index stream. The CUDA kernel (``csrc/sls_grad_table.cu``) gives each
run of equal destinations one warp, which sums it in ascending position
order and writes the row once: no float atomics, so it is deterministic
and equals the CPU's ``index_add_`` bit for bit. The sort, the bag id of
each position and the validity mask stay torch ops here, as they stay
XLA ops in the reference's wrapper.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU
tensors to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of each CUDA kernel in this process (not of the plain
# version): sls_grad_table, embedding_bag (gather_rows included),
# sparse_lengths_sum
launches = 0
bag_launches = 0
sls_launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_BAG_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int)
_SLS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int)


def _fp32_rows(table: torch.Tensor) -> None:
    if isinstance(table, torch.Tensor) and table.dtype != torch.float32:
        raise ValueError(f"table must be torch.float32, got {table.dtype}: "
                         "the kernel reads fp32 rows (the plain version, "
                         "for a CPU tensor, keeps any dtype)")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Fixed-lookup SparseLengthsSum: ``out[b] = sum_l table[indices[b,
    l]]``, summed in order of l.

    table (V, D) f32; indices (B, L) int32, any in-range row (no null-row
    assumption). Returns (B, D) in the table's dtype (f32);
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
    fn = _build.function("embedding_bag", "embedding_bag_f32", _BAG_ARGS)
    _build.launch(fn, "embedding_bag", table.device, table.data_ptr(),
                  indices.data_ptr(), out.data_ptr(), b, n_l, d)
    bag_launches += 1
    return out


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain row gather: ``out[t] = table[indices[t]]``, the L = 1 bags of
    ``embedding_bag`` (one launch of its kernel)."""
    _build.require(indices, "indices", dtype=torch.int32, ndim=1)
    return embedding_bag(table, indices[:, None])


def sparse_lengths_sum(table: torch.Tensor, indices: torch.Tensor,
                       offsets: torch.Tensor, *, max_l: int) -> torch.Tensor:
    """Ragged SparseLengthsSum: bag b sums ``table[indices[p]]`` over its
    first ``min(offsets[b+1] - offsets[b], max_l)`` positions, in order.

    table (V, D) f32; indices (N,) int32, padded past offsets[-1] (never
    read); offsets (B+1,) int32. Returns (B, D) in the table's dtype
    (f32); an empty bag sums to zeros. The kernel reads the offsets on
    the card, so the wrapper never waits for the stream to check them.
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
    fn = _build.function("sparse_lengths_sum", "sparse_lengths_sum_f32",
                         _SLS_ARGS)
    _build.launch(fn, "sparse_lengths_sum", table.device, table.data_ptr(),
                  indices.data_ptr(), offsets.data_ptr(), out.data_ptr(), n,
                  n_bags, min(int(max_l), 2 ** 31 - 1), d)
    sls_launches += 1
    return out


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
