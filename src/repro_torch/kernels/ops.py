"""Public wrappers around the kernels, dispatched by the tensors' device.

CPU tensors take the plain PyTorch version (``kernels.ref``); CUDA
tensors take the hand-written Hopper kernel, or raise. There is no
global implementation switch and no fallback: a CUDA tensor never
reaches a plain version here, and tensors on any other device, or on
two devices at once, are refused.

``gemm``, ``fused_segment_sum`` and ``interaction`` are
``torch.autograd.Function``s whose backward passes do what the
reference's custom VJPs do: the backward of a GEMM is two GEMMs on the
same kernel, the backward of the fused gather-reduce is the
``sls_grad_table`` segment scatter-add with the null row's gradient
pinned to zero, and the interaction's backward is (G + G^T) X in plain
torch, as the reference's einsum sits outside any Pallas kernel.
Serving runs them under ``torch.inference_mode``, which records nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import feature_interaction as _fi
from repro_torch.kernels import fused_dispatch as _fd
from repro_torch.kernels import gemm as _gm
from repro_torch.kernels import ref as _ref


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA arguments, False for all-CPU, else raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernels run on CUDA tensors and their plain "
                     f"versions on CPU tensors; got {sorted(kinds)}")


def _gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _on_cuda(x, w):
        return _gm.gemm(x, w)
    return _ref.gemm(x, w)


class _Gemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        # two GEMMs on the same kernel (dx = g w^T, dw = x^T g); the
        # kernel takes contiguous operands, so the transposes are copied
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gemm(g, w.t().contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _gemm(x.t().contiguous(), g).to(w.dtype)
        return dx, dw


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) with fp32 accumulation (the dense engine).
    Differentiable: the backward runs the same kernel twice, and skips
    dx where nothing needs it (the bottom MLP's first layer)."""
    return _Gemm.apply(x, w)


def sls_grad_table(g: torch.Tensor, indices: torch.Tensor,
                   offsets: torch.Tensor, *, n_rows: int,
                   skip_row: Optional[int] = None) -> torch.Tensor:
    """Segment scatter-add (n_rows, D) f32: ``d[r] = sum over valid p
    with indices[p] == r of g[bag(p)]``, each row summed in ascending
    position order; ``skip_row``'s gradient is zero."""
    if _on_cuda(g, indices, offsets):
        return _eg.sls_grad_table(g, indices, offsets, n_rows=n_rows,
                                  skip_row=skip_row)
    d = _ref.sls_grad_table(g, indices, offsets, n_rows).float()
    if skip_row is not None:
        d[skip_row] = 0.0
    return d


class _FusedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, dense_ids, null_row):
        ctx.save_for_backward(dense_ids)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.null_row = null_row
        if _on_cuda(table, dense_ids):
            return _fd.fused_segment_sum(table, dense_ids)
        return _ref.fused_segment_sum(table, dense_ids)

    @staticmethod
    def backward(ctx, g):
        # a dense (B, max_l) id matrix is a ragged stream with uniform
        # offsets, so the backward is the same segment scatter-add; the
        # relayout points every fill slot at the null row, whose gradient
        # is pinned to zero as in the reference (kernels/ops.py:172-188)
        (dense_ids,) = ctx.saved_tensors
        b, max_l = dense_ids.shape
        offsets = torch.arange(b + 1, dtype=torch.int32,
                               device=dense_ids.device) * max_l
        d = sls_grad_table(g.float().contiguous(), dense_ids.reshape(-1),
                           offsets, n_rows=ctx.n_rows, skip_row=ctx.null_row)
        return d.to(ctx.table_dtype), None, None


def fused_segment_sum(table: torch.Tensor, dense_ids: torch.Tensor, *,
                      null_row: Optional[int] = None) -> torch.Tensor:
    """Segmented reduce over a dense id matrix: out[b] = sum_j
    table[ids[b, j]], f32 (B, D).

    ``dense_ids`` is a ``sparse_engine.ragged_dense_ids`` relayout with
    short/padded slots pointing at the always-zero ``null_row``. The
    forward needs no mask; the backward (the table gradient) pins
    ``null_row``'s gradient to zero, as the reference does.
    """
    return _FusedSegmentSum.apply(table, dense_ids,
                                  None if null_row is None else int(null_row))


class _Interaction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if _on_cuda(x):
            return _fi.interaction(x)
        return _ref.interaction(x)

    @staticmethod
    def backward(ctx, g):
        # z = X X^T per sample => dX = (G + G^T) X
        (x,) = ctx.saved_tensors
        g32 = g.float()
        return torch.bmm(g32 + g32.transpose(1, 2), x.float()).to(x.dtype)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, D) -> (B, F, F) pairwise dots per sample."""
    return _Interaction.apply(x)


def interaction_tril(x: torch.Tensor) -> torch.Tensor:
    """DLRM interaction: lower-triangle (offset -1) of X X^T, flattened
    row-major, as the reference takes it outside its kernel."""
    z = interaction(x)
    f = x.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=x.device)
    return z[:, li, lj]
