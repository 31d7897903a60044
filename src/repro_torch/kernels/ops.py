"""Public wrappers around the kernels, dispatched by the tensors' device.

CPU tensors take the plain PyTorch version (``kernels.ref``); CUDA
tensors take the hand-written Hopper kernel, or raise. There is no
global implementation switch and no fallback: a CUDA tensor never
reaches a plain version here, and tensors on any other device, or on
two devices at once, are refused.

Serving runs under ``torch.inference_mode``; the backward passes (the
segment scatter-add, the two backward GEMMs, (G + G^T) X) come with the
training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

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


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) with fp32 accumulation (the dense engine)."""
    if _on_cuda(x, w):
        return _gm.gemm(x, w)
    return _ref.gemm(x, w)


def fused_segment_sum(table: torch.Tensor, dense_ids: torch.Tensor, *,
                      null_row: Optional[int] = None) -> torch.Tensor:
    """Segmented reduce over a dense id matrix: out[b] = sum_j
    table[ids[b, j]], f32 (B, D).

    ``dense_ids`` is a ``sparse_engine.ragged_dense_ids`` relayout with
    short/padded slots pointing at the always-zero ``null_row``. The
    forward needs no mask; ``null_row`` is kept in the signature for the
    backward of the training slice, which pins the sentinel's gradient
    to zero as the reference does.
    """
    del null_row  # forward-only until the training slice
    if _on_cuda(table, dense_ids):
        return _fd.fused_segment_sum(table, dense_ids)
    return _ref.fused_segment_sum(table, dense_ids)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, D) -> (B, F, F) pairwise dots per sample."""
    if _on_cuda(x):
        return _fi.interaction(x)
    return _ref.interaction(x)


def interaction_tril(x: torch.Tensor) -> torch.Tensor:
    """DLRM interaction: lower-triangle (offset -1) of X X^T, flattened
    row-major, as the reference takes it outside its kernel."""
    z = interaction(x)
    f = x.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=x.device)
    return z[:, li, lj]
