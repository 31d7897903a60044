"""Plain PyTorch versions of every ported kernel.

The ground truth in the tests, the path a CPU tensor takes through
``kernels.ops``, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card. Same names and semantics as the reference's
``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) with fp32 accumulation, result in x.dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fused_segment_sum(table: torch.Tensor,
                      dense_ids: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_j table[dense_ids[b, j]]; fill slots point at the zero
    null row. Returns f32 (B, D); an empty id matrix sums to zeros."""
    return table[dense_ids].float().sum(dim=1)


def sls_grad_table(g: torch.Tensor, indices: torch.Tensor,
                   offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """VJP of ragged SparseLengthsSum w.r.t. the table: segment scatter-add.

    d_table[r] = sum over valid positions p with indices[p] == r of
    g[bag(p)]; padded positions (>= offsets[-1]) add nothing. On the CPU
    ``index_add_`` adds in ascending position order, the order the CUDA
    kernel keeps, so the two agree bit for bit there.
    """
    n = indices.shape[0]
    n_bags = offsets.shape[0] - 1
    out = torch.zeros((n_rows, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    if n == 0 or n_bags == 0:
        return out.to(g.dtype)
    pos = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    seg = torch.searchsorted(offsets[1:], pos, right=True)
    rows = g.float()[torch.clamp(seg, max=n_bags - 1)]
    rows = torch.where((pos < offsets[-1])[:, None], rows, 0.0)
    return out.index_add_(0, indices, rows).to(g.dtype)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """Pairwise dot products: x (B, F, D) -> (B, F, F) = X X^T per sample."""
    x32 = x.float()
    return torch.matmul(x32, x32.transpose(1, 2)).to(x.dtype)


def interaction_tril(x: torch.Tensor) -> torch.Tensor:
    """DLRM feature interaction output: lower triangle (offset -1)
    flattened row-major, as ``jnp.tril_indices`` orders it."""
    z = interaction(x)
    f = x.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=x.device)
    return z[:, li, lj]


def mlp(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """Reference MLP: relu between layers, last layer linear."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = gemm(h, w) + b
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h
