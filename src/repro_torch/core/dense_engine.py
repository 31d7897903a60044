"""The Centaur dense engine: the GEMM kernel run as MLPs + interaction.

The two dense stages of the paper's pipeline (Fig. 11): the MLP unit
(bottom/top MLPs, one ``ops.gemm`` per layer) and the feature-interaction
unit (batched X X^T + lower-triangle concat).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import ops


def init_mlp(generator: torch.Generator, dims: Sequence[int]
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """dims = (in, h1, ..., out); returns a list of fp32 (w, b) on the
    generator's device, He-scaled like the reference."""
    params = []
    for i in range(len(dims) - 1):
        scale = (2.0 / dims[i]) ** 0.5
        w = scale * torch.randn((dims[i], dims[i + 1]), generator=generator,
                                dtype=torch.float32, device=generator.device)
        b = torch.zeros((dims[i + 1],), dtype=torch.float32,
                        device=generator.device)
        params.append((w, b))
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Run the MLP unit: one GEMM per layer, relu between layers, the last
    layer linear. Bias and relu stay tensor ops outside the kernel, as in
    the reference."""
    h = x
    for i, (w, b) in enumerate(params):
        h = ops.gemm(h, w) + b
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def feature_interaction(bottom_out: torch.Tensor, reduced_embs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Fig. 3: concat the bottom-MLP vector with the reduced
    embeddings, take all pairwise dots (lower triangle), concat with the
    bottom-MLP output.

    bottom_out: (B, D); reduced_embs: (B, T, D) -> (B, D + F(F-1)/2), and
    the (B, F, D) features. One ``interaction`` launch on the card, and
    one for its backward.
    """
    return ops.feature_interaction(bottom_out, reduced_embs)
