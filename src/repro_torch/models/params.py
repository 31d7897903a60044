"""Parameter factory for the LM trees, the counterpart of the reference's
``Builder`` (``repro/models/params.py``).

The reference's init functions build ``Param(value, spec)`` leaves whose
logical sharding specs feed its mesh; the port runs on one card, so its
trees are plain nested dicts of tensors (the LM side's sharding is
ROADMAP Queue 1, items 13b and 15b). Values are drawn from an explicit ``torch.Generator`` on the
params' device: they follow the reference's distributions and scales,
not ``jax.random``'s bits; parity tests load the reference's own values
through ``api.params_from_numpy``.
"""
from __future__ import annotations

from typing import Optional

import torch


class Builder:
    """Draws params from ``generator`` onto ``device`` in ``dtype``."""

    def __init__(self, generator: torch.Generator, *, dtype: torch.dtype,
                 device: torch.device):
        if generator.device.type != torch.device(device).type:
            raise ValueError(f"generator on {generator.device}, params "
                             f"asked on {device}")
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def normal(self, shape, scale: Optional[float] = None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """N(0, scale^2), drawn in fp32; scale defaults to fan_in ** -0.5
        with fan_in = shape[0] (the last dim for a vector)."""
        if scale is None:
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            scale = fan_in ** -0.5
        v = scale * torch.randn(tuple(shape), generator=self.generator,
                                dtype=torch.float32, device=self.device)
        return v.to(dtype or self.dtype)

    def zeros(self, shape, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)


def stack_layers(trees):
    """Stack per-layer trees (nested dicts of tensors, one structure) along
    a new leading axis: the reference's stacked ``(L, ...)`` layers."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
