"""Parameter factory for the LM trees, the counterpart of the reference's
``Builder`` (``repro/models/params.py``).

The reference's init functions build ``Param(value, spec)`` leaves whose
logical sharding specs feed its mesh; the port runs on one card, so its
trees are plain nested dicts of tensors (the LM side's sharding is
ROADMAP Queue 1, item 13c). Values are drawn from an explicit
``torch.Generator`` on the params' device: they follow the reference's
distributions and scales, not ``jax.random``'s bits; parity tests load
the reference's own values through ``api.params_from_numpy``.

Init allocates each leaf once: ``init_stacked`` fills a stacked (L, ...)
leaf layer by layer in place, and ``Builder.normal_`` draws a leaf of
more than ``MAX_DRAW`` values a block of leading rows at a time (a
chunk of experts, of vocab rows), so that init's peak is the model plus
one fp32 block. Every leaf of at most ``MAX_DRAW`` values is drawn whole,
in the order the block's init function asks for it: the same bits as
drawing each layer's tree and stacking the trees.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.optim import tree_leaves, tree_map

# values drawn in one fp32 block (2 GiB): larger leaves are drawn a block
# of leading rows at a time
MAX_DRAW = 1 << 29


def _scale(shape, scale: Optional[float]) -> float:
    """scale, defaulting to fan_in ** -0.5 with fan_in = shape[0] (the
    last dim for a vector), the reference's rule."""
    if scale is not None:
        return scale
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    return fan_in ** -0.5


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
        out = torch.empty(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)
        return self.normal_(out, _scale(shape, scale))

    def normal_(self, out: torch.Tensor, scale: float) -> torch.Tensor:
        """Fill ``out`` with N(0, scale^2) drawn in fp32 and rounded to
        its dtype: whole, or past ``MAX_DRAW`` values a block of leading
        rows at a time."""
        rows = out.shape[0] if out.dim() > 1 else 1
        per_row = out.numel() // max(rows, 1)
        block = rows if out.numel() <= MAX_DRAW else max(1,
                                                         MAX_DRAW // per_row)
        flat = out if out.dim() > 1 else out[None]
        for r in range(0, rows, block):
            v = torch.randn(tuple(flat[r:r + block].shape),
                            generator=self.generator, dtype=torch.float32,
                            device=self.device)
            flat[r:r + block].copy_(v.mul_(scale))
        return out

    def zeros(self, shape, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)

    def const(self, value: torch.Tensor, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
        """``value`` (computed by the caller, as the reference's
        ``Builder.const`` takes it) in ``dtype`` on the params' device."""
        return value.to(dtype=dtype or self.dtype, device=self.device)


@dataclass(frozen=True)
class Leaf:
    """A leaf that ``init_stacked`` has yet to fill."""
    shape: tuple
    dtype: torch.dtype
    kind: str                      # "normal" | "zeros" | "ones" | "const"
    scale: Optional[float] = None
    value: Optional[torch.Tensor] = None   # a "const" leaf's value


class _Shapes:
    """Stands in for a ``Builder`` to record one block's leaves, in the
    order its init function asks for them, without drawing."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def normal(self, shape, scale=None, dtype=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "normal",
                    _scale(shape, scale))

    def zeros(self, shape, dtype=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "zeros")

    def ones(self, shape, dtype=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "ones")

    def const(self, value, dtype=None) -> Leaf:
        return Leaf(tuple(value.shape), dtype or self.dtype, "const",
                    value=value)


def init_stacked(b: Builder, make_block: Callable, n: int):
    """``stack_layers([make_block(b) for _ in range(n)])`` with the same
    draws in the same order, but each stacked (n, ...) leaf allocated
    once and filled layer by layer in place."""
    spec = make_block(_Shapes(b.dtype))
    out = tree_map(lambda leaf: torch.empty((n,) + leaf.shape,
                                            dtype=leaf.dtype,
                                            device=b.device), spec)
    pairs = list(zip(tree_leaves(spec), tree_leaves(out)))
    for i in range(n):
        for leaf, dst in pairs:
            if leaf.kind == "normal":
                b.normal_(dst[i], leaf.scale)
            elif leaf.kind == "const":
                dst[i].copy_(leaf.value)
            else:
                dst[i].fill_(1 if leaf.kind == "ones" else 0)
    return out


def stack_layers(trees):
    """Stack per-layer trees (nested dicts of tensors, one structure) along
    a new leading axis: the reference's stacked ``(L, ...)`` layers."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
