"""Parameter factory for the LM trees, the counterpart of the reference's
``Builder`` (``repro/models/params.py``).

The reference's init functions build ``Param(value, spec)`` leaves whose
logical sharding specs feed its mesh. The port's trees are plain nested
dicts of tensors, and each init function passes every leaf's logical
spec to the builder (``spec=``, default replicated); running the same
init code on ``SpecRecorder`` instead of a ``Builder`` draws nothing and
gives the spec tree (``spec_tree``), so the specs come from the code
that makes the values. ``shard_params`` cuts a rank's blocks of a full
tree with ``distributed.sharding.local_block``. Values are drawn from an explicit
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

from repro_torch.distributed import sharding
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
               dtype: Optional[torch.dtype] = None,
               spec: Optional[tuple] = None) -> torch.Tensor:
        """N(0, scale^2), drawn in fp32; scale defaults to fan_in ** -0.5
        with fan_in = shape[0] (the last dim for a vector). ``spec`` (the
        leaf's logical spec) is for ``SpecRecorder``; a builder draws."""
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

    def zeros(self, shape, dtype: Optional[torch.dtype] = None,
              spec: Optional[tuple] = None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape, dtype: Optional[torch.dtype] = None,
             spec: Optional[tuple] = None) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)

    def const(self, value: torch.Tensor, dtype: Optional[torch.dtype] = None,
              spec: Optional[tuple] = None) -> torch.Tensor:
        """``value`` (computed by the caller, as the reference's
        ``Builder.const`` takes it) in ``dtype`` on the params' device."""
        return value.to(dtype=dtype or self.dtype, device=self.device)


@dataclass(frozen=True)
class Leaf:
    """A leaf recorded, not drawn: what ``init_stacked`` has yet to fill,
    or an entry of a spec tree."""
    shape: tuple
    dtype: torch.dtype
    kind: str                      # "normal" | "zeros" | "ones" | "const"
    scale: Optional[float] = None
    value: Optional[torch.Tensor] = None   # a "const" leaf's value
    spec: Optional[tuple] = None   # the logical spec (None: replicated)

    @property
    def logical(self) -> tuple:
        return self.spec if self.spec is not None else (None,) * len(
            self.shape)


class SpecRecorder:
    """Stands in for a ``Builder`` to record an init function's leaves,
    in the order it asks for them, without drawing: one ``Leaf`` a
    leaf."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def normal(self, shape, scale=None, dtype=None, spec=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "normal",
                    _scale(shape, scale), spec=spec)

    def zeros(self, shape, dtype=None, spec=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "zeros", spec=spec)

    def ones(self, shape, dtype=None, spec=None) -> Leaf:
        return Leaf(tuple(shape), dtype or self.dtype, "ones", spec=spec)

    def const(self, value, dtype=None, spec=None) -> Leaf:
        return Leaf(tuple(value.shape), dtype or self.dtype, "const",
                    value=value, spec=spec)


def _stacked(leaf: Leaf, n: int) -> Leaf:
    return Leaf((n,) + leaf.shape, leaf.dtype, leaf.kind, leaf.scale,
                leaf.value, (None,) + leaf.logical)


def init_stacked(b: Builder, make_block: Callable, n: int):
    """``stack_layers([make_block(b) for _ in range(n)])`` with the same
    draws in the same order, but each stacked (n, ...) leaf allocated
    once and filled layer by layer in place. On a ``SpecRecorder``: the
    stacked leaves, recorded."""
    if isinstance(b, SpecRecorder):
        return tree_map(lambda leaf: _stacked(leaf, n), make_block(b))
    spec = make_block(SpecRecorder(b.dtype))
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


def spec_tree(recorded) -> dict:
    """The logical spec tree of a tree of recorded leaves (an init
    function run on ``SpecRecorder``)."""
    return tree_map(lambda leaf: leaf.logical, recorded)


def shard_params(params, cfg, mesh):
    """This rank's blocks of the full LM ``params`` of ``cfg`` on
    ``mesh`` (``sharding.local_block`` of each leaf under its logical
    spec, ``api.param_specs(cfg)``: copies); ``params`` itself without a
    mesh."""
    if mesh is None:
        return params
    # models.api imports this module
    from repro_torch.models import api
    return tree_map(lambda x, spec: sharding.local_block(
        x, mesh, sharding.resolve(mesh, spec)), params,
        api.param_specs(cfg))
