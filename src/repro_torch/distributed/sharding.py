"""Logical-axis sharding: one vocabulary, every mesh; the counterpart of
the reference's ``repro/distributed/sharding.py``.

Models name the dimensions of their params and activations by *logical*
axes; ``resolve`` maps them onto the mesh's axes, exactly as the
reference's does:

    'batch'  -> every mesh axis except 'model'  (DP: ('pod','data') or 'data')
    'model', 'expert', 'vocab', 'heads', 'ff' -> 'model'   (TP/EP/vocab rows)
    'fsdp'   -> every mesh axis except 'model'  (param sharding, ZeRO-3 style)
    None     -> replicated

``resolve`` returns the reference's ``PartitionSpec`` entries as a tuple:
one entry a dimension, ``None``, an axis name or a tuple of names. The
reference hands the spec to GSPMD, which places each device's block; in
the port each rank holds its block itself, and ``local_block`` cuts it
out of a full tensor (the block a ``NamedSharding`` of that spec would
put on this rank). ``sharding_for`` and ``spec_tree_to_shardings`` pair a
spec with its mesh (``Sharding``), ``place_row_sharded`` hands a rank its
rows. Under no mesh every helper is an identity, so the same call sites
run on one card and on a mesh.

``use_mesh`` / ``active_mesh`` keep the reference's active-mesh context.
The reference's ``constrain`` (a GSPMD constraint on activations) belongs
to the LM's tensor-parallel layers, which the port does not have yet.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives

_ACTIVE_MESH = None

MODEL_AXES = ("model", "expert", "vocab", "heads", "ff")


class Sharding(NamedTuple):
    """A spec on its mesh: the port's form of a ``NamedSharding``."""
    mesh: Any
    spec: Tuple


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh within the block."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def active_mesh():
    return _ACTIVE_MESH


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _dp(mesh):
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else (ba[0] if ba else None)


def resolve(mesh, logical: Sequence[Optional[str]]) -> Tuple:
    """Map a tuple of logical axis names to the mesh's spec entries."""
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
        elif ax in ("batch", "fsdp"):
            # ZeRO-3 shards over every DP axis (pod AND data on the
            # multi-pod mesh), as the batch does
            out.append(_dp(mesh))
        elif ax in MODEL_AXES:
            out.append("model" if "model" in mesh.axis_names else None)
        else:
            raise ValueError(f"unknown logical axis {ax!r}")
    return tuple(out)


def sharding_for(mesh, logical: Sequence[Optional[str]]
                 ) -> Optional[Sharding]:
    if mesh is None:
        return None
    return Sharding(mesh, resolve(mesh, logical))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (one
    entry a leading dimension of ``x``: None, an axis name or a tuple of
    names; missing trailing entries are None): along each sharded
    dimension the slice at the rank's index across the entry's axes,
    row-major in the order named. Every sharded dimension must divide.
    Returns a tensor of its own (a copy), so the full one can be freed;
    ``x`` itself without a mesh."""
    if mesh is None:
        return x
    out = x
    for dim, entry in enumerate(tuple(spec)):
        axes = tuple(a for a in _entry_axes(entry) if a in mesh.axis_names)
        n = collectives.axes_size(mesh, axes)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                             f"not divide over {axes} ({n} ranks)")
        size = out.shape[dim] // n
        out = out.narrow(dim, collectives.axes_index(mesh, axes) * size,
                         size)
    return out.clone() if out is not x else x


def place_row_sharded(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """This rank's rows of ``x`` row-sharded over ``axis`` (identity with
    no mesh or no such axis). The row count must divide the axis
    (``ArenaSpec.padded_rows`` guarantees it). A DLRM arena block also
    carries a zero sentinel row: ``core.sparse_engine.shard_block``."""
    if mesh is None or axis not in mesh.axis_names:
        return x
    return local_block(x, mesh, (axis,))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(v is None or isinstance(v, str)
                                        for v in x)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


def spec_tree_to_shardings(mesh, spec_tree):
    """Map a tree of logical tuples to ``Sharding``s (``None`` each
    without a mesh)."""
    if mesh is None:
        return _map_specs(lambda _: None, spec_tree)
    return _map_specs(lambda logical: Sharding(mesh, resolve(mesh, logical)),
                      spec_tree)
