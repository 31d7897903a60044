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

**The LM's heads.** The reference splits a flat ``heads * head_dim``
dimension evenly and lets GSPMD pad and regroup the heads
(``head_constrain``). The port splits by whole heads: a spec entry
``Heads(n_heads, n_kv_heads, head_dim, kind)`` names a q or kv
projection's dimension, and ``resolve`` turns it into ``Blocks(axis,
sizes)`` (each rank's share along the dimension, in order of its index on
the axis) by ``head_split``'s rule, or into None where the kv heads are
replicated. ``local_block`` cuts ``Blocks`` as it cuts an even split, and
``gather_full`` puts the blocks of any resolved spec back together.

**The layout points.** The reference constrains activations and GSPMD
inserts the collectives; the port calls them where the reference's call
sites constrain (``repro/models/transformer.py``), against the active
mesh (identities without one, or on a 'model' axis of one rank):

* ``gather_seq``: ``constrain(x, "batch", None, None)`` of the
  sequence-parallel stream, the all-gather of S at a block's entry;
* ``scatter_seq``: ``constrain(y, "batch", "model", None)`` of a
  block's partial output, the reduce-scatter back onto S;
* ``psum_model``: the row-parallel end of a decode step, whose stream
  stays replicated over 'model' (``transformer.py:422``);
* ``last_position``: prefill's last position, from the last rank's chunk.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives

_ACTIVE_MESH = None

MODEL_AXES = ("model", "expert", "vocab", "heads", "ff")


class Sharding(NamedTuple):
    """A spec on its mesh: the port's form of a ``NamedSharding``."""
    mesh: Any
    spec: Tuple


class Heads(NamedTuple):
    """A logical spec entry: a dimension of ``n_heads * head_dim`` (kind
    "q") or ``n_kv_heads * head_dim`` (kind "kv") split over 'model' by
    whole heads (``head_split``)."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str


class Blocks(NamedTuple):
    """A resolved spec entry: a dimension cut over ``axis`` in blocks of
    ``sizes`` (one a rank of the axis, in order of its index), which may
    differ and may be 0."""
    axis: str
    sizes: Tuple[int, ...]


def _even(n: int, parts: int) -> list:
    """n split into ``parts`` contiguous shares, the first n % parts one
    larger."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def head_split(n_heads: int, n_kv_heads: int, tp: int
               ) -> Tuple[Tuple[int, int, int, int], ...]:
    """Each 'model' rank's heads, ``(q0, q1, k0, k1)``: query heads
    [q0, q1) on kv heads [k0, k1), for ``tp`` ranks; query head i reads kv
    head i // (n_heads / n_kv_heads).

    * ``n_kv_heads >= tp``: the kv heads are split into ``tp`` contiguous
      groups (sizes differing by at most one) and each rank takes the
      query heads of its kv heads: smollm-360m's 15 / 5 at 2 ranks gives
      9 / 6 query heads on 3 / 2 kv heads.
    * ``n_kv_heads < tp``: each rank reads one kv head, the ranks split
      over the kv heads in contiguous groups (sizes differing by at most
      one), and each kv head's query heads split over its ranks the same
      way, so a rank may hold no query head (smollm at 16 ranks: 4 ranks
      on kv head 0 for its 3 query heads). The kv projections are then
      replicated over 'model' (``resolve`` gives None), the reference's
      rule where the kv heads divide the ranks (``head_constrain``:
      smollm's smoke config, 1 kv head under 2 ranks)."""
    if n_heads % n_kv_heads:
        raise ValueError(f"{n_heads} query heads on {n_kv_heads} kv heads")
    g = n_heads // n_kv_heads
    out = []
    if n_kv_heads >= tp:
        k0 = 0
        for nk in _even(n_kv_heads, tp):
            out.append((k0 * g, (k0 + nk) * g, k0, k0 + nk))
            k0 += nk
        return tuple(out)
    for kv, ranks in enumerate(_even(tp, n_kv_heads)):
        q0 = kv * g
        for nq in _even(g, ranks):
            out.append((q0, q0 + nq, kv, kv + 1))
            q0 += nq
    return tuple(out)


def kv_replicated(n_kv_heads: int, tp: int) -> bool:
    """Whether ``head_split`` replicates the kv projections over 'model'
    (fewer kv heads than ranks)."""
    return n_kv_heads < tp


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


def _tp(mesh) -> int:
    return mesh.size("model") if "model" in mesh.axis_names else 1


def _resolve_heads(mesh, h: Heads):
    tp = _tp(mesh)
    if tp == 1 or (h.kind == "kv" and kv_replicated(h.n_kv_heads, tp)):
        return None
    split = head_split(h.n_heads, h.n_kv_heads, tp)
    lo, hi = (0, 1) if h.kind == "q" else (2, 3)
    return Blocks("model", tuple((r[hi] - r[lo]) * h.head_dim
                                 for r in split))


def resolve(mesh, logical: Sequence[Optional[str]]) -> Tuple:
    """Map a tuple of logical axis names to the mesh's spec entries (a
    ``Heads`` entry to ``Blocks`` or None, module docstring)."""
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
        elif isinstance(ax, Heads):
            out.append(_resolve_heads(mesh, ax))
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


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a resolved spec entry names."""
    if entry is None:
        return ()
    if isinstance(entry, Blocks):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _cuts(mesh, entry, length: int, what) -> Optional[list]:
    """(offset, size) of each rank of the entry's axes along a dimension
    of ``length`` (index across the axes, row-major), or None where the
    dimension is whole on every rank."""
    axes = tuple(a for a in entry_axes(entry) if a in mesh.axis_names)
    n = collectives.axes_size(mesh, axes)
    if n == 1:
        return None
    if isinstance(entry, Blocks):
        sizes = list(entry.sizes)
        if len(sizes) != n or sum(sizes) != length:
            raise ValueError(f"blocks {entry.sizes} do not cut a dimension "
                             f"of {length} over {n} ranks ({what})")
    else:
        if length % n:
            raise ValueError(f"dimension of {length} in {what} does not "
                             f"divide over {axes} ({n} ranks)")
        sizes = [length // n] * n
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return [(int(o), int(s)) for o, s in zip(offsets, sizes)]


def _index(mesh, entry) -> int:
    axes = tuple(a for a in entry_axes(entry) if a in mesh.axis_names)
    return collectives.axes_index(mesh, axes)


def local_block(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (one
    entry a leading dimension of ``x``: None, an axis name, a tuple of
    names or ``Blocks``; missing trailing entries are None): along each
    sharded dimension the slice at the rank's index across the entry's
    axes, row-major in the order named. Every evenly sharded dimension
    must divide. Returns a tensor of its own (a copy), so the full one
    can be freed; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    out = x
    for dim, entry in enumerate(tuple(spec)):
        cuts = _cuts(mesh, entry, out.shape[dim], tuple(x.shape))
        if cuts is None:
            continue
        off, size = cuts[_index(mesh, entry)]
        out = out.narrow(dim, off, size)
    return out.clone() if out is not x else x


@torch.no_grad()
def gather_full(block: torch.Tensor, mesh, spec: Sequence,
                shape: Sequence[int]) -> torch.Tensor:
    """The full tensor of ``shape`` whose block under the resolved
    ``spec`` this rank holds, assembled on every rank of the spec's axes:
    each block broadcast by its owner, so the bits are the owners'.
    Collective over the axes of the sharded dimensions; ``block`` itself
    where none is sharded."""
    out = block
    for dim, entry in enumerate(tuple(spec)):
        cuts = _cuts(mesh, entry, shape[dim], tuple(shape))
        if cuts is None:
            continue
        if isinstance(entry, Blocks):
            out = collectives._gather_one(out, mesh, entry.axis, dim,
                                          [s for _, s in cuts])
            continue
        # row-major over the axes named: the last varies fastest, so it
        # is gathered first
        for a in reversed(entry_axes(entry)):
            if a in mesh.axis_names and mesh.size(a) > 1:
                out = collectives._gather_one(out, mesh, a, dim)
    return out


def place_row_sharded(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """This rank's rows of ``x`` row-sharded over ``axis`` (identity with
    no mesh or no such axis). The row count must divide the axis
    (``ArenaSpec.padded_rows`` guarantees it). A DLRM arena block also
    carries a zero sentinel row: ``core.sparse_engine.shard_block``."""
    if mesh is None or axis not in mesh.axis_names:
        return x
    return local_block(x, mesh, (axis,))


def _is_entry(v) -> bool:
    return (v is None or isinstance(v, (str, Heads, Blocks))
            or (type(v) is tuple and all(isinstance(a, str) for a in v)))


def _is_spec(x) -> bool:
    """A logical or resolved spec: a plain tuple of entries."""
    return type(x) is tuple and all(_is_entry(v) for v in x)


def map_specs(fn, tree):
    """``fn`` of each spec (a tuple of entries) of a tree of specs."""
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


def spec_tree_to_shardings(mesh, spec_tree):
    """Map a tree of logical tuples to ``Sharding``s (``None`` each
    without a mesh)."""
    if mesh is None:
        return map_specs(lambda _: None, spec_tree)
    return map_specs(lambda logical: Sharding(mesh, resolve(mesh, logical)),
                      spec_tree)


# ---------------------------------------------------------------------------
# The layout points of the LM's blocks (module docstring)
# ---------------------------------------------------------------------------

def model_mesh():
    """The active mesh when its 'model' axis has more than one rank, else
    None: where the LM's tensor- and sequence-parallel layout applies."""
    mesh = _ACTIVE_MESH
    if mesh is None or _tp(mesh) == 1:
        return None
    return mesh


def tp_size(mesh=None) -> int:
    """Ranks on the 'model' axis of ``mesh`` (default: the active mesh);
    1 without one."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    return 1 if mesh is None else _tp(mesh)


def tp_rank(mesh=None) -> int:
    mesh = _ACTIVE_MESH if mesh is None else mesh
    return 0 if mesh is None or _tp(mesh) == 1 else mesh.rank("model")


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """``constrain(x, "batch", None, None)`` of the S-sharded stream: the
    ranks' chunks of S all-gathered over 'model' (backward: a
    reduce-scatter)."""
    mesh = model_mesh()
    return x if mesh is None else collectives.gather_seq(x, mesh)


def last_position(x: torch.Tensor) -> torch.Tensor:
    """The last position ``x[:, -1:]`` of the S-sharded stream on every
    rank: the last rank's chunk holds it, so each rank's last row is
    gathered over 'model' and the last one kept (the stream itself is
    never gathered)."""
    mesh = model_mesh()
    if mesh is None:
        return x[:, -1:]
    return collectives.all_gather(x[:, -1:], mesh, "model", dim=1)[:, -1:]


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """``constrain(y, "batch", "model", None)`` of a block's partial
    output: summed over 'model', each rank keeping its chunk of S
    (backward: an all-gather)."""
    mesh = model_mesh()
    return x if mesh is None else collectives.scatter_seq(x, mesh)


def psum_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums added over 'model' into a
    replicated result (the decode step's ends), in fp32 and rounded once
    to ``x``'s dtype, as ``scatter_seq`` adds."""
    mesh = model_mesh()
    if mesh is None:
        return x
    return collectives.psum(x.float(), mesh, "model").to(x.dtype)
