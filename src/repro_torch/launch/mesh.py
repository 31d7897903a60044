"""Meshes over ``torch.distributed``: the port's counterpart of a JAX mesh.

A JAX mesh names the devices of one SPMD program and ``shard_map`` hands
each its block. The port runs one process a rank (SPMD): a ``Mesh`` is a
small frozen object that maps each axis name to (process group, this
rank's index on the axis, the axis' size). Every ``mesh=`` argument of the
port takes one, so call sites read like the reference's.

``make_mesh(shape, axes)`` lays the joined ranks out row-major, as
``jax.make_mesh`` lays out devices: rank r sits at
``np.unravel_index(r, shape)``, and an axis' process group is the ranks
that share every other index, in order of their index on the axis. The
reference's ``--shards N`` builds ``make_mesh((n,), ("model",))``, its
multi-device tests ``make_mesh((2, 4), ("data", "model"))``;
``make_production_mesh`` builds the reference's (16, 16) pod and (2, 16,
16) multi-pod meshes, and refuses a process group of fewer ranks.

``make_mesh`` does not start processes: the caller has already joined the
process group (``repro_torch.distributed.spawn`` starts N ranks and
joins them, with the backend the caller names). A mesh of one rank needs
no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """Axis name -> (process group, this rank's index, the axis' size),
    as one tuple an axis, in the mesh's axis order. ``group`` is ``None``
    on an axis of one rank, and on a mesh built without a process
    group."""
    axes: Tuple[Tuple[str, Optional[object], int, int], ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a[0] for a in self.axes)

    @property
    def shape(self) -> dict:
        return {a[0]: a[3] for a in self.axes}

    def _axis(self, axis: str):
        for a in self.axes:
            if a[0] == axis:
                return a
        raise KeyError(f"mesh has no axis {axis!r} ({self.axis_names})")

    def group(self, axis: str = "model"):
        return self._axis(axis)[1]

    def rank(self, axis: str = "model") -> int:
        return self._axis(axis)[2]

    def size(self, axis: str = "model") -> int:
        return self._axis(axis)[3]

    @property
    def backend(self) -> Optional[str]:
        """The backend of the first axis' group with one (None without
        one)."""
        for a in self.axes:
            if a[1] is not None:
                return dist.get_backend(a[1])
        return None


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the axis names ``axes`` whose product is
    the world size of the joined process group, ranks laid out row-major
    (rank r at ``np.unravel_index(r, shape)``). Each axis of more than one
    rank gets its own process group (the whole world when the axis spans
    it), created on every rank in the same order: every rank of the world
    must call this with the same arguments. A product of 1 needs no
    process group."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or not shape:
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape}")
    n = int(np.prod(shape))
    if not dist.is_available() or not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs torch.distributed joined on "
                f"each of them (repro_torch.distributed.spawn)")
        return Mesh(tuple((a, None, 0, 1) for a in axes))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {shape} of {n} ranks in a process group of "
                         f"{world}")
    me = np.unravel_index(dist.get_rank(), shape)
    grid = np.arange(n).reshape(shape)
    out = []
    for i, (name, size) in enumerate(zip(axes, shape)):
        group = None
        if size == n:
            group = dist.group.WORLD
        elif size > 1:
            # one group for each line of the grid along axis i; every
            # rank creates all of them, in the same order
            lines = np.moveaxis(grid, i, -1).reshape(-1, size)
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if dist.get_rank() in line:
                    group = g
        out.append((name, group, int(me[i]), size))
    return Mesh(tuple(out))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model"), over a joined
    process group of that many ranks. With fewer (or none joined, which
    is one rank) it raises ``RuntimeError``, as the reference does with
    fewer devices; a larger group is refused too (ranks outside the mesh
    would join none of its collectives)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {have}: start "
            f"{n} ranks joined over torch.distributed (one a card)")
    if have != n:
        raise RuntimeError(
            f"the production mesh takes {n} ranks, the process group holds "
            f"{have}")
    return make_mesh(shape, axes)
