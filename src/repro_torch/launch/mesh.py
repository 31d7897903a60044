"""Meshes over ``torch.distributed``: the port's counterpart of a JAX mesh.

A JAX mesh names the devices of one SPMD program and ``shard_map`` hands
each its block. The port runs one process a rank (SPMD): a ``Mesh`` is a
small frozen object that maps each axis name to (process group, this
rank's index on the axis, the axis' size). Every ``mesh=`` argument of the
port takes one, so call sites read like the reference's.

Only the one-dimensional ``"model"`` row axis is ported, which is what the
reference's ``--shards N`` builds: ``make_mesh((n,), ("model",))``. A
two-dimensional (data, model) mesh and ``make_production_mesh`` (256 and
512 TPU chips) are ROADMAP Queue 1, item 13b.

``make_mesh`` does not start processes: the caller has already joined the
process group (``repro_torch.distributed.spawn`` starts N ranks and
joins them, with the backend the caller names). A mesh of one rank needs
no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

@dataclass(frozen=True)
class Mesh:
    """Axis name -> (process group, this rank's index, the axis' size),
    as one tuple an axis. ``group`` is ``None`` on a one-rank axis with
    no process group."""
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
        """The backend of the first axis' group (None without one)."""
        g = self.axes[0][1]
        return None if g is None else dist.get_backend(g)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The one-dimensional ``(n,)`` mesh over ``("model",)``: every rank
    of the joined process group, in rank order (each rank chose its
    device when it joined). ``n`` must be the world size; ``n == 1``
    needs no process group."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != 1 or axes != ("model",):
        raise NotImplementedError(
            f"mesh {shape} over {axes}: only the one-dimensional 'model' "
            "row axis is ported; other axes and a (data, model) mesh are "
            "ROADMAP Queue 1, item 13b")
    n = int(shape[0])
    if n < 1:
        raise ValueError(f"mesh size {n}")
    if not dist.is_available() or not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs torch.distributed joined on "
                f"each of them (repro_torch.distributed.spawn)")
        return Mesh(((axes[0], None, 0, 1),))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh of {n} ranks in a process group of "
                         f"{world}")
    return Mesh(((axes[0], dist.group.WORLD, dist.get_rank(), n),))

