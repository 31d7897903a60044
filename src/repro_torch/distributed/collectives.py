"""The collectives of the row-sharded path, over a ``launch.mesh.Mesh``.

The reference runs its sharded path inside ``shard_map`` and combines
with ``psum``; here every rank is a process and the combines are
``torch.distributed`` calls on the mesh axis' group:

* ``psum``: the one collective of a sharded lookup, an ``all_reduce(SUM)``
  of the reduced (n_bags, D) partials. Its backward is the identity on
  the (replicated) cotangent, the transpose of ``psum`` into a
  replicated output under ``shard_map``. (``torch.distributed.nn``'s
  all_reduce all-reduces the cotangent too, which would hand every
  shard N times its gradient.)
* ``pmean_``: the MLP gradients of the sharded sparse step, all-reduced
  and divided by N in place, as one flat buffer.
* ``gather_rows`` / ``gather_blocks``: rows that other ranks own, each
  brought from its owner by ``broadcast`` (one a rank), never by an
  all-reduce of zero-filled buffers: a sum with +0.0 turns a -0.0
  element into +0.0, and hot copies must equal their arena rows bit for
  bit.

Gloo moves CUDA tensors only for ``broadcast`` and ``all_reduce``, so
these are the only two collectives used: the same code runs over gloo
(ranks sharing a card, or CPU ranks) and over nccl (a card a rank).
Each is the identity on an axis of one rank.

A row-sharded arena lives on each rank as its *block*: the rank's
``vlocal`` contiguous rows, then one always-zero sentinel row
(``core.sparse_engine.shard_block``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    return None if mesh is None or mesh.size(axis) == 1 \
        else mesh.group(axis)


def _global_rank(mesh, axis: str, r: int) -> int:
    return dist.get_global_rank(mesh.group(axis), r)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # the transpose of psum into a replicated output: every rank
        # already holds the whole cotangent
        return g, None


def psum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Sum ``x`` over the mesh axis (every rank gets the same bits);
    differentiable, with the identity as its backward."""
    group = _group(mesh, axis)
    if group is None:
        return x
    return _PSum.apply(x, group)


@torch.no_grad()
def pmean_(tensors: List[torch.Tensor], mesh, axis: str = "model") -> None:
    """Replace each tensor by its mean over the mesh axis, in place: one
    all-reduce of the tensors packed into one flat float32 buffer."""
    group = _group(mesh, axis)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= mesh.size(axis)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view(t.shape))
        i += n


@torch.no_grad()
def gather_rows(block: torch.Tensor, rows: torch.Tensor, mesh,
                axis: str = "model") -> torch.Tensor:
    """Rows ``rows`` (global ids, equal on every rank) of a row-sharded
    arena whose block this rank holds: (len(rows), ...) on every rank, in
    ``block``'s dtype. Each owner broadcasts a buffer of all ``rows``
    with its own rows filled and the others read from its zero sentinel;
    every rank keeps the owner's rows, so each row arrives bit for bit.
    An id no rank owns gives a zero row. Collective: every rank of the
    axis calls it with the same ``rows``."""
    vlocal = block.shape[0] - 1
    rows = rows.to(torch.int64)
    n = mesh.size(axis) if mesh is not None else 1
    out = torch.zeros((rows.shape[0],) + tuple(block.shape[1:]),
                      dtype=block.dtype, device=block.device)
    me = mesh.rank(axis) if mesh is not None else 0
    for r in range(n):
        rel = rows - r * vlocal
        own = (rel >= 0) & (rel < vlocal)
        if r == me:
            buf = block[torch.where(own, rel, vlocal)]
        else:
            buf = torch.empty_like(out)
        if n > 1:
            dist.broadcast(buf, src=_global_rank(mesh, axis, r),
                           group=mesh.group(axis))
        own = own.reshape((-1,) + (1,) * (block.dim() - 1))
        out = torch.where(own, buf, out)
    return out


@torch.no_grad()
def gather_blocks(block: torch.Tensor, mesh, axis: str = "model",
                  to_host: bool = True) -> torch.Tensor:
    """The whole row-sharded arena, (n * vlocal, ...) without the
    sentinels, on every rank: each rank's block broadcast by its owner
    (into host memory when ``to_host``, one block at a time).
    Collective."""
    n = mesh.size(axis) if mesh is not None else 1
    me = mesh.rank(axis) if mesh is not None else 0
    parts = []
    for r in range(n):
        buf = block if r == me else torch.empty_like(block)
        if n > 1:
            dist.broadcast(buf, src=_global_rank(mesh, axis, r),
                           group=mesh.group(axis))
        part = buf[:-1]
        parts.append(part.to("cpu", copy=True) if to_host
                     else part.clone())
    return torch.cat(parts)
