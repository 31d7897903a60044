"""The collectives of the sharded paths, over a ``launch.mesh.Mesh``.

The reference runs its sharded paths inside ``shard_map`` and combines
with ``psum``, ``all_gather`` and ``all_to_all``; here every rank is a
process and the combines are ``torch.distributed`` calls on the groups of
the mesh axes named (one name, or a tuple of names):

* ``psum``: the one collective of a sharded lookup, an ``all_reduce(SUM)``
  of the reduced (n_bags, D) partials. Its backward is the identity on
  the (replicated) cotangent, the transpose of ``psum`` into a
  replicated output under ``shard_map``. (``torch.distributed.nn``'s
  all_reduce all-reduces the cotangent too, which would hand every
  shard N times its gradient.)
* ``replicated``: the identity whose backward is that all-reduce: a
  tensor every rank of the axes holds alike (an arena block replicated
  over the data axes) whose uses on the ranks are each a part of the
  work, so its gradient is the sum of theirs (the transpose of a
  ``shard_map`` input replicated over those axes).
* ``pmean_``: the MLP gradients of the sharded sparse step, all-reduced
  and divided by N in place, as one flat buffer.
* ``all_gather``: the ranks' equal-shaped blocks concatenated along a
  dimension, in the order of their index on the axes (the reference's
  tiled ``all_gather``); its backward hands each rank its own slice of
  the (replicated) cotangent.
* ``gather_rows`` / ``gather_blocks`` / ``all_gather``: what other ranks
  hold, each piece brought from its owner by ``broadcast`` (one a rank),
  never by an all-reduce of zero-filled buffers: a sum with +0.0 turns a
  -0.0 element into +0.0, and copies must equal their source bit for bit.
* ``gather_seq`` / ``scatter_seq``: the sequence-parallel pair of the
  LM's blocks on a mesh. ``gather_seq`` all-gathers the ranks' chunks of
  S over an axis; its backward is a reduce-scatter, since each rank's
  cotangent of the whole sequence is a part of the sum (its heads', its
  FFN columns'). ``scatter_seq`` reduce-scatters partial sums along S
  (every rank's whole-sequence partial, summed, each rank keeping its
  chunk); its backward is an all-gather. The reduce-scatter is an
  all-reduce and a slice: every rank of the axis sums the same bits in
  the same order, and gloo has no reduce-scatter;
* ``pmax``: the maximum over an axis (the vocab-parallel loss' shift),
  no gradient;
* ``all_to_all``: the MoE's dispatch and return, chunk j of dim 0 to
  rank j of the axis (``all_to_all_single``; its backward is the same
  exchange of the cotangent). Gloo moves CUDA tensors only for
  ``broadcast`` and ``all_reduce``, so over gloo the exchange runs on an
  explicit host copy; over nccl on the card. The backend is the one the
  caller joined with: this is dispatch, nothing is tried after a failure.

The same code runs over gloo (ranks sharing a card, or CPU ranks) and
over nccl (a card a rank). Each is the identity on axes of one rank.

A row-sharded arena lives on each rank as its *block*: the rank's
``vlocal`` contiguous rows, then one always-zero sentinel row
(``core.sparse_engine.shard_block``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group(mesh, axis: str):
    return None if mesh is None or mesh.size(axis) == 1 \
        else mesh.group(axis)


def _groups(mesh, axes: Axes) -> list:
    """The process groups of the named axes that have more than one
    rank, in the order named."""
    return [g for g in (_group(mesh, a) for a in _axes(axes))
            if g is not None]


def _global_rank(mesh, axis: str, r: int) -> int:
    return dist.get_global_rank(mesh.group(axis), r)


def axes_size(mesh, axes: Axes) -> int:
    """Ranks across the named axes (1 without a mesh)."""
    n = 1
    if mesh is not None:
        for a in _axes(axes):
            n *= mesh.size(a)
    return n


def axes_index(mesh, axes: Axes) -> int:
    """This rank's index across the named axes, row-major in the order
    named (the block a tiled ``all_gather`` over them puts it at)."""
    i = 0
    if mesh is not None:
        for a in _axes(axes):
            i = i * mesh.size(a) + mesh.rank(a)
    return i


def _all_reduce(x: torch.Tensor, groups: list) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``x``, added in fp32 and rounded once
    to ``x``'s dtype (a new tensor)."""
    out = _all_reduce(x.to(torch.float32, copy=True).contiguous(), [group])
    return out.to(x.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        # the transpose of psum into a replicated output: every rank
        # already holds the whole cotangent
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.groups), None


def psum(x: torch.Tensor, mesh, axis: Axes = "model") -> torch.Tensor:
    """Sum ``x`` over the mesh axis or axes (every rank gets the same
    bits); differentiable, with the identity as its backward."""
    groups = _groups(mesh, axis)
    if not groups:
        return x
    return _PSum.apply(x, groups)


def replicated(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` as it is, with its gradient summed over the axes: for a
    tensor every rank of ``axes`` holds alike and each uses for its own
    part of the work (the transpose of a ``shard_map`` input replicated
    over them). The identity on axes of one rank."""
    groups = _groups(mesh, axes)
    if not groups or not x.requires_grad:
        return x
    return _Replicated.apply(x, groups)


@torch.no_grad()
def pmean_(tensors: List[torch.Tensor], mesh, axis: Axes = "model") -> None:
    """Replace each tensor by its mean over the mesh axis or axes, in
    place: one all-reduce an axis of the tensors packed into one flat
    float32 buffer."""
    groups = _groups(mesh, axis)
    if not groups or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    _all_reduce(flat, groups)
    flat /= axes_size(mesh, axis)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view(t.shape))
        i += n


def pmean(x: torch.Tensor, mesh, axis: Axes = "model") -> torch.Tensor:
    """The mean of ``x`` over the mesh axis or axes (``psum`` / N)."""
    return psum(x, mesh, axis) / axes_size(mesh, axis)


@torch.no_grad()
def _gather_one(x: torch.Tensor, mesh, axis: str, dim: int,
                sizes: Sequence[int] = None) -> torch.Tensor:
    """The ranks' blocks along ``dim`` concatenated in order of their
    index on ``axis``, each broadcast by its owner: rank r's block has
    ``sizes[r]`` along ``dim`` (equal to this rank's by default), and a
    block of size 0 is skipped."""
    me = mesh.rank(axis)
    if sizes is None:
        sizes = [x.shape[dim]] * mesh.size(axis)
    x = x.contiguous()
    parts = []
    for r, size in enumerate(sizes):
        if size == 0:
            continue
        if r == me:
            buf = x.clone()
        else:
            shape = list(x.shape)
            shape[dim] = size
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.broadcast(buf, src=_global_rank(mesh, axis, r),
                       group=mesh.group(axis))
        parts.append(buf)
    return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.size = mesh, axes, dim, x.shape[dim]
        out = x
        # the last axis named varies fastest: gather over it first
        for a in reversed(axes):
            out = _gather_one(out, mesh, a, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        i = axes_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks ``x`` (equal shapes) concatenated along ``dim``
    in the order of their index across ``axes`` (row-major in the order
    named), on every rank: each block broadcast by its owner, so the bits
    are the owner's. Differentiable: the backward hands each rank its own
    slice of the cotangent, which every rank holds whole. Collective over
    the axes; the identity on axes of one rank."""
    axes = tuple(a for a in _axes(axes)
                 if mesh is not None and mesh.size(a) > 1)
    if not axes:
        return x
    dim = dim % x.dim()
    return _AllGather.apply(x, mesh, axes, dim)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return _gather_one(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent of the whole sequence is a part: sum
        # them, each rank keeping its own chunk
        g = _sum_f32(g, ctx.mesh.group(ctx.axis))
        i = ctx.mesh.rank(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        n = mesh.size(axis)
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        size = x.shape[dim] // n
        x = _sum_f32(x, mesh.group(axis))
        return x.narrow(dim, mesh.rank(axis) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_one(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
               ) -> torch.Tensor:
    """The ranks' equal chunks of a sequence (``dim``) concatenated in
    order of their index on ``axis``, on every rank (each chunk
    broadcast by its owner). Its backward sums the ranks' cotangents and
    hands each rank its chunk (a reduce-scatter). The identity on an axis
    of one rank."""
    if _group(mesh, axis) is None:
        return x
    return _GatherSeq.apply(x, mesh, axis, dim % x.dim())


def scatter_seq(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1
                ) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x``, of which each
    rank keeps its chunk along ``dim`` (a reduce-scatter: an all-reduce,
    so every rank sums in the same order, then a slice), added in fp32
    and rounded once to ``x``'s dtype. ``dim`` must divide over the
    axis. Its backward all-gathers the chunks'
    cotangents. The identity on an axis of one rank."""
    if _group(mesh, axis) is None:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % mesh.size(axis):
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over {mesh.size(axis)} ranks of {axis!r}")
    return _ScatterSeq.apply(x, mesh, axis, dim)


@torch.no_grad()
def pmax(x: torch.Tensor, mesh, axis: Axes = "model") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the axes (no gradient)."""
    out = x.detach().contiguous().clone()
    for g in _groups(mesh, axis):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    return out


def _exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    group = mesh.group(axis)
    x = x.contiguous()
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        host = x.to("cpu")
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # chunk j went to rank j's chunk me: the cotangent comes back by
        # the same exchange
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """(n, ...) -> (n, ...): chunk j of ``x``'s dim 0 goes to rank j of
    the axis, and chunk i of the result is what rank i sent this rank
    (the reference's tiled ``all_to_all`` with split and concat on dim
    0). Over gloo a CUDA tensor is exchanged through a host copy.
    Differentiable. The identity on an axis of one rank."""
    if _group(mesh, axis) is None:
        return x
    if x.shape[0] != mesh.size(axis):
        raise ValueError(f"all_to_all over {mesh.size(axis)} ranks of "
                         f"{axis!r}: dim 0 is {x.shape[0]}")
    return _AllToAll.apply(x, mesh, axis)


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
