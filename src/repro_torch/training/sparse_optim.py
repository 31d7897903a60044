"""Row-wise sparse optimizer for the embedding arena.

A ragged batch with an N-position index stream touches at most N of the
arena's V rows. The dense training path nevertheless materializes a
(V, D) gradient; this module keeps the update O(N): sum the touched
rows' gradients, apply the row-wise Adagrad rule to those rows only,
scatter back. The sparse update is exact against dense
``optim.rowwise_adagrad``: untouched rows there see g = 0, which adds 0
to the accumulator and 0 to the row.

The shapes stay static as in the reference: ``rows`` is (N,), the sorted
unique touched rows padded with the fill row (``unique_padded``: one
sort). The per-row sum is deterministic: it is the ``sls_grad_table``
segment scatter-add over the positions' unique-row ids into an (N, D)
table, one kernel launch that finds each position's bag itself, adds
each row's positions in ascending order without float atomics and
writes the unused slots' zeros (``index_add_`` on the card would add in
an order that changes from run to run). Nothing here syncs the host.

A table group trains per table: ``group_row_grads`` gives one (rows,
grads) pair a table, one ``sls_grad_table`` call each, and
``group_rowwise_adagrad`` keeps one accumulator a table.

A row-sharded arena trains shard-locally: every rank computes the same
global (rows, row_grads) pair, and ``shard_local_rows`` projects it onto
the rank's block, the rows it does not own (and the null row) sent to
local row 0 with a zero gradient, which row-wise Adagrad leaves exactly
as it was.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import sparse_engine as se
from repro_torch.kernels import ops


class SparseOptimizer(NamedTuple):
    """Like optim.Optimizer but updates (rows, row_grads) slices.

    init(arena) -> state
    update(arena, state, rows, row_grads) -> (new_arena, new_state)
    """
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Any]


def unique_padded(keys: torch.Tensor, fill: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(keys, size=N, fill_value=fill, return_inverse=True)``
    with no host sync: (rows (N,), the sorted unique keys then `fill`;
    inv (N,) int64, each key's index in rows)."""
    n = keys.shape[0]
    sorted_keys, order = torch.sort(keys, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    uid = torch.cumsum(start, dim=0) - 1
    inv = torch.empty_like(uid).scatter_(0, order, uid)
    # every write to one slot carries the same key, so the result does
    # not depend on which write lands
    rows = torch.full((n,), fill, dtype=keys.dtype,
                      device=keys.device).scatter_(0, uid, sorted_keys)
    return rows, inv


def ragged_row_grads(d_bags: torch.Tensor, indices: torch.Tensor,
                     offsets: torch.Tensor, *,
                     fill_row: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upstream bag gradients -> (touched rows, per-row gradients).

    d_bags (B, D): d loss / d bag-sum; indices (N,) int32 destination rows
    (padded tail allowed); offsets (B+1,) int32. Returns rows (N,) int32
    and grads (N, D) f32 where grads[i] is the summed gradient of row
    rows[i]; unused slots hold `fill_row` and a zero gradient. Pass the
    arena null row as `fill_row`: its gradient is forced to zero even when
    indices target it validly, since the null row is an engine sentinel,
    never a trainable parameter. Duplicate indices within and across bags
    are summed.
    """
    n = indices.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=indices.device)
    key = torch.where(pos < offsets[-1], indices, fill_row)
    rows, inv = unique_padded(key, fill_row)
    # segment_sum(per_pos, inv) of the reference: the same scatter-add,
    # with the same mask on positions past offsets[-1]
    grads = ops.sls_grad_table(d_bags.float().contiguous(),
                               inv.to(torch.int32), offsets, n_rows=n)
    grads = torch.where((rows == fill_row)[:, None], 0.0, grads)
    return rows.to(torch.int32), grads


def source_row_grads(spec: se.ArenaSpec, d_bags: torch.Tensor,
                     indices: torch.Tensor, offsets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row gradients of ``lookup_bags(FpArena(arena), spec, ...)`` w.r.t.
    the arena, restricted to the touched rows: the same gradient the
    autograd backward scatters into a dense (V, D) table, as the
    O(index-stream) pair (rows, row_grads). `indices`/`offsets` are the
    per-table ragged batch exactly as passed to ``lookup_bags``."""
    flat = se.flatten_ragged_indices(spec, indices, offsets)
    return ragged_row_grads(d_bags, flat, offsets, fill_row=spec.null_row)


def group_row_grads(specs, d_bags: torch.Tensor, indices: torch.Tensor,
                    offsets: torch.Tensor, *, max_l: Optional[int] = None
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-table row gradients of a ``TableGroupSource`` lookup.

    `specs` are the group's per-table ArenaSpecs, `d_bags` (n_bags, dmax)
    d loss / d padded bag output, `indices`/`offsets` the interleaved
    ragged batch as passed to ``lookup_bags``. Returns one (rows, grads
    (rows.shape + (dim_t,))) pair a table: table t's touched rows in its
    own arena and their summed gradients (only the leading dim_t lanes of
    `d_bags` reach table t). Fill slots go to table t's null row, whose
    gradient ``ragged_row_grads`` forces to zero.

    With ``max_l`` (the lookup's bound) the stream is relayouted once and
    each table walks only its own (B, max_l) slice: rows are (B*max_l,) a
    table. Without it each table walks the whole N-position stream (rows
    (N,) a table).
    """
    t_count = len(specs)
    if max_l is None:
        table, valid = se.ragged_position_tables(offsets, indices.shape[0],
                                                 t_count)
        out = []
        for t, sp in enumerate(specs):
            idx_t = torch.where(valid & (table == t), indices, sp.null_row)
            out.append(ragged_row_grads(d_bags[:, :sp.dim], idx_t, offsets,
                                        fill_row=sp.null_row))
        return out
    n_bags = offsets.shape[0] - 1
    b = n_bags // t_count
    dense = se.ragged_dense_ids(indices, offsets, max_l=max_l, fill=-1)
    dense = dense.reshape(b, t_count, max_l)
    uni = torch.arange(b + 1, dtype=torch.int32,
                       device=offsets.device) * max_l
    out = []
    for t, sp in enumerate(specs):
        ids_t = torch.where(dense[:, t, :] >= 0, dense[:, t, :],
                            sp.null_row)
        # bag (s, t) sits at row s * t_count + t of the interleaved batch
        out.append(ragged_row_grads(d_bags[t::t_count, :sp.dim],
                                    ids_t.reshape(-1), uni,
                                    fill_row=sp.null_row))
    return out


def group_rowwise_adagrad(lr: float, eps: float = 1e-8) -> SparseOptimizer:
    """``sparse_rowwise_adagrad`` over a tuple of per-table arenas: one
    accumulator a table, each updated from its (rows_t, grads_t) pair of
    ``group_row_grads``; in place, as the single-arena optimizer."""
    leaf = sparse_rowwise_adagrad(lr, eps)

    def init(arenas):
        return tuple(leaf.init(a) for a in arenas)

    def update(arenas, states, per_table):
        new_arenas, new_states = [], []
        for a, s, (rows, grads) in zip(arenas, states, per_table):
            na, ns = leaf.update(a, s, rows, grads)
            new_arenas.append(na)
            new_states.append(ns)
        return tuple(new_arenas), tuple(new_states)

    return SparseOptimizer(init, update)


def shard_local_rows(rows: torch.Tensor, row_grads: torch.Tensor, *, lo: int,
                     vlocal: int, null_row: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project a global (rows, row_grads) update onto one arena
    row-shard: ``lo`` is the first global row the shard owns, ``vlocal``
    its row count. Rows the shard does not own, and the null row, whose
    always-zero invariant must survive training, are redirected to local
    row 0 with a zero gradient: under ``sparse_rowwise_adagrad`` a zero
    gradient adds zero to the accumulator and a zero delta to the row, an
    exact no-op. Each shard so applies the updates of the rows it owns
    and nothing else; the union over shards is the replicated update."""
    rel = rows - lo
    own = (rel >= 0) & (rel < vlocal) & (rows != null_row)
    local = torch.where(own, rel, 0).to(torch.int32)
    grads = torch.where(own[:, None], row_grads, 0.0)
    return local, grads


def sparse_rowwise_adagrad(lr: float, eps: float = 1e-8) -> SparseOptimizer:
    """Row-wise Adagrad over touched rows only (state: one scalar per row).

    Matches optim.rowwise_adagrad exactly on the touched rows and leaves
    the rest of the arena and accumulator untouched. ``update`` works in
    place on the arena and the accumulator and returns them. `rows` are
    unique apart from fill duplicates whose gradients are zero, so each
    real row is added to once and the fill row only ever receives
    zeros: the in-place scatter-adds are deterministic.
    """
    def init(arena):
        return {"acc": torch.zeros(arena.shape[:-1] + (1,),
                                   dtype=torch.float32, device=arena.device),
                "step": 0}

    @torch.no_grad()
    def update(arena, state, rows, row_grads):
        g32 = row_grads.float()                          # (N, D)
        acc = state["acc"].index_add_(
            0, rows, g32.square().mean(dim=-1, keepdim=True))
        delta = -lr * g32 / (torch.sqrt(acc[rows]) + eps)
        arena.index_add_(0, rows, delta.to(arena.dtype))
        return arena, {"acc": acc, "step": state["step"] + 1}

    return SparseOptimizer(init, update)
