"""Fixed-capacity mixture of experts, the counterpart of the reference's
``repro/models/moe.py``.

Each token picks ``top_k`` experts from an fp32 router softmax; its
choices are ranked within their expert in token-major order and the
first ``capacity`` of an expert's choices take its dispatch slots
``expert * C + rank``; the rest go to the drop slot ``E * C`` and add
nothing. The experts run as one batched SwiGLU over the (E, C, d)
dispatch buffer, and each token sums its valid choices' rows, weighted
by its renormalised router probabilities. The shapes are static: every
step runs all E * C expert rows, whatever the routing.

Under a mesh whose ``"model"`` axis has more than one rank, and when the
batch divides the data axes, the sequence the model axis and the experts
the model axis (the reference's exact condition), ``apply_moe`` runs the
reference's expert-parallel path (``_moe_shard``): each rank takes its
(B/dp, S/tp) block of the tokens and flattens it locally, routes in fp32
with the capacity of its own token count, all-gathers its FSDP slice of
the expert weights over the data axes, sends each expert's dispatch rows
to the expert's owner and back by ``all_to_all`` over ``"model"``,
combines at the source, and all-gathers the (B, S, D) result onto every
rank; the load-balance loss is the mean of the ranks' own. Each rank
holds the ``("expert", "fsdp", None)`` block of the expert weights
(``shard_moe_params``). Otherwise the local path runs, as the
reference's does. The LM on a mesh takes two entries of its own:
``apply_moe_chunk``, the same expert-parallel path on a rank's chunk of
the S-sharded stream (the reference hands its shard_map that chunk), and
``apply_moe_decode``, a decode step's tokens routed as one batch over
the data ranks, each rank running its own experts' slots. The expert products are torch ops: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models.params import Builder

# the logical axes of the expert weights, the reference's init_moe's
EXPERT_LOGICAL = ("expert", "fsdp", None)


def init_moe(b: Builder, mcfg: MoEConfig, d: int):
    """Router ``wr`` (d, E) fp32; experts ``wg``/``wu`` (E, d, ff) and
    ``wd`` (E, ff, d) in the builder's dtype. Their scale follows the
    reference's rule, fan_in = shape[0], which is E for the experts."""
    e, ff = mcfg.n_experts, mcfg.expert_ff
    return {"wr": b.normal((d, e), dtype=torch.float32),
            "wg": b.normal((e, d, ff), spec=EXPERT_LOGICAL),
            "wu": b.normal((e, d, ff), spec=EXPERT_LOGICAL),
            "wd": b.normal((e, ff, d), spec=EXPERT_LOGICAL)}


def _capacity(t_local: int, mcfg: MoEConfig) -> int:
    """Slots an expert: t k cf / E rounded up to a multiple of 8, at
    least 8."""
    c = int(math.ceil(t_local * mcfg.top_k * mcfg.capacity_factor
                      / mcfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def _route(xf32: torch.Tensor, wr: torch.Tensor, mcfg: MoEConfig):
    """xf32 (T, d) -> (weights (T, k), idx (T, k), probs (T, E)). Ties
    go to the lower expert index, as ``jax.lax.top_k``'s do (a stable
    descending sort)."""
    probs = torch.softmax(xf32 @ wr, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :mcfg.top_k]
    w = torch.gather(probs, -1, idx)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def _slots(idx: torch.Tensor, n_experts: int, capacity: int):
    """Each choice's dispatch slot, expert * C + its rank among that
    expert's choices in token-major order, or the drop slot E * C past
    capacity -> (slot (T k,), valid (T k,))."""
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = (torch.arange(flat_e.numel(), device=flat_e.device)
                  - starts[flat_e[order]])
    valid = pos < capacity
    slot = torch.where(valid, flat_e * capacity + pos,
                       torch.full_like(flat_e, n_experts * capacity))
    return slot, valid


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), experts stacked on dim 0 -> (E, C, d)."""
    h = F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
    return torch.bmm(h, wd)


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style load balance: E sum_e (routed fraction) (router
    mass)."""
    e = mcfg.n_experts
    flat = idx.reshape(-1)
    frac = torch.bincount(flat, minlength=e).float() / flat.numel()
    return e * torch.sum(frac * probs.mean(0))


def _moe_local(xf: torch.Tensor, p, mcfg: MoEConfig):
    """xf (T, d) -> (y (T, d) in xf.dtype, aux scalar fp32)."""
    t, d = xf.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = _capacity(t, mcfg)
    w, idx, probs = _route(xf.float(), p["wr"], mcfg)
    slot, valid = _slots(idx, e, cap)
    # the reference's .at[slot].set(..., mode="drop"): one row more, the
    # drop slot's, cut off before the experts run
    disp = xf.new_zeros((e * cap + 1, d))
    disp[slot] = xf.repeat_interleave(k, dim=0)
    y = _expert_ffn(disp[:-1].view(e, cap, d), p["wg"], p["wu"], p["wd"])
    back = y.reshape(e * cap, d)
    rows = back[torch.clamp(slot, max=e * cap - 1)]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    y_tok = (rows.view(t, k, d) * w[..., None].to(rows.dtype)).sum(1)
    return y_tok.to(xf.dtype), _aux_loss(probs, idx, mcfg)


def _plan(mcfg: MoEConfig, shape, mesh):
    """(data axes, whether the experts' hidden dims FSDP over them) when
    the reference's expert-parallel condition holds for a (B, S, D)
    input, else None."""
    if mesh is None or "model" not in mesh.axis_names \
            or mesh.size("model") <= 1:
        return None
    b, s, d = shape
    dp = sharding.batch_axes(mesh)
    n_dp = coll.axes_size(mesh, dp)
    tp = mesh.size("model")
    if b % n_dp or s % tp or mcfg.n_experts % tp:
        return None
    fsdp = bool(dp) and d % n_dp == 0 and mcfg.expert_ff % n_dp == 0
    return dp, fsdp


def _weight_spec(mcfg: MoEConfig, d: int, mesh) -> tuple:
    """The resolved spec of ``wg``/``wu``/``wd`` on ``mesh``: experts
    over ``"model"`` when they divide it, the hidden dim (d, or ff for
    ``wd``) over the data axes when both divide them, as the reference's
    expert-parallel path takes them."""
    expert, fsdp, _ = sharding.resolve(mesh, EXPERT_LOGICAL)
    tp = mesh.size("model") if "model" in mesh.axis_names else 1
    n_dp = coll.axes_size(mesh, sharding.batch_axes(mesh))
    if mcfg.n_experts % tp:
        expert = None
    if d % n_dp or mcfg.expert_ff % n_dp:
        fsdp = None
    return expert, fsdp, None


def shard_moe_params(p, mcfg: MoEConfig, mesh):
    """This rank's MoE params on ``mesh``: the router replicated, each
    expert leaf present (``wg``/``wu``/``wd``) its block under the
    ``("expert", "fsdp", None)`` axes (``sharding.local_block``, a copy).
    A dict of some of the leaves gives those, so a caller can shard one
    leaf at a time. The params as they are without a mesh."""
    if mesh is None:
        return p
    d = next(v.shape[2] if k == "wd" else v.shape[1]
             for k, v in p.items() if k != "wr")
    spec = _weight_spec(mcfg, d, mesh)
    return {k: (sharding.local_block(v, mesh, spec) if k != "wr" else v)
            for k, v in p.items()}


def _full_weights(p, mcfg: MoEConfig, d: int, mesh):
    """The whole expert weights from this rank's blocks (each sharded
    dim gathered from its owners); the params as they are when they are
    whole already."""
    if tuple(p["wg"].shape) == (mcfg.n_experts, d, mcfg.expert_ff):
        return p
    expert, fsdp, _ = _weight_spec(mcfg, d, mesh)
    out = dict(p)
    for k in ("wg", "wu", "wd"):
        w = out[k]
        if fsdp is not None:
            w = coll.all_gather(w, mesh, fsdp, 1)
        if expert is not None:
            w = coll.all_gather(w, mesh, expert, 0)
        out[k] = w
    return out


def _moe_shard(xl: torch.Tensor, wr: torch.Tensor, ws, mcfg: MoEConfig,
               mesh):
    """One rank's share of the expert-parallel MoE (the reference's
    ``_moe_shard``): xl (B/dp, S/tp, d) its tokens, ``wr`` the router,
    ``ws`` its experts' (wg, wu, wd), whole along their hidden dims ->
    (its y block, its own aux loss)."""
    ep = mesh.size("model")
    e, k = mcfg.n_experts, mcfg.top_k
    e_loc = e // ep
    b_loc, s_loc, d = xl.shape
    xl = xl.reshape(b_loc * s_loc, d)
    t_loc = b_loc * s_loc
    cap = _capacity(t_loc, mcfg)
    w, idx, probs = _route(xl.float(), wr, mcfg)
    slot, valid = _slots(idx, e, cap)
    disp = xl.new_zeros((e * cap + 1, d))
    disp[slot] = xl.repeat_interleave(k, dim=0)
    disp = disp[:-1].reshape(ep, e_loc * cap, d)
    # stream the dispatch rows to the experts' owners (fixed capacity)
    recv = coll.all_to_all(disp, mesh, "model")
    recv = recv.reshape(ep, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, ep * cap, d)
    y = _expert_ffn(recv, *ws)
    # and the results back
    y = y.reshape(e_loc, ep, cap, d).transpose(0, 1) \
        .reshape(ep, e_loc * cap, d)
    back = coll.all_to_all(y, mesh, "model").reshape(e * cap, d)
    # the combine, a weighted sum at the source
    rows = back[torch.clamp(slot, max=e * cap - 1)]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    y_tok = (rows.view(t_loc, k, d) * w[..., None].to(rows.dtype)).sum(1)
    return (y_tok.reshape(b_loc, s_loc, d).to(xl.dtype),
            _aux_loss(probs, idx, mcfg))


def apply_moe(p, mcfg: MoEConfig, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar). Under ``mesh``
    (every rank with the same ``x``) the expert-parallel path runs when
    the reference's condition holds and the local one otherwise; ``p``
    may be whole or this rank's blocks (``shard_moe_params``), and each
    path takes what it needs."""
    b, s, d = x.shape
    plan = _plan(mcfg, x.shape, mesh)
    if plan is None:
        if mesh is not None:
            p = _full_weights(p, mcfg, d, mesh)
        y, aux = _moe_local(x.reshape(b * s, d), p, mcfg)
        return y.reshape(b, s, d), aux
    dp, fsdp = plan
    if p["wg"].shape[0] == mcfg.n_experts:
        p = shard_moe_params(p, mcfg, mesh)
    axes = tuple(mesh.axis_names)
    tp = mesh.size("model")
    b_loc, s_loc = b // coll.axes_size(mesh, dp), s // tp
    # every rank holds all of x: its gradient is the sum of the ranks'
    xr = coll.replicated(x, mesh, axes)
    xl = xr.narrow(0, coll.axes_index(mesh, dp) * b_loc, b_loc) \
        .narrow(1, mesh.rank("model") * s_loc, s_loc)
    # the weights are replicated over the data axes (gathered there when
    # FSDP), and each data group's tokens are its own: their gradients
    # sum over the data axes; the router's over every axis
    ws = []
    for name in ("wg", "wu", "wd"):
        w = p[name]
        if fsdp:
            w = coll.all_gather(w, mesh, dp, 1)
        ws.append(coll.replicated(w, mesh, dp))
    y, aux = _moe_shard(xl, coll.replicated(p["wr"], mesh, axes), ws, mcfg,
                        mesh)
    aux = coll.pmean(aux, mesh, axes)
    y = coll.all_gather(coll.all_gather(y, mesh, dp, 0), mesh, "model", 1)
    return y, aux


def apply_moe_chunk(p, mcfg: MoEConfig, x: torch.Tensor,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE of the LM's S-sharded stream on ``mesh``, as the reference
    hands it its shard_map (in-spec ``P(batch, "model", None)``, no
    gather): x (B/dp, S/tp, D) this rank's chunk, ``p`` this rank's
    blocks (the router whole, the experts' ``("expert", "fsdp", None)``
    blocks) -> (the chunk's output, complete: no sum over 'model' is
    owed; the aux loss, the mean of every rank's).

    The rank's tokens route with the capacity of their own count and
    travel to the experts' owners by ``all_to_all`` over 'model'
    (``_moe_shard``); each expert leaf is gathered over the data axes it
    is split over by ``collectives.gather_seq``, whose backward sums the
    data ranks' gradients of the whole leaf and hands each rank its
    block's. Nothing else sums inside: the train step sums the router's
    gradient (it is replicated) over every axis. The aux loss's value is
    every rank's mean; its gradient is that of the mean over the data
    group's ranks, as the cross entropy's is its data group's, since
    the train step averages every gradient over the data axes."""
    tp = sharding.tp_size(mesh)
    if tp == 1 or mcfg.n_experts % tp:
        raise ValueError(
            f"the MoE on a mesh takes a 'model' axis of more than one rank "
            f"that divides its {mcfg.n_experts} experts (the reference's "
            f"expert-parallel path); this mesh has {tp}")
    d = x.shape[-1]
    _, fsdp, _ = _weight_spec(mcfg, d, mesh)
    ws = []
    for name in ("wg", "wu", "wd"):
        w = p[name]
        # row-major over the axes named: the last varies fastest
        for a in reversed(sharding.entry_axes(fsdp)):
            w = coll.gather_seq(w, mesh, a, dim=1)
        ws.append(w)
    y, aux = _moe_shard(x, p["wr"], ws, mcfg, mesh)
    aux_m = coll.pmean(aux, mesh, "model")
    aux_all = coll.pmean(aux_m.detach(), mesh, sharding.batch_axes(mesh))
    return y, aux_all + (aux_m - aux_m.detach())


def apply_moe_decode(p, mcfg: MoEConfig, x: torch.Tensor,
                     mesh) -> torch.Tensor:
    """The MoE of a decode step on ``mesh``, whose one-token stream is
    replicated over 'model': x (B/dp, 1, D) this rank's rows. The
    reference takes ``_moe_local`` over its program's global batch
    there (S = 1 does not divide 'model'), so the capacity and the
    slots' ranking see every data rank's tokens: the rows are gathered
    over the data axes and every rank routes and ranks them as one
    batch, the same bits everywhere. The experts stay where they are:
    each 'model' rank runs its own experts' slots (all of them where the
    experts are not split), its hidden-dim slice of each where they are
    split over the data axes (FSDP), whose partial products are summed
    over those axes in fp32 and rounded once, as one product's are; the
    experts' outputs are gathered over 'model' (a few rows a slot) and
    combined -> y (B/dp, 1, D), complete, this rank's rows."""
    dp = sharding.batch_axes(mesh)
    b, s, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    xg = coll.all_gather(x, mesh, dp, 0).reshape(-1, d)
    t = xg.shape[0]
    cap = _capacity(t, mcfg)
    w, idx, _ = _route(xg.float(), p["wr"], mcfg)
    slot, valid = _slots(idx, e, cap)
    disp = xg.new_zeros((e * cap + 1, d))
    disp[slot] = xg.repeat_interleave(k, dim=0)
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    e_loc = wg.shape[0]
    m = sharding.tp_rank(mesh) if e_loc < e else 0
    mine = disp[m * e_loc * cap:(m + 1) * e_loc * cap].view(e_loc, cap, d)
    if wg.shape[1] < d:
        # this rank's slice of the hidden dims, its blocks' rows
        i = coll.axes_index(mesh, dp)

        def summed(a, w_):
            part = torch.bmm(a.float(), w_.float())
            return coll.psum(part, mesh, dp).to(a.dtype)
        dl, fl = wg.shape[1], wd.shape[1]
        xs = mine[..., i * dl:(i + 1) * dl]
        h = F.silu(summed(xs, wg)) * summed(xs, wu)
        y = summed(h[..., i * fl:(i + 1) * fl], wd)
    else:
        y = _expert_ffn(mine, wg, wu, wd)
    back = y.reshape(e_loc * cap, d)
    if e_loc < e:
        back = coll.all_gather(back, mesh, "model", 0)
    rows = back[torch.clamp(slot, max=e * cap - 1)]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    y_tok = (rows.view(t, k, d) * w[..., None].to(rows.dtype)).sum(1)
    return y_tok.to(x.dtype).view(-1, s, d).narrow(
        0, coll.axes_index(mesh, dp) * b, b)
