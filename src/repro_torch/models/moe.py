"""Fixed-capacity mixture of experts on one card, the counterpart of the
reference's ``repro/models/moe.py`` without a mesh.

Each token picks ``top_k`` experts from an fp32 router softmax; its
choices are ranked within their expert in token-major order and the
first ``capacity`` of an expert's choices take its dispatch slots
``expert * C + rank``; the rest go to the drop slot ``E * C`` and add
nothing. The experts run as one batched SwiGLU over the (E, C, d)
dispatch buffer, and each token sums its valid choices' rows, weighted
by its renormalised router probabilities. The shapes are static: every
step runs all E * C expert rows, whatever the routing.

The reference's expert-parallel path (``_moe_shard``: tokens to the
experts' owners over an all-to-all under a mesh) is ROADMAP Queue 1,
item 13b; ``apply_moe`` refuses a mesh of more than one rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.params import Builder


def init_moe(b: Builder, mcfg: MoEConfig, d: int):
    """Router ``wr`` (d, E) fp32; experts ``wg``/``wu`` (E, d, ff) and
    ``wd`` (E, ff, d) in the builder's dtype. Their scale follows the
    reference's rule, fan_in = shape[0], which is E for the experts."""
    e, ff = mcfg.n_experts, mcfg.expert_ff
    return {"wr": b.normal((d, e), dtype=torch.float32),
            "wg": b.normal((e, d, ff)),
            "wu": b.normal((e, d, ff)),
            "wd": b.normal((e, ff, d))}


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


def apply_moe(p, mcfg: MoEConfig, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar)."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "MoE under a mesh (the expert-parallel all-to-all) is not "
            "ported yet (ROADMAP Queue 1, item 13b)")
    b, s, d = x.shape
    y, aux = _moe_local(x.reshape(b * s, d), p, mcfg)
    return y.reshape(b, s, d), aux
