"""DLRM, the paper's model (Fig. 1/3), on the sparse + dense engines.

Topology: dense features -> bottom MLP ─┐
          sparse indices -> embedding    ├─> feature interaction -> top MLP
          gather+reduce (sparse engine) ─┘         -> sigmoid -> CTR

Parameters are the reference's nested dict, ``{"bottom": [(w, b), ...],
"top": [(w, b), ...], "arena": T}``; ``params_from_numpy`` carries the
reference's weights across. This slice ports the ragged serving path on
the uniform arena; training and the heterogeneous table groups are
ROADMAP Queue 1, items 5 and 8.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dense_engine as de
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se


def _uniform_only(cfg: DLRMConfig) -> None:
    if cfg.heterogeneous:
        raise NotImplementedError(
            "heterogeneous table groups are not ported yet "
            "(ROADMAP Queue 1, item 8)")


def arena_spec(cfg: DLRMConfig) -> se.ArenaSpec:
    """The uniform ArenaSpec of a config."""
    _uniform_only(cfg)
    return se.ArenaSpec(cfg.n_tables, cfg.rows_per_table, cfg.emb_dim,
                        cfg.dtype)


def top_mlp_in_dim(cfg: DLRMConfig) -> int:
    f = cfg.n_interact_features
    return cfg.emb_dim + f * (f - 1) // 2


def init(generator: torch.Generator, cfg: DLRMConfig, *,
         device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random params drawn from ``generator``, on the card unless
    ``device="cpu"``; the generator must live on that device type."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params asked "
                         f"on {device}")
    if cfg.bottom_mlp[-1] != cfg.emb_dim:
        raise ValueError("bottom MLP must end at emb_dim so its output "
                         "joins the interaction")
    spec = arena_spec(cfg)
    return {
        "bottom": de.init_mlp(generator,
                              (cfg.dense_features,) + cfg.bottom_mlp),
        "top": de.init_mlp(generator, (top_mlp_in_dim(cfg),) + cfg.top_mlp),
        "arena": se.init_arena(generator, spec),
    }


def params_from_numpy(tree: Dict, device: Optional[Union[str, torch.device]]
                      = None) -> Dict:
    """The reference's params as a numpy tree
    (``jax.tree.map(np.asarray, repro.core.dlrm.init(key, cfg))``) -> the
    port's params on ``device`` (the card unless told otherwise)."""
    if "arena" not in tree:
        raise NotImplementedError(
            "only uniform-arena params are ported yet (ROADMAP Queue 1, "
            "item 8)")
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        # np.array copies: the reference's arrays may be read-only views
        return torch.from_numpy(np.array(a)).to(device)

    return {"bottom": [(t(w), t(b)) for w, b in tree["bottom"]],
            "top": [(t(w), t(b)) for w, b in tree["top"]],
            "arena": t(tree["arena"])}


def head_logits(mlp_params: Dict, dense: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
    """The DLRM head: reduced embeddings (B, T, D) + dense features ->
    logits (B,). The stage names are the reference's trace names."""
    with record_function("interaction"):
        bot = de.mlp_apply(mlp_params["bottom"], dense)
        x, _ = de.feature_interaction(bot, emb.to(bot.dtype))
    with record_function("mlp"):
        return de.mlp_apply(mlp_params["top"], x)[:, 0]


def forward_ragged(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                   indices: torch.Tensor, offsets: torch.Tensor, *,
                   max_l: int,
                   source: Optional[es.EmbeddingSource] = None
                   ) -> torch.Tensor:
    """Ragged-bag forward: the production SparseLengthsSum path.

    dense: (B, dense_features); indices: flat per-table row-id stream
    (N,) int32, possibly padded; offsets: (B*T+1,) int32 ragged bag
    boundaries in (sample, table) row-major order; max_l: per-bag length
    bound. The embedding stage is ``lookup_bags`` over `source` (default:
    the fp arena in `params`). Returns logits (B,).
    """
    spec = arena_spec(cfg)
    if source is None:
        source = es.FpArena(params["arena"])
    with record_function("sparse_lookup"):
        emb = es.lookup_bags(source, spec, indices, offsets, max_l=max_l)
    return head_logits(params, dense, emb)


def make_ragged_serve_step(cfg: DLRMConfig, *, max_l: int):
    """Serve step over ragged batches ({dense, indices, offsets} -> CTR),
    run under ``torch.inference_mode``. The source is a per-call argument
    (default: the fp arena in `params`)."""
    def serve_step(params: Dict, batch: Dict,
                   source: Optional[es.EmbeddingSource] = None
                   ) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(forward_ragged(
                params, cfg, batch["dense"], batch["indices"],
                batch["offsets"], max_l=max_l, source=source))
    return serve_step
