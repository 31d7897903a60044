"""DLRM, the paper's model (Fig. 1/3), on the sparse + dense engines.

Topology: dense features -> bottom MLP ─┐
          sparse indices -> embedding    ├─> feature interaction -> top MLP
          gather+reduce (sparse engine) ─┘         -> sigmoid -> CTR

Parameters are the reference's nested dict, ``{"bottom": [(w, b), ...],
"top": [(w, b), ...], "arena": T}``; ``params_from_numpy`` carries the
reference's weights across. Ported on the uniform, replicated arena: the
ragged serve step and the ragged train step, both the row-wise sparse
step and the dense-gradient baseline (row-wise Adagrad on the arena,
AdamW on the MLPs). The heterogeneous table groups are ROADMAP Queue 1,
item 8; sharded training is item 13.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dense_engine as de
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.optim import (Optimizer, adamw, partitioned,
                               rowwise_adagrad, tree_map)


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -(labels * logp + (1 - labels) * lognp).mean()


def loss_ragged(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                indices: torch.Tensor, offsets: torch.Tensor,
                labels: torch.Tensor, *, max_l: int) -> torch.Tensor:
    """BCE over the ragged production path; differentiable through the
    kernels' backward passes (``kernels.ops``)."""
    logits = forward_ragged(params, cfg, dense, indices, offsets,
                            max_l=max_l)
    return _bce(logits, labels)


def make_optimizer(cfg: DLRMConfig, lr: float = 1e-3) -> Optimizer:
    _uniform_only(cfg)
    return partitioned({"arena": rowwise_adagrad(lr * 10)}, adamw(lr))


def _tracked(tree: Any) -> Any:
    """Aliases of the tree's tensors (same storage) that autograd tracks."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def make_train_step_ragged(cfg: DLRMConfig, *, max_l: int, lr: float = 1e-3,
                           sparse: bool = True, mesh: Any = None,
                           sharded: Optional[bool] = None):
    """Train step over ragged batches {dense, indices, offsets, labels}.

    Returns (opt_like, step) where step(params, opt_state, batch) ->
    (new_params, new_opt_state, loss, touched_rows); touched_rows (N,)
    int32 are the sorted unique arena rows the batch updated, padded with
    the null row. loss is a 0-dim tensor on the params' device.

    sparse=True composes the row-wise *sparse* optimizer on the arena
    (update cost O(N) in the index-stream length, no densified (V, D)
    gradient) with AdamW on the MLPs; sparse=False is the dense-gradient
    baseline (autograd through the whole model, the ``sls_grad_table``
    scatter-add into a (V, D) gradient, partitioned row-wise Adagrad).

    The step updates the parameters and the optimizer state **in place**
    and returns the same tensors (new_params is a new dict over them):
    keep a copy of whatever must survive the step.

    Sharded training (``sharded=True`` or a mesh) is ROADMAP Queue 1,
    item 13; heterogeneous table groups are item 8.
    """
    from repro_torch.training import sparse_optim as so

    if sharded or mesh is not None:
        raise NotImplementedError(
            "sharded training is not ported yet (ROADMAP Queue 1, item 13)")
    spec = arena_spec(cfg)

    if not sparse:
        opt = make_optimizer(cfg, lr)

        def dense_step(params, opt_state, batch):
            live = _tracked(params)
            loss = loss_ragged(live, cfg, batch["dense"], batch["indices"],
                               batch["offsets"], batch["labels"],
                               max_l=max_l)
            with record_function("backward"):
                loss.backward()
            with torch.no_grad(), record_function("optimizer"):
                grads = tree_map(lambda t: t.grad, live)
                new_params, new_state = opt.update(grads, opt_state, params)
                flat = se.flatten_ragged_indices(spec, batch["indices"],
                                                 batch["offsets"])
                rows, _ = so.unique_padded(flat, spec.null_row)
            return new_params, new_state, loss.detach(), rows

        return opt, dense_step

    arena_opt = so.sparse_rowwise_adagrad(lr * 10)
    mlp_opt = adamw(lr)

    def init(params):
        return {"arena": arena_opt.init(params["arena"]),
                "mlp": mlp_opt.init({k: v for k, v in params.items()
                                     if k != "arena"})}

    def step(params, opt_state, batch):
        n_bags = batch["offsets"].shape[0] - 1
        # The sparse stage runs forward once, outside autograd; its
        # gradient w.r.t. the arena is a pure scatter of the bag
        # gradients, which the row-wise update applies directly, so the
        # update stays O(N).
        with torch.no_grad(), record_function("sparse_lookup"):
            emb = es.lookup_bags(es.FpArena(params["arena"]), spec,
                                 batch["indices"], batch["offsets"],
                                 max_l=max_l)
        emb.requires_grad_()
        mlp_params = {k: v for k, v in params.items() if k != "arena"}
        live = _tracked(mlp_params)
        loss = _bce(head_logits(live, batch["dense"], emb), batch["labels"])
        with record_function("backward"):
            loss.backward()
        with torch.no_grad(), record_function("optimizer"):
            d_bags = emb.grad.reshape(n_bags, spec.dim)
            rows, row_g = so.source_row_grads(spec, d_bags, batch["indices"],
                                              batch["offsets"])
            new_arena, arena_state = arena_opt.update(
                params["arena"], opt_state["arena"], rows, row_g)
            new_mlp, mlp_state = mlp_opt.update(
                tree_map(lambda t: t.grad, live), opt_state["mlp"],
                mlp_params)
        new_params = dict(new_mlp)
        new_params["arena"] = new_arena
        return new_params, {"arena": arena_state, "mlp": mlp_state}, \
            loss.detach(), rows

    return Optimizer(init, None), step
