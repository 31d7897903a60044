"""DLRM, the paper's model (Fig. 1/3), on the sparse + dense engines.

Topology: dense features -> bottom MLP ─┐
          sparse indices -> embedding    ├─> feature interaction -> top MLP
          gather+reduce (sparse engine) ─┘         -> sigmoid -> CTR

Parameters are the reference's nested dict, ``{"bottom": [(w, b), ...],
"top": [(w, b), ...], "arena": T}``; on a heterogeneous config
``"tables"`` (one (vocab_t + 1, dim_t) arena a table) and ``"proj"``
(one (dim_t, emb_dim) projection a table) take the arena's place.
``params_from_numpy`` carries the reference's weights across. Ported,
replicated:

* the fixed (B, T, L) layout: ``forward``, ``loss_fn``, the
  dense-gradient ``make_train_step`` and ``make_serve_step``;
* the ragged layout: ``forward_ragged``, the ragged serve step and the
  ragged train step, both the row-wise sparse step and the
  dense-gradient baseline;
* heterogeneous table groups on both layouts: the group source over
  ``params["tables"]`` (``group_source``, or any ``TableGroupSource``),
  each table's bag projected into the interaction width
  (``project_tables``), per-table streams, and the group train steps.

Every train step puts row-wise Adagrad on the arena (one accumulator a
table on a group) and AdamW on the rest.

Row sharding: with a ``mesh`` (``launch.mesh.make_mesh((n,), ("model",))``,
one process a rank) of more than one shard, ``params["arena"]`` (a group's
``params["tables"]``) is this rank's block of the arena padded to
``spec.padded_rows(n)`` rows (``init(..., shards=n)`` then
``shard_params``), the forwards and serve steps look up through a
``ShardedArena``, and ``make_train_step_ragged``'s sparse step updates
the rank's block. Every rank runs the
same batch. A group serves sharded but trains replicated, as the
reference's does.

On a (data, model) mesh (``make_mesh((2, 2), ("data", "model"))``) the
block is replicated over the data axes. The fixed-L path splits its bags
over them (``ShardedArena.reduce_fixed``) and hands every rank the whole
result, so the dense-gradient ``make_train_step`` computes the MLP
gradients of the whole batch on every rank, and sums the block's
gradient over the data axes before the row-wise Adagrad (each data
group's backward sees only its own bags). The ragged path is replicated
over the data axes, as the reference's is: its steps are the 1-D ones,
run alike by every data replica.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dense_engine as de
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.distributed import collectives
from repro_torch.obs.tracing import stage as obs_stage
from repro_torch.optim import (Optimizer, adamw, partitioned,
                               rowwise_adagrad, tree_leaves, tree_map)


def arena_spec(cfg: DLRMConfig) -> se.ArenaSpec:
    """The uniform ArenaSpec, or on a heterogeneous config the group's
    envelope (n_tables, the largest vocab, the largest dim), of which the
    entry points read only n_tables and dim."""
    if cfg.heterogeneous:
        return se.ArenaSpec(cfg.n_tables, max(cfg.table_rows),
                            max(cfg.table_dims), cfg.dtype)
    return se.ArenaSpec(cfg.n_tables, cfg.rows_per_table, cfg.emb_dim,
                        cfg.dtype)


def member_specs(cfg: DLRMConfig) -> tuple:
    """The per-table single-table ArenaSpecs of a config."""
    return tuple(se.ArenaSpec(1, r, d, cfg.dtype)
                 for r, d in zip(cfg.resolved_table_rows,
                                 cfg.resolved_table_dims))


def table_plans(cfg: DLRMConfig, *, cache_k: Union[int, tuple, list] = 0,
                quantize_rows_above: Optional[int] = None) -> tuple:
    """The per-table composition of a config, the ``TablePlan`` tuple a
    ``SourceSpec(tables=...)`` takes: ``cache_k`` (one K, or one a table;
    0: no hot cache) pins the skewed tables, ``quantize_rows_above``
    int8-quantizes every table whose vocab exceeds it."""
    rows = cfg.resolved_table_rows
    dims = cfg.resolved_table_dims
    if not isinstance(cache_k, (tuple, list)):
        cache_k = (cache_k,) * cfg.n_tables
    return tuple(es.TablePlan(
        rows=r, dim=d, cache_k=int(k),
        quantize=(quantize_rows_above is not None
                  and r > quantize_rows_above))
        for r, d, k in zip(rows, dims, cache_k))


def top_mlp_in_dim(cfg: DLRMConfig) -> int:
    f = cfg.n_interact_features
    return cfg.emb_dim + f * (f - 1) // 2


def init(generator: torch.Generator, cfg: DLRMConfig, shards: int = 1, *,
         device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random params drawn from ``generator``, on the card unless
    ``device="cpu"``; the generator must live on that device type. Each
    arena is padded for ``shards`` row-shards (``se.init_arena``), as the
    reference's ``init(key, cfg, shards)``; ``shard_params`` then takes a
    rank's block."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params asked "
                         f"on {device}")
    if cfg.bottom_mlp[-1] != cfg.emb_dim:
        raise ValueError("bottom MLP must end at emb_dim so its output "
                         "joins the interaction")
    params = {
        "bottom": de.init_mlp(generator,
                              (cfg.dense_features,) + cfg.bottom_mlp),
        "top": de.init_mlp(generator, (top_mlp_in_dim(cfg),) + cfg.top_mlp),
    }
    if cfg.heterogeneous:
        specs = member_specs(cfg)
        params["tables"] = tuple(se.init_arena(generator, sp, shards)
                                 for sp in specs)
        # table t's reduced (dim_t,) bag joins the interaction as an
        # (emb_dim,) vector
        params["proj"] = tuple(
            (torch.randn((sp.dim, cfg.emb_dim), generator=generator,
                         dtype=torch.float32, device=device)
             / sp.dim ** 0.5).to(getattr(torch, cfg.dtype))
            for sp in specs)
    else:
        params["arena"] = se.init_arena(generator, arena_spec(cfg), shards)
    return params


def shard_params(params: Dict, mesh: Any) -> Dict:
    """This rank's params on a row-sharded mesh: the arena (a group's
    tables) replaced by the rank's block (``se.shard_block``: its rows,
    then the zero sentinel), every other leaf as it was. The arenas must
    be padded for the mesh (``init(..., shards=n)``). With one shard the
    params are returned as they are."""
    n = se.mesh_shards(mesh)
    if n == 1:
        return params
    rank = mesh.rank()

    def block(a: torch.Tensor) -> torch.Tensor:
        if a.shape[0] % n:
            raise ValueError(f"arena of {a.shape[0]} rows does not divide "
                             f"into {n} shards: pad it (init(..., "
                             f"shards={n}))")
        return se.shard_block(a, rank, n)

    out = dict(params)
    if "tables" in params:
        out["tables"] = tuple(block(a) for a in params["tables"])
    else:
        out["arena"] = block(params["arena"])
    return out


def params_from_numpy(tree: Dict, device: Optional[Union[str, torch.device]]
                      = None) -> Dict:
    """The reference's params as a numpy tree
    (``jax.tree.map(np.asarray, repro.core.dlrm.init(key, cfg))``) -> the
    port's params on ``device`` (the card unless told otherwise): the
    uniform arena, or a heterogeneous config's per-table arenas and
    projections."""
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        # np.array copies: the reference's arrays may be read-only views
        return torch.from_numpy(np.array(a)).to(device)

    out = {"bottom": [(t(w), t(b)) for w, b in tree["bottom"]],
           "top": [(t(w), t(b)) for w, b in tree["top"]]}
    if "tables" in tree:
        out["tables"] = tuple(t(a) for a in tree["tables"])
        out["proj"] = tuple(t(p) for p in tree["proj"])
    else:
        out["arena"] = t(tree["arena"])
    return out


def group_source(params: Dict, cfg: DLRMConfig,
                 mesh: Any = None) -> es.TableGroupSource:
    """The default serving group of a heterogeneous config: one fp member
    a table arena, row-sharded when a mesh of more than one shard is
    given."""
    if not cfg.heterogeneous:
        raise ValueError("group_source needs a heterogeneous config")
    return es.TableGroupSource.from_arenas(params["tables"],
                                           member_specs(cfg), mesh)


def project_tables(proj, emb: torch.Tensor) -> torch.Tensor:
    """Per-table output projections: (B, T, dmax) padded group embeddings
    -> (B, T, emb_dim) interaction features. Table t reads only its
    leading dim_t lanes. One matmul a table, as the reference's plain
    ``@`` (no Pallas kernel there)."""
    cols = [emb[:, t, :p.shape[0]].to(p.dtype) @ p
            for t, p in enumerate(proj)]
    return torch.stack(cols, dim=1)


def _default_source(params: Dict, cfg: DLRMConfig,
                    mesh: Any = None) -> es.EmbeddingSource:
    return (group_source(params, cfg, mesh) if cfg.heterogeneous
            else es.resolve_source(params["arena"], mesh))


def head_logits(mlp_params: Dict, dense: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
    """The DLRM head: reduced embeddings (B, T, D) + dense features ->
    logits (B,). The stage names are the reference's trace names; the
    ``obs_stage`` annotations are off unless
    ``obs.enable_stage_annotations`` turned them on."""
    with obs_stage("interaction"):
        bot = de.mlp_apply(mlp_params["bottom"], dense)
        x, _ = de.feature_interaction(bot, emb.to(bot.dtype))
    with obs_stage("mlp"):
        return de.mlp_apply(mlp_params["top"], x)[:, 0]


def forward(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
            indices: torch.Tensor, mesh: Any = None, *,
            source: Optional[es.EmbeddingSource] = None) -> torch.Tensor:
    """Fixed-L forward: dense (B, dense_features), indices (B, T, L)
    int32 per-table ids -> logits (B,).

    The sparse stage is ``lookup_fixed`` over `source` (default: the fp
    arena in `params`, one ``embedding_bag`` launch for all tables,
    row-sharded when a mesh is given, or on a heterogeneous config the
    group over ``params["tables"]``, whose bags are projected through
    ``params["proj"]``); the head is the one the ragged path runs.
    """
    spec = arena_spec(cfg)
    if source is None:
        source = _default_source(params, cfg, mesh)
    with obs_stage("sparse_lookup"):
        emb = es.lookup_fixed(source, spec, indices)
        if cfg.heterogeneous:
            emb = project_tables(params["proj"], emb)
    return head_logits(params, dense, emb)


def make_serve_step(cfg: DLRMConfig, mesh: Any = None):
    """Serve step over fixed-L batches ({dense, indices} -> CTR), run
    under ``torch.inference_mode``, from the fp arena (or tables) in
    `params`, row-sharded over `mesh` when given."""
    se.mesh_shards(mesh)

    def serve_step(params: Dict, batch: Dict) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(forward(params, cfg, batch["dense"],
                                         batch["indices"], mesh))
    return serve_step


def forward_ragged(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                   indices: torch.Tensor, offsets: torch.Tensor, *,
                   max_l: int,
                   source: Optional[es.EmbeddingSource] = None,
                   mesh: Any = None) -> torch.Tensor:
    """Ragged-bag forward: the production SparseLengthsSum path.

    dense: (B, dense_features); indices: flat per-table row-id stream
    (N,) int32, possibly padded; offsets: (B*T+1,) int32 ragged bag
    boundaries in (sample, table) row-major order; max_l: per-bag length
    bound. The embedding stage is ``lookup_bags`` over `source` (default:
    the fp arena in `params`, or on a heterogeneous config the group over
    ``params["tables"]``, row-sharded when a mesh is given). Returns
    logits (B,).

    Per-table streams: with a ``TableGroupSource``, `indices` / `offsets`
    may instead be sequences, table t's own flat stream and (B+1,)
    offsets (``lookup_bags_per_table``; `max_l` may be one a table). A
    heterogeneous config projects each table's bag into the interaction
    width through ``params["proj"]``.
    """
    spec = arena_spec(cfg)
    if source is None:
        source = _default_source(params, cfg, mesh)
    with obs_stage("sparse_lookup"):
        if isinstance(indices, (tuple, list)):
            emb = es.lookup_bags_per_table(source, indices, offsets,
                                           max_l=max_l)
        else:
            emb = es.lookup_bags(source, spec, indices, offsets,
                                 max_l=max_l)
        if cfg.heterogeneous:
            emb = project_tables(params["proj"], emb)
    return head_logits(params, dense, emb)


def make_ragged_serve_step(cfg: DLRMConfig, *, max_l: int, mesh: Any = None):
    """Serve step over ragged batches ({dense, indices, offsets} -> CTR),
    run under ``torch.inference_mode``. The source is a per-call argument
    (default: the fp arena in `params`, or the group over its tables,
    row-sharded over `mesh` when given)."""
    se.mesh_shards(mesh)

    def serve_step(params: Dict, batch: Dict,
                   source: Optional[es.EmbeddingSource] = None
                   ) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(forward_ragged(
                params, cfg, batch["dense"], batch["indices"],
                batch["offsets"], max_l=max_l, source=source, mesh=mesh))
    return serve_step


def make_ragged_serve_stages(cfg: DLRMConfig, *, max_l: int):
    """The ragged serve step split at its pipeline-stage boundaries: the
    live Fig-5 mode, in which the serving engine synchronizes after each
    stage and attributes device time to the embedding stage against the
    dense stages.

    Returns ``(sparse_stage, interact_stage, top_stage)``, each run under
    ``torch.inference_mode``; composed they run the very ops of
    ``make_ragged_serve_step``:

      * ``sparse_stage(params, batch, source)`` -> (B, T, D) reduced bags
        (projected through ``params["proj"]`` on a heterogeneous config,
        the scope ``obs_stage("sparse_lookup")`` covers in the fused
        step);
      * ``interact_stage(params, batch, emb)`` -> interaction features
        (bottom MLP and feature interaction);
      * ``top_stage(params, x)`` -> CTR probabilities (top MLP and
        sigmoid).
    """
    spec = arena_spec(cfg)

    def sparse_stage(params: Dict, batch: Dict,
                     source: es.EmbeddingSource) -> torch.Tensor:
        with torch.inference_mode(), obs_stage("sparse_lookup"):
            emb = es.lookup_bags(source, spec, batch["indices"],
                                 batch["offsets"], max_l=max_l)
            if cfg.heterogeneous:
                emb = project_tables(params["proj"], emb)
        return emb

    def interact_stage(params: Dict, batch: Dict,
                       emb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), obs_stage("interaction"):
            bot = de.mlp_apply(params["bottom"], batch["dense"])
            x, _ = de.feature_interaction(bot, emb.to(bot.dtype))
        return x

    def top_stage(params: Dict, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), obs_stage("mlp"):
            return torch.sigmoid(de.mlp_apply(params["top"], x)[:, 0])

    return sparse_stage, interact_stage, top_stage


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -(labels * logp + (1 - labels) * lognp).mean()


def loss_fn(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
            indices: torch.Tensor, labels: torch.Tensor,
            mesh: Any = None) -> torch.Tensor:
    """Binary cross-entropy on click labels over the fixed-L forward."""
    return _bce(forward(params, cfg, dense, indices, mesh), labels)


def loss_ragged(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                indices: torch.Tensor, offsets: torch.Tensor,
                labels: torch.Tensor, *, max_l: int,
                mesh: Any = None) -> torch.Tensor:
    """BCE over the ragged production path; differentiable through the
    kernels' backward passes (``kernels.ops``) and, on a mesh, the
    all-reduce's identity backward."""
    logits = forward_ragged(params, cfg, dense, indices, offsets,
                            max_l=max_l, mesh=mesh)
    return _bce(logits, labels)


def make_optimizer(cfg: DLRMConfig, lr: float = 1e-3) -> Optimizer:
    key = "tables" if cfg.heterogeneous else "arena"
    return partitioned({key: rowwise_adagrad(lr * 10)}, adamw(lr))


def _tracked(tree: Any) -> Any:
    """Aliases of the tree's tensors (same storage) that autograd tracks."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def make_train_step(cfg: DLRMConfig, optimizer: Optional[Optimizer] = None,
                    mesh: Any = None):
    """Train step over fixed-L batches {dense, indices (B, T, L),
    labels}: the dense-gradient step of the reference, autograd through
    the whole model (the arena's gradient is ``embedding_bag``'s
    backward, the ``sls_grad_table`` scatter-add into a (V, D) table; on
    a heterogeneous config, the group's, one table gradient a member),
    then ``optimizer`` (default ``make_optimizer``: row-wise Adagrad on
    the arena or tables, AdamW on the rest).

    Returns (opt, step) where step(params, opt_state, batch) ->
    (new_params, new_opt_state, loss), loss a 0-dim tensor on the
    params' device. The step updates the parameters and the optimizer
    state **in place** and returns the same tensors: keep a copy of
    whatever must survive the step. With a mesh the arena is this rank's
    block and its gradient the rank's rows of the whole one (the
    sentinel's pinned to zero); the MLP gradients are equal on every
    rank, the batch being. On a (data, model) mesh each data group
    reduces its own bags and the block's gradient is summed over the
    data axes inside the backward (``collectives.replicated``), so the
    data replicas of a block step alike.
    """
    se.mesh_shards(mesh)
    opt = optimizer or make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        live = _tracked(params)
        loss = loss_fn(live, cfg, batch["dense"], batch["indices"],
                       batch["labels"], mesh)
        with obs_stage("backward"):
            loss.backward()
        with torch.no_grad(), obs_stage("optimizer"):
            grads = tree_map(lambda t: t.grad, live)
            new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss.detach()

    return opt, train_step


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

    On a heterogeneous config the step is the group's
    (``_make_train_step_group``): touched_rows is then a tuple, one
    array a table; a group does not train sharded.

    On a mesh of more than one shard the sparse step is the row-sharded
    one (sharded=None or True; sharded=False is refused, since a
    replicated sparse step would train a copy of the arena a rank): the
    arena and its Adagrad accumulator are this rank's blocks
    (``shard_params``), the forward reduces the rank's partial bags over
    its block (``ShardedArena``: one ``fused_segment_sum``, one
    all-reduce of reduced D-vectors), the MLP gradients are all-reduced
    and divided by N (the reference's ``pmean``: equal gradients, so
    exact for N a power of two), and ``shard_local_rows`` keeps the row
    gradients the rank owns for its row-wise Adagrad. Row gradients
    never leave their rank; ``touched_rows`` is the global sorted unique
    rows, equal on every rank. At one shard each of these three is the
    identity, and the step is the replicated one. The dense-gradient
    baseline on a mesh differentiates through the sharded source.
    """
    from repro_torch.training import sparse_optim as so

    spec = arena_spec(cfg)
    shards = se.mesh_shards(mesh)
    if cfg.heterogeneous:
        if sharded or shards > 1:
            raise ValueError(
                "sharded TRAINING of a heterogeneous table group is not "
                "supported yet: serve groups sharded (ShardedArena "
                "members) and train replicated")
        return _make_train_step_group(cfg, spec, max_l=max_l, lr=lr,
                                      sparse=sparse)
    if sharded is None:
        sharded = sparse and shards > 1
    if sharded:
        if not sparse:
            raise ValueError("sharded=True is the sparse-optimizer path; "
                             "the dense-grad baseline threads the mesh "
                             "through the default sharded source instead")
        if mesh is None or "model" not in mesh.axis_names:
            raise ValueError("sharded=True needs a mesh with axis 'model'")
    elif sparse and shards > 1:
        raise ValueError(
            "sparse ragged training on a mesh must be sharded: the "
            "replicated sparse branch would silently train a per-rank "
            "arena copy; pass sharded=True (or leave sharded=None)")

    if not sparse:
        opt = make_optimizer(cfg, lr)

        def dense_step(params, opt_state, batch):
            live = _tracked(params)
            loss = loss_ragged(live, cfg, batch["dense"], batch["indices"],
                               batch["offsets"], batch["labels"],
                               max_l=max_l, mesh=mesh)
            with obs_stage("backward"):
                loss.backward()
            with torch.no_grad(), obs_stage("optimizer"):
                grads = tree_map(lambda t: t.grad, live)
                new_params, new_state = opt.update(grads, opt_state, params)
                flat = se.flatten_ragged_indices(spec, batch["indices"],
                                                 batch["offsets"])
                rows, _ = so.unique_padded(flat, spec.null_row)
            return new_params, new_state, loss.detach(), rows

        return opt, dense_step

    arena_opt = so.sparse_rowwise_adagrad(lr * 10)
    mlp_opt = adamw(lr)
    shard = mesh.rank() if shards > 1 else 0

    def init(params):
        return {"arena": arena_opt.init(params["arena"]),
                "mlp": mlp_opt.init({k: v for k, v in params.items()
                                     if k != "arena"})}

    def step(params, opt_state, batch):
        n_bags = batch["offsets"].shape[0] - 1
        arena = params["arena"]
        # The sparse stage runs forward once, outside autograd; its
        # gradient w.r.t. the arena is a pure scatter of the bag
        # gradients, which the row-wise update applies directly, so the
        # update stays O(N).
        with torch.no_grad(), obs_stage("sparse_lookup"):
            emb = es.lookup_bags(es.resolve_source(arena, mesh), spec,
                                 batch["indices"], batch["offsets"],
                                 max_l=max_l)
        emb.requires_grad_()
        mlp_params = {k: v for k, v in params.items() if k != "arena"}
        live = _tracked(mlp_params)
        loss = _bce(head_logits(live, batch["dense"], emb), batch["labels"])
        with obs_stage("backward"):
            loss.backward()
        with torch.no_grad(), obs_stage("optimizer"):
            d_mlp = tree_map(lambda t: t.grad, live)
            collectives.pmean_(tree_leaves(d_mlp), mesh)
            d_bags = emb.grad.reshape(n_bags, spec.dim)
            rows, row_g = so.source_row_grads(spec, d_bags, batch["indices"],
                                              batch["offsets"])
            local_rows, local_g = rows, row_g
            if shards > 1:
                lo, vlocal = se.shard_row_range(arena, shard)
                local_rows, local_g = so.shard_local_rows(
                    rows, row_g, lo=lo, vlocal=vlocal,
                    null_row=spec.null_row)
            new_arena, arena_state = arena_opt.update(
                arena, opt_state["arena"], local_rows, local_g)
            new_mlp, mlp_state = mlp_opt.update(d_mlp, opt_state["mlp"],
                                                mlp_params)
        new_params = dict(new_mlp)
        new_params["arena"] = new_arena
        return new_params, {"arena": arena_state, "mlp": mlp_state}, \
            loss.detach(), rows

    return Optimizer(init, None), step


def _make_train_step_group(cfg: DLRMConfig, spec: se.ArenaSpec, *,
                           max_l: int, lr: float, sparse: bool):
    """The heterogeneous (table-group) ragged train step.

    sparse=True: the group lookup runs outside autograd, the head
    (projections and MLPs) backpropagates, and
    ``sparse_optim.group_row_grads`` turns the padded bag gradient into
    one (rows, grads) pair a table (one ``sls_grad_table`` call a table),
    which per-table row-wise Adagrad applies in O(index stream) a table.
    sparse=False: the dense-gradient baseline, autograd through the group
    (each member arena's table gradient, one ``sls_grad_table`` a table)
    and partitioned row-wise Adagrad.

    step(params, opt_state, batch) -> (new_params, new_opt_state, loss,
    touched), `touched` one array of touched rows a table (padded with
    that table's null row). Both update in place, as the uniform steps.
    """
    from repro_torch.training import sparse_optim as so

    specs = member_specs(cfg)

    def touched_rows(batch):
        idx = batch["indices"]
        table, valid = se.ragged_position_tables(batch["offsets"],
                                                 idx.shape[0], cfg.n_tables)
        return tuple(so.unique_padded(
            torch.where(valid & (table == t), idx, sp.null_row),
            sp.null_row)[0] for t, sp in enumerate(specs))

    if not sparse:
        opt = make_optimizer(cfg, lr)

        def dense_step(params, opt_state, batch):
            live = _tracked(params)
            loss = loss_ragged(live, cfg, batch["dense"], batch["indices"],
                               batch["offsets"], batch["labels"],
                               max_l=max_l)
            with obs_stage("backward"):
                loss.backward()
            with torch.no_grad(), obs_stage("optimizer"):
                grads = tree_map(lambda t: t.grad, live)
                new_params, new_state = opt.update(grads, opt_state, params)
                rows = touched_rows(batch)
            return new_params, new_state, loss.detach(), rows

        return opt, dense_step

    arena_opt = so.group_rowwise_adagrad(lr * 10)
    mlp_opt = adamw(lr)

    def init(params):
        return {"tables": arena_opt.init(params["tables"]),
                "mlp": mlp_opt.init({k: v for k, v in params.items()
                                     if k != "tables"})}

    def step(params, opt_state, batch):
        n_bags = batch["offsets"].shape[0] - 1
        with torch.no_grad(), obs_stage("sparse_lookup"):
            group = es.TableGroupSource(
                members=tuple(es.FpArena(a) for a in params["tables"]),
                specs=specs)
            emb = es.lookup_bags(group, spec, batch["indices"],
                                 batch["offsets"], max_l=max_l)
        emb.requires_grad_()
        head_params = {k: v for k, v in params.items() if k != "tables"}
        live = _tracked(head_params)
        loss = _bce(head_logits(live, batch["dense"],
                                project_tables(live["proj"], emb)),
                    batch["labels"])
        with obs_stage("backward"):
            loss.backward()
        with torch.no_grad(), obs_stage("optimizer"):
            d_bags = emb.grad.reshape(n_bags, spec.dim)
            per_table = so.group_row_grads(specs, d_bags, batch["indices"],
                                           batch["offsets"], max_l=max_l)
            new_tables, tables_state = arena_opt.update(
                params["tables"], opt_state["tables"], per_table)
            new_head, mlp_state = mlp_opt.update(
                tree_map(lambda t: t.grad, live), opt_state["mlp"],
                head_params)
        new_params = dict(new_head)
        new_params["tables"] = new_tables
        return new_params, {"tables": tables_state, "mlp": mlp_state}, \
            loss.detach(), tuple(rows for rows, _ in per_table)

    return Optimizer(init, None), step
