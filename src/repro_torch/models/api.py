"""Model API over the LM architectures, the counterpart of the
reference's ``repro/models/api.py``; an encoder-decoder config goes to
``models.encdec``, every other one to ``models.transformer``, as the
reference dispatches:

    init(generator, cfg, device=None)       -> params
    params_from_numpy(tree, device=None)    -> params
    param_specs(cfg)                        -> logical spec tree
    shard_params(params, cfg, mesh)         -> this rank's blocks
    forward / prefill / decode_step / init_cache
    make_prefill_step(cfg, max_len, mesh=None)
    make_decode_fn(cfg, mesh=None)
    loss(params, cfg, batch, remat=True)    -> scalar
    default_optimizer(cfg)                  -> (name, optimizer)
    make_train_step(cfg, optimizer=None, mesh=None, ...)
                                            -> (name, optimizer, step fn)
    train_state_specs(cfg, name, opt, mesh) -> shardings of the state
    cache_specs(cfg, batch, max_len, mesh)  -> shardings of the cache

Params are built under ``torch.no_grad()``, so their leaves can take
``requires_grad_()``; serving (forward, prefill, decode, the cache) runs
under ``torch.inference_mode()``, which records nothing. ``forward``
returns (logits, aux) as the reference's does, aux the MoE load-balance
loss summed over the layers (zero for a dense model), and ``loss``
adds ``aux_loss_coef`` x aux. Training differentiates ``loss`` with
autograd: through the flash op, whose backward recomputes through the
chunked attention. The dry-run stand-ins (``input_specs``) are not
ported.

**On a mesh** (``launch.mesh.Mesh``: one process a rank, (data, model)
or any of ``make_mesh``'s shapes) the ``mesh=`` steps run the decoder
and vision-prefix families (GQA or MLA attention, a dense FFN or a
MoE) tensor- and sequence-parallel over 'model', expert-parallel there
for a MoE, and data-parallel over the other axes
(``models.transformer``'s docstring). Each rank passes its blocks of the params
(``shard_params``) and its share of the batch, split on its first dim
over the data axes (``data.make_placer`` with ``batch_specs(cfg,
mesh)``); the steps return what that rank holds: prefill and decode the
rank's vocab shard of the logits (``collectives.all_gather(logits, mesh,
"model", dim=-1)`` puts them together), the cache the rank's kv heads
(``init_cache(..., mesh=mesh)``; MLA's latent cache whole over
'model'), and the train step updates the rank's blocks in place, its
loss and grad norm the whole batch's, the same bits on every rank. The
train step sums each leaf's gradient over the axes that do not split it
(its uses on the ranks' chunks and heads are parts of it), averages
every gradient over the data axes in fp32, clips by the norm of the
whole tree, and updates with AdamW, SGD or Adafactor (whose row, column
and whole-leaf means span the whole leaf, ``optim.Layout``). The
hybrid, ssm and encoder-decoder families are refused on a mesh (ROADMAP
Queue 1, item 13e).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import optim as optim_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import encdec, params as params_lib, transformer


def _impl(cfg: ModelConfig):
    return encdec if cfg.is_encdec else transformer


def _inference(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


@torch.no_grad()
def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` (on the card unless ``device``
    says otherwise)."""
    return _impl(cfg).init(generator, cfg, device=device)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same
        # 16 bits, reinterpreted
        bits = np.array(a).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    # np.array copies: the reference's arrays may be read-only views
    return torch.from_numpy(np.array(a)).to(device)


@torch.no_grad()
def params_from_numpy(tree: Any, device=None) -> Any:
    """The reference's params as a numpy tree
    (``jax.tree.map(np.asarray, repro.models.api.init(key, cfg)[0])``) ->
    the port's tree on ``device`` (the card unless told otherwise), the
    same leaves in the same dtypes, bf16 included."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _tensor(t, device)
    return conv(tree)


def _sharded_mesh(mesh) -> bool:
    return mesh is not None and coll.axes_size(mesh, mesh.axis_names) > 1


def mesh_ported(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s family runs on a mesh (the decoders, GQA or MLA,
    dense or MoE, and the vision-prefix decoder; the rest are ROADMAP
    Queue 1, item 13e)."""
    try:
        _refuse_on_mesh(cfg)
    except NotImplementedError:
        return False
    return True


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    """Refuse a family the port does not shard yet, on a mesh of more
    than one rank."""
    if _sharded_mesh(mesh):
        _refuse_on_mesh(cfg)


def _refuse_on_mesh(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder on a mesh (its logical axes) "
            "is ROADMAP Queue 1, item 13e")
    transformer.check_mesh_ported(cfg)


def param_specs(cfg: ModelConfig):
    """The logical spec tree of ``init``'s params (the reference's
    ``init(key, cfg)[1]``), with ``sharding.Heads`` entries where the
    reference's flat head dims split over 'model'; of the families that
    run on a mesh."""
    _refuse_on_mesh(cfg)
    return transformer.param_specs(cfg)


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's blocks of the full ``params`` on ``mesh`` (copies);
    ``params`` itself without a mesh."""
    _check_mesh(cfg, mesh)
    return params_lib.shard_params(params, cfg, mesh)


def batch_specs(cfg: ModelConfig, mesh) -> Dict[str, tuple]:
    """The resolved specs of an LM batch on ``mesh``: every key split on
    its first dim over the data axes (``data.make_placer``)."""
    keys = ["tokens"] + (["patches"] if cfg.family == "vlm" else [])
    return {k: sharding.resolve(mesh, ("batch",)) for k in keys}


@_inference
def forward(params, cfg: ModelConfig, batch):
    return _impl(cfg).forward(params, cfg, batch)


@_inference
def prefill(params, cfg: ModelConfig, batch, max_len: int):
    return _impl(cfg).prefill(params, cfg, batch, max_len)


@_inference
def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """``pos`` an int or a 0-dim tensor (read on the host)."""
    return _impl(cfg).decode_step(params, cfg, cache, tokens, int(pos))


@_inference
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, mesh=None):
    """The decode cache; on ``mesh`` this rank's: its share of the batch
    (``batch`` is the rank's) and its kv heads."""
    _check_mesh(cfg, mesh)
    with sharding.use_mesh(mesh):
        return _impl(cfg).init_cache(cfg, batch, max_len, dtype, device)


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh=None):
    """prefill_step(params, batch) -> (last-position logits, cache), on
    ``mesh`` this rank's (module docstring)."""
    _check_mesh(cfg, mesh)

    def prefill_step(params, batch):
        with sharding.use_mesh(mesh):
            return prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_fn(cfg: ModelConfig, mesh=None):
    """serve_step(params, cache, {"tokens", "pos"}) -> (logits, cache),
    on ``mesh`` this rank's (module docstring)."""
    _check_mesh(cfg, mesh)

    def serve_step(params, cache, batch):
        with sharding.use_mesh(mesh):
            return decode_step(params, cfg, cache, batch["tokens"],
                               batch["pos"])
    return serve_step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def loss(params, cfg: ModelConfig, batch, remat: bool = True):
    return _impl(cfg).loss_fn(params, cfg, batch, remat=remat)


def default_optimizer(cfg: ModelConfig) -> Tuple[str, Any]:
    """Adafactor for the >100B MoE archs (state must stay O(P/d)), else
    AdamW; both wrapped layerwise, so an update's temporaries are one
    layer of the stacked params. Returns (name, optimizer)."""
    if cfg.moe is not None and cfg.d_model >= 4096:
        return "adafactor", optim_lib.layerwise(optim_lib.adafactor(1e-4))
    return "adamw", optim_lib.layerwise(optim_lib.adamw(3e-4))


def leaf_layout(mesh, logical, shape) -> optim_lib.Layout:
    """The ``optim.Layout`` of a leaf of the whole ``shape`` and the
    ``logical`` spec on ``mesh``: the axes that split each dim of its
    block."""
    spec = sharding.resolve(mesh, logical)
    dims = tuple(tuple(a for a in sharding.entry_axes(e)
                       if a in mesh.axis_names and mesh.size(a) > 1)
                 for e in spec)
    return optim_lib.Layout(mesh, dims, tuple(shape))


def _layouts(cfg: ModelConfig, mesh):
    """An ``optim.Layout`` a leaf of the params on ``mesh``."""
    return optim_lib.tree_map(
        lambda leaf: leaf_layout(mesh, leaf.logical, leaf.shape),
        transformer.param_leaves(cfg))


def _mesh_sync(cfg: ModelConfig, mesh):
    """(the gradient sync, the params' ``optim.Layout``s) of a train
    step on ``mesh``: each leaf's gradient summed over the axes that do
    not split it ('model' first, then the data axes; the rank's
    gradient of a block split over a data axis already holds every data
    rank's part, ``moe.apply_moe_chunk``), then divided by the data
    ranks, in fp32, in place."""
    layouts = _layouts(cfg, mesh)
    data = sharding.batch_axes(mesh)
    n_data = coll.axes_size(mesh, data)

    @torch.no_grad()
    def sync(grads):
        def one(g, lay):
            axes = tuple(a for a in ("model",) + data
                         if a in mesh.axis_names and a not in lay.axes)
            if coll.axes_size(mesh, axes) == 1 and n_data == 1:
                return g
            g32 = coll.psum(g.float(), mesh, axes)
            if n_data > 1:
                g32 /= n_data
            return g.copy_(g32)
        return optim_lib.tree_map(one, grads, layouts)
    return sync, layouts


# the optimizers a mesh step takes: elementwise ones, and Adafactor with
# the params' layouts
MESH_OPTIMIZERS = ("adamw", "sgd", "adafactor")


def make_train_step(cfg: ModelConfig, optimizer=None, mesh=None,
                    grad_clip: float = 1.0, microbatches: int = 1):
    """Returns (opt_name, optimizer, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    updates ``params`` and ``opt_state`` in place and returns them, with
    ``metrics = {"loss", "grad_norm"}`` as 0-dim fp32 tensors on the
    params' device (nothing is read to the host). ``grad_norm`` is the
    norm before clipping to ``grad_clip``.

    microbatches > 1 is gradient accumulation, as the reference's scan:
    the batch is split contiguously along its first dim, the gradients are
    added in the params' dtype in micro-batch order starting from zeros,
    then divided by n; the loss is the mean of the micro-batch losses.

    On ``mesh`` the step takes this rank's blocks and batch share (module
    docstring).
    """
    _check_mesh(cfg, mesh)
    if optimizer is None:
        opt_name, opt = default_optimizer(cfg)
    else:
        opt_name, opt = optimizer
    sync = layouts = None
    if _sharded_mesh(mesh):
        if opt_name not in MESH_OPTIMIZERS:
            raise ValueError(f"{opt_name} on a mesh: the mesh steps take "
                             f"{MESH_OPTIMIZERS}")
        sync, layouts = _mesh_sync(cfg, mesh)
    # Adafactor's means over a leaf run over the whole leaf
    update_kw = ({"layouts": layouts}
                 if opt_name == "adafactor" and layouts is not None else {})

    def value_and_grad(params, batch):
        # fresh leaves over the params' storage: autograd records on
        # them, and the in-place update below writes the params
        leaves = optim_lib.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
        # the backward recomputes checkpointed layers: on the mesh too
        with sharding.use_mesh(mesh):
            value = loss(leaves, cfg, batch)
            grads = torch.autograd.grad(value, optim_lib.tree_leaves(leaves))
        it = iter(grads)
        return value.detach(), optim_lib.tree_map(lambda _: next(it), leaves)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss_val, grads = value_and_grad(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads = optim_lib.tree_map(torch.zeros_like, params)
            losses = []
            for i in range(microbatches):
                mb_loss, g = value_and_grad(
                    params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                optim_lib.tree_map(torch.Tensor.add_, grads, g)
                losses.append(mb_loss)
            grads = optim_lib.tree_map(lambda g: g / microbatches, grads)
            loss_val = torch.stack(losses).mean()
        if sync is not None:
            grads = sync(grads)
            loss_val = coll.pmean(loss_val, mesh, sharding.batch_axes(mesh))
        grads, gnorm = optim_lib.clip_by_global_norm(grads, grad_clip,
                                                     mesh=mesh,
                                                     layouts=layouts)
        params, opt_state = opt.update(grads, opt_state, params,
                                       **update_kw)
        return params, opt_state, {"loss": loss_val, "grad_norm": gnorm}

    return opt_name, opt, train_step


def train_state_specs(cfg: ModelConfig, opt_name: str, opt, mesh):
    """(params' shardings, the optimizer state's, the logical spec tree):
    trees of ``sharding.Sharding`` (None without a mesh), for
    ``CheckpointManager.save`` / ``restore``, by the reference's
    ``state_logical_specs``: AdamW's (and SGD's) moments sharded as their
    params; Adafactor's ``vr`` by its param's spec without the last
    entry, ``vc`` without the second-to-last, ``v`` as it is; the step
    count replicated."""
    specs = param_specs(cfg)
    shard = sharding.spec_tree_to_shardings(mesh, specs)
    if opt_name == "adamw":
        return shard, {"m": shard, "v": shard, "step": None}, specs
    if opt_name == "sgd":
        return shard, {"mu": shard, "step": None}, specs
    if opt_name != "adafactor":
        raise ValueError(f"{opt_name}'s state specs: the mesh steps take "
                         f"{MESH_OPTIMIZERS}")

    def fac(leaf):
        s = leaf.logical
        if len(leaf.shape) >= 2:
            return {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
        return {"v": s}
    fac_specs = optim_lib.tree_map(fac, transformer.param_leaves(cfg))
    return shard, {"fac": sharding.spec_tree_to_shardings(mesh, fac_specs),
                   "step": None}, specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """The decode cache's shardings (``sharding.Sharding`` leaves, None
    without a mesh). GQA: k and v split on the batch over the data axes
    and by kv head over 'model' (``sharding.head_split``; replicated
    where the kv heads are), slot positions replicated. MLA: the latent
    ``c_kv`` and ``k_rope``, which have no head dim, split on the batch
    and replicated over 'model', each rank reading them whole for its
    heads. The reference splits the cache positions over 'model' instead,
    for its split-KV decode (``repro/models/api.py:211-237``); the port's
    decode attends with the rank's heads, so its cache is split as they
    are. Both hold the same values."""
    _check_mesh(cfg, mesh)
    a = cfg.attention
    if a.kind == "mla":
        lat = (None, "batch", None, None)
        return sharding.spec_tree_to_shardings(mesh, {"layers": {
            "c_kv": lat, "k_rope": lat, "slot_pos": (None, None)}})
    heads = sharding.Heads(a.n_heads, a.n_kv_heads, 1, "kv")
    kv = (None, "batch", None, heads, None)
    return sharding.spec_tree_to_shardings(mesh, {"layers": {
        "k": kv, "v": kv, "slot_pos": (None, None)}})
