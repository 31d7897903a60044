"""Decoder-only model assembly for the reference's four decoder
families (``repro/models/transformer.py``): ``decoder`` and ``vlm`` (GQA
or multi-head latent attention (MLA), a dense FFN or a fixed-capacity
MoE with arctic's dense residual branch beside it, and the vision
prefix: precomputed patch embeddings before the tokens), ``ssm`` (RWKV-6
time-mix and channel-mix blocks, attention-free) and ``hybrid``
(RecurrentGemma's RG-LRU recurrent blocks and local attention blocks in
the config's ``block_pattern``).

Parameters keep the reference's tree: ``"embed"`` (padded vocab, D),
``"layers"`` with every leaf stacked over the layers (L, ...) (the
hybrid: ``"groups"`` stacked over the pattern's whole groups, each group
``{"b0", "b1", ...}`` one block a pattern entry, and ``"tail"`` a list of
the blocks left over), ``"ln_f"`` and, untied, ``"unembed"``. The decode
cache has the same shape: ``{"layers": {"k", "v", "slot_pos"}}`` (MLA:
``{"c_kv", "k_rope", "slot_pos"}``; RWKV: ``{"tm": {"x_prev", "S"},
"cm": {"x_prev"}}``), the hybrid's ``{"groups", "tail"}`` with a
recurrent block's ``{"h", "conv"}`` beside the attention caches (a ring
of ``window`` slots when the cache is longer). The reference scans the
stacked layers with ``lax.scan``; here a Python loop indexes them.
Training (``loss_fn``) runs ``forward`` with each layer (a hybrid's
group) under ``torch.utils.checkpoint`` when ``remat``, as the
reference's ``jax.checkpoint`` of the scan body. The encoder-decoder
family is ``models/encdec.py``.

**On a mesh** (the active mesh of ``distributed.sharding.use_mesh``, set
by ``api``'s ``mesh=`` steps; the decoder and vision-prefix families)
each rank holds its blocks of the params (``params.shard_params``) and
its share of the batch, and the blocks run Megatron-style, where the
reference constrains: the residual stream between blocks is this rank's
chunk of S (``_embed_input`` reduce-scatters the partial token rows, a
``vlm`` batch's patches ahead of them); a block all-gathers S at the
entry to attention and to a dense FFN (``sharding.gather_seq``),
computes its heads (GQA's, or MLA's with the latent whole on every
rank) and d_ff columns, and reduce-scatters its partial output back
onto S (``sharding.scatter_seq``). A MoE takes the rank's chunk itself,
expert-parallel (``moe.apply_moe_chunk``), and its output is whole;
arctic's dense residual branch beside it runs as a dense FFN. The head
gathers S and gives the rank's vocab shard of the logits, and the loss
is vocab-parallel. A decode step keeps its one-token stream replicated
over 'model' and adds the row-parallel partials with
``sharding.psum_model``; a MoE there routes the data ranks' tokens as
one batch (``moe.apply_moe_decode``); the cache holds the rank's kv
heads (MLA: the whole latent). S must divide over 'model'. The hybrid
and ssm configs are refused on a mesh (ROADMAP Queue 1, item 13e).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import embedding as emb
from repro_torch.models import layers, mla, moe, rglru, rwkv6
from repro_torch.models.params import (Builder, SpecRecorder, init_stacked,
                                       spec_tree, stack_layers)

# the reference's decoder families (encdec is models/encdec.py)
FAMILIES = ("decoder", "vlm", "ssm", "hybrid")


def check_ported(cfg: ModelConfig) -> None:
    """Refuse what the reference's transformer refuses: a family other
    than its four, and an attention block without GQA or MLA."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder family "
            f"{FAMILIES}; the encoder-decoder goes through models.encdec")
    if cfg.family != "ssm" and cfg.attention.kind not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: attention {cfg.attention.kind!r} in "
                         f"a {cfg.family} model; it takes gqa or mla")
    mesh = sharding.active_mesh()
    if mesh is not None and coll.axes_size(mesh, mesh.axis_names) > 1:
        check_mesh_ported(cfg)


def check_mesh_ported(cfg: ModelConfig) -> None:
    """Refuse, on a mesh, what the port does not shard yet: the hybrid
    and ssm families (and, in ``models.api``, the encoder-decoder)."""
    if cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh (its logical "
            "axes) is ROADMAP Queue 1, item 13e")


def _layer(tree, i: int):
    """Layer i's params (or cache entry) out of a stacked tree: views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The n per-layer trees of a stacked tree: views, one ``unbind`` a
    leaf, whose backward is one stack a leaf (indexing layer by layer
    would add n full-size gradients a leaf)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def n_layers(params) -> int:
    return params["layers"]["ln1"]["w"].shape[0]


def n_groups(params) -> int:
    return params["groups"]["b0"]["ln1"]["w"].shape[0]


def _write(dst, src) -> None:
    """Copy a state tree into the cache's tensors in place."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn_block(b: Builder, cfg: ModelConfig):
    p = {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
         "ln2": layers.init_norm(b, cfg.d_model, cfg.norm)}
    if cfg.attention.kind == "mla":
        p["mla"] = mla.init_mla(b, cfg.attention, cfg.d_model)
    else:
        p["attn"] = layers.init_attention(b, cfg.attention, cfg.d_model)
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(b, cfg.moe, cfg.d_model)
        if cfg.moe.dense_residual_ff:
            p["res_mlp"] = layers.init_mlp(b, cfg.d_model,
                                           cfg.moe.dense_residual_ff, cfg.act)
    else:
        p["mlp"] = layers.init_mlp(b, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def _init_rwkv_block(b: Builder, cfg: ModelConfig):
    return {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
            "tm": rwkv6.init_time_mix(b, cfg.rwkv, cfg.d_model),
            "ln2": layers.init_norm(b, cfg.d_model, cfg.norm),
            "cm": rwkv6.init_channel_mix(b, cfg.d_model, cfg.d_ff)}


def _init_rec_block(b: Builder, cfg: ModelConfig):
    return {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
            "rec": rglru.init_rec(b, cfg.rglru, cfg.d_model),
            "ln2": layers.init_norm(b, cfg.d_model, cfg.norm),
            "mlp": layers.init_mlp(b, cfg.d_model, cfg.d_ff, cfg.act)}


def _init_block(b: Builder, cfg: ModelConfig, kind: str):
    return (_init_rec_block(b, cfg) if kind == "rec"
            else _init_attn_block(b, cfg))


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(whole groups, the tail's kinds) of the block pattern over
    n_layers: recurrentgemma-9b's 38 layers are 12 (rec, rec, attn)
    groups and a tail of (rec, rec)."""
    pat = cfg.rglru.block_pattern
    groups = cfg.n_layers // len(pat)
    return groups, tuple(pat[i] for i in range(cfg.n_layers
                                               - groups * len(pat)))


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` on the card unless ``device`` says
    otherwise; norm weights, the MoE router and the recurrent blocks'
    Lambda and decay base fp32, every other leaf ``cfg.dtype``. Each
    stacked leaf is allocated once and filled layer (group) by layer
    (``params.init_stacked``); a hybrid's tail blocks follow its
    groups, as the reference draws them."""
    check_ported(cfg)
    return _build(Builder(generator, dtype=getattr(torch, cfg.dtype),
                          device=resolve_device(device)), cfg)


def param_leaves(cfg: ModelConfig) -> Dict:
    """``init``'s params recorded, not drawn: a ``params.Leaf`` (shape,
    dtype, logical spec) a leaf."""
    check_ported(cfg)
    return _build(SpecRecorder(getattr(torch, cfg.dtype)), cfg)


def param_specs(cfg: ModelConfig) -> Dict:
    """The logical spec tree of ``init``'s params (the reference's
    ``split(tree)[1]``), recorded from the same init code."""
    return spec_tree(param_leaves(cfg))


def _build(b, cfg: ModelConfig) -> Dict:
    tree = {"embed": emb.init_table(b, cfg.vocab_size, cfg.d_model)}
    if cfg.family == "hybrid":
        groups, tail = _hybrid_layout(cfg)
        pat = cfg.rglru.block_pattern
        tree["groups"] = init_stacked(
            b, lambda bb: {f"b{j}": _init_block(bb, cfg, kind)
                           for j, kind in enumerate(pat)}, groups)
        tree["tail"] = [_init_block(b, cfg, kind) for kind in tail]
    else:
        make = _init_rwkv_block if cfg.family == "ssm" else _init_attn_block
        tree["layers"] = init_stacked(b, lambda bb: make(bb, cfg),
                                      cfg.n_layers)
    tree["ln_f"] = layers.init_norm(b, cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        tree["unembed"] = emb.init_unembed(b, cfg.vocab_size, cfg.d_model)
    return tree


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, h):
    """The block's FFN of the S-sharded stream ``h`` (its rank's chunk on
    a mesh) -> (y, aux), y complete on the chunk: the dense MLP on the
    S-gathered stream, its partial output reduce-scattered onto S; or
    the MoE on the chunk itself, whose output is whole (the reference
    hands it the S-sharded stream, ``transformer.py:115-121``), plus
    arctic's dense residual branch, the one partial sum there. A dense
    FFN's aux is 0."""
    if cfg.moe is None:
        return sharding.scatter_seq(layers.apply_mlp(
            p["mlp"], sharding.gather_seq(h), cfg.act)), 0.0
    mesh = sharding.active_mesh()
    if mesh is not None and coll.axes_size(mesh, mesh.axis_names) > 1:
        y, aux = moe.apply_moe_chunk(p["moe"], cfg.moe, h, mesh)
    else:
        y, aux = moe.apply_moe(p["moe"], cfg.moe, h)
    if cfg.moe.dense_residual_ff:
        y = y + sharding.scatter_seq(layers.apply_mlp(
            p["res_mlp"], sharding.gather_seq(h), cfg.act))
    return y, aux


def _ffn_decode(p, cfg: ModelConfig, h):
    """The block's FFN of a decode step's one-token stream, replicated
    over 'model' on a mesh -> y: the row-parallel partials summed
    (``psum_model``); the MoE's output whole (on a mesh the data ranks'
    tokens routed as one batch, ``moe.apply_moe_decode``)."""
    if cfg.moe is None:
        return sharding.psum_model(layers.apply_mlp(p["mlp"], h, cfg.act))
    mesh = sharding.active_mesh()
    if mesh is not None and coll.axes_size(mesh, mesh.axis_names) > 1:
        y = moe.apply_moe_decode(p["moe"], cfg.moe, h, mesh)
    else:
        y, _ = moe.apply_moe(p["moe"], cfg.moe, h)
    if cfg.moe.dense_residual_ff:
        y = y + sharding.psum_model(layers.apply_mlp(p["res_mlp"], h,
                                                     cfg.act))
    return y


def _attn_block_full(p, cfg: ModelConfig, x, positions):
    # on a mesh: gather S at the entry (SP all-gather), reduce-scatter the
    # partial outputs back onto S; identities without one
    h = sharding.gather_seq(layers.apply_norm(p["ln1"], x, cfg.norm))
    if cfg.attention.kind == "mla":
        a = mla.mla_full(p["mla"], cfg.attention, h, positions, cfg.d_model)
    else:
        a = layers.attention_full(p["attn"], cfg.attention, h, positions,
                                  cfg.d_model)
    x = x + sharding.scatter_seq(a)
    y, aux = _ffn(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))
    return x + y, aux


def _embed_input(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Tokens -> (B, S, D); a ``vlm`` batch's patches (B, P, D), cast to
    the embedding dtype, go before the tokens. On a mesh: this rank's
    chunk of S, the ranks' token rows reduce-scattered (the patches come
    in from 'model' rank 0, zeros from the others)."""
    x = emb.embed_rows(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype)
        if sharding.tp_rank() != 0:
            patches = torch.zeros_like(patches)
        x = torch.cat([patches, x], 1)
    return sharding.scatter_seq(x)


def _positions(x) -> torch.Tensor:
    """arange of the whole sequence, of which ``x`` is this rank's chunk
    on a mesh."""
    return torch.arange(x.shape[1] * sharding.tp_size(), device=x.device)


def _head(params, cfg: ModelConfig, x, seq_sharded: bool = True):
    """The final norm and the logits (the rank's vocab shard on a mesh),
    after gathering the S-sharded stream when ``seq_sharded``."""
    x = layers.apply_norm(params["ln_f"], x, cfg.norm)
    if seq_sharded:
        x = sharding.gather_seq(x)
    if cfg.tie_embeddings:
        return emb.lm_head(x, params["embed"], cfg.vocab_size)
    return emb.lm_head_untied(x, params["unembed"], cfg.vocab_size)


def _rwkv_block_full(p, cfg: ModelConfig, x, state=None,
                     chunked: bool = False):
    """One RWKV block from ``state`` (None: zeros) -> (x, its new
    state)."""
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, tm = rwkv6.time_mix_full(p["tm"], cfg.rwkv, h,
                                None if state is None else state["tm"],
                                chunked=chunked)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    y, cm = rwkv6.channel_mix_full(p["cm"], h,
                                   None if state is None else state["cm"])
    return x + y, {"tm": tm, "cm": cm}


def _rec_block_full(p, cfg: ModelConfig, x):
    """One RG-LRU block from a zero state -> (x, its final state)."""
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, state = rglru.rec_full(p["rec"], cfg.rglru, h)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act), state


def _block_full(p, cfg: ModelConfig, kind: str, x, positions):
    """A hybrid model's block of ``kind`` ("rec" or "attn") -> x."""
    if kind == "rec":
        return _rec_block_full(p, cfg, x)[0]
    return _attn_block_full(p, cfg, x, positions)[0]


def _group_full(p_g, cfg: ModelConfig, x, positions):
    for j, kind in enumerate(cfg.rglru.block_pattern):
        x = _block_full(p_g[f"b{j}"], cfg, kind, x, positions)
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, rwkv_chunked: bool = True):
    """Teacher-forced forward -> (logits (B, S, Vpad) f32, aux: the MoE
    load-balance losses summed over the layers, a 0-dim fp32 tensor,
    zero for a model without a MoE). With ``remat`` and autograd
    recording, each layer (a hybrid's group) runs under
    ``torch.utils.checkpoint``; a hybrid's tail blocks run as they are,
    as the reference unrolls them. An RWKV model takes the chunked WKV
    where its chunk divides S, unless ``rwkv_chunked`` is False."""
    check_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = _positions(x)
    remat = remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for p_l in _unstack(params["layers"], n_layers(params)):
            x, _ = run(_rwkv_block_full, p_l, cfg, x, None, rwkv_chunked)
    elif cfg.family == "hybrid":
        for p_g in _unstack(params["groups"], n_groups(params)):
            x = run(_group_full, p_g, cfg, x, positions)
        for p_t, kind in zip(params["tail"], _hybrid_layout(cfg)[1]):
            x = _block_full(p_t, cfg, kind, x, positions)
    else:
        for p_l in _unstack(params["layers"], n_layers(params)):
            x, a = run(_attn_block_full, p_l, cfg, x, positions)
            aux = aux + a
    return _head(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` (B, S), fp32
    (a ``vlm`` model's logits cut to the text region), plus
    ``aux_loss_coef`` x the MoE aux loss."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        logits = logits[:, batch["patches"].shape[1]:]
    labels = tokens[:, 1:]
    lg = logits[:, :-1]
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    ce = emb.cross_entropy(lg, labels, mask)
    coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    return ce + coef * aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _ring(cfg: ModelConfig, max_len: int) -> bool:
    return (cfg.attention.window is not None
            and max_len > cfg.attention.window)


def _attn_block_prefill(p, cfg: ModelConfig, x, positions, max_len,
                        dtype=torch.bfloat16):
    h = sharding.gather_seq(layers.apply_norm(p["ln1"], x, cfg.norm))
    if cfg.attention.kind == "mla":
        a, (c_kv, k_rope) = mla.mla_full(p["mla"], cfg.attention, h,
                                         positions, cfg.d_model,
                                         return_latent=True)
        entry = mla.cache_from_latent(cfg.attention, c_kv, k_rope, max_len,
                                      dtype)
    else:
        a, (k, v) = layers.attention_full(p["attn"], cfg.attention, h,
                                          positions, cfg.d_model,
                                          return_kv=True)
        entry = layers.cache_from_kv(cfg.attention, k, v, max_len, dtype,
                                     ring=_ring(cfg, max_len))
    x = x + sharding.scatter_seq(a)
    y, _ = _ffn(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))
    return x + y, entry


def _block_prefill(p, cfg: ModelConfig, kind: str, x, positions, max_len,
                   dtype):
    """A hybrid model's block -> (x, its cache entry)."""
    if kind == "rec":
        return _rec_block_full(p, cfg, x)
    return _attn_block_prefill(p, cfg, x, positions, max_len, dtype)


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int, dtype=torch.bfloat16):
    """Run the prompt (a ``vlm`` model's patches, then its tokens)
    through the model, building the decode cache: each attention layer's
    K/V, each recurrent block's final state (an RWKV model's through the
    chunked WKV where its chunk divides S).

    Returns (last-position logits (B, Vpad) f32, cache tree)."""
    check_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = _positions(x)
    if cfg.family == "hybrid":
        pat = cfg.rglru.block_pattern
        groups = []
        for g in range(n_groups(params)):
            p_g, entry = _layer(params["groups"], g), {}
            for j, kind in enumerate(pat):
                x, entry[f"b{j}"] = _block_prefill(
                    p_g[f"b{j}"], cfg, kind, x, positions, max_len, dtype)
            groups.append(entry)
        tail = []
        for p_t, kind in zip(params["tail"], _hybrid_layout(cfg)[1]):
            x, entry = _block_prefill(p_t, cfg, kind, x, positions, max_len,
                                      dtype)
            tail.append(entry)
        cache = {"groups": stack_layers(groups), "tail": tail}
    else:
        entries = []
        for i in range(n_layers(params)):
            p_l = _layer(params["layers"], i)
            if cfg.family == "ssm":
                x, entry = _rwkv_block_full(p_l, cfg, x, chunked=True)
            else:
                x, entry = _attn_block_prefill(p_l, cfg, x, positions,
                                               max_len, dtype)
            entries.append(entry)
        cache = {"layers": stack_layers(entries)}
    logits = _head(params, cfg, sharding.last_position(x), seq_sharded=False)
    return logits[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer cache tree sized for ``max_len`` positions (GQA:
    a ring of ``window`` slots when the window is shorter; MLA: the
    latent cache; a recurrent block: its zero state). Attention caches
    are ``dtype``. A recurrent state is fp32 (RG-LRU's h, RWKV's S) or
    ``cfg.dtype`` (the token-shift carries, the conv history), the
    dtypes the reference's decode step gives them; the reference's own
    init gives the latter ``dtype`` and its first step replaces them,
    where the port's steps write every state in place."""
    check_ported(cfg)
    device = resolve_device(device)
    sdtype = getattr(torch, cfg.dtype)

    def one_attn():
        if cfg.attention.kind == "mla":
            return mla.init_mla_cache(cfg.attention, batch, max_len, dtype,
                                      device=device)
        return layers.init_kv_cache(cfg.attention, cfg.d_model, batch,
                                    max_len, dtype, ring=_ring(cfg, max_len),
                                    device=device)

    def one(kind):
        if kind == "rec":
            return rglru.init_rec_state(cfg.rglru, cfg.d_model, batch,
                                        sdtype, device)
        if kind == "rwkv":
            return {"tm": rwkv6.init_tm_state(cfg.rwkv, cfg.d_model, batch,
                                              sdtype, device),
                    "cm": rwkv6.init_cm_state(cfg.d_model, batch, sdtype,
                                              device)}
        return one_attn()

    if cfg.family == "hybrid":
        groups, tail = _hybrid_layout(cfg)
        pat = cfg.rglru.block_pattern
        return {"groups": stack_layers([
                    {f"b{j}": one(kind) for j, kind in enumerate(pat)}
                    for _ in range(groups)]),
                "tail": [one(kind) for kind in tail]}
    kind = "rwkv" if cfg.family == "ssm" else "attn"
    return {"layers": stack_layers([one(kind)
                                    for _ in range(cfg.n_layers)])}


def _attn_block_decode(p, cfg: ModelConfig, x, pos: int, cache):
    # on a mesh the one-token stream stays replicated over 'model': the
    # row-parallel partials are summed into it
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.attention.kind == "mla":
        a, cache = mla.mla_decode(p["mla"], cfg.attention, h, pos, cache,
                                  cfg.d_model)
    else:
        a, cache = layers.attention_decode(p["attn"], cfg.attention, h, pos,
                                           cache, cfg.d_model)
    x = x + sharding.psum_model(a)
    return x + _ffn_decode(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))


def _rwkv_block_decode(p, cfg: ModelConfig, x, state):
    x, new = _rwkv_block_full(p, cfg, x, state)
    _write(state, new)
    return x


def _rec_block_decode(p, cfg: ModelConfig, x, state):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, new = rglru.rec_step(p["rec"], cfg.rglru, h, state)
    _write(state, new)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act)


def _block_decode(p, cfg: ModelConfig, kind: str, x, pos: int, cache):
    if kind == "rec":
        return _rec_block_decode(p, cfg, x, cache)
    return _attn_block_decode(p, cfg, x, pos, cache)


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One decode step. tokens (B,) int; pos the step's position. A
    ``vlm`` model decodes tokens only, as the reference's engine feeds
    them.

    Returns (logits (B, Vpad) f32, cache). The step's attention entries
    and recurrent states go into ``cache``'s tensors in place (the
    reference returns a new cache); the returned cache is the same
    tree."""
    check_ported(cfg)
    x = sharding.psum_model(emb.embed_rows(params["embed"], tokens[:, None]))
    if cfg.family == "hybrid":
        pat = cfg.rglru.block_pattern
        for g in range(n_groups(params)):
            p_g, c_g = _layer(params["groups"], g), _layer(cache["groups"], g)
            for j, kind in enumerate(pat):
                x = _block_decode(p_g[f"b{j}"], cfg, kind, x, pos,
                                  c_g[f"b{j}"])
        for p_t, c_t, kind in zip(params["tail"], cache["tail"],
                                  _hybrid_layout(cfg)[1]):
            x = _block_decode(p_t, cfg, kind, x, pos, c_t)
    else:
        for i in range(n_layers(params)):
            p_l, c_l = _layer(params["layers"], i), _layer(cache["layers"], i)
            if cfg.family == "ssm":
                x = _rwkv_block_decode(p_l, cfg, x, c_l)
            else:
                x = _attn_block_decode(p_l, cfg, x, pos, c_l)
    return _head(params, cfg, x, seq_sharded=False)[:, 0], cache
