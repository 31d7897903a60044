"""Decoder-only model assembly for the attention-family decoders, the
``decoder`` and ``vlm`` families of the reference's
``repro/models/transformer.py``: GQA or multi-head latent attention
(MLA), a dense FFN or a fixed-capacity MoE (with arctic's dense residual
branch beside it), and the vision prefix (precomputed patch embeddings
prepended to the tokens).

Parameters keep the reference's tree: ``"embed"`` (padded vocab, D),
``"layers"`` with every leaf stacked over the layers (L, ...),
``"ln_f"`` and, untied, ``"unembed"``; the decode cache is
``{"layers": {"k", "v", "slot_pos"}}`` (MLA: ``{"c_kv", "k_rope",
"slot_pos"}``), stacked the same way. The reference scans the stacked
layers with ``lax.scan``; here a Python loop indexes them. Training
(``loss_fn``) runs ``forward`` with each layer under
``torch.utils.checkpoint`` when ``remat``, as the reference's
``jax.checkpoint`` of the scan body: a layer's activations are
recomputed in the backward, so its attention forward runs twice. The
recurrent, hybrid and encoder-decoder families are ROADMAP Queue 1, item
15c.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers, mla, moe
from repro_torch.models.params import Builder, init_stacked, stack_layers


def check_ported(cfg: ModelConfig) -> None:
    """Refuse what the port does not have yet."""
    if (cfg.family not in ("decoder", "vlm")
            or cfg.attention.kind not in ("gqa", "mla")):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, attention "
            f"{cfg.attention.kind!r} is not ported yet; the port has the "
            "decoder and vlm families with GQA or MLA, dense or MoE "
            "(ROADMAP Queue 1, item 15c)")


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


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` on the card unless ``device`` says
    otherwise; norm weights and the MoE router fp32, every other leaf
    ``cfg.dtype``. Each stacked leaf is allocated once and filled layer
    by layer (``params.init_stacked``)."""
    check_ported(cfg)
    b = Builder(generator, dtype=getattr(torch, cfg.dtype),
                device=resolve_device(device))
    tree = {"embed": emb.init_table(b, cfg.vocab_size, cfg.d_model),
            "layers": init_stacked(b, lambda bb: _init_attn_block(bb, cfg),
                                   cfg.n_layers),
            "ln_f": layers.init_norm(b, cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        tree["unembed"] = emb.init_unembed(b, cfg.vocab_size, cfg.d_model)
    return tree


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, h):
    """The block's FFN -> (y, aux): the MoE (plus arctic's dense residual
    branch) or the dense MLP, whose aux is 0."""
    if cfg.moe is None:
        return layers.apply_mlp(p["mlp"], h, cfg.act), 0.0
    y, aux = moe.apply_moe(p["moe"], cfg.moe, h)
    if cfg.moe.dense_residual_ff:
        y = y + layers.apply_mlp(p["res_mlp"], h, cfg.act)
    return y, aux


def _attn_block_full(p, cfg: ModelConfig, x, positions):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.attention.kind == "mla":
        a = mla.mla_full(p["mla"], cfg.attention, h, positions, cfg.d_model)
    else:
        a = layers.attention_full(p["attn"], cfg.attention, h, positions,
                                  cfg.d_model)
    x = x + a
    y, aux = _ffn(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))
    return x + y, aux


def _embed_input(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Tokens -> (B, S, D); a ``vlm`` batch's patches (B, P, D), cast to
    the embedding dtype, go before the tokens."""
    x = emb.embed_tokens(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], 1)
    return x


def _head(params, cfg: ModelConfig, x):
    x = layers.apply_norm(params["ln_f"], x, cfg.norm)
    if cfg.tie_embeddings:
        return emb.lm_head(x, params["embed"], cfg.vocab_size)
    return emb.lm_head_untied(x, params["unembed"], cfg.vocab_size)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True):
    """Teacher-forced forward -> (logits (B, S, Vpad) f32, aux: the MoE
    load-balance losses summed over the layers, a 0-dim fp32 tensor,
    zero for a dense model). With ``remat`` and autograd recording, each
    layer runs under ``torch.utils.checkpoint``."""
    check_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in _unstack(params["layers"], n_layers(params)):
        if remat:
            x, a = checkpoint(_attn_block_full, p_l, cfg, x, positions,
                              use_reentrant=False)
        else:
            x, a = _attn_block_full(p_l, cfg, x, positions)
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
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
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
    x = x + a
    y, _ = _ffn(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))
    return x + y, entry


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int, dtype=torch.bfloat16):
    """Run the prompt (a ``vlm`` model's patches, then its tokens)
    through the model, building the decode cache.

    Returns (last-position logits (B, Vpad) f32, cache tree)."""
    check_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    entries = []
    for i in range(n_layers(params)):
        x, entry = _attn_block_prefill(_layer(params["layers"], i), cfg, x,
                                       positions, max_len, dtype)
        entries.append(entry)
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"layers": stack_layers(entries)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer cache tree sized for ``max_len`` positions (GQA:
    a ring of ``window`` slots when the window is shorter; MLA: the
    latent cache)."""
    check_ported(cfg)
    device = resolve_device(device)

    def one():
        if cfg.attention.kind == "mla":
            return mla.init_mla_cache(cfg.attention, batch, max_len, dtype,
                                      device=device)
        return layers.init_kv_cache(cfg.attention, cfg.d_model, batch,
                                    max_len, dtype, ring=_ring(cfg, max_len),
                                    device=device)
    return {"layers": stack_layers([one() for _ in range(cfg.n_layers)])}


def _attn_block_decode(p, cfg: ModelConfig, x, pos: int, cache):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.attention.kind == "mla":
        a, cache = mla.mla_decode(p["mla"], cfg.attention, h, pos, cache,
                                  cfg.d_model)
    else:
        a, cache = layers.attention_decode(p["attn"], cfg.attention, h, pos,
                                           cache, cfg.d_model)
    x = x + a
    y, _ = _ffn(p, cfg, layers.apply_norm(p["ln2"], x, cfg.norm))
    return x + y, cache


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One decode step. tokens (B,) int; pos the step's position. A
    ``vlm`` model decodes tokens only, as the reference's engine feeds
    them.

    Returns (logits (B, Vpad) f32, cache). The new token's entries go
    into ``cache``'s tensors in place (the reference returns a new
    cache); the returned cache is the same tree."""
    check_ported(cfg)
    x = emb.embed_tokens(params["embed"], tokens[:, None])
    for i in range(n_layers(params)):
        x, _ = _attn_block_decode(_layer(params["layers"], i), cfg, x, pos,
                                  _layer(cache["layers"], i))
    return _head(params, cfg, x)[:, 0], cache
