"""Decoder-only model assembly for the dense GQA decoders, the
``decoder`` family of the reference's ``repro/models/transformer.py``.

Parameters keep the reference's tree: ``"embed"`` (padded vocab, D),
``"layers"`` with every leaf stacked over the layers (L, ...),
``"ln_f"`` and, untied, ``"unembed"``; the decode cache is
``{"layers": {"k", "v", "slot_pos"}}``, stacked the same way. The
reference scans the stacked layers with ``lax.scan``; here a Python loop
indexes them. Training (``loss_fn``) runs ``forward`` with each layer
under ``torch.utils.checkpoint`` when ``remat``, as the reference's
``jax.checkpoint`` of the scan body: a layer's activations are
recomputed in the backward, so its attention forward runs twice. MoE,
MLA, the recurrent and hybrid families and the frontends are ROADMAP
Queue 1, item 15b.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers
from repro_torch.models.params import Builder, stack_layers


def check_ported(cfg: ModelConfig) -> None:
    """Refuse what the port does not have yet."""
    if (cfg.family != "decoder" or cfg.attention.kind != "gqa"
            or cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, attention "
            f"{cfg.attention.kind!r}{', MoE' if cfg.moe else ''} is not "
            "ported yet; the port has the dense GQA decoders (ROADMAP "
            "Queue 1, item 15b)")


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
    return {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
            "ln2": layers.init_norm(b, cfg.d_model, cfg.norm),
            "attn": layers.init_attention(b, cfg.attention, cfg.d_model),
            "mlp": layers.init_mlp(b, cfg.d_model, cfg.d_ff, cfg.act)}


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` on the card unless ``device`` says
    otherwise; norm weights fp32, every other leaf ``cfg.dtype``."""
    check_ported(cfg)
    b = Builder(generator, dtype=getattr(torch, cfg.dtype),
                device=resolve_device(device))
    tree = {"embed": emb.init_table(b, cfg.vocab_size, cfg.d_model),
            "layers": stack_layers([_init_attn_block(b, cfg)
                                    for _ in range(cfg.n_layers)]),
            "ln_f": layers.init_norm(b, cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        tree["unembed"] = emb.init_unembed(b, cfg.vocab_size, cfg.d_model)
    return tree


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------

def _attn_block_full(p, cfg: ModelConfig, x, positions):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    x = x + layers.attention_full(p["attn"], cfg.attention, h, positions,
                                  cfg.d_model)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act)


def _embed_input(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Tokens -> (B, S, D)."""
    return emb.embed_tokens(params["embed"], batch["tokens"])


def _head(params, cfg: ModelConfig, x):
    x = layers.apply_norm(params["ln_f"], x, cfg.norm)
    if cfg.tie_embeddings:
        return emb.lm_head(x, params["embed"], cfg.vocab_size)
    return emb.lm_head_untied(x, params["unembed"], cfg.vocab_size)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True):
    """Teacher-forced forward -> (logits (B, S, Vpad) f32, aux 0.0). With
    ``remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint``."""
    check_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()
    for p_l in _unstack(params["layers"], n_layers(params)):
        if remat:
            x = checkpoint(_attn_block_full, p_l, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = _attn_block_full(p_l, cfg, x, positions)
    return _head(params, cfg, x), 0.0


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` (B, S), fp32;
    plus the MoE aux loss, 0 here."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    tokens = batch["tokens"]
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
    a, (k, v) = layers.attention_full(p["attn"], cfg.attention, h,
                                      positions, cfg.d_model,
                                      return_kv=True)
    entry = layers.cache_from_kv(cfg.attention, k, v, max_len, dtype,
                                 ring=_ring(cfg, max_len))
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act), entry


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int, dtype=torch.bfloat16):
    """Run the prompt through the model, building the decode cache.

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
    """Stacked per-layer cache tree sized for ``max_len`` positions (a
    ring of ``window`` slots when the window is shorter)."""
    check_ported(cfg)
    device = resolve_device(device)
    return {"layers": stack_layers([
        layers.init_kv_cache(cfg.attention, cfg.d_model, batch, max_len,
                             dtype, ring=_ring(cfg, max_len), device=device)
        for _ in range(cfg.n_layers)])}


def _attn_block_decode(p, cfg: ModelConfig, x, pos: int, cache):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, cache = layers.attention_decode(p["attn"], cfg.attention, h, pos,
                                       cache, cfg.d_model)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act), cache


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One decode step. tokens (B,) int; pos the step's position.

    Returns (logits (B, Vpad) f32, cache). The new token's k/v go into
    ``cache``'s tensors in place (the reference returns a new cache); the
    returned cache is the same tree."""
    check_ported(cfg)
    x = emb.embed_tokens(params["embed"], tokens[:, None])
    for i in range(n_layers(params)):
        x, _ = _attn_block_decode(_layer(params["layers"], i), cfg, x, pos,
                                  _layer(cache["layers"], i))
    return _head(params, cfg, x)[:, 0], cache
