"""Encoder-decoder assembly (seamless-m4t), the counterpart of the
reference's ``repro/models/encdec.py``: a stub audio frontend (the
batch's precomputed frame embeddings), an encoder self-attention stack
(not causal), and a decoder of causal self-attention and cross-attention
against the encoder's memory.

Parameters keep the reference's tree: ``"embed"``, ``"enc"`` and
``"dec"`` with every leaf stacked over their layers, ``"enc_ln_f"``,
``"ln_f"`` and, untied, ``"unembed"``. The decode cache is ``{"self":
{"k", "v", "slot_pos"} stacked over the decoder's layers, "cross_k",
"cross_v"}``, the cross K/V (dec_layers, B, enc_memory_len, KV, hd).

The encoder's attention runs the flash kernel not causal at S >= 2048
(seamless's 3,200 frames), the decoder's self-attention causal;
cross-attention takes the chunked path at S >= 2048 and the direct one
below, never the kernel, as in the reference. The frames are cast to the
params' dtype at the encoder's entry, as the decoders cast a vlm
model's patches (the reference adds them in their own dtype, fp32, which
would run its bf16 encoder in fp32 and keep the kernel, bf16 only, off
the path); a test that compares the two hands the reference frames in
the params' dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers
from repro_torch.models.params import Builder, init_stacked, stack_layers
from repro_torch.models.transformer import _head, _layer, _unstack


def check_ported(cfg: ModelConfig) -> None:
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the "
                         "encoder-decoder; it goes through "
                         "models.transformer")


def _enc_attn_cfg(cfg: ModelConfig):
    return dataclasses.replace(cfg.attention, causal=False)


def _init_enc_block(b: Builder, cfg: ModelConfig):
    return {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
            "attn": layers.init_attention(b, cfg.attention, cfg.d_model),
            "ln2": layers.init_norm(b, cfg.d_model, cfg.norm),
            "mlp": layers.init_mlp(b, cfg.d_model, cfg.d_ff, cfg.act)}


def _init_dec_block(b: Builder, cfg: ModelConfig):
    return {"ln1": layers.init_norm(b, cfg.d_model, cfg.norm),
            "self": layers.init_attention(b, cfg.attention, cfg.d_model),
            "lnx": layers.init_norm(b, cfg.d_model, cfg.norm),
            "cross": layers.init_attention(b, cfg.attention, cfg.d_model),
            "ln2": layers.init_norm(b, cfg.d_model, cfg.norm),
            "mlp": layers.init_mlp(b, cfg.d_model, cfg.d_ff, cfg.act)}


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` on the card unless ``device`` says
    otherwise, drawn in the reference's order (embed, encoder, its norm,
    decoder, the final norm, unembed)."""
    check_ported(cfg)
    b = Builder(generator, dtype=getattr(torch, cfg.dtype),
                device=resolve_device(device))
    tree = {"embed": emb.init_table(b, cfg.vocab_size, cfg.d_model),
            "enc": init_stacked(b, lambda bb: _init_enc_block(bb, cfg),
                                cfg.enc_layers),
            "enc_ln_f": layers.init_norm(b, cfg.d_model, cfg.norm),
            "dec": init_stacked(b, lambda bb: _init_dec_block(bb, cfg),
                                cfg.dec_layers),
            "ln_f": layers.init_norm(b, cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        tree["unembed"] = emb.init_unembed(b, cfg.vocab_size, cfg.d_model)
    return tree


def _enc_block(p, cfg: ModelConfig, x, positions):
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    x = x + layers.attention_full(p["attn"], _enc_attn_cfg(cfg), h,
                                  positions, cfg.d_model)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act)


def _run(remat: bool, fn, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames (B, S_src, D), the stub frontend's embeddings -> the
    encoder's memory (B, S_src, D) in the params' dtype."""
    x = frames.to(params["embed"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for p_l in _unstack(params["enc"], params["enc"]["ln1"]["w"].shape[0]):
        x = _run(remat, _enc_block, p_l, cfg, x, positions)
    return layers.apply_norm(params["enc_ln_f"], x, cfg.norm)


def _self_attn(p, cfg: ModelConfig, x, positions, max_len=None,
               dtype=torch.bfloat16):
    """The decoder block's causal self-attention half -> (x, its cache
    entry when ``max_len`` is given)."""
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    if max_len is None:
        return x + layers.attention_full(p["self"], cfg.attention, h,
                                         positions, cfg.d_model), None
    a, (k, v) = layers.attention_full(p["self"], cfg.attention, h, positions,
                                      cfg.d_model, return_kv=True)
    return x + a, layers.cache_from_kv(cfg.attention, k, v, max_len, dtype)


def _cross_and_mlp(p, cfg: ModelConfig, x, kv):
    h = layers.apply_norm(p["lnx"], x, cfg.norm)
    x = x + layers.cross_attention_full(p["cross"], cfg.attention, h, kv,
                                        cfg.d_model)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act)


def _dec_block_full(p, cfg: ModelConfig, x, positions, memory):
    x, _ = _self_attn(p, cfg, x, positions)
    kv = layers.memory_kv(p["cross"], cfg.attention, memory, cfg.d_model)
    return _cross_and_mlp(p, cfg, x, kv)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True):
    """batch {"frames" (B, S_src, D), "tokens" (B, S_tgt)} -> (logits
    (B, S_tgt, Vpad) f32, aux: a 0-dim fp32 zero, as the decoders'
    without a MoE). With ``remat`` and autograd recording, each layer
    runs under ``torch.utils.checkpoint``."""
    check_ported(cfg)
    memory = encode(params, cfg, batch["frames"], remat)
    x = emb.embed_tokens(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for p_l in _unstack(params["dec"], params["dec"]["ln1"]["w"].shape[0]):
        x = _run(remat, _dec_block_full, p_l, cfg, x, positions, memory)
    return (_head(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of the target tokens, fp32."""
    logits, _ = forward(params, cfg, batch, remat)
    labels = batch["tokens"][:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    return emb.cross_entropy(logits[:, :-1], labels, mask)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Self-attention caches of ``max_len`` positions and zero cross K/V
    of ``enc_memory_len`` positions, a decoder layer each."""
    check_ported(cfg)
    device = resolve_device(device)
    hd = cfg.attention.resolved_head_dim(cfg.d_model)
    cross = (cfg.dec_layers, batch, cfg.enc_memory_len,
             cfg.attention.n_kv_heads, hd)
    return {"self": stack_layers([
                layers.init_kv_cache(cfg.attention, cfg.d_model, batch,
                                     max_len, dtype, device=device)
                for _ in range(cfg.dec_layers)]),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int, dtype=torch.bfloat16):
    """Encode the frames, then a teacher-forced decoder pass over the
    tokens building every cache: each layer's self-attention K/V and its
    cross K/V of the memory. Returns (last-position logits (B, Vpad)
    f32, cache)."""
    check_ported(cfg)
    memory = encode(params, cfg, batch["frames"], remat=False)
    x = emb.embed_tokens(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    entries, cross_k, cross_v = [], [], []
    for i in range(params["dec"]["ln1"]["w"].shape[0]):
        p_l = _layer(params["dec"], i)
        x, entry = _self_attn(p_l, cfg, x, positions, max_len, dtype)
        kv = layers.memory_kv(p_l["cross"], cfg.attention, memory,
                              cfg.d_model)
        x = _cross_and_mlp(p_l, cfg, x, kv)
        entries.append(entry)
        cross_k.append(kv[0].to(dtype))
        cross_v.append(kv[1].to(dtype))
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"self": stack_layers(entries),
                          "cross_k": torch.stack(cross_k),
                          "cross_v": torch.stack(cross_v)}


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One decoder token against the self cache and the fixed cross K/V.
    Returns (logits (B, Vpad) f32, cache), the token's self-attention
    entries written into the cache in place."""
    check_ported(cfg)
    x = emb.embed_tokens(params["embed"], tokens[:, None])
    for i in range(params["dec"]["ln1"]["w"].shape[0]):
        p_l = _layer(params["dec"], i)
        h = layers.apply_norm(p_l["ln1"], x, cfg.norm)
        a, _ = layers.attention_decode(p_l["self"], cfg.attention, h, pos,
                                       _layer(cache["self"], i), cfg.d_model)
        x = x + a
        h = layers.apply_norm(p_l["lnx"], x, cfg.norm)
        x = x + layers.cross_attention_decode(
            p_l["cross"], cfg.attention, h,
            (cache["cross_k"][i], cache["cross_v"][i]), cfg.d_model)
        h = layers.apply_norm(p_l["ln2"], x, cfg.norm)
        x = x + layers.apply_mlp(p_l["mlp"], h, cfg.act)
    return _head(params, cfg, x)[:, 0], cache
