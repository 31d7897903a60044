"""Multi-head latent attention (MiniCPM3 / DeepSeek-V2 family), the
counterpart of the reference's ``repro/models/mla.py`` on one card.

Queries go through a low-rank bottleneck; keys and values are rebuilt
from a compressed latent ``c_kv`` (``kv_lora_rank``) and one shared RoPE
key head. The decode cache holds only ``(c_kv, k_rope)``.

The full-sequence path rebuilds K and V and attends through the model's
direct path below ``CHUNKED_THRESHOLD`` and its chunked path at or above
it: the qk depth (nope + rope) differs from the v depth, so MLA never
reaches the flash kernel, in the reference or here.

Two decode paths, the same function:
  * naive: rebuild K and V for the whole cache each step;
  * absorbed (the default): fold W_uk into the query and W_uv into the
    output, so scores and values are computed in the latent space.

As ``layers.attention_decode``, ``mla_decode`` writes the new token's
latent and position into the cache's tensors in place and returns the
same tree (the reference returns a new cache).

On a mesh (the reference's specs, ``repro/models/mla.py:27-44``) the
low-rank projections ``wq_a`` and ``wkv_a`` and the two norms are
replicated, and so the latent ``c_kv`` and the shared RoPE key head
``k_rope`` are computed whole on every rank; ``wq_b``, ``wk_b`` and
``wv_b`` are column blocks of whole heads and ``wo`` a row block
(``sharding.head_split`` with as many kv heads as heads: MLA is MHA).
Each rank attends with its heads, whose count the blocks' widths give,
and returns a partial sum over 'model' for the caller to reduce. The
decode cache holds the latent, which has no head dim: it is split on
the batch and replicated over 'model' (``api.cache_specs``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.params import Builder


def _heads(h: int, head_dim: int) -> sharding.Heads:
    """A dimension of ``h`` heads of ``head_dim``, split by whole heads
    over 'model'."""
    return sharding.Heads(h, h, head_dim, "q")


def init_mla(b: Builder, acfg: AttentionConfig, d: int):
    m = acfg.mla
    h = acfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    v = _heads(h, m.v_head_dim)
    return {
        "wq_a": b.normal((d, m.q_lora_rank)),
        "q_norm": layers.init_norm(b, m.q_lora_rank, "rmsnorm"),
        "wq_b": b.normal((m.q_lora_rank, h * qk), spec=(None, _heads(h, qk))),
        "wkv_a": b.normal((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": layers.init_norm(b, m.kv_lora_rank, "rmsnorm"),
        "wk_b": b.normal((m.kv_lora_rank, h * m.qk_nope_head_dim),
                         spec=(None, _heads(h, m.qk_nope_head_dim))),
        "wv_b": b.normal((m.kv_lora_rank, h * m.v_head_dim), spec=(None, v)),
        "wo": b.normal((h * m.v_head_dim, d), spec=(v, None)),
    }


def local_heads(p, acfg: AttentionConfig) -> int:
    """The heads whose blocks ``p`` holds: all of them without a mesh,
    the rank's on one."""
    return p["wv_b"].shape[-1] // acfg.mla.v_head_dim


def _latent(p, acfg: AttentionConfig, x: torch.Tensor):
    """x (B, S, D) -> (c_kv normed (B, S, r), k_rope (B, S, 1, rope))."""
    m = acfg.mla
    kv_a = x @ p["wkv_a"]
    c_kv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    c_kv = layers.apply_norm(p["kv_norm"], c_kv, "rmsnorm")
    return c_kv, k_rope[..., None, :]


def _queries(p, acfg: AttentionConfig, x: torch.Tensor, positions):
    m = acfg.mla
    b_, s, _ = x.shape
    q = layers.apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm") @ p["wq_b"]
    q = q.reshape(b_, s, local_heads(p, acfg),
                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = (q[..., :m.qk_nope_head_dim],
                      q[..., m.qk_nope_head_dim:])
    return q_nope, layers.rope(q_rope, positions, acfg.rope_theta)


def mla_full(p, acfg: AttentionConfig, x: torch.Tensor,
             positions: torch.Tensor, d: int, return_latent: bool = False):
    """Forward / prefill: rebuild K and V, attend directly below
    ``CHUNKED_THRESHOLD`` and chunked at or above it. With
    ``return_latent``, also (c_kv (B, S, r), k_rope (B, S, rope)) for the
    decode cache."""
    m = acfg.mla
    h = local_heads(p, acfg)
    b_, s, _ = x.shape
    q_nope, q_rope = _queries(p, acfg, x, positions)
    c_kv, k_rope = _latent(p, acfg, x)
    k_rope = layers.rope(k_rope, positions, acfg.rope_theta)
    k_nope = (c_kv @ p["wk_b"]).reshape(b_, s, h, m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"]).reshape(b_, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b_, s, h, m.qk_rope_head_dim)], -1)
    qg = q[:, :, :, None, :]                    # (B, S, H, 1, qk): G = 1
    if s >= layers.CHUNKED_THRESHOLD:
        out = layers._sdpa_chunked(qg, k, v, positions, positions,
                                   acfg.causal, acfg.window,
                                   layers.pick_chunk(s, layers.Q_CHUNK),
                                   layers.pick_chunk(s, layers.KV_CHUNK))
    else:
        out = layers._sdpa_direct(qg, k, v, positions, positions,
                                  acfg.causal, acfg.window)
    out = out.reshape(b_, s, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    if return_latent:
        return out, (c_kv, k_rope[:, :, 0])
    return out


def init_mla_cache(acfg: AttentionConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    m = acfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                   device=device)}


def cache_from_latent(acfg: AttentionConfig, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, max_len: int,
                      dtype=torch.bfloat16):
    """A decode cache from prefill latents c_kv (B, S, r), k_rope (B, S,
    rope): the last min(S, max_len) positions, each in slot ``position %
    max_len``."""
    b_, s, _ = c_kv.shape
    cache = init_mla_cache(acfg, b_, max_len, dtype, device=c_kv.device)
    keep = min(s, max_len)
    positions = torch.arange(s - keep, s, device=c_kv.device)
    slots = positions % max_len
    cache["c_kv"][:, slots] = c_kv[:, s - keep:].to(dtype)
    cache["k_rope"][:, slots] = k_rope[:, s - keep:].to(dtype)
    cache["slot_pos"][slots] = positions.to(torch.int32)
    return cache


def mla_decode(p, acfg: AttentionConfig, x: torch.Tensor, pos: int, cache,
               d: int, absorbed: bool = True):
    """One-token step against the compressed cache. x (B, 1, D) ->
    (out (B, 1, D), cache)."""
    m = acfg.mla
    h = local_heads(p, acfg)
    b_ = x.shape[0]
    posb = torch.full((b_, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, acfg, x, posb)     # (B, 1, H, .)
    c_new, k_rope_new = _latent(p, acfg, x)
    k_rope_new = layers.rope(k_rope_new, posb, acfg.rope_theta)

    c_kv, k_rope, slot_pos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]
    size = c_kv.shape[1]
    slot = pos % size
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = k_rope_new[:, 0, 0].to(k_rope.dtype)
    slot_pos[slot] = pos
    keep = (slot_pos >= 0) & (slot_pos <= pos)

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    wdt = p["wk_b"].dtype
    s_rope = torch.einsum("bqhn,bcn->bhqc", q_rope.float(), k_rope.float())
    if absorbed:
        # q_nope^T W_uk c = (W_uk^T q_nope)^T c: scores in the latent space
        wk = p["wk_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk)
        s_nope = torch.einsum("bqhr,bcr->bhqc", q_lat.float(), c_kv.float())
    else:
        k_nope = (c_kv.to(wdt) @ p["wk_b"]).reshape(b_, size, h,
                                                    m.qk_nope_head_dim)
        s_nope = torch.einsum("bqhn,bchn->bhqc", q_nope.float(),
                              k_nope.float())
    s = (s_nope + s_rope) * scale
    s = torch.where(keep[None, None, None, :], s, layers.NEG_INF)
    prob = torch.softmax(s, dim=-1)
    if absorbed:
        # prob . (c W_uv): contract the cache first, in the latent space
        ctx = torch.einsum("bhqc,bcr->bqhr", prob, c_kv.float())
        wv = p["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, wv.float())
    else:
        v = (c_kv.to(wdt) @ p["wv_b"]).reshape(b_, size, h, m.v_head_dim)
        out = torch.einsum("bhqc,bchv->bqhv", prob, v.float())
    out = out.reshape(b_, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    return out, cache
