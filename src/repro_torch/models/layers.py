"""Transformer building blocks: norms, RoPE, the FFNs, GQA attention and
cross-attention, the counterpart of the reference's
``repro/models/layers.py``.

Attention has two full-sequence paths and a decode path:
  * direct: materialises the (S, S) scores, below ``CHUNKED_THRESHOLD``;
  * flash: at S >= ``CHUNKED_THRESHOLD``, ``ops.flash_attention_gqa`` on
    every device, the hand-written kernel on the card and its plain
    version on the CPU (the reference takes its Pallas kernel on the TPU
    there, and its chunked path elsewhere). The op's backward recomputes
    through the chunked path, ``_sdpa_chunked``: online softmax over
    (``Q_CHUNK``, ``KV_CHUNK``) blocks, each kv step checkpointed, so the
    gradient is the one ``jax.grad`` takes off the TPU;
  * decode: one query token against a linear or ring-buffered KV cache;
and the encoder-decoder's cross-attention against the encoder's memory
(``memory_kv``, ``cross_attention_full``, ``cross_attention_decode``),
which never takes the kernel.

On a mesh (``distributed.sharding.use_mesh`` with a 'model' axis of
more than one rank) each rank holds its blocks of the params
(``params.shard_params``): the FFN's ``wi``/``wg``/``wu`` columns and
``wd`` rows of its share of d_ff, and attention's projections for its
heads (``sharding.head_split``: ``wq``/``bq`` columns and ``wo`` rows of
its query heads, ``wk``/``wv``/``bk``/``bv`` columns of its kv heads, or
the whole kv projections where they are replicated). ``apply_mlp``,
``attention_full`` and ``attention_decode`` then compute the rank's part
and return a partial sum over 'model', which the caller reduces
(``sharding.scatter_seq`` / ``psum_model``); the flash op runs at the
rank's head counts, and the decode cache holds the rank's kv heads. A
rank may hold no query head, and then attends to nothing. The
reference's ``constrain`` / ``head_constrain`` calls here are layouts
GSPMD acts on; the port's blocks are those layouts.

Numerics follow the reference: norms and RoPE compute in fp32 and cast
back; attention scores are fp32 from the bf16 operands (both widened, so
each product is exact), masked entries -1e30, and the PV product takes P
rounded to ``v.dtype``; ``gelu`` is the tanh approximation, as
``jax.nn.gelu``'s default.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models.params import Builder

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: Builder, d: int, kind: str):
    if kind == "rmsnorm":
        return {"w": b.ones((d,), dtype=torch.float32)}
    return {"w": b.ones((d,), dtype=torch.float32),
            "b": b.zeros((d,), dtype=torch.float32)}


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        scale = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        return (x32 * scale * p["w"]).to(x.dtype)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["w"]
            + p["b"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq            # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------

COL, ROW = (None, "model"), ("model", None)


def init_mlp(b: Builder, d: int, dff: int, act: str):
    if act in ("swiglu", "geglu"):
        return {"wg": b.normal((d, dff), spec=COL),
                "wu": b.normal((d, dff), spec=COL),
                "wd": b.normal((dff, d), spec=ROW)}
    return {"wi": b.normal((d, dff), spec=COL),
            "wd": b.normal((dff, d), spec=ROW)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        gate = F.silu if act == "swiglu" else _gelu
        return (gate(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    act_fn = _gelu if act == "gelu" else torch.relu
    return act_fn(x @ p["wi"]) @ p["wd"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(b: Builder, acfg: AttentionConfig, d: int):
    hd = acfg.resolved_head_dim(d)
    h, k = acfg.n_heads, acfg.n_kv_heads
    q = sharding.Heads(h, k, hd, "q")
    kv = sharding.Heads(h, k, hd, "kv")
    p = {"wq": b.normal((d, h * hd), spec=(None, q)),
         "wk": b.normal((d, k * hd), spec=(None, kv)),
         "wv": b.normal((d, k * hd), spec=(None, kv)),
         "wo": b.normal((h * hd, d), spec=(q, None))}
    if acfg.qkv_bias:
        p["bq"] = b.zeros((h * hd,), spec=(q,))
        p["bk"] = b.zeros((k * hd,), spec=(kv,))
        p["bv"] = b.zeros((k * hd,), spec=(kv,))
    return p


def local_heads(acfg: AttentionConfig):
    """(query heads, kv heads, the kv columns to take or None) of this
    rank under the active mesh (``sharding.head_split``): all of them
    without one. Where the kv projections are replicated the rank takes
    its kv head's columns, ``slice(k0 * hd, k1 * hd)`` in head units."""
    h, kh = acfg.n_heads, acfg.n_kv_heads
    tp = sharding.tp_size()
    if tp == 1:
        return h, kh, None
    q0, q1, k0, k1 = sharding.head_split(h, kh, tp)[sharding.tp_rank()]
    cols = (k0, k1) if sharding.kv_replicated(kh, tp) else None
    return q1 - q0, k1 - k0, cols


def _project_qkv(p, acfg: AttentionConfig, x: torch.Tensor, d: int):
    b_, s, _ = x.shape
    hd = acfg.resolved_head_dim(d)
    h, k, cols = local_heads(acfg)
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if cols is not None:
        # replicated kv projections: this rank's kv head
        sl = slice(cols[0] * hd, cols[1] * hd)
        wk, wv = wk[:, sl], wv[:, sl]
        if acfg.qkv_bias:
            bk, bv = bk[sl], bv[sl]
    q, kk, v = x @ p["wq"], x @ wk, x @ wv
    if acfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + bk, v + bv
    return (q.reshape(b_, s, h, hd), kk.reshape(b_, s, k, hd),
            v.reshape(b_, s, k, hd))


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """qpos (..., Sq), kpos (..., Sk) -> bool (..., Sq, Sk); True = keep."""
    m = torch.ones(qpos.shape + kpos.shape[-1:], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[..., None, :] <= qpos[..., None]
    if window is not None:
        m &= kpos[..., None, :] > qpos[..., None] - window
    return m


def _sdpa_direct(q, k, v, qpos, kpos, causal, window):
    """q (B, Sq, K, G, h); k, v (B, Sk, K, h) -> (B, Sq, K, G, h) in
    v.dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float()) * scale
    mask = _mask(qpos, kpos, causal, window)              # (Sq, Sk)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqc,bckh->bqkgh", p.to(v.dtype), v)


def _sdpa_chunked(q, k, v, qpos, kpos, causal, window, q_chunk: int,
                  kv_chunk: int):
    """Online-softmax attention over (q_chunk, kv_chunk) blocks, the
    reference's chunked path; same signature as ``_sdpa_direct``, the
    output in q.dtype. Scores are fp32 from the widened operands, masked
    entries -1e30, P is rounded to v.dtype before the PV product and the
    running state is fp32. Every kv step runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
    backward keeps one block's scores at a time; the bits are the
    same."""
    b_, sq, kh, g, hd = q.shape
    hv = v.shape[-1]
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"({sq}, {sk})")
    scale = hd ** -0.5

    def kv_step(acc, m, den, qc, qp, kc, vc, kp):
        s = torch.einsum("bqkgh,bckh->bkgqc", qc.float(), kc.float()) * scale
        s = torch.where(_mask(qp, kp, causal, window)[None, None, None], s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den_new = den * corr + p.sum(-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype), vc)
        return acc * corr[..., None] + pv.float(), m_new, den_new

    outs = []
    for i in range(0, sq, q_chunk):
        qc, qp = q[:, i:i + q_chunk], qpos[i:i + q_chunk]
        acc = torch.zeros((b_, kh, g, q_chunk, hv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b_, kh, g, q_chunk), float("-inf"),
                       dtype=torch.float32, device=q.device)
        den = torch.zeros((b_, kh, g, q_chunk), dtype=torch.float32,
                          device=q.device)
        for j in range(0, sk, kv_chunk):
            acc, m, den = checkpoint(kv_step, acc, m, den, qc, qp,
                                     k[:, j:j + kv_chunk],
                                     v[:, j:j + kv_chunk],
                                     kpos[j:j + kv_chunk],
                                     use_reentrant=False)
        out = acc / torch.clamp(den[..., None], min=1e-30)
        outs.append(torch.einsum("bkgqh->bqkgh", out).to(q.dtype))
    return torch.cat(outs, 1)


# Sequences at or beyond this length take the flash kernel; its backward
# recomputes through the chunked path at these block sizes.
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s not exceeding target (the chunked path's block
    size)."""
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return s


def attention_full(p, acfg: AttentionConfig, x: torch.Tensor,
                   positions: torch.Tensor, d: int,
                   return_kv: bool = False):
    """Full-sequence self-attention (forward and prefill). At S >=
    ``CHUNKED_THRESHOLD`` it attends through ``flash_attention_gqa``,
    which masks by sequence index: ``positions`` is ``arange(S)`` there,
    as every caller passes it."""
    b_, s, _ = x.shape
    hd = acfg.resolved_head_dim(d)
    q, k, v = _project_qkv(p, acfg, x, d)
    h, kh = q.shape[2], k.shape[2]
    q = rope(q, positions, acfg.rope_theta)
    k = rope(k, positions, acfg.rope_theta)
    if h == 0:
        # a rank of the mesh that holds no query head
        out = q
    elif s >= CHUNKED_THRESHOLD:
        out = ops.flash_attention_gqa(q, k, v, causal=acfg.causal,
                                      window=acfg.window)
    else:
        out = _sdpa_direct(q.reshape(b_, s, kh, h // kh, hd), k, v,
                           positions, positions, acfg.causal, acfg.window)
    out = out.reshape(b_, s, h * hd).to(x.dtype) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def memory_kv(p, acfg: AttentionConfig, memory: torch.Tensor, d: int):
    """Cross-attention K/V (B, S_src, KV, hd) from the encoder's output
    (no RoPE)."""
    b_, sk, _ = memory.shape
    hd = acfg.resolved_head_dim(d)
    kh = acfg.n_kv_heads
    k = (memory @ p["wk"]).reshape(b_, sk, kh, hd)
    v = (memory @ p["wv"]).reshape(b_, sk, kh, hd)
    if acfg.qkv_bias:
        k = k + p["bk"].reshape(kh, hd)
        v = v + p["bv"].reshape(kh, hd)
    return k, v


def _cross_q(p, acfg: AttentionConfig, x: torch.Tensor, d: int):
    """The queries of cross-attention, grouped (B, S, KV, G, hd)."""
    b_, s, _ = x.shape
    hd = acfg.resolved_head_dim(d)
    h, kh = acfg.n_heads, acfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b_, s, h, hd)
    if acfg.qkv_bias:
        q = q + p["bq"].reshape(h, hd)
    return q.reshape(b_, s, kh, h // kh, hd)


def cross_attention_full(p, acfg: AttentionConfig, x: torch.Tensor,
                         memory_kv, d: int) -> torch.Tensor:
    """Cross-attention of x (B, S, D) against precomputed memory (K, V),
    not causal: the chunked path at S >= ``CHUNKED_THRESHOLD`` (its kv
    blocks a divisor of the memory's length), the direct one below; never
    the flash kernel, as in the reference (its kernel takes one length
    for q and k)."""
    b_, s, _ = x.shape
    hd = acfg.resolved_head_dim(d)
    qg = _cross_q(p, acfg, x, d)
    k, v = memory_kv
    sk = k.shape[1]
    qpos = torch.arange(s, device=x.device)
    kpos = torch.arange(sk, device=x.device)
    if s >= CHUNKED_THRESHOLD:
        out = _sdpa_chunked(qg, k, v, qpos, kpos, False, None,
                            pick_chunk(s, Q_CHUNK), pick_chunk(sk, KV_CHUNK))
    else:
        out = _sdpa_direct(qg, k, v, qpos, kpos, False, None)
    out = out.reshape(b_, s, acfg.n_heads * hd).to(x.dtype)
    return out @ p["wo"]


def cross_attention_decode(p, acfg: AttentionConfig, x: torch.Tensor,
                           cross_kv, d: int) -> torch.Tensor:
    """One token's cross-attention against the fixed memory K/V."""
    b_ = x.shape[0]
    hd = acfg.resolved_head_dim(d)
    qg = _cross_q(p, acfg, x, d)
    k, v = cross_kv
    out = _sdpa_direct(qg, k, v,
                       torch.zeros((1,), dtype=torch.int32, device=x.device),
                       torch.zeros((k.shape[1],), dtype=torch.int32,
                                   device=x.device), False, None)
    out = out.reshape(b_, 1, acfg.n_heads * hd).to(x.dtype)
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# Decode (KV cache) path
# ---------------------------------------------------------------------------

def _cache_size(acfg: AttentionConfig, max_len: int, ring: bool) -> int:
    return min(max_len, acfg.window) if (ring and acfg.window) else max_len


def init_kv_cache(acfg: AttentionConfig, d: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, ring: bool = False,
                  device=None):
    """Cache tree for one attention layer. ring=True bounds the buffer at
    ``window`` slots; slot_pos holds the absolute position in each slot
    (-1 = empty)."""
    hd = acfg.resolved_head_dim(d)
    size = _cache_size(acfg, max_len, ring)
    shape = (batch, size, local_heads(acfg)[1], hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((size,), -1, dtype=torch.int32,
                                   device=device)}


def cache_from_kv(acfg: AttentionConfig, k: torch.Tensor, v: torch.Tensor,
                  max_len: int, dtype=torch.bfloat16, ring: bool = False):
    """A decode cache from prefill K/V (B, S, KV, hd): the last
    min(S, size) positions, each in slot ``position % size``."""
    b_, s, kh, hd = k.shape
    size = _cache_size(acfg, max_len, ring)
    cache = {"k": torch.zeros((b_, size, kh, hd), dtype=dtype,
                              device=k.device),
             "v": torch.zeros((b_, size, kh, hd), dtype=dtype,
                              device=k.device),
             "slot_pos": torch.full((size,), -1, dtype=torch.int32,
                                    device=k.device)}
    keep = min(s, size)
    positions = torch.arange(s - keep, s, device=k.device)
    slots = positions % size
    cache["k"][:, slots] = k[:, s - keep:].to(dtype)
    cache["v"][:, slots] = v[:, s - keep:].to(dtype)
    cache["slot_pos"][slots] = positions.to(torch.int32)
    return cache


def attention_decode(p, acfg: AttentionConfig, x: torch.Tensor, pos: int,
                     cache, d: int):
    """One-token attention step. x (B, 1, D); pos the token's position.

    Returns (out (B, 1, D), cache). Unlike the reference, which returns a
    new cache, the token's k/v and position are written into ``cache``'s
    tensors in place, and the same tree is returned. Works for linear
    caches (size > every position) and ring buffers (size == window).
    """
    b_ = x.shape[0]
    hd = acfg.resolved_head_dim(d)
    q, k_new, v_new = _project_qkv(p, acfg, x, d)
    h, kh = q.shape[2], k_new.shape[2]
    posb = torch.full((b_, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posb, acfg.rope_theta)
    k_new = rope(k_new, posb, acfg.rope_theta)

    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % k.shape[1]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slot_pos[slot] = pos

    qg = q.reshape(b_, 1, kh, h // kh, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg.float(), k.float()) * hd ** -0.5
    keep = (slot_pos >= 0) & (slot_pos <= pos)
    if acfg.window is not None:
        keep &= slot_pos > pos - acfg.window
    s = torch.where(keep, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", prob.to(v.dtype), v)
    out = out.reshape(b_, 1, h * hd).to(x.dtype) @ p["wo"]
    return out, cache
