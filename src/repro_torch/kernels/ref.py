"""Plain PyTorch versions of every ported kernel.

The bag sums reduce a non-innermost dim with torch's ``sum``; a masked
or fill position adds +0.0, which leaves a sum's value as it was. So one
bag summed by any of them, with or without trailing fill, gives the same
bits. Torch's order within a bag is its own (on the CPU not strictly in
order of position past a few rows), so the CUDA kernels, which add in
order of j, agree with these within a tolerance; on the card
``chip_smoke.py`` also holds ``fused_segment_sum`` bit for bit against a
loop over j.

``int4_pack``, ``int4_unpack`` and ``_int4_codes`` have no kernel, in
the reference either; they are the cold tier's codec.

The ground truth in the tests, the path a CPU tensor takes through
``kernels.ops``, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card. Same names and semantics as the reference's
``repro/kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) with fp32 accumulation, result in x.dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(M,K) @ b:(N,K)^T with fp32 accumulation, result in a.dtype."""
    return torch.matmul(a.float(), b.float().t()).to(a.dtype)


def gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(K,M)^T @ b:(K,N) with fp32 accumulation, result in a.dtype."""
    return torch.matmul(a.float().t(), b.float()).to(a.dtype)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Fixed-lookup SparseLengthsSum: out[b] = sum_l table[indices[b, l]].

    table (V, D), indices (B, L) int32 -> (B, D) in the table's dtype,
    accumulated in f32. Any in-range id is taken; nothing is masked.
    """
    return table[indices].float().sum(dim=1).to(table.dtype)


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Single-row bags: out[t] = table[indices[t]], the L = 1 case."""
    return embedding_bag(table, indices[:, None])


def sparse_lengths_sum(table: torch.Tensor, indices: torch.Tensor,
                       offsets: torch.Tensor, max_l: int) -> torch.Tensor:
    """Ragged SparseLengthsSum (paper Fig. 2): bag b sums the rows of
    ``indices[offsets[b]:offsets[b+1]]``, at most its first ``max_l``.

    table (V, D); indices (N,) int32, padding past offsets[-1] never
    read; offsets (B+1,) int32. Returns (B, D) in the table's dtype,
    accumulated in f32; an empty bag sums to zeros.

    ``max_l`` bounds every bag by contract (``se.ragged_dense_ids``).
    Past it the reference's two versions differ: its Pallas kernel
    (``repro/kernels/embedding_gather.py:125``) walks ``max_l`` grid
    steps, so it sums a bag's first ``max_l`` rows, while its XLA oracle
    (``repro/kernels/ref.py:22``) sums the whole bag. This version, and
    the CUDA kernel, do what the Pallas kernel does.
    """
    n_bags = offsets.shape[0] - 1
    if n_bags > 0:
        # a bound past the longest bag walks no further than that bag
        # does, and keeps the (B, max_l) position plan small
        max_l = min(max_l, int((offsets[1:] - offsets[:-1]).max()))
    if n_bags == 0 or indices.shape[0] == 0 or max_l <= 0:
        return torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                           device=table.device)
    pos = offsets[:-1, None].long() + torch.arange(max_l,
                                                  device=offsets.device)
    valid = pos < offsets[1:, None]
    safe = torch.clamp(torch.where(valid, pos, 0), max=indices.shape[0] - 1)
    rows = table[indices[safe]].float()
    return torch.where(valid[..., None], rows, 0.0).sum(dim=1).to(table.dtype)


def fused_segment_sum(table: torch.Tensor,
                      dense_ids: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_j table[dense_ids[b, j]]; fill slots point at the zero
    null row. Returns f32 (B, D); an empty id matrix sums to zeros."""
    return table[dense_ids].float().sum(dim=1)


def fused_cached_segment_sum(hot_rows: torch.Tensor, arena: torch.Tensor,
                             slots: torch.Tensor,
                             cold_ids: torch.Tensor) -> torch.Tensor:
    """One-pass hot/cold reduce: out[b] = sum_j hot_rows[slots[b, j]] +
    arena[cold_ids[b, j]], f32 (B, D).

    Per position exactly one term is nonzero (a miss reads the zero slot
    K, a hit the zero null row), so each summed row equals the uncached
    row elementwise, and the same ``sum`` over it equals
    ``fused_segment_sum(arena, dense)`` bit for bit on a coherent cache.
    """
    rows = hot_rows[slots].float() + arena[cold_ids].float()
    return rows.sum(dim=1)


def cached_split(slot_of: torch.Tensor, dense_ids: torch.Tensor, k: int,
                 null_row: int):
    """The hit split of a dense id matrix: (slots ``slot_of[dense]``, cold
    ids with each hit redirected to ``null_row``), as ``CachedSource``
    makes it."""
    slots = slot_of[dense_ids]
    # a Python scalar, not a device tensor: copying one to the card would
    # wait for the stream
    return slots, torch.where(slots < k, null_row, dense_ids)


def fused_cached_segment_stage(hot_rows: torch.Tensor, slot_of: torch.Tensor,
                               arena: torch.Tensor, dense_ids: torch.Tensor,
                               null_row: int) -> torch.Tensor:
    """The cached stage: the hit split of ``dense_ids`` through
    ``slot_of``, then ``fused_cached_segment_sum`` over it, f32 (B, D)."""
    slots, cold_ids = cached_split(slot_of, dense_ids,
                                   hot_rows.shape[0] - 1, null_row)
    return fused_cached_segment_sum(hot_rows, arena, slots, cold_ids)


def int4_pack(a32: torch.Tensor):
    """Row-wise symmetric int4 quantize + nibble-pack (the cold tier).

    The int8 rule at 4 bits: per-row scale = amax/7, values rounded
    (half to even, as ``jnp.round``) into [-7, 7], an all-zero row gets a
    zero scale. Codes are stored biased (+8, so 8 encodes zero), two per
    byte: column 2j in the low nibble, 2j+1 in the high one; an odd dim
    pads one zero-code column. Returns (packed uint8 (R, ceil(D/2)),
    scales f32 (R, 1)), equal to the reference's codes and scales.
    """
    a32 = a32.float()
    amax = a32.abs().amax(dim=-1, keepdim=True)
    scales = amax / 7.0
    q = torch.where(scales > 0,
                    torch.clamp(torch.round(a32 / torch.clamp(scales,
                                                              min=1e-30)),
                                -7, 7), 0.0).to(torch.int32)
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    code = (q + 8).to(torch.uint8)               # 1..15, 8 == zero
    return code[:, 0::2] | (code[:, 1::2] << 4), scales


def _int4_codes(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Unbiased integer codes in [-7, 7]: (..., P) uint8 -> (..., dim)
    int32."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = (p >> 4) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])[..., :dim]


def int4_unpack(packed: torch.Tensor, scales: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Dequantize an ``int4_pack`` arena back to f32 (R, dim): each value
    is the rounded product code * scale."""
    return _int4_codes(packed, dim).float() * scales


def fused_int4_segment_sum(packed: torch.Tensor, scales: torch.Tensor,
                           dense_ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Int4 dequantize-in-the-gather segmented reduce: out[b] = sum_j
    unpack(packed)[dense_ids[b, j]], f32 (B, dim). Fill slots point at a
    row of zero codes and zero scale. Each term is the rounded product of
    ``int4_unpack``, so on the CPU this equals ``fused_segment_sum`` over
    the unpacked table bit for bit."""
    codes = _int4_codes(packed[dense_ids], dim).float()
    return (codes * scales[dense_ids]).sum(dim=1)


def sls_grad_table(g: torch.Tensor, indices: torch.Tensor,
                   offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """VJP of ragged SparseLengthsSum w.r.t. the table: segment scatter-add.

    d_table[r] = sum over valid positions p with indices[p] == r of
    g[bag(p)]; padded positions (>= offsets[-1]) add nothing. On the CPU
    ``index_add_`` adds in ascending position order, the order the CUDA
    kernel keeps, so the two agree bit for bit there.
    """
    n = indices.shape[0]
    n_bags = offsets.shape[0] - 1
    out = torch.zeros((n_rows, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    if n == 0 or n_bags == 0:
        return out.to(g.dtype)
    pos = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    seg = torch.searchsorted(offsets[1:], pos, right=True)
    rows = g.float()[torch.clamp(seg, max=n_bags - 1)]
    rows = torch.where((pos < offsets[-1])[:, None], rows, 0.0)
    return out.index_add_(0, indices, rows).to(g.dtype)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """Pairwise dot products: x (B, F, D) -> (B, F, F) = X X^T per sample."""
    x32 = x.float()
    return torch.matmul(x32, x32.transpose(1, 2)).to(x.dtype)


def interaction_tril(x: torch.Tensor) -> torch.Tensor:
    """DLRM feature interaction output: lower triangle (offset -1)
    flattened row-major, as ``jnp.tril_indices`` orders it."""
    z = interaction(x)
    f = x.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=x.device)
    return z[:, li, lj]


def feature_interaction(bottom_out: torch.Tensor, reduced_embs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense engine's interaction stage, as the reference composes it:
    feats = [bottom_out; reduced_embs] (B, F, D), out = [bottom_out,
    tril(X X^T, -1)] (B, D + F(F-1)/2). Returns (out, feats)."""
    feats = torch.cat([bottom_out[:, None, :], reduced_embs], dim=1)
    return torch.cat([bottom_out, interaction_tril(feats)], dim=-1), feats


def feature_interaction_backward(
        g: torch.Tensor, g_feats: Optional[torch.Tensor],
        bottom_out: torch.Tensor, reduced_embs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of ``feature_interaction``: the pair gradients scattered into
    the triangle, dX = (G + G^T) X as the reference's interaction VJP
    takes it, plus the feats gradient, and G[:, :D] into the bottom's.
    Returns (d_bottom (B, D), d_embs (B, T, D))."""
    d = bottom_out.shape[1]
    feats = torch.cat([bottom_out[:, None, :], reduced_embs], dim=1).float()
    f = feats.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=g.device)
    gz = torch.zeros((g.shape[0], f, f), dtype=torch.float32, device=g.device)
    gz[:, li, lj] = g[:, d:].float()
    dx = torch.matmul(gz + gz.transpose(1, 2), feats)
    if g_feats is not None:
        dx = dx + g_feats.float()
    d_bottom = g[:, :d].float() + dx[:, 0]
    return (d_bottom.to(bottom_out.dtype),
            dx[:, 1:].to(reduced_embs.dtype))


# the masked score of the reference's flash kernel: a finite stand-in for
# -inf, so a fully masked block gives exp(0) terms that a later valid
# block wipes (corr = exp(-1e30 - m) = 0)
NEG_INF = -1e30


def _block(b: int, s: int) -> int:
    """The reference's block size: ``b`` capped at S, shrunk to a divisor
    of S."""
    b = min(b, s)
    while s % b:
        b -= 1
    return b


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Causal or windowed online-softmax attention: q, k, v (BH, S, d) ->
    (BH, S, d) in q.dtype, block by block as the reference's Pallas
    kernel (``repro/kernels/flash_attention.py:31``) computes it.

    Per q block, over every kv block in order (masked ones included):
    scores in fp32 times d**-0.5, masked entries -1e30 (``kpos <= qpos``
    when causal, ``kpos > qpos - window`` with a window); ``m_new =
    max(m, rowmax)``, ``p = exp(s - m_new)``, ``corr = exp(m - m_new)``,
    ``l = l corr + sum p`` in fp32, ``acc = acc corr + p.to(v.dtype) @
    v`` with an fp32 product; the output is ``acc / max(l, 1e-30)``.
    """
    bh, s, d = q.shape
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    bq, bk = _block(bq, s), _block(bk, s)
    scale = d ** -0.5
    pos = torch.arange(s, device=q.device)
    for i in range(0, s, bq):
        qi = q[:, i:i + bq].float()
        qpos = pos[i:i + bq, None]
        acc = torch.zeros((bh, bq, v.shape[-1]), dtype=torch.float32,
                          device=q.device)
        m = torch.full((bh, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, bq, 1), dtype=torch.float32, device=q.device)
        for j in range(0, s, bk):
            sc = torch.matmul(qi, k[:, j:j + bk].float().transpose(1, 2))
            sc = sc * scale
            kpos = pos[None, j:j + bk]
            keep = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            sc = torch.where(keep, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                            v[:, j:j + bk].float())
            m = m_new
        out[:, i:i + bq] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None, bq: int = 512,
                        bk: int = 512) -> torch.Tensor:
    """GQA form: q (B, S, H, hd), k/v (B, S, KH, hd) -> (B, S, H, hd).
    Each kv head serves H/KH query heads, repeated as the reference's
    wrapper (``flash_attention.py:113``) repeats them; ``bq``, ``bk`` as
    ``flash_attention``'s."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, hd)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, hd)
    out = flash_attention(qf, kf, vf, causal=causal, window=window, bq=bq,
                          bk=bk)
    return out.reshape(b, h, s, hd).transpose(1, 2).contiguous()


def mlp(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """Reference MLP: relu between layers, last layer linear."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = gemm(h, w) + b
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h
