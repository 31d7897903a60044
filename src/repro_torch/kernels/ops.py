"""Public wrappers around the kernels, dispatched by the tensors' device.

CPU tensors take the plain PyTorch version (``kernels.ref``); CUDA
tensors take the hand-written Hopper kernel, or raise. There is no
global implementation switch and no fallback: a CUDA tensor never
reaches a plain version here, and tensors on any other device, or on
two devices at once, are refused.

``gemm``, ``embedding_bag`` (and ``gather_rows``), ``sparse_lengths_sum``,
``fused_segment_sum``, ``fused_cached_segment_sum`` (and its stage form
``fused_cached_segment_stage``), ``fused_int4_segment_sum`` and
``interaction`` are
``torch.autograd.Function``s whose backward passes do what the
reference's custom VJPs do: the backward of a GEMM is two GEMMs on the
same kernel, reading the transposed operands in place; the backward of
every gather-reduce is the ``sls_grad_table`` segment scatter-add,
deterministic on the card (no float atomics), with the null row's
gradient pinned to zero for the fused
forms (twice for the cached one: onto the hot slots with the miss slot
pinned, and onto the cold ids) and nothing pinned for ``embedding_bag``
and ``sparse_lengths_sum``; the int4 reduce's gradient reaches its
scales only, one ``sls_grad_table`` walk over one-position bags.
``feature_interaction``, the dense engine's whole interaction stage, is
one ``interaction`` launch each way on the card: the forward writes the
output and the features from the two inputs read in place, and the
backward writes both input gradients, the reference's (G + G^T) X over
the kept triangle (its einsum sits outside any Pallas kernel, but on
eager CUDA its scatter, transpose-add, ``bmm`` and pass-through adds
would each be a launch) plus the pass-throughs. ``interaction``, the
TPU kernel's full (B, F, F), keeps its (G + G^T) X backward in plain
torch. ``flash_attention`` and ``flash_attention_gqa`` run the kernel
forward and recompute backward through the model's chunked attention
(``models.layers._sdpa_chunked``), as the reference's kernel docstring
promises and as ``jax.grad`` differentiates off the TPU; the recompute
runs in a profiler span, ``RECOMPUTE_SPAN``. Serving runs them under
``torch.inference_mode``, which records nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import feature_interaction as _fi
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_dispatch as _fd
from repro_torch.kernels import gemm as _gm
from repro_torch.kernels import ref as _ref


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA arguments, False for all-CPU, else raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernels run on CUDA tensors and their plain "
                     f"versions on CPU tensors; got {sorted(kinds)}")


def _gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _on_cuda(x, w):
        return _gm.gemm(x, w)
    return _ref.gemm(x, w)


def gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(M,K) @ b:(N,K)^T with fp32 accumulation, b read in place: dx of
    a layer. Forward only, a building block of ``gemm``'s backward."""
    if _on_cuda(a, b):
        return _gm.gemm_nt(a, b)
    return _ref.gemm_nt(a, b)


def gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(K,M)^T @ b:(K,N) with fp32 accumulation, a read in place: dw of
    a layer. Forward only, a building block of ``gemm``'s backward."""
    if _on_cuda(a, b):
        return _gm.gemm_tn(a, b)
    return _ref.gemm_tn(a, b)


class _Gemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        # two GEMMs on the same kernel (dx = g w^T, dw = x^T g), which
        # reads the transposed operands in place
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm_nt(g, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gemm_tn(x, g).to(w.dtype)
        return dx, dw


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) with fp32 accumulation (the dense engine).
    Differentiable: the backward runs the same kernel twice, on w and x
    in place (``gemm_nt``, ``gemm_tn``), and skips dx where nothing needs
    it (the bottom MLP's first layer)."""
    return _Gemm.apply(x, w)


def sls_grad_table(g: torch.Tensor, indices: torch.Tensor,
                   offsets: torch.Tensor, *, n_rows: int,
                   skip_row: Optional[int] = None) -> torch.Tensor:
    """Segment scatter-add (n_rows, D) f32: ``d[r] = sum over valid p
    with indices[p] == r of g[bag(p)]``, each row summed in ascending
    position order; ``skip_row``'s gradient is zero."""
    if _on_cuda(g, indices, offsets):
        return _eg.sls_grad_table(g, indices, offsets, n_rows=n_rows,
                                  skip_row=skip_row)
    d = _ref.sls_grad_table(g, indices, offsets, n_rows).float()
    if skip_row is not None:
        d[skip_row] = 0.0
    return d


def _dense_grad_table(g: torch.Tensor, dense_ids: torch.Tensor, n_rows: int,
                      skip_row: Optional[int]) -> torch.Tensor:
    """Table gradient of a reduce over a dense (B, max_l) id matrix: a
    dense matrix is a ragged stream with uniform offsets, so it is the
    same segment scatter-add, with ``skip_row``'s gradient pinned to
    zero (the sentinel every fill slot points at)."""
    b, max_l = dense_ids.shape
    offsets = torch.arange(b + 1, dtype=torch.int32,
                           device=dense_ids.device) * max_l
    return sls_grad_table(g.float().contiguous(), dense_ids.reshape(-1),
                          offsets, n_rows=n_rows, skip_row=skip_row)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, null_row):
        ctx.save_for_backward(indices)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.null_row = null_row
        if _on_cuda(table, indices):
            return _eg.embedding_bag(table, indices)
        return _ref.embedding_bag(table, indices)

    @staticmethod
    def backward(ctx, g):
        # the reference's _bag_bwd (kernels/ops.py:92-99) scatter-adds
        # every position's bag gradient, with no row pinned: a fixed bag
        # has no fill slots (a shard's block pins its sentinel). A (B, L)
        # matrix is a uniform-offset stream, so it is sls_grad_table's
        # deterministic walk, not index_add_'s float atomics on the card.
        (indices,) = ctx.saved_tensors
        d = _dense_grad_table(g, indices, ctx.n_rows, ctx.null_row)
        return d.to(ctx.table_dtype), None, None


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  null_row: Optional[int] = None) -> torch.Tensor:
    """Fixed-lookup SparseLengthsSum: out[b] = sum_l table[indices[b, l]];
    table (V, D), indices (B, L) int32 -> (B, D) in the table's dtype,
    accumulated in f32. Differentiable w.r.t. the table; ``null_row``'s
    gradient is pinned to zero (a row-sharded block's sentinel, on which
    the ids the rank does not own sit)."""
    return _EmbeddingBag.apply(table, indices,
                               None if null_row is None else int(null_row))


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[t] = table[indices[t]]: single-row bags of ``embedding_bag``."""
    return embedding_bag(table, indices[:, None])


class _SparseLengthsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, offsets, max_l):
        ctx.save_for_backward(indices, offsets)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        if _on_cuda(table, indices, offsets):
            return _eg.sparse_lengths_sum(table, indices, offsets,
                                          max_l=max_l)
        return _ref.sparse_lengths_sum(table, indices, offsets, max_l)

    @staticmethod
    def backward(ctx, g):
        # the reference's _sls_bwd (kernels/ops.py:130-139): the segment
        # scatter-add over the same stream, padded positions adding
        # nothing
        indices, offsets = ctx.saved_tensors
        d = sls_grad_table(g.float().contiguous(), indices, offsets,
                           n_rows=ctx.n_rows)
        return d.to(ctx.table_dtype), None, None, None


def sparse_lengths_sum(table: torch.Tensor, indices: torch.Tensor,
                       offsets: torch.Tensor, *, max_l: int) -> torch.Tensor:
    """Ragged SparseLengthsSum (the paper's Fig. 2 API): bag b sums
    ``table[indices[offsets[b]:offsets[b+1]]]``, at most its first
    ``max_l`` rows; indices may be padded past offsets[-1]. Returns
    (B, D) in the table's dtype.

    ``max_l`` must bound every bag, as for ``se.ragged_dense_ids``. Past
    it the forward follows the reference's Pallas kernel (the first
    ``max_l`` rows), and the backward, as the reference's, scatters to
    every position of the bag.
    """
    return _SparseLengthsSum.apply(table, indices, offsets, int(max_l))


class _FusedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, dense_ids, null_row):
        ctx.save_for_backward(dense_ids)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.null_row = null_row
        if _on_cuda(table, dense_ids):
            return _fd.fused_segment_sum(table, dense_ids)
        return _ref.fused_segment_sum(table, dense_ids)

    @staticmethod
    def backward(ctx, g):
        # the relayout points every fill slot at the null row, whose
        # gradient is pinned to zero as in the reference
        # (kernels/ops.py:172-188)
        (dense_ids,) = ctx.saved_tensors
        d = _dense_grad_table(g, dense_ids, ctx.n_rows, ctx.null_row)
        return d.to(ctx.table_dtype), None, None


def fused_segment_sum(table: torch.Tensor, dense_ids: torch.Tensor, *,
                      null_row: Optional[int] = None) -> torch.Tensor:
    """Segmented reduce over a dense id matrix: out[b] = sum_j
    table[ids[b, j]], f32 (B, D).

    ``dense_ids`` is a ``sparse_engine.ragged_dense_ids`` relayout with
    short/padded slots pointing at the always-zero ``null_row``. The
    forward needs no mask; the backward (the table gradient) pins
    ``null_row``'s gradient to zero, as the reference does.
    """
    return _FusedSegmentSum.apply(table, dense_ids,
                                  None if null_row is None else int(null_row))


def _cached_grads(ctx, g, slots, cold_ids, hot: bool, arena: bool):
    """The cached reduce's gradients, as the reference's
    (kernels/ops.py:248-257): the hot gradient over the slots with the
    miss slot (the last hot row) pinned, the arena gradient over the
    redirected cold ids with the null row pinned."""
    n_hot, n_arena = ctx.shapes
    d_hot = d_arena = None
    if hot:
        d_hot = _dense_grad_table(g, slots, n_hot,
                                  n_hot - 1).to(ctx.dtypes[0])
    if arena:
        d_arena = _dense_grad_table(g, cold_ids, n_arena,
                                    ctx.null_row).to(ctx.dtypes[1])
    return d_hot, d_arena


class _FusedCachedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hot_rows, arena, slots, cold_ids, null_row):
        ctx.save_for_backward(slots, cold_ids)
        ctx.shapes = (hot_rows.shape[0], arena.shape[0])
        ctx.dtypes = (hot_rows.dtype, arena.dtype)
        ctx.null_row = null_row
        if _on_cuda(hot_rows, arena, slots, cold_ids):
            return _fd.fused_cached_segment_sum(hot_rows, arena, slots,
                                                cold_ids)
        return _ref.fused_cached_segment_sum(hot_rows, arena, slots,
                                             cold_ids)

    @staticmethod
    def backward(ctx, g):
        slots, cold_ids = ctx.saved_tensors
        return (*_cached_grads(ctx, g, slots, cold_ids,
                               ctx.needs_input_grad[0],
                               ctx.needs_input_grad[1]), None, None, None)


def fused_cached_segment_sum(hot_rows: torch.Tensor, arena: torch.Tensor,
                             slots: torch.Tensor, cold_ids: torch.Tensor, *,
                             null_row: Optional[int] = None) -> torch.Tensor:
    """One-pass hot/cold segmented reduce with the hit test in the kernel:
    ``out[b] = sum_j hot_rows[slots[b, j]] + arena[cold_ids[b, j]]``, f32
    (B, D).

    hot_rows (K+1, D) has the zero miss slot K; slots and cold_ids are
    (B, max_l) over the same bags, a hit's cold id redirected to the zero
    ``null_row``. Gradients reach both tables, the miss slot's and
    ``null_row``'s pinned to zero. (The reference's ``dense_ids``, its
    declaration that the cache is coherent, has no counterpart: the card
    takes the two-table walk either way.)
    """
    return _FusedCachedSegmentSum.apply(
        hot_rows, arena, slots, cold_ids,
        None if null_row is None else int(null_row))


class _FusedCachedSegmentStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hot_rows, slot_of, arena, dense_ids, null_row):
        ctx.save_for_backward(slot_of, dense_ids)
        ctx.shapes = (hot_rows.shape[0], arena.shape[0])
        ctx.dtypes = (hot_rows.dtype, arena.dtype)
        ctx.null_row = null_row
        if _on_cuda(hot_rows, slot_of, arena, dense_ids):
            return _fd.fused_cached_segment_stage(hot_rows, slot_of, arena,
                                                  dense_ids)
        return _ref.fused_cached_segment_stage(hot_rows, slot_of, arena,
                                               dense_ids, null_row)

    @staticmethod
    def backward(ctx, g):
        # the split recomputed from the saved slot map and ids, then the
        # two-matrix op's gradients
        slot_of, dense_ids = ctx.saved_tensors
        slots, cold_ids = _ref.cached_split(slot_of, dense_ids,
                                            ctx.shapes[0] - 1, ctx.null_row)
        d_hot, d_arena = _cached_grads(ctx, g, slots, cold_ids,
                                       ctx.needs_input_grad[0],
                                       ctx.needs_input_grad[2])
        return d_hot, None, d_arena, None, None


def fused_cached_segment_stage(hot_rows: torch.Tensor, slot_of: torch.Tensor,
                               arena: torch.Tensor, dense_ids: torch.Tensor,
                               *, null_row: int) -> torch.Tensor:
    """The cached plan's embedding stage: the hit split of ``dense_ids``
    (slots ``slot_of[dense]``, a hit's cold id redirected to the zero
    ``null_row``) and ``fused_cached_segment_sum`` over it, f32 (B, D).
    One launch on the card, which makes the split itself; on the CPU the
    split's torch ops and the plain version. Gradients reach both tables
    as ``fused_cached_segment_sum``'s do."""
    return _FusedCachedSegmentStage.apply(hot_rows, slot_of, arena,
                                          dense_ids, int(null_row))


def int4_pack(a32: torch.Tensor):
    """Row-wise symmetric int4 quantize + nibble-pack: per-row scale
    amax/7, an all-zero row gets a zero scale. Returns (packed uint8
    (R, ceil(D/2)), scales f32 (R, 1)); torch ops on either device, as
    the reference leaves them to XLA."""
    return _ref.int4_pack(a32)


def int4_unpack(packed: torch.Tensor, scales: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Dequantize an ``int4_pack`` arena back to f32 (R, dim)."""
    return _ref.int4_unpack(packed, scales, dim)


class _FusedInt4SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, scales, dense_ids, dim):
        ctx.save_for_backward(packed, dense_ids)
        ctx.dim = dim
        if _on_cuda(packed, scales, dense_ids):
            return _fd.fused_int4_segment_sum(packed, scales, dense_ids,
                                              dim=dim)
        return _ref.fused_int4_segment_sum(packed, scales, dense_ids, dim)

    @staticmethod
    def backward(ctx, g):
        # as the reference (kernels/ops.py:372-386): the codes are frozen
        # integers, so the one trainable leaf is the scales, d_scales[r] =
        # sum over positions p with id_p == r of <g[bag(p)], codes[r]>. A
        # null row's codes are zero, so its gradient is zero unpinned.
        # The scatter is sls_grad_table over one-position bags (offsets
        # 0..N): deterministic, where index_add_ on the card would add
        # with float atomics.
        packed, dense_ids = ctx.saved_tensors
        codes = _ref._int4_codes(packed[dense_ids], ctx.dim).float()
        per_pos = torch.einsum("bld,bd->bl", codes, g.float())
        n = per_pos.numel()
        offsets = torch.arange(n + 1, dtype=torch.int32,
                               device=dense_ids.device)
        d_scales = sls_grad_table(per_pos.reshape(n, 1).contiguous(),
                                  dense_ids.reshape(-1), offsets,
                                  n_rows=packed.shape[0])
        return None, d_scales, None, None


def fused_int4_segment_sum(packed: torch.Tensor, scales: torch.Tensor,
                           dense_ids: torch.Tensor, *,
                           dim: int) -> torch.Tensor:
    """Int4 dequantize-in-the-gather reduce over a dense id matrix:
    out[b] = sum_j unpack(packed)[dense_ids[b, j]], f32 (B, dim).

    packed (V, ceil(dim/2)) uint8 and scales (V, 1) f32 from
    ``int4_pack``; dense_ids (B, max_l) int32 with fill slots pointing at
    a zero-scale row. Differentiable in ``scales`` only: the codes are
    frozen integers.
    """
    return _FusedInt4SegmentSum.apply(packed, scales, dense_ids, int(dim))


class _Interaction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if _on_cuda(x):
            return _fi.interaction(x)
        return _ref.interaction(x)

    @staticmethod
    def backward(ctx, g):
        # z = X X^T per sample => dX = (G + G^T) X
        (x,) = ctx.saved_tensors
        g32 = g.float()
        return torch.bmm(g32 + g32.transpose(1, 2), x.float()).to(x.dtype)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, D) -> (B, F, F) pairwise dots per sample."""
    return _Interaction.apply(x)


def interaction_tril(x: torch.Tensor) -> torch.Tensor:
    """DLRM interaction: lower-triangle (offset -1) of X X^T, flattened
    row-major, as the reference takes it outside its kernel."""
    z = interaction(x)
    f = x.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=x.device)
    return z[:, li, lj]


class _FeatureInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bottom_out, reduced_embs):
        ctx.save_for_backward(bottom_out, reduced_embs)
        # a feats gradient that nothing produced stays None, and the
        # backward kernel skips it
        ctx.set_materialize_grads(False)
        if _on_cuda(bottom_out, reduced_embs):
            return _fi.feature_interaction(bottom_out, reduced_embs)
        return _ref.feature_interaction(bottom_out, reduced_embs)

    @staticmethod
    def backward(ctx, g, g_feats):
        bottom_out, reduced_embs = ctx.saved_tensors
        if g is None and g_feats is None:
            return None, None
        if g is None:
            b, t, d = reduced_embs.shape
            g = bottom_out.new_zeros((b, d + _fi.n_pairs(t + 1)))
        if _on_cuda(g, bottom_out, reduced_embs):
            d_bottom, d_embs = _fi.feature_interaction_backward(
                g.contiguous(),
                None if g_feats is None else g_feats.contiguous(),
                bottom_out, reduced_embs)
        else:
            d_bottom, d_embs = _ref.feature_interaction_backward(
                g, g_feats, bottom_out, reduced_embs)
        return (d_bottom if ctx.needs_input_grad[0] else None,
                d_embs if ctx.needs_input_grad[1] else None)


def feature_interaction(bottom_out: torch.Tensor, reduced_embs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense engine's interaction stage (paper Fig. 3): bottom_out (B,
    D) and reduced_embs (B, T, D) -> (out (B, D + F(F-1)/2) = [bottom_out,
    tril(X X^T, -1) row-major], feats (B, F, D) = X), F = T + 1.
    Differentiable in both inputs through both outputs."""
    return _FeatureInteraction.apply(bottom_out.contiguous(),
                                     reduced_embs.contiguous())


# the profiler span around the flash op's backward recompute
RECOMPUTE_SPAN = "flash_attention_recompute"


class _FlashAttentionGQA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if _on_cuda(q, k, v):
            return _fa.flash_attention_gqa(q, k, v, causal=causal,
                                           window=window)
        return _ref.flash_attention_gqa(q, k, v, causal=causal,
                                        window=window)

    @staticmethod
    def backward(ctx, g):
        # the recompute the reference's kernel docstring promises (its
        # pallas_call has no VJP): autograd through the chunked path, what
        # jax.grad differentiates off the TPU (models.layers imports this
        # module, so it is imported here)
        from repro_torch.models import layers
        q, k, v = ctx.saved_tensors
        b, s, h, hd = q.shape
        kh = k.shape[2]
        with torch.enable_grad(), \
                torch.profiler.record_function(RECOMPUTE_SPAN):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            pos = torch.arange(s, device=q.device)
            chunk = layers.pick_chunk(s, layers.Q_CHUNK)
            out = layers._sdpa_chunked(
                q.reshape(b, s, kh, h // kh, hd), k, v, pos, pos, ctx.causal,
                ctx.window, chunk, layers.pick_chunk(s, layers.KV_CHUNK))
            dq, dk, dv = torch.autograd.grad(out.reshape(b, s, h, hd),
                                             (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Causal or windowed online-softmax attention, GQA form: q (B, S, H,
    hd), k/v (B, S, KH, hd) -> (B, S, H, hd) in q.dtype, query head h on
    kv head h // (H / KH). Masks by sequence index. The backward
    recomputes through ``models.layers._sdpa_chunked`` (on either
    device; no kernel of its own)."""
    return _FlashAttentionGQA.apply(q, k, v, bool(causal), window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The (BH, S, d) form: one head per row of the leading dim."""
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window)[:, :, 0]
