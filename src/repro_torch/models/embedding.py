"""Token embedding, LM head and the next-token loss, the counterpart of
the reference's ``repro/models/embedding.py``.

The reference shards the (padded) vocab table's rows over its 'model'
mesh axis and gathers with a masked local gather and a psum;
``embed_tokens(table, tokens, mesh)`` does so on a mesh whose 'model'
axis has more than one rank, ``table`` being the rank's block of rows.
On one card it is a plain gather, and the head a plain product.

Under the LM's active mesh (``sharding.use_mesh``, a 'model' axis of more
than one rank) the table and the untied head are the rank's blocks of
vocab rows (columns): ``embed_rows`` gives the rank's rows of the tokens
and zeros elsewhere, a partial sum the caller reduces (``scatter_seq``
onto the sequence-parallel stream, or ``psum_model`` in decode), as the
reference's masked gather + psum; ``lm_head`` and ``lm_head_untied``
give the rank's vocab-sharded fp32 logits with the padded entries
masked on the shard that holds them; and ``cross_entropy`` is
vocab-parallel: the max and the sum of exps all-reduced over 'model',
the label's logit taken from the rank that owns it. Logits are fp32 from bf16 operands, as the
reference's ``preferred_element_type=float32``: both operands are
widened, so each product is exact and the sum is fp32.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models.params import Builder

VOCAB_PAD = 128
# the score of a padded vocab entry
NEG_INF = -1e30


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def init_table(b: Builder, vocab: int, d: int) -> torch.Tensor:
    """(padded vocab, d) rows ~ N(0, 0.02^2); the padding rows are zero,
    so tied logits of pad ids stay inert."""
    t = b.normal((padded_vocab(vocab), d), scale=0.02, spec=("model", None))
    if isinstance(t, torch.Tensor):     # a recorded leaf has no values
        t[vocab:] = 0
    return t


def init_unembed(b: Builder, vocab: int, d: int) -> torch.Tensor:
    return b.normal((d, padded_vocab(vocab)), scale=0.02,
                    spec=(None, "model"))


def _own_rows(block: torch.Tensor, tokens: torch.Tensor,
              mesh) -> torch.Tensor:
    """The rank's rows of the tokens, zero where another rank owns the
    row."""
    vloc = block.shape[0]
    rel = tokens.long() - mesh.rank("model") * vloc
    ok = (rel >= 0) & (rel < vloc)
    rows = block[torch.where(ok, rel, 0)]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def _local_gather(block: torch.Tensor, tokens: torch.Tensor,
                  mesh) -> torch.Tensor:
    """The rank's rows of the tokens, zero where another rank owns the
    row, summed over 'model' (the reference's masked gather + psum)."""
    return coll.psum(_own_rows(block, tokens, mesh), mesh, "model")


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D): under the active mesh the rows of
    ``table`` (this rank's block of vocab rows) that this rank owns, zero
    elsewhere, a partial sum over 'model'; the plain gather without
    one."""
    mesh = sharding.model_mesh()
    if mesh is None:
        return table[tokens.long()]
    return _own_rows(table, tokens, mesh)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D). Under a mesh whose 'model' axis has
    more than one rank, ``table`` is this rank's block of vocab rows
    (rows split over 'model', replicated over the data axes) and every
    rank passes the same tokens: each data group gathers its share of the
    batch (masked local gather, psum over 'model') and the shares are
    all-gathered, so every rank gets the whole (B, S, D). When the batch
    does not divide the data axes (the reference's own condition), the
    plain gather runs over the table gathered from its blocks."""
    if mesh is None or "model" not in mesh.axis_names \
            or mesh.size("model") <= 1:
        return table[tokens.long()]
    ba = sharding.batch_axes(mesh)
    n_b = coll.axes_size(mesh, ba)
    if tokens.shape[0] % n_b:
        return coll.all_gather(table, mesh, "model")[tokens.long()]
    b = tokens.shape[0] // n_b
    mine = tokens.narrow(0, coll.axes_index(mesh, ba) * b, b)
    # each data group's gradient reaches only its own tokens' rows
    rows = _local_gather(coll.replicated(table, mesh, ba), mine, mesh)
    return coll.all_gather(rows, mesh, ba)


def _vocab_offset(v_local: int) -> int:
    """The first vocab id of this rank's logits under the active mesh."""
    return sharding.tp_rank() * v_local


def _mask_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Padded vocab entries -1e30: the columns past ``vocab`` of the whole
    vocab, on the shard that holds them under a mesh."""
    first = vocab - _vocab_offset(logits.shape[-1])
    if first < logits.shape[-1]:
        logits[..., max(first, 0):] = NEG_INF
    return logits


def lm_head(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """x (B, S, D) @ table^T -> fp32 logits (B, S, Vpad), pads -1e30; the
    rank's vocab shard of them under a mesh."""
    return _mask_pad(torch.matmul(x.float(), table.float().t()), vocab)


def lm_head_untied(x: torch.Tensor, w: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """x (B, S, D) @ w (D, Vpad) -> fp32 logits, pads -1e30; the rank's
    vocab shard under a mesh."""
    return _mask_pad(torch.matmul(x.float(), w.float()), vocab)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean masked next-token CE. logits (B, S, V) f32, labels (B, S)
    int, mask (B, S) f32; ``logz`` from the max as a constant, as the
    reference's ``stop_gradient``. The reference picks the gold logit by a
    one-hot masked sum over the vocab (gather-free for its sharded vocab
    dim); ``torch.gather`` gives the same bits, since that sum adds only
    zeros to the gold logit, without a (B, S, V) boolean.

    Under the active mesh ``logits`` is this rank's vocab shard: the max
    is all-reduced over 'model' (a constant), the shards' sums of exps
    and the label's logit (from the shard that owns the label, zero on
    the others) are summed over 'model', so every rank of the axis gets
    the same loss, and its gradient reaches each shard's logits."""
    mesh = sharding.model_mesh()
    if mesh is None:
        m = logits.amax(-1, keepdim=True).detach()
        logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        v_local = logits.shape[-1]
        m = coll.pmax(logits.amax(-1, keepdim=True), mesh, "model")
        sumexp = coll.psum(torch.exp(logits - m).sum(-1), mesh, "model")
        logz = m[..., 0] + torch.log(sumexp)
        rel = labels.long() - _vocab_offset(v_local)
        own = (rel >= 0) & (rel < v_local)
        pick = torch.gather(logits, -1, torch.where(own, rel, 0)[..., None])
        gold = coll.psum(torch.where(own, pick[..., 0],
                                     torch.zeros_like(pick[..., 0])),
                         mesh, "model")
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
