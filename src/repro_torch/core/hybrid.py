"""HybridSparseDense: the Centaur orchestration layer.

Three ways to run one set of parameters:

* ``baseline_forward``: the paper's CPU-only baseline, a naive
  gather-materialize-reduce (``table[idx]`` then ``sum``) and plain
  matmuls. The floor every speed-up is measured against, plain torch by
  design: it runs no kernel of the port.
* ``dlrm.forward`` / ``dlrm.forward_ragged``: sparse engine, then dense
  engine, on one stream.
* ``pipelined_forward`` / ``pipelined_forward_ragged``: a micro-batch
  software pipeline. While the dense engine runs the MLPs and the
  interaction of micro-batch i, the sparse engine streams the gathers of
  micro-batch i+1 (paper Section IV-D). The reference expresses this as
  a stage-skewed ``lax.scan`` that the TPU scheduler overlaps; here it is
  two CUDA streams. Every lookup runs on a side stream, the dense stages
  on the caller's stream, and a ``torch.cuda.Event`` per micro-batch
  orders each dense stage after its own lookup and nothing else. On the
  CPU the same steps run one after the other.

Each micro-batch's rows go through the same per-row arithmetic as the
single-shot forward (every kernel of the port computes a bag, a sample or
an output row on its own), so the pipelined logits equal the single-shot
ones.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_mod
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.kernels import ref as kref

__all__ = ["baseline_forward", "make_pipelined_serve_step",
           "pipelined_forward", "pipelined_forward_ragged",
           "split_ragged_microbatches"]


# ---------------------------------------------------------------------------
# CPU-only baseline (paper Section III)
# ---------------------------------------------------------------------------

def baseline_forward(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """Naive path: materialize the gathered rows, reduce, plain matmul
    MLPs. indices (B, T, L) -> logits (B,)."""
    spec = dlrm_mod.arena_spec(cfg)
    flat = se.flatten_indices(spec, indices)               # (B*T, L)
    rows = params["arena"][flat]                           # materialized
    emb = rows.float().sum(dim=1)
    emb = emb.reshape(indices.shape[0], spec.n_tables, spec.dim)
    emb = emb.to(params["arena"].dtype)
    bot = kref.mlp(dense, [w for w, _ in params["bottom"]],
                   [b for _, b in params["bottom"]])
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    pairs = kref.interaction_tril(feats)
    x = torch.cat([bot, pairs], dim=-1)
    logit = kref.mlp(x, [w for w, _ in params["top"]],
                     [b for _, b in params["top"]])
    return logit[:, 0]


# ---------------------------------------------------------------------------
# The two-stream pipeline
# ---------------------------------------------------------------------------

_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One lookup stream per card, made on first use."""
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def _pipeline(params: Dict, dense_s: torch.Tensor,
              lookup: Callable[[int], torch.Tensor],
              n_micro: int) -> torch.Tensor:
    """Run ``lookup(i)`` for i = 0 .. n_micro (n_micro is the pipeline
    tail's no-op dummy) skewed one step ahead of the dense stage of
    micro-batch i; returns the concatenated logits.

    On the card the lookups are enqueued on the side stream and the dense
    stages on the current stream. The side stream first waits for the
    current one (the caller's ids and params are written there); each
    dense stage waits for its own lookup's event; each reduced batch,
    made on the side stream and read on this one, is marked with
    ``record_stream`` so the caching allocator does not hand its memory
    out again before the read; and before returning the current stream
    waits for the tail, so no work of this call is left on the side
    stream. Tensors that the current stream made and only the lookups
    read (the caller's ids, a split of them) may be freed once this
    returns: their memory goes back to the current stream, whose later
    work is ordered after that wait.
    """
    logits: List[torch.Tensor] = []
    if dense_s.device.type != "cuda":
        emb = lookup(0)
        for i in range(n_micro):
            nxt = lookup(i + 1)
            logits.append(dlrm_mod.head_logits(params, dense_s[i], emb))
            emb = nxt
        return torch.cat(logits)
    main = torch.cuda.current_stream(dense_s.device)
    side = _side_stream(dense_s.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        emb = lookup(0)
        ready = torch.cuda.Event()
        ready.record(side)
    for i in range(n_micro):
        # micro-batch i+1's gathers go first, so the card can run them
        # beside micro-batch i's dense stage
        with torch.cuda.stream(side):
            nxt = lookup(i + 1)
            nxt_ready = torch.cuda.Event()
            nxt_ready.record(side)
        main.wait_event(ready)
        emb.record_stream(main)
        logits.append(dlrm_mod.head_logits(params, dense_s[i], emb))
        emb, ready = nxt, nxt_ready
    main.wait_event(ready)
    emb.record_stream(main)
    return torch.cat(logits)


def _split(b: int, n_micro: int) -> int:
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "micro-batches")
    return b // n_micro


def pipelined_forward(params: Dict, cfg: DLRMConfig, dense: torch.Tensor,
                      indices: torch.Tensor, n_micro: int = 4,
                      mesh: Any = None) -> torch.Tensor:
    """Stage-skewed pipeline over n_micro micro-batches of a fixed-L
    batch: dense (B, dense_features), indices (B, T, L) -> logits (B,).

    The last micro-batch has no successor: its "next" lookup reduces
    ``se.null_indices``, ids that all flatten to the zero null row, so
    the tail gathers one cache-resident row and no real traffic. With a
    mesh of more than one shard, ``params["arena"]`` is this rank's block
    and each lookup is the sharded one (its all-reduce enqueued with it,
    in the same order on every rank).
    """
    spec = dlrm_mod.arena_spec(cfg)
    mb = _split(dense.shape[0], n_micro)
    dense_s = dense.reshape(n_micro, mb, -1)
    idx_s = indices.reshape(n_micro, mb, spec.n_tables, -1)
    src = es.resolve_source(params["arena"], mesh)

    def lookup(i: int) -> torch.Tensor:
        ids = (idx_s[i] if i < n_micro else
               se.null_indices(spec, idx_s.shape[1:], device=indices.device))
        return es.lookup_fixed(src, spec, ids)

    return _pipeline(params, dense_s, lookup, n_micro)


def make_pipelined_serve_step(cfg: DLRMConfig, n_micro: int = 4,
                              mesh: Any = None):
    """Serve step over fixed-L batches through ``pipelined_forward``,
    under ``torch.inference_mode``."""
    def serve_step(params: Dict, batch: Dict) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(pipelined_forward(
                params, cfg, batch["dense"], batch["indices"], n_micro,
                mesh))
    return serve_step


# ---------------------------------------------------------------------------
# Ragged micro-batch pipeline (per-micro-batch offsets)
# ---------------------------------------------------------------------------

def split_ragged_microbatches(indices: torch.Tensor, offsets: torch.Tensor,
                              n_micro: int, max_l: int):
    """Slice one ragged batch into n_micro static-shape ragged streams.

    indices (N,) flat per-table ids (padding allowed); offsets (B*T+1,)
    with B*T divisible by n_micro. Micro-batch i gets its bag range
    re-based to local offsets and its index slice padded to the static
    cap bags_per_micro * max_l (pad positions sit past the local
    offsets[-1], so every ragged consumer ignores them). Slices and
    gathers on the device only: the data-dependent bag boundaries are
    never read on the host. Returns (indices (n_micro, cap), offsets
    (n_micro, bags_per_micro + 1)).
    """
    n_bags = offsets.shape[0] - 1
    per = _split(n_bags, n_micro)
    ar = torch.arange(per * max_l, device=indices.device)
    idx_list, off_list = [], []
    for i in range(n_micro):
        base = offsets[i * per]
        off_list.append(offsets[i * per:(i + 1) * per + 1] - base)
        pos = torch.clamp(base + ar, max=indices.shape[0] - 1)
        idx_list.append(indices[pos])
    return torch.stack(idx_list), torch.stack(off_list)


def pipelined_forward_ragged(params: Dict, cfg: DLRMConfig,
                             dense: torch.Tensor, indices: torch.Tensor,
                             offsets: torch.Tensor, *, max_l: int,
                             n_micro: int = 4,
                             mesh: Any = None) -> torch.Tensor:
    """Stage-skewed pipeline over ragged micro-batches: the structure of
    ``pipelined_forward`` with the ragged production lookup
    (``lookup_bags``) as the sparse stage, sharded over `mesh` as in
    ``pipelined_forward``. The tail dummy is a stream of all-empty bags
    (offsets all zero), the cheapest no-op pass."""
    spec = dlrm_mod.arena_spec(cfg)
    mb = _split(dense.shape[0], n_micro)
    if offsets.shape[0] - 1 != dense.shape[0] * spec.n_tables:
        raise ValueError(f"{offsets.shape[0] - 1} bags for "
                         f"{dense.shape[0]} samples x {spec.n_tables} tables")
    dense_s = dense.reshape(n_micro, mb, -1)
    idx_s, off_s = split_ragged_microbatches(indices, offsets, n_micro,
                                             max_l)
    src = es.resolve_source(params["arena"], mesh)

    def lookup(i: int) -> torch.Tensor:
        if i < n_micro:
            idx, off = idx_s[i], off_s[i]
        else:
            idx, off = torch.zeros_like(idx_s[0]), torch.zeros_like(off_s[0])
        return es.lookup_bags(src, spec, idx, off, max_l=max_l)

    return _pipeline(params, dense_s, lookup, n_micro)
