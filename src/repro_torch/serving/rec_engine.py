"""Recommendation serving engine over the ragged production sparse path.

* ``RecRequest``: one user impression, dense features + per-table ragged
  sparse id lists (the SparseLengthsSum format of paper Fig. 2);
* ``RecBatcher``: admission queue with (max_batch, max_wait_ms)
  micro-batching on the monotonic clock;
* ``RecEngine``: drains the batcher, pads each micro-batch to a static
  *bucket* shape (batch rounded up to a bucket size with empty-bag dummy
  rows, flat index stream padded to bucket*T*max_l) and serves one ragged
  forward on the device, under ``torch.inference_mode``.

This slice serves the ``"ragged"`` plan: the full-precision arena in
``params``. The other plans, ``update_source``, dispatch/settle,
telemetry, the downgrade path and CUDA-graph capture are later ROADMAP
items; each unported plan raises ``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm

# reference plans not served yet, and the ROADMAP item that ports each
_UNPORTED_PLANS = {
    "fixed": "ROADMAP Queue 1, item 4 (the fixed layout)",
    "sharded": "ROADMAP Queue 1, item 13",
    "cached": "ROADMAP Queue 1, item 8",
}


@dataclass
class RecRequest:
    rid: int
    dense: np.ndarray                   # (dense_features,) float32
    sparse_ids: List[np.ndarray]        # per table: (l_t,) int32, l_t<=max_l
    # wall-clock stamps are user-facing only; every deadline and latency
    # runs on submitted_mono, so a clock step cannot corrupt either
    submitted_at: float = field(default_factory=time.time)
    submitted_mono: float = field(default_factory=time.monotonic)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    prob: Optional[float] = None        # predicted CTR, set when served


class RecBatcher:
    """Admission queue: release a micro-batch when it is full or when the
    oldest request has waited max_wait_ms (the SLA knob). ``clock`` is
    injectable for tests."""

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 clock=time.monotonic):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._clock = clock
        self._queue: List[RecRequest] = []

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, req: RecRequest):
        self._queue.append(req)

    def take(self, force: bool = False) -> List[RecRequest]:
        if not self._queue:
            return []
        oldest = self._clock() - self._queue[0].submitted_mono
        if force or len(self._queue) >= self.max_batch \
                or oldest * 1e3 >= self.max_wait_ms:
            batch = self._queue[:self.max_batch]
            self._queue = self._queue[self.max_batch:]
            return batch
        return []


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class RecEngine:
    """Batcher-fed DLRM inference over the fp arena in ``params``.

    ``device`` defaults to the card; pass ``device="cpu"`` (with params
    on the CPU) to serve through the plain PyTorch path. Latencies are
    kept over a bounded ring of the last ``LATENCY_RING`` requests.
    """

    LATENCY_RING = 4096

    def __init__(self, cfg: DLRMConfig, params: Dict, *,
                 source: Union[str, object, None] = "ragged",
                 max_l: Optional[int] = None,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 device: Optional[Union[str, torch.device]] = None):
        if isinstance(source, str) and source in _UNPORTED_PLANS:
            raise NotImplementedError(f"source={source!r} is not ported "
                                      f"yet ({_UNPORTED_PLANS[source]})")
        if source not in (None, "ragged"):
            raise NotImplementedError(
                "only the 'ragged' fp plan is ported; SourceSpec plans and "
                "pre-built sources come with ROADMAP Queue 1, item 8")
        self.device = resolve_device(device)
        for name in ("bottom", "top"):
            for w, b in params[name]:
                self._check_device(w, name)
                self._check_device(b, name)
        self._check_device(params["arena"], "arena")
        self.cfg = cfg
        self.params = params
        self.path = "ragged"
        self.spec = dlrm.arena_spec(cfg)
        self.max_l = max_l if max_l is not None else cfg.lookups_per_table
        self.batcher = RecBatcher(max_batch, max_wait_ms)
        self.max_batch = max_batch
        self.buckets = tuple(sorted(set(buckets) | {max_batch}))
        self.served = 0
        self.batches = 0
        self._lat_ms: deque = deque(maxlen=self.LATENCY_RING)
        self._serve = dlrm.make_ragged_serve_step(cfg, max_l=self.max_l)

    def _check_device(self, t: torch.Tensor, name: str) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"params[{name!r}] on {t.device}, engine on "
                             f"{self.device}")

    def warmup(self) -> None:
        """Serve one dummy request through every bucket, off the SLA
        clock: the first call builds and loads the kernels."""
        dummy = [RecRequest(
            rid=-1, dense=np.zeros(self.cfg.dense_features, np.float32),
            sparse_ids=[np.zeros(0, np.int32)] * self.cfg.n_tables)]
        for bucket in self.buckets:
            self._serve(self.params, self._assemble(dummy, bucket)).cpu()

    def submit(self, req: RecRequest) -> None:
        if len(req.sparse_ids) != self.cfg.n_tables:
            raise ValueError(f"request {req.rid} has {len(req.sparse_ids)} "
                             f"id lists for {self.cfg.n_tables} tables")
        self.batcher.submit(req)

    def _assemble(self, reqs: List[RecRequest],
                  bucket: int) -> Dict[str, torch.Tensor]:
        """Pad a micro-batch to its bucket's static shapes, on the
        engine's device."""
        t = self.cfg.n_tables
        dense = np.zeros((bucket, self.cfg.dense_features), np.float32)
        lens = np.zeros(bucket * t, np.int32)
        for i, r in enumerate(reqs):
            dense[i] = r.dense
            for j, ids in enumerate(r.sparse_ids):
                if len(ids) > self.max_l:
                    raise ValueError(f"request {r.rid} table {j}: bag of "
                                     f"{len(ids)} > max_l {self.max_l}")
                lens[i * t + j] = len(ids)
        offsets = np.zeros(bucket * t + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        flat = np.zeros(bucket * t * self.max_l, np.int32)  # static cap
        for i, r in enumerate(reqs):
            for j, ids in enumerate(r.sparse_ids):
                o = offsets[i * t + j]
                flat[o:o + len(ids)] = ids
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in (("dense", dense), ("indices", flat),
                             ("offsets", offsets))}

    def step(self, force: bool = False) -> int:
        """Serve one micro-batch; returns the number of requests served."""
        reqs = self.batcher.take(force=force)
        if not reqs:
            return 0
        now = time.time()
        for r in reqs:
            r.started_at = now
        batch = self._assemble(reqs, _bucket(len(reqs), self.buckets))
        probs = self._serve(self.params, batch).cpu().numpy()  # host sync
        done, done_m = time.time(), time.monotonic()
        for i, r in enumerate(reqs):
            r.prob = float(probs[i])
            r.finished_at = done
            self._lat_ms.append((done_m - r.submitted_mono) * 1e3)
        self.served += len(reqs)
        self.batches += 1
        return len(reqs)

    def drain(self) -> int:
        """Serve everything still queued (end-of-stream flush)."""
        n = 0
        while len(self.batcher):
            n += self.step(force=True)
        return n

    def stats(self) -> Dict:
        """Requests served, latency percentiles over the ring, buckets."""
        if not self._lat_ms:
            return {"n": 0}
        lat = np.fromiter(self._lat_ms, np.float64, count=len(self._lat_ms))
        return {"n": self.served,
                "path": self.path,
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "mean_ms": float(lat.mean()),
                # no hot cache on the fp path: None, never a fake 0.0
                "cache_hit_rate": None,
                "buckets": self.buckets}


def requests_from_ragged_batch(batch: Dict[str, np.ndarray], n_tables: int,
                               rid0: int = 0) -> List[RecRequest]:
    """Explode a DLRMSynthetic.ragged_batch into individual requests."""
    off = batch["offsets"]
    b = (len(off) - 1) // n_tables
    out = []
    for i in range(b):
        ids = [batch["indices"][off[i * n_tables + j]:
                                off[i * n_tables + j + 1]]
               for j in range(n_tables)]
        out.append(RecRequest(rid=rid0 + i, dense=batch["dense"][i],
                              sparse_ids=ids))
    return out
