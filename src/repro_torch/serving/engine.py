"""LM serving: request batcher and the slot-pooled decode engine, the
counterpart of the reference's ``repro/serving/engine.py``.

* ``Batcher``: an admission queue with (max_batch, max_wait_ms)
  micro-batching;
* ``DecodeEngine``: a fixed slot pool with *wave* batching. A wave of
  requests is admitted together, so positions stay aligned with the
  scalar-position KV cache, and prefilled one aligned ``decode_step`` per
  prompt position (shorter prompts left-padded with token 0), as the
  reference does; then greedy argmax decoding until every member is
  done, after which the slots are reused;
* latency stats (p50/p95/p99) per request.

The engine decodes on the params' device. ``decode_step`` writes the
cache in place (``models/layers.py``), so a wave's cache is one set of
tensors for its whole life.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    output: List[int] = field(default_factory=list)


class Batcher:
    def __init__(self, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: List[Request] = []

    def submit(self, req: Request):
        self._queue.append(req)

    def take(self) -> List[Request]:
        """Non-blocking micro-batch: whatever is queued up to max_batch,
        or everything older than max_wait_ms."""
        if not self._queue:
            return []
        oldest = time.time() - self._queue[0].submitted_at
        if len(self._queue) >= self.max_batch \
                or oldest * 1e3 >= self.max_wait_ms:
            batch, self._queue = (self._queue[:self.max_batch],
                                  self._queue[self.max_batch:])
            return batch
        return []


class DecodeEngine:
    """Slot-pooled decode over a fixed cache."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.cache = api.init_cache(cfg, n_slots, max_len,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.latencies: List[float] = []
        self.pos = 0
        self._last_logits = None

    def _decode(self, tokens: np.ndarray) -> None:
        self._last_logits, self.cache = api.decode_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(tokens).to(self.device), self.pos)
        self.pos += 1

    def _argmax(self) -> np.ndarray:
        return torch.argmax(self._last_logits, -1).cpu().numpy()

    def idle(self) -> bool:
        return all(r is None for r in self.slot_req)

    def admit(self, reqs: List[Request]):
        """Admit a wave (only when idle): a fresh cache, then one batched
        decode step per prompt position."""
        if not reqs or not self.idle():
            return
        reqs = reqs[:self.n_slots]
        plen = max(len(r.prompt) for r in reqs)
        self.cache = api.init_cache(self.cfg, self.n_slots, self.max_len,
                                    device=self.device)
        self.pos = 0
        for i, req in enumerate(reqs):
            req.started_at = time.time()
            self.slot_req[i] = req
        for t in range(plen):
            tokens = np.zeros((self.n_slots,), np.int32)
            for i, req in enumerate(reqs):
                off = plen - len(req.prompt)
                if t >= off:
                    tokens[i] = req.prompt[t - off]
            self._decode(tokens)

    def step(self) -> int:
        """One decode step for the wave; returns the number still
        active."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.n_slots,), np.int32)
        nxt = self._argmax()
        for i in active:
            tokens[i] = nxt[i]
        self._decode(tokens)
        out = self._argmax()
        for i in active:
            req = self.slot_req[i]
            req.output.append(int(out[i]))
            if len(req.output) >= req.max_new_tokens \
                    or self.pos >= self.max_len - 1:
                req.finished_at = time.time()
                self.latencies.append(req.finished_at - req.submitted_at)
                self.slot_req[i] = None
        return len([r for r in self.slot_req if r is not None])

    def stats(self) -> Dict[str, float]:
        if not self.latencies:
            return {}
        arr = np.array(self.latencies)
        return {"n": len(arr),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3)}
