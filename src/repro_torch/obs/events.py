"""Structured event log for the versioned-swap protocol.

The trainer → fleet broadcast path (``VersionedSource`` /
``VersionedHotCache``) is the one part of the system where "what
happened when" genuinely matters after the fact: did the p99 regression
start at the v12 hot-cache rebuild or the v13 quantized-cold refresh?
Did a replica reject a stale broadcast? ``stats()`` can't answer those —
an append-only (bounded) event log can.

Event kinds emitted by the engine/trainers:

    ``source_swap``        engine accepted a new source version
    ``cache_swap``         engine accepted a new hot-cache version
    ``stale_rejected``     engine rejected an out-of-order broadcast
    ``hot_cache_rebuild``  trainer rebuilt the hot set from trace counts
    ``quantized_refresh``  trainer re-quantized cold rows touched by grads
    ``tier_migration``     trainer moved rows across the storage tiers
    ``publish``            trainer stamped + broadcast an artifact
    ``retune``             engine re-derived its padding buckets
    ``shed``               scheduler dropped a request at admission (SLA)
    ``downgrade``          scheduler served a batch on the int8 path
    ``drain``              engine/scheduler flushed the queue (totals)

Every event carries ``version`` where applicable; ``source_swap`` /
``cache_swap`` events additionally carry the *outgoing* version's hit
statistics (``hits``/``lookups``, per-table for groups), which is what
makes ``hit_rate_by_version()`` — per-version hit-rate attribution —
possible: the engine snapshots its counters at the swap boundary, right
before they reset.

The port's copy of ``repro.obs.events``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["Event", "EventLog"]


class Event:
    __slots__ = ("kind", "time", "version", "attrs")

    def __init__(self, kind: str, version: Optional[int] = None,
                 attrs: Optional[Dict] = None, *,
                 time_s: Optional[float] = None):
        self.kind = kind
        self.version = version
        self.attrs: Dict = dict(attrs or {})
        self.time = time.time() if time_s is None else time_s

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "time": self.time,
                "version": self.version, **self.attrs}

    def __repr__(self):
        v = f" v{self.version}" if self.version is not None else ""
        return f"<Event {self.kind}{v} {self.attrs}>"


class EventLog:
    """Bounded append-only log with per-version hit-rate attribution."""

    def __init__(self, *, max_events: int = 4096):
        self.events: Deque[Event] = deque(maxlen=max_events)

    def emit(self, kind: str, version: Optional[int] = None,
             **attrs) -> Event:
        e = Event(kind, version, attrs)
        self.events.append(e)
        return e

    def query(self, kind: Optional[str] = None,
              version: Optional[int] = None) -> List[Event]:
        out = []
        for e in self.events:
            if kind is not None and e.kind != kind:
                continue
            if version is not None and e.version != version:
                continue
            out.append(e)
        return out

    def hit_rate_by_version(self) -> Dict[int, Optional[float]]:
        """Hit rate attributed to each *outgoing* source/cache version.

        Swap events carry the hit/lookup totals accumulated while that
        version was live (snapshotted by the engine at the boundary).
        Versions that served no lookups map to ``None`` — unknown, not
        0.0, matching the ``stats()`` convention.
        """
        out: Dict[int, Optional[float]] = {}
        for e in self.events:
            if e.kind not in ("source_swap", "cache_swap"):
                continue
            prev = e.attrs.get("prev_version")
            if prev is None:
                continue
            hits, lookups = e.attrs.get("hits"), e.attrs.get("lookups")
            if not lookups:
                out[prev] = None
            else:
                out[prev] = float(hits) / float(lookups)
        return out

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e.to_dict()) for e in self.events)

    def __len__(self):
        return len(self.events)
