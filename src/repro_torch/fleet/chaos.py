"""Deterministic fault injection for the versioned broadcast path.

The trainer publishes ``VersionedSource`` blobs; a fleet transport can
drop them, deliver them twice, or deliver them late (after a newer
version already landed — reordering). ``ChaosChannel`` models exactly
that, between ``publish_source`` and a replica's ``update_source``, with
every decision drawn from one seeded generator:

* no wall-clock randomness anywhere — a ``FaultPlan`` seed fully
  determines the schedule, so any scenario replays bit-for-bit from its
  recorded seed (``ChaosChannel.schedule`` is the decision transcript);
* "time" is the send index, not seconds: a delayed artifact becomes
  deliverable ``d`` *sends* later, which is what makes delay produce
  genuine reordering (the newer versions published in between are
  applied first, so the late artifact arrives stale and the engine's
  version gate rejects it — countable on both sides of the channel).

The channel is transport only: it never touches an engine. Delivery
(deserialize + version-gated adoption, per model variant) lives in
``repro.fleet.runner.Replica``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs

__all__ = ["CLEAN", "ChaosChannel", "FaultPlan"]


@dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule for one broadcast channel.

    Probabilities are per-send; ``max_delay`` bounds how many future
    sends a delayed artifact waits for. ``CLEAN`` (all zeros) is the
    perfect-transport plan the recovery phases use.
    """
    seed: int = 0
    drop: float = 0.0        # P(artifact lost)
    dup: float = 0.0         # P(artifact delivered twice)
    delay: float = 0.0       # P(held for 1..max_delay future sends)
    max_delay: int = 2

    def with_seed(self, seed: int) -> "FaultPlan":
        """Same fault mix, different (recorded) schedule — per-replica
        channels derive their seeds this way so replicas see independent
        but individually replayable schedules."""
        return dataclasses.replace(self, seed=seed)


CLEAN = FaultPlan()


class ChaosChannel:
    """A lossy, duplicating, reordering broadcast transport.

    ``send(blob, version)`` draws this send's fate (the same three
    uniforms plus one delay draw are consumed on EVERY send, so the
    schedule depends only on ``plan.seed`` and the send count — never on
    which fates were taken); ``poll()`` returns the artifacts that have
    become deliverable, oldest first. ``schedule`` records one dict per
    send: the full transcript needed to replay or audit a scenario.
    """

    def __init__(self, plan: FaultPlan, *,
                 telemetry: Optional[obs.Telemetry] = None,
                 name: str = "chan0"):
        self.plan = plan
        self.name = name
        self.telemetry = telemetry if telemetry is not None \
            else obs.Telemetry()
        self._rng = np.random.default_rng(plan.seed)
        self._queue: List[Tuple[int, int, int, bytes]] = []
        self._seq = 0
        self.sends = 0
        self.dropped = 0
        self.duplicated = 0
        self.delayed = 0
        self.schedule: List[Dict] = []

    def send(self, blob: bytes, version: int) -> Dict:
        """Trainer-side publish into the channel; returns this send's
        recorded fate."""
        u_drop, u_dup, u_delay = self._rng.uniform(size=3)
        d = int(self._rng.integers(1, max(self.plan.max_delay, 1) + 1))
        self.sends += 1
        fate = {"send": self.sends, "version": int(version),
                "dropped": bool(u_drop < self.plan.drop),
                "duplicated": bool(u_dup < self.plan.dup),
                "delay": d if u_delay < self.plan.delay else 0}
        self.schedule.append(fate)
        if fate["dropped"]:
            self.dropped += 1
            self.telemetry.emit("broadcast_dropped", version=version,
                                channel=self.name, send=self.sends)
            return fate
        due = self.sends + fate["delay"]
        if fate["delay"]:
            self.delayed += 1
        copies = 2 if fate["duplicated"] else 1
        if fate["duplicated"]:
            self.duplicated += 1
        for _ in range(copies):
            self._queue.append((due, self._seq, int(version), blob))
            self._seq += 1
        return fate

    def poll(self) -> List[Tuple[int, bytes]]:
        """Artifacts deliverable now (due at or before the current send
        index), in (due, send) order — a delayed artifact surfaces after
        the newer versions published while it was in flight."""
        ready = sorted(e for e in self._queue if e[0] <= self.sends)
        self._queue = [e for e in self._queue if e[0] > self.sends]
        return [(v, blob) for _, _, v, blob in ready]

    def flush(self) -> List[Tuple[int, bytes]]:
        """Everything still in flight, delays waived (end-of-scenario
        drain; dropped artifacts stay dropped)."""
        ready = sorted(self._queue)
        self._queue = []
        return [(v, blob) for _, _, v, blob in ready]

    @property
    def in_flight(self) -> int:
        return len(self._queue)
