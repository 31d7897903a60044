"""Fault tolerance for long runs: the reference's
``repro/distributed/fault_tolerance.py``, whose restores land on the
checkpoint manager's device.

On a synchronous SPMD fleet the realistic levers are:

* **checkpoint/restart** — periodic async checkpoints + resume-from-latest
  (``ResilientTrainer``); a dead node means the job scheduler re-provisions
  and every worker restarts from step N (tested by killing a run mid-stream);
* **straggler detection** — per-step wall-time EWMA; a step slower than
  ``threshold x`` the running median flags the slowest host for replacement
  (the replacement is the caller's ``on_straggler`` callback);
* **data-skip determinism** — the data generator is seeded by step number, so
  a restarted run consumes exactly the batches it would have.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointManager


class SimulatedFailure(Exception):
    """Raised by tests/examples to model a node loss mid-run."""


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 32,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.threshold = threshold
        self.durations: deque = deque(maxlen=window)
        self.on_straggler = on_straggler or (lambda step, dt: None)
        self.events: List[Dict] = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step was flagged as a straggler."""
        flagged = False
        if len(self.durations) >= 8:
            med = sorted(self.durations)[len(self.durations) // 2]
            if duration_s > self.threshold * med:
                flagged = True
                self.events.append({"step": step, "duration": duration_s,
                                    "median": med})
                self.on_straggler(step, duration_s)
        if not flagged:
            # flagged outliers stay out of the window: a straggler that
            # polluted the median would raise the bar enough to mask an
            # immediately following straggler of the same magnitude
            self.durations.append(duration_s)
        return flagged


class ResilientTrainer:
    """Checkpoint/restart wrapper around a train step.

    run() executes steps [resume..total); any exception triggers a restore
    from the latest checkpoint and continuation, up to max_restarts.
    """

    def __init__(self, step_fn, ckpt: CheckpointManager,
                 ckpt_every: int = 50, max_restarts: int = 3,
                 straggler: Optional[StragglerMonitor] = None,
                 on_resume: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerMonitor()
        self.on_resume = on_resume
        self.restarts = 0

    def run(self, state, batch_fn, total_steps: int,
            fail_at: Optional[int] = None):
        """state: (params, opt_state); batch_fn(step) -> batch. A restore
        hands ``step_fn`` new tensors, which become the live state.

        fail_at: step at which to raise SimulatedFailure once (tests).
        """
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, _ = self.ckpt.restore(state, step=latest)
            start = latest + 1

        step = start
        metrics = None
        while step < total_steps:
            try:
                t0 = time.time()
                if fail_at is not None and step == fail_at \
                        and self.restarts == 0:
                    raise SimulatedFailure(f"node lost at step {step}")
                params, opt_state, metrics = self.step_fn(
                    state[0], state[1], batch_fn(step))
                state = (params, opt_state)
                self.straggler.record(step, time.time() - t0)
                if (step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = 0
                    if self.on_resume is not None:
                        self.on_resume(step)
                    continue
                state, _ = self.ckpt.restore(state, step=latest)
                step = latest + 1
                if self.on_resume is not None:
                    self.on_resume(step)
        self.ckpt.wait()
        return state, metrics
