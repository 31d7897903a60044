"""One captured forward per (path, bucket): the card's counterpart of the
reference engine's ``jax.jit`` executable per bucket.

``ServeGraph`` owns, for one bucket's static shapes:

* the static device inputs the graph reads (``inputs``: ``dense`` and the
  bucket's id tensors) and the output it writes;
* the CUDA graph of the forward, captured once after one eager pass on a
  side stream (the pass builds and loads the kernels and sets their
  attributes outside the capture);
* a ring of ``Slot``s, one per micro-batch in flight: pinned host inputs
  that the engine fills in numpy, a pinned host output, and the event
  recorded after the output's copy back.

``replay(slot)`` enqueues, on the current stream and in this order, the
slot's host-to-device copies into the static inputs, the graph, and the
copy of the probabilities into the slot's pinned output, then records the
slot's event; nothing waits on the host. The engine's graphs share one
memory pool. That is safe because every replay's output is copied out
before the next replay on the same stream can reuse the pool's memory.

A capture records kernel launches without running them, and a replay
runs no Python: the kernel wrappers' launch counters tick during the
eager pass and the capture, never during a replay.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["ServeGraph", "Slot"]

Shapes = Dict[str, Tuple[tuple, torch.dtype]]


class Slot:
    """One micro-batch in flight through a ``ServeGraph``: pinned host
    inputs (``arrays``, numpy views the engine fills), a pinned output
    and the event recorded after the output's copy back."""

    def __init__(self, shapes: Shapes, n_out: int):
        self.host = {k: torch.zeros(s, dtype=dt, pin_memory=True)
                     for k, (s, dt) in shapes.items()}
        self.arrays: Dict[str, np.ndarray] = {k: t.numpy()
                                              for k, t in self.host.items()}
        self.out = torch.zeros(n_out, dtype=torch.float32, pin_memory=True)
        self.event = torch.cuda.Event()
        self.busy = False

    def result(self) -> np.ndarray:
        """The probabilities, once the copy back has landed (the one host
        wait of a dispatched micro-batch); a view of the pinned output,
        valid until ``release``."""
        self.event.synchronize()
        return self.out.numpy()

    def release(self) -> None:
        self.busy = False


class ServeGraph:
    """The captured forward of one (path, bucket) pair.

    ``forward(inputs)`` is the eager serve step over a batch dict; it
    must not wait on the host (no ``.item()``, no synchronize), or the
    capture raises. ``pool`` is the engine's graph memory pool."""

    def __init__(self, forward: Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor],
                 shapes: Shapes, device: torch.device, pool):
        self._shapes = shapes
        self.inputs = {k: torch.zeros(s, dtype=dt, device=device)
                       for k, (s, dt) in shapes.items()}
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            forward(self.inputs)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.output = forward(self.inputs)
        self._slots: List[Slot] = []

    def acquire(self) -> Slot:
        """A free ring slot (a new one when every slot is in flight), its
        last copy back complete, so the host may write its inputs."""
        slot = next((s for s in self._slots if not s.busy), None)
        if slot is None:
            slot = Slot(self._shapes, self.output.shape[0])
            self._slots.append(slot)
        slot.event.synchronize()
        slot.busy = True
        return slot

    def replay(self, slot: Slot) -> None:
        """Copy the slot's inputs in, replay, copy the probabilities out
        and record the slot's event, all enqueued on the current
        stream."""
        for k, t in self.inputs.items():
            t.copy_(slot.host[k], non_blocking=True)
        self.graph.replay()
        slot.out.copy_(self.output, non_blocking=True)
        slot.event.record()
