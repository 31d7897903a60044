"""Host-side input pipeline: background prefetch + device placement, the
counterpart of the reference's ``repro/data/pipeline.py``.

A worker thread generates batches ahead of the training step,
double-buffered through a bounded queue, and places each one on the
device, so a step takes an already-resident batch. The reference places
onto a JAX mesh; here ``make_placer`` copies into pinned host memory and
then to the card with ``non_blocking`` copies, which the step's kernels
on the same stream wait for. Placing onto a mesh (``make_placer(mesh)``)
is not ported yet (ROADMAP Queue 1, item 13b).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device


class Prefetcher:
    """Wrap a host batch iterator with N-deep background prefetch. The
    end of the iterator ends the prefetcher; an exception the iterator or
    ``place`` raises surfaces on the next ``__next__``."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], depth: int = 2,
                 place: Optional[Callable] = None):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._place = place or (lambda x: x)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._place(batch))
            self._q.put(None)         # end-of-stream sentinel
        except BaseException as e:   # surfaced on next __next__
            self._exc = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def make_placer(device=None, mesh=None) -> Callable:
    """Returns fn placing a numpy batch on ``device`` (the card unless
    told otherwise): on the card through pinned host tensors and
    ``non_blocking`` copies, on the CPU as tensors that own copies of the
    arrays."""
    if mesh is not None:
        raise NotImplementedError(
            "placing a batch onto a mesh is not ported yet (ROADMAP Queue "
            "1, item 13b)")
    device = resolve_device(device)

    def place(batch):
        host = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        if device.type == "cpu":
            return host
        return {k: v.pin_memory().to(device, non_blocking=True)
                for k, v in host.items()}
    return place
