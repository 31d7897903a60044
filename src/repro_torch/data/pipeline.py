"""Host-side input pipeline: background prefetch + device placement, the
counterpart of the reference's ``repro/data/pipeline.py``.

A worker thread generates batches ahead of the training step,
double-buffered through a bounded queue, and places each one on the
device, so a step takes an already-resident batch. The reference places
onto a JAX mesh; here ``make_placer`` copies into pinned host memory and
then to the card with ``non_blocking`` copies, which the step's kernels
on the same stream wait for. On a mesh (``make_placer(device, mesh,
batch_specs)``, the specs ``distributed.sharding.resolve``'s tuples, as
the reference's ``PartitionSpec``s) each rank places its own block of
every host array (``sharding.local_block``), the block a
``NamedSharding`` would put on its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh


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


def make_placer(device=None, mesh=None, batch_specs=None) -> Callable:
    """Returns fn placing a numpy batch on ``device`` (the card unless
    told otherwise): on the card through pinned host tensors and
    ``non_blocking`` copies, on the CPU as tensors that own copies of the
    arrays. With ``mesh`` (a ``launch.mesh.Mesh``), ``batch_specs`` maps
    every key of a batch to its spec (``sharding.resolve(mesh,
    logical)``), and the rank places its block of each array."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if batch_specs is None:
            raise ValueError("placing onto a mesh needs batch_specs: a spec "
                             "(sharding.resolve) for every key")
    device = resolve_device(device)

    def place(batch):
        host = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.array(v))
            if mesh is not None:
                t = sharding.local_block(t, mesh, batch_specs[k])
            host[k] = t
        if device.type == "cpu":
            return host
        return {k: v.pin_memory().to(device, non_blocking=True)
                for k, v in host.items()}
    return place
