"""Per-request span tracing for the serving pipeline.

A *span* is one named, timed region (``enqueue``, ``batch``,
``bucket_pad``, ``sparse_lookup``, ``interaction``, ``mlp``,
``respond``). Spans nest: ``Tracer.span()`` is a context manager and the
tracer maintains a stack, so a ``serve_step`` span contains the
``sparse_lookup`` span it opened. Finished spans land in a bounded deque
(oldest dropped) — tracing a replica for a week costs the same memory as
tracing it for a minute.

Two hook layers bridge our spans to the PyTorch profiler:

* ``stage(name)`` — used inside the model's stages (dlrm /
  embedding_source). Disabled (the default) it returns a shared
  ``nullcontext`` singleton: no object allocation and nothing recorded.
  Enabled it opens ``torch.profiler.record_function(name)``, so the stage
  names show up in ``torch.profiler`` traces (host time per stage) beside
  our spans. The ops run are the same either way: a captured CUDA graph
  records the same kernels with or without the annotations.
* ``step_annotation(n)`` — a ``record_function`` named ``name#n`` for the
  serve/train step loop, same disabled-is-free contract.

The port's copy of ``repro.obs.tracing``.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Deque, Dict, Iterator, List, Optional

from torch.profiler import record_function

__all__ = ["Span", "Tracer", "stage", "step_annotation",
           "enable_stage_annotations", "stage_annotations_enabled"]

# Stage hooks are module-level (not per-Tracer) because they run inside
# model functions that know nothing about engine instances. One shared
# disabled singleton keeps the off path allocation-free and lets tests
# assert `stage("x") is stage("y")`.
_NULL = nullcontext()
_STAGE_ANNOTATIONS = False


def enable_stage_annotations(on: bool = True) -> None:
    """Globally toggle ``record_function`` annotations in the model's
    stages. Off by default; they are host-side only (the same ops run
    either way, pinned by test)."""
    global _STAGE_ANNOTATIONS
    _STAGE_ANNOTATIONS = bool(on)


def stage_annotations_enabled() -> bool:
    return _STAGE_ANNOTATIONS


def stage(name: str):
    """Context manager wrapping one pipeline stage of the model."""
    if not _STAGE_ANNOTATIONS:
        return _NULL
    return record_function(name)


def step_annotation(step_num: int, name: str = "serve_step"):
    """A profiler annotation of one step of the host-side step loop."""
    if not _STAGE_ANNOTATIONS:
        return _NULL
    return record_function(f"{name}#{step_num}")


class Span:
    """One finished (or open) timed region."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "attrs")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], start: float,
                 attrs: Optional[Dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict = dict(attrs or {})

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.perf_counter()) - self.start) * 1e3

    def to_dict(self) -> Dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end,
                "duration_ms": self.duration_ms, "attrs": self.attrs}


class Tracer:
    """Bounded collector of nested spans.

    ``enabled=False`` (the default for a bare engine) turns ``span()``
    into the shared null context — the serve path pays one attribute
    check, nothing else.
    """

    def __init__(self, *, enabled: bool = True, max_spans: int = 4096):
        self.enabled = enabled
        self.finished: Deque[Span] = deque(maxlen=max_spans)
        self._stack: List[Span] = []
        self._ids = itertools.count(1)
        self._trace_ids = itertools.count(1)

    @contextmanager
    def _span_cm(self, name: str, attrs: Optional[Dict]) -> Iterator[Span]:
        parent = self._stack[-1] if self._stack else None
        s = Span(name,
                 trace_id=(parent.trace_id if parent
                           else next(self._trace_ids)),
                 span_id=next(self._ids),
                 parent_id=parent.span_id if parent else None,
                 start=time.perf_counter(), attrs=attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self._stack.pop()
            self.finished.append(s)

    def span(self, name: str, attrs: Optional[Dict] = None):
        if not self.enabled:
            return _NULL
        return self._span_cm(name, attrs)

    def record(self, name: str, start: float, end: float,
               attrs: Optional[Dict] = None) -> Optional[Span]:
        """Append an already-timed span (perf_counter timestamps),
        nested under the currently open span if any. Used when the timed
        region ends before its logical parent opens (e.g. the batcher
        drain that precedes the serve_step span it belongs to)."""
        if not self.enabled:
            return None
        parent = self._stack[-1] if self._stack else None
        s = Span(name,
                 trace_id=(parent.trace_id if parent
                           else next(self._trace_ids)),
                 span_id=next(self._ids),
                 parent_id=parent.span_id if parent else None,
                 start=start, attrs=attrs)
        s.end = end
        self.finished.append(s)
        return s

    def spans(self, name: Optional[str] = None) -> List[Span]:
        if name is None:
            return list(self.finished)
        return [s for s in self.finished if s.name == name]

    def traces(self) -> Dict[int, List[Span]]:
        """Finished spans grouped by trace, each in finish order."""
        out: Dict[int, List[Span]] = {}
        for s in self.finished:
            out.setdefault(s.trace_id, []).append(s)
        return out

    def clear(self) -> None:
        self.finished.clear()
