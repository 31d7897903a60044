"""repro_torch.obs — the telemetry subsystem (metrics, traces, events),
the port's copy of the reference's ``repro.obs``.

Three layers, one bundle:

* :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` of counters, gauges,
  and bounded-memory streaming histograms (p50/p95/p99 without keeping
  every sample), with JSON ``snapshot()`` and Prometheus-style
  ``exposition()``.
* :mod:`repro_torch.obs.tracing` — ``Tracer`` for nested per-request
  spans through the serving pipeline, plus the model-side ``stage()`` /
  ``step_annotation()`` hooks that line our spans up with
  ``torch.profiler`` traces (``record_function``). Off by default with a
  zero-cost null path.
* :mod:`repro_torch.obs.events` — ``EventLog`` for the versioned-swap
  protocol (swaps, rebuilds, refreshes, stale rejections) with
  per-version hit-rate attribution.

``Telemetry`` is the bundle consumers take as one constructor argument:

    from repro_torch import obs
    engine = RecEngine(cfg, params, source="cached", cache_k=K,
                       cache_trace=counts,
                       telemetry=obs.Telemetry(tracing=True))
    ...
    print(engine.telemetry.registry.exposition())
    print(engine.telemetry.events.hit_rate_by_version())

``Telemetry(metrics=False)`` is the genuinely uninstrumented
configuration: the engine records nothing and never dispatches the
hit-rate probe (on the card its graphs are captured without it) — the
baseline of the reference's ``obs_overhead`` benchmark scenario.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.events import Event, EventLog
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracing import (Span, Tracer,
                                     enable_stage_annotations, stage,
                                     stage_annotations_enabled,
                                     step_annotation)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "stage", "step_annotation",
    "enable_stage_annotations", "stage_annotations_enabled",
    "Event", "EventLog", "Telemetry",
]


class Telemetry:
    """One bundle of registry + tracer + event log.

    ``metrics``  — master switch. False means *nothing* is recorded and
                   the engine skips even dispatching accounting work
                   (the hit-rate probe); histograms/counters stay empty.
    ``tracing``  — collect per-request spans (host-side timing).
    ``device_stages`` — run the serving forward as three eager stages
                   with a sync between each, recording per-stage
                   *device* time (CUDA events on the card) — the live
                   Fig-5 mode. Costs the stage-boundary syncs and the
                   graph replay; only turn on when you want the
                   characterization.
    """

    def __init__(self, *, metrics: bool = True, tracing: bool = False,
                 device_stages: bool = False, max_spans: int = 4096,
                 max_events: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = bool(metrics)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=tracing and self.enabled,
                             max_spans=max_spans)
        self.events = EventLog(max_events=max_events)
        self.device_stages = bool(device_stages) and self.enabled

    @classmethod
    def disabled(cls) -> "Telemetry":
        """The uninstrumented configuration (obs_overhead baseline)."""
        return cls(metrics=False)

    def span(self, name: str, attrs=None):
        return self.tracer.span(name, attrs)

    def emit(self, kind: str, version=None, **attrs):
        if not self.enabled:
            return None
        return self.events.emit(kind, version, **attrs)

    def snapshot(self) -> dict:
        """Registry snapshot + recent events, JSON-able (--metrics-json)."""
        snap = self.registry.snapshot()
        snap["events"] = [e.to_dict() for e in self.events.events]
        snap["hit_rate_by_version"] = {
            str(k): v for k, v in
            self.events.hit_rate_by_version().items()}
        return snap
