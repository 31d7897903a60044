"""Bounded-memory serving metrics: counters, gauges, streaming histograms.

The serving plane used to keep ``self.latencies``/``self.batch_sizes`` as
plain Python lists — O(requests served) memory, guaranteed to OOM a
long-lived replica. Every instrument here is O(1) in the number of
observations:

* ``Counter`` / ``Gauge`` — one float each;
* ``Histogram`` — a fixed log-spaced bucket array (streaming p50/p95/p99
  by in-bucket interpolation, relative error bounded by the bucket growth
  factor) plus a fixed-size ring of the most recent raw samples, which
  buys two things: *exact* percentiles while the stream still fits the
  ring (so short runs report the same numbers the old unbounded list
  did), and exact rolling-N percentiles forever after. A second bucket
  array forms the *window* view (``reset_window``), used by the engine
  for since-last-swap percentiles — a post-swap latency regression shows
  up instead of being averaged into history.

``MetricsRegistry`` is the one place instruments live: get-or-create by
(name, labels), JSON ``snapshot()`` for dashboards/artifacts, and
Prometheus-style text ``exposition()`` for scrapers.

The port's copy of ``repro.obs.metrics``, numpy only, with the same bucket
bounds, ring and views. ``Histogram.record_many`` adds one call that
records a micro-batch's samples in one vectorised pass and leaves the
histogram exactly as the same samples recorded one by one would.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _fmt(v: float) -> str:
    """Deterministic number formatting for the exposition text."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.6g}"


class Counter:
    """Monotone accumulator (requests served, cache hits, ...)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self.name} can only go up (got {n})"
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (source version, queue depth, loss, ...)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram with bounded memory and three percentile views.

    * ``percentile(q)`` — since construction. Exact (``np.percentile``
      over the raw ring) while ``count <= ring`` samples have been seen;
      afterwards a bucket-interpolated estimate whose relative error is
      bounded by ``growth - 1`` (the bucket width ratio).
    * ``percentile(q, window='window')`` — since the last
      ``reset_window()`` (bucket estimate). The serving engine resets
      this window on every version swap.
    * ``percentile(q, window='rolling')`` — exact over the last
      ``min(count, ring)`` samples.

    Values below ``lo`` clamp into the first bucket, above ``hi`` into
    the last — the estimate degrades gracefully instead of growing state.
    """

    __slots__ = ("name", "help", "labels", "_bounds", "_edges", "_counts",
                 "_window_counts", "_ring", "_ring_pos", "count",
                 "window_count", "total", "_growth")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None, *,
                 lo: float = 1e-3, hi: float = 1e5, growth: float = 1.08,
                 ring: int = 2048):
        assert lo > 0 and hi > lo and growth > 1 and ring >= 1
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        n = int(np.ceil(np.log(hi / lo) / np.log(growth))) + 1
        self._bounds = lo * growth ** np.arange(n + 1)
        # the interior edges: a sample's bucket is the number of them at
        # or below it, which is the reference's searchsorted on the bounds
        # clamped to [0, n - 1]
        self._edges = self._bounds[1:-1]
        self._growth = growth
        self._counts = np.zeros(n, np.int64)
        self._window_counts = np.zeros(n, np.int64)
        self._ring = np.zeros(ring, np.float64)
        self._ring_pos = 0
        self.count = 0
        self.window_count = 0
        self.total = 0.0

    @property
    def ring_size(self) -> int:
        return len(self._ring)

    def record(self, v: float) -> None:
        v = float(v)
        b = int(self._edges.searchsorted(v, side="right"))
        self._counts[b] += 1
        self._window_counts[b] += 1
        self._ring[self._ring_pos] = v
        self._ring_pos = (self._ring_pos + 1) % len(self._ring)
        self.count += 1
        self.window_count += 1
        self.total += v

    def record_many(self, values) -> None:
        """Record a sequence of samples in one pass: one ``searchsorted``
        over the array, one ``np.add.at`` on each count array, the ring
        written in order. The state after it (counts, window counts,
        ring, ring position, count, total) is exactly what ``record``
        called on each sample in turn leaves: ``total`` adds the samples
        in order, as those calls do (``np.sum`` would group them)."""
        v = np.asarray(values, np.float64).reshape(-1)
        n = v.size
        if n == 0:
            return
        b = self._edges.searchsorted(v, side="right")
        np.add.at(self._counts, b, 1)
        np.add.at(self._window_counts, b, 1)
        ring, pos = self._ring.size, self._ring_pos
        if n <= ring - pos:
            self._ring[pos:pos + n] = v
        else:
            # of more than a ring's worth, only the last ring's survives
            tail = v[-ring:]
            start = (pos + n - tail.size) % ring
            self._ring[(start + np.arange(tail.size)) % ring] = tail
        self._ring_pos = (pos + n) % ring
        self.count += n
        self.window_count += n
        total = self.total
        for x in v.tolist():
            total += x
        self.total = total

    def reset_window(self) -> None:
        """Start a fresh 'window' view (cumulative/rolling untouched)."""
        self._window_counts[:] = 0
        self.window_count = 0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def ring_values(self) -> np.ndarray:
        """The last min(count, ring) raw samples, oldest first."""
        n = min(self.count, len(self._ring))
        if n < len(self._ring):
            return self._ring[:n].copy()
        p = self._ring_pos
        return np.concatenate([self._ring[p:], self._ring[:p]])

    def _bucket_percentile(self, q: float, counts: np.ndarray,
                           n: int) -> float:
        if n == 0:
            return 0.0
        target = q / 100.0 * n
        cum = np.cumsum(counts)
        b = int(np.searchsorted(cum, max(target, 1e-12)))
        b = min(b, len(counts) - 1)
        prev = cum[b - 1] if b > 0 else 0
        inside = counts[b]
        frac = (target - prev) / inside if inside else 0.0
        lo, hi = self._bounds[b], self._bounds[b + 1]
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    def percentile(self, q: float, window: str = "cumulative") -> float:
        if window == "cumulative":
            if self.count == 0:
                return 0.0
            if self.count <= len(self._ring):
                # the stream still fits the ring: exact, bit-for-bit what
                # an unbounded list would have reported
                return float(np.percentile(self.ring_values(), q))
            return self._bucket_percentile(q, self._counts, self.count)
        if window == "window":
            return self._bucket_percentile(q, self._window_counts,
                                           self.window_count)
        if window == "rolling":
            if self.count == 0:
                return 0.0
            return float(np.percentile(self.ring_values(), q))
        raise ValueError(f"unknown percentile window {window!r} "
                         "(cumulative | window | rolling)")

    def fraction_leq(self, v: float, window: str = "cumulative") -> float:
        """Fraction of observations <= v (the SLA-attainment query).
        Exact from the raw ring while the stream fits it (or for the
        rolling window); bucket-interpolated afterwards."""
        if window == "rolling" or (window == "cumulative"
                                   and self.count <= len(self._ring)):
            vals = self.ring_values()
            return float(np.mean(vals <= v)) if len(vals) else 0.0
        counts, n = ((self._counts, self.count)
                     if window == "cumulative"
                     else (self._window_counts, self.window_count))
        if n == 0:
            return 0.0
        b = int(np.searchsorted(self._bounds, v, side="right")) - 1
        if b < 0:
            return 0.0
        b = min(b, len(counts) - 1)
        below = int(np.sum(counts[:b]))
        lo, hi = self._bounds[b], self._bounds[b + 1]
        frac = min(max((v - lo) / (hi - lo), 0.0), 1.0)
        return float(below + frac * counts[b]) / n

    def summary(self) -> Dict[str, float]:
        return {"count": self.count,
                "sum": self.total,
                "mean": self.mean,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
                "p99": self.percentile(99)}


def _key(name: str, labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create instrument store with JSON + Prometheus views."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._counters.setdefault(_key(name, labels),
                                         Counter(name, help, labels))

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._gauges.setdefault(_key(name, labels),
                                       Gauge(name, help, labels))

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  **kwargs) -> Histogram:
        key = _key(name, labels)
        if key not in self._histograms:
            self._histograms[key] = Histogram(name, help, labels, **kwargs)
        return self._histograms[key]

    def histograms(self, name: str) -> Dict[str, Histogram]:
        """Every labeled variant of one histogram family."""
        return {k: h for k, h in self._histograms.items()
                if h.name == name}

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able view of every instrument (the --metrics-json body)."""
        return {
            "counters": {k: c.value for k, c in
                         sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary() for k, h in
                           sorted(self._histograms.items())},
        }

    def exposition(self) -> str:
        """Prometheus text format. Histograms render as summaries
        (streaming quantiles + _sum/_count)."""
        lines = []
        seen_help = set()

        def header(inst, kind):
            if inst.name not in seen_help:
                seen_help.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {kind}")

        for key, c in sorted(self._counters.items()):
            header(c, "counter")
            lines.append(f"{key} {_fmt(c.value)}")
        for key, g in sorted(self._gauges.items()):
            header(g, "gauge")
            lines.append(f"{key} {_fmt(g.value)}")
        for key, h in sorted(self._histograms.items()):
            header(h, "summary")
            base = dict(h.labels)
            for q in (0.5, 0.95, 0.99):
                lab = _key(h.name, dict(base, quantile=str(q)))
                lines.append(f"{lab} {_fmt(h.percentile(q * 100))}")
            lines.append(f"{_key(h.name + '_sum', base)} {_fmt(h.total)}")
            lines.append(f"{_key(h.name + '_count', base)} "
                         f"{_fmt(h.count)}")
        return "\n".join(lines) + "\n"
