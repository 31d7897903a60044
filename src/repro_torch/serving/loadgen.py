"""Open-loop load generation for the serving plane.

Closed-loop benches (submit a wave, drain, repeat) hide queueing: the
load generator politely waits for the system, so an overloaded server
still looks fine. Open-loop arrival processes do not wait — requests
arrive on their own clock, an overloaded server's queue (and p99)
grows without bound, and that is exactly the regime the SLA-aware
scheduler (``repro.serving.scheduler``) exists for (the MP-Rec /
RecNMP tail-latency motivation in PAPERS.md).

Three trace shapes:

* ``poisson_arrivals``  — homogeneous Poisson at a fixed rate (the
  textbook open-loop overload probe);
* ``diurnal_arrivals``  — nonhomogeneous Poisson via Lewis thinning,
  sinusoidal rate between a trough and a peak (the day/night swing,
  time-compressed);
* ``zipf_requests``     — request bodies with Zipf-skewed ids whose hot
  set shifts every ``chunk`` requests (the drifting-Zipf stream of
  ``repro.training.online``, re-cut into per-request bodies).

``replay`` drives any (submit, pump) pair in real time: each request is
(re)stamped and submitted AT its arrival instant, with the serving loop
pumped between arrivals — the arrival clock never waits for the server.

The port's copy of the reference's ``benchmarks/loadgen.py``, over the
port's ``RecRequest``: the same seeds give the same arrivals and bodies.
It lives in the package so that a benchmark harness of the port can
import it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from repro_torch.serving.rec_engine import RecRequest


def poisson_arrivals(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a homogeneous Poisson
    process: iid exponential inter-arrivals at ``rate_qps``."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def diurnal_arrivals(trough_qps: float, peak_qps: float, period_s: float,
                     n: int, seed: int = 0) -> np.ndarray:
    """Nonhomogeneous Poisson via Lewis thinning: sinusoidal rate from
    ``trough_qps`` (at t=0) up to ``peak_qps`` with period ``period_s``
    — a whole diurnal swing compressed into seconds."""
    assert peak_qps >= trough_qps > 0, (trough_qps, peak_qps)
    rng = np.random.default_rng(seed)
    out = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / peak_qps)
        phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / period_s))
        lam = trough_qps + (peak_qps - trough_qps) * phase
        if rng.random() * peak_qps <= lam:
            out[i] = t
            i += 1
    return out


def zipf_requests(cfg, n: int, *, mean_l: int = 8, max_l: int = 16,
                  alpha: float = 1.05, drift_per_chunk: int = 0,
                  chunk: int = 64, seed: int = 0) -> List[RecRequest]:
    """``n`` request bodies with Zipf(alpha)-ranked ids mapped onto the
    arena rows; ``drift_per_chunk`` shifts the hot set every ``chunk``
    requests (rank r serves row ``(r + shift) % rows`` — the drifting
    head means yesterday's hot rows go cold mid-trace)."""
    rng = np.random.default_rng(seed)
    rows = cfg.rows_per_table
    out: List[RecRequest] = []
    shift = 0
    for rid in range(n):
        if rid and drift_per_chunk and rid % chunk == 0:
            shift += drift_per_chunk
        dense = rng.standard_normal(cfg.dense_features).astype(np.float32)
        ids = []
        for _ in range(cfg.n_tables):
            l = int(np.clip(rng.poisson(mean_l), 1, max_l))
            ranks = rng.zipf(alpha, size=l).astype(np.int64)
            ids.append(((ranks - 1 + shift) % rows).astype(np.int32))
        out.append(RecRequest(rid=rid, dense=dense, sparse_ids=ids))
    return out


@dataclass
class OpenLoopTrace:
    """An arrival schedule bound to its request bodies."""
    kind: str
    arrivals_s: np.ndarray
    requests: List[RecRequest]

    @property
    def duration_s(self) -> float:
        return float(self.arrivals_s[-1])

    @property
    def offered_qps(self) -> float:
        return len(self.requests) / self.duration_s


def make_trace(cfg, n: int, *, kind: str = "poisson",
               rate_qps: float = 1000.0, peak_ratio: float = 3.0,
               period_s: float = 1.0, mean_l: int = 8, max_l: int = 16,
               alpha: float = 1.05, drift_per_chunk: int = 0,
               seed: int = 0) -> OpenLoopTrace:
    """One open-loop trace: ``kind`` picks the arrival process
    ("poisson" at ``rate_qps``, or "diurnal" swinging from ``rate_qps``
    up to ``rate_qps * peak_ratio``); bodies are Zipf-skewed, drifting
    when ``drift_per_chunk`` > 0."""
    if kind == "poisson":
        arrivals = poisson_arrivals(rate_qps, n, seed=seed)
    elif kind == "diurnal":
        arrivals = diurnal_arrivals(rate_qps, rate_qps * peak_ratio,
                                    period_s, n, seed=seed)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    reqs = zipf_requests(cfg, n, mean_l=mean_l, max_l=max_l, alpha=alpha,
                         drift_per_chunk=drift_per_chunk, seed=seed + 1)
    return OpenLoopTrace(kind=kind, arrivals_s=arrivals, requests=reqs)


def replay(trace: OpenLoopTrace, submit: Callable[[RecRequest], object],
           pump: Callable[[], object], *, speed: float = 1.0,
           clock: Callable[[], float] = time.monotonic) -> float:
    """Real-time open-loop replay.

    Submits each request AT its arrival time (scaled by ``1/speed``),
    pumping the serving loop while waiting for the next arrival — the
    arrival clock never blocks on the server, which is the whole point.
    Arrival stamps (``submitted_mono`` / ``submitted_at``) are (re)set
    at the submit instant, so queue-wait and latency measure from
    arrival, not from trace construction. Returns elapsed seconds.
    """
    t0 = clock()
    for t_arr, req in zip(trace.arrivals_s, trace.requests):
        target = t0 + t_arr / speed
        while clock() < target:
            pump()
        req.submitted_mono = clock()
        req.submitted_at = time.time()
        submit(req)
    return clock() - t0
