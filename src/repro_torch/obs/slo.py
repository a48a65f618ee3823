"""SLO accounting: deadline misses and goodput-under-SLO.

The headline serving metric under open-loop traffic is not raw throughput
but **goodput under an SLO** -- the rate of requests served *within* a
latency target (``TrafficProfile.arrival_rate`` alone feeds no
deadline/latency term).  This module computes it with
arithmetic over the same per-request data the spans and ``ServingStats``
records already carry:

  SLO compliance   a request served with ``latency_s <= slo_s`` is
                   compliant; ``goodput_rps`` is compliant requests per
                   second of serving span (or per trailing window).
  deadline misses  independent of the SLO: a request whose *flush
                   deadline* (``submit + max_delay_s``, the knob that
                   drives microbatching) passed before it was fulfilled.
                   Deadlines used to shape batching only; now misses are
                   counted (see also ``ServingStats.summary``).

``SLOTracker`` is fed by the serving engine at retire time (one
``observe`` per fulfilled request) and mirrors its counts into the metric
registry (``slo_requests_total`` / ``slo_miss_total`` /
``deadline_miss_total`` by op) so the Prometheus export and the SLO
summary can never disagree.  ``from_records`` computes the same summary
offline from ``ServingStats`` records -- the replay/CI path where no
tracker was attached.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, Iterable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLORecord:
    """One fulfilled request, as the SLO math sees it."""
    op: str
    t_done: float
    latency_s: float
    compliant: bool
    deadline_missed: bool


def _summary(records, slo_s: Optional[float], span_s: float,
             window_s: Optional[float] = None) -> Dict:
    n = len(records)
    compliant = sum(1 for r in records if r.compliant)
    deadline_missed = sum(1 for r in records if r.deadline_missed)
    return {
        "slo_ms": slo_s * 1e3 if slo_s is not None else None,
        "window_s": window_s,
        "requests": n,
        "compliant": compliant,
        "slo_miss_count": n - compliant,
        "slo_miss_frac": (n - compliant) / n if n else 0.0,
        "deadline_miss_count": deadline_missed,
        "deadline_miss_frac": deadline_missed / n if n else 0.0,
        "goodput_rps": compliant / span_s if span_s > 0 else 0.0,
        "throughput_rps": n / span_s if span_s > 0 else 0.0,
    }


class SLOTracker:
    """Streaming SLO accounting over fulfilled requests.

    Args:
      slo_s: the latency target; ``None`` means "no SLO" (every request
        compliant -- goodput degenerates to throughput, deadline misses
        still count).
      registry: optional ``metrics.MetricRegistry`` to mirror counters
        into (``slo_requests_total{op}``, ``slo_miss_total{op}``,
        ``deadline_miss_total{op}``).
      clock: only used for the default ``now`` of windowed summaries;
        inject the server's clock in tests.
      capacity: bounded record ring (windowed summaries look back at most
        this many requests).
    """

    def __init__(self, slo_s: Optional[float] = None, registry=None,
                 clock=time.monotonic, capacity: int = 65536):
        if slo_s is not None and slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {slo_s}")
        self.slo_s = slo_s
        self.clock = clock
        self.records: Deque[SLORecord] = deque(maxlen=capacity)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._m_requests = self._m_miss = self._m_deadline = None
        if registry is not None:
            self._m_requests = registry.counter(
                "slo_requests_total", "Requests fulfilled (SLO accounting).",
                ("op",))
            self._m_miss = registry.counter(
                "slo_miss_total", "Requests fulfilled over the SLO target.",
                ("op",))
            self._m_deadline = registry.counter(
                "deadline_miss_total",
                "Requests fulfilled after their flush deadline.", ("op",))

    def observe(self, op: str, latency_s: float, t_done: float,
                t_submit: Optional[float] = None,
                deadline: Optional[float] = None) -> SLORecord:
        """Account one fulfilled request.

        ``deadline`` is the request's flush-by time on the same clock as
        ``t_done`` (None = no deadline tracking for this request).
        """
        compliant = self.slo_s is None or latency_s <= self.slo_s
        missed = deadline is not None and t_done > deadline
        rec = SLORecord(op=op, t_done=t_done, latency_s=latency_s,
                        compliant=compliant, deadline_missed=missed)
        self.records.append(rec)
        t_start = t_done - latency_s if t_submit is None else t_submit
        self._t_first = (t_start if self._t_first is None
                         else min(self._t_first, t_start))
        self._t_last = (t_done if self._t_last is None
                        else max(self._t_last, t_done))
        if self._m_requests is not None:
            self._m_requests.labels(op=op).inc(now=t_done)
            if not compliant:
                self._m_miss.labels(op=op).inc(now=t_done)
            if missed:
                self._m_deadline.labels(op=op).inc(now=t_done)
        return rec

    def summary(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> Dict:
        """Goodput/miss accounting, lifetime or over a trailing window.

        Lifetime goodput divides by the served span (first submit to last
        fulfil); a windowed summary divides by the window length -- the
        quantity a controller compares against the arrival rate.
        """
        if window_s is None:
            span = ((self._t_last - self._t_first)
                    if self._t_first is not None else 0.0)
            return _summary(list(self.records), self.slo_s, span)
        now = self.clock() if now is None else now
        recent = [r for r in self.records if r.t_done >= now - window_s]
        return _summary(recent, self.slo_s, window_s, window_s=window_s)

    def reset(self) -> None:
        self.records.clear()
        self._t_first = self._t_last = None


def from_records(records: Iterable, slo_s: Optional[float]) -> Dict:
    """The SLO summary computed offline from ``ServingStats`` records
    (``RequestRecord`` rows carry t_submit/t_done/deadline already)."""
    recs = list(records)
    rows = [SLORecord(
        op=r.op, t_done=r.t_done, latency_s=r.latency_s,
        compliant=slo_s is None or r.latency_s <= slo_s,
        deadline_missed=(getattr(r, "deadline", math.inf) < r.t_done))
        for r in recs]
    if recs:
        span = max(r.t_done for r in recs) - min(r.t_submit for r in recs)
    else:
        span = 0.0
    return _summary(rows, slo_s, span)
