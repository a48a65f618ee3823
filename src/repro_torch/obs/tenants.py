"""Tenant-labeled metric families for the traffic frontend.

The serving engine's registry keys its telemetry by (op, bucket,
backend) -- the *device's* view of traffic.  The open-loop frontend
needs the *tenant's* view: who was admitted, who was shed, who made
their SLO, and at what per-tenant goodput.  ``TenantAccounting`` owns those families inside a
shared ``MetricRegistry`` (so one ``--metrics-out`` export carries both
views) and keeps exact per-tenant aggregates on the side -- the metric
histograms are fixed-bucket approximations, but fairness assertions
("WFQ bounds the starved tenant's p99 where FIFO does not") want exact
percentiles over bounded runs.

Families:

  frontend_requests_total{tenant, outcome}    admission outcomes
      (outcome: served | degraded | shed | throttled)
  frontend_tenant_latency_seconds{tenant}     ingress-to-completion
  frontend_tenant_slo_total{tenant, status}   per-tenant SLO verdicts
      (status: ok | miss)
  frontend_tenant_goodput_rps{tenant}         set at report time
  frontend_tenant_queue_depth{tenant}         scheduler queue depth
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np

from .metrics import MetricRegistry

OUTCOMES = ("served", "degraded", "shed", "throttled")


def _pctl(values: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(values, float), p))


class TenantAccounting:
    """Per-tenant admission/latency/goodput accounting, mirrored into a
    ``MetricRegistry``.

    Args:
      registry: registry to register the families in; a private one is
        created when omitted (standalone use in tests).
      clock: timestamp source for the registry's windowed event rings --
        pass the server's clock so tenant series line up with serving
        telemetry, including under an injected test clock.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 clock=time.monotonic):
        self.registry = (registry if registry is not None
                         else MetricRegistry(clock=clock))
        self.clock = clock
        reg = self.registry
        self._m_requests = reg.counter(
            "frontend_requests_total",
            "Frontend admission outcomes by tenant.",
            ("tenant", "outcome"))
        self._m_latency = reg.histogram(
            "frontend_tenant_latency_seconds",
            "Frontend ingress-to-completion latency by tenant.",
            ("tenant",))
        self._m_slo = reg.counter(
            "frontend_tenant_slo_total",
            "Per-tenant SLO verdicts for served requests.",
            ("tenant", "status"))
        self._m_goodput = reg.gauge(
            "frontend_tenant_goodput_rps",
            "SLO-compliant served requests/s by tenant (report time).",
            ("tenant",))
        self._m_depth = reg.gauge(
            "frontend_tenant_queue_depth",
            "Scheduler queue depth by tenant.",
            ("tenant",))
        self._outcomes: Dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self._latencies: Dict[str, List[float]] = \
            collections.defaultdict(list)
        self._slo_ok: Dict[str, int] = collections.defaultdict(int)

    def outcome(self, tenant: str, outcome: str,
                now: Optional[float] = None) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(
                f"unknown outcome {outcome!r}; one of {OUTCOMES}")
        self._outcomes[tenant][outcome] += 1
        self._m_requests.labels(tenant=tenant, outcome=outcome).inc(now=now)

    def served(self, tenant: str, latency_s: float, slo_ok: bool,
               now: Optional[float] = None) -> None:
        """One completed (served or degraded) request's latency + SLO
        verdict.  Callers record the admission ``outcome`` separately."""
        self._latencies[tenant].append(float(latency_s))
        self._m_latency.labels(tenant=tenant).observe(latency_s, now=now)
        self._m_slo.labels(
            tenant=tenant, status="ok" if slo_ok else "miss").inc(now=now)
        if slo_ok:
            self._slo_ok[tenant] += 1

    def queue_depth(self, tenant: str, depth: int,
                    now: Optional[float] = None) -> None:
        self._m_depth.labels(tenant=tenant).set(depth, now=now)

    def goodput(self, tenant: str, rps: float,
                now: Optional[float] = None) -> None:
        self._m_goodput.labels(tenant=tenant).set(rps, now=now)

    def tenants(self) -> List[str]:
        return sorted(set(self._outcomes) | set(self._latencies))

    def summary(self, span_s: Optional[float] = None) -> Dict[str, Dict]:
        """Exact per-tenant aggregates (plain JSON).  With ``span_s`` the
        per-tenant goodput gauges are also refreshed from it."""
        doc = {}
        for tenant in self.tenants():
            counts = self._outcomes[tenant]
            lats = self._latencies[tenant]
            ok = self._slo_ok[tenant]
            row = {
                "served": counts["served"],
                "degraded": counts["degraded"],
                "shed": counts["shed"],
                "throttled": counts["throttled"],
                "slo_ok": ok,
                "latency_p50_ms": (_pctl([l * 1e3 for l in lats], 50)
                                   if lats else 0.0),
                "latency_p99_ms": (_pctl([l * 1e3 for l in lats], 99)
                                   if lats else 0.0),
            }
            if span_s is not None and span_s > 0:
                row["goodput_rps"] = ok / span_s
                self.goodput(tenant, row["goodput_rps"])
            doc[tenant] = row
        return doc
