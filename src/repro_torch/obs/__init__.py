"""repro_torch.obs -- observability for the serving pipeline (port of
``repro.obs``).

The paper co-designs its MM and SVD stages around *measured per-stage*
latency and energy; this package gives the software serving stack the same
per-stage eyes on live traffic, as three small, composable pieces:

  ``tracing``   span-based tracing of the request/flush/control lifecycle
                into a bounded ring, exportable as Chrome trace-event JSON
                (``chrome://tracing`` / Perfetto-loadable), with
                parent/child links tying each request to the flush that
                retired it.
  ``metrics``   a process-local registry of counters / gauges /
                fixed-bucket histograms with labeled series, windowed
                snapshots, and Prometheus-text + JSON export.
  ``slo``       deadline-miss counting and goodput-under-SLO
                (SLO-compliant requests/s) from the same per-request data.

``Observability`` bundles one of each behind a single object the serving
engine threads through its stages: ``PCAServer(obs=Observability.enabled(
slo_ms=50))``.  The default (``obs=None``) keeps the engine on an
uninstrumented fast path -- one attribute check per stage.  All three
pieces take the same injectable clock so spans, metric windows and SLO
accounting line up with the server's own telemetry, including under a
manual test clock.
``tracing.device_profile`` wraps ``torch.profiler`` (the reference's wraps
``jax.profiler``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, Optional

from .metrics import (DEFAULT_BUCKETS, Counter, Family, Gauge, Histogram,
                      MetricRegistry, fmt_label, histogram_quantile)
from .slo import SLORecord, SLOTracker, from_records as slo_from_records
from .tenants import OUTCOMES as TENANT_OUTCOMES, TenantAccounting
from .tracing import Span, Tracer, device_profile, validate_trace


def backend_resolution_collector(registry: MetricRegistry) -> None:
    """Mirror the kernel backend registry's per-(op, backend) resolution
    counts into ``kernel_backend_resolutions_total`` at export time."""
    from ..backends import registry as kernel_registry
    fam = registry.counter(
        "kernel_backend_resolutions_total",
        "Kernel-op backend resolutions by (op, backend).",
        ("op", "backend"))
    for (op, backend), n in sorted(
            kernel_registry.resolution_counts().items()):
        fam.labels(op=op, backend=backend).set_total(n)


@dataclasses.dataclass
class Observability:
    """One tracer + one metric registry + (optionally) one SLO tracker.

    Build with ``Observability.enabled(...)``; pass to
    ``PCAServer(obs=...)`` and/or use standalone.  ``clock`` is the shared
    timestamp source -- give the server the same one.
    """
    tracer: Tracer
    metrics: MetricRegistry
    slo: Optional[SLOTracker] = None
    clock: "callable" = time.monotonic

    @classmethod
    def enabled(cls, slo_ms: Optional[float] = None,
                clock=time.monotonic, trace_capacity: int = 65536,
                window_capacity: int = 8192) -> "Observability":
        """An armed observability bundle (the CLI's ``--trace-out`` /
        ``--metrics-out`` / ``--slo-ms`` path).  The kernel backend
        resolution counters are wired in as an export-time collector."""
        metrics = MetricRegistry(clock=clock,
                                 window_capacity=window_capacity)
        metrics.register_collector(backend_resolution_collector)
        slo = (SLOTracker(slo_s=slo_ms / 1e3, registry=metrics, clock=clock)
               if slo_ms is not None
               else SLOTracker(slo_s=None, registry=metrics, clock=clock))
        return cls(tracer=Tracer(capacity=trace_capacity, clock=clock),
                   metrics=metrics, slo=slo, clock=clock)

    # -- exports ------------------------------------------------------------
    def trace_doc(self, process_name: str = "repro_torch.serving") -> Dict:
        return self.tracer.export(process_name)

    def save_trace(self, path) -> pathlib.Path:
        """Validate against the Chrome trace schema, then write."""
        return self.tracer.save(path)

    def prometheus_text(self) -> str:
        return self.metrics.to_prometheus()

    def save_metrics(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(self.prometheus_text())
        return path

    def summary(self, window_s: Optional[float] = None) -> Dict:
        """Compact JSON-able status: span/series counts + SLO accounting."""
        doc = {
            "spans": len(self.tracer),
            "spans_dropped": self.tracer.dropped,
            "metric_series": sum(len(f._children)
                                 for f in self.metrics.families()),
        }
        if self.slo is not None:
            doc["slo"] = self.slo.summary(window_s=window_s)
        return doc

    def save_summary(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.summary(), indent=2, sort_keys=True)
                        + "\n")
        return path


__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Family", "Gauge", "Histogram",
    "MetricRegistry", "Observability", "SLORecord", "SLOTracker", "Span",
    "TENANT_OUTCOMES", "TenantAccounting",
    "Tracer", "backend_resolution_collector", "device_profile", "fmt_label",
    "histogram_quantile", "slo_from_records", "validate_trace",
]
