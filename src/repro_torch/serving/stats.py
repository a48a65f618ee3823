"""Serving telemetry (port of ``repro.serving.stats``): per-request
latency, queue depth, padding waste, throughput -- plus predicted-vs-measured
hooks into the analytical fabric model (``core.memory_model``), so measured
service latency can be compared against what a MANOJAVAM(T, S) fabric would
promise for the same request stream (the paper's Sec. VII-A simulator, fed
by live traffic).  Pure Python over numpy: a copy of the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import memory_model


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    rid: int
    op: str                    # "eigh" | "svd" | "pca"
    shape: Tuple[int, ...]     # true shape
    bucket: Tuple[int, ...]    # padded shape
    batch_size: int            # device batch it rode in
    cache_hit: bool            # executable cache hit at flush time
    t_submit: float
    t_done: float              # retirement time (results on host)
    queue_s: float             # time spent waiting before the dispatch
    padding_waste: float       # 1 - true_area / bucket_area
    backend: Optional[str] = None  # kernel backend the bucket routed to
                                   # (None = plain torch.matmul datapath);
                                   # always a concrete name, never "auto"
    n_shards: int = 1          # data-axis shards the flush spread over
                               # (1 = single-device LocalExecutor)
    t_dispatch: float = 0.0    # when the flush launched (non-blocking)
    inflight_depth: int = 1    # outstanding flushes right after dispatch
                               # (1 = synchronous engine)
    deadline: float = float("inf")  # flush-by time (submit + max_delay);
                                    # inf = no deadline was tracked
    sweeps: Optional[int] = None    # Jacobi sweeps the request ran with
                                    # (None = pre-degrade-path record)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def deadline_missed(self) -> bool:
        """Fulfilled after its flush deadline had already passed."""
        return self.t_done > self.deadline

    @property
    def inflight_s(self) -> float:
        """Dispatch-to-retire span (device execution + pipeline residency)."""
        return self.t_done - self.t_dispatch


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    """Per-flush pipeline accounting (the dispatch/retire split).

    ``t_dispatch`` is when the dispatch stage began (pre-stack),
    ``t_launched`` when the non-blocking launch returned (host free again),
    ``t_wait`` when the engine finally blocked on the flush, ``t_retire``
    when its results were on host.  Of the in-flight window
    [t_launched, t_retire], the part up to ``t_wait`` is device execution
    the host *overlapped* with other work (batching or retiring
    neighbours) and the rest is the un-hidden remainder; the flush's own
    dispatch-stage host cost (``dispatch_s``) precedes the window.  A
    synchronous engine (max_inflight=1) blocks immediately after
    launching, so overlap_s ~ 0; a deep pipeline pushes overlap_frac
    toward 1 -- that is the measured host/device overlap the benchmark
    reports.
    """
    t_dispatch: float
    t_launched: float
    t_wait: float
    t_retire: float
    batch_size: int
    cache_hit: bool
    inflight_depth: int        # outstanding flushes right after dispatch
    op: str = ""               # which solver the flush ran
    bucket: Tuple[int, ...] = ()   # the flush's shape bucket
    padded_batch: int = 0      # device batch after padding/rounding (the
                               # slab the executable actually consumed;
                               # padded_batch - batch_size is inert filler)

    @property
    def dispatch_s(self) -> float:
        """Host cost of the dispatch stage (stack/pad/cache-lookup/launch)."""
        return self.t_launched - self.t_dispatch

    @property
    def overlap_s(self) -> float:
        return self.t_wait - self.t_launched

    @property
    def wait_s(self) -> float:
        return self.t_retire - self.t_wait


def percentile(xs: Sequence[float], p: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), p))


class ServingStats:
    """Accumulates serving telemetry; cheap to record, summarised on demand.

    Per-request histories are bounded ring buffers (``max_records``) so a
    long-running server's telemetry stays O(1) in traffic volume; counters
    (flushes, cache hits) are lifetime totals.
    """

    def __init__(self, clock=time.monotonic, max_records: int = 65536):
        self.clock = clock
        self.records: Deque[RequestRecord] = collections.deque(
            maxlen=max_records)
        self.queue_depths: Deque[Tuple[float, int]] = collections.deque(
            maxlen=max_records)
        self.inflight_depths: Deque[Tuple[float, int]] = collections.deque(
            maxlen=max_records)
        self.flush_records: Deque[FlushRecord] = collections.deque(
            maxlen=max_records)
        self.plan_switches: Deque[Dict] = collections.deque(
            maxlen=max_records)
        self.flushes = 0
        self.cache_hits = 0
        self.cache_misses = 0

    # -- recording ----------------------------------------------------------
    def record_request(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def record_queue_depth(self, depth: int, now: Optional[float] = None) -> None:
        self.queue_depths.append((self.clock() if now is None else now, depth))

    def record_dispatch(self, depth: int,
                        now: Optional[float] = None) -> None:
        """In-flight depth right after a flush launched."""
        self.inflight_depths.append(
            (self.clock() if now is None else now, depth))

    def record_flush(self, cache_hit: bool, *,
                     t_dispatch: Optional[float] = None,
                     t_launched: Optional[float] = None,
                     t_wait: Optional[float] = None,
                     t_retire: Optional[float] = None,
                     batch_size: int = 0,
                     inflight_depth: int = 1,
                     op: str = "",
                     bucket: Tuple[int, ...] = (),
                     padded_batch: int = 0) -> None:
        self.flushes += 1
        if cache_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if t_dispatch is not None:
            self.flush_records.append(FlushRecord(
                t_dispatch=t_dispatch,
                t_launched=t_dispatch if t_launched is None else t_launched,
                t_wait=t_dispatch if t_wait is None else t_wait,
                t_retire=t_dispatch if t_retire is None else t_retire,
                batch_size=batch_size, cache_hit=cache_hit,
                inflight_depth=inflight_depth, op=op, bucket=tuple(bucket),
                padded_batch=padded_batch))

    def record_plan_switch(self, switch: Dict,
                           now: Optional[float] = None) -> None:
        """One ``PCAServer.apply_plan`` hot-swap (old plan, new plan,
        how many queued requests were re-bucketed)."""
        self.plan_switches.append(
            {"t": self.clock() if now is None else now, **switch})

    def reset(self) -> None:
        self.records.clear()
        self.queue_depths.clear()
        self.inflight_depths.clear()
        self.flush_records.clear()
        self.plan_switches.clear()
        self.flushes = self.cache_hits = self.cache_misses = 0

    # -- summaries ----------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        # empty percentiles are 0.0, not NaN: profile capture on an idle
        # server (serving.autotune) must produce a well-defined, JSON-clean
        # summary, and NaN would poison every downstream aggregate
        def pct(xs, p):
            return percentile(xs, p) if len(xs) else 0.0

        lat = [r.latency_s for r in self.records]
        if self.records:
            span = (max(r.t_done for r in self.records)
                    - min(r.t_submit for r in self.records))
        else:
            span = 0.0
        depths = [d for _, d in self.queue_depths]
        inflight = [d for _, d in self.inflight_depths]
        # measured host/device overlap: of every flush's in-flight window
        # (launch-to-retire; the flush's own dispatch-stage host cost
        # precedes the launch and is excluded), how much did the host
        # spend doing other work (batching / retiring neighbours) rather
        # than blocked waiting
        overlap_s = float(sum(f.overlap_s for f in self.flush_records))
        span_s = overlap_s + float(sum(f.wait_s for f in self.flush_records))
        deadline_misses = sum(1 for r in self.records if r.deadline_missed)
        return {
            "requests": len(self.records),
            "wall_s": span,
            "requests_per_s": len(self.records) / span if span > 0 else 0.0,
            "latency_p50_ms": pct(lat, 50) * 1e3,
            "latency_p99_ms": pct(lat, 99) * 1e3,
            "queue_p50_ms": pct(
                [r.queue_s for r in self.records], 50) * 1e3,
            "mean_batch": (float(np.mean([r.batch_size for r in self.records]))
                           if self.records else 0.0),
            "mean_padding_waste": (
                float(np.mean([r.padding_waste for r in self.records]))
                if self.records else 0.0),
            "max_queue_depth": max(depths) if depths else 0,
            "mean_shards": (float(np.mean([r.n_shards for r in self.records]))
                            if self.records else 0.0),
            "max_shards": (max(r.n_shards for r in self.records)
                           if self.records else 0),
            "flushes": self.flushes,
            "cache_hit_rate": (self.cache_hits / self.flushes
                               if self.flushes else 0.0),
            "mean_inflight_depth": (float(np.mean(inflight))
                                    if inflight else 0.0),
            "max_inflight_depth": max(inflight) if inflight else 0,
            "overlap_frac": (overlap_s / span_s if span_s > 0 else 0.0),
            "overlap_s": overlap_s,
            "plan_switches": len(self.plan_switches),
            "deadline_miss_count": deadline_misses,
            "deadline_miss_frac": (deadline_misses / len(self.records)
                                   if self.records else 0.0),
        }

    # -- fabric-model hooks -------------------------------------------------
    @staticmethod
    def predicted_seconds(op: str, shape: Tuple[int, ...],
                          fabric: memory_model.FabricConfig =
                          memory_model.VIRTEX_US) -> float:
        """What the analytical MANOJAVAM(T, S) model promises per request."""
        f = fabric.freq_mhz * 1e6
        if op == "eigh":
            return memory_model.jacobi_cycles(shape[0], fabric) / f
        m, n = shape[0], shape[1]
        est = memory_model.pca_seconds(m, n, fabric,
                                       include_projection=(op == "pca"))
        return est["total_s"] if op == "pca" else est["covariance_s"] + est["svd_s"]

    def predicted_vs_measured(self, fabric: memory_model.FabricConfig =
                              memory_model.VIRTEX_US) -> List[Dict[str, float]]:
        """Per-request (predicted fabric latency, measured service latency).

        The measured number includes queueing + batching + dispatch; the
        predicted number is pure fabric compute -- the gap is the serving
        overhead the engine exists to amortise.
        """
        out = []
        for r in self.records:
            pred = self.predicted_seconds(r.op, r.shape, fabric)
            out.append({
                "rid": r.rid,
                "op": r.op,
                "predicted_s": pred,
                "measured_s": r.latency_s,
                "ratio": r.latency_s / pred if pred > 0 else float("inf"),
            })
        return out
