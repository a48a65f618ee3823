"""Process-local metric registry: counters, gauges, fixed-bucket histograms.

The serving pipeline's quantitative telemetry, in the Prometheus data
model: a ``MetricRegistry`` holds metric *families* (one name + label
schema each); a family holds one child series per label-value tuple (the
serving layer keys latency histograms by ``(op, bucket, backend,
executor)``).  Recording is a dict lookup plus an integer/float update --
cheap enough to sit on the flush hot path -- and every child additionally
keeps a bounded deque of ``(t, value)`` events so ``snapshot(window_s=...)``
can answer *windowed* questions (recent rate, recent p99) for the
sliding-window re-profiling controller (``serving.controller``) without a
second collection system.

Exports:

  ``to_prometheus()``  the text exposition format (``# HELP``/``# TYPE``,
                       ``_bucket``/``_sum``/``_count`` histogram series
                       with cumulative ``le`` buckets) -- scrapeable as-is.
  ``to_json()``        the same content as a plain dict.
  ``snapshot(...)``    per-series aggregates over a trailing window
                       (rates, histogram percentiles), or lifetime totals
                       when no window is given.

Histogram percentiles are bucket-interpolated (the PromQL
``histogram_quantile`` rule): exact to within one bucket width, constant
memory, and identical math for lifetime and windowed readouts.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

# latency-flavoured default buckets (seconds): 50us .. 30s
DEFAULT_BUCKETS: Tuple[float, ...] = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0)


def fmt_label(v) -> str:
    """Canonical label-value spelling: tuples (shape buckets) join with
    'x', None means the plain ``torch.matmul`` datapath (the reference
    spells it "xla"), everything else is str()."""
    if v is None:
        return "plain"
    if isinstance(v, (tuple, list)):
        return "x".join(str(int(d)) for d in v)
    return str(v)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def histogram_quantile(q: float, uppers: Sequence[float],
                       counts: Sequence[int]) -> float:
    """PromQL-style bucket-interpolated quantile.

    ``counts[i]`` is the count in ``(uppers[i-1], uppers[i]]``;
    ``counts[-1]`` is the +Inf overflow bucket.  Linear interpolation
    inside the winning bucket; the overflow bucket clamps to its lower
    bound (there is no upper edge to interpolate toward).
    """
    total = sum(counts)
    if total == 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= rank and c > 0:
            lo = uppers[i - 1] if i > 0 else 0.0
            if i >= len(uppers):          # +Inf bucket
                return float(uppers[-1]) if uppers else float("nan")
            hi = uppers[i]
            return lo + (hi - lo) * (rank - cum) / c
        cum += c
    return float(uppers[-1]) if uppers else float("nan")


class _Series:
    """Shared per-child state: labels, the windowed event ring, and the
    owning registry's clock (used when an observation has no explicit
    timestamp, so injected-clock registries stamp consistently)."""

    __slots__ = ("labels", "events", "clock")

    def __init__(self, labels: Tuple[str, ...], capacity: int,
                 clock: Callable[[], float]):
        self.labels = labels
        self.events: Deque[Tuple[float, float]] = deque(maxlen=capacity)
        self.clock = clock

    def window(self, now: float,
               window_s: Optional[float]) -> List[Tuple[float, float]]:
        if window_s is None:
            return list(self.events)
        cut = now - window_s
        return [(t, v) for t, v in self.events if t >= cut]


class Counter(_Series):
    """Monotone count; ``inc`` appends the delta to the event ring so a
    windowed snapshot can report a recent rate."""

    __slots__ = ("total",)

    def __init__(self, labels, capacity, clock):
        super().__init__(labels, capacity, clock)
        self.total = 0.0

    def inc(self, v: float = 1.0, now: Optional[float] = None) -> None:
        self.total += v
        self.events.append((now if now is not None else self.clock(), v))

    def set_total(self, v: float) -> None:
        """Mirror an externally-maintained monotone count (collectors)."""
        self.total = float(v)


class Gauge(_Series):
    __slots__ = ("value",)

    def __init__(self, labels, capacity, clock):
        super().__init__(labels, capacity, clock)
        self.value = 0.0

    def set(self, v: float, now: Optional[float] = None) -> None:
        self.value = float(v)
        self.events.append(
            (now if now is not None else self.clock(), self.value))

    def inc(self, v: float = 1.0, now: Optional[float] = None) -> None:
        self.set(self.value + v, now)


class Histogram(_Series):
    """Fixed-bucket histogram with p50/p90/p99 readout.

    ``buckets`` are upper bounds; an implicit +Inf bucket catches the
    overflow.  Lifetime bucket counts serve the Prometheus export; the
    event ring re-buckets on demand for windowed percentiles.
    """

    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, labels, capacity, clock, uppers: Tuple[float, ...]):
        super().__init__(labels, capacity, clock)
        self.uppers = uppers
        self.counts = [0] * (len(uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_index(self, v: float) -> int:
        for i, hi in enumerate(self.uppers):
            if v <= hi:
                return i
        return len(self.uppers)

    def observe(self, v: float, now: Optional[float] = None) -> None:
        self.counts[self._bucket_index(v)] += 1
        self.sum += v
        self.count += 1
        self.events.append((now if now is not None else self.clock(), v))

    def percentile(self, p: float, now: Optional[float] = None,
                   window_s: Optional[float] = None) -> float:
        """p in [0, 100]; windowed when ``window_s`` is given."""
        if window_s is None:
            counts = self.counts
        else:
            counts = [0] * (len(self.uppers) + 1)
            for _, v in self.window(
                    now if now is not None else self.clock(), window_s):
                counts[self._bucket_index(v)] += 1
        return histogram_quantile(p / 100.0, self.uppers, counts)


class Family:
    """One metric name + label schema; children keyed by label values."""

    def __init__(self, registry: "MetricRegistry", name: str, help: str,
                 kind: str, labelnames: Tuple[str, ...],
                 uppers: Optional[Tuple[float, ...]] = None):
        self.registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self.uppers = uppers
        self._children: Dict[Tuple[str, ...], _Series] = {}

    def labels(self, *values, **kv):
        """The child series for one label-value tuple (created on first
        use).  Accepts positional values in schema order or keywords."""
        if kv:
            if values:
                raise TypeError("pass labels positionally or by keyword, "
                                "not both")
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(fmt_label(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{values!r}")
        child = self._children.get(key)
        if child is None:
            cap = self.registry.window_capacity
            clock = self.registry.clock
            if self.kind == "counter":
                child = Counter(key, cap, clock)
            elif self.kind == "gauge":
                child = Gauge(key, cap, clock)
            else:
                child = Histogram(key, cap, clock, self.uppers)
            self._children[key] = child
        return child

    def items(self):
        return sorted(self._children.items())

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricRegistry:
    """Process-local registry; families are idempotent by name.

    Args:
      clock: timestamp source for the windowed event rings (inject the
        server's clock so windows line up with its telemetry).
      window_capacity: per-series event-ring size; beyond it the oldest
        observations leave the *window* view (lifetime totals and bucket
        counts are unaffected).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window_capacity: int = 8192):
        self.clock = clock
        self.window_capacity = window_capacity
        self._families: Dict[str, Family] = {}
        self._collectors: List[Callable[["MetricRegistry"], None]] = []

    # -- family constructors ------------------------------------------------
    def _family(self, name: str, help: str, kind: str, labels,
                uppers=None) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                    f"{fam.labelnames}, not {kind}{tuple(labels)}")
            return fam
        fam = Family(self, name, help, kind, tuple(labels), uppers)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", labels=()) -> Family:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Family:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        uppers = tuple(sorted(float(b) for b in buckets))
        fam = self._family(name, help, "histogram", labels, uppers)
        if fam.uppers != uppers:
            raise ValueError(f"metric {name!r} already registered with "
                             f"buckets {fam.uppers}")
        return fam

    def register_collector(self, fn: Callable[["MetricRegistry"], None]):
        """``fn(registry)`` runs before every export/snapshot -- the hook
        that pulls externally-maintained counts (e.g. the kernel backend
        registry's resolution counters) into the export."""
        self._collectors.append(fn)
        return fn

    def families(self) -> List[Family]:
        return [self._families[n] for n in sorted(self._families)]

    def _collect(self) -> None:
        for fn in self._collectors:
            fn(self)

    # -- exports ------------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self._collect()
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.items():
                if fam.kind == "counter":
                    out.append(f"{fam.name}{fam._label_str(key)} "
                               f"{_num(child.total)}")
                elif fam.kind == "gauge":
                    out.append(f"{fam.name}{fam._label_str(key)} "
                               f"{_num(child.value)}")
                else:
                    cum = 0
                    for hi, c in zip(child.uppers, child.counts):
                        cum += c
                        le = 'le="%s"' % _num(hi)
                        out.append(f"{fam.name}_bucket"
                                   f"{fam._label_str(key, le)} {cum}")
                    cum += child.counts[-1]
                    le = 'le="+Inf"'
                    out.append(f"{fam.name}_bucket"
                               f"{fam._label_str(key, le)} {cum}")
                    out.append(f"{fam.name}_sum{fam._label_str(key)} "
                               f"{_num(child.sum)}")
                    out.append(f"{fam.name}_count{fam._label_str(key)} "
                               f"{cum}")
        return "\n".join(out) + "\n"

    def snapshot(self, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> Dict:
        """Per-series aggregates, windowed to the trailing ``window_s``.

        Counters report the window's delta and rate; gauges their latest
        value (and window min/max); histograms windowed count/sum/p50/p90/
        p99.  ``window_s=None`` means lifetime (rates use the span between
        the series' first and last events).  The structure is plain JSON
        for the controller loop and tests.
        """
        self._collect()
        now = self.clock() if now is None else now
        doc: Dict = {"window_s": window_s, "now": now, "series": {}}
        for fam in self.families():
            fdoc = doc["series"].setdefault(
                fam.name, {"kind": fam.kind, "labels": fam.labelnames,
                           "children": {}})
            for key, child in fam.items():
                label_str = ",".join(key) if key else ""
                events = child.window(now, window_s)
                if fam.kind == "counter":
                    delta = sum(v for _, v in events)
                    if window_s is not None:
                        rate = delta / window_s if window_s > 0 else 0.0
                    else:
                        span = (events[-1][0] - events[0][0]
                                if len(events) > 1 else 0.0)
                        rate = delta / span if span > 0 else 0.0
                    fdoc["children"][label_str] = {
                        "total": child.total, "delta": delta,
                        "rate_per_s": rate}
                elif fam.kind == "gauge":
                    vals = [v for _, v in events]
                    fdoc["children"][label_str] = {
                        "value": child.value,
                        "min": min(vals) if vals else child.value,
                        "max": max(vals) if vals else child.value}
                else:
                    vals = [v for _, v in events]
                    counts = [0] * (len(child.uppers) + 1)
                    for v in vals:
                        counts[child._bucket_index(v)] += 1
                    fdoc["children"][label_str] = {
                        "count": len(vals),
                        "sum": float(sum(vals)),
                        "p50": histogram_quantile(.50, child.uppers, counts),
                        "p90": histogram_quantile(.90, child.uppers, counts),
                        "p99": histogram_quantile(.99, child.uppers, counts),
                        "lifetime_count": child.count,
                    }
        return doc

    def series_events(self, name: str, window_s: Optional[float] = None,
                      now: Optional[float] = None
                      ) -> List[Tuple[Dict[str, str],
                                      List[Tuple[float, float]]]]:
        """Raw windowed events of one family, with *structured* labels.

        ``snapshot`` keys children by a comma-joined label string -- fine
        for JSON eyeballs, lossy for programs.  This accessor returns
        ``[(labels_dict, [(t, value), ...]), ...]`` per child so the
        sliding-window re-profiler (``TrafficProfile.from_registry``) can
        recover (op, bucket) tuples without string parsing.  Children are
        in sorted label order; an unknown family is an empty list, and an
        empty window is an empty event list per child (the child itself is
        still reported, which is what lets the re-profiler distinguish
        "series went quiet" from "series never existed").
        """
        self._collect()
        now = self.clock() if now is None else now
        fam = self._families.get(name)
        if fam is None:
            return []
        return [(dict(zip(fam.labelnames, key)), child.window(now, window_s))
                for key, child in fam.items()]

    def to_json(self) -> Dict:
        """Lifetime snapshot as a plain dict (JSON-clean: NaN-free)."""
        doc = self.snapshot(window_s=None)
        return _denan(doc)


def _num(v: float) -> str:
    """Prometheus number spelling: integers without the trailing .0."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _denan(x):
    if isinstance(x, dict):
        return {k: _denan(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_denan(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return None
    return x
