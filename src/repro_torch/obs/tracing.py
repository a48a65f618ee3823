"""Span tracing for the serving pipeline, exportable as Chrome trace JSON.

The paper's evaluation stands on *stage-timed* breakdowns (per-unit cycle
counts from the fabric model, per-stage wall time in the benchmarks); the
serving stack needs the same per-stage visibility on live traffic.  This
module records one span per pipeline stage into a bounded ring buffer:

  request   submit -> fulfil, with a "queued" child covering the
            pre-dispatch wait; linked (``parent``) to the flush span
            that retired it.
  flush     dispatch -> retire-complete, with "dispatch" (stack / pad /
            cache-lookup / launch), "inflight" (launched, host free),
            "wait" (blocked on the device) and "retire" (gather / unpack /
            fulfil) children.  On a cache miss the executable build gets
            its own "compile" child; the kernels themselves build once
            a process, at their first launch, so that cost lands in the
            dispatch span of the flush that first launches them.
  control   plan swaps (``PCAServer.apply_plan``) and autotune searches.

Recording is O(1) per span (an append into a ``deque(maxlen=...)``); a
long-running server's trace is the *most recent* window, never unbounded.
``Tracer(enabled=False)`` turns every call into a cheap no-op, and the
serving engine skips instrumentation entirely when no observability object
is attached -- the disabled fast path costs one attribute check.

``export()`` emits the Chrome trace-event format (the JSON
``chrome://tracing`` and https://ui.perfetto.dev load directly): complete
``"X"`` events with microsecond timestamps, plus ``"M"`` metadata events
naming the tracks.  Overlapping root spans of one track are fanned out
across sub-lanes at export time so concurrent requests/flushes render as
parallel rows instead of a false flame stack; children stay on their
parent's lane so each span nests under its parent.  ``validate_trace``
checks the schema contract the selftest and CI enforce: required keys,
non-decreasing ``ts``, non-negative ``dur``, matched B/E stacks, and
parent links that reference real spans and end inside their parent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import pathlib
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# export-time comparison slack for float timestamps (seconds)
_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span (recorded at end time; clock units = seconds)."""
    id: int
    name: str
    cat: str
    track: str
    ts: float                  # start, on the tracer's clock
    dur: float
    parent: Optional[int] = None
    args: Tuple[Tuple[str, object], ...] = ()

    @property
    def end(self) -> float:
        return self.ts + self.dur


class _SpanHandle:
    """An open span: ``end()`` records it (usable as a context manager)."""

    __slots__ = ("_tracer", "id", "name", "cat", "track", "parent",
                 "ts", "_args", "_open")

    def __init__(self, tracer: "Tracer", id: int, name: str, cat: str,
                 track: str, parent: Optional[int], ts: float, args: Dict):
        self._tracer = tracer
        self.id = id
        self.name = name
        self.cat = cat
        self.track = track
        self.parent = parent
        self.ts = ts
        self._args = args
        self._open = True

    def end(self, ts: Optional[float] = None, **args) -> Optional[Span]:
        if not self._open:
            return None
        self._open = False
        if args:
            self._args.update(args)
        ts = self._tracer.clock() if ts is None else ts
        return self._tracer.complete(
            self.name, ts=self.ts, end=max(ts, self.ts), cat=self.cat,
            track=self.track, parent=self.parent, id=self.id, **self._args)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullHandle:
    """Shared no-op handle returned by a disabled tracer."""

    __slots__ = ()
    id = None

    def end(self, ts=None, **args) -> None:
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_HANDLE = _NullHandle()


class Tracer:
    """Bounded ring buffer of pipeline spans.

    Args:
      capacity: ring size; the oldest spans fall off under sustained load
        so a long-running server holds the most recent window.
      clock: monotonic seconds source (tests inject a manual clock -- use
        the same one the server runs on so span timestamps line up with
        its telemetry).
      enabled: ``False`` turns every recording call into a no-op; flip
        ``tracer.enabled`` at runtime to pause/resume capture.
    """

    def __init__(self, capacity: int = 65536, clock=time.monotonic,
                 enabled: bool = True):
        self.capacity = capacity
        self.clock = clock
        self.enabled = enabled
        self.spans: Deque[Span] = deque(maxlen=capacity)
        self.dropped = 0           # spans the ring displaced
        self._ids = itertools.count(1)

    def __len__(self) -> int:
        return len(self.spans)

    def new_id(self) -> int:
        """Reserve a span id before the span is recorded (so children can
        name their parent while it is still open)."""
        return next(self._ids)

    def begin(self, name: str, cat: str = "serving", track: str = "serving",
              parent: Optional[int] = None, ts: Optional[float] = None,
              **args):
        """Open a span; ``.end()`` (or context-manager exit) records it."""
        if not self.enabled:
            return _NULL_HANDLE
        return _SpanHandle(self, self.new_id(), name, cat, track, parent,
                           self.clock() if ts is None else ts, args)

    def complete(self, name: str, ts: float, end: float,
                 cat: str = "serving", track: str = "serving",
                 parent: Optional[int] = None, id: Optional[int] = None,
                 **args) -> Optional[Span]:
        """Record an already-finished span from explicit timestamps (the
        engine samples its own clock at stage boundaries; spans reuse those
        samples instead of re-reading the clock)."""
        if not self.enabled:
            return None
        if len(self.spans) == self.capacity:
            self.dropped += 1
        span = Span(id=self.new_id() if id is None else id, name=name,
                    cat=cat, track=track, ts=ts, dur=max(end - ts, 0.0),
                    parent=parent,
                    args=tuple(sorted(args.items())) if args else ())
        self.spans.append(span)
        return span

    def instant(self, name: str, cat: str = "serving",
                track: str = "serving", ts: Optional[float] = None,
                **args) -> Optional[Span]:
        """A zero-duration marker (plan swap, admission decision, ...)."""
        t = self.clock() if ts is None else ts
        return self.complete(name, ts=t, end=t, cat=cat, track=track, **args)

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0

    # -- export -------------------------------------------------------------
    def export(self, process_name: str = "repro_torch.serving") -> Dict:
        """The ring's spans as a Chrome trace-event JSON document."""
        # ties broken by id: a parent reserves its id before its children
        # record (new_id), so on a frozen test clock -- every ts equal --
        # parents still lane-assign before the children that ride them
        spans = sorted(self.spans, key=lambda s: (s.ts, -s.dur, s.id))
        by_id = {s.id: s for s in spans}
        t0 = min((s.ts for s in spans), default=0.0)

        # lane allocation: root spans of one track fan out over sub-lanes
        # so concurrent spans render side by side; children ride their
        # parent's lane so every span nests under its parent
        tracks = sorted({s.track for s in spans})
        lane_of: Dict[int, Tuple[str, int]] = {}
        lanes_per_track: Dict[str, List[float]] = {t: [] for t in tracks}
        for s in spans:
            parent = by_id.get(s.parent) if s.parent is not None else None
            if (parent is not None and parent.track == s.track
                    and parent.id in lane_of):
                lane_of[s.id] = lane_of[parent.id]
                continue
            busy = lanes_per_track[s.track]
            for i, busy_until in enumerate(busy):
                if busy_until <= s.ts + _EPS:
                    busy[i] = s.end
                    lane_of[s.id] = (s.track, i)
                    break
            else:
                busy.append(s.end)
                lane_of[s.id] = (s.track, len(busy) - 1)

        tid_of: Dict[Tuple[str, int], int] = {}
        events: List[Dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0, "ts": 0,
            "args": {"name": process_name},
        }]
        for track in tracks:
            for lane in range(len(lanes_per_track[track])):
                tid = len(tid_of) + 1
                tid_of[(track, lane)] = tid
                events.append({
                    "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                    "ts": 0,
                    "args": {"name": track if lane == 0
                             else f"{track} ~{lane + 1}"},
                })
        for s in spans:
            args = dict(s.args)
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X", "pid": 0,
                "tid": tid_of[lane_of[s.id]],
                "ts": round((s.ts - t0) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "id": s.id,
                "args": args,
            })
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"spans": len(spans), "dropped": self.dropped,
                          "clock_origin_s": t0},
        }

    def save(self, path,
             process_name: str = "repro_torch.serving") -> pathlib.Path:
        """Validate, then write the trace JSON (Perfetto-loadable)."""
        doc = self.export(process_name)
        errors = validate_trace(doc)
        if errors:
            raise ValueError(f"trace failed schema validation: {errors[:5]}")
        path = pathlib.Path(path)
        path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        return path


def validate_trace(doc: Dict) -> List[str]:
    """Chrome trace-event schema check; returns a list of violations.

    The contract CI enforces on every exported trace: the document holds a
    non-empty ``traceEvents`` list; every event carries name / ph / ts /
    pid / tid; ``ts`` is non-decreasing in document order; ``"X"`` events
    carry a non-negative ``dur``; ``"B"``/``"E"`` events match per
    (pid, tid) stack; a span's ``args.parent`` references a real span id
    whose interval contains the child's end (same-track parents must
    contain the child's start too -- cross-track links, e.g. request ->
    retiring flush, legitimately start before their parent).
    """
    errors: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    last_ts = None
    stacks: Dict[Tuple, List[str]] = {}
    xspans: Dict[int, Dict] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i} ({ev.get('name')!r}): missing "
                              f"required key {key!r}")
        ph = ev.get("ph")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: ts must be a non-negative number, "
                          f"got {ts!r}")
            continue
        if ph != "M":               # metadata events sit outside the timeline
            if last_ts is not None and ts < last_ts - 1e-6:
                errors.append(f"event {i}: ts {ts} < previous {last_ts} "
                              f"(must be non-decreasing)")
            last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev.get('name')!r}): X event "
                              f"needs a non-negative dur, got {dur!r}")
            elif isinstance(ev.get("id"), int):
                xspans[ev["id"]] = ev
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                errors.append(f"event {i}: E without matching B on tid "
                              f"{ev.get('tid')}")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(f"unmatched B events on (pid, tid) {key}: {stack}")
    for sid, ev in xspans.items():
        parent_id = (ev.get("args") or {}).get("parent")
        if parent_id is None:
            continue
        parent = xspans.get(parent_id)
        if parent is None:
            errors.append(f"span {sid} ({ev['name']!r}): parent "
                          f"{parent_id} not in trace")
            continue
        end, pend = ev["ts"] + ev["dur"], parent["ts"] + parent["dur"]
        if end > pend + 1.0:       # 1 us slack on rounded timestamps
            errors.append(f"span {sid} ({ev['name']!r}): ends at {end} "
                          f"after its parent {parent_id} at {pend}")
        if parent["tid"] == ev["tid"] and ev["ts"] < parent["ts"] - 1.0:
            errors.append(f"span {sid} ({ev['name']!r}): starts before "
                          f"its same-track parent {parent_id}")
    return errors


@contextlib.contextmanager
def device_profile(logdir: Optional[str] = None):
    """Optional ``torch.profiler`` run around a traced serve run.

    With a log directory, profiles the CPU and, where a card is present,
    the CUDA activity (the hand-written kernels' launches and device
    times), and on exit writes one Chrome trace (``*.pt.trace.json``,
    Perfetto-loadable) into ``logdir``, next to the host-side span trace.
    A ``None``/empty logdir is a no-op, so callers can wrap
    unconditionally.  A profiler that fails to start raises: nothing
    drops the device picture quietly.
    """
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"device_profile.{time.time_ns()}.pt.trace.json"))
