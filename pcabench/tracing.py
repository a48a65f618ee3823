"""The traced run's recorder: ``torch.profiler`` over the window, spans
around the benchmark's calls into each layer of the program, and the
reduction of the trace to device intervals, the idle share and the
breakdown.

The spans are the benchmark's own (``record_function`` ranges in the
drivers), recorded where the benchmark calls the program; the program
records none of its own for these metrics.  With tracing off, ``span`` is a
no-op and no profiler runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "pcabench.window"   # the span around the measured window
TOP = 10                     # entries of each breakdown list
ANON = "(anonymous namespace)::"
# the program's launch counters (``repro_torch.kernels.launch_counts``) and
# the kernel each counts, as the trace names it
PROGRAM_KERNELS = {"covariance": "gram_kernel",
                   "jacobi_sweep": "sweep_grid_kernel",
                   "jacobi_sweep_smem": "sweep_smem_kernel",
                   "mm_engine_matmul": "mm_kernel"}


def union_length(intervals: Sequence[Tuple[float, float]],
                 lo: float = float("-inf"), hi: float = float("inf")
                 ) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi]:
    overlapping kernels and copies count once."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def merged(intervals: Sequence[Tuple[float, float]],
           lo: float = float("-inf"), hi: float = float("inf")
           ) -> List[Tuple[float, float]]:
    """The union of the intervals, clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Event:
    name: str
    start: float   # seconds, on the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    """What the profiler held: device operations (kernels, copies, sets),
    host events (the spans and the aten ops) and the window's span."""
    device: List[Event]
    host: List[Event]
    window: Optional[Tuple[float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def in_window(self, kernel: str) -> List[Event]:
        """Launches of the program's kernel ``kernel`` (``is_kernel``) that
        start inside the window."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        return [e for e in self.device
                if lo <= e.start < hi and is_kernel(e.name, kernel)]

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_length([(e.start, e.end) for e in self.device], lo, hi)

    def breakdown(self) -> Dict[str, List]:
        """The device operations that took most time in the window, and the
        longest idle gaps, each named by the innermost host event running
        when the gap opened (the benchmark's span, then the op)."""
        lo, hi = self.window
        by_name: Dict[str, float] = {}
        for e in self.device:
            s, t = max(e.start, lo), min(e.end, hi)
            if t > s:
                key = short(e.name)
                by_name[key] = by_name.get(key, 0.0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = merged([(e.start, e.end) for e in self.device], lo, hi)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at(s), e - s]
                              for s, e in gaps[:TOP]]}

    def host_at(self, t: float) -> str:
        """'span > op': the innermost benchmark span and the innermost host
        op running at ``t``."""
        spans = [e for e in self.host if e.start <= t < e.end]
        ours = [e for e in spans if e.name.startswith("pcabench.")
                and e.name != WINDOW]
        ops = [e for e in spans if not e.name.startswith("pcabench.")]
        span = max(ours, key=lambda e: e.start).name if ours else "window"
        op = max(ops, key=lambda e: e.start).name if ops else "python"
        return f"{span} > {short(op)}"

    def launches(self) -> Dict[str, int]:
        """{counter: launches in the window of the kernel it counts}"""
        return {k: len(self.in_window(n)) for k, n in PROGRAM_KERNELS.items()}


def _base(name: str) -> str:
    """A demangled name without "void ", an anonymous namespace or its
    argument list: "(anonymous namespace)::gram_kernel<float, ...>"."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace(ANON, "").split("(", 1)[0]


def is_kernel(name: str, kernel: str) -> bool:
    """Whether the demangled ``name`` is the port's ``kernel``, any template
    instance of it included, and not a library's kernel of the same last
    name (``at::native::reduce_kernel``)."""
    return _base(name).split("<", 1)[0] == kernel


def short(name: str, width: int = 96) -> str:
    """A kernel's or op's name without its argument list, cut to
    ``width``."""
    return _base(name)[:width]


class Recorder:
    """``with Recorder(on) as rec:`` profiles the block when ``on``; then
    ``rec.trace()`` gives the ``Trace``.  ``rec.span(name)`` marks a range
    on the host (a no-op with tracing off)."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def trace(self) -> Trace:
        events = self._prof.profiler.kineto_results.events()
        device, host, window = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            start, dur = _ns(e)
            ev = Event(e.name(), start, start + dur)
            if e.device_type() == cuda:
                # a span's range as the profiler mirrors it on the device's
                # timeline is no operation of the device
                if not (ev.name.startswith("pcabench.")
                        or getattr(e, "is_user_annotation", bool)()):
                    device.append(ev)
            else:
                host.append(ev)
                if ev.name == WINDOW:
                    window = (ev.start, ev.end)
        return Trace(device, host, window)


def _ns(e) -> Tuple[float, float]:
    """(start, duration) of a kineto event in seconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    return e.start_us() * 1e-6, e.duration_us() * 1e-6
