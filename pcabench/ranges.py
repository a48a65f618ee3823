"""The program's own profiler ranges in a traced run: ``repro.*``
(``repro_torch.obs.tracing.stage``), recorded among the host events on
the device trace's clock.  A program without them gives no range, and
each reading here is then None.

A flush's launch range is named
``repro.launch:<op>:<bucket>:<live>/<padded>:n<width>:s<sweeps>:<kernel>``
(``serving/sharded.py`` ``launch_name``): the kernel is ``smem``, ``grid``
or ``none``, as the sweep op's own plan picks it.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

from pcabench import counts

LAUNCH = "repro.launch:"


class Launch(NamedTuple):
    op: str
    bucket: str
    live: int
    padded: int
    n: int
    sweeps: int
    kernel: str


def parse(name: str) -> Launch:
    """The fields of a launch range's name."""
    _, op, bucket, batch, n, sweeps, kernel = name.split(":")
    live, padded = batch.split("/")
    return Launch(op, bucket, int(live), int(padded), int(n[1:]),
                  int(sweeps[1:]), kernel)


def in_window(trace, name: str, prefix: bool = False) -> List:
    """The host events named ``name`` (or, with ``prefix``, starting with
    it) that start inside the window."""
    lo, hi = trace.window or (float("-inf"), float("inf"))
    return [e for e in trace.host if lo <= e.start < hi and (
        e.name.startswith(name) if prefix else e.name == name)]


def mean_ms(trace, name: str, prefix: bool = False) -> Optional[float]:
    """Mean length in ms of the ranges ``in_window`` finds, or None."""
    ranges = in_window(trace, name, prefix)
    if not ranges:
        return None
    return 1e3 * sum(e.seconds for e in ranges) / len(ranges)


def sweep_bound_s(launch: Launch) -> float:
    """The bound of one sweep of a launch: its padded problems' operations
    at the fp32 rate, or their bytes at the HBM rate where that is
    longer."""
    b, n = launch.padded, launch.n
    return counts.bound_s(b * counts.sweep_flops(n),
                          b * counts.sweep_bytes(n), counts.PEAK_FP32)


def sweep_roofline(trace, kernel: str, name: str) -> Optional[float]:
    """100 x the mean bound of a sweep over the window's launch ranges of
    ``kernel`` ("smem" or "grid"), weighted by their sweeps, over the mean
    device time of the kernel ``name``'s launches in the window; None
    without either."""
    launches = [launch for launch in (
        parse(e.name) for e in in_window(trace, LAUNCH, prefix=True))
        if launch.kernel == kernel]
    sweeps = trace.in_window(name)
    if not launches or not sweeps:
        return None
    weight = sum(launch.sweeps for launch in launches)
    bound = sum(launch.sweeps * sweep_bound_s(launch)
                for launch in launches) / weight
    mean = sum(e.seconds for e in sweeps) / len(sweeps)
    return 100.0 * bound / mean
