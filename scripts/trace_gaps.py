#!/usr/bin/env python
"""Run one cell of the benchmark traced, as ``pcabench/run.py --trace 1``
does, and put each of its longest idle gaps on the card down to the host
ranges open when it opened:

    python scripts/trace_gaps.py --workload serve.small --seed 7 \\
        [--seconds 51] [--top 10]

Prints the card on stderr, then one JSON line: the cell's per-layer
metrics, each ``repro.*`` range name the window holds with its count and
total seconds, and the longest gaps, each with its start in the window,
its length, every host event open at its start, outermost first (the
benchmark's spans, the program's ranges, torch's ops), and the ranges
that overlap it, by the seconds of the overlap.  Nothing is judged:
the run is for reading, not for the benchmark's numbers.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from pcabench import harness, tracing  # noqa: E402


def gaps(trace, top: int):
    """The ``top`` longest idle intervals of the window, longest first."""
    lo, hi = trace.window
    busy = tracing.merged([(e.start, e.end) for e in trace.device], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    out = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
           if edges[i + 1] > edges[i]]
    return sorted(out, key=lambda g: g[0] - g[1])[:top]


def open_at(trace, t: float):
    """Names of the host events running at ``t``, outermost first."""
    running = [e for e in trace.host
               if e.start <= t < e.end and e.name != tracing.WINDOW]
    return [e.name for e in sorted(running, key=lambda e: e.start)]


def during(trace, s: float, e: float, top: int = 8):
    """The ranges (``repro.*``, ``pcabench.*``) that overlap [s, e), with
    the seconds of the overlap, most first."""
    out = {}
    for ev in trace.host:
        if ev.name.startswith(("repro.", "pcabench.")) \
                and ev.name != tracing.WINDOW:
            o = min(ev.end, e) - max(ev.start, s)
            if o > 0:
                out[ev.name] = out.get(ev.name, 0.0) + o
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def ranges(trace):
    """{repro.* name: [count, total seconds]} over the window."""
    lo, hi = trace.window
    out = {}
    for e in trace.host:
        if e.name.startswith("repro.") and lo <= e.start < hi:
            n = out.setdefault(e.name, [0, 0.0])
            n[0] += 1
            n[1] += e.seconds
    return dict(sorted(out.items()))


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, args.workload, args.seed)
    cell.device = harness.look_for_card(cell)
    print(f"card: {harness.card()}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = harness.load_module("drivers", cell.traffic["driver"])
    state = driver.prepare(cell)
    with tracing.Recorder(True) as rec:
        measured = driver.measure(cell, state, args.seconds, rec)
    t0 = time.perf_counter()
    trace = rec.trace()
    view = harness.View(cell, measured, trace)
    metrics = {m["name"]: harness.load_module("metrics", m["name"]).read(
        view) for m in cell.per_layer}
    lo = trace.window[0]
    doc = {"workload": cell.name, "seed": cell.seed,
           "window_s": trace.window_s, "busy_s": trace.busy_s(),
           "metrics": metrics, "ranges": ranges(trace),
           "gaps": [{"at_s": s - lo, "seconds": e - s,
                     "open": open_at(trace, s),
                     "during": during(trace, s, e)}
                    for s, e in gaps(trace, args.top)],
           "reduce_s": time.perf_counter() - t0}
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
