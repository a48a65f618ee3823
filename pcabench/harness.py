"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver and per-layer metrics by the names in ``BENCHMARK.json``, runs the
cell once and prints its result line.

Everything that belongs to one configuration, traffic mix, driver or
metric sits in a file of its own, found by name:

  configs/<config>.json    the configuration: sizes, solver, limits
  traffic/<mix>.json       the traffic mix: its driver and parameters
  drivers/<kind>.py        a driver: ``prepare``, ``measure``, ``release``,
                           ``judge``, ``control``
  metrics/<metric>.py      a per-layer metric: ``read(view)``

so that a cell of an existing driver needs a traffic file, perhaps a
configuration file, and its entry in ``BENCHMARK.json``, and no edit.

A run: set-up (imports, the kernel library from the checkout's ``build/``,
the inputs made on the card from ``--seed``, the warm-up of the cell's own
shapes), the measured window, then, outside the timings: the peak memory,
the check that neither JAX nor the JAX package was loaded, the trace's
reduction (``--trace 1``), the program's state freed, and the comparison
with the float64 reference that decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names
KINDS = {"configs": ".json", "traffic": ".json", "drivers": ".py",
         "metrics": ".py"}
EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


class Refused(Exception):
    """The run cannot start: no such cell or file, or no card for it."""


def find(kind: str, name: str, root: pathlib.Path = BENCH) -> pathlib.Path:
    """The file of the ``kind`` ("configs", "traffic", "drivers",
    "metrics") named ``name``."""
    path = root / kind / f"{name}{KINDS[kind]}"
    if "/" in name or not path.is_file():
        raise Refused(f"no {kind[:-1] if kind != 'traffic' else kind} "
                      f"named {name!r} (looked for {path.relative_to(root)})")
    return path


def load_json(kind: str, name: str, root: pathlib.Path = BENCH) -> Dict:
    return json.loads(find(kind, name, root).read_text())


def load_module(kind: str, name: str, root: pathlib.Path = BENCH):
    """A driver or metric module, imported from its file once a process."""
    path = find(kind, name, root)
    key = f"pcabench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[key] = module
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files, for one seed."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    seed: int
    device: Any = None     # torch.device the run uses
    stamps: List = dataclasses.field(default_factory=list)

    def stamp(self, what: str) -> None:
        """Mark the end of a step of set-up, for the log."""
        self.stamps.append((what, time.perf_counter()))


def _for_cell(metrics: List[Dict], cell: str, reported=None) -> List[Dict]:
    """The metrics that this cell reports: those that list it, or, without
    a ``workloads`` key, (end-to-end) every cell or (per-layer) every cell
    that reports the metric they move."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m["moves"] in reported:
            out.append(m)
    return out


def resolve(bench: Dict, workload: str, seed: int,
            root: pathlib.Path = BENCH) -> Cell:
    """The cell named ``workload``, its configuration and traffic files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload named {workload!r}; the benchmark has "
                      f"{sorted(cells)}")
    w = cells[workload]
    e2e = _for_cell(bench["end_to_end"], workload)
    names = {m["name"] for m in e2e}
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json("configs", w["config"], root),
                traffic=load_json("traffic", w["traffic"], root),
                end_to_end=e2e,
                per_layer=_for_cell(bench["per_layer"], workload, names),
                seed=int(seed))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def card() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


@dataclasses.dataclass
class Measured:
    """What a driver's window gave: when it opened (``perf_counter``; the
    driver marks it with ``tracing.WINDOW``), its end-to-end readings, the
    window's length, the work attempted and what never came back, the
    per-layer sources, and the answers to judge."""
    t0: float
    e2e: Dict[str, float]
    window_s: float
    attempted: int
    missing: int
    layer: Dict[str, Any]
    answers: List[Any]


@dataclasses.dataclass
class View:
    """What a per-layer metric reads: the cell, the window's per-layer
    sources and, in a traced run, the trace."""
    cell: Cell
    measured: Measured
    trace: Any = None


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float,
             driver=None) -> Dict:
    """Set up, measure, and judge one run; the result line as a dict (its
    ``checks`` last) and what the log needs."""
    import torch

    from pcabench import tracing
    from pcabench.reference import compare

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 with TF32 off
    torch.backends.cudnn.allow_tf32 = False
    on_card = cell.device.type == "cuda"
    if driver is None:
        driver = load_module("drivers", cell.traffic["driver"])
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        cell.stamp("cuda")
    state = driver.prepare(cell)
    rec = tracing.Recorder(trace)
    with rec:
        measured = driver.measure(cell, state, seconds, rec)
    setup_s = measured.t0 - t_start
    steps = [("start", t_start)] + cell.stamps + [("window", measured.t0)]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name() if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    log = {"card": card() if on_card else None, "setup_s": setup_s,
           "setup_steps": {b[0]: round(b[1] - a[1], 3)
                           for a, b in zip(steps, steps[1:])}}
    view = View(cell, measured)
    if trace:
        view.trace = tr = rec.trace()
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        log["launches"] = launches(measured, tr)
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        readings = dict(measured.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": readings[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    inputs = driver.release(state)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    readings = driver.judge(cell, inputs, measured.answers)
    nums = compare.numbers(cell.config["checks"], readings)
    nums["missing"] = {"value": measured.missing, "limit": 0}
    log["judge_s"] = time.perf_counter() - t_judge
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    log["parts"] = compare.part_maxima(readings)
    result = {"correct": compare.passed(nums),
              "attempted": measured.attempted, "failed": measured.missing,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = view.trace.breakdown()
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in nums.items()}
    return {"result": result, "log": log, "numbers": nums}


def launches(measured: Measured, tr) -> Dict:
    """The program's launch counters over the window beside the kernels
    the trace holds, and what the trace lost."""
    counted = measured.layer["launches"]
    held = tr.launches()
    return {"counted": {k: counted[k] for k in held}, "traced": held,
            "lost": {k: counted[k] - held[k] for k in held}}


class ForbiddenModules(Exception):
    pass


def main(argv=None, t_start: Optional[float] = None, device=None) -> int:
    """``run.py``'s body.  ``device`` skips the look for a card (the CPU
    tests drive the rest of a run this way)."""
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cell = resolve(bench, args.workload, args.seed)
        cell.device = device if device is not None else look_for_card(cell)
    except (Refused, OSError, ValueError) as err:
        print(f"pcabench: {err}", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        out = run_cell(cell, args.seconds, bool(args.trace), t_start)
    except ForbiddenModules as err:
        print(f"pcabench: modules of JAX or of the JAX package loaded: "
              f"{err.args[0]}", file=sys.stderr)
        return EXIT_FORBIDDEN
    log = out["log"]
    if "launches" in log:
        print(f"launches in the window: {json.dumps(log['launches'])}",
              file=sys.stderr)
    print(f"card: {log['card']}; setup {log['setup_s']:.3f} s; reference "
          f"and comparison {log['judge_s']:.3f} s", file=sys.stderr)
    print(f"set-up by step (s): {json.dumps(log['setup_steps'])}",
          file=sys.stderr)
    print(f"worst part by op: {json.dumps(log['parts'])}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    for name, n in out["numbers"].items():
        where = f" ({n['part']}, {n['answers']} answers)" if "part" in n \
            else ""
        print(f"check {name}: {n['value']!r} limit {n['limit']!r}{where}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


def look_for_card(cell: Cell):
    """The card the cell runs on; ``Refused`` without enough of them."""
    import torch
    cell.stamp("torch")
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark "
                      "runs on a card")
    have = torch.cuda.device_count()
    cell.stamp("driver")
    if have < cell.chips:
        raise Refused(f"the cell needs {cell.chips} cards, "
                      f"{have} visible")
    return torch.device("cuda", 0)
