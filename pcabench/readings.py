"""The readings a cell's limits are set from, many seeds in one process:
the program's (a short window of the cell's own traffic, judged as a run
judges it) and the control's (the TF32 reference in the program's place,
over the same inputs).  The benchmark's runs never run this.

    python3 pcabench/readings.py --workload <name> --seeds 1,2,3 \\
        [--seconds 3] [--program] [--control]

One JSON line a (mode, seed): the compared numbers and the worst reading
of each part by op.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from pcabench import harness  # noqa: E402
from pcabench.reference import compare  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.resolve(bench, args.workload, seed)
        cell.device = harness.look_for_card(cell)
        driver = harness.load_module("drivers", cell.traffic["driver"])
        if args.program:
            out = harness.run_cell(cell, args.seconds, False,
                                   time.perf_counter(), driver)
            print(json.dumps({"mode": "program", "seed": seed,
                              "correct": out["result"]["correct"],
                              "numbers": out["result"]["checks"],
                              "parts": out["log"]["parts"],
                              "metrics": out["result"]["metrics"]}),
                  flush=True)
        if args.control:
            readings = driver.control(cell, driver.inputs(cell))
            nums = compare.numbers(cell.config["checks"], readings)
            print(json.dumps({"mode": "control", "seed": seed,
                              "numbers": nums,
                              "parts": compare.part_maxima(readings)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
