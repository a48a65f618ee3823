"""Cells of the benchmark cut to a size the CPU runs in seconds, on the
port's plain PyTorch versions (the ``torch`` backend): what the CPU tests
drive in place of the card."""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from pcabench import harness  # noqa: E402

SMALL_FIT = {"m": 1500, "d": 48, "k": 8}
SMALL_SWEEPS = 12
SMALL_POOL = {"count": 6, "width": {"lo": 12, "hi": 40, "alpha": 1.5,
                                    "scale": 3.0}}
SMALL_DRIVER = {"serve_closed": {"WARM_S": 0.2, "CHECK_PER_OP": 4},
                "fit_loop": {"WARMUP_FITS": 1}}


def small_cell(workload: str, seed: int = 7) -> harness.Cell:
    """``workload`` of the committed ``BENCHMARK.json`` on the CPU, its
    sizes cut, its solver on the ``torch`` backend.  The driver's own
    constants are cut too, on its module, for the whole test process."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, workload, seed)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    for name, value in SMALL_DRIVER[cell.traffic["driver"]].items():
        setattr(driver, name, value)
    cell.device = torch.device("cpu")
    solver = dict(cell.config["solver"], backend="torch",
                  sweeps=SMALL_SWEEPS)
    cell.config = dict(cell.config, solver=solver)
    if "m" in cell.config:
        cell.config.update(SMALL_FIT)
        cell.traffic = dict(cell.traffic, pool=2)
    else:
        pool = dict(cell.traffic["pool"], **SMALL_POOL)
        cell.config["server"] = dict(cell.config["server"],
                                     policy={"T": 8, "mode": "pow2"},
                                     max_batch=4, max_inflight=2)
        # a client a request of the pool: the first round sends every op,
        # however few rounds the CPU finishes before the clients stop
        cell.traffic = dict(cell.traffic, pool=pool,
                            clients=len(pool["ops"]) * pool["count"],
                            check_keep=1.0)
    return cell
