"""Driver ``fit_loop``: one client calling ``repro_torch.fit_transform``
back to back, a closed loop over a pool of datasets held on the card.

Traffic parameters: ``pool`` (datasets, made on the card from the seed)
and ``check_keep`` (the share of fits after the first of each dataset
whose answers are kept for the judge, drawn from the seed; the rest are
dropped as they come). Set-up ends with ``WARMUP_FITS`` fits of dataset 0.
The configuration gives ``m``, ``d``, ``k``, the data's spectrum (``data``)
and the solver (``solver``: ``PCAConfig``'s fields).

The window opens before the first fit and closes when the first fit that
ends at or past ``--seconds`` ends, so that every fit it starts is counted
with all of its time: ``fit_s`` is the window over the fits. Each fit ends
in ``torch.cuda.synchronize()``. The kept fits' answers (Y, the
eigenvalues, the top-k components) stay on the card and are judged after
the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from pcabench import counts, tracing
from pcabench.harness import Measured
from pcabench.reference import compare, data, plain

WARMUP_FITS = 1  # fits of dataset 0 in set-up


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(cell) -> dict:
    """The pool of datasets, on the card, from the seed."""
    cfg = cell.config
    gen = data.generator(cell.seed, cell.device)
    return {"xs": data.datasets(int(cell.traffic["pool"]), cfg["m"],
                                cfg["d"], cfg["data"], gen, cell.device)}


def prepare(cell) -> dict:
    from repro_torch import PCAConfig, fit_transform
    cell.stamp("program")
    cfg, tr = cell.config, cell.traffic
    xs = inputs(cell)["xs"]
    _sync(cell.device)
    cell.stamp("inputs")
    config = PCAConfig(**cfg["solver"])
    for _ in range(WARMUP_FITS):
        fit_transform(xs[0], cfg["k"], config)
    _sync(cell.device)
    cell.stamp("warm")
    keep = np.random.default_rng((cell.seed + 2) % (1 << 64)).random(
        1 << 16) < float(tr["check_keep"])
    return {"xs": xs, "config": config, "k": int(cfg["k"]), "keep": keep}


def measure(cell, state: dict, seconds: float, rec) -> Measured:
    from repro_torch import fit_transform
    from repro_torch.kernels import launch_counts, reset_launch_counts
    xs, config, k = state["xs"], state["config"], state["k"]
    keep = state["keep"]
    dev = cell.device
    _sync(dev)
    reset_launch_counts()
    answers = []
    fits = 0
    with rec.span(tracing.WINDOW):
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            i = fits % len(xs)
            with rec.span("pcabench.fit_transform"):
                y, res = fit_transform(xs[i], k, config)
                _sync(dev)
            t = time.perf_counter()
            if fits < len(xs) or keep[fits % len(keep)]:
                answers.append((i, y, res.eigenvalues,
                                res.components[:, :k]))
            fits += 1
            if t >= end:
                break
    m, d = xs[0].shape
    return Measured(
        t0=t0, e2e={"fit_s": (t - t0) / fits}, window_s=t - t0,
        attempted=fits, missing=0,
        layer={"launches": launch_counts(), "fits": fits, "m": m, "d": d,
               "k": k, "sweeps": config.sweeps,
               "flops": fits * counts.fit_flops(m, d, k, config.sweeps)},
        answers=answers)


def release(state: dict) -> dict:
    """The inputs, for the reference; the program keeps no state here."""
    return {"xs": state.pop("xs")}


def judge(cell, inputs: dict, answers) -> list:
    """Every kept fit against the float64 reference of its dataset, one
    dataset's reference at a time."""
    readings = []
    for j, x in enumerate(inputs["xs"]):
        mine = [a for a in answers if a[0] == j]
        if not mine:
            continue
        ref = plain.fit_reference(x)
        readings += [("fit", compare.fit_parts(y, w, vk, ref))
                     for _, y, w, vk in mine]
        del ref
    return readings


def control(cell, inputs: dict) -> list:
    """The TF32 control in the program's place, one fit a dataset, judged
    as the program's fits are."""
    k = int(cell.config["k"])
    sweeps = int(cell.config["solver"]["sweeps"])
    readings = []
    for x in inputs["xs"]:
        y, w, vk = plain.tf32_fit(x, k, sweeps)
        readings.append(("fit", compare.fit_parts(
            y, w, vk, plain.fit_reference(x))))
    return readings
