"""The benchmark's inputs, made from ``--seed``: the fit's datasets on the
device, and the serve cells' request pools as numpy arrays, the way users
hand requests over.  The program and the reference get the same arrays.

Rewritten in torch from ``chip_smoke.py``'s ``synthetic_dataset`` (decaying
low-rank factors plus noise, the stand-in for the paper's Table IV data)
and the serving CLI's requests (symmetric Gaussian eigh requests, Gaussian
svd and pca requests, widths Pareto-tailed as the port's "heavy" trace).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from the run's seed (any
    whole number: it is reduced into the generator's 64-bit range)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def decay(rank: int, top: float, bottom: float, device) -> torch.Tensor:
    """Column scales of the low-rank factor: geometric from top to bottom."""
    return torch.logspace(math.log10(top), math.log10(bottom), rank,
                          dtype=torch.float64, device=device).float()


def datasets(count: int, m: int, n: int, data: Dict, gen: torch.Generator,
             device) -> List[torch.Tensor]:
    """``count`` (m, n) float32 datasets on ``device``: base @ mix + noise,
    base (m, rank) scaled column by column, mix (rank, n) / sqrt(rank).
    Three draws a dataset, each in one call."""
    rank = min(n, int(data["rank"]))
    scale = decay(rank, data["decay"][0], data["decay"][1], device)
    out = []
    for _ in range(count):
        base = torch.randn((m, rank), generator=gen, device=device) * scale
        mix = torch.randn((rank, n), generator=gen, device=device) / \
            math.sqrt(rank)
        x = torch.randn((m, n), generator=gen, device=device)
        x.mul_(float(data["noise"])).addmm_(base, mix)
        out.append(x)
    return out


class Request(NamedTuple):
    op: str
    shape: tuple


def heavy_widths(count: int, lo: int, hi: int, alpha: float, scale: float,
                 rng: np.random.Generator) -> List[int]:
    """``count`` widths Pareto-tailed above ``lo``: lo + scale * Lomax(alpha)
    (numpy's ``pareto``), rounded and clipped to [lo, hi]. Most requests
    are near ``lo``, a few reach ``hi``. This is the port's own "heavy"
    traffic shape (``repro_torch.serving.autotune.trace_dims``, alpha 1.5,
    scale 3), copied here so that the benchmark's traffic does not move
    when the program changes."""
    d = lo + rng.pareto(alpha, size=count) * scale
    return [int(w) for w in np.clip(np.round(d), lo, hi)]


def pool_shapes(mix: Dict) -> List[Request]:
    """The pool's requests (op, shape), drawn with the traffic file's own
    ``shape_seed``, so that every run seed serves the same sizes (the seed
    changes only the data).

    ``mix`` has ``ops`` (each op gets ``count`` requests), ``width``
    (``lo``, ``hi``, ``alpha``, ``scale`` of ``heavy_widths``) and
    ``rows_per_width``: an eigh request is (n, n); an svd or pca request is
    (rows_per_width * n, n), tall data as the serving CLI makes it
    (``repro_torch.launch.serve_pca.mixed_traffic``)."""
    rng = np.random.default_rng(int(mix["shape_seed"]))
    w = mix["width"]
    rows = int(mix["rows_per_width"])
    out = []
    for op in mix["ops"]:
        for n in heavy_widths(int(mix["count"]), int(w["lo"]), int(w["hi"]),
                              float(w["alpha"]), float(w["scale"]), rng):
            out.append(Request(op, (n, n) if op == "eigh" else (rows * n, n)))
    return out


def pool_data(requests: Sequence[Request], gen: torch.Generator,
              device) -> List[np.ndarray]:
    """One float32 numpy matrix a request, made on ``device`` in one draw
    and copied to the host once, as the serving CLI's requests are made
    (``repro_torch.serving.autotune.synthesize``): eigh a symmetric
    (g + g^T) / 2 of a Gaussian g, svd and pca a Gaussian."""
    sizes = [int(np.prod(r.shape)) for r in requests]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    mats, at = [], 0
    for r, size in zip(requests, sizes):
        a = flat[at:at + size].view(r.shape)
        at += size
        mats.append((a + a.T) / 2 if r.op == "eigh" else a)
    host = torch.cat([a.reshape(-1) for a in mats]).cpu().numpy()
    out, at = [], 0
    for r, size in zip(requests, sizes):
        out.append(np.ascontiguousarray(host[at:at + size].reshape(r.shape)))
        at += size
    return out
