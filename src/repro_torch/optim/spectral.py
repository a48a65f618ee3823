"""Spectral training telemetry: per-parameter gradient-covariance spectra
via the MANOJAVAM Jacobi engine (port of ``repro.optim.spectral``).

For a 2-D (or folded) gradient G (m, n), the right Gram matrix G^T G is
eigendecomposed on a random sketch of columns (keeps the problem <= probe
dim), giving the EVCR curve of the gradient covariance.  The Gram goes
through the ``covariance`` op and the eigensolve through the Jacobi
solver with ``fused=True`` (on the card: the ``covariance`` and
``jacobi_sweep_smem`` kernels).

Trees are dicts of tensors keyed by the parameter's path, visited in
sorted key order (the reference's flattening order for a dict).  The
sketch of each parameter is drawn from an explicit ``torch.Generator``;
``sketch=`` / ``sketches=`` take given ones instead (the reference's
``jax.random`` draws, for parity).  Gradients are tensors, which stay
where they are, or arrays, which go to ``device`` (default ``cuda``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..core.pca import evcr_cvcr
from ..kernels import ops
from .._device import DeviceLike, as_input
from ..core.jacobi import jacobi_eigh


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    probe_dim: int = 32     # sketch size (Jacobi problem is probe x probe)
    sweeps: int = 10
    min_size: int = 65536


def gradient_spectrum(g: torch.Tensor, cfg: SpectralConfig = SpectralConfig(),
                      generator: Optional[torch.Generator] = None,
                      sketch: Optional[torch.Tensor] = None,
                      device: DeviceLike = None):
    """EVCR of the gradient covariance of one parameter tensor.

    Returns (eigenvalues, evcr, cvcr) of the sketched Gram, descending.
    ``sketch`` (n, k) replaces the draw N(0, 1/n) from ``generator``
    (default: a generator seeded with 0 on g's device)."""
    g = as_input(g, device)
    g2 = g.reshape(-1, g.shape[-1]).float()
    m, n = g2.shape
    k = min(cfg.probe_dim, n)
    if n > k:
        if sketch is None:
            gen = generator or torch.Generator(device=g.device).manual_seed(0)
            sketch = torch.randn((n, k), generator=gen, dtype=torch.float32,
                                 device=g.device) / n ** 0.5
        gs = g2 @ sketch.to(g2)                  # (m, k)
    else:
        gs = g2
    gram = ops.covariance(gs)                     # (k, k)
    res = jacobi_eigh(gram, sweeps=cfg.sweeps, pivot="parallel", fused=True)
    evcr, cvcr = evcr_cvcr(res.eigenvalues)
    return res.eigenvalues, evcr, cvcr


def tree_spectra(grads: Mapping[str, torch.Tensor],
                 cfg: SpectralConfig = SpectralConfig(),
                 generator: Optional[torch.Generator] = None,
                 sketches: Optional[Mapping[str, torch.Tensor]] = None,
                 device: DeviceLike = None
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Spectra for every >=2-D parameter above the size threshold.
    Returns {param_path: {eigenvalues, evcr, cvcr, effective_rank}}.  One
    generator (default seeded with 0) draws the sketches in key order;
    ``sketches`` gives them by path instead."""
    out = {}
    for name in sorted(grads):
        g = as_input(grads[name], device)
        if g.ndim < 2 or g.numel() < cfg.min_size:
            continue
        if generator is None and sketches is None:
            generator = torch.Generator(device=g.device).manual_seed(0)
        lam, evcr, cvcr = gradient_spectrum(
            g, cfg, generator,
            sketch=None if sketches is None else sketches.get(name))
        # entropy-based effective rank
        p = evcr.clamp_min(1e-12)
        eff = torch.exp(-torch.sum(p * torch.log(p)))
        out[name] = {"eigenvalues": lam, "evcr": evcr, "cvcr": cvcr,
                     "effective_rank": eff}
    return out


def suggest_compression_rank(spectra: Dict, coverage: float = 0.9) -> int:
    """Smallest rank whose mean CVCR across parameters reaches coverage."""
    if not spectra:
        return 0
    cvcrs = torch.stack([s["cvcr"] for s in spectra.values()])
    mean_cvcr = cvcrs.mean(0)
    return int(torch.argmax((mean_cvcr >= coverage).to(torch.int32))) + 1
