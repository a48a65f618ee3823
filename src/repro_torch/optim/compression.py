"""PCA gradient compression for slow (cross-pod) all-reduce (port of
``repro.optim.compression``).

PowerSGD-style rank-r subspace iteration with error feedback, where the
orthogonalisation's small eigenproblem is solved by the MANOJAVAM Jacobi
engine.  For a 2-D gradient G (m, n), maintain Q (n, r):
    P = G Q            (m, r)   -> all-reduce P      [r/n of the bytes]
    P = orth(P)                  (Gram eigh via Jacobi)
    Q = G^T P          (n, r)   -> all-reduce Q
    G_hat = P Q^T
    error feedback: e <- G - G_hat, folded into the next step's gradient.

``compress_tree`` applies this to every >=2-D parameter above a size
threshold; small parameters pass exactly.  Trees are dicts of tensors
keyed by the parameter's path.  The r x r Gram of ``_orthonormalize``
goes through the ``covariance`` op and its cyclic solve through the
Jacobi solver with ``fused=True`` (on the card: the ``covariance`` and
``jacobi_sweep_smem`` kernels); the products stay torch matmuls, as
they are ``jnp`` products in the reference.

Gradients and parameters are tensors, which stay where they are, or
arrays, which go to ``device`` (default ``cuda``).

With ``axis_name`` (the cross-pod exchange, ``launch/pod_compression``)
the reductions run over that axis of ``mesh``, a ``parallel.Mesh`` bound
to the process group: each exact leaf, P = G Q before
``_orthonormalize`` and Q = G^T P after it are mean-all-reduced
(``jax.lax.pmean``; ``parallel.collectives.all_reduce(..., op="mean")``,
counted there), each rank holding its own state (its pod's subspace and
error feedback).  An axis that spans one rank issues nothing, so a world
of one computes the local result.  ``axis_name=None`` is the local
path, and ignores ``mesh``.  In the sharded train step the reference
compresses the logical gradient with a replicated state
(``launch/steps.py``, ``comp_specs = P()``), and so does the port's:
it gathers each compressed leaf's gradient whole, runs ``compress_tree``
identically on every rank and keeps its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, as_input
from ..core.jacobi import jacobi_eigh
from ..kernels import ops
from ..parallel import collectives as C


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 4
    min_size: int = 65536       # params smaller than this pass exactly
    axis_name: Optional[str] = None   # collective axis; None = local
    error_feedback: bool = True
    jacobi_sweeps: int = 8


class CompressionState(NamedTuple):
    q: Dict[str, Optional[torch.Tensor]]      # per-param subspace (or None)
    error: Dict[str, Optional[torch.Tensor]]  # per-param error feedback


def _reducer(cfg: CompressionConfig, mesh):
    """The mean over ``cfg.axis_name`` of ``mesh`` (``jax.lax.pmean``), or
    the identity without an axis."""
    axis = cfg.axis_name
    if axis is None:
        return lambda x: x
    names = getattr(mesh, "axis_names", ())
    if axis not in names:
        raise ValueError(
            f"axis_name={axis!r} needs a parallel.Mesh with that axis; got "
            + ("no mesh" if mesh is None else f"axes {names}"))
    return lambda x: C.all_reduce(x, mesh, axis, op="mean")


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """Fold leading (e.g. stacked-layer) dims into rows: compress along the
    trailing feature dim, one subspace per parameter tensor."""
    return g.reshape(-1, g.shape[-1]) if g.ndim > 2 else g


def _orthonormalize(p: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Orthonormalise the columns of p (m, r) via Jacobi eigh of p^T p --
    the MANOJAVAM datapath (r x r problem, r <= 16)."""
    gram = ops.covariance(p.float())                 # (r, r)
    res = jacobi_eigh(gram, sweeps=sweeps, pivot="cyclic", fused=True)
    vecs = res.eigenvectors
    inv_sqrt = vecs @ (torch.diag(torch.rsqrt(
        res.eigenvalues.clamp_min(1e-12))) @ vecs.T)
    return p @ inv_sqrt.to(p.dtype)


def init_state(params: Mapping[str, torch.Tensor], cfg: CompressionConfig,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> CompressionState:
    """A random N(0, 1) subspace (n, rank) for each compressed parameter,
    drawn in sorted key order from ``generator`` (default seeded with 0),
    and a zero fp32 error buffer.  (The reference seeds each subspace with
    ``hash(str(path))``, which Python salts per process; parity carries the
    reference's state across instead.)"""
    q, err = {}, {}
    for name in sorted(params):
        p = as_input(params[name], device)
        if p.ndim < 2 or p.numel() < cfg.min_size:
            q[name] = err[name] = None
            continue
        if generator is None:
            generator = torch.Generator(device=p.device).manual_seed(0)
        n = _as_matrix(p).shape[1]
        q[name] = torch.randn((n, cfg.rank), generator=generator,
                              dtype=torch.float32, device=p.device)
        err[name] = torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    return CompressionState(q=q, error=err)


def compress_tree(grads: Mapping[str, torch.Tensor], state: CompressionState,
                  cfg: CompressionConfig, device: DeviceLike = None,
                  mesh=None
                  ) -> Tuple[Dict[str, torch.Tensor], CompressionState, dict]:
    """Returns (approximated grads, reduced over ``cfg.axis_name`` of
    ``mesh`` where it is set; new state; metrics)."""
    reduce = _reducer(cfg, mesh)
    new_q, new_e, out = {}, {}, {}
    comp_bytes = full_bytes = 0
    for k in sorted(grads):
        g = as_input(grads[k], device)
        q = state.q.get(k)
        if q is None:
            out[k] = reduce(g)
            new_q[k] = new_e[k] = None
            full_bytes += g.numel() * 4
            continue
        g2 = _as_matrix(g).float()
        if cfg.error_feedback:
            g2 = g2 + _as_matrix(state.error[k])
        p = _orthonormalize(reduce(g2 @ q), cfg.jacobi_sweeps)   # (m, r)
        qn = reduce(g2.T @ p)                                     # (n, r)
        g_hat = p @ qn.T
        new_e[k] = ((g2 - g_hat) if cfg.error_feedback
                    else torch.zeros_like(g2)).reshape(g.shape)
        out[k] = g_hat.reshape(g.shape).to(g.dtype)
        new_q[k] = qn
        comp_bytes += (p.numel() + qn.numel()) * 4
        full_bytes += g.numel() * 4
    metrics = {"compressed_bytes": comp_bytes, "exact_bytes": full_bytes}
    return out, CompressionState(q=new_q, error=new_e), metrics
