"""The plain reference, in float64 torch, and its control: the same
reference computed at TF32.

Nothing here imports the program.  The reference works every result out
again from the inputs the benchmark made (``reference.data``): the
standardization, the Gram and its eigendecomposition, a request's spectrum.
``chip_smoke.py``'s ``reference_values`` and ``main_path`` did the same in
numpy; this is that arithmetic in float64 torch, so that it runs on the
card after the window.

The control (``tf32_*``) is the reference put in the program's place one
precision below the configuration's: the configuration states float32 with
TF32 off, so operands are rounded to TF32 (10 explicit mantissa bits, to
nearest, ties away from zero: the more accurate of the hardware's two
roundings), products of them are exact in fp32 and sum in fp32, as the
tensor cores' TF32 mode does.  The fit's control runs the Gram, the solve
(``tf32_eigh``: every rotation a TF32 product, the step a PR that moved the
sweep onto the tensor cores would take) and the projection at TF32: at
70000 rows a TF32 Gram alone averages its rounding out and reads like
fp32.  A request's control rounds the request and the Gram's operands to
TF32 and factors in fp32 (LAPACK), which the comparison already tells
apart by a factor of ten.  Its answers are judged by the same comparison
as the program's; the checks' limits have to fail it.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

STD_EPS = 1e-8  # a feature whose std is below this is scaled by 1


def standardize(x: torch.Tensor):
    """Per-feature zero mean, unit population std over the rows."""
    mean = x.mean(dim=0)
    std = x.std(dim=0, correction=0)
    std = torch.where(std < STD_EPS, torch.ones_like(std), std)
    return (x - mean) / std, mean, std


def eigh_desc(c: torch.Tensor):
    w, v = torch.linalg.eigh(c)
    return w.flip(-1), v.flip(-1)


class FitReference(NamedTuple):
    xs: torch.Tensor      # standardized X, float64
    c: torch.Tensor       # Xs^T Xs, float64
    w: torch.Tensor       # its eigenvalues, descending
    v: torch.Tensor       # their eigenvectors, columns


def fit_reference(x: torch.Tensor) -> FitReference:
    """Float64 PCA of one dataset (the paper's Alg. 1 without the solver's
    schedule: LAPACK's eigh on the exact Gram)."""
    xs, _, _ = standardize(x.double())
    c = xs.T @ xs
    w, v = eigh_desc(c)
    return FitReference(xs, c, w, v)


def request_reference(op: str, a) -> Dict[str, torch.Tensor]:
    """Float64 answer to one request: eigh its eigenvalues (descending),
    svd its singular values, pca the moments, the standardized Gram and its
    eigenvalues."""
    a = torch.as_tensor(a).double()
    if op == "eigh":
        return {"a": a, "w": torch.linalg.eigvalsh(a).flip(-1)}
    if op == "svd":
        return {"a": a, "s": torch.linalg.svdvals(a)}
    xs, mean, std = standardize(a)
    c = xs.T @ xs
    return {"a": a, "mean": mean, "std": std, "c": c,
            "w": torch.linalg.eigvalsh(c).flip(-1)}


# -- the control: the reference at TF32 ---------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits: to
    nearest, ties away from zero (PTX ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on TF32 operands: the products of two 11-bit significands are
    exact in fp32, the sums fp32 (the caller keeps the library's own TF32
    off, so nothing rounds twice)."""
    return tf32(a) @ tf32(b)


def round_robin(n: int) -> List[List[Tuple[int, int]]]:
    """The parallel (round-robin) order of a cyclic Jacobi sweep: n - 1
    rounds (n even; an odd n sits one index out each round) of disjoint
    (p, q) pairs, p < q, covering every pair once."""
    m = n + n % 2
    ring = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [(min(ring[i], ring[m - 1 - i]), max(ring[i], ring[m - 1 - i]))
                 for i in range(m // 2)]
        rounds.append([pq for pq in pairs if pq[1] < n])
        ring = [ring[0], ring[-1]] + ring[1:-1]
    return rounds


def tf32_eigh(c: torch.Tensor, sweeps: int):
    """The eigendecomposition at TF32: cyclic Jacobi in the parallel order
    (LAPACK cannot run at TF32), ``sweeps`` sweeps, the Rutishauser angle
    in fp32, every rotation of C's rows and columns and of V's columns a
    product of TF32 operands (``tf32``) summed in fp32.  Descending."""
    c = c.float().clone()
    n = c.shape[0]
    v = torch.eye(n, dtype=c.dtype, device=c.device)
    rounds = [torch.tensor(r, device=c.device) for r in round_robin(n)]
    for _ in range(sweeps):
        for pq in rounds:
            p, q = pq[:, 0], pq[:, 1]
            apq = c[p, q]
            theta = (c[q, q] - c[p, p]) / (2 * apq)
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta
                                                              + 1))
            t = torch.where(apq == 0, torch.zeros_like(t), t)
            cs = 1 / torch.sqrt(t * t + 1)
            co, si = tf32(cs), tf32(t * cs)
            rp, rq = tf32(c[p]), tf32(c[q])
            c[p] = co[:, None] * rp - si[:, None] * rq
            c[q] = si[:, None] * rp + co[:, None] * rq
            for a in (c, v):
                ap, aq = tf32(a[:, p]), tf32(a[:, q])
                a[:, p] = ap * co - aq * si
                a[:, q] = ap * si + aq * co
    w, order = torch.sort(torch.diagonal(c), descending=True)
    return w, v[:, order]


def tf32_fit(x: torch.Tensor, k: int, sweeps: int):
    """The fit's control: (Y, eigenvalues, top-k components), the Gram,
    the solve and the projection at TF32."""
    xs, _, _ = standardize(x.float())
    w, v = tf32_eigh(tf32_mm(xs.T, xs), sweeps)
    return tf32_mm(xs, v[:, :k]), w, v[:, :k]


def tf32_request(op: str, a):
    """A request's control answer, as a dict of the served fields: the
    request rounded to TF32, the Gram a TF32 product, the factorization in
    fp32."""
    a = tf32(torch.as_tensor(a).float())
    if op == "eigh":
        w, v = eigh_desc(a)
        return {"eigenvalues": w, "eigenvectors": v}
    if op == "svd":
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return {"U": u, "S": s, "Vt": vt}
    xs, mean, std = standardize(a)
    w, v = eigh_desc(tf32_mm(xs.T, xs))
    lam = w.clamp_min(0.0)
    evcr = lam / lam.sum().clamp_min(1e-30)
    return {"components": v, "eigenvalues": w, "mean": mean, "scale": std,
            "evcr": evcr, "cvcr": torch.cumsum(evcr, 0)}
