"""The comparison that decides ``correct``: each answer of the window
against the float64 reference (``reference.plain``), in float64.

Every part is a relative error taken entry by entry: the largest entry of
the difference over the largest entry of what it is measured against, so
that one wrong entry shows as plainly as a wrong whole.  A configuration's
``checks`` name the compared numbers: each is the worst, over the window's
answers of one op, of the largest of the parts it lists, held to its
limit.

Parts (max| . | is the largest entry's magnitude):
  fit   proj      max|Y - Xs V_k| / max|Xs V_k|: the projection of the
                  program's own components, Xs standardized in float64
        subspace  sin of the largest principal angle between the top-k
                  components and the reference's
        eigval    max over the top k of |w - w_ref| / w_ref
        orth      max|V_k^T V_k - I|
  eigh  recon     max|A - V diag(w) V^T| / max|A|
        orth      max|V^T V - I|
        eigval    max|w - w_ref| / max|w_ref|
  svd   resid     the larger of max|A V - U S| and max|A^T U - V S|, over
                  max|A|, on the columns whose reference singular value is
                  above ``SVD_LIVE`` of the largest (below it the Gram path
                  returns a zero column of U by design)
        orth      max|V^T V - I|
        sval      max|s^2 - s_ref^2| / s_ref_max^2: the Gram's spectrum
  pca   recon     max|C - V diag(w) V^T| / max|C|, C the float64 Gram of
                  the standardized data
        orth, eigval  as for eigh, on C
        moments   max |mean - mean_ref| / std_ref and |scale - std_ref| /
                  std_ref over the features
        ratios    max |evcr - evcr_ref|, |cvcr - cvcr_ref| (shares of 1)
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

from . import plain

# twice the widest cutoff below which the port's Gram-path SVD zeroes a
# column of U: sqrt(nb * eps_f32) at the widest svd bucket, nb = 256
SVD_LIVE = 2.0 * math.sqrt(256 * 1.1920929e-07)


def _amax(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return _amax(x) / max(_amax(ref), 1e-300)


def _orth(v: torch.Tensor) -> float:
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return _amax(v.T @ v - eye)


def fit_parts(y, w, vk, ref: plain.FitReference) -> Dict[str, float]:
    """One fit's answer (Y, all eigenvalues, top-k components) against the
    reference of its dataset."""
    dev = ref.xs.device
    y, w, vk = (t.to(dev).double() for t in (y, w, vk))
    k = vk.shape[1]
    want = ref.xs @ vk
    vr = ref.v[:, :k]
    away = vk - vr @ (vr.T @ vk)
    return {
        "proj": _rel(y - want, want),
        "subspace": float(torch.linalg.matrix_norm(away, ord=2)),
        "eigval": float(((w[:k] - ref.w[:k]).abs()
                         / ref.w[:k].abs().clamp_min(1e-300)).max()),
        "orth": _orth(vk),
    }


def _sym_parts(c, w, v, w_ref) -> Dict[str, float]:
    return {
        "recon": _rel(c - (v * w) @ v.T, c),
        "orth": _orth(v),
        "eigval": float((w - w_ref).abs().max()
                        / w_ref.abs().max().clamp_min(1e-300)),
    }


def request_parts(op: str, answer: Dict, ref: Dict) -> Dict[str, float]:
    """One served request's answer (its fields as arrays) against the
    reference of its input (``plain.request_reference``)."""
    dev = ref["a"].device
    got = {k: torch.as_tensor(v).to(dev).double() for k, v in answer.items()
           if k in FIELDS[op]}
    if op == "eigh":
        return _sym_parts(ref["a"], got["eigenvalues"], got["eigenvectors"],
                          ref["w"])
    if op == "svd":
        a, u, s, v = ref["a"], got["U"], got["S"], got["Vt"].T
        live = ref["s"] > SVD_LIVE * ref["s"].max()
        ul, sl, vl = u[:, live], s[live], v[:, live]
        resid = max(_amax(a @ vl - ul * sl), _amax(a.T @ ul - vl * sl))
        return {
            "resid": resid / max(_amax(a), 1e-300),
            "orth": _orth(v),
            "sval": float((s ** 2 - ref["s"] ** 2).abs().max()
                          / (ref["s"].max() ** 2).clamp_min(1e-300)),
        }
    parts = _sym_parts(ref["c"], got["eigenvalues"], got["components"],
                       ref["w"])
    std = ref["std"]
    parts["moments"] = float(torch.maximum(
        (got["mean"] - ref["mean"]).abs() / std,
        (got["scale"] - std).abs() / std).max())
    lam = ref["w"].clamp_min(0.0)
    evcr = lam / lam.sum().clamp_min(1e-300)
    parts["ratios"] = float(torch.maximum(
        (got["evcr"] - evcr).abs(),
        (got["cvcr"] - torch.cumsum(evcr, 0)).abs()).max())
    return parts


def _worse(v: float, worst) -> bool:
    """Whether reading ``v`` is worse than ``worst`` (None: no reading
    yet); NaN is worse than any number."""
    if worst is None or math.isnan(v):
        return worst is None or not math.isnan(worst)
    return not math.isnan(worst) and v > worst


# the served fields each op's comparison reads
FIELDS = {
    "eigh": ("eigenvalues", "eigenvectors"),
    "svd": ("U", "S", "Vt"),
    "pca": ("components", "eigenvalues", "mean", "scale", "evcr", "cvcr"),
}


def numbers(checks: Dict, readings: Iterable[Tuple[str, Dict[str, float]]]
            ) -> Dict[str, Dict]:
    """The compared numbers: for each check of the configuration, the worst
    over the answers of its op of the largest of its parts, beside its
    limit, with the part and the count it came from.  A check whose op has
    no answer reads nothing (None) and fails."""
    readings = list(readings)
    out = {}
    for name, check in checks.items():
        worst, part, count = None, None, 0
        for op, parts in readings:
            if op != check["op"]:
                continue
            count += 1
            for p in check["parts"]:
                if _worse(parts[p], worst):
                    worst, part = parts[p], p
        out[name] = {"value": worst, "limit": check["limit"], "part": part,
                     "answers": count}
    return out


def passed(nums: Dict[str, Dict]) -> bool:
    return all(n["value"] is not None and n["value"] <= n["limit"]
               for n in nums.values())


def part_maxima(readings: List[Tuple[str, Dict[str, float]]]) -> Dict:
    """{op: {part: worst reading}}, for the log."""
    out: Dict[str, Dict[str, float]] = {}
    for op, parts in readings:
        slot = out.setdefault(op, {})
        for p, v in parts.items():
            if _worse(v, slot.get(p)):
                slot[p] = v
    return out
