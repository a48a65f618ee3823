"""Mixture-of-Experts with capacity-based top-k dispatch (port of
``repro.models.moe``, its single-shard path): jamba's and arctic's top-2
and llama4's top-1 expert layers, arctic's parallel dense residual FFN
and llama4's shared expert.

Routing is the reference's: router logits and softmax in fp32, the top k
experts a token, their gates renormalised, and the load-balance ``aux``
(E x sum(mean router probability x fraction of assignments) over the
experts).  Dispatch gives each expert ``capacity`` slots, filled in
slot-major order (every token's first choice before any second choice);
an assignment past its expert's capacity is dropped, and its token gets
nothing from that expert.  The expert products are the reference's plain
``einsum``s, outside any Pallas kernel, so ``torch.bmm`` here.

The reference's ``shard_map`` path (experts sharded over a mesh axis)
waits for the LM half of the multi-device work (ROADMAP queue 1, item 4b);
``_dispatch_compute_combine`` keeps its ``e0`` / ``E_local`` arguments,
the share of the experts that one device holds.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .layers import MLP, _normal, _param


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f,
    d) in the model's dtype (every expert is a swiglu FFN)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param(torch.empty(d, E, dtype=torch.float32,
                                         device=device))
        self.wi = _param(torch.empty(E, d, f, dtype=dt, device=device))
        self.wg = _param(torch.empty(E, d, f, dtype=dt, device=device))
        self.wo = _param(torch.empty(E, f, d, dtype=dt, device=device))

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        """The reference's ``init_moe``: normal, scaled by 1/sqrt(d) (the
        router, ``wi``, ``wg``) and 1/sqrt(f) (``wo``)."""
        d, f = self.wi.shape[1:]
        dev = self.wi.device
        for w, scale in ((self.router, d), (self.wi, d), (self.wg, d),
                         (self.wo, f)):
            w.copy_(_normal(gen, w.shape, w.dtype, 1.0 / math.sqrt(scale),
                            dev))


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slot count for ``tokens`` routed tokens."""
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(1, c)
    if c > 8:
        c += (-c) % 8
    return min(tokens * cfg.top_k, c)


def _routing(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """(gate (T, k), idx (T, k), aux) from flat tokens xf (T, d)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=xf.device)
    ) / (xf.shape[0] * k)
    aux = E * torch.sum(me * ce)
    return gate, idx, aux


def positions(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each assignment's position in its expert's queue: the running count
    of earlier assignments to the same expert, in the order of ``e_flat``
    (the slot-major expert ids, ``idx.T.reshape(-1)``).  Those at or past
    the capacity are dropped."""
    onehot = F.one_hot(e_flat, E)
    return (onehot.cumsum(0) - 1).gather(1, e_flat[:, None])[:, 0]


def _dispatch_compute_combine(xf, gate, idx, wi, wg, wo, *, E: int, k: int,
                              C: int, e0: int, E_local: int):
    """Dispatch -> expert FFN -> combine for the ``E_local`` experts from
    global id ``e0``.  xf (T, d) -> (T, d).

    The reference scatters every assignment with an add, the dropped and
    the foreign ones as zeros at a clamped slot (slot C - 1 of an expert
    that may own it).  Here each kept assignment is copied to its own
    (expert, slot), which no other kept one shares, and every other one
    to a spare row past the buffer: no value can land on a slot a token
    owns, and each slot holds what the reference's sum holds."""
    T, d = xf.shape
    e_flat = idx.T.reshape(-1)                          # (k T,) slot-major
    pos = positions(e_flat, E)
    rel = e_flat - e0
    mine = (pos < C) & (rel >= 0) & (rel < E_local)
    dest = rel.clamp(0, E_local - 1) * C + pos.clamp(max=C - 1)
    tok_ids = torch.arange(T, device=xf.device).repeat(k)
    buf = xf.new_zeros(E_local * C + 1, d)
    buf[torch.where(mine, dest, E_local * C)] = xf[tok_ids]
    buf = buf[:-1].view(E_local, C, d)

    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    y_e = torch.bmm(F.silu(g) * h, wo).view(E_local * C, d)

    y_tok = y_e[dest] * mine[:, None].to(y_e.dtype)
    gates_flat = gate.T.reshape(-1)[:, None].to(y_tok.dtype)
    return (y_tok * gates_flat).view(k, T, d).sum(0)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              mlp_res: Optional[MLP] = None,
              mlp_shared: Optional[MLP] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux).  ``mlp_res`` (arctic's dense residual)
    and ``mlp_shared`` (llama4's shared expert) are dense FFNs on the same
    tokens, added into the same sum (the reference's ``_dense_partial``
    is ``MLP.forward``: swiglu, or tanh-gelu without ``wg``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate, idx, aux = _routing(p, xf, cfg)
    C = capacity(b * s, cfg)
    y = _dispatch_compute_combine(xf, gate, idx, p.wi, p.wg, p.wo,
                                  E=cfg.n_experts, k=cfg.top_k, C=C, e0=0,
                                  E_local=cfg.n_experts)
    for mlp in (mlp_res, mlp_shared):
        if mlp is not None:
            y = y + mlp(xf)
    return y.reshape(b, s, d).to(x.dtype), aux


__all__ = ["MoE", "apply_moe", "capacity", "positions"]
