"""Ring attention: sequence-parallel exact attention (port of
``repro.parallel.ring_attention``).

The sequence is split into one block a rank of a mesh axis.  Each rank
keeps its query block and the TRUE GQA K/V blocks rotate around the ring
(``collectives.ring_shift``, a ``batch_isend_irecv`` to the next rank),
each visiting block folded into an fp32 online softmax with the causal
mask by global positions.  G query heads share a KV head inside the
grouped ``einsum``s, so only the KV heads travel: (ring size - 1) x the
local K/V bytes a layer.  The reference computes this with plain
``einsum``s and ``ppermute`` inside ``shard_map``, not with a Pallas
kernel, so the port does too.

Where gradients flow the backward pass is the ring again: the saved
log-sum-exp gives each block's probabilities, dQ accumulates at home
while dK and dV travel with their K and V blocks and arrive home after a
full turn.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives as C

_NEG = -1e30


def _scores(qf, kf, scale, q_pos, k_pos, causal):
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    return s


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axes, causal, scale):
        n, idx = mesh.axes_size(axes), mesh.axes_index(axes)
        b, sl, h, d = q.shape
        kvh = k.shape[2]
        g = h // kvh
        qf = q.reshape(b, sl, kvh, g, d).float()
        ar = torch.arange(sl, device=q.device)
        q_pos = idx * sl + ar
        m = torch.full((b, kvh, g, sl), _NEG, device=q.device)
        l = torch.zeros((b, kvh, g, sl), device=q.device)
        acc = torch.zeros((b, kvh, g, sl, d), device=q.device)
        kc, vc = k, v
        for i in range(n):
            src = (idx - i) % n
            s = _scores(qf, kc.float(), scale, q_pos, src * sl + ar, causal)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc.float())
            m = m_new
            if i < n - 1:
                kc, vc = C.ring_shift([kc, vc], mesh, axes)
        lc = torch.clamp(l, min=1e-30)
        out = acc / lc[..., None]                       # (B, KV, G, sl, D)
        lse = m + torch.log(lc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axes, ctx.causal, ctx.scale = mesh, axes, causal, scale
        return out.permute(0, 3, 1, 2, 4).reshape(b, sl, h, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axes, causal, scale = ctx.mesh, ctx.axes, ctx.causal, ctx.scale
        n, idx = mesh.axes_size(axes), mesh.axes_index(axes)
        b, sl, h, d = q.shape
        kvh = k.shape[2]
        g = h // kvh
        qf = q.reshape(b, sl, kvh, g, d).float()
        do = dout.reshape(b, sl, kvh, g, d).permute(0, 2, 3, 1, 4).float()
        delta = (do * out).sum(-1)                       # (B, KV, G, sl)
        ar = torch.arange(sl, device=q.device)
        q_pos = idx * sl + ar
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            src = (idx - i) % n
            kf, vf = kc.float(), vc.float()
            s = _scores(qf, kf, scale, q_pos, src * sl + ar, causal)
            p = torch.exp(s - lse[..., None])            # (B, KV, G, q, k)
            dv = dv + torch.einsum("bhgqk,bhgqd->bkhd", p, do)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do, vf)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
            dk = dk + torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
            # dK, dV travel with their blocks and are home after n shifts
            if i < n - 1:
                kc, vc, dk, dv = C.ring_shift([kc, vc, dk, dv], mesh, axes)
            else:
                dk, dv = C.ring_shift([dk, dv], mesh, axes)
        return (dq.reshape(b, sl, h, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   *, seq_axis="model", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """This rank's blocks: q (B, S_l, H, D); k/v (B, S_l, KV, D) with H %
    KV == 0, block i of the sequence on the rank of linear index i over
    ``seq_axis`` (a name or a tuple of names).  Returns (B, S_l, H, D),
    this rank's block of the output."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    axes = (seq_axis,) if isinstance(seq_axis, str) else tuple(seq_axis)
    return _Ring.apply(q, k, v, mesh, axes, causal, scale)


__all__ = ["ring_attention"]
