"""Gradients of the two ops the models call: ``flash_attention`` and
``mamba_scan`` as ``torch.autograd.Function``s.

``ops.flash_attention`` and ``ops.mamba_scan`` route through these when
gradients are enabled and an input requires one.  The forward is the
registry's op, resolved as it would be without gradients: on the card
``flash_attention_mma`` (bf16), ``flash_attention_tf32x3`` (fp32) or
``mamba_scan``, on the CPU the plain versions.  A ctypes launch has no
backward, and none of the TPU kernels has a backward kernel, so the
backward passes here are PyTorch ops, in fp32, whatever the forward ran
on; a CUDA backward kernel would be a later speed item.  They are not the
plain versions of ``kernels.ref``, which stay the tests' yardstick.

Attention (FlashAttention-2's backward, over KV chunks of ``chunk`` keys,
so its memory is O(Sq x chunk) a problem, never Sq x Skv):

* one chunked pass computes the row log-sum-exp of the scaled, masked
  scores and, with the same online softmax, the output O in fp32.  The
  forward's O is bf16 on the bf16 path: D taken from it would carry O's
  rounding (2^-9 relative) into every dS, and the bf16 dQ and dK would
  no longer be one rounding from the fp32 ones, so O is recomputed, at
  the cost of one P V product a chunk;
* D = rowsum(dO o O);
* a second pass, for each chunk: P = exp(S - lse), dV += P^T dO, dP = dO
  V^T, dS = P o (dP - D), dQ += scale dS (K - k_mean), dK += scale dS^T Q.

Each row of dS sums to zero (sum_j P_ij dP_ij = D_i), so dQ = scale dS K
= scale dS (K - c) for any key c; the rounding leaves each computed row a
small sum, which dS K multiplies by the keys' common part.  Keys with a
large common part (whisper's cross attention over its encoder's output:
dQ 3.5e-5 x max |dQ| from the exact gradient) lose dQ's small entries,
so dQ takes the keys less their mean over the problem's keys.

The causal mask is the forward's (row i at position i + ``q_offset``
sees keys 0..i + q_offset; a masked score is -1e30); a chunk is taken
only with the rows that see some key of it (none past the last row's
diagonal), which halves a causal call's work.

Selective scan (x_t = exp(dt_t A) x_{t-1} + dt_t u_t B_t, y_t = C_t . x_t
+ D u_t, an fp32 (batch, D, N) state): the states at the chunk
boundaries are recomputed in one forward pass, then the chunks are taken
last to first, each chunk's states recomputed from its boundary and the
adjoint lambda_t = dL/dx_t run backwards through it,

    lambda_t = C_t dy_t + exp(dt_{t+1} A) lambda_{t+1}

(starting from the final state's gradient, where the caller used it).
From a chunk's states and adjoints, in batched products over the chunk:
dC_t = x_t^T dy_t, dB_t = lambda_t^T (dt_t u_t), du_t = dt_t
(lambda_t B_t) + D dy_t, d(dt)_t = u_t (lambda_t B_t) + sum_n lambda_t
x_{t-1} a_t A, dA = sum_t dt_t lambda_t x_{t-1} a_t, dD = sum_t u_t
dy_t, with a_t = exp(dt_t A).  Memory is a few (batch, chunk, D, N)
fp32 tensors.  With a bf16 state (``state_dtype=torch.bfloat16``, the
reference's ``ssm_dtype="bfloat16"``) the states are recomputed with the
forward's rounding points (``kernels.ref.mamba_scan``), and the adjoint
takes the rounded values (dt, A, B, C, u in b_t's product, a_t, x_t) in
fp32, each rounding's derivative the identity, as ``jax.grad`` takes the
reference's casts; D dy_t and dD stay on the unrounded u.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .ref import bf16_round

_NEG_INF = -1e30  # the forward's masked score


# -- attention ----------------------------------------------------------------

def _scores(qf, kf, j0: int, causal: bool, scale: float, q_offset: int):
    """Scaled, masked fp32 scores of every query row against keys j0.."""
    s = torch.matmul(qf, kf.mT) * scale
    if causal:
        rows = torch.arange(qf.shape[-2], device=qf.device)[:, None] \
            + q_offset
        cols = torch.arange(kf.shape[-2], device=qf.device)[None, :] + j0
        s = s.masked_fill(rows < cols, _NEG_INF)
    return s


def _key_chunks(sq: int, skv: int, causal: bool, q_offset: int, chunk: int):
    """(first row, start, stop) of each KV chunk that some row sees, the
    first row the first that sees its start."""
    end = min(skv, sq + q_offset) if causal else skv
    return [(max(0, j0 - q_offset) if causal else 0, j0,
             min(j0 + chunk, skv)) for j0 in range(0, max(end, 1), chunk)]


def attention_backward(q, k, v, dout, *, causal: bool, scale: float,
                       q_offset: int, chunk: int):
    """(dq, dk, dv) of softmax attention, fp32, in q's, k's and v's dtypes
    (the module docstring's two passes)."""
    f32 = torch.float32
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, dout))
    chunks = _key_chunks(q.shape[-2], k.shape[-2], causal, q_offset, chunk)
    # pass 1: the online softmax, for lse and O in fp32
    m = torch.full(q.shape[:-1], float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for r0, j0, j1 in chunks:
        s = _scores(qf[:, r0:], kf[:, j0:j1], j0, causal, scale,
                    q_offset + r0)
        m_new = torch.maximum(m[:, r0:], s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m[:, r0:] - m_new)
        l[:, r0:] = l[:, r0:] * alpha + p.sum(-1)
        acc[:, r0:] = (acc[:, r0:] * alpha[..., None]
                       + torch.matmul(p, vf[:, j0:j1]))
        m[:, r0:] = m_new
    lse = m + torch.log(l)
    delta = (dof * (acc / l[..., None])).sum(-1, keepdim=True)
    del acc
    # pass 2: the gradients, chunk by chunk
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kc = kf - kf.mean(-2, keepdim=True)    # dQ's keys (module docstring)
    for r0, j0, j1 in chunks:
        kj, vj = kf[:, j0:j1], vf[:, j0:j1]
        qr, dor = qf[:, r0:], dof[:, r0:]
        p = torch.exp(_scores(qr, kj, j0, causal, scale, q_offset + r0)
                      - lse[:, r0:, None])
        dv[:, j0:j1] = torch.matmul(p.mT, dor)
        ds = p * (torch.matmul(dor, vj.mT) - delta[:, r0:])
        del p
        dq[:, r0:] += torch.matmul(ds, kc[:, j0:j1]) * scale
        dk[:, j0:j1] = torch.matmul(ds.mT, qr) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``fn(q, k, v, **kw)`` (a resolved registry op) forward, the torch
    FlashAttention-2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, fn: Callable, causal: bool, scale: float,
                q_offset: int, chunk: int, kw: dict):
        out = fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                 **kw)
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(fn: Callable, q, k, v, *, causal: bool,
                    scale: Optional[float], q_offset: int, chunk: int,
                    **kw):
    """``fn``'s attention with the backward above; ``kw`` goes to ``fn``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, fn, causal, scale, q_offset,
                                max(1, chunk), kw)


# -- selective scan -----------------------------------------------------------

def _chunk_terms(u, dt, A, B, c0: int, c1: int, bf16: bool = False):
    """a_t = exp(dt_t A) and b_t = dt_t u_t B_t over steps c0..c1, each
    (batch, T, D, N) fp32; with ``bf16`` (u, dt, A, B already rounded)
    each product and the exponential rounded to bf16."""
    dtc = dt[:, c0:c1]
    if not bf16:
        a = torch.exp(dtc[..., None] * A)
        b = (dtc * u[:, c0:c1])[..., None] * B[:, c0:c1, None, :]
        return a, b
    a = bf16_round(torch.exp(bf16_round(dtc[..., None] * A)))
    b = bf16_round(bf16_round(dtc * u[:, c0:c1])[..., None]
                   * B[:, c0:c1, None, :])
    return a, b


def _step(a_t, b_t, x, bf16: bool):
    """x_t = a_t x_{t-1} + b_t, with ``bf16`` the product and the sum each
    rounded to bf16."""
    if bf16:
        return bf16_round(bf16_round(a_t * x) + b_t)
    return a_t * x + b_t


def _states(a, b, x0, bf16: bool = False):
    """x_t = a_t x_{t-1} + b_t over a chunk from x0: (batch, T, D, N)."""
    xs = torch.empty_like(a)
    x = x0
    for t in range(a.shape[1]):
        x = _step(a[:, t], b[:, t], x, bf16)
        xs[:, t] = x
    return xs


def scan_backward(u, delta, A, B, C, D_skip, dy, dstate, *, chunk: int,
                  state_dtype: torch.dtype = torch.float32):
    """Gradients of (u, delta, A, B, C, D_skip) of the selective scan, in
    fp32 and then each input's dtype (the module docstring's adjoint).
    ``dy`` (batch, L, D) or None, ``dstate`` (batch, D, N) or None."""
    f32 = torch.float32
    u32, dt32, A32, B32, C32, D32 = (t.to(f32) for t in
                                     (u, delta, A, B, C, D_skip))
    bf16 = state_dtype == torch.bfloat16
    # the values the states and the adjoint take: rounded with a bf16
    # state (D dy and dD keep the unrounded u)
    ub = bf16_round(u32) if bf16 else u32
    if bf16:
        dt32, A32, B32, C32 = (bf16_round(t) for t in (dt32, A32, B32, C32))
    bsz, length, d = u.shape
    n = A.shape[1]
    dy32 = (torch.zeros_like(u32) if dy is None else dy.to(f32))
    bounds = [(c0, min(c0 + chunk, length))
              for c0 in range(0, length, chunk)]
    # the state before each chunk
    starts, x = [], torch.zeros(bsz, d, n, dtype=f32, device=u.device)
    for c0, c1 in bounds:
        starts.append(x)
        a, b = _chunk_terms(ub, dt32, A32, B32, c0, c1, bf16)
        for t in range(c1 - c0):
            x = _step(a[:, t], b[:, t], x, bf16)
    du, ddt = torch.empty_like(u32), torch.empty_like(dt32)
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dA = torch.zeros_like(A32)
    carry = (torch.zeros(bsz, d, n, dtype=f32, device=u.device)
             if dstate is None else dstate.to(f32))
    for (c0, c1), x0 in zip(reversed(bounds), reversed(starts)):
        a, b = _chunk_terms(ub, dt32, A32, B32, c0, c1, bf16)
        xs = _states(a, b, x0, bf16)
        del b
        dyc, uc, dtc = dy32[:, c0:c1], ub[:, c0:c1], dt32[:, c0:c1]
        lam = dyc[..., None] * C32[:, c0:c1, None, :]    # C_t dy_t
        for t in range(c1 - c0 - 1, -1, -1):
            lam[:, t] += carry
            carry = a[:, t] * lam[:, t]
        dC[:, c0:c1] = torch.einsum("btdn,btd->btn", xs, dyc)
        du_dt = dtc * uc
        if bf16:  # b_t's product, as the forward rounded it
            du_dt = bf16_round(du_dt)
        dB[:, c0:c1] = torch.einsum("btdn,btd->btn", lam, du_dt)
        w = torch.einsum("btdn,btn->btd", lam, B32[:, c0:c1])
        xprev = torch.cat([x0[:, None], xs[:, :-1]], dim=1)
        del xs
        g = lam * xprev * a                  # d/d(dt_t A), each (d, n)
        del lam, xprev, a
        ddt[:, c0:c1] = w * uc + torch.einsum("btdn,dn->btd", g, A32)
        dA += torch.einsum("btdn,btd->dn", g, dtc)
        du[:, c0:c1] = w * dtc + D32 * dyc
    dD = (dy32 * u32).sum((0, 1))
    return (du.to(u.dtype), ddt.to(delta.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D_skip.dtype))


class MambaScan(torch.autograd.Function):
    """``fn(..., return_state=True)`` (a resolved registry op) forward,
    the chunked adjoint backward; returns (y, final state)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D_skip, fn: Callable, chunk: int,
                state_dtype: torch.dtype):
        ctx.set_materialize_grads(False)
        y, state = fn(u, delta, A, B, C, D_skip, chunk=chunk,
                      return_state=True, state_dtype=state_dtype)
        ctx.save_for_backward(u, delta, A, B, C, D_skip)
        ctx.chunk = chunk
        ctx.state_dtype = state_dtype
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = scan_backward(*ctx.saved_tensors, dy, dstate,
                              chunk=ctx.chunk, state_dtype=ctx.state_dtype)
        return (*grads, None, None, None)


def mamba_scan(fn: Callable, u, delta, A, B, C, D_skip, *, chunk: int,
               return_state: bool = False,
               state_dtype: torch.dtype = torch.float32):
    """``fn``'s selective scan with the backward above."""
    y, state = MambaScan.apply(u, delta, A, B, C, D_skip, fn, max(1, chunk),
                               state_dtype)
    return (y, state) if return_state else y


__all__ = ["FlashAttention", "MambaScan", "attention_backward",
           "flash_attention", "mamba_scan", "scan_backward"]
