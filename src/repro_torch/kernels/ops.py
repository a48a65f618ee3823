"""Registry-dispatched ops over the kernel layer (port of
``repro.kernels.ops``): the three ops of the PCA/SVD path
(``covariance``, ``jacobi_sweep``, ``mm_engine_matmul``) and the four
standalone ops (``dle_find_pivot``, ``cordic_rotate``, ``flash_attention``,
``mamba_scan``).

Each op resolves a named backend per call (``repro_torch.backends``):

  ``cuda``   the hand-written CUDA kernel; raises on a tensor that is not
             on a CUDA device, except the dry run's meta tensors, which
             ``flash_attention`` and ``mamba_scan`` take (their fake
             branch) and the other ops refuse
  ``torch``  the plain PyTorch version (``kernels.ref``), on any device

``backend=None`` follows the registry's resolution order, whose last rule
follows the tensor: ``cuda`` for a CUDA tensor, ``torch`` for a CPU one.
``flash_attention`` and ``mamba_scan`` are differentiable: where
gradients are enabled and an input requires one, the resolved op runs as
the forward of a ``torch.autograd.Function`` whose backward is PyTorch
ops (``kernels.grad``).
The three path ops take one problem (2-D) or a batch (3-D).  The reference
pads shapes up to block multiples for Pallas; the CUDA kernels mask their
ragged edges instead, so nothing here pads, and the block arguments kept
for the reference's signatures do not change a result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..backends import registry
from ..core import dle as _core_dle
from ..core import precision as prec
from . import cordic as _cordic
from . import dle as _dle
from . import flash_attention as _fa
from . import fused as _fused
from . import grad as _grad
from . import mamba_scan as _ms
from . import mm_engine as _mm
from . import ref as _ref
from .launch import require_cuda

# -- mm_engine_matmul -------------------------------------------------------


@registry.register("mm_engine_matmul", "cuda")
def _mm_cuda(a, b, *, block: int = 0):
    del block  # the kernels' tiles are fixed (mm_engine.choose_kernel)
    require_cuda("mm_engine_matmul", a, b)
    return _mm.mm_engine(a, b)


@registry.register("mm_engine_matmul", "torch")
def _mm_torch(a, b, *, block: int = 0):
    del block
    return _ref.mm_engine(a, b)


def mm_engine_matmul(a, b, block: int = 128, *,
                     backend: Optional[str] = None):
    """a @ b (2-D or batched 3-D) with an fp32 accumulator (paper tile
    size T = ``block``, kept for the reference's signature)."""
    return registry.resolve("mm_engine_matmul", backend, like=a)(
        a, b, block=block)


# -- covariance (fused one-pass Gram) ---------------------------------------

def _cov_block_m(m: int, block_m: int) -> int:
    """Effective streaming panel: one 8-row-aligned panel when the matrix
    is shorter than the requested block."""
    return min(block_m, -(-m // 8) * 8)


@registry.register("covariance", "cuda")
def _cov_cuda(x, *, block_m: int = 1024, precision: str = "fp32"):
    require_cuda("covariance", x)
    if precision == "fp64":
        raise ValueError("covariance: the CUDA kernel takes fp32 or bf16 "
                         "operands; the fp64 lane runs on the torch backend")
    xo = x.to(prec.operand_dtype(precision)).contiguous()
    return _fused.fused_covariance(
        xo, block_m=_cov_block_m(x.shape[-2], block_m))


@registry.register("covariance", "torch")
def _cov_torch(x, *, block_m: int = 0, precision: str = "fp32"):
    xo = x.to(prec.operand_dtype(precision))
    return _ref.covariance_gram(xo, acc_dtype=prec.acc_dtype(precision),
                                block_m=block_m)


def covariance(x, block_m: int = 1024, *, precision: str = "fp32",
               normalize: bool = False, backend: Optional[str] = None):
    """Fused one-pass Gram C = x^T x over the sample axis (-2) of x (m, n)
    or (B, m, n).  ``precision`` selects the operand dtype
    (``repro_torch.core.precision``); accumulation never narrows below
    fp32.

    Against ``core.covariance.blocked_covariance`` at the same ``block_m``
    (the unfused path): the ``torch`` backend sums the same zero-padded
    ``block_m`` panels in the same order, so with fp32 operands it is
    bitwise equal, as the reference's kernel path is.  The ``cuda`` kernel
    (3xTF32 tensor-core products, the m axis split into ``cov_splits``
    slices) sums in another order: it is held to relative Frobenius 1e-6
    of the unfused Gram, a tenth of ``ERROR_BUDGETS["fp32"]["covariance"]``.
    """
    c = registry.resolve("covariance", backend, like=x)(
        x, block_m=block_m, precision=precision)
    if normalize:
        c = c / max(x.shape[-2] - 1, 1)
    return c


# -- jacobi_sweep (fused pivot rounds) --------------------------------------

@registry.register("jacobi_sweep", "cuda")
def _sweep_cuda(C, V, pairs, *, angle: str = "rutishauser", out=None):
    require_cuda("jacobi_sweep", C, V, pairs)
    return _fused.jacobi_sweep_step(C, V, pairs, angle=angle, out=out)


@registry.register("jacobi_sweep", "torch")
def _sweep_torch(C, V, pairs, *, angle: str = "rutishauser", out=None):
    del out  # the plain version allocates its results
    return _ref.jacobi_sweep_step(C, V, pairs, angle=angle)


def jacobi_sweep(C, V, pairs, *, angle: str = "rutishauser",
                 backend: Optional[str] = None,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Fused Jacobi pivot rounds: gather + angle + guard + row/col rotation
    over (C, V), (n, n) or (B, n, n), with the disjoint ``pairs`` shared
    across the batch: (k, 2) for one round, or (R, k, 2) for R rounds in
    order (a whole sweep: one kernel launch on the ``cuda`` backend).  The
    caller's C and V are never written; ``out`` may name two buffers for
    the kernel to write (not C or V); the plain version ignores it."""
    return registry.resolve("jacobi_sweep", backend, like=C)(
        C, V, pairs, angle=angle, out=out)


# -- dle_find_pivot ---------------------------------------------------------

@registry.register("dle_find_pivot", "cuda")
def _dle_cuda(c, *, tile: int = 128):
    require_cuda("dle_find_pivot", c)
    # one launch: the kernel's last block gathers the pivot
    return _core_dle.Pivot(*_dle.dle_pivot(c, tile=tile))


@registry.register("dle_find_pivot", "torch")
def _dle_torch(c, *, tile: int = 0):
    del tile  # the flat argmax, as the reference's ``ref`` backend
    return _core_dle.find_pivot(c)


def dle_find_pivot(c, tile: int = 128, *, backend: Optional[str] = None):
    """Pivot for the Jacobi step: (p, q, c_pq, c_pp, c_qq) of the max
    |off-diagonal| element of C (n, n), found in one scan of ``tile`` x
    ``tile`` tiles (one kernel launch on the ``cuda`` backend).  The kernel
    breaks ties in tile order and skips a tile holding a NaN, and the
    ``torch`` backend (``core.dle.find_pivot``) takes the first maximum in
    flat row-major order, a NaN first, as the reference's Pallas and
    ``ref`` backends do."""
    return registry.resolve("dle_find_pivot", backend, like=c)(c, tile=tile)


# -- cordic_rotate ----------------------------------------------------------

def _as_pivots(*ts):
    return tuple(t if t.dim() == 1 and t.dtype == torch.float32
                 else torch.atleast_1d(t).to(torch.float32) for t in ts)


@registry.register("cordic_rotate", "cuda")
def _cordic_cuda(apq, app, aqq, *, block: int = 256):
    del block  # one thread per pivot
    require_cuda("cordic_rotate", apq, app, aqq)
    return _cordic.cordic_rotation_params(
        *(t if t.is_contiguous() else t.contiguous()
          for t in _as_pivots(apq, app, aqq)))


@registry.register("cordic_rotate", "torch")
def _cordic_torch(apq, app, aqq, *, block: int = 0):
    del block  # the float oracle, as the reference's ``ref`` backend
    return _ref.cordic_rotation_params(*_as_pivots(apq, app, aqq))


def cordic_rotation_params(apq, app, aqq, block: int = 256, *,
                           backend: Optional[str] = None):
    """(theta, cos, sin) of each pivot: theta = -1/2 atan2(2 apq,
    app - aqq), in Q2.29 CORDIC on the ``cuda`` backend and in float on the
    ``torch`` backend."""
    return registry.resolve("cordic_rotate", backend, like=apq)(
        apq, app, aqq, block=block)


cordic_rotate = cordic_rotation_params  # registry op name alias


# -- flash_attention --------------------------------------------------------

@registry.register("flash_attention", "cuda")
def _fa_cuda(q, k, v, *, causal, scale, block_q=128, block_k=128,
             q_offset=0):
    del block_q, block_k  # each kernel's tiles are fixed (64 x 64 keys)
    require_cuda("flash_attention", q, k, v, fake_ok=True)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)


@registry.register("flash_attention", "torch")
def _fa_torch(q, k, v, *, causal, scale, block_q=0, block_k=0, q_offset=0):
    del block_q, block_k
    return _ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                q_offset=q_offset)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0, *, backend: Optional[str] = None,
                    chunk: int = 1024):
    """Softmax attention of q (BH, Sq, D) over k/v (BH, Skv, D); query row
    i sits at position i + ``q_offset``.  Any Sq and Skv: keys are masked
    by the true Skv, never padded.  ``chunk``: the KV chunk of the
    backward, where gradients flow (the models pass ``cfg.attn_chunk``)."""
    fn = registry.resolve("flash_attention", backend, like=q)
    if _needs_grad(q, k, v):
        return _grad.flash_attention(fn, q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, chunk=chunk,
                                     block_q=block_q, block_k=block_k)
    return fn(q, k, v, causal=causal, scale=scale, block_q=block_q,
              block_k=block_k, q_offset=q_offset)


# -- mamba_scan -------------------------------------------------------------

@registry.register("mamba_scan", "cuda")
def _ms_cuda(u, delta, A, B, C, D_skip, *, chunk: int = 128,
             return_state: bool = False,
             state_dtype: torch.dtype = torch.float32):
    del chunk  # the kernel runs each channel over all of L
    require_cuda("mamba_scan", u, delta, A, B, C, D_skip, fake_ok=True)
    return _ms.mamba_scan(u, delta, A, B, C, D_skip,
                          return_state=return_state, state_dtype=state_dtype)


@registry.register("mamba_scan", "torch")
def _ms_torch(u, delta, A, B, C, D_skip, *, chunk: int = 0,
              return_state: bool = False,
              state_dtype: torch.dtype = torch.float32):
    del chunk
    return _ref.mamba_scan(u, delta, A, B, C, D_skip,
                           return_state=return_state, state_dtype=state_dtype)


def mamba_scan(u, delta, A, B, C, D_skip, chunk: int = 128, *,
               return_state: bool = False, backend: Optional[str] = None,
               state_dtype: torch.dtype = torch.float32):
    """Selective scan y (batch, L, D) of u, delta (batch, L, D), A (D, N),
    B, C (batch, L, N) and D_skip (D,), with a ``state_dtype`` state
    (float32, or bfloat16: the reference's ``ssm_dtype="bfloat16"``,
    ``kernels.ref.mamba_scan``'s rounding points); with ``return_state``,
    (y, the final state (batch, D, N) fp32).  ``chunk``: the backward's
    recompute chunk, where gradients flow (the models pass
    ``cfg.mamba_chunk``)."""
    fn = registry.resolve("mamba_scan", backend, like=u)
    if _needs_grad(u, delta, A, B, C, D_skip):
        return _grad.mamba_scan(fn, u, delta, A, B, C, D_skip, chunk=chunk,
                                return_state=return_state,
                                state_dtype=state_dtype)
    return fn(u, delta, A, B, C, D_skip, chunk=chunk,
              return_state=return_state, state_dtype=state_dtype)
