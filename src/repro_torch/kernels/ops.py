"""Registry-dispatched ops over the kernel layer (port of
``repro.kernels.ops`` for the ops of the PCA/SVD path).

Each op resolves a named backend per call (``repro_torch.backends``):

  ``cuda``   the hand-written CUDA kernel; raises on a tensor that is not
             on a CUDA device
  ``torch``  the plain PyTorch version (``kernels.ref``), on any device

``backend=None`` follows the registry's resolution order, whose last rule
follows the tensor: ``cuda`` for a CUDA tensor, ``torch`` for a CPU one.
Each op takes one problem (2-D) or a batch (3-D).  The reference pads
shapes up to block multiples for Pallas; the CUDA kernels mask their
ragged edges instead, so nothing here pads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..backends import registry
from ..core import precision as prec
from . import fused as _fused
from . import mm_engine as _mm
from . import ref as _ref
from .launch import require_cuda

# -- mm_engine_matmul -------------------------------------------------------


@registry.register("mm_engine_matmul", "cuda")
def _mm_cuda(a, b, *, block: int = 0):
    del block  # the kernel's tile is fixed (64 x 64 x 16)
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
    del block_m
    xo = x.to(prec.operand_dtype(precision))
    return _ref.covariance_gram(xo, acc_dtype=prec.acc_dtype(precision))


def covariance(x, block_m: int = 1024, *, precision: str = "fp32",
               normalize: bool = False, backend: Optional[str] = None):
    """Fused one-pass Gram C = x^T x over the sample axis (-2) of x (m, n)
    or (B, m, n).  ``precision`` selects the operand dtype
    (``repro_torch.core.precision``); accumulation never narrows below
    fp32."""
    c = registry.resolve("covariance", backend, like=x)(
        x, block_m=block_m, precision=precision)
    if normalize:
        c = c / max(x.shape[-2] - 1, 1)
    return c


# -- jacobi_sweep (fused pivot round) ---------------------------------------

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
    """One fused Jacobi pivot round: gather + angle + guard + row/col
    rotation over (C, V), (n, n) or (B, n, n), with the (k, 2) disjoint
    ``pairs`` shared across the batch.  ``out`` may name two buffers for the
    kernel to write (not C or V); the plain version ignores it."""
    return registry.resolve("jacobi_sweep", backend, like=C)(
        C, V, pairs, angle=angle, out=out)

