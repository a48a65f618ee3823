"""Wrapper of the flash-attention forward kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces
``repro/kernels/flash_attention.py::flash_attention`` (``pallas_call`` at
:92): online-softmax attention for q (BH, Sq, D) and k/v (BH, Skv, D) of
fp32 or bf16, with fp32 m, l and accumulator, the causal mask offset by
``q_offset`` and the output in q's dtype.  One block per (bh, 64-row q
tile) streams 64-row K/V tiles through shared memory; fp32 FMAs on the
CUDA cores.  Keys are masked by the true Skv, as in the dense oracle, so
nothing is padded (the TPU wrapper pads K/V and relies on the causal mask,
which lets padded keys in when ``q_offset > Skv - Sq``).  Bound by
operations at prefill: 68.7 GFLOP for causal BH 16, S 4096, D 128, 1.03 ms
at 67 TFLOP/s fp32.

On a CPU tensor it returns the plain version
(``kernels.ref.flash_attention``); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, require, require_cuda, stream

FLASH_ATTENTION = KernelInfo("flash_attention",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:92")

MAX_HEAD_DIM = 128
_BQ = 64  # q rows per block of csrc/flash_attention.cu


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over k, v (BH, Skv, D), all float32 or
    all bfloat16; query row i sits at position i + ``q_offset``.  The
    default scale is D^-1/2."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset)
    what = "flash_attention"
    dev = require_cuda(what, q, k, v)
    require(q.ndim == 3 and k.ndim == 3 and k.shape == v.shape, what,
            f"expected q (BH, Sq, D) and k, v (BH, Skv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    skv = k.shape[1]
    require(k.shape[0] == bh and k.shape[2] == d, what,
            f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16), what,
            f"q, k and v must all be float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
            what, "q, k and v must be contiguous")
    require(0 < d <= MAX_HEAD_DIM, what,
            f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    require(skv > 0, what, "attention over no keys")
    require(bh <= 65535 and sq < 2 ** 30 and skv < 2 ** 30, what,
            f"shape {tuple(q.shape)} x {skv} keys exceeds the launch grid")
    require(abs(q_offset) < 2 ** 30, what, f"q_offset {q_offset} is out of "
            f"range")
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:  # an empty grid is no launch
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, sq, skv, d, scale,
            int(causal), int(q_offset), stream(dev)), what)
    FLASH_ATTENTION.launches += 1
    return out
