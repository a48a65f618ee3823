"""Wrapper of the flash-attention forward kernels.

``flash_attention`` replaces
``repro/kernels/flash_attention.py::flash_attention`` (``pallas_call`` at
:92): online-softmax attention for q (BH, Sq, D) and k/v (BH, Skv, D) of
fp32 or bf16, with fp32 m, l and accumulator, the causal mask offset by
``q_offset`` (a masked score is -1e30) and the output in q's dtype.  Three
hand-written kernels serve the op; ``choose_kernel`` picks one from the
shape and dtype before any launch, and nothing falls back after one:

* ``flash_attention_splitkv`` (``csrc/flash_decode.cu``), Sq <= 16 in
  either dtype: a (split, bh) grid of 256-key runs, each scoring all query
  rows against every K/V row it loads, and a second launch that merges the
  splits in a fixed order.  Bound by bytes (K and V read once).
* ``flash_attention_mma`` (``csrc/flash_attention_mma.cu``), bf16 prefill
  with D % 8 == 0: mma.sync on the tensor cores fed by ldmatrix from a
  cp.async ring, with P split into two bf16 halves for P V so that the
  result keeps fp32 accuracy.  Bound by operations: 68.7 GFLOP for causal
  BH 16, S 4096, D 128, 0.0695 ms at 989 TFLOP/s bf16.
* ``flash_attention_simt`` (``csrc/flash_attention.cu``), every other
  prefill (fp32, bf16 with D % 8 != 0 or rows not 16-byte aligned): one
  block per (bh, 64-row q tile), fp32 FMAs on the CUDA cores; TF32 would
  break the fp32 contract.

Keys are masked by the true Skv, as in the dense oracle, so nothing is
padded (the TPU wrapper pads K/V and relies on the causal mask, which lets
padded keys in when ``q_offset > Skv - Sq``).

On a CPU tensor it returns the plain version
(``kernels.ref.flash_attention``); on a CUDA tensor it launches a kernel or
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, require, require_cuda, stream

_TPU = "src/repro/kernels/flash_attention.py:92"
_CSRC = "src/repro_torch/csrc/"
FLASH_SIMT = KernelInfo("flash_attention_simt", _CSRC + "flash_attention.cu",
                        _TPU)
FLASH_MMA = KernelInfo("flash_attention_mma",
                       _CSRC + "flash_attention_mma.cu", _TPU)
FLASH_SPLITKV = KernelInfo("flash_attention_splitkv",
                           _CSRC + "flash_decode.cu", _TPU)
FLASH_KERNELS = (FLASH_MMA, FLASH_SPLITKV, FLASH_SIMT)

MAX_HEAD_DIM = 128
DECODE_MAX_SQ = 16  # query rows of one split-KV launch
SPLIT_KEYS = 256    # keys a block of csrc/flash_decode.cu covers


def choose_kernel(sq: int, d: int, dtype: torch.dtype,
                  aligned: bool = True) -> KernelInfo:
    """The kernel that serves a CUDA call with Sq query rows of head dim d:
    split-KV for Sq <= 16, the tensor-core kernel for bf16 prefill with
    D % 8 == 0 and 16-byte aligned q, k, v and out (``aligned``), the SIMT
    kernel otherwise."""
    if sq <= DECODE_MAX_SQ:
        return FLASH_SPLITKV
    if dtype == torch.bfloat16 and d % 8 == 0 and aligned:
        return FLASH_MMA
    return FLASH_SIMT


def visible_keys(sq: int, skv: int, causal: bool, q_offset: int) -> int:
    """The keys a kernel visits: all Skv, or, when causal and every row sees
    key 0, those up to the last row's diagonal (the weights of the rest are
    exactly zero)."""
    if causal and q_offset >= 0:
        return min(skv, sq + q_offset)
    return skv


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    kernel = choose_kernel(sq, d, q.dtype, aligned)
    lib = build.library()
    with torch.cuda.device(dev):
        if kernel is FLASH_SPLITKV:
            kv_end = visible_keys(sq, skv, causal, q_offset)
            n_split = -(-kv_end // SPLIT_KEYS)
            part = torch.empty(bh * sq * n_split * (d + 2),
                               dtype=torch.float32, device=dev)
            status = lib.repro_flash_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part.data_ptr(), int(q.dtype == torch.bfloat16), bh, sq, skv,
                kv_end, d, scale, int(causal), int(q_offset), n_split,
                stream(dev))
        elif kernel is FLASH_MMA:
            status = lib.repro_flash_attention_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, skv, d, scale, int(causal), int(q_offset), stream(dev))
        else:
            status = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), bh, sq, skv, d, scale,
                int(causal), int(q_offset), stream(dev))
        build.check(status, f"{what} ({kernel.name})")
    kernel.launches += 1
    return out
