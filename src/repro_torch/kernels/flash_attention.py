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
  at every D <= 128 and alignment: mma.sync on the tensor cores fed by
  ldmatrix from a cp.async ring of 16-, 8- or 4-byte copies (or single
  elements) as D and the bases' alignment allow (``copy_elems``), with P
  split into two bf16 halves for P V so that the result keeps fp32
  accuracy.  Bound by operations: 68.7 GFLOP for causal BH 16, S 4096,
  D 128, 0.0695 ms at 989 TFLOP/s bf16.
* ``flash_attention_tf32x3`` (``csrc/flash_attention_tf32.cu``), fp32
  prefill at every D <= 128: mma.sync on the tensor cores with each fp32
  operand split into tf32 hi and lo and three products (hi hi + hi lo +
  lo hi) per k8 step, which keep the fp32 contract where one tf32 product
  would not; 16-, 8- or 4-byte cp.async copies as D and the rows'
  alignment allow (``copy_floats``).  Bound by operations: 68.7 GFLOP for
  causal BH 16, S 4096, D 128, 1.026 ms at 67 TFLOP/s fp32, 0.416 ms for
  the three tf32 products at 495 TFLOP/s.

Keys are masked by the true Skv, as in the dense oracle, so nothing is
padded (the TPU wrapper pads K/V and relies on the causal mask, which lets
padded keys in when ``q_offset > Skv - Sq``).

On a CPU tensor it returns the plain version
(``kernels.ref.flash_attention``); on a CUDA tensor it launches a kernel or
raises; on the dry run's meta tensors it takes the fake branch
(``kernels.launch``), counted under the kernel the call would launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from . import ref as _ref
from .launch import (KernelInfo, copy_width, is_fake, require,
                     require_cuda, stream)

_TPU = "src/repro/kernels/flash_attention.py:92"
_CSRC = "src/repro_torch/csrc/"
FLASH_MMA = KernelInfo("flash_attention_mma",
                       _CSRC + "flash_attention_mma.cu", _TPU)
FLASH_TF32 = KernelInfo("flash_attention_tf32x3",
                        _CSRC + "flash_attention_tf32.cu", _TPU)
FLASH_SPLITKV = KernelInfo("flash_attention_splitkv",
                           _CSRC + "flash_decode.cu", _TPU)
FLASH_KERNELS = (FLASH_MMA, FLASH_TF32, FLASH_SPLITKV)

MAX_HEAD_DIM = 128
DECODE_MAX_SQ = 16  # query rows of one split-KV launch
SPLIT_KEYS = 256    # keys a block of csrc/flash_decode.cu covers


def choose_kernel(sq: int, dtype: torch.dtype) -> KernelInfo:
    """The kernel that serves a CUDA call with Sq query rows: split-KV for
    Sq <= 16, the 3xTF32 kernel for fp32 prefill, the bf16 tensor-core
    kernel for bf16 prefill (every head dim and alignment)."""
    if sq <= DECODE_MAX_SQ:
        return FLASH_SPLITKV
    return FLASH_TF32 if dtype == torch.float32 else FLASH_MMA


def copy_floats(d: int, *tensors: torch.Tensor) -> int:
    """Floats a cp.async of the 3xTF32 kernel moves: 4, 2 or 1."""
    return copy_width(d, 4, (4, 2), tensors)


def copy_elems(d: int, *tensors: torch.Tensor) -> int:
    """bf16 elements a copy of the bf16 tensor-core kernel moves: 8, 4 or
    2 (a 16-, 8- or 4-byte cp.async), or 1 (one element, copied
    synchronously).  Given ``out`` too, it also says whether the output
    can be stored in pairs (any width >= 2)."""
    return copy_width(d, 2, (8, 4, 2), tensors)


def visible_keys(sq: int, skv: int, causal: bool, q_offset: int) -> int:
    """The keys a kernel visits: all Skv, or, when causal and every row sees
    key 0, those up to the last row's diagonal (the weights of the rest are
    exactly zero)."""
    if causal and q_offset >= 0:
        return min(skv, sq + q_offset)
    return skv


def attention_flops(bh: int, sq: int, skv: int, d: int, causal: bool,
                    q_offset: int) -> float:
    """FLOPs of one call, as ``PERF.md`` bounds it: 4 x d a visible score
    (QK^T and PV, a multiply and an add each), the scores those of the
    keys the kernel visits (``visible_keys``), a causal call's rows each
    seeing keys up to its diagonal."""
    keys = visible_keys(sq, skv, causal, q_offset)
    scores = sq * (keys - (sq - 1) / 2) if causal else sq * keys
    return 4.0 * bh * d * scores


def attention_bytes(q: torch.Tensor, bh: int, sq: int, skv: int, d: int,
                    causal: bool, q_offset: int) -> float:
    """Bytes one call must move: q read and the output written (Sq rows a
    problem), the visited keys of K and V read once."""
    keys = visible_keys(sq, skv, causal, q_offset)
    return float(q.element_size() * bh * d * (2 * sq + 2 * keys))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over k, v (BH, Skv, D), all float32 or
    all bfloat16; query row i sits at position i + ``q_offset``.  The
    default scale is D^-1/2.  On the dry run's meta tensors the kernel
    that would serve the call makes the same checks and allocations,
    counts the call's FLOPs and bytes and launches nothing."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset)
    what = "flash_attention"
    fake = is_fake(q)
    dev = require_cuda(what, q, k, v, fake_ok=fake)
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
    kernel = choose_kernel(sq, q.dtype)
    if kernel is FLASH_SPLITKV:
        kv_end = visible_keys(sq, skv, causal, q_offset)
        n_split = -(-kv_end // SPLIT_KEYS)
        part = torch.empty(bh * sq * n_split * (d + 2),
                           dtype=torch.float32, device=dev)
    if fake:
        kernel.fake_call(attention_flops(bh, sq, skv, d, causal, q_offset),
                         attention_bytes(q, bh, sq, skv, d, causal,
                                         q_offset))
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        if kernel is FLASH_SPLITKV:
            status = lib.repro_flash_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part.data_ptr(), int(q.dtype == torch.bfloat16), bh, sq, skv,
                kv_end, d, scale, int(causal), int(q_offset), n_split,
                stream(dev))
        elif kernel is FLASH_TF32:
            status = lib.repro_flash_attention_tf32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, skv, d, copy_floats(d, q, k, v), scale, int(causal),
                int(q_offset), stream(dev))
        else:
            status = lib.repro_flash_attention_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, skv, d, copy_elems(d, q, k, v, out), scale, int(causal),
                int(q_offset), stream(dev))
        build.check(status, f"{what} ({kernel.name})")
    kernel.launches += 1
    return out
