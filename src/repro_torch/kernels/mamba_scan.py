"""Wrapper of the selective-scan kernel (``csrc/mamba_scan.cu``).

``mamba_scan`` replaces ``repro/kernels/mamba_scan.py::mamba_scan``
(``pallas_call`` at :67): x_t = exp(dt_t A) x_{t-1} + (dt_t u_t) B_t,
y_t = x_t . C_t + D u_t with an fp32 state.  A thread owns one (b, d)
channel and 4 of its N <= 16 states, so a channel is 4 adjacent lanes
(states past N are zero); they sum each step's y by xor shuffles once a
chunk is done.  A block of 32 channels streams the time axis in chunks of
32 steps through a cp.async ring, each operand copied 16, 8 or 4 bytes (or
one bf16 element) at a time as its width and base allow (``scan_copies``);
y is stored from a shared tile the same way, as wide as D and y's base
allow; with ``return_state`` each lane also stores its 4 final states
(``models.mamba``'s prefill keeps them for decode).  Nothing is padded.
With ``state_dtype=torch.bfloat16`` (a model's ``ssm_dtype="bfloat16"``)
the launch takes the kernel's bf16-state instance (``MAMBA_SCAN_BF16``,
its own launch count): the state kept in bf16 and rounded where the
reference's bf16 scan rounds (``kernels.ref.mamba_scan``'s rounding
points), y summed in fp32, the final state stored in fp32.
Bound at falcon-mamba-7b's d_inner 8192, N 16, L 4096 in fp32: 5.4e8
exponentials on the SFU (0.128 ms at 16 a clock an SM on 132 SMs at 1.98
GHz) and 403 MB of u, dt and y (0.120 ms at 3.35 TB/s); the kernel takes
0.25 ms there on an H100 SXM at 700 W.

On a CPU tensor it returns the plain version (``kernels.ref.mamba_scan``);
on a CUDA tensor it launches the kernel or raises; on the dry run's meta
tensors it takes the fake branch (``kernels.launch``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from . import ref as _ref
from .launch import (KernelInfo, copy_width, is_fake, require,
                     require_cuda, stream)

MAMBA_SCAN = KernelInfo("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                        "src/repro/kernels/mamba_scan.py:67")

MAMBA_SCAN_BF16 = KernelInfo("mamba_scan_bf16_state",
                             "src/repro_torch/csrc/mamba_scan.cu",
                             "src/repro/kernels/mamba_scan.py:67")

MAX_STATE = 16   # N limit of csrc/mamba_scan.cu (4 lanes of 4 states)

# the bf16-state instance's packed primitives, in the order of the
# entry's ``which`` (csrc/mamba_scan.cu, check_kernel), each with the
# inputs its check covers: every bf16 pair for mul and add, every fp32
# bit pattern for the convert, every bf16 for r(expf(x))
BF16_PRIMITIVES = {"mul": 2 ** 32, "add": 2 ** 32, "cvt": 2 ** 32,
                   "exp": 2 ** 16}


def scan_copies(u: torch.Tensor, delta: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor) -> Tuple[int, int]:
    """Elements a copy of u and delta, and of B and C: the widest of 16, 8
    and 4 bytes (or one element) that divides the row width (D, N) and to
    which every base of the pair is aligned."""
    es = u.element_size()
    widths = (4, 2) if es == 4 else (8, 4, 2)
    D, N = u.shape[-1], B.shape[-1]
    return (copy_width(D, es, widths, (u, delta)),
            copy_width(N, es, widths, (B, C)))


def scan_flops(batch: int, length: int, d: int, n: int) -> float:
    """Operations of one call at the fp32 rate, as ``PERF.md`` bounds it:
    7 N + 3 a (b, t, d) (the N exponentials run on the SFU and are not
    counted)."""
    return float(batch * length * d * (7 * n + 3))


def scan_bytes(u: torch.Tensor, batch: int, length: int, d: int, n: int,
               return_state: bool) -> float:
    """Bytes one call must move: u, delta and B, C read and y written in
    the operands' dtype, A and D_skip in fp32, the final state (fp32)
    written with ``return_state``."""
    es = u.element_size()
    return float(es * (3 * batch * length * d + 2 * batch * length * n)
                 + 4 * d * (n + 1) + 4 * batch * d * n * return_state)


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D_skip: torch.Tensor,
               return_state: bool = False,
               state_dtype: torch.dtype = torch.float32):
    """y (batch, L, D) for u, delta (batch, L, D), A (D, N), B, C
    (batch, L, N) and D_skip (D,).  u, delta, B and C share one dtype,
    float32 or bfloat16, which y takes; A and D_skip are used in fp32.
    ``state_dtype``: the state's, float32 or bfloat16 (the bf16-state
    instance).  With ``return_state``, (y, state): the final state
    x_{L-1}, (batch, D, N) in fp32, stored by the same launch.  On the
    dry run's meta tensors the same checks and allocations, the call's
    FLOPs and bytes counted, nothing launched."""
    tensors = (u, delta, A, B, C, D_skip)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.mamba_scan(u, delta, A, B, C, D_skip,
                               return_state=return_state,
                               state_dtype=state_dtype)
    what = "mamba_scan"
    require(state_dtype in (torch.float32, torch.bfloat16), what,
            f"state_dtype must be float32 or bfloat16, got {state_dtype}")
    fake = is_fake(u)
    dev = require_cuda(what, *tensors, fake_ok=fake)
    require(u.ndim == 3 and delta.shape == u.shape, what,
            f"u and delta must be (batch, L, D), got {tuple(u.shape)} and "
            f"{tuple(delta.shape)}")
    batch, L, D = u.shape
    require(A.ndim == 2 and A.shape[0] == D, what,
            f"A must be (D, N) with D = {D}, got {tuple(A.shape)}")
    N = A.shape[1]
    require(0 < N <= MAX_STATE, what,
            f"state size {N} is outside 1..{MAX_STATE}")
    require(B.shape == (batch, L, N) and C.shape == (batch, L, N), what,
            f"B and C must be {(batch, L, N)}, got {tuple(B.shape)} and "
            f"{tuple(C.shape)}")
    require(D_skip.shape == (D,), what,
            f"D_skip must be ({D},), got {tuple(D_skip.shape)}")
    require(u.dtype == delta.dtype == B.dtype == C.dtype
            and u.dtype in (torch.float32, torch.bfloat16), what,
            f"u, delta, B and C must all be float32 or all bfloat16, got "
            f"{u.dtype}, {delta.dtype}, {B.dtype}, {C.dtype}")
    require(A.is_floating_point() and D_skip.is_floating_point(), what,
            "A and D_skip must be floating point")
    require(all(t.is_contiguous() for t in (u, delta, B, C)), what,
            "u, delta, B and C must be contiguous")
    require(batch <= 65535 and L < 2 ** 31 and D < 2 ** 31, what,
            f"shape {tuple(u.shape)} exceeds the launch grid")
    y = torch.empty_like(u)
    state = (torch.zeros(batch, D, N, dtype=torch.float32, device=dev)
             if return_state else None)
    if y.numel() == 0:  # an empty grid is no launch
        return (y, state) if return_state else y
    # the reference kernel also takes A and D_skip in fp32; both are small
    A32 = A.to(torch.float32).contiguous()
    D32 = D_skip.to(torch.float32).contiguous()
    bf16_state = state_dtype == torch.bfloat16
    kernel = MAMBA_SCAN_BF16 if bf16_state else MAMBA_SCAN
    if fake:
        kernel.fake_call(scan_flops(batch, L, D, N),
                         scan_bytes(u, batch, L, D, N, return_state))
        return (y, state) if return_state else y
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_mamba_scan(
            u.data_ptr(), delta.data_ptr(), A32.data_ptr(), B.data_ptr(),
            C.data_ptr(), D32.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(),
            int(u.dtype == torch.bfloat16), int(bf16_state), batch, L, D, N,
            *scan_copies(u, delta, B, C), stream(dev)), what)
    kernel.launches += 1
    return (y, state) if return_state else y


def bf16_primitive_mismatches(device) -> dict:
    """Each packed primitive of the bf16-state instance held on the card
    to its plain counterpart at every input (``BF16_PRIMITIVES``):
    ``{name: {"inputs": n, "mismatches": m, "first": the first
    mismatching item or None}}`` (NaN against NaN is a match).  It runs
    device code, so it needs a CUDA device; the plain version has nothing
    to check on the CPU."""
    dev = torch.device(device)
    require(dev.type == "cuda", "bf16_primitive_mismatches",
            f"needs a CUDA device, got {dev}")
    lib = build.library()
    out = {}
    with torch.cuda.device(dev):
        for which, (name, n) in enumerate(BF16_PRIMITIVES.items()):
            res = torch.tensor([0, -1], dtype=torch.int64, device=dev)
            build.check(lib.repro_scan_bf16_check(which, res.data_ptr(),
                                                  stream(dev)),
                        f"bf16 check {name}")
            bad, first = (int(v) for v in res.cpu())
            out[name] = {"inputs": n, "mismatches": bad,
                         "first": None if first == -1 else first}
    return out
