"""Wrapper of the CORDIC rotation-parameter kernel (``csrc/cordic.cu``).

``cordic_rotation_params`` replaces
``repro/kernels/cordic.py::cordic_rotation_params`` (``pallas_call`` at
:87): (theta, cos, sin) for k pivots in Q2.29 fixed point, one thread per
pivot, bitwise the plain version ``kernels.ref.cordic_rotation_params_q29``
(the TPU kernel's seed round(2^29 / K) and no fold before rotation mode).
The TPU wrapper pads k to a block multiple; this kernel masks the tail.
24 bytes and about 500 operations a pivot: at one round's k = 392 the
launch is the cost, so the wrapper allocates one (3, k) output, fuses its
checks into one condition (the detailed message only on failure), enters
the device context only when another device is current and reads the
stream's handle without building a Stream object.

On a CPU tensor it returns the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, call_on, raw_stream, require, require_cuda

CORDIC = KernelInfo("cordic_rotate", "src/repro_torch/csrc/cordic.cu",
                    "src/repro/kernels/cordic.py:87")


def _refuse(apq, app, aqq) -> None:
    """Raise with the first check that the pivots fail."""
    what = "cordic_rotation_params"
    require_cuda(what, apq, app, aqq)
    require(apq.ndim == 1 and app.shape == apq.shape
            and aqq.shape == apq.shape, what,
            f"expected three (k,) tensors, got {tuple(apq.shape)}, "
            f"{tuple(app.shape)}, {tuple(aqq.shape)}")
    require(all(t.dtype == torch.float32 for t in (apq, app, aqq)), what,
            "apq, app and aqq must be float32")
    require(all(t.is_contiguous() for t in (apq, app, aqq)), what,
            "apq, app and aqq must be contiguous")
    require(apq.shape[0] < 2 ** 31, what,
            f"k = {apq.shape[0]} exceeds the launch grid")


def cordic_rotation_params(apq: torch.Tensor, app: torch.Tensor,
                           aqq: torch.Tensor):
    """(theta, cos, sin) of each pivot, for three 1-D float32 tensors of
    one length: the rows of one (3, k) output."""
    if apq.device.type == app.device.type == aqq.device.type == "cpu":
        return _ref.cordic_rotation_params_q29(apq, app, aqq)
    dev = apq.get_device()
    f32 = torch.float32
    if not (apq.is_cuda and app.get_device() == dev == aqq.get_device()
            and apq.dim() == 1 and app.shape == apq.shape == aqq.shape
            and apq.dtype == f32 and app.dtype == f32 and aqq.dtype == f32
            and apq.is_contiguous() and app.is_contiguous()
            and aqq.is_contiguous() and apq.shape[0] < 2 ** 31):
        _refuse(apq, app, aqq)
    k = apq.shape[0]
    out = torch.empty((3, k), dtype=f32, device=apq.device)
    if k:  # an empty grid is no launch
        build.check(call_on(dev, build.library().repro_cordic,
                            apq.data_ptr(), app.data_ptr(), aqq.data_ptr(),
                            out.data_ptr(), k, raw_stream(dev)),
                    "cordic_rotation_params")
        CORDIC.launches += 1
    return out.unbind()
