"""Wrapper of the CORDIC rotation-parameter kernel (``csrc/cordic.cu``).

``cordic_rotation_params`` replaces
``repro/kernels/cordic.py::cordic_rotation_params`` (``pallas_call`` at
:87): (theta, cos, sin) for k pivots in Q2.29 fixed point, one thread per
pivot, bitwise the plain version ``kernels.ref.cordic_rotation_params_q29``
(the TPU kernel's seed round(2^29 / K) and no fold before rotation mode).
The TPU wrapper pads k to a block multiple; this kernel masks the tail.
24 bytes and about 500 operations a pivot: at one round's k = 392 the
launch is the cost.

On a CPU tensor it returns the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, require, require_cuda, stream

CORDIC = KernelInfo("cordic_rotate", "src/repro_torch/csrc/cordic.cu",
                    "src/repro/kernels/cordic.py:87")


def cordic_rotation_params(apq: torch.Tensor, app: torch.Tensor,
                           aqq: torch.Tensor):
    """(theta, cos, sin) of each pivot, for three 1-D float32 tensors of
    one length."""
    if all(t.device.type == "cpu" for t in (apq, app, aqq)):
        return _ref.cordic_rotation_params_q29(apq, app, aqq)
    what = "cordic_rotation_params"
    dev = require_cuda(what, apq, app, aqq)
    require(apq.ndim == 1 and app.shape == apq.shape
            and aqq.shape == apq.shape, what,
            f"expected three (k,) tensors, got {tuple(apq.shape)}, "
            f"{tuple(app.shape)}, {tuple(aqq.shape)}")
    require(all(t.dtype == torch.float32 for t in (apq, app, aqq)), what,
            "apq, app and aqq must be float32")
    require(all(t.is_contiguous() for t in (apq, app, aqq)), what,
            "apq, app and aqq must be contiguous")
    k = apq.shape[0]
    require(k < 2 ** 31, what, f"k = {k} exceeds the launch grid")
    theta, c, s = (torch.empty_like(apq) for _ in range(3))
    if k == 0:  # an empty grid is no launch
        return theta, c, s
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_cordic(
            apq.data_ptr(), app.data_ptr(), aqq.data_ptr(), theta.data_ptr(),
            c.data_ptr(), s.data_ptr(), k, stream(dev)), what)
    CORDIC.launches += 1
    return theta, c, s
