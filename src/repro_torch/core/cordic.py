"""Rotation-parameter computation for Jacobi sweeps (port of
``repro.core.cordic``).

  * ``rotation_params``             -- float atan2 formulation
  * ``rotation_params_rutishauser`` -- Golub & Van Loan stable t-formula
  * ``rotation_params_cordic``      -- fixed-point (Q2.29) CORDIC, the
                                       hardware datapath
  * ``cordic_atan2`` / ``cordic_sincos`` -- the underlying engines

Sign convention as in the reference: R[p,p]=R[q,q]=cos, R[p,q]=sin,
R[q,p]=-sin and theta = -1/2 * atan2(2*c_pq, c_pp - c_qq), which zeroes the
pivot under C' = R^T C R.

All functions take float32 tensors of any shape and compute in float32
(the CORDIC micro-rotations in int32).  The CUDA sweep kernel
(``csrc/jacobi_sweep.cu``) repeats this arithmetic operation for operation
and carries the same constants.
"""
from __future__ import annotations

import numpy as np
import torch

# Number of CORDIC micro-rotations; 30 iterations in Q2.29 reaches ~2^-29
# angle granularity.
CORDIC_ITERS = 30
_FRAC_BITS = 29
_ONE = np.int64(1) << _FRAC_BITS
# CORDIC gain K = prod(sqrt(1 + 2^-2i)); the rotation seed is 1/K.
_GAIN = float(np.prod([np.sqrt(1.0 + 2.0 ** (-2 * i))
                       for i in range(CORDIC_ITERS)]))
_ATAN_TABLE = np.array(
    [np.arctan(2.0 ** -i) for i in range(CORDIC_ITERS)], dtype=np.float64)
_ATAN_FIXED = np.round(_ATAN_TABLE * _ONE).astype(np.int32)
# rotation-mode seed x0 = round(f32(1/K) * 2^29), as the reference core
# computes it (the standalone reference kernel seeds round(2^29 / K), one
# ulp away; this port follows the core solver)
_X0_FIXED = int(np.round(np.float64(np.float32(1.0 / _GAIN)) * float(_ONE)))

_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def rotation_params(apq, app, aqq):
    """theta, cos, sin such that R^T C R zeroes c_pq."""
    theta = -0.5 * torch.atan2(2.0 * apq, app - aqq)
    return theta, torch.cos(theta), torch.sin(theta)


def rotation_params_rutishauser(apq, app, aqq):
    """Numerically stable small-angle rotation (|theta| <= pi/4): the root
    of smaller magnitude of t^2 + 2*tau*t - 1 = 0, tau = (app-aqq)/(2apq),
    sign-flipped to the R convention above."""
    safe = torch.abs(apq) > 0.0
    one = torch.ones_like(apq)
    tau = (app - aqq) / torch.where(safe, 2.0 * apq, one)
    sgn = torch.where(tau >= 0.0, one, -one)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(safe, -t, torch.zeros_like(t))
    # c = 1/sqrt(1 + t*t) rounded once, from float64.  Rounding the sqrt and
    # then the division in float32 leaves c^2 + s^2 above 1 on average, and
    # each coordinate takes ~n rotations a sweep: the eigenvalues then drift
    # 4x further from float64 than the reference's (whose XLA rsqrt rounds
    # once).  The CUDA kernel computes c the same way, bit for bit.
    c = (1.0 / torch.sqrt((1.0 + t * t).to(torch.float64))).to(t.dtype)
    s = t * c
    theta = torch.atan(t)
    return theta, c, s


# -- fixed-point CORDIC (mirrors the RTL datapath) ---------------------------

def _to_fixed(x: torch.Tensor) -> torch.Tensor:
    # x * 2^29 is exact in float32; torch.round is round-half-to-even
    return torch.round(x * float(_ONE)).to(torch.int32)


def _from_fixed(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / float(_ONE)


def _pow2_scale(mag: torch.Tensor) -> torch.Tensor:
    """2^-ceil(log2(mag)) for positive normal float32 ``mag``, built from
    the exponent bits, so it is exact and the same on every device.

    The reference spells it ``exp2(-ceil(log2(mag)))``; float log2 may
    round onto the wrong side of an integer just above a power of two, and
    XLA's CPU exp2 is not exact for integer exponents of magnitude 13 and
    up, so the reference's scale is off by up to 1e-6 there."""
    bits = mag.view(torch.int32)
    ceil_log2 = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    ceil_log2 = ceil_log2.clamp(-126, 126)
    return ((127 - ceil_log2) << 23).view(torch.float32)


def cordic_atan2(y, x, iters: int = CORDIC_ITERS):
    """Vectoring-mode CORDIC: atan2(y, x) for x of any sign.  The operands
    share a power-of-two normalisation into Q2.29 (a barrel shift in
    hardware), which leaves the angle unchanged."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    mag = torch.maximum(torch.abs(y), torch.abs(x)).clamp_min(1e-30)
    scale = _pow2_scale(mag)
    yn = y * scale
    xn = x * scale
    # quadrant fold: vectoring CORDIC converges for x > 0
    neg_x = xn < 0
    xi = _to_fixed(torch.where(neg_x, -xn, xn))
    yi = _to_fixed(torch.where(neg_x, -yn, yn))
    zi = torch.zeros_like(xi)
    for i in range(iters):
        d = torch.where(yi >= 0, 1, -1).to(torch.int32)
        xi, yi, zi = (xi + d * (yi >> i), yi - d * (xi >> i),
                      zi + d * int(_ATAN_FIXED[i]))
    ang = _from_fixed(zi)
    # unfold quadrant: atan2(y, x) = atan2(-y, -x) +/- pi
    pi = _f32(_PI, ang)
    return torch.where(neg_x, torch.where(y >= 0, ang + pi, ang - pi), ang)


def cordic_sincos(theta, iters: int = CORDIC_ITERS):
    """Rotation-mode CORDIC: (sin, cos) of theta in (-pi, pi]."""
    theta = theta.to(torch.float32)
    pi = _f32(_PI, theta)
    half_pi = _f32(_HALF_PI, theta)
    # fold into (-pi/2, pi/2]; CORDIC rotation converges for |z| < ~1.74
    fold_hi = theta > half_pi
    fold_lo = theta < -half_pi
    th = torch.where(fold_hi, theta - pi,
                     torch.where(fold_lo, theta + pi, theta))
    flip = fold_hi | fold_lo
    zi = _to_fixed(th)
    xi = torch.full_like(zi, _X0_FIXED)
    yi = torch.zeros_like(zi)
    for i in range(iters):
        d = torch.where(zi >= 0, 1, -1).to(torch.int32)
        xi, yi, zi = (xi - d * (yi >> i), yi + d * (xi >> i),
                      zi - d * int(_ATAN_FIXED[i]))
    sign = torch.where(flip, -1.0, 1.0).to(torch.float32)
    return _from_fixed(yi) * sign, _from_fixed(xi) * sign


def rotation_params_cordic(apq, app, aqq, iters: int = CORDIC_ITERS):
    """Paper datapath: CORDIC atan -> 1-bit right shift -> CORDIC sin/cos."""
    full = cordic_atan2(2.0 * apq, app - aqq, iters)
    theta = -0.5 * full
    s, c = cordic_sincos(theta, iters)
    return theta, c, s


ANGLE_MODES = {
    "atan2": rotation_params,
    "rutishauser": rotation_params_rutishauser,
    "cordic": rotation_params_cordic,
}
