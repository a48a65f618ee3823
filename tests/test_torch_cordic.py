"""Parity of the port's rotation angles and pivot schedules with the JAX
reference (``repro_torch.core.cordic`` / ``core.jacobi`` vs ``repro``).

Contracts:
  * Q2.29 CORDIC (``cordic_atan2``, ``cordic_sincos``,
    ``rotation_params_cordic``): bitwise where the reference's power-of-two
    normalisation is exact -- operand magnitudes in (2^-13, 2^12]; outside
    it XLA's CPU exp2 is off by up to 1e-6 at integer exponents, while the
    port builds the power of two from the exponent bits (tested exact);
  * Rutishauser and atan2 (c, s): at most 2^-23 apart, one ulp at 1.0,
    the scale a rotation works at (elementwise the Rutishauser pair is at
    most 3 ulp apart: XLA contracts and rounds its rsqrt differently; the
    reference's atan2-mode cos near pi/2 and torch's differ by more ulps of
    a tiny c, never by more than 2^-23);
  * ``round_robin_rounds`` / ``cyclic_pairs``: identical arrays;
  * the CUDA sweep kernel's Q2.29 constants equal the port's.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import cordic as jcordic
from repro.core import jacobi as jjacobi
from repro_torch.core import cordic as tcordic
from repro_torch.core import jacobi as tjacobi

from _torch_parity import assert_contract

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
        / "csrc")


def _pivots(count=4096, seed=0, span=(-6, 7)):
    """(apq, app, aqq) over the decades of ``span``, with exact zeros and
    equal diagonals among them."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(*span, count)
    apq = rng.standard_normal(count) * scale
    app = rng.standard_normal(count) * scale * 3
    aqq = rng.standard_normal(count) * scale
    apq[::17] = 0.0
    aqq[::13] = app[::13]
    return [a.astype(np.float32) for a in (apq, app, aqq)]


def _both(fn_jax, fn_port, *arrays):
    want = fn_jax(*arrays)
    got = fn_port(*(torch.from_numpy(a) for a in arrays))
    return got, want


def _exact_range(y, x):
    """Entries whose shared normalisation the reference computes exactly."""
    mag = np.maximum(np.abs(y), np.abs(x))
    return (mag > 2.0 ** -13) & (mag <= 2.0 ** 12)


@pytest.mark.parametrize("seed", [0, 1])
def test_cordic_rotation_params_bitwise(seed):
    apq, app, aqq = _pivots(seed=seed, span=(-3, 3))
    keep = _exact_range(2 * apq, app - aqq)
    assert keep.mean() > 0.9
    got, want = _both(jcordic.rotation_params_cordic,
                      tcordic.rotation_params_cordic,
                      apq[keep], app[keep], aqq[keep])
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_cordic_engines_bitwise():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 3, 4096))
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 3, 4096))
    y, x = y.astype(np.float32), x.astype(np.float32)
    x[::7] = -np.abs(x[::7])
    keep = _exact_range(y, x)
    got, want = _both(jcordic.cordic_atan2, tcordic.cordic_atan2, y[keep],
                      x[keep])
    assert_contract(got, want, "bitwise")
    theta = rng.uniform(-np.pi, np.pi, 2048).astype(np.float32)
    got, want = _both(jcordic.cordic_sincos, tcordic.cordic_sincos, theta)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_pow2_scale_is_exact():
    rng = np.random.default_rng(4)
    mag = np.abs(rng.standard_normal(4096)
                 * 10.0 ** rng.integers(-29, 30, 4096)).astype(np.float32)
    mag = np.concatenate([mag, 2.0 ** np.arange(-99, 100, dtype=np.float32),
                          np.float32(1e-30)[None]]).astype(np.float32)
    got = tcordic._pow2_scale(torch.from_numpy(mag)).numpy()
    want = 2.0 ** -np.ceil(np.log2(mag.astype(np.float64)))
    np.testing.assert_array_equal(got.astype(np.float64), want)


@pytest.mark.parametrize("angle", ["rutishauser", "atan2"])
def test_float_angles_within_one_ulp_of_one(angle):
    got, want = _both(jcordic.ANGLE_MODES[angle], tcordic.ANGLE_MODES[angle],
                      *_pivots(seed=5))
    for g, w in zip(got[1:], want[1:]):
        diff = np.abs(g.numpy().astype(np.float64) - np.asarray(w))
        assert diff.max() <= 2.0 ** -23
    if angle == "rutishauser":
        for g, w in zip(got[1:], want[1:]):
            assert_contract(g, w, "ulp", 3)


@pytest.mark.parametrize("angle", ["rutishauser", "atan2", "cordic"])
def test_angles_annihilate_the_pivot(angle):
    """R^T C R with the port's (c, s) zeroes c_pq to fp32 rounding."""
    apq, app, aqq = (torch.from_numpy(a) for a in _pivots(512, seed=7))
    _, c, s = tcordic.ANGLE_MODES[angle](apq, app, aqq)
    c, s, apq, app, aqq = (t.double() for t in (c, s, apq, app, aqq))
    new_pq = (c * c - s * s) * apq + c * s * (app - aqq)
    scale = torch.maximum(torch.maximum(apq.abs(), app.abs()), aqq.abs())
    tol = 1e-6 if angle != "cordic" else 1e-5
    assert bool((new_pq.abs() <= tol * scale.clamp_min(1e-30)).all())


def test_cordic_constants_match_reference_and_kernel():
    np.testing.assert_array_equal(tcordic._ATAN_FIXED, jcordic._ATAN_FIXED)
    assert tcordic.CORDIC_ITERS == jcordic.CORDIC_ITERS == 30
    # the core solver's seed round(f32(1/K) * 2^29), not the standalone
    # kernel's round(2^29 / K)
    seed = int(np.asarray(jcordic._to_fixed(np.float32(1.0 / jcordic._GAIN))))
    assert tcordic._X0_FIXED == seed == 326016448
    # the table is shared by both CORDIC kernels (cordic.cuh); the core's
    # seed is the sweep kernel's
    shared = (CSRC / "cordic.cuh").read_text()
    table = re.search(r"kAtanFixed\[CORDIC_ITERS\] = \{([^}]*)\}", shared)
    assert [int(v) for v in table.group(1).split(",")] == list(
        tcordic._ATAN_FIXED)
    src = (CSRC / "jacobi_sweep.cu").read_text()
    assert re.search(r"kX0Fixed = (\d+);", src).group(1) == str(seed)


@pytest.mark.parametrize("n", [2, 4, 8, 10, 16, 32])
def test_round_robin_rounds_identical(n):
    got = tjacobi.round_robin_rounds(n)
    want = jjacobi.round_robin_rounds(n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 7, 16])
def test_cyclic_pairs_identical(n):
    got = tjacobi.cyclic_pairs(n)
    want = jjacobi.cyclic_pairs(n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_round_robin_rejects_odd_n():
    with pytest.raises(ValueError):
        tjacobi.round_robin_rounds(7)
