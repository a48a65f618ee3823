"""The rest of the first slice against the reference: ``core.schedule``
(the sweep schedule, the convergence study and its ill-conditioned data),
``precision.rel_frobenius``, the error budgets of ``tests/test_precision``
and the 50-sweep schedule of ``tests/test_jacobi``, and the port's native
fp64 lane against the reference's float64 oracle subprocess.

Contracts: ``make_ill_conditioned`` and ``sweeps_to_tolerance`` identical
(both pure numpy); ``convergence_curve`` starts at the reference's value
(relative 1e-5) and reaches 1e-5 within one sweep of it (XLA's and
PyTorch's float math round differently, and with a standardized Gram's
equal diagonals that flips the sign of near-zero Rutishauser angles, so the
paths part after the first sweep while both converge); the fp32 and
bf16_fp32acc budgets of ``ERROR_BUDGETS`` against float64 numpy; the fp64
lane within 1e-12 of the oracle.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import jacobi as jjacobi
from repro.core import precision as jprec
from repro.core import schedule as jschedule
from repro_torch.core.covariance import covariance as tcovariance
from repro_torch.core import jacobi as tjacobi
from repro_torch.core import precision as tprec
from repro_torch.core import schedule as tschedule
from repro_torch.kernels import ops as tops

from _torch_parity import rel_frobenius, to_numpy

# the reference precision tests' data (tests/test_precision.py)
M, N, SWEEPS = 256, 12, 20


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(42)
    base = rng.standard_normal((M, N))
    return (base * np.logspace(0, -2, N)[None, :]).astype(np.float32)


def test_sweep_schedule_matches_the_reference():
    assert dataclasses.asdict(tschedule.PAPER_SCHEDULE) == \
        dataclasses.asdict(jschedule.PAPER_SCHEDULE)
    assert tschedule.SweepSchedule().kwargs() == \
        jschedule.SweepSchedule().kwargs() == {"sweeps": 50, "tol": None}
    s = tschedule.SweepSchedule(sweeps=7, tol=1e-6)
    assert s.kwargs() == jschedule.SweepSchedule(sweeps=7, tol=1e-6).kwargs()


@pytest.mark.parametrize("n,d,gap,seed", [(200, 12, 1e-6, 0), (64, 7, 1e-3, 1),
                                          (500, 32, 1e-6, 2), (10, 1, 0.1, 3)])
def test_make_ill_conditioned_is_the_reference(n, d, gap, seed):
    want = jschedule.make_ill_conditioned(n, d, gap, seed)
    got = tschedule.make_ill_conditioned(n, d, gap, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tol", [1e-2, 1e-6, 1e-9, 0.0])
def test_sweeps_to_tolerance_is_the_reference(tol):
    curve = np.array([0.3, 0.1, 2e-3, 4e-6, 3e-8, 3e-8], np.float32)
    assert tschedule.sweeps_to_tolerance(curve, tol) == \
        jschedule.sweeps_to_tolerance(curve, tol)


@pytest.mark.parametrize("pivot,angle", [("parallel", "rutishauser"),
                                         ("cyclic", "rutishauser"),
                                         ("paper", "rutishauser"),
                                         ("parallel", "atan2"),
                                         ("parallel", "cordic")])
def test_convergence_curve_follows_the_reference(pivot, angle):
    X = jschedule.make_ill_conditioned(200, 12, seed=1)
    want = jschedule.convergence_curve(X, sweeps=10, pivot=pivot, angle=angle)
    got = tschedule.convergence_curve(X, sweeps=10, pivot=pivot, angle=angle,
                                      device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape == (11,)
    assert abs(got[0] - want[0]) <= 1e-5 * want[0]
    assert abs(tschedule.sweeps_to_tolerance(got, 1e-5)
               - jschedule.sweeps_to_tolerance(want, 1e-5)) <= 1
    assert got[-1] <= 1e-6 and want[-1] <= 1e-6
    # float64 input is taken as float32, as the reference's jnp.asarray
    np.testing.assert_array_equal(
        tschedule.convergence_curve(X.astype(np.float64), sweeps=10,
                                    pivot=pivot, angle=angle, device="cpu"),
        got)


def _sym(n, seed=0, cond=None):
    """``tests/test_jacobi.py``'s matrix maker."""
    rng = np.random.default_rng(seed)
    if cond is None:
        a = rng.standard_normal((n, n)).astype(np.float32)
        return (a + a.T) / 2
    eigs = np.geomspace(1.0, 1.0 / cond, n)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * eigs) @ q.T


@pytest.mark.parametrize("fused", [False, True])
def test_fixed_50_sweep_schedule_ill_conditioned(fused):
    """Paper Sec. VII-D, as ``tests/test_jacobi.py`` holds the reference:
    the 50-sweep factor of safety covers clustered spectra; well-conditioned
    data converges in 10-15."""
    c = _sym(32, 4, cond=1e6).astype(np.float32)
    want = jjacobi.jacobi_eigh(c, sweeps=50, track_history=True)
    res = tjacobi.jacobi_eigh(c, sweeps=50, track_history=True, fused=fused,
                              device="cpu")
    hist = to_numpy(res.history)
    assert hist.shape == (51,)
    assert hist[-1] < 1e-6
    assert (hist < 1e-6).argmax() <= 15
    assert abs((hist < 1e-6).argmax()
               - (np.asarray(want.history) < 1e-6).argmax()) <= 1
    assert rel_frobenius(res.eigenvalues, want.eigenvalues) <= 1e-5


@pytest.mark.parametrize("shape,seed", [((5,), 0), ((4, 6), 1), ((3, 3, 3), 2)])
def test_rel_frobenius_is_the_reference(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = a + 1e-3 * rng.standard_normal(shape)
    assert tprec.rel_frobenius(a, b) == jprec.rel_frobenius(a, b)
    assert tprec.rel_frobenius(a, np.zeros(shape)) == \
        jprec.rel_frobenius(a, np.zeros(shape))


# -- ERROR_BUDGETS against float64 numpy (tests/test_precision.py) ----------

@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_covariance_budget(X, precision):
    C = tops.covariance(torch.from_numpy(X), block_m=64, precision=precision,
                        backend="torch")
    X64 = X.astype(np.float64)
    err = rel_frobenius(C, X64.T @ X64)
    assert err < tprec.ERROR_BUDGETS[precision]["covariance"], err


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_eigh_budget(X, precision):
    C = tops.covariance(torch.from_numpy(X), block_m=64, precision=precision,
                        backend="torch")
    res = tjacobi.jacobi_eigh(C, sweeps=SWEEPS)
    X64 = X.astype(np.float64)
    err = rel_frobenius(res.eigenvalues, np.linalg.eigvalsh(X64.T @ X64)[::-1])
    assert err < tprec.ERROR_BUDGETS[precision]["eigh"], err


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_svd_budget(X, precision):
    _, s, _ = tjacobi.jacobi_svd(torch.from_numpy(X), sweeps=SWEEPS,
                                 fused=True, fused_backend="torch",
                                 precision=precision)
    want = np.linalg.svd(X.astype(np.float64), compute_uv=False)
    err = rel_frobenius(s, want)
    assert err < tprec.ERROR_BUDGETS[precision]["svd"], err


@pytest.mark.parametrize("op", ["eigh", "svd"])
def test_fp64_lane_matches_the_reference_oracle(X, op):
    """The port's native float64 against the reference's fp64 lane, which
    runs in a ``JAX_ENABLE_X64=1`` subprocess."""
    oracle = jprec.run_fp64_oracle(X, op, sweeps=SWEEPS)
    X64 = torch.from_numpy(X.astype(np.float64))
    if op == "eigh":
        res = tjacobi.jacobi_eigh(tcovariance(X64), sweeps=SWEEPS,
                                  precision="fp64")
        got, want = res.eigenvalues, oracle["eigenvalues"]
    else:
        _, got, _ = tjacobi.jacobi_svd(X.astype(np.float64), sweeps=SWEEPS,
                                       precision="fp64", device="cpu")
        want = oracle["S"]
    assert got.dtype == torch.float64
    assert rel_frobenius(got, want) <= 1e-12
