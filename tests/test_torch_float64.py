"""Numpy float64 input, as numpy makes it by default, through both packages.

The reference runs with x64 off, so ``jnp.asarray`` narrows float64 to
float32 and every entry point computes and returns float32.  The port
takes floating input the same way (``_device.as_input``): float32 and
bfloat16 kept, anything else as float32, except under
``precision="fp64"``, the port's native float64 lane, where it computes in
float64.  Contracts: the port's dtypes equal the reference's; eigenvalues
and singular values within ``ERROR_BUDGETS`` of float64 numpy and of the
reference; the fp64 lane within 1e-12 of float64 numpy; a float32 tensor
passes through without a copy.
"""
import numpy as np
import pytest
import torch

from repro.core import jacobi as jjacobi
from repro.core import pca as jpca
from repro.serving import batching as jbatching
from repro.serving import solver as jsolver
from repro_torch import _device
from repro_torch.core import jacobi as tjacobi
from repro_torch.core import pca as tpca
from repro_torch.core.precision import ERROR_BUDGETS
from repro_torch.serving import solver as tsolver

from _torch_parity import rel_frobenius, to_numpy

SWEEPS = 12


def _data64(m=300, d=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, d)) * np.geomspace(3.0, 0.3, d)


def _pca_eigs64(X):
    Xs = (X - X.mean(axis=0)) / X.std(axis=0)
    return np.linalg.eigvalsh(Xs.T @ Xs)[::-1]


def _dtype_name(a) -> str:
    return str(to_numpy(a).dtype)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("fused", [False, True])
def test_fit_transform_takes_float64_as_the_reference_does(fused, precision):
    X = _data64()
    assert X.dtype == np.float64
    Yj, rj = jpca.fit_transform(X, 4, jpca.PCAConfig(
        fused=fused, precision=precision, sweeps=SWEEPS))
    Yt, rt = tpca.fit_transform(X, 4, tpca.PCAConfig(
        fused=fused, precision=precision, sweeps=SWEEPS), device="cpu")
    assert _dtype_name(Yt) == _dtype_name(Yj) == "float32"
    for field in rj._fields:
        assert _dtype_name(getattr(rt, field)) == _dtype_name(
            getattr(rj, field)), field
    budget = ERROR_BUDGETS[precision]["eigh"]
    assert rel_frobenius(rt.eigenvalues, _pca_eigs64(X)) <= budget
    assert rel_frobenius(rt.eigenvalues, rj.eigenvalues) <= budget
    assert Yt.shape == (300, 4) and bool(torch.isfinite(Yt).all())


@pytest.mark.parametrize("fused", [False, True])
def test_fp64_lane_computes_in_float64(fused):
    X = _data64(seed=1)
    Y, res = tpca.fit_transform(X, 4, tpca.PCAConfig(
        fused=fused, precision="fp64", sweeps=SWEEPS), device="cpu")
    assert Y.dtype == torch.float64
    assert all(getattr(res, f).dtype == torch.float64 for f in res._fields)
    assert rel_frobenius(res.eigenvalues, _pca_eigs64(X)) <= 1e-12
    # float32 input joins the lane as float64 too
    res32 = tpca.fit(X.astype(np.float32), tpca.PCAConfig(
        fused=fused, precision="fp64", sweeps=SWEEPS), device="cpu")
    assert res32.eigenvalues.dtype == torch.float64


def test_float64_tensor_input_is_narrowed_like_numpy():
    X = _data64(seed=2)
    got = tpca.fit(torch.from_numpy(X), tpca.PCAConfig(sweeps=SWEEPS))
    want = tpca.fit(X.astype(np.float32), tpca.PCAConfig(sweeps=SWEEPS),
                    device="cpu")
    assert got.eigenvalues.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got.eigenvalues),
                                  to_numpy(want.eigenvalues))


def test_single_problem_solvers_take_float64_as_float32():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((12, 12))
    C = (g + g.T) / 2
    want = jjacobi.jacobi_eigh(C, sweeps=SWEEPS)
    got = tjacobi.jacobi_eigh(C, sweeps=SWEEPS, device="cpu")
    assert _dtype_name(got.eigenvalues) == _dtype_name(want.eigenvalues)
    assert rel_frobenius(got.eigenvalues, want.eigenvalues) <= 1e-5
    assert rel_frobenius(got.eigenvalues, np.linalg.eigvalsh(C)[::-1]) \
        <= ERROR_BUDGETS["fp32"]["eigh"]
    A = rng.standard_normal((30, 10))
    Uj, sj, Vj = jjacobi.jacobi_svd(A, sweeps=SWEEPS)
    Ut, st, Vt = tjacobi.jacobi_svd(A, sweeps=SWEEPS, device="cpu")
    for g_, w_ in ((Ut, Uj), (st, sj), (Vt, Vj)):
        assert _dtype_name(g_) == _dtype_name(w_) == "float32"
    assert rel_frobenius(st, np.linalg.svd(A, compute_uv=False)) \
        <= ERROR_BUDGETS["fp32"]["svd"]


def _bucket_batch(op: str, seed: int = 4):
    """A float64 (B, 16, 16) bucket of mixed true sizes for ``op``."""
    rng = np.random.default_rng(seed)
    mats = []
    for n in (5, 9, 12):
        if op == "eigh":
            g = rng.standard_normal((n, n))
            mats.append((g + g.T) / 2)
        else:
            mats.append(rng.standard_normal((n + 3, n)))
    shape = jbatching.BucketPolicy(T=16).bucket_shape(
        (16, 16) if op == "eigh" else (15, 12))
    batch, n_active = jbatching.stack_requests(mats, shape)
    return mats, batch.astype(np.float64), n_active


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_batched_solvers_take_float64_as_the_reference_does(op):
    mats, batch, n_active = _bucket_batch(op)
    assert batch.dtype == np.float64
    want = jsolver.build_solver_fn(op, jpca.PCAConfig(sweeps=SWEEPS))(
        batch, n_active[0], n_active[-1])
    got = tsolver.build_solver_fn(op, tpca.PCAConfig(sweeps=SWEEPS),
                                  device="cpu")(batch, n_active[0],
                                                n_active[-1])
    for field in want._fields:
        assert _dtype_name(getattr(got, field)) == _dtype_name(
            getattr(want, field)), field
    values = "S" if op == "svd" else "eigenvalues"
    budget = ERROR_BUDGETS["fp32"]["svd" if op == "svd" else "eigh"]
    for i, a in enumerate(mats):
        n = a.shape[1]
        g = to_numpy(getattr(got, values))[i, :n]
        assert rel_frobenius(g, to_numpy(getattr(want, values))[i, :n]) \
            <= budget
        if op == "eigh":
            ref = np.linalg.eigvalsh(a)[::-1]
        elif op == "svd":
            ref = np.linalg.svd(a, compute_uv=False)
        else:
            ref = _pca_eigs64(a)
        assert rel_frobenius(g, ref) <= budget, (op, i)


def test_batched_transform_takes_float64_as_the_reference_does():
    mats, batch, n_active = _bucket_batch("pca", seed=5)
    cfg_j, cfg_t = jpca.PCAConfig(sweeps=SWEEPS), tpca.PCAConfig(sweeps=SWEEPS)
    fit_j = jsolver.pca_fit_batched(batch, n_active[0], n_active[1], cfg_j)
    fit_t = tsolver.pca_fit_batched(batch, n_active[0], n_active[1], cfg_t,
                                    device="cpu")
    want = jsolver.pca_transform_batched(batch, fit_j, 3)
    got = tsolver.pca_transform_batched(batch, fit_t, 3, device="cpu")
    assert _dtype_name(got) == _dtype_name(want) == "float32"
    for i, a in enumerate(mats):
        m = a.shape[0]
        g, w = to_numpy(got)[i, :m], to_numpy(want)[i, :m]
        # components up to sign, column by column
        assert np.allclose(np.abs(g), np.abs(w), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind,precision,want", [
    (np.float64, "fp32", torch.float32),
    (np.float64, "bf16_fp32acc", torch.float32),
    (np.float64, "fp64", torch.float64),
    (np.float32, "fp64", torch.float64),
    (np.float16, "fp32", torch.float32),
    (np.int32, "fp32", torch.int32),
    (torch.float64, "fp32", torch.float32),
    (torch.float16, "fp32", torch.float32),
    (torch.bfloat16, "fp32", torch.bfloat16),
    (torch.bfloat16, "fp64", torch.float64),
])
def test_as_input_dtype_rule(kind, precision, want):
    a = np.arange(6).reshape(2, 3)
    x = (torch.from_numpy(a).to(kind) if isinstance(kind, torch.dtype)
         else a.astype(kind))
    got = _device.as_input(x, "cpu", precision)
    assert got.dtype == want
    np.testing.assert_array_equal(got.float().numpy(), a)


def test_float32_tensor_keeps_its_storage():
    x = torch.randn(40, 6)
    assert _device.as_input(x) is x
    assert _device.as_input(x, "cpu") is x
    b = x.bfloat16()
    assert _device.as_input(b) is b
    assert _device.as_input(x, precision="bf16_fp32acc") is x
