"""The port's solvers against the JAX reference: ``jacobi_eigh`` /
``jacobi_svd`` for every pivot x rotation pair, odd n, the ``tol`` early
exit and ``track_history``; ``fit`` / ``transform`` (through ``convert``);
the batched solvers on zero-padded buckets with mixed ``n_active``.

The port runs on the CPU (``device="cpu"``), the reference with its
kernels in interpret mode or on its plain path.  Contracts:
  * eigenvalues / singular values: relative Frobenius 1e-5 against the
    reference (both are fp32 Jacobi solves; the fp32 ``eigh`` budget is
    1e-4 against float64);
  * eigenvectors / components: |cos| >= 1 - 1e-4 against the reference,
    column by column, where the spectrum has no near-ties;
  * inside the port, bitwise: padded coordinates stay exactly zero (and
    their eigenvectors exact basis vectors), and ``fused=True`` equals
    ``fused=False`` on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import dle as jdle
from repro.core import jacobi as jjacobi
from repro.core import pca as jpca
from repro.serving import batching as jbatching
from repro.serving import solver as jsolver
from repro_torch import convert
from repro_torch.core import dle as tdle
from repro_torch.core import jacobi as tjacobi
from repro_torch.core import pca as tpca
from repro_torch.core.precision import ERROR_BUDGETS
from repro_torch.serving import batching as tbatching
from repro_torch.serving import solver as tsolver

from _torch_parity import assert_contract, data, subspace_cos, sym

PIVOTS = ["parallel", "cyclic", "paper"]
ROTATIONS = ["rowcol", "matmul"]


def _spd(n: int, seed: int) -> np.ndarray:
    """A symmetric matrix with well-separated eigenvalues."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.geomspace(10.0, 0.1, n) * rng.choice([-1, 1], n)
    return ((q * w) @ q.T).astype(np.float32)


@pytest.mark.parametrize("rotation", ROTATIONS)
@pytest.mark.parametrize("pivot", PIVOTS)
def test_jacobi_eigh_matches_reference(pivot, rotation):
    C = _spd(10, seed=1)
    want = jjacobi.jacobi_eigh(C, sweeps=8, pivot=pivot, rotation=rotation)
    got = tjacobi.jacobi_eigh(torch.from_numpy(C), sweeps=8, pivot=pivot,
                              rotation=rotation)
    assert_contract(got.eigenvalues, want.eigenvalues, "rel_frobenius", 1e-5)
    assert subspace_cos(got.eigenvectors, want.eigenvectors).min() >= 1 - 1e-4
    assert float(got.off_norm) <= 1e-5


@pytest.mark.parametrize("n,tile", [(10, 4), (16, 8), (7, 7)])
def test_find_pivot_matches_reference(n, tile):
    """The DLE pivot of the "paper" solver: the same (p, q) and values,
    flat and tile by tile (ties are broken in row-major order)."""
    C = sym(n, seed=n)
    C[1, 4] = C[4, 1] = C[2, 5] = C[5, 2] = 9.0  # a tie: (1, 4) comes first
    for jfn, tfn in ((jdle.find_pivot, tdle.find_pivot),
                     (lambda c: jdle.find_pivot_tilewise(c, tile),
                      lambda c: tdle.find_pivot_tilewise(c, tile))):
        want = jfn(C)
        got = tfn(torch.from_numpy(C))
        assert (int(got.p), int(got.q)) == (int(want.p), int(want.q))
        for g, w in zip(got[2:], want[2:]):
            assert_contract(g, w, "bitwise")
    batch = tdle.find_pivot(torch.from_numpy(np.stack([C, C.T * 2])))
    assert batch.p.tolist() == [1, 1] and batch.q.tolist() == [4, 4]


@pytest.mark.parametrize("angle", ["rutishauser", "atan2", "cordic"])
def test_jacobi_eigh_angle_modes_and_odd_n(angle):
    C = _spd(9, seed=2)  # odd: the parallel schedule pads one coordinate
    want = jjacobi.jacobi_eigh(C, sweeps=10, angle=angle)
    got = tjacobi.jacobi_eigh(torch.from_numpy(C), sweeps=10, angle=angle)
    assert got.eigenvectors.shape == (9, 9)
    assert_contract(got.eigenvalues, want.eigenvalues, "rel_frobenius", 1e-5)
    assert subspace_cos(got.eigenvectors, want.eigenvectors).min() >= 1 - 1e-4
    w64 = np.linalg.eigvalsh(C.astype(np.float64))[::-1]
    assert_contract(got.eigenvalues, w64, "rel_frobenius",
                    ERROR_BUDGETS["fp32"]["eigh"])


def test_jacobi_eigh_tol_early_exit_and_history():
    C = _spd(12, seed=3)
    want = jjacobi.jacobi_eigh(C, sweeps=50, tol=1e-5)
    got = tjacobi.jacobi_eigh(torch.from_numpy(C), sweeps=50, tol=1e-5)
    assert float(got.off_norm) <= 1e-5 and got.history is None
    assert_contract(got.eigenvalues, want.eigenvalues, "rel_frobenius", 1e-5)
    hist = tjacobi.jacobi_eigh(torch.from_numpy(C), sweeps=6,
                               track_history=True).history
    hist_ref = jjacobi.jacobi_eigh(C, sweeps=6, track_history=True).history
    assert hist.shape == (7,)
    np.testing.assert_allclose(hist[:3].numpy(), np.asarray(hist_ref)[:3],
                               rtol=1e-3)
    # the early exit stops at the first sweep under tol: the history shows
    # that sweep, and running to it with no tol gives the same answer
    first = int(np.argmax(hist.numpy() <= 1e-5))
    fixed = tjacobi.jacobi_eigh(torch.from_numpy(C), sweeps=first)
    assert_contract(got.eigenvalues, fixed.eigenvalues, "bitwise")


@pytest.mark.parametrize("rotation", ROTATIONS)
@pytest.mark.parametrize("pivot", PIVOTS)
def test_jacobi_svd_matches_reference(pivot, rotation):
    A = data(20, 8, seed=4) * np.geomspace(3, 0.3, 8).astype(np.float32)
    kw = dict(sweeps=10, pivot=pivot, rotation=rotation)
    Uj, Sj, Vtj = jjacobi.jacobi_svd(A, **kw)
    U, S, Vt = tjacobi.jacobi_svd(torch.from_numpy(A), **kw)
    assert_contract(S, Sj, "rel_frobenius", 1e-5)
    assert subspace_cos(U, Uj).min() >= 1 - 1e-4
    assert subspace_cos(Vt.mT, np.asarray(Vtj).T).min() >= 1 - 1e-4
    U, S, Vt = tjacobi.jacobi_svd(torch.from_numpy(A), fused=True, **kw)
    assert_contract(S, Sj, "rel_frobenius", 1e-5)


@pytest.mark.parametrize("fused,backend", [(False, None), (True, None),
                                           (True, "torch"), (False, "torch")])
def test_fit_transform_matches_reference(fused, backend):
    X = data(120, 10, seed=5) * np.geomspace(3, 0.3, 10).astype(np.float32)
    jcfg = jpca.PCAConfig(sweeps=10, fused=fused,
                          backend=None if backend is None else "ref")
    tcfg = tpca.PCAConfig(sweeps=10, fused=fused, backend=backend)
    want = jpca.fit(X, jcfg)
    Y, got = tpca.fit_transform(X, 4, tcfg, device="cpu")
    assert_contract(got.eigenvalues, want.eigenvalues, "rel_frobenius", 1e-5)
    assert subspace_cos(got.components[:, :4],
                        np.asarray(want.components)[:, :4]).min() >= 1 - 1e-4
    assert_contract(got.cvcr, want.cvcr, "rel_frobenius", 1e-6)
    assert int(tpca.select_k(got.cvcr, 0.9)) == int(jpca.select_k(
        want.cvcr, 0.9))
    # the reference's fitted state, carried into the port, projects the same
    ported = convert.to_port(want, device="cpu")
    Yj = jpca.transform(X, want, 4, jcfg)
    assert_contract(tpca.transform(X, ported, 4, tcfg, device="cpu"), Yj,
                    "rel_frobenius", 1e-6)


def test_convert_every_result_type():
    X = data(30, 6, seed=6)
    res = convert.to_port(jpca.fit(X, jpca.PCAConfig(sweeps=4)), "cpu")
    assert isinstance(res, tpca.PCAResult)
    assert res.components.device.type == "cpu"
    eig = convert.to_port(jjacobi.jacobi_eigh(sym(5), sweeps=3), "cpu")
    assert isinstance(eig, tjacobi.EighResult) and eig.history is None
    batch, na = tbatching.stack_requests([sym(5), sym(3)], (5, 5))
    beig = convert.to_port(jsolver.jacobi_eigh_batched(batch, na[0],
                                                       sweeps=3), "cpu")
    assert isinstance(beig, tsolver.BatchedEighResult)
    with pytest.raises(TypeError):
        convert.to_port((1, 2), "cpu")


@pytest.mark.parametrize("mode,cap", [("tile", None), ("pow2", None),
                                      ("pow2", 64)])
def test_batching_copy_matches_reference(mode, cap):
    tp = tbatching.BucketPolicy(T=8, mode=mode, pow2_cap=cap)
    jp = jbatching.BucketPolicy(T=8, mode=mode, pow2_cap=cap)
    for n in (1, 7, 8, 9, 31, 65, 200):
        assert tp.bucket_dim(n) == jp.bucket_dim(n)
    mats = [data(5, 3, 1), data(11, 6, 2)]
    shape = tp.bucket_shape((11, 6))
    got = tbatching.stack_requests(mats, shape)
    want = jbatching.stack_requests(mats, shape)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")
    assert tbatching.padding_waste((5, 3), shape) == jbatching.padding_waste(
        (5, 3), shape)
    with pytest.raises(ValueError):
        tbatching.pad_to_bucket(mats[1], (8, 8))


def _bucket(mats, T=8):
    policy = tbatching.BucketPolicy(T=T)
    shape = tuple(max(d) for d in zip(*(policy.bucket_shape(m.shape)
                                        for m in mats)))
    return tbatching.stack_requests(mats, shape)


@pytest.mark.parametrize("fused", [False, True])
def test_eigh_batched_mixed_n_active(fused):
    mats = [_spd(n, seed=10 + n) for n in (16, 11, 7, 13)]
    batch, na = _bucket(mats)
    want = jsolver.jacobi_eigh_batched(batch, na[0], sweeps=10, fused=fused,
                                       fused_backend="interpret")
    got = tsolver.jacobi_eigh_batched(batch, na[0], sweeps=10, fused=fused,
                                      device="cpu")
    for i, m in enumerate(mats):
        n = m.shape[0]
        assert_contract(got.eigenvalues[i, :n], want.eigenvalues[i, :n],
                        "rel_frobenius", 1e-5)
        assert subspace_cos(got.eigenvectors[i, :n, :n],
                            np.asarray(want.eigenvectors)[i, :n, :n]
                            ).min() >= 1 - 1e-4
    assert_contract(got.n_active, na[0], "bitwise")


def test_svd_batched_mixed_shapes():
    mats = [data(m, n, seed=m) for m, n in ((20, 8), (14, 5), (9, 7))]
    batch, na = _bucket(mats)
    want = jsolver.jacobi_svd_batched(batch, na[0], na[1], sweeps=10)
    got = tsolver.jacobi_svd_batched(batch, na[0], na[1], sweeps=10,
                                     device="cpu")
    for i, m in enumerate(mats):
        n = m.shape[1]
        assert_contract(got.S[i, :n], want.S[i, :n], "rel_frobenius", 1e-5)
        assert subspace_cos(got.U[i, :m.shape[0], :n],
                            np.asarray(want.U)[i, :m.shape[0], :n]
                            ).min() >= 1 - 1e-4
        # padded U rows and the rcond-zeroed columns are exact zeros
        assert bool((got.U[i, m.shape[0]:, :] == 0).all())
        assert bool((got.U[i, :, n:] == 0).all())


def test_svd_batched_rank_deficient_zeroes_u():
    a = data(12, 3, seed=7)
    A = np.concatenate([a, a[:, :1]], axis=1)  # rank 3 of 4 columns
    got = tsolver.jacobi_svd_batched(A[None], sweeps=10, device="cpu")
    want = jsolver.jacobi_svd_batched(A[None], sweeps=10)
    assert_contract(got.S, want.S, "rel_frobenius", 1e-5)
    assert bool((got.U[0, :, 3] == 0).all())


@pytest.mark.parametrize("fused", [False, True])
def test_pca_fit_batched_and_transform(fused):
    mats = [data(m, d, seed=m) * np.geomspace(2, 0.2, d).astype(np.float32)
            for m, d in ((40, 8), (25, 6), (33, 8))]
    batch, na = _bucket(mats)
    jcfg = jpca.PCAConfig(sweeps=10, fused=fused,
                          backend="ref" if fused else None)
    tcfg = tpca.PCAConfig(sweeps=10, fused=fused)
    want = jsolver.pca_fit_batched(batch, na[0], na[1], config=jcfg)
    got = tsolver.pca_fit_batched(batch, na[0], na[1], config=tcfg,
                                  device="cpu")
    for i, m in enumerate(mats):
        d = m.shape[1]
        assert_contract(got.eigenvalues[i, :d], want.eigenvalues[i, :d],
                        "rel_frobenius", 1e-5)
        assert_contract(got.mean[i], want.mean[i], "rel_frobenius", 1e-6)
        assert_contract(got.scale[i, :d], want.scale[i, :d],
                        "rel_frobenius", 1e-6)
    Yj = jsolver.pca_transform_batched(batch, want, 3)
    Y = tsolver.pca_transform_batched(batch, convert.to_port(want, "cpu"), 3,
                                      device="cpu")
    assert_contract(Y, Yj, "rel_frobenius", 1e-5)


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_build_solver_fn_dispatch(op):
    mats = ([sym(6, 1), sym(4, 2)] if op == "eigh"
            else [data(9, 6, 1), data(7, 4, 2)])
    batch, na = _bucket(mats)
    cfg = tpca.PCAConfig(sweeps=6, fused=True)
    res = tsolver.build_solver_fn(op, cfg, device="cpu")(batch, na[0], na[-1])
    assert type(res).__name__ == {"eigh": "BatchedEighResult",
                                  "svd": "BatchedSVDResult",
                                  "pca": "BatchedPCAResult"}[op]
    with pytest.raises(ValueError):
        tsolver.build_solver_fn("qr", cfg)


@pytest.mark.parametrize("angle", ["rutishauser", "atan2", "cordic"])
@pytest.mark.parametrize("pivot", ["parallel", "cyclic"])
def test_padding_stays_exact_and_fused_equals_unfused(pivot, angle):
    """Inside the port, bitwise: a bucket's padded coordinates keep exact
    zero eigenvalues and exact basis eigenvectors, and the fused op path
    (one call per round) equals the unfused one."""
    mats = [sym(n, seed=n) for n in (10, 7, 4)]
    batch, na = _bucket(mats, T=5)
    runs = [tsolver.jacobi_eigh_batched(batch, na[0], sweeps=6, pivot=pivot,
                                        angle=angle, fused=fused,
                                        device="cpu")
            for fused in (False, True)]
    assert_contract(runs[0].eigenvalues, runs[1].eigenvalues, "bitwise")
    assert_contract(runs[0].eigenvectors, runs[1].eigenvectors, "bitwise")
    nb = batch.shape[-1]
    eye = torch.eye(nb)
    for i, m in enumerate(mats):
        n = m.shape[0]
        V = runs[1].eigenvectors[i]
        assert bool((runs[1].eigenvalues[i, n:] == 0).all())
        assert bool((V[n:, :] == eye[n:, :]).all()
                    and (V[:, n:] == eye[:, n:]).all())


def test_batched_equals_single_problem_solves():
    """The written-out batch dimension solves each problem as the
    single-problem entry point does, bitwise."""
    mats = np.stack([_spd(8, seed=s) for s in range(3)])
    res = tsolver.jacobi_eigh_batched(mats, sweeps=6, fused=True,
                                      device="cpu")
    for b in range(3):
        one = tjacobi.jacobi_eigh(torch.from_numpy(mats[b]), sweeps=6,
                                  fused=True)
        assert_contract(res.eigenvalues[b], one.eigenvalues, "bitwise")
        assert_contract(res.eigenvectors[b], one.eigenvectors, "bitwise")
