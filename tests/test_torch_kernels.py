"""The port's kernel ops (``repro_torch.kernels.ops``) against the JAX
reference's (``repro.kernels.ops``).

On the CPU the ops run their plain versions (``kernels.ref``); the JAX side
runs its Pallas kernels in interpret mode, as the reference's own tests do.
Contracts:
  * ``jacobi_sweep`` (one pivot round, every angle mode, both the
    ``parallel`` and the ``cyclic`` pair sets): 1e-6 of the largest entry
    -- the angles differ by at most 2^-23 (see test_torch_cordic) and XLA
    may contract the rotation into FMAs;
  * ``covariance``: relative Frobenius 1e-6 under fp32 (sums in another
    order), and within ``ERROR_BUDGETS`` of float64 under bf16_fp32acc;
  * ``mm_engine_matmul``: relative Frobenius 1e-6.
The kernels themselves are held against their plain versions on the card
in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import jacobi as jjacobi
from repro.kernels import ops as jops
from repro_torch.core import precision as tprec
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops

from _torch_parity import assert_contract, data, rel_frobenius, sym

ANGLES = ["rutishauser", "atan2", "cordic"]


def _pairs(kind: str, n: int) -> np.ndarray:
    if kind == "parallel":
        return jjacobi.round_robin_rounds(n)[n // 3]
    return jjacobi.cyclic_pairs(n)[n // 2]


def _rel_max(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# -- jacobi_sweep -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["parallel", "cyclic"])
@pytest.mark.parametrize("angle", ANGLES)
def test_jacobi_sweep_round_matches_reference(angle, kind):
    n = 12
    C = sym(n, seed=1)
    V = data(n, n, seed=2)
    pairs = _pairs(kind, n)
    Cj, Vj = jops.jacobi_sweep(C, V, pairs, angle=angle, backend="interpret")
    Ct, Vt = tops.jacobi_sweep(torch.from_numpy(C), torch.from_numpy(V),
                               torch.from_numpy(pairs), angle=angle)
    assert _rel_max(Ct, Cj) <= 1e-6
    assert _rel_max(Vt, Vj) <= 1e-6
    # the plain version of the registry op is the reference's oracle too
    Cr, Vr = jops.jacobi_sweep(C, V, pairs, angle=angle, backend="ref")
    assert _rel_max(Ct, Cr) <= 1e-6 and _rel_max(Vt, Vr) <= 1e-6


@pytest.mark.parametrize("angle", ANGLES)
def test_jacobi_sweep_batch_is_each_problem(angle):
    """A (B, n, n) round equals the B single-problem rounds, bitwise."""
    n = 10
    C = np.stack([sym(n, seed=s) for s in range(3)])
    V = np.stack([data(n, n, seed=10 + s) for s in range(3)])
    pairs = torch.from_numpy(_pairs("parallel", n))
    Cb, Vb = tops.jacobi_sweep(torch.from_numpy(C), torch.from_numpy(V),
                               pairs, angle=angle)
    for b in range(3):
        Cs, Vs = tops.jacobi_sweep(torch.from_numpy(C[b]),
                                   torch.from_numpy(V[b]), pairs,
                                   angle=angle)
        assert_contract(Cb[b], Cs, "bitwise")
        assert_contract(Vb[b], Vs, "bitwise")


@pytest.mark.parametrize("angle", ANGLES)
def test_jacobi_sweep_keeps_padding_exact(angle):
    """A zero-padded coordinate never mixes: after a full sweep the padded
    rows/cols of C are exactly zero and V's padded block is exactly I."""
    n, live = 12, 9
    C = np.zeros((n, n), np.float32)
    C[:live, :live] = sym(live, seed=3)
    Ct = torch.from_numpy(C)
    Vt = torch.eye(n)
    for pairs in jjacobi.round_robin_rounds(n):
        Ct, Vt = tops.jacobi_sweep(Ct, Vt, torch.from_numpy(pairs),
                                   angle=angle)
    assert bool((Ct[live:, :] == 0).all() and (Ct[:, live:] == 0).all())
    eye = torch.eye(n)
    assert bool((Vt[live:, :] == eye[live:, :]).all()
                and (Vt[:, live:] == eye[:, live:]).all())


# -- covariance -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 12), (33, 7), (200, 16)])
def test_covariance_fp32_matches_reference(shape):
    x = data(*shape, seed=4)
    want = jops.covariance(x, block_m=32, backend="interpret")
    got = tops.covariance(torch.from_numpy(x), block_m=32)
    assert got.dtype == torch.float32
    assert_contract(got, want, "rel_frobenius", 1e-6)
    assert_contract(got, jops.covariance(x, backend="ref"), "rel_frobenius",
                    1e-6)


@pytest.mark.parametrize("shape", [(64, 12), (200, 16)])
def test_covariance_bf16_within_budget(shape):
    x = data(*shape, seed=5)
    x64 = x.astype(np.float64)
    budget = tprec.ERROR_BUDGETS["bf16_fp32acc"]["covariance"]
    got = tops.covariance(torch.from_numpy(x), precision="bf16_fp32acc")
    want = jops.covariance(x, block_m=32, precision="bf16_fp32acc",
                           backend="interpret")
    assert got.dtype == torch.float32
    assert rel_frobenius(got, x64.T @ x64) <= budget
    # the same bf16 operands, products exact in fp32: only the order differs
    assert_contract(got, want, "rel_frobenius", 1e-6)


def test_covariance_batched_and_normalized():
    x = np.stack([data(40, 6, seed=s) for s in range(3)])
    got = tops.covariance(torch.from_numpy(x), normalize=True)
    for b in range(3):
        want = jops.covariance(x[b], normalize=True, backend="ref")
        assert_contract(got[b], want, "rel_frobenius", 1e-6)


def test_cov_block_m_matches_reference():
    for m, bm in [(1, 1024), (7, 1024), (70000, 1024), (100, 64), (0, 8)]:
        assert tops._cov_block_m(m, bm) == jops._cov_block_m(m, bm)


@pytest.mark.parametrize("m,n,batch", [(70000, 784, 1), (2048, 256, 32),
                                       (5, 3, 1), (100000, 64, 4),
                                       (7000, 784, 1), (1000, 70, 3)])
def test_cov_splits_cover_the_sample_axis(m, n, batch):
    """The m-axis split of the Gram kernel: whole panels, every row once,
    enough blocks to fill the card in one wave of its 128-edge tiles."""
    block = tops._cov_block_m(m, 1024)
    splits = tfused.cov_splits(m, n, batch, block, sms=132)
    most = -(-m // block)
    assert 1 <= splits <= most
    tiles = -(-n // tfused.COV_TILE)
    blocks = batch * tiles * (tiles + 1) // 2
    slots = tfused.COV_BLOCKS_PER_SM * 132
    # one wave of COV_BLOCKS_PER_SM blocks an SM (on the H100 at
    # 70000 x 784 it beat two and four waves): every block fits in it ...
    assert blocks * splits <= max(slots, blocks)
    # ... and fills it as far as whole slices allow, every SM busy
    assert blocks * splits >= min(slots - blocks + 1, blocks * most)
    assert blocks * splits >= min(132, blocks * most)
    # the slices the wrapper launches: whole panels, each row in one slice
    count, per = tfused.cov_slices(m, n, batch, block, sms=132)
    assert count <= splits and per % block == 0
    assert count * per >= m and (count - 1) * per < m


# -- mm_engine_matmul -------------------------------------------------------

@pytest.mark.parametrize("shapes", [((16, 8), (8, 12)), ((37, 19), (19, 23)),
                                    ((130, 64), (64, 5))])
def test_mm_engine_matches_reference(shapes):
    a = data(*shapes[0], seed=6)
    b = data(*shapes[1], seed=7)
    want = jops.mm_engine_matmul(a, b, block=16, backend="interpret")
    got = tops.mm_engine_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert_contract(got, want, "rel_frobenius", 1e-6)


def test_mm_engine_batched_bf16_and_views():
    a = torch.from_numpy(np.stack([data(9, 5, seed=s) for s in range(2)]))
    b = torch.from_numpy(data(5, 4, seed=8))
    got = tops.mm_engine_matmul(a, b)
    for i in range(2):
        want = jops.mm_engine_matmul(a[i].numpy(), b.numpy(), backend="ref")
        assert_contract(got[i], want, "rel_frobenius", 1e-6)
    got = tops.mm_engine_matmul(a.bfloat16(), b.bfloat16())
    assert got.dtype == torch.bfloat16  # a's dtype, fp32 accumulation
    assert_contract(got.float(), (a.bfloat16().float() @ b.bfloat16().float()
                                  ).bfloat16().float(), "bitwise")
