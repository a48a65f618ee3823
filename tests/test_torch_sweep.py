"""The ``jacobi_sweep`` op with a whole sweep in one call: ``pairs`` of shape
(R, k, 2) applies R rounds in order (one kernel launch on the card).

On the CPU the op runs its plain version, which loops over the rounds; the
JAX side runs the reference's Pallas round in interpret mode, once a round.
Contracts:
  * one (R, k, 2) call equals R (k, 2) calls, bitwise (the plain version
    is the definition of the kernels' result, which the card tests hold
    bitwise);
  * a full sweep against R reference rounds: 1e-6 of the largest entry a
    round (the per-round contract of ``test_torch_kernels.py``, where the
    angles differ by at most 2^-23 and XLA may contract the rotation into
    FMAs), so R * 1e-6 for the sweep;
  * padded coordinates of a bucket stay exactly zero after a sweep in one
    call;
  * ``_sweep_scan(fused=True)`` makes one op call a sweep;
  * ``fused.sweep_plan`` puts the flush's 64- and 128-wide buckets in
    shared memory and 256 and 784 on the grid, and never plans a grid
    larger than the resident blocks it is given.
"""
import numpy as np
import pytest
import torch

from repro.core import jacobi as jjacobi
from repro.kernels import ops as jops
from repro_torch.backends import registry
from repro_torch.core import jacobi as tjacobi
from repro_torch.core.cordic import ANGLE_MODES
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.serving import solver as tsolver

from _torch_parity import assert_contract, data, sym

ANGLES = ["rutishauser", "atan2", "cordic"]
# the H100's opt-in shared memory a block and SM count (the CUDA runtime's
# figures on the card)
H100_SMEM, H100_SMS = 232448, 132


def _rounds(kind: str, n: int) -> np.ndarray:
    if kind == "parallel":
        return tjacobi.round_robin_rounds(n)
    return tjacobi.cyclic_pairs(n)


def _case(n: int, batch=None, seed=0):
    if batch is None:
        return (torch.from_numpy(sym(n, seed=seed)),
                torch.from_numpy(data(n, n, seed=seed + 1)))
    return (torch.from_numpy(np.stack([sym(n, seed=seed + s)
                                       for s in range(batch)])),
            torch.from_numpy(np.stack([data(n, n, seed=seed + 10 + s)
                                       for s in range(batch)])))


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("kind", ["parallel", "cyclic"])
@pytest.mark.parametrize("angle", ANGLES)
def test_one_call_equals_round_by_round(angle, kind, batch):
    n = 10
    C, V = _case(n, batch)
    rounds = torch.from_numpy(_rounds(kind, n))
    got = tops.jacobi_sweep(C, V, rounds, angle=angle)
    want = (C, V)
    for pairs in rounds:
        want = tops.jacobi_sweep(*want, pairs, angle=angle)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")
    # out of place: the caller's C and V are untouched
    assert_contract(C, _case(n, batch)[0], "bitwise")


@pytest.mark.parametrize("kind", ["parallel", "cyclic"])
@pytest.mark.parametrize("angle", ANGLES)
def test_full_sweep_matches_reference_rounds(angle, kind):
    n = 12
    C = sym(n, seed=1)
    V = data(n, n, seed=2)
    rounds = _rounds(kind, n)
    Cj, Vj = C, V
    for pairs in rounds:
        Cj, Vj = jops.jacobi_sweep(Cj, Vj, pairs, angle=angle,
                                   backend="interpret")
    Ct, Vt = tops.jacobi_sweep(torch.from_numpy(C), torch.from_numpy(V),
                               torch.from_numpy(rounds), angle=angle)
    tol = len(rounds) * 1e-6
    for g, w in ((Ct, Cj), (Vt, Vj)):
        w = np.asarray(w, np.float64)
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        assert err <= tol * np.abs(w).max(), (err, tol)


@pytest.mark.parametrize("angle", ANGLES)
def test_padded_bucket_stays_exact_after_a_sweep_in_one_call(angle):
    nb = 12
    live = (10, 7, 4)
    C = torch.zeros(len(live), nb, nb)
    for i, n in enumerate(live):
        C[i, :n, :n] = torch.from_numpy(sym(n, seed=n))
    V = torch.eye(nb).expand(len(live), nb, nb).contiguous()
    rounds = torch.from_numpy(tjacobi.round_robin_rounds(nb))
    Cs, Vs = tops.jacobi_sweep(C, V, rounds, angle=angle)
    eye = torch.eye(nb)
    for i, n in enumerate(live):
        assert bool((Cs[i, n:, :] == 0).all() and (Cs[i, :, n:] == 0).all())
        assert bool((Vs[i, n:, :] == eye[n:, :]).all()
                    and (Vs[i, :, n:] == eye[:, n:]).all())


@pytest.mark.parametrize("pivot", ["parallel", "cyclic"])
def test_fused_solve_makes_one_op_call_a_sweep(pivot):
    C = torch.from_numpy(sym(9, seed=3))  # odd: parallel pads to 10
    registry.reset_resolution_counts()
    res = tjacobi.jacobi_eigh(C, sweeps=5, pivot=pivot, fused=True,
                              track_history=True)
    assert registry.resolution_counts() == {("jacobi_sweep", "torch"): 5}
    assert res.history.shape[0] == 6
    registry.reset_resolution_counts()
    batch = np.stack([sym(8, seed=s) for s in range(3)])
    tsolver.jacobi_eigh_batched(batch, sweeps=4, pivot=pivot, fused=True,
                                device="cpu")
    assert registry.resolution_counts() == {("jacobi_sweep", "torch"): 4}
    # the early exit: one call a sweep until every problem has converged
    registry.reset_resolution_counts()
    res = tjacobi.jacobi_eigh(C, sweeps=30, pivot=pivot, fused=True,
                              tol=1e-5)
    calls = registry.resolution_counts()[("jacobi_sweep", "torch")]
    assert 1 <= calls < 30 and float(res.off_norm) <= 1e-5


def test_fused_sweep_equals_unfused_scan():
    """``_sweep_scan``: the one-call fused sweep is bitwise the unfused
    Python loop over rounds."""
    C, V = _case(10, batch=2, seed=4)
    rounds = torch.from_numpy(tjacobi.round_robin_rounds(10))
    fn = ANGLE_MODES["rutishauser"]
    fused = tjacobi._sweep_scan(C, V, rounds, fn, "rowcol", None, fused=True)
    loop = tjacobi._sweep_scan(C, V, rounds, fn, "rowcol", None)
    for g, w in zip(fused, loop):
        assert_contract(g, w, "bitwise")


@pytest.mark.parametrize("n", [64, 66, 128])
def test_plan_puts_small_buckets_in_shared_memory(n):
    plan = tfused.sweep_plan(32, n, n // 2, H100_SMEM, H100_SMS, 4)
    assert plan.kernel is tfused.JACOBI_SWEEP_SMEM
    assert plan.grid == 32  # one block a problem
    assert tfused.sweep_smem_bytes(n, n // 2) <= H100_SMEM


@pytest.mark.parametrize("batch,n", [(32, 256), (1, 784), (4, 784),
                                     (1, 1024)])
def test_plan_puts_large_problems_on_the_grid(batch, n):
    for per_sm in (1, 2, 4):
        plan = tfused.sweep_plan(batch, n, n // 2, H100_SMEM, H100_SMS,
                                 per_sm)
        assert plan.kernel is tfused.JACOBI_SWEEP
        assert 1 <= plan.grid <= per_sm * H100_SMS
    rows, cols = tfused.SWEEP_TILE
    units = n // 2
    tiles = batch * -(-units // rows) * -(-units // cols)
    assert tfused.sweep_plan(batch, n, n // 2, H100_SMEM, H100_SMS,
                             4).grid == min(tiles, 4 * H100_SMS)


def test_plan_never_exceeds_the_resident_blocks():
    assert tfused.sweep_smem_bytes(192, 96) > H100_SMEM  # 192 needs the grid
    for sms, per_sm in ((1, 1), (4, 2), (132, 4)):
        for batch, n, k in ((1, 784, 392), (32, 256, 128), (3, 300, 1)):
            plan = tfused.sweep_plan(batch, n, k, H100_SMEM, sms, per_sm)
            assert plan.grid <= sms * per_sm
    # the cyclic pivot's single pair: a unit a coordinate besides the pair
    plan = tfused.sweep_plan(1, 300, 1, H100_SMEM, 1000, 8)
    rows, cols = tfused.SWEEP_TILE
    assert plan.grid == -(-301 // rows) * -(-301 // cols)
    with pytest.raises(ValueError, match="grid kernel"):
        tfused.sweep_plan(1, 784, 392, H100_SMEM, 132, 0)


# blocks of each grid-kernel instance an H100 SM holds (the staging's
# registers and shared memory bound the two-round one)
H100_GRID_PER_SM, H100_STAGED_PER_SM = 4, 3


@pytest.mark.parametrize("n", [64, 66, 128])
def test_plan_keeps_small_buckets_in_shared_memory_at_any_depth(n):
    plan = tfused.sweep_plan(32, n, n // 2, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, H100_STAGED_PER_SM)
    assert plan.kernel is tfused.JACOBI_SWEEP_SMEM and plan.depth == 1


@pytest.mark.parametrize("batch,n", [(1, 784), (1, 600), (1, 256),
                                     (2, 512)])
def test_plan_takes_two_rounds_a_barrier_where_every_tile_is_resident(
        batch, n):
    """The fit's (1, 784, 392), among others: two rounds a barrier on a
    grid that holds every tile at once (the fit's 325 tiles)."""
    plan = tfused.sweep_plan(batch, n, n // 2, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, H100_STAGED_PER_SM)
    assert plan.kernel is tfused.JACOBI_SWEEP and plan.depth == 2
    rows, cols = tfused.SWEEP_TILE
    tiles = batch * -(-(n // 2) // rows) * -(-(n // 2) // cols)
    assert plan.grid == tiles <= H100_STAGED_PER_SM * H100_SMS
    if (batch, n) == (1, 784):
        assert plan.grid == 325


@pytest.mark.parametrize("batch,n", [(32, 256), (4, 784), (2, 1024)])
def test_plan_takes_one_round_a_barrier_where_blocks_take_several_tiles(
        batch, n):
    """The 256 bucket's (32, 256, 128): 1024 tiles, two or three a block
    of the staged grid, so one round a barrier on the resident grid."""
    plan = tfused.sweep_plan(batch, n, n // 2, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, H100_STAGED_PER_SM)
    assert plan.kernel is tfused.JACOBI_SWEEP and plan.depth == 1
    assert plan.grid == H100_GRID_PER_SM * H100_SMS


@pytest.mark.parametrize("batch,n", [(1, 784), (1, 512)])
def test_plan_drops_to_one_round_a_barrier_where_the_staging_does_not_fit(
        batch, n):
    """The limits report no block of the two-round instance an SM where
    its staging does not fit the opt-in shared memory: one round a
    barrier, on the resident grid of the one-round instance."""
    k = n // 2
    plan = tfused.sweep_plan(batch, n, k, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, 0)
    assert plan.kernel is tfused.JACOBI_SWEEP and plan.depth == 1
    assert 1 <= plan.grid <= H100_GRID_PER_SM * H100_SMS
    plan = tfused.sweep_plan(batch, n, k, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, H100_STAGED_PER_SM)
    assert plan.depth == 2


@pytest.mark.parametrize("k", [1, 100])
def test_plan_runs_pairs_leaving_coordinates_out_one_round_a_barrier(k):
    """Where the k pairs cannot cover n coordinates (the cyclic pivot's
    k = 1), a coordinate's unit jumps between rounds: one round a
    barrier."""
    plan = tfused.sweep_plan(1, 300, k, H100_SMEM, H100_SMS,
                             H100_GRID_PER_SM, H100_STAGED_PER_SM)
    assert plan.kernel is tfused.JACOBI_SWEEP and plan.depth == 1


def test_plan_keeps_two_rounds_only_where_every_tile_is_resident():
    """The same shape takes two rounds a barrier where the card holds all
    its tiles at once, and one where it does not."""
    assert tfused.sweep_plan(1, 784, 392, H100_SMEM, H100_SMS, 4, 3).depth \
        == 2
    plan = tfused.sweep_plan(1, 784, 392, H100_SMEM, H100_SMS, 4, 2)
    assert plan.depth == 1 and plan.grid == 325  # 264 staged < 325 tiles
    plan = tfused.sweep_plan(32, 256, 128, H100_SMEM, 1024, 4, 1)
    assert plan.depth == 2 and plan.grid == 1024


def test_grid_sweep_counts_no_barrier_off_the_card():
    """A CPU tensor takes the plain version: no launch, and the grid
    sweep's barrier count (read from the card's counters) stays put."""
    before = (tfused.JACOBI_SWEEP.launches, tfused.JACOBI_SWEEP.barriers)
    C = torch.from_numpy(sym(258, seed=3))
    V = torch.eye(258)
    pairs = torch.from_numpy(tjacobi.round_robin_rounds(258)[:3].copy())
    Co, Vo = tfused.jacobi_sweep_step(C, V, pairs)
    assert (tfused.JACOBI_SWEEP.launches,
            tfused.JACOBI_SWEEP.barriers) == before
    want = (C, V)
    for r in pairs:
        want = tfused.jacobi_sweep_step(*want, r)
    assert torch.equal(Co, want[0]) and torch.equal(Vo, want[1])


def test_reference_rounds_are_the_ports():
    for n in (12, 784):
        np.testing.assert_array_equal(tjacobi.round_robin_rounds(n),
                                      jjacobi.round_robin_rounds(n))
