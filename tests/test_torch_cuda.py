"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Every test here is marked ``cuda`` and skips on a host without one;
the file imports nothing of JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Contracts: a Jacobi sweep in one launch, on either residency (shared
memory or the grid), is bitwise equal to the plain version's
round-by-round loop on the card (the kernels round every product and sum
as the separate PyTorch operations do); the Gram and the matmul sum in
another order than cuBLAS: the Gram is held to the fp32 covariance budget,
relative Frobenius 1e-5 (over 1000 samples the bf16 case measured 1.3e-6
on an H100), to 1e-6 of the unfused panel-by-panel Gram, and must come out
exactly symmetric, the fp32 matmul to 1e-6 and the bf16-output matmul to
1e-2, each call on the one MM-Engine kernel its operands' layout calls
for.  The standalone
kernels: the DLE scan identical in (value, index), ties included; the
CORDIC unit bitwise; flash attention within 2e-5 in fp32 and, in bf16,
within one bf16 ulp plus 2e-5 of the plain version's fp32 result (two fp32
sums 1e-7 apart round to bf16 values many ulps apart near zero); the
selective scan within rtol = atol = 1e-4 in fp32 and, in bf16, within one
bf16 ulp plus 1e-4 of the plain version's fp32 result, bitwise the same
whatever its operands' alignment, its final state within rtol = atol =
1e-4; the bf16-state instance's final state within one bf16 ulp of the
plain bf16-state version's (its contract) and, at shapes the models do
not give, equal to it, with its packed bf16 primitives equal to their
plain counterparts at every input.  The ssm and hybrid LM (reduced falcon-mamba and the 2-layer jamba
stand-in): one scan launch a mamba layer a prefill, none in decode, each
scan call held at the op; logits as the dense LM's, fp32 within n_layers
x 1e-4.  The encdec and vlm LM (reduced whisper with 80 frames and
reduced llava): one prefill kernel a flash call (whisper's encoder, self
and cross attention), one split-KV kernel a call a decode step, each bf16
call held at the op; logits as the dense LM's, fp32 within (decoder +
encoder layers) x 2e-5; and the flash op at whisper's shapes (B 32 x 12
heads of 64: 1500 x 1500, 64 x 1500 and 1 x 1500, non-causal) to the
standalone kernels' contracts.  The dense LM (reduced olmo-1b and
granite-8b with GQA): one flash kernel launch a layer a prefill or decode
step; fp32 logits within n_layers x 2e-5 of plain attention's, bf16
logits within sqrt(2) x bf16's own noise of plain attention's (the plain
bf16 run against the plain fp32 run of the same weights), and each bf16
flash call held at the op, on the operands the model gave it, to the
standalone kernels' bf16 contract.  KV
compression: the Gram kernel to 1e-6 of the plain Gram, the sweep kernel
bitwise the plain sweep, one launch a sweep.  Training: each
differentiable op (``kernels.grad``: the kernel's forward, a PyTorch
backward) against autograd through the plain version, attention in fp32
within 1e-5 and in bf16 within one bf16 ulp plus 2e-5 x max |want| of the
plain fp32 gradients, the scan within 1e-5; a reduced olmo-1b step's
gradients within n_layers x 2e-5 of plain attention's, with one flash
launch a layer forward and one in the remat recompute.  The mesh: a
``MeshExecutor`` over ``cuda:0`` bitwise the ``LocalExecutor`` for every
op, and ``fit_distributed`` over one card bitwise the plain ``fit``.  The
persistent tier (on a capability-(9, 0) card): each serve-phase key's CUDA
graph replays bitwise the eager solve, the cooperative grid sweep
included; in-flight flushes of one key do not alias; a fresh process
warms from the cache directory with no nvcc run.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import pca as tpca
from repro_torch.core.jacobi import cyclic_pairs, round_robin_rounds
from repro_torch.kernels import (build, cordic, dle, flash_attention, fused,
                                 launch, launch_counts, mamba_scan, mm_engine,
                                 ops, ref)

from _torch_parity import (DLE_KINDS, DLE_N, DLE_TILES,  # noqa: F401
                           assert_contract, bf16_ulp, cuda_device, data,
                           dle_matrix, rel_frobenius, sym)

pytestmark = pytest.mark.cuda

ANGLES = ["rutishauser", "atan2", "cordic"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_covariance_kernel(cuda_device, dtype):
    x = torch.randn(3, 1000, 70, device=cuda_device).to(dtype)
    before = fused.COVARIANCE.launches
    got = fused.fused_covariance(x, block_m=64)
    assert fused.COVARIANCE.launches == before + 1
    assert_contract(got, ref.covariance_gram(x), "rel_frobenius", 1e-5)
    assert bool((got == got.mT).all())  # mirrored, exactly symmetric


def _sweep_case(dev, n, batch=2, seed=0):
    C = torch.from_numpy(np.stack([sym(n, seed=seed + s)
                                   for s in range(batch)])).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    V = torch.randn(batch, n, n, generator=g, device=dev)
    return C, V


def _launched(before):
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _residency(n, k, batch=2):
    dev = torch.cuda.current_device()
    return fused.sweep_plan(batch, n, k,
                            *fused._sweep_limits(dev, n, k)).kernel.name


# n = 66 and 128: the shared-memory kernel; 258: the grid kernel
SWEEP_N = [66, 128, 258]


@pytest.mark.parametrize("n", SWEEP_N)
@pytest.mark.parametrize("angle", ANGLES)
def test_jacobi_sweep_kernel_bitwise(cuda_device, angle, n):
    """A full sweep (n - 1 rounds) in one launch is bitwise the plain
    version's round-by-round loop, and so is a single round; each call
    launches once, on the residency the plan names."""
    C, V = _sweep_case(cuda_device, n)
    rounds = torch.from_numpy(round_robin_rounds(n)).to(cuda_device)
    kernel = _residency(n, n // 2)
    assert kernel == ("jacobi_sweep_smem" if n <= 128 else "jacobi_sweep")
    for pairs in (rounds, rounds[7]):
        before = launch_counts()
        got = fused.jacobi_sweep_step(C, V, pairs, angle=angle)
        assert _launched(before) == {kernel: 1}
        want = ref.jacobi_sweep_step(C, V, pairs, angle=angle)
        for g, w in zip(got, want):
            assert_contract(g, w, "bitwise")


@pytest.mark.parametrize("n", [20, 180])
def test_jacobi_sweep_kernel_cyclic_rounds(cuda_device, n):
    """k = 1 rounds (the cyclic pivot): a full sweep of n(n-1)/2 rounds
    on the shared-memory kernel (n = 20); on the grid kernel (n = 180),
    its first 600 rounds, one grid barrier each."""
    C, V = _sweep_case(cuda_device, n, seed=3)
    rounds = torch.from_numpy(cyclic_pairs(n)).to(cuda_device)
    if n > 128:
        rounds = rounds[:600].contiguous()
    kernel = _residency(n, 1)
    assert kernel == ("jacobi_sweep_smem" if n <= 128 else "jacobi_sweep")
    before = launch_counts()
    got = fused.jacobi_sweep_step(C, V, rounds, angle="rutishauser")
    assert _launched(before) == {kernel: 1}
    want = ref.jacobi_sweep_step(C, V, rounds, angle="rutishauser")
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


@pytest.mark.parametrize("n", [8, 200])
def test_jacobi_sweep_kernel_out_buffers_and_bad_pairs(cuda_device, n):
    """An out-of-range pair is no rotation, on either residency: rows and
    columns 4.. pass through every round, and the rest is the plain
    version without that pair.  ``out`` is written and must not alias C
    or V.  A degenerate pair is bitwise the plain version."""
    C = torch.from_numpy(sym(n)).to(cuda_device)
    V = torch.eye(n, device=cuda_device)
    good = [[0, 1], [2, 3]]
    rounds = torch.tensor([good + [[4, n + 91]]] * 5, dtype=torch.int32,
                          device=cuda_device)
    out = (torch.empty_like(C), torch.empty_like(V))
    Co, Vo = fused.jacobi_sweep_step(C, V, rounds, out=out)
    assert Co.data_ptr() == out[0].data_ptr()
    assert Vo.data_ptr() == out[1].data_ptr()
    assert bool((Co[4:, 4:] == C[4:, 4:]).all())
    assert bool((Vo[:, 4:] == V[:, 4:]).all())
    want = ref.jacobi_sweep_step(C, V, rounds[:, :2].contiguous())
    assert_contract(Co, want[0], "bitwise")
    assert_contract(Vo, want[1], "bitwise")
    before = launch_counts()
    for bad in ((C, out[1]), (out[0], V), (out[0], out[0])):
        with pytest.raises(ValueError, match="alias"):
            fused.jacobi_sweep_step(C, V, rounds, out=bad)
    assert launch_counts() == before
    # a degenerate pair (p == q) is the identity, written as the plain
    # version writes it; coordinates 4, 6, 7 are in no pair
    rounds = torch.tensor([[[0, 1], [2, 2], [3, 5]]] * 5, dtype=torch.int32,
                          device=cuda_device)
    got = fused.jacobi_sweep_step(C, V, rounds)
    want = ref.jacobi_sweep_step(C, V, rounds)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def _grid_sweep(C, V, pairs):
    """One grid-sweep call counted on ``jacobi_sweep`` alone, and the grid
    barriers the kernel counted passing."""
    barriers = fused.JACOBI_SWEEP.barriers
    before = launch_counts()
    got = fused.jacobi_sweep_step(C, V, pairs)
    assert _launched(before) == {"jacobi_sweep": 1}
    return got, fused.JACOBI_SWEEP.barriers - barriers


def _grid_depth(batch, n, k):
    dev = torch.cuda.current_device()
    plan = fused.sweep_plan(batch, n, k, *fused._sweep_limits(dev, n, k))
    assert plan.kernel is fused.JACOBI_SWEEP
    return plan.depth


def test_grid_sweep_two_rounds_a_barrier_at_the_fit_shape(cuda_device):
    """The fit's whole sweep (n = 784, batch 1, 783 rounds) takes two
    rounds a grid barrier, 391 barriers, and is bitwise the plain loop."""
    n = 784
    C, V = _sweep_case(cuda_device, n, batch=1, seed=11)
    rounds = torch.from_numpy(round_robin_rounds(n)).to(cuda_device)
    assert _grid_depth(1, n, n // 2) == 2
    got, barriers = _grid_sweep(C, V, rounds)
    assert barriers == 391
    want = ref.jacobi_sweep_step(C, V, rounds)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_grid_sweep_on_a_padded_flush(cuda_device):
    """A 32 x 256 flush as the engine stacks one: three live problems
    zero-padded from their widths to 256, the rest its zero filler, V the
    identity.  One sweep in the barriers its plan's depth gives
    (ceil(R / depth) - 1), bitwise the plain loop; the padded coordinates
    stay exactly zero in C and off the live block in V."""
    n, widths = 256, (200, 256, 131)
    C = torch.zeros(32, n, n, device=cuda_device)
    for b, w in enumerate(widths):
        C[b, :w, :w] = torch.from_numpy(sym(w, seed=20 + b)).to(cuda_device)
    V = torch.eye(n, device=cuda_device).expand(32, n, n).contiguous()
    rounds = torch.from_numpy(round_robin_rounds(n)).to(cuda_device)
    depth = _grid_depth(32, n, n // 2)
    got, barriers = _grid_sweep(C, V, rounds)
    assert barriers == -(-(n - 1) // depth) - 1
    want = ref.jacobi_sweep_step(C, V, rounds)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")
    Co, Vo = got
    for b, w in enumerate(widths):
        assert bool((Co[b, w:] == 0).all()) and bool((Co[b, :, w:] == 0).all())
        assert bool((Vo[b, w:, :w] == 0).all())
        assert bool((Vo[b, :w, w:] == 0).all())
    assert bool((Co[len(widths):] == 0).all())


@pytest.mark.parametrize("R", [1, 2, 7])
def test_grid_sweep_two_rounds_a_barrier_odd_and_even_ends(cuda_device, R):
    """R rounds of a 258-wide table: an odd R ends on one single round, an
    even one on a two-round step; ceil(R / 2) - 1 barriers a launch."""
    n = 258
    C, V = _sweep_case(cuda_device, n, seed=R)
    rounds = torch.from_numpy(round_robin_rounds(n)[:R].copy()).to(
        cuda_device)
    assert _grid_depth(2, n, n // 2) == 2
    got, barriers = _grid_sweep(C, V, rounds)
    assert barriers == -(-R // 2) - 1
    want = ref.jacobi_sweep_step(C, V, rounds)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def _matching(n, rng):
    return rng.permutation(n).reshape(-1, 2)


def _two_round_barriers(rounds, n):
    """The grid barriers a depth-2 launch over ``rounds`` takes: one
    between steps, and one more inside each two-round step whose rounds
    leave a coordinate out or move one by more than one pair (run one
    round a barrier)."""
    def live(r):
        return [(int(p), int(q)) for p, q in r if 0 <= p < n and 0 <= q < n]

    def staged(r0, r1):
        if any(sum(1 if p == q else 2 for p, q in live(r)) != n
               for r in (r0, r1)):
            return False
        k = len(r0)
        for u, (p, q) in enumerate(r1):
            if not (0 <= p < n and 0 <= q < n):
                return False
            near = [c for v in range(max(u - 1, 0), min(u + 2, k))
                    if 0 <= r0[v][0] < n and 0 <= r0[v][1] < n
                    for c in r0[v]]
            if p not in near or q not in near:
                return False
        return True

    R = len(rounds)
    extra = sum(not staged(rounds[2 * s], rounds[2 * s + 1])
                for s in range(R // 2))
    return -(-R // 2) - 1 + extra


@pytest.mark.parametrize("table", ["degenerate", "out_of_range", "mixed",
                                   "swapped"])
def test_grid_sweep_two_rounds_a_barrier_any_pairs_table(cuda_device,
                                                         table):
    """Tables the depth-2 grid must hold bitwise, at k >= n / 2 (the depth
    the plan gives the circle method): the same rounds again with two
    degenerate pairs (two rounds a barrier); with an out-of-range pair and
    coordinates in no pair (no rotation: the plain version runs without
    it; one round a barrier); the circle method with every third round a
    random matching (those steps one round a barrier), or with a pair's
    order swapped.  The kernel's own count of its barriers shows which
    steps ran one round a barrier."""
    n = 258
    rng = np.random.default_rng(7)
    C, V = _sweep_case(cuda_device, n, seed=5)
    circle = round_robin_rounds(n)
    if table == "degenerate":
        base = [[2 * i, 2 * i + 1] for i in range(128)] + [[256, 256],
                                                           [257, 257]]
        rounds = np.asarray([base] * 9)
    elif table == "out_of_range":
        base = [[2 * i, 2 * i + 1] for i in range(127)] + [[254, 254],
                                                           [255, 900]]
        rounds = np.asarray([base] * 7)
    elif table == "mixed":
        rounds = circle[:40].copy()
        rounds[::3] = [_matching(n, rng) for _ in rounds[::3]]
    else:
        rounds = circle[:40].copy()
        rounds[:, 5] = rounds[:, 5, ::-1]
    k = rounds.shape[1]
    assert _grid_depth(2, n, k) == 2
    pairs = torch.from_numpy(rounds.astype(np.int32)).to(cuda_device)
    got, barriers = _grid_sweep(C, V, pairs)
    assert barriers == _two_round_barriers(rounds, n)
    live = torch.from_numpy(np.stack([
        [p for p in r if p[0] < n and p[1] < n] for r in rounds]).astype(
            np.int32)).to(cuda_device)
    want = ref.jacobi_sweep_step(C, V, live)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_covariance_kernel_against_the_unfused_gram(cuda_device):
    """The CUDA Gram (3xTF32, the m axis in ``cov_splits`` slices) against
    ``blocked_covariance`` at the same ``block_m`` (one cuBLAS product a
    panel): relative Frobenius 1e-6, the tolerance ``PCAConfig.fused``
    states, a tenth of the fp32 covariance budget."""
    from repro_torch.core.covariance import blocked_covariance
    x = torch.from_numpy(data(3000, 96, seed=4)).to(cuda_device)
    before = fused.COVARIANCE.launches
    got = blocked_covariance(x, block_m=128, fused=True, backend="cuda")
    assert fused.COVARIANCE.launches == before + 1
    want = blocked_covariance(x, block_m=128)
    assert_contract(got, want, "rel_frobenius", 1e-6)


def test_mm_engine_kernel(cuda_device):
    a = torch.randn(2, 130, 70, device=cuda_device)
    b = torch.randn(70, 33, device=cuda_device)
    assert_contract(mm_engine.mm_engine(a, b), ref.mm_engine(a, b),
                    "rel_frobenius", 1e-6)
    at = torch.randn(70, 130, device=cuda_device).mT  # a transposed view
    assert_contract(mm_engine.mm_engine(at, b), ref.mm_engine(at, b),
                    "rel_frobenius", 1e-6)
    ab, bb = a.bfloat16(), b.bfloat16()
    assert_contract(mm_engine.mm_engine(ab, bb).float(),
                    ref.mm_engine(ab, bb).float(), "rel_frobenius", 1e-2)


RAGGED_N = [1, 31, 32, 33, 70, 784]


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_covariance_kernel_ragged(cuda_device, dtype, n):
    """m not a multiple of the 32-row panel, every n edge case, a batch."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(3, 999, n, generator=g, device=cuda_device).to(dtype)
    before = fused.COVARIANCE.launches
    got = fused.fused_covariance(x, block_m=96)
    assert fused.COVARIANCE.launches == before + 1
    assert_contract(got, ref.covariance_gram(x), "rel_frobenius", 1e-5)
    assert bool((got == got.mT).all())


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_engine_kernel_ragged(cuda_device, dtype, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    a = torch.randn(3, 301, 77, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(3, 77, n, generator=g, device=cuda_device).to(dtype)
    before = launch_counts()
    got = mm_engine.mm_engine(a, b)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"mm_engine_matmul": 1}
    assert got.dtype == dtype
    assert_contract(got.float(), ref.mm_engine(a, b).float(),
                    "rel_frobenius", 1e-6 if dtype == torch.float32 else 1e-2)


def test_mm_engine_projection_shape(cuda_device):
    """The main path's projection (70000, 784) @ (784, 32), cut to 7000
    rows, on the narrow tile."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    a = torch.randn(7000, 784, generator=g, device=cuda_device)
    b = torch.randn(784, 784, generator=g, device=cuda_device)[:, :32]
    assert mm_engine.choose_kernel(a, b).narrow
    assert_contract(mm_engine.mm_engine(a, b), ref.mm_engine(a, b),
                    "rel_frobenius", 1e-6)


def _layouts(dev, dtype):
    """Operands in ``dtype``, each view made after the cast (a cast of a
    strided view is contiguous)."""
    g = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    return [
        ("contiguous", rnd(300, 784), rnd(784, 32), "mm_engine_matmul"),
        ("a.mT", rnd(784, 300).mT, rnd(784, 70), "mm_engine_matmul"),
        ("J.mT batched", rnd(3, 66, 66).mT, rnd(3, 66, 66),
         "mm_engine_matmul"),
        ("column slice", rnd(300, 784), rnd(784, 784)[:, :33],
         "mm_engine_matmul"),
        ("odd leading strides", rnd(301, 70), rnd(70, 33),
         "mm_engine_matmul"),
        ("b.mT", rnd(300, 48), rnd(40, 48).mT, "mm_engine_matmul"),
        ("offset view", rnd(300 * 64 + 1)[1:].view(300, 64),
         rnd(64 * 20 + 2)[2:].view(64, 20), "mm_engine_matmul"),
        ("batch stride 0", rnd(64, 48).expand(3, 64, 48), rnd(3, 48, 40),
         "mm_engine_matmul"),
        ("general stride", rnd(300, 128)[:, ::2], rnd(64, 32),
         "mm_engine_matmul"),
        ("general stride in b", rnd(300, 64), rnd(128, 66)[::2, ::2],
         "mm_engine_matmul"),
        ("rows and columns strided", rnd(301, 128)[::3, ::2], rnd(64, 70),
         "mm_engine_matmul"),
        ("a strided along m", rnd(64, 390)[::2, ::3].mT, rnd(32, 20),
         "mm_engine_matmul"),
        ("expanded b, step 0", rnd(300, 64), rnd(64, 2)[:, :1].expand(64, 40),
         "mm_engine_matmul"),
        ("expanded b, unit stride", rnd(300, 64), rnd(1, 40).expand(64, 40),
         "mm_engine_matmul"),
        ("batched strided a", rnd(3, 130, 128)[:, :, ::2], rnd(64, 33),
         "mm_engine_matmul"),
        ("batched strided b", rnd(3, 130, 64), rnd(3, 128, 66)[:, ::2, ::2],
         "mm_engine_matmul"),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_engine_takes_the_kernel_its_layout_calls_for(cuda_device, dtype):
    for name, a, b, kernel in _layouts(cuda_device, dtype):
        before = launch_counts()
        got = mm_engine.mm_engine(a, b)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == {kernel: 1}, (name, moved)
        assert mm_engine.choose_kernel(a, b).kernel.name == kernel
        assert_contract(got.float(), ref.mm_engine(a, b).float(),
                        "rel_frobenius",
                        1e-6 if dtype == torch.float32 else 1e-2)


def test_fit_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((500, 24))
         * np.geomspace(3, 0.3, 24)).astype(np.float32)
    cfg = tpca.PCAConfig(fused=True, backend="cuda", sweeps=12)
    before = launch_counts()
    Y, res = tpca.fit_transform(X, 5, cfg, device=cuda_device)
    moved = _launched(before)
    for name in ("covariance", "mm_engine_matmul"):
        assert moved.get(name, 0) > 0, name
    # one launch a sweep, on the shared-memory kernel at n = 24
    assert moved["jacobi_sweep_smem"] == 12 and "jacobi_sweep" not in moved
    Yc, cpu = tpca.fit_transform(X, 5, tpca.PCAConfig(fused=True, sweeps=12),
                                 device="cpu")
    assert_contract(res.eigenvalues.cpu(), cpu.eigenvalues, "rel_frobenius",
                    1e-5)
    assert Y.device.type == "cuda" and Y.shape == (500, 5)


def test_dle_kernel_matches_its_plain_version(cuda_device):
    cases = [(torch.from_numpy(sym(n, seed=n)), tile)
             for n, tile in [(64, 32), (100, 32), (33, 16), (784, 128)]]
    diag = torch.diag(torch.arange(1.0, 9.0))
    tie = torch.zeros(8, 8)
    tie[0, 5] = tie[5, 0] = tie[1, 2] = tie[2, 1] = 3.0
    cases += [(diag, 4), (tie, 4), (torch.ones(1, 1), 4)]
    for c, tile in cases:
        c = c.to(cuda_device)
        before = dle.DLE_SCAN.launches
        got = dle.dle_scan(c, tile)
        assert dle.DLE_SCAN.launches == before + 1
        want = ref.dle_scan(c, tile)
        assert (float(got[0]), int(got[1])) == (float(want[0]),
                                                int(want[1])), (c.shape,
                                                                tile)


def _bits(t: torch.Tensor) -> list:
    """The values of 0-d tensors as exact, NaN-comparable bit patterns."""
    return [int(x.view(torch.int32)) if x.dtype == torch.float32
            else int(x) for x in t]


def _dle_at(c: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous copy of ``c`` whose base is ``shift`` floats past a
    16-byte boundary (shift 1: one element a load)."""
    n = c.shape[0]
    flat = torch.empty(n * n + 4, dtype=c.dtype, device=c.device)
    out = flat[shift:shift + n * n].view(n, n)
    out.copy_(c)
    return out


@pytest.mark.parametrize("tile", DLE_TILES)
@pytest.mark.parametrize("n", DLE_N)
def test_dle_kernel_bitwise_with_ties_nan_and_inf(cuda_device, n, tile):
    """(value, flat index) bitwise the plain version's, NaN tiles skipped,
    at aligned and unaligned bases; the gathered pivot is C's entries."""
    for kind in DLE_KINDS:
        host = torch.from_numpy(dle_matrix(n, kind, seed=n + tile))
        want = ref.dle_scan(host, tile)
        for shift in (0, 1):
            c = _dle_at(host.to(cuda_device), shift)
            before = dle.DLE_SCAN.launches
            got = dle.dle_scan(c, tile)
            piv = dle.dle_pivot(c, tile)
            assert dle.DLE_SCAN.launches == before + 2
            assert _bits(got) == _bits(want), (kind, shift)
            p, q = int(piv[0]), int(piv[1])
            assert p * n + q == int(want[1]) and piv[0].dtype == torch.int64
            assert _bits(piv[2:]) == _bits(
                (host[p, q], host[p, p], host[q, q])), (kind, shift)


def test_dle_find_pivot_is_one_launch_on_a_grid_that_fills_the_card(
        cuda_device, tmp_path):
    """Each op call adds one to the kernel's count, and the profiler traces
    no kernel but the DLE kernel, on the grid ``launch_grid`` gives (a
    trace may miss an event, so its count is held to at most one a
    call)."""
    import json
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, tile, calls = 784, 128, 10
    c = torch.from_numpy(sym(n, seed=3)).to(cuda_device)
    ops.dle_find_pivot(c, tile)  # the stream's scratch, zeroed once
    torch.cuda.synchronize()
    before = dle.DLE_SCAN.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pivots = [ops.dle_find_pivot(c, tile) for _ in range(calls)]
        torch.cuda.synchronize()
    assert dle.DLE_SCAN.launches == before + calls
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert 0 < len(kernels) <= calls and all(
        "dle_kernel" in k for k in kernels), kernels
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    grids = [e["args"]["grid"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]
        if e.get("cat") == "kernel"]
    gx, gy = dle.launch_grid(n, tile)
    assert grids and all(g == [gx, gy, 1] for g in grids), grids
    assert gx * gy >= 132
    want = int(ref.dle_scan(c, tile)[1])
    assert all(int(p.p) * n + int(p.q) == want for p in pivots)


def test_dle_scratch_cleans_itself_across_calls_and_streams(cuda_device):
    """Back-to-back calls on different matrices (no synchronize between
    them), a larger tile grid after a smaller one, and calls on a second
    stream, each with its own scratch: every result right."""
    mats = [torch.from_numpy(dle_matrix(n, kind, seed=i)).to(cuda_device)
            for i, (n, kind) in enumerate(
                [(64, "random"), (300, "ties"), (129, "nan"),
                 (784, "nan_inf"), (64, "ties"), (1030, "nan")])]
    tiles = [32, 4, 128, 1, 16, 128]  # n = 1030: the diagonal from C
    side = torch.cuda.Stream(cuda_device)
    got, got_side = [], []
    for c, tile in zip(mats, tiles):
        got.append(dle.dle_scan(c, tile))
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            got_side.append(dle.dle_scan(c, tile))
    torch.cuda.synchronize()
    for c, tile, g, gs in zip(mats, tiles, got, got_side):
        want = _bits(ref.dle_scan(c.cpu(), tile))
        assert _bits(g) == want and _bits(gs) == want, (c.shape, tile)
        piv = dle.dle_pivot(c, tile)
        assert _bits(piv) == _bits(ref.dle_pivot(c.cpu(), tile)), c.shape
    streams = {key[1] for key in dle._SCRATCH if key[0] == cuda_device.index}
    assert side.cuda_stream in streams and len(streams) >= 2
    for buf in dle._SCRATCH.values():  # zero again after the last block
        assert int(buf.count_nonzero()) == 0


def test_cordic_outputs_are_three_rows_that_do_not_overlap(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for k in (0, 1, 392, 1000):
        apq, app, aqq = torch.randn(3, k, generator=g, device=cuda_device)
        apq, app, aqq = (t.contiguous() for t in (apq, app, aqq))
        got = cordic.cordic_rotation_params(apq, app, aqq)
        spans = sorted((t.data_ptr(), t.data_ptr() + 4 * k) for t in got)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(t.shape == (k,) and t.is_contiguous() for t in got)
        want = ref.cordic_rotation_params_q29(apq, app, aqq)
        for gg, w in zip(got, want):
            assert_contract(gg, w, "bitwise")


def test_cordic_kernel_bitwise(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    scale = 10.0 ** torch.randint(-6, 7, (3, 4099), generator=g,
                                  device=cuda_device)
    apq, app, aqq = torch.randn(3, 4099, generator=g,
                                device=cuda_device) * scale
    apq[::17] = 0.0
    aqq[::13] = app[::13]
    got = cordic.cordic_rotation_params(apq, app, aqq)
    want = ref.cordic_rotation_params_q29(apq, app, aqq)
    for gg, w in zip(got, want):
        assert_contract(gg, w, "bitwise")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    # ragged lengths, D not a multiple of 16, decode past the prefix
    cases = [(3, 100, 100, 40, True, 0), (2, 64, 150, 128, False, 0),
             (2, 5, 77, 64, True, 72), (2, 1, 300, 128, True, 299),
             (1, 70, 90, 16, True, -10)]
    # Sq and Skv not multiples of 64; D 40, 64, 128 and 20 (8-byte copies
    # in bf16); non-causal over a ragged Skv; q_offset < 0
    cases += [(2, 130, 333, 64, True, 203), (2, 70, 190, 40, True, 120),
              (1, 129, 129, 128, True, 0), (2, 90, 100, 20, True, 10),
              (1, 200, 77, 128, False, 0), (2, 80, 200, 64, True, -30),
              (1, 33, 65, 128, True, -40)]
    # decode: one, several and a ragged last split of 256 keys
    cases += [(2, sq, skv, 64, True, skv - sq) for sq in (1, 7, 16)
              for skv in (1, 255, 3000)]
    cases += [(3, 16, 700, 128, False, 0), (1, 7, 300, 20, True, -3)]
    # D 20 and 8 (in fp32, the 3xTF32 kernel's 24- and 8-wide padding);
    # several 128-row q tiles, the first rows of the first tile seeing no
    # key (that tile visits every key, the next ones stop at the diagonal,
    # and their warps skip the tiles above their own rows); odd D
    # (4-byte copies) and D 18 (8-byte copies)
    cases += [(2, 100, 120, 20, True, 0), (3, 90, 90, 8, True, 0),
              (2, 300, 320, 128, True, -20), (1, 520, 520, 64, True, 0),
              (2, 150, 180, 13, True, 30), (1, 140, 70, 18, False, 0)]
    for bh, sq, skv, d, causal, off in cases:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        before = launch_counts()
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              q_offset=off)
        kernel = flash_attention.choose_kernel(sq, dtype)
        assert _launched(before) == {kernel.name: 1}
        if dtype == torch.float32 and sq > flash_attention.DECODE_MAX_SQ:
            assert kernel is flash_attention.FLASH_TF32
        want = ref.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal, q_offset=off)
        assert got.dtype == dtype
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 2e-5, (bh, sq, skv, d, causal, off)
        else:
            slack = bf16_ulp(torch.maximum(got.float().abs(), want.abs()))
            assert bool((err <= slack + 2e-5).all()), (bh, sq, skv, d, off)


def test_flash_attention_takes_the_kernel_its_shape_calls_for(cuda_device):
    """Each call launches exactly one of the three kernels: split-KV for
    Sq <= 16, the 3xTF32 kernel for fp32 prefill and the bf16 tensor-core
    kernel for bf16 prefill, both at any D and alignment."""
    shapes = [(1, torch.bfloat16, 64, "flash_attention_splitkv"),
              (16, torch.float32, 128, "flash_attention_splitkv"),
              (17, torch.bfloat16, 128, "flash_attention_mma"),
              (100, torch.bfloat16, 40, "flash_attention_mma"),
              (100, torch.bfloat16, 20, "flash_attention_mma"),
              (100, torch.bfloat16, 7, "flash_attention_mma"),
              (100, torch.float32, 128, "flash_attention_tf32x3"),
              (17, torch.float32, 20, "flash_attention_tf32x3"),
              (100, torch.float32, 7, "flash_attention_tf32x3")]
    for sq, dtype, d, name in shapes:
        q, k, v = (torch.randn(2, s, d, device=cuda_device).to(dtype)
                   for s in (sq, 90, 90))
        before = launch_counts()
        flash_attention.flash_attention(q, k, v, q_offset=90 - sq)
        after = launch_counts()
        moved = {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}
        assert moved == {name: 1}, (sq, dtype, d, moved)
        assert flash_attention.choose_kernel(sq, dtype).name == name


@pytest.mark.parametrize("shift", [1, 2])
def test_flash_attention_tf32_on_unaligned_rows(cuda_device, shift):
    """fp32 q, k, v starting 4 or 8 bytes past a 16-byte boundary: the
    3xTF32 kernel takes 4- or 8-byte copies and stays within 2e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bh, sq, skv, d = 2, 150, 200, 64
    tensors = []
    for s in (sq, skv, skv):
        flat = torch.randn(bh * s * d + shift, generator=g,
                           device=cuda_device)
        tensors.append(flat[shift:].view(bh, s, d))
    q, k, v = tensors
    assert flash_attention.copy_floats(d, q, k, v) == shift
    before = launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=True, q_offset=50)
    assert _launched(before) == {"flash_attention_tf32x3": 1}
    want = ref.flash_attention(q, k, v, causal=True, q_offset=50)
    assert float((got - want).abs().max()) <= 2e-5


def _bf16_at(dev, shape, shift, g):
    """A random bf16 tensor of ``shape`` starting ``shift`` elements past
    a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.randn(n + 8, generator=g, device=dev).bfloat16()
    base = flat.data_ptr() % 16 // 2
    t = flat[(shift - base) % 8:][:n].view(shape)
    assert t.data_ptr() % 16 == 2 * shift % 16
    return t


def _within_bf16_contract(got, want32):
    g = got.float()
    slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) + 2e-5
    return bool(((g - want32).abs() <= slack).all())


@pytest.mark.parametrize("d", [1, 2, 7, 19, 20, 36, 100, 127, 128])
def test_flash_attention_bf16_any_head_dim_and_alignment(cuda_device, d):
    """bf16 prefill on the tensor-core kernel at head dims that take 16-,
    8-, 4-byte and single-element copies, with q, k and v starting 0, 1, 2
    or 4 elements past a 16-byte boundary; causal and not, Sq and Skv not
    multiples of 64, and q_offset beyond Skv - Sq (rows see padded keys
    in the TPU wrapper, none here).  One launch each, within one bf16 ulp
    + 2e-5 of the fp32 plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    cases = [(2, 70, 150, True, 100), (1, 130, 90, True, 0),
             (2, 65, 65, False, 0), (1, 100, 40, True, -20)]
    for shift in (0, 1, 2, 4):
        for bh, sq, skv, causal, off in cases:
            q, k, v = (_bf16_at(cuda_device, (bh, s, d), shift, g)
                       for s in (sq, skv, skv))
            vec = flash_attention.copy_elems(d, q, k, v)
            assert d % vec == 0 and q.data_ptr() % (2 * vec) == 0
            before = launch_counts()
            got = flash_attention.flash_attention(q, k, v, causal=causal,
                                                  q_offset=off)
            assert _launched(before) == {"flash_attention_mma": 1}
            want = ref.flash_attention(q.float(), k.float(), v.float(),
                                       causal=causal, q_offset=off)
            assert _within_bf16_contract(got, want), (d, shift, sq, skv,
                                                      causal, off)


@pytest.mark.parametrize("d", [7, 19, 20])
def test_flash_attention_bf16_store_stays_inside_out(cuda_device, d):
    """The kernel's entry called on an ``out`` that starts one element
    into a buffer filled with a sentinel (so out is 2-byte aligned only,
    and the store takes single elements): the sentinel before and after
    out stays, and out equals the wrapper's result (whose out is aligned)
    bitwise.  At odd D a pair store past a row would land in the next."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    bh, sq, skv = 2, 70, 90
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
               .bfloat16() for s in (sq, skv, skv))
    want = flash_attention.flash_attention(q, k, v, causal=True)
    sentinel = -7.0
    buf = torch.full((bh * sq * d + 16,), sentinel, dtype=torch.bfloat16,
                     device=cuda_device)
    out = buf[1:1 + bh * sq * d].view(bh, sq, d)
    vec = flash_attention.copy_elems(d, q, k, v, out)
    assert vec == 1
    status = build.library().repro_flash_attention_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        skv, d, vec, d ** -0.5, 1, 0, launch.stream(cuda_device))
    build.check(status, "flash_attention_mma")
    torch.cuda.synchronize()
    assert float(buf[0]) == sentinel
    assert bool((buf[1 + bh * sq * d:] == sentinel).all())
    assert torch.equal(out, want)


def _scan_inputs(dev, b, L, D, N, g, dtype=torch.float32):
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    u, Bm, Cm = rnd(b, L, D), rnd(b, L, N), rnd(b, L, N)
    dt = torch.rand(b, L, D, generator=g, device=dev) * 0.19 + 0.01
    A = -(torch.rand(D, N, generator=g, device=dev) * 1.5 + 0.5)
    return (u.to(dtype), dt.to(dtype), A, Bm.to(dtype), Cm.to(dtype),
            rnd(D))


# ragged: L not a whole number of 32-step chunks, D of 32-channel blocks
SCAN_SHAPES = [(2, 50, 16, 8), (1, 300, 200, 16), (3, 33, 8, 4),
               (3, 70, 45, 1), (3, 70, 45, 3), (3, 70, 45, 4),
               (3, 70, 45, 13), (3, 70, 45, 16)]


def test_mamba_scan_kernel(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for b, L, D, N in SCAN_SHAPES:
        args = _scan_inputs(cuda_device, b, L, D, N, g)
        before = launch_counts()
        got = mamba_scan.mamba_scan(*args)
        assert _launched(before) == {"mamba_scan": 1}
        want = ref.mamba_scan(*args)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_final_state(cuda_device, dtype):
    """``return_state``: the same launch stores the final state, (batch,
    D, N) fp32, within rtol = atol = 1e-4 of the plain version's on the
    same inputs (in fp32), and y stays bitwise the default call's."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for b, L, D, N in SCAN_SHAPES:
        args = _scan_inputs(cuda_device, b, L, D, N, g, dtype=dtype)
        before = launch_counts()
        y, state = mamba_scan.mamba_scan(*args, return_state=True)
        assert _launched(before) == {"mamba_scan": 1}
        assert state.shape == (b, D, N) and state.dtype == torch.float32
        _, want = ref.mamba_scan(*(t.float() for t in args),
                                 return_state=True)
        torch.testing.assert_close(state, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(y, mamba_scan.mamba_scan(*args))
        # the op passes it through
        y_op, state_op = ops.mamba_scan(*args, return_state=True)
        assert torch.equal(y_op, y) and torch.equal(state_op, state)


def _within_scan_bf16_contract(got, want32):
    g = got.float()
    slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) + 1e-4
    return bool(((g - want32).abs() <= slack).all())


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_mamba_scan_kernel_bf16(cuda_device, shape):
    """bf16 inputs against the plain version's fp32 result on the same
    inputs: within one bf16 ulp + 1e-4 (the state is fp32, y is rounded
    to bf16 once)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    args = _scan_inputs(cuda_device, *shape, g, dtype=torch.bfloat16)
    before = launch_counts()
    got = mamba_scan.mamba_scan(*args)
    assert _launched(before) == {"mamba_scan": 1}
    assert got.dtype == torch.bfloat16
    want = ref.mamba_scan(*(t.float() for t in args))
    assert _within_scan_bf16_contract(got, want)


def _at(flat, shape, shift):
    """``shape`` cut from the contiguous ``flat`` so that it starts
    ``shift`` elements past a 16-byte boundary."""
    n = int(np.prod(shape))
    es = flat.element_size()
    base = flat.data_ptr() % 16 // es
    t = flat[(shift - base) % (16 // es):][:n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == shift * es % 16
    return t


@pytest.mark.parametrize("dtype,shift", [(torch.float32, 1),
                                         (torch.float32, 2),
                                         (torch.bfloat16, 1),
                                         (torch.bfloat16, 2)])
def test_mamba_scan_kernel_on_unaligned_bases(cuda_device, dtype, shift):
    """Every operand a contiguous view starting at an odd offset: the
    copies and the y store narrow to the alignment (one or two elements)
    and the result is the same as on aligned copies of the inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, L, D, N = 2, 90, 64, 16
    args = _scan_inputs(cuda_device, b, L, D, N, g, dtype=dtype)
    moved = []
    for t in args:
        if t.ndim == 3:
            flat = torch.empty(t.numel() + 16, dtype=dtype,
                               device=cuda_device)
            view = _at(flat, t.shape, shift)
            view.copy_(t)
            moved.append(view)
        else:
            moved.append(t)
    vec = mamba_scan.scan_copies(*moved[:2], *moved[3:5])
    assert vec[0] == vec[1] == shift
    got = mamba_scan.mamba_scan(*moved)
    want = mamba_scan.mamba_scan(*args)
    want32 = ref.mamba_scan(*(t.float() for t in args))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-4, atol=1e-4)
    else:
        assert _within_scan_bf16_contract(got, want32)
    # the same arithmetic whatever the copies: bitwise the aligned run
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 45),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 45),
                                     (torch.bfloat16, 64)])
def test_mamba_scan_store_stays_inside_y(cuda_device, dtype, D):
    """The kernel's entry called on a y that starts one element into a
    buffer filled with a sentinel (so the entry narrows y's stores to one
    element):
    the sentinel before and after y stays, and y equals the wrapper's
    result bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, L, N = 3, 70, 16
    args = _scan_inputs(cuda_device, b, L, D, N, g, dtype=dtype)
    want = mamba_scan.mamba_scan(*args)
    sentinel = -7.0
    n = b * L * D
    buf = torch.full((n + 16,), sentinel, dtype=dtype, device=cuda_device)
    y = buf[1:1 + n].view(b, L, D)
    u, dt, A, Bm, Cm, Dskip = args
    status = build.library().repro_mamba_scan(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), Dskip.data_ptr(), y.data_ptr(), None,
        int(dtype == torch.bfloat16), 0, b, L, D, N,
        *mamba_scan.scan_copies(u, dt, Bm, Cm), launch.stream(cuda_device))
    build.check(status, "mamba_scan")
    torch.cuda.synchronize()
    assert float(buf[0]) == sentinel
    assert bool((buf[1 + n:] == sentinel).all())
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_bf16_state(cuda_device, dtype):
    """The bf16-state instance (``state_dtype=torch.bfloat16``) against
    the plain version in bf16-state mode on the same inputs: one launch
    on its own record, the final state (bf16 values in fp32) within one
    bf16 ulp of the plain version's, y within 2^-8 relative Frobenius
    (both round the same values at the same points; y is summed in fp32
    in other orders), and away from the fp32 state's result."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    for b, L, D, N in SCAN_SHAPES:
        args = _scan_inputs(cuda_device, b, L, D, N, g, dtype=dtype)
        before = launch_counts()
        y, state = mamba_scan.mamba_scan(*args, return_state=True,
                                         state_dtype=torch.bfloat16)
        assert _launched(before) == {"mamba_scan_bf16_state": 1}
        assert state.dtype == torch.float32 and y.dtype == dtype
        assert torch.equal(state.bfloat16().float(), state)
        want_y, want_state = ref.mamba_scan(*args, return_state=True,
                                            state_dtype=torch.bfloat16)
        ulp = bf16_ulp(torch.maximum(state.abs(), want_state.abs()))
        assert bool(((state - want_state).abs() <= ulp).all())
        assert rel_frobenius(y.float(), want_y.float()) <= 2.0 ** -8
        y32 = mamba_scan.mamba_scan(*args)
        assert not torch.equal(y32, y)
        # the op passes state_dtype through
        y_op, state_op = ops.mamba_scan(*args, return_state=True,
                                        state_dtype=torch.bfloat16)
        assert torch.equal(y_op, y) and torch.equal(state_op, state)


def test_bf16_state_primitives_match_their_plain_counterparts(cuda_device):
    """The bf16-state instance's packed primitives at every input: bf16x2
    mul and add at every bf16 pair against __float2bfloat16_rn of
    __fmul_rn / __fadd_rn, the packed convert at every fp32 bit pattern
    against __float2bfloat16_rn, r(expf(x)) at every bf16 x; subnormals,
    infinities and NaN included (a NaN matches a NaN)."""
    got = mamba_scan.bf16_primitive_mismatches(cuda_device)
    assert set(got) == set(mamba_scan.BF16_PRIMITIVES)
    for name, rec in got.items():
        assert rec["inputs"] == mamba_scan.BF16_PRIMITIVES[name]
        assert rec["mismatches"] == 0 and rec["first"] is None, (name, rec)


# shapes the models do not give the bf16-state instance: N below 16, D not
# a whole number of 32-channel blocks, L not one of 32-step chunks
SCAN_BF16_STATE_SHAPES = [(2, 50, 16, 8), (1, 300, 200, 16), (3, 33, 8, 4),
                          (3, 70, 45, 1), (3, 70, 45, 13), (4, 129, 96, 16)]


@pytest.mark.parametrize("shape", SCAN_BF16_STATE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bf16_state_final_state_bitwise(cuda_device, dtype,
                                                   shape):
    """The bf16-state instance's final state equal to the plain version's
    in bf16-state mode on the card, value for value, y within 2^-8
    relative Frobenius; without ``return_state`` the same y, bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    args = _scan_inputs(cuda_device, *shape, g, dtype=dtype)
    bf16 = torch.bfloat16
    before = launch_counts()
    y, state = mamba_scan.mamba_scan(*args, return_state=True,
                                     state_dtype=bf16)
    y_only = mamba_scan.mamba_scan(*args, state_dtype=bf16)
    assert _launched(before) == {"mamba_scan_bf16_state": 2}
    want_y, want_state = ref.mamba_scan(*args, return_state=True,
                                        state_dtype=bf16)
    assert torch.equal(state, want_state)
    assert rel_frobenius(y.float(), want_y.float()) <= 2.0 ** -8
    assert torch.equal(y_only, y)


@pytest.mark.parametrize("k", [1, 392, 1 << 20])
def test_cordic_kernel_bitwise_at_path_sizes(cuda_device, k):
    """k = 1, one round's 392 pivots at n = 784 and 2^20: bitwise the
    plain version, zeros and equal diagonals included."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    scale = 10.0 ** torch.randint(-6, 7, (3, k), generator=g,
                                  device=cuda_device)
    apq, app, aqq = (torch.randn(3, k, generator=g, device=cuda_device)
                     * scale)
    apq[::17] = 0.0
    aqq[::13] = app[::13]
    apq, app, aqq = (t.contiguous() for t in (apq, app, aqq))
    before = launch_counts()
    got = cordic.cordic_rotation_params(apq, app, aqq)
    assert _launched(before) == {"cordic_rotate": 1}
    want = ref.cordic_rotation_params_q29(apq, app, aqq)
    for gg, w in zip(got, want):
        assert_contract(gg, w, "bitwise")


# -- configurations the smoke test's main path does not take -----------------

def _pca_eigs64(X):
    X = X.astype(np.float64)
    Xs = (X - X.mean(axis=0)) / X.std(axis=0)
    return np.linalg.eigvalsh(Xs.T @ Xs)[::-1]


def test_paper_faithful_configuration_on_the_card(cuda_device):
    """pivot='paper' (DLE max-pivot) + CORDIC angles + matmul rotations
    through the CUDA MM-Engine, as ``tests/test_pca.py`` runs the
    reference: every matmul (the Gram's panels, each rotation, the
    projection) on ``mm_engine_matmul``, no sweep kernel."""
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((120, 10))
         * np.geomspace(3, 0.3, 10)).astype(np.float32)
    cfg = tpca.PCAConfig(T=16, sweeps=40, pivot="paper", rotation="matmul",
                         angle="cordic", backend="cuda")
    before = launch_counts()
    Y, res = tpca.fit_transform(X, 4, cfg, device=cuda_device)
    moved = _launched(before)
    assert moved.get("mm_engine_matmul", 0) > 40 * 45, moved
    assert "jacobi_sweep" not in moved and "jacobi_sweep_smem" not in moved
    want = _pca_eigs64(X)
    np.testing.assert_allclose(res.eigenvalues.cpu().numpy(), want,
                               rtol=1e-3, atol=1e-2)
    assert_contract(res.eigenvalues, want, "rel_frobenius", 1e-4)
    assert Y.device.type == "cuda" and bool(torch.isfinite(Y).all())


def test_bf16_fused_gram_on_the_card(cuda_device):
    """precision='bf16_fp32acc' through the fused Gram: bf16 operands, fp32
    sums; the eigenvalues within the bf16 budget of float64 numpy."""
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((700, 48))
         * np.geomspace(3, 0.3, 48)).astype(np.float32)
    cfg = tpca.PCAConfig(fused=True, backend="cuda", sweeps=15,
                         precision="bf16_fp32acc")
    before = launch_counts()
    _, res = tpca.fit_transform(X, 4, cfg, device=cuda_device)
    moved = _launched(before)
    assert moved.get("covariance") == 1 and moved["jacobi_sweep_smem"] == 15
    assert res.eigenvalues.dtype == torch.float32
    assert_contract(res.eigenvalues, _pca_eigs64(X), "rel_frobenius", 2e-2)


@pytest.mark.parametrize("path", ["fit", "fit_fused", "eigh_batched",
                                  "svd_batched"])
def test_float64_input_on_the_card(cuda_device, path):
    """Numpy float64 input is taken as float32 before any kernel sees it
    (the MM-Engine and the sweep kernels take fp32 or bf16 only)."""
    from repro_torch.serving import solver as tsolver
    rng = np.random.default_rng(5)
    if path.startswith("fit"):
        X = rng.standard_normal((300, 20)) * np.geomspace(3, 0.3, 20)
        cfg = tpca.PCAConfig(fused=path == "fit_fused", backend="cuda",
                             sweeps=12)
        before = launch_counts()
        Y, res = tpca.fit_transform(X, 4, cfg, device=cuda_device)
        moved = _launched(before)
        assert moved.get("mm_engine_matmul", 0) > 0, moved
        assert Y.dtype == res.eigenvalues.dtype == torch.float32
        assert_contract(res.eigenvalues, _pca_eigs64(X), "rel_frobenius",
                        1e-4)
        return
    op = path.split("_")[0]
    if op == "eigh":
        g = rng.standard_normal((3, 16, 16))
        batch = (g + g.transpose(0, 2, 1)) / 2
    else:
        batch = rng.standard_normal((3, 24, 16))
    fn = tsolver.build_solver_fn(
        op, tpca.PCAConfig(fused=True, backend="cuda", sweeps=12),
        device=cuda_device)
    before = launch_counts()
    out = fn(batch, None, None)
    assert _launched(before)["jacobi_sweep_smem"] == 12
    vals = out.eigenvalues if op == "eigh" else out.S
    assert vals.dtype == torch.float32
    for i in range(3):
        want = (np.linalg.eigvalsh(batch[i])[::-1] if op == "eigh"
                else np.linalg.svd(batch[i], compute_uv=False))
        assert_contract(vals[i], want, "rel_frobenius", 1e-4)


# -- the serving engine on the card -------------------------------------------

def _served_burst(op):
    rng = np.random.default_rng({"eigh": 1, "svd": 2, "pca": 3}[op])
    dims = [5, 7, 12, 6, 14, 8, 3, 10, 6, 11, 16, 9]
    if op == "eigh":
        return [sym(n, seed=i) for i, n in enumerate(dims)]
    return [rng.standard_normal((n + 4, n)).astype(np.float32)
            for n in dims]


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_server_on_the_card_sync_matches_async_bitwise(cuda_device, op):
    """``PCAServer()`` runs on the card by default; a pipelined run serves
    every field bitwise as the synchronous one, through the path's
    kernels, and within the fp32 budget of the CPU server."""
    import dataclasses
    from repro_torch.serving import BucketPolicy, LocalExecutor, PCAServer
    mats = _served_burst(op)
    cfg = tpca.PCAConfig(T=8, S=4, sweeps=12, fused=True, backend="cuda")
    runs = []
    for depth in (1, 3):
        srv = PCAServer(cfg, policy=BucketPolicy(T=8), max_delay_s=1e9,
                        max_inflight=depth)
        assert srv.executor.device.type == "cuda"
        before = launch_counts()
        runs.append(srv.solve_many(mats, op=op))
        moved = _launched(before)
        assert moved.get("jacobi_sweep_smem", 0) > 0, moved
        if op != "eigh":
            assert moved.get("covariance", 0) > 0, moved
        if op == "svd":
            assert moved.get("mm_engine_matmul", 0) > 0, moved
    cpu = PCAServer(tpca.PCAConfig(T=8, S=4, sweeps=12, fused=True),
                    policy=BucketPolicy(T=8), max_delay_s=1e9,
                    executor=LocalExecutor(device="cpu")).solve_many(mats,
                                                                     op=op)
    field = "S" if op == "svd" else "eigenvalues"
    for sync, pipelined, host in zip(*runs, cpu):
        for f in dataclasses.fields(sync):
            np.testing.assert_array_equal(getattr(pipelined, f.name),
                                          getattr(sync, f.name))
        assert_contract(getattr(sync, field), getattr(host, field),
                        "rel_frobenius", 1e-4)


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_executor_submit_makes_no_host_sync(cuda_device, op):
    """The dispatch stage never blocks the host: the batch and its true
    sizes go through pinned memory, the pair table is on the card, so
    ``submit`` runs under ``set_sync_debug_mode("error")``; the flush's
    event then says when it is done, and ``result`` is one host tree."""
    from repro_torch.serving import LocalExecutor
    from repro_torch.serving.batching import stack_requests
    mats = _served_burst(op)[:4]
    shape = (16, 16) if op == "eigh" else (24, 16)
    batch, n_active = stack_requests(mats, shape)
    ex = LocalExecutor()
    fn = ex.compile(op, tpca.PCAConfig(T=8, sweeps=12, fused=True,
                                       backend="cuda"), shape, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flush = ex.submit(fn, batch, n_active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert flush.block_until_ready().ready()
    host = flush.result()
    assert all(isinstance(v, np.ndarray) for v in host)
    want = ex.run(fn, batch, n_active)
    for g, w in zip(host, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_mesh_executor_on_the_card_is_bitwise_the_local_executor(
        cuda_device, op):
    """A ``MeshExecutor`` over ``cuda:0`` serves every field bitwise as
    the ``LocalExecutor`` does, through the path's kernels, with no host
    sync in ``submit``."""
    import dataclasses
    from repro_torch.serving import (BucketPolicy, LocalExecutor,
                                     MeshExecutor, PCAServer, host_mesh)
    mats = _served_burst(op)
    cfg = tpca.PCAConfig(T=8, S=4, sweeps=12, fused=True, backend="cuda")
    want = PCAServer(cfg, policy=BucketPolicy(T=8), max_delay_s=1e9,
                     executor=LocalExecutor()).solve_many(mats, op=op)
    for mesh in (host_mesh(1),):
        ex = MeshExecutor(mesh=mesh)
        submit = ex.submit

        def guarded(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return submit(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        ex.submit = guarded
        srv = PCAServer(cfg, policy=BucketPolicy(T=8), max_delay_s=1e9,
                        max_inflight=3, executor=ex)
        before = launch_counts()
        got = srv.solve_many(mats, op=op)
        assert _launched(before).get("jacobi_sweep_smem", 0) > 0
        assert {r.n_shards for r in srv.stats.records} == {mesh.size}
        for g, w in zip(got, want):
            for f in dataclasses.fields(g):
                np.testing.assert_array_equal(getattr(g, f.name),
                                              getattr(w, f.name))


def test_fit_distributed_on_one_card_is_the_plain_fit(cuda_device):
    """Over a 1-card mesh ``fit_distributed`` is ``fit`` with the plain
    config (``torch.matmul`` Gram, unfused solve) bit for bit, and within
    the fp32 budget of the kernels' fit."""
    from repro_torch.serving import host_mesh
    X = data(4000, 48, seed=5)
    cfg = tpca.PCAConfig(T=64, sweeps=12)
    got = tpca.fit_distributed(X, host_mesh(1), cfg)
    assert got.eigenvalues.device == cuda_device
    plain = tpca.fit(X, cfg, device=cuda_device)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    kernels = tpca.fit(X, tpca.PCAConfig(T=64, sweeps=12, fused=True,
                                         backend="cuda"), device=cuda_device)
    assert_contract(got.eigenvalues, kernels.eigenvalues, "rel_frobenius",
                    1e-4)


def _control_spec(**obs):
    from repro_torch.serving import (ExecutionSpec, ObsSpec, SchedulingSpec,
                                     ServerSpec)
    return ServerSpec(
        scheduling=SchedulingSpec(mode="pow2", T=16, max_batch=4,
                                  max_delay_s=0.02, max_inflight=3),
        execution=ExecutionSpec(backend="cuda", fused=True, sweeps=12),
        obs=ObsSpec(**obs))


def test_paced_frontend_on_the_card_matches_the_virtual_run(cuda_device,
                                                           tmp_path):
    """A spec-built server on the card (kernels, obs armed) serves a small
    paced open-loop stream: the worker thread dispatches flushes, the main
    thread's ``drain`` retires the rest, and every result is bitwise the
    one a virtual-clock run of the same stream serves."""
    from repro_torch.obs import validate_trace
    from repro_torch.serving import (TenantSpec, TrafficFrontend,
                                     VirtualClock, build_server, generate,
                                     merge)
    tenants = (TenantSpec("whale"), TenantSpec("mouse", weight=2.0))
    stream = merge(
        generate("poisson", rate=300.0, n=24, tenants=tenants[:1], seed=3,
                 trace="uniform", lo=20, hi=40),
        generate("poisson", rate=100.0, n=8, tenants=tenants[1:], seed=4,
                 op="eigh", trace="uniform", lo=6, hi=14))
    spec = _control_spec(slo_ms=5000.0,
                         trace_out=str(tmp_path / "trace.json"))
    reports = {}
    for pace in (False, True):
        clock = VirtualClock() if not pace else None
        srv = build_server(spec, clock=clock, device=cuda_device)
        assert srv.executor.device.type == "cuda"
        before = launch_counts()
        fe = TrafficFrontend(srv, tenants, slo_ms=5000.0, admission="none",
                             seed=1)
        reports[pace] = fe.run(stream, pace=pace)
        assert srv.inflight() == 0 and srv.pending() == 0
        moved = _launched(before)
        assert moved.get("jacobi_sweep_smem", 0) > 0, moved  # n <= 64
        assert validate_trace(srv.obs.trace_doc()) == []
    virtual, paced = reports[False], reports[True]
    assert paced.served == virtual.served == len(stream)
    assert paced.outcomes == virtual.outcomes
    assert paced.digest == virtual.digest  # every result's bytes


def test_device_profile_records_the_kernels_on_the_card(cuda_device,
                                                        tmp_path):
    """``device_profile`` around a fused fit on the card writes a Chrome
    trace whose CUDA kernel events name the hand-written kernels."""
    import json
    from repro_torch.obs import device_profile
    x = torch.from_numpy(data(512, 48, seed=2)).to(cuda_device)
    cfg = tpca.PCAConfig(fused=True, backend="cuda", sweeps=8)
    tpca.fit(x, cfg)  # build the kernels outside the profile
    with device_profile(str(tmp_path)):
        tpca.fit(x, cfg)
        torch.cuda.synchronize()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {e.get("name") for e in events if e.get("cat") == "kernel"}
    assert any("sweep" in str(k) for k in kernels), sorted(map(str, kernels))
    assert any("gram_kernel" in str(k) for k in kernels), kernels


# -- the dense LM serving path and the PCA consumers ----------------------------

@contextlib.contextmanager
def _flash_held_at_op(monkeypatch, held):
    """Inside the block every ``ops.flash_attention`` call with
    bf16 operands is held at the op, right after it (decode writes the
    cache in place): the kernel's output within one bf16 ulp plus 2e-5 of
    the plain version's fp32 result on the same operands.  Appends the
    count of values beyond that to ``held``, one entry a call."""
    from repro_torch.backends import registry
    kernel = ops.flash_attention

    def call(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        if out.dtype == torch.bfloat16:
            with registry.use_backend("torch"):
                want32 = kernel(q.float(), k.float(), v.float(), **kw)
            g = out.float()
            slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) + 2e-5
            held.append(int(((g - want32).abs() > slack).sum()))
        return out

    with monkeypatch.context() as m:
        m.setattr(ops, "flash_attention", call)
        yield


def _lm_steps(model, cfg, tokens, forced, monkeypatch):
    """Prefill and teacher-forced decode logits (true vocabulary, fp32)
    through the kernels, each step checked to launch one kernel a layer
    and, in bf16, each layer's flash call held at the op
    (``_flash_held_at_op``), and with attention on the flash op's
    ``torch`` backend."""
    from repro_torch.backends import registry
    from repro_torch.models import transformer as tfm
    v = cfg.vocab_size
    bf16 = cfg.dtype == "bfloat16"
    prefill_kernel = ("flash_attention_mma" if bf16
                      else "flash_attention_tf32x3")

    def through_kernels(fn, *args, **kw):
        held = []
        before = launch_counts()
        with _flash_held_at_op(monkeypatch, held):
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        assert held == ([0] * cfg.n_layers if bf16 else []), held
        return out, _launched(before)

    (logits, state), moved = through_kernels(
        tfm.prefill, model, {"tokens": tokens}, cfg, cache_len=72)
    assert moved == {prefill_kernel: cfg.n_layers}
    with registry.use_backend("torch"):
        want, plain = tfm.prefill(model, {"tokens": tokens}, cfg,
                                  cache_len=72)
    got, ref = [logits[:, :v].float()], [want[:, :v].float()]
    for tok in forced:
        (logits, state), moved = through_kernels(tfm.decode_step, model,
                                                 state, tok, cfg)
        assert moved == {"flash_attention_splitkv": cfg.n_layers}
        with registry.use_backend("torch"):
            want, plain = tfm.decode_step(model, plain, tok, cfg)
        got.append(logits[:, :v].float())
        ref.append(want[:, :v].float())
    return got, ref


@pytest.mark.parametrize("arch,overrides", [("olmo-1b", {}),
                                            ("granite-8b",
                                             {"n_kv_heads": 2})],
                         ids=["olmo_mha", "granite_gqa"])
def test_lm_prefill_and_decode_through_the_kernels(cuda_device, arch,
                                                   overrides, monkeypatch):
    """Reduced olmo-1b (MHA) and granite-8b (GQA, G = 2) in bf16 and in
    fp32 on the same weights (the bf16 ones cast).  fp32: the logits of
    the kernels within n_layers x 2e-5 (the fp32 flash kernels' contract
    a call) of the plain attention's.  bf16: step by step, within sqrt(2)
    x bf16's own noise, the plain bf16 run's distance from the plain fp32
    run: bf16 rounding turns any difference between two runs into whole
    bf16 steps within a few layers, so two bf16 runs end up as two draws
    of that noise, sqrt(2) x its size apart when independent.  That bound
    is all of bf16's noise, so each bf16 flash call is also held at the
    op: the prefill's 64 queries over the 72-slot cache (its zero tail
    past the prompt) and each decode step's query over keys 0..pos."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm
    cfg = reduced_config(arch, dtype="bfloat16", **overrides)
    cfg32 = reduced_config(arch, **overrides)
    model = tfm.init_model(cfg, seed=0, device=cuda_device)
    model32 = tfm.Transformer(cfg32, cuda_device)
    model32.load_state_dict({k: t.float()
                             for k, t in model.state_dict().items()})
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           device=cuda_device)
    forced = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                           device=cuda_device)
    got16, plain16 = _lm_steps(model, cfg, tokens, forced, monkeypatch)
    got32, plain32 = _lm_steps(model32, cfg32, tokens, forced, monkeypatch)
    for step in range(len(got16)):
        assert_contract(got32[step], plain32[step], "rel_frobenius",
                        2e-5 * cfg.n_layers)
        floor = 2 ** 0.5 * rel_frobenius(plain16[step], plain32[step])
        assert rel_frobenius(got16[step], plain16[step]) <= floor, step


@contextlib.contextmanager
def _scan_held_at_op(monkeypatch, held):
    """Inside the block every ``ops.mamba_scan`` call is held at the op:
    its y and final state within rtol = atol = 1e-4 of the plain
    version's on the same operands.  Appends True or False a call."""
    from repro_torch.backends import registry
    kernel = ops.mamba_scan

    def call(*args, **kw):
        out = kernel(*args, **kw)
        with registry.use_backend("torch"):
            want = kernel(*args, **kw)
        held.append(all(torch.allclose(g.float(), w.float(), rtol=1e-4,
                                       atol=1e-4)
                        for g, w in zip(out, want)))
        return out

    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan", call)
        yield


def _family_steps(model, cfg, tokens, forced, monkeypatch):
    """``_lm_steps`` for a stack of mamba and attention layers: each step
    launches ``mamba_scan`` once a mamba layer (prefill only) and one
    flash kernel an attention layer, every scan call held at the op
    (``_scan_held_at_op``) and, in bf16, every flash call too."""
    from repro_torch.backends import registry
    from repro_torch.models import transformer as tfm
    v = cfg.vocab_size
    bf16 = cfg.dtype == "bfloat16"
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")

    def through_kernels(fn, want, scans, *args, **kw):
        flash, held = [], []
        before = launch_counts()
        with _flash_held_at_op(monkeypatch, flash), \
                _scan_held_at_op(monkeypatch, held):
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        assert _launched(before) == {k: n for k, n in want.items() if n}
        assert held == [True] * scans
        assert flash == ([0] * n_attn if bf16 else [])
        return out

    prefill_kernel = ("flash_attention_mma" if bf16
                      else "flash_attention_tf32x3")
    logits, state = through_kernels(
        tfm.prefill, {"mamba_scan": n_mamba, prefill_kernel: n_attn},
        n_mamba, model, {"tokens": tokens}, cfg, cache_len=72)
    with registry.use_backend("torch"):
        want, plain = tfm.prefill(model, {"tokens": tokens}, cfg,
                                  cache_len=72)
    got, ref_ = [logits[:, :v].float()], [want[:, :v].float()]
    for tok in forced:
        logits, state = through_kernels(
            tfm.decode_step, {"flash_attention_splitkv": n_attn}, 0, model,
            state, tok, cfg)
        with registry.use_backend("torch"):
            want, plain = tfm.decode_step(model, plain, tok, cfg)
        got.append(logits[:, :v].float())
        ref_.append(want[:, :v].float())
    return got, ref_


@pytest.mark.parametrize("arch,overrides", [
    ("falcon-mamba-7b", {}),
    ("jamba-v0.1-52b", {"n_layers": 2, "attn_every": 2, "moe_every": 2})],
    ids=["falcon_mamba", "jamba_2layer"])
def test_ssm_and_hybrid_through_the_kernels(cuda_device, arch, overrides,
                                            monkeypatch):
    """Reduced falcon-mamba (2 mamba layers) and the 2-layer jamba
    stand-in (a mamba layer, an attention layer with MoE) in bf16 and in
    fp32 on the same weights: each scan call held at the op (rtol = atol
    = 1e-4, y and the final state) and each bf16 flash call too; fp32
    logits within n_layers x 1e-4 (the larger contract a call) of the
    plain versions', bf16 logits within sqrt(2) x bf16's own noise."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm
    cfg = reduced_config(arch, dtype="bfloat16", **overrides)
    cfg32 = reduced_config(arch, **overrides)
    model = tfm.init_model(cfg, seed=0, device=cuda_device)
    model32 = tfm.Transformer(cfg32, cuda_device)
    model32.load_state_dict({k: t.float()
                             for k, t in model.state_dict().items()})
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           device=cuda_device)
    forced = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                           device=cuda_device)
    got16, plain16 = _family_steps(model, cfg, tokens, forced, monkeypatch)
    got32, plain32 = _family_steps(model32, cfg32, tokens, forced,
                                   monkeypatch)
    for step in range(len(got16)):
        assert_contract(got32[step], plain32[step], "rel_frobenius",
                        1e-4 * cfg.n_layers)
        floor = 2 ** 0.5 * rel_frobenius(plain16[step], plain32[step])
        assert rel_frobenius(got16[step], plain16[step]) <= floor, step


# -- the encdec and vlm families ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_whisper_shapes(cuda_device, dtype):
    """whisper-small's three new callers at B 32 x 12 heads of 64: the
    encoder (non-causal 1500 x 1500), the cross prefill (non-causal 64
    queries over 1500 keys) and the cross decode (one query, non-causal,
    split-KV), each one launch of its kernel, within 2e-5 (fp32) or one
    bf16 ulp + 2e-5 of the plain fp32 result (bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for sq, skv in ((1500, 1500), (64, 1500), (1, 1500)):
        q, k, v = (torch.randn(384, s, 64, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        before = launch_counts()
        got = ops.flash_attention(q, k, v, causal=False)
        kernel = flash_attention.choose_kernel(sq, dtype)
        assert _launched(before) == {kernel.name: 1}
        want = ref.flash_attention(q.float(), k.float(), v.float(),
                                   causal=False)
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 2e-5, (sq, skv)
        else:
            slack = bf16_ulp(torch.maximum(got.float().abs(), want.abs()))
            assert bool((err <= slack + 2e-5).all()), (sq, skv)


def _encdec_steps(model, cfg, batch, forced, monkeypatch):
    """``_lm_steps`` with the stub inputs in ``batch``: a prefill launches
    one prefill kernel a flash call (an encoder layer's, a decoder
    layer's self and cross attention), a decode step one split-KV kernel
    a call (self and cross), every bf16 call held at the op."""
    from repro_torch.backends import registry
    from repro_torch.models import transformer as tfm
    v = cfg.vocab_size
    bf16 = cfg.dtype == "bfloat16"
    L = cfg.n_layers
    calls = ((cfg.encoder_layers + 2 * L, 2 * L) if cfg.family == "encdec"
             else (L, L))
    prefill_kernel = ("flash_attention_mma" if bf16
                      else "flash_attention_tf32x3")
    cache_len = batch["tokens"].shape[1] + 8 + cfg.n_patches

    def through_kernels(fn, kernel, n, *args, **kw):
        held = []
        before = launch_counts()
        with _flash_held_at_op(monkeypatch, held):
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        assert _launched(before) == {kernel: n}
        assert held == ([0] * n if bf16 else []), held
        return out

    logits, state = through_kernels(tfm.prefill, prefill_kernel, calls[0],
                                    model, batch, cfg, cache_len=cache_len)
    with registry.use_backend("torch"):
        want, plain = tfm.prefill(model, batch, cfg, cache_len=cache_len)
    got, ref_ = [logits[:, :v].float()], [want[:, :v].float()]
    for tok in forced:
        logits, state = through_kernels(
            tfm.decode_step, "flash_attention_splitkv", calls[1], model,
            state, tok, cfg)
        with registry.use_backend("torch"):
            want, plain = tfm.decode_step(model, plain, tok, cfg)
        got.append(logits[:, :v].float())
        ref_.append(want[:, :v].float())
    return got, ref_


@pytest.mark.parametrize("arch,overrides", [
    ("whisper-small", {"n_frames": 80}), ("llava-next-34b", {})],
    ids=["whisper", "llava"])
def test_encdec_and_vlm_through_the_kernels(cuda_device, arch, overrides,
                                            monkeypatch):
    """Reduced whisper (80 frames, so that the encoder's calls take the
    prefill kernels) and reduced llava (8 patches, GQA over 1 KV head) in
    bf16 and in fp32 on the same weights and seeded frames or patches:
    every bf16 flash call held at the op; fp32 logits within (layers,
    encoder's too) x 2e-5 of plain attention's, bf16 logits within
    sqrt(2) x bf16's own noise."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm
    cfg = reduced_config(arch, dtype="bfloat16", **overrides)
    cfg32 = reduced_config(arch, **overrides)
    model = tfm.init_model(cfg, seed=0, device=cuda_device)
    model32 = tfm.Transformer(cfg32, cuda_device)
    model32.load_state_dict({k: t.float()
                             for k, t in model.state_dict().items()})
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           device=cuda_device)
    forced = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                           device=cuda_device)
    key, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
              else ("patches", cfg.n_patches))
    stub = torch.randn(2, n, cfg.d_model, generator=g, device=cuda_device)
    batch = {"tokens": tokens, key: stub.to(torch.bfloat16)}
    got16, plain16 = _encdec_steps(model, cfg, batch, forced, monkeypatch)
    got32, plain32 = _encdec_steps(model32, cfg32, batch, forced,
                                   monkeypatch)
    layers = cfg.n_layers + cfg.encoder_layers
    for step in range(len(got16)):
        assert_contract(got32[step], plain32[step], "rel_frobenius",
                        2e-5 * layers)
        floor = 2 ** 0.5 * rel_frobenius(plain16[step], plain32[step])
        assert rel_frobenius(got16[step], plain16[step]) <= floor, step


def test_kv_compression_sweep_kernel_is_bitwise_the_plain_sweep(cuda_device):
    from repro_torch.backends import registry
    from repro_torch.models import kv_compression as kvc
    from repro_torch.serving.solver import jacobi_eigh_batched
    g = torch.Generator(device=cuda_device).manual_seed(0)
    basis = torch.randn(4, 128, 24, generator=g, device=cuda_device)
    coef = torch.randn(2, 512, 4, 24, generator=g, device=cuda_device)
    k = torch.einsum("bskr,kdr->bskd", coef, basis) + 0.05 * torch.randn(
        2, 512, 4, 128, generator=g, device=cuda_device)
    xf = k.permute(2, 0, 1, 3).reshape(4, 1024, 128)
    before = launch_counts()
    gram = ops.covariance(xf) / 1024
    res = jacobi_eigh_batched(gram, sweeps=12, pivot="parallel", fused=True)
    torch.cuda.synchronize()
    assert _launched(before) == {"covariance": 1, "jacobi_sweep_smem": 12}
    with registry.use_backend("torch"):
        plain_gram = ops.covariance(xf) / 1024
        plain = jacobi_eigh_batched(gram, sweeps=12, pivot="parallel",
                                    fused=True)
    assert_contract(gram, plain_gram, "rel_frobenius", 1e-6)
    assert_contract(res.eigenvalues, plain.eigenvalues, "bitwise")
    assert_contract(res.eigenvectors, plain.eigenvectors, "bitwise")
    # the whole consumer: two solves (K and V), each one launch a sweep
    before = launch_counts()
    err, ratio = kvc.attention_error(
        torch.randn(2, 4, 1, 128, generator=g, device=cuda_device), k, k,
        kvc.KVCompressionConfig(rank=32, sweeps=12), 128 ** -0.5)
    torch.cuda.synchronize()
    assert _launched(before) == {"covariance": 2, "jacobi_sweep_smem": 24}
    assert err.is_cuda and 0 <= float(err) < 0.5 and ratio == 0.25


# -- the differentiable ops (kernels.grad) ----------------------------------------

FA_GRAD_SHAPES = [  # (BH, Sq, Skv, D, causal, q_offset, chunk)
    (4, 256, 256, 128, True, 0, 64),
    (4, 200, 333, 64, True, 133, 128),
    (6, 96, 500, 20, False, 0, 1024),
    (2, 1024, 1024, 128, True, 0, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FA_GRAD_SHAPES, ids=str)
def test_flash_attention_gradients_on_the_card(cuda_device, shape, dtype):
    """The attention Function (the kernel forward, the torch FA-2
    backward) against autograd through the plain fp32 version of the same
    operands: fp32 within 1e-5 relative Frobenius; bf16 each value within
    one bf16 ulp of the larger, plus 2e-5 x max |want| (fp32 arithmetic,
    rounded once)."""
    bh, sq, skv, d, causal, q_offset, chunk = shape
    g = torch.Generator(device=cuda_device).manual_seed(sq + skv + d)
    q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda_device)
               .to(dtype).requires_grad_(True) for n in (sq, skv, skv))
    dout = torch.randn(bh, sq, d, generator=g, device=cuda_device).to(dtype)
    before = launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, scale=d ** -0.5,
                              q_offset=q_offset, chunk=chunk)
    got = torch.autograd.grad(out, (q, k, v), dout)
    after = launch_counts()
    kernel = flash_attention.choose_kernel(sq, dtype).name
    assert after[kernel] == before[kernel] + 1
    args = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(
        *args, causal=causal, scale=d ** -0.5, q_offset=q_offset), args,
        dout.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            assert rel_frobenius(a, b) <= 1e-5
            continue
        a = a.float()
        slack = bf16_ulp(torch.maximum(a.abs(), b.abs())) \
            + 2e-5 * float(b.abs().max())
        assert bool(((a - b).abs() <= slack).all())


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("shape", [(2, 300, 64, 16, 256), (1, 77, 40, 5, 32),
                                   (3, 512, 128, 16, 100)], ids=str)
def test_mamba_scan_gradients_on_the_card(cuda_device, shape, return_state):
    """The scan Function (the kernel forward, the chunked adjoint) against
    autograd through the plain version: within 1e-5 relative Frobenius."""
    b, length, d, n, chunk = shape
    g = torch.Generator(device=cuda_device).manual_seed(length + d + n)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    args = [randn(b, length, d),
            torch.nn.functional.softplus(randn(b, length, d) - 3.0),
            -torch.rand(d, n, generator=g, device=cuda_device) * 4,
            randn(b, length, n), randn(b, length, n), randn(d)]
    args = [t.requires_grad_(True) for t in args]
    cots = (randn(b, length, d), randn(b, d, n))
    before = launch_counts()["mamba_scan"]
    out = ops.mamba_scan(*args, chunk=chunk, return_state=return_state)
    outs = out if return_state else (out,)
    got = torch.autograd.grad(outs, args, cots[:len(outs)])
    assert launch_counts()["mamba_scan"] == before + 1
    want = torch.autograd.grad(
        ref.mamba_scan(*args, return_state=return_state), args,
        cots[:len(outs)] if return_state else cots[0])
    for a, w in zip(got, want):
        assert rel_frobenius(a, w) <= 1e-5


def test_train_step_on_the_card(cuda_device):
    """A reduced olmo-1b train step through the trainer's step builder on
    the kernels: one flash launch a layer forward and one a layer in the
    recompute, the loss and gradients in fp32 within n_layers x 2e-5 of
    the same step on plain attention."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.backends import registry
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(configs.reduced_config("olmo-1b"), remat=True)
    model = tfm.init_model(cfg, seed=0, device=cuda_device, train=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96),
                           generator=torch.Generator().manual_seed(0)).to(
        cuda_device)
    params = list(model.parameters())

    def grads():
        loss, _ = tfm.loss_fn(model, {"tokens": tokens}, cfg)
        return loss.detach(), torch.autograd.grad(loss, params)

    before = launch_counts()["flash_attention_tf32x3"]
    loss, got = grads()
    assert launch_counts()["flash_attention_tf32x3"] == \
        before + 2 * cfg.n_layers
    with registry.use_backend("torch"):
        want_loss, want = grads()
    assert launch_counts()["flash_attention_tf32x3"] == \
        before + 2 * cfg.n_layers
    tol = cfg.n_layers * 2e-5
    assert abs(float(loss) - float(want_loss)) <= tol * abs(float(want_loss))
    for a, b in zip(got, want):
        assert rel_frobenius(a, b) <= tol


def test_world_of_one_nccl_train_step_on_the_card(cuda_device, tmp_path):
    """A train step on a mesh bound to a NCCL process group of one rank
    (the driver's machine has one card) equals the one-device step:
    the same loss, gradient norm and updated parameters, bit for bit
    (every collective spans one rank and is elided)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import Mesh
    cfg = configs.reduced_config("olmo-1b")
    shape = ShapeCell("t", 32, 2, "train")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    collectives.init_world("cuda", store_path=str(tmp_path / "store"),
                           rank=0, world_size=1)
    try:
        mesh = Mesh.from_world((1, 1), ("data", "model"))
        assert mesh.bound and mesh.device == cuda_device
        results = []
        for kw in ({"mesh": mesh}, {"device": cuda_device}):
            step, _ = steps.build_train_step(cfg, shape, **kw)
            model = tfm.init_model(cfg, seed=0, device=cuda_device,
                                   train=True)
            params = dict(model.named_parameters())
            state = steps.TrainState(
                model, adamw.init(params, adamw.AdamWConfig()),
                torch.zeros((), dtype=torch.int32, device=cuda_device))
            collectives.reset_counts()
            _, metrics = step(state, {"tokens": tokens})
            results.append((float(metrics["loss"]),
                            float(metrics["grad_norm"]),
                            [p.detach().clone() for p in params.values()],
                            collectives.counts()))
    finally:
        collectives.close_world()
    (la, ga, pa, ca), (lb, gb, pb, _) = results
    assert (la, ga) == (lb, gb) and ca == {}
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


# -- the persistent executable tier: a CUDA graph a flush key -----------------

SERVE_CFG = dict(fused=True, backend="cuda", sweeps=50, T=64, S=32)


@pytest.fixture
def hopper(cuda_device):
    """The card, where its capability is (9, 0): the graphs hold sm_90a
    kernels."""
    if torch.cuda.get_device_capability(cuda_device) != (9, 0):
        pytest.skip("the captured kernels are built for sm_90a: needs a "
                    "capability-(9, 0) card")
    return cuda_device


def _phase6_buckets(op):
    """Every bucket chip_smoke.py's serve phase gives ``op``, with the
    stacked (batch, n_active) of its requests."""
    import importlib.util
    import pathlib
    from repro_torch.serving import BucketPolicy
    from repro_torch.serving.batching import stack_requests
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    policy = BucketPolicy(T=64, mode="pow2")
    buckets = {}
    for a in smoke.flush_requests()[op]:
        buckets.setdefault(policy.bucket_shape(a.shape), []).append(a)
    return {shape: stack_requests(mats, shape)
            for shape, mats in sorted(buckets.items())}


def _padded(batch, n_active, rows):
    b = batch.shape[0]
    return (np.concatenate([batch, np.zeros((rows - b, *batch.shape[1:]),
                                            batch.dtype)]),
            np.concatenate([n_active, np.zeros((2, rows - b), np.int32)],
                           axis=1))


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_graph_replay_is_bitwise_the_eager_solve(hopper, op):
    """For every (op, bucket) of the serve phase, the key's CUDA graph
    (``aot_compile``: captured, replayed once and held to the eager solve
    on seeded inputs) replays the served requests bitwise as the eager
    solver solves them."""
    from repro_torch.serving import LocalExecutor
    from repro_torch.serving.sharded import GraphedSolver
    ex = LocalExecutor()
    cfg = tpca.PCAConfig(**SERVE_CFG)
    for shape, (batch, n_active) in _phase6_buckets(op).items():
        graphed = ex.aot_compile(op, cfg, shape, 32)
        assert isinstance(graphed, GraphedSolver)
        x, sizes = _padded(batch, n_active, 32)
        xt = torch.from_numpy(x).to(hopper)
        nt = torch.from_numpy(sizes).to(hopper)
        want = ex.compile(op, cfg, shape, 32)(xt, nt[0], nt[-1])
        got = graphed(xt, nt[0], nt[-1])
        for g, w in zip(got, want):
            assert torch.equal(g, w), (op, shape)


def test_cooperative_grid_sweep_is_captured(hopper):
    """At n = 256 the sweep runs on the cooperative grid kernel: its launch
    is captured as a cooperative node and every replay matches the eager
    solve, on the seeded inputs and on others."""
    from repro_torch.serving import LocalExecutor
    ex = LocalExecutor()
    cfg = tpca.PCAConfig(**SERVE_CFG)
    graphed = ex.aot_compile("eigh", cfg, (256, 256), 8)
    assert graphed.record["plan"]["sweep"]["kernel"] == "jacobi_sweep"
    assert graphed.record["launches"] == {"jacobi_sweep": 50}
    fn = ex.compile("eigh", cfg, (256, 256), 8)
    sizes = torch.tensor([256, 200, 256, 3, 256, 256, 128, 255],
                         dtype=torch.int32, device=hopper)
    for seed in range(3):
        x = torch.from_numpy(np.stack(
            [sym(256, seed=8 * seed + i) for i in range(8)])).to(hopper)
        want = fn(x, sizes, sizes)
        got = graphed(x, sizes, sizes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert graphed.replays == 3


def test_inflight_flushes_of_one_key_do_not_alias(hopper, tmp_path):
    """Depth 3 with back-to-back flushes of one key (each replay
    overwrites the graph's outputs) serves bitwise what depth 1 and the
    eager server serve."""
    import dataclasses
    from repro_torch.serving import (CacheSpec, ExecutionSpec, PCAServer,
                                     SchedulingSpec, ServerSpec)
    mats = [sym(100 + (i % 28), seed=i) for i in range(4 * 32)]
    runs = []
    for depth, cache in ((1, None), (1, tmp_path), (3, tmp_path)):
        srv = PCAServer.from_spec(ServerSpec(
            scheduling=SchedulingSpec(mode="pow2", T=64, max_batch=32,
                                      max_inflight=depth),
            execution=ExecutionSpec(backend="cuda", fused=True, sweeps=50),
            cache=CacheSpec(cache_dir=None if cache is None
                            else str(cache))))
        tickets = [srv.submit(m, op="eigh") for m in mats]
        if depth == 3:
            assert srv.inflight() == 2   # four flushes, two still in flight
        srv.drain()
        runs.append([t.result() for t in tickets])
    for eager, graphed1, graphed3 in zip(*runs):
        for f in dataclasses.fields(eager):
            np.testing.assert_array_equal(getattr(graphed1, f.name),
                                          getattr(eager, f.name))
            np.testing.assert_array_equal(getattr(graphed3, f.name),
                                          getattr(eager, f.name))


_FRESH = """\
import json, sys, warnings
warnings.simplefilter("ignore")
import numpy as np
from repro_torch.core.pca import PCAConfig
from repro_torch.kernels import build
from repro_torch.serving import BucketPolicy, PCAServer, TrafficProfile
srv = PCAServer(PCAConfig(fused=True, backend="cuda", sweeps=50, T=64, S=4),
                policy=BucketPolicy(T=64, mode="pow2"), cache_dir=sys.argv[1])
doc = srv.warmup(TrafficProfile.from_shapes(json.loads(sys.argv[2])))
mats = [np.load(p) for p in sys.argv[3:]]
res = srv.solve_many(mats[:2], op="eigh") + srv.solve_many(mats[2:], op="svd")
print(json.dumps({"warmup": doc, "nvcc_runs": build.nvcc_runs(),
                  "values": [np.asarray(r.eigenvalues if hasattr(
                      r, "eigenvalues") else r.S).tolist() for r in res]}))
"""


def test_disk_hit_in_a_fresh_process_runs_no_nvcc(hopper, tmp_path):
    """A replica in a fresh process with an empty build directory warms
    every key from the cache directory: no nvcc run, no compile, and its
    results are this process's bit for bit."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    from repro_torch.serving import BucketPolicy, PCAServer, TrafficProfile
    shapes = [("eigh", (100, 100), 1), ("svd", (300, 200), 1)]
    mats = [sym(100, seed=1), sym(90, seed=2),
            data(300, 200, seed=3), data(260, 150, seed=4)]
    seeder = PCAServer(tpca.PCAConfig(fused=True, backend="cuda", sweeps=50,
                                      T=64, S=4),
                       policy=BucketPolicy(T=64, mode="pow2"),
                       cache_dir=str(tmp_path / "cache"))
    seeded = seeder.warmup(TrafficProfile.from_shapes(shapes))
    assert seeded["compile"] == seeded["executables"] == 2
    want = (seeder.solve_many(mats[:2], op="eigh")
            + seeder.solve_many(mats[2:], op="svd"))
    paths = []
    for i, m in enumerate(mats):
        paths.append(str(tmp_path / f"m{i}.npy"))
        np.save(paths[-1], m)
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env[build.BUILD_ENV] = str(tmp_path / "empty_build")
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, str(tmp_path / "cache"),
         json.dumps(shapes), *paths], env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads(out.stdout.splitlines()[-1])
    assert doc["nvcc_runs"] == 0
    assert doc["warmup"]["disk"] == doc["warmup"]["executables"] == 2
    assert doc["warmup"]["compile"] == 0
    for got, res in zip(doc["values"], want):
        w = res.eigenvalues if hasattr(res, "eigenvalues") else res.S
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)


def test_launch_range_names_the_sweep_kernel_the_card_runs(cuda_device):
    """Under a profiler each flush's ``repro.launch:`` range names the
    sweep kernel its solve launches (``fused.sweep_plan`` at the flush's
    padded batch and width): 128 wide on the shared-memory kernel, 256
    wide on the grid kernel, and each launch range holds its flush's
    sweeps on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import BucketPolicy, PCAServer
    srv = PCAServer(tpca.PCAConfig(fused=True, backend="cuda", sweeps=4,
                                   T=64, S=2),
                    policy=BucketPolicy(T=64, mode="pow2"), max_batch=2,
                    max_delay_s=1e9)
    mats = [sym(100, seed=1), sym(120, seed=2), sym(200, seed=3)]
    srv.solve_many(mats)  # the kernels build outside the trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv.solve_many(mats)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    names = sorted(e.name() for e in events
                   if e.device_type() != torch.autograd.DeviceType.CUDA
                   and e.name().startswith("repro.launch:"))
    assert names == ["repro.launch:eigh:128x128:2/2:n128:s4:smem",
                     "repro.launch:eigh:256x256:1/2:n256:s4:grid"]
    kernels = [e.name() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("sweep_smem_kernel" in k for k in kernels) == 4
    assert sum("sweep_grid_kernel" in k for k in kernels) == 4
