"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Every test here is marked ``cuda`` and skips on a host without one;
the file imports nothing of JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Contracts: the Jacobi round is bitwise equal to the plain version on the
card (the kernel rounds every product and sum as the separate PyTorch
operations do); the Gram and the matmul sum in another order than cuBLAS:
the Gram is held to the fp32 covariance budget, relative Frobenius 1e-5
(over 1000 samples the bf16 case measured 1.3e-6 on an H100), the fp32
matmul to 1e-6 and the bf16-output matmul to 1e-2.  The standalone
kernels: the DLE scan identical in (value, index), ties included; the
CORDIC unit bitwise; flash attention within 2e-5 in fp32 and, in bf16,
within one bf16 ulp plus 2e-5 of the plain version's fp32 result (two fp32
sums 1e-7 apart round to bf16 values many ulps apart near zero); the
selective scan within rtol = atol = 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pca as tpca
from repro_torch.core.jacobi import cyclic_pairs, round_robin_rounds
from repro_torch.kernels import (cordic, dle, flash_attention, fused,
                                 launch_counts, mamba_scan, mm_engine, ref)

from _torch_parity import (assert_contract, bf16_ulp,  # noqa: F401
                           cuda_device, sym)

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


@pytest.mark.parametrize("angle", ANGLES)
def test_jacobi_sweep_kernel_bitwise(cuda_device, angle):
    n = 66
    C = torch.from_numpy(np.stack([sym(n, seed=s) for s in range(2)])).to(
        cuda_device)
    V = torch.randn(2, n, n, device=cuda_device)
    for pairs in (round_robin_rounds(n)[7], cyclic_pairs(n)[40]):
        p = torch.from_numpy(pairs).to(cuda_device)
        got = fused.jacobi_sweep_step(C, V, p, angle=angle)
        want = ref.jacobi_sweep_step(C, V, p, angle=angle)
        for g, w in zip(got, want):
            assert_contract(g, w, "bitwise")


def test_jacobi_sweep_kernel_out_buffers_and_bad_pairs(cuda_device):
    n = 8
    C = torch.from_numpy(sym(n)).to(cuda_device)
    V = torch.eye(n, device=cuda_device)
    pairs = torch.tensor([[0, 1], [2, 3], [4, 99]], dtype=torch.int32,
                         device=cuda_device)
    out = (torch.empty_like(C), torch.empty_like(V))
    Co, Vo = fused.jacobi_sweep_step(C, V, pairs, out=out)
    assert Co.data_ptr() == out[0].data_ptr()
    # the out-of-range pair is no rotation: rows/cols 4.. pass through
    assert bool((Co[4:, 4:] == C[4:, 4:]).all())
    with pytest.raises(ValueError, match="alias"):
        fused.jacobi_sweep_step(C, V, pairs, out=(C, out[1]))


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


def test_fit_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((500, 24))
         * np.geomspace(3, 0.3, 24)).astype(np.float32)
    cfg = tpca.PCAConfig(fused=True, backend="cuda", sweeps=12)
    before = launch_counts()
    Y, res = tpca.fit_transform(X, 5, cfg, device=cuda_device)
    after = launch_counts()
    for name in ("covariance", "jacobi_sweep", "mm_engine_matmul"):
        assert after[name] > before[name], name
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
    # Sq and Skv not multiples of 64; D 40, 64, 128 (the tensor-core kernel
    # in bf16) and 20 (the SIMT kernel in bf16); non-causal over a ragged
    # Skv; q_offset < 0
    cases += [(2, 130, 333, 64, True, 203), (2, 70, 190, 40, True, 120),
              (1, 129, 129, 128, True, 0), (2, 90, 100, 20, True, 10),
              (1, 200, 77, 128, False, 0), (2, 80, 200, 64, True, -30),
              (1, 33, 65, 128, True, -40)]
    # decode: one, several and a ragged last split of 256 keys
    cases += [(2, sq, skv, 64, True, skv - sq) for sq in (1, 7, 16)
              for skv in (1, 255, 3000)]
    cases += [(3, 16, 700, 128, False, 0), (1, 7, 300, 20, True, -3)]
    for bh, sq, skv, d, causal, off in cases:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for s in (sq, skv, skv))
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              q_offset=off)
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
    Sq <= 16, the tensor-core kernel for bf16 prefill with D % 8 == 0, the
    SIMT kernel for the rest."""
    shapes = [(1, torch.bfloat16, 64, "flash_attention_splitkv"),
              (16, torch.float32, 128, "flash_attention_splitkv"),
              (17, torch.bfloat16, 128, "flash_attention_mma"),
              (100, torch.bfloat16, 40, "flash_attention_mma"),
              (100, torch.bfloat16, 20, "flash_attention_simt"),
              (100, torch.float32, 128, "flash_attention_simt")]
    for sq, dtype, d, name in shapes:
        q, k, v = (torch.randn(2, s, d, device=cuda_device).to(dtype)
                   for s in (sq, 90, 90))
        before = launch_counts()
        flash_attention.flash_attention(q, k, v, q_offset=90 - sq)
        after = launch_counts()
        moved = {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}
        assert moved == {name: 1}, (sq, dtype, d, moved)
        assert flash_attention.choose_kernel(sq, d, dtype).name == name


def test_mamba_scan_kernel(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for b, L, D, N in [(2, 50, 16, 8), (1, 300, 200, 16), (3, 33, 8, 4)]:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=cuda_device)
        u, Bm, Cm = rnd(b, L, D), rnd(b, L, N), rnd(b, L, N)
        dt = torch.rand(b, L, D, generator=g, device=cuda_device) * 0.19 \
            + 0.01
        A = -(torch.rand(D, N, generator=g, device=cuda_device) * 1.5 + 0.5)
        Dskip = rnd(D)
        got = mamba_scan.mamba_scan(u, dt, A, Bm, Cm, Dskip)
        want = ref.mamba_scan(u, dt, A, Bm, Cm, Dskip)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
