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
matmul to 1e-6 and the bf16-output matmul to 1e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pca as tpca
from repro_torch.core.jacobi import cyclic_pairs, round_robin_rounds
from repro_torch.kernels import fused, launch_counts, mm_engine, ref

from _torch_parity import assert_contract, cuda_device, sym  # noqa: F401

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
    assert all(after[k] > before[k] for k in after)
    Yc, cpu = tpca.fit_transform(X, 5, tpca.PCAConfig(fused=True, sweeps=12),
                                 device="cpu")
    assert_contract(res.eigenvalues.cpu(), cpu.eigenvalues, "rel_frobenius",
                    1e-5)
    assert Y.device.type == "cuda" and Y.shape == (500, 5)
