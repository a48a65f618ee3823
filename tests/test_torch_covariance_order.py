"""The fused Gram against the unfused one, in the port and the reference.

The reference promises that its fp32 fused Gram is bitwise equal to
``blocked_covariance`` at the same ``block_m`` (``tests/test_fused.py``,
``tests/test_precision.py``): both sum the ``block_m``-row panels' Grams
in order.  The port's plain Gram (the ``torch`` backend of the
``covariance`` op, what a CPU tensor takes) sums the same zero-padded
panels in the same order, so on the CPU:
  * the fp32 fused Gram is bitwise ``blocked_covariance`` at the same
    ``block_m``;
  * ``fit(fused=True)`` is bitwise ``fit(fused=False)``.
Across the two frameworks the panels' products differ at the ulp level:
the port's fused Gram is held to relative Frobenius 1e-6 of the
reference's.  The CUDA Gram is held to the unfused one at 1e-6 on the
card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.core.covariance import blocked_covariance as jblocked
from repro_torch.core import pca as tpca
from repro_torch.core.covariance import blocked_covariance as tblocked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_contract, data

# (m, n, block_m): whole panels, a ragged last panel, one short panel
CASES = [(128, 16, 32), (1000, 24, 128), (333, 20, 64), (50, 12, 64),
         (4096, 8, 1024)]


@pytest.mark.parametrize("m,n,block_m", CASES)
def test_fused_gram_is_bitwise_the_blocked_gram(m, n, block_m):
    x = torch.from_numpy(data(m, n, seed=m))
    fused = tblocked(x, block_m=block_m, fused=True)
    unfused = tblocked(x, block_m=block_m)
    assert_contract(fused, unfused, "bitwise")


@pytest.mark.parametrize("m,n,block_m", CASES[:3])
def test_fused_gram_matches_the_reference(m, n, block_m):
    x = data(m, n, seed=m)
    got = tblocked(torch.from_numpy(x), block_m=block_m, fused=True)
    want = jblocked(x, block_m=block_m, fused=True, backend="interpret")
    assert_contract(got, want, "rel_frobenius", 1e-6)


def test_batched_gram_sums_each_problem_in_panels():
    x = torch.from_numpy(np.stack([data(300, 10, seed=s)
                                   for s in range(3)]))
    got = tops.covariance(x, block_m=64)
    for b in range(3):
        assert_contract(got[b], tblocked(x[b], block_m=64), "bitwise")
    # block_m 0: one product, as before the panels
    assert_contract(tref.covariance_gram(x[0]), x[0].mT @ x[0], "bitwise")


@pytest.mark.parametrize("angle", ["rutishauser", "cordic"])
def test_fused_fit_is_bitwise_the_unfused_fit(angle):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((1000, 24))
         * np.geomspace(3, 0.3, 24)).astype(np.float32)
    fits = [tpca.fit(X, tpca.PCAConfig(fused=fused, sweeps=10, angle=angle),
                     device="cpu") for fused in (True, False)]
    assert_contract(fits[0].eigenvalues, fits[1].eigenvalues, "bitwise")
    assert_contract(fits[0].components, fits[1].components, "bitwise")
