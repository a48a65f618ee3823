"""The yardstick's counts give PERF.md's bounds at the fit's shape."""
import pytest

import small  # noqa: F401  (puts the checkout on sys.path)
from pcabench import counts


def test_sweep_bound_at_784_is_perf_mds():
    assert counts.sweep_flops(784) == 9 * 784 ** 3
    assert counts.sweep_bound_s(784) * 1e3 == pytest.approx(0.0647, abs=5e-5)


def test_fp32_gram_bound_at_mnist_is_perf_mds():
    ms = counts.gram_flops(70000, 784) / counts.PEAK_FP32 * 1e3
    assert ms == pytest.approx(0.643, abs=5e-4)
    # the covariance roofline's bound: the TF32 tensor rate, 87 us
    assert counts.gram_bound_s(70000, 784) * 1e6 == pytest.approx(87.0,
                                                                  abs=0.1)


def test_fit_flops_match_the_issue_total():
    total = counts.fit_flops(70000, 784, 32, 50)
    assert total == pytest.approx(2.64e11, rel=0.01)
    assert total == (counts.standardize_flops(70000, 784)
                     + counts.gram_flops(70000, 784)
                     + 50 * counts.sweep_flops(784)
                     + counts.projection_flops(70000, 784, 32))


@pytest.mark.parametrize("op,shape,want", [
    ("eigh", (100, 100), 50 * 9 * 100 ** 3),
    ("svd", (300, 200), 300 * 200 * 201 + 50 * 9 * 200 ** 3
     + 2 * 300 * 200 ** 2),
    ("pca", (1000, 64), 6 * 1000 * 64 + 1000 * 64 * 65 + 50 * 9 * 64 ** 3),
])
def test_request_flops_at_the_requests_own_size(op, shape, want):
    assert counts.request_flops(op, shape, 50) == want


def test_bound_is_the_larger_of_operations_and_bytes():
    assert counts.bound_s(67e12, 0.0, counts.PEAK_FP32) == 1.0
    assert counts.bound_s(0.0, 3.35e12, counts.PEAK_FP32) == 1.0
