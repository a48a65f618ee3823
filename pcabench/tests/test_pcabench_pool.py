"""The serve pools keep to each mix's ranges, and every seed serves the
same sizes; the data is a function of the seed."""
import json

import numpy as np
import pytest
import torch

import small
from pcabench.reference import data

MIXES = ["serve_mixed", "serve_small"]


def mix(name):
    return json.loads((small.ROOT / "pcabench" / "traffic"
                       / f"{name}.json").read_text())["pool"]


@pytest.mark.parametrize("name", MIXES)
def test_pool_keeps_to_its_ranges(name):
    spec = mix(name)
    lo, hi = spec["width"]["lo"], spec["width"]["hi"]
    rows = spec["rows_per_width"]
    reqs = data.pool_shapes(spec)
    assert [r.op for r in reqs] == [op for op in spec["ops"]
                                    for _ in range(spec["count"])]
    for r in reqs:
        m, n = r.shape
        assert lo <= n <= hi
        assert m == (n if r.op == "eigh" else rows * n)


@pytest.mark.parametrize("name", MIXES)
def test_pool_widths_are_heavy_tailed(name):
    """Most widths sit near the low end, a few far above it."""
    spec = mix(name)
    lo, hi = spec["width"]["lo"], spec["width"]["hi"]
    n = np.array([r.shape[1] for r in data.pool_shapes(spec)])
    assert np.median(n) - lo < 0.1 * (hi - lo)
    assert n.max() - lo > 0.5 * (hi - lo)


def test_heavy_widths_follow_their_tail():
    """lo + scale * Lomax(alpha) before rounding and the clip: a width
    rounds above w where the draw is at least w + 1/2, which it is with
    probability (1 + (w + 1/2 - lo) / scale)^-alpha."""
    n = np.array(data.heavy_widths(200000, 96, 10 ** 6, 1.5, 3.0,
                                   np.random.default_rng(1)))
    for w in (99, 126):
        want = (1 + (w + 0.5 - 96) / 3.0) ** -1.5
        assert abs((n > w).mean() - want) < 0.01


def test_small_mix_is_at_most_128_wide():
    reqs = data.pool_shapes(mix("serve_small"))
    assert max(r.shape[1] for r in reqs) <= 128      # n, or pca's d
    assert min(r.shape[1] for r in reqs) > 64        # above one tile


def test_mixed_mix_reaches_the_256_bucket():
    reqs = data.pool_shapes(mix("serve_mixed"))
    assert any(r.shape[1] > 128 for r in reqs)


def test_seed_changes_the_data_not_the_sizes():
    reqs = data.pool_shapes(dict(mix("serve_small"), **small.SMALL_POOL))
    a = data.pool_data(reqs, data.generator(2 ** 31 + 11, "cpu"), "cpu")
    b = data.pool_data(reqs, data.generator(2 ** 31 + 11, "cpu"), "cpu")
    c = data.pool_data(reqs, data.generator(5, "cpu"), "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    for r, x in zip(reqs, a):
        assert x.shape == r.shape and x.dtype == np.float32
        assert x.flags.c_contiguous
        if r.op == "eigh":
            assert np.array_equal(x, x.T)


def test_datasets_are_seeded_and_low_rank():
    cfg = {"rank": 4, "decay": [1.0, 0.5], "noise": 0.05}
    g = data.generator(123, "cpu")
    x, y = data.datasets(2, 400, 16, cfg, g, "cpu")
    x2, _ = data.datasets(2, 400, 16, cfg, data.generator(123, "cpu"), "cpu")
    assert torch.equal(x, x2) and not torch.equal(x, y)
    s = torch.linalg.svdvals(x.double() - x.double().mean(0))
    assert s[4] < 0.2 * s[3]   # four components above the noise
