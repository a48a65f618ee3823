"""The four standalone registry ops of the port (``dle_find_pivot``,
``cordic_rotate``, ``flash_attention``, ``mamba_scan``) against the JAX
reference.

The plain versions in ``repro_torch.kernels.ref`` are what the CUDA kernels
compute; here they are held against the Pallas kernels run in interpret
mode, as the reference's own tests run them on the CPU:
  * ``dle_scan``: bitwise (value, flat index), ties and the diagonal-only
    matrix included -- the kernel's tile order, not ``find_pivot``'s;
  * ``cordic_rotation_params_q29``: bitwise (theta, cos, sin) where the
    reference's power-of-two scale is exact, magnitudes in (2^-13, 2^12]
    (see test_torch_cordic);
  * ``flash_attention``: 2e-5 max abs in fp32; in bf16 the kernel's output
    within one bf16 ulp plus 2e-5 of the plain version's fp32 result (two
    fp32 sums 1e-7 apart round to bf16 values many ulps apart near zero);
  * ``mamba_scan``: rtol = atol = 1e-4, the reference's own tolerance.
The ``torch`` backend of each op is held against the reference's ``ref``
backend: identical pivots, CORDIC angles within 3e-7 of the float oracle.
The kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import dle as jdle_core
from repro.kernels import cordic as jcordic
from repro.kernels import dle as jdle
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.backends import registry
from repro_torch.core import dle as tdle_core
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

from _torch_parity import assert_contract, bf16_ulp

SEVEN_OPS = {"mm_engine_matmul", "dle_find_pivot", "cordic_rotate",
             "flash_attention", "mamba_scan", "covariance", "jacobi_sweep"}


def _sym(n: int, seed: int) -> np.ndarray:
    c = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return c + c.T


def _diagonal_only() -> np.ndarray:
    return np.diag(np.arange(1, 9)).astype(np.float32)


def _cross_tile_tie() -> np.ndarray:
    c = np.zeros((8, 8), np.float32)
    c[0, 5] = c[5, 0] = c[1, 2] = c[2, 1] = 3.0
    return c


# -- dle_scan ---------------------------------------------------------------

def _dle_both(c: np.ndarray, tile: int):
    jv, ji = jdle.dle_scan(jnp.asarray(c), tile=tile, interpret=True)
    tv, ti = ref.dle_scan(torch.from_numpy(c), tile)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    return (float(tv), int(ti)), (float(jv), int(ji))


@pytest.mark.parametrize("n,tile", [(64, 32), (100, 32), (33, 16),
                                    (256, 128)])
def test_dle_scan_plain_matches_pallas_kernel(n, tile):
    got, want = _dle_both(_sym(n, seed=n), tile)
    assert got == want
    c = _sym(n, seed=n)
    assert got[0] == np.abs(c * (1 - np.eye(n, dtype=np.float32))).max()


@pytest.mark.parametrize("case,flat", [("diagonal_only", 1),
                                       ("cross_tile_tie", 10)])
def test_dle_scan_plain_keeps_the_kernels_tie_order(case, flat):
    """The tile-order scan returns (0, 1) on a diagonal matrix and the
    tie in the earlier tile, (1, 2); the flat ``find_pivot`` returns (0, 0)
    and (0, 5)."""
    c = _diagonal_only() if case == "diagonal_only" else _cross_tile_tie()
    got, want = _dle_both(c, tile=4)
    assert got == want and got[1] == flat
    piv = tdle_core.find_pivot(torch.from_numpy(c))
    assert int(piv.p) * 8 + int(piv.q) == (0 if case == "diagonal_only"
                                           else 5)


def test_dle_scan_plain_without_a_candidate():
    """n = 1 has no off-diagonal entry: the TPU kernel's reset value."""
    got, want = _dle_both(np.ones((1, 1), np.float32), tile=4)
    assert got == want == (-1.0, 0)


# -- cordic_rotation_params -------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 64, 300, 4096])
def test_cordic_q29_plain_matches_pallas_kernel(k):
    rng = np.random.default_rng(k)
    apq, app, aqq = (rng.uniform(-3, 3, k).astype(np.float32)
                     for _ in range(3))
    mag = np.maximum(np.abs(2 * apq), np.abs(app - aqq))
    keep = (mag > 2.0 ** -13) & (mag <= 2.0 ** 12)
    assert keep.sum() >= k - 1
    args = [a[keep] for a in (apq, app, aqq)]
    want = jcordic.cordic_rotation_params(*map(jnp.asarray, args),
                                          block=256, interpret=True)
    got = ref.cordic_rotation_params_q29(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_cordic_kernel_constants():
    """The standalone kernel's seed round(2^29 / K), in the plain version
    and in csrc/cordic.cu; the atan table both CORDIC kernels share."""
    import pathlib
    import re
    from repro.core import cordic as jcore
    seed = int(round(float(1 << jcore._FRAC_BITS) / jcore._GAIN))
    assert ref.CORDIC_X0_KERNEL == seed == 326016437
    csrc = pathlib.Path(tops.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "cordic.cu").read_text()
    assert re.search(r"kX0 = (\d+);", src).group(1) == str(seed)
    shared = (csrc / "cordic.cuh").read_text()
    table = re.search(r"kAtanFixed\[CORDIC_ITERS\] = \{([^}]*)\}", shared)
    assert [int(v) for v in table.group(1).split(",")] == list(
        jcore._ATAN_FIXED)


# -- flash_attention --------------------------------------------------------

def _qkv(bh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,d", [(2, 64, 64, 32), (4, 96, 96, 64),
                                         (1, 128, 256, 64)])
def test_flash_attention_plain_matches_pallas_kernel(bh, sq, skv, d, causal):
    q, k, v = _qkv(bh, sq, skv, d, seed=bh * sq)
    off = skv - sq if causal else 0
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                block_q=32, block_k=32, q_offset=off,
                                backend="interpret")
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, q_offset=off)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5


def test_flash_attention_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(2, 64, 64, 32, seed=3)
    want = jops.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        block_q=32, block_k=32, backend="interpret")
    qkv = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = ref.flash_attention(*qkv, causal=True)
    assert got.dtype == torch.bfloat16
    fp32 = ref.flash_attention(*(t.float() for t in qkv), causal=True)
    assert bool((got == fp32.bfloat16()).all())
    want = torch.from_numpy(np.asarray(want, np.float32))
    slack = bf16_ulp(torch.maximum(want.abs(), fp32.abs())) + 2e-5
    assert bool(((want - fp32).abs() <= slack).all())


def test_flash_attention_past_the_prefix_matches_the_oracle():
    """With q_offset > Skv - Sq the TPU wrapper lets its zero-padded keys
    in; the port masks by the true Skv and agrees with the dense oracle."""
    q, k, v = _qkv(2, 8, 20, 16, seed=0)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                q_offset=30)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block_q=16, block_k=16,
                               q_offset=30)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5
    padded = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  block_q=16, block_k=16, q_offset=30,
                                  backend="interpret")
    assert np.abs(np.asarray(padded) - np.asarray(want)).max() > 1e-2


# -- mamba_scan -------------------------------------------------------------

def _scan_inputs(b, l, d, n):
    rng = np.random.default_rng(l)
    return (rng.standard_normal((b, l, d)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, l, d)).astype(np.float32),
            -rng.uniform(0.5, 2, (d, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((d,)).astype(np.float32))


@pytest.mark.parametrize("b,l,d,n,chunk", [(2, 50, 16, 8, 16),
                                           (1, 128, 32, 16, 32),
                                           (3, 33, 8, 4, 8)])
def test_mamba_scan_plain_matches_pallas_kernel(b, l, d, n, chunk):
    args = _scan_inputs(b, l, d, n)
    want = jops.mamba_scan(*map(jnp.asarray, args), chunk=chunk,
                           backend="interpret")
    got = ref.mamba_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# -- the torch backend of each op against the reference's ref backend --------

@pytest.mark.parametrize("n", [26, 33])
def test_dle_find_pivot_torch_backend_matches_ref(n):
    c = _sym(n, seed=43)
    want = jops.dle_find_pivot(jnp.asarray(c), tile=16, backend="ref")
    got = tops.dle_find_pivot(torch.from_numpy(c), tile=16)
    for g, w in zip(got, want):
        assert_contract(g, w, "bitwise")


def test_cordic_rotate_torch_backend_matches_ref():
    rng = np.random.default_rng(44)
    apq, app, aqq = (rng.uniform(-3, 3, 33).astype(np.float32)
                     for _ in range(3))
    want = jops.cordic_rotation_params(*map(jnp.asarray, (apq, app, aqq)),
                                       block=16, backend="ref")
    got = tops.cordic_rotate(*map(torch.from_numpy, (apq, app, aqq)),
                             block=16)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 3e-7
    # the rotation zeroes the pivot: apq' = sc(app - aqq) + (c^2 - s^2) apq
    _, c, s = (t.numpy().astype(np.float64) for t in got)
    apq2 = s * c * (app - aqq) + (c ** 2 - s ** 2) * apq
    np.testing.assert_allclose(apq2, 0.0, atol=1e-5)


def test_ops_take_scalars_and_follow_the_tensor():
    """A CPU tensor resolves to ``torch``; a scalar pivot is one pivot."""
    registry.reset_resolution_counts()
    th, c, s = tops.cordic_rotate(torch.tensor(1.0), torch.tensor(2.0),
                                  torch.tensor(0.5))
    assert th.shape == (1,)
    assert registry.resolution_counts() == {("cordic_rotate", "torch"): 1}


def test_registry_lists_all_seven_ops():
    assert set(registry.registered_ops()) == SEVEN_OPS
    for op in SEVEN_OPS:
        assert registry.backends_for(op) == ("cuda", "torch")


def test_to_port_carries_a_pivot():
    c = _sym(12, seed=5)
    piv = jdle_core.find_pivot(jnp.asarray(c))
    got = convert.to_port(piv, device="cpu")
    assert type(got) is tdle_core.Pivot
    want = tdle_core.find_pivot(torch.from_numpy(c))
    for g, w in zip(got, want):
        assert int(g) == int(w) if not g.is_floating_point() else \
            float(g) == float(w)
