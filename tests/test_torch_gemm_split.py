"""The arithmetic and the routing of the tensor-core GEMM tile shared by the
MM-Engine and the Gram kernel (``csrc/gemm_tile.cuh``), on the CPU (no card,
no nvcc).

* fp32 operands go through three tf32 products, hi*hi + hi*lo + lo*hi with
  hi = x rounded to tf32 and lo = x - hi, of which the tensor core reads
  the top 19 bits.  On a standardized 4096 x 256 Gram (``chip_smoke.py``'s
  recipe) that stays within 1e-6 of the float64 Gram (emulated: 1.0e-8),
  where one tf32 product lands beyond the fp32 policy's 1e-5 budget
  (emulated: 1.7e-5).  ``tf32`` below is the kernel's rounding, two integer
  operations on the bits, which round as ``cvt.rna.tf32.f32`` does: to 10
  mantissa bits, ties away from zero; ``truncate`` is what the tensor core
  does to lo.
* bf16 operands go through one product: bf16 products are exact in fp32.
* The tensor core sums an mma's products into its accumulator input with
  truncation.  Fed the running sum, a Gram's diagonal of 20000 rows drifts
  beyond the 1e-5 budget (the first card run, without the flush, put the
  70000-row Gram 7.8e-5 from its plain version); a k step summed from zero
  and added to the sum with a rounded fp32 add (``add_step``) stays near
  fp32.
* ``mm_engine.choose_kernel`` routes every layout to the tensor-core
  kernel, with the copied dim, the copy width and the element step it
  picks: an operand with no unit stride in its last two dims is copied
  one element a copy along its smaller stride (0 for an expanded one).
  The kernel's address formula, base + row * ld + col * step, rebuilds
  each operand from its flat storage.  The Gram kernel's copy width
  follows the base and the row length.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.precision import ERROR_BUDGETS
from repro_torch.kernels import fused, launch, mm_engine

from _torch_parity import rel_frobenius


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (ties away from zero), as float32:
    adding half a tf32 unit to the magnitude bits and cutting the low 13
    rounds the magnitude, whatever the sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor core reads from a float32: its top 19
    bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) as the kernel's products see them."""
    hi = tf32(x)
    return hi, truncate(x - hi)


def standardized(m: int, n: int, seed: int = 0) -> torch.Tensor:
    """``chip_smoke.synthetic_dataset``: decaying rank-32 factors plus
    noise, then standardized per column."""
    rng = np.random.default_rng(seed)
    k = min(n, 32)
    base = rng.standard_normal((m, k)) * np.geomspace(1, 0.05, k)
    mix = rng.standard_normal((k, n)) / np.sqrt(k)
    x = (base @ mix + 0.05 * rng.standard_normal((m, n))).astype(np.float32)
    x = x.astype(np.float64)
    return torch.from_numpy(((x - x.mean(0)) / x.std(0)).astype(np.float32))


def products(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b from tf32 operands, each product summed in float64 (what the
    split contributes, apart from the fp32 accumulator's own rounding)."""
    ah, al = (t.double() for t in split(a))
    bh, bl = (t.double() for t in split(b))
    if not three:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


@pytest.fixture(scope="module")
def gram_input():
    return standardized(4096, 256)


def test_three_tf32_products_keep_the_gram_fp32_accurate(gram_input):
    x = gram_input
    want = x.double().mT @ x.double()
    err = rel_frobenius(products(x.mT, x, three=True), want)
    assert err <= 1e-6, err


def test_one_tf32_product_breaks_the_fp32_budget(gram_input):
    """Why the split is there: one rounding of each operand to tf32 puts
    this Gram beyond the fp32 covariance budget."""
    x = gram_input
    want = x.double().mT @ x.double()
    err = rel_frobenius(products(x.mT, x, three=False), want)
    assert err > ERROR_BUDGETS["fp32"]["covariance"], err


def test_three_tf32_products_keep_the_projection_fp32_accurate():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2048, 784)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((784, 32)).astype(np.float32))
    want = a.double() @ b.double()
    assert rel_frobenius(products(a, b, three=True), want) <= 1e-6
    assert rel_frobenius(products(a, b, three=False), want) > 1e-5


def test_tf32_split_is_exact_and_short():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100000)
                          * 10.0 ** rng.integers(-20, 20, 100000)
                          ).astype(np.float32))
    hi, lo = split(x)
    low13 = 0x1FFF
    assert bool(((hi.view(torch.int32) & low13) == 0).all())
    assert bool(((lo.view(torch.int32) & low13) == 0).all())
    # x - hi is exact in fp32, so hi + (x - hi) gives x back
    assert torch.equal(hi + (x - hi), x)
    # the half-unit rounding of hi leaves at most 2^-11 of |x|, and the
    # truncation of lo at most 2^-21 more
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all())
    # ties go away from zero, as cvt.rna does
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def _truncated(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_truncating_sums_need_the_per_step_flush():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    want = (x.astype(np.float64) ** 2).sum(0)  # the Gram's diagonal
    sq = (x.astype(np.float64) ** 2).reshape(-1, 8, 64)  # k8 steps
    running = np.zeros(64, np.float32)
    flushed = np.zeros(64, np.float32)
    for step in sq:
        # the mma: products and accumulator input summed, then truncated
        running = _truncated(running.astype(np.float64) + step.sum(0))
        flushed = flushed + _truncated(step.sum(0))  # rounded fp32 add
    budget = ERROR_BUDGETS["fp32"]["covariance"]
    assert rel_frobenius(running, want) > budget
    assert rel_frobenius(flushed, want) < budget / 10


def test_bf16_products_are_exact_in_fp32():
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal(100000).astype(np.float32)
                             * 10.0 ** rng.integers(-15, 15, 100000)
                             .astype(np.float32)).bfloat16().float()
            for _ in range(2))
    assert torch.equal((a * b).double(), a.double() * b.double())


def _randn(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0)
                       ).to(dtype)


F32, BF16 = torch.float32, torch.bfloat16
# (name, a, b, narrow, a's (contiguous, ld, copy bytes, step), b's)
ROUTES = [
    ("contiguous projection", lambda: _randn(100, 784),
     lambda: _randn(784, 32), True, ("k", 784, 16, 1), ("mn", 32, 16, 1)),
    ("a.mT (unfused Gram)", lambda: _randn(784, 100).mT,
     lambda: _randn(784, 40), False, ("mn", 100, 16, 1), ("mn", 40, 16, 1)),
    ("J.mT, batched", lambda: _randn(3, 64, 64).mT,
     lambda: _randn(3, 64, 64), False, ("mn", 64, 16, 1), ("mn", 64, 16, 1)),
    ("column slice components[:, :k]", lambda: _randn(50, 784),
     lambda: _randn(784, 784)[:, :32], True, ("k", 784, 16, 1),
     ("mn", 784, 16, 1)),
    ("odd leading strides", lambda: _randn(100, 70),
     lambda: _randn(70, 33), False, ("k", 70, 8, 1), ("mn", 33, 4, 1)),
    ("b.mT, contiguous along k", lambda: _randn(64, 48),
     lambda: _randn(32, 48).mT, True, ("k", 48, 16, 1), ("k", 48, 16, 1)),
    ("offset view", lambda: _randn(100 * 64 + 2)[2:].view(100, 64),
     lambda: _randn(64 * 20 + 1)[1:].view(64, 20), True, ("k", 64, 8, 1),
     ("mn", 20, 4, 1)),
    ("batch stride 0", lambda: _randn(64, 48).expand(3, 64, 48),
     lambda: _randn(3, 48, 40), False, ("k", 48, 16, 1), ("mn", 40, 16, 1)),
    ("bf16, odd n", lambda: _randn(100, 64, dtype=BF16),
     lambda: _randn(64, 33, dtype=BF16), False, ("k", 64, 16, 1),
     ("mn", 33, 2, 1)),
    ("bf16, n of 4", lambda: _randn(100, 70, dtype=BF16),
     lambda: _randn(70, 4, dtype=BF16), True, ("k", 70, 4, 1),
     ("mn", 4, 8, 1)),
    ("general stride", lambda: _randn(100, 128)[:, ::2],
     lambda: _randn(64, 32), True, ("k", 128, 4, 2), ("mn", 32, 16, 1)),
    ("general stride in b", lambda: _randn(100, 64),
     lambda: _randn(128, 64)[::2, ::2], True, ("k", 64, 16, 1),
     ("mn", 128, 4, 2)),
    ("rows and columns strided", lambda: _randn(300, 128)[::3, ::2],
     lambda: _randn(64, 40), False, ("k", 384, 4, 2), ("mn", 40, 16, 1)),
    ("a strided along m", lambda: _randn(64, 200)[::2, ::3].mT,
     lambda: _randn(32, 20), True, ("mn", 400, 4, 3), ("mn", 20, 16, 1)),
    ("expanded b, step 0", lambda: _randn(100, 64),
     lambda: _randn(64, 2)[:, :1].expand(64, 40), False, ("k", 64, 16, 1),
     ("mn", 2, 4, 0)),
    ("expanded b, unit stride along k", lambda: _randn(100, 64),
     lambda: _randn(64, 1).expand(64, 40), False, ("k", 64, 16, 1),
     ("k", 0, 16, 1)),
    ("bf16 strided a", lambda: _randn(100, 128, dtype=BF16)[:, ::2],
     lambda: _randn(64, 32, dtype=BF16), True, ("k", 128, 2, 2),
     ("mn", 32, 16, 1)),
    ("batched strided a", lambda: _randn(3, 100, 128)[:, :, ::2],
     lambda: _randn(64, 32), True, ("k", 128, 4, 2), ("mn", 32, 16, 1)),
]


@pytest.mark.parametrize("name,make_a,make_b,narrow,la,lb", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_choose_kernel_routes_each_layout(name, make_a, make_b, narrow, la,
                                          lb):
    a, b = make_a(), make_b()
    route = mm_engine.choose_kernel(a, b)
    assert route.kernel is mm_engine.MM_ENGINE
    assert route.kernel.name == "mm_engine_matmul"
    assert route.narrow == narrow
    for got, want in ((route.a, la), (route.b, lb)):
        assert (got.contiguous, got.ld, got.copy_bytes, got.step) == want
        if got.step != 1:  # one element a copy
            assert got.copy_bytes == a.element_size()
    # the plain version on the CPU computes what the kernel does
    torch.testing.assert_close(mm_engine.mm_engine(a, b),
                               (a.double() @ b.double()).to(a.dtype),
                               rtol=1e-2 if a.dtype == BF16 else 1e-5,
                               atol=1e-2 if a.dtype == BF16 else 1e-4)


def _rebuild(t: torch.Tensor, layout, inner: int) -> torch.Tensor:
    """Operand ``t`` read from its flat storage at the kernel's addresses:
    element (mn, kk) of batch z at base + z * batch_stride +
    mn * ld + kk * step when copies run along k, kk * ld + mn * step when
    they run along mn (mn is a's row or b's column)."""
    es = t.element_size()
    flat = torch.empty(0, dtype=t.dtype).set_(
        t.untyped_storage(), 0, (t.untyped_storage().nbytes() // es,), (1,))
    rows, cols = t.shape[-2:]
    mn_size, k_size = (rows, cols) if inner == -1 else (cols, rows)
    batch = t.shape[0] if t.ndim == 3 else 1
    z = torch.arange(batch)[:, None, None]
    mn = torch.arange(mn_size)[None, :, None]
    kk = torch.arange(k_size)[None, None, :]
    if layout.contiguous == "k":
        off = mn * layout.ld + kk * layout.step
    else:
        off = kk * layout.ld + mn * layout.step
    got = flat[t.storage_offset() + z * layout.batch_stride + off]
    return got if inner == -1 else got.mT  # back to b's (k, n)


@pytest.mark.parametrize("name,make_a,make_b,narrow,la,lb", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_layout_addresses_rebuild_each_operand(name, make_a, make_b, narrow,
                                               la, lb):
    a, b = make_a(), make_b()
    route = mm_engine.choose_kernel(a, b)
    for t, layout, inner in ((a, route.a, -1), (b, route.b, -2)):
        want = t if t.ndim == 3 else t[None]
        assert torch.equal(_rebuild(t, layout, inner), want), name


def test_batch_strides_take_part_in_the_copy_width():
    # batch stride 66 (an odd multiple of 2 floats): 8-byte copies
    a = torch.as_strided(_randn(3 * 66), (3, 8, 8), (66, 8, 1))
    b = _randn(3, 8, 8)
    route = mm_engine.choose_kernel(a, b)
    assert route.a.batch_stride == 66 and route.a.copy_bytes == 8
    assert route.b.batch_stride == 64 and route.b.copy_bytes == 16
    # a batch of one, or a 2-D operand, has batch stride 0
    one = mm_engine.choose_kernel(_randn(1, 8, 8), _randn(8, 8))
    assert one.a.batch_stride == 0 and one.b.batch_stride == 0


@pytest.mark.parametrize("dtype,n,want", [(F32, 784, 16), (F32, 70, 8),
                                          (F32, 33, 4), (BF16, 784, 16),
                                          (BF16, 70, 4), (BF16, 33, 2),
                                          (BF16, 4, 8)])
def test_gram_copy_width_follows_the_row_length(dtype, n, want):
    """The Gram kernel reads contiguous x: rows n, batches m * n apart."""
    x = _randn(10, n, dtype=dtype)
    assert launch.copy_bytes(x, n, 10 * n) == want
    assert launch.copy_bytes(x[None], n, 10 * n) == want


def test_cov_slices_tile_edge_and_the_main_path():
    """70000 x 784 at 132 SMs: 28 upper tiles of 128, nine slices of 8192
    rows fill 252 of the 264 block slots in one wave."""
    assert fused.COV_TILE == 128
    splits, per = fused.cov_slices(70000, 784, 1, 1024, 132)
    assert (splits, per) == (9, 8192)
    assert fused.cov_slices(0, 784, 1, 1024, 132) == (1, 0)
