"""The choice among the three ``flash_attention`` kernels, and plain-PyTorch
emulations of parts of their designs, on the CPU (no card, no nvcc).

* ``choose_kernel`` picks split-KV for Sq <= 16, the 3xTF32 kernel for fp32
  prefill and the bf16 tensor-core kernel for bf16 prefill, both at any D
  and alignment.  ``copy_floats`` gives the 3xTF32 kernel's copy width,
  ``copy_elems`` the bf16 kernel's: 8, 4 or 2 bf16 a cp.async, or one
  element, which divides D and to which every base is aligned.  The bf16
  kernel's copy plan writes each tile row once, zeros in [D, DP), and its
  output store writes nothing past D.
* The tensor-core kernel splits P into bf16 halves for P V.  At BH 2,
  S 1024, D 128, rounding P once to bf16 (as SDPA does) puts outputs
  beyond the bf16 contract, one bf16 ulp + 2e-5 of the fp32 plain
  version's result; P_hi + P_lo keeps every output within it.
* The split-KV kernel's merge: a split whose keys are all masked takes part
  with m = -1e30 and l = its key count, a split with no keys takes none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

from _torch_parity import bf16_ulp

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("sq,d,dtype,aligned,name", [
    (1, 128, BF16, True, "flash_attention_splitkv"),
    (16, 128, F32, True, "flash_attention_splitkv"),
    (7, 20, BF16, False, "flash_attention_splitkv"),
    (17, 128, BF16, True, "flash_attention_mma"),
    (4096, 40, BF16, True, "flash_attention_mma"),
    (4096, 8, BF16, True, "flash_attention_mma"),
    (4096, 20, BF16, True, "flash_attention_mma"),
    (4096, 128, BF16, False, "flash_attention_mma"),
    (4096, 128, F32, True, "flash_attention_tf32x3"),
    (17, 64, F32, True, "flash_attention_tf32x3"),
    (4096, 20, F32, False, "flash_attention_tf32x3"),
    (100, 7, F32, True, "flash_attention_tf32x3"),
    (100, 1, BF16, True, "flash_attention_mma"),
    (100, 7, BF16, True, "flash_attention_mma"),
    (100, 19, BF16, True, "flash_attention_mma"),
    (100, 64, BF16, False, "flash_attention_mma"),
])
def test_choose_kernel_by_shape_and_dtype(sq, d, dtype, aligned, name):
    """The kernel depends on Sq and the dtype alone; a bf16 prefill then
    gets a copy width that D and its bases allow (``aligned`` False: q
    starts one element past a 16-byte boundary)."""
    kernel = fa.choose_kernel(sq, dtype)
    assert kernel.name == name
    assert kernel.replaces == "src/repro/kernels/flash_attention.py:92"
    if kernel is fa.FLASH_MMA:
        q = _bf16_at(2 * sq * d, 0 if aligned else 1).view(2, sq, d)
        vec = fa.copy_elems(d, q, torch.zeros(2, sq, d, dtype=BF16))
        assert d % vec == 0 and q.data_ptr() % (2 * vec) == 0
        assert aligned or vec == 1


def _bf16_at(n: int, shift: int) -> torch.Tensor:
    """n bf16 starting ``shift`` elements past a 16-byte boundary."""
    flat = torch.zeros(n + 8, dtype=BF16)
    base = flat.data_ptr() % 16 // 2
    t = flat[(shift - base) % 8:][:n]
    assert t.data_ptr() % 16 == 2 * shift % 16
    return t


@pytest.mark.parametrize("d,shift,want", [
    (128, 0, 8), (20, 0, 4), (18, 0, 2), (19, 0, 1), (1, 0, 1), (7, 0, 1),
    (2, 0, 2), (36, 0, 4), (100, 0, 4), (127, 0, 1), (64, 1, 1),
    (64, 2, 2), (64, 4, 4), (64, 6, 2), (64, 8, 8), (20, 2, 2),
])
def test_copy_elems_by_head_dim_and_alignment(d, shift, want):
    """16-byte copies where D % 8 == 0 and the bases are 16-byte aligned,
    else 8 or 4 bytes, else one element: a base ``shift`` bf16 past an
    aligned one."""
    t = _bf16_at(2 * 3 * d, shift).view(2, 3, d)
    assert fa.copy_elems(d, t, t, t) == want
    assert fa.copy_elems(d, torch.zeros(2, 3, d, dtype=BF16), t) == want


def test_every_bf16_prefill_takes_the_tensor_core_kernel():
    """D 1..128 at base offsets of 0, 1, 2 and 4 elements: the bf16 kernel,
    with a copy width that divides D and every base is aligned to."""
    assert fa.choose_kernel(17, BF16) is fa.FLASH_MMA
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        for shift in (0, 1, 2, 4):
            t = _bf16_at(3 * d, shift).view(1, 3, d)
            vec = fa.copy_elems(d, t)
            assert vec in (1, 2, 4, 8) and d % vec == 0
            assert t.data_ptr() % (2 * vec) == 0, (d, shift)


THREADS = 128  # csrc/flash_attention_mma.cu: four warps a block


def _copy_plan_tile(d: int, vec: int) -> torch.Tensor:
    """The 64 x DP tile that csrc/flash_attention_mma.cu writes through
    the row copy of csrc/gemm_tile.cuh (row_copy, copy_rows): how many
    times each (row, column) is written, counted negative where the copy
    is a zero fill."""
    dp = 16 * -(-d // 16)
    chunks = dp // vec
    assert chunks <= THREADS
    r_step = THREADS // chunks
    tile = torch.zeros(64, dp, dtype=torch.int64)
    for tid in range(r_step * chunks):  # the active threads
        col = tid % chunks * vec
        live = col < d
        assert live == (col + vec <= d)  # no copy straddles d
        for r in range(tid // chunks, 64, r_step):
            tile[r, col:col + vec] += 1 if live else -1
    return tile


@pytest.mark.parametrize("d", [1, 2, 7, 8, 19, 20, 36, 48, 100, 127, 128])
def test_copy_plan_covers_each_tile_row_once(d):
    """Every column of every row in [0, DP) is written once: by a copy of
    live data below D, by a zero fill from D on, at every width D allows."""
    dp = 16 * -(-d // 16)
    want = torch.where(torch.arange(dp) < d, 1, -1).expand(64, dp)
    for vec in (8, 4, 2, 1):
        if d % vec == 0:
            assert torch.equal(_copy_plan_tile(d, vec), want), vec


@pytest.mark.parametrize("d,vec", [(7, 1), (19, 1), (20, 4), (36, 4),
                                   (127, 1), (128, 8)])
def test_output_store_writes_no_column_past_d(d, vec):
    """The kernel's store: pairs at columns 8 n + 2 t where vec >= 2 (D
    even), else single elements, nothing at or past D.  Each column of a
    row is written once and no element of the next row."""
    dp = 16 * -(-d // 16)
    written = torch.zeros(2 * d, dtype=torch.int64)  # a row and the next
    for n in range(dp // 8):
        for t in range(4):
            col = n * 8 + 2 * t
            if vec >= 2:
                if col < d:
                    written[col:col + 2] += 1
            else:
                for c in (col, col + 1):
                    if c < d:
                        written[c] += 1
    assert bool((written[:d] == 1).all()) and bool((written[d:] == 0).all())


@pytest.mark.parametrize("d,shift,want", [
    (128, 0, 4), (20, 0, 4), (18, 0, 2), (13, 0, 1), (64, 1, 1),
    (64, 2, 2), (64, 4, 4),
])
def test_copy_floats_by_head_dim_and_alignment(d, shift, want):
    """16-byte copies where D % 4 == 0 and the bases are 16-byte aligned,
    else 8 or 4 bytes: a base ``shift`` floats past an aligned one."""
    flat = torch.zeros(2 * 3 * d + 8)
    base = flat.data_ptr() % 16 // 4  # floats past a 16-byte boundary
    t = flat[(shift - base) % 4:][:2 * 3 * d].view(2, 3, d)
    assert t.data_ptr() % 16 == 4 * shift % 16
    assert fa.copy_floats(d, t, t, t) == want
    assert fa.copy_floats(d, torch.zeros(2, 3, d), t) == want


@pytest.mark.parametrize("sq,skv,causal,off,want", [
    (1, 4096, True, 4095, 4096),   # decode past the prefix: every key
    (16, 4096, True, 100, 116),    # the last row's diagonal
    (4096, 4096, True, 0, 4096),
    (5, 77, True, -3, 77),         # a row sees no key: all keys, uniform
    (5, 77, False, 50, 77),
])
def test_visible_keys(sq, skv, causal, off, want):
    assert fa.visible_keys(sq, skv, causal, off) == want


def _bf16_inputs(bh, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).bfloat16() for _ in range(3)]


def _over_contract(got: torch.Tensor, want32: torch.Tensor) -> int:
    """Outputs beyond one bf16 ulp + 2e-5 of the fp32 result."""
    g = got.float()
    slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) + 2e-5
    return int(((g - want32).abs() > slack).sum())


def test_p_split_keeps_the_bf16_contract_where_one_rounding_breaks_it():
    q, k, v = _bf16_inputs(2, 1024, 128, seed=14)
    qf, kf, vf = q.float(), k.float(), v.float()
    want32 = ref.flash_attention(qf, kf, vf, causal=True)
    s = torch.matmul(qf, kf.mT) * 128 ** -0.5
    rows = torch.arange(1024)[:, None]
    s = s.masked_fill(rows < torch.arange(1024)[None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    once = torch.matmul(p_hi, vf).bfloat16()
    split = (torch.matmul(p_hi, vf) + torch.matmul(p_lo, vf)).bfloat16()
    assert _over_contract(once, want32) > 100
    assert _over_contract(split, want32) == 0


def _splitkv_emulation(q, k, v, causal, q_offset, split=fa.SPLIT_KEYS,
                       empty_splits=0):
    """The split-KV kernel's arithmetic in plain PyTorch: per-split
    (m, l, acc), then the merge in split order.  ``empty_splits`` appends
    splits with no keys (l = 0)."""
    sq, skv = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    kv_end = fa.visible_keys(sq, skv, causal, q_offset)
    parts = []
    for k0 in range(0, kv_end, split):
        k1 = min(kv_end, k0 + split)
        s = torch.matmul(q, k[:, k0:k1].mT) * scale
        if causal:
            rows = torch.arange(sq)[:, None] + q_offset
            s = s.masked_fill(rows < torch.arange(k0, k1)[None, :], -1e30)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.matmul(p, v[:, k0:k1])))
    zeros = torch.zeros_like(parts[0][2])
    parts += [(torch.full_like(parts[0][0], -1e30),
               torch.zeros_like(parts[0][1]), zeros)] * empty_splits
    live = [pt for pt in parts if bool((pt[1] > 0).all())]
    big_m = torch.stack([m for m, _, _ in live]).amax(dim=0)
    l_sum = sum(torch.exp(m - big_m) * l for m, l, _ in live)
    acc = sum(torch.exp(m - big_m) * a for m, _, a in live)
    return acc / l_sum.clamp_min(1e-30)


@pytest.mark.parametrize("sq,skv,causal,off", [
    (1, 3000, True, 2999), (7, 255, True, 248), (16, 700, False, 0),
    (7, 300, True, -3),      # rows 0-2 see no key: the mean of all values
    (16, 1000, True, -300),  # every split of the first rows is all masked
])
def test_splitkv_merge_matches_the_plain_version(sq, skv, causal, off):
    g = torch.Generator().manual_seed(sq * skv)
    q, k, v = (torch.randn(2, s, 32, generator=g) for s in (sq, skv, skv))
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=off)
    for empty in (0, 2):
        got = _splitkv_emulation(q, k, v, causal, off, empty_splits=empty)
        assert float((got - want).abs().max()) <= 2e-5
    if off < 0:  # a row that sees no key averages every value
        blind = min(sq, -off)
        torch.testing.assert_close(want[:, :blind],
                                   v.mean(dim=1, keepdim=True).expand(
                                       -1, blind, -1), rtol=0, atol=1e-6)
