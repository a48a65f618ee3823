"""The choice among the three ``flash_attention`` kernels, and plain-PyTorch
emulations of two of their designs, on the CPU (no card, no nvcc).

* ``choose_kernel`` picks split-KV for Sq <= 16, the tensor-core kernel for
  bf16 prefill with D % 8 == 0 and aligned rows, the SIMT kernel otherwise.
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
    (4096, 20, BF16, True, "flash_attention_simt"),
    (4096, 128, BF16, False, "flash_attention_simt"),
    (4096, 128, F32, True, "flash_attention_simt"),
    (17, 64, F32, True, "flash_attention_simt"),
])
def test_choose_kernel_by_shape_and_dtype(sq, d, dtype, aligned, name):
    kernel = fa.choose_kernel(sq, d, dtype, aligned)
    assert kernel.name == name
    assert kernel.replaces == "src/repro/kernels/flash_attention.py:92"


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
