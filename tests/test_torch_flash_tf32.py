"""The arithmetic of the fp32 prefill kernel ``flash_attention_tf32x3``
(``csrc/flash_attention_tf32.cu``) emulated in plain PyTorch on the CPU (no
card, no nvcc).

* Each fp32 operand x of S = Q K^T and O = P V is split into hi = x rounded
  to tf32 (10 mantissa bits, ties away from zero, as ``cvt.rna`` rounds) and
  lo = x - hi, of which the tensor core reads the top 19 bits; every k8
  step is three products, lo hi + hi lo + hi hi.  Each mma returns its
  input plus its eight products rounded toward zero (the tensor core
  truncates).  In S, each step's hi hi is summed from zero and added to S
  with a rounded fp32 add, and the two small products are chained over the
  head dim in an accumulator of their own, added to S at the end; P V is
  chained over a 32-key tile from zero and then added to O.
* P V takes P from S's accumulator registers with the k index relabelled:
  lane (g, t) holds keys 2t and 2t + 1, which the tf32 A fragment reads as
  columns t and t + 4, so V's B fragment is read from rows 2t and 2t + 1
  (Q K^T relabels its head-dim index the same way).
  ``test_relabelled_fragments_give_p_v`` builds the fragments lane by lane
  and checks that they multiply to P V.
* The online softmax runs over 32-key tiles in log2 units, with the
  oracle's masking: -1e30 above the causal diagonal, keys past Skv out,
  and a row that sees no key gets the mean of all values.

The emulation stays within the fp32 contract, 2e-5 max abs, of the float64
oracle, of ``kernels.ref.flash_attention`` and of the Pallas kernel in
interpret mode, rows that see one key and rows that see none included;
one tf32 product per step (hi hi alone) does not.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

BK = 32          # keys per K/V tile of the kernel
TOL = 2e-5       # the fp32 contract, max abs
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (ties away from zero), as the
    kernel's ``split_tf32`` computes it on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor core reads from a float32: its top 19
    bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncate(x - hi)


def toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero: the tensor core's sum."""
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


# mma column t <-> index 2t, column t + 4 <-> 2t + 1 within a k8 step
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def mma(c: torch.Tensor, a64: torch.Tensor, b64: torch.Tensor):
    """One mma.sync m16n8k8: c plus the exact products, truncated."""
    return toward_zero(c.double() + a64 @ b64)


def k8_steps(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) of a's and b's k8 slices, in the kernel's relabelled
    order, as float64."""
    for k0 in range(0, a.shape[-1], 8):
        idx = k0 + PERM
        ah, al = (t.double() for t in split(a[..., idx]))
        bh, bl = (t.double() for t in split(b[..., idx, :]))
        yield ah, al, bh, bl


def scores(q: torch.Tensor, k: torch.Tensor, three: bool) -> torch.Tensor:
    """S = q k^T: each step's hi hi from zero, added to S in fp32; the
    small products in a chain of their own, added at the end."""
    s = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
    small = torch.zeros_like(s)
    for ah, al, bh, bl in k8_steps(q, k.mT):
        if three:
            small = mma(mma(small, al, bh), ah, bl)
        s = s + mma(torch.zeros_like(s), ah, bh)
    return s + small


def tile_pv(p: torch.Tensor, v: torch.Tensor, three: bool) -> torch.Tensor:
    """A tile's P V: every step's products chained from zero."""
    out = torch.zeros(p.shape[0], p.shape[1], v.shape[-1])
    for ah, al, bh, bl in k8_steps(p, v):
        if three:
            out = mma(mma(out, al, bh), ah, bl)
        out = mma(out, ah, bh)
    return out


def emulate(q, k, v, causal=True, q_offset=0, three=True):
    """The kernel's arithmetic for fp32 q (BH, Sq, D), k/v (BH, Skv, D):
    D zero-filled to a multiple of 8, 32-key tiles, fp32 m, l and
    accumulator in log2 units, the relabelled key order in P V."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    dp = -(-d // 8) * 8
    pad = (0, dp - d)
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    kv_end = fa.visible_keys(sq, skv, causal, q_offset)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, dp)
    rows = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, kv_end, BK):
        cols = torch.arange(k0, k0 + BK)
        kt = torch.zeros(bh, BK, dp)
        vt = torch.zeros(bh, BK, dp)
        live = min(BK, skv - k0)
        kt[:, :live] = k[:, k0:k0 + live]
        vt[:, :live] = v[:, k0:k0 + live]
        s = scores(q, kt, three) * scale_log2
        if causal:
            s = s.masked_fill(rows < cols[None, :], -1e30)
        s = s.masked_fill(cols[None, :] >= skv, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(s - m)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + tile_pv(p, vt, three)
    return (acc / l.clamp_min(1e-30))[..., :d]


def oracle64(q, k, v, causal=True, q_offset=0):
    """Dense softmax attention in float64 with the reference's masking."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.mT * q.shape[-1] ** -0.5
    if causal:
        rows = torch.arange(q.shape[1])[:, None] + q_offset
        s = s.masked_fill(rows < torch.arange(k.shape[1])[None, :], -1e30)
    return torch.softmax(s, dim=-1) @ v


def qkv(bh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d))]


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


# (BH, Sq, Skv, D, causal, q_offset): D 40 (padded to 40), 20 (to 24),
# 13 (to 16), ragged Skv past one tile, non-causal; q_offset 0 gives row 0
# exactly one key, q_offset < 0 rows that see none
CASES = [(2, 80, 80, 40, True, 0), (2, 70, 150, 20, True, 80),
         (1, 90, 130, 13, False, 0), (2, 100, 100, 64, True, -7)]


@pytest.mark.parametrize("bh,sq,skv,d,causal,off", CASES)
def test_three_products_keep_the_fp32_contract(bh, sq, skv, d, causal, off):
    q, k, v = qkv(bh, sq, skv, d, seed=sq + skv + d)
    got = emulate(q, k, v, causal, off)
    assert max_abs(got, oracle64(q, k, v, causal, off)) <= TOL
    assert max_abs(got, ref.flash_attention(q, k, v, causal=causal,
                                            q_offset=off)) <= TOL


@pytest.mark.parametrize("bh,sq,skv,d,causal,off", CASES)
def test_one_tf32_product_breaks_the_fp32_contract(bh, sq, skv, d, causal,
                                                   off):
    q, k, v = qkv(bh, sq, skv, d, seed=sq + skv + d)
    got = emulate(q, k, v, causal, off, three=False)
    assert max_abs(got, oracle64(q, k, v, causal, off)) > TOL


def test_rows_that_see_one_key_or_none():
    """q_offset = -5: rows 0-4 see no key (the mean of every value), row 5
    sees key 0 alone (its value)."""
    q, k, v = qkv(2, 40, 100, 24, seed=5)
    got = emulate(q, k, v, True, -5)
    want = oracle64(q, k, v, True, -5)
    assert max_abs(got, want) <= TOL
    mean = v.double().mean(dim=1, keepdim=True).expand(-1, 5, -1)
    assert max_abs(got[:, :5], mean) <= TOL
    assert max_abs(got[:, 5], v[:, 0]) <= TOL


def test_emulation_matches_the_pallas_kernel():
    q, k, v = qkv(2, 96, 96, 64, seed=96)
    want = jops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                causal=True, block_q=32, block_k=32,
                                backend="interpret")
    got = emulate(q, k, v, True, 0)
    assert max_abs(got, torch.from_numpy(np.asarray(want))) <= TOL


def test_relabelled_fragments_give_p_v():
    """One m16n8k8 step built lane by lane: S's accumulator registers
    (c0..c3 = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)) passed as the A
    fragment in the order c0, c2, c1, c3 (the fragment's (g, t), (g+8, t),
    (g, t+4), (g+8, t+4)), V's B fragment from rows 2t and 2t + 1
    (the fragment's rows t and t + 4, column g)."""
    g = torch.Generator().manual_seed(0)
    p = torch.rand(16, 8, generator=g, dtype=torch.float64)
    v = torch.randn(8, 8, generator=g, dtype=torch.float64)
    a_mma = torch.full((16, 8), math.nan, dtype=torch.float64)
    b_mma = torch.full((8, 8), math.nan, dtype=torch.float64)
    for lane in range(32):
        gg, t = lane // 4, lane % 4
        c = [p[gg, 2 * t], p[gg, 2 * t + 1], p[gg + 8, 2 * t],
             p[gg + 8, 2 * t + 1]]
        a = [c[0], c[2], c[1], c[3]]
        for i, (r, col) in enumerate([(gg, t), (gg + 8, t), (gg, t + 4),
                                      (gg + 8, t + 4)]):
            a_mma[r, col] = a[i]
        b_mma[t, gg] = v[2 * t, gg]
        b_mma[t + 4, gg] = v[2 * t + 1, gg]
    assert not bool(a_mma.isnan().any() or b_mma.isnan().any())
    torch.testing.assert_close(a_mma @ b_mma, p @ v, rtol=0, atol=1e-12)
