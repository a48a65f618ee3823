"""Identities the redesigned device code relies on, checked on the CPU (no
card, no nvcc) by emulating that code in plain PyTorch.

* The scan's bf16-state instance (``csrc/mamba_scan.cu``) keeps bf16
  values in pairs, one 32-bit word a pair (lo: the element at the lower
  address).  A landed chunk of fp32 operands is rounded once for the
  block: each dt slot becomes the word (r(dt), r(r(dt) r(u))), read back
  as (r(dt), r(dt)) and (du, du) by ``__byte_perm``; the selectors are
  read from the kernel's source, and ``__byte_perm`` is emulated.  The
  whole step in pairs -- decay = r(expf(r(dt a))), b = r(du B),
  x = r(r(decay x) + b), with the packed primitives emulated as
  products and sums of two bf16 values in fp32 rounded to bf16 (the
  card holds the real ones to exactly that at every input) -- gives the
  plain bf16-state scan's final state bit for bit.
* CORDIC (``csrc/cordic.cuh``): one stage function serves vectoring and
  rotation mode, each called with its direction, and is each mode's
  stage; ``from_fixed`` takes x * 2^-29 for the IEEE division x / 2^29,
  which for an int32 x has the same bits (a power of two: the product is
  exact).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import cordic as tcordic
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref

CSRC = pathlib.Path(ms.__file__).resolve().parent.parent / "csrc"
SCAN_SOURCE = (CSRC / "mamba_scan.cu").read_text()
NP = 16     # states a channel in the kernel (G x S)
MASK = 0xFFFFFFFF


def _body(name: str) -> str:
    """The source of the first function ``name`` in mamba_scan.cu."""
    start = re.search(r"\b" + name + r"\(", SCAN_SOURCE).start()
    end = SCAN_SOURCE.index("\n}\n", start)
    return SCAN_SOURCE[start:end]


def _selectors(name: str) -> list:
    return [int(s, 16) for s in re.findall(
        r"__byte_perm\([^;]*?(0x[0-9a-fA-F]+)\)", _body(name))]


SWAP, MERGE = _selectors("round_chunk")
(TWICE,) = _selectors("twice")
(DU,) = _selectors("step_operands")


def byte_perm(x: torch.Tensor, y, s: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, s)`` on int64 words: byte i of the result
    is byte (s >> 4 i) & 7 of the eight bytes x (0-3), y (4-7)."""
    both = (torch.as_tensor(y, dtype=torch.int64) << 32) | (x & MASK)
    out = torch.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((both >> (8 * sel)) & 0xFF) << (8 * i)
    return out


def bits(v: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (round to nearest even), their bits."""
    return v.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def value(h: torch.Tensor) -> torch.Tensor:
    """bf16 bits as fp32 (exact)."""
    return (h.to(torch.int32) << 16).view(torch.float32)


def lo(w):
    return value(w & 0xFFFF)


def hi(w):
    return value((w >> 16) & 0xFFFF)


def pack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``pack2(lo, hi)``: both rounded, in one word."""
    return bits(a) | (bits(b) << 16)


def mul2(a, b):
    return pack(lo(a) * lo(b), hi(a) * hi(b))


def add2(a, b):
    return pack(lo(a) + lo(b), hi(a) + hi(b))


def exp_pair(w):
    return pack(torch.exp(lo(w)), torch.exp(hi(w)))


def test_selectors_read_from_the_kernel():
    assert (SWAP, MERGE, TWICE, DU) == (0x1032, 0x7610, 0x1010, 0x3232)


def test_dt_word_holds_what_the_step_reads():
    """Every bf16 dt with a spread of u's (and the specials): the word
    round_chunk leaves in a dt slot is read back as (r(dt), r(dt)) and
    (du, du) with du = r(r(dt) r(u))."""
    g = torch.Generator().manual_seed(0)
    dt_bits = torch.arange(1 << 16, dtype=torch.int64)
    u_bits = torch.randint(0, 1 << 16, (1 << 16,), generator=g,
                           dtype=torch.int64)
    u_bits[:4] = torch.tensor([0x7F80, 0xFF80, 0x7FC0, 0x0001])
    dt, u = value(dt_bits), value(u_bits)
    p = pack(dt, u)  # cvt.rn.bf16x2.f32: (lo dt, hi u)
    w = byte_perm(p, mul2(p, byte_perm(p, 0, SWAP)), MERGE)
    dr2, du2 = byte_perm(w, 0, TWICE), byte_perm(w, 0, DU)
    du = bits(value(dt_bits) * value(u_bits))
    for word, want in ((dr2, dt_bits), (du2, du)):
        for half in (word & 0xFFFF, (word >> 16) & 0xFFFF):
            same = (half == want) | (value(half).isnan()
                                     & value(want).isnan())
            assert bool(same.all())


def _packed_scan(u, dt, A, B, C, D_skip):
    """The bf16-state instance's dataflow for fp32 operands, a thread's G
    states as G / 2 words, every (b, d) channel at once: the chunk's
    rounding (round_chunk), then each step's pairs (step_operands and
    the loop).  Returns (y, final state)."""
    b, L, d = u.shape
    n = A.shape[1]
    pad = NP - n

    def words(t):  # (..., NP) fp32 -> (..., NP / 2) words
        t = torch.nn.functional.pad(t, (0, pad))
        return pack(t[..., 0::2], t[..., 1::2])
    p = pack(dt, u)
    w = byte_perm(p, mul2(p, byte_perm(p, 0, SWAP)), MERGE)
    bw = words(B)                                    # (b, L, NP / 2)
    cr = value(bits(torch.nn.functional.pad(C, (0, pad))))
    a2 = words(A)                                    # (d, NP / 2)
    x2 = torch.zeros(b, d, NP // 2, dtype=torch.int64)
    ys = []
    for t in range(L):
        dr2 = byte_perm(w[:, t], 0, TWICE)[..., None]
        du2 = byte_perm(w[:, t], 0, DU)[..., None]
        bt = mul2(du2, bw[:, t, None, :])
        decay = exp_pair(mul2(dr2, a2[None]))
        x2 = add2(mul2(decay, x2), bt)
        x = torch.stack((lo(x2), hi(x2)), -1).reshape(b, d, NP)
        ys.append(D_skip * u[:, t] + (x * cr[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), x[..., :n]


@pytest.mark.parametrize("shape", [(2, 40, 12, 16), (1, 33, 5, 3),
                                   (3, 17, 7, 1)])
def test_packed_step_is_the_plain_bf16_state_scan(shape):
    b, L, d, n = shape
    rng = np.random.default_rng(sum(shape))
    u = torch.from_numpy(rng.standard_normal((b, L, d)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, L, d))
                          .astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2, (d, n)).astype(np.float32))
    B, C = (torch.from_numpy(rng.standard_normal((b, L, n))
                             .astype(np.float32)) for _ in range(2))
    D_skip = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    y, state = _packed_scan(u, dt, A, B, C, D_skip)
    want_y, want_state = ref.mamba_scan(u, dt, A, B, C, D_skip,
                                        return_state=True,
                                        state_dtype=torch.bfloat16)
    assert torch.equal(state, want_state)
    rel = float(torch.linalg.norm(y - want_y) / torch.linalg.norm(want_y))
    assert rel <= 1e-6


def _stage(up, i, t, x, y, z):
    """cordic.cuh's cordic_stage: direction d = +1 where ``up``, else -1."""
    d = torch.where(up, 1, -1).to(torch.int32)
    return x - d * (y >> i), y + d * (x >> i), z - d * t


@pytest.mark.parametrize("mode", ["vectoring", "rotation"])
def test_cordic_stage_is_each_modes_stage(mode):
    """The shared stage, called as cordic_atan2 (direction -sign(y)) and
    cordic_kernel (direction sign(z)) call it, against each mode's stage
    as the plain version writes it (``core.cordic``, ``kernels.ref``)."""
    g = torch.Generator().manual_seed(1)
    k = 100000
    atan = [int(v) for v in tcordic._ATAN_FIXED]
    one = 1 << 29
    if mode == "vectoring":   # x >= 0 after the quadrant fold
        x = torch.randint(0, one, (k,), generator=g, dtype=torch.int32)
        y = torch.randint(-one, one, (k,), generator=g, dtype=torch.int32)
        z = torch.zeros_like(x)
        y[:3] = torch.tensor([0, 1, -1], dtype=torch.int32)
    else:                     # |theta| <= pi / 2, from the kernel's seed
        z = torch.randint(-843314857, 843314857, (k,), generator=g,
                          dtype=torch.int32)
        z[:3] = torch.tensor([0, 1, -1], dtype=torch.int32)
        x = torch.full_like(z, ref.CORDIC_X0_KERNEL)
        y = torch.zeros_like(z)
    want, got = (x, y, z), (x, y, z)
    for i in range(tcordic.CORDIC_ITERS):
        wx, wy, wz = want
        if mode == "vectoring":
            d = torch.where(wy >= 0, 1, -1).to(torch.int32)
            want = (wx + d * (wy >> i), wy - d * (wx >> i), wz + d * atan[i])
            got = _stage(got[1] < 0, i, atan[i], *got)
        else:
            d = torch.where(wz >= 0, 1, -1).to(torch.int32)
            want = (wx - d * (wy >> i), wy + d * (wx >> i), wz - d * atan[i])
            got = _stage(got[2] >= 0, i, atan[i], *got)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_from_fixed_product_is_the_division():
    """Every int32 of magnitude below 2^22, the extremes and a spread of
    the rest: int32 -> fp32, then / 2^29 and * 2^-29 give the same bits."""
    g = torch.Generator().manual_seed(2)
    xs = torch.cat([
        torch.arange(-(1 << 22), 1 << 22, dtype=torch.int64),
        torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 22,), generator=g,
                      dtype=torch.int64),
        torch.tensor([-(1 << 31), (1 << 31) - 1, (1 << 31) - 64])]
    ).to(torch.int32).to(torch.float32)
    quot = xs / float(1 << 29)
    prod = xs * float(2.0 ** -29)
    assert torch.equal(quot.view(torch.int32), prod.view(torch.int32))


def test_bf16_primitive_check_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        ms.bf16_primitive_mismatches("cpu")
    assert ms.BF16_PRIMITIVES == {"mul": 2 ** 32, "add": 2 ** 32,
                                  "cvt": 2 ** 32, "exp": 2 ** 16}
