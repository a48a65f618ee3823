"""The selective-scan kernel's partition (``csrc/mamba_scan.cu``) emulated
in plain PyTorch on the CPU (no card, no nvcc).

* Each (b, d) channel is S = 4 adjacent lanes of G = 4 states each (N
  padded to 16 with states whose A, B and C are zero); blocks of 32
  channels; the grid is (ceil(D / 32), batch).  These constants are read
  from the kernel's source, so the emulation follows the kernel's own.
* A lane's step: du = dt u; for each of its states x = fma(2^(dt a), x,
  du B) with a = A log2(e) rounded once and dt a rounded once (the
  argument of ``ex2.approx``); its partial y = fma(x, C, ..) over its
  states, starting from D u on the channel's first lane and from 0 on the
  others.  The S partials are summed in pairs (j, j ^ 1), then those sums
  in pairs j ^ 2.
* Time runs in chunks of 32 steps and channels in blocks of 32, with the
  ragged ends zero-filled: a dead step (dt = 0) leaves the state as it is.

The emulation holds the reference's contract, rtol = atol = 1e-4, against
``kernels.ref.mamba_scan`` and the Pallas kernel in interpret mode at
ragged shapes, and over 4096 steps.  ``scan_copies`` and the row copies of
the kernel's tiles (``gemm_tile.cuh::row_copy`` / ``copy_rows``) are
checked at aligned and unaligned bases.
"""
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref

TOL = 1e-4  # the reference's contract, rtol = atol
F32_LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
# the kernel's `constexpr int NAME = <number>;` lines: G (states a lane),
# S (lanes a channel), CH (channels a block), TCH (steps a chunk)
SOURCE = (pathlib.Path(ms.__file__).parent.parent / "csrc" /
          "mamba_scan.cu").read_text()
K = {name: int(value) for name, value in
     re.findall(r"^constexpr int (\w+) = (\d+);", SOURCE, re.M)}
G, S, CH, TCH = K["G"], K["S"], K["CH"], K["TCH"]
NP = G * S         # states a channel
THREADS = CH * S   # a block


def _inputs(b, l, d, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, d)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, l, d)).astype(np.float32),
            -rng.uniform(0.5, 2, (d, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((d,)).astype(np.float32))


def _fma(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _pad(t, dim, size):
    pad = [0, 0] * t.ndim
    pad[2 * (t.ndim - 1 - dim) + 1] = size - t.shape[dim]
    return torch.nn.functional.pad(t, pad)


def emulate(u, dt, A, B, C, Dskip):
    """The kernel's arithmetic, lane by lane, on float32 CPU tensors."""
    batch, L, D = u.shape
    Lp = -(-L // TCH) * TCH
    Dp = -(-D // CH) * CH
    # the zero-filled tiles past L, D and N
    u, dt = (_pad(_pad(t, 1, Lp), 2, Dp) for t in (u, dt))
    B, C = (_pad(_pad(t, 1, Lp), 2, NP) for t in (B, C))
    a = _pad(_pad(A * F32_LOG2E, 0, Dp), 1, NP)          # (Dp, NP)
    dskip = _pad(Dskip, 0, Dp)
    x = torch.zeros(batch, Dp, NP)
    y = torch.empty(batch, Lp, Dp)
    for t in range(Lp):
        dd, uu = dt[:, t, :, None], u[:, t]
        du = dd * uu[..., None]
        x = _fma(torch.exp2(dd * a), x, du * B[:, t, None, :])
        # lane g's partial: D u on the first lane, then its 4 states
        x4 = x.view(batch, Dp, S, G)
        c4 = C[:, t, None, :].expand(batch, Dp, NP).reshape(
            batch, Dp, S, G)
        p = torch.zeros(batch, Dp, S)
        p[..., 0] = dskip * uu
        for j in range(G):
            p = _fma(x4[..., j], c4[..., j], p)
        # pairs (j, j ^ 1) first, then j ^ 2
        while p.shape[-1] > 1:
            p = p[..., 0::2] + p[..., 1::2]
        y[:, t] = p[..., 0]
    return y[:, :L, :D]


def _close(got, want):
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


@pytest.mark.parametrize("n", [1, 3, 4, 13, 16])
def test_partition_holds_the_contract_at_ragged_shapes(n):
    """batch 3, L 70 (not a whole number of 32-step chunks), D 45 (not a
    whole number of 32-channel blocks)."""
    args = _inputs(3, 70, 45, n, seed=n)
    got = emulate(*map(torch.from_numpy, args))
    want = ref.mamba_scan(*map(torch.from_numpy, args))
    assert _close(got, want), float((got - want).abs().max())
    pallas = np.asarray(jops.mamba_scan(*map(jnp.asarray, args), chunk=32,
                                        backend="interpret"))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)


def test_partition_holds_the_contract_over_4096_steps():
    """falcon-mamba-7b's sequence length and N at a few channels: the
    decay keeps each step's rounding from growing over the sequence."""
    args = _inputs(1, 4096, 5, 16, seed=7)
    got = emulate(*map(torch.from_numpy, args))
    want = ref.mamba_scan(*map(torch.from_numpy, args))
    err = float((got - want).abs().max())
    assert _close(got, want), err
    assert err < 1e-5  # well inside the contract


def test_dead_steps_and_channels_change_nothing():
    """The zero-filled tail of the last chunk and block: y of the live
    steps and channels is the same when L and D are whole chunks."""
    args = list(map(torch.from_numpy, _inputs(2, 64, 32, 16, seed=3)))
    whole = emulate(*args)
    cut = emulate(args[0][:, :50, :20], args[1][:, :50, :20],
                  args[2][:20], args[3][:, :50], args[4][:, :50],
                  args[5][:20])
    assert torch.equal(cut, whole[:, :50, :20])


@pytest.mark.parametrize("n", [1, 3, 4, 13, 16])
@pytest.mark.parametrize("batch,d", [(1, 1), (1, 31), (3, 45), (2, 64),
                                     (1, 8192)])
def test_partition_covers_every_channel_and_state_once(batch, d, n):
    """The kernel's constants hold the wrapper's MAX_STATE, a channel's
    lanes sit in one warp (its sums are shuffles) and a block is whole
    warps; its grid (ceil(D / CH), batch) is within the launch limits."""
    assert NP == ms.MAX_STATE
    assert 32 % S == 0 and THREADS % 32 == 0 and THREADS <= 1024
    grid = (-(-d // CH), batch)
    assert grid[0] < 2 ** 31 and grid[1] <= 65535
    # block bx, thread t: channel bx * CH + t // S, states (t % S) * G + j
    bx, t, j = np.meshgrid(np.arange(grid[0]), np.arange(THREADS),
                           np.arange(G), indexing="ij")
    ch = bx * CH + t // S
    state = t % S * G + j
    live = (ch < d) & (state < n)
    seen = np.zeros((d, n), dtype=int)
    np.add.at(seen, (ch[live], state[live]), 1)
    assert (seen == 1).all()


def _at(shape, shift, dtype):
    """A contiguous tensor of ``shape`` starting ``shift`` elements past a
    16-byte boundary."""
    n = int(np.prod(shape))
    es = torch.tensor([], dtype=dtype).element_size()
    flat = torch.zeros(n + 16, dtype=dtype)
    base = flat.data_ptr() % 16 // es
    t = flat[(shift - base) % (16 // es):][:n].view(shape)
    assert t.data_ptr() % 16 == shift * es % 16
    return t


@pytest.mark.parametrize("dtype,d,n,shift,want", [
    (torch.float32, 8192, 16, 0, (4, 4)),
    (torch.float32, 8192, 16, 1, (1, 1)),
    (torch.float32, 8192, 16, 2, (2, 2)),
    (torch.float32, 45, 13, 0, (1, 1)),
    (torch.float32, 46, 6, 0, (2, 2)),
    (torch.bfloat16, 8192, 16, 0, (8, 8)),
    (torch.bfloat16, 8192, 16, 1, (1, 1)),
    (torch.bfloat16, 8192, 16, 4, (4, 4)),
    (torch.bfloat16, 44, 4, 0, (4, 4)),
    (torch.bfloat16, 45, 16, 0, (1, 8)),
])
def test_scan_copies_by_width_and_alignment(dtype, d, n, shift, want):
    u = _at((2, 3, d), shift, dtype)
    bc = _at((2, 3, n), shift, dtype)
    got = ms.scan_copies(u, u, bc, bc)
    assert got == want
    es = u.element_size()
    for vec, width, t in zip(got, (d, n), (u, bc)):
        assert width % vec == 0 and t.data_ptr() % (vec * es) == 0
    # u and delta's copies follow both bases
    aligned = _at((2, 3, d), 0, dtype)
    assert ms.scan_copies(u, aligned, bc, bc)[0] == want[0]


def _row_copy(threads, cols, live, vec):
    """gemm_tile.cuh::row_copy: each thread's (first row, row step,
    column, live) for a tile ``cols`` wide."""
    chunks = cols // vec
    r_step = threads // chunks
    return [(t // chunks, r_step, t % chunks * vec, t % chunks * vec < live)
            for t in range(threads) if t < r_step * chunks]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4, 13, 16])
@pytest.mark.parametrize("d,shift", [(8192, 0), (45, 0), (8192, 1),
                                     (46, 0)])
def test_row_copies_cover_the_tiles_once(dtype, n, d, shift):
    """Every (row, column) of a chunk's u (or dt) tile, in the first and
    in the last block, and of its B (or C) tile is copied by exactly one
    copy of ``vec`` elements, and no live copy straddles the live width."""
    u = _at((1, 3, d), shift, dtype)
    bc = _at((1, 3, n), shift, dtype)
    vec_ud, vec_bc = ms.scan_copies(u, u, bc, bc)
    last = d - (-(-d // CH) - 1) * CH
    tiles = [(CH, min(d, CH), vec_ud), (CH, last, vec_ud), (NP, n, vec_bc)]
    for cols, width, vec in tiles:
        cover = np.zeros((TCH, cols), dtype=int)
        for r0, r_step, col, live in _row_copy(THREADS, cols, width, vec):
            assert not live or col + vec <= width
            for r in range(r0, TCH, r_step):
                cover[r, col:col + vec] += 1
        assert (cover == 1).all()
