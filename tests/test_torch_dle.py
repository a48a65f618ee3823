"""The DLE pivot scan of the port against the JAX package, on the CPU (no
card, no nvcc): inputs made with numpy from a seed go through the Pallas
kernel in interpret mode and through the port.

* The NaN rule of the reference (``repro/kernels/dle.py::_dle_kernel``):
  a tile whose max is NaN (a NaN in a valid, off-diagonal entry) is never
  strictly greater than the running best, so it is skipped whole; a NaN on
  the diagonal is masked.  The port's plain ``dle_scan`` is held to the
  Pallas kernel bitwise in (value, flat index).
* The CUDA kernel's order (``csrc/dle.cu``) emulated in numpy: each
  element's key (bits of |v| << 32 | (POS_TOP - position in its tile) << 1
  | the sign of v; ``NAN_KEY`` for a NaN), each tile's slot the max of its
  keys, then the tiles in
  order with the larger value and on a tie the earlier tile winning, NaN
  tiles skipped.  The emulation also maps every element to the block,
  warp, lane, pass and load that read it, by the kernel's own formulas and
  its constants read from the source, and checks that each element is read
  once, by a block inside its tile.  It is held bitwise to the Pallas
  kernel over ragged n and tiles, ties and NaN tiles; at n = 784 with
  tiles of 1, 3 and 4 (about 10^5 grid steps, minutes in interpret mode)
  to the plain version, which is held to the Pallas kernel everywhere else.
* ``ops.dle_find_pivot`` and the wrapper's pivot (``dle.dle_pivot``, the
  plain version on the CPU) against the reference's ops, and the flat
  ``torch`` backend's NaN rule against ``repro.core.dle.find_pivot``.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import dle as jdle_core
from repro.kernels import dle as jdle
from repro.kernels import ops as jops
from repro_torch.core import dle as tdle_core
from repro_torch.kernels import dle, ops, ref

from _torch_parity import DLE_KINDS, DLE_N, DLE_TILES, dle_matrix, sym

SOURCE = (pathlib.Path(dle.__file__).parent.parent / "csrc" /
          "dle.cu").read_text()
K = {name: int(value, 0) for name, value in re.findall(
    r"^constexpr (?:int|unsigned int|unsigned long long) (\w+) = "
    r"(0x[0-9a-f]+|\d+)", SOURCE, re.M)}
THREADS, ROWS, COLS = K["THREADS"], K["ROWS"], K["COLS"]
NAN_KEY, POS_TOP = np.uint64(K["NAN_KEY"]), np.uint64(K["POS_TOP"])
WARPS = THREADS // 32
PASSES = ROWS // WARPS
HI = np.uint64(0xFFFFFFFF00000000)
# (n, tile) where the interpret-mode Pallas kernel takes minutes
SLOW_PALLAS = {(784, 1), (784, 3), (784, 4)}


def _pallas(c: np.ndarray, tile: int):
    v, i = jdle.dle_scan(jnp.asarray(c), tile=tile, interpret=True)
    return float(v), int(i)


def _plain(c: np.ndarray, tile: int):
    v, i = ref.dle_scan(torch.from_numpy(c), tile)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return float(v), int(i)


def _same(a, b) -> bool:
    """(value, index) pairs equal, a NaN value equal to a NaN."""
    return np.float32(a[0]).tobytes() == np.float32(b[0]).tobytes() \
        and a[1] == b[1]


# -- the NaN rule ------------------------------------------------------------

def _base(n: int = 8) -> np.ndarray:
    a = np.arange(n * n, dtype=np.float32).reshape(n, n)
    return ((a + a.T) / 10).astype(np.float32)


def _nan_case(case: str) -> np.ndarray:
    c = _base()
    if case == "one_tile":              # tiles (0, 1) and (1, 0) at tile 4
        c[2, 5] = c[5, 2] = np.nan
    elif case == "several_tiles":
        c[0, 1] = c[6, 7] = c[3, 4] = np.nan
    elif case == "diagonal":            # masked: not a candidate
        c[3, 3] = c[6, 6] = np.nan
    elif case == "every_tile":
        c[::3, ::3] = np.nan
        c[np.arange(8), np.arange(8)] = 1.0
        c[1::4, ::2] = np.nan
    elif case == "inf":
        c[1, 6] = np.inf
        c[6, 1] = -np.inf
        c[4, 5] = np.nan
    elif case == "neg_inf_only":
        c[7, 2] = -np.inf
    elif case == "nan_and_inf_one_tile":
        c[5, 6] = np.inf
        c[6, 5] = np.nan
    return c


NAN_CASES = ["one_tile", "several_tiles", "diagonal", "every_tile", "inf",
             "neg_inf_only", "nan_and_inf_one_tile"]


@pytest.mark.parametrize("tile", [2, 3, 4, 8])
@pytest.mark.parametrize("case", NAN_CASES)
def test_dle_scan_plain_follows_the_reference_nan_rule(case, tile):
    c = _nan_case(case)
    got, want = _plain(c, tile), _pallas(c, tile)
    assert _same(got, want), (got, want)


def test_dle_scan_plain_skips_a_nan_tile_whole():
    """C = (a + a^T) / 10 with C[2, 5] = C[5, 2] = NaN: at tile 4 the tiles
    (0, 1) and (1, 0) are skipped and the max lies in tile (1, 1); at tile
    8 the one tile is NaN and nothing is found."""
    c = _nan_case("one_tile")
    assert _plain(c, 4) == _pallas(c, 4) == (np.float32(11.7), 55)
    assert _plain(c, 8) == _pallas(c, 8) == (-1.0, 0)


# -- the kernel's order, emulated ---------------------------------------------

def _geometry(n: int, tile: int):
    """csrc/dle.cu's launch: tiles a side, column chunks and row strips a
    tile, and the grid (``dle.launch_grid``, which the card tests hold to
    the profiler's trace)."""
    g = -(-n // tile)
    chunks, strips = -(-tile // COLS), -(-tile // ROWS)
    return g, chunks, strips, dle.launch_grid(n, tile)


def _readers(n: int, tile: int, vec: int):
    """For every element (r, col): the block, warp, lane, pass and load
    slot that reads it, inverted from the kernel's index formulas and then
    put through them forward, with the kernel's masks."""
    g, chunks, strips, (gx, gy) = _geometry(n, tile)
    r, col = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ti, tj = r // tile, col // tile
    bx = tj * chunks + (col - tj * tile) // COLS
    by = ti * strips + (r - ti * tile) // ROWS
    # the kernel: tj = bx / chunks, c0 = tj T + (bx - tj chunks) COLS, ...
    ktj, kti = bx // chunks, by // strips
    c0 = ktj * tile + (bx - ktj * chunks) * COLS
    r0 = kti * tile + (by - kti * strips) * ROWS
    c1 = np.minimum(np.minimum(c0 + COLS, ktj * tile + tile), n)
    r1 = np.minimum(np.minimum(r0 + ROWS, kti * tile + tile), n)
    warp, i = (r - r0) % WARPS, (r - r0) // WARPS
    if vec == 4:
        lane, e = (col - c0) // 4, (col - c0) % 4
        kcol = c0 + 4 * lane + e
    else:
        lane, e = (col - c0) % 32, (col - c0) // 32
        kcol = c0 + lane + 32 * e
    kr = r0 + warp + i * WARPS
    assert (bx < gx).all() and (by < gy).all()
    assert (ktj == tj).all() and (kti == ti).all()  # a block in one tile
    assert (lane < 32).all() and (e < 4).all() and (i < PASSES).all()
    assert (kr == r).all() and (kcol == col).all()   # read where it lies
    assert ((r < r1) & (col < c1)).all()             # inside the masks
    slot = (((by * gx + bx) * WARPS + warp) * 32 + lane) * PASSES * 4 \
        + i * 4 + e
    assert np.unique(slot).size == n * n             # each read once
    if vec == 4:  # a 16-byte load starts on a multiple of 4 columns
        assert ((c0 % 4 == 0) & ((c1 - c0) % 4 == 0)).all()
    return ti, tj


def _emulate(c: np.ndarray, tile: int, vec: int):
    n = c.shape[0]
    g = -(-n // tile)
    ti, tj = _readers(n, tile, vec)
    r, col = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pos = ((r - ti * tile) * tile + (col - tj * tile)).astype(np.uint64)
    bits = c.astype(np.float32).view(np.uint32).astype(np.uint64)
    mag = bits & np.uint64(0x7FFFFFFF)
    key = (mag << np.uint64(32)) | ((POS_TOP - pos) << np.uint64(1)) \
        | (bits >> np.uint64(31))
    key = np.where(mag > 0x7F800000, NAN_KEY, key)
    key = np.where(r == col, np.uint64(0), key)      # the diagonal
    slots = np.zeros(g * g, np.uint64)               # atomicMax a warp
    np.maximum.at(slots, (ti * g + tj).ravel(), key.ravel())
    t = np.arange(g * g, dtype=np.uint64)
    cand = (slots & HI) | (~t & np.uint64(0xFFFFFFFF))
    cand = np.where((slots == 0) | (slots == NAN_KEY), np.uint64(0), cand)
    best = int(np.argmax(cand))
    top = cand[best]
    if top == 0:
        return -1.0, 0
    tile_id = int(~np.uint32(top & np.uint64(0xFFFFFFFF)))
    low = int(slots[tile_id] & np.uint64(0xFFFFFFFF))
    p_in = int(POS_TOP) - (low >> 1)
    p = tile_id // g * tile + p_in // tile
    q = tile_id % g * tile + p_in % tile
    mag = np.uint32(top >> np.uint64(32))
    # the key carries C[p, q]'s sign: the pivot's C[p, q] needs no load
    assert (mag | np.uint32(low << 31 & 0xFFFFFFFF)) == \
        c[p, q:q + 1].view(np.uint32)[0]
    return float(mag.view(np.float32)), p * n + q


@pytest.mark.parametrize("tile", DLE_TILES)
@pytest.mark.parametrize("n", DLE_N)
@pytest.mark.parametrize("kind", DLE_KINDS)
def test_dle_kernel_order_emulated_matches_the_pallas_kernel(kind, n, tile):
    c = dle_matrix(n, kind, seed=n + tile)
    want = _plain(c, tile) if (n, tile) in SLOW_PALLAS else _pallas(c, tile)
    vecs = [1, 4] if n % 4 == 0 and tile % 4 == 0 else [1]
    for vec in vecs:
        got = _emulate(c, tile, vec)
        assert _same(got, want), (vec, got, want)
    assert _same(_plain(c, tile), want)


def test_dle_kernel_constants_read_from_the_source():
    assert (THREADS, ROWS, COLS) == (256, 16, 128)
    assert NAN_KEY == np.uint64(2 ** 64 - 1)
    # every position in the largest tile the wrapper takes lies below
    # POS_TOP, so a valid key's low word is at least 2: above the empty
    # slot's 0
    assert int(POS_TOP) == 2 ** 31 - 1 > (dle._LIMIT - 1) ** 2 - 1
    assert (dle.ROWS, dle.COLS) == (ROWS, COLS)
    # n = 784, tile 128: 7 column chunks x 49 row strips fill 132 SMs
    assert dle.launch_grid(784, 128) == (7, 49)


# -- the pivot the op returns ------------------------------------------------

def _diagonal_only() -> np.ndarray:
    return np.diag(np.arange(1, 9, dtype=np.float32))


def _cross_tile_tie() -> np.ndarray:
    c = np.zeros((8, 8), np.float32)
    c[0, 5] = c[5, 0] = c[1, 2] = c[2, 1] = 3.0
    return c


PIVOT_CASES = {
    "random_33": lambda: sym(33, seed=7),
    "ties_40": lambda: dle_matrix(40, "ties", seed=2),
    "nan_129": lambda: dle_matrix(129, "nan", seed=5),
    "nan_inf_64": lambda: dle_matrix(64, "nan_inf", seed=9),
    "one_nan_tile": lambda: _nan_case("one_tile"),
    "diagonal_only": _diagonal_only,
    "cross_tile_tie": _cross_tile_tie,
    "one_by_one": lambda: np.ones((1, 1), np.float32),
}


def _as_bits(x) -> int:
    a = np.asarray(x)
    return int(a.astype(np.float32).view(np.int32)) \
        if a.dtype.kind == "f" else int(a)


@pytest.mark.parametrize("case", sorted(PIVOT_CASES))
def test_dle_pivot_matches_the_reference_interpret_backend(case):
    """The wrapper's pivot (the kernel's epilogue: (p, q, C[p, q], C[p, p],
    C[q, q]) at the scan's index, (0, 0, C[0, 0], ...) with none) against
    the reference's ``dle_find_pivot(backend="interpret")``."""
    c = PIVOT_CASES[case]()
    tile = 16 if c.shape[0] > 8 else 4
    want = jops.dle_find_pivot(jnp.asarray(c), tile=tile,
                               backend="interpret")
    got = dle.dle_pivot(torch.from_numpy(c), tile)
    assert got[0].dtype == got[1].dtype == torch.int64
    assert [_as_bits(g) for g in got] == [_as_bits(w) for w in want]


@pytest.mark.parametrize("n", [5, 33, 100])
def test_ops_dle_find_pivot_on_the_cpu_matches_the_interpret_backend(n):
    """On a CPU tensor the op takes the flat ``torch`` backend; on a
    symmetric matrix with one largest pair it finds the interpret
    backend's pivot (the pair's entry above the diagonal)."""
    c = sym(n, seed=n)
    want = jops.dle_find_pivot(jnp.asarray(c), tile=16, backend="interpret")
    got = ops.dle_find_pivot(torch.from_numpy(c), tile=16)
    assert type(got) is tdle_core.Pivot
    assert [_as_bits(g) for g in got] == [_as_bits(w) for w in want]


@pytest.mark.parametrize("case", ["one_tile", "several_tiles", "diagonal",
                                  "inf", "neg_inf_only"])
def test_torch_backend_nan_rule_matches_the_reference_find_pivot(case):
    """The flat ``find_pivot`` (the ``torch`` backend, held to the
    reference's ``ref`` backend): |C| times the off-diagonal mask keeps a
    NaN anywhere, the diagonal included, and the first NaN in row-major
    order wins; the port does as the reference does."""
    c = _nan_case(case)
    want = jdle_core.find_pivot(jnp.asarray(c))
    got = tdle_core.find_pivot(torch.from_numpy(c))
    assert [_as_bits(g) for g in got] == [_as_bits(w) for w in want]
    via_op = ops.dle_find_pivot(torch.from_numpy(c))
    assert [_as_bits(g) for g in via_op] == [_as_bits(w) for w in want]
