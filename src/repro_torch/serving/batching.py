"""Shape bucketing and padding: the software Matrix Padding Unit.

The hardware MPU (paper Sec. VI) zero-pads any input up to the next multiple
of the tile size T so a fixed (T, S) fabric can consume "datasets of any
input dimension".  In the serving engine the same trick makes *heterogeneous
traffic batchable*: every incoming matrix is padded up to a T-multiple
bucket, and up to S same-bucket requests stack into one device batch that a
single compiled executable consumes.  Zero padding is exact for the Jacobi
solvers -- see ``core.jacobi._null_pivot_guard`` -- so the bucket never
perturbs the embedded problem.

Two bucket policies:

  * ``"tile"`` -- round each dim up to the next multiple of T.  Minimal
    padding waste, but heterogeneous traffic spreads across many buckets
    (fewer batching opportunities, more executables).
  * ``"pow2"`` -- round the *tile count* up to the next power of two
    (bucket edges T, 2T, 4T, 8T, ...).  Geometric bucketing: more padding
    waste per request, but O(log) distinct buckets, so mixed traffic
    coalesces into full batches and the executable cache stays tiny.

``pow2_cap`` bounds the geometric growth: bucket edges run T, 2T, 4T, ...
up to the cap, and any dimension whose power-of-two bucket would overshoot
it falls back to linear tile rounding.  Geometric padding waste compounds
with the bucket edge (a dim just past cap/2 pays ~2x area), so capping the
doubling where traffic is sparse is one of the knobs the serving-plan
autotuner (``serving.autotune``) searches over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

POLICIES = ("tile", "pow2")


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    T: int = 16            # tile edge (paper T); bucket dims are multiples
    mode: str = "tile"     # "tile" | "pow2"
    pow2_cap: Optional[int] = None  # pow2 mode: largest geometric bucket
                                    # edge; beyond it, linear tile rounding

    def __post_init__(self):
        if self.mode not in POLICIES:
            raise ValueError(f"unknown bucket mode {self.mode!r}")
        if self.T < 1:
            raise ValueError("bucket tile size must be >= 1")
        if self.pow2_cap is not None:
            if self.mode != "pow2":
                raise ValueError("pow2_cap only applies to the pow2 mode")
            if self.pow2_cap < self.T or self.pow2_cap % self.T:
                raise ValueError(
                    f"pow2_cap must be a multiple of T={self.T} "
                    f"(got {self.pow2_cap})")

    def bucket_dim(self, n: int) -> int:
        """Smallest bucket edge that holds a dimension of size n."""
        if n < 1:
            raise ValueError("matrix dimensions must be >= 1")
        tiles = math.ceil(n / self.T)
        if self.mode == "pow2":
            p2 = 1 << (tiles - 1).bit_length()
            if self.pow2_cap is None or p2 * self.T <= self.pow2_cap:
                tiles = p2
        return tiles * self.T

    def bucket_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(self.bucket_dim(int(d)) for d in shape)


def pad_to_bucket(a: np.ndarray, bucket: Sequence[int]) -> np.ndarray:
    """Zero-pad a matrix into its bucket (the MPU's zero fill)."""
    a = np.asarray(a)
    if len(bucket) != a.ndim:
        raise ValueError(f"bucket rank {len(bucket)} != matrix rank {a.ndim}")
    pads = []
    for d, b in zip(a.shape, bucket):
        if d > b:
            raise ValueError(f"matrix dim {d} exceeds bucket dim {b}")
        pads.append((0, b - d))
    if any(p for _, p in pads):
        a = np.pad(a, pads)
    return a


def stack_requests(mats: Sequence[np.ndarray], bucket: Sequence[int]):
    """Stack same-bucket matrices into one device batch.

    Returns ``(batch, n_active)`` where ``batch`` is (B, *bucket) and
    ``n_active`` is a (rank, B) int32 array of true sizes per axis --
    the masks the batched solvers use to keep padded coordinates inert.
    """
    batch = np.stack([pad_to_bucket(m, bucket) for m in mats])
    n_active = np.asarray([[m.shape[ax] for m in mats]
                           for ax in range(len(bucket))], dtype=np.int32)
    return batch, n_active


def padding_waste(shape: Sequence[int], bucket: Sequence[int]) -> float:
    """Fraction of the bucket area occupied by padding (0 = exact fit)."""
    true = float(np.prod([int(d) for d in shape]))
    padded = float(np.prod([int(b) for b in bucket]))
    return 1.0 - true / padded
