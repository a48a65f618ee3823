"""Solver cache of the serving engine (port of ``repro.serving.cache``,
memory tier).

The engine keeps one solver a key in a bounded in-memory LRU
(``LRUCache``), so a long-lived server that churns plans stays bounded:
the cap evicts the least-recently-dispatched entries.

Keying: the solver depends only on the numerics subset of ``PCAConfig``
(sweeps / pivot / rotation / angle / tol / standardize / backend, the
matmul block size when a kernel backend is routed, precision, fused).
``SolverKey`` is that subset, so two configs that differ only in
scheduling facts (T, S) share one entry, and a plan hot-swap that keeps
the bucketing keeps its whole cache.

The reference's persistent tier (``DiskCache``, ``aot_supported``,
``content_hash``) serializes compiled XLA executables through
``jax.experimental.serialize_executable``.  The port's solvers run eagerly
and PyTorch has no serialized form of them, so that tier is not ported:
``PCAServer(cache_dir=...)`` raises.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from .._device import DeviceLike

# default in-memory cap: generous for steady traffic (a few ops x a few
# buckets x a few batches), small enough that a plan-churning server stays
# bounded
DEFAULT_MAX_ENTRIES = 256


def environment_fingerprint(device: DeviceLike = None) -> Tuple:
    """(torch version, CUDA version, device name, device capability): the
    facts a compiled solver would depend on.  ``device`` defaults to the
    current CUDA device where there is one, else the CPU (name ``"cpu"``,
    capability None)."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return (torch.__version__, torch.version.cuda, "cpu", None)
    return (torch.__version__, torch.version.cuda,
            torch.cuda.get_device_name(dev),
            torch.cuda.get_device_capability(dev))


@dataclasses.dataclass(frozen=True)
class SolverKey:
    """The PCAConfig subset a solver actually depends on.

    ``build_solver_fn`` reads sweeps/pivot/rotation/angle/tol/standardize
    and routes matmuls through ``backend`` (whose block size is ``block`` =
    config.T -- only relevant when a kernel backend is set, so it is
    normalized to None on the plain matmul datapath).  T and S are
    deliberately absent: they are scheduling facts (bucket tile, flush
    size) that reach the solver through (bucket, batch) in the engine key.
    """
    sweeps: int
    tol: Optional[float]
    pivot: str
    rotation: str
    angle: str
    standardize: bool
    backend: Optional[str]
    block: Optional[int]
    # the precision policy and fused routing change the operand dtypes and
    # the kernels launched, so they are key material like the numerics
    precision: str = "fp32"
    fused: bool = False

    @classmethod
    def from_config(cls, config) -> "SolverKey":
        return cls(
            sweeps=config.sweeps, tol=config.tol, pivot=config.pivot,
            rotation=config.rotation, angle=config.angle,
            standardize=config.standardize, backend=config.backend,
            block=(config.T if config.backend is not None else None),
            precision=getattr(config, "precision", "fp32"),
            fused=getattr(config, "fused", False))


class LRUCache:
    """Bounded mapping with least-recently-used eviction.

    Reads refresh recency (a steadily-hit solver never ages out); writes
    beyond ``max_entries`` evict the coldest entry.  ``max_entries=None``
    is unbounded.
    """

    def __init__(self, max_entries: Optional[int] = DEFAULT_MAX_ENTRIES,
                 on_evict: Optional[Callable] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.evictions = 0
        self._on_evict = on_evict
        self._data: "collections.OrderedDict" = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(list(self._data))

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def get(self, key, default=None):
        if key not in self._data:
            return default
        return self[key]

    def __setitem__(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while (self.max_entries is not None
               and len(self._data) > self.max_entries):
            old_key, old_value = self._data.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_key, old_value)

    def clear(self) -> None:
        self._data.clear()


class ExecutableCache:
    """The engine's solver cache (``PCAServer._cache``): the mapping
    surface (``len``/``in``/iteration/indexing) of one ``LRUCache``, with
    the reference's ``lookup``/``store`` path over it.

      lookup   memory hit -> (fn, "memory"); otherwise (None, "miss").
      store    memory insert.
    """

    def __init__(self, max_entries: Optional[int] = DEFAULT_MAX_ENTRIES):
        self.mem = LRUCache(max_entries=max_entries)

    def __len__(self) -> int:
        return len(self.mem)

    def __iter__(self) -> Iterator:
        return iter(self.mem)

    def __contains__(self, key) -> bool:
        return key in self.mem

    def __getitem__(self, key):
        return self.mem[key]

    def get(self, key, default=None):
        return self.mem.get(key, default)

    @property
    def evictions(self) -> int:
        return self.mem.evictions

    def lookup(self, key) -> Tuple[Optional[Callable], str]:
        """(solver, source) where source is 'memory' or 'miss'."""
        fn = self.mem.get(key)
        return (fn, "memory") if fn is not None else (None, "miss")

    def store(self, key, fn) -> None:
        self.mem[key] = fn

    def summary(self) -> Dict:
        """The reference's summary; ``disk`` is None (no persistent
        tier)."""
        return {
            "entries": len(self.mem),
            "max_entries": self.mem.max_entries,
            "evictions": self.mem.evictions,
            "disk": None,
        }
