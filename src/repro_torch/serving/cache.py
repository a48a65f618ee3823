"""Solver cache of the serving engine: the in-memory LRU tier and the
persistent tier (port of ``repro.serving.cache``).

A software replica that builds its solvers on the first requests serves
its first minutes at build speed -- fatal for elastic scale-out, where a
fresh replica is spawned because traffic already exceeds capacity.  Two
tiers sit under ``PCAServer._cache``:

  memory  ``LRUCache`` -- one solver a key, bounded: a long-lived server
          that churns plans evicts the least-recently-dispatched entries.
  disk    ``DiskCache`` -- one content-addressed JSON record an
          executable.  The reference serializes compiled XLA executables;
          the port's executable is a CUDA graph of one (op, bucket, batch)
          key (``sharded.LocalExecutor.aot_compile``), which cannot be
          written to disk.  A record holds what a fresh process needs to
          capture that graph again without compiling anything: the key
          material, the static inputs' shapes and dtypes, the output
          structure, the kernel plan the miss path resolved and the digest
          of the graph's outputs on seeded inputs.  The kernel library --
          the port's compiled artefact -- is kept beside the records
          (``kernels.build.arm_cache``), so a replica with a warm directory
          runs nvcc no time.  Writes are atomic (a tempfile in the cache
          directory, then ``os.replace``); any load failure quarantines the
          entry and the caller builds again, which repairs it; the
          directory is size-capped, oldest access first.  Loading a record
          runs no code: it is JSON.

Keying: the solver depends only on the numerics subset of ``PCAConfig``
(sweeps / pivot / rotation / angle / tol / standardize / backend, the
matmul block size when a kernel backend is routed, precision, fused).
``SolverKey`` is that subset, so two configs that differ only in
scheduling facts (T, S) share one entry, and a plan hot-swap that keeps
the bucketing keeps its whole cache.  The disk tier hashes ``SolverKey``
with (op, bucket, batch, executor token, the environment fingerprint,
``CACHE_FORMAT``), so an entry is invalidated -- cleanly, by never being
looked up -- the moment any of them changes.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from .._device import DeviceLike
from ..kernels import build

# bump when the record layout changes; part of the content hash, so
# old-format records are never looked up again
CACHE_FORMAT = 1

# default in-memory cap: generous for steady traffic (a few ops x a few
# buckets x a few batches), small enough that a plan-churning server stays
# bounded
DEFAULT_MAX_ENTRIES = 256


DEFAULT_MAX_DISK_BYTES = 1 << 30    # 1 GiB of records


def aot_supported() -> bool:
    """Can this process build the persistent tier's executables?  Always:
    a CUDA graph where the executor is on a card, the eager solver with
    its record on the CPU (the reference answers whether its jax can
    serialize an executable)."""
    return True


def environment_fingerprint(device: DeviceLike = None) -> Tuple:
    """(torch version, CUDA version, device name, device capability, the
    kernel library's source hash): the facts that invalidate every record
    at once when they drift.  ``device`` defaults to the current CUDA
    device where there is one, else the CPU (name ``"cpu"``, capability
    None)."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return (torch.__version__, torch.version.cuda, "cpu", None,
                build.source_hash())
    return (torch.__version__, torch.version.cuda,
            torch.cuda.get_device_name(dev),
            tuple(torch.cuda.get_device_capability(dev)),
            build.source_hash())


def _plain(value):
    """``value`` as JSON gives it back (tuples become lists), so that a
    record's key material compares equal to a live key's."""
    return json.loads(json.dumps(value))


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


def key_material(op: str, bucket: Tuple[int, ...], batch: int,
                 solver: "SolverKey", exec_token) -> Dict:
    """The key of one executable as a record stores it."""
    return _plain({"op": op, "bucket": list(bucket), "batch": int(batch),
                   "solver": dataclasses.asdict(solver),
                   "executor": exec_token})


def content_hash(op: str, bucket: Tuple[int, ...], batch: int,
                 solver: "SolverKey", exec_token) -> str:
    """Stable content address of one executable.

    Everything that changes the executable is in the digest: the op, the
    concrete shapes (bucket, batch), the solver numerics, the executor
    placement token (its device, or the mesh's axes and devices), the
    environment fingerprint and the record format.  A mismatch in any of
    them lands on a different file -- stale entries are never loaded,
    only evicted by the size cap in time.
    """
    material = repr((CACHE_FORMAT, op, tuple(bucket), int(batch),
                     dataclasses.astuple(solver), exec_token,
                     environment_fingerprint()))
    return hashlib.sha256(material.encode()).hexdigest()


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


class StaleRecord(ValueError):
    """A record that parsed but does not describe what this process would
    build (its key, its kernel plan or its output digest differ): the
    cache quarantines it and the caller builds again."""


class DiskCache:
    """Content-addressed directory of the persistent tier's records.

    One file an executable: ``<sha256>.json`` holding ``{"format",
    "fingerprint", "key", "record"}`` -- the executable's record (see the
    module docstring) under the header that lets a loader reject an entry
    copied across environments even when the file name matches.  Every
    failure degrades to a miss:

      * write: a ``tempfile`` in the cache directory, then ``os.replace``d
        into place -- readers see the old bytes or the new, never a
        prefix, so concurrent warmers are safe.
      * read: any failure (truncated JSON, header or key mismatch, a stale
        record) quarantines the file (best-effort unlink) and returns
        None; the caller builds and re-``put``s, repairing the entry.
      * size: after each write the directory is evicted down to
        ``max_bytes``, oldest access first (POSIX atime is unreliable, so
        eviction uses mtime and ``get`` re-touches on a hit).  The kernel
        library kept beside the records (``kernels/``) is not counted.
    """

    SUFFIX = ".json"

    def __init__(self, cache_dir,
                 max_bytes: int = DEFAULT_MAX_DISK_BYTES):
        self.dir = pathlib.Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.errors = 0        # corrupt/mismatched entries quarantined

    def _path(self, key_hash: str) -> pathlib.Path:
        return self.dir / f"{key_hash}{self.SUFFIX}"

    def get(self, key_hash: str, key: Optional[Dict] = None,
            load: Optional[Callable] = None):
        """``load(record)`` of the entry (the record itself without
        ``load``), or None on a miss or a quarantined entry.  ``key`` is
        the key material the entry must hold; ``load`` raising
        ``StaleRecord`` quarantines it too (any other error of ``load``
        is raised)."""
        path = self._path(key_hash)
        try:
            blob = path.read_bytes()
        except OSError:
            self.misses += 1
            return None
        try:
            doc = json.loads(blob)
            fingerprint = _plain(environment_fingerprint())
            if (doc["format"] != CACHE_FORMAT
                    or doc["fingerprint"] != fingerprint):
                raise StaleRecord(
                    f"cache entry of format {doc.get('format')} from "
                    f"{doc.get('fingerprint')}, this process is format "
                    f"{CACHE_FORMAT} on {fingerprint}")
            if key is not None and doc["key"] != _plain(key):
                raise StaleRecord(f"cache entry holds key {doc['key']}")
            record = doc["record"]
            # only a record that does not describe this build is stale; a
            # capture or a library load that fails raises to the caller
            fn = record if load is None else load(record)
        except (StaleRecord, json.JSONDecodeError, UnicodeDecodeError,
                KeyError, TypeError):
            # corrupt, truncated, drifted or stale: quarantine; the caller
            # builds again and re-puts, which repairs the entry
            self.quarantine(key_hash)
            return None
        self.hits += 1
        try:                   # refresh recency for mtime-ordered eviction
            os.utime(path)
        except OSError:
            pass
        return fn

    def quarantine(self, key_hash: str) -> None:
        self.errors += 1
        try:
            self._path(key_hash).unlink()
        except OSError:
            pass

    def put(self, key_hash: str, executable, key: Optional[Dict] = None
            ) -> bool:
        """Write one executable's record (``executable.record``, or a
        record dict); atomic, best-effort (a full disk is a skipped store,
        not a serving failure).  Returns True when the entry landed."""
        try:
            blob = json.dumps({
                "format": CACHE_FORMAT,
                "fingerprint": _plain(environment_fingerprint()),
                "key": key, "record": getattr(executable, "record",
                                              executable)},
                sort_keys=True).encode()
        except (TypeError, ValueError):
            self.errors += 1
            return False
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self._path(key_hash))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            self.errors += 1
            return False
        self.stores += 1
        self._evict_to_cap()
        return True

    def entries(self):
        return sorted(self.dir.glob(f"*{self.SUFFIX}"))

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for p in self.entries())

    def _evict_to_cap(self) -> None:
        """Drop oldest-touched entries until the directory fits the cap."""
        try:
            paths = [(p.stat().st_mtime, p.stat().st_size, p)
                     for p in self.entries()]
        except OSError:        # raced a concurrent eviction
            return
        total = sum(size for _, size, _ in paths)
        for _, size, path in sorted(paths, key=lambda t: t[0]):
            if total <= self.max_bytes:
                break
            try:
                path.unlink()
                total -= size
            except OSError:    # another process got there first
                pass

    def summary(self) -> Dict:
        return {
            "dir": str(self.dir),
            "entries": len(self.entries()),
            "bytes": self.total_bytes(),
            "max_bytes": self.max_bytes,
            "hits": self.hits, "misses": self.misses,
            "stores": self.stores, "errors": self.errors,
        }


class ExecutableCache:
    """The engine's two-tier solver cache (``PCAServer._cache``).

    Mapping surface (``len``/``in``/iteration/indexing) is the in-memory
    LRU tier; ``lookup``/``store`` add the disk tier underneath:

      lookup   memory hit -> (fn, "memory").  Disk hit -> the executor
               builds the record's executable (``from_record``: a graph
               captured again, no compile), promoted into memory,
               ("disk").  Otherwise (None, "miss").
      store    memory insert; with ``persist`` and a disk tier armed the
               executable's record is also written to disk.

    A disk tier also arms the kernel library's copy in ``cache_dir``
    (``kernels.build.arm_cache``).  One LRU backs the steady-state path
    and the disk tier's promotions, so the size cap is shared.
    """

    def __init__(self, max_entries: Optional[int] = DEFAULT_MAX_ENTRIES,
                 cache_dir=None,
                 max_disk_bytes: int = DEFAULT_MAX_DISK_BYTES):
        self.mem = LRUCache(max_entries=max_entries)
        self.disk: Optional[DiskCache] = None
        if cache_dir is not None and aot_supported():
            self.disk = DiskCache(cache_dir, max_bytes=max_disk_bytes)
            build.arm_cache(self.disk.dir / build.CACHE_SUBDIR)

    # -- mapping surface (the old dict's contract) --------------------------
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

    # -- two-tier path ------------------------------------------------------
    def hash_key(self, key) -> str:
        return content_hash(*key)

    def lookup(self, key, executor=None) -> Tuple[Optional[Callable], str]:
        """(solver, source) where source is 'memory'|'disk'|'miss'; a disk
        hit needs the ``executor`` that builds the record's executable."""
        fn = self.mem.get(key)
        if fn is not None:
            return fn, "memory"
        if self.disk is not None and executor is not None:
            fn = self.disk.get(self.hash_key(key), key=key_material(*key),
                               load=executor.from_record)
            if fn is not None:
                self.mem[key] = fn
                return fn, "disk"
        return None, "miss"

    def store(self, key, fn, persist: bool = False) -> None:
        self.mem[key] = fn
        if persist and self.disk is not None:
            self.disk.put(self.hash_key(key), fn, key=key_material(*key))

    def clear_memory(self) -> None:
        """Drop the in-memory tier only (a fresh replica's view of a warm
        disk cache -- used by cold-start runs and tests)."""
        self.mem.clear()

    def summary(self) -> Dict:
        return {
            "entries": len(self.mem),
            "max_entries": self.mem.max_entries,
            "evictions": self.mem.evictions,
            "disk": self.disk.summary() if self.disk is not None else None,
        }
