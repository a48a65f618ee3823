"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface and loaded with ``ctypes``.  The build happens at
first use, into ``build/repro_torch/<hash of sources and flags>/`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), so a
changed source is rebuilt and an unchanged one is loaded again.

With the serving engine's persistent tier armed (``arm_cache``, called
by ``serving.cache.ExecutableCache(cache_dir=...)``), the library is looked
up in this order: the process's build directory, then a copy under the
cache directory made from the same sources and flags (``source_hash``)
by the same CUDA toolkit (``toolkit_version``, read from the toolkit's
``version.json`` without running nvcc); only then is it built, and the
new library is copied into the cache directory (atomically).  So a
replica whose cache directory is warm runs nvcc no time
(``nvcc_runs``).  A copy made from other sources is never loaded.

Importing this module needs no ``nvcc`` and no card; ``library()`` does.
No fast-math flags: the Rutishauser angle needs IEEE sqrt and division.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parents[2]
BUILD_ENV = "REPRO_TORCH_BUILD_DIR"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "repro_cov_gram": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_cov_reduce": [_P, _P, _L, _I, _P],
    "repro_jacobi_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    "repro_jacobi_sweep_limits": [_I, _I, _P, _P, _P],
    "repro_mm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _L,
                 _L, _L, _I, _I, _P],
    "repro_dle_pivot": [_P, _P, _P, _I, _I, _I, _P],
    "repro_cordic": [_P, _P, _P, _P, _I, _P],
    "repro_flash_attention_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _P],
    "repro_flash_attention_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _I, _I, _P],
    "repro_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _I, _I, _I, _P],
    "repro_mamba_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "repro_scan_bf16_check": [_I, _P, _P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[pathlib.Path] = None
_NVCC_RUNS = 0                       # nvcc processes this process started
_NVCC_S = 0.0                        # wall seconds of this process's builds
_CACHE: Optional[pathlib.Path] = None  # armed library cache directory
CACHE_SUBDIR = "kernels"             # where a serving cache keeps the library


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    root = os.environ.get(BUILD_ENV)
    base = pathlib.Path(root) if root else REPO_ROOT / "build" / "repro_torch"
    return base / source_hash()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build (PATH or /usr/local/cuda)")
    return nvcc


def nvcc_runs() -> int:
    """How many nvcc processes (compiles and the link) this process ran."""
    return _NVCC_RUNS


def nvcc_seconds() -> float:
    """Wall seconds this process spent building the library with nvcc."""
    return _NVCC_S


def _toolkit_root() -> Optional[pathlib.Path]:
    """The CUDA toolkit's root: the one holding the nvcc on PATH, else
    ``$CUDA_HOME``, else ``/usr/local/cuda``; None without one."""
    nvcc = shutil.which("nvcc")
    roots = [pathlib.Path(nvcc).resolve().parent.parent] if nvcc else []
    roots += [pathlib.Path(p) for p in (os.environ.get("CUDA_HOME"),
                                        "/usr/local/cuda") if p]
    for root in roots:
        if (root / "bin" / "nvcc").is_file() or \
                (root / "version.json").is_file():
            return root.resolve()
    return None


@functools.lru_cache(maxsize=None)
def _toolkit_id(root: pathlib.Path) -> str:
    try:
        doc = json.loads((root / "version.json").read_text())
        part = doc.get("cuda_nvcc") or doc.get("cuda") or {}
        if "version" in part:
            return str(part["version"])
    except (OSError, ValueError):
        pass
    # no version.json: cuda.h's CUDA_VERSION and the nvcc binary's bytes
    try:
        header = (root / "include" / "cuda.h").read_text(errors="replace")
        found = re.search(r"#define\s+CUDA_VERSION\s+(\d+)", header)
        version = found.group(1) if found else "unknown"
        nvcc = hashlib.sha256((root / "bin" / "nvcc").read_bytes())
        return f"{version}.{nvcc.hexdigest()[:12]}"
    except OSError:
        return "unknown"


def toolkit_version() -> str:
    """The CUDA toolkit's version, read from files only (no nvcc run): its
    ``version.json`` (the nvcc component's where listed), else
    ``cuda.h``'s ``CUDA_VERSION`` and a hash of the nvcc binary;
    ``"none"`` without a toolkit."""
    root = _toolkit_root()
    return "none" if root is None else _toolkit_id(root)


def _digest(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def cached_dir(root: pathlib.Path) -> pathlib.Path:
    """Where ``root`` keeps the library of these sources and toolkit."""
    return pathlib.Path(root) / f"{source_hash()}-{toolkit_version()}"


def _cached_library(root: pathlib.Path) -> Optional[pathlib.Path]:
    """The library copy under ``root`` for these sources and this toolkit,
    or None.  A copy whose note names other sources or a toolkit, or whose
    bytes are not the ones noted, is never returned (a torn or foreign
    copy is removed)."""
    where = cached_dir(root)
    lib = where / LIB_NAME
    try:
        note = json.loads((where / "library.json").read_text())
    except (OSError, ValueError):
        return None
    if (note.get("source_hash") != source_hash()
            or note.get("toolkit") != toolkit_version()):
        return None
    try:
        if _digest(lib) == note.get("sha256"):
            return lib
    except OSError:
        return None
    for path in (where / "library.json", lib):
        try:
            path.unlink()
        except OSError:
            pass
    return None


def _write_atomic(path: pathlib.Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _store_library(root: pathlib.Path, lib: pathlib.Path) -> None:
    """Copy ``lib`` under ``root`` (atomically, the note last) unless a
    good copy is there; best-effort, as a cache write is."""
    if _cached_library(root) is not None:
        return
    where = cached_dir(root)
    try:
        where.mkdir(parents=True, exist_ok=True)
        _write_atomic(where / LIB_NAME, lib.read_bytes())
        _write_atomic(where / "library.json", json.dumps({
            "source_hash": source_hash(), "toolkit": toolkit_version(),
            "sha256": _digest(lib)}).encode())
    except OSError:
        pass


def arm_cache(root) -> None:
    """Keep the library under ``root`` too (the serving engine's cache
    directory): looked up after the build directory and before nvcc, and
    written after a build.  A library already loaded is copied there now
    if no copy is."""
    global _CACHE
    with _LOCK:
        _CACHE = pathlib.Path(root)
        if _LIB_PATH is not None:
            _store_library(_CACHE, _LIB_PATH)


def build() -> pathlib.Path:
    """The library's path: the build directory's, else the armed cache's
    copy, else compiled now (and copied into the armed cache).  Raises with
    the compiler's output on failure."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        if _CACHE is not None:
            _store_library(_CACHE, lib)
        return lib
    if _CACHE is not None:
        cached = _cached_library(_CACHE)
        if cached is not None:
            return cached
    _compile(out, lib)
    if _CACHE is not None:
        _store_library(_CACHE, lib)
    return lib


def _compile(out: pathlib.Path, lib: pathlib.Path) -> None:
    """Every source by its own nvcc process, then the link, into ``lib``."""
    global _NVCC_RUNS, _NVCC_S
    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}"
    jobs = []
    for src in sources():
        obj = out / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        _NVCC_RUNS += 1
    log, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode:
            failed.append(src.name)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out / f"{LIB_NAME}.{tag}.tmp"
    _NVCC_RUNS += 1
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in jobs)],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    for _, obj, _ in jobs:
        obj.unlink()
    _NVCC_S += time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB, _LIB_PATH
    if _LIB is not None:  # loaded: no lock on the launch path
        return _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB, _LIB_PATH = lib, path
        return _LIB


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status:
        text = library().repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
