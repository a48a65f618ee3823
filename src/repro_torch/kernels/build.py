"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface and loaded with ``ctypes``.  The build happens at
first use, into ``build/repro_torch/<hash of sources and flags>/`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), so a
changed source is rebuilt and an unchanged one is loaded again.

Importing this module needs no ``nvcc`` and no card; ``library()`` does.
No fast-math flags: the Rutishauser angle needs IEEE sqrt and division.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
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
    "repro_cov_gram": [_P, _I, _P, _I, _I, _I, _I, _I, _P],
    "repro_cov_reduce": [_P, _P, _L, _I, _P],
    "repro_jacobi_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_mm": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                 _P],
    "repro_dle_scan": [_P, _P, _P, _P, _P, _I, _I, _P],
    "repro_cordic": [_P, _P, _P, _P, _P, _P, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                              _I, _P],
    "repro_flash_attention_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                  _I, _P],
    "repro_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _I, _I, _I, _P],
    "repro_mamba_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


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


def build() -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  Raises with the compiler's output on failure."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
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
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in jobs)],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    for _, obj, _ in jobs:
        obj.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status:
        text = library().repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
