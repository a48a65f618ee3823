"""Backend-dispatch registry for the port's kernel layer.

Every hot-path op resolves, at call time, to one of two named
implementations:

  ``cuda``   the hand-written CUDA kernel (needs a CUDA tensor; raises on
             any other)
  ``torch``  the plain PyTorch version of the same function

Resolution order for the backend name:

  1. per-call override (``backend=`` on the op);
  2. scoped override (``use_backend``), then the process default
     (``set_default_backend``);
  3. the ``REPRO_TORCH_BACKEND`` environment variable;
  4. auto: follow the tensor -- ``cuda`` for a CUDA tensor or a ``meta``
     one (the dry run's, which stands for one), ``torch`` for a CPU
     tensor.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

BACKENDS: Tuple[str, ...] = ("cuda", "torch")

ENV_VAR = "REPRO_TORCH_BACKEND"

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_STATE = threading.local()
_PROCESS_DEFAULT: Optional[str] = None

# per-(op, backend) resolution counts: which implementation every op call
# landed on
_RESOLUTIONS: "collections.Counter[Tuple[str, str]]" = collections.Counter()


def _check_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {BACKENDS}")
    return name


def register(op: str, backend: str) -> Callable[[Callable], Callable]:
    """Decorator: ``@register("mm_engine_matmul", "torch")``."""
    _check_backend(backend)

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op, {})[backend] = fn
        return fn

    return deco


_BUILTINS_LOADED = False


def _ensure_populated() -> None:
    # the built-in implementations register themselves when
    # repro_torch.kernels.ops imports
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        _BUILTINS_LOADED = True
        import repro_torch.kernels.ops  # noqa: F401


def registered_ops() -> Tuple[str, ...]:
    _ensure_populated()
    return tuple(sorted(_REGISTRY))


def backends_for(op: str) -> Tuple[str, ...]:
    _ensure_populated()
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {registered_ops()}")
    impls = _REGISTRY[op]
    return tuple(b for b in BACKENDS if b in impls)


def available() -> Tuple[str, ...]:
    """Backends runnable on this host (``cuda`` needs a CUDA device)."""
    return tuple(b for b in BACKENDS
                 if b != "cuda" or torch.cuda.is_available())


def default_backend(like: Optional[torch.Tensor] = None) -> str:
    """The backend used when no per-call override is given; ``like`` is the
    tensor the op will run on (auto resolution follows its device)."""
    override = getattr(_STATE, "backend", None)
    if override is not None:
        return override
    if _PROCESS_DEFAULT is not None:
        return _PROCESS_DEFAULT
    env = os.environ.get(ENV_VAR)
    if env:
        return _check_backend(env)
    return ("cuda" if like is not None and (like.is_cuda or like.is_meta)
            else "torch")


def set_default_backend(name: Optional[str]) -> None:
    """Set (or with ``None`` clear) the process-level default backend."""
    global _PROCESS_DEFAULT
    _PROCESS_DEFAULT = None if name is None else _check_backend(name)


def scoped_backend() -> Optional[str]:
    """This thread's ``use_backend`` override, or None."""
    return getattr(_STATE, "backend", None)


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped (thread-local) backend override."""
    _check_backend(name)
    prev = getattr(_STATE, "backend", None)
    _STATE.backend = name
    try:
        yield
    finally:
        _STATE.backend = prev


def resolve(op: str, backend: Optional[str] = None,
            like: Optional[torch.Tensor] = None) -> Callable:
    """The implementation of ``op`` for ``backend`` (None = resolution order
    above, with ``like`` the tensor the op runs on)."""
    _ensure_populated()
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {registered_ops()}")
    name = (default_backend(like) if backend is None
            else _check_backend(backend))
    impls = _REGISTRY[op]
    if name not in impls:
        raise KeyError(
            f"op {op!r} has no {name!r} backend; available: "
            f"{backends_for(op)}")
    _RESOLUTIONS[(op, name)] += 1
    return impls[name]


def resolution_counts() -> Dict[Tuple[str, str], int]:
    """Lifetime (op, backend) -> resolve() count."""
    return dict(_RESOLUTIONS)


def reset_resolution_counts() -> None:
    _RESOLUTIONS.clear()


def describe() -> str:
    """Multi-line op x backend availability table for logs."""
    _ensure_populated()
    lines = [f"default backend: {default_backend()} for CPU tensors"
             f" (env {ENV_VAR}={os.environ.get(ENV_VAR, '<unset>')})"]
    for op in registered_ops():
        lines.append(f"  {op:<20s} {', '.join(backends_for(op))}")
    return "\n".join(lines)
