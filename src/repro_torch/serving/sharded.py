"""Flush executors: where a bucket's microbatch runs (port of
``repro.serving.sharded``, the single-device part).

``PCAServer`` owns queueing, bucketing and deadlines and delegates the
solver, the placement and the launch to an executor.  ``LocalExecutor``
runs every flush on one device (default ``cuda``):

  * ``compile`` hands out one ``build_solver_fn`` closure per (op,
    ``SolverKey``).  The port's solvers run eagerly, so there is no trace
    to cache: a solve is about 50 sweep launches and a few small ones,
    each queued without a wait.
  * ``submit`` launches without blocking the host: the stacked batch and
    the true sizes go to the card through pinned host memory
    (``non_blocking=True`` copies; a copy from pageable memory would wait
    for every launch queued before it), the solver enqueues its kernels,
    the copy of its results to pinned host memory follows them
    (``inflight.copy_to_host``), and a ``torch.cuda.Event`` recorded right
    after that is the flush's completion signal.  The pinned buffers ride
    on the ``InFlightFlush`` until it retires.

The reference's ``MeshExecutor`` (one flush sharded across a device mesh)
is not ported yet: ``mesh_executor`` gives a ``LocalExecutor`` wherever
its spec resolves to one device, and raises where it resolves to more.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.pca import PCAConfig
from .cache import SolverKey
from .inflight import InFlightFlush, copy_to_host
from .solver import build_solver_fn


def _stage(a: np.ndarray, dtype: torch.dtype, device: torch.device):
    """(device tensor, host tensor it was copied from) for numpy ``a``: on
    a card, a pinned host copy and a non-blocking copy from it."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return host.to(device=device, dtype=dtype), None
    pinned = torch.empty(host.shape, dtype=dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True), pinned


class LocalExecutor:
    """Single-device flush execution.

    Near-stateless: the engine owns the solver cache; the executor decides
    batch rounding, builds the solvers (one per solver identity) and
    launches them.  ``device`` defaults to ``cuda`` and, as every entry
    point of the port, raises on a host without a card; pass
    ``device="cpu"`` for the plain PyTorch versions.
    """

    n_shards: int = 1
    # optional observability bundle; the engine attaches its own when it
    # carries one, so launches are traced where they happen
    obs = None

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._solvers = {}

    def cache_token(self):
        """Executor identity mixed into the engine's solver-cache key."""
        return ("local", str(self.device))

    def round_batch(self, b: int) -> int:
        """Device batch the engine must pad a b-request flush up to."""
        return b

    def compile(self, op: str, config: PCAConfig,
                bucket: Tuple[int, ...], batch: int) -> Callable:
        """The solver of (op, config), built once per (op, ``SolverKey``)
        and shared by every (bucket, batch) key that routes through it."""
        del bucket, batch  # the eager solver takes any shape
        key = (op, SolverKey.from_config(config))
        fn = self._solvers.get(key)
        if fn is None:
            fn = self._solvers[key] = build_solver_fn(op, config,
                                                      device=self.device)
        return fn

    def submit(self, fn: Callable, batch, n_active) -> InFlightFlush:
        """Launch a flush without blocking (the pipeline's dispatch stage).

        ``batch`` is the stacked (B, *bucket) float32 slab and ``n_active``
        the (ndim, B) int32 true sizes, both numpy.  The returned handle
        exposes ``ready()`` for completion detection and ``result()`` for
        the single host gather -- per-request slicing happens on the host
        copy.
        """
        obs = self.obs
        t0 = obs.clock() if obs is not None else 0.0
        dev = self.device
        xb, pinned_b = _stage(batch, torch.float32, dev)
        na, pinned_n = _stage(n_active, torch.int32, dev)
        out = fn(xb, *na)
        copy = event = None
        if dev.type == "cuda":
            copy = copy_to_host(out)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        if obs is not None:
            obs.tracer.complete(
                "launch", ts=t0, end=obs.clock(), cat="launch",
                track="launch", executor=self.describe(),
                batch=int(np.shape(batch)[0]), n_shards=self.n_shards)
            obs.metrics.counter(
                "serve_launches_total", "Device launches by executor.",
                ("executor", )).labels(self.describe()).inc()
        staged = tuple(t for t in (pinned_b, pinned_n) if t is not None)
        return InFlightFlush(out, n_shards=self.n_shards, copy=copy,
                             event=event, staged=staged)

    def run(self, fn: Callable, batch, n_active):
        """Blocking compatibility path: ``submit(...).result()``."""
        return self.submit(fn, batch, n_active).result()

    def describe(self) -> str:
        return f"local({self.device})"


def mesh_executor(spec, device: DeviceLike = None) -> LocalExecutor:
    """Executor from a CLI-style mesh spec, on ``device`` (default
    ``cuda``).

    ``None``/``"none"``/``"local"`` and an int(-string) N <= 1 give a
    ``LocalExecutor``.  ``"auto"`` (every visible device) and N (the first
    min(N, visible) devices) clamp to the devices visible to ``device``'s
    type, as the reference's ``host_mesh`` does: the CUDA devices, or one
    on the CPU.  Where that leaves one device the result is a
    ``LocalExecutor`` on it; a mesh over more than one is not ported yet
    (the multi-device ``MeshExecutor``, ROADMAP queue 1 item 4) and
    raises."""
    if spec is None or spec in ("none", "local"):
        return LocalExecutor(device)
    n = None if spec == "auto" else int(spec)
    if n is not None and n <= 1:
        return LocalExecutor(device)
    dev = resolve_device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = visible if n is None else min(n, visible)
    if n <= 1:
        return LocalExecutor(dev)
    raise NotImplementedError(
        f"mesh spec {spec!r} resolves to {n} devices: the multi-device "
        "MeshExecutor is not ported yet (ROADMAP queue 1 item 4); use "
        "None, 'none', 'local', N <= 1, or a host with one device")
