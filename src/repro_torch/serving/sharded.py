"""Flush executors: where a bucket's microbatch runs (port of
``repro.serving.sharded``).

``PCAServer`` owns queueing, bucketing and deadlines and delegates the
solver, the placement and the launch to an executor:

  * ``LocalExecutor`` -- one device (default ``cuda``).  ``compile`` hands
    out one ``build_solver_fn`` closure per (op, ``SolverKey``).  The
    port's solvers run eagerly, so there is no trace to cache: a solve is
    about 50 sweep launches and a few small ones, each queued without a
    wait.  ``submit`` launches without blocking the host: the stacked
    batch and the true sizes go to the card through pinned host memory
    (``non_blocking=True`` copies; a copy from pageable memory would wait
    for every launch queued before it), the solver enqueues its kernels,
    the copy of its results to pinned host memory follows them
    (``inflight.copy_to_host``), and a ``torch.cuda.Event`` recorded right
    after that is the flush's completion signal.  The pinned buffers ride
    on the ``InFlightFlush`` until it retires.
  * ``MeshExecutor`` -- the paper's next rung: replicate the whole fabric
    across a device mesh (``parallel.sharding.Mesh``) and shard the
    microbatch (S) axis over its data axis, so one flush retires S x
    n_devices requests.  One process drives every device: ``submit``
    splits the slab into contiguous shards, and each shard is staged,
    launched, copied back and signalled on its own device exactly as a
    ``LocalExecutor`` flush is.  Each problem lives on one shard, so a
    sharded flush is the same arithmetic as the local flush on every
    problem.  Partial flushes pad up to a multiple of the shard count, so
    every shard gets an identical slab.

Solvers cache under a key that includes ``cache_token()`` (the device, or
the mesh's axis sizes and devices), so one server can swap meshes without
reusing a solver built for another placement.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.pca import PCAConfig
from ..parallel.sharding import (Mesh, pad_to_multiple, rules_for_mesh,
                                 visible_devices)
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


def _launch(fn: Callable, batch: np.ndarray, n_active: np.ndarray,
            device: torch.device):
    """One slab's launch on ``device``: (result tree, its host copy in
    flight, the event after it, the pinned inputs) -- the last three None
    or empty on the CPU, where the solve has finished on return."""
    on_card = device.type == "cuda"
    with torch.cuda.device(device) if on_card else contextlib.nullcontext():
        xb, pinned_b = _stage(batch, torch.float32, device)
        na, pinned_n = _stage(n_active, torch.int32, device)
        out = fn(xb, *na)
        copy = event = None
        if on_card:
            copy = copy_to_host(out)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
    staged = tuple(t for t in (pinned_b, pinned_n) if t is not None)
    return out, copy, event, staged


def _flush(shards, n_shards: int) -> InFlightFlush:
    """The ``InFlightFlush`` of ``_launch`` results, in shard order."""
    outs, copies, events, staged = zip(*shards)
    return InFlightFlush(
        outs, n_shards=n_shards,
        copies=tuple(c for c in copies if c is not None),
        events=tuple(e for e in events if e is not None),
        staged=tuple(t for ts in staged for t in ts))


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
        t0 = self.obs.clock() if self.obs is not None else 0.0
        shard = _launch(fn, batch, n_active, self.device)
        self._trace_launch(t0, batch)
        return _flush((shard,), self.n_shards)

    def _trace_launch(self, t0: float, batch) -> None:
        obs = self.obs
        if obs is None:
            return
        obs.tracer.complete(
            "launch", ts=t0, end=obs.clock(), cat="launch",
            track="launch", executor=self.describe(),
            batch=int(np.shape(batch)[0]), n_shards=self.n_shards)
        obs.metrics.counter(
            "serve_launches_total", "Device launches by executor.",
            ("executor", )).labels(self.describe()).inc()

    def run(self, fn: Callable, batch, n_active):
        """Blocking compatibility path: ``submit(...).result()``."""
        return self.submit(fn, batch, n_active).result()

    def describe(self) -> str:
        return f"local({self.device})"


class MeshExecutor(LocalExecutor):
    """Shard the flush's batch (S) axis across a named device mesh.

    Args:
      mesh: the ``parallel.sharding.Mesh`` to run on; ``data_axis`` must
        be one of its axis names.  Default: a 1-D "data" mesh over
        ``devices``, or over every visible card (raising on a host without
        one, as every entry point of the port; pass CPU devices, which may
        repeat, to run the plain PyTorch versions).
      devices: devices for the default mesh (ignored when ``mesh`` given).
      data_axis: mesh axis the batch dim shards over.

    The batch role (``Rules.axis("batch")``: "pod" and "data") must
    resolve onto ``data_axis``; ``n_shards`` is the product of the batch
    axes' sizes.  Shard i runs on the i-th device along the batch axes
    (``Mesh.axis_devices``).  ``device`` is the first of them: where a
    plan swap builds its next executor.
    """

    def __init__(self, mesh: Optional[Mesh] = None,
                 devices: Optional[Sequence] = None,
                 data_axis: str = "data"):
        if mesh is None:
            devs = list(devices if devices is not None
                        else visible_devices())
            mesh = Mesh(devs, (data_axis,))
        if data_axis not in mesh.axis_names:
            raise ValueError(
                f"data_axis {data_axis!r} not in mesh axes {mesh.axis_names}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.rules = rules_for_mesh(mesh)
        axes = self.rules.axis("batch")
        if not axes or data_axis not in axes:
            raise ValueError(
                "the batch role must resolve onto the data axis; name the "
                f"mesh axis 'data' (got mesh axes {mesh.axis_names})")
        self.n_shards = int(np.prod([mesh.shape[a] for a in axes]))
        self.shard_devices = tuple(mesh.axis_devices(axes))
        self.device = self.shard_devices[0]
        if self.device.type == "cuda":
            resolve_device(self.device)
        self._solvers = {}

    def cache_token(self):
        # axis sizes + each device and its place: same-shaped meshes over
        # different devices must not share solvers
        return ("mesh", tuple(self.mesh.shape.items()),
                tuple(str(d) for d in self.mesh.devices.flat))

    def round_batch(self, b: int) -> int:
        return pad_to_multiple(max(b, 1), self.n_shards)

    def compile(self, op: str, config: PCAConfig,
                bucket: Tuple[int, ...], batch: int) -> Tuple[Callable, ...]:
        """One solver a shard, in shard order; each built once per (op,
        ``SolverKey``, device)."""
        if batch % self.n_shards:
            raise ValueError(
                f"batch {batch} not a multiple of the data-axis size "
                f"{self.n_shards}; round with round_batch() first")
        key = (op, SolverKey.from_config(config))
        fns = []
        for dev in self.shard_devices:
            fn = self._solvers.get(key + (dev,))
            if fn is None:
                fn = self._solvers[key + (dev,)] = build_solver_fn(
                    op, config, device=dev)
            fns.append(fn)
        return tuple(fns)

    def submit(self, fn: Sequence[Callable], batch,
               n_active) -> InFlightFlush:
        """Launch a flush shard by shard, without blocking the host: the
        leading dim of ``batch`` and the last of ``n_active`` split into
        ``n_shards`` contiguous slabs, and each is staged, launched, copied
        back and signalled on its own device (``LocalExecutor.submit``)."""
        t0 = self.obs.clock() if self.obs is not None else 0.0
        b = np.shape(batch)[0]
        if b % self.n_shards:
            raise ValueError(
                f"batch {b} not a multiple of the data-axis size "
                f"{self.n_shards}")
        rows = b // self.n_shards
        shards = [_launch(f, batch[i * rows:(i + 1) * rows],
                          n_active[:, i * rows:(i + 1) * rows], dev)
                  for i, (f, dev) in enumerate(zip(fn, self.shard_devices))]
        self._trace_launch(t0, batch)
        return _flush(shards, self.n_shards)

    def describe(self) -> str:
        shape = "x".join(f"{k}={v}" for k, v in self.mesh.shape.items())
        return f"mesh({shape}; {self.n_shards} shards)"


def host_mesh(n_devices: Optional[int] = None, data_axis: str = "data",
              device: DeviceLike = None) -> Mesh:
    """A 1-D data mesh over the first ``n_devices`` devices visible to
    ``device``'s type (None/0 = all; default ``cuda``): the CUDA cards,
    or the one CPU device.  Asking for more than visible clamps rather
    than raising, so one launch line works on one card and on eight."""
    devs = visible_devices(device)
    n = len(devs) if not n_devices else min(n_devices, len(devs))
    return Mesh(devs[:n], (data_axis,))


def mesh_executor(spec, device: DeviceLike = None) -> LocalExecutor:
    """Executor from a CLI-style mesh spec, on ``device``'s type (default
    ``cuda``).

    ``None``/``"none"``/``"local"`` and an int(-string) N <= 1 give a
    ``LocalExecutor`` on ``device``; ``"auto"`` a ``MeshExecutor`` over
    every visible device, N one over the first min(N, visible)
    (``host_mesh``) -- a 1-device mesh where one is visible, as the
    reference's does.
    """
    if spec is None or spec in ("none", "local"):
        return LocalExecutor(device)
    if spec == "auto":
        n = None
    else:
        n = int(spec)
        if n <= 1:
            return LocalExecutor(device)
    return MeshExecutor(mesh=host_mesh(n, device=device))
