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

The persistent tier (``PCAServer(cache_dir=...)``) asks instead for one
executable a concrete (op, bucket, batch) key: ``aot_compile``.  On a card
that is a ``GraphedSolver``, the key's solve captured into a
``torch.cuda.CUDAGraph`` over static input tensors (about 50 sweep
launches and a few small ones replayed with no host work a kernel; a mesh
gets one graph a shard, on the shard's card); on the CPU the eager solver.
Either carries its ``record`` (``serving.cache``), from which
``from_record`` builds the executable again in a fresh process with no
compile: the kernel library from the cache directory, the graph captured
again with no eager solve and held to the record's output digest.  A
capture that fails, or a replay that differs from the eager solve, raises;
nothing serves the eager path in a graph's place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import jacobi
from ..core.pca import PCAConfig
from ..parallel.sharding import (Mesh, pad_to_multiple, rules_for_mesh,
                                 visible_devices)
from .cache import SolverKey, StaleRecord
from .inflight import InFlightFlush, copy_to_host
from .solver import (BatchedEighResult, BatchedPCAResult, BatchedSVDResult,
                     build_solver_fn)

RESULTS = {cls.__name__: cls for cls in (BatchedEighResult,
                                         BatchedSVDResult, BatchedPCAResult)}
CHECK_SEED = 0  # seed of the inputs a record's output digest is taken on


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


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _config_of(solver: Dict) -> PCAConfig:
    """A ``PCAConfig`` with the numerics of a record's ``SolverKey``."""
    fields = dict(solver)
    block = fields.pop("block")
    if block is not None:
        fields["T"] = block
    return dataclasses.replace(PCAConfig(), **fields)


def _seeded(op: str, bucket: Tuple[int, ...], rows: int):
    """The inputs a record's output digest is taken on: a seeded (rows,
    *bucket) slab (symmetric for eigh) and its full true sizes."""
    rng = np.random.default_rng(CHECK_SEED)
    x = rng.standard_normal((rows, *bucket)).astype(np.float32)
    if op == "eigh":
        x = (x + x.transpose(0, 2, 1)) / 2
    sizes = np.array([[bucket[0]] * rows, [bucket[-1]] * rows], np.int32)
    return x, sizes


def _digest(out) -> str:
    """SHA-256 of a result tree's bytes (field by field, in order)."""
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _structure(out) -> Dict:
    return {"type": type(out).__name__,
            "fields": [[name, list(t.shape), _dtype_name(t.dtype)]
                       for name, t in zip(out._fields, out)]}


def _bitwise(a, b) -> bool:
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def _sweep_width(config: PCAConfig, bucket: Tuple[int, ...]) -> int:
    """The width the sweeps of a bucket run at: its last dim, made even
    for the parallel pivot."""
    n = bucket[-1]
    return n + n % 2 if config.pivot == "parallel" else n


def plan_facts(device: torch.device, op: str, config: PCAConfig,
               bucket: Tuple[int, ...], rows: int,
               launched: Dict[str, int]) -> Dict:
    """The kernel plan of one key's solve on ``device`` that a record
    keeps: the sweep kernel and its grid (``fused.sweep_plan`` from the
    card's limits, ``repro_jacobi_sweep_limits``) where a sweep kernel
    launched, the Gram's m-axis slices where ``covariance`` did.  Empty
    off a card."""
    if device.type != "cuda":
        return {}
    from ..kernels import fused
    facts = {}
    if launched.get("jacobi_sweep") or launched.get("jacobi_sweep_smem"):
        n = _sweep_width(config, bucket)
        k = n // 2 if config.pivot == "parallel" else 1
        limits = fused._sweep_limits(device.index, n, k)
        plan = fused.sweep_plan(rows, n, k, *limits)
        facts["sweep"] = {"n": n, "k": k, "kernel": plan.kernel.name,
                          "grid": plan.grid, "limits": list(limits)}
    if launched.get("covariance"):
        slices, per = fused.cov_slices(bucket[0], bucket[-1], rows, 1024,
                                       fused._sm_count(device.index))
        facts["covariance"] = {"slices": slices, "rows": per}
    return facts


def _input_spec(bucket: Tuple[int, ...], rows: int) -> list:
    """A shard's static inputs: the slab and its true sizes."""
    return [["x", [rows, *bucket], "float32"], ["n_rows", [rows], "int32"],
            ["n_cols", [rows], "int32"]]


def make_record(op: str, config: PCAConfig, bucket: Tuple[int, ...],
                batch: int, rows: int, out, launched: Dict[str, int],
                device: torch.device) -> Dict:
    """The record of one key's executable (see ``serving.cache``): key
    material, a shard's static inputs, the output structure, the kernel
    plan, the launches of one solve and the output digest on the seeded
    inputs."""
    return {
        "op": op, "bucket": list(bucket), "batch": int(batch),
        "solver": dataclasses.asdict(SolverKey.from_config(config)),
        "rows": int(rows), "inputs": _input_spec(bucket, rows),
        "outputs": _structure(out),
        "plan": plan_facts(device, op, config, bucket, rows, launched),
        "launches": {k: n for k, n in sorted(launched.items()) if n},
        "check": {"seed": CHECK_SEED, "sha256": _digest(out)},
    }


class EagerSolver:
    """The eager solver of one key with its record: the persistent tier's
    executable on the CPU, where there is no graph."""

    def __init__(self, fn: Callable, record: Dict):
        self.fn = fn
        self.record = record

    def __call__(self, x, n_rows, n_cols):
        return self.fn(x, n_rows, n_cols)


class GraphedSolver:
    """One key's solve captured into a ``torch.cuda.CUDAGraph``.

    It owns static device inputs for the key's (rows, *bucket) slab and
    its true sizes, and the graph's outputs.  A call copies the staged
    batch into the static inputs on the current stream, replays, and
    returns the outputs -- the same tensors every call, overwritten by the
    next replay; callers copy them out on the same stream first
    (``inflight.copy_to_host``, enqueued right behind the replay).  The
    kernel wrappers count Python calls, so their launch counts move once,
    at capture, and never at a replay: the profiler's kernel names show
    what a replay ran, and ``replays`` times the record's ``launches``
    counts it.
    """

    def __init__(self, fn: Callable, record: Dict, device: torch.device):
        self.fn = fn
        self.record = record
        self.device = device
        self.static = tuple(
            torch.zeros(shape, dtype=getattr(torch, dtype), device=device)
            for _, shape, dtype in record["inputs"])
        self.graph = None
        self.out = None
        self.replays = 0

    def fill(self, x: np.ndarray, sizes: np.ndarray) -> None:
        """Copy host inputs into the static inputs (synchronously)."""
        self.static[0].copy_(torch.from_numpy(x))
        self.static[1].copy_(torch.from_numpy(sizes[0]))
        self.static[2].copy_(torch.from_numpy(sizes[-1]))

    def capture(self) -> None:
        """Capture ``fn`` on the static inputs, on a side stream, in the
        solve's sync-free form (``core.jacobi.capture_form``); raises
        whatever the capture raised."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side), jacobi.capture_form():
                graph.capture_begin()
                try:
                    out = self.fn(*self.static)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            main.wait_stream(side)
        self.graph, self.out = graph, out

    def __call__(self, x, n_rows, n_cols):
        for dst, src in zip(self.static, (x, n_rows, n_cols)):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.out


def _launched_by(fn: Callable, *args):
    """(fn(*args), launches of each kernel during the call)."""
    from ..kernels import launch_counts
    before = launch_counts()
    out = fn(*args)
    return out, {k: n - before[k] for k, n in launch_counts().items()}


def _aot_build(fn: Callable, op: str, config: PCAConfig,
               bucket: Tuple[int, ...], batch: int, rows: int,
               device: torch.device):
    """One shard's executable on ``device`` and its record.  On a card:
    the eager solve on the seeded inputs, the capture, one replay, held
    bitwise to the eager solve (a mismatch raises)."""
    x, sizes = _seeded(op, bucket, rows)
    if device.type != "cuda":
        out, launched = _launched_by(fn, torch.from_numpy(x),
                                     *torch.from_numpy(sizes))
        return EagerSolver(fn, make_record(op, config, bucket, batch, rows,
                                           out, launched, device))
    with torch.cuda.device(device):
        probe = GraphedSolver(fn, {"inputs": _input_spec(bucket, rows)},
                              device)
        probe.fill(x, sizes)
        eager, launched = _launched_by(fn, *probe.static)
        eager = type(eager)(*(t.clone() for t in eager))
        probe.capture()
        probe.graph.replay()
        torch.cuda.synchronize(device)
        if not _bitwise(probe.out, eager):
            raise RuntimeError(
                f"aot_compile({op}, {tuple(bucket)}, {batch}): the CUDA "
                f"graph's replay differs from the eager solve on {device}")
        probe.record = make_record(op, config, bucket, batch, rows,
                                   probe.out, launched, device)
    return probe


def _from_record(fn: Callable, record: Dict, config: PCAConfig,
                 device: torch.device):
    """One shard's executable from ``record`` on ``device`` with no
    compile and no eager solve: the graph captured again and one replay on
    the seeded inputs held to the record's digest.  ``StaleRecord`` where
    the record does not describe what this process builds."""
    op, bucket = record["op"], tuple(record["bucket"])
    rows = record["rows"]
    if device.type != "cuda":
        return EagerSolver(fn, record)
    from ..kernels import build
    with torch.cuda.device(device):
        build.library()  # the cache's copy where the process has none
        if record["plan"] != plan_facts(device, op, config, bucket, rows,
                                        record["launches"]):
            raise StaleRecord(f"kernel plan {record['plan']} is not this "
                              f"card's")
        # the pivot pairs' one copy to the card is made now: a copy from
        # a pinned temporary inside the capture would replay stale memory
        if config.pivot in ("parallel", "cyclic"):
            jacobi.pair_table(config.pivot, _sweep_width(config, bucket),
                              device)
        graphed = GraphedSolver(fn, record, device)
        graphed.fill(*_seeded(op, bucket, rows))
        torch.cuda.synchronize(device)
        graphed.capture()
        graphed.graph.replay()
        torch.cuda.synchronize(device)
    if (_structure(graphed.out) != record["outputs"]
            or _digest(graphed.out) != record["check"]["sha256"]):
        raise StaleRecord(
            f"the graph of ({op}, {bucket}, {record['batch']}) replays "
            f"to other outputs than its record's")
    return graphed


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

    def aot_compile(self, op: str, config: PCAConfig,
                    bucket: Tuple[int, ...], batch: int):
        """One concrete (bucket, batch) executable with its record, what
        the persistent tier stores and ``PCAServer.warmup`` pre-builds: on
        a card a ``GraphedSolver`` (a call replays the key's whole solve),
        on the CPU the eager solver."""
        return _aot_build(self.compile(op, config, bucket, batch), op,
                          config, tuple(bucket), batch, batch, self.device)

    def from_record(self, record: Dict):
        """The executable of a record written by ``aot_compile`` (in this
        process or another), built without a compile: the disk hit."""
        config = self._check_record(record)
        fn = self.compile(record["op"], config, tuple(record["bucket"]),
                          record["batch"])
        return _from_record(fn, record, config, self.device)

    def _check_record(self, record: Dict) -> PCAConfig:
        """The record's config; ``StaleRecord`` where the record is
        malformed or not of this executor's batch split."""
        try:
            fits = (record["op"] in ("eigh", "svd", "pca")
                    and record["outputs"]["type"] in RESULTS
                    and record["rows"] * self.n_shards == record["batch"]
                    and all(k in record for k in ("bucket", "inputs", "plan",
                                                  "launches", "check")))
            config = _config_of(record["solver"])
        except (KeyError, TypeError, ValueError) as err:
            raise StaleRecord(f"malformed record: {err!r}") from err
        if not fits:
            raise StaleRecord(f"record of ({record['op']}, "
                              f"{record['rows']} rows) is not this "
                              f"executor's")
        return config

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

    def aot_compile(self, op: str, config: PCAConfig,
                    bucket: Tuple[int, ...], batch: int):
        """One executable a shard (a graph on each shard's card), in shard
        order, with the first shard's record (every shard runs the same
        slab shape)."""
        fns = self.compile(op, config, bucket, batch)
        rows = batch // self.n_shards
        return ShardExecutables(
            _aot_build(fn, op, config, tuple(bucket), batch, rows, dev)
            for fn, dev in zip(fns, self.shard_devices))

    def from_record(self, record: Dict):
        config = self._check_record(record)
        fns = self.compile(record["op"], config, tuple(record["bucket"]),
                           record["batch"])
        return ShardExecutables(_from_record(fn, record, config, dev)
                                for fn, dev in zip(fns, self.shard_devices))

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


class ShardExecutables(tuple):
    """A mesh key's executables, one a shard in shard order; ``record`` is
    the first shard's."""

    @property
    def record(self) -> Dict:
        return self[0].record


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
