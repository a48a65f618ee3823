"""PCAServer: deadline-aware microbatching over shape-bucketed traffic
(port of ``repro.serving.engine``).

The serving loop is the software image of the paper's fabric: the Matrix
Padding Unit (``batching``) normalizes heterogeneous requests into T-multiple
buckets, and the S-array axis (``solver``) retires up to S same-bucket
requests per dispatch.  Requests queue per (op, bucket); a queue flushes when
it reaches S (full microbatch) or when its oldest request's deadline expires
(``poll``).  Each (op, bucket, batch) triple maps to one solver held in an
explicit cache -- with ``pad_batches=True`` partial flushes are zero-padded
up to S so steady-state traffic runs on one cached solver a bucket.

A flush is a three-stage pipeline, the software image of the paper's
block-streaming (keep the S arrays busy while the next block streams in):

  dispatch   ``_dispatch_key``: stack/pad, grab the cached solver,
             launch via ``executor.submit`` -- non-blocking, the host goes
             straight back to batching while the card crunches.
  in-flight  a bounded ``inflight.InFlightQueue`` of launched flushes
             (``max_inflight`` is the back-pressure valve).
  retire     ``_retire``: one host gather per flush, unpack into tickets,
             record telemetry.  ``poll``/``drain`` retire completed
             flushes; ``Ticket.result()``/``Ticket.wait()`` force exactly
             their own flush home.

With ``max_inflight=1`` (the default) every dispatch immediately retires
its own flush -- exactly the synchronous engine this pipeline replaced --
so the clock-injectable deterministic test story is unchanged: callers
drive time via ``submit``/``poll``/``drain``.

Where a flush *runs* is the executor's business (``sharded``): the default
``LocalExecutor()`` runs on ``cuda`` (and raises on a host without a card;
``LocalExecutor(device="cpu")`` runs the plain PyTorch versions).  The
engine only asks the executor to round the batch, build the solver, and
launch it -- queueing/bucketing/deadlines never see devices.

With ``cache_dir`` the engine arms the persistent tier
(``serving.cache.DiskCache``): a miss builds the key's executable ahead of
time (``executor.aot_compile``: a CUDA graph of the whole solve on a card)
and writes its record, and a fresh replica pointed at the same directory
captures its graphs again from the records, with the kernel library from
the same directory -- no nvcc run, no eager solve.  ``from_spec`` builds
through ``serving.spec.build_server``; the ``obs`` bundle is the port's
``repro_torch.obs.Observability``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.pca import PCAConfig
from .batching import BucketPolicy, padding_waste, stack_requests
from .cache import DEFAULT_MAX_ENTRIES, ExecutableCache, SolverKey
from .inflight import InFlightFlush, InFlightQueue
from .sharded import LocalExecutor
from .stats import RequestRecord, ServingStats

OPS = ("eigh", "svd", "pca")

# sentinel distinguishing "caller passed this kwarg" from the default --
# the deprecation shim below counts explicit spec-covered kwargs
_UNSET = object()

# how many spec-covered kwargs a direct PCAServer(...) call may pass
# before the construction is spec-shaped enough that the shim asks for a
# ServerSpec instead (1-2 kwargs is a tweak; 3+ is a configuration)
SPEC_SHIM_THRESHOLD = 3

_spec_depth = 0  # >0 while spec.build_server / server_for_plan constructs


@contextlib.contextmanager
def spec_construction():
    """Suppress the multi-kwarg ``DeprecationWarning`` for construction
    paths that already went through the spec layer (``PCAServer.from_spec``
    builds with many kwargs internally -- that is the blessed path, not
    the deprecated one)."""
    global _spec_depth
    _spec_depth += 1
    try:
        yield
    finally:
        _spec_depth -= 1


def _serialized(method):
    """Run ``method`` under the server's lock.  The paced open-loop
    frontend drives one server from two threads (its worker submits and
    polls while the feeder ticks the controller, which may apply a plan);
    the lock keeps a plan swap from interleaving with a submit, which
    could otherwise drop the submitted request between the old queues and
    the new.  Reentrant: a poll that ticks the controller applies its plan
    under the lock it already holds."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return locked


# a backend router maps (op, bucket_shape) -> kernel backend name for that
# bucket's solver (None = plain torch.matmul datapath); see
# ``repro_torch.backends`` for the names
BackendRouter = Callable[[str, Tuple[int, ...]], Optional[str]]


def threshold_router(min_dim: int, large: Optional[str] = "auto",
                     small: Optional[str] = None) -> BackendRouter:
    """Route big buckets to one backend, small ones to another.

    Kernel-launch overhead dominates tiny problems (keep them on the plain
    matmul datapath) while large tiles win on the MM-Engine.  A bucket
    whose largest dim reaches ``min_dim`` routes to ``large``; everything
    else to ``small``.  ``"auto"`` resolves through the registry's
    ``default_backend()`` (a scoped or process override, then
    ``$REPRO_TORCH_BACKEND``, else ``torch``); ``None`` means the plain
    ``torch.matmul`` datapath.

    ``"auto"`` is resolved *once, here at construction*, pinning the
    routing decision for the router's lifetime: a later
    ``set_default_backend``/``use_backend`` must not silently re-route a
    live server's buckets (build a new router to pick up a changed
    default), and ``RequestRecord.backend`` telemetry always names the
    concrete backend, never the sentinel.
    """
    def resolve(name: Optional[str]) -> Optional[str]:
        if name == "auto":
            from ..backends import default_backend
            return default_backend()
        return name

    large = resolve(large)
    small = resolve(small)

    def route(op: str, bucket: Tuple[int, ...]) -> Optional[str]:
        del op
        return large if max(bucket) >= min_dim else small
    return route


@dataclasses.dataclass(frozen=True)
class ServedEigh:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    off_norm: float


@dataclasses.dataclass(frozen=True)
class ServedSVD:
    U: np.ndarray
    S: np.ndarray
    Vt: np.ndarray


@dataclasses.dataclass(frozen=True)
class ServedPCA:
    components: np.ndarray
    eigenvalues: np.ndarray
    mean: np.ndarray
    scale: np.ndarray
    evcr: np.ndarray
    cvcr: np.ndarray
    off_norm: float


class Ticket:
    """Handle returned by ``submit``; fulfilled when its flush retires.

    A ticket moves through the pipeline stages with its request: *queued*
    (waiting in its bucket queue), *in flight* (its microbatch was
    dispatched and is executing), *done* (its flush retired).  ``result()``
    on an in-flight ticket forces exactly its own flush home; ``wait()``
    additionally dispatches a still-queued partial batch, so it always
    makes progress.
    """

    __slots__ = ("rid", "op", "shape", "bucket", "sweeps", "record",
                 "_result", "_done", "_flush", "_server")

    def __init__(self, rid: int, op: str, shape, bucket, sweeps: int = 0):
        self.rid = rid
        self.op = op
        self.shape = shape
        self.bucket = bucket
        self.sweeps = sweeps
        self.record: Optional[RequestRecord] = None
        self._result = None
        self._done = False
        self._flush: Optional[InFlightFlush] = None
        self._server = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def inflight(self) -> bool:
        """Dispatched but not yet retired."""
        return self._flush is not None

    def result(self):
        """The served result; retires this ticket's own flush if it is in
        flight, raises if the request is still queued (un-dispatched)."""
        if not self._done:
            flush = self._flush
            if flush is None:
                depth = (self._server._queue_depth(self.op, self.bucket,
                                                   self.sweeps)
                         if self._server is not None else 0)
                raise RuntimeError(
                    f"request {self.rid} (op={self.op!r}, bucket "
                    f"{self.bucket}) is still queued ({depth} request(s) "
                    f"in its bucket queue); call wait(), or poll()/drain() "
                    f"the server, to flush it")
            flush.retire()
        return self._result

    def wait(self, timeout: Optional[float] = None):
        """Block until this request's result is available and return it.

        A still-queued request first has its bucket queue dispatched (a
        partial flush, like a deadline expiry).  ``timeout`` -- measured on
        the host wall clock, not the server's injectable clock, since it
        bounds a real device wait -- raises ``TimeoutError`` if the flush
        has not completed in time (the flush stays in flight and a later
        ``wait``/``poll``/``drain`` can still retire it).
        """
        if self._done:
            return self._result
        if self._flush is None:
            if self._server is None:
                raise RuntimeError(
                    f"request {self.rid} is not attached to a server")
            self._server._dispatch_key((self.op, self.bucket, self.sweeps))
        if self._done:  # dispatch back-pressure may already have retired us
            return self._result
        if timeout is not None:
            deadline = time.monotonic() + timeout
            while not self._flush.ready():
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"request {self.rid} (op={self.op!r}, bucket "
                        f"{self.bucket}) still in flight after "
                        f"{timeout:g}s")
                time.sleep(50e-6)
        self._flush.retire()
        return self._result

    def _fulfil(self, result, record: RequestRecord) -> None:
        self._result = result
        self.record = record
        self._done = True
        self._flush = None
        self._server = None


@dataclasses.dataclass
class _Pending:
    rid: int
    matrix: np.ndarray
    ticket: Ticket
    t_submit: float
    flush_by: float


class PCAServer:
    """Multi-tenant PCA/SVD/eigh service over one PCAConfig.

    Args:
      config: solver configuration; ``config.S`` is the default microbatch
        size (the fabric's S arrays), ``config.T`` the default bucket tile.
      policy: bucket policy (default: tile-mode with T = config.T).
      max_batch: requests per device batch (default: config.S).
      max_delay_s: default flush deadline for a queued request.
      pad_batches: zero-pad partial flushes up to max_batch so every bucket
        uses a single cached executable (no recompiles on timeout flushes).
      backend_router: optional (op, bucket) -> backend-name routing so
        different buckets run on different kernel backends in one server
        (e.g. ``threshold_router(128, large="cuda")``: big buckets on the
        CUDA MM-Engine, small ones on plain ``torch.matmul``).  Default:
        every bucket uses ``config.backend``.  The solver cache key is
        backend-qualified.
      executor: where flushes run (default: ``LocalExecutor()``, one CUDA
        device; raises on a host without a card).  The cache key is
        executor-qualified (its device), so swapping executors never
        reuses a solver built for another placement.
      max_inflight: pipeline depth -- how many dispatched flushes may
        exist simultaneously, counting the one being dispatched.  ``1``
        (the default) is the synchronous engine: every dispatch
        immediately blocks on its own retirement.  ``N > 1`` lets up to
        ``N - 1`` flushes stay in flight while the host batches the next,
        overlapping host-side stacking/padding/unpacking with device
        execution; dispatching beyond the cap back-pressures by retiring
        the oldest flush first.
      obs: optional ``repro_torch.obs.Observability`` bundle.  When given,
        every pipeline stage emits spans (request submit->fulfil, flush
        dispatch/inflight/wait/retire with compile children on cache
        misses, plan swaps) into its tracer and per-(op, bucket, backend,
        executor) counters/histograms into its metric registry, and each
        fulfilled request is SLO-accounted.  ``None`` (the default) is the
        uninstrumented fast path: one attribute check per stage.  Give the
        bundle the same ``clock`` as the server so spans line up with
        telemetry.
      cache_dir: optional directory for the persistent executable tier.
        When set, every solver miss builds its (op, bucket, batch)
        executable ahead of time (on a card a CUDA graph of the solve) and
        writes its record there, and the kernel library is kept there too,
        so the *next* replica pointed at the same directory warms from
        disk: no nvcc run, no eager solve (see ``serving.cache``).  ``None``
        (the default) keeps the eager solvers.
      max_cached_executables: in-memory solver cap; least-recently-
        dispatched entries are evicted beyond it.  ``None`` = unbounded.
      clock: injectable monotonic clock (tests drive deadlines manually).
    """

    def __init__(
        self,
        config: PCAConfig = PCAConfig(),
        policy: Optional[BucketPolicy] = _UNSET,
        max_batch: Optional[int] = _UNSET,
        max_delay_s: float = _UNSET,
        pad_batches: bool = _UNSET,
        backend_router: Optional[BackendRouter] = _UNSET,
        executor: Optional[LocalExecutor] = _UNSET,
        max_inflight: int = _UNSET,
        obs=_UNSET,
        cache_dir=_UNSET,
        max_cached_executables: Optional[int] = _UNSET,
        clock: Callable[[], float] = time.monotonic,
    ):
        # compatibility shim: this 13-kwarg signature predates
        # serving.spec.ServerSpec.  Each spec-covered kwarg defaults to a
        # sentinel so explicitly-passed kwargs are countable; passing
        # SPEC_SHIM_THRESHOLD or more of them outside the spec layer is a
        # spec-shaped construction and earns a DeprecationWarning pointing
        # at PCAServer.from_spec.
        explicit = sum(
            v is not _UNSET
            for v in (policy, max_batch, max_delay_s, pad_batches,
                      backend_router, executor, max_inflight, obs,
                      cache_dir, max_cached_executables))
        if explicit >= SPEC_SHIM_THRESHOLD and not _spec_depth:
            warnings.warn(
                f"PCAServer(...) with {explicit} construction kwargs is "
                "deprecated: build a serving.spec.ServerSpec and call "
                "PCAServer.from_spec(spec) (or spec.build_server(spec))",
                DeprecationWarning, stacklevel=2)
        policy = None if policy is _UNSET else policy
        max_batch = None if max_batch is _UNSET else max_batch
        max_delay_s = 0.01 if max_delay_s is _UNSET else max_delay_s
        pad_batches = True if pad_batches is _UNSET else pad_batches
        backend_router = (None if backend_router is _UNSET
                          else backend_router)
        executor = None if executor is _UNSET else executor
        max_inflight = 1 if max_inflight is _UNSET else max_inflight
        obs = None if obs is _UNSET else obs
        cache_dir = None if cache_dir is _UNSET else cache_dir
        max_cached_executables = (DEFAULT_MAX_ENTRIES
                                  if max_cached_executables is _UNSET
                                  else max_cached_executables)
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.config = config
        self.policy = policy or BucketPolicy(T=config.T)
        self.max_batch = max_batch or config.S
        self.max_delay_s = max_delay_s
        self.pad_batches = pad_batches
        self.backend_router = backend_router
        self.executor = executor or LocalExecutor()
        self.max_inflight = max_inflight
        self.obs = obs
        self.clock = clock
        self.stats = ServingStats(clock=clock)
        self._queues: Dict[Tuple, List[_Pending]] = {}
        self._inflight = InFlightQueue()
        self._cache = ExecutableCache(max_entries=max_cached_executables,
                                      cache_dir=cache_dir)
        self._rid = itertools.count()
        self._lock = threading.RLock()  # see _serialized
        self._seq = itertools.count()
        self._exec_label = self.executor.describe()
        # optional serving.controller.ServingController; poll() ticks it
        # so the re-profile/search/swap loop rides the engine's own clock
        self.controller = None
        # declarative construction record when built via from_spec/
        # build_server (None for direct kwarg construction)
        self.spec = None
        if obs is not None:
            self._wire_obs()

    @classmethod
    def from_spec(cls, spec, clock: Optional[Callable[[], float]] = None,
                  frontend=None, device=None) -> "PCAServer":
        """Build a server (plus obs bundle and controller, when the spec
        asks for them) from a declarative ``serving.spec.ServerSpec`` --
        the blessed construction path the 13-kwarg ``__init__`` shims.
        ``clock`` injects a shared clock (tests pass a ``VirtualClock``);
        ``frontend`` wires the controller's admission feedback; ``device``
        places the executor (default ``cuda``, raising without a card)."""
        from .spec import build_server
        return build_server(spec, clock=clock, frontend=frontend,
                            device=device)

    def _wire_obs(self) -> None:
        """Create the engine's metric families once (per-call recording is
        then a dict lookup) and hand the executor the bundle so launches
        are traced where they happen."""
        m = self.obs.metrics
        self._m_submitted = m.counter(
            "serve_requests_total", "Requests accepted by submit().",
            ("op",))
        self._m_flushes = m.counter(
            "serve_flushes_total", "Microbatch flushes dispatched.",
            ("op", "bucket", "backend", "executor", "cache"))
        self._m_latency = m.histogram(
            "serve_request_latency_seconds",
            "Submit-to-fulfil latency per request.",
            ("op", "bucket", "backend", "executor"))
        self._m_queue = m.histogram(
            "serve_queue_seconds",
            "Submit-to-dispatch wait per request.",
            ("op", "bucket", "backend", "executor"))
        self._m_wait = m.histogram(
            "serve_flush_wait_seconds",
            "Blocked-on-device time per retired flush.",
            ("op", "bucket", "backend", "executor"))
        self._m_batch = m.histogram(
            "serve_flush_batch_size", "Live requests per flush.",
            ("op", "bucket"), buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self._m_depth = m.gauge(
            "serve_inflight_depth",
            "In-flight flushes after a dispatch.").labels()
        self._m_queued = m.gauge(
            "serve_queued_requests",
            "Requests queued, not yet dispatched.").labels()
        self._m_swaps = m.counter(
            "serve_plan_swaps_total", "apply_plan hot-swaps.").labels()
        self._m_exec_cached = m.gauge(
            "serve_executables_cached",
            "Executables held in the in-memory cache tier.").labels()
        self._m_disk = m.counter(
            "serve_cache_disk_total",
            "Persistent executable-tier lookups by outcome.", ("event",))
        self._m_warm = m.counter(
            "serve_warmup_executables_total",
            "Executables pre-built by warmup(), by cache source.",
            ("source",))
        if getattr(self.executor, "obs", None) is None:
            self.executor.obs = self.obs

    # -- request path -------------------------------------------------------
    @_serialized
    def submit(self, matrix, op: str = "eigh",
               max_delay_s: Optional[float] = None,
               sweeps: Optional[int] = None) -> Ticket:
        """Queue one request.  ``sweeps`` overrides the config's Jacobi
        sweep count for this request only -- the admission-control degrade
        path (``serving.frontend``) trades accuracy for latency by
        submitting with fewer sweeps.  Requests with different sweep
        counts batch separately (they need different executables, keyed by
        their relaxed ``SolverKey``)."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        matrix = np.asarray(matrix, np.float32)
        if matrix.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {matrix.shape}")
        if op == "eigh" and matrix.shape[0] != matrix.shape[1]:
            raise ValueError(f"eigh needs a square matrix, got {matrix.shape}")
        sweeps = self.config.sweeps if sweeps is None else int(sweeps)
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        now = self.clock()
        bucket = self.policy.bucket_shape(matrix.shape)
        rid = next(self._rid)
        ticket = Ticket(rid, op, matrix.shape, bucket, sweeps)
        ticket._server = self
        delay = self.max_delay_s if max_delay_s is None else max_delay_s
        if self.obs is not None:
            self._m_submitted.labels(op=op).inc(now=now)
        self._enqueue((op, bucket, sweeps),
                      _Pending(rid, matrix, ticket, now, now + delay), now)
        return ticket

    def _enqueue(self, key: Tuple, entry: "_Pending", now: float) -> None:
        """Queue one request and flush its bucket when it reaches the cap
        (shared by ``submit`` and ``apply_plan``'s re-queue)."""
        queue = self._queues.setdefault(key, [])
        queue.append(entry)
        self.stats.record_queue_depth(len(queue), now)
        if self.obs is not None:
            self._m_queued.set(self.pending(), now=now)
        if len(queue) >= self.max_batch:
            self._dispatch_key(key)

    @_serialized
    def poll(self, now: Optional[float] = None) -> int:
        """Retire every completed in-flight flush, then dispatch every
        queue whose oldest deadline has passed; returns the number of
        requests *retired* (with ``max_inflight=1`` a dispatched queue
        retires synchronously, so this is also the number flushed).

        Queues are visited in sorted (op, bucket) order, so dispatch --
        and therefore retirement and telemetry -- order is reproducible
        under the injected clock no matter the submission interleaving.

        When a ``serving.controller.ServingController`` is attached, poll
        also ticks it (before dispatch, so a plan swap this tick decides
        on lands ahead of the flushes it re-buckets); the controller's
        own cadence guard makes the tick a no-op between re-profiles.
        """
        now = self.clock() if now is None else now
        if self.controller is not None:
            self.controller.maybe_tick(now)
        done = self._inflight.retire_ready()
        for key in sorted(k for k, q in self._queues.items()
                          if q and min(e.flush_by for e in q) <= now):
            done += self._dispatch_key(key)
        return done

    @_serialized
    def drain(self) -> int:
        """Dispatch everything regardless of deadlines, then retire every
        in-flight flush; returns the number of requests retired."""
        done = 0
        for key in sorted(self._queues):
            done += self._dispatch_key(key)
        return done + self._inflight.retire_to_depth(0)

    def pending(self) -> int:
        """Requests queued but not yet dispatched."""
        return sum(len(q) for q in self._queues.values())

    def inflight(self) -> int:
        """Flushes dispatched but not yet retired."""
        return self._inflight.depth

    def inflight_requests(self) -> int:
        """Requests riding the currently in-flight flushes."""
        return self._inflight.requests()

    def solve_many(self, matrices, op: str = "eigh") -> List:
        """Convenience: submit a burst, drain, return results in order."""
        tickets = [self.submit(m, op=op) for m in matrices]
        self.drain()
        return [t.result() for t in tickets]

    # -- plan hot-swap ------------------------------------------------------
    def describe_plan(self) -> Dict:
        """The serving plan currently in force, as plain JSON-able facts."""
        return {
            "mode": self.policy.mode,
            "T": self.policy.T,
            "pow2_cap": self.policy.pow2_cap,
            "max_batch": self.max_batch,
            "max_inflight": self.max_inflight,
            "executor": self.executor.describe(),
        }

    @_serialized
    def apply_plan(self, plan, warm_profile=None) -> Dict:
        """Atomically switch this server onto a new serving plan.

        ``plan`` is any object with the ``serving.autotune.ServingPlan``
        surface: ``policy()``, ``build_executor(device=)`` (called with the
        current executor's device), ``max_batch``, ``max_inflight``.  The
        swap happens *between* flushes:

          1. every in-flight flush is retired first (its tickets are
             fulfilled under the old plan -- they already rode old-plan
             slabs, so retiring them is the only exact choice);
          2. still-queued requests are re-bucketed under the new policy in
             submission order -- their tickets survive the swap untouched
             (same rid, same deadline), only their bucket assignment moves;
          3. policy / batch cap / pipeline depth / executor switch, and
             re-bucketed queues dispatch whenever they reach the new batch
             cap, mirroring ``submit``'s flush-on-full (so a merged queue
             that now holds several caps' worth flushes in cap-sized
             microbatches, not one oversized slab).

        ``config.T``/``config.S`` are realigned to the plan's tile and
        flush size (exactly what ``autotune.server_for_plan`` builds for a
        cold start), so a hot-swapped server and a cold server on the same
        plan compile identical executables -- including the matmul block
        size when ``config.backend`` routes through the MM-Engine -- and
        serve bit-identical results.  The executable cache is keyed on
        (op, bucket, batch, solver numerics, executor), none of which
        mention the policy or the scheduling facts T/S, so buckets both
        plans agree on keep their compiled executables across *any* swap
        that preserves bucketing and flush size.  Executables the new plan
        *does* need fresh are pre-warmed before the swap (from the queued
        requests' shapes, plus ``warm_profile`` when given), so the first
        post-swap flush dispatches warm.
        Returns the switch record also appended to
        ``stats.plan_switches``.
        """
        if plan.max_inflight < 1:
            raise ValueError(
                f"plan.max_inflight must be >= 1, got {plan.max_inflight}")
        if plan.max_batch < 1:
            raise ValueError(
                f"plan.max_batch must be >= 1, got {plan.max_batch}")
        # materialize the plan's policy and executor *before* touching any
        # server state: a plan that fails here (bad pow2_cap, a mesh spec
        # the port lacks) must leave the server -- and every queued ticket
        # -- intact
        t_swap = self.clock()
        new_policy = plan.policy()
        # the new executor runs where the current one does: a swap never
        # moves a server between devices
        new_executor = plan.build_executor(device=self.executor.device)
        old_plan = self.describe_plan()
        # pre-warm the incoming plan's solvers while the old plan is still
        # serving: every shape we know about (queued requests, plus the
        # traffic profile when given) is looked up or built under the new
        # plan's facts, before any ticket is re-bucketed onto them
        new_config = dataclasses.replace(self.config, T=new_policy.T,
                                         S=plan.max_batch)
        plan_backend = getattr(plan, "backend", "keep")
        if plan_backend != "keep":
            new_config = dataclasses.replace(new_config,
                                             backend=plan_backend)
        warm_shapes = sorted({(e.ticket.op, e.matrix.shape)
                              for q in self._queues.values() for e in q})
        if warm_profile is not None:
            warm_shapes += self._profile_shapes(warm_profile)
        prewarmed = {"memory": 0, "disk": 0, "compile": 0}
        for op, bucket, batch, backend in self._enumerate_keys(
                warm_shapes, new_policy, new_executor, new_config,
                plan.max_batch):
            _, source = self._executable_for(op, bucket, batch, backend,
                                             new_config, new_executor)
            prewarmed[source] += 1
        self._inflight.retire_to_depth(0)
        queued = sorted((e for q in self._queues.values() for e in q),
                        key=lambda e: e.rid)
        self._queues = {}
        self.policy = new_policy
        self.max_batch = plan.max_batch
        self.max_inflight = plan.max_inflight
        self.executor = new_executor
        self.config = new_config
        self._exec_label = self.executor.describe()
        switch = {"from": old_plan, "to": self.describe_plan(),
                  "requeued": len(queued), "prewarmed": prewarmed}
        now = self.clock()
        self.stats.record_plan_switch(switch, now=now)
        if self.obs is not None:
            if getattr(self.executor, "obs", None) is None:
                self.executor.obs = self.obs
            self._m_swaps.inc(now=now)
            self.obs.tracer.complete(
                "plan_swap", ts=t_swap, end=now, cat="control",
                track="control", requeued=len(queued),
                executor=self._exec_label, max_batch=self.max_batch,
                max_inflight=self.max_inflight, T=self.policy.T)
        for e in queued:
            bucket = self.policy.bucket_shape(e.matrix.shape)
            e.ticket.bucket = bucket
            self._enqueue((e.ticket.op, bucket, e.ticket.sweeps), e, now)
        return switch

    # -- dispatch stage -----------------------------------------------------
    def _dispatch_key(self, key: Tuple) -> int:
        """Stack, pad, compile, launch one bucket queue -- non-blocking.

        The flush joins the in-flight queue; back-pressure then retires
        whatever already completed (free) and, if the pipeline is over
        ``max_inflight``, blocks on the oldest flush until the cap holds.
        With ``max_inflight=1`` the just-dispatched flush itself retires
        here -- exactly the old synchronous flush.  Returns the number of
        requests retired while enforcing the cap.
        """
        op, bucket, sweeps = key
        queue = self._queues.pop(key, [])
        if not queue:
            return 0
        t_dispatch = self.clock()
        batch, n_active = stack_requests([e.matrix for e in queue], bucket)
        b = len(queue)
        bp = max(self.max_batch if self.pad_batches else b, b)
        # the executor may demand a larger batch (a mesh pads up to the
        # next data-axis multiple so every shard gets an identical slab)
        bp = self.executor.round_batch(bp)
        if bp > b:  # inert filler: zero matrices with zero live coordinates
            batch = np.concatenate(
                [batch, np.zeros((bp - b, *bucket), batch.dtype)])
            n_active = np.concatenate(
                [n_active, np.zeros((n_active.shape[0], bp - b), np.int32)],
                axis=1)
        backend = self.backend_for(op, bucket)
        obs = self.obs
        if obs is not None:
            # reserve the flush span's id now so the compile/launch spans
            # recorded below can name it as their parent; the span itself
            # is recorded at retire time, when its end is known
            flush_span = obs.tracer.new_id()
            t0 = self.clock()
            fn, source = self._executable(op, bucket, bp, backend, sweeps)
            if source != "memory":
                # the solver *build* (a closure over the config, or with a
                # disk tier the key's graph captured: "compile"), or a
                # graph captured again from its record ("aot_load")
                obs.tracer.complete(
                    "compile" if source == "compile" else "aot_load",
                    ts=t0, end=self.clock(), cat="compile",
                    track="flushes", parent=flush_span, op=op,
                    bucket=list(bucket), batch=bp, backend=str(backend))
        else:
            fn, source = self._executable(op, bucket, bp, backend, sweeps)
        hit = source != "compile"
        flush = self.executor.submit(fn, batch, n_active)
        flush.seq = next(self._seq)
        flush.key = key
        flush.entries = tuple(queue)
        flush.t_dispatch = t_dispatch
        flush.t_launched = self.clock()
        flush.backend = backend
        flush.batch_size = b
        flush.padded_batch = bp
        flush.cache_hit = hit
        flush._retire_cb = self._retire
        self._inflight.push(flush)
        flush.inflight_depth = self._inflight.depth
        for e in queue:
            e.ticket._flush = flush
        self.stats.record_dispatch(self._inflight.depth, t_dispatch)
        if obs is not None:
            flush.span_id = flush_span
            self._m_flushes.labels(
                op, bucket, backend, self._exec_label,
                "hit" if hit else "miss").inc(now=t_dispatch)
            self._m_batch.labels(op, bucket).observe(b, now=t_dispatch)
            self._m_depth.set(self._inflight.depth, now=t_dispatch)
            self._m_queued.set(self.pending(), now=t_dispatch)
        # back-pressure: block on the oldest flush until the cap holds.
        # Deliberately *not* an opportunistic ready-sweep -- retirement
        # points stay deterministic (cap, poll, drain, ticket) no matter
        # how fast the device happens to be, which is what keeps the
        # injected-clock test story exact.
        return self._inflight.retire_to_depth(self.max_inflight - 1)

    # -- retire stage -------------------------------------------------------
    def _retire(self, flush: InFlightFlush) -> int:
        """Force one flush's device batch home and fulfil its tickets.

        Idempotent (a ticket may race poll/drain to the same flush).  The
        gap between ``t_dispatch`` and the moment we block here is host
        work that overlapped device execution -- the quantity the pipeline
        exists to maximize; ``stats`` accounts it per flush.
        """
        if flush.retired:
            return 0
        op, bucket, sweeps = flush.key
        t_wait = self.clock()
        out = flush.result()
        t_retire = self.clock()
        flush.retired = True
        self._inflight.remove(flush)
        self.stats.record_flush(
            flush.cache_hit, t_dispatch=flush.t_dispatch,
            t_launched=flush.t_launched, t_wait=t_wait, t_retire=t_retire,
            batch_size=flush.batch_size,
            inflight_depth=flush.inflight_depth,
            op=op, bucket=bucket, padded_batch=flush.padded_batch)
        records = []
        for i, e in enumerate(flush.entries):
            rec = RequestRecord(
                rid=e.rid, op=op, shape=e.matrix.shape, bucket=bucket,
                batch_size=flush.batch_size, cache_hit=flush.cache_hit,
                t_submit=e.t_submit, t_done=t_retire,
                queue_s=flush.t_dispatch - e.t_submit,
                padding_waste=padding_waste(e.matrix.shape, bucket),
                backend=flush.backend, n_shards=flush.n_shards,
                t_dispatch=flush.t_dispatch,
                inflight_depth=flush.inflight_depth,
                deadline=e.flush_by, sweeps=sweeps)
            e.ticket._fulfil(self._unpack(op, out, i, e.matrix.shape), rec)
            self.stats.record_request(rec)
            records.append(rec)
        if self.obs is not None:
            self._record_obs(flush, records, t_wait, t_retire)
        return len(flush.entries)

    def _record_obs(self, flush: InFlightFlush, records: List[RequestRecord],
                    t_wait: float, t_retire: float) -> None:
        """Emit the retired flush's spans and metrics (obs attached only).

        One flush span (dispatch -> retire-complete) with dispatch /
        inflight / wait / retire children, then one request span per
        fulfilled ticket, parented to the flush span -- the link that ties
        a request's latency to the microbatch that actually served it.
        """
        obs = self.obs
        tr = obs.tracer
        op, bucket, _sweeps = flush.key
        backend, exec_label = flush.backend, self._exec_label
        t_end = self.clock()
        fid = flush.span_id if flush.span_id is not None else tr.new_id()
        bucket_l = list(bucket)
        tr.complete(
            f"flush:{op}", ts=flush.t_dispatch, end=t_end, cat="flush",
            track="flushes", id=fid, op=op, bucket=bucket_l,
            batch=flush.batch_size, padded_batch=flush.padded_batch,
            backend=str(backend), executor=exec_label,
            cache_hit=flush.cache_hit, n_shards=flush.n_shards,
            inflight_depth=flush.inflight_depth, seq=flush.seq)
        tr.complete("dispatch", ts=flush.t_dispatch, end=flush.t_launched,
                    cat="flush", track="flushes", parent=fid,
                    cache_hit=flush.cache_hit)
        tr.complete("inflight", ts=flush.t_launched, end=t_wait,
                    cat="flush", track="flushes", parent=fid)
        tr.complete("wait", ts=t_wait, end=t_retire, cat="flush",
                    track="flushes", parent=fid)
        tr.complete("retire", ts=t_retire, end=t_end, cat="flush",
                    track="flushes", parent=fid,
                    requests=len(records))
        labels = (op, bucket, backend, exec_label)
        self._m_wait.labels(*labels).observe(t_retire - t_wait, now=t_retire)
        lat = self._m_latency.labels(*labels)
        qwait = self._m_queue.labels(*labels)
        slo = obs.slo
        for rec in records:
            tr.complete(
                f"request:{op}", ts=rec.t_submit, end=t_end, cat="request",
                track="requests", parent=fid, rid=rec.rid, op=op,
                bucket=bucket_l, shape=list(rec.shape),
                backend=str(backend))
            lat.observe(t_end - rec.t_submit, now=t_end)
            qwait.observe(rec.queue_s, now=t_end)
            if slo is not None:
                slo.observe(op=op, latency_s=t_end - rec.t_submit,
                            t_done=t_end, t_submit=rec.t_submit,
                            deadline=rec.deadline)

    def _queue_depth(self, op: str, bucket: Tuple[int, ...],
                     sweeps: int) -> int:
        return len(self._queues.get((op, bucket, sweeps), ()))

    def backend_for(self, op: str, bucket: Tuple[int, ...]) -> Optional[str]:
        """The kernel backend this (op, bucket) routes to."""
        if self.backend_router is not None:
            return self.backend_router(op, bucket)
        return self.config.backend

    def _executable(self, op: str, bucket: Tuple[int, ...], batch: int,
                    backend: Optional[str],
                    sweeps: Optional[int] = None) -> Tuple[Callable, str]:
        return self._executable_for(op, bucket, batch, backend,
                                    self.config, self.executor,
                                    sweeps=sweeps)

    def _executable_for(self, op: str, bucket: Tuple[int, ...], batch: int,
                        backend: Optional[str], config: PCAConfig,
                        executor: LocalExecutor,
                        sweeps: Optional[int] = None) -> Tuple[Callable, str]:
        """Solver lookup under explicit plan facts.

        Returns (fn, source) with source ``"memory"`` (steady state),
        ``"disk"`` (built from its record, promoted into memory) or
        ``"compile"``.  The key is ``SolverKey``-based -- the numerics
        subset the solver actually depends on -- so configs that differ
        only in scheduling facts (T, S) share one entry.  With a disk tier
        armed, misses build ahead of time (``executor.aot_compile``: the
        result has a record to persist); without one, the executor's
        shared eager solver.  The explicit (config, executor) arguments
        let ``apply_plan`` pre-warm an *incoming* plan's solvers before
        the swap.
        """
        cfg = dataclasses.replace(
            config, backend=backend,
            sweeps=config.sweeps if sweeps is None else sweeps)
        key = (op, bucket, batch, SolverKey.from_config(cfg),
               executor.cache_token())
        fn, source = self._cache.lookup(key, executor)
        if fn is None:
            source = "compile"
            if self._cache.disk is not None:
                fn = executor.aot_compile(op, cfg, bucket, batch)
                self._cache.store(key, fn, persist=True)
            else:
                fn = executor.compile(op, cfg, bucket, batch)
                self._cache.store(key, fn)
        if self.obs is not None:
            if self._cache.disk is not None and source != "memory":
                self._m_disk.labels(
                    "hit" if source == "disk" else "miss").inc()
            self._m_exec_cached.set(len(self._cache))
        return fn, source

    # -- warmup / persistent tier -------------------------------------------
    @staticmethod
    def _profile_shapes(profile) -> List[Tuple[str, Tuple[int, ...], int]]:
        """(op, shape, count) rows of a ``TrafficProfile`` (anything with
        ``shape_counts``) or of a bare iterable of (op, shape[, n]);
        rows without a count carry weight 1."""
        rows = getattr(profile, "shape_counts", profile)
        return [(row[0], tuple(row[1]),
                 int(row[2]) if len(row) > 2 else 1) for row in rows]

    def _enumerate_keys(self, shapes, policy, executor, config,
                        max_batch) -> List[Tuple]:
        """Distinct (op, bucket, batch, backend) executables the given
        (op, shape[, count]) rows imply under the given plan facts.  The
        batch is the plan's padded flush size -- the one executable
        steady-state ``pad_batches`` traffic dispatches.

        Keys come back in descending traffic weight (sum of the counts of
        the shapes that bucket onto them), ties broken by first
        appearance: warmup compiles the executables the profile says will
        be hit most *first*, so an interrupted or still-running warmup has
        already armed the highest-traffic (i.e. SLO-critical) paths."""
        weight, order = {}, {}
        batch = executor.round_batch(max_batch)
        for row in shapes:
            op, shape = row[0], row[1]
            n = int(row[2]) if len(row) > 2 else 1
            bucket = policy.bucket_shape(tuple(shape))
            backend = (self.backend_router(op, bucket)
                       if self.backend_router is not None
                       else config.backend)
            k = (op, bucket, batch, backend)
            if k not in weight:
                weight[k] = 0
                order[k] = len(order)
            weight[k] += n
        return sorted(weight, key=lambda k: (-weight[k], order[k]))

    def warmup_keys(self, profile) -> List[Tuple]:
        """The distinct (op, bucket, batch, backend) executables
        ``profile`` implies under the plan currently in force, in
        descending traffic weight (see ``_enumerate_keys``)."""
        return self._enumerate_keys(self._profile_shapes(profile),
                                    self.policy, self.executor,
                                    self.config, self.max_batch)

    @_serialized
    def warmup(self, profile) -> Dict:
        """Pre-build every solver ``profile`` implies.

        Each key resolves through the same path a live flush uses: memory
        hit (already warm), disk hit (the graph captured again from its
        record -- the cold-start win) or compile (which, with a disk tier
        armed, also writes the record for the *next* replica).  Returns a
        summary dict; with obs attached the pass is traced as one
        ``warmup`` span with per-source counters in the metric registry.
        """
        t0 = self.clock()
        keys = self.warmup_keys(profile)
        counts = {"memory": 0, "disk": 0, "compile": 0}
        for op, bucket, batch, backend in keys:
            _, source = self._executable(op, bucket, batch, backend)
            counts[source] += 1
        now = self.clock()
        doc = {"executables": len(keys), "seconds": now - t0, **counts}
        if self.obs is not None:
            for source, n in counts.items():
                if n:
                    self._m_warm.labels(source).inc(n, now=now)
            self.obs.tracer.complete(
                "warmup", ts=t0, end=now, cat="control", track="control",
                executables=len(keys), **counts)
        return doc

    def cache_summary(self) -> Dict:
        """The solver cache's counters, JSON-able (see
        ``serving.cache.ExecutableCache.summary``)."""
        return self._cache.summary()

    @staticmethod
    def _unpack(op: str, out, i: int, shape: Tuple[int, ...]):
        if op == "eigh":
            n = shape[0]
            return ServedEigh(
                eigenvalues=np.asarray(out.eigenvalues[i, :n]),
                eigenvectors=np.asarray(out.eigenvectors[i, :n, :n]),
                off_norm=float(out.off_norm[i]))
        if op == "svd":
            m, n = shape
            return ServedSVD(
                U=np.asarray(out.U[i, :m, :n]),
                S=np.asarray(out.S[i, :n]),
                Vt=np.asarray(out.Vt[i, :n, :n]))
        d = shape[1]
        return ServedPCA(
            components=np.asarray(out.components[i, :d, :d]),
            eigenvalues=np.asarray(out.eigenvalues[i, :d]),
            mean=np.asarray(out.mean[i, :d]),
            scale=np.asarray(out.scale[i, :d]),
            evcr=np.asarray(out.evcr[i, :d]),
            cvcr=np.asarray(out.cvcr[i, :d]),
            off_norm=float(out.off_norm[i]))
