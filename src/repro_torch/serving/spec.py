"""Declarative server construction: one frozen ``ServerSpec`` replaces
the 13-kwarg ``PCAServer.__init__`` and the ``serve_pca`` flag soup (port
of ``repro.serving.spec``: the same fields, the same JSON, so a spec file
written by either package loads in the other).

The spec is the single source of truth for *what to build*; live objects
(executors, obs bundles, routers) are built from it, never stored in it,
so a spec round-trips through JSON losslessly and two servers built from
equal specs are built from identical parts:

  SchedulingSpec   bucketing + microbatching + pipeline depth -- the
                   facts a ``ServingPlan`` hot-swaps.
  ExecutionSpec    where and how flushes run: mesh, kernel backend (and
                   the threshold router's cut-over), solver numerics.
  CacheSpec        the persistent executable tier + warmup profile.
  ObsSpec          tracing/metrics/SLO outputs (obs is armed iff any
                   output is requested).
  ControllerSpec   the autonomous serving controller's cadence,
                   hysteresis and search budget.

Construction paths:

  ``ServerSpec.from_args(ns)``    every ``serve_pca`` flag resolves here
                                  (and ``validate_args`` rejects flag
                                  combinations that would silently
                                  last-write-win).
  ``ServerSpec.from_json``/``to_json``  the ``--spec server.json`` file.
  ``build_server(spec)`` / ``PCAServer.from_spec(spec)``  the live
                                  server, with obs bundle and controller
                                  attached when the spec asks.

Parity contract: a spec-built server serves the selftest burst
bitwise-identical to the kwarg-built server, because the spec layer
passes the same values to the same constructor -- there is no second
code path to drift.

The spec holds no device: ``build_server(spec, device=...)`` places the
executor (``cuda`` by default, raising on a host without a card).
``ExecutionSpec.backend`` names one of the port's backends: ``"cuda"``
(the hand-written kernels; the reference's ``"pallas"``), ``"torch"``
(their plain PyTorch versions; the reference's ``"ref"``) or ``None``
(plain torch ops -- not the kernels, even on the card).  A spec naming a
backend of the reference (``"pallas"``, ``"interpret"``, ``"ref"``) fails
``validate`` with the port's names; nothing maps it silently.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, Optional, Tuple

from .._device import DeviceLike
from ..backends.registry import BACKENDS
from ..core.pca import PCAConfig
from .batching import BucketPolicy, POLICIES

SPEC_FORMAT = 1


class SpecConflictError(ValueError):
    """Two flags (or a flag and a spec file) claim the same fact."""


def _freeze(v):
    return tuple(v) if isinstance(v, list) else v


def _check_backend(field: str, backend: Optional[str]) -> None:
    """``backend`` must be ``None`` or one of the port's backends."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"{field}={backend!r} is not a backend of repro_torch: use one "
            f"of {BACKENDS} or None (the reference's 'pallas' is 'cuda' "
            "here, its 'ref' is 'torch', and 'interpret' has no "
            "counterpart)")


@dataclasses.dataclass(frozen=True)
class SchedulingSpec:
    """Bucketing and microbatching: the hot-swappable plan facts."""
    mode: str = "tile"               # bucket policy (POLICIES)
    T: int = 16                      # bucket tile (paper T)
    pow2_cap: Optional[int] = None
    max_batch: int = 4               # requests per flush (paper S)
    max_delay_s: float = 0.01        # flush deadline per queued request
    pad_batches: bool = True
    max_inflight: int = 1            # dispatch pipeline depth

    def policy(self) -> BucketPolicy:
        return BucketPolicy(T=self.T, mode=self.mode,
                            pow2_cap=self.pow2_cap)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Where and how flushes execute."""
    mesh: str = "none"               # sharded.mesh_executor spelling
    backend: Optional[str] = None    # PCAConfig.backend (None = plain torch)
    router_min_dim: Optional[int] = None  # threshold_router cut-over
    sweeps: int = 12
    precision: str = "fp32"
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """The persistent executable tier and pre-traffic warmup."""
    cache_dir: Optional[str] = None
    max_cached_executables: Optional[int] = None  # None = engine default
    warmup_profile: Optional[str] = None          # TrafficProfile JSON path


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability outputs; the bundle is armed iff any is set."""
    slo_ms: Optional[float] = None
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    # the reference's field name, kept so spec files load in both
    # packages; in the port it names a torch.profiler trace directory
    jax_profile: Optional[str] = None

    @property
    def armed(self) -> bool:
        return any((self.slo_ms is not None, self.trace_out,
                    self.metrics_out, self.jax_profile))


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """The autonomous controller's cadence, guards and search budget."""
    enabled: bool = False
    window_s: float = 5.0            # sliding re-profile window
    reprofile_every_s: float = 1.0   # tick cadence on the engine clock
    hysteresis: float = 0.15         # min predicted gain before a swap
    min_dwell_s: float = 2.0         # anti-thrash: min time between swaps
    budget_frac: float = 0.25        # measured-replay budget vs grid size
    measure: bool = False            # False = analytic bandit (CI-cheap)
    meshes: Tuple[str, ...] = ("none",)        # executor axis of the grid
    backends: Tuple[Optional[str], ...] = ("keep",)  # backend axis

    def __post_init__(self):
        object.__setattr__(self, "meshes", _freeze(self.meshes))
        object.__setattr__(self, "backends", _freeze(self.backends))


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Everything needed to build one ``PCAServer`` (and its controller).

    Frozen and JSON-round-trippable; see the module docstring for the
    sub-spec split.  ``build_server(spec)`` is the constructor.
    """
    scheduling: SchedulingSpec = SchedulingSpec()
    execution: ExecutionSpec = ExecutionSpec()
    cache: CacheSpec = CacheSpec()
    obs: ObsSpec = ObsSpec()
    controller: ControllerSpec = ControllerSpec()

    # -- derived parts ------------------------------------------------------
    def config(self) -> PCAConfig:
        return PCAConfig(T=self.scheduling.T,
                         S=self.scheduling.max_batch,
                         sweeps=self.execution.sweeps,
                         backend=self.execution.backend,
                         precision=self.execution.precision,
                         fused=self.execution.fused)

    def validate(self) -> "ServerSpec":
        s = self.scheduling
        if s.mode not in POLICIES:
            raise ValueError(f"unknown bucket mode {s.mode!r}; "
                             f"one of {POLICIES}")
        if s.T < 1 or s.max_batch < 1 or s.max_inflight < 1:
            raise ValueError(f"T/max_batch/max_inflight must be >= 1: {s}")
        _check_backend("execution.backend", self.execution.backend)
        for backend in self.controller.backends:
            if backend != "keep":
                _check_backend("controller.backends", backend)
        c = self.controller
        if c.enabled:
            if c.window_s <= 0 or c.reprofile_every_s <= 0:
                raise ValueError(
                    f"controller window/cadence must be > 0: {c}")
            if not 0 <= c.hysteresis < 1:
                raise ValueError(
                    f"hysteresis must be in [0, 1), got {c.hysteresis}")
            if c.min_dwell_s < 0:
                raise ValueError(
                    f"min_dwell_s must be >= 0, got {c.min_dwell_s}")
        return self

    # -- JSON round trip ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"server_spec": SPEC_FORMAT,
                           **dataclasses.asdict(self)},
                          indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ServerSpec":
        doc = json.loads(text)
        doc.pop("server_spec", None)
        parts = {}
        for f in dataclasses.fields(cls):
            sub = doc.get(f.name)
            if sub is None:
                continue
            sub_cls = {"scheduling": SchedulingSpec,
                       "execution": ExecutionSpec, "cache": CacheSpec,
                       "obs": ObsSpec, "controller": ControllerSpec}[f.name]
            parts[f.name] = sub_cls(**{
                sf.name: _freeze(sub[sf.name])
                for sf in dataclasses.fields(sub_cls) if sf.name in sub})
        return cls(**parts).validate()

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ServerSpec":
        return cls.from_json(pathlib.Path(path).read_text())

    # -- CLI resolution -----------------------------------------------------
    @classmethod
    def from_args(cls, ns) -> "ServerSpec":
        """Resolve an argparse namespace (the ``serve_pca`` flag set) into
        a spec.  Every construction-relevant flag flows through here --
        the CLI has no second path to the constructor.  Missing attributes
        fall back to the spec defaults, so partially-populated namespaces
        (tests, other CLIs) resolve too."""
        g = lambda name, default: getattr(ns, name, default)
        timeout_ms = g("timeout_ms", 10.0)
        spec = cls(
            scheduling=SchedulingSpec(
                mode=g("bucket_policy", "tile"),
                T=g("tile", 16),
                max_batch=g("max_batch", 4),
                max_delay_s=float(timeout_ms) / 1e3,
                max_inflight=g("inflight", 1)),
            execution=ExecutionSpec(
                mesh=g("mesh", "none"),
                sweeps=g("sweeps", 12)),
            cache=CacheSpec(
                cache_dir=g("cache_dir", None),
                warmup_profile=g("warmup", None)),
            obs=ObsSpec(
                slo_ms=g("slo_ms", None),
                trace_out=g("trace_out", None),
                metrics_out=g("metrics_out", None),
                jax_profile=g("jax_profile", None)),
            controller=ControllerSpec(
                enabled=g("controller", "off") == "on",
                window_s=g("profile_window", 5.0),
                reprofile_every_s=g("reprofile_every", 1.0),
                hysteresis=g("hysteresis", 0.15),
                min_dwell_s=g("min_dwell", 2.0),
                meshes=("none",) if g("mesh", "none") in ("none", "local")
                else ("none", g("mesh", "none"))),
        )
        return spec.validate()


# flag dest -> "which fact it sets" for the conflict messages; these are
# exactly the serve_pca flags a --spec file owns
SPEC_COVERED_FLAGS = {
    "tile": "scheduling.T",
    "bucket_policy": "scheduling.mode",
    "max_batch": "scheduling.max_batch",
    "timeout_ms": "scheduling.max_delay_s",
    "inflight": "scheduling.max_inflight",
    "mesh": "execution.mesh",
    "sweeps": "execution.sweeps",
    "cache_dir": "cache.cache_dir",
    "warmup": "cache.warmup_profile",
    "slo_ms": "obs.slo_ms",
    "trace_out": "obs.trace_out",
    "metrics_out": "obs.metrics_out",
    "jax_profile": "obs.jax_profile",
    "controller": "controller.enabled",
    "profile_window": "controller.window_s",
    "reprofile_every": "controller.reprofile_every_s",
    "hysteresis": "controller.hysteresis",
    "min_dwell": "controller.min_dwell_s",
}


def _explicit(ns, defaults: Dict, dest: str) -> bool:
    """Did the CLI user set this flag away from its parser default?"""
    return (dest in defaults
            and getattr(ns, dest, defaults[dest]) != defaults[dest])


def validate_args(ns, defaults: Dict) -> None:
    """Reject mutually-exclusive / silently-ignored flag combinations
    with a named conflict, instead of last-write-wins.  ``defaults`` is
    the parser's own default mapping (``vars(parser.parse_args([]))``),
    so "explicitly set" means "differs from the parser default"."""
    def conflict(msg):
        raise SpecConflictError(f"flag conflict: {msg}")

    spec_file = getattr(ns, "spec", None)
    if spec_file:
        clash = sorted(dest for dest in SPEC_COVERED_FLAGS
                       if _explicit(ns, defaults, dest))
        if clash:
            flags = ", ".join("--" + d.replace("_", "-") for d in clash)
            facts = ", ".join(SPEC_COVERED_FLAGS[d] for d in clash)
            conflict(f"{flags} conflicts with --spec {spec_file}: the "
                     f"spec file owns {facts}; edit the spec instead")
    controller_on = getattr(ns, "controller", "off") == "on"
    if controller_on and getattr(ns, "autotune", "off") != "off":
        conflict(f"--autotune {ns.autotune} conflicts with --controller "
                 "on: the controller owns plan search (it re-tunes every "
                 "re-profile window); drop one of the two")
    if not controller_on and not spec_file:
        for dest in ("reprofile_every", "hysteresis", "min_dwell",
                     "profile_window"):
            if _explicit(ns, defaults, dest):
                conflict(f"--{dest.replace('_', '-')} is ignored without "
                         "--controller on")
    if getattr(ns, "arrivals", None):
        for dest, why in (("autotune", "open-loop runs tune via the "
                           "controller (--controller on), not --autotune"),
                          ("profile_in", "open-loop runs profile their "
                           "own arrival stream"),
                          ("warmup", "open-loop runs warm every bucket "
                           "of the arrival stream themselves")):
            if _explicit(ns, defaults, dest):
                conflict(f"--{dest.replace('_', '-')} is ignored under "
                         f"--arrivals: {why}")
    if (_explicit(ns, defaults, "degrade_frac")
            and getattr(ns, "admission", "shed") != "degrade"):
        conflict("--degrade-frac only applies with --admission degrade")
    if (_explicit(ns, defaults, "measure_top_k")
            and getattr(ns, "autotune", "off") != "measured"):
        conflict("--measure-top-k only applies with --autotune measured")


def resolve_spec(ns, defaults: Optional[Dict] = None) -> "ServerSpec":
    """The CLI entry point: validate the flag set, then resolve it into a
    spec -- from the ``--spec`` file when given, else from the flags."""
    validate_args(ns, defaults or {})
    spec_file = getattr(ns, "spec", None)
    if spec_file:
        return ServerSpec.load(spec_file)
    return ServerSpec.from_args(ns)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def build_server(spec: ServerSpec, clock=None, frontend=None,
                 device: DeviceLike = None):
    """The live ``PCAServer`` a spec describes (obs bundle and controller
    included).  ``clock=None`` uses wall time; tests inject a
    ``VirtualClock``.  ``frontend`` (a ``TrafficFrontend``) wires the
    controller's admission feedback.  ``device`` places the executor
    (default ``cuda``, raising on a host without a card)."""
    from . import engine
    from .sharded import mesh_executor
    spec.validate()
    clock = clock or time.monotonic
    obs = None
    if spec.obs.armed:
        from ..obs import Observability
        obs = Observability.enabled(slo_ms=spec.obs.slo_ms, clock=clock)
    router = None
    if spec.execution.router_min_dim is not None:
        router = engine.threshold_router(spec.execution.router_min_dim)
    kw = {}
    if spec.cache.max_cached_executables is not None:
        kw["max_cached_executables"] = spec.cache.max_cached_executables
    with engine.spec_construction():
        srv = engine.PCAServer(
            spec.config(),
            policy=spec.scheduling.policy(),
            max_batch=spec.scheduling.max_batch,
            max_delay_s=spec.scheduling.max_delay_s,
            pad_batches=spec.scheduling.pad_batches,
            backend_router=router,
            executor=mesh_executor(spec.execution.mesh, device=device),
            max_inflight=spec.scheduling.max_inflight,
            obs=obs,
            cache_dir=spec.cache.cache_dir,
            clock=clock,
            **kw)
    srv.spec = spec
    if spec.controller.enabled:
        from .controller import ServingController
        srv.controller = ServingController.from_spec(
            srv, spec.controller, frontend=frontend)
    return srv
