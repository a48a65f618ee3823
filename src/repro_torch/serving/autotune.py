"""Traffic-driven serving-plan autotuning: pick (policy, T, pow2 cap,
max_batch, max_inflight, executor) from observed traffic (port of
``repro.serving.autotune``; the plans, the profile, the cost model and the
searches are the reference's, so both packages choose the same plans).

MANOJAVAM's two-tier cache and mode-aware memory policies adapt the fabric
to the access patterns of covariance vs rotation work; the software MPU
adapts the same way, but to *traffic*: the right bucket policy, tile size,
flush size and pipeline depth depend on the shape mix and arrival pattern
the server actually sees, not on a hand-picked tuple.  This module turns
the engine's telemetry (``ServingStats.flush_records`` +
``inflight_depths``) into the classic autotuned-search loop (TVM/Ansor
style, applied to the Jacobi/matmul serving fabric):

  profile    ``TrafficProfile.from_stats`` condenses live telemetry into a
             JSON-round-trippable artifact: per-(op, shape) histograms,
             arrival rate, padding-waste and host/device-overlap
             aggregates, and the calibration signals (dispatch cost split
             by cache hit/miss, device seconds per unit bucket-work).
             Capture once in production, replay forever in CI.
  search     ``autotune`` scores every ``ServingPlan`` in a small discrete
             grid with an analytical ``CostModel`` (bucket area x flush
             count, recompile amortization charged per executable the plan
             needs, pipeline occupancy derived from the plan's depth and
             the profile's measured ``overlap_frac``), optionally
             refining the analytic top-K by *measuring*: ``replay``
             regenerates the profile's traffic deterministically and
             times it against a live ``PCAServer`` built from the plan.
  apply      ``PCAServer.apply_plan`` hot-swaps the winner between
             flushes: in-flight work retires first, queued tickets are
             re-bucketed in place, and the switch lands in
             ``stats.plan_switches``.

The cost model is deliberately simple -- every term is a quantity the
telemetry already measures -- because its job is *ranking* a few dozen
plans, not predicting wall time: the measured refinement exists precisely
so close calls are settled by the hardware.  ``CostModel``'s defaults are
model constants, not measurements of any device; ``CostModel.calibrated``
replaces them from a profile's telemetry.

The entry points that build executors (``ServingPlan.build_executor``,
``server_for_plan``, ``replay``, ``autotune`` and ``bandit_search`` when
they measure) take ``device=``: ``cuda`` by default, raising on a host
without a card; the tests pass ``device="cpu"``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.pca import PCAConfig
from .._device import DeviceLike
from .batching import BucketPolicy, POLICIES
from .sharded import LocalExecutor, mesh_executor
from .stats import ServingStats

TRACE_KINDS = ("uniform", "bimodal", "heavy")


def solve_work(op: str, bucket: Sequence[int]) -> float:
    """Bucket-work units of one problem: the O(.) the Jacobi datapath does.

    eigh on an (n, n) bucket is n^3-ish (sweeps x rotations x row/col
    updates); svd/pca on (m, n) add the m n^2 Gram/standardize streaming
    pass in front of the n^3 eigensolve.  Constant factors cancel in
    ranking; the calibrated ``CostModel.device_work_per_s`` absorbs them
    when real flush telemetry is available.
    """
    if len(bucket) == 1 or op == "eigh":
        n = float(bucket[-1])
        return n * n * n
    m, n = float(bucket[0]), float(bucket[-1])
    return m * n * n + n * n * n


def _parse_bucket(label: str) -> Optional[Tuple[int, ...]]:
    """Invert ``repro_torch.obs.metrics.fmt_label`` for bucket labels:
    ``"24x16" -> (24, 16)``.  Non-shape labels return None."""
    try:
        dims = tuple(int(d) for d in str(label).split("x"))
    except ValueError:
        return None
    return dims if dims and all(d > 0 for d in dims) else None


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One point of the serving-policy space ``PCAServer`` can run under.

    ``mesh`` is the executor choice in ``sharded.mesh_executor`` spelling:
    ``"none"`` (single device), ``"auto"`` (every visible device) or an
    integer-string N.  ``backend`` is the kernel-backend axis: the
    sentinel ``"keep"`` (default) leaves the server's ``config.backend``
    untouched -- every pre-existing plan JSON round-trips to it -- while
    any other value (a registry backend name, or ``None`` for plain torch)
    overrides the config when the plan is applied or a server is built
    for it.  The default instance is exactly the ``launch.serve_pca``
    CLI's defaults -- the hand-picked tuple the autotuner exists to beat.
    """
    mode: str = "tile"
    T: int = 16
    pow2_cap: Optional[int] = None
    max_batch: int = 4
    max_inflight: int = 1
    mesh: str = "none"
    backend: Optional[str] = "keep"

    def policy(self) -> BucketPolicy:
        return BucketPolicy(T=self.T, mode=self.mode,
                            pow2_cap=self.pow2_cap)

    def build_executor(self, device: DeviceLike = None) -> LocalExecutor:
        """The plan's executor on ``device`` (default ``cuda``)."""
        return mesh_executor(self.mesh, device=device)

    def n_shards(self) -> int:
        """Data-axis shards the plan's executor would spread a flush over
        (without instantiating a mesh -- cost scoring must stay cheap):
        the visible CUDA devices, or 1 on a host without a card."""
        if self.mesh in (None, "none", "local"):
            return 1
        visible = (torch.cuda.device_count() if torch.cuda.is_available()
                   else 1)
        n = (visible if self.mesh == "auto"
             else min(int(self.mesh), visible))
        return max(n, 1)

    def describe(self) -> str:
        cap = f"<=cap{self.pow2_cap}" if self.pow2_cap else ""
        be = "" if self.backend == "keep" else f" backend={self.backend}"
        return (f"{self.mode}{cap}(T={self.T}) S={self.max_batch} "
                f"inflight={self.max_inflight} mesh={self.mesh}{be}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: Dict) -> "ServingPlan":
        return cls(**{f.name: doc[f.name]
                      for f in dataclasses.fields(cls) if f.name in doc})


def plan_grid(modes: Sequence[str] = POLICIES,
              tiles: Sequence[int] = (8, 16, 32),
              pow2_caps: Sequence[Optional[int]] = (None,),
              batches: Sequence[int] = (4, 8, 16, 32),
              inflights: Sequence[int] = (1, 2, 4),
              meshes: Sequence[str] = ("none",),
              backends: Sequence[Optional[str]] = ("keep",)
              ) -> List[ServingPlan]:
    """The small discrete search grid (exhaustive scoring is cheap).

    pow2 caps that are not a multiple of a tile size are skipped for that
    tile rather than raising, so one cap list can serve mixed tile lists.
    ``meshes`` and ``backends`` default to single-element axes (the
    grid stays scheduling-only unless a caller -- the serving controller
    -- grows them); the analytic cost model cannot separate backends, so
    a widened backend axis only pays off under measured bandit rungs.
    """
    plans = []
    for mode in modes:
        caps = pow2_caps if mode == "pow2" else (None,)
        for T in tiles:
            for cap in caps:
                if cap is not None and (cap < T or cap % T):
                    continue
                for S in batches:
                    for depth in inflights:
                        for mesh in meshes:
                            for backend in backends:
                                plans.append(ServingPlan(
                                    mode=mode, T=T, pow2_cap=cap,
                                    max_batch=S, max_inflight=depth,
                                    mesh=mesh, backend=backend))
    return plans


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """What the server observed, condensed for scoring and replay.

    ``shape_counts`` is the per-op shape histogram -- the replayable part.
    The aggregates are the cost-model calibration signals; all of them are
    exact zeros (never NaN) when the capture window saw no traffic, so a
    profile of an idle server is well-defined (see
    ``ServingStats.summary``'s same contract).
    """
    shape_counts: Tuple[Tuple[str, Tuple[int, ...], int], ...]
    requests: int = 0
    duration_s: float = 0.0
    arrival_rate: float = 0.0        # requests/s over the capture span
    mean_padding_waste: float = 0.0  # under the *captured* plan's buckets
    flushes: int = 0
    mean_flush_batch: float = 0.0    # live requests per flush
    mean_dispatch_hit_s: float = 0.0   # host cost/flush, executable cached
    mean_dispatch_miss_s: float = 0.0  # host cost/flush incl. compilation
    host_s: float = 0.0              # total dispatch-stage host seconds
    device_s: float = 0.0            # total launch-to-retire seconds
    work_dispatched: float = 0.0     # padded problems x solve_work, summed
    overlap_frac: float = 0.0        # measured host/device overlap
    captured: Tuple[Tuple[str, object], ...] = ()  # plan it ran under

    @classmethod
    def from_stats(cls, stats: ServingStats,
                   captured: Optional[Dict] = None) -> "TrafficProfile":
        recs = list(stats.records)
        counts = collections.Counter(
            (r.op, tuple(int(d) for d in r.shape)) for r in recs)
        shape_counts = tuple(sorted(
            (op, shape, n) for (op, shape), n in counts.items()))
        span = (max(r.t_done for r in recs) - min(r.t_submit for r in recs)
                if recs else 0.0)
        fr = list(stats.flush_records)
        hit = [f.dispatch_s for f in fr if f.cache_hit]
        miss = [f.dispatch_s for f in fr if not f.cache_hit]
        overlap_s = float(sum(f.overlap_s for f in fr))
        inflight_s = overlap_s + float(sum(f.wait_s for f in fr))
        return cls(
            shape_counts=shape_counts,
            requests=len(recs),
            duration_s=float(span),
            arrival_rate=len(recs) / span if span > 0 else 0.0,
            mean_padding_waste=(float(np.mean(
                [r.padding_waste for r in recs])) if recs else 0.0),
            flushes=len(fr),
            mean_flush_batch=(float(np.mean([f.batch_size for f in fr]))
                              if fr else 0.0),
            mean_dispatch_hit_s=float(np.mean(hit)) if hit else 0.0,
            mean_dispatch_miss_s=float(np.mean(miss)) if miss else 0.0,
            host_s=float(sum(f.dispatch_s for f in fr)),
            device_s=inflight_s,
            work_dispatched=float(sum(
                f.padded_batch * solve_work(f.op, f.bucket)
                for f in fr if f.bucket)),
            overlap_frac=(overlap_s / inflight_s if inflight_s > 0 else 0.0),
            captured=tuple(sorted((captured or {}).items())),
        )

    @classmethod
    def from_registry(cls, registry, window_s: float,
                      now: Optional[float] = None,
                      carry: Optional["TrafficProfile"] = None,
                      decay: float = 0.5,
                      captured: Optional[Dict] = None) -> "TrafficProfile":
        """A sliding-window profile from live
        ``repro_torch.obs.MetricRegistry`` telemetry (the controller's
        re-profiling substrate).

        Reads the per-request ``serve_request_latency_seconds`` events of
        the trailing ``window_s`` via ``registry.series_events`` -- one
        event per fulfilled request, labeled (op, bucket) -- so the shape
        histogram is bucket-granular (the registry does not retain
        pre-bucketing shapes; ``from_stats`` does, and the controller
        prefers it when the server's ``ServingStats`` is reachable).

        Carry-forward: a windowed snapshot drops every op that saw zero
        events in the window, and a profile that went empty would make a
        controller swap to a degenerate plan tuned for nothing.  When
        ``carry`` (the previous window's profile) is given, ops absent
        from this window inherit their last non-empty histogram at
        ``decay`` weight; because the controller hands each emitted
        profile back as the next tick's ``carry``, a quiet op fades out
        geometrically (counts round to zero after ~log2(n) quiet windows)
        instead of vanishing the instant its traffic pauses.
        """
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        now = registry.clock() if now is None else now
        counts: Dict[Tuple[str, Tuple[int, ...]], int] = \
            collections.Counter()
        for labels, events in registry.series_events(
                "serve_request_latency_seconds", window_s, now):
            if not events:
                continue
            bucket = _parse_bucket(labels.get("bucket", ""))
            if bucket is None:
                continue
            counts[(labels.get("op", "eigh"), bucket)] += len(events)
        fresh_ops = {op for op, _ in counts}
        if carry is not None and decay > 0:
            for op, shape, n in carry.shape_counts:
                if op in fresh_ops:
                    continue
                kept = int(round(n * decay))
                if kept > 0:
                    counts[(op, tuple(int(d) for d in shape))] += kept
        shape_counts = tuple(sorted(
            (op, shape, n) for (op, shape), n in counts.items()))
        requests = sum(n for _, _, n in shape_counts)
        batch_events = [v for labels, events in registry.series_events(
            "serve_flush_batch_size", window_s, now) for _, v in events]
        return cls(
            shape_counts=shape_counts,
            requests=requests,
            duration_s=float(window_s),
            arrival_rate=requests / window_s,
            flushes=len(batch_events),
            mean_flush_batch=(float(np.mean(batch_events))
                              if batch_events else 0.0),
            captured=tuple(sorted((captured or {}).items())),
        )

    @classmethod
    def from_shapes(cls, shape_counts, **aggregates) -> "TrafficProfile":
        """A profile straight from an (op, shape, count) histogram -- for
        banners, tests and hand-written what-if scenarios."""
        norm = tuple(sorted((op, tuple(int(d) for d in shape), int(n))
                            for op, shape, n in shape_counts))
        return cls(shape_counts=norm,
                   requests=sum(n for _, _, n in norm), **aggregates)

    @property
    def captured_plan(self) -> Dict:
        return dict(self.captured)

    def warmup_shapes(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        """The distinct (op, shape) pairs this profile implies -- what
        ``PCAServer.warmup``/``warmup_keys`` expands into concrete
        (op, bucket, batch, backend) executables under a live plan, and
        what ``serve_pca --warmup profile.json`` pre-builds before the
        first request lands."""
        seen, out = set(), []
        for op, shape, _n in self.shape_counts:
            if (op, shape) not in seen:
                seen.add((op, shape))
                out.append((op, shape))
        return tuple(out)

    # -- JSON round trip ----------------------------------------------------
    def to_json(self) -> str:
        doc = dataclasses.asdict(self)
        doc["shape_counts"] = [[op, list(shape), n]
                               for op, shape, n in self.shape_counts]
        doc["captured"] = self.captured_plan
        return json.dumps({"traffic_profile": 1, **doc}, indent=2,
                          sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "TrafficProfile":
        doc = json.loads(text)
        doc.pop("traffic_profile", None)
        doc["shape_counts"] = tuple(
            (op, tuple(int(d) for d in shape), int(n))
            for op, shape, n in doc["shape_counts"])
        doc["captured"] = tuple(sorted(doc.get("captured", {}).items()))
        return cls(**{f.name: doc[f.name]
                      for f in dataclasses.fields(cls) if f.name in doc})

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "TrafficProfile":
        return cls.from_json(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# synthetic traffic (deterministic generators for tests, CI and replay)
# ---------------------------------------------------------------------------

def trace_dims(kind: str, n: int, lo: int = 6, hi: int = 48,
               seed: int = 0) -> List[int]:
    """Deterministic dimension stream for a named traffic shape.

    uniform: flat over [lo, hi]; bimodal: a small-matrix mode near ``lo``
    and a large mode near ``hi`` (the heterogeneous mix where bucket
    policies differ most); heavy: Pareto-tailed around ``lo`` (most
    requests tiny, rare huge ones -- the regime where pow2 caps pay).
    """
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; one of {TRACE_KINDS}")
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        dims = rng.integers(lo, hi + 1, size=n)
    elif kind == "bimodal":
        small = rng.normal(lo + 2, 1.5, size=n)
        large = rng.normal(hi - 4, 3.0, size=n)
        pick = rng.random(n) < 0.65      # small mode dominates
        dims = np.where(pick, small, large)
    else:  # heavy
        dims = lo + rng.pareto(1.5, size=n) * 3.0
    return [int(d) for d in np.clip(np.round(dims), lo, hi)]


def synthesize(op: str, shape: Sequence[int], rng) -> np.ndarray:
    """One request matrix for (op, shape): symmetric for eigh, tall data
    for svd/pca -- matching ``launch.serve_pca.mixed_traffic``."""
    if op == "eigh":
        n = int(shape[-1])
        a = rng.standard_normal((n, n)).astype(np.float32)
        return (a + a.T) / 2
    m, n = int(shape[0]), int(shape[1])
    return rng.standard_normal((m, n)).astype(np.float32)


def synthetic_trace(kind: str, n: int, op: str = "eigh", lo: int = 6,
                    hi: int = 48, seed: int = 0) -> List[np.ndarray]:
    """A deterministic heterogeneous request burst of a named shape."""
    rng = np.random.default_rng(seed + 1)
    mats = []
    for d in trace_dims(kind, n, lo=lo, hi=hi, seed=seed):
        shape = (d, d) if op == "eigh" else (4 * d, d)
        mats.append(synthesize(op, shape, rng))
    return mats


def request_sequence(profile: TrafficProfile,
                     seed: int = 0) -> List[Tuple[str, Tuple[int, ...]]]:
    """The profile's histogram expanded into a deterministic arrival order
    (a seeded shuffle -- histograms forget ordering, and a sorted replay
    would batch unrealistically well)."""
    reqs = [(op, shape) for op, shape, n in profile.shape_counts
            for _ in range(n)]
    order = np.random.default_rng(seed).permutation(len(reqs))
    return [reqs[i] for i in order]


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CostModel:
    """Analytical score of (plan, profile) -> estimated seconds to serve.

    Three terms, each a telemetry-calibratable quantity:

      device   bucket area (to the solve-work power) x padded batch x
               flush count / device rate -- the padding-waste and
               batching term: bigger buckets and emptier flushes cost.
      host     per-flush dispatch cost (stack/pad/launch/unpack), minus
               the fraction the plan's pipeline depth hides behind device
               execution.  Occupancy is ``1 - 1/max_inflight`` scaled by
               the efficiency the profile actually measured
               (``overlap_frac``) when it was captured under a pipelined
               plan -- a host that never reached its theoretical overlap
               will not magically reach it under the candidate either.
      compile  one charge per distinct executable the plan needs
               (op x bucket x padded-batch), amortized against the
               executable cache: steady-state traffic compiles once, so
               plans that shatter traffic across many buckets pay here.
    """
    device_work_per_s: float = 2.0e9
    host_s_per_flush: float = 1.0e-3
    host_s_per_request: float = 3.0e-5
    compile_s_per_executable: float = 0.25

    def request_service_s(self, op: str, bucket: Sequence[int],
                          batch: int = 1,
                          sweeps_frac: float = 1.0) -> float:
        """Predicted seconds to serve one request of (op, bucket).

        The admission-control primitive: device work for the padded
        problem (scaled by ``sweeps_frac`` -- the degrade path trades
        Jacobi sweeps for time) plus the per-request share of one flush's
        host cost.  ``batch`` amortizes the flush overhead the way the
        serving engine actually does.
        """
        batch = max(int(batch), 1)
        dev = solve_work(op, bucket) * max(sweeps_frac, 0.0) \
            / self.device_work_per_s
        host = self.host_s_per_flush / batch + self.host_s_per_request
        return dev + host

    @classmethod
    def calibrated(cls, profile: TrafficProfile) -> "CostModel":
        """Constants from the profile's own telemetry where available."""
        m = cls()
        if profile.mean_dispatch_hit_s > 0:
            m.host_s_per_flush = max(
                profile.mean_dispatch_hit_s
                - m.host_s_per_request * profile.mean_flush_batch, 1e-6)
        if profile.mean_dispatch_miss_s > profile.mean_dispatch_hit_s > 0:
            m.compile_s_per_executable = (profile.mean_dispatch_miss_s
                                          - profile.mean_dispatch_hit_s)
        if profile.work_dispatched > 0 and profile.device_s > 0:
            m.device_work_per_s = profile.work_dispatched / profile.device_s
        return m

    def occupancy(self, plan: ServingPlan,
                  profile: TrafficProfile) -> float:
        """Fraction of per-flush host cost the plan's pipeline hides."""
        if plan.max_inflight <= 1:
            return 0.0
        ceiling = 1.0 - 1.0 / plan.max_inflight
        captured = profile.captured_plan
        cap_depth = int(captured.get("max_inflight", 1) or 1)
        if cap_depth > 1 and profile.overlap_frac > 0:
            # the profile measured real overlap under a pipelined plan:
            # trust its efficiency relative to that plan's own ceiling
            eff = profile.overlap_frac / (1.0 - 1.0 / cap_depth)
            return ceiling * float(np.clip(eff, 0.1, 1.0))
        return ceiling

    def plan_cost(self, plan: ServingPlan,
                  profile: TrafficProfile) -> Dict[str, float]:
        """Score one plan against one profile (lower total_s is better)."""
        policy = plan.policy()
        shards = plan.n_shards()
        per_bucket: Dict[Tuple, int] = collections.Counter()
        waste_num = 0.0
        for op, shape, n in profile.shape_counts:
            bucket = policy.bucket_shape(shape)
            per_bucket[(op, bucket)] += n
            true = float(np.prod([int(d) for d in shape]))
            padded = float(np.prod(bucket))
            waste_num += n * (1.0 - true / padded)
        occupancy = self.occupancy(plan, profile)
        device_s = host_s = hidden_s = 0.0
        n_exec = 0
        padded_batch = int(math.ceil(plan.max_batch / shards)) * shards
        for (op, bucket), n in sorted(per_bucket.items()):
            flushes = math.ceil(n / plan.max_batch)
            dev_flush = (padded_batch / shards) * solve_work(op, bucket) \
                / self.device_work_per_s
            host_flush = (self.host_s_per_flush
                          + self.host_s_per_request * plan.max_batch)
            n_exec += 1
            device_s += flushes * dev_flush
            host_s += flushes * host_flush
            hidden_s += flushes * occupancy * min(host_flush, dev_flush)
        compile_s = n_exec * self.compile_s_per_executable
        # deadline term: when the profile measured an arrival rate, a plan
        # slower than the offered load queues unboundedly -- every second
        # of predicted service beyond the offered span is a second of
        # backlog at the end of the window, charged at face value so
        # plans that keep up dominate plans that almost keep up.
        overload_s = 0.0
        if profile.arrival_rate > 0 and profile.requests > 0:
            offered_span = profile.requests / profile.arrival_rate
            serve_s = device_s + host_s - hidden_s
            overload_s = max(0.0, serve_s - offered_span)
        total_s = max(device_s + host_s - hidden_s + compile_s
                      + overload_s, 1e-12)
        requests = max(profile.requests, 1)
        return {
            "total_s": total_s,
            "device_s": device_s,
            "host_s": host_s,
            "hidden_s": hidden_s,
            "compile_s": compile_s,
            "overload_s": overload_s,
            "n_buckets": float(len(per_bucket)),
            "n_executables": float(n_exec),
            "est_padding_waste": waste_num / requests,
            "est_requests_per_s": requests / total_s,
        }


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def server_for_plan(plan: ServingPlan, config: Optional[PCAConfig] = None,
                    device: DeviceLike = None, **kw) -> "PCAServer":
    """A fresh ``PCAServer`` configured exactly as the plan prescribes, its
    executor on ``device`` (default ``cuda``)."""
    from . import engine
    cfg = dataclasses.replace(config or PCAConfig(),
                              T=plan.T, S=plan.max_batch)
    if getattr(plan, "backend", "keep") != "keep":
        cfg = dataclasses.replace(cfg, backend=plan.backend)
    kw.setdefault("max_delay_s", 10.0)
    with engine.spec_construction():
        return engine.PCAServer(
            cfg, policy=plan.policy(), max_batch=plan.max_batch,
            max_inflight=plan.max_inflight,
            executor=plan.build_executor(device=device), **kw)


def replay(profile: TrafficProfile, plan: ServingPlan,
           config: Optional[PCAConfig] = None, seed: int = 0,
           passes: int = 2, device: DeviceLike = None) -> Dict[str, float]:
    """Measure one plan on the profile's regenerated traffic.

    Deterministic end to end: the request sequence and matrix contents
    depend only on (profile, seed), so every candidate plan sees the
    byte-identical burst.  One warmup pass compiles the plan's buckets
    (steady-state serving runs on the executable cache; the cost model
    charges compilation separately), then best-of-``passes`` timing.
    The server runs on ``device`` (default ``cuda``).
    """
    import time as _time

    reqs = request_sequence(profile, seed)
    rng = np.random.default_rng(seed)
    mats = [(op, synthesize(op, shape, rng)) for op, shape in reqs]
    srv = server_for_plan(plan, config, device=device)

    def one_pass():
        tickets = [srv.submit(m, op=op) for op, m in mats]
        srv.drain()
        return tickets

    one_pass()                       # warmup: compile every bucket
    wall, s = float("inf"), None
    for _ in range(max(passes, 1)):
        srv.stats.reset()
        t0 = _time.perf_counter()
        one_pass()
        elapsed = _time.perf_counter() - t0
        if elapsed < wall:
            # keep the telemetry of the pass whose wall time wins, so a
            # row's throughput and latency numbers come from the same run
            wall, s = elapsed, srv.stats.summary()
    return {
        "wall_s": wall,
        "requests_per_s": len(mats) / wall if wall > 0 else 0.0,
        "latency_p99_ms": s["latency_p99_ms"],
        "mean_padding_waste": s["mean_padding_waste"],
        "mean_batch": s["mean_batch"],
        "cache_hit_rate": s["cache_hit_rate"],
        "overlap_frac": s["overlap_frac"],
    }


@dataclasses.dataclass
class AutotuneResult:
    best: ServingPlan
    mode: str            # "analytic" | "measured" | "bandit[-analytic]"
    scored: List[Tuple[ServingPlan, Dict]]      # every plan, best first
    measured: List[Dict] = dataclasses.field(default_factory=list)
    model: Optional[CostModel] = None
    measured_evals: int = 0                     # replay calls spent
    grid_size: int = 0

    def to_json(self) -> Dict:
        return {
            "mode": self.mode,
            "best": self.best.to_json(),
            "best_describe": self.best.describe(),
            "grid_size": self.grid_size,
            "measured_evals": self.measured_evals,
            "analytic_top": [
                {"plan": p.to_json(), "total_s": c["total_s"],
                 "est_requests_per_s": c["est_requests_per_s"],
                 "est_padding_waste": c["est_padding_waste"]}
                for p, c in self.scored[:5]],
            "measured": self.measured,
        }


def autotune(profile: TrafficProfile,
             grid: Optional[Sequence[ServingPlan]] = None,
             model: Optional[CostModel] = None,
             measure_top_k: int = 0,
             config: Optional[PCAConfig] = None,
             seed: int = 0,
             passes: int = 2,
             obs=None, device: DeviceLike = None) -> AutotuneResult:
    """Search the plan grid against a profile.

    Exhaustive analytic scoring (the grid is small by design), then an
    optional measured refinement: the analytic top-``measure_top_k`` plans
    replay the profile's traffic on live servers and the measured best
    wins.  ``measure_top_k=0`` is the pure-analytic mode (CI-cheap).

    ``obs``: optional ``repro_torch.obs.Observability`` -- the search
    lands as one span on the control track plus an
    ``autotune_searches_total{mode}`` counter, so plan churn shows up next
    to the plan-swap spans it causes.  ``device``: where the measured
    replays run (default ``cuda``).
    """
    grid = list(grid) if grid is not None else plan_grid()
    if not grid:
        raise ValueError("empty plan grid")
    t0 = obs.clock() if obs is not None else 0.0
    model = model or CostModel.calibrated(profile)
    scored = sorted(((plan, model.plan_cost(plan, profile))
                     for plan in grid), key=lambda pc: pc[1]["total_s"])
    best, mode, measured = scored[0][0], "analytic", []
    if measure_top_k > 0:
        for plan, cost in scored[:measure_top_k]:
            row = replay(profile, plan, config=config, seed=seed,
                         passes=passes, device=device)
            row.update(plan=plan.to_json(), describe=plan.describe(),
                       est_total_s=cost["total_s"])
            measured.append(row)
        measured.sort(key=lambda r: -r["requests_per_s"])
        best, mode = ServingPlan.from_json(measured[0]["plan"]), "measured"
    if obs is not None:
        obs.tracer.complete(
            "autotune", ts=t0, end=obs.clock(), cat="control",
            track="control", mode=mode, plans=len(grid),
            measured=len(measured), best=best.describe())
        obs.metrics.counter(
            "autotune_searches_total", "Serving-plan autotune searches.",
            ("mode",)).labels(mode=mode).inc()
    return AutotuneResult(best=best, mode=mode, scored=scored,
                          measured=measured, model=model,
                          measured_evals=len(measured), grid_size=len(grid))


# ---------------------------------------------------------------------------
# successive-halving bandit search
# ---------------------------------------------------------------------------

def subsample(profile: TrafficProfile, frac: float,
              seed: int = 0) -> TrafficProfile:
    """The profile at reduced fidelity: every histogram count scaled by
    ``frac`` (at least 1, so no op disappears -- a rung must still see
    every traffic mode it is ranking plans for).  Low rungs of the bandit
    replay these cheap approximations; only the final rung pays for the
    full profile."""
    if frac >= 1.0:
        return profile
    if frac <= 0:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    rows = tuple(sorted((op, shape, max(1, int(round(n * frac))))
                        for op, shape, n in profile.shape_counts))
    requests = sum(n for _, _, n in rows)
    return dataclasses.replace(
        profile, shape_counts=rows, requests=requests,
        duration_s=profile.duration_s * frac)


def _rung_sizes(budget: int, n_plans: int, eta: int) -> List[int]:
    """Survivor counts per rung: geometric decay by ``eta`` down to a
    final rung of 1, sized so the total replay calls fit ``budget``."""
    n0 = min(n_plans, max(2, (budget * (eta - 1)) // eta))
    while n0 > 1:
        sizes = []
        n = n0
        while n > 1:
            sizes.append(n)
            n = max(1, math.ceil(n / eta))
        sizes.append(1)
        if sum(sizes) <= budget:
            return sizes
        n0 -= 1
    return [1] if budget >= 1 else []


def bandit_search(profile: TrafficProfile,
                  grid: Optional[Sequence[ServingPlan]] = None,
                  model: Optional[CostModel] = None,
                  budget_frac: float = 0.25,
                  eta: int = 3,
                  config: Optional[PCAConfig] = None,
                  seed: int = 0,
                  passes: int = 1,
                  measure: bool = True,
                  obs=None, device: DeviceLike = None) -> AutotuneResult:
    """Successive-halving plan search: analytic seeding, measured rungs.

    The exhaustive ``autotune(measure_top_k=len(grid))`` spends one
    ``replay`` per plan; this spends at most ``budget_frac`` of that
    (default 25% -- i.e. >= 75% of the measured evaluations are pruned),
    which is what lets the grid grow the mesh x backend axes without the
    measured refinement exploding:

      rung 0   the analytic ``CostModel`` scores the *whole* grid for
               free and seeds the first measured rung with its top
               ``n0`` arms (``n0`` sized so the geometric rung series
               fits the replay budget).
      rung i   every surviving arm replays a ``subsample`` of the
               profile whose fidelity grows by ``eta`` per rung (classic
               successive halving on fidelity); the top ``1/eta`` of
               arms by measured throughput survive.  Ties break toward
               the better analytic rank, so fidelity noise can only
               reorder plans the model already called close.
      final    the last survivor pair replays the full profile; the
               measured winner is the plan.

    ``measure=False`` (or a budget below 2 replays) degrades to pure
    analytic ranking over the grid -- deterministic under an injected
    clock, which is how the serving controller runs in tests and under
    ``VirtualClock`` traffic.  ``device``: where the measured rungs replay
    (default ``cuda``; the controller passes its server's device).
    """
    grid = list(grid) if grid is not None else plan_grid()
    if not grid:
        raise ValueError("empty plan grid")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    t0 = obs.clock() if obs is not None else 0.0
    model = model or CostModel.calibrated(profile)
    scored = sorted(((plan, model.plan_cost(plan, profile))
                     for plan in grid), key=lambda pc: pc[1]["total_s"])
    budget = int(budget_frac * len(grid))
    measured: List[Dict] = []
    evals = 0
    if not measure or budget < 2:
        best, mode = scored[0][0], "bandit-analytic"
    else:
        sizes = _rung_sizes(budget, len(grid), eta)
        analytic_rank = {plan: i for i, (plan, _) in enumerate(scored)}
        survivors = [plan for plan, _ in scored[:sizes[0]]]
        n_rungs = len(sizes)
        for i, size in enumerate(sizes):
            survivors = survivors[:size]
            frac = float(eta) ** (i - (n_rungs - 1))
            rung_profile = subsample(profile, frac, seed=seed)
            rows = []
            for plan in survivors:
                row = replay(rung_profile, plan, config=config, seed=seed,
                             passes=passes, device=device)
                evals += 1
                row.update(plan=plan.to_json(), describe=plan.describe(),
                           rung=i, fidelity=frac,
                           est_total_s=model.plan_cost(
                               plan, profile)["total_s"])
                rows.append((plan, row))
            rows.sort(key=lambda pr: (-pr[1]["requests_per_s"],
                                      analytic_rank[pr[0]]))
            measured.extend(r for _, r in rows)
            survivors = [plan for plan, _ in rows]
        best, mode = survivors[0], "bandit"
    if obs is not None:
        obs.tracer.complete(
            "autotune", ts=t0, end=obs.clock(), cat="control",
            track="control", mode=mode, plans=len(grid),
            measured=evals, best=best.describe())
        obs.metrics.counter(
            "autotune_searches_total", "Serving-plan autotune searches.",
            ("mode",)).labels(mode=mode).inc()
    return AutotuneResult(best=best, mode=mode, scored=scored,
                          measured=measured, model=model,
                          measured_evals=evals, grid_size=len(grid))
