"""Open-loop traffic frontend: arrivals, tenant fairness, admission (port
of ``repro.serving.frontend``: the same arrivals, queue and admission
math, so a seeded virtual-clock run takes the reference's decisions).

The benchmarks before this module replayed closed-loop bursts -- submit
everything, drain, divide.  Millions of users are an *open-loop* arrival
process: requests land on their own schedule whether or not the server
kept up, and the headline metric shifts from raw throughput to **goodput
under an SLO** (p99-latency-compliant requests/s).  This module is the
layer between that traffic and ``PCAServer.submit``:

  arrivals    seeded generators for Poisson / diurnal (sinusoid-modulated
              rate, thinning-sampled) / bursty (Markov-modulated on-off)
              processes, producing timestamped per-tenant ``Arrival``
              streams whose shape mix reuses ``autotune.trace_dims`` --
              so ``profile_of(arrivals)`` hands the autotuner a
              ``TrafficProfile`` describing exactly the traffic the
              frontend will emit, arrival rate included.
  fairness    per-tenant ``TokenBucket`` quotas and a ``FairQueue``
              scheduling across tenant queues by virtual finish time
              (start-time fair queueing: tag = max(vtime, tenant finish),
              finish += work/weight; pop min tag) with a priority lane
              that bypasses WFQ for latency-critical tenants.
  admission   deadline feasibility at ingress: ``CostModel``-predicted
              service time plus the current backlog vs the request's SLO.
              Infeasible requests are *shed* (typed outcome, no queueing)
              or *degraded* (resubmitted with fewer Jacobi sweeps -- a
              relaxed ``SolverKey`` executable -- when the cheaper
              variant fits the deadline).  The backlog estimate is
              scheduler-aware: under WFQ a tenant waits on its *own*
              queue scaled by its weight share, so admission does not
              shed a light tenant for a whale's backlog.

``TrafficFrontend.run`` drives a live server in two modes.  ``pace=True``
replays arrivals in real time through a feeder thread + submitter worker
(the threaded slot/queue shape of the MaxText offline-inference harness):
the feeder never blocks on the server -- that is what makes the loop
open -- while the worker absorbs backpressure from the engine's in-flight
cap, so the scheduler queue grows exactly when the server saturates and
fairness starts to matter.  ``pace=False`` runs the same admission and
scheduling math single-threaded under a ``VirtualClock`` with a modeled
service horizon (``CostModel`` seconds accumulate into ``busy_until``),
which makes queueing, shedding and WFQ ordering bit-reproducible: same
seed, same admitted/shed split, same results.  CI asserts exactly that.

On the card, the paced run's worker thread dispatches flushes (each
recording its completion event on the device's current stream, which a
thread that never set one shares with the main thread) and the main
thread's ``drain`` retires whatever is still in flight.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import heapq
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .autotune import CostModel, TrafficProfile, synthesize, trace_dims

ARRIVALS = ("poisson", "diurnal", "bursty")
SCHEDULERS = ("wfq", "fifo")
ADMISSION_MODES = ("none", "shed", "degrade")


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

class VirtualClock:
    """A settable monotonic clock -- inject into ``PCAServer``,
    ``Observability`` and the frontend so a whole open-loop run advances
    in simulated time, deterministically."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock by {dt}")
        self._t += dt
        return self._t

    def set(self, t: float) -> float:
        """Move to ``t`` (monotone: never backwards)."""
        self._t = max(self._t, float(t))
        return self._t


# ---------------------------------------------------------------------------
# tenants and arrivals
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic contract.

    ``share`` is its fraction of the offered load (normalized across the
    tenant set); ``weight`` its WFQ weight; ``rate_limit`` a token-bucket
    quota in requests/s (0 = unlimited) with ``burst`` tokens of depth
    (default: one second's worth); ``priority`` routes it around WFQ
    through the priority lane; ``slo_ms`` overrides the frontend SLO.
    """
    name: str
    share: float = 1.0
    weight: float = 1.0
    rate_limit: float = 0.0
    burst: float = 0.0
    priority: bool = False
    slo_ms: Optional[float] = None


def parse_tenants(spec: str) -> Tuple[TenantSpec, ...]:
    """CLI spelling: ``name[:share[:weight]][:p]`` comma-separated --
    ``"whale:0.9,mouse:0.1"``, ``"rt:0.2:1:p,batch:0.8:1"``."""
    tenants = []
    for tok in spec.split(","):
        parts = [p.strip() for p in tok.strip().split(":") if p.strip()]
        if not parts:
            continue
        priority = parts[-1].lower() == "p"
        if priority:
            parts = parts[:-1]
        name = parts[0]
        share = float(parts[1]) if len(parts) > 1 else 1.0
        weight = float(parts[2]) if len(parts) > 2 else 1.0
        tenants.append(TenantSpec(name=name, share=share, weight=weight,
                                  priority=priority))
    if not tenants:
        raise ValueError(f"no tenants in spec {spec!r}")
    return tuple(tenants)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One timestamped request in an open-loop stream."""
    t: float
    tenant: str
    op: str
    shape: Tuple[int, ...]
    rid: int


def arrival_times(kind: str, rate: float, n: int, seed: int = 0,
                  period_s: float = 60.0, depth: float = 0.8,
                  on_s: float = 1.0, off_s: float = 3.0,
                  burst_factor: float = 4.0) -> List[float]:
    """``n`` arrival timestamps of a named process at mean ``rate`` req/s.

    poisson  homogeneous: exponential inter-arrivals.
    diurnal  non-homogeneous, lam(t) = rate * (1 + depth sin(2 pi t /
             period_s)), sampled by thinning against lam_max.
    bursty   Markov-modulated on-off: exponential dwell in on/off states
             (mean ``on_s``/``off_s``), on-rate = burst_factor * rate,
             off-rate chosen so the long-run mean stays ``rate`` (clamped
             at 0 when the on state alone exceeds it -- the defaults,
             4x bursts for a quarter of the cycle, balance exactly).

    Deterministic in (kind, rate, n, seed, shape params) -- the generator
    never reads a wall clock.
    """
    if kind not in ARRIVALS:
        raise ValueError(f"unknown arrival kind {kind!r}; one of {ARRIVALS}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n <= 0:
        return []
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = 0.0
    if kind == "poisson":
        for dt in rng.exponential(1.0 / rate, size=n):
            t += dt
            times.append(t)
    elif kind == "diurnal":
        lam_max = rate * (1.0 + abs(depth))
        while len(times) < n:
            t += rng.exponential(1.0 / lam_max)
            lam = rate * (1.0 + depth * math.sin(2 * math.pi * t / period_s))
            if rng.random() * lam_max <= max(lam, 0.0):
                times.append(t)
    else:  # bursty
        rate_on = burst_factor * rate
        cycle = on_s + off_s
        rate_off = max((rate * cycle - rate_on * on_s) / off_s, 0.0)
        on = True
        t_flip = t + rng.exponential(on_s)
        while len(times) < n:
            r = rate_on if on else rate_off
            if r <= 0:
                t = t_flip
                on = not on
                t_flip = t + rng.exponential(on_s if on else off_s)
                continue
            dt = rng.exponential(1.0 / r)
            if t + dt >= t_flip:
                t = t_flip
                on = not on
                t_flip = t + rng.exponential(on_s if on else off_s)
                continue
            t += dt
            times.append(t)
    return times


def generate(kind: str, rate: float, n: int,
             tenants: Sequence[TenantSpec] = (TenantSpec("t0"),),
             seed: int = 0, trace: str = "bimodal", op: str = "eigh",
             lo: int = 6, hi: int = 48, **arrival_kw) -> List[Arrival]:
    """A timestamped per-tenant request stream: arrival times from the
    named process, dims from ``autotune.trace_dims`` (the same named
    shape mixes the autotuner replays), tenants drawn by ``share``."""
    times = arrival_times(kind, rate, n, seed=seed, **arrival_kw)
    dims = trace_dims(trace, n, lo=lo, hi=hi, seed=seed)
    shares = np.asarray([max(t.share, 0.0) for t in tenants], float)
    if shares.sum() <= 0:
        raise ValueError("tenant shares must sum > 0")
    picks = np.random.default_rng(seed + 7).choice(
        len(tenants), size=n, p=shares / shares.sum())
    out = []
    for i, (t, d) in enumerate(zip(times, dims)):
        shape = (d, d) if op == "eigh" else (4 * d, d)
        out.append(Arrival(t=t, tenant=tenants[int(picks[i])].name,
                           op=op, shape=shape, rid=i))
    return out


def merge(*streams: Sequence[Arrival]) -> List[Arrival]:
    """Interleave independently-generated per-tenant streams into one
    timeline (rids reassigned in arrival order) -- the skewed-mix story:
    a whale of large refits and a mouse of small interactive requests
    get *different* shape distributions, not just different shares."""
    merged = sorted((a for s in streams for a in s),
                    key=lambda a: (a.t, a.tenant, a.rid))
    return [dataclasses.replace(a, rid=i) for i, a in enumerate(merged)]


def materialize(arrival: Arrival, seed: int = 0) -> np.ndarray:
    """The request matrix for one arrival -- deterministic per (seed,
    rid), so admission order cannot change any request's contents."""
    rng = np.random.default_rng((seed, arrival.rid))
    return synthesize(arrival.op, arrival.shape, rng)


def profile_of(arrivals: Sequence[Arrival]) -> TrafficProfile:
    """The ``TrafficProfile`` describing this exact stream -- histogram,
    span and measured arrival rate -- ready for ``autotune``/``warmup``.
    This is the ROADMAP seam: plans are scored against offered load."""
    counts = collections.Counter((a.op, a.shape) for a in arrivals)
    span = (max(a.t for a in arrivals) - min(a.t for a in arrivals)
            if len(arrivals) > 1 else 0.0)
    return TrafficProfile.from_shapes(
        sorted((op, shape, c) for (op, shape), c in counts.items()),
        duration_s=float(span),
        arrival_rate=len(arrivals) / span if span > 0 else 0.0)


# ---------------------------------------------------------------------------
# fairness: token buckets and weighted fair queueing
# ---------------------------------------------------------------------------

class TokenBucket:
    """Per-tenant rate quota: ``rate`` tokens/s refill into a bucket of
    ``burst`` depth; a request takes one token or is throttled.
    ``rate <= 0`` means unlimited.  Time is injected per call, so the
    bucket is exact under a virtual clock."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(self.rate, 1.0)
        self.tokens = self.burst
        self._t: Optional[float] = None

    def try_take(self, now: float, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        if self._t is None:
            self._t = now
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class FairQueue:
    """Tenant-fair scheduler ahead of ``PCAServer.submit``.

    ``wfq`` mode is start-time fair queueing over virtual time: each item
    gets tag = max(vtime, tenant's last finish), the tenant's finish
    advances by work/weight, and pop takes the minimum tag (ties by
    push order).  Popping advances vtime to the popped tag, so an idle
    tenant re-enters at *current* virtual time instead of burning its
    saved-up past -- the classic SFQ rule.  ``fifo`` mode is the
    baseline the benchmarks compare against.  A separate priority lane
    (``push(..., priority=True)``) always pops first, in FIFO order --
    the latency-critical bypass.

    Per-tenant queued work (in the same units as ``work``; the frontend
    uses predicted service seconds) is tracked for admission control.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 mode: str = "wfq"):
        if mode not in SCHEDULERS:
            raise ValueError(f"unknown mode {mode!r}; one of {SCHEDULERS}")
        self.mode = mode
        self.weights = dict(weights or {})
        self.vtime = 0.0
        self._finish: Dict[str, float] = {}
        self._heap: List[Tuple[float, int, str, float, object]] = []
        self._fifo: collections.deque = collections.deque()
        self._prio: collections.deque = collections.deque()
        self._seq = itertools.count()
        self._work: Dict[str, float] = collections.defaultdict(float)
        self._n: Dict[str, int] = collections.defaultdict(int)
        self._prio_work = 0.0

    def weight(self, tenant: str) -> float:
        return max(float(self.weights.get(tenant, 1.0)), 1e-9)

    def weight_share(self, tenant: str) -> float:
        """This tenant's share of total scheduler weight (all known
        tenants -- a stable, conservative denominator)."""
        names = set(self.weights) | {tenant}
        total = sum(self.weight(n) for n in names)
        return self.weight(tenant) / total if total > 0 else 1.0

    def push(self, tenant: str, item, work: float = 1.0,
             priority: bool = False) -> None:
        self._work[tenant] += work
        self._n[tenant] += 1
        if priority:
            self._prio_work += work
            self._prio.append((tenant, work, item))
        elif self.mode == "fifo":
            self._fifo.append((tenant, work, item))
        else:
            tag = max(self.vtime, self._finish.get(tenant, 0.0))
            self._finish[tenant] = tag + work / self.weight(tenant)
            heapq.heappush(self._heap,
                           (tag, next(self._seq), tenant, work, item))

    def pop(self) -> Tuple[str, float, object]:
        """(tenant, work, item) of the next request in fair order."""
        if self._prio:
            tenant, work, item = self._prio.popleft()
            self._prio_work -= work
        elif self.mode == "fifo":
            if not self._fifo:
                raise IndexError("pop from an empty FairQueue")
            tenant, work, item = self._fifo.popleft()
        else:
            if not self._heap:
                raise IndexError("pop from an empty FairQueue")
            tag, _, tenant, work, item = heapq.heappop(self._heap)
            self.vtime = max(self.vtime, tag)
        self._work[tenant] -= work
        self._n[tenant] -= 1
        return tenant, work, item

    def __len__(self) -> int:
        return len(self._prio) + len(self._fifo) + len(self._heap)

    def depth(self, tenant: str) -> int:
        return self._n[tenant]

    def queued_work(self, tenant: Optional[str] = None) -> float:
        if tenant is not None:
            return self._work[tenant]
        return sum(self._work.values())

    def priority_work(self) -> float:
        return self._prio_work


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    outcome: str          # "admit" | "degrade" | "shed"
    predicted_s: float    # service estimate for the variant chosen
    backlog_s: float      # backlog the decision saw


class AdmissionController:
    """Deadline feasibility at ingress.

    A request is feasible when predicted backlog + predicted service fits
    inside its SLO.  ``mode="none"`` admits everything (the unbounded-
    queueing baseline the benchmark beats); ``"shed"`` rejects infeasible
    requests outright; ``"degrade"`` first retries the feasibility check
    with a ``degrade_frac``-sweeps service estimate and admits the
    relaxed variant when *that* fits -- trading eigenvector accuracy for
    a kept deadline -- shedding only when even the cheap variant cannot
    make it.
    """

    def __init__(self, model: CostModel, policy, slo_s: Optional[float],
                 mode: str = "shed", degrade_frac: float = 0.5,
                 batch: int = 1):
        if mode not in ADMISSION_MODES:
            raise ValueError(
                f"unknown admission mode {mode!r}; one of {ADMISSION_MODES}")
        self.model = model
        self.policy = policy
        self.slo_s = slo_s
        self.mode = mode
        self.degrade_frac = float(degrade_frac)
        self.batch = int(batch)

    def service_s(self, op: str, shape, sweeps_frac: float = 1.0) -> float:
        return self.model.request_service_s(
            op, self.policy.bucket_shape(shape), batch=self.batch,
            sweeps_frac=sweeps_frac)

    def decide(self, op: str, shape, backlog_s: float,
               slo_s: Optional[float] = None) -> AdmissionDecision:
        slo = self.slo_s if slo_s is None else slo_s
        full = self.service_s(op, shape)
        if self.mode == "none" or slo is None or backlog_s + full <= slo:
            return AdmissionDecision("admit", full, backlog_s)
        if self.mode == "degrade":
            deg = self.service_s(op, shape, self.degrade_frac)
            if backlog_s + deg <= slo:
                return AdmissionDecision("degrade", deg, backlog_s)
        return AdmissionDecision("shed", full, backlog_s)


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrontendReport:
    """One open-loop run's accounting (plain JSON via ``to_json``)."""
    requests: int
    served: int
    degraded: int
    shed: int
    throttled: int
    duration_s: float
    offered_rps: float
    goodput_rps: float        # SLO-compliant completions / duration
    served_rps: float         # all completions / duration
    shed_frac: float          # (shed + throttled) / requests
    per_tenant: Dict[str, Dict]
    outcomes: Dict[int, str]  # rid -> served|degraded|shed|throttled
    digest: str               # sha256 over (rid, outcome, result bytes)

    @property
    def worst_tenant_goodput_rps(self) -> float:
        rows = [r.get("goodput_rps", 0.0)
                for r in self.per_tenant.values()]
        return min(rows) if rows else 0.0

    def to_json(self) -> Dict:
        doc = dataclasses.asdict(self)
        doc.pop("outcomes")
        doc["worst_tenant_goodput_rps"] = self.worst_tenant_goodput_rps
        return doc


class TrafficFrontend:
    """Open-loop traffic in front of one ``PCAServer``.

    Args:
      server: the engine to drive; its clock is shared (pass the same
        ``VirtualClock`` for deterministic runs).
      tenants: the tenant set (weights, quotas, priority, SLO overrides).
      slo_ms: default deadline; per-tenant ``slo_ms`` overrides it.
      scheduler: "wfq" | "fifo".
      admission: "none" | "shed" | "degrade".
      model: ``CostModel`` for service prediction; calibrate it from a
        profile of the same stream for honest admission estimates.
      degrade_frac: sweeps fraction of the degrade variant (the actual
        sweep count is ``max(1, round(config.sweeps * degrade_frac))``).
      accounting: optional ``repro_torch.obs.TenantAccounting`` to mirror
        tenant-labeled counters/latency/goodput into a metric registry.
      seed: matrix-content seed (see ``materialize``).
    """

    def __init__(self, server, tenants: Sequence[TenantSpec],
                 slo_ms: Optional[float] = None, scheduler: str = "wfq",
                 admission: str = "shed",
                 model: Optional[CostModel] = None,
                 degrade_frac: float = 0.5, accounting=None, seed: int = 0):
        self.server = server
        self.tenants = {t.name: t for t in tenants}
        self.slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.model = model or CostModel()
        self.queue = FairQueue({t.name: t.weight for t in tenants},
                               mode=scheduler)
        self.buckets = {t.name: TokenBucket(t.rate_limit, t.burst or None)
                        for t in tenants}
        self.admission = AdmissionController(
            self.model, server.policy, self.slo_s, mode=admission,
            degrade_frac=degrade_frac, batch=server.max_batch)
        self.accounting = accounting
        self.seed = seed
        self.degrade_sweeps = max(
            1, int(round(server.config.sweeps * degrade_frac)))

    def set_cost_model(self, model: CostModel) -> None:
        """Swap the admission cost model in place -- the controller's
        feedback path.  After a plan hot-swap the server's policy and
        batch cap may have moved too, so admission re-reads both: a
        feasibility verdict should price the plan actually in force, not
        the one the frontend was built against."""
        self.model = model
        self.admission.model = model
        self.admission.policy = self.server.policy
        self.admission.batch = self.server.max_batch

    # -- shared admission math ----------------------------------------------
    def _slo_for(self, tenant: str) -> Optional[float]:
        spec = self.tenants[tenant]
        return spec.slo_ms / 1e3 if spec.slo_ms is not None else self.slo_s

    def _backlog_s(self, tenant: str, residual_s: float) -> float:
        """Scheduler-aware backlog: what *this* tenant's next request
        would wait.  Work already on the server (``residual_s``) delays
        everyone; scheduler queue wait depends on the discipline -- under
        WFQ a tenant's queue drains at its weight share of capacity, so
        a light tenant is not charged for a whale's backlog."""
        spec = self.tenants[tenant]
        if spec.priority:
            return residual_s + self.queue.priority_work()
        if self.queue.mode == "fifo":
            return residual_s + self.queue.queued_work()
        share = self.queue.weight_share(tenant)
        return (residual_s + self.queue.priority_work()
                + self.queue.queued_work(tenant) / share)

    def _ingest(self, a: Arrival, now: float,
                residual_s: float) -> Optional[Tuple]:
        """Token bucket + admission for one arrival; returns the queue
        entry (arrival, matrix, sweeps, t_ingress) or None when the
        request was throttled/shed.  Outcome accounting for the rejected
        paths happens here; served/degraded land at completion."""
        controller = getattr(self.server, "controller", None)
        if controller is not None:
            # the virtual-time run never calls server.poll(), so the
            # arrival stream is the controller's clock source there; the
            # paced run double-ticks harmlessly (cadence-guarded no-op)
            controller.maybe_tick(now)
        spec = self.tenants[a.tenant]
        if not self.buckets[a.tenant].try_take(now):
            self._outcome(a, "throttled", now)
            return None
        decision = self.admission.decide(
            a.op, a.shape, self._backlog_s(a.tenant, residual_s),
            self._slo_for(a.tenant))
        if decision.outcome == "shed":
            self._outcome(a, "shed", now)
            return None
        sweeps = (self.degrade_sweeps if decision.outcome == "degrade"
                  else None)
        entry = (a, materialize(a, self.seed), sweeps, now)
        self.queue.push(a.tenant, entry, work=decision.predicted_s,
                        priority=spec.priority)
        if self.accounting is not None:
            self.accounting.queue_depth(a.tenant,
                                        self.queue.depth(a.tenant), now=now)
        return entry

    def _outcome(self, a: Arrival, outcome: str, now: float) -> None:
        self._outcomes[a.rid] = outcome
        if self.accounting is not None:
            self.accounting.outcome(a.tenant, outcome, now=now)

    # -- run ----------------------------------------------------------------
    def run(self, arrivals: Sequence[Arrival],
            pace: bool = False) -> FrontendReport:
        """Drive the server through one arrival stream.

        ``pace=False`` (default): single-threaded virtual-time run -- the
        server's clock must be a ``VirtualClock``; completions are modeled
        off ``CostModel`` service seconds (``busy_until`` horizon), which
        makes the whole run -- admission split, WFQ order, results --
        bit-deterministic in (arrivals, seed).  ``pace=True``: wall-clock
        replay through feeder/worker threads; latencies are measured on
        the real server (the benchmark path).
        """
        self._outcomes: Dict[int, str] = {}
        arrivals = sorted(arrivals, key=lambda a: (a.t, a.rid))
        if not arrivals:
            raise ValueError("empty arrival stream")
        if pace:
            completions, span = self._run_paced(arrivals)
        else:
            completions, span = self._run_virtual(arrivals)
        return self._report(arrivals, completions, span)

    def _run_virtual(self, arrivals):
        clock = self.server.clock
        if not isinstance(clock, VirtualClock):
            raise TypeError(
                "pace=False needs the server built on a VirtualClock "
                "(PCAServer(..., clock=VirtualClock()))")
        busy = clock()                     # modeled service horizon
        completions = []                   # (arrival, ticket, t_done)

        def drain_until(t_limit):
            nonlocal busy
            while len(self.queue) and busy < t_limit:
                tenant, work, (a, mat, sweeps, _) = self.queue.pop()
                clock.set(busy)
                ticket = self.server.submit(mat, op=a.op, sweeps=sweeps)
                busy += work
                completions.append((a, ticket, busy))

        for a in arrivals:
            drain_until(a.t)
            now = clock.set(a.t)
            self._ingest(a, now, residual_s=max(0.0, busy - now))
        drain_until(float("inf"))
        clock.set(busy)
        self.server.drain()
        t0 = arrivals[0].t
        t_end = max([busy] + [t for _, _, t in completions])
        return ([(a, tk, t_done - a.t) for a, tk, t_done in completions],
                max(t_end - t0, 1e-9))

    def _run_paced(self, arrivals):
        clock = self.server.clock
        lock = threading.Lock()
        cond = threading.Condition(lock)
        busy = [clock()]                   # modeled horizon, shared
        completions = []                   # (arrival, ticket, t_ingress)
        feeding = [True]

        def worker():
            while True:
                with cond:
                    if not len(self.queue) and feeding[0]:
                        cond.wait(0.005)
                    if not len(self.queue):
                        if not feeding[0]:
                            return
                        popped = None
                    else:
                        popped = self.queue.pop()
                        _, work, _ = popped
                        busy[0] = max(busy[0], clock()) + work
                if popped is None:
                    # idle tick: flush partial batches whose deadline
                    # passed, retire completed in-flight work
                    self.server.poll()
                    continue
                _, _, (a, mat, sweeps, t_in) = popped
                # submit outside the lock: this is where engine
                # backpressure (flush-on-full + in-flight cap) bites, and
                # the feeder must keep pacing meanwhile
                ticket = self.server.submit(mat, op=a.op, sweeps=sweeps)
                self.server.poll()
                with lock:
                    completions.append((a, ticket, t_in))

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        t0 = clock()
        first_t = arrivals[0].t
        for a in arrivals:
            target = t0 + (a.t - first_t)
            now = clock()
            if now < target:
                time.sleep(target - now)
                now = clock()
            with cond:
                residual = max(0.0, busy[0] - now)
                if self._ingest(a, now, residual) is not None:
                    cond.notify()
        with cond:
            feeding[0] = False
            cond.notify_all()
        th.join()
        self.server.drain()
        t_end = clock()
        out = []
        for a, ticket, t_in in completions:
            rec = ticket.record
            t_done = rec.t_done if rec is not None else clock()
            out.append((a, ticket, t_done - t_in))
        return out, max(t_end - t0, 1e-9)

    # -- accounting ---------------------------------------------------------
    def _report(self, arrivals, completions, span) -> FrontendReport:
        per_tenant: Dict[str, Dict] = {
            name: {"served": 0, "degraded": 0, "shed": 0, "throttled": 0,
                   "slo_ok": 0, "latencies_ms": []}
            for name in self.tenants}
        h = hashlib.sha256()
        ok_total = 0
        for a, ticket, latency in sorted(completions,
                                         key=lambda c: c[0].rid):
            outcome = ("degraded" if ticket.sweeps < self.server.config.sweeps
                       else "served")
            self._outcomes[a.rid] = outcome
            slo = self._slo_for(a.tenant)
            ok = slo is None or latency <= slo
            ok_total += int(ok)
            row = per_tenant[a.tenant]
            row[outcome] += 1
            row["slo_ok"] += int(ok)
            row["latencies_ms"].append(latency * 1e3)
            h.update(f"{a.rid}:{outcome}".encode())
            for part in _result_arrays(ticket.result()):
                h.update(np.ascontiguousarray(part).tobytes())
            if self.accounting is not None:
                self.accounting.outcome(a.tenant, outcome)
                self.accounting.served(a.tenant, latency, ok)
        tenant_of = {a.rid: a.tenant for a in arrivals}
        for a in arrivals:
            if a.rid not in self._outcomes:   # defensive: lost entries
                self._outcomes[a.rid] = "shed"
        for rid in sorted(self._outcomes):
            if self._outcomes[rid] in ("shed", "throttled"):
                h.update(f"{rid}:{self._outcomes[rid]}".encode())
                per_tenant[tenant_of[rid]][self._outcomes[rid]] += 1
        counts = collections.Counter(self._outcomes.values())
        for name, row in per_tenant.items():
            lats = row.pop("latencies_ms")
            row["latency_p50_ms"] = (float(np.percentile(lats, 50))
                                     if lats else 0.0)
            row["latency_p99_ms"] = (float(np.percentile(lats, 99))
                                     if lats else 0.0)
            row["goodput_rps"] = row["slo_ok"] / span
            if self.accounting is not None:
                self.accounting.goodput(name, row["goodput_rps"])
        n = len(arrivals)
        return FrontendReport(
            requests=n,
            served=counts["served"],
            degraded=counts["degraded"],
            shed=counts["shed"],
            throttled=counts["throttled"],
            duration_s=span,
            offered_rps=n / span,
            goodput_rps=ok_total / span,
            served_rps=len(completions) / span,
            shed_frac=(counts["shed"] + counts["throttled"]) / n,
            per_tenant=per_tenant,
            outcomes=dict(self._outcomes),
            digest=h.hexdigest())


def _result_arrays(result) -> List[np.ndarray]:
    """Every array inside a served result (ServedEigh/SVD/PCA dataclass,
    tuple, or bare array), in field order, for digesting."""
    if dataclasses.is_dataclass(result):
        out = []
        for f in dataclasses.fields(result):
            out.extend(_result_arrays(getattr(result, f.name)))
        return out
    if isinstance(result, (tuple, list)):
        out = []
        for part in result:
            out.extend(_result_arrays(part))
        return out
    return [np.asarray(result)]
