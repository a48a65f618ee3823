"""Autonomous serving controller: sliding-window re-profiling + bandit
plan search + hysteresis-guarded hot-swaps (port of
``repro.serving.controller``; under an injected clock and a pinned
``CostModel`` it takes the reference's decisions).

MANOJAVAM's mode-aware memory policies re-adapt the fabric as the access
pattern shifts between PCA stages; the serving-layer analogue re-adapts
the *plan* as the traffic regime shifts under the open-loop frontend.
``PCAServer.apply_plan`` makes swaps possible but manual; this closes
the loop:

  re-profile   every ``reprofile_every_s`` on the engine's injected clock
               (``PCAServer.poll`` ticks the controller, so the loop is
               single-threaded and fully deterministic under a
               ``VirtualClock``), condense the trailing ``window_s`` of
               live telemetry into a ``TrafficProfile`` --
               ``ServingStats`` records when reachable (true pre-bucket
               shapes), else ``MetricRegistry`` series
               (``TrafficProfile.from_registry``).  Quiet ops carry
               forward at exponential decay, so a traffic pause never
               yields the empty profile that would tune for nothing.
  search       ``autotune.bandit_search`` over the plan grid grown by the
               mesh x backend axes: the analytic ``CostModel``
               (calibrated from lifetime telemetry) seeds the rungs for
               free; with ``measure=True`` surviving arms replay at
               rising fidelity, spending <= ``budget_frac`` of the
               exhaustive grid's measured evaluations, on the live
               server's device.
  swap         only when the predicted gain clears ``hysteresis`` AND
               ``min_dwell_s`` has passed since the last swap -- the
               anti-thrash pair.  The swap goes through
               ``apply_plan(warm_profile=...)`` so the incoming plan's
               executables pre-build before any ticket re-buckets.
  feed back    the post-swap calibrated ``CostModel`` is pushed into the
               frontend's ``AdmissionController``
               (``TrafficFrontend.set_cost_model``), so admission
               feasibility tracks the plan actually in force.

Every tick emits ``controller_*`` telemetry through ``repro_torch.obs``: a
``controller_tick`` span on the control track, swap/skip counters (skips
labeled by reason: same-plan / below-hysteresis / dwell / empty-window)
and a predicted-gain gauge.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from .autotune import (CostModel, ServingPlan, TrafficProfile,
                       bandit_search, plan_grid)

__all__ = ["ServingController"]


class ServingController:
    """The re-profile / search / swap loop around one ``PCAServer``.

    Args:
      server: the engine to steer; its clock and telemetry drive the loop.
      window_s: sliding re-profile window (seconds of trailing traffic).
      reprofile_every_s: tick cadence; ``maybe_tick`` between cadences is
        a cheap no-op, so the engine can call it every ``poll``.
      hysteresis: minimum predicted fractional gain
        (``1 - best_cost / current_cost``) before a swap is worth the
        re-bucketing churn.
      min_dwell_s: minimum time between swaps (anti-thrash).
      grid: explicit plan grid; default ``plan_grid`` grown by ``meshes``
        x ``backends``.
      meshes / backends: the executor and kernel-backend axes (default
        off, matching the engine's own defaults).
      budget_frac / measure / passes: bandit search budget --
        ``measure=False`` (default) is the pure-analytic bandit,
        deterministic under an injected clock.
      frontend: optional ``TrafficFrontend``; after a swap its admission
        controller receives the new calibrated cost model.
      min_window_requests: windows with fewer fresh+carried requests are
        skipped (not enough signal to out-predict the current plan).
      decay: carry-forward weight for ops quiet in the current window.
    """

    def __init__(self, server, window_s: float = 5.0,
                 reprofile_every_s: float = 1.0, hysteresis: float = 0.15,
                 min_dwell_s: float = 2.0,
                 grid: Optional[Sequence[ServingPlan]] = None,
                 meshes: Sequence[str] = ("none",),
                 backends: Sequence[Optional[str]] = ("keep",),
                 budget_frac: float = 0.25, measure: bool = False,
                 passes: int = 1, seed: int = 0, frontend=None,
                 min_window_requests: int = 4, decay: float = 0.5,
                 model: Optional[CostModel] = None):
        if window_s <= 0 or reprofile_every_s <= 0:
            raise ValueError("window_s and reprofile_every_s must be > 0")
        if not 0 <= hysteresis < 1:
            raise ValueError(f"hysteresis must be in [0, 1), "
                             f"got {hysteresis}")
        self.server = server
        self.window_s = float(window_s)
        self.reprofile_every_s = float(reprofile_every_s)
        self.hysteresis = float(hysteresis)
        self.min_dwell_s = float(min_dwell_s)
        self.grid = (list(grid) if grid is not None
                     else plan_grid(meshes=tuple(meshes),
                                    backends=tuple(backends)))
        self.budget_frac = float(budget_frac)
        self.measure = bool(measure)
        self.passes = int(passes)
        self.seed = int(seed)
        self.frontend = frontend
        self.min_window_requests = int(min_window_requests)
        self.decay = float(decay)
        # a pinned model skips per-tick calibration -- benchmarks pin it
        # so regret is well-defined under one scoring function; live
        # serving leaves it None and recalibrates from each window
        self.model = model
        self.swaps: List[Dict] = []       # one record per applied swap
        self.plan_log: List[tuple] = []   # (t, ServingPlan) per swap
        self.ticks = 0
        self.last_result = None           # AutotuneResult of the last tick
        self._last_tick: Optional[float] = None
        self._last_swap: Optional[float] = None
        self._last_profile: Optional[TrafficProfile] = None
        self._tick_lock = threading.Lock()  # see maybe_tick
        self._wire_obs()

    @classmethod
    def from_spec(cls, server, cspec, frontend=None,
                  seed: int = 0) -> "ServingController":
        """Build from a ``serving.spec.ControllerSpec``."""
        return cls(server, window_s=cspec.window_s,
                   reprofile_every_s=cspec.reprofile_every_s,
                   hysteresis=cspec.hysteresis,
                   min_dwell_s=cspec.min_dwell_s,
                   meshes=cspec.meshes, backends=cspec.backends,
                   budget_frac=cspec.budget_frac, measure=cspec.measure,
                   seed=seed, frontend=frontend)

    # -- telemetry ----------------------------------------------------------
    def _wire_obs(self) -> None:
        obs = self.server.obs
        if obs is None:
            self._m_ticks = None
            return
        m = obs.metrics
        self._m_ticks = m.counter(
            "controller_ticks_total",
            "Controller re-profile ticks.").labels()
        self._m_swaps = m.counter(
            "controller_swaps_total",
            "Plan swaps the controller applied.").labels()
        self._m_skips = m.counter(
            "controller_skips_total",
            "Ticks that decided against swapping, by reason.", ("reason",))
        self._m_gain = m.gauge(
            "controller_predicted_gain",
            "Predicted fractional gain of the last tick's best plan "
            "over the current plan.").labels()

    def _skip(self, reason: str, now: float) -> None:
        if self._m_ticks is not None:
            self._m_skips.labels(reason=reason).inc(now=now)

    # -- profiling ----------------------------------------------------------
    def current_plan(self) -> ServingPlan:
        """The server's in-force facts as a ``ServingPlan`` (the
        hysteresis baseline the candidate must beat)."""
        srv = self.server
        n = int(getattr(srv.executor, "n_shards", 1))
        return ServingPlan(mode=srv.policy.mode, T=srv.policy.T,
                           pow2_cap=srv.policy.pow2_cap,
                           max_batch=srv.max_batch,
                           max_inflight=srv.max_inflight,
                           mesh="none" if n <= 1 else str(n))

    def window_profile(self, now: float) -> TrafficProfile:
        """The trailing window's traffic, with quiet-op carry-forward.

        Prefers ``ServingStats`` records (true pre-bucketing shapes; the
        registry only retains bucket labels); falls back to
        ``TrafficProfile.from_registry`` when stats are unreachable.
        Either way, ops with zero events this window inherit the previous
        profile's histogram at ``decay`` weight -- see ``from_registry``.
        """
        captured = self.server.describe_plan()
        stats = getattr(self.server, "stats", None)
        if stats is not None:
            profile = self._from_stats_window(stats, now, captured)
        else:
            profile = TrafficProfile.from_registry(
                self.server.obs.metrics, self.window_s, now=now,
                carry=self._last_profile, decay=self.decay,
                captured=captured)
        self._last_profile = profile
        return profile

    def _from_stats_window(self, stats, now: float,
                           captured: Dict) -> TrafficProfile:
        """Windowed ``from_stats`` with the same carry-forward contract
        as ``from_registry``."""
        import collections
        cut = now - self.window_s
        # one copy of the ring first: the paced frontend's worker appends
        # records while the feeder ticks
        recs = [r for r in list(stats.records) if r.t_done >= cut]
        counts = collections.Counter(
            (r.op, tuple(int(d) for d in r.shape)) for r in recs)
        fresh_ops = {op for op, _ in counts}
        carry = self._last_profile
        if carry is not None and self.decay > 0:
            for op, shape, n in carry.shape_counts:
                if op in fresh_ops:
                    continue
                kept = int(round(n * self.decay))
                if kept > 0:
                    counts[(op, tuple(int(d) for d in shape))] += kept
        shape_counts = tuple(sorted(
            (op, shape, n) for (op, shape), n in counts.items()))
        requests = sum(n for _, _, n in shape_counts)
        # calibration aggregates come from lifetime telemetry (more
        # samples -> steadier cost-model constants than one window's)
        life = TrafficProfile.from_stats(stats, captured=captured)
        return dataclasses.replace(
            life, shape_counts=shape_counts, requests=requests,
            duration_s=self.window_s,
            arrival_rate=requests / self.window_s)

    # -- the loop -----------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> Optional[Dict]:
        """Run one controller decision if the cadence is due.

        Returns the swap record when a swap was applied, else None.
        Reentrancy-guarded: a swap's own pre-warm/poll activity cannot
        recurse into another tick, and a tick running in another thread
        makes this call a no-op.
        """
        now = self.server.clock() if now is None else now
        if not self._cadence_due(now):
            return None
        # the paced frontend ticks from its feeder thread while its worker
        # polls (and so ticks) under the server's lock: a tick already
        # running in either thread makes this call a no-op, so neither
        # thread waits for the other and the feeder never waits for the
        # server -- only a swap's ``apply_plan`` takes the server's lock
        if not self._tick_lock.acquire(blocking=False):
            return None
        try:
            # again under the tick lock: a tick may have ended since
            if not self._cadence_due(now):
                return None
            return self._tick(now)
        finally:
            self._tick_lock.release()

    def _cadence_due(self, now: float) -> bool:
        return (self._last_tick is None
                or now - self._last_tick >= self.reprofile_every_s)

    def _tick(self, now: float) -> Optional[Dict]:
        self._last_tick = now
        self.ticks += 1
        obs = self.server.obs
        if self._m_ticks is not None:
            self._m_ticks.inc(now=now)
        profile = self.window_profile(now)
        if profile.requests < self.min_window_requests:
            self._skip("empty-window", now)
            return None
        model = self.model or CostModel.calibrated(profile)
        result = bandit_search(
            profile, grid=self.grid, model=model,
            budget_frac=self.budget_frac,
            config=dataclasses.replace(self.server.config),
            seed=self.seed, passes=self.passes,
            measure=self.measure, obs=obs,
            device=self.server.executor.device)
        self.last_result = result
        current = self.current_plan()
        cur_cost = model.plan_cost(current, profile)["total_s"]
        best_cost = model.plan_cost(result.best, profile)["total_s"]
        gain = 1.0 - best_cost / cur_cost if cur_cost > 0 else 0.0
        if self._m_ticks is not None:
            self._m_gain.set(gain, now=now)
        swap = None
        reason = None
        if result.best == current:
            reason = "same-plan"
        elif gain < self.hysteresis:
            reason = "below-hysteresis"
        elif (self._last_swap is not None
              and now - self._last_swap < self.min_dwell_s):
            reason = "dwell"
        else:
            swap = self.server.apply_plan(result.best,
                                          warm_profile=profile)
            swap.update(t=now, predicted_gain=gain,
                        plan=result.best.describe(),
                        search_mode=result.mode,
                        measured_evals=result.measured_evals)
            self.swaps.append(swap)
            self.plan_log.append((now, result.best))
            self._last_swap = now
            if self._m_ticks is not None:
                self._m_swaps.inc(now=now)
            if self.frontend is not None:
                self.frontend.set_cost_model(model)
        if reason is not None:
            self._skip(reason, now)
        if obs is not None:
            obs.tracer.complete(
                "controller_tick", ts=now, end=obs.clock(), cat="control",
                track="control", requests=profile.requests,
                gain=round(gain, 4), swapped=swap is not None,
                **({"skip": reason} if reason else {}))
        return swap

    def summary(self) -> Dict:
        """Plain JSON-able controller state for reports and banners."""
        return {
            "ticks": self.ticks,
            "swaps": len(self.swaps),
            "grid_size": len(self.grid),
            "window_s": self.window_s,
            "reprofile_every_s": self.reprofile_every_s,
            "hysteresis": self.hysteresis,
            "min_dwell_s": self.min_dwell_s,
            "current_plan": self.current_plan().describe(),
            "swap_log": [{k: s[k] for k in
                          ("t", "predicted_gain", "plan", "requeued")}
                         for s in self.swaps],
        }
