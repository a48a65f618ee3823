"""Multi-tenant PCA/SVD serving CLI (the MANOJAVAM fabric as a service;
port of ``repro.launch.serve_pca``: the same flags, spec file and JSON).

Feeds a synthetic mixed-shape request stream through ``serving.PCAServer``
and prints the telemetry summary as JSON: requests/s, p50/p99 latency,
padding waste, solver-cache hit rate, and the predicted-vs-measured
comparison against the analytical fabric model.

The server runs on the card (``cuda``): give it the hand-written kernels
with a spec whose execution sets ``backend="cuda"`` and ``fused=True``
(``backend=None``, the default, is plain torch ops).  Without a card the
CLI raises; from Python, ``main([...], device="cpu")`` runs the plain
PyTorch versions on the CPU, as the tests do.

On the card, with the kernels:
  python -c 'from repro_torch.serving import *; ServerSpec(
      scheduling=SchedulingSpec(mode="pow2", T=64, max_batch=32),
      execution=ExecutionSpec(backend="cuda", fused=True, sweeps=50)
      ).save("server.json")'
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --spec server.json \
      --requests 96 --op eigh --dims 96,128,192,256

Plain torch ops (the flags alone; every flag the reference has):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --requests 32 \
      --op eigh --max-batch 4 --bucket-policy tile --tile 16

Async pipeline (up to N flushes in flight; host batching overlaps device
execution -- N=1 is the synchronous engine):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --inflight 4

Traffic-driven autotuning (capture a profile of the observed traffic, score
the serving-plan grid analytically, optionally measure the top candidates,
hot-swap the winner onto the live server before the timed pass):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --autotune analytic \
      --profile-out /tmp/traffic.json
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --autotune measured \
      --profile-in /tmp/traffic.json

Observability (span trace of the timed pass -- load in chrome://tracing or
https://ui.perfetto.dev -- plus Prometheus metrics and goodput under an
SLO; ``--jax-profile DIR``, the reference's flag name, additionally writes
a ``torch.profiler`` Chrome trace of the timed pass into DIR):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --slo-ms 50 \
      --trace-out /tmp/trace.json --metrics-out /tmp/metrics.prom

Open-loop traffic (continuous seeded arrivals through the fairness /
admission frontend instead of the closed-loop burst; requests land on
their own schedule and the report is goodput under the SLO, per tenant):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --arrivals poisson \
      --rate 200 --requests 256 --tenants "whale:0.9,mouse:0.1" \
      --scheduler wfq --admission shed --slo-ms 50

Autonomous control (the controller re-profiles a sliding telemetry
window, bandit-searches the plan grid, and hot-swaps behind hysteresis +
dwell guards -- --autotune's one-shot search, closed into a loop):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --arrivals poisson \
      --rate 200 --requests 256 --controller on --reprofile-every 1 \
      --hysteresis 0.1 --slo-ms 50

Spec files (every construction flag resolves into one frozen ServerSpec;
--spec builds from a saved JSON instead, and conflicts with any explicit
construction flag -- the error names the clash):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --spec server.json

Sharded serving (each flush's batch split across a mesh of the visible
cards by ``serving.MeshExecutor``; ``auto`` on one card is a 1-device
mesh, ``mesh(data=1; 1 shards)``):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --spec server.json \
      --mesh auto

Cold start (a replica that pre-builds its executables before the first
request -- with a warm ``--cache-dir`` it captures its CUDA graphs again
from their records, with the kernel library from the same directory, and
runs nvcc no time):
  PYTHONPATH=src python -m repro_torch.launch.serve_pca \
      --cache-dir /var/cache/pca --warmup profile.json

Smoke (``--selftest``): mixed shapes through every op against numpy, a
mesh leg (``auto``: every visible card, or the one CPU device; it prints
its executor), an async-pipeline leg (bit-for-bit
the synchronous engine), an autotune leg (the tuned plan and a mid-stream
``apply_plan`` hot-swap bit-identical to a cold server on the plan), an
observability leg, a frontend leg (a seeded open-loop run under a virtual
clock bit-identical across two invocations; WFQ bounds the starved
tenant's p99 where FIFO does not), a cold-start leg (a fresh replica warms
every key from a seeded ``--cache-dir`` and serves bit-identical results),
a spec leg and a controller leg (deterministic, dwell-guarded hot-swaps
with admission feedback).
  PYTHONPATH=src python -m repro_torch.launch.serve_pca --selftest
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.memory_model import VIRTEX_US
from ..core.pca import PCAConfig
from ..obs import TenantAccounting, device_profile, validate_trace
from ..serving import (ADMISSION_MODES, ARRIVALS, BucketPolicy,
                       CacheSpec, ControllerSpec, CostModel, ExecutionSpec,
                       LocalExecutor, ObsSpec, PCAServer, POLICIES,
                       SCHEDULERS, SchedulingSpec, ServerSpec,
                       SpecConflictError, TenantSpec, TrafficFrontend,
                       TrafficProfile, VirtualClock, autotune, build_server,
                       generate, materialize, merge, parse_tenants,
                       aot_supported, plan_grid, profile_of, resolve_spec,
                       server_for_plan)
from ..serving.autotune import synthesize


def mixed_traffic(n_req: int, op: str, dims, seed: int = 0):
    """Synthetic heterogeneous request stream (shared with the benchmark).

    Matrix construction is ``serving.autotune.synthesize`` -- the same
    generator the autotuner's profile replay uses, so CLI traffic and
    replayed traffic stay comparable by construction.
    """
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(n_req):
        n = int(dims[i % len(dims)])
        shape = (n, n) if op == "eigh" else (4 * n, n)
        mats.append(synthesize(op, shape, rng))
    return mats


def _kwarg_server(config: PCAConfig, device, **kw) -> PCAServer:
    """A server built from keyword arguments, on ``device`` -- the
    baseline the spec-built servers are held to.  The executor (the
    device) is one kwarg more than the reference passes, so the
    deprecation shim's warning for it is silenced here; the shim itself is
    checked in the spec leg."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return PCAServer(config, executor=LocalExecutor(device), **kw)


def selftest(device: DeviceLike = None) -> int:
    """Smoke: mixed shapes through every op; verify against numpy.  Every
    server runs on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    srv = _kwarg_server(PCAConfig(T=8, S=4, sweeps=14), dev,
                        policy=BucketPolicy(T=8), max_delay_s=10.0)
    mats = []
    for n in (5, 9, 12, 7, 11, 6, 10, 8):
        a = rng.standard_normal((n, n)).astype(np.float32)
        mats.append((a + a.T) / 2)
    for m, r in zip(mats, srv.solve_many(mats, op="eigh")):
        ref = np.linalg.eigh(m)[0][::-1]
        np.testing.assert_allclose(r.eigenvalues, ref, rtol=1e-3, atol=1e-3)
    svd_in = [rng.standard_normal((24, d)).astype(np.float32)
              for d in (5, 9, 7, 6)]
    for a, r in zip(svd_in, srv.solve_many(svd_in, op="svd")):
        ref = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(r.S, ref, rtol=1e-3, atol=1e-3)
    # steady state: repeated traffic must be all cache hits
    srv.stats.reset()
    srv.solve_many(mats, op="eigh")
    summary = srv.stats.summary()
    assert summary["cache_hit_rate"] == 1.0, summary
    assert summary["mean_batch"] == 4.0, summary

    # sharded leg: the same eigh traffic through a mesh over every visible
    # device must match numpy too (a MeshExecutor, over one device here
    # or there).
    # From here on, multi-kwarg servers are built through the spec API --
    # the legs double as spec-vs-kwarg parity checks, since every result
    # is compared against the kwarg-built ``srv``
    base_spec = ServerSpec(
        scheduling=SchedulingSpec(T=8, max_batch=4, max_delay_s=10.0),
        execution=ExecutionSpec(sweeps=14))
    sharded = PCAServer.from_spec(dataclasses.replace(
        base_spec, execution=ExecutionSpec(mesh="auto", sweeps=14)),
        device=dev)
    ex = sharded.executor
    for m, r in zip(mats, sharded.solve_many(mats, op="eigh")):
        ref = np.linalg.eigh(m)[0][::-1]
        np.testing.assert_allclose(r.eigenvalues, ref, rtol=1e-3, atol=1e-3)
    shards = {r.n_shards for r in sharded.stats.records}
    assert shards == {ex.n_shards}, shards

    # async-pipeline leg: the same mixed burst (both ops, two buckets)
    # through a deep pipeline must match the synchronous engine
    # *bit-for-bit* -- the pipeline only reorders work, it runs the
    # identical cached executables on identical slabs -- while the depth
    # telemetry proves flushes really were in flight together
    pipelined = PCAServer.from_spec(dataclasses.replace(
        base_spec, scheduling=dataclasses.replace(base_spec.scheduling,
                                                  max_inflight=4)),
        device=dev)
    for op, traffic in (("eigh", mats), ("svd", svd_in)):
        got = pipelined.solve_many(traffic, op=op)
        want = srv.solve_many(traffic, op=op)
        for g, w in zip(got, want):
            for field in (f.name for f in dataclasses.fields(g)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, field)),
                    np.asarray(getattr(w, field)),
                    err_msg=f"sync-vs-async {op}.{field}")
    async_summary = pipelined.stats.summary()
    assert async_summary["max_inflight_depth"] > 1, async_summary
    assert pipelined.inflight() == 0

    # autotune leg: capture a profile of the live traffic, tune over the
    # scheduling axes (max_batch / max_inflight; bucketing pinned to the
    # default policy, under which batching and pipelining provably do not
    # change the math), and require the tuned plan to serve the identical
    # burst *bit-for-bit* equal to the default plan.  Then the hot-swap
    # parity: a server that switches onto the plan mid-stream via
    # ``apply_plan`` must match a cold server built with the plan
    # bit-for-bit too (same executables, same slabs), with the switch
    # visible in telemetry.  The profile must survive its JSON round trip
    # exactly -- that is the capture-once / replay-in-CI contract.
    cfg = PCAConfig(T=8, S=4, sweeps=14)
    profile = TrafficProfile.from_stats(srv.stats,
                                        captured=srv.describe_plan())
    assert TrafficProfile.from_json(profile.to_json()) == profile
    sched_grid = plan_grid(modes=("tile",), tiles=(8,),
                           batches=(1, 2, 4, 8), inflights=(1, 2, 4))
    tuned = autotune(profile, grid=sched_grid, config=cfg).best
    default_results = srv.solve_many(mats, op="eigh")
    cold = server_for_plan(tuned, cfg, device=dev)
    hot = _kwarg_server(cfg, dev, policy=BucketPolicy(T=8), max_delay_s=10.0)
    early = [hot.submit(m) for m in mats[:3]]   # queued across the swap
    hot.apply_plan(tuned)                       # re-buckets them in place
    for results in (cold.solve_many(mats, op="eigh"),
                    hot.solve_many(mats, op="eigh")):
        for g, w in zip(results, default_results):
            for field in (f.name for f in dataclasses.fields(g)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, field)),
                    np.asarray(getattr(w, field)),
                    err_msg=f"tuned-vs-default eigh.{field}")
    # the tickets that crossed the swap retired under the new plan with
    # the same bits the default plan would have produced
    for t, w in zip(early, default_results):
        assert t.done
        np.testing.assert_array_equal(t.result().eigenvalues,
                                      w.eigenvalues)
    assert len(hot.stats.plan_switches) == 1, hot.stats.plan_switches
    assert hot.stats.summary()["plan_switches"] == 1

    # observability leg: the same mixed burst through a fully traced
    # server must be *bitwise identical* to the untraced one (tracing
    # samples clocks and appends to rings -- it must never touch the
    # math), the exported trace must pass the Chrome-schema validator
    # with every request span parented to a flush span, and the metric
    # export must carry the per-(op, bucket, backend) latency series
    traced = PCAServer.from_spec(dataclasses.replace(
        base_spec,
        scheduling=dataclasses.replace(base_spec.scheduling,
                                       max_inflight=2),
        obs=ObsSpec(slo_ms=1000.0)), device=dev)
    obs = traced.obs
    for op, traffic in (("eigh", mats), ("svd", svd_in)):
        got = traced.solve_many(traffic, op=op)
        want = srv.solve_many(traffic, op=op)
        for g, w in zip(got, want):
            for field in (f.name for f in dataclasses.fields(g)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, field)),
                    np.asarray(getattr(w, field)),
                    err_msg=f"traced-vs-untraced {op}.{field}")
    trace = obs.trace_doc()
    errors = validate_trace(trace)
    assert not errors, errors
    by_id = {e["id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and isinstance(e.get("id"), int)}
    requests = [e for e in trace["traceEvents"]
                if e.get("ph") == "X" and e["name"].startswith("request:")]
    assert len(requests) == len(mats) + len(svd_in), len(requests)
    for e in requests:
        parent = by_id[e["args"]["parent"]]
        assert parent["name"].startswith("flush:"), parent["name"]
    prom = obs.prometheus_text()
    assert "serve_request_latency_seconds_bucket" in prom, prom[:400]
    assert 'op="eigh"' in prom and 'op="svd"' in prom
    slo = obs.summary()["slo"]
    assert slo["requests"] == len(mats) + len(svd_in), slo

    # cold-start leg: seed a persistent --cache-dir with one replica's
    # executables, then a *fresh* replica pointed at the same directory
    # must warm up entirely from disk (every warmup key a disk hit, zero
    # compiles) and serve the identical burst *bit-for-bit* equal to the
    # cold replica -- capturing a graph again from its record must never
    # touch the math
    cold_info = {"skipped": True}
    if aot_supported():
        import tempfile
        seed_profile = TrafficProfile.from_shapes(
            [("eigh", m.shape, 1) for m in mats]
            + [("svd", a.shape, 1) for a in svd_in])
        with tempfile.TemporaryDirectory() as cdir:
            cache_spec = dataclasses.replace(
                base_spec, cache=CacheSpec(cache_dir=cdir))
            seeder = PCAServer.from_spec(cache_spec, device=dev)
            seeded = seeder.warmup(seed_profile)
            assert seeded["compile"] == seeded["executables"], seeded
            stores = seeder.cache_summary()["disk"]["stores"]
            assert stores == seeded["executables"], seeder.cache_summary()
            warm = PCAServer.from_spec(cache_spec, device=dev)
            warmed = warm.warmup(seed_profile)
            assert warmed["disk"] == warmed["executables"], warmed
            assert warmed["compile"] == 0, warmed
            for op, traffic in (("eigh", mats), ("svd", svd_in)):
                got = warm.solve_many(traffic, op=op)
                want = srv.solve_many(traffic, op=op)
                for g, w in zip(got, want):
                    for field in (f.name for f in dataclasses.fields(g)):
                        np.testing.assert_array_equal(
                            np.asarray(getattr(g, field)),
                            np.asarray(getattr(w, field)),
                            err_msg=f"warm-vs-cold {op}.{field}")
            warm_summary = warm.stats.summary()
            assert warm_summary["cache_hit_rate"] == 1.0, warm_summary
            cold_info = {"skipped": False,
                         "executables": warmed["executables"],
                         "disk_hits": warmed["disk"],
                         "warmup_s": round(warmed["seconds"], 4)}

    # frontend leg: the open-loop path must be *reproducible* -- a seeded
    # arrival stream through admission + WFQ under a virtual clock gives
    # the same admitted/shed split and the same result bytes on every
    # invocation -- and *fair*: with a whale saturating the server, WFQ
    # keeps the mouse's p99 bounded (its queue drains at its weight share)
    # while FIFO parks the mouse behind the whale's whole backlog
    whale = TenantSpec("whale")
    mouse = TenantSpec("mouse", slo_ms=30.0)
    stream = merge(
        generate("poisson", rate=240.0, n=120, tenants=(whale,), seed=3,
                 trace="uniform", lo=24, hi=40),
        generate("poisson", rate=30.0, n=15, tenants=(mouse,), seed=11,
                 trace="uniform", lo=8, hi=12))
    fe_model = CostModel(device_work_per_s=2e6)   # modeled slow device
    open_spec = ServerSpec(
        scheduling=SchedulingSpec(T=16, max_batch=8, max_delay_s=0.02),
        execution=ExecutionSpec(sweeps=6))

    def open_loop(scheduler, admission):
        fsrv = build_server(open_spec, clock=VirtualClock(), device=dev)
        fe = TrafficFrontend(fsrv, (whale, mouse), slo_ms=100.0,
                             scheduler=scheduler, admission=admission,
                             model=fe_model, seed=1)
        return fe.run(stream, pace=False)

    rep_a, rep_b = open_loop("wfq", "shed"), open_loop("wfq", "shed")
    assert rep_a.digest == rep_b.digest, "open-loop run not deterministic"
    assert rep_a.outcomes == rep_b.outcomes
    assert rep_a.shed > 0 and rep_a.served > 0, rep_a.to_json()
    assert (rep_a.served + rep_a.degraded + rep_a.shed + rep_a.throttled
            == rep_a.requests == len(stream))
    wfq_rep, fifo_rep = open_loop("wfq", "none"), open_loop("fifo", "none")
    wfq_p99 = wfq_rep.per_tenant["mouse"]["latency_p99_ms"]
    fifo_p99 = fifo_rep.per_tenant["mouse"]["latency_p99_ms"]
    assert wfq_p99 < 0.5 * fifo_p99, \
        f"WFQ did not bound the starved tenant: {wfq_p99} vs {fifo_p99}"

    # spec leg: the frozen ServerSpec must survive its JSON round trip
    # exactly, a spec-built server must serve the burst bit-identical to
    # the kwarg-built one (several legs above already ran on from_spec
    # servers against ``srv``), and legacy multi-kwarg construction must
    # point at the spec API with a DeprecationWarning
    spec_rt = dataclasses.replace(base_spec, controller=ControllerSpec(
        enabled=True, window_s=1.0, reprofile_every_s=0.25,
        hysteresis=0.02, min_dwell_s=0.5))
    assert ServerSpec.from_json(spec_rt.to_json()) == spec_rt
    spec_srv = PCAServer.from_spec(base_spec, device=dev)
    for g, w in zip(spec_srv.solve_many(mats, op="eigh"),
                    srv.solve_many(mats, op="eigh")):
        for field in (f.name for f in dataclasses.fields(g)):
            np.testing.assert_array_equal(
                np.asarray(getattr(g, field)), np.asarray(getattr(w, field)),
                err_msg=f"spec-vs-kwarg eigh.{field}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        PCAServer(PCAConfig(T=8, S=4, sweeps=14), policy=BucketPolicy(T=8),
                  max_delay_s=10.0, max_inflight=2,
                  executor=LocalExecutor(dev))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught), \
        "multi-kwarg PCAServer construction must DeprecationWarn"

    # controller leg: a regime shift (small interactive traffic, then a
    # flood of large refits) under a virtual clock.  The controller must
    # be bit-deterministic across invocations (same swaps at the same
    # virtual times, same result digest), actually adapt (>= 1 hot-swap),
    # respect the dwell guard between swaps, and push the recalibrated
    # cost model into the frontend's admission controller
    ctrl_spec = ServerSpec(
        scheduling=SchedulingSpec(T=16, max_batch=4, max_delay_s=0.02),
        execution=ExecutionSpec(sweeps=6),
        controller=ControllerSpec(enabled=True, window_s=1.0,
                                  reprofile_every_s=0.25, hysteresis=0.02,
                                  min_dwell_s=0.5))
    shift_stream = merge(
        generate("poisson", rate=80.0, n=80, tenants=(whale,), seed=5,
                 trace="uniform", lo=8, hi=12),
        [dataclasses.replace(a, t=a.t + 1.5) for a in
         generate("poisson", rate=300.0, n=150, tenants=(whale,), seed=9,
                  trace="uniform", lo=28, hi=44)])

    def controlled_run():
        csrv = build_server(ctrl_spec, clock=VirtualClock(), device=dev)
        fe = TrafficFrontend(csrv, (whale,), slo_ms=200.0,
                             admission="none", model=fe_model, seed=1)
        csrv.controller.frontend = fe
        rep = fe.run(shift_stream, pace=False)
        return csrv, fe, rep

    csrv_a, cfe_a, crep_a = controlled_run()
    csrv_b, _, crep_b = controlled_run()
    ctrl = csrv_a.controller
    assert crep_a.digest == crep_b.digest, "controller run not deterministic"
    assert ([round(s["t"], 9) for s in ctrl.swaps]
            == [round(s["t"], 9) for s in csrv_b.controller.swaps])
    assert len(ctrl.swaps) >= 1, ctrl.summary()
    for s1, s2 in zip(ctrl.swaps, ctrl.swaps[1:]):
        assert s2["t"] - s1["t"] >= ctrl.min_dwell_s - 1e-9, ctrl.swaps
    assert cfe_a.model is not fe_model, \
        "swap did not feed the recalibrated cost model back to admission"

    print("serve_pca selftest ok:",
          json.dumps({k: round(v, 4) for k, v in summary.items()}))
    print("serve_pca sharded selftest ok:", json.dumps({
        "executor": ex.describe(), "n_shards": ex.n_shards}))
    print("serve_pca async selftest ok:", json.dumps({
        "max_inflight_depth": async_summary["max_inflight_depth"],
        "overlap_frac": round(async_summary["overlap_frac"], 4)}))
    print("serve_pca autotune selftest ok:", json.dumps({
        "tuned_plan": tuned.describe(),
        "profile_requests": profile.requests,
        "hot_swap_requeued": hot.stats.plan_switches[0]["requeued"]}))
    print("serve_pca obs selftest ok:", json.dumps({
        "spans": len(obs.tracer),
        "trace_events": len(trace["traceEvents"]),
        "request_spans": len(requests),
        "goodput_rps": round(slo["goodput_rps"], 2)}))
    print("serve_pca cold-start selftest ok:", json.dumps(cold_info))
    print("serve_pca frontend selftest ok:", json.dumps({
        "requests": rep_a.requests, "served": rep_a.served,
        "shed": rep_a.shed, "digest": rep_a.digest[:12],
        "mouse_p99_ms": {"wfq": round(wfq_p99, 1),
                         "fifo": round(fifo_p99, 1)}}))
    print("serve_pca spec selftest ok:", json.dumps({
        "round_trip": True, "parity": True, "deprecation_warns": True}))
    print("serve_pca controller selftest ok:", json.dumps({
        "ticks": ctrl.ticks, "swaps": len(ctrl.swaps),
        "first_swap_t": round(ctrl.swaps[0]["t"], 3),
        "plan": ctrl.swaps[-1]["plan"], "digest": crep_a.digest[:12]}))
    return 0


def open_loop_run(args, srv, obs, dims, spec) -> int:
    """Open-loop mode: seeded paced arrivals through the traffic frontend
    (fairness + admission) instead of the closed-loop burst."""
    tenants = parse_tenants(args.tenants)
    stream = generate(args.arrivals, rate=args.rate, n=args.requests,
                      tenants=tenants, seed=args.seed, trace="uniform",
                      op=args.op, lo=min(dims), hi=max(dims))
    # the offered-load profile of this exact stream -- arrival rate
    # included, so plan_grid scores candidates against real load pressure
    profile = profile_of(stream)
    if args.profile_out:
        profile.save(args.profile_out)
    # warm every bucket the stream will touch, then calibrate the
    # admission model from that pass's telemetry: service predictions
    # come from the hardware they will gate
    seen, sample = set(), []
    for a in stream:
        if a.shape not in seen:
            seen.add(a.shape)
            sample.append(materialize(a, seed=args.seed))
    srv.solve_many(sample * max(1, args.max_batch), op=args.op)
    model = CostModel.calibrated(TrafficProfile.from_stats(srv.stats))
    srv.stats.reset()
    accounting = None
    if obs is not None:
        accounting = TenantAccounting(obs.metrics, clock=obs.clock)
        obs.tracer.clear()
        if obs.slo is not None:
            obs.slo.reset()
    fe = TrafficFrontend(srv, tenants, slo_ms=spec.obs.slo_ms,
                         scheduler=args.scheduler, admission=args.admission,
                         model=model, degrade_frac=args.degrade_frac,
                         accounting=accounting, seed=args.seed)
    if srv.controller is not None:
        # the controller's admission feedback path: after a swap, this
        # frontend's cost model is recalibrated to the new plan
        srv.controller.frontend = fe
    rep = fe.run(stream, pace=True)
    obs_info = None
    if obs is not None:
        accounting.summary(span_s=rep.duration_s)  # refresh goodput gauges
        obs_info = obs.summary()
        if spec.obs.trace_out:
            obs_info["trace_out"] = str(obs.save_trace(spec.obs.trace_out))
        if spec.obs.metrics_out:
            obs_info["metrics_out"] = str(
                obs.save_metrics(spec.obs.metrics_out))
    print(json.dumps({
        "op": args.op,
        "arrivals": args.arrivals,
        "rate_rps": args.rate,
        "tenants": [dataclasses.asdict(t) for t in tenants],
        "scheduler": args.scheduler,
        "admission": args.admission,
        "slo_ms": spec.obs.slo_ms,
        "plan": srv.describe_plan(),
        "controller": (srv.controller.summary()
                       if srv.controller is not None else None),
        "profile": {"requests": profile.requests,
                    "arrival_rate": profile.arrival_rate,
                    "duration_s": profile.duration_s},
        "frontend": rep.to_json(),
        "obs": obs_info,
    }, indent=2))
    return 0


def main(argv=None, device: DeviceLike = None) -> int:
    """The CLI.  ``device`` places the server (default ``cuda``, raising on
    a host without a card); it is a keyword for Python callers, not a
    flag, so the flag set stays the reference's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="eigh", choices=("eigh", "svd", "pca"))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--dims", default="10,14,18,24,29,31",
                    help="comma-separated feature dims of the mixed traffic")
    ap.add_argument("--tile", type=int, default=16,
                    help="bucket tile size (paper T)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="microbatch size (paper S)")
    ap.add_argument("--bucket-policy", default="tile", choices=POLICIES)
    ap.add_argument("--mesh", default="none",
                    help="shard each flush's batch axis across a device "
                         "mesh: 'none' (single device, default), 'auto' "
                         "(every visible device), or an integer N (first N "
                         "devices; clamps to what is visible)")
    ap.add_argument("--inflight", type=int, default=1,
                    help="pipeline depth: how many dispatched flushes may "
                         "be in flight at once, counting the one being "
                         "dispatched.  1 (default) is the synchronous "
                         "engine; N>1 overlaps host-side batching with "
                         "device execution (launches queue on the CUDA "
                         "stream without blocking the host), "
                         "back-pressuring by retiring the oldest flush")
    ap.add_argument("--timeout-ms", type=float, default=10.0,
                    help="flush deadline per queued request")
    ap.add_argument("--sweeps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--autotune", default="off",
                    choices=("off", "analytic", "measured"),
                    help="pick the serving plan from observed traffic "
                         "instead of the CLI flags: 'analytic' scores the "
                         "plan grid with the calibrated cost model; "
                         "'measured' additionally replays the profile "
                         "against live servers for the analytic top-K and "
                         "keeps the measured best.  The winner is "
                         "hot-swapped onto the server (apply_plan) before "
                         "the timed pass")
    ap.add_argument("--measure-top-k", type=int, default=3,
                    help="how many analytic-best plans the 'measured' "
                         "mode replays")
    ap.add_argument("--profile-in", default=None,
                    help="tune against a previously captured traffic "
                         "profile JSON instead of profiling this run")
    ap.add_argument("--profile-out", default=None,
                    help="write the captured traffic profile JSON here "
                         "(capture once, replay in CI)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the timed "
                         "pass here (load in chrome://tracing or "
                         "https://ui.perfetto.dev); implies tracing on")
    ap.add_argument("--metrics-out", default=None,
                    help="write the Prometheus text exposition of the "
                         "serving metrics here; implies metrics on")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO target: report goodput (requests/s "
                         "served within the target) and miss counts next "
                         "to raw throughput; implies observability on")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent executable-cache directory: each "
                         "solver's CUDA graph record and the kernel "
                         "library are written here, so a restarted (or "
                         "newly scaled-out) replica warms from disk with "
                         "no nvcc run instead of building on its first "
                         "requests")
    ap.add_argument("--warmup", default=None, metavar="PROFILE",
                    help="pre-build every solver this traffic-profile "
                         "JSON (--profile-out format) implies, before any "
                         "request is accepted; pairs with --cache-dir so "
                         "the warmup is a disk load on every replica after "
                         "the first")
    ap.add_argument("--arrivals", default=None, choices=ARRIVALS,
                    help="open-loop mode: drive the server with this "
                         "seeded arrival process (continuous paced "
                         "traffic through the fairness/admission "
                         "frontend) instead of the closed-loop burst; "
                         "reports goodput under --slo-ms per tenant")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="open-loop mean offered load, requests/s")
    ap.add_argument("--tenants", default="t0",
                    help="tenant spec, comma-separated "
                         "name[:share[:weight]][:p] -- e.g. "
                         "'whale:0.9,mouse:0.1' or 'rt:0.2:1:p,batch:0.8'")
    ap.add_argument("--scheduler", default="wfq", choices=SCHEDULERS,
                    help="cross-tenant scheduling discipline ahead of "
                         "the engine (wfq: weighted virtual-finish-time "
                         "fairness; fifo: arrival order)")
    ap.add_argument("--admission", default="shed", choices=ADMISSION_MODES,
                    help="deadline-feasibility policy at ingress: none "
                         "(queue unboundedly), shed (reject infeasible "
                         "requests), degrade (retry the feasibility "
                         "check at --degrade-frac sweeps first)")
    ap.add_argument("--degrade-frac", type=float, default=0.5,
                    help="sweeps fraction of the degraded variant")
    ap.add_argument("--jax-profile", default=None,
                    help="directory for a torch.profiler trace of the "
                         "timed pass (a Chrome trace JSON with the CPU "
                         "and, on a card, the CUDA kernels; Perfetto-"
                         "loadable).  The reference's flag name, kept so "
                         "command lines and spec files carry over")
    ap.add_argument("--spec", default=None, metavar="JSON",
                    help="build the server from a ServerSpec JSON file "
                         "(ServerSpec.to_json / `serve_pca ... --spec-out`-"
                         "less: write one with serving.ServerSpec.save). "
                         "Mutually exclusive with every construction flag "
                         "the spec owns -- conflicts error with the flag "
                         "and the spec fact named")
    ap.add_argument("--controller", default="off", choices=("off", "on"),
                    help="run the autonomous serving controller: "
                         "re-profile a sliding telemetry window every "
                         "--reprofile-every seconds, bandit-search the "
                         "plan grid, and hot-swap when the predicted gain "
                         "clears --hysteresis (anti-thrash: --min-dwell). "
                         "Owns plan search, so conflicts with --autotune")
    ap.add_argument("--profile-window", type=float, default=5.0,
                    help="controller: sliding re-profile window, seconds "
                         "of trailing traffic")
    ap.add_argument("--reprofile-every", type=float, default=1.0,
                    help="controller: tick cadence on the engine clock")
    ap.add_argument("--hysteresis", type=float, default=0.15,
                    help="controller: minimum predicted fractional gain "
                         "before a hot-swap is applied")
    ap.add_argument("--min-dwell", type=float, default=2.0,
                    help="controller: minimum seconds between swaps")
    ap.add_argument("--selftest", action="store_true",
                    help="run the smoke and exit")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(device)

    # every construction flag resolves through the spec layer: one frozen
    # ServerSpec is the single source of truth, whether it came from the
    # flags or a --spec file, and conflicting flag combinations error here
    # with the clash named instead of last-write-winning
    try:
        spec = resolve_spec(args, vars(ap.parse_args([])))
    except SpecConflictError as e:
        print(f"serve_pca: {e}", file=sys.stderr)
        return 2
    dims = [int(d) for d in args.dims.split(",")]
    srv = build_server(spec, device=device)
    obs, config, executor = srv.obs, srv.config, srv.executor
    if args.arrivals:
        return open_loop_run(args, srv, obs, dims, spec)
    warmup_info = None
    if spec.cache.warmup_profile:
        # pre-build the profile's solvers before the first request --
        # with a warm --cache-dir each is a disk load, not a build
        warmup_info = srv.warmup(
            TrafficProfile.load(spec.cache.warmup_profile))
    mats = mixed_traffic(args.requests, args.op, dims, args.seed)
    srv.solve_many(mats, op=args.op)       # warmup: build the buckets
    # the warmup pass doubles as the profiling pass: its telemetry is the
    # traffic profile the autotuner scores plans against.  --profile-out
    # always writes *this run's* captured profile, even when the tuner is
    # fed a replayed one via --profile-in
    captured = TrafficProfile.from_stats(srv.stats,
                                         captured=srv.describe_plan())
    if args.profile_out:
        captured.save(args.profile_out)
    profile = (TrafficProfile.load(args.profile_in) if args.profile_in
               else captured)
    tune_info = None
    if args.autotune != "off":
        # the CLI's mesh choice joins the executor axis of the grid, so a
        # requested mesh is kept unless the tuner finds single-device
        # genuinely better -- never silently dropped
        mesh = spec.execution.mesh
        meshes = ("none",) if mesh in ("none", "local") else ("none", mesh)
        result = autotune(
            profile, grid=plan_grid(meshes=meshes), config=config,
            measure_top_k=(args.measure_top_k
                           if args.autotune == "measured" else 0),
            seed=args.seed, obs=obs, device=executor.device)
        # the swap pre-warms the tuned plan's executables from the profile
        # before any ticket is re-bucketed onto them
        srv.apply_plan(result.best, warm_profile=profile)
        srv.solve_many(mats, op=args.op)   # re-warmup under the tuned plan
        tune_info = result.to_json()
    srv.stats.reset()
    if obs is not None:
        # the exported trace/metrics cover the timed pass only, not the
        # warmup/profiling passes (steady-state is what the artifacts mean)
        obs.tracer.clear()
        if obs.slo is not None:
            obs.slo.reset()
    with device_profile(spec.obs.jax_profile):
        srv.solve_many(mats, op=args.op)
    summary = srv.stats.summary()
    pvm = srv.stats.predicted_vs_measured(VIRTEX_US)
    ratios = [r["ratio"] for r in pvm if np.isfinite(r["ratio"])]
    obs_info = None
    if obs is not None:
        obs_info = obs.summary()
        if spec.obs.trace_out:
            obs_info["trace_out"] = str(obs.save_trace(spec.obs.trace_out))
        if spec.obs.metrics_out:
            obs_info["metrics_out"] = str(
                obs.save_metrics(spec.obs.metrics_out))
    print(json.dumps({
        "op": args.op,
        "spec": json.loads(spec.to_json()),
        "plan": srv.describe_plan(),
        "autotune": tune_info,
        "controller": (srv.controller.summary()
                       if srv.controller is not None else None),
        "warmup": warmup_info,
        "cache": srv.cache_summary(),
        "obs": obs_info,
        "summary": summary,
        "fabric_model": {
            "reference": "MANOJAVAM(16,32)@Virtex-US+",
            "median_measured_over_predicted":
                float(np.median(ratios)) if ratios else None,
        },
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
