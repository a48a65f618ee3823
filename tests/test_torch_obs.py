"""The port's observability stack (``repro_torch.obs``) against the
reference's (``repro.obs``).

Two groups:

  * the reference's own tests (``tests/test_obs.py``: span tracing, the
    metric registry, SLO accounting and the serving integration; its
    ``slow`` overhead gate stays out) as one body each, run once per
    package -- the port's servers on the CPU;
  * cross-package checks: the same recorded series give the same
    Prometheus text, snapshot and JSON in both packages; a trace the
    port's server exports passes the reference's ``validate_trace`` (and
    the other way round); the port's one spelling change (``fmt_label``
    of ``None``); ``device_profile`` as a ``torch.profiler`` run.
"""
import dataclasses
import json

import numpy as np
import pytest

from _control_pkgs import NAMES, PKGS

# kwarg-built servers trip the deprecation shim by design (the port's
# executor is one kwarg more); the shim has its own tests
pytestmark = pytest.mark.filterwarnings(
    "ignore:PCAServer\\(\\.\\.\\.\\) with:DeprecationWarning")


@pytest.fixture(params=NAMES)
def P(request):
    return PKGS[request.param]


class ManualClock:
    """Injectable monotonic clock driven by the test."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _sym(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


# ---------------------------------------------------------------------------
# tracing (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_span_lifecycle_and_parentage(P):
    clock = ManualClock()
    tr = P.obs.Tracer(clock=clock)
    parent = tr.begin("flush", cat="flush", track="flushes", op="eigh")
    clock.advance(0.5)
    child = tr.begin("wait", track="flushes", parent=parent.id)
    clock.advance(0.25)
    child.end()
    parent.end()
    assert len(tr) == 2
    by_name = {s.name: s for s in tr.spans}
    assert by_name["wait"].parent == by_name["flush"].id
    assert by_name["flush"].ts == 0.0
    assert by_name["flush"].dur == pytest.approx(0.75)
    assert by_name["wait"].ts == pytest.approx(0.5)
    assert dict(by_name["flush"].args)["op"] == "eigh"
    assert parent.end() is None
    assert len(tr) == 2


def test_complete_and_reserved_ids(P):
    tr = P.obs.Tracer(clock=ManualClock())
    fid = tr.new_id()
    tr.complete("compile", ts=0.0, end=0.1, parent=fid, track="flushes")
    tr.complete("flush", ts=0.0, end=1.0, id=fid, track="flushes")
    doc = tr.export()
    assert P.obs.validate_trace(doc) == []
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    compile_ev = next(e for e in xs if e["name"] == "compile")
    assert compile_ev["args"]["parent"] == fid


def test_ring_buffer_bounds_and_dropped_counter(P):
    tr = P.obs.Tracer(capacity=8, clock=ManualClock())
    for i in range(20):
        tr.complete(f"s{i}", ts=float(i), end=float(i) + 0.5)
    assert len(tr) == 8
    assert tr.dropped == 12
    assert [s.name for s in tr.spans] == [f"s{i}" for i in range(12, 20)]
    assert tr.export()["otherData"]["dropped"] == 12
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_disabled_tracer_is_noop(P):
    tr = P.obs.Tracer(enabled=False, clock=ManualClock())
    assert tr.begin("x").end() is None
    assert tr.complete("y", ts=0.0, end=1.0) is None
    assert tr.instant("z") is None
    assert len(tr) == 0


def test_export_lane_allocation_for_overlapping_roots(P):
    tr = P.obs.Tracer(clock=ManualClock())
    a = tr.complete("a", ts=0.0, end=2.0, track="flushes")
    tr.complete("b", ts=1.0, end=3.0, track="flushes")
    tr.complete("c", ts=4.0, end=5.0, track="flushes")
    tr.complete("a.child", ts=0.5, end=1.5, track="flushes", parent=a.id)
    doc = tr.export()
    assert P.obs.validate_trace(doc) == []
    tid = {e["name"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tid["a"] != tid["b"]
    assert tid["c"] == tid["a"]
    assert tid["a.child"] == tid["a"]


def test_validate_trace_catches_violations(P):
    validate = P.obs.validate_trace
    ok = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 5, "pid": 0, "tid": 1}]}
    assert validate(ok) == []
    assert validate({"traceEvents": []})
    assert any("missing required key" in e for e in validate(
        {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0}]}))
    assert any("non-decreasing" in e for e in validate(
        {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 5, "dur": 1, "pid": 0, "tid": 1},
            {"name": "b", "ph": "X", "ts": 1, "dur": 1, "pid": 0, "tid": 1},
        ]}))
    assert any("dur" in e for e in validate(
        {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 1}]}))
    assert any("unmatched B" in e for e in validate(
        {"traceEvents": [
            {"name": "a", "ph": "B", "ts": 0, "pid": 0, "tid": 1}]}))
    assert any("not in trace" in e for e in validate(
        {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "dur": 1, "pid": 0, "tid": 1,
             "id": 7, "args": {"parent": 99}}]}))
    assert any("after its parent" in e for e in validate(
        {"traceEvents": [
            {"name": "p", "ph": "X", "ts": 0, "dur": 5, "pid": 0, "tid": 1,
             "id": 1},
            {"name": "c", "ph": "X", "ts": 0, "dur": 50, "pid": 0, "tid": 2,
             "id": 2, "args": {"parent": 1}}]}))


def test_trace_save_roundtrip(P, tmp_path):
    tr = P.obs.Tracer(clock=ManualClock())
    tr.complete("a", ts=0.0, end=1.0)
    path = tr.save(tmp_path / "trace.json")
    doc = json.loads(path.read_text())
    assert P.obs.validate_trace(doc) == []
    assert doc["displayTimeUnit"] == "ms"
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= names


# ---------------------------------------------------------------------------
# metrics (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_histogram_percentiles_vs_numpy(P):
    clock = ManualClock()
    reg = P.obs.MetricRegistry(clock=clock)
    child = reg.histogram("lat_seconds", "x", ("op",)).labels(op="eigh")
    vals = np.random.default_rng(0).gamma(2.0, 0.005, size=4000)
    for v in vals:
        child.observe(float(v), now=clock.advance(1e-4))
    uppers = list(child.uppers)
    for p in (50, 90, 99):
        got = child.percentile(p)
        want = float(np.percentile(vals, p))
        i = next(i for i, hi in enumerate(uppers) if want <= hi)
        lo = uppers[i - 1] if i else 0.0
        assert lo - 1e-12 <= got <= uppers[i] + 1e-12, (p, got, want)


def test_histogram_quantile_edges(P):
    q = P.obs.histogram_quantile
    assert np.isnan(q(0.5, (1.0, 2.0), [0, 0, 0]))
    assert q(0.5, (1.0, 2.0), [0, 0, 10]) == 2.0
    assert q(0.5, (1.0, 2.0), [0, 10, 0]) == pytest.approx(1.5)


def _golden_registry(P):
    reg = P.obs.MetricRegistry(clock=ManualClock())
    reg.counter("req_total", "Requests.", ("op",)).labels(op="eigh").inc(
        3, now=1.0)
    reg.gauge("depth", "Depth.").labels().set(2, now=1.0)
    c = reg.histogram("lat", "Latency.", ("op",),
                      buckets=(0.1, 1.0)).labels(op="eigh")
    c.observe(0.05, now=1.0)
    c.observe(0.5, now=2.0)
    c.observe(5.0, now=3.0)
    return reg


def test_prometheus_golden_output(P):
    assert _golden_registry(P).to_prometheus() == """\
# HELP depth Depth.
# TYPE depth gauge
depth 2
# HELP lat Latency.
# TYPE lat histogram
lat_bucket{op="eigh",le="0.1"} 1
lat_bucket{op="eigh",le="1"} 2
lat_bucket{op="eigh",le="+Inf"} 3
lat_sum{op="eigh"} 5.55
lat_count{op="eigh"} 3
# HELP req_total Requests.
# TYPE req_total counter
req_total{op="eigh"} 3
"""


def test_windowed_snapshot_under_injected_clock(P):
    clock = ManualClock()
    reg = P.obs.MetricRegistry(clock=clock)
    ctr = reg.counter("req_total", labels=("op",)).labels(op="eigh")
    h = reg.histogram("lat", labels=()).labels()
    for i in range(10):
        clock.t = float(i)
        ctr.inc()
        h.observe(1e-3)
    for i in range(5):
        clock.t = 100.0 + i
        ctr.inc()
        h.observe(0.1)
    clock.t = 105.0
    snap = reg.snapshot(window_s=10.0)
    c = snap["series"]["req_total"]["children"]["eigh"]
    assert c["total"] == 15 and c["delta"] == 5
    assert c["rate_per_s"] == pytest.approx(0.5)
    hs = snap["series"]["lat"]["children"][""]
    assert hs["count"] == 5 and hs["lifetime_count"] == 15
    assert hs["p50"] > 5e-2
    assert reg.snapshot()["series"]["lat"]["children"][""]["count"] == 15
    assert h.percentile(50, window_s=10.0) > 5e-2
    assert h.percentile(50) < 5e-2


def test_registry_family_idempotence_and_mismatch(P):
    reg = P.obs.MetricRegistry(clock=ManualClock())
    a = reg.counter("x_total", "x", ("op",))
    assert reg.counter("x_total", "x", ("op",)) is a
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total", "x", ("op",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("x_total", "x", ("op", "bucket"))
    reg.histogram("h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("h", buckets=(1.0, 5.0))
    with pytest.raises(ValueError, match="expected labels"):
        a.labels("eigh", "extra")


def test_to_json_is_nan_free(P):
    reg = P.obs.MetricRegistry(clock=ManualClock())
    reg.histogram("empty", labels=()).labels()
    doc = reg.to_json()
    assert doc["series"]["empty"]["children"][""]["p50"] is None
    json.dumps(doc)


# ---------------------------------------------------------------------------
# SLO accounting (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_slo_goodput_on_crafted_burst(P):
    clock = ManualClock()
    reg = P.obs.MetricRegistry(clock=clock)
    slo = P.obs.SLOTracker(slo_s=0.05, registry=reg, clock=clock)
    for i in range(10):
        lat = 0.01 if i % 2 == 0 else 0.2
        t_done = float(i + 1)
        slo.observe(op="eigh", latency_s=lat, t_done=t_done,
                    t_submit=t_done - 1.0 if i == 0 else None,
                    deadline=t_done + (1.0 if i < 8 else -1.0))
    s = slo.summary()
    assert s["requests"] == 10 and s["compliant"] == 5
    assert s["slo_miss_count"] == 5 and s["slo_miss_frac"] == 0.5
    assert s["deadline_miss_count"] == 2
    assert s["goodput_rps"] == pytest.approx(0.5)
    assert s["throughput_rps"] == pytest.approx(1.0)
    prom = reg.to_prometheus()
    assert 'slo_requests_total{op="eigh"} 10' in prom
    assert 'slo_miss_total{op="eigh"} 5' in prom
    assert 'deadline_miss_total{op="eigh"} 2' in prom
    clock.t = 11.0
    w = slo.summary(window_s=3.0)
    assert w["requests"] == 3
    assert w["goodput_rps"] == pytest.approx(w["compliant"] / 3.0)


def test_slo_none_means_throughput_equals_goodput(P):
    slo = P.obs.SLOTracker(slo_s=None, clock=ManualClock())
    for i in range(4):
        slo.observe(op="svd", latency_s=10.0, t_done=float(i + 1))
    s = slo.summary()
    assert s["slo_miss_count"] == 0
    assert s["goodput_rps"] == s["throughput_rps"]
    with pytest.raises(ValueError):
        P.obs.SLOTracker(slo_s=-1.0)


def test_slo_from_records_offline(P):
    recs = [
        P.stats.RequestRecord(
            rid=i, op="eigh", shape=(8, 8), bucket=(8, 8), batch_size=4,
            cache_hit=True, t_submit=float(i), t_done=float(i) + lat,
            queue_s=0.0, padding_waste=0.0, deadline=float(i) + 0.05)
        for i, lat in enumerate((0.01, 0.02, 0.10, 0.01))
    ]
    s = P.obs.slo_from_records(recs, slo_s=0.05)
    assert s["requests"] == 4 and s["slo_miss_count"] == 1
    assert s["deadline_miss_count"] == 1
    legacy = [dataclasses.replace(r, deadline=float("inf")) for r in recs]
    assert P.obs.slo_from_records(legacy,
                                  slo_s=None)["deadline_miss_count"] == 0
    assert P.obs.slo_from_records([], slo_s=0.05)["goodput_rps"] == 0.0


def test_serving_stats_summary_counts_deadline_misses(P):
    stats = P.stats.ServingStats(clock=ManualClock())
    for i, (t_done, deadline) in enumerate(
            ((1.0, 2.0), (2.0, 1.5), (3.0, 2.0))):
        stats.record_request(P.stats.RequestRecord(
            rid=i, op="eigh", shape=(8, 8), bucket=(8, 8), batch_size=1,
            cache_hit=True, t_submit=0.0, t_done=t_done, queue_s=0.0,
            padding_waste=0.0, deadline=deadline))
    s = stats.summary()
    assert s["deadline_miss_count"] == 2
    assert s["deadline_miss_frac"] == pytest.approx(2 / 3)


# ---------------------------------------------------------------------------
# serving integration (tests/test_obs.py)
# ---------------------------------------------------------------------------

def _mixed_burst(seed=0):
    rng = np.random.default_rng(seed)
    mats = []
    for n in (5, 9, 12, 7, 11, 6, 10, 8):
        a = rng.standard_normal((n, n)).astype(np.float32)
        mats.append((a + a.T) / 2)
    return mats


def _traced_server(P, obs, **kw):
    return P.server(P.PCAConfig(T=8, S=4, sweeps=6),
                    policy=P.serving.BucketPolicy(T=8), max_delay_s=10.0,
                    obs=obs, clock=obs.clock, **kw)


def test_traced_server_bitwise_identical_to_untraced(P):
    cfg = P.PCAConfig(T=8, S=4, sweeps=6)
    mats = _mixed_burst()
    bare = P.server(cfg, policy=P.serving.BucketPolicy(T=8),
                    max_delay_s=10.0, max_inflight=2)
    obs = P.obs.Observability.enabled(slo_ms=1000.0)
    traced = _traced_server(P, obs, max_inflight=2)
    for g, w in zip(traced.solve_many(mats, op="eigh"),
                    bare.solve_many(mats, op="eigh")):
        for field in (f.name for f in dataclasses.fields(g)):
            np.testing.assert_array_equal(np.asarray(getattr(g, field)),
                                          np.asarray(getattr(w, field)))
    assert len(obs.tracer) > 0
    assert obs.summary()["slo"]["requests"] == len(mats)


def test_request_spans_parent_to_flush_spans(P):
    obs = P.obs.Observability.enabled(slo_ms=1000.0)
    srv = _traced_server(P, obs)
    mats = _mixed_burst()
    srv.solve_many(mats, op="eigh")
    doc = obs.trace_doc()
    assert P.obs.validate_trace(doc) == []
    xs = {e["id"]: e for e in doc["traceEvents"]
          if e.get("ph") == "X" and isinstance(e.get("id"), int)}
    requests = [e for e in xs.values() if e["name"] == "request:eigh"]
    flushes = [e for e in xs.values() if e["name"] == "flush:eigh"]
    assert len(requests) == len(mats)
    assert len(flushes) == srv.stats.flushes
    for e in requests:
        assert xs[e["args"]["parent"]]["name"] == "flush:eigh"
    child_names = {e["name"] for e in xs.values()
                   if e["args"].get("parent") in {f["id"] for f in flushes}}
    assert {"dispatch", "inflight", "wait", "retire",
            "compile"} <= child_names


def test_serving_metrics_and_backend_collector(P):
    obs = P.obs.Observability.enabled()
    srv = _traced_server(P, obs)
    srv.solve_many(_mixed_burst(), op="eigh")
    prom = obs.prometheus_text()
    assert 'serve_requests_total{op="eigh"} 8' in prom
    assert 'serve_request_latency_seconds_bucket{op="eigh",bucket="8x8"' \
        in prom
    assert "serve_flushes_total" in prom and "cache=" in prom
    assert "serve_launches_total" in prom
    op = P.backends.registered_ops()[0]
    P.backends.resolve(op, P.plain_backend)
    prom = obs.prometheus_text()
    assert (f'kernel_backend_resolutions_total{{op="{op}",'
            f'backend="{P.plain_backend}"}}') in prom


def test_plan_swap_and_autotune_observed(P):
    obs = P.obs.Observability.enabled()
    cfg = P.PCAConfig(T=8, S=4, sweeps=6)
    srv = _traced_server(P, obs)
    srv.solve_many(_mixed_burst(), op="eigh")
    profile = P.serving.TrafficProfile.from_stats(srv.stats)
    result = P.autotune(profile,
                        grid=[P.serving.ServingPlan(T=8, max_batch=4)],
                        config=cfg, obs=obs)
    srv.apply_plan(result.best)
    names = [s.name for s in obs.tracer.spans]
    assert "autotune" in names and "plan_swap" in names
    prom = obs.prometheus_text()
    assert "serve_plan_swaps_total 1" in prom
    assert 'autotune_searches_total{mode="analytic"} 1' in prom


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _recorded_series(P):
    """One registry with every kind of series, windowed events and a
    collector, recorded the same way in either package."""
    clock = ManualClock()
    reg = P.obs.MetricRegistry(clock=clock, window_capacity=64)
    reg.register_collector(lambda r: r.counter(
        "collected_total", "From a collector.", ("src",)).labels(
            src="x").set_total(7))
    ctr = reg.counter("req_total", "Requests.", ("op", "bucket"))
    gauge = reg.gauge("depth", "Depth.").labels()
    hist = reg.histogram("lat_seconds", "Latency.", ("op", "bucket"))
    rng = np.random.default_rng(3)
    for i in range(200):
        clock.t = 0.05 * i
        op = ("eigh", "svd")[i % 2]
        bucket = (8 * (1 + i % 3), 8 * (1 + i % 3))
        ctr.labels(op=op, bucket=bucket).inc()
        hist.labels(op, bucket).observe(float(rng.gamma(2.0, 0.01)))
        gauge.set(i % 5)
    slo = P.obs.SLOTracker(slo_s=0.02, registry=reg, clock=clock)
    for i in range(20):
        slo.observe(op="eigh", latency_s=0.001 * i, t_done=10.0 + i,
                    deadline=10.0 + i + (0.5 if i % 3 else -0.5))
    acct = P.obs.TenantAccounting(reg, clock=clock)
    for i in range(12):
        tenant = ("whale", "mouse")[i % 2]
        acct.outcome(tenant, P.obs.TENANT_OUTCOMES[i % 4], now=30.0 + i)
        acct.served(tenant, 0.01 * i, slo_ok=i % 3 != 0, now=30.0 + i)
    clock.t = 42.0
    return reg, slo, acct


def test_prometheus_text_equal_across_packages():
    """The same recorded series give the same Prometheus text, snapshots,
    JSON and summaries in both packages."""
    ref, port = (_recorded_series(PKGS[n]) for n in NAMES)
    (rreg, rslo, racct), (treg, tslo, tacct) = ref, port
    assert treg.to_prometheus() == rreg.to_prometheus()
    same = lambda a, b: (json.dumps(a, sort_keys=True)  # noqa: E731
                         == json.dumps(b, sort_keys=True))  # NaN == NaN
    for window in (None, 1.0, 12.5):
        assert same(treg.snapshot(window_s=window),
                    rreg.snapshot(window_s=window))
        assert same(tslo.summary(window_s=window),
                    rslo.summary(window_s=window))
    assert treg.to_json() == rreg.to_json()
    assert (treg.series_events("lat_seconds", 2.0)
            == rreg.series_events("lat_seconds", 2.0))
    assert tacct.summary(span_s=4.0) == racct.summary(span_s=4.0)


def test_port_trace_passes_the_reference_validator():
    """The port's server exports a trace the reference's validator accepts
    (and the other way round), with the reference's span vocabulary."""
    docs = {}
    for name in NAMES:
        P = PKGS[name]
        obs = P.obs.Observability.enabled(slo_ms=1000.0)
        srv = _traced_server(P, obs, max_inflight=2)
        srv.solve_many(_mixed_burst(), op="eigh")
        srv.apply_plan(P.serving.ServingPlan(T=8, max_batch=2))
        srv.solve_many(_mixed_burst(1)[:4], op="eigh")
        docs[name] = obs.trace_doc()
    port, ref = docs["port"], docs["ref"]
    assert PKGS["ref"].obs.validate_trace(port) == []
    assert PKGS["port"].obs.validate_trace(ref) == []
    names = lambda d: sorted(e["name"] for e in d["traceEvents"])  # noqa
    assert names(port) == names(ref)


def test_fmt_label_spells_the_plain_datapath():
    """The one spelling the port changes: ``None`` (no kernel backend) is
    the plain torch datapath, not XLA."""
    assert PKGS["ref"].obs.fmt_label(None) == "xla"
    assert PKGS["port"].obs.fmt_label(None) == "plain"
    for v in ((8, 16), "eigh", 3, "cuda"):
        assert PKGS["port"].obs.fmt_label(v) == PKGS["ref"].obs.fmt_label(v)


def test_port_collector_reads_the_port_registry():
    from repro_torch import backends

    P = PKGS["port"]
    obs = P.obs.Observability.enabled()
    backends.resolve("mm_engine_matmul", "cuda")  # a name lookup, no launch
    prom = obs.prometheus_text()
    n = backends.resolution_counts()[("mm_engine_matmul", "cuda")]
    assert (f'kernel_backend_resolutions_total{{op="mm_engine_matmul",'
            f'backend="cuda"}} {n}') in prom


def test_device_profile_none_is_a_noop(tmp_path, monkeypatch):
    from torch import profiler

    def refuse(*args, **kwargs):
        raise AssertionError("device_profile(None) started a profiler")

    monkeypatch.setattr(profiler, "profile", refuse)
    for logdir in (None, ""):
        with PKGS["port"].obs.device_profile(logdir):
            pass
    assert list(tmp_path.iterdir()) == []


def test_device_profile_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    out = tmp_path / "profile"
    with PKGS["port"].obs.device_profile(str(out)):
        a = torch.randn(64, 64)
        (a @ a).sum().item()
    traces = sorted(out.glob("*.pt.trace.json"))
    assert len(traces) == 1
    doc = json.loads(traces[0].read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]


def test_device_profile_does_not_swallow_a_profiler_failure(tmp_path,
                                                             monkeypatch):
    from torch import profiler

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with PKGS["port"].obs.device_profile(str(tmp_path)):
            pass


def test_observability_bundle_exports(tmp_path):
    P = PKGS["port"]
    obs = P.obs.Observability.enabled(slo_ms=50.0, clock=ManualClock(1.0))
    obs.tracer.complete("a", ts=1.0, end=1.5)
    obs.slo.observe(op="eigh", latency_s=0.01, t_done=1.5)
    assert json.loads(obs.save_trace(tmp_path / "t.json").read_text())
    assert "slo_requests_total" in obs.save_metrics(
        tmp_path / "m.prom").read_text()
    doc = json.loads(obs.save_summary(tmp_path / "s.json").read_text())
    assert doc["spans"] == 1 and doc["slo"]["requests"] == 1
    meta = {e["name"]: e["args"]["name"]
            for e in obs.trace_doc()["traceEvents"] if e["ph"] == "M"}
    assert meta["process_name"] == "repro_torch.serving"
