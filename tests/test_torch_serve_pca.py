"""The port's serving CLI (``repro_torch.launch.serve_pca``) against the
reference's (``repro.launch.serve_pca``).

Each mode runs through ``main([...])`` of both packages -- the port's on
the CPU (``device="cpu"``; its default is the card) -- and the printed JSON
documents must have the same keys and, where the run is deterministic,
the same values: closed loop (each op, with the observability outputs),
open loop with the controller, ``--spec`` files (each package's file
loading in the other), ``--autotune`` and the flag-conflict exits (code
2).  The port's ``--selftest`` runs every leg on the CPU; its cold-start
leg prints ``{"skipped": true}`` (no persistent tier).
"""
import json
import time

import pytest
import torch

from _control_pkgs import NAMES, PKGS

pytestmark = pytest.mark.filterwarnings(
    "ignore:PCAServer\\(\\.\\.\\.\\) with:DeprecationWarning")

CLOSED = ["--requests", "8", "--dims", "6,9,12", "--max-batch", "4",
          "--tile", "8", "--sweeps", "6"]


@pytest.fixture(params=NAMES)
def P(request):
    return PKGS[request.param]


def _run(P, argv, capsys):
    """``main(argv)`` of package P: (exit code, parsed JSON or None)."""
    capsys.readouterr()
    rc = P.main(argv)
    out = capsys.readouterr().out
    return rc, (json.loads(out) if rc == 0 and out.strip() else None)


def _keys(doc):
    """The nested key structure of a JSON document."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_closed_loop_prints_the_reference_document(P, op, capsys):
    rc, doc = _run(P, CLOSED + ["--op", op], capsys)
    assert rc == 0
    assert doc["op"] == op
    s = doc["summary"]
    assert s["requests"] == 8 and s["cache_hit_rate"] == 1.0
    assert s["flushes"] == 3  # buckets 8 (dims 6) and 16 (dims 9, 12)
    assert doc["plan"]["T"] == 8 and doc["plan"]["max_batch"] == 4
    assert doc["fabric_model"]["median_measured_over_predicted"] > 0
    assert doc["obs"] is None and doc["controller"] is None


def test_closed_loop_documents_have_the_same_keys(capsys):
    (_, ref), (_, port) = (_run(PKGS[n], CLOSED, capsys) for n in NAMES)
    assert _keys(port) == _keys(ref)
    assert port["spec"] == ref["spec"]
    for key in ("requests", "flushes", "mean_batch", "cache_hit_rate",
                "mean_padding_waste", "plan_switches"):
        assert port["summary"][key] == ref["summary"][key], key
    assert port["plan"]["executor"] == "local(cpu)"


def test_closed_loop_writes_trace_metrics_and_profile(P, capsys, tmp_path):
    argv = CLOSED + ["--op", "eigh", "--slo-ms", "1000",
                     "--trace-out", str(tmp_path / "trace.json"),
                     "--metrics-out", str(tmp_path / "metrics.prom")]
    if P.name == "port":   # the port's --jax-profile is a torch.profiler run
        argv += ["--jax-profile", str(tmp_path / "profile")]
    rc, doc = _run(P, argv, capsys)
    assert rc == 0
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert P.obs.validate_trace(trace) == []
    assert PKGS["ref"].obs.validate_trace(trace) == []
    spans = {e["id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and isinstance(e.get("id"), int)}
    requests = [e for e in spans.values() if e["name"] == "request:eigh"]
    assert len(requests) == 8
    for e in requests:
        assert spans[e["args"]["parent"]]["name"] == "flush:eigh"
    prom = (tmp_path / "metrics.prom").read_text()
    assert "serve_request_latency_seconds_bucket" in prom
    assert "kernel_backend_resolutions_total" in prom
    assert doc["obs"]["slo"]["requests"] == 8
    if P.name == "port":
        traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any("jacobi" in str(e.get("name", "")) or
                   "aten::" in str(e.get("name", "")) for e in events)


def _virtual_time(P, monkeypatch):
    """Inside the test, P's CLI builds its server on a ``VirtualClock`` and
    its frontend replays the arrival stream in virtual time (``pace=False``):
    the run no longer depends on the host's thread scheduling and load."""
    s = P.serving
    build, run = P.serve_pca.build_server, s.TrafficFrontend.run
    monkeypatch.setattr(P.serve_pca, "build_server", lambda spec, **kw:
                        build(spec, clock=s.VirtualClock(), **kw))
    monkeypatch.setattr(s.TrafficFrontend, "run",
                        lambda self, arrivals, pace=False:
                        run(self, arrivals, pace=False))


OPEN_CONTROLLED = ["--arrivals", "poisson", "--rate", "400", "--requests",
                   "40", "--op", "eigh", "--dims", "6,12", "--tenants",
                   "whale:0.9,mouse:0.1", "--scheduler", "wfq",
                   "--admission", "shed", "--slo-ms", "200", "--controller",
                   "on", "--reprofile-every", "0.02", "--profile-window",
                   "0.5", "--min-dwell", "0.05", "--sweeps", "6", "--tile",
                   "8"]


def test_open_loop_with_the_controller(P, capsys, monkeypatch):
    """The open loop with the controller on, in virtual time
    (``_virtual_time``): paced on the wall clock, what this leg checks
    depends on the host's speed (``test_paced_open_loop_sheds_all_on_a_
    stalled_host``); the paced path keeps its own test
    (``test_paced_run_with_a_swapping_controller_loses_no_request``)."""
    _virtual_time(P, monkeypatch)
    argv = OPEN_CONTROLLED
    rc, doc = _run(P, argv, capsys)
    assert rc == 0
    fe = doc["frontend"]
    assert fe["served"] + fe["degraded"] + fe["shed"] + fe["throttled"] \
        == fe["requests"] == 40
    assert fe["served"] > 0
    assert set(fe["per_tenant"]) == {"whale", "mouse"}
    ctrl = doc["controller"]
    assert ctrl["ticks"] >= 1 and ctrl["grid_size"] > 0
    assert doc["profile"]["requests"] == 40
    assert doc["obs"]["slo"]["requests"] == fe["served"] + fe["degraded"]
    rc, again = _run(P, argv, capsys)       # virtual time: the same run
    assert rc == 0 and again["frontend"] == fe
    assert again["controller"]["ticks"] == ctrl["ticks"]


def test_paced_open_loop_sheds_all_on_a_stalled_host(P, capsys,
                                                     monkeypatch):
    """The same leg paced on the wall clock (the CLI's own run) on a host
    whose every dispatch stalls 1 s: the admission model, calibrated on
    that host, predicts each request past the 200 ms SLO and sheds all 40,
    so the leg's ``served > 0`` fails there.  This is why the leg above
    runs in virtual time."""
    submit = P.serving.LocalExecutor.submit

    def stalled(self, *args, **kw):
        time.sleep(1.0)
        return submit(self, *args, **kw)

    monkeypatch.setattr(P.serving.LocalExecutor, "submit", stalled)
    rc, doc = _run(P, OPEN_CONTROLLED, capsys)
    assert rc == 0
    fe = doc["frontend"]
    assert fe["served"] == fe["degraded"] == 0 and fe["shed"] == 40
    assert doc["obs"]["slo"]["requests"] == 0


def test_open_loop_documents_have_the_same_keys(capsys):
    argv = ["--arrivals", "poisson", "--rate", "500", "--requests", "24",
            "--dims", "6,10", "--tenants", "a:0.5,b:0.5", "--slo-ms", "500",
            "--sweeps", "6", "--tile", "8"]
    (_, ref), (_, port) = (_run(PKGS[n], argv, capsys) for n in NAMES)
    assert _keys(port) == _keys(ref)
    assert port["profile"] == ref["profile"]
    assert port["tenants"] == ref["tenants"]


@pytest.mark.parametrize("writer", NAMES)
def test_spec_file_mode(P, writer, capsys, tmp_path):
    """A spec file written by either package serves through either CLI."""
    w = PKGS[writer].serving
    path = tmp_path / "server.json"
    w.ServerSpec(
        scheduling=w.SchedulingSpec(mode="pow2", T=8, max_batch=4,
                                    max_delay_s=10.0, max_inflight=2),
        execution=w.ExecutionSpec(sweeps=6),
        obs=w.ObsSpec(slo_ms=500.0)).save(path)
    rc, doc = _run(P, ["--spec", str(path), "--requests", "8", "--dims",
                       "6,9,12"], capsys)
    assert rc == 0
    assert doc["spec"] == json.loads(path.read_text())
    assert doc["plan"]["mode"] == "pow2" and doc["plan"]["max_inflight"] == 2
    assert doc["summary"]["requests"] == 8


@pytest.mark.parametrize("argv", [
    ["--spec", "server.json", "--tile", "8"],
    ["--controller", "on", "--autotune", "analytic"],
    ["--hysteresis", "0.05"],
    ["--arrivals", "poisson", "--warmup", "p.json"],
    ["--degrade-frac", "0.25"],
    ["--measure-top-k", "5"],
])
def test_flag_conflicts_exit_2(P, argv, capsys):
    capsys.readouterr()
    assert P.main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("serve_pca: flag conflict:")


def test_autotune_modes_run_on_the_callers_device(capsys, monkeypatch):
    """``--autotune`` measures its replays where the server runs: on the
    CPU here, with the card's default refusing (no card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = PKGS["port"]
    for mode in ("analytic", "measured"):
        argv = CLOSED + ["--autotune", mode]
        if mode == "measured":
            argv += ["--measure-top-k", "2"]
        rc, doc = _run(port, argv, capsys)
        assert rc == 0
        assert doc["autotune"]["mode"] == mode
        assert doc["plan"]["executor"] == "local(cpu)"
        assert doc["summary"]["plan_switches"] == 0  # the timed pass alone
    with pytest.raises(RuntimeError, match="is_available"):
        port.serve_pca.main(CLOSED)


def test_port_selftest_on_the_cpu(capsys):
    assert PKGS["port"].main(["--selftest"]) == 0
    lines = capsys.readouterr().out.splitlines()
    legs = {line.split(" selftest ok:")[0]: json.loads(
        line.split(" selftest ok:")[1]) for line in lines
        if " selftest ok:" in line}
    assert set(legs) == {f"serve_pca{leg}" for leg in (
        "", " sharded", " async", " autotune", " obs", " cold-start",
        " frontend", " spec", " controller")}
    assert legs["serve_pca cold-start"] == {"skipped": True}
    assert legs["serve_pca sharded"] == {"executor": "local(cpu)",
                                         "n_shards": 1}
    assert legs["serve_pca controller"]["swaps"] >= 1
    assert legs["serve_pca frontend"]["served"] > 0


def test_cli_and_control_plane_import_no_jax():
    """The CLI, the control plane and obs pull in neither JAX nor the
    reference (the card's machine has no JAX)."""
    import os
    import pathlib
    import subprocess
    import sys

    import repro_torch
    src = pathlib.Path(repro_torch.__file__).resolve().parent.parent
    code = ("import sys, repro_torch.launch.serve_pca, repro_torch.obs, "
            "repro_torch.serving.controller, repro_torch.serving.frontend\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_paced_run_with_a_swapping_controller_loses_no_request():
    """The paced frontend ticks the controller from its feeder thread
    while its worker submits; with the controller swapping plans
    mid-run, every admitted request is still served."""
    s = PKGS["port"].serving
    spec = s.ServerSpec(
        scheduling=s.SchedulingSpec(T=16, max_batch=4, max_delay_s=0.005),
        execution=s.ExecutionSpec(sweeps=4),
        controller=s.ControllerSpec(enabled=True, window_s=0.2,
                                    reprofile_every_s=0.01, hysteresis=0.0,
                                    min_dwell_s=0.0))
    srv = s.build_server(spec, device="cpu")
    srv.controller.model = s.CostModel(device_work_per_s=1e6,
                                       compile_s_per_executable=0.0)
    srv.controller.min_window_requests = 1
    stream = s.generate("poisson", rate=2000.0, n=120,
                        tenants=(s.TenantSpec("t0"),), seed=7,
                        trace="bimodal", lo=4, hi=24)
    fe = s.TrafficFrontend(srv, (s.TenantSpec("t0"),), admission="none",
                           seed=1)
    srv.controller.frontend = fe
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: widen any race
    try:
        rep = fe.run(stream, pace=True)
    finally:
        sys.setswitchinterval(interval)
    assert rep.served == rep.requests == len(stream)
    assert srv.pending() == 0 and srv.inflight() == 0
    assert srv.controller.ticks > 1 and len(srv.controller.swaps) >= 1
