"""The port's stage ranges on the profiler's clock (``obs.tracing.stage``):
the serving engine's dispatch, executor and retire stages, the fit's four
stages and the garbage collector's collections, as ``torch.profiler``
records them on the CPU; the launch range's name and its sweep kernel; and
the gate: with no profiler recording, no range is entered at all."""
import gc
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.pca import PCAConfig, fit_transform
from repro_torch.kernels import fused
from repro_torch.obs import Observability
from repro_torch.obs import tracing
from repro_torch.parallel.sharding import Mesh
from repro_torch.serving import BucketPolicy, PCAServer
from repro_torch.serving.sharded import (LocalExecutor, MeshExecutor, Solver,
                                         launch_name, sweep_kernel)

# H100 SXM: 227 KiB of opt-in shared memory a block, 132 SMs
H100_LIMITS = (227 * 1024, 132, 1)
SERVE = PCAConfig(T=8, S=4, sweeps=3)
CARD = PCAConfig(T=64, S=32, sweeps=50, fused=True, backend="cuda")


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return (a + a.T) / 2


def _server(executor=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return PCAServer(SERVE, policy=BucketPolicy(T=8), max_batch=4,
                         max_delay_s=1e9,
                         executor=executor or LocalExecutor(device="cpu"),
                         **kw)


def _ranges(prof):
    """[(name, start_ns, end_ns)] of the ``repro.*`` host events, in
    start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("repro.")), key=lambda r: r[1])


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _two_buckets():
    return [_sym(n, seed=n) for n in (5, 6, 7, 12, 14)]


def test_recording_follows_the_profiler():
    assert tracing.recording.__code__.co_names[-1] == "_profiler_enabled"
    assert not tracing.recording()
    assert tracing.stage("repro.x") is tracing.stage("repro.y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        assert isinstance(tracing.stage("repro.x"),
                          torch.profiler.record_function)
    assert not tracing.recording()


def test_serving_stages_nest_as_the_engine_runs_them():
    srv = _server(max_inflight=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv.solve_many(_two_buckets())
    got = _ranges(prof)
    names = [r[0] for r in got]
    by = lambda name: [r for r in got if r[0] == name]  # noqa: E731
    launches = [r for r in got if r[0].startswith("repro.launch:")]
    assert {n for n in names if not n.startswith(("repro.launch:",
                                                  "repro.gc:"))} == {
        "repro.dispatch", "repro.stack", "repro.lookup", "repro.stage",
        "repro.retire", "repro.wait", "repro.fulfil"}
    assert len(by("repro.dispatch")) == len(launches) == 2
    assert len(by("repro.retire")) == 2
    for name in ("repro.stack", "repro.lookup", "repro.stage"):
        assert len(by(name)) == 2
        assert all(_inside(r, by("repro.dispatch")) for r in by(name))
    assert all(_inside(r, by("repro.dispatch")) for r in launches)
    for name in ("repro.wait", "repro.fulfil"):
        assert len(by(name)) == 2
        assert all(_inside(r, by("repro.retire")) for r in by(name))
    # in each dispatch: stack, lookup, stage, launch, one after another
    for d in by("repro.dispatch"):
        inner = [r[0].split(":")[0] for r in got
                 if _inside(r, [d]) and r is not d
                 and not r[0].startswith("repro.gc:")]
        assert inner == ["repro.stack", "repro.lookup", "repro.stage",
                         "repro.launch"]


def test_launch_name_carries_the_flush_key():
    srv = _server()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv.solve_many(_two_buckets())
    launches = [r[0] for r in _ranges(prof)
                if r[0].startswith("repro.launch:")]
    assert launches == ["repro.launch:eigh:8x8:3/4:n8:s3:none",
                        "repro.launch:eigh:16x16:2/4:n16:s3:none"]
    assert not any("(" in name for name in launches)


def test_launch_name_of_a_svd_flush_and_of_a_bare_solver():
    ex = LocalExecutor(device="cpu")
    fn = ex.compile("svd", SERVE, (24, 16), 4)
    batch = np.zeros((4, 24, 16), np.float32)
    n_active = np.array([[20, 24, 0, 0], [15, 16, 0, 0]], np.int32)
    assert launch_name(fn, batch, n_active, ex.device) == \
        "repro.launch:svd:24x16:2/4:n16:s3:none"
    # odd widths sweep one wider under the parallel pivot
    n_active = np.array([[20, 24, 24, 0], [15, 15, 15, 0]], np.int32)
    assert launch_name(fn, batch[:, :, :15], n_active, ex.device) == \
        "repro.launch:svd:24x15:3/4:n16:s3:none"
    assert launch_name(lambda *a: None, batch, n_active, ex.device) == \
        "repro.launch"


@pytest.mark.parametrize("n,kernel", [(128, "smem"), (256, "grid"),
                                      (784, "grid")])
def test_kernel_field_is_the_sweep_plan_of_the_card(monkeypatch, n, kernel):
    """At H100 limits the field is ``fused.sweep_plan``'s own choice at
    the flush's padded batch and width (no card needed: the limits are
    the card's numbers)."""
    monkeypatch.setattr(fused, "_sweep_limits", lambda index, n, k:
                        H100_LIMITS)
    card = torch.device("cuda", 0)
    plan = fused.sweep_plan(32, n, n // 2, *H100_LIMITS)
    want = {"jacobi_sweep_smem": "smem", "jacobi_sweep": "grid"}
    assert sweep_kernel(card, CARD, n, 32) == want[plan.kernel.name] == \
        kernel
    solver = Solver("eigh", CARD, lambda *a: None)
    batch = np.zeros((32, n, n), np.float32)
    n_active = np.full((2, 32), n, np.int32)
    n_active[:, 30:] = 0
    assert launch_name(solver, batch, n_active, card) == \
        f"repro.launch:eigh:{n}x{n}:30/32:n{n}:s50:{kernel}"


@pytest.mark.parametrize("config", [
    PCAConfig(fused=False, backend="cuda"),
    PCAConfig(fused=True, backend="torch"),
    PCAConfig(fused=True, backend="cuda", rotation="matmul"),
    PCAConfig(fused=True, backend="cuda", pivot="paper")])
def test_kernel_field_is_none_without_a_fused_sweep(monkeypatch, config):
    monkeypatch.setattr(fused, "_sweep_limits", lambda index, n, k:
                        H100_LIMITS)
    assert sweep_kernel(torch.device("cuda", 0), config, 128, 32) == "none"
    assert sweep_kernel(torch.device("cpu"), CARD, 128, 32) == "none"


def test_a_mesh_names_each_shard_launch():
    cpu = torch.device("cpu")
    ex = MeshExecutor(mesh=Mesh([cpu, cpu], ("data",)))
    srv = _server(executor=ex)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv.solve_many([_sym(n, seed=n) for n in (5, 6, 7)])
    got = _ranges(prof)
    assert [r[0] for r in got if r[0].startswith("repro.launch:")] == [
        "repro.launch:eigh:8x8:2/2:n8:s3:none",
        "repro.launch:eigh:8x8:1/2:n8:s3:none"]
    assert len([r for r in got if r[0] == "repro.stage"]) == 2


def test_fit_stages_nest_in_order():
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(
        np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit_transform(x, 3, PCAConfig(sweeps=3), device="cpu")
    got = [r for r in _ranges(prof) if not r[0].startswith("repro.gc:")]
    assert [r[0] for r in got] == [
        "repro.fit", "repro.fit.standardize", "repro.fit.covariance",
        "repro.fit.eigh", "repro.fit.transform"]
    assert all(_inside(r, got[:1]) for r in got[1:])
    assert all(a[2] <= b[1] for a, b in zip(got[1:], got[2:]))


def test_a_collection_while_recording_is_one_gc_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert [r[0] for r in _ranges(prof)] == ["repro.gc:2"]
    gc.collect()  # outside the profiler: nothing opens
    assert [cb for cb in gc.callbacks
            if isinstance(cb, tracing._GcRanges)][0].open is None


def test_no_profiler_enters_no_range(monkeypatch):
    """The gate: with no profiler recording, a flush, a fit and a
    collection run with ``record_function`` made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    srv = _server(max_inflight=2)
    srv.solve_many(_two_buckets())
    x = np.random.default_rng(1).standard_normal((64, 8)).astype(
        np.float32)
    fit_transform(x, 3, PCAConfig(sweeps=3), device="cpu")
    gc.collect()
    with pytest.raises(AssertionError, match="no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            srv.solve_many(_two_buckets())


def test_launch_counter_family_is_wired_once_with_the_engine():
    obs = Observability.enabled()
    srv = _server(obs=obs, clock=obs.clock)
    fam = obs.metrics.counter("serve_launches_total",
                              "Device launches by executor.", ("executor",))
    assert srv._m_launches is fam
    srv.solve_many(_two_buckets())
    assert 'serve_launches_total{executor="local(cpu)"} 2' in \
        obs.prometheus_text()
