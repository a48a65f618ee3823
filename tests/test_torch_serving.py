"""The port's serving engine (``repro_torch.serving``: ``PCAServer`` with its
executor, in-flight queue, solver cache and stats) against the reference's.

The port runs on the CPU (``LocalExecutor(device="cpu")``).  Three groups:

  * engine behaviour: the reference's own engine and cache tests
    (``tests/test_serving.py``, ``tests/test_serving_cache.py``; the disk
    tier is not ported) replayed on the port's server, with the same
    assertions -- flush on full and on timeout, cache hits, bucketing,
    stats, the dispatch / in-flight / retire pipeline, warmup and
    ``apply_plan``;
  * engine parity: one burst of each op through both servers retires the
    same flushes (op, bucket, live and padded batch sizes, cache hits and
    misses, in the same order) and serves results within the fp32
    ``ERROR_BUDGETS`` of the reference's and of float64 numpy;
  * the port's own seams: the default executor is ``cuda`` and raises
    without a card, the features not ported raise, the executor's host
    tree, the copied modules (``stats``, ``core.memory_model``) equal to
    the reference's.

Sync and async runs of the port are held **bitwise** equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import memory_model as jmm
from repro.core import pca as jpca
from repro.obs import Observability
from repro.parallel import sharding as jsharding
from repro.serving import PCAServer as JServer
from repro.serving import TrafficProfile
from repro.serving import BucketPolicy as JBucketPolicy
from repro.serving import stats as jstats
from repro_torch import backends as tbackends
from repro_torch.core import memory_model as tmm
from repro_torch.core.pca import PCAConfig
from repro_torch.core.precision import ERROR_BUDGETS
from repro_torch.serving import (BucketPolicy, CacheSpec, ExecutionSpec,
                                 InFlightFlush, InFlightQueue, LRUCache,
                                 LocalExecutor, PCAServer, ServedEigh,
                                 ServedPCA, ServedSVD, ServerSpec, SolverKey,
                                 environment_fingerprint, mesh_executor,
                                 threshold_router)
from repro_torch.parallel import sharding as tsharding
from repro_torch.serving import sharded as sharded_mod
from repro_torch.serving import stats as tstats

from _torch_parity import rel_frobenius

# a direct PCAServer(...) with three or more construction kwargs warns (the
# reference's deprecation shim, tested on its own below)
pytestmark = pytest.mark.filterwarnings(
    "ignore:PCAServer\\(\\.\\.\\.\\) with:DeprecationWarning")


def _sym(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def _server(clock=None, **kw):
    kw.setdefault("config", PCAConfig(T=8, S=4, sweeps=12))
    kw.setdefault("policy", BucketPolicy(T=8))
    kw.setdefault("executor", LocalExecutor(device="cpu"))
    if clock is not None:
        kw["clock"] = clock
    return PCAServer(**kw)


def _eig_ok(result, n, seed):
    ref = np.linalg.eigh(_sym(n, seed=seed))[0][::-1]
    np.testing.assert_allclose(result.eigenvalues, ref, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# engine behaviour (tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_engine_flush_on_full():
    srv = _server(max_delay_s=1e9)   # deadline can never fire
    tickets = [srv.submit(_sym(6, seed=i)) for i in range(4)]
    assert all(t.done for t in tickets)          # S-full flush, no poll needed
    assert srv.pending() == 0
    for i, t in enumerate(tickets):
        assert isinstance(t.result(), ServedEigh)
        assert isinstance(t.result().eigenvalues, np.ndarray)
        _eig_ok(t.result(), 6, i)


def test_engine_flush_on_timeout():
    t = [0.0]
    srv = _server(clock=lambda: t[0], max_delay_s=0.5)
    ticket = srv.submit(_sym(6))
    assert not ticket.done
    assert srv.poll() == 0                       # deadline not reached
    t[0] = 0.49
    assert srv.poll() == 0
    t[0] = 0.51
    assert srv.poll() == 1 and ticket.done       # deadline flush
    rec = ticket.record
    assert rec.batch_size == 1 and rec.queue_s == pytest.approx(0.51)


def test_engine_executable_cache_hits_on_repeated_shapes():
    srv = _server(max_delay_s=1e9)
    [srv.submit(_sym(6, seed=i)) for i in range(4)]
    assert srv.stats.cache_misses == 1 and srv.stats.cache_hits == 0
    [srv.submit(_sym(6, seed=10 + i)) for i in range(4)]
    assert srv.stats.cache_hits == 1             # same (op, bucket, batch)
    # timeout-style partial flush pads the batch -> same solver, still hit
    srv.submit(_sym(7, seed=20))
    srv.drain()
    assert srv.stats.cache_hits == 2
    assert len(srv._cache) == 1


def test_engine_mixed_buckets_separate_queues():
    srv = _server(max_delay_s=1e9)
    small = srv.submit(_sym(6))                  # bucket (8, 8)
    big = srv.submit(_sym(12))                   # bucket (16, 16)
    assert not small.done and not big.done and srv.pending() == 2
    srv.drain()
    assert small.done and big.done
    assert small.record.bucket == (8, 8) and big.record.bucket == (16, 16)


def test_engine_stats_summary():
    srv = _server(max_delay_s=1e9)
    srv.solve_many([_sym(6, seed=i) for i in range(8)])
    s = srv.stats.summary()
    assert s["requests"] == 8 and s["flushes"] == 2
    assert s["mean_batch"] == 4.0
    assert 0.0 <= s["mean_padding_waste"] < 1.0
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] > 0.0
    pvm = srv.stats.predicted_vs_measured()
    assert len(pvm) == 8 and all(r["predicted_s"] > 0 for r in pvm)


def _assert_served_equal(got, want, op):
    fields = [f.name for f in dataclasses.fields(got)]
    assert fields, op
    for field in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
            err_msg=f"{op}.{field}")


def _op_burst(op):
    rng = np.random.default_rng(11)
    if op == "eigh":
        return [_sym(n, seed=n) for n in (5, 7, 6, 8, 4, 6, 7, 5)]
    return [rng.standard_normal((24, d)).astype(np.float32)
            for d in (5, 7, 6, 4, 5, 7, 6, 4)]


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_async_matches_sync_per_op(op):
    """The pipeline runs the identical cached solver on identical slabs, so
    a deep pipeline matches the synchronous engine bit for bit on every
    served field."""
    mats = _op_burst(op)
    got = _server(max_delay_s=1e9, max_inflight=3).solve_many(mats, op=op)
    want = _server(max_delay_s=1e9).solve_many(mats, op=op)
    kind = {"eigh": ServedEigh, "svd": ServedSVD, "pca": ServedPCA}[op]
    for g, w in zip(got, want):
        assert isinstance(g, kind)
        _assert_served_equal(g, w, op)


def test_async_inflight_cap_backpressures_dispatch():
    """Dispatching past max_inflight retires the oldest flush first: older
    microbatches complete without any poll/drain, and the pipeline depth
    never exceeds the cap."""
    srv = _server(max_delay_s=1e9, max_inflight=2,
                  config=PCAConfig(T=8, S=2, sweeps=12), max_batch=2)
    t1 = [srv.submit(_sym(6, seed=i)) for i in range(2)]      # flush 1
    assert srv.inflight() == 1 and srv.pending() == 0
    assert not any(t.done for t in t1)
    assert all(t.inflight for t in t1)
    t2 = [srv.submit(_sym(6, seed=10 + i)) for i in range(2)]  # flush 2
    assert all(t.done for t in t1)
    t3 = [srv.submit(_sym(6, seed=20 + i)) for i in range(2)]  # flush 3
    assert all(t.done for t in t2)
    assert srv.inflight() == 1 and srv.inflight_requests() == 2
    assert [d for _, d in srv.stats.inflight_depths] == [1, 2, 2]
    srv.drain()
    assert all(t.done for t in t1 + t2 + t3) and srv.inflight() == 0
    for i, t in enumerate(t1):
        _eig_ok(t.result(), 6, i)


def test_async_out_of_order_retirement():
    """A younger flush may retire before an older one: each flush fulfils
    only its own tickets."""
    srv = _server(max_delay_s=1e9, max_inflight=4)
    small = [srv.submit(_sym(6, seed=i)) for i in range(4)]    # flush 1
    big = [srv.submit(_sym(12, seed=i)) for i in range(4)]     # flush 2
    assert srv.inflight() == 2
    big[0].result()                  # retire flush 2 while flush 1 flies
    assert all(t.done for t in big)
    assert not any(t.done for t in small) and srv.inflight() == 1
    assert srv.drain() == 4          # retires exactly flush 1
    assert all(t.done for t in small)
    for i, t in enumerate(small):
        _eig_ok(t.result(), 6, i)
    for i, t in enumerate(big):
        _eig_ok(t.result(), 12, i)


def test_max_inflight_one_is_synchronous_under_injected_clock():
    t = [0.0]
    srv = _server(clock=lambda: t[0], max_delay_s=0.5)
    assert srv.max_inflight == 1
    tickets = [srv.submit(_sym(6, seed=i)) for i in range(4)]
    assert all(tk.done for tk in tickets)        # S-full flush, synchronous
    assert srv.inflight() == 0
    late = srv.submit(_sym(6, seed=9))
    assert not late.done
    t[0] = 0.51
    assert srv.poll() == 1 and late.done and srv.inflight() == 0
    assert all(f.overlap_s == 0.0 and f.wait_s == 0.0
               for f in srv.stats.flush_records)
    assert srv.stats.summary()["max_inflight_depth"] == 1


def test_poll_dispatches_expired_queues_in_sorted_order():
    t = [0.0]
    srv = _server(clock=lambda: t[0], max_delay_s=0.5)
    srv.submit(_sym(12))                         # ("eigh", (16, 16)) first
    srv.submit(_sym(6))                          # ("eigh", (8, 8)) second
    srv.submit(np.random.default_rng(0).standard_normal((8, 6))
               .astype(np.float32), op="svd")    # ("svd", (8, 8)) third
    t[0] = 1.0
    assert srv.poll() == 3
    flushed = [(r.op, r.bucket) for r in srv.stats.records]
    assert flushed == [("eigh", (8, 8)), ("eigh", (16, 16)),
                       ("svd", (8, 8))]


def test_ticket_result_error_names_op_bucket_and_depth():
    srv = _server(max_delay_s=1e9)
    srv.submit(_sym(6, seed=0))
    ticket = srv.submit(_sym(6, seed=1))
    with pytest.raises(RuntimeError, match=r"op='eigh'.*\(8, 8\).*2 "
                                           r"request\(s\)"):
        ticket.result()
    assert not ticket.done and srv.pending() == 2


def test_ticket_wait_flushes_its_own_queue():
    srv = _server(max_delay_s=1e9)
    other = srv.submit(_sym(12, seed=0))         # different bucket
    ticket = srv.submit(_sym(6, seed=3))
    res = ticket.wait()
    assert ticket.done and ticket.record.batch_size == 1
    assert not other.done and srv.pending() == 1
    _eig_ok(res, 6, 3)
    assert ticket.wait() is res                  # idempotent once done
    assert ticket.wait(timeout=0.0) is res


def test_ticket_wait_timeout_leaves_flush_in_flight():
    srv = _server(max_delay_s=1e9, max_inflight=2,
                  config=PCAConfig(T=8, S=1, sweeps=80), max_batch=1)
    ticket = srv.submit(_sym(24, seed=0))
    assert not ticket.done and srv.inflight() == 1
    try:
        ticket.wait(timeout=0.0)
        assert ticket.done                       # the solve won the race
    except TimeoutError:
        assert not ticket.done and srv.inflight() == 1
    res = ticket.wait()                          # no timeout: blocks home
    assert ticket.done and srv.inflight() == 0
    assert res.eigenvalues.shape == (24,)


@pytest.mark.parametrize("bad", [
    dict(op="qr"), dict(matrix=np.ones(4, np.float32)),
    dict(matrix=np.ones((3, 4), np.float32)), dict(sweeps=0)])
def test_submit_rejects_bad_requests(bad):
    srv = _server()
    kw = dict(matrix=_sym(4), op="eigh")
    kw.update(bad)
    with pytest.raises(ValueError):
        srv.submit(kw.pop("matrix"), **kw)
    assert srv.pending() == 0


def test_submit_takes_float64_requests_as_float32():
    srv = _server(max_delay_s=1e9)
    a = _sym(6, seed=4).astype(np.float64)
    got = srv.submit(a).wait()
    want = _server(max_delay_s=1e9).submit(a.astype(np.float32)).wait()
    assert got.eigenvalues.dtype == np.float32
    _assert_served_equal(got, want, "eigh")


def test_per_request_sweeps_batch_separately():
    srv = _server(max_delay_s=1e9)
    a = srv.submit(_sym(6, seed=1), sweeps=3)
    b = srv.submit(_sym(6, seed=2))
    assert srv.pending() == 2
    srv.drain()
    assert a.record.sweeps == 3 and b.record.sweeps == 12
    assert a.record.batch_size == 1 and b.record.batch_size == 1
    assert len(srv._cache) == 2


# ---------------------------------------------------------------------------
# cache, warmup, apply_plan (tests/test_serving_cache.py, memory tier)
# ---------------------------------------------------------------------------

def _cache_server(sweeps=4, **kw):
    kw.setdefault("policy", BucketPolicy(T=8))
    kw.setdefault("max_delay_s", 10.0)
    kw.setdefault("executor", LocalExecutor(device="cpu"))
    return PCAServer(PCAConfig(T=8, S=2, sweeps=sweeps), **kw)


def test_lru_cache_evicts_coldest_first():
    evicted = []
    lru = LRUCache(max_entries=2, on_evict=lambda k, v: evicted.append(k))
    lru["a"], lru["b"] = 1, 2
    assert lru["a"] == 1            # refresh "a": "b" is now coldest
    lru["c"] = 3
    assert set(lru) == {"a", "c"}
    assert lru.evictions == 1 and evicted == ["b"]
    assert lru.get("b") is None
    unbounded = LRUCache(max_entries=None)
    for i in range(600):
        unbounded[i] = i
    assert len(unbounded) == 600 and unbounded.evictions == 0
    with pytest.raises(ValueError):
        LRUCache(max_entries=0)


def test_solver_key_ignores_scheduling_facts():
    a = SolverKey.from_config(PCAConfig(T=8, S=2))
    b = SolverKey.from_config(PCAConfig(T=32, S=64))
    assert a == b and hash(a) == hash(b)
    assert a != SolverKey.from_config(PCAConfig(T=8, S=2, sweeps=3))
    # ...except the matmul block size once a kernel backend consumes it
    ka = SolverKey.from_config(PCAConfig(T=8, backend="torch"))
    kb = SolverKey.from_config(PCAConfig(T=16, backend="torch"))
    assert ka != kb and ka.backend == "torch"


def test_solver_key_carries_precision_and_fused():
    base = SolverKey.from_config(PCAConfig(T=8, S=2))
    assert base.precision == "fp32" and base.fused is False
    assert base != SolverKey.from_config(
        PCAConfig(T=8, S=2, precision="bf16_fp32acc"))
    assert base != SolverKey.from_config(PCAConfig(T=8, S=2, fused=True))


@pytest.mark.parametrize("config", [
    PCAConfig(T=8, S=2), PCAConfig(T=16, S=4, sweeps=3, backend="cuda"),
    PCAConfig(pivot="paper", rotation="matmul", angle="cordic", tol=1e-6,
              standardize=False, precision="bf16_fp32acc", fused=True)])
def test_solver_key_is_the_reference_key(config):
    from repro.serving import SolverKey as JSolverKey
    jconfig = jpca.PCAConfig(**{
        f.name: getattr(config, f.name) for f in dataclasses.fields(config)})
    assert dataclasses.astuple(SolverKey.from_config(config)) == \
        dataclasses.astuple(JSolverKey.from_config(jconfig))


def test_local_executor_builds_each_solver_once(monkeypatch):
    builds = []
    real = sharded_mod.build_solver_fn

    def counting(op, config, device=None):
        builds.append((op, SolverKey.from_config(config)))
        return real(op, config, device=device)

    monkeypatch.setattr(sharded_mod, "build_solver_fn", counting)
    srv = _cache_server(pad_batches=False, sweeps=3)
    mats = [_sym(6, seed=i) for i in range(4)]
    srv.submit(mats[0]).wait()            # flush of batch 1
    for m in mats[1:]:                    # flush of batch 2 + batch 1
        srv.submit(m)
    srv.drain()
    assert {k[2] for k in srv._cache} >= {1, 2}   # distinct engine keys...
    fns = {id(srv._cache[k]) for k in srv._cache}
    assert len(fns) == 1                  # ...but one shared solver
    assert len(builds) == 1, builds       # built exactly once


def test_engine_cache_bounded_with_gauge():
    obs = Observability.enabled()
    srv = _cache_server(sweeps=2, obs=obs, clock=obs.clock,
                        max_cached_executables=2)
    for n in (5, 9, 17):                  # three buckets, one solver key each
        srv.solve_many([_sym(n)], op="eigh")
    assert len(srv._cache) == 2
    assert srv._cache.evictions >= 1
    assert srv.cache_summary()["entries"] == 2
    assert srv.cache_summary()["disk"] is None
    assert "serve_executables_cached 2" in obs.prometheus_text()
    srv.solve_many([_sym(17)], op="eigh")
    assert len(srv._cache) == 2


def test_warmup_prebuilds_profile_executables():
    obs = Observability.enabled()
    srv = _cache_server(sweeps=2, obs=obs, clock=obs.clock)
    profile = TrafficProfile.from_shapes(
        [("eigh", (6, 6), 3), ("eigh", (5, 5), 1), ("svd", (12, 6), 2)])
    assert len(srv.warmup_keys(profile)) == 2
    doc = srv.warmup(profile)
    assert doc["executables"] == 2 and doc["compile"] == 2
    assert doc["disk"] == 0
    again = srv.warmup(profile)
    assert again["memory"] == 2 and again["compile"] == 0
    srv.solve_many([_sym(6), _sym(5)], op="eigh")
    assert srv.stats.summary()["cache_hit_rate"] == 1.0
    names = {e.get("name") for e in obs.trace_doc()["traceEvents"]}
    assert "warmup" in names
    assert "serve_warmup_executables_total" in obs.prometheus_text()


def test_warmup_keys_ordered_by_descending_traffic_weight():
    srv = _cache_server(sweeps=2)
    profile = TrafficProfile.from_shapes([
        ("eigh", (6, 6), 2),       # bucket (8,8): 2 + 5 = 7 total
        ("svd", (12, 6), 1),
        ("eigh", (5, 5), 5),
        ("pca", (12, 6), 4),
    ])
    keys = srv.warmup_keys(profile)
    assert [(k[0], k[1]) for k in keys] == [
        ("eigh", (8, 8)), ("pca", (16, 8)), ("svd", (16, 8))]
    bare = srv.warmup_keys([("svd", (12, 6)), ("eigh", (6, 6))])
    assert [k[0] for k in bare] == ["svd", "eigh"]


@dataclasses.dataclass
class _Plan:
    """The ``serving.autotune.ServingPlan`` surface ``apply_plan`` reads."""
    mode: str = "tile"
    T: int = 16
    max_batch: int = 2
    max_inflight: int = 1
    backend: object = "keep"

    def policy(self):
        return BucketPolicy(T=self.T, mode=self.mode)

    def build_executor(self, device=None):
        # apply_plan passes the server's device: the CPU here
        return LocalExecutor(device=device)


def test_apply_plan_prewarms_incoming_executables():
    srv = _cache_server(sweeps=2, max_batch=2)
    ticket = srv.submit(_sym(6))          # queued, below max_batch: no flush
    switch = srv.apply_plan(_Plan())
    assert switch["prewarmed"]["compile"] >= 1
    assert switch["requeued"] == 1 and ticket.bucket == (16, 16)
    assert srv.describe_plan()["T"] == 16 and srv.config.T == 16
    srv.drain()
    assert srv.stats.flush_records        # the queued request was served...
    assert all(f.cache_hit for f in srv.stats.flush_records)  # ...warm
    assert ticket.done and len(srv.stats.plan_switches) == 1


def test_apply_plan_rejects_bad_plans_and_keeps_the_queue():
    srv = _cache_server(sweeps=2, max_batch=2)
    srv.submit(_sym(6))
    for bad in (_Plan(max_inflight=0), _Plan(max_batch=0)):
        with pytest.raises(ValueError):
            srv.apply_plan(bad)
    assert srv.pending() == 1 and srv.policy.T == 8


# ---------------------------------------------------------------------------
# engine parity: one burst of each op through both servers
# ---------------------------------------------------------------------------

def _burst(op):
    """Mixed shapes over two buckets of each op (T = 8): some buckets fill
    S = 4 and flush on submit, the rest flush at drain."""
    rng = np.random.default_rng({"eigh": 1, "svd": 2, "pca": 3}[op])
    dims = [5, 7, 12, 6, 14, 8, 3, 10, 6, 11]
    if op == "eigh":
        return [_sym(n, seed=i) for i, n in enumerate(dims)]
    return [rng.standard_normal((n + 4, n)).astype(np.float32)
            for n in dims]


def _flushes(srv):
    return [(f.op, f.bucket, f.batch_size, f.padded_batch, f.cache_hit)
            for f in srv.stats.flush_records]


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_engine_retires_the_reference_flushes(op):
    mats = _burst(op)
    t = [0.0]
    jsrv = JServer(jpca.PCAConfig(T=8, S=4, sweeps=12),
                   policy=JBucketPolicy(T=8), max_delay_s=1e9,
                   clock=lambda: t[0])
    tsrv = _server(clock=lambda: t[0], max_delay_s=1e9)
    jt = [jsrv.submit(m, op=op) for m in mats]
    tt = [tsrv.submit(m, op=op) for m in mats]
    assert [k.done for k in tt] == [k.done for k in jt]
    assert tsrv.drain() == jsrv.drain()
    assert _flushes(tsrv) == _flushes(jsrv)
    assert (tsrv.stats.cache_hits, tsrv.stats.cache_misses) == \
        (jsrv.stats.cache_hits, jsrv.stats.cache_misses)
    assert [(r.rid, r.bucket, r.batch_size) for r in tsrv.stats.records] == \
        [(r.rid, r.bucket, r.batch_size) for r in jsrv.stats.records]
    field = "S" if op == "svd" else "eigenvalues"
    budget = ERROR_BUDGETS["fp32"]["svd" if op == "svd" else "eigh"]
    for m, a, b in zip(mats, tt, jt):
        got, want = a.result(), b.result()
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            assert np.shape(getattr(got, f.name)) == \
                np.shape(getattr(want, f.name)), f.name
        g = getattr(got, field)
        assert g.dtype == np.float32
        assert rel_frobenius(g, getattr(want, field)) <= budget
        m64 = m.astype(np.float64)
        if op == "eigh":
            ref = np.linalg.eigvalsh(m64)[::-1]
        elif op == "svd":
            ref = np.linalg.svd(m64, compute_uv=False)
        else:
            xs = (m64 - m64.mean(axis=0)) / m64.std(axis=0)
            ref = np.linalg.eigvalsh(xs.T @ xs)[::-1]
        assert rel_frobenius(g, ref) <= budget


@pytest.mark.parametrize("max_inflight", [1, 3])
def test_obs_hooks_emit_the_reference_spans_and_families(max_inflight):
    """The reference's observability bundle (duck-typed in the port) sees
    the same span names and metric families from both servers."""
    mats = _burst("eigh")[:7]
    docs = []
    for make in ("port", "reference"):
        obs = Observability.enabled(slo_ms=1e6)
        if make == "port":
            srv = _server(max_delay_s=1e9, obs=obs, clock=obs.clock,
                          max_inflight=max_inflight)
        else:
            srv = JServer(jpca.PCAConfig(T=8, S=4, sweeps=12),
                          policy=JBucketPolicy(T=8), max_delay_s=1e9,
                          obs=obs, clock=obs.clock, max_inflight=max_inflight)
        srv.solve_many(mats, op="eigh")
        srv.warmup([("eigh", (6, 6))])
        spans = {e.get("name") for e in obs.trace_doc()["traceEvents"]
                 if e.get("ph") != "M"}
        docs.append((spans, {f.name for f in obs.metrics.families()},
                     obs.summary()["slo"]["requests"]))
    assert docs[0] == docs[1]
    assert {"flush:eigh", "request:eigh", "dispatch", "inflight", "wait",
            "retire", "launch", "compile", "warmup"} <= docs[0][0]


# ---------------------------------------------------------------------------
# the port's own seams
# ---------------------------------------------------------------------------

def test_default_server_runs_on_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PCAServer()
    with pytest.raises(RuntimeError, match="is_available"):
        LocalExecutor()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    srv = PCAServer()                  # built, not run: nothing touches CUDA
    assert srv.executor.device.type == "cuda"
    assert srv.describe_plan()["executor"] == "local(cuda)"


def test_features_not_ported_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="DiskCache"):
        _server(cache_dir="somewhere")
    # from_spec is ported; the persistent tier and a mesh over more than
    # one device are not, through it either
    with pytest.raises(NotImplementedError, match="DiskCache"):
        PCAServer.from_spec(ServerSpec(cache=CacheSpec(
            cache_dir="somewhere")), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="MeshExecutor"):
        PCAServer.from_spec(ServerSpec(execution=ExecutionSpec(
            mesh="auto")))


def test_deprecation_shim_counts_explicit_kwargs():
    with pytest.warns(DeprecationWarning, match="3 construction kwargs"):
        PCAServer(PCAConfig(), policy=BucketPolicy(T=8), max_delay_s=1.0,
                  executor=LocalExecutor(device="cpu"))


@pytest.mark.parametrize("spec", [None, "none", "local", "1", "0", 1])
def test_mesh_executor_local_specs(spec, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ex = mesh_executor(spec)
    assert type(ex) is LocalExecutor and ex.n_shards == 1
    assert ex.device.type == "cuda"


@pytest.mark.parametrize("spec", ["auto", "2", 8])
def test_mesh_executor_other_specs_raise(spec, monkeypatch):
    # a mesh spec raises where it resolves to more than one device (on one
    # device it gives a LocalExecutor, tests/test_torch_control.py)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        mesh_executor(spec)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 4), (8, 4), (0, 3), (9, 8)])
def test_pad_to_multiple_is_the_reference(n, k):
    assert tsharding.pad_to_multiple(n, k) == jsharding.pad_to_multiple(n, k)


def test_environment_fingerprint_names_torch_cuda_and_device():
    fp = environment_fingerprint("cpu")
    assert fp == (torch.__version__, torch.version.cuda, "cpu", None)
    if not torch.cuda.is_available():
        assert environment_fingerprint() == fp


def test_local_executor_gathers_one_host_tree_on_the_cpu():
    ex = LocalExecutor(device="cpu")
    assert ex.cache_token() == ("local", "cpu")
    assert ex.round_batch(3) == 3 and ex.describe() == "local(cpu)"
    fn = ex.compile("eigh", PCAConfig(sweeps=6), (8, 8), 2)
    assert ex.compile("eigh", PCAConfig(T=64, sweeps=6), (16, 16), 4) is fn
    batch = np.stack([np.pad(_sym(n, seed=n), ((0, 8 - n), (0, 8 - n)))
                      for n in (5, 8)])
    n_active = np.array([[5, 8], [5, 8]], np.int32)
    flush = ex.submit(fn, batch, n_active)
    assert isinstance(flush, InFlightFlush)
    assert flush.ready() and flush.block_until_ready() is flush
    host = flush.result()
    assert type(host).__name__ == "BatchedEighResult"
    assert all(isinstance(v, np.ndarray) for v in host)
    assert host.eigenvalues.dtype == np.float32
    assert host.n_active.tolist() == [5, 8]
    assert flush.result() is host         # gathered once
    np.testing.assert_array_equal(ex.run(fn, batch, n_active).eigenvalues,
                                  host.eigenvalues)
    with pytest.raises(RuntimeError, match="not attached"):
        flush.retire()


def test_inflight_queue_orders_and_bounds():
    q = InFlightQueue()
    done = []

    class _Flush:
        def __init__(self, name, ready):
            self.name, self._ready, self.entries = name, ready, (1, 2)

        def ready(self):
            return self._ready

        def retire(self):
            done.append(self.name)
            q.remove(self)
            return len(self.entries)

    for name, ready in (("a", False), ("b", True), ("c", False)):
        q.push(_Flush(name, ready))
    assert q.depth == 3 and q.requests() == 6 and q.oldest().name == "a"
    assert q.retire_ready() == 2 and done == ["b"]    # out of order
    assert q.retire_to_depth(1) == 2 and done == ["b", "a"]
    assert q.retire_to_depth(0) == 2 and len(q) == 0 and q.oldest() is None


def test_threshold_router_boundaries():
    route = threshold_router(16, large="cuda", small="torch")
    assert route("eigh", (16, 16)) == "cuda"
    assert route("svd", (24, 8)) == "cuda"
    assert route("pca", (8, 8)) == "torch"
    assert threshold_router(16)("eigh", (8, 8)) is None


def test_threshold_router_resolves_auto_once_at_construction(monkeypatch):
    calls = []
    orig = tbackends.default_backend

    def counting_default():
        calls.append(1)
        return orig()

    monkeypatch.setattr(tbackends, "default_backend", counting_default)
    route = threshold_router(16)            # large="auto"
    assert calls == [1]
    for n in (8, 16, 24, 32):
        assert route("eigh", (n, n)) != "auto"
    assert calls == [1]
    srv = _server(config=PCAConfig(T=8, S=2, sweeps=14), max_delay_s=1e9,
                  backend_router=threshold_router(16, large="auto",
                                                  small=None))
    srv.solve_many([_sym(20, seed=5), _sym(20, seed=6), _sym(5)], op="eigh")
    assert {r.backend for r in srv.stats.records} == {orig(), None}


# ---------------------------------------------------------------------------
# the copied modules: stats and the fabric model
# ---------------------------------------------------------------------------

def _records(mod):
    return [mod.RequestRecord(
        rid=i, op=op, shape=shape, bucket=(16, 16), batch_size=2,
        cache_hit=bool(i % 2), t_submit=0.1 * i, t_done=0.1 * i + 0.05 * i,
        queue_s=0.01 * i, padding_waste=0.25, backend=None, n_shards=1,
        t_dispatch=0.1 * i + 0.01, inflight_depth=1 + i % 2,
        deadline=0.1 * i + 0.2, sweeps=12)
        for i, (op, shape) in enumerate([("eigh", (12, 12)), ("svd", (15, 9)),
                                         ("pca", (40, 16)), ("eigh", (5, 5))])]


def test_serving_stats_summary_is_the_reference():
    summaries = []
    for mod in (tstats, jstats):
        st = mod.ServingStats(clock=lambda: 0.0)
        for i, rec in enumerate(_records(mod)):
            st.record_request(rec)
            st.record_queue_depth(i + 1, now=0.1 * i)
            st.record_dispatch(1 + i % 2, now=0.1 * i)
            st.record_flush(rec.cache_hit, t_dispatch=rec.t_dispatch,
                            t_launched=rec.t_dispatch + 0.001,
                            t_wait=rec.t_done - 0.01, t_retire=rec.t_done,
                            batch_size=2, inflight_depth=rec.inflight_depth,
                            op=rec.op, bucket=rec.bucket, padded_batch=4)
        st.record_plan_switch({"from": {}, "to": {}}, now=1.0)
        summaries.append((st.summary(), st.predicted_vs_measured()))
    assert summaries[0] == summaries[1]
    empty = tstats.ServingStats().summary()
    assert empty == jstats.ServingStats().summary()
    assert empty["latency_p50_ms"] == 0.0


@pytest.mark.parametrize("op,shape", [("eigh", (8, 8)), ("eigh", (784, 784)),
                                      ("svd", (100, 30)), ("pca", (70000, 784)),
                                      ("pca", (16, 4))])
@pytest.mark.parametrize("fabric", ["VIRTEX_US", "ARTIX7"])
def test_predicted_seconds_is_the_reference(op, shape, fabric):
    assert tstats.ServingStats.predicted_seconds(
        op, shape, getattr(tmm, fabric)) == jstats.ServingStats \
        .predicted_seconds(op, shape, getattr(jmm, fabric))


@pytest.mark.parametrize("T,S,freq", [(4, 8, 200.0), (16, 32, 434.0),
                                      (8, 16, 300.0)])
def test_memory_model_is_the_reference(T, S, freq):
    tc, jc = (mod.FabricConfig(T=T, S=S, freq_mhz=freq) for mod in (tmm, jmm))
    assert tmm.power_w(tc) == jmm.power_w(jc)
    assert tmm.resources(tc) == jmm.resources(jc)
    for m, n in ((70000, 784), (128, 16), (1000, 33)):
        assert tmm.covariance_cycles(m, n, tc) == jmm.covariance_cycles(
            m, n, jc)
        for pivot in ("cyclic", "parallel"):
            assert tmm.jacobi_cycles(n, tc, pivot) == jmm.jacobi_cycles(
                n, jc, pivot)
        assert tmm.projection_cycles(m, n, 8, tc) == jmm.projection_cycles(
            m, n, 8, jc)
        assert tmm.pca_seconds(m, n, tc, k=8) == jmm.pca_seconds(
            m, n, jc, k=8)
