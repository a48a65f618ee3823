"""The port's persistent executable tier (``repro_torch.serving.cache``:
``DiskCache``, ``content_hash``, the two-tier ``ExecutableCache``; the
executors' ``aot_compile``/``from_record``; the kernel library kept in the
cache directory by ``kernels.build``) on the CPU.

The reference's failure-mode tests (``tests/test_serving_cache.py``:
round trip, corruption, environment drift, header mismatch, concurrent
warmers, the size cap) replayed on the port's server, then what the port
adds: the record's contents, ``content_hash`` across processes and key
parts, the kernel library's lookup order with no nvcc, the sync-free
``tol`` loop a CUDA graph holds, the engine's spans and counters of a disk
hit, a mesh executor's records, and one parity test of a disk-warmed port
replica against the reference's ``PCAServer(cache_dir=...)``.  Every port
server runs on ``device="cpu"``, where an executable is the eager solver
with its record (the graphs run on the card: ``tests/test_torch_cuda.py``).
"""
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import jacobi
from repro_torch.core.pca import PCAConfig
from repro_torch.core.precision import ERROR_BUDGETS
from repro_torch.kernels import build
from repro_torch.obs import Observability
from repro_torch.parallel.sharding import make_mesh
from repro_torch.serving import (BucketPolicy, DiskCache, LocalExecutor,
                                 MeshExecutor, PCAServer, SolverKey,
                                 TrafficProfile, aot_supported,
                                 content_hash, jacobi_eigh_batched)
import repro_torch.serving.cache as cache_mod

from _torch_parity import rel_frobenius

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.filterwarnings(
    "ignore:PCAServer\\(\\.\\.\\.\\) with:DeprecationWarning")


@pytest.fixture(autouse=True)
def _library_cache_unarmed(monkeypatch):
    """A server with a cache_dir arms the library's copy process-wide;
    each test starts and ends unarmed."""
    monkeypatch.setattr(build, "_CACHE", None)


def _sym(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def _server(tmpdir=None, sweeps=4, executor=None, **kw):
    kw.setdefault("policy", BucketPolicy(T=8))
    kw.setdefault("max_delay_s", 10.0)
    return PCAServer(PCAConfig(T=8, S=2, sweeps=sweeps),
                     cache_dir=(str(tmpdir) if tmpdir is not None else None),
                     executor=executor or LocalExecutor(device="cpu"), **kw)


def _assert_results_equal(a, b):
    for ra, rb in zip(a, b):
        for field in ra.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(ra, field),
                                          getattr(rb, field))


# ---------------------------------------------------------------------------
# the reference's failure modes
# ---------------------------------------------------------------------------

def test_aot_is_supported():
    assert aot_supported()


def test_disk_tier_round_trip_is_bitwise_identical(tmp_path):
    mats = [_sym(6), _sym(7, seed=1)]
    seeder = _server(tmp_path)
    expect = seeder.solve_many(mats, op="eigh")
    assert seeder.cache_summary()["disk"]["stores"] >= 1
    assert list(tmp_path.glob("*.json"))

    fresh = _server(tmp_path)
    got = fresh.solve_many(mats, op="eigh")
    disk = fresh.cache_summary()["disk"]
    assert disk["hits"] >= 1 and disk["errors"] == 0
    _assert_results_equal(expect, got)
    # and identical to a memory-only replica: the record round trip must
    # never touch the math
    _assert_results_equal(expect, _server().solve_many(mats, op="eigh"))


def test_corrupt_cache_entry_falls_back_and_repairs(tmp_path):
    mats = [_sym(6)]
    expect = _server(tmp_path).solve_many(mats, op="eigh")
    files = list(tmp_path.glob("*.json"))
    assert files
    for f in files:
        f.write_bytes(b"not a record")

    srv = _server(tmp_path)
    got = srv.solve_many(mats, op="eigh")
    _assert_results_equal(expect, got)
    disk = srv.cache_summary()["disk"]
    assert disk["errors"] >= 1            # quarantined the torn entry...
    assert disk["stores"] >= 1            # ...and repaired it in place

    repaired = _server(tmp_path)
    _assert_results_equal(expect, repaired.solve_many(mats, op="eigh"))
    disk = repaired.cache_summary()["disk"]
    assert disk["hits"] >= 1 and disk["errors"] == 0


def test_environment_drift_invalidates_cleanly(tmp_path, monkeypatch):
    """A different fingerprint (torch, CUDA, card, kernel sources) hashes
    to a different file name: the stale entry is simply never looked
    up."""
    mats = [_sym(6)]
    _server(tmp_path).solve_many(mats, op="eigh")
    before = set(tmp_path.glob("*.json"))

    monkeypatch.setattr(cache_mod, "environment_fingerprint",
                        lambda device=None: ("torch-9.9.9", "13.0", "card",
                                             (10, 0), "0" * 16))
    srv = _server(tmp_path)
    srv.solve_many(mats, op="eigh")
    disk = srv.cache_summary()["disk"]
    assert disk["hits"] == 0 and disk["misses"] >= 1
    assert disk["errors"] == 0            # clean miss, not a load failure
    assert set(tmp_path.glob("*.json")) > before   # stored under new hash


def test_header_version_mismatch_is_quarantined(tmp_path):
    """Defense in depth: even if the hash collided across environments,
    the in-file header is checked and a drifted entry is rejected."""
    mats = [_sym(6)]
    expect = _server(tmp_path).solve_many(mats, op="eigh")
    path = next(iter(tmp_path.glob("*.json")))
    doc = json.loads(path.read_text())
    doc["fingerprint"][0] = "0.0.1"
    path.write_text(json.dumps(doc))

    srv = _server(tmp_path)
    got = srv.solve_many(mats, op="eigh")
    _assert_results_equal(expect, got)
    disk = srv.cache_summary()["disk"]
    assert disk["errors"] >= 1 and disk["stores"] >= 1


_WARMER = """\
import sys
import warnings
warnings.simplefilter("ignore")
from repro_torch.core.pca import PCAConfig
from repro_torch.serving import (BucketPolicy, LocalExecutor, PCAServer,
                                 TrafficProfile)
srv = PCAServer(PCAConfig(T=8, S=2, sweeps=2), policy=BucketPolicy(T=8),
                max_delay_s=10.0, cache_dir=sys.argv[1],
                executor=LocalExecutor(device="cpu"))
doc = srv.warmup(TrafficProfile.from_shapes(
    [("eigh", (6, 6), 1), ("svd", (12, 6), 1)]))
assert doc["executables"] == 2, doc
print("warmed")
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT / "src"), str(REPO_ROOT / "tests"),
         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_concurrent_warmers_share_one_cache_dir(tmp_path):
    """Two replicas warming the same --cache-dir concurrently must not
    torch each other's entries (atomic write-then-rename)."""
    procs = [subprocess.Popen([sys.executable, "-c", _WARMER,
                               str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_child_env())
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("warmed" in out for out, _ in outs)
    # every surviving entry is loadable: a third replica warms with zero
    # compiles and zero quarantines
    srv = PCAServer(PCAConfig(T=8, S=2, sweeps=2), policy=BucketPolicy(T=8),
                    max_delay_s=10.0, cache_dir=str(tmp_path),
                    executor=LocalExecutor(device="cpu"))
    doc = srv.warmup(TrafficProfile.from_shapes(
        [("eigh", (6, 6), 1), ("svd", (12, 6), 1)]))
    assert doc["compile"] == 0 and doc["disk"] == doc["executables"] == 2
    assert srv.cache_summary()["disk"]["errors"] == 0


def test_disk_cache_size_cap_evicts_down_to_cap(tmp_path):
    record = {"op": "eigh", "payload": list(range(64))}
    probe = DiskCache(tmp_path / "probe")
    assert probe.put("a" * 64, record)
    entry_bytes = probe.total_bytes()

    disk = DiskCache(tmp_path / "capped", max_bytes=int(entry_bytes * 1.5))
    assert disk.put("a" * 64, record)
    assert disk.put("b" * 64, record)     # over cap: one entry evicted
    assert len(disk.entries()) == 1
    assert disk.total_bytes() <= disk.max_bytes
    assert disk.get("b" * 64) == record   # the newest survives


# ---------------------------------------------------------------------------
# records and keys
# ---------------------------------------------------------------------------

def test_record_holds_the_key_inputs_outputs_and_digest(tmp_path):
    srv = _server(tmp_path)
    srv.solve_many([np.ones((12, 6), np.float32)], op="svd")
    doc = json.loads(next(iter(tmp_path.glob("*.json"))).read_text())
    assert doc["format"] == cache_mod.CACHE_FORMAT
    assert doc["fingerprint"] == json.loads(json.dumps(
        cache_mod.environment_fingerprint()))
    assert doc["key"]["op"] == "svd" and doc["key"]["bucket"] == [16, 8]
    assert doc["key"]["executor"] == ["local", "cpu"]
    rec = doc["record"]
    assert rec["inputs"] == [["x", [2, 16, 8], "float32"],
                             ["n_rows", [2], "int32"],
                             ["n_cols", [2], "int32"]]
    assert rec["outputs"]["type"] == "BatchedSVDResult"
    assert [f[0] for f in rec["outputs"]["fields"]] == [
        "U", "S", "Vt", "n_rows", "n_cols"]
    assert rec["plan"] == {}              # no card: no kernel plan
    assert len(rec["check"]["sha256"]) == 64
    assert SolverKey(**rec["solver"]) == SolverKey.from_config(
        PCAConfig(T=8, S=2, sweeps=4))


def test_a_record_under_another_key_is_quarantined(tmp_path):
    """A record copied under another key's file name is rejected by its
    key material, not served."""
    srv = _server(tmp_path)
    srv.solve_many([_sym(6)], op="eigh")
    srv.solve_many([_sym(12)], op="eigh")
    small, large = sorted(tmp_path.glob("*.json"),
                          key=lambda p: json.loads(p.read_text())[
                              "key"]["bucket"][0])
    small.write_bytes(large.read_bytes())
    fresh = _server(tmp_path)
    expect = _server().solve_many([_sym(6)], op="eigh")
    _assert_results_equal(expect, fresh.solve_many([_sym(6)], op="eigh"))
    disk = fresh.cache_summary()["disk"]
    assert disk["errors"] == 1 and disk["stores"] == 1


_HASH = """\
import json
from repro_torch.serving import SolverKey, content_hash
from repro_torch.core.pca import PCAConfig
print(json.dumps(content_hash("eigh", (8, 8), 2,
                              SolverKey.from_config(PCAConfig(sweeps=4)),
                              ("local", "cpu"))))
"""

_BASE = ("eigh", (8, 8), 2, SolverKey.from_config(PCAConfig(sweeps=4)),
         ("local", "cpu"))


def test_content_hash_is_stable_across_processes():
    out = subprocess.run([sys.executable, "-c", _HASH], capture_output=True,
                         text=True, env=_child_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == content_hash(*_BASE)


@pytest.mark.parametrize("part,value", [
    (0, "svd"), (1, (16, 8)), (2, 4),
    (3, SolverKey.from_config(PCAConfig(sweeps=5))),
    (3, SolverKey.from_config(PCAConfig(sweeps=4, tol=1e-6))),
    (3, SolverKey.from_config(PCAConfig(sweeps=4, fused=True))),
    (4, ("local", "cuda:0")),
    (4, ("mesh", (("data", 2),), ("cpu", "cpu"))),
])
def test_content_hash_changes_with_each_part_of_the_key(part, value):
    key = list(_BASE)
    key[part] = value
    assert content_hash(*key) != content_hash(*_BASE)
    assert content_hash(*key) == content_hash(*key)


def test_content_hash_changes_with_the_kernel_sources(monkeypatch):
    before = content_hash(*_BASE)
    monkeypatch.setattr(build, "source_hash", lambda: "f" * 16)
    assert content_hash(*_BASE) != before


# ---------------------------------------------------------------------------
# the kernel library kept in the cache directory
# ---------------------------------------------------------------------------

@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """An empty build directory, nvcc that cannot be found, and a stand-in
    library file where a build would put one."""
    monkeypatch.setenv(build.BUILD_ENV, str(tmp_path / "build"))

    def refuse():
        raise AssertionError("nvcc was looked for")
    monkeypatch.setattr(build, "find_nvcc", refuse)
    lib = tmp_path / "stand-in.so"
    lib.write_bytes(b"\x7fELF stand-in library " * 64)
    return lib


def test_library_lookup_order_loads_the_cached_copy_without_nvcc(no_nvcc,
                                                                 tmp_path):
    cache = tmp_path / "cache" / build.CACHE_SUBDIR
    build._store_library(cache, no_nvcc)
    runs = build.nvcc_runs()
    build.arm_cache(cache)
    got = build.build()
    assert got == build.cached_dir(cache) / build.LIB_NAME
    assert got.read_bytes() == no_nvcc.read_bytes()
    assert build.nvcc_runs() == runs
    # the build directory comes first: a library there wins
    own = build.build_dir() / build.LIB_NAME
    own.parent.mkdir(parents=True)
    own.write_bytes(b"own build")
    assert build.build() == own


def test_library_from_other_sources_is_never_loaded(no_nvcc, tmp_path,
                                                    monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setattr(build, "source_hash", lambda: "a" * 16)
    build._store_library(cache, no_nvcc)
    # the copy's directory renamed onto this process's sources: its note
    # still names the other sources
    monkeypatch.setattr(build, "source_hash", lambda: "b" * 16)
    (cache / f"{'a' * 16}-{build.toolkit_version()}").rename(
        build.cached_dir(cache))
    build.arm_cache(cache)
    with pytest.raises(AssertionError, match="nvcc was looked for"):
        build.build()


def test_a_torn_library_copy_is_removed_not_loaded(no_nvcc, tmp_path):
    cache = tmp_path / "cache"
    build._store_library(cache, no_nvcc)
    (build.cached_dir(cache) / build.LIB_NAME).write_bytes(b"torn")
    build.arm_cache(cache)
    with pytest.raises(AssertionError, match="nvcc was looked for"):
        build.build()
    assert not (build.cached_dir(cache) / build.LIB_NAME).exists()


def test_arming_stores_a_loaded_library(no_nvcc, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_LIB_PATH", no_nvcc)
    cache = tmp_path / "cache"
    build.arm_cache(cache)
    note = json.loads((build.cached_dir(cache) / "library.json").read_text())
    assert note["source_hash"] == build.source_hash()
    assert note["toolkit"] == build.toolkit_version()
    assert build._cached_library(cache) is not None


@pytest.mark.parametrize("layout", ["version.json", "cuda.h"])
def test_toolkit_version_is_read_from_files_without_nvcc(tmp_path,
                                                         monkeypatch,
                                                         layout):
    root = tmp_path / layout
    (root / "bin").mkdir(parents=True)
    (root / "bin" / "nvcc").write_bytes(b"an nvcc binary")
    if layout == "version.json":
        (root / "version.json").write_text(json.dumps(
            {"cuda": {"version": "12.8.0"},
             "cuda_nvcc": {"version": "12.8.93"}}))
        want = "12.8.93"
    else:
        (root / "include").mkdir()
        (root / "include" / "cuda.h").write_text(
            "#define CUDA_VERSION 12080\n")
        want = "12080." + hashlib.sha256(b"an nvcc binary").hexdigest()[:12]
    monkeypatch.setattr(build.shutil, "which",
                        lambda name: str(root / "bin" / "nvcc"))
    assert build.toolkit_version() == want
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nothing"))
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        assert build.toolkit_version() == "none"


# ---------------------------------------------------------------------------
# the sync-free tol loop a graph captures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_tol_capture_form_is_bitwise_the_early_exit_solve(fused):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 10, 10)).astype(np.float32)
    C = torch.from_numpy((a + a.transpose(0, 2, 1)) / 2)
    n_active = torch.tensor([10, 7, 4, 10], dtype=torch.int32)
    kw = dict(sweeps=30, tol=1e-6, fused=fused, device="cpu")
    early = jacobi_eigh_batched(C, n_active, **kw)
    with jacobi.capture_form():
        captured = jacobi_eigh_batched(C, n_active, **kw)
    for x, y in zip(early, captured):
        assert torch.equal(x, y)
    # the early exit did leave sweeps unrun (the forms differ in work)
    assert float(early.off_norm.max()) <= 1e-6


def test_capture_form_nests_and_restores():
    assert not getattr(jacobi._CAPTURE, "on", False)
    with jacobi.capture_form():
        with jacobi.capture_form():
            assert jacobi._CAPTURE.on
        assert jacobi._CAPTURE.on
    assert not jacobi._CAPTURE.on


# ---------------------------------------------------------------------------
# the engine over the disk tier
# ---------------------------------------------------------------------------

def test_disk_hit_records_an_aot_load_span_and_the_disk_counter(tmp_path):
    mats = [_sym(6)]
    _server(tmp_path).solve_many(mats, op="eigh")
    obs = Observability.enabled()
    srv = _server(tmp_path, obs=obs)
    srv.solve_many(mats, op="eigh")
    names = [e["name"] for e in obs.trace_doc()["traceEvents"]
             if e.get("ph") == "X"]
    assert "aot_load" in names and "compile" not in names
    prom = obs.prometheus_text()
    assert 'serve_cache_disk_total{event="hit"} 1' in prom
    # a miss with the tier armed is a compile span and a disk miss
    obs2 = Observability.enabled()
    _server(tmp_path, obs=obs2).solve_many([_sym(12)], op="eigh")
    assert 'serve_cache_disk_total{event="miss"} 1' in \
        obs2.prometheus_text()


def test_warmup_and_apply_plan_count_disk_hits(tmp_path):
    from repro_torch.serving import ServingPlan
    profile = TrafficProfile.from_shapes([("eigh", (6, 6), 3),
                                          ("pca", (20, 5), 1)])
    seeded = _server(tmp_path).warmup(profile)
    assert seeded["compile"] == seeded["executables"] == 2
    warm = _server(tmp_path)
    doc = warm.warmup(profile)
    assert doc["disk"] == 2 and doc["compile"] == 0
    # a swap onto the seeder's plan pre-warms from memory; a fresh server
    # swapping onto it pre-warms from disk
    fresh = _server(tmp_path, policy=BucketPolicy(T=4))
    plan = ServingPlan(mode="tile", T=8, pow2_cap=None, max_batch=2,
                       max_inflight=1, mesh="none")
    switch = fresh.apply_plan(plan, warm_profile=profile)
    assert switch["prewarmed"]["disk"] == 2
    assert switch["prewarmed"]["compile"] == 0


def test_clear_memory_serves_again_from_disk(tmp_path):
    mats = [_sym(6)]
    srv = _server(tmp_path)
    first = srv.solve_many(mats, op="eigh")
    srv._cache.clear_memory()
    assert len(srv._cache) == 0
    _assert_results_equal(first, srv.solve_many(mats, op="eigh"))
    assert srv.cache_summary()["disk"]["hits"] == 1


def test_mesh_executor_round_trips_its_records(tmp_path):
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    mats = [_sym(6, seed=i) for i in range(3)]
    seeder = _server(tmp_path, executor=MeshExecutor(mesh=mesh))
    expect = seeder.solve_many(mats, op="eigh")
    doc = json.loads(next(iter(tmp_path.glob("*.json"))).read_text())
    assert doc["record"]["rows"] * 2 == doc["record"]["batch"] == 2
    assert doc["key"]["executor"][0] == "mesh"
    fresh = _server(tmp_path, executor=MeshExecutor(mesh=mesh))
    _assert_results_equal(expect, fresh.solve_many(mats, op="eigh"))
    assert fresh.cache_summary()["disk"]["hits"] == 1
    _assert_results_equal(expect, _server().solve_many(mats, op="eigh"))


def test_local_executor_refuses_a_mesh_record(tmp_path):
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    ex = MeshExecutor(mesh=mesh)
    rec = ex.aot_compile("eigh", PCAConfig(sweeps=2), (8, 8), 2).record
    with pytest.raises(cache_mod.StaleRecord):
        LocalExecutor(device="cpu").from_record(rec)
    assert LocalExecutor(device="cpu").aot_compile(
        "eigh", PCAConfig(sweeps=2), (8, 8), 2).record["rows"] == 2


# ---------------------------------------------------------------------------
# parity with the reference's persistent tier
# ---------------------------------------------------------------------------

def _traffic(op):
    rng = np.random.default_rng({"eigh": 1, "svd": 2, "pca": 3}[op])
    if op == "eigh":
        out = []
        for n in (5, 8, 7, 6):
            a = rng.standard_normal((n, n)).astype(np.float32)
            out.append((a + a.T) / 2)
        return out
    return [rng.standard_normal((n + 6, n)).astype(np.float32)
            for n in (5, 8, 7, 6)]


def test_disk_warmed_replica_matches_the_reference_cache_dir(tmp_path):
    from repro.core import pca as jpca
    from repro.serving import BucketPolicy as JBucketPolicy
    from repro.serving import PCAServer as JServer
    from repro.serving import TrafficProfile as JProfile
    import repro.serving as jserving
    if not jserving.aot_supported():
        pytest.fail("the reference's persistent tier is not available")
    shapes = [(op, m.shape, 1) for op in ("eigh", "svd", "pca")
              for m in _traffic(op)]
    # the reference: a seeder, then a replica warmed from its directory
    jdir = tmp_path / "ref"
    jcfg = jpca.PCAConfig(T=8, S=4, sweeps=12)
    JServer(jcfg, policy=JBucketPolicy(T=8), max_delay_s=10.0,
            cache_dir=str(jdir)).warmup(JProfile.from_shapes(shapes))
    jwarm = JServer(jcfg, policy=JBucketPolicy(T=8), max_delay_s=10.0,
                    cache_dir=str(jdir))
    jdoc = jwarm.warmup(JProfile.from_shapes(shapes))
    # the port: the same
    tdir = tmp_path / "port"
    tcfg = PCAConfig(T=8, S=4, sweeps=12)
    PCAServer(tcfg, policy=BucketPolicy(T=8), max_delay_s=10.0,
              cache_dir=str(tdir), executor=LocalExecutor(device="cpu")
              ).warmup(TrafficProfile.from_shapes(shapes))
    twarm = PCAServer(tcfg, policy=BucketPolicy(T=8), max_delay_s=10.0,
                      cache_dir=str(tdir),
                      executor=LocalExecutor(device="cpu"))
    tdoc = twarm.warmup(TrafficProfile.from_shapes(shapes))
    assert {k: tdoc[k] for k in ("executables", "memory", "disk",
                                 "compile")} == \
        {k: jdoc[k] for k in ("executables", "memory", "disk", "compile")}
    assert tdoc["disk"] == tdoc["executables"] and tdoc["compile"] == 0
    for op in ("eigh", "svd", "pca"):
        mats = _traffic(op)
        got = twarm.solve_many(mats, op=op)
        want = jwarm.solve_many(mats, op=op)
        field = "S" if op == "svd" else "eigenvalues"
        budget = ERROR_BUDGETS["fp32"]["svd" if op == "svd" else "eigh"]
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            for f in dataclasses.fields(w):
                assert np.shape(getattr(g, f.name)) == \
                    np.shape(getattr(w, f.name)), f.name
            assert rel_frobenius(getattr(g, field),
                                 getattr(w, field)) <= budget
    assert twarm.stats.summary()["cache_hit_rate"] == \
        jwarm.stats.summary()["cache_hit_rate"] == 1.0


def test_a_malformed_record_is_quarantined_and_a_failing_load_raises(
        tmp_path, monkeypatch):
    """A record missing its fields is stale (quarantined, rebuilt); an
    error of the executor's build (as a capture that fails) is raised,
    never served around."""
    mats = [_sym(6)]
    expect = _server(tmp_path).solve_many(mats, op="eigh")
    path = next(iter(tmp_path.glob("*.json")))
    doc = json.loads(path.read_text())
    del doc["record"]["rows"]
    path.write_text(json.dumps(doc))
    srv = _server(tmp_path)
    _assert_results_equal(expect, srv.solve_many(mats, op="eigh"))
    assert srv.cache_summary()["disk"]["errors"] == 1

    def failing(self, record):
        raise ValueError("jacobi_sweep_step: the capture failed")
    monkeypatch.setattr(LocalExecutor, "from_record", failing)
    with pytest.raises(ValueError, match="the capture failed"):
        _server(tmp_path).solve_many(mats, op="eigh")
    assert path.exists()
