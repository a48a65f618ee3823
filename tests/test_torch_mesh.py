"""The port's multi-device PCA path against the reference's, on the CPU.

The reference runs once, in one subprocess with 8 forced host devices
(``tests/_mesh.py``): ``distributed_covariance`` and ``fit_distributed``
over its 8-way mesh, a single-device serving flush, ``pick_mesh`` and
``make_host_mesh`` over a table of device counts.  The port runs in this
process on a ``Mesh`` of 8 virtual CPU devices (the CPU device repeated),
where every shard is its own slab and its own solve, as on 8 cards.

Contracts: the distributed Gram within relative Frobenius 1e-6 of the
reference's and of the port's one-device Gram; ``fit_distributed``'s
eigenvalues within relative Frobenius 1e-5 of the reference's and its
leading eigenvectors spanning the same subspace; the 8-shard flush bitwise
the port's ``LocalExecutor`` flush and within 1e-5 of the reference's
single-device flush, field by field (relative to the field's largest entry
where that is above 1; vectors up to sign); the reference's own 8-way ``pca`` flush is not a
yardstick (under jax 0.9.0 it is 1.46 away from its local flush);
``Rules``, ``pick_mesh``, ``make_host_mesh`` and ``mesh_executor`` return
what the reference's return.
"""
import dataclasses
import importlib
import textwrap

import numpy as np
import pytest
import torch

from _mesh import run_in_mesh_subprocess
from _torch_parity import rel_frobenius
from repro.parallel import sharding as jsharding
from repro_torch.core import (PCAConfig, covariance, distributed_covariance,
                              fit_distributed, standardize)
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import (Mesh, REPLICATED, Rules, batch_axes,
                                  make_mesh, rules_for_mesh)
from repro_torch.runtime import pick_mesh
from repro_torch.serving import (BucketPolicy, InFlightFlush, LocalExecutor,
                                 MeshExecutor, PCAServer, host_mesh,
                                 mesh_executor)

pytestmark = pytest.mark.filterwarnings(
    "ignore:PCAServer\\(\\.\\.\\.\\) with:DeprecationWarning")

# the inputs, built by the same source in the reference's subprocess
INPUTS = """
def mesh_inputs():
    rng = np.random.default_rng(0)
    x_cov = rng.standard_normal((256, 24)).astype(np.float32)
    rng = np.random.default_rng(1)
    x_fit = (rng.standard_normal((256, 4))
             @ rng.standard_normal((4, 12))).astype(np.float32)
    rng = np.random.default_rng(2)
    sym = [0.5 * (a + a.T) for a in
           [rng.standard_normal((6, 6)).astype(np.float32)
            for _ in range(8)]]
    rect = [rng.standard_normal((16, d)).astype(np.float32)
            for d in (5, 7, 6, 4, 5, 7, 6, 4)]
    return {"x_cov": x_cov, "x_fit": x_fit,
            "flush": {"eigh": sym, "svd": rect, "pca": rect}}
"""
SERVE = dict(T=8, S=8, sweeps=14)
FIT = dict(T=32, sweeps=15)
# (devices, model_parallel, global_batch) for pick_mesh
PICKS = [(8, 1, None), (8, 2, None), (8, 4, None), (8, 8, None),
         (8, 3, None), (8, 16, None), (8, 2, 4), (8, 1, 3), (8, 2, 6),
         (6, 4, None), (6, 2, 3), (5, 2, None), (4, 8, 2), (1, 2, None)]
HOST_MODELS = (1, 2, 4, 8)


def _inputs():
    ns = {"np": np}
    exec(INPUTS, ns)
    return ns["mesh_inputs"]()


@pytest.fixture(scope="module")
def ref():
    """Every reference number, from one 8-device subprocess."""
    return run_in_mesh_subprocess(INPUTS + textwrap.dedent(f"""
        import dataclasses
        from repro.core import (PCAConfig, distributed_covariance,
                                fit_distributed)
        from repro.launch.mesh import make_host_mesh
        from repro.runtime.elastic import pick_mesh
        from repro.serving import BucketPolicy, PCAServer
        inp = mesh_inputs()
        mesh = jax.make_mesh((8,), ("data",))
        out = {{"n_devices": jax.device_count()}}
        out["cov"] = np.asarray(distributed_covariance(
            jnp.asarray(inp["x_cov"]), mesh, block_m=16)).tolist()
        res = fit_distributed(jnp.asarray(inp["x_fit"]), mesh,
                              PCAConfig(**{FIT!r}))
        out["fit"] = {{"eigenvalues": np.asarray(res.eigenvalues).tolist(),
                       "components": np.asarray(res.components).tolist()}}
        local = PCAServer(PCAConfig(**{SERVE!r}), policy=BucketPolicy(T=8),
                          max_batch=8, max_delay_s=1e9)
        out["flush"] = {{}}
        for op, mats in inp["flush"].items():
            out["flush"][op] = [
                {{f.name: np.asarray(getattr(r, f.name)).tolist()
                  for f in dataclasses.fields(r)}}
                for r in local.solve_many(mats, op=op)]
        out["picks"] = [dict(pick_mesh(mp, devices=jax.devices()[:n],
                                       global_batch=gb).shape)
                        for n, mp, gb in {PICKS!r}]
        out["host"] = [dict(make_host_mesh(model).shape)
                       for model in {HOST_MODELS!r}]
        print(json.dumps(out))
    """))


def _cpu_mesh(n: int = 8, axes=("data",), shape=None) -> Mesh:
    return make_mesh(shape or (n,), axes, ["cpu"] * n)


# -- the mesh ------------------------------------------------------------------

def test_reference_ran_on_eight_devices(ref):
    assert ref["n_devices"] == 8


def test_mesh_holds_devices_on_named_axes():
    mesh = _cpu_mesh(8, ("data", "model"), (4, 2))
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    assert list(mesh.shape) == ["data", "model"] and mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_mesh_rejects_repeated_cuda_devices():
    """Two entries of one card would be one device counted twice; only
    the CPU device repeats (virtual host devices).  Building a mesh of
    CUDA devices touches no card."""
    with pytest.raises(ValueError, match="distinct"):
        Mesh(np.array([torch.device("cuda", 0), torch.device("cuda", 0)],
                      dtype=object), ("data",))
    with pytest.raises(ValueError, match="distinct"):
        Mesh(np.array(["cuda", "cuda:0"], dtype=object), ("data",))
    mesh = Mesh(np.array(["cuda:1", "cuda:0"], dtype=object), ("data",))
    assert [str(d) for d in mesh.devices.flat] == ["cuda:1", "cuda:0"]
    with pytest.raises(ValueError, match="one type"):
        Mesh(np.array(["cpu", "cuda:0"], dtype=object), ("data",))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 2, dtype=object), ("data", "model"))


def test_make_mesh_needs_exactly_its_devices():
    with pytest.raises(ValueError, match="needs 8 devices; 6"):
        make_mesh((4, 2), ("data", "model"), ["cpu"] * 6)
    with pytest.raises(ValueError, match="needs 256 devices; 8"):
        tmesh.make_production_mesh(devices=["cpu"] * 8)
    assert dict(tmesh.make_production_mesh(devices=["cpu"] * 256).shape) \
        == {"data": 16, "model": 16}
    assert dict(tmesh.make_production_mesh(
        multi_pod=True, devices=["cpu"] * 512).shape) == {
        "pod": 2, "data": 16, "model": 16}


def test_meshes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tmesh.make_production_mesh, tmesh.make_host_mesh,
                 lambda: pick_mesh(1), lambda: host_mesh(),
                 lambda: MeshExecutor()):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in host_mesh().devices.flat] == ["cuda:0", "cuda:1"]
    assert host_mesh(8).size == 2 and host_mesh(1).size == 1
    assert host_mesh(device="cpu").size == 1
    assert dict(tmesh.make_host_mesh(2).shape) == {"data": 1, "model": 2}


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model"), ()])
def test_rules_resolve_every_role_as_the_reference(axes):
    roles = [None, "batch", "fsdp", "tp", "vocab", "expert", "seq",
             "seq_tp", "layers"]
    for fsdp in (True, False):
        for tensor in (True, False):
            for sod in (True, False):
                kw = dict(mesh_axes=axes, fsdp=fsdp, tensor=tensor,
                          seq_over_data=sod)
                port, want = Rules(**kw), jsharding.Rules(**kw)
                for role in roles:
                    assert port.axis(role) == want.axis(role), (kw, role)
                assert port.spec(*roles) == tuple(
                    want.axis(r) for r in roles)
                with pytest.raises(ValueError, match="unknown"):
                    port.axis("bogus")
    assert REPLICATED.axis("batch") == jsharding.REPLICATED.axis("batch")


def test_rules_for_mesh_and_the_lm_half():
    mesh = _cpu_mesh(8, ("data", "model"), (4, 2))
    rules = rules_for_mesh(mesh)
    assert rules.mesh is mesh and rules.mesh_axes == ("data", "model")
    assert rules.axis("batch") == ("data",)
    x = torch.ones(2)
    assert REPLICATED.shard(x, "batch") is x and rules.shard(None) is None
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        rules.shard(x, "batch")


def test_batch_axes_leads_with_the_batch_role():
    from repro_torch.serving.solver import BatchedEighResult
    tree = BatchedEighResult(torch.zeros(4, 3), torch.zeros(4, 3, 3),
                             torch.zeros(4), torch.zeros(4))
    axes = batch_axes(tree)
    assert type(axes) is BatchedEighResult
    assert tuple(axes) == (("batch", None), ("batch", None, None),
                           ("batch",), ("batch",))
    assert batch_axes({"x": torch.zeros(2, 5)}) == {"x": ("batch", None)}


def test_pick_mesh_is_the_references(ref):
    got = [dict(pick_mesh(mp, devices=["cpu"] * n, global_batch=gb).shape)
           for n, mp, gb in PICKS]
    assert got == ref["picks"]


def test_make_host_mesh_is_the_references(ref):
    got = [dict(tmesh.make_host_mesh(model, devices=["cpu"] * 8).shape)
           for model in HOST_MODELS]
    assert got == ref["host"]
    with pytest.raises(ValueError, match="model axes of 3"):
        tmesh.make_host_mesh(3, devices=["cpu"] * 8)


# -- data-parallel fit ---------------------------------------------------------

def test_distributed_covariance_matches_the_reference(ref):
    x = torch.from_numpy(_inputs()["x_cov"])
    got = distributed_covariance(x, _cpu_mesh(), block_m=16)
    assert got.shape == (24, 24) and got.device.type == "cpu"
    assert rel_frobenius(got, np.asarray(ref["cov"])) <= 1e-6
    assert rel_frobenius(got, covariance(x)) <= 1e-6
    # numpy input, and a (data, model) mesh: 4 data shards, model replicas
    # computed once, the same Gram
    got2 = distributed_covariance(_inputs()["x_cov"],
                                  _cpu_mesh(8, ("data", "model"), (4, 2)),
                                  block_m=16)
    assert rel_frobenius(got2, covariance(x)) <= 1e-6


def test_distributed_covariance_sums_the_shards_in_order(monkeypatch):
    """Each shard is ``blocked_covariance`` of its own contiguous rows
    with the caller's ``block_m`` and ``matmul_fn``; C is their sum in
    shard order."""
    tcov = importlib.import_module("repro_torch.core.covariance")
    x = torch.from_numpy(_inputs()["x_cov"])
    seen = []
    real = tcov.blocked_covariance

    def spy(xs, **kw):
        seen.append((xs.clone(), kw))
        return real(xs, **kw)

    monkeypatch.setattr(tcov, "blocked_covariance", spy)
    mm = torch.matmul
    got = tcov.distributed_covariance(x, _cpu_mesh(4), block_m=16,
                                      matmul_fn=mm)
    assert [torch.equal(s, x[64 * i:64 * (i + 1)])
            for i, (s, _) in enumerate(seen)] == [True] * 4
    assert all(kw == {"block_m": 16, "matmul_fn": mm} for _, kw in seen)
    want = real(x[:64], block_m=16)
    for i in range(1, 4):
        want = want + real(x[64 * i:64 * (i + 1)], block_m=16)
    assert torch.equal(got, want)


def test_distributed_covariance_needs_rows_that_divide():
    x = torch.from_numpy(_inputs()["x_cov"])[:250]
    with pytest.raises(ValueError, match="250 rows"):
        distributed_covariance(x, _cpu_mesh(), block_m=16)
    with pytest.raises(ValueError, match="data_axis"):
        distributed_covariance(x[:248], _cpu_mesh(), data_axis="model")


def test_fit_distributed_matches_the_reference(ref):
    x = _inputs()["x_fit"]
    res = fit_distributed(x, _cpu_mesh(), PCAConfig(**FIT))
    want_w = np.asarray(ref["fit"]["eigenvalues"])
    assert rel_frobenius(res.eigenvalues, want_w) <= 1e-5
    # rank 4: the leading four eigenvectors span the reference's subspace
    # (the other eight eigenvalues are zero, their vectors any basis)
    got_v = res.components[:, :4].double().numpy()
    want_v = np.asarray(ref["fit"]["components"])[:, :4]
    gap = np.linalg.norm(got_v @ got_v.T - want_v @ want_v.T)
    assert gap <= 1e-4, gap
    # and numpy's float64 answer on the same standardized data
    xs, _, _ = standardize(torch.from_numpy(x).double())
    w64 = np.linalg.eigvalsh((xs.T @ xs).numpy())[::-1]
    assert rel_frobenius(res.eigenvalues, w64) <= 1e-4
    np.testing.assert_allclose(res.cvcr[-1].item(), 1.0, rtol=1e-6)


def test_fit_distributed_ignores_fused_and_backend():
    """As the reference's: the Gram streams through ``torch.matmul`` and
    the solve is the unfused Jacobi, whatever ``fused`` and ``backend``
    say -- so the results are bitwise those of the plain config."""
    x = _inputs()["x_fit"]
    plain = fit_distributed(x, _cpu_mesh(), PCAConfig(**FIT))
    routed = fit_distributed(x, _cpu_mesh(), PCAConfig(
        **FIT, fused=True, backend="torch"))
    for g, w in zip(routed, plain):
        assert torch.equal(g, w)
    raw = fit_distributed(x, _cpu_mesh(4), PCAConfig(**FIT,
                                                     standardize=False))
    assert torch.equal(raw.mean, torch.zeros(12))
    assert torch.equal(raw.scale, torch.ones(12))


# -- the sharded flush ---------------------------------------------------------

def _server(executor, **kw):
    kw = {"max_batch": 8, "max_delay_s": 1e9, **kw}
    return PCAServer(PCAConfig(**SERVE), policy=BucketPolicy(T=8),
                     executor=executor, **kw)


@pytest.fixture(scope="module")
def flushes():
    """The three ops' bursts through an 8-shard server (max_inflight 3)
    and through a local one."""
    sharded = _server(MeshExecutor(mesh=_cpu_mesh()), max_inflight=3)
    local = _server(LocalExecutor(device="cpu"))
    out = {}
    for op, mats in _inputs()["flush"].items():
        out[op] = (sharded.solve_many(mats, op=op),
                   local.solve_many(mats, op=op))
    return sharded, out


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_sharded_flush_is_bitwise_the_local_flush(flushes, op):
    _, out = flushes
    got, want = out[op]
    for g, w in zip(got, want):
        fields = [f.name for f in dataclasses.fields(g)]
        assert fields
        for f in fields:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f"{op}.{f}")


@pytest.mark.parametrize("op", ["eigh", "svd", "pca"])
def test_sharded_flush_matches_the_references_single_device_flush(
        flushes, ref, op):
    """Every field of every result within 1e-5, absolute up to magnitude
    1 and relative to the field's largest entry above it (a pca request's
    eigenvalues reach about 40: fp32's ulp there is 4e-6).  Singular and
    eigenvectors count up to the sign of each vector: a rotation angle
    near zero may take the other branch in the two packages' fp32."""
    _, out = flushes
    for i, (g, w) in enumerate(zip(out[op][0], ref["flush"][op])):
        for f, want in w.items():
            got = np.asarray(getattr(g, f), np.float64)
            want = np.asarray(want, np.float64)
            if f in ("eigenvectors", "components", "U", "Vt"):
                axis = 1 if f == "Vt" else 0   # Vt's vectors are its rows
                sign = np.sign(np.sum(got * want, axis=axis, keepdims=True))
                got = got * np.where(sign == 0, 1.0, sign)
            err = np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))
            assert err <= 1e-5, (op, i, f, err)


def test_sharded_flush_ran_on_eight_shards(flushes):
    sharded, _ = flushes
    assert sorted({r.n_shards for r in sharded.stats.records}) == [8]
    assert sharded.inflight() == 0
    assert sharded.describe_plan()["executor"] == "mesh(data=8; 8 shards)"


def test_cache_isolation_across_mesh_shapes_and_partial_flush():
    """One server, three executors (local, 2-wide, 4-wide): a solver
    each.  A partial flush of 3 on 8 shards pads to 8 with inert zero
    problems and reports the live batch."""
    mats = _inputs()["flush"]["eigh"]
    want = [np.linalg.eigh(m)[0][::-1] for m in mats]
    srv = _server(LocalExecutor(device="cpu"))
    for ex in (None, MeshExecutor(mesh=_cpu_mesh(2)),
               MeshExecutor(mesh=_cpu_mesh(4))):
        if ex is not None:
            srv.executor = ex
        for r, w in zip(srv.solve_many(mats), want):
            np.testing.assert_allclose(r.eigenvalues, w, rtol=1e-3,
                                       atol=1e-3)
    assert len(srv._cache) == 3
    srv8 = _server(MeshExecutor(mesh=_cpu_mesh()), pad_batches=False)
    tickets = [srv8.submit(m) for m in mats[:3]]
    srv8.drain()
    for t, w in zip(tickets, want):
        np.testing.assert_allclose(t.result().eigenvalues, w, rtol=1e-3,
                                   atol=1e-3)
    assert sorted(k[2] for k in srv8._cache) == [8]
    assert sorted({r.batch_size for r in srv8.stats.records}) == [3]
    assert srv8.warmup_keys([("eigh", (6, 6))])[0][2] == 8


def test_mesh_executor_rounds_validates_and_names_itself():
    ex = MeshExecutor(mesh=_cpu_mesh())
    assert ex.n_shards == 8 and ex.device == torch.device("cpu")
    assert [ex.round_batch(b) for b in (0, 1, 3, 8, 9)] == [8, 8, 8, 8, 16]
    with pytest.raises(ValueError, match="multiple"):
        ex.compile("eigh", PCAConfig(**SERVE), (8, 8), 9)
    fns = ex.compile("eigh", PCAConfig(**SERVE), (8, 8), 16)
    assert len(fns) == 8 and len(set(map(id, fns))) == 1  # one CPU device
    assert ex.compile("eigh", PCAConfig(**SERVE), (16, 16), 8) == fns
    assert ex.describe() == "mesh(data=8; 8 shards)"
    with pytest.raises(ValueError, match="data_axis"):
        MeshExecutor(mesh=_cpu_mesh(), data_axis="model")
    with pytest.raises(ValueError, match="batch role"):
        MeshExecutor(mesh=_cpu_mesh(2, ("model",)), data_axis="model")
    two_d = MeshExecutor(mesh=_cpu_mesh(8, ("data", "model"), (4, 2)))
    assert two_d.n_shards == 4 and len(two_d.shard_devices) == 4
    pod = MeshExecutor(mesh=_cpu_mesh(8, ("pod", "data", "model"),
                                      (2, 2, 2)))
    assert pod.n_shards == 4
    tokens = {LocalExecutor(device="cpu").cache_token(),
              MeshExecutor(mesh=_cpu_mesh(1)).cache_token(),
              MeshExecutor(mesh=_cpu_mesh(2)).cache_token(),
              two_d.cache_token(), pod.cache_token()}
    assert len(tokens) == 5


def test_mesh_executor_builds_one_solver_per_device(monkeypatch):
    """On distinct cards every shard gets its own solver, built on its
    card (built, not run: nothing touches CUDA)."""
    from repro_torch.serving import sharded as sharded_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    built = []
    monkeypatch.setattr(sharded_mod, "build_solver_fn",
                        lambda op, cfg, device: built.append(device)
                        or (lambda *a: None))
    ex = mesh_executor("auto")
    assert ex.n_shards == 4 and ex.device == torch.device("cuda", 0)
    fns = ex.compile("eigh", PCAConfig(**SERVE), (8, 8), 8)
    assert len(fns) == 4 and [str(d) for d in built] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    ex.compile("eigh", PCAConfig(**SERVE), (16, 16), 4)
    assert len(built) == 4  # one per (op, SolverKey, device)


def test_mesh_submit_makes_no_host_sync_and_carries_every_shard(
        monkeypatch):
    """``submit`` launches every shard and returns without reading a
    result: any device-to-host read or wait during it raises.  The flush
    holds one result tree a shard and concatenates them in order."""
    ex = MeshExecutor(mesh=_cpu_mesh(4))
    mats = _inputs()["flush"]["eigh"]
    from repro_torch.serving.batching import stack_requests
    batch, n_active = stack_requests(mats, (8, 8))
    fns = ex.compile("eigh", PCAConfig(**SERVE), (8, 8), 8)

    def forbidden(*a, **k):
        raise AssertionError("host sync in submit")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "__bool__"):
            m.setattr(torch.Tensor, name, forbidden)
        m.setattr(torch.cuda, "synchronize", forbidden)
        m.setattr(InFlightFlush, "result", forbidden)
        m.setattr(InFlightFlush, "block_until_ready", forbidden)
        flush = ex.submit(fns, batch, n_active)
    assert isinstance(flush, InFlightFlush) and flush.n_shards == 4
    assert flush.ready()
    host = flush.result()
    assert host.eigenvalues.shape == (8, 8)
    want = LocalExecutor(device="cpu").run(
        LocalExecutor(device="cpu").compile("eigh", PCAConfig(**SERVE),
                                            (8, 8), 8), batch, n_active)
    for g, w in zip(host, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="multiple"):
        ex.submit(fns, batch[:6], n_active[:, :6])
