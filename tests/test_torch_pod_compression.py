"""The port's cross-pod compressed gradient exchange
(``repro_torch.launch.pod_compression`` and ``compress_tree`` with
``axis_name``) against the reference's ``repro.launch.pod_compression.
build``.

The port runs on a 2 x 2 x 2 ("pod", "data", "model") mesh of 8 gloo
processes on the CPU (``tests/_torch_dist.py``; the body in
``tests/_torch_dist_cases.py``), both modes in one world; the reference
runs its own ``build``, compiled and called, in a child with 8 forced
host devices on a mesh of ``AxisType.Auto`` axes (``tests/_mesh.py``;
jax 0.9's default ``Explicit`` axes reject its sharded code).  The two
run at once.  The cell is the reference's granite-8b at
``REDUCED_WIDTHS`` (d 256, d_ff 1024, vocab 1024, head dim 64), 2 layers,
fp32, seq 64, global batch 16, rank 4: at ``reduced_config``'s own
widths no leaf reaches ``min_size`` 65536.  The weights are the
reference's; each pod's state (Q and error feedback) is drawn with numpy,
the pods differently, and handed to both packages.

Held: each mode's all-reduce bytes a device exactly the reference's HLO
count (19,408,896 and 10,144,768); the exchanged gradients, those that
reach ``adamw.update``, against ``jax.grad`` on each rank's rows (the
mean over the ranks within ``GRAD_TOL`` relative Frobenius a leaf, a
compressed leaf's P Qn^T within ``STATE_TOL``); the new state of each
pod within ``STATE_TOL``; the new parameters within ``PARAM_LRS`` x the
step's learning rate elementwise (Adam's first step is
lr * g / (|g| + eps), so this bound sees the gradient's sign but not its
scale; the gradients' check sees the scale); every rank's parameters
equal and each pod's ranks' state equal, the pods' error feedback
apart.  The CLI runs in the same
world (its bytes those of the leaves' sizes) and raises for a ``--mesh``
or ``--batch`` that does not fit the world.  Single-process cases: the
local path bitwise, a world of one with ``axis_name="pod"`` bitwise the
local path with 0 bytes, the raises without a mesh or an axis, and the
CLI on a world of one.
"""
import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import convert
from repro_torch.launch import pod_compression as pc
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import Mesh

from _mesh import run_in_mesh_subprocess
from _torch_dist import run_world
from _torch_parity import ref_lm_params, rel_frobenius

LAYERS, SEQ, BATCH, RANK = 2, 64, 16, 4
STATE_TOL = 1e-4
GRAD_TOL = 1e-5
PARAM_LRS = 0.5
CLI = ["--device", "cpu", "--mesh", "2,2,2", "--reduced", "--layers", "1",
       "--seq", "16", "--batch", "8", "--rank", "4", "--steps", "2"]

_REF_BODY = """
jax.devices()   # the backend holds 8 devices before the module below
                # sets XLA_FLAGS to 512 when it is imported
import dataclasses, pathlib
from jax.sharding import AxisType
from repro import configs as jconfigs
from repro.launch import pod_compression as pc
from repro.launch.dryrun import collective_bytes
from repro.models import transformer as tfm
from repro.optim import compression as comp
from repro.parallel.sharding import REPLICATED, use_mesh
from repro_torch import convert

tmp = pathlib.Path({tmp!r})
inputs = np.load(tmp / "pod_inputs.npz")
cfg = dataclasses.replace(jconfigs.reduced_config("granite-8b", **{widths!r}),
                          n_layers={layers}, remat=False)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
state = {{k[2:]: inputs[k] for k in inputs.files if k.startswith("p/")}}
params = jax.tree.map(jnp.asarray, convert.lm_tree(state, cfg))
tokens = jnp.asarray(inputs["tokens"], jnp.int32)
like = comp.init_state(params, comp.CompressionConfig(
    rank={rank}, min_size=65536), jax.random.PRNGKey(0))

def dotted(path):
    return ".".join(part[2:-2] for part in path)

def leaves(tree, w):
    return {{p: None if v is None else jnp.asarray(inputs[f"{{w}}/{{dotted(p)}}"])
            for p, v in tree.items()}}

comp_state = comp.CompressionState(q=leaves(like.q, "q"),
                                   error=leaves(like.error, "e"))
out, arrays, states = {{}}, {{}}, {{}}
for mode in ("baseline", "compressed"):
    fn, in_sh, ab = pc.build(cfg, mesh, {seq}, {batch}, mode, {rank})
    with use_mesh(mesh):
        compiled = jax.jit(fn, in_shardings=in_sh).lower(*ab).compile()
        new_p, new_s = compiled(*jax.device_put((params, tokens, comp_state),
                                                in_sh))
    out[mode] = collective_bytes(compiled.as_text())
    states[mode] = new_s
    arrays.update({{f"{{mode}}/p/{{k}}": np.asarray(v) for k, v in
                   convert.lm_state_dict(jax.tree.map(np.asarray, new_p),
                                         cfg).items()}})
    if mode == "compressed":
        for w, tree in (("q", new_s.q), ("e", new_s.error)):
            arrays.update({{f"{{w}}/{{dotted(p)}}": np.asarray(v)
                           for p, v in tree.items() if v is not None}})

# the exchanged gradients: each rank's jax.grad on its rows (tok_spec's
# order, "pod" major), their mean over the 8 ranks (baseline, and the exact
# leaves of either mode), and each pod's P Qn^T: its ranks' mean plus the old
# error feedback less the reference's new one
rows = {batch} // 8
grad = jax.jit(jax.grad(
    lambda p, t: tfm.loss_fn(p, {{"tokens": t}}, cfg, REPLICATED)[0]))
per_rank = [comp._flatten(grad(params, tokens[r * rows:(r + 1) * rows]))
            for r in range(8)]

def mean(flats):
    return {{p: sum(f[p] for f in flats) / len(flats) for p in flats[0]}}

g_all = mean(per_rank)
arrays.update({{f"baseline/g/{{dotted(p)}}": np.asarray(g)
               for p, g in g_all.items()}})
for pod in (0, 1):
    g_pod = mean(per_rank[4 * pod:4 * pod + 4])
    for p, g in g_all.items():
        if comp_state.error[p] is not None:
            g = (g_pod[p] + comp_state.error[p][pod]
                 - states["compressed"].error[p][pod])
        arrays[f"compressed{{pod}}/g/{{dotted(p)}}"] = np.asarray(g)
np.savez(tmp / "ref_out.npz", **arrays)
print(json.dumps(out))
"""


def _port_cfg(layers: int = LAYERS):
    from repro_torch import configs as tconfigs
    return dataclasses.replace(tconfigs.reduced_config(
        "granite-8b", **pc.REDUCED_WIDTHS), n_layers=layers, remat=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod_compression")
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        "granite-8b", **pc.REDUCED_WIDTHS), n_layers=LAYERS, remat=False)
    state = convert.lm_state_dict(ref_lm_params(jcfg), jcfg)
    rng = np.random.default_rng(29)
    inputs = {f"p/{k}": np.asarray(v) for k, v in state.items()}
    stacked = tsteps.stack_layers(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        _port_cfg())
    for k, a in stacked.items():
        if a.ndim >= 2 and a.numel() >= pc.MIN_SIZE:
            inputs[f"q/{k}"] = rng.standard_normal(
                (2, a.shape[-1], RANK)).astype(np.float32)
            inputs[f"e/{k}"] = (1e-4 * rng.standard_normal(
                (2,) + tuple(a.shape))).astype(np.float32)
    inputs["tokens"] = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ))
    np.savez(tmp / "pod_inputs.npz", **inputs)
    body = _REF_BODY.format(tmp=str(tmp), widths=pc.REDUCED_WIDTHS,
                            layers=LAYERS, rank=RANK, seq=SEQ, batch=BATCH)
    bad = {"mesh": CLI[:3] + ["2,2,1"] + CLI[4:],
           "batch": CLI[:10] + ["12"] + CLI[11:]}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(run_in_mesh_subprocess, body)
        port = pool.submit(run_world, 8, "pod_compression_world", tmp,
                           layers=LAYERS, seq=SEQ, batch=BATCH, rank=RANK,
                           cli=CLI + ["--out", str(tmp / "cli")], bad=bad)
        want, got = ref.result(), port.result()
    return {"want": want, "got": got, "tmp": tmp, "inputs": inputs,
            "ref": np.load(tmp / "ref_out.npz"),
            "port": np.load(tmp / "pod_out.npz")}


@pytest.mark.parametrize("mode", pc.MODES)
def test_bytes_equal_the_reference_hlo(world, mode):
    got = world["got"][mode]
    want = world["want"][mode]
    assert set(want) == {"all-reduce"}
    total = sum(n for k, n in got["bytes"].items()
                if k.startswith("all_reduce:"))
    assert total == want["all-reduce"] == sum(got["bytes"].values())
    # the in-pod mean is the same in both modes: every fp32 gradient
    inpod = 4 * sum(a.size for k, a in world["inputs"].items()
                    if k.startswith("p/"))
    assert got["bytes"]["all_reduce:data+model"] == inpod
    assert got["counts"]["all_reduce:data+model"] == 1    # one fp32 buffer


def test_compressed_metrics_count_the_pod_exchange(world):
    """``compress_tree``'s metrics (4 bytes an element, as the
    reference's) against the leaves: P (m, r) and Q (n, r) a compressed
    leaf, and the pod's mean of the exact ones beside them."""
    inputs = world["inputs"]
    errors = [a.shape[1:] for k, a in inputs.items() if k.startswith("e/")]
    whole = sum(a.size for k, a in inputs.items() if k.startswith("p/"))
    compressed = sum(int(np.prod(s)) for s in errors)
    m = world["got"]["compressed"]["metrics"]
    assert m == {"compressed_bytes": sum((int(np.prod(s[:-1])) + s[-1])
                                         * RANK * 4 for s in errors),
                 "exact_bytes": 4 * whole}
    pod = world["got"]["compressed"]["bytes"]["all_reduce:pod"]
    assert pod == m["compressed_bytes"] + 4 * (whole - compressed)
    assert pod == world["want"]["compressed"]["all-reduce"] - 4 * whole


@pytest.mark.parametrize("pod", [0, 1])
def test_pod_state_matches_the_reference(world, pod):
    port = np.load(world["tmp"] / f"pod_state_{pod}.npz")
    ref = world["ref"]
    keys = [k for k in ref.files if k[:2] in ("q/", "e/")]
    assert sorted(keys) == sorted(port.files) and keys
    for k in keys:
        err = rel_frobenius(port[k], ref[k][pod])
        assert err <= STATE_TOL, f"pod {pod} {k}: {err:.3e}"


@pytest.mark.parametrize("mode", pc.MODES)
def test_exchanged_gradients_match_the_reference(world, mode):
    """The gradients that each mode hands to ``adamw.update`` (on the
    reference's layer-stacked layout), against ``jax.grad`` on each rank's
    rows: the mean over the 8 ranks (every baseline leaf and each exact
    leaf of the compressed mode) within ``GRAD_TOL``; a compressed leaf,
    the same P Qn^T for both pods, that pod's mean over its 4 ranks plus
    its old error feedback less the reference's new one, within
    ``STATE_TOL`` (the state's bound).  A sum in place of a mean, a rank's
    rows left out or a pod's mean over the wrong group moves these."""
    port, ref = world["port"], world["ref"]
    got = {k[len(f"{mode}/g/"):]: port[k] for k in port.files
           if k.startswith(f"{mode}/g/")}
    compressed = {k[2:] for k in ref.files if k.startswith("q/")}
    assert compressed and compressed <= set(got)
    wants = (["baseline"] if mode == "baseline"
             else ["compressed0", "compressed1"])
    for want in wants:
        assert sorted(got) == sorted(k[len(f"{want}/g/"):] for k in ref.files
                                     if k.startswith(f"{want}/g/"))
        for k, g in got.items():
            tol = STATE_TOL if k in compressed and mode != "baseline" \
                else GRAD_TOL
            err = rel_frobenius(g, ref[f"{want}/g/{k}"])
            assert err <= tol, f"{want} {k}: {err:.3e} > {tol:g}"


@pytest.mark.parametrize("mode", pc.MODES)
def test_parameters_within_half_a_learning_rate(world, mode):
    lr = world["got"][mode]["lr"]
    want = float(tadamw.lr_schedule(tadamw.AdamWConfig(),
                                    torch.tensor(1)))
    assert lr == pytest.approx(want)
    port, ref = world["port"], world["ref"]
    keys = [k for k in ref.files if k.startswith(f"{mode}/p/")]
    assert sorted(keys) == sorted(k for k in port.files
                                  if k.startswith(f"{mode}/p/")) and keys
    moved = 0.0
    for k in keys:
        diff = np.abs(port[k] - ref[k]).max()
        assert diff <= PARAM_LRS * lr, \
            f"{k}: {diff:.3e} > {PARAM_LRS} x lr {lr:.3e}"
        before = world["inputs"][k.replace(f"{mode}/", "")]
        moved = max(moved, np.abs(ref[k] - before).max())
    assert moved > 0.5 * lr      # the step moved the weights


@pytest.mark.parametrize("mode", pc.MODES)
def test_ranks_agree_and_pods_keep_their_state(world, mode):
    got = world["got"][mode]
    assert got["params_agree"] and got["pod_agrees"]
    if mode == "compressed":
        assert got["pods_differ"]


def test_cli_in_the_world(world):
    rec = world["got"]["cli"]
    written = json.loads((world["tmp"] / "cli" /
                          "pod_compression_granite-8b_L1_r4.json")
                         .read_text())
    assert written == rec
    assert rec["world"] == 8 and rec["mesh"] == {"pod": 2, "data": 2,
                                                 "model": 2}
    for mode in pc.MODES:
        run = rec[mode]
        assert run["total_bytes"] == run["collectives"]["all-reduce"] \
            == run["expected_bytes"] > 0
        assert len(run["losses"]) == len(run["step_s"]) == 2
        assert all(np.isfinite(run["losses"]))
    assert rec["compressed"]["metrics"]["compressed_bytes"] > 0
    assert rec["pod_exchange_savings_bytes"] == \
        rec["baseline"]["total_bytes"] - rec["compressed"]["total_bytes"] > 0
    assert rec["reduction_factor_total"] > 1


@pytest.mark.parametrize("flag", ["mesh", "batch"])
def test_cli_raises_where_the_world_does_not_fit(world, flag):
    msg = world["got"]["raises"][flag]
    assert msg is not None and f"--{flag}" in msg


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _grads_and_state(axis_name):
    rng = np.random.default_rng(3)
    grads = {"w": torch.from_numpy(rng.standard_normal((96, 40)).astype(
        np.float32)),
             "stack": torch.from_numpy(rng.standard_normal((2, 48, 32))
                                       .astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(40).astype(
                 np.float32))}
    cfg = tcomp.CompressionConfig(rank=3, min_size=1000,
                                  axis_name=axis_name)
    state = tcomp.init_state(grads, cfg, torch.Generator().manual_seed(1))
    state = state._replace(error={k: None if e is None else
                                  e + 0.01 * torch.ones_like(e)
                                  for k, e in state.error.items()})
    return grads, state, cfg


def _one_device_mesh():
    return Mesh(np.full((1, 1, 1), torch.device("cpu"), dtype=object),
                pc.AXES)


def _assert_bitwise(a, b):
    for x, y in ((a[0], b[0]), (a[1].q, b[1].q), (a[1].error, b[1].error)):
        assert x.keys() == y.keys()
        for k in x:
            assert (x[k] is None) == (y[k] is None)
            if x[k] is not None:
                assert torch.equal(x[k], y[k]), k
    assert a[2] == b[2]


def test_axis_name_none_is_the_local_path():
    grads, state, cfg = _grads_and_state(None)
    local = tcomp.compress_tree(grads, state, cfg)
    assert local[2] == {"compressed_bytes": (96 + 40 + 96 + 32) * 3 * 4,
                        "exact_bytes": (96 * 40 + 2 * 48 * 32 + 40) * 4}
    assert torch.equal(local[0]["b"], grads["b"])
    _assert_bitwise(tcomp.compress_tree(grads, state, cfg,
                                        mesh=_one_device_mesh()), local)


def test_world_of_one_over_pod_is_the_local_path():
    grads, state, cfg = _grads_and_state("pod")
    local = tcomp.compress_tree(grads, state,
                                dataclasses.replace(cfg, axis_name=None))
    C.reset_counts()
    got = tcomp.compress_tree(grads, state, cfg, mesh=_one_device_mesh())
    assert C.counts() == {} and C.byte_counts() == {}
    _assert_bitwise(got, local)


@pytest.mark.parametrize("mesh", ["none", "no_pod_axis"])
def test_axis_name_without_the_axis_raises(mesh):
    grads, state, cfg = _grads_and_state("pod")
    m = None if mesh == "none" else Mesh([[torch.device("cpu")]],
                                         ("data", "model"))
    with pytest.raises(ValueError, match="axis_name='pod'"):
        tcomp.compress_tree(grads, state, cfg, mesh=m)


def test_expected_bytes_from_the_leaf_sizes():
    cfg = _port_cfg()
    model = ttfm.Transformer(cfg, "cpu")
    params = dict(model.named_parameters())
    whole = 4 * sum(p.numel() for p in params.values())
    assert whole == 9704448
    got = pc.expected_bytes(params, cfg, RANK, {"pod": 2, "data": 2,
                                                "model": 2})
    assert got == {"baseline": 19408896, "compressed": 10144768}
    assert pc.expected_bytes(params, cfg, RANK, {"pod": 1, "data": 1,
                                                 "model": 1}) == \
        {"baseline": 0, "compressed": 0}
    assert pc.expected_bytes(params, cfg, RANK, {"pod": 2, "data": 1,
                                                 "model": 1}) == \
        {"baseline": whole, "compressed": 10144768 - whole}


def test_cli_on_a_world_of_one(tmp_path):
    argv = ["--device", "cpu", "--mesh", "1,1,1", "--reduced", "--layers",
            "1", "--seq", "16", "--batch", "2", "--rank", "4", "--steps",
            "2", "--out", str(tmp_path)]
    rec = pc.main(argv)
    written = json.loads((tmp_path / "pod_compression_granite-8b_L1_r4.json")
                         .read_text())
    assert written == rec
    assert {"baseline", "compressed", "pod_exchange_savings_bytes",
            "reduction_factor_total"} <= set(rec)
    for mode in pc.MODES:
        assert rec[mode]["collectives"] == {} and rec[mode]["counts"] == {}
        assert rec[mode]["total_bytes"] == 0.0 == rec[mode]["expected_bytes"]
    assert rec["compressed"]["metrics"]["compressed_bytes"] > 0
    # both modes start from the same weights and tokens
    assert rec["baseline"]["losses"][0] == rec["compressed"]["losses"][0]


def test_cli_mesh_must_hold_the_world():
    with pytest.raises(ValueError, match="--mesh 2,2,2 holds 8 ranks"):
        pc.main(["--device", "cpu", "--mesh", "2,2,2", "--reduced"])
