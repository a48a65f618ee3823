"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* Collectives: reduced cells on a fake 2 x 4 ("data", "model") and
  2 x 2 x 2 ("pod", "data", "model") world give, on rank 0, exactly the
  per-kind collective bytes of the same steps run for real in an
  8-process gloo world (``tests/_torch_dist_cases.py::dryrun_cells``):
  a dense train cell, a moe train cell, and a decode cell (the hybrid,
  at a global batch below the batch axes on 2 x 2 x 2, so its cache is
  sharded over them too).
* Memory: ``argument_bytes`` of the reduced dense train cell on 2 x 4
  equals the reference's ``memory_analysis().argument_size_in_bytes``
  for the same cell (``repro.launch.dryrun._compile_cell`` on an
  8-device ``AxisType.Auto`` mesh in a child), leaf group by leaf group:
  the parameters, the moments m and v, the moments' count, the step and
  the tokens, each this device's shard.
* FLOPs: at a world of one, the FLOPs outside the kernels equal
  ``FlopCounterMode``'s count of the same step run for real on the CPU,
  less what the kernels' plain versions run there, and the kernels'
  FLOPs equal their formulas over the calls the real step made.
* Every (arch, shape) of ``ARCH_IDS`` x ``SHAPES`` at the reduced widths
  traces on a fake 2 x 2 x 2 world: the train cells at 256 tokens (the
  scan backward's loop runs a step a token), the others at full length.
* One full-width cell (olmo-1b ``train_4k`` on 16 x 16) gives a record
  with every key.
* The fake branches: each of the four kernels on the path gives, on meta
  operands, the plain version's output shapes and dtypes and counts a
  fake call, not a launch; a CPU tensor still resolves ``torch``; the
  other ops refuse a meta operand.
"""
import concurrent.futures
import dataclasses
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.backends import registry
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.kernels import fake_counts, launch_counts, reset_fake_counts
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import mamba_scan as kscan
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

from _mesh import run_in_mesh_subprocess
from _torch_dist import run_world

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (arch, reduced_config overrides, ShapeCell fields)
CELLS = {
    "dense_train": ("olmo-1b", {}, ("train_4k", 32, 8, "train")),
    "moe_train": ("llama4-maverick-400b-a17b", {},
                  ("train_4k", 32, 8, "train")),
    "decode": ("jamba-v0.1-52b", {}, ("long_500k", 64, 2, "decode")),
}
TRAIN_SEQ = 256   # the reduced train cells' tokens in the all-cells sweep
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "moments", "overrides",
               "chips", "trace_s", "memory", "flops_per_device",
               "bytes_per_device", "collective_bytes_per_device",
               "collectives", "model_flops", "param_count", "active_params",
               "roofline", "useful_flops_ratio", "dominant"}

_REF_BODY = """
jax.devices()   # the backend holds 8 devices before the module below
                # sets XLA_FLAGS to 512 when it is imported
from jax.sharding import AxisType, NamedSharding
from repro import configs as jconfigs
from repro.configs.shapes import ShapeCell
from repro.launch import dryrun as jdry
from repro.launch import steps as jsteps
from repro.optim.adamw import AdamWConfig

cfg = jconfigs.reduced_config({arch!r}, tp=4)
shape = ShapeCell(*{shape!r})
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
compiled = jdry._compile_cell(cfg, shape, mesh, "float32")
_, in_sh, _, abstract, _ = jsteps.build_step(
    "train", cfg, mesh, shape, opt_cfg=AdamWConfig(moment_dtype="float32"))
groups = {{}}
def add(group, tree, shardings):
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
        n = int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
        groups[group] = groups.get(group, 0) + n
state, batch = abstract
add("params", state.params, in_sh[0].params)
add("m", state.opt.m, in_sh[0].opt.m)
add("v", state.opt.v, in_sh[0].opt.v)
add("count", state.opt.count, in_sh[0].opt.count)
add("step", state.step, in_sh[0].step)
add("tokens", batch, in_sh[1])
print(json.dumps({{"argument": compiled.memory_analysis(
    ).argument_size_in_bytes, "groups": groups}}))
"""


def _cfg(arch, overrides, mesh_dims):
    return tconfigs.reduced_config(arch, tp=mesh_dims[-1], **overrides)


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """The gloo world's byte counts and the reference's argument bytes,
    made at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cells = {f"{name}/{m}": {"arch": arch, "overrides": dict(
        over, tp=MESHES[m][0][-1]), "shape": list(shape),
        "mesh": list(MESHES[m][0]), "axes": list(MESHES[m][1]),
        "moments": "float32"}
        for name, (arch, over, shape) in CELLS.items() for m in MESHES}
    arch, _, shape = CELLS["dense_train"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref_out = pool.submit(run_in_mesh_subprocess, _REF_BODY.format(
            arch=arch, shape=shape))
        world = pool.submit(run_world, 8, "dryrun_cells", tmp, cells=cells)
        return {"world": world.result(), "reference": ref_out.result()}


def _dry(name, mesh, **kw):
    arch, over, shape = CELLS[name]
    dims, axes = MESHES[mesh]
    return dryrun.run_cell(arch, shape[0], cfg=_cfg(arch, over, dims),
                           shape=ShapeCell(*shape), mesh_axes=(dims, axes),
                           verbose=False, **kw)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CELLS))
def test_collective_bytes_equal_the_gloo_world(real, name, mesh):
    got = _dry(name, mesh)["collectives"]
    want = real["world"][f"{name}/{mesh}"]
    assert want  # the cell communicates
    assert got == want


def test_argument_bytes_equal_the_reference(real):
    """The leaves both sides count, group by group: every parameter, the
    moments m and v (fp32), the moments' count and the step (int32
    scalars), the tokens (int32); each this rank's shard."""
    rec = _dry("dense_train", "2x4")
    arch, over, shape = CELLS["dense_train"]
    dims, axes = MESHES["2x4"]
    cfg = _cfg(arch, over, dims)
    with dryrun.fake_world(8):
        mesh = dryrun.Mesh.from_world(dims, axes, device=dryrun.DEVICE)
        _, (state, batch), _ = dryrun.build_cell(cfg, ShapeCell(*shape),
                                                 mesh, "float32")
    groups = {"params": dryrun.tensor_bytes(state.params),
              "m": dryrun.tensor_bytes(state.opt.m),
              "v": dryrun.tensor_bytes(state.opt.v),
              "count": dryrun.tensor_bytes(state.opt.count),
              "step": dryrun.tensor_bytes(state.step),
              "tokens": dryrun.tensor_bytes(batch)}
    want = real["reference"]
    assert groups == want["groups"]
    assert rec["memory"]["argument_bytes"] == want["argument"] \
        == sum(groups.values())


# -- FLOPs at a world of one -----------------------------------------------

ONE = {
    "dense_train": ("olmo-1b", {}, ShapeCell("t", 24, 2, "train")),
    "ssm_train_remat": ("falcon-mamba-7b", {"remat": True},
                        ShapeCell("t", 12, 2, "train")),
    "hybrid_prefill": ("jamba-v0.1-52b", {}, ShapeCell("p", 20, 2,
                                                       "prefill")),
    "vlm_prefill": ("llava-next-34b", {}, ShapeCell("p", 40, 2,
                                                    "prefill")),
    "decode": ("granite-8b", {}, ShapeCell("d", 30, 2, "decode")),
}


def _real_step(cfg, shape):
    """The cell's step on the CPU at a world of one (seeded weights) under
    ``FlopCounterMode``: (its total FLOPs, the FLOPs the kernels' plain
    versions ran, the formulas' FLOPs of those calls)."""
    step, specs = steps.build_step(shape.kind, cfg, shape, device="cpu")
    model = tfm.init_model(cfg, seed=0, device="cpu",
                           train=shape.kind == "train")
    g = torch.Generator().manual_seed(3)

    def t(shp, dt):
        if dt == torch.int32:
            return torch.randint(0, cfg.vocab_size, shp, generator=g,
                                 dtype=dt)
        return torch.randn(shp, generator=g).to(dt)
    if shape.kind == "decode":
        state = tfm.make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                      device="cpu")
        args = (model, state, t(*specs["token"]))
    else:
        batch = {k: t(*v) for k, v in specs.items()}
        args = ((steps.TrainState(model, adamw.init(
            dict(model.named_parameters()), adamw.AdamWConfig()),
            torch.zeros((), dtype=torch.int32)), batch)
            if shape.kind == "train" else (model, batch))
    counter = FlopCounterMode(display=False)
    inside = {"plain": 0, "formula": 0.0}
    plain = {op: registry._REGISTRY[op]["torch"]
             for op in ("flash_attention", "mamba_scan")}

    def counted(op, fn):
        def call(*a, **kw):
            before = counter.get_total_flops()
            out = fn(*a, **kw)
            inside["plain"] += counter.get_total_flops() - before
            if op == "flash_attention":
                q, k = a[0], a[1]
                inside["formula"] += kfa.attention_flops(
                    q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    kw["causal"], kw["q_offset"])
            else:
                u, A = a[0], a[2]
                inside["formula"] += kscan.scan_flops(*u.shape, A.shape[1])
            return out
        return call
    try:
        for op, fn in plain.items():
            registry._REGISTRY[op]["torch"] = counted(op, fn)
        with counter:
            step(*args)
    finally:
        for op, fn in plain.items():
            registry._REGISTRY[op]["torch"] = fn
    return counter.get_total_flops(), inside


@pytest.mark.parametrize("name", sorted(ONE))
def test_flops_at_a_world_of_one_equal_the_real_step(name):
    arch, over, shape = ONE[name]
    cfg = tconfigs.reduced_config(arch, **over)
    total, inside = _real_step(cfg, shape)
    rec = dryrun.run_cell(arch, shape.name, cfg=cfg, shape=shape,
                          mesh_axes=((1, 1), ("data", "model")),
                          verbose=False)
    kernel = rec["kernel_flops_per_device"]
    assert kernel > 0   # (the plain scan runs no op FlopCounterMode counts)
    assert rec["flops_per_device"] - kernel == total - inside["plain"]
    assert kernel == inside["formula"]
    assert rec["collectives"] == {}


# -- every cell at the reduced widths ----------------------------------------

@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_reduced_cell_traces_on_2x2x2(arch, shape_name):
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        shape = dataclasses.replace(shape, seq_len=TRAIN_SEQ)
    cfg = tconfigs.reduced_config(arch, tp=2)
    rec = dryrun.run_cell(arch, shape_name, cfg=cfg, shape=shape,
                          mesh_axes=MESHES["2x2x2"], verbose=False)
    if "skipped" in rec:
        assert shape_name == "long_500k"
        assert cfg.family not in ("ssm", "hybrid")
        assert "full-attention" in rec["skipped"]
        return
    assert RECORD_KEYS <= set(rec)
    assert rec["chips"] == 8 and rec["mesh"] == "2x2x2"
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"] <= dryrun.H100_BYTES
    assert mem["fits"]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        rec["collectives"].values()) > 0
    calls = rec["kernel_calls"]
    kinds = cfg.layer_kinds()
    if shape.kind != "decode" and "mamba" in kinds:
        assert calls["mamba_scan"] == kinds.count("mamba")
    if shape.kind == "decode":
        assert "mamba_scan" not in calls
    assert rec["dominant"] in rec["roofline"]


def test_full_width_cell_gives_every_key(tmp_path, capsys):
    before = dict(os.environ)
    rec = dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                       "--out", str(tmp_path)])
    assert dict(os.environ) == before   # the dry run sets no variable
    assert "olmo-1b x train_4k on 16x16" in capsys.readouterr().out
    saved = json.loads((tmp_path / "olmo-1b__train_4k__sp__float32.json"
                        ).read_text())
    assert saved == json.loads(json.dumps(rec))
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "peak_bytes", "fits"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["chips"] == 256 and rec["kind"] == "train"
    # olmo-1b's 16 layers on a flash call each, twice with remat
    assert rec["kernel_calls"] == {"flash_attention_mma": 32}
    assert rec["memory"]["fits"] is True
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["model_flops"] == 6.0 * rec["active_params"] * 256 * 4096


# -- the fake branches ---------------------------------------------------------

def _branch_cases():
    g = torch.Generator().manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    bf = torch.bfloat16
    scan = (randn(2, 20, 8), torch.rand(2, 20, 8, generator=g) * 0.2,
            -torch.rand(8, 4, generator=g), randn(2, 20, 4), randn(2, 20, 4),
            randn(8))
    return {
        "flash_attention_mma": ("flash_attention", (
            randn(3, 40, 16, dtype=bf), randn(3, 50, 16, dtype=bf),
            randn(3, 50, 16, dtype=bf)), {"causal": True, "q_offset": 10}),
        "flash_attention_tf32x3": ("flash_attention", (
            randn(3, 40, 16), randn(3, 40, 16), randn(3, 40, 16)),
            {"causal": False}),
        "flash_attention_splitkv": ("flash_attention", (
            randn(3, 1, 16, dtype=bf), randn(3, 600, 16, dtype=bf),
            randn(3, 600, 16, dtype=bf)), {"causal": True, "q_offset": 599}),
        "mamba_scan": ("mamba_scan", scan, {"return_state": True}),
        "mamba_scan_bf16_state": ("mamba_scan", scan, {
            "return_state": True, "state_dtype": torch.bfloat16}),
    }


@pytest.mark.parametrize("kernel", sorted(_branch_cases()))
def test_fake_branch_gives_the_plain_outputs(kernel):
    op, args, kw = _branch_cases()[kernel]
    fn = getattr(ops, op)
    registry.reset_resolution_counts()
    want = fn(*args, **kw)
    assert registry.resolution_counts() == {(op, "torch"): 1}
    launches = launch_counts()
    reset_fake_counts()
    got = fn(*(a.to("meta") for a in args), **kw)
    assert registry.resolution_counts()[(op, "cuda")] == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())
    assert launch_counts() == launches
    counts = fake_counts()
    assert set(counts) == {kernel} and counts[kernel]["calls"] == 1
    if op == "flash_attention":
        q, k = args[0], args[1]
        assert counts[kernel]["flops"] == kfa.attention_flops(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], kw["causal"],
            kw.get("q_offset", 0))
    else:
        assert counts[kernel]["flops"] == kscan.scan_flops(
            *args[0].shape, args[2].shape[1])
    assert counts[kernel]["bytes"] > 0


@pytest.mark.parametrize("return_state", [True, False])
def test_fake_branch_takes_the_state_dtype(return_state):
    """A bf16 state (``ssm_dtype="bfloat16"``) in the dry run: the fake
    branch counts the call on the bf16-state instance's record, with the
    fp32 state's outputs (shapes, dtypes, strides), FLOPs and bytes (the
    state never leaves registers)."""
    _, scan, _ = _branch_cases()["mamba_scan"]
    meta = [a.to("meta") for a in scan]
    out = {}
    for sd in (torch.float32, torch.bfloat16):
        reset_fake_counts()
        got = ops.mamba_scan(*meta, return_state=return_state,
                             state_dtype=sd)
        got = got if isinstance(got, tuple) else (got,)
        out[sd] = ([(g.shape, g.dtype, g.stride()) for g in got],
                   fake_counts())
    (shapes32, counts32), (shapes16, counts16) = out.values()
    assert shapes16 == shapes32
    assert set(counts32) == {"mamba_scan"}
    assert set(counts16) == {"mamba_scan_bf16_state"}
    assert counts16["mamba_scan_bf16_state"] == counts32["mamba_scan"]


def test_other_ops_refuse_a_meta_operand():
    x = torch.ones(8, 8, device="meta")
    pairs = torch.zeros(2, 2, dtype=torch.int64, device="meta")
    v = torch.ones(4, device="meta")
    for call in (lambda: ops.covariance(x, backend="cuda"),
                 lambda: ops.mm_engine_matmul(x, x),
                 lambda: ops.jacobi_sweep(x, x, pairs),
                 lambda: ops.dle_find_pivot(x),
                 lambda: ops.cordic_rotate(v, v, v)):
        with pytest.raises(ValueError, match="fake branch"):
            call()
    assert registry.default_backend(torch.ones(2)) == "torch"
    assert registry.default_backend(x) == "cuda"
