"""The port's LM half of multi-device against the reference, on a 2 x 4
("data", "model") mesh of 8 gloo processes on the CPU
(``tests/_torch_dist.py``; the bodies in ``tests/_torch_dist_cases.py``),
in fp32 on reduced configs with ``tp`` 4.

The reference side runs here (``JAX_PLATFORMS=cpu``) for its
single-device results, and for its sharded ones in a child with 8 forced
host devices (``tests/_mesh.py``) on a mesh of ``AxisType.Auto`` axes:
under jax 0.9 ``jax.make_mesh`` defaults to ``Explicit`` axes, which the
reference's ``with_sharding_constraint`` rejects, so its own sharded
tests fail on this container (ROADMAP queue 3).

Cases, one world for all of them:
* placement: every parameter's local shard, and every moment leaf's
  under float32 and int8 moments, has the reference's
  ``NamedSharding(mesh, rules.spec(*roles)).shard_shape``;
* forward: the logits of every reduced config (its weights the
  reference's, each rank its rows of the batch and its vocab columns)
  within ``TOL`` relative Frobenius of the reference's ``REPLICATED``
  forward (the MoE configs at ``capacity_factor`` 4, where nothing is
  dropped on either side);
* ring attention, causal and not over 6 heads and GQA 8/2 on a 4-way
  ring: within 2e-6 of the reference's ``ring_attention`` and of its
  ``_dense_attention``; the ring's backward pass within ``TOL`` of
  autograd of plain attention; the ring-mode model (reduced qwen) within
  the reference test's 5e-3 of the reference's chunked one;
* decode over a cache sharded on the sequence, and with
  ``seq_over_data`` at batch 1, through GQA self attention, whisper's
  head-parallel cross attention, falcon-mamba's channel-parallel state
  and jamba's mamba, attention and MoE layers: the logits within ``TOL``
  of the port's one-device decode and of the reference's forward at the
  last position; falcon-mamba with a bf16 state within ``TOL`` of the
  port's one-device decode;
* the MoE where capacity binds (``capacity_factor`` 1): the port's
  expert-parallel output and aux within ``TOL`` of the reference's 2 x 4
  sharded ``apply_moe``, and both away from the single-device output.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import convert

from _mesh import run_in_mesh_subprocess
from _torch_dist import run_world
from _torch_parity import lm_extra_inputs, ref_lm_params, rel_frobenius

TOL = 1e-5
B, S = 2, 8
NOT_BINDING = {"capacity_factor": 4.0}
ARCHS = {
    "olmo-1b": {},
    "granite-8b": {},
    "granite-34b": {},
    "qwen1.5-32b": {},
    "arctic-480b": NOT_BINDING,
    "llama4-maverick-400b-a17b": NOT_BINDING,
    "falcon-mamba-7b": {},
    "jamba-v0.1-52b": NOT_BINDING,
    "whisper-small": {},
    "llava-next-34b": {},
}
RING_MODEL = ("qwen1.5-32b", {"n_layers": 2, "attn_impl": "ring"})
# (arch, overrides, batch, seq_over_data): GQA self attention, cross
# attention, mamba, and mamba with an MoE (nothing dropped)
DECODE = {
    "seq": ("granite-8b", {"n_layers": 2}, 2, False),
    "seq_over_data": ("granite-8b", {"n_layers": 2}, 1, True),
    "encdec": ("whisper-small", {}, 2, False),
    "ssm": ("falcon-mamba-7b", {}, 2, False),
    "ssm_bf16": ("falcon-mamba-7b", {"ssm_dtype": "bfloat16"}, 2, False),
    "hybrid": ("jamba-v0.1-52b", {"n_layers": 2, "attn_every": 2,
                                  "moe_every": 2, "capacity_factor": 4.0},
               2, False),
}
MOE = ("arctic-480b", {"n_layers": 1, "n_experts": 8,
                       "capacity_factor": 1.0})
RING = {"causal": (4, 64, 6, 6, 16), "full": (4, 64, 6, 6, 16),
        "gqa": (2, 64, 8, 2, 16)}
CACHE_LEN = 16


def _over(over):
    return dict(over, tp=4)


def _jcfg(arch, over):
    return jconfigs.reduced_config(arch, **_over(over))


_REF_BODY = """
import dataclasses
from jax.sharding import NamedSharding
from repro import configs as jconfigs
from repro.models import moe, transformer as tfm
from repro.optim import adamw
from repro.parallel.ring_attention import ring_attention
from repro.parallel.sharding import REPLICATED, is_axes, rules_for_mesh
from repro.parallel.sharding import use_mesh
from repro_torch.convert import lm_state_dict

args = json.load(open({args!r}))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = rules_for_mesh(mesh)
out = {{"placement": {{}}}}

def shard_shapes(axes, shapes):
    return jax.tree.map(
        lambda ax, s: np.zeros(NamedSharding(mesh, rules.spec(*ax))
                               .shard_shape(s.shape), bool),
        axes, shapes, is_leaf=is_axes)

def named(tree, cfg):
    return {{k: list(v.shape) for k, v in lm_state_dict(tree, cfg).items()}}

for arch, over in args["archs"].items():
    cfg = jconfigs.reduced_config(arch, **over)
    abstract = tfm.abstract_init(cfg)
    axes = tfm.param_axes(abstract)
    values = tfm.param_values(abstract)
    shapes = named(shard_shapes(axes, values), cfg)
    for md in ("float32", "int8"):
        ocfg = adamw.AdamWConfig(moment_dtype=md)
        opt = jax.eval_shape(lambda p: adamw.init(p, ocfg), values)
        for which, tree in (("m", opt.m), ("v", opt.v)):
            sh = shard_shapes(adamw.moment_axes(axes, ocfg, which), tree)
            if md == "int8" and which == "v":
                for part in ("q", "s"):
                    sub = jax.tree.map(lambda d: d[part], sh,
                                       is_leaf=lambda d: isinstance(d, dict)
                                       and "q" in d)
                    shapes.update({{f"{{md}}/v/{{k}}/{{part}}": s for k, s in
                                   named(sub, cfg).items()}})
            else:
                shapes.update({{f"{{md}}/{{which}}/{{k}}": s for k, s in
                               named(sh, cfg).items()}})
    out["placement"][arch] = shapes

inputs = np.load({inputs!r})
arrays = {{}}
cfg = jconfigs.reduced_config(args["moe"][0], **args["moe"][1])
p = jax.tree.map(lambda x: x.v if hasattr(x, "v") else x,
                 moe.init_moe(jax.random.PRNGKey(0), cfg),
                 is_leaf=lambda x: hasattr(x, "v"))
x = jnp.asarray(inputs["moe/x"])
with mesh:
    y_sh, aux_sh = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg, rules))(p, x)
    y_sh = jax.device_get(y_sh)
y_one, aux_one = moe.apply_moe(p, x, cfg, REPLICATED)
arrays.update({{"moe/y_sh": np.asarray(y_sh), "moe/aux_sh": float(aux_sh),
               "moe/y_one": np.asarray(y_one),
               "moe/aux_one": float(aux_one)}})
arrays.update({{f"moe/p/{{k}}": np.asarray(v) for k, v in p.items()}})
for case in ("causal", "full", "gqa"):
    q, k, v = (jnp.asarray(inputs[f"ring/{{case}}/{{n}}"]) for n in "qkv")
    with use_mesh(mesh):
        o = jax.jit(lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=case != "full"))(q, k, v)
        arrays[f"ring/{{case}}"] = np.asarray(jax.device_get(o))
np.savez({result!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_lm")
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    for arch, over in ARCHS.items():
        jcfg = _jcfg(arch, over)
        params = ref_lm_params(jcfg)
        for k, v in convert.lm_state_dict(params, jcfg).items():
            inputs[f"{arch}/p/{k}"] = np.asarray(v)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)),
                 **lm_extra_inputs(jcfg, B, rng)}
        for k, v in batch.items():
            inputs[f"{arch}/in/{k}"] = np.asarray(v)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, aux = jtfm.forward(params, jb, jcfg, REPLICATED,
                                   "train")[:2]
        want[f"{arch}/logits"] = np.asarray(logits)
        want[f"{arch}/aux"] = float(aux)
    for case, (b, s, h, kv, d) in RING.items():
        for n, heads in (("q", h), ("k", kv), ("v", kv), ("g", h)):
            inputs[f"ring/{case}/{n}"] = rng.standard_normal(
                (b, s, heads, d)).astype(np.float32)
    jcfg = _jcfg(*RING_MODEL)
    params = ref_lm_params(jcfg)
    inputs.update({f"ringmodel/p/{k}": np.asarray(v) for k, v in
                   convert.lm_state_dict(params, jcfg).items()})
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32))
    inputs["ringmodel/tokens"] = tokens
    chunked = jconfigs.reduced_config(RING_MODEL[0], n_layers=2, tp=1)
    want["ringmodel"] = np.asarray(jtfm.forward(
        params, {"tokens": jnp.asarray(tokens)}, chunked, REPLICATED,
        "train")[0])
    for case, (arch, over, b, _) in DECODE.items():
        jcfg = _jcfg(arch, over)
        params = ref_lm_params(jcfg)
        inputs.update({f"decode/{case}/p/{k}": np.asarray(v) for k, v in
                       convert.lm_state_dict(params, jcfg).items()})
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, 9)),
                 **lm_extra_inputs(jcfg, b, rng)}
        inputs.update({f"decode/{case}/in/{k}": np.asarray(v)
                       for k, v in batch.items()})
        logits = jtfm.forward(params, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, jcfg, REPLICATED,
                              "train")[0]
        want[f"decode/{case}"] = np.asarray(logits)[:, -1]
    mcfg = _jcfg(*MOE)
    inputs["moe/x"] = rng.standard_normal((8, 16, mcfg.d_model)).astype(
        np.float32)
    np.savez(tmp / "lm_inputs.npz", **inputs)

    args = tmp / "ref_args.json"
    args.write_text(json.dumps({
        "archs": {a: _over(o) for a, o in ARCHS.items()},
        "moe": [MOE[0], _over(MOE[1])]}))
    ref = run_in_mesh_subprocess(_REF_BODY.format(
        args=str(args), inputs=str(tmp / "lm_inputs.npz"),
        result=str(tmp / "ref_out.npz")))
    ref_arrays = np.load(tmp / "ref_out.npz")
    # the workers take the reference's own MoE parameters
    inputs.update({k: ref_arrays[k] for k in ref_arrays.files
                   if k.startswith("moe/p/")})
    np.savez(tmp / "lm_inputs.npz", **inputs)

    world = run_world(
        8, "lm", tmp,
        archs={a: {"arch": a, "overrides": _over(o)}
               for a, o in ARCHS.items()},
        ring_model={"arch": RING_MODEL[0], "overrides": _over(RING_MODEL[1])},
        decode={case: {"arch": a, "overrides": _over(o), "cache_len":
                       CACHE_LEN, "seq_over_data": sod}
                for case, (a, o, _, sod) in DECODE.items()},
        moe={"arch": MOE[0], "overrides": _over(MOE[1])})
    return {"world": world, "got": np.load(tmp / "lm_out.npz"),
            "ref": ref, "ref_arrays": ref_arrays, "want": want,
            "inputs": inputs}


def test_ranks_lie_on_the_mesh(lm):
    assert lm["world"]["coords"] == {"data": 0, "model": 0}
    counts = lm["world"]["collectives"]
    assert counts["all_reduce:model"] > 0 and counts["ring_shift:model"] > 0
    assert counts["all_gather:data"] > 0        # the FSDP gathers


@pytest.mark.parametrize("arch", list(ARCHS))
def test_placement_is_the_references(lm, arch):
    got = lm["world"]["placement"][arch]
    want = lm["ref"]["placement"][arch]
    assert set(got) == set(want)
    assert {k: got[k] for k in sorted(got)} == {k: want[k]
                                               for k in sorted(want)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_reference(lm, arch):
    got = lm["got"][f"{arch}/logits"]
    want = lm["want"][f"{arch}/logits"]
    assert got.shape == want.shape
    assert rel_frobenius(got, want) < TOL
    aux = float(lm["got"][f"{arch}/aux"])
    assert abs(aux - lm["want"][f"{arch}/aux"]) <= TOL * max(
        1.0, abs(lm["want"][f"{arch}/aux"]))


def _torch_dense(q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("case", list(RING))
def test_ring_attention_matches_reference(lm, case):
    got = lm["got"][f"ring/{case}"]
    causal = case != "full"
    ins = {n: lm["inputs"][f"ring/{case}/{n}"] for n in "qkvg"}
    g = ins["q"].shape[2] // ins["k"].shape[2]
    kx, vx = (jnp.repeat(jnp.asarray(ins[n]), g, axis=2) for n in "kv")
    dense = np.asarray(jattn._dense_attention(
        jnp.asarray(ins["q"]), kx, vx, causal, ins["q"].shape[-1] ** -0.5))
    assert np.max(np.abs(got - lm["ref_arrays"][f"ring/{case}"])) < 2e-6
    assert np.max(np.abs(got - dense)) < 2e-6
    q, k, v = (torch.from_numpy(ins[n]).requires_grad_() for n in "qkv")
    _torch_dense(q, k, v, causal).backward(torch.from_numpy(ins["g"]))
    for n, t in zip("qkv", (q, k, v)):
        assert rel_frobenius(lm["got"][f"ring/{case}/d{n}"],
                             t.grad.numpy()) < TOL


def test_ring_mode_model_matches_chunked(lm):
    got = lm["got"]["ringmodel/logits"]
    want = lm["want"]["ringmodel"]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 5e-3
    assert rel_frobenius(got, want) < TOL


@pytest.mark.parametrize("case", [c for c in DECODE if c != "ssm_bf16"])
def test_seq_sharded_decode(lm, case):
    got = lm["got"][f"decode/{case}"]
    if case != "ssm":   # the cache's sequence split 4 ways, or 8 with
        # seq_over_data (falcon-mamba has no attention cache)
        shards = 8 if case == "seq_over_data" else 4
        assert (lm["got"][f"decode/{case}/cache_shape"][2]
                == CACHE_LEN // shards)
    assert rel_frobenius(got, lm["got"][f"decode/{case}/one"]) < TOL
    assert rel_frobenius(got, lm["want"][f"decode/{case}"]) < TOL


def test_bf16_state_decode_on_the_mesh(lm):
    """falcon-mamba with ``ssm_dtype="bfloat16"``, tensor-parallel over
    d_inner: the bf16-state prefill and a decode step within ``TOL`` of
    the port's one-device run (each channel's scan rounds the same values
    at the same points; only ``x_proj``'s all-reduce sums in another
    order)."""
    got = lm["got"]["decode/ssm_bf16"]
    assert rel_frobenius(got, lm["got"]["decode/ssm_bf16/one"]) < TOL


def test_moe_capacity_binding_matches_the_sharded_reference(lm):
    got, ref = lm["got"], lm["ref_arrays"]
    assert np.max(np.abs(got["moe/y"] - ref["moe/y_sh"])) < TOL
    assert abs(float(got["moe/aux"]) - float(ref["moe/aux_sh"])) < TOL
    # capacity applies a data shard: both differ from one device's result
    assert np.max(np.abs(ref["moe/y_sh"] - ref["moe/y_one"])) > 1e-2
    assert np.max(np.abs(got["moe/y"] - ref["moe/y_one"])) > 1e-2
