"""The bodies of the port's multi-rank tests, run in each process of a
gloo world by ``tests/_torch_dist.py``.  This module imports only
``torch``, ``numpy`` and the port; ``run`` asserts that neither JAX nor
the reference was imported.

Inputs come from the test process as ``.npz`` files in the world's
directory (the reference's parameters under the port's names, prompts,
activations); each case writes rank 0's results there as ``.npz`` and
returns a small JSON document.
"""
import dataclasses
import hashlib
import pathlib
import sys

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import pod_compression, serve, steps, train
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ring_attention import ring_attention
from repro_torch.parallel.sharding import (Mesh, REPLICATED, Rules,
                                           Sharding, rules_for_mesh)

AXES = ("data", "model")


def run(case: str, rank: int, world: int, tmp: str, kw: dict):
    C.init_world("cpu", store_path=f"{tmp}/{case}.store", rank=rank,
                 world_size=world)
    try:
        out = CASES[case](pathlib.Path(tmp), **kw)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not leaked, leaked
        C.barrier()
    finally:
        C.close_world()
    return out


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _save(tmp: pathlib.Path, name: str, arrays: dict) -> None:
    if _rank() == 0:
        np.savez(tmp / f"{name}.npz", **{k: np.asarray(v) for k, v in
                                         arrays.items()})


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _cfg(arch: str, overrides: dict):
    return tconfigs.reduced_config(arch, **overrides)


def _model(cfg, state: dict, rules=None, train_: bool = False):
    """The port's model holding ``state`` (the reference's values under
    the port's names), cut to this rank's shards under ``rules``."""
    model = tfm.Transformer(cfg, "cpu", train=train_)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    if rules is not None:
        tfm.shard_model(model, rules)
    return model


def _params_of(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the LM world: placement, forward, ring, seq-sharded decode, MoE
# ---------------------------------------------------------------------------

def lm(tmp: pathlib.Path, archs: dict, ring_model: dict, decode: dict,
       moe: dict):
    mesh = Mesh.from_world((2, 4), AXES)
    rules = rules_for_mesh(mesh)
    out = {"coords": mesh.coords, "placement": {}}
    inputs = np.load(tmp / "lm_inputs.npz")
    arrays = {}

    # placement: every parameter and every moment leaf, f32 and int8
    for name, over in archs.items():
        cfg = _cfg(over["arch"], over["overrides"])
        model = tfm.init_model(cfg, seed=0, device="cpu", rules=rules)
        sh = tfm.param_shardings(model, rules)
        params = dict(model.named_parameters())
        shapes = {k: list(p.shape) for k, p in params.items()}
        for md in ("float32", "int8"):
            opt = adamw.init(params, adamw.AdamWConfig(moment_dtype=md), sh)
            for k in params:
                shapes[f"{md}/m/{k}"] = list(opt.m[k].shape)
                v = opt.v[k]
                if isinstance(v, dict):
                    shapes[f"{md}/v/{k}/q"] = list(v["q"].shape)
                    shapes[f"{md}/v/{k}/s"] = list(v["s"].shape)
                else:
                    shapes[f"{md}/v/{k}"] = list(v.shape)
        out["placement"][name] = shapes

    # forward: the reference's weights, the global batch's rows a rank
    for name, over in archs.items():
        cfg = _cfg(over["arch"], over["overrides"])
        model = _model(cfg, _params_of(inputs, f"{name}/p/"), rules)
        batch = {k: rules.shard(torch.from_numpy(np.array(v)), "batch")
                 for k, v in _params_of(inputs, f"{name}/in/").items()}
        batch["tokens"] = batch["tokens"].long()
        with torch.no_grad():
            logits, aux = tfm.forward(model, batch, cfg, "train", rules)[:2]
        arrays[f"{name}/logits"] = _np(rules.gather(logits, "batch", None,
                                                    "vocab"))
        arrays[f"{name}/aux"] = _np(aux)

    # ring attention on the (data, model) mesh, sequence over "model"
    for case in ("causal", "full", "gqa"):
        q, k, v = (torch.from_numpy(inputs[f"ring/{case}/{x}"])
                   for x in "qkv")
        causal = case != "full"
        blk = Rules(mesh_axes=AXES, mesh=mesh)

        def local(t):
            return blk.shard(t, "batch", "seq_tp")
        o = ring_attention(local(q), local(k), local(v), mesh,
                           seq_axis="model", causal=causal)
        arrays[f"ring/{case}"] = _np(blk.gather(o, "batch", "seq_tp"))
        # the backward pass against autograd of plain attention
        ql, kl, vl = (local(t).clone().requires_grad_() for t in (q, k, v))
        gw = local(torch.from_numpy(inputs[f"ring/{case}/g"]))
        ring_attention(ql, kl, vl, mesh, seq_axis="model",
                       causal=causal).backward(gw)
        for x, t in zip("qkv", (ql, kl, vl)):
            arrays[f"ring/{case}/d{x}"] = _np(blk.gather(t.grad, "batch",
                                                         "seq_tp"))

    # the ring-mode model (qwen, heads % mesh != 0 allowed)
    cfg = _cfg(ring_model["arch"], ring_model["overrides"])
    model = _model(cfg, _params_of(inputs, "ringmodel/p/"), rules)
    toks = rules.shard(torch.from_numpy(inputs["ringmodel/tokens"]).long(),
                       "batch")
    with torch.no_grad():
        logits = tfm.forward(model, {"tokens": toks}, cfg, "train", rules)[0]
    arrays["ringmodel/logits"] = _np(rules.gather(logits, "batch", None,
                                                  "vocab"))

    # decode over a cache sharded on the sequence (and with seq_over_data
    # at batch 1), through cross attention, mamba and the MoE
    for case, dec in decode.items():
        cfg = _cfg(dec["arch"], dec["overrides"])
        r = Rules(mesh_axes=AXES, mesh=mesh,
                  seq_over_data=dec["seq_over_data"])
        state_np = _params_of(inputs, f"decode/{case}/p/")
        ins = {k: torch.from_numpy(np.array(v)) for k, v in
               _params_of(inputs, f"decode/{case}/in/").items()}
        tokens = ins.pop("tokens").long()
        model = _model(cfg, state_np, r)
        lt = r.shard(tokens, "batch")
        extra = {k: r.shard(v, "batch") for k, v in ins.items()}
        _, st = tfm.prefill(model, {"tokens": lt[:, :8], **extra}, cfg,
                            cache_len=dec["cache_len"], rules=r)
        logits, _ = tfm.decode_step(model, st, lt[:, 8], cfg, r)
        arrays[f"decode/{case}"] = _np(r.gather(logits, "batch", None))
        kv = [c for c in st.caches if hasattr(c, "k")]
        if kv:
            arrays[f"decode/{case}/cache_shape"] = np.asarray(kv[0].k.shape)
        one = _model(cfg, state_np)
        _, st1 = tfm.prefill(one, {"tokens": tokens[:, :8], **ins}, cfg,
                             cache_len=dec["cache_len"])
        arrays[f"decode/{case}/one"] = _np(tfm.decode_step(
            one, st1, tokens[:, 8], cfg)[0])

    # the MoE's expert-parallel path where capacity binds
    cfg = _cfg(moe["arch"], moe["overrides"])
    layer = tmoe.MoE(cfg, "cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           _params_of(inputs, "moe/p/").items()})
    x = torch.from_numpy(inputs["moe/x"])
    sh = {k: Sharding(rules, ax) for k, ax in layer.roles().items()}
    with torch.no_grad():
        for k, p in layer.named_parameters():
            p.data = sh[k].local(p.data).contiguous().clone()
        y, aux = tmoe.apply_moe(layer, rules.shard(x, "batch"), cfg,
                                rules=rules)
    arrays["moe/y"] = _np(rules.gather(y, "batch"))
    arrays["moe/aux"] = _np(aux)
    out["collectives"] = C.counts()
    _save(tmp, "lm_out", arrays)
    return out


# ---------------------------------------------------------------------------
# the train world: steps, checkpoints across meshes, the CLIs
# ---------------------------------------------------------------------------

def _gather_params(model, rules) -> dict:
    return {k: _np(sh.gather(p.detach()))
            for (k, p), sh in zip(model.named_parameters(),
                                  tfm.param_shardings(model, rules).values())}


def _train_state(model, opt_cfg, rules):
    params = dict(model.named_parameters())
    return steps.TrainState(
        params=model, opt=adamw.init(params, opt_cfg,
                                     tfm.param_shardings(model, rules)),
        step=torch.zeros((), dtype=torch.int32))


def trainer(tmp: pathlib.Path, cells: dict, ckpt: dict, cli: dict):
    inputs = np.load(tmp / "train_inputs.npz")
    mesh = Mesh.from_world((2, 4), AXES)
    out, arrays = {}, {}

    # one step of each cell against the reference's value_and_grad + update
    for name, cell in cells.items():
        cfg = _cfg(cell["arch"], cell["overrides"])
        tokens = inputs[f"{name}/tokens"]
        shape = ShapeCell("t", tokens.shape[1], tokens.shape[0], "train")
        step, _ = steps.build_train_step(cfg, shape, mesh=mesh)
        rules = step.rules
        model = _model(cfg, _params_of(inputs, f"{name}/p/"), rules, True)
        state = _train_state(model, adamw.AdamWConfig(), rules)
        C.reset_counts()
        _, metrics = step(state, {"tokens": tokens})
        out[name] = {"loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "collectives": C.counts()}
        for k, a in _gather_params(model, rules).items():
            arrays[f"{name}/{k}"] = a

    # a leaf saved from ("data", "model") on (4, 2) restores bitwise onto
    # (2, 2) placed as ("model", "data")
    d = tmp / "ckpt_leaf"
    mesh_a = Mesh.from_world((4, 2), AXES)
    ra = rules_for_mesh(mesh_a)
    whole = torch.arange(64.0).reshape(8, 8)
    sa = Sharding(ra, ("fsdp", "tp"))      # ("data", "model")
    checkpointer.save(d, 3, {"w": sa.local(whole).contiguous()},
                      metadata={"step": 3}, shardings={"w": sa})
    mesh_b = Mesh.from_world((2, 2), AXES, ranks=[0, 1, 2, 3])
    leaf = {"ok": None}
    if mesh_b.member:
        rb = Rules(mesh_axes=AXES, mesh=mesh_b)
        sb = Sharding(rb, ("tp", "fsdp"))    # ("model", "data")
        like = {"w": torch.zeros(4, 4)}
        got, meta = checkpointer.restore(d, like, shardings={"w": sb})
        leaf = {"ok": bool(torch.equal(got["w"], sb.local(whole))),
                "shape": list(got["w"].shape), "step": meta["step"]}
    out["leaf"] = leaf

    # 2 steps on (2, 4), a save, a restore onto (4, 2) (and onto (2, 4)),
    # 2 more steps; against 4 steps on (2, 4)
    cfg = _cfg(ckpt["arch"], ckpt["overrides"])
    tokens = inputs["ckpt/tokens"]            # (4 steps, B, S + 1)
    shape = ShapeCell("t", tokens.shape[2], tokens.shape[1], "train")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    state_np = _params_of(inputs, "ckpt/p/")

    def run_steps(mesh_, state, lo, hi):
        step, _ = steps.build_train_step(cfg, shape, opt_cfg, mesh=mesh_)
        for s in range(lo, hi):
            state, _ = step(state, {"tokens": tokens[s]})
        return state

    def fresh(mesh_):
        r = rules_for_cell(mesh_)
        return _train_state(_model(cfg, state_np, r, True), opt_cfg, r), r

    def rules_for_cell(mesh_):
        return steps.rules_for_cell(mesh_, cfg, shape)

    st, r24 = fresh(mesh)
    full = _gather_params(run_steps(mesh, st, 0, 4).params, r24)
    mesh_42 = Mesh.from_world((4, 2), AXES)
    for name, target in (("cross", mesh_42), ("same", mesh)):
        st, r = fresh(mesh)
        st = run_steps(mesh, st, 0, 2)
        cd = tmp / f"ckpt_{name}"
        checkpointer.save(cd, 2, st, metadata={"step": 2},
                          shardings=steps.train_state_shardings(
                              st.params, r, opt_cfg))
        st2, r2 = fresh(target)
        st2, _ = checkpointer.restore(cd, st2,
                                      shardings=steps.train_state_shardings(
                                          st2.params, r2, opt_cfg))
        got = _gather_params(run_steps(target, st2, 2, 4).params, r2)
        for k in full:
            arrays[f"ckpt/{name}/{k}"] = got[k]
    for k, a in full.items():
        arrays[f"ckpt/full/{k}"] = a

    # the CLIs at --model-parallel 4 in this world
    C.reset_counts()
    losses = train.main(cli["train"], device="cpu")
    out["cli_train"] = losses
    out["cli_train_collectives"] = C.counts()
    tokens = serve.main(cli["serve"], device="cpu")
    out["cli_serve"] = tokens.tolist()
    _save(tmp, "train_out", arrays)
    return out


# ---------------------------------------------------------------------------
# small worlds for the rewritten raise tests
# ---------------------------------------------------------------------------

def rules_shard(tmp: pathlib.Path):
    """``Rules.shard`` and ``Rules.gather`` on a bound (1, 2) mesh."""
    mesh = Mesh.from_world((1, 2), AXES)
    rules = rules_for_mesh(mesh)
    x = torch.arange(24.0).reshape(2, 3, 4)
    local = rules.shard(x, "batch", None, "tp")
    return {"coords": mesh.coords, "bound": mesh.bound,
            "local": local.tolist(),
            "gathered": bool(torch.equal(rules.gather(local, "batch", None,
                                                      "tp"), x)),
            "replicated": REPLICATED.shard(x, "tp") is x,
            "counts": C.counts()}


# ---------------------------------------------------------------------------
# the pod exchange on a 2 x 2 x 2 ("pod", "data", "model") world
# ---------------------------------------------------------------------------

def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        if tensors[k] is not None:
            h.update(k.encode())
            h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gather_object(obj) -> list:
    """Every rank's ``obj``, through ``torch.distributed`` itself (not
    counted by ``collectives``)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def pod_compression_world(tmp: pathlib.Path, layers: int, seq: int,
                          batch: int, rank: int, cli: list, bad: dict):
    """Each mode's step of ``launch.pod_compression.build`` from the
    reference's weights and each pod's numpy state: rank 0's collectives,
    bytes and metrics, whether the ranks agree (parameters everywhere,
    state within a pod), the exchanged gradients that the step hands to
    ``adamw.update`` and the new parameters (rank 0) and each pod's new
    state (its first rank); then the CLI at a small size, and the raises
    of ``--mesh`` and ``--batch`` that do not fit the world."""
    pc = pod_compression
    inputs = np.load(tmp / "pod_inputs.npz")
    mesh = Mesh.from_world((2, 2, 2), pc.AXES)
    cfg = dataclasses.replace(tconfigs.reduced_config(
        "granite-8b", **pc.REDUCED_WIDTHS), n_layers=layers, remat=False)
    pod = mesh.coords["pod"]
    head = mesh.coords["data"] == mesh.coords["model"] == 0
    out, arrays = {}, {}
    for mode in pc.MODES:
        model = _model(cfg, _params_of(inputs, "p/"), train_=True)
        like = steps.init_compression(dict(model.named_parameters()), cfg,
                                      pc.comp_config(rank))
        state = tcomp.CompressionState(
            q={k: None if v is None else torch.from_numpy(
                inputs[f"q/{k}"][pod].copy()) for k, v in like.q.items()},
            error={k: None if v is None else torch.from_numpy(
                inputs[f"e/{k}"][pod].copy())
                for k, v in like.error.items()})
        step = pc.build(cfg, mesh, seq, batch, mode, rank)
        handed = {}
        update = adamw.update

        def kept(grads, *args, **kw):
            handed.update({k: g.detach().clone() for k, g in grads.items()})
            return update(grads, *args, **kw)
        C.reset_counts()
        adamw.update = kept
        try:
            state, metrics = step(model, inputs["tokens"], state)
        finally:
            adamw.update = update
        got = {"counts": C.counts(), "bytes": C.byte_counts(),
               "lr": float(metrics["lr"]),
               "metrics": {k: int(metrics[k]) for k in
                           ("compressed_bytes", "exact_bytes")
                           if k in metrics}}
        params = {k: p.detach() for k, p in model.named_parameters()}
        ranks = _gather_object((pod, _digest(params), _digest(state.q),
                                _digest(state.error)))
        got["params_agree"] = len({r[1] for r in ranks}) == 1
        got["pod_agrees"] = all(len({r[2:] for r in ranks if r[0] == p})
                                == 1 for p in (0, 1))
        got["pods_differ"] = (ranks[0][3] != ranks[-1][3]
                              if mode == "compressed" else None)
        out[mode] = got
        if _rank() == 0:
            arrays.update({f"{mode}/p/{k}": _np(p)
                           for k, p in params.items()})
            arrays.update({f"{mode}/g/{k}": _np(g) for k, g in
                           steps.stack_layers(handed, cfg).items()})
        if mode == "compressed" and head:
            np.savez(tmp / f"pod_state_{pod}.npz",
                     **{f"{w}/{k}": _np(v) for w, tree in
                        (("q", state.q), ("e", state.error))
                        for k, v in tree.items() if v is not None})
    _save(tmp, "pod_out", arrays)

    rec = pod_compression.main(cli)
    out["cli"] = rec
    out["raises"] = {}
    for name, argv in bad.items():
        try:
            pod_compression.main(argv)
            out["raises"][name] = None
        except ValueError as e:
            out["raises"][name] = str(e)
    return out


# ---------------------------------------------------------------------------
# the dry run's cells, run for real: each rank's collective bytes
# ---------------------------------------------------------------------------

def dryrun_cells(tmp: pathlib.Path, cells: dict):
    """Each cell's step (``launch.steps.build_step``) on its mesh of this
    world, with seeded weights, as the dry run builds it: rank 0's
    ``collectives.byte_counts()`` of the step."""
    out = {}
    for name, cell in cells.items():
        dims, names = tuple(cell["mesh"]), tuple(cell["axes"])
        cfg = _cfg(cell["arch"], cell["overrides"])
        shape = ShapeCell(*cell["shape"])
        mesh = Mesh.from_world(dims, names)
        kw = {}
        if shape.kind == "train":
            kw["opt_cfg"] = adamw.AdamWConfig(moment_dtype=cell["moments"])
        step, specs = steps.build_step(shape.kind, cfg, shape, mesh=mesh,
                                       **kw)
        rules = step.rules
        model = tfm.init_model(cfg, seed=0, device="cpu",
                               train=shape.kind == "train", rules=rules)
        g = torch.Generator().manual_seed(1)
        nb = rules.size("batch")

        def local(shp, dt):
            shp = (shp[0] // nb,) + tuple(shp[1:])
            if dt == torch.int32:
                return torch.randint(0, cfg.vocab_size, shp, generator=g,
                                     dtype=dt)
            return torch.randn(shp, generator=g).to(dt)
        if shape.kind == "decode":
            state = tfm.make_decode_state(cfg, shape.global_batch,
                                          shape.seq_len, device="cpu",
                                          rules=rules)
            args = (model, state, local(*specs["token"]))
        else:
            batch = {k: local(*v) for k, v in specs.items()}
            if shape.kind == "train":
                args = (_train_state(model, kw["opt_cfg"], rules), batch)
            else:
                args = (model, batch)
        C.reset_counts()
        step(*args)
        out[name] = C.byte_counts()
    return out


CASES = {"lm": lm, "trainer": trainer, "rules_shard": rules_shard,
         "pod_compression_world": pod_compression_world,
         "dryrun_cells": dryrun_cells}
