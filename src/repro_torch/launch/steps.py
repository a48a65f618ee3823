"""Train / prefill / serve steps on a mesh or one device (port of
``repro.launch.steps``).

``build_train_step`` / ``build_prefill`` / ``build_serve_step`` return
(step_fn, input_specs): the step as a Python function over the port's
eager model, and the (shape, dtype) pairs of the cell's inputs
(``configs.shapes.input_specs``).  The reference returns jit-ready
functions with sharding trees for a mesh.  Here ``mesh=None`` runs on
``device`` alone (a 1 x 1 mesh of it); a ``parallel.Mesh`` bound to a
process group (or a mesh of one device) runs the step on this rank's
shards under
``rules_for_cell`` (``step_fn.rules``): the model is sharded
(``tfm.shard_model``), the batch is given whole or as this rank's rows
(cut to them when its leading dim is the cell's global batch), and the
train step reduces each gradient over the batch axes its leaf is
replicated across (an ``"fsdp"`` leaf's was reduce-scattered over "data"
in the backward pass), compresses the logical gradient with a replicated
state (each compressed leaf gathered whole, ``compress_tree`` run alike
on every rank, the shard kept), then updates the shards
(``adamw.update(..., shardings=)``).  ``rules_for_cell``,
``batch_specs``, ``param_spec_tree``, ``train_state_specs`` and
``train_state_shardings`` give the specs and ``Sharding``s; a non-Mesh
``mesh`` raises ``TypeError``.

A train step is the reference's: ``loss_fn``, its gradients with respect
to every parameter (zeros for one the loss does not reach), then, with
``comp_cfg``, ``optim.compression.compress_tree`` (on the card its Gram
and sweep kernels), then ``adamw.update``, which writes the new values
into the model's parameters and the new moments into the state's (the
step consumes its state, as the reference's jitted step donates it).
``TrainState.params`` is the model itself (``init_model(...,
train=True)``).

Compression sees the gradients in the reference's layout
(``stack_layers``): a layer's leaf stacked over the layer groups, as the
reference's parameter tree holds it, so that one subspace serves the
whole stack (its rows are every group's rows) and the compressed
gradient is the reference's.  ``init_compression`` gives the state for
that layout.
"""
from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..configs.shapes import ShapeCell, input_specs
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..optim import adamw
from ..optim import compression as comp
from ..parallel import collectives as C
from ..parallel.sharding import (Mesh, Rules, Sharding, map_axes,
                                 rules_for_mesh)


class TrainState(NamedTuple):
    params: tfm.Transformer
    opt: adamw.OptState
    step: torch.Tensor             # 0-d int32
    comp: Any = None               # optional PCA gradient-compression state


def rules_for_cell(mesh: Mesh, cfg: ModelConfig,
                   shape: Optional[ShapeCell] = None,
                   fsdp: bool = True) -> Rules:
    """The reference's: the sequence is sharded over the batch axes too
    for a decode cell whose global batch is smaller than them."""
    data = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            data *= mesh.shape[ax]
    seq_over_data = bool(shape and shape.kind == "decode"
                         and shape.global_batch < data)
    return rules_for_mesh(mesh, fsdp=fsdp, seq_over_data=seq_over_data)


def batch_specs(cfg: ModelConfig, shape: ShapeCell, rules: Rules) -> dict:
    """The specs of each input of this cell (the reference's)."""
    specs = input_specs(cfg, shape)
    b = rules.axis("batch")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": (b, None)}
        for k in ("patches", "frames"):
            if k in specs:
                out[k] = (b, None, None)
        return out
    return {"token": (b,), "state": rules.spec_tree(
        tfm.decode_state_axes(cfg))}


def param_spec_tree(cfg: ModelConfig, rules: Rules, model) -> dict:
    return {k: rules.spec(*ax) for k, ax in tfm.param_axes(model).items()}


def train_state_specs(cfg: ModelConfig, rules: Rules, model,
                      opt_cfg: adamw.AdamWConfig) -> "TrainState":
    axes = tfm.param_axes(model)

    def spec(ax):
        return rules.spec(*ax)
    return TrainState(
        params=param_spec_tree(cfg, rules, model),
        opt=adamw.OptState(
            m=map_axes(spec, adamw.moment_axes(axes, opt_cfg, "m")),
            v=map_axes(spec, adamw.moment_axes(axes, opt_cfg, "v")),
            count=()),
        step=())


def train_state_shardings(model, rules: Rules,
                          opt_cfg: adamw.AdamWConfig) -> "TrainState":
    """A ``Sharding`` for each sharded leaf of a ``TrainState`` (the
    checkpointer's ``shardings=``); the compression state is replicated."""
    sh = tfm.param_shardings(model, rules)
    axes = tfm.param_axes(model)
    v = adamw.moment_axes(axes, opt_cfg, "v")
    return TrainState(
        params=sh,
        opt=adamw.OptState(
            m=sh, v={k: map_axes(lambda ax: Sharding(rules, ax), v[k])
                     if isinstance(v[k], dict) else sh[k] for k in v},
            count=None),
        step=None, comp=None)


def _mesh_rules(mesh, cfg: ModelConfig, shape: ShapeCell,
                device: DeviceLike) -> Rules:
    """The cell's rules on ``mesh``, or on a mesh of ``device`` alone
    (default ``cuda``) without one."""
    if mesh is None:
        mesh = Mesh([[resolve_device(device)]], ("data", "model"))
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if not mesh.bound and mesh.size > 1:
        raise ValueError(
            f"a mesh of {mesh.size} devices without a process group: the "
            "LM steps run one process a device (Mesh.from_world, "
            "runtime.pick_mesh in a started world)")
    return rules_for_cell(mesh, cfg, shape)


def _on(batch: dict, dev: torch.device, rules: Rules,
        global_batch: int) -> dict:
    """The batch's tensors on ``dev``; tokens as int64; a tensor whose
    leading dim is ``global_batch`` cut to this rank's rows."""
    out = {}
    nb = rules.size("batch")
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        if nb > 1 and t.ndim and t.shape[0] == global_batch:
            t = rules.shard(t, "batch")
        out[k] = t.long() if k in ("tokens", "token") else t
    return out


def all_reduce_tree(tree: Dict[str, torch.Tensor], mesh: Mesh, axes,
                    op: str = "sum") -> Dict[str, torch.Tensor]:
    """Each tensor of ``tree`` all-reduced over ``axes`` of ``mesh`` (one
    all-reduce of a flat buffer a dtype, the keys in sorted order); the
    tree as it is where the axes span one rank."""
    out = dict(tree)
    if mesh.axes_size(axes) == 1:
        return out
    by_dtype: Dict[torch.dtype, list] = {}
    for k in sorted(tree):
        by_dtype.setdefault(tree[k].dtype, []).append(k)
    for keys in by_dtype.values():
        flat = C.all_reduce(torch.cat([tree[k].reshape(-1) for k in keys]),
                            mesh, axes, op=op)
        for k, part in zip(keys, flat.split([tree[k].numel()
                                             for k in keys])):
            out[k] = part.view_as(tree[k])
    return out


def reduce_grads(grads: Dict[str, torch.Tensor], shardings: dict,
                 rules: Rules) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the batch axes its leaf is not split
    across (``all_reduce_tree`` for each set of axes)."""
    batch = rules.axes("batch")
    groups: Dict[tuple, dict] = {}
    for k in sorted(grads):
        axes = tuple(a for a in batch
                     if a not in shardings[k].sharded_axes())
        if axes:
            groups.setdefault(axes, {})[k] = grads[k]
    out = dict(grads)
    for axes, tree in groups.items():
        out.update(all_reduce_tree(tree, rules.mesh, axes))
    return out


_LAYER = re.compile(r"^(encoder\.)?layers\.(\d+)\.(.+)$")


def _stacked_name(name: str, per: int):
    """(the reference's name, group) of a port parameter name: decoder
    layer i = group x ``per`` + j under ``blocks.l{j}``, encoder layer i
    under ``encoder.blocks.l0``; (name, None) outside the layers."""
    m = _LAYER.match(name)
    if m is None:
        return name, None
    enc, i = m.group(1) or "", int(m.group(2))
    per = 1 if enc else per
    return f"{enc}blocks.l{i % per}.{m.group(3)}", i // per


def stack_layers(tree: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> Dict[str, torch.Tensor]:
    """``tree`` (the port's names) in the reference's layout: each layer
    leaf stacked over the groups (``torch.stack``, a copy), other leaves
    as they are."""
    per, out, stacks = tfm.period(cfg), {}, {}
    for name, t in tree.items():
        key, g = _stacked_name(name, per)
        if g is None:
            out[key] = t
        else:
            stacks.setdefault(key, {})[g] = t
    for key, by_group in stacks.items():
        out[key] = torch.stack([by_group[g] for g in range(len(by_group))])
    return out


def unstack_layers(tree: Dict[str, torch.Tensor], names, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_layers`` for the port's ``names``: each a
    view of its group's slice."""
    per, out = tfm.period(cfg), {}
    for name in names:
        key, g = _stacked_name(name, per)
        out[name] = tree[key] if g is None else tree[key][g]
    return out


def init_compression(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                     comp_cfg: comp.CompressionConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> comp.CompressionState:
    """``compress_tree``'s state for the reference's layout of
    ``params``."""
    with torch.no_grad():
        return comp.init_state(stack_layers(
            {k: p.detach() for k, p in params.items()}, cfg), comp_cfg,
            generator)


def _compress_sharded(grads, state_comp, comp_cfg, cfg, shardings):
    """``compress_tree`` on the logical gradient: each compressed leaf
    gathered whole, compressed alike on every rank, its shard kept."""
    per = tfm.period(cfg)

    def compressed(k):
        return state_comp.q.get(_stacked_name(k, per)[0]) is not None
    full = {k: shardings[k].gather(g) if compressed(k) else g
            for k, g in grads.items()}
    stacked, new_comp, _ = comp.compress_tree(stack_layers(full, cfg),
                                              state_comp, comp_cfg)
    out = unstack_layers(stacked, grads, cfg)
    return {k: shardings[k].local(g).contiguous() if compressed(k) else g
            for k, g in out.items()}, new_comp


def build_train_step(cfg: ModelConfig, shape: ShapeCell,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     comp_cfg: Optional[comp.CompressionConfig] = None,
                     device: DeviceLike = None, mesh=None):
    rules = _mesh_rules(mesh, cfg, shape, device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dev = rules.mesh.device

    def train_step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        shardings = tfm.param_shardings(model, rules)
        objective, metrics = tfm.loss_fn(
            model, _on(batch, dev, rules, shape.global_batch), cfg, rules)
        grads = torch.autograd.grad(objective, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        grads = reduce_grads(grads, shardings, rules)
        new_comp = state.comp
        if comp_cfg is not None:
            grads, new_comp = _compress_sharded(grads, state.comp, comp_cfg,
                                                cfg, shardings)
        # the state is consumed, as the reference's jitted step donates it
        _, new_opt, opt_metrics = adamw.update(grads, state.opt, params,
                                               opt_cfg, shardings=shardings,
                                               in_place=True)
        ce, aux = metrics["ce"].detach(), metrics["aux"].detach()
        metrics = dict(ce=ce, aux=aux, loss=ce + tfm.AUX_COEF * aux,
                       **opt_metrics)
        return (TrainState(model, new_opt, state.step + 1, new_comp),
                metrics)

    train_step.rules = rules
    return train_step, input_specs(cfg, shape)


def build_prefill(cfg: ModelConfig, shape: ShapeCell,
                  device: DeviceLike = None, mesh=None):
    rules = _mesh_rules(mesh, cfg, shape, device)
    dev = rules.mesh.device

    def prefill_step(params, batch, cache_len: Optional[int] = None):
        return tfm.prefill(params, _on(batch, dev, rules, shape.global_batch),
                           cfg, cache_len=cache_len, rules=rules)

    prefill_step.rules = rules
    return prefill_step, input_specs(cfg, shape)


def build_serve_step(cfg: ModelConfig, shape: ShapeCell,
                     device: DeviceLike = None, mesh=None):
    """One-token decode against a KV cache of shape.seq_len: (next token
    (B,) int64, the greedy argmax; logits; the new state).  On a mesh the
    token and the logits are this rank's rows."""
    rules = _mesh_rules(mesh, cfg, shape, device)
    dev = rules.mesh.device

    def serve_step(params, state, token):
        tok = _on({"token": token}, dev, rules, shape.global_batch)["token"]
        logits, new_state = tfm.decode_step(params, state, tok, cfg, rules)
        return torch.argmax(logits, dim=-1), logits, new_state

    serve_step.rules = rules
    return serve_step, input_specs(cfg, shape)


def build_step(kind: str, cfg: ModelConfig, shape: ShapeCell, **kw):
    if kind == "train":
        return build_train_step(cfg, shape, **kw)
    if kind == "prefill":
        return build_prefill(cfg, shape, **kw)
    return build_serve_step(cfg, shape, **kw)


__all__ = ["TrainState", "all_reduce_tree", "batch_specs", "build_prefill", "build_serve_step",
           "build_step", "build_train_step", "init_compression",
           "param_spec_tree", "reduce_grads", "rules_for_cell",
           "stack_layers", "train_state_shardings", "train_state_specs",
           "unstack_layers"]
