"""Train / prefill / serve steps on one device (port of
``repro.launch.steps``).

``build_train_step`` / ``build_prefill`` / ``build_serve_step`` return
(step_fn, input_specs): the step as a Python function over the port's
eager model, and the (shape, dtype) pairs of the cell's inputs
(``configs.shapes.input_specs``).  The reference returns jit-ready
functions with sharding trees for a mesh; a ``mesh`` here raises until
the LM half of the multi-device work (ROADMAP queue 1, item 4b).

A train step is the reference's: ``loss_fn``, its gradients with respect
to every parameter (zeros for one the loss does not reach), then, with
``comp_cfg``, ``optim.compression.compress_tree`` (on the card its Gram
and sweep kernels), then ``adamw.update``, which writes the new values
into the model's parameters.  ``TrainState.params`` is the model itself
(``init_model(..., train=True)``).

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


class TrainState(NamedTuple):
    params: tfm.Transformer
    opt: adamw.OptState
    step: torch.Tensor             # 0-d int32
    comp: Any = None               # optional PCA gradient-compression state


def _one_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (data or model parallelism) comes with the LM half of "
            "the multi-device work (ROADMAP queue 1, item 4b); the port's "
            "steps run on one device")


def _on(batch: dict, dev: torch.device) -> dict:
    """The batch's tensors on ``dev``; tokens as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        out[k] = t.long() if k in ("tokens", "token") else t
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


def build_train_step(cfg: ModelConfig, shape: ShapeCell,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     comp_cfg: Optional[comp.CompressionConfig] = None,
                     device: DeviceLike = None, mesh=None):
    _one_device(mesh)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dev = resolve_device(device)

    def train_step(state: TrainState, batch):
        params = dict(state.params.named_parameters())
        loss, metrics = tfm.loss_fn(state.params, _on(batch, dev), cfg)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        new_comp = state.comp
        if comp_cfg is not None:
            stacked, new_comp, _ = comp.compress_tree(
                stack_layers(grads, cfg), state.comp, comp_cfg)
            grads = unstack_layers(stacked, grads, cfg)
        _, new_opt, opt_metrics = adamw.update(grads, state.opt, params,
                                               opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return (TrainState(state.params, new_opt, state.step + 1, new_comp),
                metrics)

    return train_step, input_specs(cfg, shape)


def build_prefill(cfg: ModelConfig, shape: ShapeCell,
                  device: DeviceLike = None, mesh=None):
    _one_device(mesh)
    dev = resolve_device(device)

    def prefill_step(params, batch):
        return tfm.prefill(params, _on(batch, dev), cfg)

    return prefill_step, input_specs(cfg, shape)


def build_serve_step(cfg: ModelConfig, shape: ShapeCell,
                     device: DeviceLike = None, mesh=None):
    """One-token decode against a KV cache of shape.seq_len: (next token
    (B,) int64, the greedy argmax; logits; the new state)."""
    _one_device(mesh)
    dev = resolve_device(device)

    def serve_step(params, state, token):
        logits, new_state = tfm.decode_step(
            params, state, torch.as_tensor(token, device=dev).long(), cfg)
        return torch.argmax(logits, dim=-1), logits, new_state

    return serve_step, input_specs(cfg, shape)


def build_step(kind: str, cfg: ModelConfig, shape: ShapeCell, **kw):
    if kind == "train":
        return build_train_step(cfg, shape, **kw)
    if kind == "prefill":
        return build_prefill(cfg, shape, **kw)
    return build_serve_step(cfg, shape, **kw)


__all__ = ["TrainState", "build_prefill", "build_serve_step", "build_step",
           "build_train_step", "init_compression", "stack_layers",
           "unstack_layers"]
