"""Carry results of the JAX reference over into the port.

The system has no weights: its carried-over state is a fitted PCA
(components, mean and scale), a solved eigen/SVD problem or a DLE pivot.
``to_port`` takes a result of the reference (``PCAResult``, ``EighResult``,
``BatchedPCAResult``, ``BatchedEighResult``, ``BatchedSVDResult``,
``Pivot``), whose fields are arrays numpy can read, and returns the port's
result of the same name with every field a tensor on ``device``.  It
matches the type by name, so this module imports nothing of the reference.

The LM stack has no weights either: both packages draw random ones, so
parity carries the reference's across.  ``lm_params_to_port`` takes the
reference's ``tfm.param_values(tfm.init_model(...))`` tree as numpy
arrays and returns the port's ``Transformer`` holding the same numbers
(attention, cross attention, mamba, MLP and MoE leaves, the encoder's and
the learned position table alike, by name); ``decode_state_to_reference``
maps a decode state's caches to the reference's group-stacked ones:
head-major KV caches (the cross K/V too) to (B, S, KV, hd), Mamba caches
as they are; ``lm_tree`` maps a state dict back onto the reference's
parameter tree.  ``adamw_state_to_port`` and ``adamw_state_to_reference``
carry an AdamW state (its moments, which mirror the parameter tree, the
int8 mode's ``{"q", "s"}`` pairs and the step count) either way.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.dle import Pivot
from .core.jacobi import EighResult
from .core.pca import PCAResult
from .serving.solver import BatchedEighResult, BatchedPCAResult, BatchedSVDResult

RESULT_TYPES = {cls.__name__: cls for cls in (
    PCAResult, EighResult, BatchedPCAResult, BatchedEighResult,
    BatchedSVDResult, Pivot)}


def to_port(result, device: DeviceLike = None):
    """The port's counterpart of a reference result, on ``device``
    (default ``cuda``)."""
    name = type(result).__name__
    if name not in RESULT_TYPES:
        raise TypeError(f"no port counterpart for {name!r}; known: "
                        f"{sorted(RESULT_TYPES)}")
    cls = RESULT_TYPES[name]
    if tuple(result._fields) != cls._fields:
        raise TypeError(f"{name} fields {result._fields} differ from the "
                        f"port's {cls._fields}")
    dev = resolve_device(device)
    return cls(*(None if v is None
                 else torch.as_tensor(np.array(v), device=dev)
                 for v in result))


# -- the LM stack -------------------------------------------------------------

def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _stacked_layers(blocks, n_layers: int, per: int, prefix: str) -> dict:
    """A group-stacked ``blocks`` tree as ``{prefix}.{i}.{part}.{name}``
    keys, layer i = group x ``per`` + j for ``blocks/l{j}``."""
    out = {}
    for j in range(per):
        for part, leaves in blocks[f"l{j}"].items():
            for name, stacked in leaves.items():
                for g in range(n_layers // per):
                    out[f"{prefix}.{g * per + j}.{part}.{name}"] = \
                        np.asarray(stacked)[g]
    return out


def lm_state_dict(params, cfg) -> Dict[str, np.ndarray]:
    """The reference's parameter tree (nested dicts of numpy arrays, the
    blocks stacked over groups under ``blocks/l{j}``) as the port's
    ``state_dict`` keys: ``embed.*`` (``pos`` too), ``layers.{i}.{norm1,
    mixer,norm_x,cross,norm2,ffn,mlp_res,mlp_shared}.*`` and ``norm_f.*``,
    layer i = group x period + j (``transformer.period``: lcm(attn_every,
    moe_every)); for encdec also ``encoder.layers.{i}.*`` (the
    reference's ``encoder/blocks/l0``, stacked over ``encoder_layers``)
    and ``encoder.norm_f.*``."""
    from .models.transformer import period
    out = {f"embed.{k}": v for k, v in params["embed"].items()}
    out.update({f"norm_f.{k}": v for k, v in params["norm_f"].items()})
    out.update(_stacked_layers(params["blocks"], cfg.n_layers, period(cfg),
                               "layers"))
    if "encoder" in params:
        enc = params["encoder"]
        out.update(_stacked_layers(enc["blocks"], cfg.encoder_layers, 1,
                                   "encoder.layers"))
        out.update({f"encoder.norm_f.{k}": v
                    for k, v in enc["norm_f"].items()})
    return out


def _stack_layers(state: dict, prefix: str, per: int) -> dict:
    """``{prefix}{i}.{part}.{name}`` entries stacked over the groups under
    ``l{i % per}``, layer i = group x per + j."""
    per_layer = {}
    for key, a in state.items():
        if key.startswith(prefix):
            i, part, name = key[len(prefix):].split(".")
            per_layer.setdefault((int(i) % per, part, name),
                                 {})[int(i) // per] = a
    blocks = {f"l{j}": {} for j in range(per)}
    for (j, part, name), by_group in per_layer.items():
        blocks[f"l{j}"].setdefault(part, {})[name] = np.stack(
            [by_group[g] for g in range(len(by_group))])
    return blocks


def lm_tree(state: Dict[str, np.ndarray], cfg) -> dict:
    """A state dict of numpy arrays (the port's keys) as the reference's
    parameter tree, the inverse of ``lm_state_dict``: layer i = group x
    period + j stacked over the groups under ``blocks/l{j}``, an encoder's
    layers under ``encoder/blocks/l0`` with its ``norm_f``, and the empty
    dicts of parameterless norms."""
    from .models.transformer import period
    tree = {"embed": {}, "norm_f": {},
            "blocks": _stack_layers(state, "layers.", period(cfg))}
    for key, a in state.items():
        parts = key.split(".")
        if parts[0] in ("embed", "norm_f"):
            tree[parts[0]][parts[1]] = a
    blocks = list(tree["blocks"].values())
    if cfg.family == "encdec":
        tree["encoder"] = {
            "blocks": _stack_layers(state, "encoder.layers.", 1),
            "norm_f": {k.split(".")[-1]: a for k, a in state.items()
                       if k.startswith("encoder.norm_f.")}}
        blocks += list(tree["encoder"]["blocks"].values())
    for block in blocks:
        block.setdefault("norm1", {})
        if "cross" in block:
            block.setdefault("norm_x", {})
        if cfg.d_ff:
            block.setdefault("norm2", {})
    return tree


def lm_params_to_port(params, cfg, device: DeviceLike = None):
    """The port's ``Transformer`` for ``cfg`` holding the reference's
    parameter values ``params`` (``tfm.param_values`` of the reference's
    ``init_model``, leaves readable by numpy), on ``device`` (default
    ``cuda``).  Every tensor of the model must be given, with its shape."""
    from .models.transformer import Transformer
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    state = {k: _tensor(v, dev) for k, v in lm_state_dict(params,
                                                          cfg).items()}
    model.load_state_dict(state, strict=True)
    return model.eval()


def decode_state_to_reference(state, cfg) -> dict:
    """A port ``DecodeState`` as the reference's fields in numpy (fp32):
    {"caches": {"l{j}": pair}, "enc_kvs": {"l{j}": (k, v)} or None, "pos":
    int}, the pair (k, v) with k, v (n_groups, B, S, KV, hd) for an
    attention layer, (conv, state) with conv (n_groups, B, d_conv - 1,
    d_inner) and state (n_groups, B, d_inner, N) for a mamba layer; the
    cross K/V (n_groups, B, F, KV, hd)."""
    from .models.mamba import MambaCache
    from .models.transformer import period
    per = period(cfg)

    def stacked(layer_caches):
        out = {}
        for j in range(per):
            firsts, seconds = [], []
            for g in range(cfg.n_layers // per):
                c = layer_caches[g * per + j]
                pair = ((c.conv, c.state) if isinstance(c, MambaCache)
                        else (c.k.transpose(1, 2), c.v.transpose(1, 2)))
                firsts.append(pair[0].float().cpu().numpy())
                seconds.append(pair[1].float().cpu().numpy())
            out[f"l{j}"] = (np.stack(firsts), np.stack(seconds))
        return out

    return {"caches": stacked(state.caches),
            "enc_kvs": (None if state.enc_kvs is None
                        else stacked(state.enc_kvs)),
            "pos": int(state.pos)}


# -- the AdamW state ----------------------------------------------------------

def _is_pair(node) -> bool:
    """An int8 moment leaf: {"q": blocks, "s": scales}."""
    return isinstance(node, dict) and set(node) == {"q", "s"} and not any(
        isinstance(v, dict) for v in node.values())


def _pick(tree, key: str):
    """The tree with each int8 pair replaced by its ``key`` part."""
    if _is_pair(tree):
        return tree[key]
    if isinstance(tree, dict):
        return {k: _pick(v, key) for k, v in tree.items()}
    return tree


def _pair_up(q, s):
    """Two trees of one structure zipped into one of {"q", "s"} leaves."""
    if isinstance(q, dict):
        return {k: _pair_up(q[k], s[k]) for k in q}
    return {"q": q, "s": s}


def _has_pairs(tree) -> bool:
    if _is_pair(tree):
        return True
    return isinstance(tree, dict) and any(_has_pairs(v)
                                          for v in tree.values())


def _moments_to_port(tree, cfg, dev) -> dict:
    """A moment tree (the parameter tree's structure) as the port's dict
    of named tensors, an int8 pair as {"q", "s"} tensors."""
    if not _has_pairs(tree):
        return {k: _tensor(a, dev) for k, a in lm_state_dict(tree,
                                                            cfg).items()}
    scales = lm_state_dict(_pick(tree, "s"), cfg)
    return {k: {"q": _tensor(a, dev), "s": _tensor(scales[k], dev)}
            for k, a in lm_state_dict(_pick(tree, "q"), cfg).items()}


def adamw_state_to_port(opt, cfg, device: DeviceLike = None):
    """The reference's ``OptState`` (``m``, ``v`` mirroring its parameter
    tree, ``count``; leaves readable by numpy) as the port's, on
    ``device`` (default ``cuda``)."""
    from .optim.adamw import OptState
    dev = resolve_device(device)
    return OptState(m=_moments_to_port(opt.m, cfg, dev),
                    v=_moments_to_port(opt.v, cfg, dev),
                    count=torch.tensor(int(np.asarray(opt.count)),
                                       dtype=torch.int32, device=dev))


def _to_numpy32(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def adamw_state_to_reference(opt, cfg) -> dict:
    """A port ``OptState`` as the reference's fields in numpy: {"m": tree,
    "v": tree, "count": int32}, each tree the parameter tree's structure
    (``lm_tree``), an int8 moment a {"q", "s"} pair; bf16 moments come as
    fp32 arrays holding the same values."""
    def tree(moments):
        first = next(iter(moments.values()))
        if isinstance(first, dict):
            return _pair_up(
                lm_tree({k: _to_numpy32(m["q"]) for k, m in moments.items()},
                        cfg),
                lm_tree({k: _to_numpy32(m["s"]) for k, m in moments.items()},
                        cfg))
        return lm_tree({k: _to_numpy32(m) for k, m in moments.items()}, cfg)

    return {"m": tree(opt.m), "v": tree(opt.v),
            "count": np.int32(int(opt.count))}
