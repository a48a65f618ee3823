"""AdamW, implemented raw (port of ``repro.optim.adamw``), on one device.

The parameters, gradients and moments are dicts of named tensors (a
model's ``named_parameters()``), and ``update`` writes the new parameter
values into the parameters in place, under ``torch.no_grad()``, as the
reference's train step donates its state.  Moment dtype is configurable:

  float32  -- exact (default)
  bfloat16 -- halves the optimizer's memory
  int8     -- v stored as block-quantised sqrt(v) (``{"q": int8, "s":
              fp32}``, last-dim blocks of 128, rounded up); m stays bf16

The arithmetic is the reference's, step for step, in fp32: the learning
rate, the bias corrections and the clip factor are 0-d fp32 tensors on
the parameters' device, so a step asks nothing of the host.

On a mesh the parameters, gradients and moments are each rank's local
shards, and ``shardings`` (a ``Sharding`` a parameter name,
``transformer.param_shardings``) says how: ``update`` is elementwise on
the shards, ``global_norm`` sums the squares of the LOGICAL gradient
(a shard's sum all-reduced over the axes the leaf is split across, never
over those it is replicated across, so each element counts once), and an
int8 ``v`` is quantised over the whole last dim, as the reference's
(``moment_axes``: its ``q``/``s`` leaves keep the leading dims' roles
and replicate the two block dims), the last dim gathered before the
quantisation and cut back after the dequantisation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from ..parallel import collectives as C


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]


class OptState(NamedTuple):
    m: Dict[str, Moment]
    v: Dict[str, Moment]
    count: torch.Tensor             # 0-d int32, the steps taken


_QBLOCK = 128  # int8 block size (last-dim blocks)
_MOMENT_DTYPES = ("float32", "bfloat16", "int8")


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Block-absmax int8 for the sqrt(v) moment (non-negative input),
    rounded UP (the reference's docstring says why): {"q": (..., blocks,
    128) int8, "s": (..., blocks, 1) fp32}."""
    last = x.shape[-1]
    pad = (-last) % _QBLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], -1, _QBLOCK)
    scale = torch.amax(xb.abs(), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.ceil(xb / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.float32)}


def _dequantize(qs: Mapping[str, torch.Tensor], shape) -> torch.Tensor:
    x = qs["q"].to(torch.float32) * qs["s"]
    x = x.reshape(*x.shape[:-2], -1)
    return x[..., : shape[-1]]


def _moment_like(p: torch.Tensor, dtype: str, which: str) -> Moment:
    # int8 mode quantises only v; m, whose entries change sign step to
    # step, stays bf16 (the reference's rule)
    if dtype == "int8":
        if which == "v":
            return _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
        return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def _zeros_whole_last(p: torch.Tensor, sh) -> torch.Tensor:
    """A zero fp32 tensor of ``p``'s local shape with its last dim whole
    (what an int8 ``v`` quantises)."""
    shape = list(p.shape)
    if sh is not None and shape:
        shape[-1] = _whole_last(sh, p.ndim, shape[-1])
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _whole_last(sh, ndim: int, n: int) -> int:
    """The logical size of the last dim of a leaf of local size ``n``."""
    if ndim == 0 or len(sh.roles) < ndim:
        return n
    return n * sh.rules.size(sh.roles[ndim - 1])


def init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
         shardings: Optional[Mapping] = None) -> OptState:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}; expected one "
                         f"of {_MOMENT_DTYPES}")
    device = next(iter(params.values())).device
    shardings = shardings or {}

    def v_like(k, p):
        if cfg.moment_dtype == "int8" and k in shardings:
            return _quantize(_zeros_whole_last(p, shardings[k]))
        return _moment_like(p, cfg.moment_dtype, "v")
    return OptState(
        m={k: _moment_like(p, cfg.moment_dtype, "m")
           for k, p in params.items()},
        v={k: v_like(k, p) for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=device))


def moment_axes(param_axes: Mapping[str, tuple], cfg: AdamWConfig,
                which: str = "v") -> dict:
    """The roles of a moment's leaves (the reference's ``moment_axes``):
    the parameter's, except an int8 ``v``, whose ``q`` and ``s`` leaves
    keep the leading dims' roles and replicate the (blocks, 128) dims."""
    if cfg.moment_dtype != "int8" or which == "m":
        return dict(param_axes)
    return {k: {"q": tuple(ax)[:-1] + (None, None),
                "s": tuple(ax)[:-1] + (None, None)}
            for k, ax in param_axes.items()}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves taken
    in sorted key order (the reference's tree order for a flat dict).  On
    a mesh each leaf's local sum of squares is all-reduced over the axes
    the leaf is split across (one collective a set of axes), so that the
    norm is the logical tree's."""
    sqs = {k: torch.sum(torch.square(tree[k].to(torch.float32)))
           for k in tree}
    if shardings:
        by_axes = {}
        for k in sorted(tree):
            sh = shardings.get(k)
            axes = sh.sharded_axes() if sh is not None else ()
            if axes:
                by_axes.setdefault(axes, []).append(k)
        for axes, keys in by_axes.items():
            mesh = shardings[keys[0]].rules.mesh
            summed = C.all_reduce(torch.stack([sqs[k] for k in keys]), mesh,
                                  axes)
            sqs.update(zip(keys, summed.unbind(0)))
    total = None
    for k in sorted(tree):
        total = sqs[k] if total is None else total + sqs[k]
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: OptState,
           params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
           shardings: Optional[Mapping] = None, in_place: bool = False
           ) -> Tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """One AdamW step: ``params`` updated in place (and returned), a new
    ``OptState`` and {"grad_norm", "lr"} as 0-d fp32 tensors.  On a mesh
    ``shardings`` gives each leaf's ``Sharding`` (module docstring).
    ``in_place`` consumes ``state``: the new moments are written into its
    tensors, which the returned ``OptState`` holds, as the reference's
    train step donates its state to XLA (``donate_argnums``); so no
    second set of moments lives during the update (for jamba's 2-layer
    stand-in, 29.4 GB of fp32 moments).  The values are bitwise the
    functional update's."""
    shardings = shardings or {}
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads, shardings)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    int8 = cfg.moment_dtype == "int8"

    def read_moment(mom, p, which, sh):
        """The moment in fp32, a tensor this update may write into: the
        state's own where it is fp32 and consumed, else a new one."""
        if int8 and which == "v":
            if sh is None or p.ndim == 0:
                r = _dequantize(mom, p.shape)   # stores sqrt(v)
            else:
                r = sh.local_dim(_dequantize(mom, p.shape[:-1] + (
                    _whole_last(sh, p.ndim, p.shape[-1]),)), p.ndim - 1)
            return r * r
        x = mom.to(torch.float32)
        return x if in_place or x is not mom else x.clone()

    def write_moment(x, which, sh, old):
        """The moment as the state keeps it, written into ``old`` where
        the state is consumed."""
        if int8 and which == "v":
            r = torch.sqrt(torch.clamp(x, min=0.0))
            if sh is not None and x.ndim:
                r = sh.gather_dim(r, x.ndim - 1)
            new = _quantize(r)
            if in_place:
                old["q"].copy_(new["q"])
                old["s"].copy_(new["s"])
                return old
            return new
        dt = (torch.bfloat16 if int8 or cfg.moment_dtype == "bfloat16"
              else torch.float32)
        new = x.to(dt)
        if in_place and new is not old:
            return old.copy_(new)
        return new

    countf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, countf)
    b2c = 1 - torch.pow(cfg.b2, countf)
    new_m, new_v = {}, {}
    for k, p in params.items():
        sh = shardings.get(k)
        g = grads[k].to(torch.float32) * clip
        # b1 m + (1 - b1) g and b2 v + (1 - b2) g g, the same roundings
        # in place
        mf = read_moment(state.m[k], p, "m", sh).mul_(cfg.b1).add_(
            (1 - cfg.b1) * g)
        vf = read_moment(state.v[k], p, "v", sh).mul_(cfg.b2).add_(
            (1 - cfg.b2) * g * g)
        del g
        # (m / b1c) / (sqrt(v / b2c) + eps), then p - lr (upd + wd p)
        upd = (mf / b1c).div_((vf / b2c).sqrt_().add_(cfg.eps))
        pf = p.to(torch.float32)
        p.copy_(pf - upd.add_(cfg.weight_decay * pf).mul_(lr))
        del upd, pf
        new_m[k] = write_moment(mf, "m", sh, state.m[k])
        new_v[k] = write_moment(vf, "v", sh, state.v[k])
    return params, OptState(new_m, new_v, count), {"grad_norm": gnorm,
                                                    "lr": lr}


__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "lr_schedule",
           "moment_axes", "update"]
