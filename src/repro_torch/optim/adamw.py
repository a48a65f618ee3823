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
the parameters' device, so a step asks nothing of the host.  The
reference's ``moment_axes`` (the moments' sharding roles) waits for the LM
half of the multi-device work (ROADMAP queue 1, item 4b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch


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


def init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> OptState:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}; expected one "
                         f"of {_MOMENT_DTYPES}")
    device = next(iter(params.values())).device
    return OptState(
        m={k: _moment_like(p, cfg.moment_dtype, "m")
           for k, p in params.items()},
        v={k: _moment_like(p, cfg.moment_dtype, "v")
           for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=device))


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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves taken
    in sorted key order (the reference's tree order for a flat dict)."""
    total = None
    for k in sorted(tree):
        sq = torch.sum(torch.square(tree[k].to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: OptState,
           params: Mapping[str, torch.Tensor], cfg: AdamWConfig
           ) -> Tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """One AdamW step: ``params`` updated in place (and returned), a new
    ``OptState`` and {"grad_norm", "lr"} as 0-d fp32 tensors."""
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    int8 = cfg.moment_dtype == "int8"

    def read_moment(mom, p, which):
        if int8 and which == "v":
            r = _dequantize(mom, p.shape)   # stores sqrt(v)
            return r * r
        return mom.to(torch.float32)

    def write_moment(x, which):
        if int8:
            if which == "v":
                return _quantize(torch.sqrt(torch.clamp(x, min=0.0)))
            return x.to(torch.bfloat16)
        dt = (torch.bfloat16 if cfg.moment_dtype == "bfloat16"
              else torch.float32)
        return x.to(dt)

    countf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, countf)
    b2c = 1 - torch.pow(cfg.b2, countf)
    new_m, new_v = {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * clip
        mf = cfg.b1 * read_moment(state.m[k], p, "m") + (1 - cfg.b1) * g
        vf = (cfg.b2 * read_moment(state.v[k], p, "v")
              + (1 - cfg.b2) * g * g)
        upd = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (upd + cfg.weight_decay * pf))
        new_m[k], new_v[k] = write_moment(mf, "m"), write_moment(vf, "v")
    return params, OptState(new_m, new_v, count), {"grad_norm": gnorm,
                                                    "lr": lr}


__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "lr_schedule",
           "update"]
