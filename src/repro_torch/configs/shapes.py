"""Assigned input-shape cells and their kinds (port of
``repro.configs.shapes``).

  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill
  decode_32k   seq 32768,   global_batch 128  -> serve step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524288,  global_batch 1    -> serve step; SSM/hybrid only

``input_specs`` gives each input of a cell as a (shape, dtype) pair, the
port's stand-in for the reference's ``jax.ShapeDtypeStruct``: nothing is
allocated.  A decode cell's state is the port's ``DecodeState`` (one
head-major ``KVCache`` or ``MambaCache`` a layer) with a (shape, dtype)
pair at each tensor, read off a state built on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeCell) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("full-attention arch: 500k dense-attention KV working set is "
                "the quadratic regime this cell excludes (DESIGN.md)")
    return None


def _spec(t: torch.Tensor) -> Spec:
    return tuple(t.shape), t.dtype


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """(shape, dtype) pairs for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.torch_dtype()
    if shape.kind in ("train", "prefill"):
        specs = {}
        s_text = s
        if cfg.family == "vlm":
            s_text = s - cfg.n_patches
            specs["patches"] = ((b, cfg.n_patches, cfg.d_model), dt)
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.n_frames, cfg.d_model), dt)
        specs["tokens"] = ((b, s_text), torch.int32)
        return specs
    # decode: one token + the decode state (KV cache of seq_len)
    from ..models import transformer as tfm
    state = tfm.make_decode_state(cfg, b, s, dtype=dt, device="meta")
    caches = [type(c)(*map(_spec, c)) for c in state.caches]
    enc_kvs = (None if state.enc_kvs is None
               else [type(c)(*map(_spec, c)) for c in state.enc_kvs])
    return {"token": ((b,), torch.int32),
            "state": tfm.DecodeState(caches=caches, enc_kvs=enc_kvs,
                                     pos=state.pos)}


__all__ = ["SHAPES", "ShapeCell", "applicable", "input_specs"]
