"""Elastic restart (port of ``repro.runtime.elastic``).

``resume_or_init`` restores the latest checkpoint into the structure of a
template state, or initialises.  Checkpoints store whole (logical)
tensors, so a restore needs no sharding here.  ``pick_mesh`` chooses the
largest (data x model) grid the surviving devices support; training on
it (a sharded train step) is the LM half of the multi-device work, and
the trainer still raises for ``--model-parallel > 1``.
"""
from __future__ import annotations

from typing import Optional

from ..checkpoint import checkpointer
from ..parallel.sharding import Mesh, make_mesh, visible_devices


def pick_mesh(model_parallel: int, devices=None,
              global_batch=None) -> Mesh:
    """Largest (data, model) mesh over ``devices`` (default: every
    visible card).

    The model axis is the largest size up to ``model_parallel`` that
    divides both it and the device count.  ``global_batch`` caps the data
    axis: batch-dim sharding needs ``global_batch % dp == 0``, so dp
    shrinks to the largest divisor of the batch that the devices support
    and the surplus devices stay idle.
    """
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    tp = model_parallel
    while tp > 1 and (n % tp or model_parallel % tp):
        tp -= 1
    dp = n // tp
    if global_batch is not None:
        dp = min(dp, global_batch)
        while dp > 1 and global_batch % dp:
            dp -= 1
    return make_mesh((dp, tp), ("data", "model"), devices[: dp * tp])


def resume_or_init(ckpt_dir, state_like, init_fn,
                   step: Optional[int] = None):
    """Restore ``step`` (default: the latest) of ``ckpt_dir`` into the
    structure of ``state_like``, or call ``init_fn``.  Returns (state,
    metadata, resumed: bool)."""
    latest = checkpointer.latest_step(ckpt_dir)
    if latest is None:
        return init_fn(), {}, False
    state, meta = checkpointer.restore(ckpt_dir, state_like, step=step)
    return state, meta, True


__all__ = ["pick_mesh", "resume_or_init"]
