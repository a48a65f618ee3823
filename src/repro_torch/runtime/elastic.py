"""Elastic restart (port of ``repro.runtime.elastic``), on one device.

``resume_or_init`` restores the latest checkpoint into the structure of a
template state, or initialises.  Checkpoints store whole (logical)
tensors, so a restore needs no sharding here.  ``pick_mesh``, the
largest (data x model) grid over the surviving devices, comes with the
multi-device slice and raises until then.
"""
from __future__ import annotations

from typing import Optional

from ..checkpoint import checkpointer


def pick_mesh(model_parallel: int, devices=None, global_batch=None):
    raise NotImplementedError(
        "pick_mesh: a (data, model) mesh over several devices comes with "
        "the multi-device slice (ROADMAP queue 1, item 4); the port trains "
        "on one device")


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
