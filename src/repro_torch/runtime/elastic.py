"""Elastic restart (port of ``repro.runtime.elastic``).

``resume_or_init`` restores the latest checkpoint into the structure of a
template state, or initialises.  Checkpoints store whole (logical)
tensors, so resuming on another mesh only needs that mesh's shardings
(``shardings=``: each rank's block is cut on load).  ``pick_mesh``
chooses the largest (data x model) grid the surviving devices support:
in a started process group the world's ranks, one device a rank (a mesh
bound to the group; every rank calls it, and a rank past the grid gets
a mesh it is not a member of), else the devices given or visible.
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
    from ..parallel import collectives as C
    bound = devices is None and C.world_started()
    if bound:
        import torch.distributed as dist
        devices = list(range(dist.get_world_size()))
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
    if bound:
        return Mesh.from_world((dp, tp), ("data", "model"))
    return make_mesh((dp, tp), ("data", "model"), devices[: dp * tp])


def resume_or_init(ckpt_dir, state_like, init_fn,
                   step: Optional[int] = None, shardings=None):
    """Restore ``step`` (default: the latest) of ``ckpt_dir`` into the
    structure of ``state_like`` (its shards placed by ``shardings`` on a
    mesh), or call ``init_fn``.  Returns (state, metadata, resumed:
    bool)."""
    latest = checkpointer.latest_step(ckpt_dir)
    if latest is None:
        return init_fn(), {}, False
    state, meta = checkpointer.restore(ckpt_dir, state_like, step=step,
                                       shardings=shardings)
    return state, meta, True


__all__ = ["pick_mesh", "resume_or_init"]
