"""Named device meshes and the logical-axis rules (port of
``repro.parallel.sharding``, the part the PCA system runs).

A ``Mesh`` is a numpy object array of ``torch.device``s with a name for
each axis, driven by one Python process (a single-controller mesh, as a
JAX ``Mesh`` is).  Its CUDA devices are distinct cards; the CPU device may
repeat, and each repeat is a *virtual host device*, the counterpart of the
reference's ``--xla_force_host_platform_device_count``: a mesh of eight
``cpu`` entries shards work eight ways on one host.

``Rules`` resolves per-dimension roles onto mesh axes exactly as the
reference does:

  role        meaning                                resolved to
  ----------  -------------------------------------  --------------------
  None        replicated                             ()
  "batch"     data-parallel batch dim                ("pod", "data")
  "fsdp"      ZeRO-style parameter shard dim         "data"
  "tp"        Megatron tensor-parallel dim           "model"
  "vocab"     vocab-parallel embedding/head dim      "model"
  "expert"    expert-parallel MoE dim                "model"
  "seq"       sequence dim (activations)             per-Rules (SP)
  "seq_tp"    sequence-sharded KV cache dim (SP)     "model" (+ "data"
                                                     when batch=1)
  "layers"    stacked-scan layer dim                 ()

``spec`` returns a plain tuple of axis names, one entry a dimension: the
port's ``PartitionSpec``.  Placing tensors by those specs (``Rules.shard``,
``Px``, ``split_tree``, ``stack_axes``) is the LM half of the multi-device
work and raises until then.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """Devices laid out on named axes.

    ``devices`` is any nested sequence (or numpy array) of devices whose
    shape is the mesh's; ``axis_names`` names its axes in order.  CUDA
    devices must be distinct; the CPU device may repeat (virtual host
    devices).  All devices are of one type."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            arr[i] = _as_device(d)
        names = tuple(axis_names)
        if len(names) != arr.ndim:
            raise ValueError(f"{len(names)} axis names {names} for a mesh "
                             f"of shape {arr.shape}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis names {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in arr.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one type of device, got {types}")
        cuda = [d for d in arr.flat if d.type == "cuda"]
        if len(set(cuda)) != len(cuda):
            raise ValueError(
                "a mesh's CUDA devices must be distinct, got "
                f"{[str(d) for d in arr.flat]}; only the CPU device may "
                "repeat (virtual host devices)")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axes: Sequence[str]) -> list:
        """The devices along ``axes`` (in mesh order, the first named
        axis major) at index 0 of every other axis: where each shard of a
        dim sharded over ``axes`` runs once (a replica along another axis
        would compute the same shard again)."""
        index = tuple(slice(None) if a in axes else 0
                      for a in self.axis_names)
        return list(self.devices[index].flat)


def visible_devices(device: DeviceLike = None) -> list:
    """The devices of ``device``'s type (default ``cuda``, raising on a
    host without a card) that a mesh may span: every CUDA card, or the one
    CPU device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over exactly ``prod(shape)`` devices, in order
    (default: the visible CUDA cards), as ``jax.make_mesh`` builds one.
    Virtual host devices: ``devices=["cpu"] * n``."""
    devs = list(visible_devices() if devices is None else devices)
    need = int(np.prod(shape))
    if len(devs) != need:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} ({tuple(axis_names)}) needs "
            f"{need} devices; {len(devs)} given or visible")
    return Mesh(np.asarray(devs, dtype=object).reshape(tuple(shape)),
                axis_names)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Resolution of logical roles onto a concrete mesh."""
    mesh_axes: Tuple[str, ...] = ("data", "model")
    fsdp: bool = True
    tensor: bool = True
    # long-context decode with global_batch < |data|: shard sequence over
    # the data axis too and replicate batch.
    seq_over_data: bool = False
    # the concrete mesh
    mesh: Any = None

    def _has(self, name: str) -> bool:
        return name in self.mesh_axes

    def axis(self, role: Optional[str]):
        if role is None or role == "layers":
            return None
        if role == "batch":
            if self.seq_over_data:
                return None
            ax = tuple(a for a in ("pod", "data") if self._has(a))
            return ax if ax else None
        if role == "fsdp":
            return "data" if (self.fsdp and self._has("data")) else None
        if role in ("tp", "vocab", "expert"):
            return "model" if (self.tensor and self._has("model")) else None
        if role == "seq":
            return None
        if role == "seq_tp":
            if self.seq_over_data:
                ax = tuple(a for a in ("pod", "data") if self._has(a))
                return ax + ("model",) if self._has("model") else ax
            return "model" if self._has("model") else None
        raise ValueError(f"unknown sharding role {role!r}")

    def spec(self, *roles) -> tuple:
        """The per-dimension mesh axes of ``roles`` (the port's
        ``PartitionSpec``)."""
        return tuple(self.axis(r) for r in roles)

    def shard(self, x, *roles):
        """Activation placement; a no-op under the empty (single-device /
        ``REPLICATED``) rule set."""
        if x is None or not self.mesh_axes:
            return x
        raise NotImplementedError(
            "Rules.shard: placing activations on a mesh is the LM half of "
            "the multi-device work (ROADMAP queue 1, item 4b)")


REPLICATED = Rules(mesh_axes=(), fsdp=False, tensor=False)


def rules_for_mesh(mesh: Mesh, **kw) -> Rules:
    return Rules(mesh_axes=tuple(mesh.axis_names), mesh=mesh, **kw)


def batch_axes(tree):
    """Role annotations for a batch-leading tree of tensors (a tensor, a
    dict, or a tuple, list or NamedTuple of them): leading dim "batch",
    every other dim replicated.  The serving executors' solver trees carry
    the microbatch axis first on every leaf."""
    if isinstance(tree, dict):
        return {k: batch_axes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        leaves = [batch_axes(t) for t in tree]
        return (type(tree)(*leaves) if hasattr(tree, "_fields")
                else type(tree)(leaves))
    return ("batch",) + (None,) * (getattr(tree, "ndim", 0) - 1)


def pad_to_multiple(n: int, multiple: int) -> int:
    """n rounded up to a multiple of ``multiple`` (a copy of the
    reference's ``parallel.sharding.pad_to_multiple``)."""
    return -(-n // multiple) * multiple
