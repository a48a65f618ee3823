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
port's ``PartitionSpec``.

The LM half runs one process a device (``parallel.collectives``).  A
``Mesh`` built by ``Mesh.from_world`` is bound to that process group: it
holds every rank's device, a ``DeviceMesh`` of the same shape and names,
this rank's coordinate on each axis, and a process group for each axis
and each tuple of axes (``comm``).  Every rank of the world calls
``from_world`` together; a rank outside the mesh's ranks gets a mesh
with ``member`` False.  A mesh not bound to a process group stays the
single-controller mesh of the PCA half.

Parameters live as each rank's local shard: ``Px`` (a tensor with its
roles), ``split_tree``, ``stack_axes``, ``spec_tree`` and
``sharding_tree`` carry the reference's meaning, and a ``Sharding`` (the
rules, the roles, and the chunks of a dim stored in pieces) slices a
whole tensor to this rank's block (``local``) and gathers it back
(``gather``).  ``Rules.shard`` forms an activation's local placement
from the whole tensor, ``Rules.gather`` undoes it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class _Comm(NamedTuple):
    group: Any
    size: int
    index: int
    members: list
    perm: Optional[list]


class Mesh:
    """Devices laid out on named axes.

    ``devices`` is any nested sequence (or numpy array) of devices whose
    shape is the mesh's; ``axis_names`` names its axes in order.  CUDA
    devices must be distinct; the CPU device may repeat (virtual host
    devices).  All devices are of one type."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 _bound: bool = False):
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
        if not _bound and len(set(cuda)) != len(cuda):
            raise ValueError(
                "a mesh's CUDA devices must be distinct, got "
                f"{[str(d) for d in arr.flat]}; only the CPU device may "
                "repeat (virtual host devices)")
        self.devices = arr
        self.axis_names = names
        # a single-controller mesh: no process group, one "rank" that is
        # every device (only a 1-device mesh can run the LM half so)
        self.bound = False
        self.member = True
        self.rank = 0
        self.ranks = np.arange(arr.size).reshape(arr.shape)
        self.device_mesh = None
        self._comms = {}
        self._cache = {}

    @classmethod
    def from_world(cls, shape: Sequence[int], axis_names: Sequence[str],
                   ranks: Optional[Sequence[int]] = None,
                   device: DeviceLike = None) -> "Mesh":
        """A mesh of ``shape`` over world ranks ``ranks`` (default the
        first prod(shape)), bound to the started process group.  Every
        rank of the world calls it (it creates the groups).  ``device``:
        this rank's device (default ``collectives.world_device()``; the
        dry run's fake world passes ``meta``)."""
        from . import collectives as C
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        shape = tuple(int(n) for n in shape)
        names = tuple(axis_names)
        need = int(np.prod(shape))
        ranks = list(range(need) if ranks is None else ranks)
        world = dist.get_world_size()
        if len(ranks) != need or max(ranks) >= world:
            raise ValueError(f"a mesh of shape {shape} needs {need} of the "
                             f"world's {world} ranks; got {ranks}")
        me = C.world_device() if device is None else torch.device(device)
        devs = [None] * world
        dist.all_gather_object(devs, str(me))
        grid = np.asarray(ranks).reshape(shape)
        mesh = cls(np.asarray([devs[r] for r in ranks],
                              dtype=object).reshape(shape), names,
                   _bound=True)
        mesh.bound = True
        mesh.rank = dist.get_rank()
        mesh.member = mesh.rank in ranks
        mesh.ranks = grid
        mesh.device_mesh = DeviceMesh(me.type, torch.as_tensor(grid),
                                      mesh_dim_names=names)
        # a group for every tuple of axes (in mesh order) spanning > 1
        # rank; every rank creates every group, in one order
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), k):
                if int(np.prod([shape[i] for i in sub])) == 1:
                    continue
                rest = [i for i in range(len(names)) if i not in sub]
                moved = np.moveaxis(grid, list(rest) + list(sub),
                                    list(range(len(names))))
                moved = moved.reshape(-1, int(np.prod(
                    [shape[i] for i in sub])))
                for members in moved:
                    g = dist.new_group([int(r) for r in members])
                    if mesh.rank in members:
                        mesh._comms[tuple(names[i] for i in sub)] = g
        return mesh

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis (None off the mesh)."""
        if "coords" not in self._cache:
            where = np.argwhere(self.ranks == self.rank)
            self._cache["coords"] = (
                dict(zip(self.axis_names, (int(c) for c in where[0])))
                if self.member and len(where) else
                {a: None for a in self.axis_names})
        return self._cache["coords"]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if not self.bound:
            return self.devices.flat[0]
        return self.devices[tuple(self.coords.values())]

    def axes_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return int(np.prod([self.shape[a] for a in axes]))

    def axes_index(self, axes) -> int:
        """This rank's linear index over ``axes`` (the first named axis
        major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        c, idx = self.coords, 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def comm(self, axes) -> Optional["_Comm"]:
        """The process group over ``axes`` with this rank's index, its
        members in the axes' linear order and their group ranks; None
        where the axes span one rank."""
        axes = tuple(axes)
        if ("comm", axes) in self._cache:
            return self._cache[("comm", axes)]
        n = self.axes_size(axes)
        if n == 1:
            return None
        if not self.bound:
            raise ValueError(
                f"a mesh of {self.size} devices without a process group "
                "cannot run the LM half: build it with Mesh.from_world")
        key = tuple(a for a in self.axis_names if a in axes)
        c = self.coords
        members = []
        for lin in range(n):
            idx, rem = dict(c), lin
            for a in reversed(axes):
                idx[a] = rem % self.shape[a]
                rem //= self.shape[a]
            members.append(int(self.ranks[tuple(idx[a] for a in
                                                self.axis_names)]))
        order = sorted(members)
        perm = [order.index(m) for m in members]
        out = _Comm(self._comms[key], n, self.axes_index(axes), members,
                    None if perm == list(range(n)) else perm)
        self._cache[("comm", axes)] = out
        return out

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

    def axes(self, role: Optional[str]) -> tuple:
        """The mesh axes ``role`` resolves to, as a tuple."""
        ax = self.axis(role)
        return () if ax is None else (ax,) if isinstance(ax, str) else ax

    def size(self, role: Optional[str]) -> int:
        """The number of shards of a dim of ``role`` (1 without a mesh)."""
        axes = self.axes(role)
        return 1 if self.mesh is None or not axes else \
            self.mesh.axes_size(axes)

    def index(self, role: Optional[str]) -> int:
        """This rank's shard of a dim of ``role``."""
        axes = self.axes(role)
        return 0 if self.mesh is None or not axes else \
            self.mesh.axes_index(axes)

    def local_shape(self, shape, *roles) -> tuple:
        """The local block's shape of a whole tensor of ``shape`` (each
        sharded dim must divide, as a ``NamedSharding`` asks)."""
        out = []
        for n, r in zip(shape, roles):
            k = self.size(r)
            if n % k:
                raise ValueError(f"dim {n} of role {r!r} does not split "
                                 f"into {k} shards")
            out.append(n // k)
        return tuple(out) + tuple(shape[len(roles):])

    def shard(self, x, *roles):
        """The local placement of an activation: ``x`` is the whole
        tensor, identical on every rank, and the result is this rank's
        block of each dim of a sharded role (a view).  A no-op under the
        empty (single-device / ``REPLICATED``) rule set and wherever the
        roles span one rank."""
        if x is None or not self.mesh_axes:
            return x
        return Sharding(self, roles).local(x)

    def gather(self, x, *roles):
        """The inverse of ``shard``: the whole tensor from every rank's
        block (a collective; no gradient)."""
        if x is None or not self.mesh_axes:
            return x
        return Sharding(self, roles).gather(x)

    def spec_tree(self, axes_tree):
        return map_axes(lambda ax: self.spec(*ax), axes_tree)

    def sharding_tree(self, axes_tree):
        """A ``Sharding`` for each roles leaf of ``axes_tree``: how this
        rank's block of each leaf is cut from the whole tensor."""
        return map_axes(lambda ax: Sharding(self, ax), axes_tree)


REPLICATED = Rules(mesh_axes=(), fsdp=False, tensor=False)


def rules_for_mesh(mesh: Mesh, **kw) -> Rules:
    return Rules(mesh_axes=tuple(mesh.axis_names), mesh=mesh, **kw)


class Sharding:
    """How a tensor of roles ``roles`` lies on ``rules``' mesh: each dim
    of a sharded role is split into equal blocks in the linear order of
    its axes, this rank holding one.  ``chunks`` ({dim: m}) marks a dim
    stored as m equal pieces, each split so (mamba's ``in_proj``: its x
    and z halves, so that a rank's channels of both lie together).
    Dims past ``roles`` are whole."""

    def __init__(self, rules: Rules, roles, chunks: Optional[dict] = None):
        self.rules = rules
        self.roles = tuple(roles)
        self.chunks = dict(chunks or {})

    def __repr__(self):
        return f"Sharding({self.rules.spec(*self.roles)}, {self.chunks})"

    def _dims(self):
        """(dim, axes, size, index, chunks) of each sharded dim."""
        r = self.rules
        for d, role in enumerate(self.roles):
            n = r.size(role)
            if n > 1:
                if not r.mesh.bound:
                    r.mesh.comm(r.axes(role))      # raises: no group
                yield d, r.axes(role), n, r.index(role), self.chunks.get(d, 1)

    def is_sharded(self) -> bool:
        return any(True for _ in self._dims())

    def sharded_axes(self) -> tuple:
        """The mesh axes this tensor is split over."""
        return tuple(a for _, axes, _, _, _ in self._dims() for a in axes)

    def shape(self, shape) -> tuple:
        return self.rules.local_shape(tuple(shape), *self.roles[:len(shape)])

    def local_dim(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """``x`` with dim ``d`` (whole) cut to this rank's block."""
        for dim, _, n, i, m in self._dims():
            if dim == d % x.ndim:
                if x.shape[dim] % (n * m):
                    raise ValueError(f"dim {x.shape[dim]} does not split "
                                     f"into {n} x {m}")
                piece = x.shape[dim] // m
                blk = piece // n
                parts = [x.narrow(dim, j * piece + i * blk, blk)
                         for j in range(m)]
                return parts[0] if m == 1 else torch.cat(parts, dim)
        return x

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        for dim, _, _, _, _ in list(self._dims()):
            x = self.local_dim(x, dim)
        return x

    def gather_dim(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """``x`` with dim ``d`` gathered whole (a collective)."""
        from . import collectives as C
        for dim, axes, n, _, m in self._dims():
            if dim == d % x.ndim:
                full = C.all_gather(x, self.rules.mesh, axes, dim)
                if m > 1:   # (n, m, blk) pieces -> (m, n, blk)
                    shp = list(full.shape)
                    blk = x.shape[dim] // m
                    full = full.unflatten(dim, (n, m, blk)).transpose(
                        dim, dim + 1).reshape(shp)
                return full
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective)."""
        for dim, _, _, _, _ in list(self._dims()):
            x = self.gather_dim(x, dim)
        return x


def map_axes(fn, tree):
    """``fn`` of each roles leaf (``is_axes``) of a tree of dicts, lists,
    tuples and NamedTuples."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        kids = [map_axes(fn, t) for t in tree]
        return (type(tree)(*kids) if hasattr(tree, "_fields")
                else type(tree)(kids))
    return tree


class Px:
    """A parameter leaf: a tensor (or anything with a shape) ``v`` and
    its logical role a dim ``ax`` (the reference's ``Px``)."""
    __slots__ = ("v", "ax")

    def __init__(self, v, ax):
        self.v = v
        self.ax = tuple(ax)

    def __repr__(self):
        shape = tuple(getattr(self.v, "shape", ()))
        return f"Px(shape={shape}, ax={self.ax})"


def is_px(x) -> bool:
    return isinstance(x, Px)


def is_axes(x) -> bool:
    """A per-dim role annotation: a *plain* tuple of None/str
    (NamedTuples such as ``KVCache`` are tree nodes, not roles)."""
    return type(x) is tuple and all(e is None or isinstance(e, str)
                                    for e in x)


def _map_px(fn, tree):
    if is_px(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_px(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not is_axes(tree):
        kids = [_map_px(fn, t) for t in tree]
        return (type(tree)(*kids) if hasattr(tree, "_fields")
                else type(tree)(kids))
    return tree


def split_tree(tree):
    """(values, axes) from a tree of ``Px`` leaves."""
    return _map_px(lambda p: p.v, tree), _map_px(lambda p: p.ax, tree)


def stack_axes(axes_leaf: Tuple) -> Tuple:
    """Axes for a stacked (scan-over-layers) parameter."""
    return ("layers",) + tuple(axes_leaf)


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
