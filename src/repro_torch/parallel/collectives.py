"""Every collective of the port's LM half, in one module, counted.

The reference runs one SPMD program over a ``jax.sharding.Mesh`` and lets
XLA place the collectives.  The port runs one process a device, joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU), and issues each
collective itself, at the points where the reference's einsums contract
over a sharded dim (the Megatron pattern):

* ``copy_to`` -- identity forward, all-reduce backward: a replicated
  activation (or weight) entering a region whose ranks each compute a
  partial share of its gradient;
* ``reduce_from`` -- all-reduce forward, identity backward: a region's
  partial outputs summed;
* ``fsdp_gather`` -- all-gather of a weight's ``"fsdp"`` dim forward,
  reduce-scatter of its gradient backward;
* ``seq_scatter`` / ``seq_gather`` -- a replicated sequence sliced to
  this rank's block (all-gather backward) and blocks gathered back
  (slice backward), around ring attention;
* ``all_reduce``, ``all_gather``, ``reduce_scatter`` and ``ring_shift``
  (``batch_isend_irecv`` to the next rank of an axis) without autograd.

Each takes the ``Rules`` and a role (or the mesh and its axes); a role
that resolves to no axis, or to axes of size 1, makes the call the
identity, and nothing is issued or counted (``counts`` then stays 0 on a
world of one).  Every call issued is counted by kind and axes:
``counts()`` gives ``{"all_reduce:model": n, ...}``, and ``byte_counts()``
the bytes of the tensors handed to ``torch.distributed`` under the same
keys (each call's operand, ``numel() * element_size()``: the input of an
all-gather, the whole input of a reduce-scatter, every tensor sent by a
ring shift), a device's share as the reference's ``collective_bytes``
counts operands in its per-device HLO; ``reset_counts`` zeroes both.
``all_reduce(..., op="mean")`` is ``jax.lax.pmean``: the sum divided by
the axes' size.

``init_world`` starts the process group: from the torchrun environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or from a ``FileStore`` path with an explicit rank and
world size.  ``torch.distributed`` is imported inside each function, never
when the module is imported.
"""
from __future__ import annotations

import collections
import os
import warnings
from typing import Optional, Sequence

import torch

_COUNTS: "collections.Counter[str]" = collections.Counter()
_BYTES: "collections.Counter[str]" = collections.Counter()
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def counts() -> dict:
    return dict(_COUNTS)


def byte_counts() -> dict:
    return dict(_BYTES)


def reset_counts() -> None:
    _COUNTS.clear()
    _BYTES.clear()


def _count(kind: str, axes, *operands: torch.Tensor) -> None:
    key = f"{kind}:{'+'.join(axes)}"
    _COUNTS[key] += 1
    _BYTES[key] += sum(t.numel() * t.element_size() for t in operands)


def _dist():
    import torch.distributed as dist
    return dist


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def torchrun_env() -> bool:
    """Whether the torchrun environment is present."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def world_started() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_world(device_type: str = "cuda", *, store_path: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Start the default process group (NCCL for ``cuda``, gloo for
    ``cpu``) unless it is up, and return this rank's device
    (``cuda:LOCAL_RANK``, or ``cpu``).  With ``store_path`` the ranks meet
    on a ``FileStore`` there (``rank`` and ``world_size`` required), else
    on the torchrun environment's ``env://`` rendezvous."""
    dist = _dist()
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*")
    warnings.filterwarnings("ignore", message=".*reduce_scatter_tensor.*")
    if not dist.is_initialized():
        if store_path is not None:
            if rank is None or world_size is None:
                raise ValueError("a FileStore world needs rank and "
                                 "world_size")
            kw = {"store": dist.FileStore(store_path, world_size),
                  "rank": rank, "world_size": world_size}
        elif torchrun_env():
            kw = {"init_method": "env://"}
            rank = int(os.environ["RANK"])
        else:
            raise RuntimeError(
                "init_world without store_path needs the torchrun "
                f"environment ({', '.join(TORCHRUN_ENV)})")
        dev = _local_device(device_type, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **kw)
    return world_device(device_type)


def _local_device(device_type: str, rank: int) -> torch.device:
    if device_type != "cuda":
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def world_device(device_type: Optional[str] = None) -> torch.device:
    """This rank's device in a started world."""
    dist = _dist()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _local_device(device_type, dist.get_rank())


def close_world() -> None:
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _comm(mesh, axes):
    """(group, size, this rank's index, perm) over ``axes`` of ``mesh``, or
    None where the axes span one rank.  ``perm[i]`` is the group rank of
    the member at linear index i (the first named axis major)."""
    axes = _axes(axes)
    if mesh is None or not axes:
        return None
    return mesh.comm(axes)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (``"max"``, or ``"mean"``: the sum over the axes' size) of
    ``x`` over ``axes``, in a new tensor."""
    if op not in ("sum", "max", "mean"):
        raise ValueError(f"all_reduce op {op!r}; expected sum, max or mean")
    c = _comm(mesh, axes)
    if c is None:
        return x
    dist = _dist()
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=c.group)
    _count("all_reduce", _axes(axes), out)
    return out.div_(c.size) if op == "mean" else out


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``axes``'s ranks joined along ``dim`` in linear order
    of the axes (the first named axis major)."""
    c = _comm(mesh, axes)
    if c is None:
        return x
    dist = _dist()
    x = x.contiguous().reshape((1,) + tuple(x.shape))
    out = x.new_empty((c.size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=c.group)
    _count("all_gather", _axes(axes), x)
    x = x[0]
    if c.perm is not None:
        out = out[c.perm]
    dim = dim % x.ndim
    out = out.movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= c.size
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, split along ``dim`` into the ranks'
    blocks in linear order; this rank's block."""
    c = _comm(mesh, axes)
    if c is None:
        return x
    dist = _dist()
    dim = dim % x.ndim
    n = c.size
    blocks = x.movedim(dim, 0)
    blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:])
    if c.perm is not None:
        inv = [0] * n
        for lin, grank in enumerate(c.perm):
            inv[grank] = lin
        blocks = blocks[inv]
    blocks = blocks.contiguous()
    out = blocks.new_empty(blocks.shape[1:])
    dist.reduce_scatter_tensor(out, blocks.reshape((-1,) + out.shape[1:]),
                               group=c.group)
    _count("reduce_scatter", _axes(axes), blocks)
    return out.movedim(0, dim)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axes
               ) -> list:
    """Each tensor sent to the next rank of ``axes`` (linear index + 1,
    wrapping) and received from the previous one, in one
    ``batch_isend_irecv``."""
    c = _comm(mesh, axes)
    if c is None:
        return list(tensors)
    dist = _dist()
    nxt, prv = c.members[(c.index + 1) % c.size], \
        c.members[(c.index - 1) % c.size]
    outs = [torch.empty_like(t) for t in tensors]
    sent = [t.contiguous() for t in tensors]
    ops = []
    for t, o in zip(sent, outs):
        ops.append(dist.P2POp(dist.isend, t, nxt, c.group))
        ops.append(dist.P2POp(dist.irecv, o, prv, c.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("ring_shift", _axes(axes), *sent)
    return outs


def barrier() -> None:
    if world_started():
        _dist().barrier()


def local_block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view)."""
    c = _comm(mesh, axes)
    if c is None:
        return x
    n = x.shape[dim] // c.size
    return x.narrow(dim, c.index * n, n)


# ---------------------------------------------------------------------------
# the conjugate pairs (autograd)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """all-gather forward, reduce-scatter backward (FSDP)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, \
            None


class _SeqScatter(torch.autograd.Function):
    """slice forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return local_block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _SeqGather(torch.autograd.Function):
    """all-gather forward, slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (local_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


def _role(rules, role: str):
    """(mesh, axes) of ``role`` under ``rules``, or None where it spans
    one rank."""
    if rules.mesh is None:
        return None
    axes = _axes(rules.axis(role))
    if not axes or rules.mesh.axes_size(axes) == 1:
        return None
    return rules.mesh, axes


def copy_to(x: torch.Tensor, rules, role: str = "tp") -> torch.Tensor:
    r = _role(rules, role)
    return x if r is None else _CopyTo.apply(x, *r)


def reduce_from(x: torch.Tensor, rules, role: str = "tp") -> torch.Tensor:
    r = _role(rules, role)
    return x if r is None else _ReduceFrom.apply(x, *r)


def fsdp_gather(w: torch.Tensor, rules, dim: int) -> torch.Tensor:
    """``w``'s ``"fsdp"`` dim ``dim`` gathered (reduce-scattered in the
    backward pass)."""
    r = _role(rules, "fsdp")
    return w if r is None else _Gather.apply(w, *r, dim)


def seq_scatter(x: torch.Tensor, rules, dim: int = 1) -> torch.Tensor:
    r = _role(rules, "seq_tp")
    return x if r is None else _SeqScatter.apply(x, *r, dim)


def seq_gather(x: torch.Tensor, rules, dim: int = 1) -> torch.Tensor:
    r = _role(rules, "seq_tp")
    return x if r is None else _SeqGather.apply(x, *r, dim)


def role_all_reduce(x: torch.Tensor, rules, role: str, op: str = "sum"
                    ) -> torch.Tensor:
    r = _role(rules, role)
    return x if r is None else all_reduce(x, *r, op=op)


def role_all_gather(x: torch.Tensor, rules, role: str, dim: int
                    ) -> torch.Tensor:
    r = _role(rules, role)
    return x if r is None else all_gather(x, *r, dim)


__all__ = ["all_gather", "all_reduce", "barrier", "byte_counts",
           "close_world", "copy_to", "counts", "fsdp_gather", "init_world",
           "local_block", "reduce_from", "reduce_scatter", "reset_counts",
           "ring_shift", "role_all_gather", "role_all_reduce", "seq_gather",
           "seq_scatter", "torchrun_env", "world_device", "world_started"]
