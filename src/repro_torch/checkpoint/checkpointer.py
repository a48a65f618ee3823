"""Atomic, versioned checkpointing (port of
``repro.checkpoint.checkpointer``), on the reference's on-disk layout:

  <dir>/step_<n>.tmp/...   (written, fsynced)
  <dir>/step_<n>/          (atomic rename = commit)
  <dir>/step_<n>/manifest.json   (leaf keys, shapes, dtypes, metadata)
  leaves stored as .npy keyed by their path in the state

A state is a tree of dicts, tuples and NamedTuples (keyed by field name),
lists, ``nn.Module``s (keyed by ``state_dict`` names), tensors, numpy
arrays and Python numbers; None is an empty subtree, as in a JAX pytree.
A leaf's key joins its path with ``__`` (``params__layers.0.mixer.wq``,
``opt__v__embed.tok__q``).  numpy has no bfloat16: a bf16 leaf is stored
as its ``uint16`` bits and named ``"bfloat16"`` in the manifest.

``restore`` checks every leaf of ``state_like`` against the manifest (a
missing leaf, a shape, a stored dtype) before it loads any, then returns
the state: new tensors on each template tensor's device in its dtype (the
reference casts to the template's dtype too), numpy arrays and numbers
for those leaves, and each ``nn.Module`` of the template loaded in place.

On a mesh the state holds each rank's shards.  ``save(...,
shardings=)`` (a tree matching the state, a ``parallel.Sharding`` at each
sharded leaf, None or absent elsewhere) writes the LOGICAL tensors: every
rank gathers each sharded leaf, rank 0 alone writes, and every rank waits
at a barrier for the commit.  ``restore(..., shardings=)`` reads the
logical tensors and places each rank's block, onto any mesh: the mesh
that saved need not be the one that restores.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, nn.Module):
        return list(node.state_dict(keep_vars=True).items())
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(node, path=()) -> List[Tuple[str, Any]]:
    if node is None:
        return []
    kids = _children(node)
    if kids is None:
        return [("__".join(path) or "root", node)]
    return [leaf for k, c in kids for leaf in _flatten(c, path + (k,))]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _shardings(shardings) -> Dict[str, Any]:
    """{leaf key: Sharding} of a shardings tree (its leaves keyed as the
    state's are)."""
    return dict(_flatten(shardings)) if shardings is not None else {}


def _writer(shardings: Dict[str, Any]) -> bool:
    """Whether this process writes: rank 0 of a sharded save, or the one
    process of an unsharded one."""
    for sh in shardings.values():
        mesh = sh.rules.mesh
        if mesh is not None and mesh.bound:
            return mesh.rank == 0
    return True


def save(directory, step: int, state, metadata: Optional[Dict] = None,
         keep: int = 3, shardings=None) -> pathlib.Path:
    d = pathlib.Path(directory)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    shards = _shardings(shardings)
    writer = _writer(shards)
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()

    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _flatten(state):
        if key in shards and isinstance(leaf, torch.Tensor):
            leaf = shards[key].gather(leaf.detach())
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    if not writer:
        _barrier(shards)
        return final
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)          # atomic commit
    _retain(d, keep)
    _barrier(shards)
    return final


def _barrier(shardings: Dict[str, Any]) -> None:
    if any(sh.rules.mesh is not None and sh.rules.mesh.bound
           for sh in shardings.values()):
        from ..parallel import collectives
        collectives.barrier()


def _retain(d: pathlib.Path, keep: int):
    steps = sorted(all_steps(d))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def all_steps(directory) -> list:
    d = pathlib.Path(directory)
    out = []
    for p in d.glob("step_*"):
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load(path: pathlib.Path, key: str, meta: dict) -> np.ndarray:
    arr = np.load(path / f"{key}.npy")
    stored = "uint16" if meta["dtype"] == "bfloat16" else meta["dtype"]
    if str(arr.dtype) != stored or list(arr.shape) != meta["shape"]:
        raise ValueError(f"{key}: file holds {arr.dtype} {arr.shape}, the "
                         f"manifest says {meta['dtype']} {meta['shape']}")
    return arr


def _as_like(arr: np.ndarray, dtype: str, like):
    """The stored array as the template leaf's kind, device and dtype."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return t.float().numpy() if dtype == "bfloat16" else arr.astype(
            like.dtype)
    return type(like)(arr.item()) if arr.ndim == 0 else arr


def _rebuild(node, values: dict, path=()):
    """``node``'s structure with each leaf replaced from ``values``;
    modules loaded in place."""
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return values["__".join(path) or "root"]
    out = [(k, _rebuild(c, values, path + (k,))) for k, c in kids]
    if isinstance(node, nn.Module):
        tensors = node.state_dict(keep_vars=True)
        with torch.no_grad():
            for k, t in out:
                tensors[k].copy_(t)
        return node
    if isinstance(node, dict):
        return {k: v for k, (_, v) in zip(sorted(node), out)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(v for _, v in out))
    return type(node)(v for _, v in out)


def restore(directory, state_like, step: Optional[int] = None,
            shardings=None):
    """Load ``step`` (default: latest) into the structure of
    ``state_like`` (on a mesh its local shards, placed by ``shardings``,
    a tree matching the state).  Returns (state, metadata)."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    cdir = d / f"step_{step}"
    manifest = json.loads((cdir / "manifest.json").read_text())

    flat = _flatten(state_like)
    shards = _shardings(shardings)
    for key, like in flat:          # every check before anything is read
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {cdir} missing leaf {key}")
        want_shape = tuple(getattr(like, "shape", meta["shape"]))
        have = tuple(meta["shape"])
        if key in shards:
            have = shards[key].shape(have)
        if have != want_shape:
            raise ValueError(f"{key}: checkpoint shape "
                             f"{tuple(meta['shape'])} != expected "
                             f"{want_shape}")
    arrays = {key: _load(cdir, key, manifest["leaves"][key])
              for key, _ in flat}
    for key, sh in shards.items():
        if key in arrays:
            a = arrays[key]
            wide = a.view(np.int16) if a.dtype == np.uint16 else a
            block = sh.local(torch.from_numpy(wide)).contiguous().numpy()
            arrays[key] = block.view(a.dtype)
    values = {key: _as_like(arrays[key], manifest["leaves"][key]["dtype"],
                            like) for key, like in flat}
    return _rebuild(state_like, values), manifest["metadata"]


__all__ = ["all_steps", "latest_step", "restore", "save"]
