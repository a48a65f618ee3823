"""Dry run: trace every (arch x shape x mesh) cell through the port's
sharded steps on a fake world (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for the 16 x 16 (256-chip)
and 2 x 16 x 16 (512-chip) meshes and reads XLA's memory and cost
analyses.  The port runs one process a device, so a cell here is rank 0
of a ``fake`` process-group world of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective is
accepted and moves nothing), its mesh bound by ``Mesh.from_world``, its
step built by ``launch.steps.build_step`` as the reference's
``_compile_cell`` builds it (AdamW moments of ``--moments`` for train, the
decode state of ``input_specs`` for decode), and one step run eagerly on
tensors of the ``meta`` device: shapes, dtypes and strides, no data, and
no card needed.  The model is built and sharded without a draw.  The
kernels' wrappers take their fake branch (``kernels.launch``): the same
outputs and scratch as a launch, the call's FLOPs and bytes counted, no
launch.  Meta tensors rather than ``FakeTensorMode``'s fakes: the same
shapes and the same counts in a fraction of the time an op (one
falcon-mamba-7b layer's train step on 16 x 16 at 1024 tokens, counts
included: 2.0 s on meta, 9.6 s under ``FakeTensorMode`` with its cache
off), which the scan backward's step-by-step loop multiplies; and a fake
``cuda`` tensor cannot be indexed from Python on a host without a
card.

Each cell gives one JSON record, with the reference's keys:

* ``memory``: ``argument_bytes`` (this rank's parameters, moments, step
  and batch or decode state), ``output_bytes`` (the step's outputs; the
  train step updates its state in place), ``peak_bytes`` (the most live
  bytes on the rank during the step, the inputs live from the start:
  ``StepCounter``) and ``fits`` (``peak_bytes`` <= ``H100_BYTES``);
* ``flops_per_device``: ``FlopCounterMode``'s count of the traced step
  (``StepCounter``, with its formulas) plus each fake kernel call's FLOPs (``kernels.flash_attention.
  attention_flops``, ``kernels.mamba_scan.scan_flops``);
* ``bytes_per_device``: every aten op's tensor inputs and outputs
  (views and collectives excluded) plus each kernel call's own I/O: an
  unfused upper bound of the HBM traffic;
* ``collectives``: ``parallel.collectives.byte_counts()`` of the step,
  by kind and axes (the operand bytes of each call, as the reference's
  ``collective_bytes`` counts an HLO's);
* ``roofline``: those over the H100 SXM constants below.

The reference extrapolates its costs from 1- and 2-group lowerings
(``_extrapolated_costs``) because XLA's ``cost_analysis`` counts a
``lax.scan`` body once.  The eager trace runs every layer, so its counts
are whole and nothing is extrapolated; ``trace_s`` (the step's trace
time) replaces ``compile_s`` and ``cost_extraction_s``.  ``--no-cost``
skips the FLOP and byte counting (as the reference, for the multi-pod
cells of ``--all``).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import kernels
from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, ShapeCell, applicable
from ..models import transformer as tfm
from ..optim import adamw
from ..parallel import collectives as C
from ..parallel.sharding import Mesh
from . import accounting
from . import steps as steps_mod

# H100 SXM (the card the port runs on), per rank
PEAK_FLOPS = 989e12     # bf16 dense tensor-core FLOP/s (PERF.md section 3)
HBM_BW = 3.35e12        # bytes/s of HBM3 (PERF.md section 3)
NVLINK_BW = 450e9       # bytes/s a direction, NVLink 4: a group inside a node
NIC_BW = 50e9           # bytes/s, one 400 Gb/s NIC a GPU: a group across nodes
NODE_RANKS = 8          # a node holds 8 consecutive ranks
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (700 W), as chip_smoke.py's phase 17 prints it
H100_BYTES = 85_017_493_504

DEVICE = "meta"         # the dry run's tensors: shapes, no data, no card
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process-group world of ``world_size`` ranks, this
    process rank 0, torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        warnings.filterwarnings("ignore", message=f".*{name}.*")
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake world; a process "
                           "group is already up")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def state_tensors(tree) -> list:
    """The tensors of ``tree``, a module's parameters and buffers
    among them."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out += list(x.parameters()) + list(x.buffers())
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold."""
    seen, total = set(), 0
    for t in state_tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class StepCounter(TorchDispatchMode):
    """Live bytes, their peak, and (with ``cost``) the FLOPs and bytes of
    every aten op that runs under it.

    Live bytes: each storage an op returns counts from then until it is
    freed (a weak reference's finalizer), rounded up to the caching
    allocator's 512 bytes; the storages of ``live`` count from the
    start.  FLOPs: ``torch.utils.flop_counter``'s formula of each op
    (``FlopCounterMode``'s registry).  Bytes: each op's tensor inputs and
    outputs, views and collectives excluded (an in-place op counts its
    operand read and written).

    ``MemTracker`` keeps the same live set but hooks every parameter's
    gradient, which serving's models do not have, and beside
    ``FlopCounterMode``'s module hooks the activations stayed alive (on
    olmo-1b ``train_4k``, 16 x 16: a 29.4 GB peak against 9.41 GB alone),
    so one mode here counts all three."""

    def __init__(self, live=(), cost: bool = True):
        super().__init__()
        self.cost = cost
        self.now = self.peak = 0
        self.flops = self.bytes = 0
        self._live = set()
        for t in live:
            self._add(t)

    def _free(self, key, n: int) -> None:
        self._live.discard(key)
        self.now -= n

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st._cdata in self._live:
            return
        n = -(-st.nbytes() // 512) * 512
        self._live.add(st._cdata)
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, st._cdata, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._add(t)
        if self.cost:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not (func.is_view or func.namespace == "c10d"):
                self.bytes += sum(t.numel() * t.element_size() for t in
                                  _tensors((args, kwargs)) + outs)
        return out


def _group_bw(mesh: Mesh, axes) -> float:
    """NVLink for a group of ranks inside one node of ``NODE_RANKS``
    consecutive ranks, the NIC for one across nodes."""
    c = mesh.comm(axes)
    nodes = {m // NODE_RANKS for m in c.members}
    return NVLINK_BW if len(nodes) == 1 else NIC_BW


def collective_seconds(colls: dict, mesh: Mesh) -> float:
    """Each kind's bytes over its group's bandwidth, summed."""
    return sum(n / _group_bw(mesh, key.split(":", 1)[1].split("+"))
               for key, n in colls.items() if n)


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------

def trace(fn, args, live, cost: bool = True) -> dict:
    """``fn(*args)`` once, on the meta tensors of ``args``: the output,
    the peak live bytes (the tensors of ``live``, a module's parameters
    among them, live from the start), the FLOPs and bytes outside the
    kernels, the fake kernels' counts, the collectives' bytes and the
    wall time."""
    kernels.reset_fake_counts()
    C.reset_counts()
    counter = StepCounter(state_tensors(live), cost)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    return {"out": out, "trace_s": time.perf_counter() - t0,
            "peak_bytes": counter.peak, "aten_flops": counter.flops,
            "aten_bytes": counter.bytes, "kernels": kernels.fake_counts(),
            "collectives": C.byte_counts()}


def _local_inputs(specs: dict, nb: int) -> dict:
    """Meta tensors of this rank's rows of each input (shape, dtype)."""
    return {k: torch.empty((shp[0] // nb,) + tuple(shp[1:]), dtype=dt,
                           device=DEVICE) for k, (shp, dt) in specs.items()}


def build_cell(cfg, shape: ShapeCell, mesh: Mesh, moments: str):
    """(step, its args, the tensors live before it) of the cell on
    ``mesh``, on the meta device, as the reference's ``_compile_cell``
    builds it."""
    kw = {}
    if shape.kind == "train":
        kw["opt_cfg"] = adamw.AdamWConfig(moment_dtype=moments)
    step, specs = steps_mod.build_step(shape.kind, cfg, shape, mesh=mesh,
                                       **kw)
    rules = step.rules
    model = tfm.Transformer(cfg, DEVICE, train=shape.kind == "train")
    tfm.shard_model(model, rules)
    nb = rules.size("batch")
    if shape.kind == "train":
        params = dict(model.named_parameters())
        opt = adamw.init(params, kw["opt_cfg"],
                         tfm.param_shardings(model, rules))
        state = steps_mod.TrainState(model, opt, torch.zeros(
            (), dtype=torch.int32, device=DEVICE))
        batch = _local_inputs(specs, nb)
        return step, (state, batch), (model, opt, state.step, batch)
    if shape.kind == "prefill":
        batch = _local_inputs(specs, nb)
        return step, (model, batch), (model, batch)
    state = tfm.make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  device=DEVICE, rules=rules)
    token = _local_inputs({"token": specs["token"]}, nb)["token"]
    return step, (model, state, token), (model, state, token)


def cell_record(t: dict, args, mesh: Mesh) -> dict:
    """The record's measured keys from ``trace``'s result."""
    k_flops = sum(k["flops"] for k in t["kernels"].values())
    k_bytes = sum(k["bytes"] for k in t["kernels"].values())
    flops = t["aten_flops"] + k_flops
    n_bytes = t["aten_bytes"] + k_bytes
    colls = t["collectives"]
    coll = float(sum(colls.values()))
    return {
        "trace_s": round(t["trace_s"], 2),
        "memory": {"argument_bytes": tensor_bytes(args),
                   "output_bytes": tensor_bytes(t["out"]),
                   "peak_bytes": t["peak_bytes"],
                   "fits": t["peak_bytes"] <= H100_BYTES},
        "flops_per_device": float(flops),
        "kernel_flops_per_device": float(k_flops),
        "bytes_per_device": float(n_bytes),
        "kernel_calls": {k: v["calls"] for k, v in t["kernels"].items()},
        "collective_bytes_per_device": coll,
        "collectives": colls,
        "roofline": {"compute_s": flops / PEAK_FLOPS,
                     "memory_s": n_bytes / HBM_BW,
                     "collective_s": collective_seconds(colls, mesh)},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             moments: str = "float32", verbose: bool = True,
             no_cost: bool = False, overrides=None, *, cfg=None,
             shape: Optional[ShapeCell] = None, mesh_axes=None) -> dict:
    """The record of one cell.  ``cfg``, ``shape`` and ``mesh_axes``
    ((shape, names)) replace the arch's config, the named shape and the
    production mesh (tests, and chip_smoke's cells at a world of one)."""
    cfg = cfg if cfg is not None else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape if shape is not None else SHAPES[shape_name]
    dims, names = mesh_axes or MESHES[multi_pod]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(n) for n in dims),
           "kind": shape.kind, "moments": moments,
           "overrides": overrides or {}}
    skip = applicable(cfg, shape)
    if skip:
        rec["skipped"] = skip
        return rec
    chips = math.prod(dims)
    with fake_world(chips):
        mesh = Mesh.from_world(dims, names, device=DEVICE)
        step, args, live = build_cell(cfg, shape, mesh, moments)
        t = trace(step, args, live, cost=not no_cost)
        rec.update(chips=chips, **cell_record(t, args, mesh))
    model_f = accounting.model_flops(cfg, shape)
    counts = accounting.param_counts(cfg)
    flops_dev = rec["flops_per_device"]
    rec.update(model_flops=model_f, param_count=counts["total"],
               active_params=counts["active"],
               useful_flops_ratio=(model_f / (flops_dev * chips)
                                   if flops_dev else None))
    r = rec["roofline"]
    rec["dominant"] = max(r, key=r.get)
    if verbose:
        mem = rec["memory"]
        print(f"== {arch} x {shape_name} on {rec['mesh']} ({shape.kind}) ==")
        print(f"  trace {rec['trace_s']:.1f}s")
        print(f"  memory: argument {mem['argument_bytes']:.3e} B, output "
              f"{mem['output_bytes']:.3e} B, peak {mem['peak_bytes']:.3e} B"
              f" (fits {mem['fits']})")
        print(f"  cost: flops={flops_dev:.3e}/dev "
              f"bytes={rec['bytes_per_device']:.3e}/dev")
        print(f"  collectives: "
              f"{ {k: f'{v:.3e}' for k, v in rec['collectives'].items()} }")
        print(f"  roofline: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s -> {rec['dominant']}"
              f"-bound")
        ratio = rec["useful_flops_ratio"]
        print(f"  MODEL_FLOPS/FLOPS = {ratio and round(ratio, 3)}")
    return rec


def cell_id(arch, shape, multi_pod, moments="float32"):
    pod = "mp" if multi_pod else "sp"
    return f"{arch}__{shape}__{pod}__{moments}"


def _parse_overrides(pairs):
    """``key=value`` pairs: an int, a float, True/False, else the
    string."""
    out = {}
    for kv in pairs or ():
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moments", default="float32")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (hillclimb variants)")
    ap.add_argument("--tag", default=None, help="suffix for the output file")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    cid = cell_id(arch, shape, mp, args.moments)
                    f = out_dir / f"{cid}.json"
                    if f.exists():
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--moments", args.moments, "--out", str(out_dir)]
                    if mp:
                        cmd.extend(["--multipod", "--no-cost"])
                    print(f">>> {cid}", flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    if r.returncode != 0:
                        failures.append(cid)
                        (out_dir / f"{cid}.err").write_text(
                            r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                        print(f"    FAILED (see {cid}.err)", flush=True)
                    else:
                        print(r.stdout[-1200:], flush=True)
        print(f"done; {len(failures)} failures: {failures}")
        return failures

    rec = run_cell(args.arch, args.shape, args.multipod, args.moments,
                   no_cost=args.no_cost,
                   overrides=_parse_overrides(args.override))
    cid = cell_id(args.arch, args.shape, args.multipod, args.moments)
    if args.tag:
        cid += f"__{args.tag}"
    (out_dir / f"{cid}.json").write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
