"""PCA-compressed cross-pod gradient exchange (port of
``repro.launch.pod_compression``).

The paper's Jacobi/SVD engine applied as a distributed-optimization
trick: on a ("pod", "data", "model") mesh the "pod" axis is the slow
link.  The step runs data-parallel over every rank, one process a rank
under ``torch.distributed`` (NCCL on cards, gloo on the CPU): each rank
holds the model whole and takes its rows of the global batch (sharded
over ("pod", "data", "model"), the first axis major, the reference's
``tok_spec``); the gradients are mean-all-reduced over the fast in-pod
axes ("data", "model"), then the pod exchange is either

  baseline   -- a mean of every gradient leaf over "pod"
  compressed -- ``optim.compression.compress_tree`` with
                ``axis_name="pod"``, ``min_size=65536`` on the
                reference's layer-stacked layout: the mean of P (m, r)
                and Q (n, r) and of each exact leaf over "pod", P
                orthonormalised through a Jacobi eigh of its r x r Gram
                (on the card the ``covariance`` and ``jacobi_sweep_smem``
                kernels); the error feedback and Q pod-local (each rank
                holds its pod's, equal across the pod),

then a fresh ``adamw.init`` and ``adamw.update``, as the reference's
step.  Each flat-buffer mean is ``launch.steps.all_reduce_tree`` (one
all-reduce a dtype; XLA combines the reference's leaves as well).  The
in-pod collectives are the same in both modes, so the difference in
bytes is the pod exchange's saving.  The reference counts operand bytes
in XLA's per-device HLO; here every collective is issued and counted by
``parallel.collectives`` (``byte_counts()``: the tensors handed to
``torch.distributed``), so the bytes are the port's own.  A collective
whose axes span one rank is elided and counts nothing: a world of one
moves 0 bytes.  Gradients are reduced in their own dtype (the
reference's CPU HLO reduces every gradient in f32, bf16 leaves too).

``main`` runs both modes for ``--steps`` steps each from the same
weights (drawn from ``--seed``), each from ``collectives.reset_counts()``
and every step's bytes equal, and writes the reference's file
(``{out}/pod_compression_{arch}_L{layers}_r{rank}.json``: per mode
``collectives`` by kind and ``total_bytes``, a step's; then
``pod_exchange_savings_bytes`` and ``reduction_factor_total``) with the
bytes by axes, the counts by key, ``compress_tree``'s metrics, each
step's seconds (synchronised; the mean leaves the first out), peak
device memory, the world, the mesh and the card.  ``--mesh`` must hold
the world's ranks (default the reference's 2 x 16 x 16); ``--batch`` is
the global batch and must split over them.  ``--reduced`` takes the
arch's ``reduced_config`` at ``REDUCED_WIDTHS``, the narrowest widths at
which leaves reach ``min_size``.  Rank 0 writes and prints.

On 8 processes of the CPU:
  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      -m repro_torch.launch.pod_compression --device cpu --mesh 2,2,2 \\
      --reduced --layers 2 --seq 64 --batch 16 --rank 4
On one card (a world of one needs no torchrun):
  PYTHONPATH=src python -m repro_torch.launch.pod_compression \\
      --mesh 1,1,1 --batch 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config, reduced_config
from ..kernels import launch_counts
from ..models import transformer as tfm
from ..optim import adamw
from ..optim import compression as comp
from ..parallel import collectives as C
from ..parallel.sharding import Mesh
from .steps import all_reduce_tree, init_compression, stack_layers, \
    unstack_layers

AXES = ("pod", "data", "model")
INPOD = ("data", "model")
MODES = ("baseline", "compressed")
MIN_SIZE = 65536
REDUCED_WIDTHS = dict(d_model=256, d_ff=1024, vocab_size=1024, head_dim=64)


def comp_config(rank: int) -> comp.CompressionConfig:
    return comp.CompressionConfig(rank=rank, axis_name="pod",
                                  min_size=MIN_SIZE)


def build(cfg, mesh: Mesh, seq: int, global_batch: int, mode: str,
          rank: int):
    """The step of ``mode`` on this rank of ``mesh`` (a ``Mesh`` on
    ``AXES``, bound to the process group or of one device):
    ``step(model, tokens, comp_state) -> (new comp_state, metrics)``.
    ``model`` (the whole model, replicated) is updated in place;
    ``tokens`` is the global batch (global_batch, seq) or this rank's
    rows; ``comp_state`` is this rank's pod's state (``init_state``; the
    baseline passes it through)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    if tuple(mesh.axis_names) != AXES:
        raise ValueError(f"a mesh on {AXES}, got {mesh.axis_names}")
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"the mesh's {mesh.size} ranks")
    comp_cfg = comp_config(rank)
    opt_cfg = adamw.AdamWConfig()
    dev = mesh.device
    rows = global_batch // mesh.size
    lo = mesh.axes_index(AXES) * rows

    def step(model, tokens, comp_state):
        tokens = torch.as_tensor(tokens, device=dev)
        if tokens.shape[1] != seq:
            raise ValueError(f"tokens of length {tokens.shape[1]}, the "
                             f"step's is {seq}")
        if tokens.shape[0] == global_batch:
            tokens = tokens[lo:lo + rows]
        params = dict(model.named_parameters())
        loss, _ = tfm.loss_fn(model, {"tokens": tokens.long()}, cfg)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        grads = all_reduce_tree(grads, mesh, INPOD, op="mean")
        metrics = {}
        if mode == "compressed":
            stacked, comp_state, metrics = comp.compress_tree(
                stack_layers(grads, cfg), comp_state, comp_cfg, mesh=mesh)
            grads = unstack_layers(stacked, grads, cfg)
        else:
            grads = all_reduce_tree(grads, mesh, ("pod",), op="mean")
        opt = adamw.init(params, opt_cfg)
        _, _, opt_metrics = adamw.update(grads, opt, params, opt_cfg)
        return comp_state, dict(metrics, loss=loss.detach(), **opt_metrics)

    return step


def seeded_tokens(cfg, steps: int, batch: int, seq: int, seed: int
                  ) -> torch.Tensor:
    """Every step's global batch, (steps, batch, seq) on the host, drawn
    from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (steps, batch, seq),
                         generator=gen)


def init_pod_state(model, cfg, mesh: Mesh, rank: int, seed: int
                   ) -> comp.CompressionState:
    """This rank's pod's compression state: each subspace drawn from a
    generator seeded with ``seed`` and the pod's index (so pods differ
    and the ranks of one pod agree), the error feedback zero."""
    gen = torch.Generator(device=mesh.device).manual_seed(
        (seed << 16) + mesh.coords["pod"] + 1)
    return init_compression(dict(model.named_parameters()), cfg,
                            comp_config(rank), gen)


def expected_bytes(params: Dict[str, torch.Tensor], cfg, rank: int,
                   mesh_shape: Dict[str, int]) -> Dict[str, int]:
    """A step's all-reduce bytes a rank in each mode from the leaves'
    sizes alone: the in-pod mean of every gradient (its dtype), then the
    pod's mean of every gradient (baseline) or of each exact leaf and the
    fp32 P (m, r) and Q (n, r) of each compressed one; a part whose axes
    span one rank moves nothing."""
    def size(t):
        return t.numel() * t.element_size()
    inpod = mesh_shape["data"] * mesh_shape["model"] > 1
    pod = mesh_shape["pod"] > 1
    whole = sum(size(p) for p in params.values())
    exchange = 0
    shapes = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for k, p in params.items()}
    for p in stack_layers(shapes, cfg).values():
        if p.ndim < 2 or p.numel() < MIN_SIZE:
            exchange += size(p)
        else:
            m = p.numel() // p.shape[-1]
            exchange += (m + p.shape[-1]) * rank * 4
    base = whole * inpod
    return {"baseline": base + whole * pod,
            "compressed": base + exchange * pod}


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of this rank's card."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={torch.cuda.current_device()}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _world_mesh(shape, dev: torch.device) -> Mesh:
    """The mesh of ``shape`` over the started world (started here from the
    torchrun environment), or over ``dev`` alone in a world of one."""
    if C.torchrun_env() and not C.world_started():
        C.init_world(dev.type)
    world = 1
    if C.world_started():
        import torch.distributed as dist
        world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"--mesh {','.join(map(str, shape))} holds "
                         f"{int(np.prod(shape))} ranks; the world has "
                         f"{world}")
    if C.world_started():
        return Mesh.from_world(shape, AXES)
    return Mesh(np.full(shape, dev, dtype=object), AXES)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_mode(cfg, mesh: Mesh, args, mode: str, tokens: torch.Tensor
             ) -> dict:
    """``--steps`` steps of ``mode`` from the weights of ``--seed``: a
    step's collectives and bytes, the metrics, the seconds, peak memory
    and kernel launches."""
    dev = mesh.device
    model = tfm.init_model(cfg, seed=args.seed, device=dev, train=True)
    state = init_pod_state(model, cfg, mesh, args.rank, args.seed)
    step = build(cfg, mesh, args.seq, args.batch, mode, args.rank)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    seconds, losses, per_step, metrics = [], [], [], {}
    for s in range(args.steps):
        C.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(model, tokens[s], state)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        per_step.append((C.counts(), C.byte_counts()))
        losses.append(float(m["loss"]))
        metrics = {k: m[k] for k in ("compressed_bytes", "exact_bytes")
                   if k in m}
    if any(p != per_step[0] for p in per_step):
        raise RuntimeError(f"{mode}: the steps' collectives differ: "
                           f"{per_step}")
    counts, by_axes = per_step[0]
    kinds: Dict[str, int] = {}
    for key, n in by_axes.items():
        kind = key.split(":")[0].replace("_", "-")
        kinds[kind] = kinds.get(kind, 0) + n
    timed = seconds[1:] or seconds
    return {"collectives": kinds, "total_bytes": float(sum(kinds.values())),
            "bytes_by_axes": by_axes, "counts": counts,
            "metrics": metrics, "losses": losses, "step_s": seconds,
            "mean_step_s": sum(timed) / len(timed),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "launches": {k: n - before[k] for k, n in launch_counts().items()
                         if n > before[k]},
            "expected_bytes": expected_bytes(
                dict(model.named_parameters()), cfg, args.rank,
                dict(mesh.shape))[mode]}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=512,
                    help="the global batch, split over the world's ranks")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--mesh", default="2,16,16",
                    help="POD,DATA,MODEL; their product is the world size")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced_config at REDUCED_WIDTHS")
    args = ap.parse_args(argv)
    args.mesh_shape = tuple(int(n) for n in args.mesh.split(","))
    if len(args.mesh_shape) != len(AXES) or min(args.mesh_shape) < 1:
        ap.error(f"--mesh {args.mesh}: three positive sizes, {AXES}")
    return args


def main(argv=None) -> dict:
    """Both modes; returns the record that rank 0 writes."""
    args = parse(argv)
    dev = resolve_device(args.device)
    mesh = _world_mesh(args.mesh_shape, dev)
    if args.batch % mesh.size:
        raise ValueError(f"--batch {args.batch} does not split over the "
                         f"world's {mesh.size} ranks")
    cfg = (reduced_config(args.arch, **REDUCED_WIDTHS) if args.reduced
           else get_config(args.arch))
    cfg = dataclasses.replace(cfg, n_layers=args.layers, remat=False)
    tokens = seeded_tokens(cfg, args.steps, args.batch, args.seq,
                           args.seed)
    lead = mesh.rank == 0
    rec = {"arch": args.arch, "layers": args.layers, "rank": args.rank,
           "seq": args.seq, "batch": args.batch, "steps": args.steps,
           "seed": args.seed, "world": mesh.size, "mesh": dict(mesh.shape),
           "device": str(dev), "dtype": cfg.dtype,
           "card": card() if dev.type == "cuda" else None}
    for mode in MODES:
        run = rec[mode] = run_mode(cfg, mesh, args, mode, tokens)
        if lead:
            kinds = {k: f"{v:.3e}" for k, v in run["collectives"].items()}
            print(f"{mode}: {kinds} total={run['total_bytes']:.3e}",
                  flush=True)
    b = rec["baseline"]["total_bytes"]
    c = rec["compressed"]["total_bytes"]
    rec["pod_exchange_savings_bytes"] = b - c
    rec["reduction_factor_total"] = b / max(c, 1)
    if lead:
        print(f"pod-exchange saving: {b - c:.3e} bytes/dev "
              f"({b / max(c, 1):.2f}x total-collective reduction)",
              flush=True)
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"pod_compression_{args.arch}_L{args.layers}_r{args.rank}"
         ".json").write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
