"""End-to-end trainer (port of ``repro.launch.train``): data pipeline ->
train step -> checkpoints, with watchdog stall detection, straggler
accounting, preemption-safe SIGTERM handling and resume, on one device.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 8 --global-batch 4 --seq-len 4096
On the CPU, from Python:
  from repro_torch.launch import train
  train.main(["--arch", "olmo-1b", "--reduced", "--steps", "20",
              "--global-batch", "4", "--seq-len", "32"], device="cpu")

The flags and the behaviour are the reference CLI's: warmup
max(2, steps // 10) and cosine decay over ``--steps``; zero ``patches``
(vlm) and ``frames`` (encdec) in the model's dtype; a stalled step writes
an emergency checkpoint and exits with ``STALL_EXIT_CODE``; ``--preempt-at
N`` checkpoints after step N and returns; ``--ckpt-dir`` resumes from its
latest checkpoint (weights, moments, compression state and the data
cursor); SIGTERM/SIGINT checkpoint after the current step and exit with
``STALL_EXIT_CODE``.  ``main`` returns the losses and prints the
reference's final JSON line.  The weights are drawn from a
``torch.Generator`` seeded with ``--seed`` (the reference's come from
``jax.random``).

Devices.  Where the torchrun environment is present (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) ``main``
starts the process group (NCCL on cards, gloo with ``device="cpu"``), or
joins one the caller started; then ``runtime.pick_mesh(--model-parallel,
global_batch=)`` lays the world's ranks on a (data, model) mesh as the
reference does, ``cfg.tp`` is its model axis, and the step runs on each
rank's shards (``launch.steps``), the pipeline reading the rows of the
rank's data coordinate.  Without that environment the mesh is the one
device, (1, 1) whatever ``--model-parallel`` asks, as the reference on
one device.  Rank 0 alone prints; a rank the mesh leaves idle returns
no losses.  On 8 cards:
  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      -m repro_torch.launch.train --arch olmo-1b \\
      --model-parallel 4 --global-batch 8 --seq-len 4096

``run(cfg, parse_args(argv))`` is the CLI's body after the config: it
trains any ``ModelConfig`` (a depth-cut one too) on the CLI's flags, so
``main(argv)`` is ``run`` of ``--arch``'s config on the mesh ``main``
picks.  ``inputs`` is a step's batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys

import torch

from .._device import DeviceLike, resolve_device
from ..checkpoint import checkpointer
from ..configs import get_config, reduced_config
from ..configs.shapes import ShapeCell
from ..data import DataConfig, TokenPipeline
from ..models import transformer as tfm
from ..optim import adamw
from ..optim import compression as comp
from ..parallel import collectives as C
from ..runtime import STALL_EXIT_CODE, Watchdog, pick_mesh
from . import steps as steps_mod


def world_mesh(model_parallel: int, global_batch: int, device: DeviceLike):
    """(the mesh, this rank's device): the process group started from the
    torchrun environment where it is present (or joined where the caller
    started one) and the world's ranks picked onto a (data, model) mesh;
    else a (1, 1) mesh of ``device``."""
    dev = resolve_device(device)
    if C.torchrun_env() and not C.world_started():
        C.init_world(dev.type)
    if C.world_started():
        mesh = pick_mesh(model_parallel, global_batch=global_batch)
        return mesh, (mesh.device if mesh.member else dev)
    return pick_mesh(model_parallel, devices=[dev],
                     global_batch=global_batch), dev


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags (the reference's, and ``--seed``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--moments", default="float32")
    ap.add_argument("--compress-grads", type=int, default=0,
                    help="PCA gradient compression rank (0 = off)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--preempt-at", type=int, default=0,
                    help="simulate preemption: checkpoint + stop after N steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def inputs(cfg, tokens, device: DeviceLike = None) -> dict:
    """A step's batch: ``tokens`` (B, S) as int64 on the device, and
    zero ``patches`` (vlm) or ``frames`` (encdec) in the model's dtype."""
    dev = resolve_device(device)
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64,
                                       device=dev)}
    extra = {"vlm": ("patches", cfg.n_patches),
             "encdec": ("frames", cfg.n_frames)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.zeros(
            batch["tokens"].shape[0], extra[1], cfg.d_model,
            dtype=cfg.torch_dtype(), device=dev)
    return batch


def run(cfg, args: argparse.Namespace, device: DeviceLike = None,
        mesh=None) -> list:
    """The trainer for any ``ModelConfig`` (a depth-cut one too): init or
    resume, the pipeline, the steps under the watchdog, checkpoints and
    the final JSON line, on ``args`` (``parse_args``; ``--arch``,
    ``--reduced`` and ``--model-parallel`` are the caller's).  ``mesh``
    (default: a (1, 1) mesh of ``device``) sets ``cfg.tp`` to its model
    axis.  Returns the losses."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = pick_mesh(1, devices=[dev], global_batch=args.global_batch)
    cfg = dataclasses.replace(cfg, tp=mesh.shape["model"])
    shape = ShapeCell("cli", args.seq_len, args.global_batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, moment_dtype=args.moments,
                                warmup_steps=max(2, args.steps // 10),
                                decay_steps=args.steps)
    comp_cfg = (comp.CompressionConfig(rank=args.compress_grads)
                if args.compress_grads else None)

    step_fn, _ = steps_mod.build_train_step(
        cfg, shape, opt_cfg=opt_cfg, comp_cfg=comp_cfg, mesh=mesh)
    rules = step_fn.rules
    lead = mesh.rank == 0

    pipe = TokenPipeline(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed),
        process_index=rules.index("batch"),
        process_count=rules.size("batch"))

    def init_state():
        # every rank draws the whole model, then keeps its shard
        model = tfm.init_model(cfg, seed=args.seed, device=dev, train=True)
        comp_state = (steps_mod.init_compression(
            dict(model.named_parameters()), cfg, comp_cfg,
            torch.Generator(device=dev).manual_seed(args.seed + 1))
            if comp_cfg else None)
        tfm.shard_model(model, rules)
        params = dict(model.named_parameters())
        return steps_mod.TrainState(
            params=model, opt=adamw.init(
                params, opt_cfg, tfm.param_shardings(model, rules)),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            comp=comp_state)

    state = init_state()
    shardings = steps_mod.train_state_shardings(state.params, rules, opt_cfg)
    start_step = 0
    if args.ckpt_dir and checkpointer.latest_step(args.ckpt_dir) is not None:
        state, meta = checkpointer.restore(args.ckpt_dir, state,
                                           shardings=shardings)
        pipe.restore(meta.get("data", {"step": 0}))
        start_step = int(meta.get("step", 0))
        if lead:
            print(f"[train] resumed from step {start_step}", flush=True)

    stop = {"flag": False, "reason": None}

    def _sigterm(signum, frame):
        stop["flag"] = True
        stop["reason"] = f"signal {signum}"

    handlers = {sig: signal.signal(sig, _sigterm)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def save(step):
        if not args.ckpt_dir:
            return
        checkpointer.save(args.ckpt_dir, step, state,
                          metadata={"step": step, "data": pipe.state(),
                                    "arch": cfg.name}, shardings=shardings)

    try:
        wd = Watchdog(on_stall=lambda: None)
        losses = []
        for step in range(start_step, args.steps):
            batch = inputs(cfg, pipe.batch_at(step)[:, : args.seq_len], dev)
            wd.start_step(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = wd.end_step()
            losses.append(loss)
            if wd.stalled:
                save(step)
                print("[train] stall detected -> emergency checkpoint",
                      flush=True)
                sys.exit(STALL_EXIT_CODE)
            if lead and (step % args.log_every == 0
                         or step == args.steps - 1):
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt*1000:.0f} ms, lr {float(metrics['lr']):.2e}, "
                      f"gnorm {float(metrics['grad_norm']):.2f})",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if args.preempt_at and step + 1 >= args.preempt_at:
                save(step + 1)
                if lead:
                    print(f"[train] simulated preemption at {step + 1}",
                          flush=True)
                return losses
            if stop["flag"]:
                save(step + 1)
                print(f"[train] preempted ({stop['reason']}); "
                      f"checkpointed at {step + 1}", flush=True)
                sys.exit(STALL_EXIT_CODE)
        save(args.steps)
        if lead:
            print(json.dumps({"final_loss": losses[-1],
                              "first_loss": losses[0],
                              "watchdog": wd.summary()}), flush=True)
        return losses
    finally:
        for sig, handler in handlers.items():
            if handler is not None:
                signal.signal(sig, handler)


def main(argv=None, device: DeviceLike = None):
    args = parse_args(argv)
    mesh, dev = world_mesh(args.model_parallel, args.global_batch, device)
    if not mesh.member:
        return []
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    return run(cfg, args, device=dev, mesh=mesh)


if __name__ == "__main__":
    main()
