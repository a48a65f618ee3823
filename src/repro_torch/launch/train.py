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
``jax.random``); ``--model-parallel`` > 1 raises until the LM half of the
multi-device work (ROADMAP queue 1, item 4b).
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
from ..runtime import STALL_EXIT_CODE, Watchdog
from . import steps as steps_mod


def main(argv=None, device: DeviceLike = None):
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
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the LM half of the multi-device "
            "work (ROADMAP queue 1, item 4b); the port trains on one "
            "device")

    dev = resolve_device(device)
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    cfg = dataclasses.replace(cfg, tp=1)
    shape = ShapeCell("cli", args.seq_len, args.global_batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, moment_dtype=args.moments,
                                warmup_steps=max(2, args.steps // 10),
                                decay_steps=args.steps)
    comp_cfg = (comp.CompressionConfig(rank=args.compress_grads)
                if args.compress_grads else None)

    step_fn, _ = steps_mod.build_train_step(
        cfg, shape, opt_cfg=opt_cfg, comp_cfg=comp_cfg, device=dev)

    pipe = TokenPipeline(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed))

    def init_state():
        model = tfm.init_model(cfg, seed=args.seed, device=dev, train=True)
        params = dict(model.named_parameters())
        comp_state = (steps_mod.init_compression(
            params, cfg, comp_cfg,
            torch.Generator(device=dev).manual_seed(args.seed + 1))
            if comp_cfg else None)
        return steps_mod.TrainState(
            params=model, opt=adamw.init(params, opt_cfg),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            comp=comp_state)

    state = init_state()
    start_step = 0
    if args.ckpt_dir and checkpointer.latest_step(args.ckpt_dir) is not None:
        state, meta = checkpointer.restore(args.ckpt_dir, state)
        pipe.restore(meta.get("data", {"step": 0}))
        start_step = int(meta.get("step", 0))
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
                                    "arch": cfg.name})

    def inputs(step):
        tokens = pipe.batch_at(step)[:, : args.seq_len]
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64,
                                           device=dev)}
        extra = {"vlm": ("patches", cfg.n_patches),
                 "encdec": ("frames", cfg.n_frames)}.get(cfg.family)
        if extra:
            batch[extra[0]] = torch.zeros(
                tokens.shape[0], extra[1], cfg.d_model,
                dtype=cfg.torch_dtype(), device=dev)
        return batch

    try:
        wd = Watchdog(on_stall=lambda: None)
        losses = []
        for step in range(start_step, args.steps):
            batch = inputs(step)
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
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt*1000:.0f} ms, lr {float(metrics['lr']):.2e}, "
                      f"gnorm {float(metrics['grad_norm']):.2f})",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if args.preempt_at and step + 1 >= args.preempt_at:
                save(step + 1)
                print(f"[train] simulated preemption at {step + 1}",
                      flush=True)
                return losses
            if stop["flag"]:
                save(step + 1)
                print(f"[train] preempted ({stop['reason']}); "
                      f"checkpointed at {step + 1}", flush=True)
                sys.exit(STALL_EXIT_CODE)
        save(args.steps)
        print(json.dumps({"final_loss": losses[-1],
                          "first_loss": losses[0],
                          "watchdog": wd.summary()}), flush=True)
        return losses
    finally:
        for sig, handler in handlers.items():
            if handler is not None:
                signal.signal(sig, handler)


if __name__ == "__main__":
    main()
