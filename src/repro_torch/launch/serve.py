"""Batched serving of the LM (port of ``repro.launch.serve``): prefill the
prompt batch, then step the decode loop against the KV cache, updated in
place.  Reports prefill and per-token decode latency and throughput as
the reference's JSON line.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --batch 4 --prompt-len 4096 --gen-len 32
On the CPU, from Python:
  from repro_torch.launch import serve
  serve.main(["--arch", "olmo-1b", "--reduced", "--batch", "4",
              "--prompt-len", "32", "--gen-len", "16"], device="cpu")

The prompt is drawn from ``np.random.default_rng(seed)`` as in the
reference, so both CLIs see the same prompt; the weights are drawn from a
``torch.Generator`` seeded with ``seed`` (the reference's come from
``jax.random``, so the two models differ).  Sampling is greedy at
temperature 0; above it, a ``torch.Generator`` draws the tokens.  Every
family is served (``--arch falcon-mamba-7b``, ``arctic-480b``,
``llama4-maverick-400b-a17b``, ``jamba-v0.1-52b``, ``whisper-small``,
``llava-next-34b``, each with ``--reduced`` on the CPU): as in the
reference CLI, whisper's stub audio frontend gives zero frames (B,
n_frames, d) and llava's stub vision tower zero patches (B, n_patches,
d), in the model's dtype, and llava's cache holds the patches too.
``--model-parallel`` lays the world's ranks on a (data, model) mesh as
the trainer does (``launch.train.world_mesh``: the torchrun environment
starts the process group; without it the mesh is the one device, (1, 1)
whatever the flag asks); each rank serves its rows of the batch on its
shards, the decode cache sharded on the sequence over "model", and rank
0 alone prints.  On 4 cards:
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.serve --arch olmo-1b \\
      --model-parallel 4 --batch 4 --prompt-len 4096 --gen-len 32
``generate`` is the CLI's body after the config: it serves any
``ModelConfig`` (a depth-cut one too), takes given frames or patches in
place of the zeros, and returns the tokens and the JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs import get_config, reduced_config
from ..models import transformer as tfm
from ..parallel.sharding import REPLICATED, rules_for_mesh


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 0.0) -> torch.Tensor:
    """(B,) int64 tokens: argmax at temperature 0, else a draw from
    softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, *, batch: int, prompt_len: int, gen_len: int,
             temperature: float = 0.0, seed: int = 0,
             device: DeviceLike = None,
             frames: Optional[torch.Tensor] = None,
             patches: Optional[torch.Tensor] = None, mesh=None
             ) -> Tuple[np.ndarray, dict]:
    """Serve ``cfg`` once: a seeded model and prompt, the prefill, then
    ``gen_len`` decode steps (the first one the reference's warm-up,
    outside the timed loop).  An encdec config takes ``frames`` (batch,
    n_frames, d) and a vlm config ``patches`` (batch, n_patches, d), zeros
    unless given.  On a ``mesh`` (its rules ``rules_for_mesh``) each rank
    serves its rows on its shards.  Returns the int32 (batch, gen_len)
    tokens and the reference CLI's JSON line as a dict."""
    tfm.check_supported(cfg)
    rules = rules_for_mesh(mesh) if mesh is not None else REPLICATED
    dev = mesh.device if mesh is not None else resolve_device(device)

    rng = np.random.default_rng(seed)
    model = tfm.init_model(cfg, seed=seed, device=dev,
                           rules=rules if mesh is not None else None)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    inputs = {"tokens": tokens}
    dt = cfg.torch_dtype()
    if cfg.family == "vlm":
        inputs["patches"] = (torch.zeros(batch, cfg.n_patches, cfg.d_model,
                                         dtype=dt, device=dev)
                             if patches is None else patches.to(dev, dt))
    if cfg.family == "encdec":
        inputs["frames"] = (torch.zeros(batch, cfg.n_frames, cfg.d_model,
                                        dtype=dt, device=dev)
                            if frames is None else frames.to(dev, dt))
    inputs = {k: rules.shard(v, "batch") for k, v in inputs.items()}
    cache_len = prompt_len + gen_len + (
        cfg.n_patches if cfg.family == "vlm" else 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = tfm.prefill(model, inputs, cfg, cache_len=cache_len,
                                rules=rules)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = sample(logits, gen, temperature)
    out = [tok]
    # the reference's warm-up decode (its compile), outside the timed loop
    logits, state = tfm.decode_step(model, state, tok, cfg, rules)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(1, gen_len):
        tok = sample(logits, gen, temperature)
        out.append(tok)
        logits, state = tfm.decode_step(model, state, tok, cfg, rules)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_tokens = rules.gather(torch.stack(out, dim=1), "batch", None).to(
        torch.int32).cpu().numpy()
    per_tok = t_decode / max(1, gen_len - 1)
    line = {
        "arch": cfg.name,
        "prefill_s": round(t_prefill, 4),
        "decode_per_token_s": round(per_tok, 5),
        "decode_tokens_per_s": round(batch / per_tok, 1),
        "generated_shape": list(gen_tokens.shape),
        "sample_tokens": gen_tokens[0, :8].tolist(),
    }
    return gen_tokens, line


def main(argv=None, device: DeviceLike = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .train import world_mesh
    mesh, dev = world_mesh(args.model_parallel, args.batch, device)
    if not mesh.member:
        return None
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    cfg = dataclasses.replace(cfg, tp=mesh.shape["model"])
    gen_tokens, line = generate(
        cfg, batch=args.batch, prompt_len=args.prompt_len,
        gen_len=args.gen_len, temperature=args.temperature, seed=args.seed,
        device=dev, mesh=mesh)
    if mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return gen_tokens


if __name__ == "__main__":
    main()
