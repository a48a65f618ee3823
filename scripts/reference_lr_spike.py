#!/usr/bin/env python
"""The reference's (JAX) training losses at lr 3e-3 over a short schedule,
with and without PCA gradient compression, on an olmo-1b of a width the
CPU can hold:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_lr_spike.py \\
        [--d-model 1024] [--d-ff 4096] [--vocab 16384] [--layers 2] \\
        [--steps 4] [--lr 3e-3]

The trainer CLI's schedule for ``--steps`` (warmup max(2, steps // 10),
cosine decay over the steps), the synthetic pipeline at B 4 x 128, the
reference's initial weights (seed 0), rank-4 compression at the default
size threshold.  The reference draws each leaf's initial subspace from
``hash(str(path))``, which Python salts per process: the compressed legs
differ from run to run unless ``PYTHONHASHSEED`` is set.  Prints one JSON
line a leg: compressed with int8 moments, uncompressed with int8
moments, compressed with fp32 moments, each with its losses and
ln(vocab), the loss of a uniform guess.  The
port runs the same steps (``tests/test_torch_grad.py::
test_compressed_steps_match_reference`` holds it to these functions at
reduced width), so this says what the reference's own algorithm does at
a wider width: whether a loss rises above ln(vocab) after the warmup,
and whether compression is what makes it.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.data import DataConfig, TokenPipeline
from repro.models import transformer as tfm
from repro.optim import adamw
from repro.optim import compression as comp
from repro.parallel.sharding import REPLICATED

BATCH, SEQ = 4, 128


def losses(cfg, steps: int, lr: float, rank: int, moments: str) -> list:
    params = tfm.param_values(tfm.init_model(jax.random.PRNGKey(0), cfg))
    ocfg = adamw.AdamWConfig(lr=lr, moment_dtype=moments,
                             warmup_steps=max(2, steps // 10),
                             decay_steps=steps)
    ccfg = comp.CompressionConfig(rank=rank) if rank else None
    state = (params, adamw.init(params, ocfg),
             comp.init_state(params, ccfg, jax.random.PRNGKey(1))
             if rank else None)

    @jax.jit
    def step(state, tokens):
        params, opt, cst = state
        (loss, _), grads = jax.value_and_grad(
            lambda p: tfm.loss_fn(p, {"tokens": tokens}, cfg, REPLICATED),
            has_aux=True)(params)
        if rank:
            grads, cst, _ = comp.compress_tree(grads, cst, ccfg)
        params, opt, _ = adamw.update(grads, opt, params, ocfg)
        return (params, opt, cst), loss

    pipe = TokenPipeline(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    out = []
    for i in range(steps):
        state, loss = step(state, jnp.asarray(pipe.batch_at(i)[:, :SEQ]))
        out.append(float(loss))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--d-ff", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=16384)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args(argv)
    cfg = configs.reduced_config(
        "olmo-1b", d_model=args.d_model, d_ff=args.d_ff,
        vocab_size=args.vocab, n_layers=args.layers,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 64,
        head_dim=64)
    for rank, moments in ((4, "int8"), (0, "int8"), (4, "float32")):
        print(json.dumps({
            "d_model": args.d_model, "d_ff": args.d_ff, "vocab": args.vocab,
            "layers": args.layers, "lr": args.lr, "rank": rank,
            "moments": moments, "ln_vocab": float(np.log(args.vocab)),
            "losses": losses(cfg, args.steps, args.lr, rank, moments)}),
            flush=True)


if __name__ == "__main__":
    main()
