#!/usr/bin/env python
"""Time the port's ``flash_attention`` kernels of several source trees in
turns, on one CUDA card:

    python scripts/flash_ab.py TREE [TREE ...]

Each TREE is a directory holding ``src/repro_torch`` (the repository root,
or another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each runs in a process of its own, which builds
that tree's kernels into the tree's own ``build/`` and times back-to-back
calls with CUDA events at olmo-1b's attention shape (BH 16, S 4096,
D 128): causal bf16 prefill, and decode of 1 and 16 query rows past the
prefix in bf16 and fp32.  Give the trees in the order to run them, for
example parent, change, change, parent: times of two versions compare only
within one run on one card.  Prints the card, then one JSON line a tree:
milliseconds a call and the outputs beyond the contracts (bf16: one bf16
ulp + 2e-5 of the fp32 plain version; fp32: 2e-5), which must be 0.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

BH, S, D = 16, 4096, 128


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def one_tree(tree: str) -> dict:
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv32 = [torch.randn(BH, S, D, generator=gen, device=dev)
             for _ in range(3)]
    qkv16 = [t.bfloat16() for t in qkv32]
    cases = {"prefill_bf16": (qkv16[0], qkv16[1:], 0, 50)}
    for sq in (1, 16):
        for name, qkv in (("bf16", qkv16), ("fp32", qkv32)):
            q = qkv[0][:, S - sq:].contiguous()
            cases[f"decode{sq}_{name}"] = (q, qkv[1:], S - sq, 500)
    out = {"tree": tree}
    for name, (q, kv, off, reps) in cases.items():
        got = fa.flash_attention(q, *kv, causal=True, q_offset=off).float()
        want = ref.flash_attention(q.float(), *(t.float() for t in kv),
                                   causal=True, q_offset=off)
        err = (got - want).abs()
        if q.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(got.abs(), want.abs())
                               .clamp_min(2.0 ** -126))
            slack = torch.ldexp(torch.ones_like(want), e - 8) + 2e-5
        else:
            slack = torch.full_like(want, 2e-5)
        out[name] = {
            "ms": time_ms(lambda: fa.flash_attention(
                q, *kv, causal=True, q_offset=off), reps),
            "beyond_contract": int((err > slack).sum())}
    return out


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one_tree(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rc = 0
    for tree in argv:
        run = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        print(run.stdout.strip() or run.stderr[-2000:], flush=True)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
