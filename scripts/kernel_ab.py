#!/usr/bin/env python
"""Time the port's kernels of several source trees in turns, on one CUDA
card:

    python scripts/kernel_ab.py CASES TREE [TREE ...]

Each TREE is a directory holding ``src/repro_torch`` (the repository root,
or another version unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The trees' kernels are built first, all at once,
each into the tree's own ``build/``; then each tree runs in a process of
its own and times back-to-back calls with CUDA events.  Give the trees in
the order to run them, for example parent, change, change, parent: times
of two versions compare only within one run on one card.  Prints the card,
then one JSON line a tree.  CASES is one of:

``attention``
    ``flash_attention`` at olmo-1b's attention shape (BH 16, S 4096,
    D 128): causal prefill in bf16 and fp32, and decode of 1 and 16 query
    rows past the prefix in bf16 and fp32; and a causal bf16 prefill at
    BH 16, S 1024, D 20 (``chip_smoke.py``'s small prefill).  Milliseconds a call, the
    kernel it launched, and the outputs beyond the contracts (bf16: one
    bf16 ulp + 2e-5 of the fp32 plain version; fp32: 2e-5), which must be
    0; for prefill also ``scaled_dot_product_attention``'s milliseconds on
    the same inputs.

``gemm``
    The GEMM-tile kernels at the main path's shapes: the projection
    (70000, 784) @ (784, 32), the strided projection (70000, 784)[:, ::2]
    @ (392, 32) (every other feature), the batched U = A V 32 x
    (2048 x 256) @ (256 x 256), the Gram of 70000 x 784 in fp32 and bf16
    and the Gram batch 32 x 2048 x 256, each with the kernel it launched
    and one PyTorch call computing the same function on the same inputs
    beside it (``torch.matmul`` with TF32 off;
    for the bf16 Gram ``torch.mm(..., out_dtype=torch.float32)``), and
    each result's relative Frobenius distance from its plain version, which
    must stay within 1e-5.  Then the 70000 x 784 Gram, fp32 and bf16, at
    each m-axis split rule of ``GRAM_BLOCKS_PER_SM`` (the wrapper's
    ``COV_BLOCKS_PER_SM``), in the order given there.  Then the main path,
    ``fit_transform`` of a seeded 70000 x 784 matrix (``chip_smoke.py``'s
    data and configuration, 50 sweeps), on the host clock after a
    one-sweep warm-up.

``scan``
    ``mamba_scan`` at falcon-mamba-7b's d_inner 8192, N 16, over 4096
    steps (batch 1) in fp32 and bf16, and in fp32 at d_inner 2048 (a
    quarter of the card's channels).  Milliseconds a call, the kernel it
    launched, and the outputs beyond the contracts (fp32: rtol = atol =
    1e-4 of the plain version; bf16: one bf16 ulp + 1e-4 of the plain
    version's fp32 result on the same bf16 inputs), which must be 0.

``jacobi``
    One Jacobi sweep through ``core.jacobi._sweep_scan`` with the fused
    ``cuda`` backend (the Rutishauser angle, the parallel pivot's n - 1
    rounds), whatever number of calls the tree makes for it: at the main
    path's n = 784, and on the batched flush's 32 x 256 x 256 and
    32 x 128 x 128 buckets.  Milliseconds a sweep, and whether the result
    is bitwise the plain version's round-by-round loop.  Then
    ``fit_transform`` as for ``gemm``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

BH, S, D = 16, 4096, 128
S_D20, D20 = 1024, 20
M, N, K = 70000, 784, 32
BATCH, BM, BN = 32, 2048, 256
GRAM_BLOCKS_PER_SM = (2, 4, 8, 8, 4, 2)
SCAN_L, SCAN_D, SCAN_N = 4096, 8192, 16  # falcon-mamba-7b, one sequence


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


def rel_frobenius(got, want) -> float:
    import torch
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w))


def attention(tree: str) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 SDPA
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv32 = [torch.randn(BH, S, D, generator=gen, device=dev)
             for _ in range(3)]
    qkv16 = [t.bfloat16() for t in qkv32]
    qkv_d20 = [torch.randn(BH, S_D20, D20, generator=gen, device=dev)
               .bfloat16() for _ in range(3)]
    cases = {"prefill_bf16": (qkv16[0], qkv16[1:], 0, 50),
             "prefill_fp32": (qkv32[0], qkv32[1:], 0, 20),
             "prefill_d20_bf16": (qkv_d20[0], qkv_d20[1:], 0, 200)}
    for sq in (1, 16):
        for name, qkv in (("bf16", qkv16), ("fp32", qkv32)):
            q = qkv[0][:, S - sq:].contiguous()
            cases[f"decode{sq}_{name}"] = (q, qkv[1:], S - sq, 500)
    out = {"tree": tree}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (q, kv, off, reps) in cases.items():
        before = launch_counts()
        got = fa.flash_attention(q, *kv, causal=True, q_offset=off).float()
        launched = [k for k, c in launch_counts().items() if c != before[k]]
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
            "kernel": launched, "max_abs_err": float(err.max()),
            "beyond_contract": int((err > slack).sum())}
        if name.startswith("prefill"):
            out[name]["sdpa_ms"] = time_ms(lambda: sdpa(
                q[None], *(t[None] for t in kv), is_causal=True), reps)
    return out


def gemm(tree: str) -> dict:
    import torch
    from repro_torch.kernels import fused, launch_counts, mm_engine, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def gram(t):
        return torch.matmul(t.mT, t)

    def gram_bf16(t):
        return torch.mm(t.mT, t, out_dtype=torch.float32)
    x = randn(M, N)
    xh = x.bfloat16()
    xb = randn(BATCH, BM, BN)
    cases = {
        "projection": (mm_engine.mm_engine, ref.mm_engine, torch.matmul,
                       (x, randn(N, K)), 20),
        "projection_strided": (mm_engine.mm_engine, ref.mm_engine,
                               torch.matmul, (x[:, ::2], randn(N // 2, K)),
                               20),
        "u_av": (mm_engine.mm_engine, ref.mm_engine, torch.matmul,
                 (xb, randn(BATCH, BN, BN)), 20),
        "gram_fp32": (fused.fused_covariance, ref.covariance_gram, gram,
                      (x,), 10),
        "gram_bf16": (fused.fused_covariance, ref.covariance_gram,
                      gram_bf16, (xh,), 10),
        "gram_batch": (fused.fused_covariance, ref.covariance_gram, gram,
                       (xb,), 20),
    }
    out = {"tree": tree}
    for name, (kernel, plain, library, args, reps) in cases.items():
        before = launch_counts()
        got = kernel(*args)
        out[name] = {
            "kernel": [k for k, c in launch_counts().items()
                       if c != before[k]],
            "rel_frobenius": rel_frobenius(got, plain(*args)),
            "ms": time_ms(lambda: kernel(*args), reps),
            "library_ms": time_ms(lambda: library(*args), reps)}
    rule = fused.COV_BLOCKS_PER_SM
    splits = []
    for per_sm in GRAM_BLOCKS_PER_SM:
        fused.COV_BLOCKS_PER_SM = per_sm
        slices = fused.cov_slices(M, N, 1, 1024, fused._sm_count(0))[0]
        splits.append({
            "blocks_per_sm": per_sm, "slices": slices,
            "fp32_ms": time_ms(lambda: fused.fused_covariance(x), 10),
            "bf16_ms": time_ms(lambda: fused.fused_covariance(xh), 10)})
    fused.COV_BLOCKS_PER_SM = rule
    out["gram_split_rules"] = splits
    del x, xh, xb, cases
    out["fit_wall_s"] = fit_wall_s(dev)
    return out


def fit_wall_s(dev) -> float:
    """The tree's ``repro_torch`` is imported already; ``chip_smoke`` (this
    checkout's) gives the data."""
    import torch
    import repro_torch
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import SEED, SWEEPS, synthetic_dataset
    X = synthetic_dataset(M, N, SEED)
    for sweeps in (1, SWEEPS):  # a warm-up, then the timed fit
        config = repro_torch.PCAConfig(fused=True, backend="cuda",
                                       sweeps=sweeps, pivot="parallel",
                                       rotation="rowcol", angle="rutishauser")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repro_torch.fit_transform(X, K, config, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall


def jacobi(tree: str) -> dict:
    import torch
    from repro_torch.core import jacobi as jac
    from repro_torch.core.cordic import ANGLE_MODES
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree}
    for name, batch, n, reps in (("sweep_784", None, N, 20),
                                 ("sweep_32x256", 32, BN, 20),
                                 ("sweep_32x128", 32, 128, 50)):
        shape = (n, n) if batch is None else (batch, n, n)
        g = torch.randn(*shape, generator=gen, device=dev)
        C = (g @ g.mT / n).contiguous()
        V = torch.eye(n, device=dev).expand(shape).contiguous()
        rounds = torch.as_tensor(jac.round_robin_rounds(n), device=dev)

        def sweep():
            return jac._sweep_scan(C, V, rounds, ANGLE_MODES["rutishauser"],
                                   "rowcol", None, fused=True,
                                   fused_backend="cuda")
        got = sweep()
        want = (C, V)
        for pairs in rounds:
            want = ref.jacobi_sweep_step(*want, pairs)
        out[name] = {
            "bitwise": all(bool(torch.equal(a, b))
                           for a, b in zip(got, want)),
            "ms": time_ms(sweep, reps)}
    out["fit_wall_s"] = fit_wall_s(dev)
    return out


def scan(tree: str) -> dict:
    import torch
    from repro_torch.kernels import launch_counts, ref
    from repro_torch.kernels import mamba_scan as ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(d, dtype):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        u, b, c = randn(1, SCAN_L, d), randn(1, SCAN_L, SCAN_N), \
            randn(1, SCAN_L, SCAN_N)
        dt = torch.rand(1, SCAN_L, d, generator=gen, device=dev) * 0.19 \
            + 0.01
        a = -(torch.rand(d, SCAN_N, generator=gen, device=dev) * 1.5 + 0.5)
        return (u.to(dtype), dt.to(dtype), a, b.to(dtype), c.to(dtype),
                randn(d))

    cases = {"fp32": (SCAN_D, torch.float32, 20),
             "bf16": (SCAN_D, torch.bfloat16, 20),
             "fp32_d2048": (SCAN_D // 4, torch.float32, 50)}
    out = {"tree": tree}
    for name, (d, dtype, reps) in cases.items():
        args = inputs(d, dtype)
        before = launch_counts()
        got = ms.mamba_scan(*args).float()
        launched = [k for k, c in launch_counts().items() if c != before[k]]
        want = ref.mamba_scan(*(t.float() for t in args))
        err = (got - want).abs()
        if dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(got.abs(), want.abs())
                               .clamp_min(2.0 ** -126))
            slack = torch.ldexp(torch.ones_like(want), e - 8) + 1e-4
        else:
            slack = 1e-4 + 1e-4 * want.abs()
        out[name] = {"ms": time_ms(lambda: ms.mamba_scan(*args), reps),
                     "kernel": launched, "max_abs_err": float(err.max()),
                     "beyond_contract": int((err > slack).sum())}
        del args, got, want, err, slack
    return out


CASES = {"attention": attention, "gemm": gemm, "jacobi": jacobi,
         "scan": scan}


def use_tree(tree: str) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--build":
        use_tree(argv[1])
        from repro_torch.kernels import build
        build.build()
        return 0
    if len(argv) == 3 and argv[0] == "--one":
        use_tree(argv[2])
        print(json.dumps(CASES[argv[1]](argv[2])), flush=True)
        return 0
    if len(argv) < 2 or argv[0] not in CASES:
        print(__doc__, file=sys.stderr)
        return 2
    cases, trees = argv[0], argv[1:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    me = str(pathlib.Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", tree])
              for tree in dict.fromkeys(trees)]
    if any(p.wait() for p in builds):
        return 1
    rc = 0
    for tree in trees:
        rc = rc or subprocess.run([sys.executable, me, "--one", cases,
                                   tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
