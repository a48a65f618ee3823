"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and exits nonzero) on a failed check:

1. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process per
   source, all at once) into one library and load it;
2. kernels: hold each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes, and time the kernel, the plain
   version, and one PyTorch call that computes the same function;
3. main path: ``fit_transform`` of a seeded synthetic (70000, 784) matrix,
   the shape of MNIST-28x28 in the paper's Table IV, under
   ``PCAConfig(fused=True, backend="cuda", sweeps=50)``, checked against
   float64 numpy on the CPU; every kernel must have launched;
4. batched flush: 32 mixed-shape requests for each of eigh, svd and pca,
   bucket-padded and solved with ``build_solver_fn``, checked against
   float64 numpy;
5. ops: the four standalone registry ops of ``repro_torch.kernels.ops``
   (``dle_find_pivot``, ``cordic_rotate``, ``flash_attention``,
   ``mamba_scan``) called with no ``backend=`` on CUDA tensors at full
   width: the DLE scan and the CORDIC unit on the main path's 784 x 784
   Gram, attention at olmo-1b's 16 heads x 128 over 4096 tokens (prefill
   in bf16 and fp32, and one decode step in each), the selective scan at
   falcon-mamba-7b's d_inner 8192 and N 16 over 4096 steps.  Each op must
   resolve to ``cuda`` and launch its kernel -- for attention, each call
   the one of its three kernels that its shape and dtype call for (the
   tensor-core kernel for bf16 prefill, split-KV for decode, SIMT for fp32
   prefill); each result is held against the plain version, and kernel,
   plain version, bound and (for attention)
   ``scaled_dot_product_attention`` are timed.

Each path is checked against the kernels it runs: phases 3 and 4 against
the three PCA/SVD kernels, phase 5 against the six kernels of the four
standalone ops.
The last three lines are the kernels' JSON record (each kernel's launches
from the phase that drives it), the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with code 2 and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

SEED = 0
M, N, K = 70000, 784, 32          # MNIST-28x28 (paper Table IV), top-k
BATCH, BM, BN = 32, 2048, 256     # the batched kernel shapes
SWEEPS = 50
BACKEND = "cuda"
# batched flush: 32 requests per op, each dimension drawn from these ranges
FLUSH_REQUESTS = 32
FLUSH_EIGH_N = (96, 256)
FLUSH_SVD_N = (64, 256)
FLUSH_PCA_M, FLUSH_PCA_D = (256, 2048), (32, 256)
# ops phase: the standalone ops at the widths of configurations the repo has
OPS_TILE = 128                       # dle_find_pivot's tile
# two equal maxima: flat row-major order picks the first, tile order the
# second (tile (0, 1) comes before tile (0, 3))
TIE = ((0, 500), (100, 200))
CORDIC_RATE_K = 1 << 20              # pivots for the CORDIC unit's rate
# operations a pivot: two modes of 30 stages (a compare, two shifts, two
# sign multiplies, three adds) and ~20 float steps, counted at the fp32 rate
CORDIC_OPS = 2 * 30 * 8 + 20
FA_BH, FA_S, FA_D = 16, 4096, 128    # olmo-1b: 16 heads x 128; train_4k
MS_B, MS_L, MS_D, MS_N = 1, 4096, 2 * 4096, 16  # falcon-mamba-7b d_inner, N
# the kernels each path runs
PATH_KERNELS = ("covariance", "jacobi_sweep", "mm_engine_matmul")
OPS = ("dle_find_pivot", "cordic_rotate", "flash_attention", "mamba_scan")
OPS_KERNELS = ("dle_find_pivot", "cordic_rotate", "flash_attention_mma",
               "flash_attention_splitkv", "flash_attention_simt",
               "mamba_scan")
# the kernel each attention call of the ops phase must launch, and the
# row of the kernels' record that it fills
FA_ROUTE = {"prefill_bf16": "flash_attention_mma",
            "prefill_fp32": "flash_attention_simt",
            "decode_bf16": "flash_attention_splitkv",
            "decode_fp32": "flash_attention_splitkv"}
FA_ROW = {"prefill_bf16", "prefill_fp32", "decode_bf16"}
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain version on the card: both sum in fp32, in another order
# (cuBLAS vs the kernel's tiles), over up to 70000 terms; held to the fp32
# covariance budget, relative Frobenius
KERNEL_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def errors(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, that over max |want|, ||got - want|| / ||want||),
    in float64."""
    g = got.double()
    w = want.double()
    abs_err = float((g - w).abs().max())
    fro = float(torch.linalg.norm(g - w)) / max(float(torch.linalg.norm(w)),
                                               1e-30)
    return abs_err, abs_err / max(float(w.abs().max()), 1e-30), fro


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int):
    """Kernel time on the card per call, summed over the kernels that
    ``torch.profiler`` traced while ``reps`` calls ran; None if the trace
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_dataset(m: int, n: int, seed: int) -> np.ndarray:
    """Decaying low-rank factors plus noise (the recipe of the benchmarks'
    synthetic stand-ins for the paper's datasets)."""
    rng = np.random.default_rng(seed)
    k = min(n, 32)
    base = rng.standard_normal((m, k)) * np.geomspace(1, 0.05, k)
    mix = rng.standard_normal((k, n)) / np.sqrt(k)
    x = base @ mix + 0.05 * rng.standard_normal((m, n))
    return x.astype(np.float32)


def rel_frobenius(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(build_log: str, source: str) -> dict:
    """{head dim padding DP (the template argument): registers and spill
    bytes} of each kernel instance compiled from ``source``, read from the
    ``-Xptxas -v`` lines of the build log."""
    out, info, here = {}, None, False
    for line in build_log.splitlines():
        if line.startswith("== "):
            here = line.split()[1] == source
            continue
        if not here:
            continue
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            dp = re.search(r"ILi(\d+)EE", entry.group(1))
            info = out.setdefault(int(dp.group(1)) if dp else entry.group(1),
                                  {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and info is not None:
            info.update(spill_stores=int(spill.group(1)),
                        spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and info is not None:
            info["registers"] = int(used.group(1))
    return out


# -- phase 2: each kernel against its plain version ---------------------------

def kernel_phase(dev, rows: dict) -> None:
    from repro_torch.core.jacobi import round_robin_rounds
    from repro_torch.kernels import fused, mm_engine, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def record(name, got, want, t_kernel, t_plain, t_lib, bound, tol,
               main=False):
        abs_err, rel_err, fro = errors(got, want)
        b_ms, b_by = bound
        log(f"kernel {name}: rel_frobenius {fro:.3e} (tol {tol:g}) "
            f"max_rel_err {rel_err:.3e} max_abs_err {abs_err:.3e} "
            f"kernel_ms {t_kernel:.4f} "
            f"plain_ms {t_plain:.4f} library_ms "
            f"{'null' if t_lib is None else f'{t_lib:.4f}'} "
            f"bound_ms {b_ms:.4f} ({b_by})")
        check(fro <= tol, f"{name}: kernel disagrees with its plain "
              f"version: {fro:.3e} > {tol:g}")
        if main:
            rows[name.split("[")[0]].update(
                max_abs_err=abs_err, ms=t_kernel, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)

    # covariance at the main path's (70000, 784), fp32 and bf16, and a batch
    x = randn(M, N)
    for dtype, peak in ((torch.float32, PEAK_FP32),
                        (torch.bfloat16, PEAK_BF16)):
        xd = x.to(dtype)
        got = fused.fused_covariance(xd)
        want = ref.covariance_gram(xd)
        torch.cuda.synchronize()
        t_k = time_ms(lambda: fused.fused_covariance(xd), 5)
        t_p = time_ms(lambda: ref.covariance_gram(xd), 5)
        t_l = (time_ms(lambda: torch.matmul(xd.mT, xd), 5)
               if dtype == torch.float32 else None)
        nbytes = xd.numel() * xd.element_size() + N * N * 4
        record(f"covariance[{M}x{N} {str(dtype)[6:]}]", got, want, t_k, t_p,
               t_l, bound_ms(nbytes, M * N * (N + 1), peak), KERNEL_TOL,
               main=dtype == torch.float32)
    del x, xd
    xb = randn(BATCH, BM, BN)
    got = fused.fused_covariance(xb)
    want = ref.covariance_gram(xb)
    record(f"covariance[{BATCH}x{BM}x{BN}]", got, want,
           time_ms(lambda: fused.fused_covariance(xb), 5),
           time_ms(lambda: ref.covariance_gram(xb), 5),
           time_ms(lambda: torch.matmul(xb.mT, xb), 5),
           bound_ms(xb.numel() * 4 + BATCH * BN * BN * 4,
                    BATCH * BM * BN * (BN + 1), PEAK_FP32), KERNEL_TOL)

    # jacobi_sweep: one round at n = 784 for each angle mode
    g = randn(N, N)
    C = (g @ g.mT) / N
    V = torch.linalg.qr(randn(N, N))[0].contiguous()
    rounds = torch.as_tensor(round_robin_rounds(N), device=dev)
    pairs = rounds[N // 3]
    k = pairs.shape[0]
    sweep_bytes = 4 * N * N * 4
    sweep_flops = 9 * N * N + 20 * k
    for angle in ("rutishauser", "atan2", "cordic"):
        Co, Vo = fused.jacobi_sweep_step(C, V, pairs, angle=angle)
        Cr, Vr = ref.jacobi_sweep_step(C, V, pairs, angle=angle)
        torch.cuda.synchronize()
        same = int((Co == Cr).sum() + (Vo == Vr).sum())
        log(f"jacobi_sweep[{angle}]: {same} of {2 * N * N} entries bitwise "
            f"equal to the plain version")
        out = (torch.empty_like(C), torch.empty_like(V))
        t_k = time_ms(lambda: fused.jacobi_sweep_step(C, V, pairs,
                                                       angle=angle, out=out),
                      200)
        t_p = time_ms(lambda: ref.jacobi_sweep_step(C, V, pairs,
                                                     angle=angle), 50)
        record(f"jacobi_sweep[{N} {angle}]",
               torch.cat([Co, Vo]), torch.cat([Cr, Vr]), t_k, t_p, None,
               bound_ms(sweep_bytes, sweep_flops, PEAK_FP32), KERNEL_TOL,
               main=angle == "rutishauser")
        t_dev = device_ms(lambda: fused.jacobi_sweep_step(
            C, V, pairs, angle=angle, out=out), 50)
        log(f"jacobi_sweep[{N} {angle}]: device_ms per round "
            f"{'not measured' if t_dev is None else f'{t_dev:.4f}'} "
            f"(profiler: both launches), against {t_k:.4f} ms between "
            f"back-to-back calls")
        if angle == "rutishauser":
            rows["jacobi_sweep"]["device_ms"] = t_dev

    # a zero-padded batch with mixed n_active: one round against the plain
    # version, then a full sweep in which padding must stay exactly zero
    n_act = torch.as_tensor(np.random.default_rng(SEED).integers(
        BN // 2, BN + 1, BATCH), device=dev)
    idx = torch.arange(BN, device=dev)
    live = (idx[None, :] < n_act[:, None]).float()
    mask = live[:, :, None] * live[:, None, :]
    gb = randn(BATCH, BN, BN)
    Cb = ((gb @ gb.mT) / BN * mask).contiguous()
    Vb = torch.eye(BN, device=dev).expand(BATCH, BN, BN).contiguous()
    rounds_b = torch.as_tensor(round_robin_rounds(BN), device=dev)
    got = fused.jacobi_sweep_step(Cb, Vb, rounds_b[5])
    want = ref.jacobi_sweep_step(Cb, Vb, rounds_b[5])
    record(f"jacobi_sweep[{BATCH}x{BN}x{BN} padded]", torch.cat(got),
           torch.cat(want),
           time_ms(lambda: fused.jacobi_sweep_step(Cb, Vb, rounds_b[5]), 100),
           time_ms(lambda: ref.jacobi_sweep_step(Cb, Vb, rounds_b[5]), 20),
           None, bound_ms(4 * Cb.numel() * 4, 9 * Cb.numel(), PEAK_FP32),
           KERNEL_TOL)
    Cs, Vs = Cb, Vb
    for pairs_b in rounds_b:
        Cs, Vs = fused.jacobi_sweep_step(Cs, Vs, pairs_b)
    pad = 1.0 - mask
    eye = torch.eye(BN, device=dev).expand_as(Vs)
    pad_c = int((Cs * pad != 0).sum())
    pad_v = int(((Vs - eye) * pad != 0).sum())
    log(f"jacobi_sweep padded batch after one sweep: {pad_c} nonzero padded "
        f"C entries, {pad_v} padded V entries off the identity")
    check(pad_c == 0 and pad_v == 0, "padded coordinates did not stay exact")
    del C, V, Cb, Vb, Cs, Vs, gb, g

    # mm_engine: the projection (70000, 784) @ (784, 32) and the batched
    # U = A V of the SVD
    a = randn(M, N)
    b = randn(N, K)
    record(f"mm_engine_matmul[{M}x{N}@{N}x{K}]", mm_engine.mm_engine(a, b),
           ref.mm_engine(a, b),
           time_ms(lambda: mm_engine.mm_engine(a, b), 10),
           time_ms(lambda: ref.mm_engine(a, b), 10),
           time_ms(lambda: torch.matmul(a, b), 10),
           bound_ms((M * N + N * K + M * K) * 4, 2 * M * N * K, PEAK_FP32),
           KERNEL_TOL, main=True)
    A = randn(BATCH, BM, BN)
    Vq = torch.linalg.qr(randn(BATCH, BN, BN))[0].contiguous()
    record(f"mm_engine_matmul[{BATCH}x{BM}x{BN}@{BN}x{BN}]",
           mm_engine.mm_engine(A, Vq), ref.mm_engine(A, Vq),
           time_ms(lambda: mm_engine.mm_engine(A, Vq), 10),
           time_ms(lambda: ref.mm_engine(A, Vq), 10),
           time_ms(lambda: torch.matmul(A, Vq), 10),
           bound_ms((A.numel() + Vq.numel() + A.numel()) * 4,
                    2 * BATCH * BM * BN * BN, PEAK_FP32), KERNEL_TOL)


# -- phase 3: the main path -----------------------------------------------

def main_path(dev) -> dict:
    import repro_torch
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts

    X = synthetic_dataset(M, N, SEED)
    config = repro_torch.PCAConfig(fused=True, backend=BACKEND, sweeps=SWEEPS,
                                   pivot="parallel", rotation="rowcol",
                                   angle="rutishauser")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    Y, res = repro_torch.fit_transform(X, K, config, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"main path: fit_transform({M}x{N}, k={K}, sweeps={SWEEPS}) wall "
        f"{wall:.3f} s, launches {json.dumps(counts)}")

    X64 = X.astype(np.float64)
    std = X64.std(axis=0)
    std[std < 1e-8] = 1.0
    Xs = (X64 - X64.mean(axis=0)) / std
    w64, v64 = np.linalg.eigh(Xs.T @ Xs)
    w64, v64 = w64[::-1], v64[:, ::-1]
    w = res.eigenvalues.cpu().numpy()
    err = rel_frobenius(w, w64)
    off = float(res.off_norm)
    comps = res.components.cpu().numpy()
    cos = np.abs(np.sum(comps[:, :8] * v64[:, :8], axis=0))
    Yh = Y.cpu().numpy()
    log(f"main path: eigenvalue rel-Frobenius vs float64 numpy {err:.3e} "
        f"(budget {ERROR_BUDGETS['fp32']['eigh']:g}), off_norm {off:.3e}, "
        f"min |cos| of the top 8 components {cos.min():.6f}")
    check(err <= ERROR_BUDGETS["fp32"]["eigh"], "eigenvalues off budget")
    check(off <= 1e-5, f"off_norm {off} > 1e-5: the sweeps did not converge")
    check(cos.min() >= 1 - 1e-3, "top components off the float64 subspace")
    check(Yh.shape == (M, K) and np.isfinite(Yh).all(), "projection bad")
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the main "
              f"path")
    return {"wall_s": wall, "launches": counts}


# -- phase 4: a batched flush ----------------------------------------------

def batched_flush(dev) -> dict:
    from repro_torch.core.pca import PCAConfig
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batching import BucketPolicy, stack_requests
    from repro_torch.serving.solver import build_solver_fn

    rng = np.random.default_rng(SEED + 1)
    policy = BucketPolicy(T=64, mode="pow2")
    config = PCAConfig(fused=True, backend=BACKEND, sweeps=SWEEPS)
    budget = ERROR_BUDGETS["fp32"]
    requests = {"eigh": [], "svd": [], "pca": []}
    for _ in range(FLUSH_REQUESTS):
        n = int(rng.integers(FLUSH_EIGH_N[0], FLUSH_EIGH_N[1] + 1))
        g = rng.standard_normal((n, n))
        requests["eigh"].append(((g + g.T) / 2).astype(np.float32))
        n = int(rng.integers(FLUSH_SVD_N[0], FLUSH_SVD_N[1] + 1))
        m = int(rng.integers(n, 2 * n + 1))
        requests["svd"].append(rng.standard_normal((m, n)).astype(np.float32))
        d = int(rng.integers(FLUSH_PCA_D[0], FLUSH_PCA_D[1] + 1))
        m = int(rng.integers(FLUSH_PCA_M[0], FLUSH_PCA_M[1] + 1))
        seed = int(rng.integers(1 << 30))
        requests["pca"].append(synthetic_dataset(m, d, seed))

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    worst = {}
    for op, mats in requests.items():
        solve = build_solver_fn(op, config, device=dev)
        budget_op = "svd" if op == "svd" else "eigh"
        buckets = {}
        for i, a in enumerate(mats):
            buckets.setdefault(policy.bucket_shape(a.shape), []).append(i)
        worst[op] = 0.0
        for shape, ids in sorted(buckets.items()):
            batch, n_active = stack_requests([mats[i] for i in ids], shape)
            res = solve(batch, n_active[0], n_active[-1])
            for j, i in enumerate(ids):
                a = mats[i].astype(np.float64)
                if op == "eigh":
                    n = a.shape[0]
                    want = np.linalg.eigvalsh(a)[::-1]
                    got = res.eigenvalues[j, :n].cpu().numpy()
                    V = res.eigenvectors[j].cpu()
                    eye = torch.eye(shape[0])
                    check(bool((V[n:, :] == eye[n:, :]).all()
                               and (V[:, n:] == eye[:, n:]).all()
                               and (res.eigenvalues[j, n:] == 0).all()),
                          f"eigh bucket {shape}: padding did not stay exact")
                elif op == "svd":
                    n = a.shape[1]
                    want = np.linalg.svd(a, compute_uv=False)
                    got = res.S[j, :n].cpu().numpy()
                else:
                    n = a.shape[1]
                    std = a.std(axis=0)
                    std[std < 1e-8] = 1.0
                    xs = (a - a.mean(axis=0)) / std
                    want = np.linalg.eigvalsh(xs.T @ xs)[::-1]
                    got = res.eigenvalues[j, :n].cpu().numpy()
                err = rel_frobenius(got, want)
                worst[op] = max(worst[op], err)
                check(np.isfinite(got).all() and err <= budget[budget_op],
                      f"{op} request {i} in bucket {shape}: rel-Frobenius "
                      f"{err:.3e} over budget")
        log(f"batched flush {op}: {len(mats)} requests in {len(buckets)} "
            f"buckets, worst rel-Frobenius vs float64 numpy {worst[op]:.3e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"batched flush: wall {wall:.3f} s (checks included), launches "
        f"{json.dumps(counts)}")
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in the "
              f"batched flush")
    return {"wall_s": wall, "launches": counts, "worst": worst}


# -- phase 5: the standalone registry ops -----------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of the bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def ops_phase(dev, rows: dict) -> dict:
    from repro_torch.backends import registry
    from repro_torch.core.jacobi import round_robin_rounds
    from repro_torch.kernels import (cordic, dle, launch_counts, ops, ref,
                                     reset_launch_counts)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    # DLE: the main path's Gram (standardized synthetic MNIST-28x28), a
    # copy with one maximum tied across tiles, and a diagonal-only matrix
    X = torch.as_tensor(synthetic_dataset(M, N, SEED), device=dev)
    std = X.std(dim=0)
    Xs = (X - X.mean(dim=0)) / torch.where(std < 1e-8, 1.0, std)
    gram = ref.covariance_gram(Xs).contiguous()
    del X, Xs
    tie = gram.clone()
    big = 2 * float(gram.abs().max())
    for i, j in TIE:
        tie[i, j] = tie[j, i] = big
    diag = torch.diag(torch.arange(1.0, N + 1.0, device=dev))
    # CORDIC: one round's pivots at n = 784, and 2^20 pivots for a rate
    pairs = torch.as_tensor(round_robin_rounds(N)[N // 3], device=dev).long()
    p, q = pairs[:, 0], pairs[:, 1]
    round_piv = (gram[p, q].contiguous(), gram[p, p].contiguous(),
                 gram[q, q].contiguous())
    scale = 10.0 ** torch.randint(-3, 4, (3, CORDIC_RATE_K), generator=gen,
                                  device=dev)
    rate_piv = tuple(randn(3, CORDIC_RATE_K) * scale)
    # attention: prefill in bf16 and fp32, one decode step past the prefix
    qkv32 = tuple(randn(FA_BH, FA_S, FA_D) for _ in range(3))
    qkv16 = tuple(t.bfloat16() for t in qkv32)
    q_dec32 = randn(FA_BH, 1, FA_D)
    q_dec16 = q_dec32.bfloat16()
    # selective scan: the reference tests' distributions
    scan = (randn(MS_B, MS_L, MS_D), rand(MS_B, MS_L, MS_D) * 0.19 + 0.01,
            -(rand(MS_D, MS_N) * 1.5 + 0.5), randn(MS_B, MS_L, MS_N),
            randn(MS_B, MS_L, MS_N), randn(MS_D))

    torch.cuda.synchronize()
    reset_launch_counts()
    registry.reset_resolution_counts()
    t0 = time.perf_counter()
    piv = {name: ops.dle_find_pivot(c, tile=OPS_TILE)
           for name, c in (("gram", gram), ("tie", tie), ("diag", diag))}
    rot = {"round": ops.cordic_rotate(*round_piv),
           "rate": ops.cordic_rotate(*rate_piv)}
    att, att_moved = {}, {}
    for name, args, off in (("prefill_bf16", qkv16, 0),
                            ("prefill_fp32", qkv32, 0),
                            ("decode_bf16", (q_dec16, *qkv16[1:]), FA_S - 1),
                            ("decode_fp32", (q_dec32, *qkv32[1:]), FA_S - 1)):
        before = launch_counts()
        att[name] = ops.flash_attention(*args, causal=True, q_offset=off)
        att_moved[name] = {k: c - before[k]
                           for k, c in launch_counts().items()
                           if c != before[k]}
    y = ops.mamba_scan(*scan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    resolved = registry.resolution_counts()
    log(f"ops: wall {wall:.3f} s, launches {json.dumps(counts)}, "
        f"resolutions {sorted(f'{o}:{b}={n}' for (o, b), n in resolved.items())}")
    for name in OPS_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in the ops "
              f"phase")
    for op in OPS:
        check(resolved.get((op, "cuda"), 0) > 0
              and (op, "torch") not in resolved,
              f"op {op} did not resolve to cuda: {resolved}")
    # one launch of the kernel the shape calls for, and nothing else (the
    # plain version counts no launch)
    for name, moved in att_moved.items():
        log(f"flash_attention[{name}]: launched {json.dumps(moved)}")
        check(moved == {FA_ROUTE[name]: 1}, f"flash_attention[{name}] "
              f"launched {moved}, not one {FA_ROUTE[name]}")
    for name in PATH_KERNELS:
        check(counts[name] == 0, f"the ops phase launched {name}")
    outs = [t for pv in piv.values() for t in pv] + [
        t for r in rot.values() for t in r] + list(att.values()) + [y]
    check(all(t.is_cuda for t in outs), "an op returned a CPU tensor")

    def row(name, err, t_k, t_p, t_l, bound, fn):
        t_dev = device_ms(fn, 10)
        log(f"{name}: device_ms per call "
            f"{'not measured' if t_dev is None else f'{t_dev:.4f}'} "
            f"(profiler), against {t_k:.4f} ms between back-to-back calls")
        rows[name].update(max_abs_err=err, ms=t_k, plain_ms=t_p,
                          library_ms=t_l, bound_ms=bound[0],
                          bound_by=bound[1], device_ms=t_dev)

    # dle_find_pivot: identical (value, flat index) to the plain scan
    for name, c in (("gram", gram), ("tie", tie), ("diag", diag)):
        pv = piv[name]
        val, idx = ref.dle_scan(c, OPS_TILE)
        n = c.shape[0]
        flat = int(pv.p) * n + int(pv.q)
        log(f"dle_find_pivot[{name} {n}x{n} tile {OPS_TILE}]: kernel "
            f"({float(pv.apq.abs()):.9g}, {flat}), plain "
            f"({float(val):.9g}, {int(idx)})")
        check(flat == int(idx) and float(pv.apq.abs()) == float(val),
              f"dle_find_pivot[{name}]: kernel and plain version differ")
        check(float(pv.app) == float(c[pv.p, pv.p])
              and float(pv.aqq) == float(c[pv.q, pv.q]),
              f"dle_find_pivot[{name}]: diagonal gather wrong")
    check((int(piv["tie"].p), int(piv["tie"].q)) == TIE[1],
          "dle_find_pivot[tie]: not the earlier tile's maximum")
    check(int(piv["diag"].p) == 0 and int(piv["diag"].q) == 1,
          "dle_find_pivot[diag]: not the TPU kernel's (0, 1)")
    t_k = time_ms(lambda: dle.dle_scan(gram, OPS_TILE), 200)
    t_p = time_ms(lambda: ref.dle_scan(gram, OPS_TILE), 50)
    b = bound_ms(N * N * 4 + 8, 2 * N * N, PEAK_FP32)
    log(f"dle_find_pivot[{N}x{N}]: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
        f"library_ms null (no one PyTorch call masks the diagonal and "
        f"ranks ties in tile order) bound_ms {b[0]:.5f} ({b[1]})")
    row("dle_find_pivot", 0.0, t_k, t_p, None, b,
        lambda: dle.dle_scan(gram, OPS_TILE))

    # cordic_rotate: bitwise the plain Q2.29 arithmetic
    for name, args in (("round", round_piv), ("rate", rate_piv)):
        k = args[0].shape[0]
        want = ref.cordic_rotation_params_q29(*args)
        same = all(bool(torch.equal(g, w)) for g, w in zip(rot[name], want))
        oracle = ref.cordic_rotation_params(*args)
        dev_err = max(float((g - w).abs().max())
                      for g, w in zip(rot[name], oracle))
        reps = 200 if k < 4096 else 50
        t_k = time_ms(lambda: cordic.cordic_rotation_params(*args), reps)
        t_p = time_ms(lambda: ref.cordic_rotation_params_q29(*args), 5)
        b = bound_ms(6 * 4 * k, CORDIC_OPS * k, PEAK_FP32)
        log(f"cordic_rotate[k={k}]: bitwise {same}, max |kernel - float "
            f"oracle| {dev_err:.3e}, kernel_ms {t_k:.4f} plain_ms "
            f"{t_p:.4f} library_ms null (no PyTorch call does Q2.29 "
            f"CORDIC) bound_ms {b[0]:.6f} ({b[1]}), "
            f"{k / t_k / 1e6:.3f} G pivots/s")
        check(same, f"cordic_rotate[k={k}]: kernel not bitwise its plain "
              f"version")
        if name == "round":
            row("cordic_rotate", 0.0, t_k, t_p, None, b,
                lambda: cordic.cordic_rotation_params(*args))

    # flash_attention: fp32 within 2e-5 of the plain version; bf16 within
    # one bf16 ulp (plus that 2e-5) of the plain version's fp32 result --
    # two fp32 sums 1e-7 apart round to bf16 values many ulps apart near 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, out in att.items():
        decode = name.startswith("decode")
        bf16 = name.endswith("bf16")
        qkv = qkv16 if bf16 else qkv32
        qq = (q_dec16 if bf16 else q_dec32) if decode else qkv[0]
        off = FA_S - 1 if decode else 0
        want32 = ref.flash_attention(qq.float(), *(t.float() for t in qkv[1:]),
                                     causal=True, q_offset=off)
        want = want32.to(out.dtype)  # the plain version's result
        g = out.float()
        err = float((g - want.float()).abs().max())
        if bf16:
            slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) + 2e-5
            over = int(((g - want32).abs() > slack).sum())
            apart = int((out != want).sum())
            note = (f" ({apart} of {out.numel()} values differ from the "
                    f"plain version's; {over} beyond one bf16 ulp + 2e-5 "
                    f"of its fp32 result)")
        else:
            note = " (tol 2e-5)"
        del want32
        reps = 20 if decode else 3
        t_k = time_ms(lambda: fa.flash_attention(qq, *qkv[1:], causal=True,
                                                 q_offset=off), 5 * reps)
        t_p = time_ms(lambda: ref.flash_attention(qq, *qkv[1:], causal=True,
                                                  q_offset=off), reps)
        # (1, BH, S, D): SDPA picks its fused backends for 4-D input.  The
        # decode row sits at Skv - 1 and sees every key, so SDPA without a
        # mask computes the same function
        t_l = time_ms(lambda: sdpa(qq[None], *(t[None] for t in qkv[1:]),
                                   is_causal=not decode), 10 * reps)
        es = 2 if bf16 else 4
        sq = qq.shape[1]
        pairs_seen = FA_S * (FA_S + 1) // 2 if not decode else FA_S
        b = bound_ms(es * FA_BH * FA_D * (2 * sq + 2 * FA_S),
                     4 * FA_BH * FA_D * pairs_seen,
                     PEAK_BF16 if bf16 else PEAK_FP32)
        log(f"flash_attention[{name} {FA_BH}x{sq}x{FA_S}x{FA_D}]: max_abs_err "
            f"{err:.3e}{note} kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f}"
            + f" bound_ms {b[0]:.4f} ({b[1]}) [{FA_ROUTE[name]}]")
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention[{name}]: non-finite output")
        check(over == 0 if bf16 else err <= 2e-5,
              f"flash_attention[{name}]: kernel disagrees with its plain "
              f"version")
        if name in FA_ROW:
            row(FA_ROUTE[name], err, t_k, t_p, t_l, b,
                lambda: fa.flash_attention(qq, *qkv[1:], causal=True,
                                           q_offset=off))

    # mamba_scan: within rtol = atol = 1e-4 (the reference's tolerance)
    want = ref.mamba_scan(*scan)
    err = float((y - want).abs().max())
    close = bool(((y - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    t_k = time_ms(lambda: ms.mamba_scan(*scan), 5)
    t_p = time_ms(lambda: ref.mamba_scan(*scan), 1, warmup=0)
    bld = MS_B * MS_L * MS_D
    b = bound_ms(4 * (3 * bld + 2 * MS_B * MS_L * MS_N + MS_D * MS_N + MS_D),
                 bld * (7 * MS_N + 3), PEAK_FP32)
    log(f"mamba_scan[{MS_B}x{MS_L}x{MS_D} N={MS_N}]: max_abs_err {err:.3e} "
        f"(rtol = atol = 1e-4: {close}) kernel_ms {t_k:.4f} plain_ms "
        f"{t_p:.4f} library_ms null (PyTorch has no selective-scan call) "
        f"bound_ms {b[0]:.4f} ({b[1]}; {bld * MS_N:.3g} exp besides)")
    check(torch.isfinite(y).all().item() and close,
          "mamba_scan: kernel disagrees with its plain version")
    row("mamba_scan", err, t_k, t_p, None, b,
        lambda: ms.mamba_scan(*scan))
    return {"wall_s": wall, "launches": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 yardsticks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import KERNELS, build
    t0 = time.perf_counter()
    build.library()
    out = build.build_dir()
    log(f"build: {time.perf_counter() - t0:.1f} s, {out / build.LIB_NAME}")
    log_path = out / "build.log"
    build_log = log_path.read_text() if log_path.exists() else ""
    for line in build_log.splitlines():  # ptxas: registers, smem, spills
        if "Used" in line or "spill" in line:
            log("  " + line.strip())

    rows = {k.name: {"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces} for k in KERNELS}
    mma_regs = ptxas_report(build_log, "flash_attention_mma.cu")
    log(f"flash_attention_mma ptxas by head-dim padding: "
        f"{json.dumps(mma_regs)}")
    rows["flash_attention_mma"]["ptxas"] = mma_regs.get(FA_D)
    kernel_phase(dev, rows)
    log("kernels " + json.dumps({k.name: k.launches for k in KERNELS}))
    main_run = main_path(dev)
    per_call = {name: rows[name].get("device_ms") or rows[name]["ms"]
                for name in PATH_KERNELS}
    busy = sum(main_run["launches"][name] * per_call[name]
               for name in per_call) / 1e3
    wall = main_run["wall_s"]
    log(f"main path: kernels busy about {busy:.3f} s of {wall:.3f} s wall "
        f"(launches x per-call device time), idle share about "
        f"{1 - busy / wall:.3f}")
    flush = batched_flush(dev)
    ops_run = ops_phase(dev, rows)

    record = []
    for k in KERNELS:
        row = rows[k.name]
        if k.name in PATH_KERNELS:
            row["launches"] = main_run["launches"][k.name]
            row["launches_batched_flush"] = flush["launches"][k.name]
        else:
            row["launches"] = ops_run["launches"][k.name]
            row["path"] = "ops phase"
        record.append(row)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
