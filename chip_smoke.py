"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and exits nonzero) on a failed check:

1. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process per
   source, all at once) into one library and load it;
2. kernels: hold each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes, and time the kernel, the plain
   version, and one PyTorch call that computes the same function; the
   MM-Engine also with a transposed a and a strided a (every other
   feature: one element a copy), each checked to launch the tensor-core
   kernel, the strided one with its sector floor beside its bound; one
   whole Jacobi sweep in one call on each of the
   sweep's two kernels (the grid kernel at n = 784 in each angle mode and
   on a padded 32 x 256 x 256 batch, the shared-memory kernel on a padded
   32 x 128 x 128 batch), bitwise the plain round-by-round loop, with
   ``torch.linalg.eigh`` of the same matrices as the solve's library time;
3. main path: ``fit_transform`` of a seeded synthetic (70000, 784) matrix,
   the shape of MNIST-28x28 in the paper's Table IV, under
   ``PCAConfig(fused=True, backend="cuda", sweeps=50)``, checked against
   float64 numpy on the CPU; every kernel must have launched, the sweep
   kernel exactly once a sweep;
4. batched flush: 32 mixed-shape requests for each of eigh, svd and pca,
   bucket-padded and solved with ``build_solver_fn``, checked against
   float64 numpy; both sweep kernels must have launched, and the
   synchronised solve calls are timed apart from the checks;
5. ops: the four standalone registry ops of ``repro_torch.kernels.ops``
   (``dle_find_pivot``, ``cordic_rotate``, ``flash_attention``,
   ``mamba_scan``) called with no ``backend=`` on CUDA tensors at full
   width: the DLE scan and the CORDIC unit on the main path's 784 x 784
   Gram (the DLE also on copies with a cross-tile tie, a diagonal only,
   NaN tiles and +-inf, each held bit for bit to the plain scan, its
   pivot to C's entries; ``dle_scan`` and the op ``dle_find_pivot`` timed,
   and the host's steps of the two small calls; the CORDIC unit's latency
   floor read from its SASS), attention at olmo-1b's 16 heads x 128 over 4096 tokens (prefill
   in bf16 and fp32, and one decode step in each) and a small bf16
   prefill of head dim 20, the selective scan at falcon-mamba-7b's
   d_inner 8192 and N 16 over 4096 steps (in fp32 and in bf16); and
   ``mm_engine_matmul`` on a
   strided view (every other feature of the main path's data, projected
   onto 32 directions).  Each op must resolve to ``cuda`` and launch its
   kernel -- for the strided projection ``mm_engine_matmul``, for
   attention each call the one of its three kernels that its shape and
   dtype call for (the bf16 tensor-core kernel for bf16 prefill at any
   head dim, the 3xTF32 kernel for fp32 prefill, split-KV for decode);
   each result is held against the plain version, and kernel, plain
   version, bound and (for attention) ``scaled_dot_product_attention``
   are timed;
6. serve: phase 4's 96 requests through the serving engine,
   ``PCAServer(PCAConfig(fused=True, backend="cuda", sweeps=50, T=64,
   S=32), policy=BucketPolicy(T=64, mode="pow2"))`` on its default
   executor (the card), once with ``max_inflight=1`` and once with
   ``max_inflight=3``, each server taking the burst twice (a cold pass
   that builds its solvers, a warm one that must hit the cache on every
   flush) and ``drain()``-ing each pass; every ``executor.submit`` runs
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
   dispatch stage fails the phase); every served result within the fp32
   budgets of float64 numpy, the four passes bitwise equal field by field,
   and the four kernels of the path launched.  Each run's warm pass prints
   requests/s, p50/p99 latency and the mean overlap and wait per flush
   (``stats``); a third pass of the pipelined server runs under
   ``torch.profiler`` for the device's idle share;
7. control: the control plane and the CLI through the entry points a
   user calls, with ``ServerSpec(SchedulingSpec(mode="pow2", T=64,
   max_batch=32, max_inflight=3), ExecutionSpec(backend="cuda",
   fused=True, sweeps=50))`` written by ``ServerSpec.save``:
   ``serve_pca.main(["--spec", ...])`` closed loop for eigh and pca (96
   requests over dims 96..256; the saved span trace validated with every
   request under a flush, the Prometheus text holding the latency
   histogram and ``kernel_backend_resolutions_total`` with
   ``backend="cuda"``, the ``--jax-profile`` directory's
   ``torch.profiler`` trace naming both sweep kernels, the path's kernels
   launched; requests/s, p50/p99 and the calibrated ``CostModel``
   printed), then open loop with the controller (256 Poisson arrivals
   from two tenants at 1.5x the closed loop's eigh requests/s, WFQ and
   shedding; every request accounted for, goodput, shed fraction, each
   tenant's p99, the controller's ticks and swaps) and the same arrivals
   without it, then the spec's
   server under a ``VirtualClock`` on the card twice on a seeded
   eigh/svd two-tenant stream (equal digests and outcome maps, every
   served result within the fp32 budget of float64 numpy, all four
   kernels of the path launched) and an ``apply_plan`` swap mid-stream
   bitwise a cold server on the plan.

Each path is checked against the kernels it runs: phase 3 against the
three PCA/SVD kernels, phases 4, 6 and 7 against those and the
shared-memory sweep, phase 5 against the seven kernels of its five ops.
The last three lines are the kernels' JSON record (each kernel's launches
from the phase that drives it, ``launches_serve`` from phase 6 and
``launches_control`` from phase 7), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

SEED = 0
M, N, K = 70000, 784, 32          # MNIST-28x28 (paper Table IV), top-k
BATCH, BM, BN = 32, 2048, 256     # the batched kernel shapes
BN_SMEM = 128                     # the flush's widest shared-memory bucket
SWEEPS = 50
BACKEND = "cuda"
# batched flush: 32 requests per op, each dimension drawn from these ranges
FLUSH_REQUESTS = 32
FLUSH_T = 64                      # BucketPolicy(T=64, mode="pow2")
FLUSH_EIGH_N = (96, 256)
FLUSH_SVD_N = (64, 256)
FLUSH_PCA_M, FLUSH_PCA_D = (256, 2048), (32, 256)
# ops phase: the standalone ops at the widths of configurations the repo has
OPS_TILE = 128                       # dle_find_pivot's tile
# two equal maxima: flat row-major order picks the first, tile order the
# second (tile (0, 1) comes before tile (0, 3))
TIE = ((0, 500), (100, 200))
# a copy of the Gram with NaNs in the tile of its largest entry and its
# mirror and at these places (those tiles are skipped whole; (3, 3) is on
# the diagonal, masked), and one with +inf and -inf at INF_AT and its
# mirror as well
NAN_AT = ((3, 3), (700, 10), (300, 301))
INF_AT = (400, 600)
CORDIC_RATE_K = 1 << 20              # pivots for the CORDIC unit's rate
# operations a pivot: two modes of 30 stages (a compare, two shifts, two
# sign multiplies, three adds) and ~20 float steps, counted at the fp32 rate
CORDIC_OPS = 2 * 30 * 8 + 20
FA_BH, FA_S, FA_D = 16, 4096, 128    # olmo-1b: 16 heads x 128; train_4k
FA_S_D20, FA_D20 = 1024, 20          # a small bf16 prefill: 8-byte copies
MS_B, MS_L, MS_D, MS_N = 1, 4096, 2 * 4096, 16  # falcon-mamba-7b d_inner, N
# the kernels each path runs
PATH_KERNELS = ("covariance", "jacobi_sweep", "mm_engine_matmul")
# the batched flush runs those and the shared-memory sweep (buckets of 64
# and 128), and so does the serve phase
FLUSH_KERNELS = PATH_KERNELS + ("jacobi_sweep_smem",)
SERVE_DEPTHS = (1, 3)             # max_inflight of the serve phase's runs
# control phase: the CLI's closed-loop dims (phase 4's eigh range, pow2
# buckets 128 and 256) and requests, the open loop's arrivals, the SLOs
# of the closed and the open specs, the virtual-clock stream (eigh whale,
# svd mouse: rates and counts) and the requests of the hot swap's check
CONTROL_DIMS = (96, 128, 160, 192, 224, 256)
CONTROL_REQUESTS = 96
OPEN_REQUESTS = 256
CONTROL_SLO_MS = (2000.0, 250.0)
VIRTUAL_RATES = (200.0, 50.0)
VIRTUAL_REQUESTS = (48, 16)
CONTROL_SWAP_N = 48
OPS = ("dle_find_pivot", "cordic_rotate", "flash_attention", "mamba_scan",
       "mm_engine_matmul")
OPS_KERNELS = ("dle_find_pivot", "cordic_rotate", "flash_attention_mma",
               "flash_attention_tf32x3", "flash_attention_splitkv",
               "mamba_scan", "mm_engine_matmul")
# the kernel each attention call of the ops phase must launch, and the
# row of the kernels' record that it fills (under the prefix given: the
# D 20 prefill adds its numbers to flash_attention_mma's row)
FA_ROUTE = {"prefill_bf16": "flash_attention_mma",
            "prefill_fp32": "flash_attention_tf32x3",
            "prefill_d20_bf16": "flash_attention_mma",
            "decode_bf16": "flash_attention_splitkv",
            "decode_fp32": "flash_attention_splitkv"}
FA_ROW = {"prefill_bf16": "", "prefill_fp32": "", "prefill_d20_bf16": "d20_",
          "decode_bf16": ""}
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3; the SFU's exponentials a clock an SM
# (CUDA C++ Programming Guide, arithmetic instructions, compute 9.0)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# the tensor-core GEMM tile does three tf32 products for each fp32 one
TF32_PRODUCTS = 3
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK = 16
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


def sector_bytes(t: torch.Tensor) -> int:
    """Bytes of the 32-byte DRAM sectors that hold the elements of the 2-D
    view ``t``."""
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    cols = torch.arange(t.shape[1], device=t.device)[None, :]
    byte = (t.storage_offset() + rows * t.stride(0) + cols * t.stride(1)) \
        * t.element_size()
    return 32 * int(torch.unique(byte // 32).numel())


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


def sm_clock_hz() -> float:
    """The card's top SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_instance(entry: str) -> str:
    """A mamba_scan.cu instance by dtype and copy widths, e.g. "fp32
    wide"; any other kernel by its mangled name."""
    inst = re.search(r"scan_kernelI(f|13__nv_bfloat16)Lb([01])E", entry)
    if not inst:
        return entry
    dtype = "fp32" if inst.group(1) == "f" else "bf16"
    return f"{dtype} {'wide' if inst.group(2) == '1' else 'any'}"


def flash_instance(entry: str):
    """The head-dim padding DP (the template argument) of a
    flash_attention_mma or flash_attention_tf32x3 instance, or its mangled
    name."""
    dp = re.search(r"ILi(\d+)EE", entry)
    return int(dp.group(1)) if dp else entry


def gemm_instance(entry: str) -> str:
    """A GEMM-tile instance by kernel, dtype, block tile (BM x BN x BK),
    each operand's copied dim and (mm) whether it reads the operands'
    steps, e.g. "mm fp32 64x32x32 a:k b:mn" or "... a:k b:mn strided";
    any other kernel by its mangled name."""
    if "gram_kernel" not in entry and "mm_kernel" not in entry:
        return entry
    kernel = "gram" if "gram_kernel" in entry else "mm"
    dtype = "bf16" if "nv_bfloat16" in entry else "fp32"
    tile = re.search(r"TileI((?:Li\d+E)+)E", entry)
    dims = re.findall(r"\d+", tile.group(1)) if tile else ["?"] * 3
    name = f"{kernel} {dtype} {'x'.join(dims[:3])}"
    if kernel == "mm":
        a_mn, b_mn, strided = (flag == "1" for flag in re.findall(
            r"Lb([01])E", entry)[-3:])
        name += f" a:{'mn' if a_mn else 'k'} b:{'mn' if b_mn else 'k'}"
        name += " strided" if strided else ""
    return name


def sweep_kernel(entry: str) -> str:
    """The record name of a kernel of jacobi_sweep.cu, or its mangled
    name."""
    if "sweep_grid_kernel" in entry:
        return "jacobi_sweep"
    return "jacobi_sweep_smem" if "sweep_smem_kernel" in entry else entry


def ptxas_report(build_log: str, source: str, key=flash_instance) -> dict:
    """{key(entry name): registers and spill bytes} of each kernel instance
    compiled from ``source``, read from the ``-Xptxas -v`` lines of the
    build log."""
    out, info, here = {}, None, False
    for line in build_log.splitlines():
        if line.startswith("== "):
            here = line.split()[1] == source
            continue
        if not here:
            continue
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            info = out.setdefault(key(entry.group(1)), {})
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
    from repro_torch.kernels import fused, launch_counts, mm_engine, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def record(name, got, want, t_kernel, t_plain, t_lib, bound, tol,
               main=False, design=None):
        """``design`` is the bound at the rate of the kernel's own
        arithmetic (the GEMM tile's tensor cores), beside ``bound`` at
        the fp32 CUDA-core rate."""
        abs_err, rel_err, fro = errors(got, want)
        b_ms, b_by = bound
        log(f"kernel {name}: rel_frobenius {fro:.3e} (tol {tol:g}) "
            f"max_rel_err {rel_err:.3e} max_abs_err {abs_err:.3e} "
            f"kernel_ms {t_kernel:.4f} "
            f"plain_ms {t_plain:.4f} library_ms "
            f"{'null' if t_lib is None else f'{t_lib:.4f}'} "
            f"bound_ms {b_ms:.4f} ({b_by})"
            + ("" if design is None else
               f" design_bound_ms {design[0]:.4f} ({design[1]})"))
        check(fro <= tol, f"{name}: kernel disagrees with its plain "
              f"version: {fro:.3e} > {tol:g}")
        numbers = dict(max_abs_err=abs_err, ms=t_kernel, plain_ms=t_plain,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
        if main:
            row = rows[name.split("[")[0]]
            row.update(max_abs_err=abs_err, ms=t_kernel, plain_ms=t_plain,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
            if design is not None:
                row.update(design_bound_ms=design[0],
                           design_bound_by=design[1])
        return numbers

    # covariance at the main path's (70000, 784), fp32 and bf16, and a
    # batch; bounds at the fp32 CUDA-core rate (bf16: the bf16 tensor
    # rate) and, as design_bound, at the tensor rate of the kernel's own
    # arithmetic (three tf32 products for an fp32 one)
    design = {torch.float32: PEAK_TF32 / TF32_PRODUCTS,
              torch.bfloat16: PEAK_BF16}

    def library_gram(xd):
        # a bf16 torch.matmul rounds its output to bf16; out_dtype keeps
        # the fp32 sums, as the kernel does
        if xd.dtype == torch.float32:
            return torch.matmul(xd.mT, xd)
        mm = torch.mm if xd.ndim == 2 else torch.bmm
        return mm(xd.mT, xd, out_dtype=torch.float32)

    def gram(name, xd, reps, main=False):
        got = fused.fused_covariance(xd)
        want = ref.covariance_gram(xd)
        torch.cuda.synchronize()
        check(bool((got == got.mT).all()), f"{name}: Gram not symmetric")
        b, m, n = xd.shape if xd.ndim == 3 else (1, *xd.shape)
        nbytes = xd.numel() * xd.element_size() + b * n * n * 4
        flops = b * m * n * (n + 1)
        peak = PEAK_FP32 if xd.dtype == torch.float32 else PEAK_BF16
        record(name, got, want,
               time_ms(lambda: fused.fused_covariance(xd), reps),
               time_ms(lambda: ref.covariance_gram(xd), reps),
               time_ms(lambda: library_gram(xd), reps),
               bound_ms(nbytes, flops, peak), KERNEL_TOL, main=main,
               design=bound_ms(nbytes, flops, design[xd.dtype]))

    x = randn(M, N)
    gram(f"covariance[{M}x{N} float32]", x, 10, main=True)
    gram(f"covariance[{M}x{N} bfloat16]", x.bfloat16(), 10)
    del x
    gram(f"covariance[{BATCH}x{BM}x{BN}]", randn(BATCH, BM, BN), 20)

    # jacobi_sweep: one full sweep (n - 1 rounds) in one call, on the grid
    # kernel at n = 784 for each angle mode and on a padded 32 x 256 x 256
    # batch, on the shared-memory kernel on a padded 32 x 128 x 128 batch;
    # each bitwise the plain version's round-by-round loop.  The bound of a
    # sweep: C and V read and written once, 9 n^2 flops a round
    def sweep_bound(C, rounds):
        k = rounds.shape[1]
        return bound_ms(4 * C.numel() * 4, rounds.shape[0] * (
            9 * C.numel() + 20 * k * (C.numel() // C.shape[-1] ** 2)),
            PEAK_FP32)

    def sweep_case(name, kernel, C, V, rounds, angle, reps, main=False,
                   yardsticks=True):
        before = launch_counts()
        got = fused.jacobi_sweep_step(C, V, rounds, angle=angle)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        want = ref.jacobi_sweep_step(C, V, rounds, angle=angle)
        torch.cuda.synchronize()
        same = int((got[0] == want[0]).sum() + (got[1] == want[1]).sum())
        log(f"{name}: one call launched {json.dumps(moved)}; {same} of "
            f"{2 * C.numel()} entries bitwise equal to the plain version's "
            f"{rounds.shape[0]}-round loop")
        check(moved == {kernel: 1}, f"{name} launched {moved}, not one "
              f"{kernel}")
        check(same == 2 * C.numel(), f"{name}: not bitwise the plain loop")
        t_k = time_ms(lambda: fused.jacobi_sweep_step(C, V, rounds,
                                                       angle=angle), reps)
        t_p, t_l = float("nan"), None
        if yardsticks:
            t_p = time_ms(lambda: ref.jacobi_sweep_step(C, V, rounds,
                                                         angle=angle), 1,
                          warmup=0)
            # the solve's library call: torch.linalg.eigh of the same
            # matrices does the work of the whole solve, not of one sweep
            t_l = time_ms(lambda: torch.linalg.eigh(C), 3)
            log(f"{name}: {t_k / rounds.shape[0] * 1e3:.2f} us a round; "
                f"the solve ({SWEEPS} sweeps) {SWEEPS * t_k:.3f} ms against "
                f"torch.linalg.eigh {t_l:.3f} ms "
                f"({SWEEPS * t_k / t_l:.2f}x)")
        record(name, torch.cat(got), torch.cat(want), t_k, t_p, t_l,
               sweep_bound(C, rounds), 0.0, main=main)
        if main:
            t_dev = device_ms(lambda: fused.jacobi_sweep_step(
                C, V, rounds, angle=angle), 3)
            log(f"{name}: device_ms per sweep "
                f"{'not measured' if t_dev is None else f'{t_dev:.4f}'} "
                f"(profiler)")
            rows[kernel].update(device_ms=t_dev, solve_ms=SWEEPS * t_k,
                                library_call="torch.linalg.eigh: the whole "
                                f"{SWEEPS}-sweep solve, not one sweep")
        return got

    g = randn(N, N)
    C = (g @ g.mT) / N
    V = torch.linalg.qr(randn(N, N))[0].contiguous()
    rounds = torch.as_tensor(round_robin_rounds(N), device=dev)
    for angle in ("rutishauser", "atan2", "cordic"):
        main = angle == "rutishauser"
        sweep_case(f"jacobi_sweep[{N} {angle}]", "jacobi_sweep", C, V,
                   rounds, angle, 10, main=main, yardsticks=main)

    # zero-padded batches with mixed n_active (the flush's buckets): one
    # sweep in one call, bitwise the plain loop, padding exactly zero; the
    # shared-memory kernel in each angle mode (the grid kernel had them at
    # 784)
    def padded(bn, kernel, main, angles=("rutishauser",)):
        n_act = torch.as_tensor(np.random.default_rng(SEED).integers(
            bn // 2, bn + 1, BATCH), device=dev)
        idx = torch.arange(bn, device=dev)
        live = (idx[None, :] < n_act[:, None]).float()
        mask = live[:, :, None] * live[:, None, :]
        gb = randn(BATCH, bn, bn)
        Cb = ((gb @ gb.mT) / bn * mask).contiguous()
        Vb = torch.eye(bn, device=dev).expand(BATCH, bn, bn).contiguous()
        rounds_b = torch.as_tensor(round_robin_rounds(bn), device=dev)
        pad = 1.0 - mask
        eye = torch.eye(bn, device=dev).expand(BATCH, bn, bn)
        for angle in angles:
            first = angle == angles[0]
            name = f"{kernel}[{BATCH}x{bn}x{bn} padded {angle}]"
            Cs, Vs = sweep_case(name, kernel, Cb, Vb, rounds_b, angle, 20,
                                main=main and first, yardsticks=first)
            pad_c = int((Cs * pad != 0).sum())
            pad_v = int(((Vs - eye) * pad != 0).sum())
            log(f"{name} after one sweep: {pad_c} nonzero padded C "
                f"entries, {pad_v} padded V entries off the identity")
            check(pad_c == 0 and pad_v == 0,
                  "padded coordinates did not stay exact")

    padded(BN, "jacobi_sweep", False)
    padded(BN_SMEM, "jacobi_sweep_smem", True,
           ("rutishauser", "atan2", "cordic"))
    del C, V, g

    # mm_engine: the projection (70000, 784) @ (784, 32), the same with a
    # transposed a, the batched U = A V of the SVD, and a strided a (every
    # other feature: one element a copy); each call must launch the
    # tensor-core kernel once
    def matmul(name, a, b, kernel="mm_engine_matmul", reps=20, main=False):
        before = launch_counts()
        got = mm_engine.mm_engine(a, b)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        log(f"kernel {name}: launched {json.dumps(moved)}")
        check(moved == {kernel: 1}, f"{name} launched {moved}, not one "
              f"{kernel}")
        m, k = a.shape[-2:]
        n = b.shape[-1]
        batch = a.shape[0] if a.ndim == 3 else 1
        nbytes = (a.numel() + b.numel() + batch * m * n) * 4
        flops = 2 * batch * m * n * k
        return record(name, got, ref.mm_engine(a, b),
                      time_ms(lambda: mm_engine.mm_engine(a, b), reps),
                      time_ms(lambda: ref.mm_engine(a, b), reps),
                      time_ms(lambda: torch.matmul(a, b), reps),
                      bound_ms(nbytes, flops, PEAK_FP32), KERNEL_TOL,
                      main=main, design=bound_ms(
                          nbytes, flops, PEAK_TF32 / TF32_PRODUCTS))

    a = randn(M, N)
    b = randn(N, K)
    matmul(f"mm_engine_matmul[{M}x{N}@{N}x{K}]", a, b, main=True)
    at = randn(N, M).mT  # contiguous along m
    matmul(f"mm_engine_matmul[({N}x{M}).mT@{N}x{K}]", at, b)
    del at
    A = randn(BATCH, BM, BN)
    Vq = torch.linalg.qr(randn(BATCH, BN, BN))[0].contiguous()
    matmul(f"mm_engine_matmul[{BATCH}x{BM}x{BN}@{BN}x{BN}]", A, Vq)
    # the strided projection: its bound counts the view's bytes once; the
    # 32-byte sectors that hold them carry every other float too, so DRAM
    # moves the whole rows (the sector floor)
    strided = matmul(f"mm_engine_matmul[{M}x{N}[:, ::2]@{N // 2}x{K}]",
                     a[:, ::2], b[::2])
    floor = (sector_bytes(a[:, ::2]) + (b[::2].numel() + M * K) * 4) \
        / PEAK_BYTES * 1e3
    log(f"kernel mm_engine_matmul[strided]: sector_floor_ms {floor:.4f} "
        f"beside bound_ms {strided['bound_ms']:.4f} (the view's bytes once)")
    rows["mm_engine_matmul"].update(
        {f"strided_{k}": v for k, v in strided.items()},
        strided_sector_floor_ms=floor)


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
    check(counts["jacobi_sweep"] == SWEEPS
          and counts["jacobi_sweep_smem"] == 0,
          f"the sweeps launched {counts['jacobi_sweep']} grid and "
          f"{counts['jacobi_sweep_smem']} shared-memory kernels, not one "
          f"grid kernel a sweep ({SWEEPS})")
    return {"wall_s": wall, "launches": counts,
            "profile": profile_fit(X, config, dev)}


def profiled(what: str, fn) -> dict:
    """Where ``fn``'s time goes: ``fn()`` under torch.profiler (its
    launches are not the phase's), the device's busy time summed over the
    traced kernels and copies, and the largest of them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(((e.key, e.count, e.device_time_total / 1e6)
                    for e in prof.key_averages()
                    if e.device_time_total > 0), key=lambda t: -t[2])
    busy = sum(t for _, _, t in spans)
    top = [{"name": name[:80], "calls": calls, "s": t}
           for name, calls, t in spans[:6]]
    log(f"{what}, profiled rerun: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}; by device time: "
        f"{json.dumps(top)}")
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
            "top": top}


def profile_fit(X, config, dev) -> dict:
    """The fit once more under torch.profiler (``profiled``)."""
    import repro_torch
    return profiled("main path", lambda: repro_torch.fit_transform(
        X, K, config, device=dev))


# -- phase 4: a batched flush ----------------------------------------------

def reference_values(op: str, a: np.ndarray) -> np.ndarray:
    """Float64 numpy's answer to one request: eigenvalues (eigh, pca) or
    singular values (svd), descending."""
    a = a.astype(np.float64)
    if op == "eigh":
        return np.linalg.eigvalsh(a)[::-1]
    if op == "svd":
        return np.linalg.svd(a, compute_uv=False)
    std = a.std(axis=0)
    std[std < 1e-8] = 1.0
    xs = (a - a.mean(axis=0)) / std
    return np.linalg.eigvalsh(xs.T @ xs)[::-1]


def batched_flush(dev) -> dict:
    from repro_torch.core.pca import PCAConfig
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batching import BucketPolicy, stack_requests
    from repro_torch.serving.solver import build_solver_fn

    rng = np.random.default_rng(SEED + 1)
    policy = BucketPolicy(T=FLUSH_T, mode="pow2")
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
    worst, solve_s = {}, 0.0
    for op, mats in requests.items():
        solve = build_solver_fn(op, config, device=dev)
        budget_op = "svd" if op == "svd" else "eigh"
        buckets = {}
        for i, a in enumerate(mats):
            buckets.setdefault(policy.bucket_shape(a.shape), []).append(i)
        worst[op] = 0.0
        for shape, ids in sorted(buckets.items()):
            batch, n_active = stack_requests([mats[i] for i in ids], shape)
            torch.cuda.synchronize()
            t_solve = time.perf_counter()
            res = solve(batch, n_active[0], n_active[-1])
            torch.cuda.synchronize()
            solve_s += time.perf_counter() - t_solve
            for j, i in enumerate(ids):
                a = mats[i]
                want = reference_values(op, a)
                n = a.shape[1]
                if op == "eigh":
                    got = res.eigenvalues[j, :n].cpu().numpy()
                    V = res.eigenvectors[j].cpu()
                    eye = torch.eye(shape[0])
                    check(bool((V[n:, :] == eye[n:, :]).all()
                               and (V[:, n:] == eye[:, n:]).all()
                               and (res.eigenvalues[j, n:] == 0).all()),
                          f"eigh bucket {shape}: padding did not stay exact")
                elif op == "svd":
                    got = res.S[j, :n].cpu().numpy()
                else:
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
    log(f"batched flush: solve {solve_s:.3f} s (the synchronised solve "
        f"calls, host to device copies included), wall {wall:.3f} s (float64 "
        f"checks included), launches {json.dumps(counts)}")
    for name in FLUSH_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in the "
              f"batched flush")
    return {"wall_s": wall, "solve_s": solve_s, "launches": counts,
            "worst": worst, "requests": requests}


# -- phase 5: the standalone registry ops -----------------------------------

def kernel_ab():
    """``scripts/kernel_ab.py`` of this checkout, for its host split of the
    small calls and its SASS chain."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "scripts" / \
        "kernel_ab.py"
    spec = importlib.util.spec_from_file_location("kernel_ab", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of the bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def ops_phase(dev, rows: dict) -> dict:
    from repro_torch.backends import registry
    from repro_torch.core.jacobi import round_robin_rounds
    from repro_torch.kernels import (build, cordic, dle, launch_counts, ops,
                                     ref, reset_launch_counts)
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
    nan = gram.clone()
    top = int(torch.argmax((gram - torch.diag(torch.diag(gram))).abs()))
    for i, j in ((top // N, top % N), (top % N, top // N), *NAN_AT):
        nan[i, j] = float("nan")
    inf = nan.clone()
    inf[INF_AT], inf[INF_AT[::-1]] = float("inf"), -float("inf")
    dle_cases = (("gram", gram), ("tie", tie), ("diag", diag), ("nan", nan),
                 ("inf", inf))
    # CORDIC: one round's pivots at n = 784, and 2^20 pivots for a rate
    pairs = torch.as_tensor(round_robin_rounds(N)[N // 3], device=dev).long()
    p, q = pairs[:, 0], pairs[:, 1]
    round_piv = (gram[p, q].contiguous(), gram[p, p].contiguous(),
                 gram[q, q].contiguous())
    scale = 10.0 ** torch.randint(-3, 4, (3, CORDIC_RATE_K), generator=gen,
                                  device=dev)
    rate_piv = tuple(randn(3, CORDIC_RATE_K) * scale)
    # attention: prefill in bf16 and fp32, one decode step past the prefix
    # in each, and a small bf16 prefill of head dim 20 (q, k, v, q_offset)
    qkv32 = tuple(randn(FA_BH, FA_S, FA_D) for _ in range(3))
    qkv16 = tuple(t.bfloat16() for t in qkv32)
    q_dec32 = randn(FA_BH, 1, FA_D)
    q_dec16 = q_dec32.bfloat16()
    fa_cases = {
        "prefill_bf16": (*qkv16, 0), "prefill_fp32": (*qkv32, 0),
        "prefill_d20_bf16": (*(randn(FA_BH, FA_S_D20, FA_D20).bfloat16()
                               for _ in range(3)), 0),
        "decode_bf16": (q_dec16, *qkv16[1:], FA_S - 1),
        "decode_fp32": (q_dec32, *qkv32[1:], FA_S - 1)}
    # mm_engine_matmul on a strided view: every other feature of the main
    # path's data onto 32 directions (no unit stride: one element a copy)
    Xg = torch.as_tensor(synthetic_dataset(M, N, SEED), device=dev)[:, ::2]
    W = randn(N // 2, K)
    # selective scan: the reference tests' distributions
    scan = (randn(MS_B, MS_L, MS_D), rand(MS_B, MS_L, MS_D) * 0.19 + 0.01,
            -(rand(MS_D, MS_N) * 1.5 + 0.5), randn(MS_B, MS_L, MS_N),
            randn(MS_B, MS_L, MS_N), randn(MS_D))
    # the same in bf16 (u, delta, B, C; A and D_skip stay fp32)
    scan16 = tuple(t.bfloat16() if t.ndim == 3 else t for t in scan)

    torch.cuda.synchronize()
    reset_launch_counts()
    registry.reset_resolution_counts()
    t0 = time.perf_counter()
    piv = {name: ops.dle_find_pivot(c, tile=OPS_TILE)
           for name, c in dle_cases}
    rot = {"round": ops.cordic_rotate(*round_piv),
           "rate": ops.cordic_rotate(*rate_piv)}
    att, att_moved = {}, {}
    for name, (*args, off) in fa_cases.items():
        before = launch_counts()
        att[name] = ops.flash_attention(*args, causal=True, q_offset=off)
        att_moved[name] = {k: c - before[k]
                           for k, c in launch_counts().items()
                           if c != before[k]}
    ys, scan_moved = {}, {}
    for name, args in (("fp32", scan), ("bf16", scan16)):
        before = launch_counts()
        ys[name] = ops.mamba_scan(*args)
        scan_moved[name] = {k: c - before[k]
                            for k, c in launch_counts().items()
                            if c != before[k]}
    before = launch_counts()
    proj = ops.mm_engine_matmul(Xg, W)
    mm_moved = {k: c - before[k] for k, c in launch_counts().items()
                if c != before[k]}
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
    for name, moved in scan_moved.items():
        log(f"mamba_scan[{name}]: launched {json.dumps(moved)}")
        check(moved == {"mamba_scan": 1}, f"mamba_scan[{name}] launched "
              f"{moved}, not one mamba_scan")
    log(f"mm_engine_matmul[strided]: launched {json.dumps(mm_moved)}")
    check(mm_moved == {"mm_engine_matmul": 1}, f"mm_engine_matmul on a "
          f"strided view launched {mm_moved}, not one mm_engine_matmul")
    for name in FLUSH_KERNELS:
        if name not in OPS_KERNELS:
            check(counts[name] == 0, f"the ops phase launched {name}")
    err = errors(proj, ref.mm_engine(Xg, W))[2]
    log(f"mm_engine_matmul[strided {M}x{N // 2}@{N // 2}x{K}]: "
        f"rel_frobenius {err:.3e} (tol {KERNEL_TOL:g})")
    check(err <= KERNEL_TOL, "mm_engine_matmul on a strided view: kernel "
          "disagrees with its plain version")
    outs = [t for pv in piv.values() for t in pv] + [
        t for r in rot.values() for t in r] + list(att.values()) + [
        *ys.values(), proj]
    check(all(t.is_cuda for t in outs), "an op returned a CPU tensor")

    def row(name, err, t_k, t_p, t_l, bound, fn, prefix=""):
        t_dev = device_ms(fn, 10)
        log(f"{name}: device_ms per call "
            f"{'not measured' if t_dev is None else f'{t_dev:.4f}'} "
            f"(profiler), against {t_k:.4f} ms between back-to-back calls")
        numbers = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=bound[0], bound_by=bound[1], device_ms=t_dev)
        rows[name].update({prefix + k: v for k, v in numbers.items()})

    # dle_find_pivot: the plain scan's (value, flat index) bit for bit,
    # NaN tiles skipped, and the pivot gathered from C
    def bits(*ts):
        return [int(t.view(torch.int32)) if t.dtype == torch.float32
                else int(t) for t in ts]

    for name, c in dle_cases:
        pv = piv[name]
        val, idx = ref.dle_scan(c, OPS_TILE)
        scanned = dle.dle_scan(c, OPS_TILE)
        n = c.shape[0]
        flat = int(pv.p) * n + int(pv.q)
        log(f"dle_find_pivot[{name} {n}x{n} tile {OPS_TILE}]: kernel "
            f"({float(scanned[0]):.9g}, {int(scanned[1])}) at ({int(pv.p)}, "
            f"{int(pv.q)}), plain ({float(val):.9g}, {int(idx)})")
        check(bits(*scanned) == bits(val, idx) and flat == int(idx)
              and float(pv.apq.abs()) == float(val),
              f"dle_find_pivot[{name}]: kernel and plain version differ")
        check(bits(pv.apq, pv.app, pv.aqq) == bits(
            c[pv.p, pv.q], c[pv.p, pv.p], c[pv.q, pv.q]),
              f"dle_find_pivot[{name}]: the gathered pivot is not C's")
    check((int(piv["tie"].p), int(piv["tie"].q)) == TIE[1],
          "dle_find_pivot[tie]: not the earlier tile's maximum")
    check(int(piv["diag"].p) == 0 and int(piv["diag"].q) == 1,
          "dle_find_pivot[diag]: not the TPU kernel's (0, 1)")
    check(bits(*dle.dle_scan(nan, OPS_TILE)) != bits(*dle.dle_scan(
        gram, OPS_TILE)), "dle_find_pivot[nan]: the NaN tile was not skipped")
    t_k = time_ms(lambda: dle.dle_scan(gram, OPS_TILE), 1000)
    t_p = time_ms(lambda: ref.dle_scan(gram, OPS_TILE), 50)
    t_op = time_ms(lambda: ops.dle_find_pivot(gram, OPS_TILE), 1000)
    t_op_dev = device_ms(lambda: ops.dle_find_pivot(gram, OPS_TILE), 10)
    b = bound_ms(N * N * 4 + 40, 2 * N * N, PEAK_FP32)
    log(f"dle_find_pivot[{N}x{N}]: kernel_ms {t_k:.4f} (dle_scan) op_ms "
        f"{t_op:.4f} (ops.dle_find_pivot; "
        f"{'not measured' if t_op_dev is None else f'{t_op_dev:.4f}'} on "
        f"the device) plain_ms {t_p:.4f} library_ms null (no one PyTorch "
        f"call masks the diagonal and ranks ties in tile order) bound_ms "
        f"{b[0]:.5f} ({b[1]})")
    row("dle_find_pivot", 0.0, t_k, t_p, None, b,
        lambda: dle.dle_scan(gram, OPS_TILE))
    rows["dle_find_pivot"].update(op_ms=t_op, op_device_ms=t_op_dev)
    # the host's share of the two small calls, step by step
    split = kernel_ab().lean_split(gram, round_piv)
    log(f"host split, microseconds a step: {json.dumps(split)}")
    rows["dle_find_pivot"]["host_split_us"] = split

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
            t_op = time_ms(lambda: ops.cordic_rotate(*args), 1000)
            # the latency floor: the longest chain of dependent
            # instructions in the kernel's SASS at the card's top SM clock
            chain = kernel_ab().sass_chain(
                str(build.build_dir() / build.LIB_NAME), "cordic_kernel")
            floor = chain["chain_cycles"] / sm_clock_hz() * 1e3
            log(f"cordic_rotate[k={k}]: op_ms {t_op:.4f} "
                f"(ops.cordic_rotate); SASS chain "
                f"{chain['chain_instructions']} dependent instructions, "
                f"{chain['chain_cycles']} cycles: latency_floor_ms "
                f"{floor:.6f} at {sm_clock_hz() / 1e6:.0f} MHz")
            rows["cordic_rotate"].update(
                op_ms=t_op, latency_floor_ms=floor,
                sass_chain_cycles=chain["chain_cycles"],
                sass_chain_instructions=chain["chain_instructions"])

    # flash_attention: fp32 within 2e-5 of the plain version; bf16 within
    # one bf16 ulp (plus that 2e-5) of the plain version's fp32 result --
    # two fp32 sums 1e-7 apart round to bf16 values many ulps apart near 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, out in att.items():
        decode = name.startswith("decode")
        bf16 = name.endswith("bf16")
        qq, kk, vv, off = fa_cases[name]
        qkv = (qq, kk, vv)
        bh, sq, d = qq.shape
        skv = kk.shape[1]
        want32 = ref.flash_attention(qq.float(), kk.float(), vv.float(),
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
        pairs_seen = skv * (skv + 1) // 2 if not decode else skv
        n_bytes = es * bh * d * (2 * sq + 2 * skv)
        flops = 4 * bh * d * pairs_seen
        b = bound_ms(n_bytes, flops, PEAK_BF16 if bf16 else PEAK_FP32)
        extra = ""
        if FA_ROUTE[name] == "flash_attention_tf32x3":
            # the same work as three tf32 products at the tensor-core rate
            b3 = bound_ms(n_bytes, TF32_PRODUCTS * flops, PEAK_TF32)
            rows[FA_ROUTE[name]].update(bound_3xtf32_ms=b3[0])
            extra = f"; {b3[0]:.4f} ({b3[1]}) at 3xTF32"
        log(f"flash_attention[{name} {bh}x{sq}x{skv}x{d}]: max_abs_err "
            f"{err:.3e}{note} kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f}"
            + f" bound_ms {b[0]:.4f} ({b[1]}{extra}) [{FA_ROUTE[name]}]")
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention[{name}]: non-finite output")
        check(over == 0 if bf16 else err <= 2e-5,
              f"flash_attention[{name}]: kernel disagrees with its plain "
              f"version")
        if name in FA_ROW:
            row(FA_ROUTE[name], err, t_k, t_p, t_l, b,
                lambda: fa.flash_attention(qq, *qkv[1:], causal=True,
                                           q_offset=off), FA_ROW[name])

    # mamba_scan: fp32 within rtol = atol = 1e-4 (the reference's
    # tolerance); bf16 within one bf16 ulp + 1e-4 of the plain version's
    # fp32 result on the same bf16 inputs.  The bound: u, dt and y once,
    # and N exponentials a (b, t, d) on the SFU (16 a clock an SM at the
    # card's top SM clock) beside the other arithmetic at the fp32 rate
    bld = MS_B * MS_L * MS_D
    sfu_rate = SFU_PER_CLOCK * torch.cuda.get_device_properties(
        dev).multi_processor_count * sm_clock_hz()
    t_sfu = bld * MS_N / sfu_rate * 1e3
    for name, args in (("fp32", scan), ("bf16", scan16)):
        out = ys[name]
        prefix = "" if name == "fp32" else "bf16_"
        es = out.element_size()
        want = ref.mamba_scan(*(t.float() for t in args))
        err = float((out.float() - want).abs().max())
        if name == "fp32":
            close = bool(((out - want).abs() <= 1e-4 + 1e-4 * want.abs())
                         .all())
            rule = "rtol = atol = 1e-4"
        else:
            slack = bf16_ulp(torch.maximum(out.float().abs(), want.abs())) \
                + 1e-4
            close = bool(((out.float() - want).abs() <= slack).all())
            rule = "one bf16 ulp + 1e-4 of the fp32 plain version"
        t_k = time_ms(lambda: ms.mamba_scan(*args), 20)
        t_p = time_ms(lambda: ref.mamba_scan(*args), 1, warmup=0)
        n_bytes = es * (3 * bld + 2 * MS_B * MS_L * MS_N) \
            + 4 * (MS_D * MS_N + MS_D)
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = bld * (7 * MS_N + 3) / PEAK_FP32 * 1e3
        b = max((t_bytes, "bytes"), (t_sfu, "operations"),
                (t_ops, "operations"))
        what = ("bytes" if b[0] == t_bytes else "the SFU's exponentials"
                if b[0] == t_sfu else "fp32 arithmetic")
        log(f"mamba_scan[{name} {MS_B}x{MS_L}x{MS_D} N={MS_N}]: max_abs_err "
            f"{err:.3e} ({rule}: {close}) kernel_ms {t_k:.4f} plain_ms "
            f"{t_p:.4f} library_ms null (PyTorch has no selective-scan "
            f"call) bound_ms {b[0]:.4f}, bound by {what} (bytes "
            f"{t_bytes:.4f}, {bld * MS_N:.3g} exponentials on the SFU "
            f"{t_sfu:.4f} at {sfu_rate / 1e12:.3f} T/s, fp32 arithmetic "
            f"{t_ops:.4f})")
        check(torch.isfinite(out.float()).all().item() and close,
              f"mamba_scan[{name}]: kernel disagrees with its plain version")
        row("mamba_scan", err, t_k, t_p, None, b,
            lambda: ms.mamba_scan(*args), prefix)
        rows["mamba_scan"].update({prefix + "bound_bytes_ms": t_bytes,
                                   prefix + "bound_sfu_ms": t_sfu})
    return {"wall_s": wall, "launches": counts}


# -- phase 6: the serving engine ---------------------------------------------

def serve_phase(dev, requests: dict) -> dict:
    import dataclasses
    from repro_torch.core.pca import PCAConfig
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import BucketPolicy, PCAServer

    config = PCAConfig(fused=True, backend=BACKEND, sweeps=SWEEPS, T=FLUSH_T,
                       S=FLUSH_REQUESTS)
    burst = [(op, a) for op, mats in requests.items() for a in mats]
    guarded = [0]

    def no_sync(submit):
        """``submit`` under the sync debug mode "error": a host sync in the
        dispatch stage raises."""
        def guarded_submit(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                flush = submit(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            guarded[0] += 1
            return flush
        return guarded_submit

    def one_pass(srv):
        """The burst through ``srv``, then drain: (served results in
        order, wall seconds, telemetry of this pass alone)."""
        srv.stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = [srv.submit(a, op=op) for op, a in burst]
        srv.drain()
        wall = time.perf_counter() - t0
        return [t.result() for t in tickets], wall, srv.stats

    servers, passes, runs = {}, [], {}
    torch.cuda.synchronize()
    reset_launch_counts()
    for depth in SERVE_DEPTHS:
        srv = servers[depth] = PCAServer(
            config, policy=BucketPolicy(T=FLUSH_T, mode="pow2"),
            max_inflight=depth)
        check(srv.executor.device.type == "cuda",
              f"PCAServer() runs on {srv.executor.device}, not the card")
        srv.executor.submit = no_sync(srv.executor.submit)
        run = runs[depth] = {}
        for name in ("cold", "warm"):
            served, wall, stats = one_pass(srv)
            passes.append(served)
            summary = stats.summary()
            flushes = list(stats.flush_records)
            run[name] = {
                "wall_s": wall, "flushes": summary["flushes"],
                "cache_hits": stats.cache_hits,
                "requests_per_s": summary["requests_per_s"],
                "latency_p50_ms": summary["latency_p50_ms"],
                "latency_p99_ms": summary["latency_p99_ms"],
                "mean_overlap_ms": 1e3 * float(np.mean(
                    [f.overlap_s for f in flushes])),
                "mean_wait_ms": 1e3 * float(np.mean(
                    [f.wait_s for f in flushes])),
                "mean_dispatch_ms": 1e3 * float(np.mean(
                    [f.dispatch_s for f in flushes])),
                "max_inflight_depth": summary["max_inflight_depth"]}
            log(f"serve[max_inflight={depth} {name}]: {len(burst)} requests "
                f"in {summary['flushes']} flushes ({stats.cache_hits} cache "
                f"hits), wall {wall:.3f} s, "
                f"{summary['requests_per_s']:.1f} requests/s, latency p50 "
                f"{summary['latency_p50_ms']:.1f} ms p99 "
                f"{summary['latency_p99_ms']:.1f} ms, per flush: overlap "
                f"{run[name]['mean_overlap_ms']:.2f} ms, wait "
                f"{run[name]['mean_wait_ms']:.2f} ms, dispatch "
                f"{run[name]['mean_dispatch_ms']:.2f} ms; max in flight "
                f"{summary['max_inflight_depth']}")
        check(run["cold"]["cache_hits"] == 0,
              f"serve[max_inflight={depth}]: the cold pass hit the cache")
        check(run["warm"]["cache_hits"] == run["warm"]["flushes"] > 0,
              f"serve[max_inflight={depth}]: the warm pass missed the cache "
              f"({run['warm']['cache_hits']} of {run['warm']['flushes']})")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"serve: launches {json.dumps(counts)}; {guarded[0]} executor.submit "
        f"calls under set_sync_debug_mode('error'), none synced the host")
    for name in FLUSH_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in the serve "
              f"phase")

    budget = ERROR_BUDGETS["fp32"]
    worst = {}
    for (op, a), res in zip(burst, passes[0]):
        got = res.S if op == "svd" else res.eigenvalues
        err = rel_frobenius(got, reference_values(op, a))
        worst[op] = max(worst.get(op, 0.0), err)
        check(np.isfinite(got).all() and got.shape == (a.shape[1],)
              and err <= budget["svd" if op == "svd" else "eigh"],
              f"serve {op} {a.shape}: rel-Frobenius {err:.3e} over budget")
    log(f"serve: worst rel-Frobenius vs float64 numpy {json.dumps(worst)}")
    for k, served in enumerate(passes[1:], 1):
        for (op, _), g, w in zip(burst, served, passes[0]):
            for f in dataclasses.fields(w):
                check(np.array_equal(getattr(g, f.name), getattr(w, f.name)),
                      f"serve pass {k} {op}.{f.name} differs bitwise from "
                      f"pass 0")
    log(f"serve: the {len(passes)} passes (max_inflight "
        f"{' and '.join(map(str, SERVE_DEPTHS))}, cold and warm) bitwise "
        f"equal field by field")
    # where the pipelined run's time goes (not counted in the launches)
    srv = servers[SERVE_DEPTHS[-1]]
    profile = profiled(f"serve[max_inflight={SERVE_DEPTHS[-1]}]",
                       lambda: one_pass(srv))
    return {"launches": counts, "runs": runs, "worst": worst,
            "profile": profile, "submits_guarded": guarded[0]}


# -- phase 7: the control plane and the serving CLI ---------------------------

def run_cli(argv) -> dict:
    """``repro_torch.launch.serve_pca.main(argv)`` on the card: its JSON
    document (it prints one) and the wall seconds of the call."""
    import contextlib
    import io
    from repro_torch.launch import serve_pca
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_pca.main([str(a) for a in argv], device="cuda")
    wall = time.perf_counter() - t0
    check(rc == 0, f"serve_pca {' '.join(map(str, argv))} exited {rc}")
    doc = json.loads(out.getvalue())
    doc["_wall_s"] = wall
    return doc


def check_trace(path: pathlib.Path, what: str) -> int:
    """The saved span trace passes ``validate_trace`` and every request
    span has a flush span as its parent; returns the request spans."""
    from repro_torch.obs import validate_trace
    trace = json.loads(path.read_text())
    errs = validate_trace(trace)
    check(not errs, f"{what}: trace fails validation: {errs[:3]}")
    spans = {e["id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and isinstance(e.get("id"), int)}
    requests = [e for e in spans.values()
                if e["name"].startswith("request:")]
    check(len(requests) > 0, f"{what}: no request spans")
    for e in requests:
        parent = spans.get(e["args"].get("parent"), {})
        check(str(parent.get("name", "")).startswith("flush:"),
              f"{what}: request span {e['id']} not under a flush span")
    return len(requests)


def profiled_kernels(logdir: pathlib.Path) -> set:
    """The CUDA kernel names of the ``torch.profiler`` Chrome trace that
    ``--jax-profile`` wrote into ``logdir``."""
    traces = sorted(logdir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"{logdir}: {len(traces)} profiler traces")
    events = json.loads(traces[0].read_text())["traceEvents"]
    return {str(e.get("name")) for e in events if e.get("cat") == "kernel"}


def control_phase(dev) -> dict:
    """Phase 7: the control plane and the CLI on the card, through the
    entry points a user calls, at the widths of phases 4 and 6.

    1. Closed loop: ``serve_pca.main(["--spec", ...])`` for eigh and pca,
       96 requests over dims 96..256 (phase 4's eigh range; pow2 buckets
       128 and 256, so both sweep kernels), the spec's obs outputs armed.
    2. Open loop with the controller: 256 Poisson arrivals over the same
       range (``--dims 96,256``: the stream draws each dimension uniformly
       between the two) from two tenants through WFQ and shedding, at
       1.5x the requests/s item 1's eigh run sustained; then the same
       arrivals without the controller.  Before each timed run the CLI
       solves one request a distinct shape times the CLI's ``--max-batch``
       (4: the spec owns the server's batch of 32, not that flag): the
       seeded stream has 134 shapes, so 536 requests in 18 flushes of 32,
       a few seconds on the card.  That is why the range is kept whole
       and the request count is the reference's 256.
    3. Correctness and determinism: the spec's server under a
       ``VirtualClock`` on the card, a seeded two-tenant stream (eigh and
       svd) through ``TrafficFrontend(pace=False)`` twice -- equal
       digests and outcome maps, every served result within the fp32
       budget of float64 numpy -- and an ``apply_plan`` swap mid-stream
       bitwise a cold server on the plan.
    """
    import dataclasses
    import tempfile
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ControllerSpec, CostModel,
                                     ExecutionSpec, ObsSpec, SchedulingSpec,
                                     ServerSpec, ServingPlan, TenantSpec,
                                     TrafficFrontend, TrafficProfile,
                                     VirtualClock, build_server, generate,
                                     materialize, merge, server_for_plan)

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_control_"))
    scheduling = SchedulingSpec(mode="pow2", T=FLUSH_T,
                                max_batch=FLUSH_REQUESTS, max_inflight=3)
    execution = ExecutionSpec(backend=BACKEND, fused=True, sweeps=SWEEPS)
    budget = ERROR_BUDGETS["fp32"]
    out = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t_phase = time.perf_counter()

    # 1. the CLI, closed loop
    closed = {}
    for op in ("eigh", "pca"):
        files = tmp / op
        spec = ServerSpec(scheduling=scheduling, execution=execution,
                          obs=ObsSpec(slo_ms=CONTROL_SLO_MS[0],
                                      trace_out=str(files / "trace.json"),
                                      metrics_out=str(files / "metrics.prom"),
                                      jax_profile=str(files / "profile")))
        files.mkdir(parents=True)
        spec_path = files / "server.json"
        spec.save(spec_path)
        before = launch_counts()
        doc = run_cli(["--spec", spec_path, "--op", op, "--requests",
                       CONTROL_REQUESTS, "--dims",
                       ",".join(map(str, CONTROL_DIMS)), "--profile-out",
                       files / "profile.json"])
        moved = {k: v - before[k] for k, v in launch_counts().items()}
        s = doc["summary"]
        check(s["requests"] == CONTROL_REQUESTS and s["cache_hit_rate"] == 1.0,
              f"closed loop {op}: {s['requests']} requests, cache hit rate "
              f"{s['cache_hit_rate']}")
        n_req = check_trace(files / "trace.json", f"closed loop {op}")
        check(n_req == CONTROL_REQUESTS, f"closed loop {op}: {n_req} request "
              f"spans")
        prom = (files / "metrics.prom").read_text()
        check("serve_request_latency_seconds_bucket" in prom,
              f"closed loop {op}: no latency histogram in the metrics")
        cuda_rows = [line for line in prom.splitlines()
                     if line.startswith("kernel_backend_resolutions_total")
                     and 'backend="cuda"' in line]
        check(len(cuda_rows) > 0, f"closed loop {op}: no "
              "kernel_backend_resolutions_total with backend=\"cuda\"")
        kernels = profiled_kernels(files / "profile")
        for name in ("sweep_grid_kernel", "sweep_smem_kernel"):
            check(any(name in k for k in kernels), f"closed loop {op}: the "
                  f"profiler trace names no {name}")
        need = ("jacobi_sweep", "jacobi_sweep_smem") + (
            ("covariance",) if op == "pca" else ())
        for name in need:
            check(moved[name] > 0, f"closed loop {op}: {name} never launched")
        model = CostModel.calibrated(
            TrafficProfile.load(files / "profile.json"))
        closed[op] = {
            "wall_s": doc["_wall_s"], "requests_per_s": s["requests_per_s"],
            "latency_p50_ms": s["latency_p50_ms"],
            "latency_p99_ms": s["latency_p99_ms"], "flushes": s["flushes"],
            "launches": {k: v for k, v in moved.items() if v},
            "resolutions": cuda_rows,
            "calibrated_model": dataclasses.asdict(model)}
        log(f"control[closed {op}]: {CONTROL_REQUESTS} requests in "
            f"{s['flushes']} flushes, {s['requests_per_s']:.1f} requests/s, "
            f"p50 {s['latency_p50_ms']:.1f} ms p99 "
            f"{s['latency_p99_ms']:.1f} ms (CLI call {doc['_wall_s']:.2f} s); "
            f"launches {json.dumps(closed[op]['launches'])}; "
            f"{len(cuda_rows)} cuda resolution series; calibrated "
            f"CostModel {json.dumps(closed[op]['calibrated_model'])}")
    out["closed"] = closed

    # 2. the CLI, open loop with the controller, then the same arrivals
    # without it (what the controller's swaps did to goodput)
    rate = 1.5 * closed["eigh"]["requests_per_s"]
    for name, enabled in (("open", True), ("open_no_controller", False)):
        files = tmp / name
        files.mkdir()
        spec = ServerSpec(scheduling=scheduling, execution=execution,
                          obs=ObsSpec(slo_ms=CONTROL_SLO_MS[1],
                                      trace_out=str(files / "trace.json"),
                                      metrics_out=str(files / "metrics.prom")),
                          controller=ControllerSpec(enabled=enabled))
        spec.save(files / "server.json")
        doc = run_cli(["--spec", files / "server.json", "--arrivals",
                       "poisson", "--rate", f"{rate:.6f}", "--requests",
                       OPEN_REQUESTS, "--op", "eigh", "--dims",
                       f"{CONTROL_DIMS[0]},{CONTROL_DIMS[-1]}", "--tenants",
                       "whale:0.9,mouse:0.1", "--scheduler", "wfq",
                       "--admission", "shed"])
        fe, ctrl = doc["frontend"], doc["controller"]
        check(fe["served"] + fe["degraded"] + fe["shed"] + fe["throttled"]
              == fe["requests"] == OPEN_REQUESTS and fe["served"] > 0,
              f"{name}: outcomes do not add up: {json.dumps(fe)[:400]}")
        check((ctrl is not None) == enabled, f"{name}: controller {ctrl}")
        check_trace(files / "trace.json", name)
        out[name] = {
            "rate_rps": rate, "wall_s": doc["_wall_s"],
            "duration_s": fe["duration_s"], "goodput_rps": fe["goodput_rps"],
            "served_rps": fe["served_rps"], "served": fe["served"],
            "shed": fe["shed"], "throttled": fe["throttled"],
            "shed_frac": fe["shed_frac"],
            "p99_ms": {t: r["latency_p99_ms"]
                       for t, r in fe["per_tenant"].items()},
            "plan": doc["plan"],
            "controller": ctrl and {"ticks": ctrl["ticks"],
                                    "swaps": ctrl["swaps"],
                                    "swap_log": ctrl["swap_log"]}}
        log(f"control[{name}]: {OPEN_REQUESTS} arrivals at {rate:.1f}/s "
            f"(1.5x closed eigh) over {fe['duration_s']:.3f} s, goodput "
            f"{fe['goodput_rps']:.1f}/s, served {fe['served']} "
            f"({fe['served_rps']:.1f}/s), shed {fe['shed']} "
            f"({fe['shed_frac']:.3f}), p99 by tenant "
            f"{json.dumps(out[name]['p99_ms'])} ms, final plan "
            f"{json.dumps(doc['plan'])}, controller "
            f"{json.dumps(out[name]['controller'])}; CLI call "
            f"{doc['_wall_s']:.2f} s")

    # 3. correctness and determinism under a virtual clock
    spec = ServerSpec(scheduling=scheduling, execution=execution,
                      obs=ObsSpec(slo_ms=CONTROL_SLO_MS[1]))
    tenants = (TenantSpec("whale"), TenantSpec("mouse", weight=2.0))
    stream = merge(
        generate("poisson", rate=VIRTUAL_RATES[0], n=VIRTUAL_REQUESTS[0],
                 tenants=tenants[:1], seed=SEED + 3, trace="uniform",
                 op="eigh", lo=FLUSH_EIGH_N[0], hi=FLUSH_EIGH_N[1]),
        generate("poisson", rate=VIRTUAL_RATES[1], n=VIRTUAL_REQUESTS[1],
                 tenants=tenants[1:], seed=SEED + 4, trace="uniform",
                 op="svd", lo=FLUSH_SVD_N[0], hi=FLUSH_SVD_N[1]))
    before = launch_counts()
    reports, served = [], []
    for _ in range(2):
        srv = build_server(spec, clock=VirtualClock(), device=dev)
        check(srv.executor.device.type == "cuda",
              f"build_server(device=cuda) runs on {srv.executor.device}")
        fe = TrafficFrontend(srv, tenants, slo_ms=CONTROL_SLO_MS[1],
                             admission="shed", model=CostModel(), seed=SEED)
        submitted, submit = [], srv.submit

        def recording_submit(mat, op="eigh", sweeps=None, _s=submit,
                             _log=submitted):
            ticket = _s(mat, op=op, sweeps=sweeps)
            _log.append((op, mat, ticket))
            return ticket

        srv.submit = recording_submit
        reports.append(fe.run(stream, pace=False))
        served.append(submitted)
    moved = {k: v - before[k] for k, v in launch_counts().items()}
    a, b = reports
    check(a.digest == b.digest and a.outcomes == b.outcomes,
          "virtual-clock runs on the card differ")
    check(a.served > 0 and a.served + a.shed + a.throttled + a.degraded
          == a.requests, f"virtual run: {a.to_json()}")
    worst = {}
    for op, mat, ticket in served[0]:
        res = ticket.result()
        got = res.S if op == "svd" else res.eigenvalues
        err = rel_frobenius(got, reference_values(op, mat))
        worst[op] = max(worst.get(op, 0.0), err)
        check(np.isfinite(got).all() and err <= budget[
            "svd" if op == "svd" else "eigh"],
              f"virtual run {op} {mat.shape}: rel-Frobenius {err:.3e}")
    for name in FLUSH_KERNELS:
        check(moved[name] > 0, f"virtual runs: {name} never launched")
    # an apply_plan swap mid-stream against a cold server on the plan
    mats = [materialize(x, seed=SEED) for x in stream[:CONTROL_SWAP_N]
            if x.op == "eigh"]
    plan = ServingPlan(mode="pow2", T=FLUSH_T, max_batch=FLUSH_REQUESTS // 2,
                       max_inflight=2)
    hot = build_server(spec, device=dev)
    early = [hot.submit(m) for m in mats[:FLUSH_REQUESTS // 2 - 1]]
    hot.apply_plan(plan)
    check(hot.executor.device.type == "cuda",
          f"apply_plan moved the server to {hot.executor.device}")
    rest = hot.solve_many(mats[len(early):])
    cold = server_for_plan(plan, spec.config(), device=dev).solve_many(mats)
    for g, w in zip([t.result() for t in early] + rest, cold):
        for f in dataclasses.fields(w):
            check(np.array_equal(getattr(g, f.name), getattr(w, f.name)),
                  f"hot-swapped eigh.{f.name} differs bitwise from the cold "
                  f"server on the plan")
    out["virtual"] = {"requests": a.requests, "served": a.served,
                      "shed": a.shed, "digest": a.digest, "worst": worst,
                      "swap_requests": len(mats),
                      "launches": {k: v for k, v in moved.items() if v}}
    log(f"control[virtual]: {a.requests} requests, {a.served} served, "
        f"{a.shed} shed, digest {a.digest[:16]} twice; worst rel-Frobenius "
        f"vs float64 numpy {json.dumps(worst)}; hot swap of {len(mats)} "
        f"eigh requests bitwise the cold server; launches "
        f"{json.dumps(out['virtual']['launches'])}")

    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"control: launches {json.dumps(out['launches'])}; phase "
        f"{out['wall_s']:.1f} s")
    shutil.rmtree(tmp)  # the specs, traces and profiles, checked above
    return out


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
    for source, name in (("flash_attention_mma.cu", "flash_attention_mma"),
                         ("flash_attention_tf32.cu",
                          "flash_attention_tf32x3")):
        regs = ptxas_report(build_log, source)
        log(f"{name} ptxas by head-dim padding: {json.dumps(regs)}")
        rows[name]["ptxas"] = regs.get(FA_D)
        if name == "flash_attention_mma":  # the D 20 prefill's instance
            rows[name]["d20_ptxas"] = regs.get(16 * -(-FA_D20 // 16))
    # the GEMM-tile instances; the rows keep the ones the main path runs
    for source, name, main_instance in (
            ("mm_engine.cu", "mm_engine_matmul", "mm fp32 64x32x32 a:k b:mn"),
            ("covariance.cu", "covariance", "gram fp32 128x128x32")):
        regs = ptxas_report(build_log, source, key=gemm_instance)
        log(f"{name} ptxas by instance: {json.dumps(regs)}")
        rows[name]["ptxas"] = regs.get(main_instance)
        if name == "mm_engine_matmul":  # the strided projection's instance
            rows[name]["strided_ptxas"] = regs.get(main_instance + " strided")
    regs = ptxas_report(build_log, "mamba_scan.cu", key=scan_instance)
    log(f"mamba_scan ptxas by instance: {json.dumps(regs)}")
    rows["mamba_scan"]["ptxas"] = regs.get("fp32 wide")
    rows["mamba_scan"]["bf16_ptxas"] = regs.get("bf16 wide")
    regs = ptxas_report(build_log, "jacobi_sweep.cu", key=sweep_kernel)
    log(f"jacobi_sweep ptxas by kernel: {json.dumps(regs)}")
    for name in ("jacobi_sweep", "jacobi_sweep_smem"):
        rows[name]["ptxas"] = regs.get(name)
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
    rows["jacobi_sweep"].update(
        fit_wall_s=wall, fit_idle_share=1 - busy / wall,
        fit_idle_share_profiled=main_run["profile"]["idle_share"])
    flush = batched_flush(dev)
    ops_run = ops_phase(dev, rows)
    serve = serve_phase(dev, flush["requests"])
    control = control_phase(dev)

    record = []
    for k in KERNELS:
        row = rows[k.name]
        if k.name in PATH_KERNELS:
            row["launches"] = main_run["launches"][k.name]
            row["launches_batched_flush"] = flush["launches"][k.name]
        elif k.name in FLUSH_KERNELS:
            row["launches"] = flush["launches"][k.name]
            row["path"] = "batched flush"
        else:
            row["launches"] = ops_run["launches"][k.name]
            row["path"] = "ops phase"
        row["launches_serve"] = serve["launches"][k.name]
        row["launches_control"] = control["launches"][k.name]
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
