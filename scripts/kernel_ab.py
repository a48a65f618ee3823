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
    Then ``chip_smoke.py``'s phase-18 shape, batch 4 x 4096 x 8192, N 16,
    fp32 operands, with ``return_state``: the fp32 state (``fp32_b4``) and
    the bf16 state (``bf16_state_b4``: its final state bitwise the plain
    bf16-state version's or not, y's relative Frobenius distance from
    it).  Then the SASS of the two fp32-operand wide instances
    (``scan_sass``: ``sass_loop``, the chunk loop's opcodes, each count
    also a (t, j), a step of one of a thread's G = 4 states).

``jacobi``
    One Jacobi sweep through ``core.jacobi._sweep_scan`` with the fused
    ``cuda`` backend (the Rutishauser angle, the parallel pivot's n - 1
    rounds), whatever number of calls the tree makes for it: at the main
    path's n = 784, and on the batched flush's 32 x 256 x 256 and
    32 x 128 x 128 buckets.  Milliseconds a sweep, whether the result
    is bitwise the plain version's round-by-round loop, and the grid
    barriers a grid-kernel launch took (``JACOBI_SWEEP.barriers``; null
    for a tree without that count or a sweep off the grid kernel).  Then
    ``fit_transform`` as for ``gemm``, with its barriers a launch.

``serve``
    ``chip_smoke.py``'s serve phase (this checkout's script, the tree's
    ``repro_torch``): its phase 4 makes the 96 seeded requests, then
    ``PCAServer`` serves them at ``max_inflight`` 1 and 3, a cold and a
    warm pass each, under the phase's checks (no host sync in
    ``executor.submit``, results in budget, passes bitwise equal), and a
    profiled pipelined pass.  Each pass's wall seconds, requests/s, p50
    and p99 latency, and the mean dispatch, overlap and wait a flush; the
    profiled pass's device idle share.  The phases' own log goes to
    stderr.

``control``
    ``chip_smoke.py``'s phase-7 open loop (this checkout's script and
    constants, the tree's ``repro_torch``): ``serve_pca.main`` with a spec
    on phase 7's plan, 256 Poisson eigh arrivals over dims 96..256 from
    two tenants (0.9/0.1) through WFQ and shedding under a 250 ms SLO, at
    a fixed ``CONTROL_AB_RATE`` arrivals/s so that every tree and run
    sees the same offered load.  ``CONTROL_AB_REPEATS`` rounds, each of
    three runs in turn: the controller on, off, and on with its swaps
    held off (``hysteresis`` 0.99, so it ticks and searches but never
    swaps).  For each run the frontend's served/s, goodput, shed
    fraction and each tenant's p99, the controller's ticks and swaps, and
    the feeder's ingest lag: for each arrival, when its ingest returned
    less its paced time (the first arrival's plus the stream's offset),
    on the server's clock -- what a feeder that waits for the server
    adds to every latency.  Then each variant's mean, min and max.

``small``
    The two small wrapper calls at the ops phase's shapes: the DLE scan of
    a seeded symmetric 784 x 784 matrix at tile 128 (``dle.dle_scan`` and
    the op a caller waits on, ``ops.dle_find_pivot``) and the CORDIC unit
    on one round's k = 392 pivots (``cordic.cordic_rotation_params``, the
    op ``ops.cordic_rotate``, and at k = 2^20).  For each: milliseconds
    between back-to-back calls (CUDA events, ``SMALL_REPS`` calls), the
    device time a call and the kernels a call that ``torch.profiler``
    traces, the launch count a call, the host's enqueue time a call
    (``time.perf_counter_ns`` over ``HOST_REPS`` calls), and whether the
    result is bitwise its plain version's.  Then the host split of one
    call: each step of the tree's wrapper timed alone over ``HOST_REPS``
    repetitions (the checks, each allocation, the device context, the
    stream query, ``build.library()``, the ctypes call), and the grid the
    profiler traced for the DLE kernel.  Then the CORDIC kernel's
    critical path read from its SASS (``cuobjdump -sass`` of the tree's
    library; ``sass_chain``), in instructions and in cycles at
    ``SASS_LATENCY``, and the SM clock ``nvidia-smi`` reads while the card
    is busy.
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
SCAN_B4 = 4                    # chip_smoke.py's phase 18 (LM_BATCH)
# the scan kernel's steps a chunk x states a thread (csrc/mamba_scan.cu's
# TCH x G): the chunk loop's body is unrolled over both
SCAN_STEP_STATES = 32 * 4
SCAN_INSTANCES = {"fp32_state": "scan_kernelIfLb1ELb0E",
                  "bf16_state": "scan_kernelIfLb1ELb1E"}
DLE_TILE = 128                 # chip_smoke.py's OPS_TILE
CORDIC_K, CORDIC_RATE_K = N // 2, 1 << 20  # one round's pivots at n = 784
SMALL_REPS, HOST_REPS, TRACE_REPS = 2000, 10000, 100
# cycles from one instruction's dispatch to a dependent one's, by SASS opcode
# (the first dot-separated word): assumed, not measured -- the fixed-latency
# integer and float pipes at 4 (Volta-to-Hopper microbenchmarks report 4-6),
# the conversion and transcendental unit at 16; loads and stores at 0, so
# the chain counts the arithmetic between the loads and the stores
SASS_LATENCY = {"F2I": 16, "I2F": 16, "I2FP": 16, "F2IP": 16, "MUFU": 16,
                "LDG": 0, "LDC": 0, "ULDC": 0, "STG": 0, "S2R": 0,
                "S2UR": 0}
SASS_DEFAULT_LATENCY = 4


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


def serve(tree: str) -> dict:
    import torch
    import repro_torch  # noqa: F401  the tree's, before chip_smoke puts
    # this checkout's src on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.log = lambda msg: print(msg, file=sys.stderr, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = chip_smoke.batched_flush(dev)
    out = chip_smoke.serve_phase(dev, flush["requests"])
    return {"tree": tree, "runs": out["runs"],
            "idle_share_pipelined": out["profile"]["idle_share"],
            "profiled_wall_s": out["profile"]["wall_s"]}


CONTROL_AB_RATE = 420.0    # arrivals/s: phase 7's 1.5x closed eigh rate
CONTROL_AB_REPEATS = 3
CONTROL_AB_VARIANTS = {"on": {"enabled": True}, "off": {"enabled": False},
                       "on_no_swap": {"enabled": True, "hysteresis": 0.99}}


def control(tree: str) -> dict:
    import numpy as np
    import torch
    import repro_torch  # noqa: F401  the tree's, before chip_smoke puts
    # this checkout's src on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.serving import (ControllerSpec, ExecutionSpec, ObsSpec,
                                     SchedulingSpec, ServerSpec, frontend)
    chip_smoke.log = lambda msg: print(msg, file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ingested = []
    ingest = frontend.TrafficFrontend._ingest

    def timed_ingest(self, a, now, residual_s):
        entry = ingest(self, a, now, residual_s)
        ingested.append((a.t, now, self.server.clock()))
        return entry

    frontend.TrafficFrontend._ingest = timed_ingest
    tmp = pathlib.Path(__file__).resolve().parents[1] / "build" / "ab_control"
    tmp.mkdir(parents=True, exist_ok=True)
    runs = []
    for rep in range(CONTROL_AB_REPEATS):
        for variant, ctrl in CONTROL_AB_VARIANTS.items():
            spec = ServerSpec(
                scheduling=SchedulingSpec(
                    mode="pow2", T=chip_smoke.FLUSH_T,
                    max_batch=chip_smoke.FLUSH_REQUESTS, max_inflight=3),
                execution=ExecutionSpec(backend=chip_smoke.BACKEND,
                                        fused=True,
                                        sweeps=chip_smoke.SWEEPS),
                obs=ObsSpec(slo_ms=chip_smoke.CONTROL_SLO_MS[1]),
                controller=ControllerSpec(**ctrl))
            path = tmp / f"{variant}.json"
            spec.save(path)
            dims = chip_smoke.CONTROL_DIMS
            ingested.clear()
            doc = chip_smoke.run_cli([
                "--spec", path, "--arrivals", "poisson", "--rate",
                f"{CONTROL_AB_RATE:.6f}", "--requests",
                chip_smoke.OPEN_REQUESTS, "--op", "eigh", "--dims",
                f"{dims[0]},{dims[-1]}", "--tenants", "whale:0.9,mouse:0.1",
                "--scheduler", "wfq", "--admission", "shed"])
            t_first, now_first, _ = ingested[0]
            lags = np.array([done - (now_first + t - t_first)
                             for t, _, done in ingested]) * 1e3
            fe, c = doc["frontend"], doc["controller"]
            runs.append({
                "variant": variant, "round": rep,
                "served_rps": fe["served_rps"],
                "goodput_rps": fe["goodput_rps"],
                "shed_frac": fe["shed_frac"], "served": fe["served"],
                "duration_s": fe["duration_s"],
                "p99_ms": {t: r["latency_p99_ms"]
                           for t, r in fe["per_tenant"].items()},
                "ticks": c and c["ticks"], "swaps": c and c["swaps"],
                "swap_plans": c and [s["plan"] for s in c["swap_log"]],
                "ingest_lag_ms": {"p50": float(np.percentile(lags, 50)),
                                  "p99": float(np.percentile(lags, 99)),
                                  "max": float(lags.max())}})
            print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    summary = {}
    for variant in CONTROL_AB_VARIANTS:
        rows = [r for r in runs if r["variant"] == variant]
        summary[variant] = {
            key: {"mean": float(np.mean(vals)), "min": float(min(vals)),
                  "max": float(max(vals))}
            for key, vals in (
                ("served_rps", [r["served_rps"] for r in rows]),
                ("goodput_rps", [r["goodput_rps"] for r in rows]),
                ("shed_frac", [r["shed_frac"] for r in rows]),
                ("ingest_lag_max_ms",
                 [r["ingest_lag_ms"]["max"] for r in rows]))}
    return {"tree": tree, "rate_rps": CONTROL_AB_RATE, "summary": summary,
            "runs": runs}


def jacobi(tree: str) -> dict:
    import torch
    from repro_torch.core import jacobi as jac
    from repro_torch.core.cordic import ANGLE_MODES
    from repro_torch.kernels import fused, launch_counts, ref

    def counts():  # (grid barriers, grid launches); no barrier count before
        return (getattr(fused.JACOBI_SWEEP, "barriers", None),
                launch_counts()["jacobi_sweep"])

    def per_launch(before):
        (b0, l0), (b1, l1) = before, counts()
        return None if b0 is None or l1 == l0 else (b1 - b0) / (l1 - l0)

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
        before = counts()
        got = sweep()
        barriers = per_launch(before)
        want = (C, V)
        for pairs in rounds:
            want = ref.jacobi_sweep_step(*want, pairs)
        out[name] = {
            "bitwise": all(bool(torch.equal(a, b))
                           for a, b in zip(got, want)),
            "ms": time_ms(sweep, reps), "barriers_a_launch": barriers}
    before = counts()
    out["fit_wall_s"] = fit_wall_s(dev)
    out["fit_barriers_a_launch"] = per_launch(before)
    return out


def scan(tree: str) -> dict:
    import torch
    from repro_torch.kernels import build, launch_counts, ref
    from repro_torch.kernels import mamba_scan as ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(d, dtype, batch=1):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        u, b, c = randn(batch, SCAN_L, d), randn(batch, SCAN_L, SCAN_N), \
            randn(batch, SCAN_L, SCAN_N)
        dt = torch.rand(batch, SCAN_L, d, generator=gen, device=dev) \
            * 0.19 + 0.01
        a = -(torch.rand(d, SCAN_N, generator=gen, device=dev) * 1.5 + 0.5)
        return (u.to(dtype), dt.to(dtype), a, b.to(dtype), c.to(dtype),
                randn(d))

    def launched_by(fn):
        before = launch_counts()
        got = fn()
        return got, [k for k, c in launch_counts().items()
                     if c != before[k]]

    cases = {"fp32": (SCAN_D, torch.float32, 20),
             "bf16": (SCAN_D, torch.bfloat16, 20),
             "fp32_d2048": (SCAN_D // 4, torch.float32, 50)}
    out = {"tree": tree}
    for name, (d, dtype, reps) in cases.items():
        args = inputs(d, dtype)
        got, launched = launched_by(lambda: ms.mamba_scan(*args).float())
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
    # phase 18's shape: both states on the same fp32 operands
    args = inputs(SCAN_D, torch.float32, SCAN_B4)
    for name, kw in (("fp32_b4", {}),
                     ("bf16_state_b4", {"state_dtype": torch.bfloat16})):
        (y, state), launched = launched_by(
            lambda: ms.mamba_scan(*args, return_state=True, **kw))
        row = {"ms": time_ms(lambda: ms.mamba_scan(
            *args, return_state=True, **kw), 10), "kernel": launched}
        if kw:  # the plain bf16-state scan: 4096 steps, about 1.5 s
            want_y, want_state = ref.mamba_scan(*args, return_state=True,
                                                **kw)
            row.update(state_bitwise=bool(torch.equal(state, want_state)),
                       state_mismatches=int((state != want_state).sum()),
                       y_rel_frobenius=rel_frobenius(y, want_y))
            del want_y, want_state
        out[name] = row
        del y, state
    del args
    lib = str(build.build_dir() / build.LIB_NAME)
    out["scan_sass"] = {name: sass_loop(lib, kernel, SCAN_STEP_STATES)
                        for name, kernel in SCAN_INSTANCES.items()}
    return out


def traced(fn, reps: int) -> dict:
    """Kernels ``torch.profiler`` traced while ``reps`` calls of ``fn`` ran:
    device milliseconds a call, kernels a call, their names and the grid
    of each kernel (from the chrome trace)."""
    import os
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    scratch = pathlib.Path(__file__).resolve().parents[1] / "build"
    scratch.mkdir(exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=scratch)
    os.close(fd)
    prof.export_chrome_trace(path)
    trace = json.loads(pathlib.Path(path).read_text())
    os.unlink(path)
    grids = {e["name"][:60]: e.get("args", {}).get("grid")
             for e in trace.get("traceEvents", [])
             if e.get("cat") == "kernel"}
    return {"device_ms": sum(e.device_time_total for e in kernels) / 1e3
            / reps, "kernels_a_call": len(kernels) / reps,
            "names": sorted({e.name[:60] for e in kernels}), "grids": grids}


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds a call of ``fn`` (no synchronize inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def sass(lib_path: str, kernel: str) -> list:
    """(address, predicate or None, opcode with its modifiers, operands)
    of each instruction of ``kernel`` in the library's SASS
    (``cuobjdump -sass``)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, here = [], False
    for line in text.splitlines():
        if "Function :" in line:
            here = kernel in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z0-9_.]+)\s*([^;]*);", line)
        if here and m:
            out.append((int(m.group(1), 16), m.group(2), m.group(3),
                        m.group(4)))
    return out


def sass_chain(lib_path: str, kernel: str) -> dict:
    """The longest chain of dependent instructions in ``kernel``'s SASS
    (straight-line code: the CORDIC kernel's stages are unrolled), each
    register and predicate ready ``SASS_LATENCY`` cycles after the
    instruction that writes it is dispatched; the first operand of an
    instruction that writes is its destination."""
    import re
    ready, longest, count, n_instr = {}, 0, {}, 0
    for _, pred, op, args in sass(lib_path, kernel):
        base = op.split(".")[0]
        if base in ("NOP", "EXIT", "BRA", "RET"):
            continue
        n_instr += 1
        regs = [re.findall(r"\b(U?R\d+|U?P\d)\b", a)
                for a in args.split(",")]
        writes = base not in ("STG", "ST", "STS", "RED", "BAR", "MEMBAR")
        dst = regs[0] if writes and regs else []
        srcs = [r for a in (regs[1:] if writes else regs) for r in a]
        if pred:
            srcs.append(pred.strip().lstrip("@!"))
        start = max((ready.get(r, (0, 0))[0] for r in srcs), default=0)
        depth = max((ready.get(r, (0, 0))[1] for r in srcs), default=0)
        lat = SASS_LATENCY.get(base, SASS_DEFAULT_LATENCY)
        for r in dst:
            ready[r] = (start + lat, depth + (1 if lat else 0))
        longest = max(longest, start + lat)
        count[base] = count.get(base, 0) + 1
    depth = max((d for _, d in ready.values()), default=0)
    return {"instructions": n_instr, "chain_cycles": longest,
            "chain_instructions": depth, "opcodes": count}


def sass_loop(lib_path: str, kernel: str, per: int) -> dict:
    """Opcodes (with their modifiers) of the longest loop in ``kernel``'s
    SASS -- the instructions from a backward branch's target to the
    branch (the whole function if no branch is read) -- and each count
    over ``per`` (the loop body's unrolled steps)."""
    import re
    instrs = sass(lib_path, kernel)
    loop = (0, -1)
    for addr, _, op, args in instrs:
        target = re.match(r"\s*0x([0-9a-f]+)", args)
        if op.startswith("BRA") and target:
            start = int(target.group(1), 16)
            if start < addr and addr - start > loop[1] - loop[0]:
                loop = (start, addr)
    if loop[1] < 0:  # no backward branch read: the whole function
        loop = (0, instrs[-1][0] if instrs else -1)
    count = {}
    for addr, _, op, _ in instrs:
        if loop[0] <= addr <= loop[1] and op != "NOP":
            count[op] = count.get(op, 0) + 1
    ranked = sorted(count.items(), key=lambda kv: -kv[1])
    return {"loop": [hex(a) for a in loop],
            "instructions": sum(count.values()),
            "per_step_state": sum(count.values()) / per,
            "opcodes": dict(ranked),
            "opcodes_per_step_state": {k: v / per for k, v in ranked}}


def busy_sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reads while the card runs a queue of
    fp32 products (about a second of work)."""
    import torch
    a = torch.randn(8192, 8192, device="cuda")
    torch.mm(a, a)
    torch.cuda.synchronize()
    for _ in range(20):
        torch.mm(a, a)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return [float(v) for v in out.split(",")]


def parent_split(c, piv) -> dict:
    """Each step of the DLE and CORDIC wrappers that keep per-call
    scratch (two launches a DLE scan), timed alone: the checks as they
    are written there, each allocation, ``build.library()``, the device
    context, the stream query and the ctypes call."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.launch import require, require_cuda, stream
    dev = c.device
    n, tile = c.shape[0], DLE_TILE
    grid_n = -(-n // tile)

    def dle_checks():
        what = "dle_scan"
        require_cuda(what, c)
        require(c.ndim == 2 and c.shape[0] == c.shape[1], what,
                f"expected (n, n), got {tuple(c.shape)}")
        require(c.dtype == torch.float32, what, f"c must be float32, got "
                f"{c.dtype}")
        require(c.is_contiguous(), what, "c must be contiguous")
        require(0 < n and n * n < 2 ** 31, what, f"n = {n} is out of range")
        require(0 < tile and tile * tile < 2 ** 31, what,
                f"tile = {tile} is out of range")
        require(grid_n <= 65535, what, f"{grid_n} tiles a side exceed the "
                f"grid")

    apq, app, aqq = piv
    k = apq.shape[0]

    def cordic_checks():
        what = "cordic_rotation_params"
        all(t.device.type == "cpu" for t in piv)
        require_cuda(what, apq, app, aqq)
        require(apq.ndim == 1 and app.shape == apq.shape
                and aqq.shape == apq.shape, what,
                f"expected three (k,) tensors, got {tuple(apq.shape)}, "
                f"{tuple(app.shape)}, {tuple(aqq.shape)}")
        require(all(t.dtype == torch.float32 for t in piv), what,
                "apq, app and aqq must be float32")
        require(all(t.is_contiguous() for t in piv), what,
                "apq, app and aqq must be contiguous")
        require(k < 2 ** 31, what, f"k = {k} exceeds the launch grid")

    tv = torch.empty(grid_n * grid_n, dtype=torch.float32, device=dev)
    ti = torch.empty(grid_n * grid_n, dtype=torch.int32, device=dev)
    val = torch.empty((), dtype=torch.float32, device=dev)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    out3 = [torch.empty_like(apq) for _ in range(3)]
    lib = build.library()
    s = stream(dev)

    def context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "dle_checks": dle_checks,
        "dle_empty_scratch_f32": lambda: torch.empty(
            grid_n * grid_n, dtype=torch.float32, device=dev),
        "dle_empty_scratch_i32": lambda: torch.empty(
            grid_n * grid_n, dtype=torch.int32, device=dev),
        "dle_empty_0d_f32": lambda: torch.empty((), dtype=torch.float32,
                                                device=dev),
        "dle_empty_0d_i32": lambda: torch.empty((), dtype=torch.int32,
                                                device=dev),
        "build_library": build.library,
        "device_context": context,
        "stream_query": lambda: stream(dev),
        "data_ptr_x5": lambda: (c.data_ptr(), tv.data_ptr(), ti.data_ptr(),
                                val.data_ptr(), idx.data_ptr()),
        "dle_ctypes_call": lambda: lib.repro_dle_scan(
            c.data_ptr(), tv.data_ptr(), ti.data_ptr(), val.data_ptr(),
            idx.data_ptr(), n, tile, s),
        "cordic_checks": cordic_checks,
        "cordic_empty_like_x3": lambda: [torch.empty_like(apq)
                                         for _ in range(3)],
        "cordic_ctypes_call": lambda: lib.repro_cordic(
            apq.data_ptr(), app.data_ptr(), aqq.data_ptr(),
            out3[0].data_ptr(), out3[1].data_ptr(), out3[2].data_ptr(), k,
            s),
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def lean_split(c, piv) -> dict:
    """The steps of the wrappers with one output allocation and scratch
    kept per stream (one DLE launch a call), timed alone."""
    import torch
    from repro_torch.kernels import build, dle
    from repro_torch.kernels.launch import raw_stream
    dev = c.get_device()
    n = c.shape[0]
    apq, app, aqq = piv
    k = apq.shape[0]
    out = torch.empty(5, dtype=torch.int64, device=c.device)
    out3 = torch.empty((3, k), dtype=torch.float32, device=c.device)
    scratch = dle._scratch(dev, raw_stream(dev), n, DLE_TILE)
    lib = build.library()
    s = raw_stream(dev)
    f = out.view(torch.float32)
    steps = {
        "dle_empty_out": lambda: torch.empty(5, dtype=torch.int64,
                                             device=c.device),
        "dle_scratch_lookup": lambda: dle._scratch(dev, s, n, DLE_TILE),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: raw_stream(dev),
        "build_library": build.library,
        "dle_ctypes_call": lambda: lib.repro_dle_pivot(
            c.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, DLE_TILE,
            4, s),
        "dle_pivot_views": lambda: (out[0], out[1], f[4], f[5], f[6]),
        "cordic_empty_out": lambda: torch.empty((3, k), dtype=torch.float32,
                                                device=c.device),
        "cordic_ctypes_call": lambda: lib.repro_cordic(
            apq.data_ptr(), app.data_ptr(), aqq.data_ptr(),
            out3.data_ptr(), k, s),
        "cordic_views": lambda: out3.unbind(),
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def small(tree: str) -> dict:
    import torch
    from repro_torch.core.jacobi import round_robin_rounds
    from repro_torch.kernels import build, cordic, dle, launch_counts, ops
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(N, N, generator=gen, device=dev)
    gram = (g @ g.mT / N).contiguous()
    pairs = torch.as_tensor(round_robin_rounds(N)[N // 3], device=dev).long()
    p, q = pairs[:, 0], pairs[:, 1]
    piv = (gram[p, q].contiguous(), gram[p, p].contiguous(),
           gram[q, q].contiguous())
    scale = 10.0 ** torch.randint(-3, 4, (3, CORDIC_RATE_K), generator=gen,
                                  device=dev)
    rate = tuple(torch.randn(3, CORDIC_RATE_K, generator=gen, device=dev)
                 * scale)
    want_scan = ref.dle_scan(gram, DLE_TILE)
    cases = {
        "dle_scan": (lambda: dle.dle_scan(gram, DLE_TILE),
                     lambda got: (float(got[0]), int(got[1])) == (
                         float(want_scan[0]), int(want_scan[1]))),
        "dle_find_pivot": (
            lambda: ops.dle_find_pivot(gram, DLE_TILE),
            lambda got: int(got.p) * N + int(got.q) == int(want_scan[1])
            and float(got.apq.abs()) == float(want_scan[0])),
        "cordic": (lambda: cordic.cordic_rotation_params(*piv),
                   lambda got: all(torch.equal(a, b) for a, b in zip(
                       got, ref.cordic_rotation_params_q29(*piv)))),
        "cordic_rotate": (lambda: ops.cordic_rotate(*piv),
                          lambda got: all(torch.equal(a, b) for a, b in zip(
                              got, ref.cordic_rotation_params_q29(*piv)))),
        "cordic_rate": (lambda: cordic.cordic_rotation_params(*rate),
                        lambda got: all(torch.equal(a, b) for a, b in zip(
                            got, ref.cordic_rotation_params_q29(*rate)))),
    }
    out = {"tree": tree}
    for name, (fn, ok) in cases.items():
        before = launch_counts()
        got = fn()
        moved = {k: c - before[k] for k, c in launch_counts().items()
                 if c != before[k]}
        row = {"launches": moved, "bitwise": bool(ok(got)),
               "ms": time_ms(fn, SMALL_REPS if name != "cordic_rate"
                             else 200)}
        row.update(traced(fn, TRACE_REPS))
        if name != "cordic_rate":  # there the device time bounds the host
            row["host_us"] = host_us(fn)
        out[name] = row
    split = lean_split if "repro_dle_pivot" in build.SIGNATURES \
        else parent_split
    out["host_split_us"] = split(gram, piv)
    lib = build.build_dir() / build.LIB_NAME
    out["cordic_sass"] = sass_chain(str(lib), "cordic_kernel")
    out["sm_clock_mhz_busy"], out["power_w_busy"] = busy_sm_clock_mhz()
    return out


CASES = {"attention": attention, "control": control, "gemm": gemm,
         "jacobi": jacobi, "scan": scan, "serve": serve, "small": small}


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
