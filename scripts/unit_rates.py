#!/usr/bin/env python
"""Issue rates of the instructions the selective scan's bf16-state
instance (``csrc/mamba_scan.cu``) spends its time on, on one CUDA card:

    python scripts/unit_rates.py

Builds a small CUDA program with ``nvcc`` (into ``build/unit_rates/``,
``sm_90a``) and runs it.  Each case is a kernel whose threads run
``CHAINS`` independent dependency chains of one instruction (or of a short
fixed sequence), written as inline PTX so that nothing is merged or
removed, over enough warps to hide the latency.  Each block reads
``clock64()`` around its loop; the rate is the thread-instructions a case
issued on an SM over the cycles its longest block took there.  Prints the
card (``nvidia-smi``'s name and power limit), then one JSON line:
``{case: {"per_sm_clock": thread-instructions an SM a clock, "ms": the
launch's CUDA-event time}}``.  Mixed cases (``ex2+cvt_bf16x2``,
``hmul2+ffma``) count every instruction of the mix: a mix whose rate is
its parts' slower one shares no unit; one at the slower one's rate over
two shares it.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "unit_rates"
CHAINS = 8
ITERS = 4096
BLOCKS_PER_SM, THREADS = 4, 256

# each case: the PTX of one step of one chain on the 32-bit register %0
# (a .b32 or .f32 value as the case declares; "{...}" may hold scratch
# registers), and how many counted instructions one step is
CASES = {
    "ffma": ("f", "fma.rn.f32 %0, %0, 0f3F7FF000, 0f3C000000;", 1),
    "ex2": ("f", "ex2.approx.ftz.f32 %0, %0;", 1),
    "cvt_bf16x2": ("r", "{ .reg .f32 t; .reg .b32 o; mov.b32 t, %0; "
                        "cvt.rn.bf16x2.f32 o, t, t; mov.b32 %0, o; }", 1),
    "cvt_bf16": ("r", "{ .reg .f32 t; .reg .b16 h; mov.b32 t, %0; "
                      "cvt.rn.bf16.f32 h, t; cvt.f32.bf16 t, h; "
                      "mov.b32 %0, t; }", 1),
    "hmul2_bf16": ("r", "{ .reg .b32 o; mul.rn.bf16x2 o, %0, %1; "
                        "mov.b32 %0, o; }", 1),
    "hadd2_bf16": ("r", "{ .reg .b32 o; add.rn.bf16x2 o, %0, %1; "
                        "mov.b32 %0, o; }", 1),
    "prmt": ("r", "prmt.b32 %0, %0, %1, 0x5173;", 1),
    "lop3": ("r", "lop3.b32 %0, %0, %1, 0x5A5A5A5A, 0x96;", 1),
    "expf": ("f", None, 1),
    "ex2+cvt_bf16x2": ("r", "{ .reg .f32 t; .reg .b32 o; mov.b32 t, %0; "
                            "ex2.approx.ftz.f32 t, t; "
                            "cvt.rn.bf16x2.f32 o, t, t; mov.b32 %0, o; }",
                       2),
    "hmul2+ffma": ("r", "{ .reg .b32 o; .reg .f32 t; "
                        "mul.rn.bf16x2 o, %0, %1; mov.b32 t, o; "
                        "fma.rn.f32 t, t, 0f3F7FF000, 0f3C000000; "
                        "mov.b32 %0, t; }", 2),
}
# the second operand of the "r" cases: bf16 1.0078125 in both halves
K = "0x3F813F81u"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CASE>
__device__ __forceinline__ void step(uint32_t& v);

%(steps)s

template <int CASE>
__global__ void rate_kernel(uint32_t* sink, long long* spans, int iters) {
  uint32_t v[%(chains)d];
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c)
    v[c] = __float_as_uint(0.5f + 1e-3f * (threadIdx.x + c));
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < %(chains)d; ++c) step<CASE>(v[c]);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) acc ^= v[c];
  if (acc == 0x12345678u) sink[0] = acc;  // keeps every chain live
  if (threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
    spans[2 * blockIdx.x] = t1 - t0;
    spans[2 * blockIdx.x + 1] = sm;
  }
}

extern "C" float run_case(int which, int blocks, int threads, int iters,
                          long long* spans_host) {
  uint32_t* sink;
  long long* spans;
  cudaMalloc(&sink, 4);
  cudaMalloc(&spans, 16 * blocks);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(a);
    switch (which) {
%(switch)s
    }
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  cudaMemcpy(spans_host, spans, 16 * blocks, cudaMemcpyDeviceToHost);
  const int status = static_cast<int>(cudaGetLastError());
  cudaFree(sink);
  cudaFree(spans);
  return status ? -static_cast<float>(status) : ms;
}
"""


def step_source(i: int, kind: str, ptx) -> str:
    if ptx is None:  # expf: libdevice's, the scan's exponential
        body = ("float f = __uint_as_float(v); "
                "v = __float_as_uint(expf(f) * -0.5f);")
    elif kind == "f":
        body = ("float f = __uint_as_float(v); "
                f"asm volatile(\"{ptx}\" : \"+f\"(f)); "
                "v = __float_as_uint(f);")
    else:
        body = f"asm volatile(\"{ptx}\" : \"+r\"(v) : \"r\"({K}));"
    return (f"template <> __device__ __forceinline__ void step<{i}>"
            f"(uint32_t& v) {{ {body} }}")


def build() -> ctypes.CDLL:
    names = list(CASES)
    steps = "\n".join(step_source(i, kind, ptx)
                      for i, (kind, ptx, _) in enumerate(CASES.values()))
    switch = "\n".join(
        f"      case {i}: rate_kernel<{i}><<<blocks, threads>>>(sink, spans, "
        f"iters); break;" for i in range(len(names)))
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "unit_rates.cu"
    src.write_text(SOURCE % {"steps": steps, "chains": CHAINS,
                             "switch": switch})
    lib = OUT / "libunit_rates.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.run_case.restype = ctypes.c_float
    dll.run_case.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return dll


def main() -> int:
    import torch  # the card's properties only
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    dll = build()
    out = {}
    for i, (name, (_, _, per_step)) in enumerate(CASES.items()):
        spans = (ctypes.c_longlong * (2 * blocks))()
        ms = dll.run_case(i, blocks, THREADS, ITERS, spans)
        if ms < 0:
            raise RuntimeError(f"{name}: CUDA error {-ms:g}")
        longest = {}
        for b in range(blocks):
            sm = spans[2 * b + 1]
            longest[sm] = max(longest.get(sm, 0), spans[2 * b])
        per_sm = {sm: 0 for sm in longest}
        for b in range(blocks):
            per_sm[spans[2 * b + 1]] += THREADS * ITERS * CHAINS * per_step
        rate = sum(per_sm[sm] / longest[sm] for sm in longest) / len(longest)
        out[name] = {"per_sm_clock": rate, "ms": ms}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
