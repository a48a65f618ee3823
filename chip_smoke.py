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
   d_inner 8192 and N 16 over 4096 steps (in fp32 and in bf16, each call
   also returning its final state, held to the plain version's); and
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

8. lm: the port's LM serving path and its PCA consumers at olmo-1b's
   full width (16 layers, d 2048, 16 heads x 128, d_ff 8192, vocab
   50304, bf16, random weights from the seed):
   ``repro_torch.launch.serve.main(["--arch", "olmo-1b", "--batch", "4",
   "--prompt-len", "4096", "--gen-len", "32"])`` on the card (its JSON
   line printed; the prefill launches ``flash_attention_mma`` once a
   layer and each of the 32 decode calls ``flash_attention_splitkv``
   once a layer, nothing else); on the same weights and prompt the
   prefill and 8 teacher-forced decode steps (the served tokens fed
   back) through the kernels and with attention on the flash op's
   ``torch`` backend: every layer's bf16 flash call held at the op, on
   the operands the model gave it (the prefill's 64 x 4096 queries over
   the 4128-slot cache with its zero tail, each decode step's one query
   over keys 0..pos), to the ops phase's bf16 contract (each value within
   one bf16 ulp + 2e-5 of the plain version's fp32 result), and the
   logits held to sqrt(2) x bf16's own noise (the plain bf16 run against
   the plain fp32 run of the same weights); then the same in fp32
   (prefill on ``flash_attention_tf32x3``, logits within n_layers x
   2e-5);
   the three PCA consumers on ``covariance`` and ``jacobi_sweep_smem``
   (launches counted): ``kv_compression.attention_error`` at ranks 32,
   64, 128 and ``suggest_rank`` on layer 0's K and V cache,
   ``tree_spectra`` and one ``compress_tree`` step on a seeded gradient
   tree of olmo-1b's MLP shapes, each held to its plain version, and
   every Gram and sweep call of that run replayed on the op's ``torch``
   backend (each Gram within the fp32 covariance budget 1e-5, each
   sweep bitwise); and one prefill and 8 decode steps
   under ``torch.profiler`` (the decode's busy share, device time a step
   against the wall, the two flash kernels' device time a call in the
   model).
9. ssm/hybrid: the ssm and hybrid families through the same serving
   path, one model after the other (each freed before the next, its peak
   device memory printed).  falcon-mamba-7b whole (64 mamba layers, d
   4096, d_inner 8192, N 16, vocab 65024, bf16):
   ``serve.main(["--arch", "falcon-mamba-7b", "--batch", "4",
   "--prompt-len", "4096", "--gen-len", "32"])``, its JSON line printed,
   ``mamba_scan`` launched once a layer by the prefill and never by a
   decode step; the served prefill's scan calls of layers 0, 31 and 63
   and every call of a 512-token prefill of the same weights held at the
   op (y and the final state within rtol = atol = 1e-4 of the plain
   version on the operands the model passed); one prefill and 8 decode
   steps profiled (the decode's busy share, the scan's device time a
   layer against its bound).  jamba-v0.1-52b cut to one period of its
   layer pattern (8 of 32 layers: 7 mamba, 1 GQA attention, 4 MoE layers
   of 16 experts top-2, 4 MLP layers, every width as published) through
   ``serve.generate`` at the same batch and lengths: 7 scans and one
   ``flash_attention_mma`` a prefill, one ``flash_attention_splitkv`` a
   decode step; the MoE's share of dropped assignments at prefill and
   at decode; on the same weights a prefill and 8 teacher-forced decode
   steps with every scan and bf16 flash call held at the op; one prefill
   and 8 decode steps profiled.
10. encdec/vlm: the encoder-decoder and vlm families through the same
   serving path, one model after the other (each freed before the next,
   its peak device memory printed), bf16.  whisper-small whole (12
   encoder and 12 decoder layers, d 768, 12 heads x 64, d_ff 3072,
   vocab 51865, 1500 frames) through ``serve.generate`` at B 32 x 64
   tokens over seeded frames, 128 generated: 12 encoder (non-causal,
   1500 x 1500), 12 self and 12 cross (non-causal, 64 x 1500)
   ``flash_attention_mma`` calls a prefill, 12 self and 12 cross
   split-KV calls a decode step, nothing else; on the same weights and
   inputs a prefill and 8 teacher-forced steps through the kernels and on
   plain attention, in bf16 with every flash call held at the op and in
   fp32 (prefill on ``flash_attention_tf32x3``; logits within 24 x
   2e-5); one prefill (the encoder profiled apart) and 8 decode steps
   profiled.  llava-next-34b cut in depth to 40 of its 60 layers (every
   width as published: d 7168, 56 query heads over 8 KV heads of 128,
   d_ff 20480, vocab 64000) at B 8 x (576 seeded patches + 1024 tokens),
   32 generated: one ``flash_attention_mma`` a layer a prefill, one
   split-KV a layer a step; on the same weights a prefill with layers 0,
   19 and 39's flash calls held at the op and 8 teacher-forced steps with
   every flash call held; one prefill and 8 decode steps profiled.
11. train: the port's training path at olmo-1b's full width and depth
   (bf16, remat on, random weights from the seed, the synthetic token
   pipeline), every run under deterministic kernels:
   ``repro_torch.launch.train.main(["--arch", "olmo-1b", "--steps", "8",
   "--global-batch", "4", "--seq-len", "4096", "--lr", "3e-3"])`` on the
   card: every loss finite, the last below the first, exactly 16
   ``flash_attention_mma`` launches a step forward and 16 in the remat
   recompute and nothing else; its step time (the watchdog's, from the
   step's start to the loss read back, a synchronize), tokens/s, model
   FLOP/s (``accounting.model_flops``) over the bf16 peak and peak memory
   printed; 4 steps at ``--compress-grads 4 --moments int8`` (losses
   finite; one ``covariance`` and 8 ``jacobi_sweep_smem`` launches a
   compressed parameter a step); ``--preempt-at 4 --ckpt-dir
   build/train_ckpt`` and a resume to step 8, whose losses must equal the
   uninterrupted run's bitwise; one step of the same weights with every
   flash call held at the op (the ops phase's bf16 contract), the
   attention ``Function``'s gradients of layers 0 and 15 against autograd
   through the plain fp32 version of the same operands (one bf16 ulp plus
   2e-5 x max |want|), the forward kernel and the torch backward timed at
   that shape; the step's forward, backward and optimizer profiled apart
   (device time, busy share, the flash kernel a call); one fp32 step's
   gradients on ``flash_attention_tf32x3`` against the op's ``torch``
   backend (each parameter within n_layers x 2e-5); the scan's
   ``Function`` at falcon-mamba-7b's widths (1 x 1024 x 8192, N 16, fp32)
   against autograd through the plain version (1e-5), its backward timed.
12. mesh: the multi-device PCA path over ``serving.host_mesh()``, a 1-D
   "data" mesh over every visible card (one here): (a) ``core.
   fit_distributed`` of phase 3's matrix under phase 3's config with the
   reference's early exit ``tol=1e-6`` (which it reads as the reference
   does: the Gram on ``torch.matmul``, the unfused solve, no kernel
   launched), its wall and sweeps printed, its
   eigenvalues within the fp32 ``eigh`` budget of phase 3's fit and of
   float64 numpy; (b) phase 6's 96 requests through ``PCAServer`` with
   ``MeshExecutor(mesh=host_mesh())`` at ``max_inflight`` 1 and 3, a
   cold and a warm pass each, ``submit`` under phase 6's sync guard,
   every result bitwise phase 6's ``LocalExecutor`` result and within the
   fp32 budget of float64 numpy, each pass's n_shards, wall and
   requests/s printed; (c) ``serve_pca.main(["--mesh", "auto", ...])``
   closed loop (the flags: plain torch ops) and the same mesh from a spec
   with the kernels (``--spec``, svd over phase 7's dims), each plan's
   executor ``mesh(data=N; N shards)``; (d) where more than one card is
   visible, (a) and (b) again over meshes of 2 cards and of every card
   (results within the fp32 budget), else ``{"multi_gpu": {"run": false,
   "visible": 1}}`` on a line of its own.

Each path is checked against the kernels it runs: phase 3 against the
three PCA/SVD kernels, phases 4, 6, 7 and 12 against those and the
shared-memory sweep, phase 5 against the seven kernels of its five ops,
phase 8 against the two flash kernels of bf16 serving and the Gram and
shared-memory sweep of the consumers, phases 9 and 10 against the scan
and the two flash kernels of bf16 serving, phase 11 against the bf16
prefill kernel and, with compression, the Gram and shared-memory sweep.
The last three lines are the kernels' JSON record (each kernel's
launches from the phase that drives it, ``launches_serve`` from phase 6,
``launches_control`` from phase 7, ``launches_lm`` from the serve runs
and consumers of phases 8 to 10, ``launches_train`` from phase 11's
trainer runs and ``launches_mesh`` from phase 12), the card's name and
power limit, and ``{"ok": true,
"device": {...}}``.
Without a CUDA device the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
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
# phase 8: the LM serving path at the full width of olmo-1b, the serve CLI's
# default --arch (16 layers, d 2048, 16 heads x 128, d_ff 8192, vocab
# 50304, bf16; random weights from the seed) serving 4 prompts of 4096
# tokens and generating 32
LM_ARCH = "olmo-1b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 32
LM_FORCED = 8                  # teacher-forced decode steps held to plain
LM_PROFILE_STEPS = 8
LM_KV_RANKS = (32, 64, 128)    # KV compression ranks of layer 0's cache
LM_GRAD_SHAPES = ((2048, 8192), (8192, 2048))  # olmo-1b's MLP wi and wo
# phase 8's bounds, relative Frobenius.  Kernels against plain attention
# on one model: in bf16, step by step, sqrt(2) x the bf16 noise of the
# logits, the plain bf16 run's distance from the plain fp32 run of the
# same weights (measured in the run): bf16 rounding turns any difference
# between two runs, however small, into differences of whole bf16 steps
# within a few layers, so the two bf16 runs end up as two draws of that
# noise, sqrt(2) x its size apart when independent; in fp32 the flash
# kernels' 2e-5 a call, times n_layers.  That bf16 bound is all of bf16's
# noise, and attention over 4100 keys of random weights moves the logits
# little, so it is no test of a flash kernel: each bf16 flash call is also
# held at the op (FA_BF16_SLACK).  Every Gram the consumers' run launched
# is held to the fp32 covariance budget, 1e-5 (as KERNEL_TOL: two fp32
# sums of up to 16384 terms in other orders); the spectra's eigenvalues move no more than their Gram (Weyl)
# plus the solve's rounding: 2e-5; one compress_tree step divides by the
# square roots of P^T P's eigenvalues: 1e-4; the attention error of a
# truncated basis, relative: 1e-3 (the basis turns by the Gram's error
# over the eigengap), plus the full-rank error (the compressed cache is
# stored in bf16 and the two paths round other coefficients); the
# full-rank error itself within one bf16 ulp (2^-8) of the stored
# coefficients
LM_FP32_TOL = 2e-5
LM_GRAM_TOL = 1e-5
LM_SPECTRA_TOL = 2e-5
LM_COMPRESS_TOL = 1e-4
LM_KV_ERR_TOL = 1e-3
LM_KV_STORE_TOL = 2.0 ** -8
# phase 9: the ssm and hybrid families at B 4 x 4096, 32 generated, as
# phase 8.  falcon-mamba-7b whole (src/repro/configs/falcon_mamba_7b.py,
# arXiv:2410.05355: 64 mamba layers, d 4096, d_inner 8192, N 16, d_conv
# 4, vocab 65024, bf16, 7.27e9 parameters); jamba-v0.1-52b
# (src/repro/configs/jamba_v0_1_52b.py, arXiv:2403.19887) cut in depth to
# one period of its pattern, lcm(attn_every 8, moe_every 2) = 8 of its 32
# layers (7 mamba and 1 GQA attention layer, 4 MoE layers of all 16
# experts top-2 and 4 MLP layers, every width as published; 1.28e10
# parameters, 26.6 GB in bf16): the whole model does not fit one card
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 8
# the served prefill's scan calls held at the op (a plain scan of 4 x
# 4096 x 8192 is a loop of 4096 steps, about a second), and the length of
# a second prefill of the same weights whose every scan call is held
SSM_HELD_LAYERS = (0, 31, 63)
SSM_SHORT_PROMPT = 512
# phase 10: the encdec and vlm families, one model after the other, bf16,
# random weights from the seed.  whisper-small whole
# (src/repro/configs/whisper_small.py, arXiv:2212.04356: 12 encoder and 12
# decoder layers, d 768, 12 heads x 64 (MHA), d_ff 3072, gelu, layernorm,
# vocab 51865, learned positions, 1500 frames): an ASR server's batch of
# 32 30-second windows (seeded N(0, 1) frames from the stub frontend), each
# conditioned on 64 tokens of the previous window's text, 128 generated
# (the prompt is over 16 rows, so the decoder's prefill runs
# flash_attention_mma)
ENCDEC_ARCH = "whisper-small"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_GEN = 32, 64, 128
# llava-next-34b (src/repro/configs/llava_next_34b.py) cut in depth only,
# 60 -> 40 layers, every width as published (d 7168, 56 query heads over 8
# KV heads of 128, d_ff 20480, vocab 64000, 576 patches): 23.2e9
# parameters, 46.5 GB in bf16, where the whole model (34.3e9, 68.7 GB)
# leaves no room for activations on one card; a chat turn over one image,
# 576 seeded N(0, 1) patch embeddings (the stub vision tower's) and 1024
# tokens, B 8, 32 generated; the flash calls of these layers of a prefill
# held at the op
VLM_ARCH = "llava-next-34b"
VLM_LAYERS = 40
VLM_BATCH, VLM_PROMPT, VLM_GEN = 8, 1024, 32
VLM_HELD_LAYERS = (0, 19, 39)
# phase 11: training olmo-1b whole (src/repro/configs/olmo_1b.py: 16
# layers, d 2048, 16 heads x 128, d_ff 8192, vocab 50304, bf16, remat on;
# 1.28e9 parameters) through the trainer CLI on the synthetic pipeline,
# B 4 x 4096, 8 steps at lr 3e-3; the compression leg (rank 4, int8
# moments) for 4 steps; a preemption after step 4 and a resume to 8, the
# checkpoints under build/ (gitignored)
TRAIN_ARCH = "olmo-1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 4096, 3e-3
TRAIN_COMP_STEPS, TRAIN_COMP_RANK = 4, 4
TRAIN_PREEMPT_AT = 4
TRAIN_CKPT = pathlib.Path(__file__).resolve().parent / "build" / \
    "train_ckpt"
# the scan's Function at falcon-mamba-7b's layer widths (batch, L,
# d_inner, N), fp32, and its gradients against autograd through the plain
# version: both sum in fp32 in other orders (the chunked adjoint against
# the step-by-step loop), held to the CPU tests' 1e-5 relative Frobenius
SCAN_GRAD_SHAPE = (1, 1024, 8192, 16)
SCAN_GRAD_TOL = 1e-5
# phase 12: the mesh.  fit_distributed's early exit, the reference's own
# tol: its unfused 50-sweep solve at 784 is host-bound Python rounds,
# 37.4-56.6 s on the H100, which would double the phase's minute
MESH_FIT_TOL = 1e-6
# the attention Function's bf16 gradients against autograd through the
# plain fp32 version on the same operands: the backward computes in fp32
# (recomputing O in fp32) and rounds each gradient to bf16 once, so each
# value is within one bf16 ulp of the larger of the two, plus this share
# of max |want| for two fp32 sums over 4096 keys in other orders
FA_GRAD_SLACK = 2e-5
# a scan call against the plain version on the same operands, y and the
# final state: the ops phase's fp32 contract
SCAN_RTOL = SCAN_ATOL = 1e-4
# a bf16 flash call against the plain version's fp32 result on the same
# operands: within one bf16 ulp of the larger of the two, plus this (the
# ops phase's contract: two fp32 results 1e-7 apart round to bf16 values
# one ulp apart)
FA_BF16_SLACK = 2e-5
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
            "profile": profile_fit(X, config, dev), "X": X, "config": config,
            "eigenvalues": w, "eigenvalues64": w64}


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
        ys[name] = ops.mamba_scan(*args, return_state=True)
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
        t for y in ys.values() for t in y] + [proj]
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
            slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) \
                + FA_BF16_SLACK
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
    # fp32 result on the same bf16 inputs; the final state (fp32 in both)
    # within rtol = atol = 1e-4, and y bitwise the default call's (no
    # state).  The bound: u, dt and y once,
    # and N exponentials a (b, t, d) on the SFU (16 a clock an SM at the
    # card's top SM clock) beside the other arithmetic at the fp32 rate
    bld = MS_B * MS_L * MS_D
    sfu_rate = SFU_PER_CLOCK * torch.cuda.get_device_properties(
        dev).multi_processor_count * sm_clock_hz()
    t_sfu = bld * MS_N / sfu_rate * 1e3
    for name, args in (("fp32", scan), ("bf16", scan16)):
        out, state = ys[name]
        prefix = "" if name == "fp32" else "bf16_"
        es = out.element_size()
        want, want_state = ref.mamba_scan(*(t.float() for t in args),
                                          return_state=True)
        state_err = float((state - want_state).abs().max())
        state_close = bool(((state - want_state).abs()
                            <= 1e-4 + 1e-4 * want_state.abs()).all())
        default_same = torch.equal(ms.mamba_scan(*args), out)
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
            f"{t_ops:.4f}); final state max_abs_err {state_err:.3e} "
            f"(rtol = atol = 1e-4: {state_close}), y bitwise the default "
            f"call's: {default_same}")
        check(torch.isfinite(out.float()).all().item() and close,
              f"mamba_scan[{name}]: kernel disagrees with its plain version")
        check(state_close and default_same, f"mamba_scan[{name}]: the "
              f"final state disagrees with the plain version's, or y with "
              f"the default call's")
        row("mamba_scan", err, t_k, t_p, None, b,
            lambda: ms.mamba_scan(*args), prefix)
        rows["mamba_scan"].update({prefix + "bound_bytes_ms": t_bytes,
                                   prefix + "bound_sfu_ms": t_sfu,
                                   prefix + "state_max_abs_err": state_err})
    return {"wall_s": wall, "launches": counts}


# -- phase 6: the serving engine ---------------------------------------------

def serve_config():
    """The serving phases' solver config: the kernels, phase 4's sweeps,
    pow2 buckets of T 64, a batch of 32."""
    from repro_torch.core.pca import PCAConfig
    return PCAConfig(fused=True, backend=BACKEND, sweeps=SWEEPS, T=FLUSH_T,
                     S=FLUSH_REQUESTS)


def no_sync(submit, guarded: list):
    """``submit`` under the sync debug mode "error": a host sync in the
    dispatch stage raises.  ``guarded[0]`` counts the guarded calls."""
    def guarded_submit(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            flush = submit(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        guarded[0] += 1
        return flush
    return guarded_submit


def serve_pass(srv, burst: list):
    """The burst of (op, request) through ``srv``, then drain: (served
    results in order, wall seconds, telemetry of this pass alone)."""
    srv.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [srv.submit(a, op=op) for op, a in burst]
    srv.drain()
    wall = time.perf_counter() - t0
    return [t.result() for t in tickets], wall, srv.stats


def serve_phase(dev, requests: dict) -> dict:
    import dataclasses
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import BucketPolicy, PCAServer

    config = serve_config()
    burst = [(op, a) for op, mats in requests.items() for a in mats]
    guarded = [0]
    servers, passes, runs = {}, [], {}
    torch.cuda.synchronize()
    reset_launch_counts()
    for depth in SERVE_DEPTHS:
        srv = servers[depth] = PCAServer(
            config, policy=BucketPolicy(T=FLUSH_T, mode="pow2"),
            max_inflight=depth)
        check(srv.executor.device.type == "cuda",
              f"PCAServer() runs on {srv.executor.device}, not the card")
        srv.executor.submit = no_sync(srv.executor.submit, guarded)
        run = runs[depth] = {}
        for name in ("cold", "warm"):
            served, wall, stats = serve_pass(srv, burst)
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
                       lambda: serve_pass(srv, burst))
    return {"launches": counts, "runs": runs, "worst": worst,
            "profile": profile, "submits_guarded": guarded[0],
            "burst": burst, "served": passes[0]}


# -- phase 7: the control plane and the serving CLI ---------------------------

def run_cli(argv) -> dict:
    """``repro_torch.launch.serve_pca.main(argv)`` on the card: its JSON
    document (it prints one) and the wall seconds of the call."""
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


# -- phase 8: the LM serving path and the PCA consumers -----------------------

def model_profile(model, cfg, dev, batch, cache_len: int) -> dict:
    """One prefill of ``batch`` (its tensors on the card; frames or
    patches beside the tokens) with capacity ``cache_len`` and
    ``LM_PROFILE_STEPS`` decode steps under torch.profiler: the busy share
    of each, the decode's device time a step, and the device time a call
    of the scan and flash kernels inside the model; for encdec also the
    encoder alone, profiled before the prefill.  Returns them with the
    prefill's argmax."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm

    def kernel_ms(prof, names):
        hits = [e for e in prof.key_averages()
                if any(n in e.key for n in names) and e.device_time_total > 0]
        calls = max((e.count for e in hits), default=0)
        total = sum(e.device_time_total for e in hits) / 1e3
        return (total / calls if calls else None), calls

    def top(prof, n=8):
        """The device's time by kernel: the n largest (name, calls, s)."""
        events = sorted((e for e in prof.key_averages()
                         if e.device_time_total > 0),
                        key=lambda e: -e.device_time_total)[:n]
        return [{"name": e.key[:72], "calls": e.count,
                 "s": e.device_time_total / 1e6} for e in events]

    def profiled_call(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.device_time_total for e in prof.key_averages()) / 1e6
        return out, prof, wall, busy

    extra = {}
    if cfg.family == "encdec":
        _, prof, wall, busy = profiled_call(
            lambda: tfm._encode(model, batch, cfg))
        enc_ms, enc_calls = kernel_ms(prof, ("flash_mma_kernel",))
        extra = {"encoder_wall_s": wall, "encoder_busy_share": busy / wall,
                 "encoder_top": top(prof), "encoder_mma_device_ms": enc_ms,
                 "encoder_mma_calls": enc_calls}
    (logits, state), prof, prefill_wall, prefill_busy = profiled_call(
        lambda: tfm.prefill(model, batch, cfg, cache_len=cache_len))
    prefill_top = top(prof)
    scan_ms, scan_calls = kernel_ms(prof, ("scan_kernel",))
    mma_ms, mma_calls = kernel_ms(prof, ("flash_mma_kernel",))
    first = logits.argmax(-1)
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    tok = first.clone()

    def steps():
        st = state
        for _ in range(LM_PROFILE_STEPS):
            _, st = tfm.decode_step(model, st, tok, cfg)
    _, prof, wall, busy = profiled_call(steps)
    split_ms, split_calls = kernel_ms(prof, ("decode_partial_kernel",
                                             "decode_merge_kernel"))
    return {"prefill_top": prefill_top, "decode_top": top(prof),
            "prefill_wall_s": prefill_wall,
            "prefill_busy_share": prefill_busy / prefill_wall,
            "decode_step_wall_ms": 1e3 * wall / LM_PROFILE_STEPS,
            "decode_step_device_ms": 1e3 * busy / LM_PROFILE_STEPS,
            "decode_busy_share": busy / wall,
            "scan_device_ms": scan_ms, "scan_calls": scan_calls,
            "mma_device_ms": mma_ms, "mma_calls": mma_calls,
            "splitkv_device_ms": split_ms, "splitkv_calls": split_calls,
            "first_tokens": first.cpu().numpy(), "finite": finite, **extra}


def attention_bound(bh: int, sq: int, keys: float, d: int, causal: bool,
                    rows: int = None):
    """The least time of one bf16 flash call: q and out (``rows`` x d a
    problem, default Sq) and the K, V it attends (``keys`` a problem) moved
    once, against 4 x d products a visible score."""
    rows = sq if rows is None else rows
    scores = sq * (keys - (sq - 1) / 2) if causal else sq * keys
    return bound_ms(2 * bh * d * (2 * rows + 2 * keys),
                    4 * bh * d * scores, PEAK_BF16)


def mean_bound(*bounds):
    """The mean of (ms, bound_by) bounds over calls of several kinds."""
    return (sum(b[0] for b in bounds) / len(bounds),
            "/".join(b[1] for b in bounds))


def log_profile(what: str, prof: dict) -> None:
    """``model_profile``'s numbers, each kernel the model ran with its
    device time a call and, where the caller set one, its bound."""
    parts = [f"{what} profile: prefill {prof['prefill_wall_s']:.4f} s wall, "
             f"busy share {prof['prefill_busy_share']:.3f}; decode "
             f"{LM_PROFILE_STEPS} steps, a step "
             f"{prof['decode_step_wall_ms']:.3f} ms wall, "
             f"{prof['decode_step_device_ms']:.3f} ms on the device (busy "
             f"share {prof['decode_busy_share']:.3f})"]
    if "encoder_wall_s" in prof:
        decoder_s = prof["prefill_wall_s"] - prof["encoder_wall_s"]
        parts.append(f"the encoder alone {prof['encoder_wall_s']:.4f} s "
                     f"wall, busy share {prof['encoder_busy_share']:.3f}, "
                     f"the decoder's prefill {decoder_s:.4f} s by "
                     f"difference")
    for key, name in (("scan", "mamba_scan"),
                      ("encoder_mma", "flash_attention_mma in the encoder"),
                      ("decoder_mma", "flash_attention_mma in the decoder"),
                      ("mma", "flash_attention_mma"),
                      ("splitkv", "flash_attention_splitkv, two kernels")):
        if prof.get(key + "_calls"):
            t, bound = prof[key + "_device_ms"], prof.get(key + "_bound")
            parts.append(f"{name} {t:.5f} ms a call on the device "
                         f"({prof[key + '_calls']} calls"
                         + (f"; bound {bound[0]:.4f}, {bound[1]})"
                            if bound else ")"))
    log("; ".join(parts))
    for part in ("encoder", "prefill", "decode"):
        if part + "_top" in prof:
            log(f"{what} {part} by device time: "
                f"{json.dumps(prof[part + '_top'])}")


def lm_config():
    """The phase's model: olmo-1b at full width, ``tp`` 1 (as the serve
    CLI sets it on one card)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), tp=1)


def lm_prompt(cfg, batch: int = None, length: int = None) -> np.ndarray:
    """The serve CLI's prompt: ``np.random.default_rng(seed)``, (batch,
    length), by default (``LM_BATCH``, ``LM_PROMPT``)."""
    rng = np.random.default_rng(SEED)
    return rng.integers(0, cfg.vocab_size, (batch or LM_BATCH,
                                            length or LM_PROMPT))


def lm_prefill_kernel(cfg) -> str:
    """The flash kernel of a prefill in the config's dtype."""
    return ("flash_attention_mma" if cfg.dtype == "bfloat16"
            else "flash_attention_tf32x3")


def lm_fp32_copy(model, cfg32, dev):
    """The bf16 model's weights, cast exactly, in an fp32 model."""
    from repro_torch.models.transformer import Transformer
    m32 = Transformer(cfg32, dev)
    m32.load_state_dict({k: t.float() for k, t in model.state_dict().items()})
    return m32.eval()


@contextlib.contextmanager
def op_calls(name: str, call):
    """Inside the block every ``kernels.ops.<name>`` call, from whatever
    module, is ``call(op, *args, **kwargs)``, ``op`` the op itself."""
    from repro_torch.kernels import ops
    op = getattr(ops, name)
    setattr(ops, name, lambda *args, **kw: call(op, *args, **kw))
    try:
        yield
    finally:
        setattr(ops, name, op)


def flash_held_at_op(held: list, keep=None):
    """``op_calls`` for ``flash_attention`` that holds each bf16 call whose
    index in the block is in ``keep`` (every one if None) at the op,
    right after it (a decode step writes the cache in place): the
    kernel's output against the plain version's fp32 result on the same
    operands, at the ops phase's bf16 contract.  Appends a record a call
    held."""
    from repro_torch.backends import registry
    count = [0]

    def call(op, q, k, v, **kw):
        out = op(q, k, v, **kw)
        i, count[0] = count[0], count[0] + 1
        if out.dtype == torch.bfloat16 and (keep is None or i in keep):
            t0 = time.perf_counter()
            with registry.use_backend("torch"):
                want32 = op(q.float(), k.float(), v.float(), **kw)
            g = out.float()
            slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) \
                + FA_BF16_SLACK
            held.append({"call": i, "q": list(q.shape), "kv": list(k.shape),
                         "causal": kw.get("causal", True),
                         "q_offset": kw.get("q_offset", 0),
                         "over": int(((g - want32).abs() > slack).sum()),
                         "max_abs_err": float((g - want32).abs().max()),
                         "hold_s": time.perf_counter() - t0})
        return out
    return op_calls("flash_attention", call)


def flash_calls(cfg):
    """The flash calls of a prefill and of a decode step: one a
    self-attention layer and, for encdec, one an encoder layer (prefill)
    and one a decoder layer's cross attention (both)."""
    n_attn = cfg.layer_kinds().count("attn")
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * n_attn, 2 * n_attn
    return n_attn, n_attn


def lm_against_plain(model, cfg, dev, batch, forced, cache_len: int):
    """The prefill of ``batch`` (tensors on the card) and ``len(forced)``
    teacher-forced decode steps of ``model`` once through the kernels and
    once with attention on the flash op's ``torch`` backend, on the card,
    each step's launches checked (``flash_calls``: one kernel a call) and,
    in bf16, each flash call held at the op (``flash_held_at_op``).
    Returns the kernels' and the plain version's logits over the true
    vocabulary, a list each (the prefill's, then a step's), and the
    kernels' decode state."""
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tfm
    v = cfg.vocab_size
    bf16 = cfg.dtype == "bfloat16"
    n_prefill, n_step = flash_calls(cfg)

    def launched(what, calls, held):
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        check(counts == {what: calls},
              f"{cfg.name}[{cfg.dtype}]: launches {counts}, not {calls} "
              f"{what} (one a flash call)")
        if not bf16:
            return
        over = [h for h in held if h["over"]]
        operands = sorted({(tuple(h["q"]), tuple(h["kv"]), h["causal"])
                           for h in held})
        log(f"{cfg.name}[bf16]: {what} held at the op in {len(held)} "
            f"calls, max_abs_err "
            f"{max(h['max_abs_err'] for h in held):.3e}, operands "
            f"{operands} (the holds {sum(h['hold_s'] for h in held):.3f} "
            f"s)")
        check(len(held) == calls and not over,
              f"{cfg.name}[bf16]: {what} off the plain version beyond one "
              f"bf16 ulp + {FA_BF16_SLACK:g} at the op: {over[:2]}")

    held = []
    reset_launch_counts()
    with flash_held_at_op(held):
        logits, state = tfm.prefill(model, batch, cfg, cache_len=cache_len)
    launched(lm_prefill_kernel(cfg), n_prefill, held)
    with registry.use_backend("torch"):
        want, plain = tfm.prefill(model, batch, cfg, cache_len=cache_len)
    got, ref = [logits[:, :v].float()], [want[:, :v].float()]
    for tok in forced:
        tok = torch.as_tensor(tok, dtype=torch.int64, device=dev)
        held = []
        reset_launch_counts()
        with flash_held_at_op(held):
            logits, state = tfm.decode_step(model, state, tok, cfg)
        launched("flash_attention_splitkv", n_step, held)
        with registry.use_backend("torch"):
            want, plain = tfm.decode_step(model, plain, tok, cfg)
        got.append(logits[:, :v].float())
        ref.append(want[:, :v].float())
    return got, ref, state


def logits_against_plain(what, got16, plain16, got32, plain32,
                         n_calls: int) -> tuple:
    """The kernels' logits against the plain versions', step by step: bf16
    within sqrt(2) x bf16's own noise (the plain bf16 run against the
    plain fp32 run of the same weights), fp32 within ``n_calls`` x
    ``LM_FP32_TOL``.  Returns (bf16 errors, their bounds, fp32 errors)."""
    err16 = [errors(g, p)[2] for g, p in zip(got16, plain16)]
    floor16 = [2 ** 0.5 * errors(p, w)[2] for p, w in zip(plain16, plain32)]
    err32 = [errors(g, p)[2] for g, p in zip(got32, plain32)]
    tol32 = LM_FP32_TOL * n_calls

    def fmt(errs):
        return json.dumps([float(f"{e:.3e}") for e in errs])

    log(f"{what}: logits rel-Frobenius (prefill, then {len(got16) - 1} "
        f"teacher-forced decode steps): bf16 kernels vs plain {fmt(err16)}, "
        f"bound (sqrt(2) x plain bf16 vs plain fp32, same weights) "
        f"{fmt(floor16)}; "
        f"fp32 kernels vs plain {fmt(err32)} (bound {tol32:.2e})")
    check(all(e <= f for e, f in zip(err16, floor16)),
          f"{what}: the bf16 kernels move the logits beyond bf16's noise")
    check(max(err32) <= tol32, f"{what}: the fp32 kernels off the plain "
          f"version ({max(err32):.3e} > {tol32:.2e})")
    return err16, floor16, err32


def sweeps_apart_from_plain(calls) -> int:
    """Replays kept ``jacobi_sweep`` calls, ``(args, kwargs, (C, V) out)``,
    on the op's ``torch`` backend: the calls that share their pivot rounds
    stacked into one batch (the plain sweep updates each matrix of a batch
    alone, element by element, so a matrix's result does not depend on its
    batch).  Returns how many calls differ bitwise from their result."""
    from repro_torch.kernels import ops
    groups = {}
    for (C, V, pairs), kw, out in calls:
        key = (C.shape[-1], pairs.data_ptr(), tuple(pairs.shape),
               tuple(sorted(kw.items())))
        groups.setdefault(key, []).append((C, V, pairs, kw, out))
    apart = 0
    for group in groups.values():
        n, pairs, kw = group[0][0].shape[-1], group[0][2], group[0][3]
        mats = [[t.reshape(-1, n, n) for t in (C, V, *out)]
                for C, V, _, _, out in group]
        Cp, Vp = ops.jacobi_sweep(torch.cat([m[0] for m in mats]),
                                  torch.cat([m[1] for m in mats]), pairs,
                                  **dict(kw, backend="torch"))
        sizes = [m[0].shape[0] for m in mats]
        for m, c, v in zip(mats, Cp.split(sizes), Vp.split(sizes)):
            apart += not (torch.equal(m[2], c) and torch.equal(m[3], v))
    return apart


@contextlib.contextmanager
def pca_calls_kept(calls: dict):
    """Inside the block every ``covariance`` and ``jacobi_sweep`` call is
    kept in ``calls[name]`` as ``(args, kwargs, result)``, the floating
    operands and the result copied (callers may reuse them; the pivot
    table stays shared, as ``sweeps_apart_from_plain`` groups by it)."""
    def copied(x):
        if isinstance(x, tuple):
            return tuple(copied(t) for t in x)
        return x.clone() if torch.is_tensor(x) and x.is_floating_point() \
            else x

    def keeper(name):
        def call(op, *args, **kw):
            out = op(*args, **kw)
            calls[name].append((copied(args), kw, copied(out)))
            return out
        return op_calls(name, call)

    calls.update(covariance=[], jacobi_sweep=[])
    with keeper("covariance"), keeper("jacobi_sweep"):
        yield


def pca_calls_against_plain(calls: dict):
    """The kept calls replayed on the ops' ``torch`` backend: (the Grams'
    largest relative Frobenius error, how many sweeps differ bitwise)."""
    from repro_torch.kernels import ops
    gram_err = max(errors(out, ops.covariance(
        *args, **dict(kw, backend="torch")))[2]
        for args, kw, out in calls["covariance"])
    return gram_err, sweeps_apart_from_plain(calls["jacobi_sweep"])


def lm_consumers(cache, dev) -> dict:
    """The three PCA consumers through their entry points, their kernel
    launches counted (the path), then held to their plain versions:
    ``kv_compression.attention_error`` at ``LM_KV_RANKS`` and
    ``suggest_rank`` on layer 0's K and V (the port's head-major cache seen
    as the reference's (B, S, KV, hd)); ``tree_spectra`` and one
    ``compress_tree`` step on a seeded gradient tree of olmo-1b's MLP
    shapes.  Every Gram and sweep call of the counted run is kept and
    replayed on the op's ``torch`` backend: each Gram within
    ``LM_GRAM_TOL``, each sweep bitwise."""
    import dataclasses
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import kv_compression as kvc
    from repro_torch.optim import compression as comp
    from repro_torch.optim import spectral

    k = cache.k[:, :, :LM_PROMPT].transpose(1, 2)   # (B, S, KV, hd) views
    v = cache.v[:, :, :LM_PROMPT].transpose(1, 2)
    b, s, kvh, hd = k.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    q = torch.randn(b, kvh, 1, hd, generator=gen, device=dev)
    scale = hd ** -0.5
    grads = {}
    for name, (m, n) in zip(("mlp.wi", "mlp.wo"), LM_GRAD_SHAPES):
        a = torch.randn(m, 16, generator=gen, device=dev)
        c = torch.randn(16, n, generator=gen, device=dev)
        grads[name] = a @ c + 0.1 * torch.randn(m, n, generator=gen,
                                                device=dev)
    kcfg = kvc.KVCompressionConfig()
    scfg, ccfg = spectral.SpectralConfig(), comp.CompressionConfig()

    def run():
        errs = {r: kvc.attention_error(q, k, v, dataclasses.replace(
            kcfg, rank=r), scale)[0] for r in LM_KV_RANKS}
        rank = kvc.suggest_rank(k, sweeps=kcfg.sweeps)
        spectra = spectral.tree_spectra(
            grads, scfg, torch.Generator(device=dev).manual_seed(SEED))
        state = comp.init_state(grads, ccfg,
                                torch.Generator(device=dev).manual_seed(SEED))
        out, _, _ = comp.compress_tree(grads, state, ccfg)
        return errs, rank, spectra, out

    calls = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with pca_calls_kept(calls):
        errs, rank, spectra, out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_kv = len(LM_KV_RANKS)
    # Grams: 2 an attention_error, 1 suggest_rank, 1 a spectrum, 1 a
    # compressed parameter; sweeps: 2 x sweeps an attention_error, sweeps
    # for suggest_rank, scfg.sweeps a spectrum, ccfg.jacobi_sweeps a
    # compressed parameter (the r x r cyclic solve)
    want = {"covariance": 2 * n_kv + 1 + 2 * len(grads),
            "jacobi_sweep_smem": (2 * n_kv + 1) * kcfg.sweeps
            + len(grads) * (scfg.sweeps + ccfg.jacobi_sweeps)}
    got = {name: n for name, n in counts.items() if n}
    log(f"lm consumers: {wall:.3f} s, launches {json.dumps(got)}")
    check(got == want, f"lm consumers launched {got}, not {want}")
    check(len(calls["covariance"]) == want["covariance"]
          and len(calls["jacobi_sweep"]) == want["jacobi_sweep_smem"],
          f"lm consumers: {len(calls['covariance'])} Gram and "
          f"{len(calls['jacobi_sweep'])} sweep calls kept for {want}")

    with registry.use_backend("torch"):
        p_errs, p_rank, p_spectra, p_out = run()
    # each kernel call of the counted run on the plain version
    t0 = time.perf_counter()
    gram_err, sweeps_apart = pca_calls_against_plain(calls)
    replay = time.perf_counter() - t0
    shapes = sorted({tuple(args[0].shape) for args, _, _ in
                     calls["jacobi_sweep"]})
    check(gram_err <= LM_GRAM_TOL, f"lm: a Gram of the consumers' run off "
          f"the plain Gram ({gram_err:.3e} > {LM_GRAM_TOL:g})")
    check(sweeps_apart == 0, f"lm: {sweeps_apart} of the consumers' "
          f"{len(calls['jacobi_sweep'])} sweeps differ bitwise from the "
          f"plain sweep (shapes {shapes})")
    kv_err = {r: float(e) for r, e in errs.items()}
    kv_plain = {r: float(e) for r, e in p_errs.items()}
    # the compressed cache is stored in the cache's dtype (bf16), so every
    # error holds the rounding of the stored coefficients, which is all of
    # the full-rank error; the two paths round different coefficients
    store = kv_plain[max(LM_KV_RANKS)]
    for r in LM_KV_RANKS:
        check(np.isfinite(kv_err[r]) and abs(kv_err[r] - kv_plain[r])
              <= LM_KV_ERR_TOL * kv_plain[r] + store,
              f"lm: attention_error at rank {r} {kv_err[r]:.6e} against "
              f"the plain {kv_plain[r]:.6e}")
    check(rank == p_rank, f"lm: suggest_rank {rank} against plain {p_rank}")
    check(kv_err[hd] <= LM_KV_STORE_TOL, f"lm: full-rank compression error "
          f"{kv_err[hd]:.3e} is over the bf16 storage bound "
          f"{LM_KV_STORE_TOL:.3e}")
    spec_err = max(errors(spectra[n][f], p_spectra[n][f])[2]
                   for n in spectra for f in ("eigenvalues", "cvcr"))
    comp_err = max(errors(out[n], p_out[n])[2] for n in out)
    check(spec_err <= LM_SPECTRA_TOL and comp_err <= LM_COMPRESS_TOL,
          f"lm: spectra {spec_err:.3e} (bound {LM_SPECTRA_TOL:g}) or "
          f"compression {comp_err:.3e} (bound {LM_COMPRESS_TOL:g}) off the "
          f"plain versions")
    eff = {n: float(sp["effective_rank"]) for n, sp in spectra.items()}
    log(f"lm consumers: layer-0 KV attention error by rank "
        f"{json.dumps(kv_err)} (plain {json.dumps(kv_plain)}), "
        f"suggest_rank(0.99) {rank}; the run's {len(calls['covariance'])} "
        f"Grams vs plain at most {gram_err:.3e}, its "
        f"{len(calls['jacobi_sweep'])} sweeps (shapes {shapes}) bitwise "
        f"(replayed in {replay:.2f} s); "
        f"spectra vs plain {spec_err:.3e}, "
        f"effective ranks {json.dumps(eff)}; compress_tree vs plain "
        f"{comp_err:.3e}")
    return {"launches": counts, "wall_s": wall, "kv_error": kv_err,
            "suggest_rank": rank, "gram_err": gram_err,
            "spectra_err": spec_err, "compress_err": comp_err}


def lm_phase(dev) -> dict:
    """Phase 8: the port's LM serving path and the three PCA consumers on
    the card (the module docstring's item 8)."""
    import dataclasses
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    cfg = lm_config()
    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen-len", str(LM_GEN), "--seed", str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv, device=dev)
    torch.cuda.synchronize()
    serve_counts = launch_counts()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm serve: {json.dumps(line)}; peak device memory {peak_gb:.2f} "
        f"GB")
    want = {lm_prefill_kernel(cfg): cfg.n_layers,
            "flash_attention_splitkv": cfg.n_layers * LM_GEN}
    got = {k: n for k, n in serve_counts.items() if n}
    check(got == want, f"lm serve launched {got}, not {want} (one prefill "
          f"kernel a layer, one split-KV kernel a layer a decode step)")
    check(gen.shape == (LM_BATCH, LM_GEN) and gen.dtype == np.int32
          and 0 <= gen.min() and gen.max() < cfg.vocab_size,
          f"lm serve: generated {gen.shape} {gen.dtype} out of range")

    prompt = lm_prompt(cfg)
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.int64,
                                       device=dev)}
    cache_len = LM_PROMPT + LM_GEN
    forced = gen[:, :LM_FORCED].T  # the served tokens, fed back
    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    got16, plain16, state = lm_against_plain(model, cfg, dev, batch, forced,
                                             cache_len)
    check(np.array_equal(got16[0].argmax(-1).cpu().numpy(), gen[:, 0]),
          "lm: the kernels' prefill does not give the served first token")
    consumers = lm_consumers(state.caches[0], dev)
    del state
    profile = model_profile(model, cfg, dev, batch, cache_len)
    check(profile["finite"]
          and np.array_equal(profile["first_tokens"], gen[:, 0]),
          "lm: the profiled prefill does not give the served first token")
    # the least time of one layer's call at the model's shapes (bf16): the
    # decode reads the visible K and V once (their mean count over the
    # profiled steps), the prefill does the causal products
    bh, d = LM_BATCH * cfg.n_heads, cfg.head_dim
    keys = LM_PROMPT + (LM_PROFILE_STEPS + 1) / 2
    profile["splitkv_bound"] = attention_bound(bh, 1, keys, d, True)
    profile["mma_bound"] = attention_bound(bh, LM_PROMPT, LM_PROMPT, d,
                                           True)
    log_profile("lm", profile)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = lm_fp32_copy(model, cfg32, dev)
    del model
    torch.cuda.empty_cache()
    got32, plain32, _ = lm_against_plain(model32, cfg32, dev, batch, forced,
                                         cache_len)
    del model32
    torch.cuda.empty_cache()
    err16, floor16, err32 = logits_against_plain(
        "lm", got16, plain16, got32, plain32, cfg.n_layers)
    wall = time.perf_counter() - t_phase
    log(f"lm: phase {wall:.1f} s")
    launches = {k: serve_counts[k] + consumers["launches"][k]
                for k in serve_counts}
    return {"serve": line, "serve_launches": serve_counts,
            "peak_gb": peak_gb,
            "launches": launches, "bf16_err": err16, "bf16_bound": floor16,
            "fp32_err": err32,
            "consumers": consumers, "profile": profile, "wall_s": wall}


# -- phase 9: the ssm and hybrid families -------------------------------------

def ssm_config():
    """falcon-mamba-7b whole, ``tp`` 1 (as the serve CLI sets it)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SSM_ARCH), tp=1)


def hybrid_config():
    """One period of jamba-v0.1-52b: 8 of its 32 layers, ``tp`` 1."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(HYBRID_ARCH),
                               n_layers=HYBRID_LAYERS, tp=1)


def hold_scan(op, i: int, args, kw, out) -> dict:
    """One call of the ``mamba_scan`` op ``op`` replayed on its ``torch``
    backend: y and the final state against the plain version's on the
    same operands at rtol = atol = 1e-4.  Returns its record (``over``:
    the values beyond)."""
    y, state = out
    t0 = time.perf_counter()
    want_y, want_state = op(*args, **dict(kw, backend="torch"))
    want_y = want_y.float()
    over = sum(int(((g.float() - w).abs() > SCAN_ATOL + SCAN_RTOL * w.abs())
                   .sum()) for g, w in ((y, want_y), (state, want_state)))
    return {"call": i, "u": list(args[0].shape), "over": over,
            "y_max_abs_err": float((y.float() - want_y).abs().max()),
            "state_max_abs_err": float((state - want_state).abs().max()),
            "hold_s": time.perf_counter() - t0}


@contextlib.contextmanager
def scans_held(held: list, keep=None, now: bool = True):
    """``op_calls`` for ``mamba_scan``: the calls whose index in the block
    is in ``keep`` (every call if None) are held at the op (``hold_scan``),
    right after the call (``now``) or, keeping their operands, when the
    block ends (outside a timed run).  Appends a record a call held."""
    count, pending = [0], []

    def call(op, *args, **kw):
        out = op(*args, **kw)
        if keep is None or count[0] in keep:
            if now:
                held.append(hold_scan(op, count[0], args, kw, out))
            else:
                pending.append((op, count[0], args, kw, out))
        count[0] += 1
        return out
    with op_calls("mamba_scan", call):
        yield
    while pending:
        held.append(hold_scan(*pending.pop(0)))


def check_scans(held: list, what: str, calls: int) -> None:
    log(f"{what}: {len(held)} mamba_scan calls held at the op (y and the "
        f"final state, rtol = atol = {SCAN_RTOL:g}), operands u "
        f"{held[0]['u'] if held else None}, max_abs_err y "
        f"{max((h['y_max_abs_err'] for h in held), default=0):.3e}, state "
        f"{max((h['state_max_abs_err'] for h in held), default=0):.3e} "
        f"(the holds {sum(h['hold_s'] for h in held):.3f} s)")
    over = [h for h in held if h["over"]]
    check(len(held) == calls and not over, f"{what}: {len(held)} of {calls} "
          f"mamba_scan calls held; off the plain version beyond rtol = "
          f"atol = {SCAN_RTOL:g} at the op: {over[:2]}")


@contextlib.contextmanager
def moe_routes(routes: list):
    """Inside the block every MoE routing appends (tokens, idx) to
    ``routes`` (``models.moe._routing`` wrapped)."""
    from repro_torch.models import moe
    routing = moe._routing

    def call(p, xf, cfg):
        out = routing(p, xf, cfg)
        routes.append((xf.shape[0], out[1]))
        return out
    moe._routing = call
    try:
        yield
    finally:
        moe._routing = routing


def dropped_share(routes: list, cfg, tokens: int):
    """(dropped assignments, assignments) over the routings of ``tokens``
    tokens: an assignment past its expert's capacity is dropped (the
    reference's rule)."""
    from repro_torch.models import moe
    dropped = total = 0
    C = moe.capacity(tokens, cfg)
    for t, idx in routes:
        if t == tokens:
            pos = moe.positions(idx.T.reshape(-1), cfg.n_experts)
            dropped += int((pos >= C).sum())
            total += pos.numel()
    return dropped, total


def scan_bound(cfg, batch: int, length: int):
    """The least time of one layer's scan at the model's shapes (fp32
    operands): u, dt, B, C read, y and the state written, against N
    exponentials a (b, t, d) on the SFU and the rest at the fp32 rate."""
    bld = batch * length * cfg.d_inner
    n = cfg.ssm_state
    n_bytes = 4 * (3 * bld + 2 * batch * length * n
                   + cfg.d_inner * (n + 1) + batch * cfg.d_inner * n)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    sfu_rate = SFU_PER_CLOCK * torch.cuda.get_device_properties(
        0).multi_processor_count * sm_clock_hz()
    t_sfu = bld * n / sfu_rate * 1e3
    t_ops = bld * (7 * n + 3) / PEAK_FP32 * 1e3
    return max((t_bytes, "bytes"), (t_sfu, "operations"),
               (t_ops, "operations"))


def served(what: str, gen, cfg, counts: dict, want: dict,
           shape=None) -> None:
    """The serve run's launches are ``want``; its tokens of ``shape``
    (default (``LM_BATCH``, ``LM_GEN``)) in the vocabulary."""
    got = {k: n for k, n in counts.items() if n}
    want = {k: n for k, n in want.items() if n}
    check(got == want, f"{what} serve launched {got}, not {want}")
    check(gen.shape == (shape or (LM_BATCH, LM_GEN)) and gen.dtype == np.int32
          and 0 <= gen.min() and gen.max() < cfg.vocab_size,
          f"{what} serve: generated {gen.shape} {gen.dtype} out of range")


def ssm_serve(dev) -> dict:
    """falcon-mamba-7b through ``serve.main`` (64 scans a prefill, none in
    decode), the served prefill's layers ``SSM_HELD_LAYERS`` and every
    layer of a ``SSM_SHORT_PROMPT``-token prefill held at the op, and a
    profiled prefill and decode."""
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    cfg = ssm_config()
    argv = ["--arch", SSM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen-len", str(LM_GEN), "--seed", str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = []
    out = io.StringIO()
    with scans_held(held, keep=set(SSM_HELD_LAYERS), now=False):
        reset_launch_counts()
        with contextlib.redirect_stdout(out):
            gen = serve.main(argv, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"ssm serve: {json.dumps(line)}; peak device memory {peak_gb:.2f} GB")
    served("ssm", gen, cfg, counts, {"mamba_scan": cfg.n_layers})
    check_scans(held, f"ssm serve ({LM_PROMPT}-token prefill, layers "
                f"{list(SSM_HELD_LAYERS)})", len(SSM_HELD_LAYERS))

    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    prompt = lm_prompt(cfg)
    short = torch.as_tensor(prompt[:, :SSM_SHORT_PROMPT], dtype=torch.int64,
                            device=dev)
    held_short = []
    reset_launch_counts()
    with scans_held(held_short):
        logits, _ = tfm.prefill(model, {"tokens": short}, cfg)
    torch.cuda.synchronize()
    short_counts = {k: n for k, n in launch_counts().items() if n}
    check(short_counts == {"mamba_scan": cfg.n_layers}, f"ssm: a "
          f"{SSM_SHORT_PROMPT}-token prefill launched {short_counts}")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "ssm: non-finite logits")
    check_scans(held_short, f"ssm {SSM_SHORT_PROMPT}-token prefill, every "
                f"layer", cfg.n_layers)
    del logits
    prof = model_profile(model, cfg, dev, {"tokens": torch.as_tensor(
        prompt, dtype=torch.int64, device=dev)}, LM_PROMPT + LM_GEN)
    del model
    torch.cuda.empty_cache()
    prof["scan_bound"] = scan_bound(cfg, LM_BATCH, LM_PROMPT)
    log_profile("ssm", prof)
    check(prof["finite"] and np.array_equal(prof["first_tokens"], gen[:, 0]),
          "ssm: the profiled prefill does not give the served first token")
    check(prof["scan_calls"] in (0, cfg.n_layers), "ssm: the profiled "
          "prefill traced another number of scan calls than layers")
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "held": held, "held_short": held_short, "profile": prof}


def hybrid_serve(dev) -> dict:
    """One period of jamba-v0.1-52b through ``serve.generate`` (7 scans
    and 1 ``flash_attention_mma`` a prefill, 1 ``flash_attention_splitkv``
    a decode step), the MoE's dropped share, then on the same weights a
    prefill and ``LM_FORCED`` decode steps with every scan and bf16 flash
    call held at the op, and a profiled prefill and decode."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    cfg = hybrid_config()
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    n_moe = cfg.ffn_kinds().count("moe")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routes = []
    reset_launch_counts()
    with moe_routes(routes):
        gen, line = serve.generate(cfg, batch=LM_BATCH,
                                   prompt_len=LM_PROMPT, gen_len=LM_GEN,
                                   seed=SEED, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"hybrid serve ({HYBRID_LAYERS} of 32 layers): {json.dumps(line)}; "
        f"peak device memory {peak_gb:.2f} GB")
    served("hybrid", gen, cfg, counts,
           {"mamba_scan": n_mamba, "flash_attention_mma": n_attn,
            "flash_attention_splitkv": n_attn * LM_GEN})
    drops = {"prefill": dropped_share(routes, cfg, LM_BATCH * LM_PROMPT),
             "decode": dropped_share(routes, cfg, LM_BATCH)}
    check(drops["prefill"][1] == n_moe * LM_BATCH * LM_PROMPT * cfg.top_k
          and drops["decode"][1] == n_moe * LM_GEN * LM_BATCH * cfg.top_k,
          f"hybrid: MoE routings {[(t, tuple(i.shape)) for t, i in routes][:3]}"
          f" are not one a MoE layer a step")
    del routes
    from repro_torch.models.moe import capacity
    log(f"hybrid MoE dropped assignments: prefill {drops['prefill'][0]} of "
        f"{drops['prefill'][1]} (capacity "
        f"{capacity(LM_BATCH * LM_PROMPT, cfg)} an expert), decode "
        f"{drops['decode'][0]} of {drops['decode'][1]} (capacity "
        f"{capacity(LM_BATCH, cfg)} an expert)")

    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    prompt = lm_prompt(cfg)
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    flash, held = [], []
    reset_launch_counts()
    with flash_held_at_op(flash), scans_held(held):
        logits, state = tfm.prefill(model, {"tokens": tokens}, cfg,
                                    cache_len=LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    moved = {k: n for k, n in launch_counts().items() if n}
    check(moved == {"mamba_scan": n_mamba, "flash_attention_mma": n_attn},
          f"hybrid prefill launched {moved}")
    check(np.array_equal(logits.argmax(-1).cpu().numpy(), gen[:, 0]),
          "hybrid: the prefill does not give the served first token")
    check_scans(held, f"hybrid {LM_PROMPT}-token prefill, every mamba "
                f"layer", n_mamba)
    for tok in gen[:, :LM_FORCED].T:  # the served tokens, fed back
        reset_launch_counts()
        with flash_held_at_op(flash), scans_held(held):
            logits, state = tfm.decode_step(
                model, state, torch.as_tensor(tok, dtype=torch.int64,
                                              device=dev), cfg)
        torch.cuda.synchronize()
        moved = {k: n for k, n in launch_counts().items() if n}
        check(moved == {"flash_attention_splitkv": n_attn}
              and len(held) == n_mamba,
              f"hybrid decode step launched {moved}")
    over = [h for h in flash if h["over"]]
    log(f"hybrid: bf16 flash held at the op in {len(flash)} calls (prefill "
        f"q {flash[0]['q']} kv {flash[0]['kv']}, then {LM_FORCED} decode "
        f"steps), max_abs_err "
        f"{max(h['max_abs_err'] for h in flash):.3e} (the holds "
        f"{sum(h['hold_s'] for h in flash):.3f} s)")
    check(len(flash) == n_attn * (1 + LM_FORCED) and not over,
          f"hybrid: flash off the plain version beyond one bf16 ulp + "
          f"{FA_BF16_SLACK:g} at the op: {over[:2]}")
    del state, logits
    prof = model_profile(model, cfg, dev, {"tokens": tokens},
                         LM_PROMPT + LM_GEN)
    del model
    torch.cuda.empty_cache()
    prof["scan_bound"] = scan_bound(cfg, LM_BATCH, LM_PROMPT)
    log_profile("hybrid", prof)
    check(prof["finite"] and np.array_equal(prof["first_tokens"], gen[:, 0]),
          "hybrid: the profiled prefill does not give the served first "
          "token")
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "drops": drops, "held": held, "flash_held": len(flash),
            "profile": prof}


def families_phase(dev) -> dict:
    """Phase 9: falcon-mamba-7b whole and one period of jamba-v0.1-52b
    through the port's serving path (the module docstring's item 9)."""
    t_phase = time.perf_counter()
    ssm = ssm_serve(dev)
    hybrid = hybrid_serve(dev)
    wall = time.perf_counter() - t_phase
    log(f"ssm/hybrid: phase {wall:.1f} s")
    launches = {k: ssm["launches"][k] + hybrid["launches"][k]
                for k in ssm["launches"]}
    return {"ssm": ssm, "hybrid": hybrid, "launches": launches,
            "wall_s": wall}


# -- phase 10: the encdec and vlm families ------------------------------------

def encdec_config():
    """whisper-small whole, ``tp`` 1 (as the serve CLI sets it)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ENCDEC_ARCH), tp=1)


def vlm_config():
    """llava-next-34b cut to ``VLM_LAYERS`` of its 60 layers, ``tp`` 1."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS,
                               tp=1)


def stub_inputs(cfg, batch: int, dev) -> dict:
    """The stub frontend's seeded N(0, 1) output in the model's dtype:
    ``frames`` (batch, n_frames, d) for encdec, ``patches`` (batch,
    n_patches, d) for vlm."""
    key, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
              else ("patches", cfg.n_patches))
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    return {key: torch.randn(batch, n, cfg.d_model, generator=gen,
                             device=dev).to(cfg.torch_dtype())}


def serve_family(what: str, cfg, dev, batch: int, prompt_len: int,
                 gen_len: int, stub: dict):
    """``serve.generate`` on the stub inputs, its launches checked
    (``flash_calls``: the prefill's on ``flash_attention_mma``, a decode
    step's on split-KV).  Returns (tokens, JSON line, launches, peak GB)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    gen, line = serve.generate(cfg, batch=batch, prompt_len=prompt_len,
                               gen_len=gen_len, seed=SEED, device=dev,
                               **stub)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{what} serve ({cfg.n_layers} layers): {json.dumps(line)}; peak "
        f"device memory {peak_gb:.2f} GB")
    n_prefill, n_step = flash_calls(cfg)
    served(what, gen, cfg, counts,
           {"flash_attention_mma": n_prefill,
            "flash_attention_splitkv": n_step * gen_len},
           shape=(batch, gen_len))
    return gen, line, counts, peak_gb


def encdec_serve(dev) -> dict:
    """whisper-small through ``serve.generate`` on seeded frames (36
    ``flash_attention_mma`` a prefill, 24 split-KV a step); on the same
    weights and inputs the prefill and ``LM_FORCED`` teacher-forced steps
    through the kernels and on plain attention, in bf16 (every flash call
    held at the op) and in fp32 (logits within 24 x ``LM_FP32_TOL``); a
    profiled prefill (the encoder apart) and decode."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    cfg = encdec_config()
    stub = stub_inputs(cfg, ENCDEC_BATCH, dev)
    gen, line, counts, peak_gb = serve_family(
        "encdec", cfg, dev, ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_GEN, stub)

    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    batch = {"tokens": torch.as_tensor(
        lm_prompt(cfg, ENCDEC_BATCH, ENCDEC_PROMPT), dtype=torch.int64,
        device=dev), **stub}
    cache_len = ENCDEC_PROMPT + ENCDEC_GEN
    forced = gen[:, :LM_FORCED].T  # the served tokens, fed back
    got16, plain16, state = lm_against_plain(model, cfg, dev, batch, forced,
                                             cache_len)
    check(np.array_equal(got16[0].argmax(-1).cpu().numpy(), gen[:, 0]),
          "encdec: the kernels' prefill does not give the served first "
          "token")
    del state
    prof = model_profile(model, cfg, dev, batch, cache_len)
    check(prof["finite"] and np.array_equal(prof["first_tokens"], gen[:, 0]),
          "encdec: the profiled prefill does not give the served first "
          "token")
    # the decoder's mma calls (self and cross) by difference from the
    # encoder's, profiled alone
    enc_calls = prof["encoder_mma_calls"]
    dec_calls = prof["mma_calls"] - enc_calls
    prof["decoder_mma_calls"] = dec_calls
    prof["decoder_mma_device_ms"] = (
        (prof["mma_device_ms"] * prof["mma_calls"]
         - prof["encoder_mma_device_ms"] * enc_calls) / dec_calls
        if dec_calls > 0 else None)
    bh, d, f, p = ENCDEC_BATCH * cfg.n_heads, cfg.head_dim, cfg.n_frames, \
        ENCDEC_PROMPT
    keys = p + (LM_PROFILE_STEPS + 1) / 2
    prof["encoder_mma_bound"] = attention_bound(bh, f, f, d, False)
    prof["decoder_mma_bound"] = mean_bound(
        attention_bound(bh, p, p, d, True), attention_bound(bh, p, f, d,
                                                            False))
    prof["mma_bound"] = None  # the two callers' bounds stand apart
    prof["splitkv_bound"] = mean_bound(
        attention_bound(bh, 1, keys, d, True), attention_bound(bh, 1, f, d,
                                                               False))
    log_profile("encdec", prof)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = lm_fp32_copy(model, cfg32, dev)
    del model
    torch.cuda.empty_cache()
    got32, plain32, _ = lm_against_plain(model32, cfg32, dev, batch, forced,
                                         cache_len)
    del model32
    torch.cuda.empty_cache()
    err16, floor16, err32 = logits_against_plain(
        "encdec", got16, plain16, got32, plain32,
        cfg.n_layers + cfg.encoder_layers)
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "bf16_err": err16, "bf16_bound": floor16, "fp32_err": err32,
            "profile": prof}


def vlm_serve(dev) -> dict:
    """llava-next-34b cut to ``VLM_LAYERS`` layers through
    ``serve.generate`` on seeded patches (one ``flash_attention_mma`` a
    layer a prefill, one split-KV a layer a step); on the same weights a
    prefill with the flash calls of ``VLM_HELD_LAYERS`` held at the op and
    ``LM_FORCED`` teacher-forced steps with every flash call held; a
    profiled prefill and decode."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tfm
    cfg = vlm_config()
    n = cfg.n_layers
    stub = stub_inputs(cfg, VLM_BATCH, dev)
    gen, line, counts, peak_gb = serve_family(
        "vlm", cfg, dev, VLM_BATCH, VLM_PROMPT, VLM_GEN, stub)

    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    batch = {"tokens": torch.as_tensor(
        lm_prompt(cfg, VLM_BATCH, VLM_PROMPT), dtype=torch.int64,
        device=dev), **stub}
    cache_len = VLM_PROMPT + VLM_GEN + cfg.n_patches
    flash = []
    reset_launch_counts()
    with flash_held_at_op(flash, keep=set(VLM_HELD_LAYERS)):
        logits, state = tfm.prefill(model, batch, cfg, cache_len=cache_len)
    torch.cuda.synchronize()
    moved = {k: c for k, c in launch_counts().items() if c}
    check(moved == {"flash_attention_mma": n}, f"vlm prefill launched "
          f"{moved}")
    check(np.array_equal(logits.argmax(-1).cpu().numpy(), gen[:, 0]),
          "vlm: the prefill does not give the served first token")
    for tok in gen[:, :LM_FORCED].T:  # the served tokens, fed back
        reset_launch_counts()
        with flash_held_at_op(flash):
            logits, state = tfm.decode_step(
                model, state, torch.as_tensor(tok, dtype=torch.int64,
                                              device=dev), cfg)
        torch.cuda.synchronize()
        moved = {k: c for k, c in launch_counts().items() if c}
        check(moved == {"flash_attention_splitkv": n},
              f"vlm decode step launched {moved}")
    over = [h for h in flash if h["over"]]
    log(f"vlm: bf16 flash held at the op in {len(flash)} calls (prefill "
        f"layers {list(VLM_HELD_LAYERS)}, q {flash[0]['q']} kv "
        f"{flash[0]['kv']}; then every layer of {LM_FORCED} decode steps, "
        f"q {flash[-1]['q']} kv {flash[-1]['kv']}), max_abs_err "
        f"{max(h['max_abs_err'] for h in flash):.3e} (the holds "
        f"{sum(h['hold_s'] for h in flash):.3f} s)")
    check([h["call"] for h in flash[:len(VLM_HELD_LAYERS)]]
          == list(VLM_HELD_LAYERS)
          and len(flash) == len(VLM_HELD_LAYERS) + n * LM_FORCED
          and not over, f"vlm: flash off the plain version beyond one bf16 "
          f"ulp + {FA_BF16_SLACK:g} at the op: {over[:2]}")
    del state, logits
    prof = model_profile(model, cfg, dev, batch, cache_len)
    del model
    torch.cuda.empty_cache()
    check(prof["finite"] and np.array_equal(prof["first_tokens"], gen[:, 0]),
          "vlm: the profiled prefill does not give the served first token")
    # the prefill expands the 8 KV heads to the 56 query heads; a decode
    # step folds each KV head's 7 query heads over its own keys
    s = VLM_PROMPT + cfg.n_patches
    bh, d = VLM_BATCH * cfg.n_heads, cfg.head_dim
    prof["mma_bound"] = attention_bound(bh, s, s, d, True)
    keys = s + (LM_PROFILE_STEPS + 1) / 2
    prof["splitkv_bound"] = attention_bound(
        VLM_BATCH * cfg.n_kv_heads, cfg.group_size, keys, d, False)
    log_profile("vlm", prof)
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "flash_held": len(flash), "profile": prof}


def encdec_vlm_phase(dev) -> dict:
    """Phase 10: whisper-small whole and llava-next-34b cut in depth
    through the port's serving path (the module docstring's item 10)."""
    t_phase = time.perf_counter()
    encdec = encdec_serve(dev)
    vlm = vlm_serve(dev)
    wall = time.perf_counter() - t_phase
    log(f"encdec/vlm: phase {wall:.1f} s")
    launches = {k: encdec["launches"][k] + vlm["launches"][k]
                for k in encdec["launches"]}
    return {"encdec": encdec, "vlm": vlm, "launches": launches,
            "wall_s": wall}


# -- phase 11: training ---------------------------------------------------------

def train_config():
    """olmo-1b whole, ``tp`` 1 (as the trainer CLI sets it)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH), tp=1)


def train_argv(steps: int, *extra) -> list:
    return ["--arch", TRAIN_ARCH, "--steps", str(steps), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--lr",
            str(TRAIN_LR), "--seed", str(SEED), "--log-every", "1", *extra]


@contextlib.contextmanager
def step_times(times: list):
    """Inside the block the trainer's watchdog appends each step's time to
    ``times``: from the step's start to its loss read back on the host (a
    synchronize), the optimizer's update included."""
    from repro_torch.launch import train
    base = train.Watchdog

    class Timed(base):
        def end_step(self):
            dt = super().end_step()
            times.append(dt)
            return dt

    train.Watchdog = Timed
    try:
        yield
    finally:
        train.Watchdog = base


def run_train(what: str, argv: list, dev) -> dict:
    """``train.main(argv)`` on the card: its losses (each finite), JSON
    line, launches, step times and peak memory."""
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, out = [], io.StringIO()
    t0 = time.perf_counter()
    with step_times(times), contextlib.redirect_stdout(out):
        losses = train.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    lines = out.getvalue().strip().splitlines()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train {what}: {len(losses)} steps in {wall:.1f} s; losses "
        f"{json.dumps(losses)}; step times (s) {json.dumps(times)}; "
        f"launches {json.dumps({k: n for k, n in counts.items() if n})}; "
        f"peak device memory {peak_gb:.2f} GB")
    check(all(np.isfinite(losses)), f"train {what}: a loss is not finite")
    line = json.loads(lines[-1]) if lines[-1].startswith("{") else None
    return {"losses": losses, "line": line, "launches": counts,
            "times": times, "peak_gb": peak_gb, "wall_s": wall}


def launched(what: str, counts: dict, want: dict) -> None:
    got = {k: n for k, n in counts.items() if n}
    want = {k: n for k, n in want.items() if n}
    check(got == want, f"{what} launched {got}, not {want}")


@contextlib.contextmanager
def train_flash_held(held: list, kept: dict, keep):
    """``op_calls`` for ``flash_attention`` in a training step: every call
    held at the op right after it (the kernel's bf16 output against the
    plain version's fp32 result on the same operands, at the ops phase's
    contract), and the operands of the calls in ``keep`` kept."""
    from repro_torch.backends import registry
    count = [0]

    def call(op, q, k, v, **kw):
        out = op(q, k, v, **kw)
        i, count[0] = count[0], count[0] + 1
        ops_in = [t.detach() for t in (q, k, v)]
        with torch.no_grad(), registry.use_backend("torch"):
            want32 = op(*(t.float() for t in ops_in), **kw)
        g = out.detach().float()
        slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) \
            + FA_BF16_SLACK
        held.append({"call": i, "q": list(q.shape),
                     "over": int(((g - want32).abs() > slack).sum()),
                     "max_abs_err": float((g - want32).abs().max())})
        if i in keep:
            kept[i] = ([t.clone() for t in ops_in], kw)
        return out
    with op_calls("flash_attention", call):
        yield


def attention_grads_held(kept: dict, dev) -> dict:
    """The attention ``Function``'s gradients on each kept call's bf16
    operands (a seeded dO) against autograd through the plain fp32
    version of the same operands (``FA_GRAD_SLACK``); the forward kernel
    and the torch backward timed at that call's shape."""
    from repro_torch.kernels import grad as kgrad
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for i, ((q, k, v), kw) in sorted(kept.items()):
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_launch_counts()
        got = torch.autograd.grad(ops.flash_attention(*args, **kw), args,
                                  dout)
        torch.cuda.synchronize()
        launched(f"train: the attention Function of call {i}",
                 launch_counts(), {"flash_attention_mma": 1})
        args32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention(
            *args32, causal=kw["causal"], scale=kw["scale"],
            q_offset=kw.get("q_offset", 0)), args32, dout.float())
        rec = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g = g.float()
            slack = bf16_ulp(torch.maximum(g.abs(), w.abs())) \
                + FA_GRAD_SLACK * float(w.abs().max())
            rec[name] = {"over": int(((g - w).abs() > slack).sum()),
                         "max_abs_err": float((g - w).abs().max()),
                         "rel_fro": errors(g, w)[2]}
        del want, args32
        scale, causal = kw["scale"], kw["causal"]
        with torch.no_grad():
            fwd_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), 5)
        bwd_ms = time_ms(lambda: kgrad.attention_backward(
            q, k, v, dout, causal=causal, scale=scale,
            q_offset=kw.get("q_offset", 0), chunk=kw["chunk"]), 3)
        out[i] = {**rec, "shape": list(q.shape), "fwd_ms": fwd_ms,
                  "bwd_torch_ms": bwd_ms}
        log(f"train: attention call {i} {list(q.shape)} bf16: the "
            f"Function's gradients vs autograd through plain fp32 "
            f"{json.dumps(rec)} (bound: one bf16 ulp + {FA_GRAD_SLACK:g} "
            f"x max |want|); forward kernel {fwd_ms:.4f} ms, torch "
            f"backward {bwd_ms:.4f} ms")
        check(all(r["over"] == 0 for r in rec.values()),
              f"train: the attention Function's gradients of call {i} "
              f"are off the plain fp32 gradients: {rec}")
    return out


def step_profile(model, cfg, state, opt_cfg, batch) -> dict:
    """One training step's forward, backward and optimizer update, each
    under torch.profiler apart: device time, wall, the flash kernel's
    device time a call in the forward and in the backward's recompute."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    params = dict(model.named_parameters())
    box = {}

    def region(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        mma = [e for e in events if "flash_mma_kernel" in e.key]
        calls = sum(e.count for e in mma)
        return {"wall_s": wall,
                "device_s": sum(e.device_time_total for e in events) / 1e6,
                "mma_calls": calls,
                "mma_device_ms": (sum(e.device_time_total for e in mma)
                                  / 1e3 / calls if calls else None),
                "top": [{"name": e.key[:72], "calls": e.count,
                         "s": e.device_time_total / 1e6} for e in sorted(
                             events, key=lambda e: -e.device_time_total)[:8]]}

    def forward():
        box["loss"], _ = tfm.loss_fn(model, batch, cfg)

    def backward():
        box["grads"] = dict(zip(params, torch.autograd.grad(
            box.pop("loss"), list(params.values()))))

    def update():
        adamw.update(box.pop("grads"), state.opt, params, opt_cfg)

    out = {name: region(fn) for name, fn in (("forward", forward),
                                              ("backward", backward),
                                              ("optimizer", update))}
    wall = sum(r["wall_s"] for r in out.values())
    busy = sum(r["device_s"] for r in out.values())
    out["step"] = {"wall_s": wall, "device_s": busy,
                   "busy_share": busy / wall}
    return out


def fp32_step_grads(cfg, batch, dev) -> dict:
    """One fp32 step's gradients of olmo-1b (its own seeded weights) with
    attention on the kernels (``flash_attention_tf32x3``, the Function's
    backward) and on the op's ``torch`` backend: each parameter's within
    n_layers x ``LM_FP32_TOL`` relative Frobenius."""
    import dataclasses
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tfm
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = tfm.init_model(cfg32, seed=SEED, device=dev, train=True)
    params = list(model.parameters())

    def grads():
        loss, _ = tfm.loss_fn(model, batch, cfg32)
        return loss.detach(), torch.autograd.grad(loss, params)

    reset_launch_counts()
    loss_k, got = grads()
    torch.cuda.synchronize()
    launched("train fp32 step", launch_counts(),
             {"flash_attention_tf32x3": 2 * cfg.n_layers})
    reset_launch_counts()
    with registry.use_backend("torch"):
        loss_t, want = grads()
    torch.cuda.synchronize()
    launched("train fp32 step on the torch backend", launch_counts(), {})
    errs = {name: errors(g, w)[2] for (name, _), g, w in zip(
        model.named_parameters(), got, want)}
    tol = cfg.n_layers * LM_FP32_TOL
    worst = max(errs, key=errs.get)
    log(f"train fp32 step: loss {float(loss_k):.7f} (kernels) vs "
        f"{float(loss_t):.7f} (plain attention); gradients rel-Frobenius "
        f"at most {errs[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(errs.values()))):.3e} (bound {tol:.2e})")
    check(errs[worst] <= tol, f"train fp32 step: {worst}'s gradient "
          f"{errs[worst]:.3e} off the plain version (> {tol:.2e})")
    return {"max_err": errs[worst], "worst": worst, "tol": tol}


def scan_grads_held(dev) -> dict:
    """The scan's ``Function`` at falcon-mamba-7b's layer widths in fp32:
    its gradients (the chunked adjoint, chunk ``mamba_chunk``) against
    autograd through the plain version, and the forward kernel's and the
    torch backward's times."""
    from repro_torch.kernels import grad as kgrad
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    b, length, d, n = SCAN_GRAD_SHAPE
    chunk = ssm_config().mamba_chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u, B, C = randn(b, length, d), randn(b, length, n), randn(b, length, n)
    dt = torch.nn.functional.softplus(randn(b, length, d) - 4.0)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        d, n).contiguous()
    D = torch.ones(d, device=dev)
    dy, dstate = randn(b, length, d), randn(b, d, n)
    args = [t.requires_grad_(True) for t in (u, dt, A, B, C, D)]
    reset_launch_counts()
    got = torch.autograd.grad(ops.mamba_scan(*args, chunk=chunk,
                                             return_state=True), args,
                              (dy, dstate))
    torch.cuda.synchronize()
    launched("train: the scan Function", launch_counts(), {"mamba_scan": 1})
    t0 = time.perf_counter()
    want = torch.autograd.grad(ref.mamba_scan(*args, return_state=True),
                               args, (dy, dstate))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    names = ("du", "ddelta", "dA", "dB", "dC", "dD")
    errs = {nm: errors(g, w)[2] for nm, g, w in zip(names, got, want)}
    plain = [t.detach() for t in args]
    with torch.no_grad():
        fwd_ms = time_ms(lambda: ops.mamba_scan(*plain, return_state=True),
                         3)
    bwd_ms = time_ms(lambda: kgrad.scan_backward(
        *plain, dy, dstate, chunk=chunk), 2)
    log(f"train: scan Function at {list(SCAN_GRAD_SHAPE)} fp32: gradients "
        f"vs autograd through plain {json.dumps(errs)} (bound "
        f"{SCAN_GRAD_TOL:g}); forward kernel {fwd_ms:.4f} ms, torch "
        f"backward {bwd_ms:.3f} ms (chunk {chunk}), autograd through the "
        f"plain loop {plain_s:.3f} s wall")
    check(max(errs.values()) <= SCAN_GRAD_TOL, f"train: the scan "
          f"Function's gradients off the plain version: {errs}")
    return {"errs": errs, "fwd_ms": fwd_ms, "bwd_torch_ms": bwd_ms,
            "plain_autograd_s": plain_s}


def train_phase(dev) -> dict:
    """Phase 11: training olmo-1b whole on the card (the module
    docstring's item 11)."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import accounting
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import CompressionConfig

    t_phase = time.perf_counter()
    cfg = train_config()
    L = cfg.n_layers
    flash = {"flash_attention_mma": 2 * L * TRAIN_STEPS}  # forward, remat
    deterministic = torch.are_deterministic_algorithms_enabled()
    # the embedding's backward adds with atomics: deterministic kernels
    # make the resumed run's losses bitwise the uninterrupted run's
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        main = run_train("olmo-1b", train_argv(TRAIN_STEPS), dev)
        losses = main["losses"]
        launched("train olmo-1b", main["launches"], flash)
        check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
              f"train olmo-1b: the loss did not fall ({losses})")
        step_s = float(np.median(main["times"][1:]))
        shape = ShapeCell("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
        flops = accounting.model_flops(cfg, shape)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        mfu = flops / step_s / PEAK_BF16
        log(f"train olmo-1b: step {step_s:.4f} s (median of steps 2-"
            f"{TRAIN_STEPS}, host clock ending in a synchronize), "
            f"{tokens / step_s:.1f} tokens/s, model FLOP/s "
            f"{flops / step_s:.4e} = {mfu:.4f} of the bf16 peak "
            f"({flops:.4e} FLOP a step, 6 x {accounting.param_counts(cfg)['total']} "
            f"x {tokens}); first step {main['times'][0]:.3f} s; peak "
            f"device memory {main['peak_gb']:.2f} GB; {json.dumps(main['line'])}")

        # compression sees the reference's layout: a layer leaf stacked
        # over the layers, one Gram and its sweeps a stacked leaf
        comp_cfg = CompressionConfig(rank=TRAIN_COMP_RANK)
        meta = dict(Transformer(cfg, "meta").named_parameters())
        stacked = steps_mod.stack_layers(meta, cfg)
        n_comp = sum(1 for p in stacked.values() if p.ndim >= 2
                     and p.numel() >= comp_cfg.min_size)
        calls = {}
        with pca_calls_kept(calls):
            comp = run_train("compressed, int8 moments", train_argv(
                TRAIN_COMP_STEPS, "--compress-grads", str(TRAIN_COMP_RANK),
                "--moments", "int8"), dev)
        want = {"flash_attention_mma": 2 * L * TRAIN_COMP_STEPS,
                "covariance": TRAIN_COMP_STEPS * n_comp,
                "jacobi_sweep_smem": TRAIN_COMP_STEPS * n_comp
                * comp_cfg.jacobi_sweeps}
        launched("train compressed", comp["launches"], want)
        check(len(calls["covariance"]) == want["covariance"]
              and len(calls["jacobi_sweep"]) == want["jacobi_sweep_smem"],
              f"train compressed: {len(calls['covariance'])} Gram and "
              f"{len(calls['jacobi_sweep'])} sweep calls kept for {want}")
        gram_err, sweeps_apart = pca_calls_against_plain(calls)
        grams = sorted({tuple(args[0].shape)
                        for args, _, _ in calls["covariance"]})
        del calls
        check(gram_err <= LM_GRAM_TOL, f"train compressed: a Gram off the "
              f"plain Gram ({gram_err:.3e} > {LM_GRAM_TOL:g})")
        check(sweeps_apart == 0, f"train compressed: {sweeps_apart} sweeps "
              f"differ bitwise from the plain sweep")
        # the same schedule and moments without compression: what the
        # losses do at lr 3e-3 apart from it
        plain = run_train("int8 moments", train_argv(
            TRAIN_COMP_STEPS, "--moments", "int8"), dev)
        launched("train int8", plain["launches"],
                 {"flash_attention_mma": 2 * L * TRAIN_COMP_STEPS})
        log(f"train compressed: {n_comp} stacked leaves compressed a step "
            f"(one Gram and {comp_cfg.jacobi_sweeps} sweeps each; Gram "
            f"operands {grams}); every Gram within {gram_err:.3e} of the "
            f"plain Gram, every sweep bitwise the plain sweep; losses "
            f"{json.dumps(comp['losses'])} against "
            f"{json.dumps(plain['losses'])} uncompressed")

        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
        ckpt = ["--ckpt-dir", str(TRAIN_CKPT)]
        first = run_train("preempted", train_argv(
            TRAIN_STEPS, "--preempt-at", str(TRAIN_PREEMPT_AT), *ckpt), dev)
        rest = run_train("resumed", train_argv(TRAIN_STEPS, *ckpt), dev)
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
        resumed = first["losses"] + rest["losses"]
        diff = max(abs(a - b) for a, b in zip(resumed, losses))
        log(f"train: preempted at {TRAIN_PREEMPT_AT} and resumed: losses "
            f"{json.dumps(resumed)}, max |difference| from the "
            f"uninterrupted run {diff:.3e} (held: bitwise, deterministic "
            f"kernels)")
        check(resumed == losses, "train: the preempted and resumed run's "
              "losses differ from the uninterrupted run's")
        launched("train preempted", first["launches"],
                 {"flash_attention_mma": 2 * L * TRAIN_PREEMPT_AT})
        launched("train resumed", rest["launches"], {
            "flash_attention_mma": 2 * L * (TRAIN_STEPS - TRAIN_PREEMPT_AT)})
    finally:
        torch.use_deterministic_algorithms(deterministic)
    launches = {k: sum(r["launches"][k]
                       for r in (main, comp, plain, first, rest))
                for k in main["launches"]}

    # one step of the same seeded model on the pipeline's first batch: every
    # flash call held at the op, the operands of layers 0 and L - 1 kept
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=max(
        2, TRAIN_STEPS // 10), decay_steps=TRAIN_STEPS)
    model = tfm.init_model(cfg, seed=SEED, device=dev, train=True)
    params = dict(model.named_parameters())
    state = steps_mod.TrainState(model, adamw.init(params, opt_cfg),
                                 torch.zeros((), dtype=torch.int32,
                                             device=dev))
    step_fn, _ = steps_mod.build_train_step(cfg, shape, opt_cfg,
                                            device=dev)
    pipe = TokenPipeline(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=SEED))
    batch = {"tokens": torch.as_tensor(pipe.batch_at(0)[:, :TRAIN_SEQ],
                                       dtype=torch.int64, device=dev)}
    held, kept = [], {}
    reset_launch_counts()
    with train_flash_held(held, kept, keep=(0, L - 1)):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    launched("train held step", launch_counts(),
             {"flash_attention_mma": 2 * L})
    over = [h for h in held if h["over"]]
    log(f"train held step: loss {float(metrics['loss']):.7f} (the "
        f"trainer's first {losses[0]:.7f}); {len(held)} flash calls held "
        f"at the op, max_abs_err "
        f"{max(h['max_abs_err'] for h in held):.3e}")
    check(len(held) == 2 * L and not over, f"train: a flash call of the "
          f"step off the plain version beyond one bf16 ulp + "
          f"{FA_BF16_SLACK:g}: {over[:2]}")
    attn = attention_grads_held(kept, dev)
    del kept
    prof = step_profile(model, cfg, state, opt_cfg, batch)
    bh = TRAIN_BATCH * cfg.n_heads
    fwd_bound = attention_bound(bh, TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim, True)
    scores = TRAIN_SEQ * (TRAIN_SEQ + 1) / 2
    bwd_bound = bound_ms(2 * bh * cfg.head_dim * TRAIN_SEQ * 8,
                         10 * bh * cfg.head_dim * scores, PEAK_BF16)
    log(f"train step profile: " + "; ".join(
        f"{name} {r['wall_s']:.4f} s wall, {r['device_s']:.4f} s on the "
        f"device" for name, r in prof.items() if name != "step")
        + f"; busy share {prof['step']['busy_share']:.3f}; "
        f"flash_attention_mma {prof['forward']['mma_device_ms']:.4f} ms a "
        f"call in the forward, {prof['backward']['mma_device_ms']:.4f} in "
        f"the recompute (bound {fwd_bound[0]:.4f}, {fwd_bound[1]}); torch "
        f"attention backward {attn[0]['bwd_torch_ms']:.3f} ms a layer "
        f"(a backward kernel's bound {bwd_bound[0]:.4f}, {bwd_bound[1]})")
    for name in ("forward", "backward", "optimizer"):
        log(f"train step {name} by device time: "
            f"{json.dumps(prof[name]['top'])}")
    del model, state, params, step_fn
    torch.cuda.empty_cache()
    fp32 = fp32_step_grads(cfg, batch, dev)
    torch.cuda.empty_cache()
    scan = scan_grads_held(dev)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"train: phase {wall:.1f} s")
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "tokens_per_s": tokens / step_s, "model_flops_per_s":
            flops / step_s, "mfu": mfu, "peak_gb": main["peak_gb"],
            "comp_losses": comp["losses"], "int8_losses": plain["losses"],
            "comp_gram_err": gram_err, "resumed": resumed,
            "attention": attn, "profile": prof, "fwd_bound": fwd_bound,
            "bwd_bound": bwd_bound, "fp32": fp32, "scan": scan,
            "wall_s": wall}


# -- phase 12: the mesh -------------------------------------------------------

def mesh_fit(main_run: dict, mesh) -> dict:
    """(a) ``fit_distributed`` of phase 3's matrix over ``mesh`` with
    phase 3's config and ``tol=MESH_FIT_TOL`` (which it reads as the
    reference does: the Gram on
    ``torch.matmul``, the unfused solve), its eigenvalues held to phase
    3's fit and to float64 numpy of the same Gram at the fp32 ``eigh``
    budget; the sweeps it ran counted at ``core.jacobi._sweep_scan``."""
    import dataclasses
    from repro_torch.core import fit_distributed
    from repro_torch.core import jacobi
    from repro_torch.core.precision import ERROR_BUDGETS

    X = main_run["X"]
    rows = X.shape[0] - X.shape[0] % mesh.size
    config = dataclasses.replace(main_run["config"], tol=MESH_FIT_TOL)
    sweeps = [0]
    real = jacobi._sweep_scan

    def counted(*args, **kw):
        sweeps[0] += 1
        return real(*args, **kw)

    jacobi._sweep_scan = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_distributed(X[:rows], mesh, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        jacobi._sweep_scan = real
    w = res.eigenvalues.cpu().numpy()
    budget = ERROR_BUDGETS["fp32"]["eigh"]
    if rows == X.shape[0]:
        err_fit = rel_frobenius(w, main_run["eigenvalues"])
        w64 = main_run["eigenvalues64"]
    else:  # rows that divide the mesh: phase 3's fit saw others
        err_fit = None
        X64 = X[:rows].astype(np.float64)
        std = X64.std(axis=0)
        std[std < 1e-8] = 1.0
        Xs = (X64 - X64.mean(axis=0)) / std
        w64 = np.linalg.eigvalsh(Xs.T @ Xs)[::-1]
    err64 = rel_frobenius(w, w64)
    where = ", ".join(str(d) for d in mesh.devices.flat)
    vs_fit = "not run" if err_fit is None else f"{err_fit:.3e}"
    log(f"mesh fit: fit_distributed({rows}x{X.shape[1]}) over mesh("
        f"{dict(mesh.shape)}; {where}) wall {wall:.3f} s, {sweeps[0]} sweeps "
        f"(sweeps={config.sweeps}, tol={config.tol}), off_norm "
        f"{float(res.off_norm):.3e}; eigenvalue rel-Frobenius vs phase 3's "
        f"fit {vs_fit}, vs float64 numpy {err64:.3e} (budget {budget:g})")
    check(np.isfinite(w).all() and w.shape == (X.shape[1],),
          "fit_distributed: eigenvalues not finite or misshapen")
    check(err_fit is None or err_fit <= budget,
          f"fit_distributed off phase 3's fit: {vs_fit}")
    check(err64 <= budget, f"fit_distributed off float64 numpy: {err64:.3e}")
    return {"devices": mesh.size, "rows": rows, "wall_s": wall,
            "sweeps": sweeps[0], "err_fit": err_fit, "err64": err64,
            "off_norm": float(res.off_norm)}


def mesh_serve(serve: dict, mesh, guarded: list) -> dict:
    """(b) Phase 6's 96 requests through ``PCAServer`` with
    ``MeshExecutor(mesh=mesh)`` at each of ``SERVE_DEPTHS``, a cold and a
    warm pass, ``submit`` under ``no_sync``: every result bitwise phase
    6's ``LocalExecutor`` result (on one card) or within the fp32 budget
    of float64 numpy (on more, whose shards solve smaller batches)."""
    import dataclasses
    import warnings
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.serving import BucketPolicy, MeshExecutor, PCAServer

    burst, local = serve["burst"], serve["served"]
    budget = ERROR_BUDGETS["fp32"]
    want = [reference_values(op, a) for op, a in burst]
    runs = {}
    for depth in SERVE_DEPTHS:
        ex = MeshExecutor(mesh=mesh)
        ex.submit = no_sync(ex.submit, guarded)
        with warnings.catch_warnings():  # the kwarg shim's deprecation
            warnings.simplefilter("ignore", DeprecationWarning)
            srv = PCAServer(serve_config(),
                            policy=BucketPolicy(T=FLUSH_T, mode="pow2"),
                            max_inflight=depth, executor=ex)
        run = runs[depth] = {}
        for name in ("cold", "warm"):
            served, wall, stats = serve_pass(srv, burst)
            summary = stats.summary()
            shards = sorted({r.n_shards for r in stats.records})
            run[name] = {"wall_s": wall, "flushes": summary["flushes"],
                         "requests_per_s": summary["requests_per_s"],
                         "latency_p50_ms": summary["latency_p50_ms"],
                         "latency_p99_ms": summary["latency_p99_ms"]}
            log(f"mesh serve[{ex.describe()} max_inflight={depth} {name}]: "
                f"{len(burst)} requests in {summary['flushes']} flushes, "
                f"wall {wall:.3f} s, {summary['requests_per_s']:.1f} "
                f"requests/s, latency p50 {summary['latency_p50_ms']:.1f} ms "
                f"p99 {summary['latency_p99_ms']:.1f} ms, n_shards {shards}")
            check(shards == [ex.n_shards] and srv.inflight() == 0,
                  f"mesh serve: records on {shards} shards, "
                  f"{srv.inflight()} flushes left in flight")
            for (op, a), g, w, w64 in zip(burst, served, local, want):
                if mesh.size == 1:
                    for f in dataclasses.fields(w):
                        check(np.array_equal(getattr(g, f.name),
                                             getattr(w, f.name)),
                              f"mesh serve {op}.{f.name} differs bitwise "
                              f"from phase 6's LocalExecutor result")
                got = g.S if op == "svd" else g.eigenvalues
                err = rel_frobenius(got, w64)
                check(np.isfinite(got).all()
                      and err <= budget["svd" if op == "svd" else "eigh"],
                      f"mesh serve {op} {a.shape}: rel-Frobenius {err:.3e} "
                      f"over budget")
        run["n_shards"] = ex.n_shards
        run["executor"] = ex.describe()
    log(f"mesh serve: every result of the {2 * len(SERVE_DEPTHS)} passes "
        + ("bitwise phase 6's LocalExecutor results" if mesh.size == 1
           else "within the fp32 budget of float64 numpy"))
    return runs


def mesh_cli() -> dict:
    """(c) ``serve_pca.main(["--mesh", "auto", ...])`` closed loop with the
    CLI's flags (plain torch ops on the card), then the same mesh from a
    spec that runs the kernels (``--spec``: the flags cannot name a
    backend), svd over phase 7's dims: each plan's executor is
    ``mesh(data=N; N shards)`` over the N visible cards."""
    import tempfile
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import (ExecutionSpec, SchedulingSpec,
                                     ServerSpec)

    n = torch.cuda.device_count()
    want = f"mesh(data={n}; {n} shards)"
    out = {}
    spec = ServerSpec(
        scheduling=SchedulingSpec(mode="pow2", T=FLUSH_T,
                                  max_batch=FLUSH_REQUESTS, max_inflight=3),
        execution=ExecutionSpec(mesh="auto", backend=BACKEND, fused=True,
                                sweeps=SWEEPS))
    path = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_")) / \
        "server.json"
    spec.save(path)
    for name, argv in (
            ("flags", ["--mesh", "auto", "--op", "eigh", "--requests", 32]),
            ("spec", ["--spec", path, "--op", "svd", "--requests",
                      CONTROL_REQUESTS, "--dims",
                      ",".join(map(str, CONTROL_DIMS))])):
        before = launch_counts()
        doc = run_cli(argv)
        moved = {k: v - before[k] for k, v in launch_counts().items()}
        s = doc["summary"]
        log(f"mesh cli[{name}] serve_pca {' '.join(map(str, argv))}: "
            f"{json.dumps({'plan': doc['plan'], 'summary': s})}")
        check(doc["plan"]["executor"] == want,
              f"serve_pca --mesh auto served through "
              f"{doc['plan']['executor']}, not {want}")
        check(s["requests"] == argv[argv.index("--requests") + 1]
              and s["cache_hit_rate"] == 1.0,
              f"mesh cli[{name}]: {s['requests']} requests, cache hit rate "
              f"{s['cache_hit_rate']}")
        if name == "spec":
            for kernel in ("covariance", "jacobi_sweep", "jacobi_sweep_smem",
                           "mm_engine_matmul"):
                check(moved[kernel] > 0,
                      f"mesh cli: {kernel} never launched")
        out[name] = {"wall_s": doc["_wall_s"], "plan": doc["plan"],
                     "requests_per_s": s["requests_per_s"],
                     "latency_p50_ms": s["latency_p50_ms"],
                     "latency_p99_ms": s["latency_p99_ms"],
                     "launches": {k: v for k, v in moved.items() if v}}
    return out


def mesh_phase(main_run: dict, serve: dict) -> dict:
    """Phase 12: the data-parallel fit (a), the sharded flush (b) and
    ``serve_pca --mesh auto`` (c) over ``host_mesh()`` -- every visible
    card -- and (d) over meshes of 2 cards and of every card where more
    than one is visible."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import host_mesh

    t_phase = time.perf_counter()
    mesh = host_mesh()
    guarded = [0]
    torch.cuda.synchronize()
    reset_launch_counts()
    fit = mesh_fit(main_run, mesh)
    after_fit = launch_counts()
    check(not any(after_fit.values()),
          f"fit_distributed launched kernels {after_fit}: its Gram is "
          f"torch.matmul and its solve unfused, as the reference's")
    served = mesh_serve(serve, mesh, guarded)
    cli = mesh_cli()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"mesh: launches {json.dumps(counts)}; {guarded[0]} "
        f"MeshExecutor.submit calls under set_sync_debug_mode('error'), "
        f"none synced the host")
    for name in FLUSH_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in the mesh "
              f"phase")
    visible = torch.cuda.device_count()
    multi = {"run": visible > 1, "visible": visible}
    if visible > 1:
        multi["legs"] = {}
        for n in sorted({2, visible}):
            sub = host_mesh(n)
            multi["legs"][n] = {"fit": mesh_fit(main_run, sub),
                                "serve": mesh_serve(serve, sub, guarded)}
    log(json.dumps({"multi_gpu": {k: v for k, v in multi.items()
                                  if k != "legs"}}))
    wall = time.perf_counter() - t_phase
    log(f"mesh: phase {wall:.1f} s")
    return {"launches": counts, "fit": fit, "serve": served, "cli": cli,
            "multi_gpu": multi, "wall_s": wall}


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
    lm = lm_phase(dev)
    families = families_phase(dev)
    phase10 = encdec_vlm_phase(dev)
    trained = train_phase(dev)
    mesh = mesh_phase(main_run, serve)
    prof = lm["profile"]
    rows["flash_attention_mma"].update(
        lm_device_ms=prof["mma_device_ms"], lm_bound_ms=prof["mma_bound"][0],
        lm_shape=f"{LM_BATCH * lm_config().n_heads}x{LM_PROMPT}x"
                 f"{lm_config().head_dim} causal bf16")
    rows["flash_attention_splitkv"].update(
        lm_device_ms=prof["splitkv_device_ms"],
        lm_bound_ms=prof["splitkv_bound"][0],
        lm_decode_busy_share=prof["decode_busy_share"])
    ed, vl = phase10["encdec"]["profile"], phase10["vlm"]["profile"]
    rows["flash_attention_mma"].update(
        encdec_encoder_device_ms=ed["encoder_mma_device_ms"],
        encdec_encoder_bound_ms=ed["encoder_mma_bound"][0],
        encdec_decoder_device_ms=ed["decoder_mma_device_ms"],
        encdec_decoder_bound_ms=ed["decoder_mma_bound"][0],
        vlm_device_ms=vl["mma_device_ms"], vlm_bound_ms=vl["mma_bound"][0])
    rows["flash_attention_splitkv"].update(
        encdec_device_ms=ed["splitkv_device_ms"],
        encdec_bound_ms=ed["splitkv_bound"][0],
        encdec_decode_busy_share=ed["decode_busy_share"],
        vlm_device_ms=vl["splitkv_device_ms"],
        vlm_bound_ms=vl["splitkv_bound"][0],
        vlm_decode_busy_share=vl["decode_busy_share"])
    tp = trained["profile"]
    rows["flash_attention_mma"].update(
        train_device_ms=tp["forward"]["mma_device_ms"],
        train_recompute_device_ms=tp["backward"]["mma_device_ms"],
        train_bound_ms=trained["fwd_bound"][0],
        train_bwd_torch_ms=trained["attention"][0]["bwd_torch_ms"],
        train_bwd_bound_ms=trained["bwd_bound"][0],
        train_step_busy_share=tp["step"]["busy_share"])
    rows["mamba_scan"].update(
        train_bwd_torch_ms=trained["scan"]["bwd_torch_ms"],
        train_fwd_ms=trained["scan"]["fwd_ms"],
        train_shape=f"{'x'.join(map(str, SCAN_GRAD_SHAPE[:3]))} N "
                    f"{SCAN_GRAD_SHAPE[3]} fp32 (falcon-mamba-7b widths)")
    ssm_prof = families["ssm"]["profile"]
    rows["mamba_scan"].update(
        lm_device_ms=ssm_prof["scan_device_ms"],
        lm_bound_ms=ssm_prof["scan_bound"][0],
        lm_shape=f"{LM_BATCH}x{LM_PROMPT}x{ssm_config().d_inner} "
                 f"N {ssm_config().ssm_state} fp32 (falcon-mamba-7b)",
        lm_decode_busy_share=ssm_prof["decode_busy_share"],
        hybrid_decode_busy_share=families["hybrid"]["profile"][
            "decode_busy_share"])

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
        row["launches_lm"] = (lm["launches"][k.name]
                              + families["launches"][k.name]
                              + phase10["launches"][k.name])
        row["launches_train"] = trained["launches"][k.name]
        row["launches_mesh"] = mesh["launches"][k.name]
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
