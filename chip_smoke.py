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
13. mesh lm: the LM half of multi-device on a NCCL process group of the
   visible cards, started through a ``FileStore`` under ``build/`` (a
   world of one rank on one card; every collective then spans one rank
   and is elided): (a) olmo-1b through ``train.main([..., "--model-
   parallel", "1"])`` on phase 11's argv with ``--preempt-at 4``, 4
   steps, exactly 32 flash launches a step, the losses within 1e-5
   relative of phase 11's first four (bitwise or not, printed), then 2
   steps at ``--compress-grads 4 --moments int8`` on phase 11's
   compressed schedule, every Gram and sweep replayed on the plain ops
   (1e-5, bitwise), the losses within 1e-5 of phase 11's; (b) olmo-1b
   through ``serve.main([..., "--model-parallel", "1"])`` at phase 8's
   cell, its line and tokens printed, then a prefill and 8
   teacher-forced steps through the mesh's ``build_prefill`` and
   ``build_serve_step`` held to phase 8's one-device path on the same
   weights within phase 8's bf16 logits bound; (c) jamba's period
   through ``serve.generate(..., mesh=)``, 7 scans a prefill, the MoE's
   dropped share equal to phase 9's, and a prefill and 8 steps through
   the mesh's steps against the one-device path; per leg its wall,
   tokens/s, peak memory, collectives a step by kind and launches; (d)
   where two cards or more are visible, olmo-1b at ``--model-parallel
   2`` for 2 steps, one process a card (``chip_smoke.py --mesh-worker``),
   within 1e-3 of (a)'s losses, else a line that says it was skipped.
14. pod: the cross-pod compressed gradient exchange,
   ``launch.pod_compression.main`` on a NCCL world of one rank at the
   reference CLI's default cell (granite-8b at full width, 4 layers, seq
   512, rank 8, bf16, one sequence: ``--mesh 1,1,1 --batch 1``), both
   modes for 3 steps from the same weights: 4 flash launches a step
   (``remat=False``), 9 Grams a compressed step, every Gram and sweep
   replayed on the plain ops (1e-5, bitwise), 0 collectives and bytes
   (every axis spans one rank), each mode's step seconds, peak memory and
   ``compress_tree`` metrics beside the card, and the bytes a rank that
   the leaves' sizes give on the 2 x 16 x 16 mesh; then, outside the
   timed runs, the training forward's logits on the first batch through
   the kernels against attention on the plain version (phase 8's bf16
   and fp32 logits bounds) and the first compressed step once more
   through ``pod_compression.build``, each flash call held at the op and
   the loss within 1e-6 relative of the CLI's first; where two cards or
   more are visible, ``--mesh 2,N/2,1`` on N cards under torchrun, its
   bytes a rank those of the leaves' sizes, else a line that says it was
   skipped.
15. moe: the moe family at every published width with all 128 experts
   in every layer, cut in depth to 2 layers (one arctic layer holds 26.8
   GB of experts, one llama4 layer 32.2 GB), one model after the other
   (each freed before the next): arctic-480b (top-2 beside a dense
   residual FFN) and llama4-maverick-400b-a17b (top-1 beside a shared
   expert, vocab 202048) through ``serve.generate`` at phase 8's B 4 x
   4096, 32 generated: 2 ``flash_attention_mma`` a prefill and 2
   ``flash_attention_splitkv`` a step, nothing else; its JSON line, peak
   memory and the MoE's dropped share at prefill and decode (C = 1); the
   init's peak less the parameters' bytes within the largest single
   draw's fp32 bytes + 0.5 GiB; on the same weights the served prefill's
   flash calls held at the op (the plain fp32 version 8 of the BH
   problems at a time), layer 0's MoE output against a plain fp32 layer
   on the same routing, expert by expert (2^-6 a token, relative
   Frobenius), a 512-token prompt and 8 teacher-forced steps through the
   kernels against plain attention (every flash call held at the op,
   logits within phase 8's bf16 bound), layer 0's MoE ops profiled at
   both shapes, and one prefill and 8 decode steps profiled beside the
   prefill's FLOP floor and the decode's weight-read floor.
16. train families: the ssm, hybrid, encdec and vlm families trained one
   after the other (each freed before the next), every width as
   published, bf16, remat, phase 11's schedule (8 steps, lr 3e-3, the
   seed, fp32 moments; llava at LLaVA-1.5's fine-tuning lr 2e-5, at
   which its loss falls) through the trainer's own loop (``launch.train.
   run`` of the cut config on the CLI's flags; whisper through
   ``train.main``): falcon-mamba-7b cut to 4 of 64 layers and jamba's
   2-layer stand-in (Mamba + MLP, then GQA attention + the 16-expert
   top-2 MoE) at B 4 x 4096, whisper-small whole at B 32 x 448 on zero
   frames, llava-next-34b cut to 4 of 60 layers at B 8 x 1024 after 576
   zero patches: every loss finite and the last below the first, exactly
   one ``flash_attention_mma`` a flash call and one ``mamba_scan`` a
   Mamba layer a step, forward and recompute (8 scans; 2 and 2; 72
   flash; 8 flash), and nothing else; no registry op resolved to its
   plain version in the run; step time, tokens/s, model FLOP/s over the
   bf16 peak and peak memory printed; then, outside the timed run, one
   step of the same seeded model with every flash call held at the op
   (one bf16 ulp + 2e-5 of the plain fp32 result, 32 problems at a time)
   and every scan call (falcon-mamba: layers 0 and 3) at rtol = atol =
   1e-4, the MoE's dropped share printed; the step profiled (forward,
   backward and optimizer device time and busy share, the two torch
   backward passes' share of the step); the attention ``Function``'s
   gradients at whisper's encoder layer 0 (non-causal square), its
   decoder layer 0's cross attention (Sq != Skv) and llava's GQA layer 0
   against autograd through plain attention (one bf16 ulp + 2e-5 x max
   |want|), each call's forward kernel and torch backward timed beside
   their bounds.

17. dry run: ``repro_torch.launch.dryrun``'s memory model held on the
   card at a world of one: olmo-1b whole trained at B 4 x 4096 (phase
   11's cell), falcon-mamba-7b cut to 4 layers trained at B 4 x 4096
   (phase 16's), olmo-1b's prefill at B 4 x 4096 and one decode step
   (phase 8's), each run once on the card with its state resident, the
   peak of ``max_memory_allocated()`` above what was allocated before
   the cell against the dry run's ``peak_bytes`` of the same cell (a
   fake world of one, meta tensors), within ``DRY_PEAK_TOL``, and the
   dry run's FLOPs against ``accounting.model_flops``; the four kernels'
   fake branches (meta operands) against their launches at phase 8's
   and phase 9's shapes, the outputs' shapes, dtypes and strides equal;
   arctic-480b and llava-next-34b ``train_4k`` on 16 x 16 and
   arctic-480b ``train_4k`` on 2 x 16 x 16 through the dry run's CLI,
   each record's peak, ``fits``, collectives and dominant term printed.
   The dry runs are worker processes (``--dryrun-worker``) started at the
   phase's start, beside the card's work; no fake branch was taken
   before the phase, and none by a CUDA tensor in it.
18. bf16 state: ``ssm_dtype="bfloat16"`` (the reference keeps the scan's
   state in bf16 and rounds it every step; the port runs the scan
   kernel's bf16-state instance, ``mamba_scan_bf16_state``).
   falcon-mamba-7b whole with it through ``serve.generate`` at phase 9's
   cell (B 4 x 4096, 32 generated): its line (``prefill_s``,
   ``decode_per_token_s``), exactly 64 bf16-state scans a prefill and
   none in decode, the served prefill's scan calls of layers 0, 31 and
   63 held at the op to the plain version in bf16-state mode (every
   final-state value within one bf16 ulp, y within 2^-8 relative
   Frobenius); on the same weights and prompt a prefill with the bf16
   state and one with the fp32 state, their last logits' distance
   printed.  falcon-mamba-7b cut to 4 layers with it trained as phase
   16's ssm run (``train.run``, 8 steps at B 4 x 4096): losses finite
   and falling (printed beside phase 16's fp32-state losses), exactly 8
   bf16-state scans a step (forward and remat) and nothing else, no
   plain version resolved; one held step with layers 0 and 3's scan
   calls held at the op; a step profiled as phase 16's, its bf16-state
   scan forward and torch scan backward against phase 16's fp32-state
   step (the extra time a step split between them).  The instance at 4 x
   4096 x 8192, N 16 (fp32 operands, as the model passes them) held at
   the op (its final state bitwise the plain version's) and timed with
   CUDA events beside the fp32 state's kernel on the same operands, each
   with its bound, its ptxas spills (none); the instance's packed bf16
   primitives held to their plain counterparts at every input
   (``mamba_scan.bf16_primitive_mismatches``: 0 mismatches).
19. cold start: the persistent executable tier
   (``PCAServer.from_spec`` with ``CacheSpec(cache_dir=...)``: a CUDA
   graph a flush key, its record and the kernel library kept in the
   cache directory).  (a) Three fresh replicas, each a process of its
   own (``--cold-start-worker``) with an empty build directory, serving
   phase 6's 96 requests at ``max_inflight=3``: ``cold`` on an empty
   cache directory (nvcc builds the library; every key captured, held
   bitwise to its eager solve and stored), ``warm_disk`` on the
   directory it seeded (every key captured again from its record),
   ``warmup`` on it with ``warmup(profile)`` of the burst's shapes
   before the first request.  Each prints its time to the first result
   from process start and from server construction, the burst's wall,
   requests/s and p50/p99, nvcc's runs and seconds, its warmup counts and
   ``cache_summary()``, and the SHA-256 of its results; the holds: nvcc
   0 times in ``warm_disk`` and ``warmup``, ``warmup``'s disk hits equal
   to its executables and no compile, ``cold`` storing every key, every
   result within the fp32 budgets of float64 numpy, the three digests
   equal to each other and to phase 6's results.  (b) Phase 6's burst in
   this process through a server with the tier armed at depths 1 and 3
   (the first captures every key, the second loads them from disk), a
   cold and a warm pass each with ``executor.submit`` under
   ``set_sync_debug_mode("error")``, every pass bitwise phase 6's eager
   results; each pass's dispatch a flush, requests/s and p50/p99 printed
   beside phase 6's eager numbers; one warm pass profiled: one graph
   launch a flush, the four kernels named in the trace (no more of each
   than the graphs replayed, 50 sweeps a flush), the device's idle
   share.
Each path is checked against the kernels it runs: phase 3 against the
three PCA/SVD kernels, phases 4, 6, 7 and 12 against those and the
shared-memory sweep, phase 5 against the seven kernels of its five ops,
phase 8 against the two flash kernels of bf16 serving and the Gram and
shared-memory sweep of the consumers, phases 9 and 10 against the scan
and the two flash kernels of bf16 serving, phase 11 against the bf16
prefill kernel and, with compression, the Gram and shared-memory sweep,
phase 13 against those, the split-KV kernel and the scan, phase 14
against the bf16 prefill kernel, the Gram and the shared-memory sweep,
phase 15 against the two flash kernels of bf16 serving, phase 16
against the bf16 prefill kernel and the scan, phase 17 against the bf16
prefill kernel, the scan and the split-KV kernel, phase 18 against the
scan's bf16-state instance, phase 19 against the flush's four kernels
as the profiler names them in a graph's replay.
The last three lines are the kernels' JSON record (each kernel's
launches from the phase that drives it, ``launches_serve`` from phase 6,
``launches_control`` from phase 7, ``launches_lm`` from the serve runs
and consumers of phases 8 to 10, ``launches_train`` from phase 11's
trainer runs, ``launches_mesh`` from phase 12, ``launches_mesh_lm``
from phase 13, ``launches_pod`` from phase 14, ``launches_moe`` from
phase 15's serve runs, ``launches_train_families`` from phase 16's
trainer runs, ``launches_dryrun`` from phase 17's three cells,
``launches_bf16_state`` from phase 18's serve and trainer runs and
``launches_cold_start`` from phase 19's profiled graphed pass, counted
by kernel name in the profiler's trace (a replay makes no wrapper call),
and ``launches_cold_start_replayed``, the same pass's graph replays
times each graph's launches of one solve (the trace can lose a replay's
kernels); the
bf16-state instance's ``launches`` are phase 18's serve run's), the
card's name and
power limit, and ``{"ok": true,
"device": {...}}``.
Without a CUDA device the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
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
# phase 13: the LM half of multi-device on a NCCL process group of the
# visible cards (world 1 on one card): olmo-1b trained through the
# trainer CLI on phase 11's argv, 4 steps (--preempt-at 4, so that the
# learning-rate schedule is phase 11's) held to phase 11's first 4 losses,
# then 2 compressed int8 steps on phase 11's compressed schedule; olmo-1b
# served as phase 8 and its prefill and LM_FORCED steps through the mesh's
# steps held to the one-device path; jamba's period as phase 9; on two
# cards or more, --model-parallel 2 for 2 steps in one process a card
MESH_LM_STEPS = 4
MESH_LM_COMP_STEPS = 2
MESH_LM_TOL = 1e-5           # relative, the losses against phase 11's
MESH_MULTI_STEPS = 2
MESH_MULTI_TOL = 1e-3        # relative: bf16 and another reduction order
MESH_STORE = pathlib.Path(__file__).resolve().parent / "build" / \
    "mesh_store"
# phase 14: the cross-pod compressed gradient exchange through
# launch.pod_compression at the reference CLI's default cell (granite-8b
# whole width, 4 layers, seq 512, rank 8, bf16), one sequence a card (the
# card's share of --batch 512 over 512 devices), both modes for POD_STEPS
# steps; on N >= 2 cards (N even) --mesh 2,N/2,1, one process a card
POD_ARCH, POD_LAYERS, POD_SEQ, POD_RANK, POD_STEPS = "granite-8b", 4, 512, \
    8, 3
POD_STORE = pathlib.Path(__file__).resolve().parent / "build" / "pod_store"
POD_OUT = pathlib.Path(__file__).resolve().parent / "build" / "pod_out"
# phase 15: the moe family at every published width with all 128 experts
# in every layer (src/repro/configs/arctic_480b.py: d 7168, 56 query heads
# over 8 KV heads of 128, 128 experts of d_ff 4864 top-2 beside a dense
# residual FFN, vocab 32000; llama4_maverick_400b_a17b.py: d 5120, 40 over
# 8 heads of 128, 128 experts of d_ff 8192 top-1 beside a shared expert,
# vocab 202048), cut in depth to MOE_LAYERS of 35 and 48 layers: one arctic
# layer holds 26.8 GB of experts and one llama4 layer 32.2 GB in bf16, so
# two layers (55.4 and 69.3 GB with the embeddings) are what one card
# holds; moe_every is 1, so one layer is a whole period and two give the
# decode a layer-to-layer hand-off.  Served as phase 8 (B 4 x 4096, 32
# generated, greedy), one model at a time.  The logits leg runs a
# MOE_SHORT_PROMPT-token prompt (plain attention's fp32 scores of the
# served prefill, 15.0 and 10.7 GB, do not fit beside the weights); the
# served prefill's flash calls are held at the op MOE_HOLD_ROWS of the BH
# problems at a time
MOE_ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
MOE_LAYERS = 2
MOE_SHORT_PROMPT = 512
MOE_HOLD_ROWS = 8
# the init's peak less the parameters' bytes: the largest single draw's
# fp32 bytes and this much for the allocator's rounding and small tensors
MOE_INIT_SLACK = 0.5 * 2 ** 30
# layer 0's MoE output against a plain fp32 computation of the same layer
# on the same routing (each expert from fp32 copies of its weights, the
# dense residual or shared expert added in fp32), relative Frobenius a
# token: the layer runs bf16 operands with fp32 accumulation and rounds
# h, g, silu(g), their product, the expert output, the gate, the gated
# product and the sum (and the residual's own four) to bf16, each at most
# 2^-8 relative, about 2^-9 r.m.s.; their sum over about ten roundings
# stays under 2^-6, while a token sent to another slot or expert, or
# dropped where it was kept, is off by the size of its expert output
MOE_LAYER_TOL = 2.0 ** -6
# phase 16: training the ssm, hybrid, encdec and vlm families, one model
# after the other (each freed before the next), every width as published,
# bf16, remat on as the configs set it, phase 11's schedule (TRAIN_STEPS
# steps at TRAIN_LR, the seed, fp32 moments) through the trainer's loop
# (train.run for a cut config, train.main for whisper):
# - ssm: falcon-mamba-7b (d 4096, d_inner 8192, N 16, d_conv 4, vocab
#   65024) cut to 4 of its 64 layers (0.95e9 parameters), B 4 x 4096: the
#   cut is time, the torch scan backward (kernels/grad.py) loops over every
#   time step, about 0.4-1.8 s a layer a step at this shape;
# - hybrid: jamba-v0.1-52b as the reference's own 2-layer stand-in
#   (n_layers 2, attn_every 2, moe_every 2: Mamba + MLP of d_ff 14336, then
#   GQA attention of 32 over 8 heads of 128 + the MoE of all 16 experts,
#   top-2; 3.68e9 parameters, about 44 GB with bf16 gradients and fp32
#   moments), B 4 x 4096: the period's 8 layers (12.8e9) do not fit one
#   card with gradients and moments, and the config asks n_layers to be a
#   multiple of attn_every;
# - encdec: whisper-small whole (0.28e9) through train.main, B 32 x 448
#   (Whisper's decoder context, n_text_ctx 448), zero frames as the
#   trainers feed;
# - vlm: llava-next-34b (d 7168, 56 over 8 heads, d_ff 20480, vocab 64000)
#   cut to 4 of its 60 layers (3.15e9, about 38 GB with gradients and
#   moments; phase 10 serves 40), B 8 x 1024 tokens after 576 zero patches,
#   at LLaVA-1.5's fine-tuning lr (arXiv:2310.03744), FAMILY_LR: from this
#   seed at phase 11's 3e-3 the loss rose to 30 after two steps and ended
#   above the first at 8, 12 and 16 steps, as it did at 8.6e-4, 5e-4, 3e-4
#   and 1e-4 over 8 steps (NVIDIA H100 80GB HBM3, 700 W); at 3e-5 it fell.
# Each: (arch, the depth cut or None for the whole model, batch, seq_len)
FAMILY_RUNS = {
    "ssm": ("falcon-mamba-7b", {"n_layers": 4}, 4, 4096),
    "hybrid": ("jamba-v0.1-52b", {"n_layers": 2, "attn_every": 2,
                                  "moe_every": 2}, 4, 4096),
    "encdec": ("whisper-small", None, 32, 448),
    "vlm": ("llava-next-34b", {"n_layers": 4}, 8, 1024),
}
FAMILY_LR = {"vlm": 2e-5}
# falcon-mamba's layers whose scan calls (forward and remat's recompute)
# the held step holds at the op (a plain scan at 4 x 4096 x 8192 is a loop
# of 4096 steps); every scan and flash call of the other runs is held
FAMILY_SSM_HELD_LAYERS = (0, 3)
# the held step's plain fp32 attention, this many BH problems at a time
# (jamba's 128 x 4096 x 4096 fp32 scores are 8.6 GB beside its 44 GB)
FAMILY_HOLD_ROWS = 32
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
# phase 17: the dry run's cells at a world of one, each (arch, its cut or
# None, batch, seq_len, kind): phase 11's olmo-1b train, phase 16's
# falcon-mamba-7b train at 4 layers, phase 8's olmo-1b prefill and one
# decode step (its cache phase 8's prompt + generated tokens)
DRY_CELLS = {
    "olmo_train": ("olmo-1b", None, TRAIN_BATCH, TRAIN_SEQ, "train"),
    "ssm_train": ("falcon-mamba-7b", {"n_layers": 4}, 4, 4096, "train"),
    "olmo_serve": ("olmo-1b", None, LM_BATCH, LM_PROMPT, "prefill+decode"),
}
# the dry run's peak against the card's: the fake trace allocates what
# the eager step allocates, storage by storage, rounded as the caching
# allocator rounds; this much is left for what it cannot see
DRY_PEAK_TOL = 0.10
# the production cells no one card holds, through the dry run's CLI
# (the 2 x 16 x 16 cell without costs, as its --all runs them)
DRY_PRODUCTION = (("arctic-480b", "train_4k", False),
                  ("llava-next-34b", "train_4k", False),
                  ("arctic-480b", "train_4k", True))
DRY_TIMEOUT = 150           # seconds a worker may take
DRY_OUT = pathlib.Path(__file__).resolve().parent / "build" / "dryrun"
# phase 18: ssm_dtype="bfloat16", the reference's bf16 scan state (the
# scan kernel's bf16-state instance): falcon-mamba-7b whole served at
# phase 9's cell (LM_BATCH x LM_PROMPT, LM_GEN generated), the scan calls
# of BF16_SERVE_HELD_LAYERS held at the op (a plain bf16-state scan at 4 x
# 4096 x 8192 is a loop of 4096 steps, 1.7 s on the card); falcon-mamba-7b
# cut to 4 layers trained as phase 16's ssm run (FAMILY_RUNS["ssm"],
# TRAIN_STEPS steps), its held step's scans those of
# FAMILY_SSM_HELD_LAYERS; the kernel timed at phase 9's shape beside the
# fp32 state's
BF16_SERVE_HELD_LAYERS = (0, 31, 63)
# a bf16-state scan call against the plain version in bf16-state mode on
# the same operands: the two round the same values at the same points
# (expf for the exponential, round to nearest even), so the final state's
# bf16 values agree to the bit unless an exponential rounds the other way;
# the contract lets each be one bf16 ulp apart.  y sums 16 products of the
# state and C in fp32 in another order (about 1e-7 apart); if every state
# were one ulp (2^-8 to 2^-7 relative) apart, y could move by up to 2^-7
# relative: y is held to half of that
SCAN_BF16_Y_TOL = 2.0 ** -8
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
    """A mamba_scan.cu instance by dtype, copy widths and state, e.g.
    "fp32 wide" or "fp32 wide bf16-state"; any other kernel by its
    mangled name."""
    inst = re.search(r"scan_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])E",
                     entry)
    if not inst:
        return entry
    dtype = "fp32" if inst.group(1) == "f" else "bf16"
    return (f"{dtype} {'wide' if inst.group(2) == '1' else 'any'}"
            + (" bf16-state" if inst.group(3) == "1" else ""))


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


def flush_requests() -> dict:
    """Phase 4's seeded requests, {op: [matrix, ...]} (FLUSH_REQUESTS an
    op): the burst of phases 6, 12 and 19."""
    rng = np.random.default_rng(SEED + 1)
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
    return requests


def batched_flush(dev) -> dict:
    from repro_torch.core.pca import PCAConfig
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.batching import BucketPolicy, stack_requests
    from repro_torch.serving.solver import build_solver_fn

    policy = BucketPolicy(T=FLUSH_T, mode="pow2")
    config = PCAConfig(fused=True, backend=BACKEND, sweeps=SWEEPS)
    budget = ERROR_BUDGETS["fp32"]
    requests = flush_requests()

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


def flash_held_at_op(held: list, keep=None, rows: int = None):
    """``op_calls`` for ``flash_attention`` that holds each bf16 call whose
    index in the block is in ``keep`` (every one if None) at the op,
    right after it (a decode step writes the cache in place): the
    kernel's output against the plain version's fp32 result on the same
    operands, at the ops phase's bf16 contract.  With ``rows`` the plain
    version runs ``rows`` of the BH problems at a time (they are
    independent; its fp32 scores are (BH, Sq, Skv)).  Appends a record a
    call held."""
    from repro_torch.backends import registry
    count = [0]

    def plain32(op, q, k, v, kw):
        step = rows or q.shape[0]
        return torch.cat([op(q[i:i + step].float(), k[i:i + step].float(),
                             v[i:i + step].float(), **kw)
                          for i in range(0, q.shape[0], step)])

    def call(op, q, k, v, **kw):
        out = op(q, k, v, **kw)
        i, count[0] = count[0], count[0] + 1
        if out.dtype == torch.bfloat16 and (keep is None or i in keep):
            t0 = time.perf_counter()
            with registry.use_backend("torch"):
                want32 = plain32(op, q, k, v, kw)
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
    same operands, at rtol = atol = 1e-4 (an fp32 state) or, for a bf16
    state (``state_dtype``), the final state's bf16 values within one
    bf16 ulp and y within ``SCAN_BF16_Y_TOL`` relative Frobenius.
    Returns its record (``over``: the values beyond)."""
    t0 = time.perf_counter()
    bf16_state = kw.get("state_dtype") == torch.bfloat16
    with torch.no_grad():  # a training step's operands carry gradients
        args = [a.detach() if torch.is_tensor(a) else a for a in args]
        y, state = (t.detach() for t in out)
        want_y, want_state = op(*args, **dict(kw, backend="torch"))
        want_y = want_y.float()
        if bf16_state:
            ulp = bf16_ulp(torch.maximum(state.abs(), want_state.abs()))
            y_rel = errors(y.float(), want_y)[2]
            over = (int(((state - want_state).abs() > ulp).sum())
                    + int(not torch.equal(state.bfloat16().float(), state))
                    + int(y_rel > SCAN_BF16_Y_TOL))
        else:
            over = sum(int(((g.float() - w).abs()
                            > SCAN_ATOL + SCAN_RTOL * w.abs()).sum())
                       for g, w in ((y, want_y), (state, want_state)))
        rec = {"call": i, "u": list(args[0].shape), "over": over,
               "bf16_state": bf16_state,
               "y_max_abs_err": float((y.float() - want_y).abs().max()),
               "state_max_abs_err": float((state - want_state).abs().max())}
        if bf16_state:
            rec.update(y_rel_frobenius=y_rel, state_bitwise=int(
                (state != want_state).sum()) == 0)
    return {**rec, "hold_s": time.perf_counter() - t0}


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


def scan_rule(held: list) -> str:
    """The contract the held scan calls were held to."""
    if held and all(h["bf16_state"] for h in held):
        return (f"bf16 state: the state within one bf16 ulp, y within "
                f"{SCAN_BF16_Y_TOL:g} relative Frobenius")
    return f"rtol = atol = {SCAN_RTOL:g}"


def check_scans(held: list, what: str, calls: int) -> None:
    rule = scan_rule(held)
    bf16 = [h for h in held if h["bf16_state"]]
    log(f"{what}: {len(held)} mamba_scan calls held at the op (y and the "
        f"final state, {rule}), operands u "
        f"{held[0]['u'] if held else None}, max_abs_err y "
        f"{max((h['y_max_abs_err'] for h in held), default=0):.3e}, state "
        f"{max((h['state_max_abs_err'] for h in held), default=0):.3e} "
        + (f"(y relative Frobenius up to "
           f"{max(h['y_rel_frobenius'] for h in bf16):.3e}, "
           f"{sum(h['state_bitwise'] for h in bf16)} of {len(bf16)} "
           f"states bitwise the plain version's) " if bf16 else "")
        + f"(the holds {sum(h['hold_s'] for h in held):.3f} s)")
    over = [h for h in held if h["over"]]
    check(len(held) == calls and not over, f"{what}: {len(held)} of {calls} "
          f"mamba_scan calls held; off the plain version beyond {rule} at "
          f"the op: {over[:2]}")


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


def scan_bound(cfg, batch: int, length: int, bf16_state: bool = False):
    """The least time of one layer's scan at the model's shapes (fp32
    operands): u, dt, B, C read, y and the state written, against N
    exponentials a (b, t, d) on the SFU and the rest at the fp32 rate
    (7 N + 3 a (b, t, d); a bf16 state rounds as many values again:
    3 a (b, t, d) and 7 a (b, t, d, n), csrc/mamba_scan.cu's header)."""
    bld = batch * length * cfg.d_inner
    n = cfg.ssm_state
    n_bytes = 4 * (3 * bld + 2 * batch * length * n
                   + cfg.d_inner * (n + 1) + batch * cfg.d_inner * n)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    sfu_rate = SFU_PER_CLOCK * torch.cuda.get_device_properties(
        0).multi_processor_count * sm_clock_hz()
    t_sfu = bld * n / sfu_rate * 1e3
    t_ops = (2 if bf16_state else 1) * bld * (7 * n + 3) / PEAK_FP32 * 1e3
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


# -- phase 11: training -------------------------------------------------------

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


def run_train(what: str, argv: list, dev, cfg=None) -> dict:
    """``train.main(argv)`` on the card or, given ``cfg``, the trainer's
    loop for that config on argv's flags (``train.run(cfg,
    train.parse_args(argv))``): its losses (each finite), JSON line,
    launches, step times, peak memory and the calls of each registry op
    that resolved to its plain version (``plain``)."""
    import io
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    registry.reset_resolution_counts()
    times, out = [], io.StringIO()
    t0 = time.perf_counter()
    with step_times(times), contextlib.redirect_stdout(out):
        losses = (train.main(argv, device=dev) if cfg is None else
                  train.run(cfg, train.parse_args(argv), device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    plain = {op: n for (op, backend), n in
             registry.resolution_counts().items() if backend == "torch" and n}
    lines = out.getvalue().strip().splitlines()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train {what}: {len(losses)} steps in {wall:.1f} s; losses "
        f"{json.dumps(losses)}; step times (s) {json.dumps(times)}; "
        f"launches {json.dumps({k: n for k, n in counts.items() if n})}; "
        f"peak device memory {peak_gb:.2f} GB")
    check(all(np.isfinite(losses)), f"train {what}: a loss is not finite")
    line = json.loads(lines[-1]) if lines[-1].startswith("{") else None
    return {"losses": losses, "line": line, "launches": counts,
            "times": times, "peak_gb": peak_gb, "wall_s": wall,
            "plain": plain}


def launched(what: str, counts: dict, want: dict) -> None:
    got = {k: n for k, n in counts.items() if n}
    want = {k: n for k, n in want.items() if n}
    check(got == want, f"{what} launched {got}, not {want}")


@contextlib.contextmanager
def train_flash_held(held: list, kept: dict, keep, rows: int = None):
    """``op_calls`` for ``flash_attention`` in a training step: every call
    held at the op right after it (the kernel's bf16 output against the
    plain version's fp32 result on the same operands, at the ops phase's
    contract; with ``rows``, ``rows`` of the BH problems at a time), and
    the operands of the calls in ``keep`` kept."""
    from repro_torch.backends import registry
    count = [0]

    def call(op, q, k, v, **kw):
        out = op(q, k, v, **kw)
        i, count[0] = count[0], count[0] + 1
        ops_in = [t.detach() for t in (q, k, v)]
        step = rows or q.shape[0]
        with torch.no_grad(), registry.use_backend("torch"):
            want32 = torch.cat([op(*(t[j:j + step].float() for t in ops_in),
                                   **kw) for j in range(0, q.shape[0], step)])
        g = out.detach().float()
        slack = bf16_ulp(torch.maximum(g.abs(), want32.abs())) \
            + FA_BF16_SLACK
        held.append({"call": i, "q": list(q.shape), "kv": list(k.shape),
                     "causal": kw.get("causal", True),
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


@contextlib.contextmanager
def backward_passes_timed(times: dict):
    """Inside the block each call of ``kernels.grad``'s two backward
    passes (``attention_backward``, ``scan_backward``) adds its time in
    ms to ``times[name]`` when the block ends: CUDA events around it on
    the stream it runs on (the host clock on the CPU)."""
    from repro_torch.kernels import grad as kgrad
    names = ("attention_backward", "scan_backward")
    saved = {name: getattr(kgrad, name) for name in names}
    marks = []

    def timed(name, fn):
        def call(*args, **kw):
            if args[0].is_cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out = fn(*args, **kw)
                end.record()
            else:
                start = time.perf_counter()
                out = fn(*args, **kw)
                end = time.perf_counter()
            marks.append((name, start, end))
            return out
        return call

    for name in names:
        setattr(kgrad, name, timed(name, saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(kgrad, name, saved[name])
    torch.cuda.synchronize()
    for name, start, end in marks:
        ms = (start.elapsed_time(end) if isinstance(start, torch.cuda.Event)
              else 1e3 * (end - start))
        times.setdefault(name, []).append(ms)


def step_profile(model, cfg, state, opt_cfg, batch) -> dict:
    """One training step's forward, backward and optimizer update, each
    under torch.profiler apart: device time, wall, the flash and scan
    kernels' device time a call (in the backward: remat's recompute), and
    in the backward each call's time of the two torch backward passes
    (``bwd_ms``, ``backward_passes_timed``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    params = dict(model.named_parameters())
    box = {}

    def kernel(events, name):
        hits = [e for e in events if name in e.key]
        calls = sum(e.count for e in hits)
        return calls, (sum(e.device_time_total for e in hits) / 1e3 / calls
                       if calls else None)

    def region(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        mma_calls, mma_ms = kernel(events, "flash_mma_kernel")
        scan_calls, scan_ms = kernel(events, "scan_kernel")
        return {"wall_s": wall,
                "device_s": sum(e.device_time_total for e in events) / 1e6,
                "mma_calls": mma_calls, "mma_device_ms": mma_ms,
                "scan_calls": scan_calls, "scan_device_ms": scan_ms,
                "top": [{"name": e.key[:72], "calls": e.count,
                         "s": e.device_time_total / 1e6} for e in sorted(
                             events, key=lambda e: -e.device_time_total)[:8]]}

    def forward():
        box["loss"], _ = tfm.loss_fn(model, batch, cfg)

    def backward():
        with backward_passes_timed(box.setdefault("bwd_ms", {})):
            box["grads"] = dict(zip(params, torch.autograd.grad(
                box.pop("loss"), list(params.values()))))

    def update():  # the train step's: the state consumed
        adamw.update(box.pop("grads"), state.opt, params, opt_cfg,
                     in_place=True)

    out = {name: region(fn) for name, fn in (("forward", forward),
                                              ("backward", backward),
                                              ("optimizer", update))}
    wall = sum(r["wall_s"] for r in out.values())
    busy = sum(r["device_s"] for r in out.values())
    out["step"] = {"wall_s": wall, "device_s": busy,
                   "busy_share": busy / wall}
    out["bwd_ms"] = box["bwd_ms"]
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
        f"device" for name, r in prof.items()
        if name in ("forward", "backward", "optimizer"))
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


# -- phase 13: the LM half of multi-device ------------------------------------

def mesh_legs_log(what: str, run: dict, steps: int, tokens: int) -> None:
    per = {k: n / max(1, steps) for k, n in run["collectives"].items()}
    log(f"mesh lm {what}: wall {run['wall_s']:.2f} s, "
        f"{tokens * steps / run['wall_s']:.1f} tokens/s over the run, peak "
        f"device memory {run['peak_gb']:.2f} GB, collectives a step "
        f"{json.dumps(per)} (every group spans one rank at world 1 and is "
        f"elided, so 0 is the count there), launches "
        f"{json.dumps({k: n for k, n in run['launches'].items() if n})}")


def counted(fn):
    """(fn's result, its kernel launches, its collectives, wall, peak
    memory)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import collectives
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"launches": launch_counts(),
                 "collectives": collectives.counts(),
                 "wall_s": time.perf_counter() - t0,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_train(trained: dict, dev) -> dict:
    """(a) olmo-1b through ``train.main(..., --model-parallel 1)`` on the
    bound mesh: 4 steps of phase 11's run, 32 flash launches a step, the
    losses against phase 11's; then 2 compressed int8 steps with every
    Gram and sweep replayed on the plain ops."""
    import io
    from repro_torch.launch import train
    L = train_config().n_layers
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        argv = train_argv(TRAIN_STEPS, "--preempt-at", str(MESH_LM_STEPS),
                          "--model-parallel", "1")
        with contextlib.redirect_stdout(io.StringIO()):
            losses, run = counted(lambda: train.main(argv, device=dev))
        launched("mesh lm train", run["launches"],
                 {"flash_attention_mma": 2 * L * MESH_LM_STEPS})
        ref = trained["losses"][:MESH_LM_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        bitwise = losses == ref
        log(f"mesh lm train: losses {json.dumps(losses)} against phase "
            f"11's {json.dumps(ref)}: max relative distance {rel:.3e}"
            f"{' (bitwise)' if bitwise else ' (not bitwise)'}")
        check(len(losses) == MESH_LM_STEPS and rel <= MESH_LM_TOL,
              f"mesh lm train: the losses are {rel:.3e} from phase 11's")
        mesh_legs_log("train", run, MESH_LM_STEPS, TRAIN_BATCH * TRAIN_SEQ)
        calls = {}
        argv = train_argv(TRAIN_COMP_STEPS, "--compress-grads",
                          str(TRAIN_COMP_RANK), "--moments", "int8",
                          "--preempt-at", str(MESH_LM_COMP_STEPS),
                          "--model-parallel", "1")
        with pca_calls_kept(calls), contextlib.redirect_stdout(
                io.StringIO()):
            comp, crun = counted(lambda: train.main(argv, device=dev))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    gram_err, sweeps_apart = pca_calls_against_plain(calls)
    n_gram = len(calls["covariance"])
    del calls
    check(crun["launches"]["covariance"] == n_gram > 0
          and crun["launches"]["jacobi_sweep_smem"] > 0
          and crun["launches"]["flash_attention_mma"]
          == 2 * L * MESH_LM_COMP_STEPS,
          f"mesh lm compressed: launches {crun['launches']}")
    check(gram_err <= LM_GRAM_TOL and sweeps_apart == 0,
          f"mesh lm compressed: a Gram {gram_err:.3e} off the plain Gram or "
          f"{sweeps_apart} sweeps apart from the plain sweep")
    ref = trained["comp_losses"][:MESH_LM_COMP_STEPS]
    crel = max(abs(a - b) / abs(b) for a, b in zip(comp, ref))
    log(f"mesh lm compressed: losses {json.dumps(comp)} against phase 11's "
        f"{json.dumps(ref)} (max relative distance {crel:.3e}); {n_gram} "
        f"Grams within {gram_err:.3e} of the plain Gram, every sweep bitwise "
        f"the plain sweep")
    check(crel <= MESH_LM_TOL, f"mesh lm compressed: the losses are "
          f"{crel:.3e} from phase 11's")
    mesh_legs_log("compressed", crun, MESH_LM_COMP_STEPS,
                  TRAIN_BATCH * TRAIN_SEQ)
    launches = {k: run["launches"][k] + crun["launches"][k]
                for k in run["launches"]}
    return {"losses": losses, "rel": rel, "bitwise": bitwise,
            "comp_losses": comp, "comp_rel": crel, "gram_err": gram_err,
            "launches": launches, "collectives": run["collectives"],
            "wall_s": run["wall_s"] + crun["wall_s"],
            "peak_gb": max(run["peak_gb"], crun["peak_gb"])}


def mesh_forced(cfg, mesh, model, prompt, forced, dev):
    """A prefill and ``len(forced)`` teacher-forced steps through the
    mesh's ``build_prefill`` and ``build_serve_step`` and through the
    one-device path, on the same model: the two runs' logits, a list each,
    and the mesh runs' launches a prefill and a step."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm
    v = cfg.vocab_size
    cache_len = LM_PROMPT + LM_GEN
    pre, _ = steps_mod.build_prefill(cfg, ShapeCell(
        "m", LM_PROMPT, LM_BATCH, "prefill"), mesh=mesh)
    step, _ = steps_mod.build_serve_step(cfg, ShapeCell(
        "m", cache_len, LM_BATCH, "decode"), mesh=mesh)
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    reset_launch_counts()
    logits, state = pre(model, {"tokens": tokens}, cache_len=cache_len)
    torch.cuda.synchronize()
    launches = [{k: n for k, n in launch_counts().items() if n}]
    one, ostate = tfm.prefill(model, {"tokens": tokens}, cfg,
                              cache_len=cache_len)
    got, want = [logits[:, :v].float()], [one[:, :v].float()]
    for tok in forced:
        reset_launch_counts()
        _, logits, state = step(model, state, tok)
        torch.cuda.synchronize()
        launches.append({k: n for k, n in launch_counts().items() if n})
        one, ostate = tfm.decode_step(model, ostate, torch.as_tensor(
            tok, dtype=torch.int64, device=dev), cfg)
        got.append(logits[:, :v].float())
        want.append(one[:, :v].float())
    return got, want, launches


def mesh_serve_lm(lm: dict, dev) -> dict:
    """(b) olmo-1b through ``serve.main(..., --model-parallel 1)``, then a
    prefill and ``LM_FORCED`` forced steps on the mesh's steps against
    phase 8's one-device path, within phase 8's bf16 logits bound."""
    import io
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import rules_for_mesh
    from repro_torch.runtime import pick_mesh
    cfg = lm_config()
    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen-len", str(LM_GEN), "--seed", str(SEED),
            "--model-parallel", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen, run = counted(lambda: serve.main(argv, device=dev))
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"mesh lm serve: {json.dumps(line)}; tokens[0] "
        f"{gen[0].tolist()}")
    served("mesh lm", gen, cfg, run["launches"],
           {"flash_attention_mma": cfg.n_layers,
            "flash_attention_splitkv": cfg.n_layers * LM_GEN})
    mesh_legs_log("serve", run, LM_GEN, LM_BATCH)
    mesh = pick_mesh(1, global_batch=LM_BATCH)
    model = tfm.init_model(cfg, seed=SEED, device=dev,
                           rules=rules_for_mesh(mesh))
    got, want, launches = mesh_forced(cfg, mesh, model, lm_prompt(cfg),
                                      gen[:, :LM_FORCED].T, dev)
    del model
    torch.cuda.empty_cache()
    check(launches[0] == {"flash_attention_mma": cfg.n_layers}
          and all(c == {"flash_attention_splitkv": cfg.n_layers}
                  for c in launches[1:]),
          f"mesh lm forced: launches {launches}")
    err = [errors(g, w)[2] for g, w in zip(got, want)]
    bound = lm["bf16_bound"]
    log(f"mesh lm forced: logits rel-Frobenius against the one-device path "
        f"(prefill, then {LM_FORCED} steps) "
        f"{json.dumps([float(f'{e:.3e}') for e in err])}, phase 8's bound "
        f"{json.dumps([float(f'{b:.3e}') for b in bound])}; bitwise "
        f"{all(e == 0 for e in err)}")
    check(all(e <= b for e, b in zip(err, bound)),
          "mesh lm forced: the mesh's logits beyond phase 8's bf16 bound")
    return {"serve": line, "tokens": gen[0].tolist(), "err": err,
            "launches": run["launches"], "collectives": run["collectives"],
            "wall_s": run["wall_s"], "peak_gb": run["peak_gb"],
            "forced_launches": launches}


def mesh_hybrid(families: dict, dev) -> dict:
    """(c) jamba's period through ``serve.generate`` on the bound mesh: 7
    scans and one prefill kernel a prefill, the MoE's dropped share equal
    to phase 9's (one shard: every expert local)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import rules_for_mesh
    from repro_torch.runtime import pick_mesh
    cfg = hybrid_config()
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    mesh = pick_mesh(1, global_batch=LM_BATCH)
    routes = []
    with moe_routes(routes):
        (gen, line), run = counted(lambda: serve.generate(
            cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen_len=LM_GEN,
            seed=SEED, device=dev, mesh=mesh))
    served("mesh hybrid", gen, cfg, run["launches"],
           {"mamba_scan": n_mamba, "flash_attention_mma": n_attn,
            "flash_attention_splitkv": n_attn * LM_GEN})
    drops = {"prefill": dropped_share(routes, cfg, LM_BATCH * LM_PROMPT),
             "decode": dropped_share(routes, cfg, LM_BATCH)}
    del routes
    log(f"mesh hybrid: {json.dumps(line)}; MoE dropped {json.dumps(drops)} "
        f"against phase 9's {json.dumps(families['hybrid']['drops'])}")
    check(drops == families["hybrid"]["drops"],
          "mesh hybrid: the MoE's dropped share differs from phase 9's")
    mesh_legs_log("hybrid", run, LM_GEN, LM_BATCH)
    model = tfm.init_model(cfg, seed=SEED, device=dev,
                           rules=rules_for_mesh(mesh))
    got, want, launches = mesh_forced(cfg, mesh, model, lm_prompt(cfg),
                                      gen[:, :LM_FORCED].T, dev)
    del model
    torch.cuda.empty_cache()
    check(launches[0] == {"mamba_scan": n_mamba,
                          "flash_attention_mma": n_attn}
          and all(c == {"flash_attention_splitkv": n_attn}
                  for c in launches[1:]),
          f"mesh hybrid forced: launches {launches}")
    err = max(errors(g, w)[2] for g, w in zip(got, want))
    log(f"mesh hybrid forced: a prefill and {LM_FORCED} steps on the mesh's "
        f"steps, {n_mamba} scans a prefill; logits against the one-device "
        f"path max rel-Frobenius {err:.3e}")
    check(err <= LM_FP32_TOL, f"mesh hybrid: the mesh's logits {err:.3e} "
          f"from the one-device path's")
    return {"serve": line, "drops": drops, "launches": run["launches"],
            "collectives": run["collectives"], "wall_s": run["wall_s"],
            "peak_gb": run["peak_gb"], "err": err}


def mesh_worker(rank: int, world: int, store: str, out: str) -> int:
    """One process of the multi-card leg: rank ``rank`` of a NCCL world
    of ``world`` cards on the ``FileStore`` ``store``, training olmo-1b at
    ``--model-parallel 2``; rank 0 writes its losses to ``out``."""
    from repro_torch.launch import train
    from repro_torch.parallel import collectives
    dev = collectives.init_world("cuda", store_path=store, rank=rank,
                                 world_size=world)
    try:
        losses = train.main(train_argv(
            TRAIN_STEPS, "--preempt-at", str(MESH_MULTI_STEPS),
            "--model-parallel", "2"), device=dev)
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(losses))
    finally:
        collectives.close_world()
    return 0


def mesh_multi(train_run: dict) -> dict:
    """Where two cards or more are visible: olmo-1b at ``--model-parallel
    2`` for 2 steps in one process a card, held to (a)'s losses."""
    import subprocess
    visible = torch.cuda.device_count()
    if visible < 2:
        log(f"mesh lm multi-card: skipped, {visible} card visible (the "
            f"leg needs two)")
        return {"run": False, "visible": visible}
    store = MESH_STORE.with_name("mesh_multi_store")
    out = MESH_STORE.with_name("mesh_multi_losses.json")
    for p in (store, out):
        p.unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, __file__, "--mesh-worker",
                               str(r), str(visible), str(store), str(out)])
             for r in range(visible)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:   # a worker past the time limit is stopped
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    check(all(c == 0 for c in codes), f"mesh lm multi-card: exit {codes}")
    losses = json.loads(out.read_text())
    ref = train_run["losses"][:MESH_MULTI_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log(f"mesh lm multi-card: {visible} cards, losses {json.dumps(losses)} "
        f"against (a)'s {json.dumps(ref)}, max relative distance {rel:.3e}")
    check(rel <= MESH_MULTI_TOL, f"mesh lm multi-card: {rel:.3e} from (a)")
    return {"run": True, "visible": visible, "losses": losses, "rel": rel}


def mesh_lm_phase(trained: dict, lm: dict, families: dict, dev) -> dict:
    """Phase 13: the LM half of multi-device on a NCCL process group of
    one rank a card (the module docstring's item 13)."""
    from repro_torch.parallel import collectives
    t_phase = time.perf_counter()
    MESH_STORE.parent.mkdir(parents=True, exist_ok=True)
    MESH_STORE.unlink(missing_ok=True)
    collectives.init_world("cuda", store_path=str(MESH_STORE), rank=0,
                           world_size=1)
    try:
        train_run = mesh_train(trained, dev)
        serve_run = mesh_serve_lm(lm, dev)
        hybrid_run = mesh_hybrid(families, dev)
    finally:
        collectives.close_world()
        MESH_STORE.unlink(missing_ok=True)
    multi = mesh_multi(train_run)
    launches = {k: sum(r["launches"][k] for r in (train_run, serve_run,
                                                  hybrid_run))
                for k in train_run["launches"]}
    wall = time.perf_counter() - t_phase
    log(f"mesh lm: launches {json.dumps({k: n for k, n in launches.items() if n})}; "
        f"phase {wall:.1f} s")
    return {"train": train_run, "serve": serve_run, "hybrid": hybrid_run,
            "multi_gpu": multi, "launches": launches, "wall_s": wall}


def pod_config(dtype: str = "bfloat16"):
    """granite-8b at its full width cut to ``POD_LAYERS``, as the
    reference CLI builds it."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(POD_ARCH), n_layers=POD_LAYERS,
                               remat=False, dtype=dtype)


def pod_argv(mesh: str, batch: int, dev) -> list:
    return ["--arch", POD_ARCH, "--layers", str(POD_LAYERS), "--seq",
            str(POD_SEQ), "--rank", str(POD_RANK), "--steps",
            str(POD_STEPS), "--seed", str(SEED), "--mesh", mesh, "--batch",
            str(batch), "--device", str(dev), "--out", str(POD_OUT)]


def pod_leaf_bytes(shape: dict) -> dict:
    """A step's all-reduce bytes a rank on a mesh of ``shape`` from the
    leaves' sizes (``pod_compression.expected_bytes``), in bf16 (what the
    port reduces) and with every gradient at 4 bytes (the reference's CPU
    HLO)."""
    from repro_torch.launch import pod_compression
    from repro_torch.models import transformer as tfm
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = pod_config(dtype)
        params = dict(tfm.Transformer(cfg, "meta").named_parameters())
        out[dtype] = pod_compression.expected_bytes(params, cfg, POD_RANK,
                                                    shape)
    return out


def pod_multi(card: str) -> dict:
    """Where two cards or more are visible: the pod exchange at ``--mesh
    2,N/2,1`` on N cards (N even), one process a card under torchrun, each
    mode's bytes a rank against those of the leaves' sizes."""
    visible = torch.cuda.device_count()
    n = visible - visible % 2
    if n < 2:
        log(f"pod multi-card: skipped, {visible} card visible (the leg "
            f"needs two)")
        return {"run": False, "visible": visible}
    out = POD_OUT.with_name("pod_multi")
    shutil.rmtree(out, ignore_errors=True)
    argv = pod_argv(f"2,{n // 2},1", n, "cuda")
    argv[argv.index("--out") + 1] = str(out)
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--nproc-per-node", str(n), "-m",
                        "repro_torch.launch.pod_compression", *argv],
                       capture_output=True, text=True, env=env, timeout=600)
    check(r.returncode == 0, f"pod multi-card: exit {r.returncode}\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    rec = json.loads((out / f"pod_compression_{POD_ARCH}_L{POD_LAYERS}_r"
                      f"{POD_RANK}.json").read_text())
    want = pod_leaf_bytes(rec["mesh"])["bfloat16"]
    got = {m: rec[m]["total_bytes"] for m in ("baseline", "compressed")}
    log(f"pod multi-card: {n} cards, mesh {json.dumps(rec['mesh'])}, "
        f"bytes a rank {json.dumps(got)} against the leaves' sizes "
        f"{json.dumps(want)}; step s {json.dumps({m: rec[m]['mean_step_s'] for m in got})} "
        f"in {time.perf_counter() - t0:.1f} s on {card}")
    check(all(got[m] == want[m] for m in got),
          "pod multi-card: the bytes differ from the leaves' sizes")
    return {"run": True, "visible": visible, "cards": n, "bytes": got,
            "record": rec}


def pod_held(dev, rec: dict) -> dict:
    """Phase 14's cell once more, outside the timed runs: the training
    forward's logits on the first step's batch through the kernels against
    the same forward with attention on the flash op's ``torch`` backend
    (``logits_against_plain``: the bf16 run within sqrt(2) x the plain bf16
    run's distance from the plain fp32 run of the same weights, the fp32
    run within ``LM_FP32_TOL`` a layer); then the first compressed step
    through ``pod_compression.build`` on a mesh of this card, every flash
    call held at the op (``train_flash_held``) and its loss that of the
    CLI's first step."""
    import dataclasses
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import pod_compression as pc
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import Mesh
    cfg = pod_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    v = cfg.vocab_size
    tokens = pc.seeded_tokens(cfg, POD_STEPS, 1, POD_SEQ, SEED)[0]
    batch = {"tokens": tokens.to(dev)}
    model = tfm.init_model(cfg, seed=SEED, device=dev, train=True)

    def logits(m, c, backend=None):
        reset_launch_counts()
        plain = (contextlib.nullcontext() if backend is None
                 else registry.use_backend(backend))
        with torch.no_grad(), plain:
            out = tfm.forward(m, batch, c)[0][..., :v].float()
        torch.cuda.synchronize()
        if backend is None:
            launched(f"pod forward[{c.dtype}]", launch_counts(),
                     {lm_prefill_kernel(c): POD_LAYERS})
        return out

    got16, plain16 = logits(model, cfg), logits(model, cfg, "torch")
    model32 = lm_fp32_copy(model, cfg32, dev)
    got32, plain32 = logits(model32, cfg32), logits(model32, cfg32, "torch")
    del model32
    torch.cuda.empty_cache()
    err16, floor16, err32 = logits_against_plain(
        "pod forward", [got16], [plain16], [got32], [plain32], POD_LAYERS)
    del got16, plain16, got32, plain32

    mesh = Mesh(np.full((1, 1, 1), dev, dtype=object), pc.AXES)
    state = pc.init_pod_state(model, cfg, mesh, POD_RANK, SEED)
    step = pc.build(cfg, mesh, POD_SEQ, 1, "compressed", POD_RANK)
    held = []
    reset_launch_counts()
    with train_flash_held(held, {}, keep=()):
        _, metrics = step(model, tokens, state)
    torch.cuda.synchronize()
    launched("pod held step", launch_counts(),
             {k: n // POD_STEPS
              for k, n in rec["compressed"]["launches"].items()})
    loss, first = float(metrics["loss"]), rec["compressed"]["losses"][0]
    over = [h for h in held if h["over"]]
    log(f"pod held step: loss {loss:.7f} (the CLI's first {first:.7f}); "
        f"{len(held)} flash calls held at the op, max_abs_err "
        f"{max(h['max_abs_err'] for h in held):.3e}")
    check(len(held) == POD_LAYERS and not over, f"pod: a flash call of the "
          f"step off the plain version beyond one bf16 ulp + "
          f"{FA_BF16_SLACK:g}: {over[:2]}")
    check(abs(loss - first) <= 1e-6 * abs(first),
          f"pod: the held step's loss {loss} is not the CLI's first {first}")
    return {"bf16_err": err16[0], "bf16_bound": floor16[0],
            "fp32_err": err32[0], "loss": loss,
            "flash_max_abs_err": max(h["max_abs_err"] for h in held)}


def pod_phase(dev, card: str) -> dict:
    """Phase 14: the cross-pod exchange on a NCCL world of one rank (the
    module docstring's item 14)."""
    import io
    from repro_torch.launch import pod_compression
    from repro_torch.parallel import collectives
    t_phase = time.perf_counter()
    POD_STORE.parent.mkdir(parents=True, exist_ok=True)
    POD_STORE.unlink(missing_ok=True)
    collectives.init_world("cuda", store_path=str(POD_STORE), rank=0,
                           world_size=1)
    calls = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        try:
            with pca_calls_kept(calls), contextlib.redirect_stdout(
                    io.StringIO()) as out:
                rec, run = counted(lambda: pod_compression.main(
                    pod_argv("1,1,1", 1, dev)))
        finally:
            collectives.close_world()
            POD_STORE.unlink(missing_ok=True)
        held = pod_held(dev, rec)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    for line in out.getvalue().strip().splitlines():
        log(f"pod cli: {line}")
    gram_err, sweeps_apart = pca_calls_against_plain(calls)
    n_gram, n_sweep = len(calls["covariance"]), len(calls["jacobi_sweep"])
    del calls
    launches = {}
    for mode in ("baseline", "compressed"):
        r = rec[mode]
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        log(f"pod {mode}: step s {json.dumps(r['step_s'])} (mean past the "
            f"first {r['mean_step_s']:.4f}), peak device memory "
            f"{r['peak_memory_bytes'] / 1e9:.2f} GB, losses "
            f"{json.dumps(r['losses'])}, compress_tree metrics "
            f"{json.dumps(r['metrics'])}, collectives {json.dumps(r['counts'])}"
            f" ({r['total_bytes']:.0f} bytes), launches "
            f"{json.dumps(r['launches'])}; on {rec['card']}")
        check(all(np.isfinite(r["losses"])), f"pod {mode}: a loss is not "
              "finite")
        check(r["counts"] == {} and r["total_bytes"] == 0
              and r["expected_bytes"] == 0,
              f"pod {mode}: collectives on a world of one: {r['counts']}")
        want = {lm_prefill_kernel(pod_config()): POD_LAYERS * POD_STEPS}
        if mode == "compressed":
            want.update(covariance=n_gram, jacobi_sweep_smem=n_sweep)
        check(r["launches"] == want, f"pod {mode}: launches "
              f"{r['launches']}, not {want}")
    check(run["launches"] == {k: launches.get(k, 0) for k in run["launches"]}
          and run["collectives"] == {},
          f"pod: the phase launched {run['launches']}, the modes {launches}")
    check(n_gram == 9 * POD_STEPS,
          f"pod: {n_gram} Grams in {POD_STEPS} compressed steps, not 9 a "
          "step (granite-8b's 9 stacked matrices)")
    check(gram_err <= LM_GRAM_TOL and sweeps_apart == 0,
          f"pod: a Gram {gram_err:.3e} off the plain Gram or {sweeps_apart} "
          "sweeps apart from the plain sweep")
    first = [rec[m]["losses"][0] for m in ("baseline", "compressed")]
    check(abs(first[0] - first[1]) <= 1e-6 * abs(first[0]),
          f"pod: the modes' first losses {first} differ (same weights)")
    prod = pod_leaf_bytes({"pod": 2, "data": 16, "model": 16})
    log(f"pod: {n_gram} Grams within {gram_err:.3e} of the plain Gram, "
        f"{n_sweep} sweeps bitwise the plain sweep; the first losses "
        f"{json.dumps(first)} (bitwise {first[0] == first[1]}); bytes a "
        f"rank on the 2 x 16 x 16 mesh from the leaves' sizes: bf16 "
        f"{json.dumps(prod['bfloat16'])}, every gradient at 4 bytes "
        f"{json.dumps(prod['float32'])}; a world of one moves 0")
    multi = pod_multi(card)
    wall = time.perf_counter() - t_phase
    log(f"pod: launches {json.dumps(launches)}; phase {wall:.1f} s")
    return {"record": rec, "launches": {k: launches.get(k, 0)
                                        for k in run["launches"]},
            "gram_err": gram_err, "n_gram": n_gram, "n_sweep": n_sweep,
            "held": held, "production_bytes": prod, "multi_gpu": multi,
            "wall_s": wall}


# -- phase 15: the moe family at 128 experts ----------------------------------

def moe_config(arch: str):
    """``arch`` at every published width and all 128 experts, cut in depth
    to ``MOE_LAYERS``, ``tp`` 1 (as ``hybrid_config`` cuts jamba)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS, tp=1)


def largest_draw_bytes(model) -> int:
    """The fp32 bytes of ``init_model``'s largest single draw: a whole
    parameter, or one expert's matrix of an expert tensor."""
    from repro_torch.models.moe import MoE
    most = 0
    for mod in model.modules():
        for name, t in mod.named_parameters(recurse=False):
            per_expert = isinstance(mod, MoE) and name != "router"
            most = max(most, 4 * (t[0].numel() if per_expert
                                  else t.numel()))
    return most


@contextlib.contextmanager
def moe_layer_kept(kept: dict):
    """Inside the block the first ``apply_moe`` call keeps its module, its
    input, its dense residual or shared expert, its routing (gate, idx)
    and its output in ``kept``."""
    from repro_torch.models import moe
    apply, routing = moe.apply_moe, moe._routing

    def route(p, xf, cfg):
        out = routing(p, xf, cfg)
        kept.update(gate=out[0], idx=out[1])
        return out

    def call(p, x, cfg, **kw):
        if kept:
            return apply(p, x, cfg, **kw)
        moe._routing = route
        try:
            y, aux = apply(p, x, cfg, **kw)
        finally:
            moe._routing = routing
        kept.update(p=p, x=x, y=y, mlps=[m for m in (
            kw.get("mlp_res"), kw.get("mlp_shared")) if m is not None])
        return y, aux
    moe.apply_moe = call
    try:
        yield
    finally:
        moe.apply_moe = apply


def moe_layer_plain(kept: dict, cfg) -> torch.Tensor:
    """The kept MoE layer in fp32 on its routing, expert by expert: each
    expert takes the first C of its assignments in slot-major order (every
    token's first choice before any second), computes swiglu from fp32
    copies of its weights and adds gate x output into its tokens' rows;
    then the dense residual or shared expert in fp32.  (T, d) fp32."""
    from torch.nn import functional as F
    from repro_torch.models.moe import capacity
    p, x = kept["p"], kept["x"]
    xf = x.reshape(-1, x.shape[-1]).float()
    T = xf.shape[0]
    C = capacity(T, cfg)
    e_flat = kept["idx"].T.reshape(-1)
    g_flat = kept["gate"].T.reshape(-1).float()
    tok = torch.arange(T, device=xf.device).repeat(cfg.top_k)
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        sel = (e_flat == e).nonzero()[:C, 0]
        if sel.numel():
            t = tok[sel]
            h = xf[t] @ p.wi[e].float()
            g = xf[t] @ p.wg[e].float()
            out = (F.silu(g) * h) @ p.wo[e].float()
            y.index_add_(0, t, out * g_flat[sel, None])
    for mlp in kept["mlps"]:
        h = xf @ mlp.wi.float()
        h = (F.silu(xf @ mlp.wg.float()) * h if mlp.kind == "swiglu"
             else F.gelu(h, approximate="tanh"))
        y += h @ mlp.wo.float()
    return y


def moe_layer_against_plain(what: str, kept: dict, cfg) -> dict:
    """Layer 0's served ``apply_moe`` output against ``moe_layer_plain``:
    the largest relative Frobenius error of a token within
    ``MOE_LAYER_TOL``."""
    t0 = time.perf_counter()
    want = moe_layer_plain(kept, cfg)
    got = kept["y"].reshape(want.shape).float()
    diff = torch.linalg.norm(got - want, dim=1)
    per_token = diff / torch.linalg.norm(want, dim=1).clamp_min(1e-30)
    worst = int(per_token.argmax())
    rec = {"tokens": want.shape[0], "per_token_max": float(per_token.max()),
           "per_token_mean": float(per_token.mean()),
           "rel_frobenius": errors(got, want)[2], "worst_token": worst,
           "hold_s": time.perf_counter() - t0}
    log(f"{what}: layer 0's MoE output on the served prompt against a plain "
        f"fp32 layer on the same routing ({rec['tokens']} tokens, each "
        f"expert from fp32 copies of its weights): relative Frobenius a "
        f"token max {rec['per_token_max']:.3e} (token {worst}), mean "
        f"{rec['per_token_mean']:.3e}, whole {rec['rel_frobenius']:.3e}; "
        f"bound {MOE_LAYER_TOL:.3e} a token (bf16 operands, fp32 "
        f"accumulation) ({rec['hold_s']:.3f} s)")
    check(rec["per_token_max"] <= MOE_LAYER_TOL,
          f"{what}: layer 0's MoE off the plain fp32 layer beyond "
          f"{MOE_LAYER_TOL:.3e} at token {worst}")
    return rec


def moe_op_profile(kept: dict, cfg) -> dict:
    """Layer 0's ``apply_moe`` on the kept prefill input and on its last
    position (a decode step's shape: one token a row, C = 1) under
    torch.profiler with CPU and CUDA activities: each aten op's own device
    time (router GEMM, topk, the one-hot and its cumsum in ``positions``,
    the dispatch scatter and gather, the three ``bmm``, the combine, the
    dense FFN beside the experts), the largest first."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import moe

    def own_ms(e):
        t = getattr(e, "self_device_time_total", None)
        return (t if t is not None else e.self_cuda_time_total) / 1e3

    out = {}
    for shape, x in (("prefill", kept["x"]), ("decode", kept["x"][:, -1:])):
        mlps = kept["mlps"]
        kw = {"mlp_res": mlps[0]} if cfg.dense_residual else (
            {"mlp_shared": mlps[0]} if cfg.shared_expert else {})
        moe.apply_moe(kept["p"], x, cfg, **kw)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            moe.apply_moe(kept["p"], x, cfg, **kw)
            torch.cuda.synchronize()
        ops = sorted(((e.key, e.count, own_ms(e)) for e in prof.key_averages()
                      if e.key.startswith("aten::") and own_ms(e) > 0),
                     key=lambda r: -r[2])
        out[shape] = {"tokens": x.shape[0] * x.shape[1],
                      "device_ms": sum(r[2] for r in ops),
                      "ops": [{"op": k, "calls": n, "ms": round(ms, 4)}
                              for k, n, ms in ops[:14]]}
    return out


def moe_floors(cfg, model) -> dict:
    """The least time of a served prefill (its operations at the bf16 peak)
    and of a decode step (every weight it reads, once, at the memory
    rate): the capacity-padded expert products, the dense FFN beside
    them, the attention projections and causal scores; the decode reads
    every parameter but the embedding table, of which it reads B rows."""
    from repro_torch.models.moe import capacity
    T = LM_BATCH * LM_PROMPT
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    experts = 3 * 2 * E * capacity(T, cfg) * d * f
    dense = 3 * 2 * T * d * f if (cfg.dense_residual
                                  or cfg.shared_expert) else 0
    proj = 2 * T * d * (2 * H + 2 * KV) * hd
    scores = 4 * LM_BATCH * H * hd * LM_PROMPT * (LM_PROMPT + 1) / 2
    flops = cfg.n_layers * (experts + dense + proj + scores)
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    tok = model.embed.tok
    read = weights - tok.numel() * tok.element_size()
    return {"prefill_flop": flops,
            "prefill_floor_ms": flops / PEAK_BF16 * 1e3,
            "decode_bytes": read,
            "decode_floor_ms": read / PEAK_BYTES * 1e3,
            "expert_flop_a_layer": experts, "dense_flop_a_layer": dense,
            "proj_flop_a_layer": proj, "score_flop_a_layer": scores}


def moe_serve(arch: str, dev, bound16: list) -> dict:
    """One moe model through ``serve.generate`` (2 ``flash_attention_mma``
    a prefill, 2 ``flash_attention_splitkv`` a step), its drops, its
    init's peak, then on the same weights: the served prefill's flash
    calls held at the op and layer 0's MoE against a plain fp32 layer,
    the logits of a short prompt and ``LM_FORCED`` steps against plain
    attention, the MoE's ops profiled at both shapes, and a profiled
    prefill and decode."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity

    cfg = moe_config(arch)
    what = f"moe {arch} ({MOE_LAYERS} layers)"
    n_attn = cfg.layer_kinds().count("attn")
    n_moe = cfg.ffn_kinds().count("moe")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
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
    log(f"{what} serve: {json.dumps(line)}; peak device memory "
        f"{peak_gb:.2f} GB ({base / 1e9:.2f} GB held before it)")
    served(what, gen, cfg, counts,
           {"flash_attention_mma": n_attn,
            "flash_attention_splitkv": n_attn * LM_GEN})
    drops = {"prefill": dropped_share(routes, cfg, LM_BATCH * LM_PROMPT),
             "decode": dropped_share(routes, cfg, LM_BATCH)}
    check(drops["prefill"][1] == n_moe * LM_BATCH * LM_PROMPT * cfg.top_k
          and drops["decode"][1] == n_moe * LM_GEN * LM_BATCH * cfg.top_k,
          f"{what}: MoE routings "
          f"{[(t, tuple(i.shape)) for t, i in routes][:3]} are not one a "
          f"MoE layer a step")
    del routes
    log(f"{what} MoE dropped assignments: prefill {drops['prefill'][0]} of "
        f"{drops['prefill'][1]} (capacity "
        f"{capacity(LM_BATCH * LM_PROMPT, cfg)} an expert), decode "
        f"{drops['decode'][0]} of {drops['decode'][1]} (capacity "
        f"{capacity(LM_BATCH, cfg)} an expert)")

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0,
            "peak_over_base": torch.cuda.max_memory_allocated() - base,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in model.parameters()),
            "largest_draw_bytes": largest_draw_bytes(model)}
    init["transient"] = init["peak_over_base"] - init["param_bytes"]
    log(f"{what} init: {init['s']:.2f} s, parameters "
        f"{init['param_bytes'] / 1e9:.2f} GB, peak less the parameters "
        f"{init['transient'] / 1e9:.3f} GB against the largest single draw "
        f"{init['largest_draw_bytes'] / 1e9:.3f} GB (fp32) + 0.5 GiB")
    check(init["transient"] <= init["largest_draw_bytes"] + MOE_INIT_SLACK,
          f"{what}: the init's peak exceeds the parameters by "
          f"{init['transient'] / 1e9:.3f} GB")

    tokens = torch.as_tensor(lm_prompt(cfg), dtype=torch.int64, device=dev)
    flash, kept = [], {}
    reset_launch_counts()
    with flash_held_at_op(flash, rows=MOE_HOLD_ROWS), moe_layer_kept(kept):
        logits, state = tfm.prefill(model, {"tokens": tokens}, cfg,
                                    cache_len=LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    moved = {k: n for k, n in launch_counts().items() if n}
    check(moved == {"flash_attention_mma": n_attn},
          f"{what} prefill launched {moved}")
    check(np.array_equal(logits.argmax(-1).cpu().numpy(), gen[:, 0]),
          f"{what}: the prefill does not give the served first token")
    over = [h for h in flash if h["over"]]
    log(f"{what}: the served prefill's bf16 flash held at the op in "
        f"{len(flash)} calls (q {flash[0]['q']} kv {flash[0]['kv']}, the "
        f"plain fp32 version {MOE_HOLD_ROWS} problems at a time), "
        f"max_abs_err {max(h['max_abs_err'] for h in flash):.3e} (the "
        f"holds {sum(h['hold_s'] for h in flash):.3f} s)")
    check(len(flash) == n_attn and not over,
          f"{what}: flash off the plain version beyond one bf16 ulp + "
          f"{FA_BF16_SLACK:g} at the op: {over[:2]}")
    del state, logits
    layer = moe_layer_against_plain(what, kept, cfg)
    ops = moe_op_profile(kept, cfg)
    del kept
    for shape, rec in ops.items():
        log(f"{what} MoE layer 0 at {shape} ({rec['tokens']} tokens): "
            f"{rec['device_ms']:.3f} ms on the device, by op "
            f"{json.dumps(rec['ops'])}")

    short = {"tokens": tokens[:, :MOE_SHORT_PROMPT]}
    got, ref, state = lm_against_plain(model, cfg, dev, short,
                                       gen[:, :LM_FORCED].T,
                                       MOE_SHORT_PROMPT + LM_FORCED)
    del state
    err16 = [errors(g, r)[2] for g, r in zip(got, ref)]
    log(f"{what}: logits rel-Frobenius on a {MOE_SHORT_PROMPT}-token prompt "
        f"(prefill, then {LM_FORCED} teacher-forced steps), bf16 kernels "
        f"vs plain attention {json.dumps([float(f'{e:.3e}') for e in err16])}"
        f", phase 8's bound "
        f"{json.dumps([float(f'{b:.3e}') for b in bound16])}")
    check(all(e <= b for e, b in zip(err16, bound16)),
          f"{what}: the kernels move the logits beyond phase 8's bf16 bound")
    del got, ref

    prof = model_profile(model, cfg, dev, {"tokens": tokens},
                         LM_PROMPT + LM_GEN)
    floors = moe_floors(cfg, model)
    del model
    torch.cuda.empty_cache()
    # the prefill expands the 8 KV heads to the query heads; a decode
    # step folds each KV head's query heads over its own keys
    bh, d = LM_BATCH * cfg.n_heads, cfg.head_dim
    prof["mma_bound"] = attention_bound(bh, LM_PROMPT, LM_PROMPT, d, True)
    prof["splitkv_bound"] = attention_bound(
        LM_BATCH * cfg.n_kv_heads, cfg.group_size,
        LM_PROMPT + (LM_PROFILE_STEPS + 1) / 2, d, False)
    log_profile(what, prof)
    check(prof["finite"] and np.array_equal(prof["first_tokens"], gen[:, 0]),
          f"{what}: the profiled prefill does not give the served first "
          "token")
    log(f"{what} floors: prefill {floors['prefill_flop']:.4g} FLOP, "
        f"{floors['prefill_floor_ms']:.2f} ms at the bf16 peak (measured "
        f"{1e3 * line['prefill_s']:.1f} ms); decode reads "
        f"{floors['decode_bytes'] / 1e9:.2f} GB a step, "
        f"{floors['decode_floor_ms']:.2f} ms at {PEAK_BYTES / 1e12:.2f} "
        f"TB/s (measured {1e3 * line['decode_per_token_s']:.2f} ms a token, "
        f"{prof['decode_step_device_ms']:.2f} on the device)")
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "drops": drops, "init": init, "flash_held": len(flash),
            "layer": layer, "ops": ops, "bf16_err": err16, "profile": prof,
            "floors": floors}


def moe_phase(dev, lm: dict) -> dict:
    """Phase 15: arctic-480b and llama4-maverick-400b-a17b at full width
    with all 128 experts, cut in depth, through the port's serving path
    (the module docstring's item 15); ``lm`` is phase 8's result (its
    bf16 logits bound)."""
    t_phase = time.perf_counter()
    log(f"moe: {MOE_LAYERS} layers of each model (every width as published, "
        f"all 128 experts a layer): one arctic-480b layer holds 26.8 GB of "
        f"experts and one llama4 layer 32.2 GB in bf16, so the whole models "
        f"(35 and 48 layers) do not fit one card")
    runs = {arch: moe_serve(arch, dev, lm["bf16_bound"])
            for arch in MOE_ARCHS}
    wall = time.perf_counter() - t_phase
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs[MOE_ARCHS[0]]["launches"]}
    log(f"moe: launches {json.dumps({k: n for k, n in launches.items() if n})}"
        f"; phase {wall:.1f} s")
    return {"runs": runs, "launches": launches, "wall_s": wall}


# -- phase 16: training the ssm, hybrid, encdec and vlm families --------------

def family_config(name: str):
    """The config of phase 16's ``name`` run: its arch at every published
    width, cut in depth as ``FAMILY_RUNS`` says, ``tp`` 1 (as the trainer
    sets it on one card)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, cut, _, _ = FAMILY_RUNS[name]
    return dataclasses.replace(get_config(arch), tp=1, **(cut or {}))


def family_lr(name: str) -> float:
    return FAMILY_LR.get(name, TRAIN_LR)


def family_argv(name: str) -> list:
    """The trainer's flags for ``name``'s run: phase 11's schedule (the
    vlm's lr ``FAMILY_LR``'s)."""
    arch, _, batch, seq = FAMILY_RUNS[name]
    return ["--arch", arch, "--steps", str(TRAIN_STEPS), "--global-batch",
            str(batch), "--seq-len", str(seq), "--lr", str(family_lr(name)),
            "--seed", str(SEED), "--log-every", "1"]


def family_launches(cfg) -> dict:
    """A training step's launches: each flash call of the forward
    (``flash_calls``: whisper's encoder layers and each decoder layer's
    self and cross attention) and each Mamba layer's scan, once in the
    forward and once more in remat's recompute."""
    mult = 2 if cfg.remat else 1
    return {"flash_attention_mma": mult * flash_calls(cfg)[0],
            scan_kernel(cfg): mult * cfg.layer_kinds().count("mamba")}


def scan_kernel(cfg) -> str:
    """The scan kernel record a config's Mamba layers launch: the
    bf16-state instance for ``ssm_dtype="bfloat16"``."""
    return ("mamba_scan_bf16_state" if cfg.ssm_dtype == "bfloat16"
            else "mamba_scan")


def family_grad_calls(name: str, cfg) -> dict:
    """The forward's flash calls whose operands the attention Function's
    gradients are held on, by index, with (what, Sq, Skv, causal):
    whisper's encoder layer 0 (non-causal square) and decoder layer 0's
    cross attention (Sq != Skv), llava's GQA layer 0 (the patches and the
    tokens)."""
    _, _, _, seq = FAMILY_RUNS[name]
    if name == "encdec":
        f = cfg.n_frames
        return {0: ("encoder layer 0", f, f, False),
                cfg.encoder_layers + 1: ("decoder layer 0, cross", seq, f,
                                         False)}
    if name == "vlm":
        s = seq + cfg.n_patches
        return {0: ("GQA layer 0", s, s, True)}
    return {}


def attention_bwd_bound(bh: int, sq: int, skv: int, d: int, causal: bool):
    """The least time of one bf16 attention backward: q, O, dO, dQ (Sq
    rows) and K, V, dK, dV (Skv rows) moved once, against 10 x d products
    a visible score (phase 11's count) at the bf16 rate."""
    scores = sq * (skv - (sq - 1) / 2) if causal else sq * skv
    return bound_ms(2 * bh * d * 4 * (sq + skv), 10 * bh * d * scores,
                    PEAK_BF16)


def scan_bwd_bound(cfg, batch: int, length: int):
    """The least time of one layer's scan backward (fp32): u, dt, dy read
    and du, dt's gradient written, B, C read and their gradients written,
    against an exponential a (b, t, d, n) on the SFU (a_t recomputed) and
    16 operations a (b, t, d, n) at the fp32 rate (the state, the
    adjoint, and the five products of dC, dB, du, dt and dA)."""
    bld = batch * length * cfg.d_inner
    n = cfg.ssm_state
    n_bytes = 4 * (5 * bld + 4 * batch * length * n)
    sfu_rate = SFU_PER_CLOCK * torch.cuda.get_device_properties(
        0).multi_processor_count * sm_clock_hz()
    return max((n_bytes / PEAK_BYTES * 1e3, "bytes"),
               (bld * n / sfu_rate * 1e3, "operations"),
               (16 * bld * n / PEAK_FP32 * 1e3, "operations"))


def family_held_step(name: str, cfg, dev, profile: bool = True) -> dict:
    """One step of ``name``'s seeded model on the pipeline's first batch,
    outside the timed run: every flash call held at the op
    (``FAMILY_HOLD_ROWS`` problems at a time), every scan call held at the
    op (falcon-mamba: those of ``FAMILY_SSM_HELD_LAYERS``, in the forward
    and in the recompute, which runs the layers last to first), the MoE's
    dropped share, the operands of ``family_grad_calls`` kept; then, with
    ``profile``, a step profiled (``step_profile``).  The model is freed
    on return."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity
    from repro_torch.optim import adamw
    _, _, batch, seq = FAMILY_RUNS[name]
    what = f"train {name} held step"
    opt_cfg = adamw.AdamWConfig(lr=family_lr(name), warmup_steps=max(
        2, TRAIN_STEPS // 10), decay_steps=TRAIN_STEPS)
    model = tfm.init_model(cfg, seed=SEED, device=dev, train=True)
    params = dict(model.named_parameters())
    state = steps_mod.TrainState(model, adamw.init(params, opt_cfg),
                                 torch.zeros((), dtype=torch.int32,
                                             device=dev))
    step_fn, _ = steps_mod.build_train_step(
        cfg, ShapeCell("smoke", seq, batch, "train"), opt_cfg, device=dev)
    pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab_size=cfg.vocab_size, seed=SEED))
    inputs = train.inputs(cfg, pipe.batch_at(0)[:, :seq], dev)
    want = family_launches(cfg)
    n_scan = want[scan_kernel(cfg)]
    keep_scans = None
    if name == "ssm":
        L = cfg.n_layers
        keep_scans = {i for i in range(n_scan) if (i if i < L else
                      2 * L - 1 - i) in FAMILY_SSM_HELD_LAYERS}
    grad_calls = family_grad_calls(name, cfg)
    flash, kept, scans, routes = [], {}, [], []
    reset_launch_counts()
    with train_flash_held(flash, kept, keep=set(grad_calls),
                          rows=FAMILY_HOLD_ROWS), \
            scans_held(scans, keep=keep_scans), moe_routes(routes):
        state, metrics = step_fn(state, inputs)
    torch.cuda.synchronize()
    launched(what, launch_counts(), want)
    loss = float(metrics["loss"])
    check(np.isfinite(loss), f"{what}: the loss is not finite")
    if flash:
        over = [h for h in flash if h["over"]]
        log(f"{what}: {len(flash)} flash calls held at the op (q, kv "
            f"{sorted({(tuple(h['q']), tuple(h['kv'])) for h in flash})}), "
            f"max_abs_err {max(h['max_abs_err'] for h in flash):.3e}")
        check(not over, f"{what}: a flash call off the plain version "
              f"beyond one bf16 ulp + {FA_BF16_SLACK:g}: {over[:2]}")
    check(len(flash) == want["flash_attention_mma"], f"{what}: "
          f"{len(flash)} flash calls held of {want['flash_attention_mma']}")
    if n_scan:
        check_scans(scans, f"{what} (scan calls "
                    f"{sorted(keep_scans) if keep_scans else 'all'})",
                    len(keep_scans) if keep_scans else n_scan)
    for i, (label, sq, skv, causal) in grad_calls.items():
        (q, k, _), kw = kept[i]
        check(q.shape[0] == batch * cfg.n_heads and q.shape[1] == sq
              and k.shape[1] == skv and kw["causal"] == causal,
              f"{what}: flash call {i} is not {label}: q {list(q.shape)}, "
              f"k {list(k.shape)}, causal {kw['causal']}")
    drops = None
    if cfg.n_experts:
        tokens = batch * seq
        drops = dropped_share(routes, cfg, tokens)
        n_moe = cfg.ffn_kinds().count("moe")
        check(drops[1] == (2 if cfg.remat else 1) * n_moe * tokens
              * cfg.top_k, f"{what}: MoE routings "
              f"{[(t, tuple(i.shape)) for t, i in routes]} are not one a "
              f"MoE layer in the forward and one in the recompute")
        log(f"{what}: the MoE dropped {drops[0]} of {drops[1]} assignments "
            f"({drops[0] / drops[1]:.4f}; the forward's and the "
            f"recompute's routings, capacity {capacity(tokens, cfg)} an "
            f"expert of {cfg.n_experts}, top-{cfg.top_k}; the reference's "
            f"rule)")
    del routes, scans
    prof = (step_profile(model, cfg, state, opt_cfg, inputs) if profile
            else None)
    log(f"{what}: loss {loss:.7f}")
    del model, state, params, step_fn, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "flash_held": len(flash), "kept": kept,
            "drops": drops, "profile": prof}


def train_family(name: str, dev) -> dict:
    """Phase 16's ``name`` run: the trainer for ``TRAIN_STEPS`` steps
    (losses finite and falling, the launches the model gives, no plain
    version resolved), its step time, tokens/s, model FLOP/s over the
    bf16 peak and peak memory; then the held and profiled step
    (``family_held_step``) and the attention Function's gradients on the
    kept operands (``attention_grads_held``)."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import accounting
    arch, cut, batch, seq = FAMILY_RUNS[name]
    cfg = family_config(name)
    layers = [f"{mix}/{ffn if cfg.d_ff else 'no FFN'}"
              for mix, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds())]
    if cfg.family == "encdec":
        layers.append(f"{cfg.encoder_layers} encoder layers")
    desc = (f"{arch} ({'whole' if cut is None else 'cut'}: "
            f"{', '.join(layers)}), B {batch} x {seq}, lr {family_lr(name)}")
    want = family_launches(cfg)
    run = run_train(f"{name} {desc}", family_argv(name), dev,
                    cfg=None if cut is None else cfg)
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
          f"train {name}: the loss did not fall ({losses})")
    launched(f"train {name}", run["launches"],
             {k: TRAIN_STEPS * n for k, n in want.items()})
    check(not run["plain"], f"train {name}: plain versions ran on the "
          f"path: {run['plain']}")
    step_s = float(np.median(run["times"][1:]))
    flops = accounting.model_flops(cfg, ShapeCell("smoke", seq, batch,
                                                  "train"))
    params = accounting.param_counts(cfg)
    tokens = batch * seq
    mfu = flops / step_s / PEAK_BF16
    log(f"train {name}: step {step_s:.4f} s (median of steps 2-{TRAIN_STEPS},"
        f" host clock ending in a synchronize), {tokens / step_s:.1f} "
        f"tokens/s, model FLOP/s {flops / step_s:.4e} = {mfu:.4f} of the "
        f"bf16 peak ({flops:.4e} FLOP a step, 6 x {params['active']} active "
        f"of {params['total']} parameters x {tokens} tokens); first step "
        f"{run['times'][0]:.3f} s; peak device memory {run['peak_gb']:.2f} "
        f"GB; launches a step {json.dumps(want)}; {json.dumps(run['line'])}")
    gc.collect()
    torch.cuda.empty_cache()
    held = family_held_step(name, cfg, dev)
    kept = held.pop("kept")
    attn = attention_grads_held(kept, dev) if kept else {}
    del kept
    torch.cuda.empty_cache()
    d = cfg.head_dim
    for i, (label, sq, skv, causal) in family_grad_calls(name, cfg).items():
        bh = batch * cfg.n_heads
        attn[i].update(label=label,
                       fwd_bound=attention_bound(bh, sq, skv, d, causal),
                       bwd_bound=attention_bwd_bound(bh, sq, skv, d, causal))
        log(f"train {name}: {label} {attn[i]['shape']} x {skv} keys: "
            f"forward kernel {attn[i]['fwd_ms']:.4f} ms (bound "
            f"{attn[i]['fwd_bound'][0]:.4f}, {attn[i]['fwd_bound'][1]}), "
            f"torch backward {attn[i]['bwd_torch_ms']:.3f} ms (a backward "
            f"kernel's bound {attn[i]['bwd_bound'][0]:.4f}, "
            f"{attn[i]['bwd_bound'][1]})")
    prof = held["profile"]
    step_wall_ms = 1e3 * prof["step"]["wall_s"]
    shares = {k: sum(v) / step_wall_ms for k, v in prof["bwd_ms"].items()}
    scan_bwd = prof["bwd_ms"].get("scan_backward", [])
    extra = {}
    if want["mamba_scan"]:
        extra = {"scan_bound": scan_bound(cfg, batch, seq),
                 "scan_bwd_bound": scan_bwd_bound(cfg, batch, seq),
                 "scan_bwd_ms": float(np.mean(scan_bwd))}
        log(f"train {name}: mamba_scan {prof['forward']['scan_device_ms']:.4f}"
            f" ms a call on the device in the forward, "
            f"{prof['backward']['scan_device_ms']:.4f} in the recompute "
            f"(bound {extra['scan_bound'][0]:.4f}, {extra['scan_bound'][1]});"
            f" torch scan backward {extra['scan_bwd_ms']:.3f} ms a layer "
            f"(calls {json.dumps([round(t, 3) for t in scan_bwd])}; a "
            f"backward kernel's bound {extra['scan_bwd_bound'][0]:.4f}, "
            f"{extra['scan_bwd_bound'][1]})")
    log(f"train {name} step profile: " + "; ".join(
        f"{part} {prof[part]['wall_s']:.4f} s wall, "
        f"{prof[part]['device_s']:.4f} s on the device"
        for part in ("forward", "backward", "optimizer"))
        + f"; busy share {prof['step']['busy_share']:.4f}; of the step's "
        f"{step_wall_ms / 1e3:.4f} s wall: "
        + ", ".join(f"{k} {v:.4f} ({len(prof['bwd_ms'][k])} calls)"
                    for k, v in shares.items())
        + (f"; flash_attention_mma {prof['forward']['mma_device_ms']:.4f} "
           f"ms a call in the forward, "
           f"{prof['backward']['mma_device_ms']:.4f} in the recompute"
           if prof["forward"]["mma_calls"] else ""))
    for part in ("forward", "backward", "optimizer"):
        log(f"train {name} step {part} by device time: "
            f"{json.dumps(prof[part]['top'])}")
    return {"cfg": cfg.name, "losses": losses, "launches": run["launches"],
            "step_s": step_s, "times": run["times"],
            "tokens_per_s": tokens / step_s, "model_flops_per_s":
            flops / step_s, "mfu": mfu, "peak_gb": run["peak_gb"],
            "held_loss": held["loss"], "drops": held["drops"],
            "attention": attn, "profile": prof, "bwd_shares": shares,
            **extra}


def train_families_phase(dev) -> dict:
    """Phase 16: the ssm, hybrid, encdec and vlm families trained on the
    card, one model after the other (the module docstring's item 16)."""
    t_phase = time.perf_counter()
    runs = {}
    for name in FAMILY_RUNS:
        runs[name] = train_family(name, dev)
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["ssm"]["launches"]}
    log(f"train families: launches {json.dumps({k: n for k, n in launches.items() if n})}"
        f"; phase {wall:.1f} s")
    return {"runs": runs, "launches": launches, "wall_s": wall}


# -- phase 17: the dry run's memory model on the card -------------------------

def dry_config(name: str):
    """The config of phase 17's ``name`` cell: its arch at every published
    width, cut as ``DRY_CELLS`` says, ``tp`` 1 (one card)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, cut = DRY_CELLS[name][:2]
    return dataclasses.replace(get_config(arch), tp=1, **(cut or {}))


def dry_shapes(name: str):
    """The ``ShapeCell``s of the cell: the train step's, or the prefill's
    and the decode step's (its cache the prompt and ``LM_GEN`` tokens)."""
    from repro_torch.configs.shapes import ShapeCell
    _, _, batch, seq, kind = DRY_CELLS[name]
    if kind == "train":
        return {"train": ShapeCell(name, seq, batch, "train")}
    return {"prefill": ShapeCell(name, seq, batch, "prefill"),
            "decode": ShapeCell(name, seq + LM_GEN, batch, "decode")}


def dry_cell(name: str) -> dict:
    """The dry run of phase 17's cell ``name`` on a fake world of one:
    the train step's record (``dryrun.run_cell``), or the prefill's and
    then the decode step's traces on the prefill's state (the larger
    peak)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    cfg, shapes = dry_config(name), dry_shapes(name)
    one = ((1, 1), ("data", "model"))
    if "train" in shapes:
        return dryrun.run_cell(cfg.name, name, cfg=cfg, shape=shapes["train"],
                               mesh_axes=one, verbose=False)
    with dryrun.fake_world(1):
        mesh = dryrun.Mesh.from_world(*one, device=dryrun.DEVICE)
        step, (model, batch), live = dryrun.build_cell(
            cfg, shapes["prefill"], mesh, "float32")
        cache_len = shapes["decode"].seq_len
        pre = dryrun.trace(lambda m, b: step(m, b, cache_len),
                           (model, batch), live)
        logits, state = pre["out"]
        token = torch.argmax(logits, dim=-1)
        del logits, pre["out"]
        serve, _ = steps_mod.build_serve_step(cfg, shapes["decode"],
                                              mesh=mesh)
        dec = dryrun.trace(serve, (model, state, token),
                           (model, batch, state, token))
        flops = sum(t["aten_flops"] + sum(k["flops"] for k in
                                          t["kernels"].values())
                    for t in (pre, dec))
        return {"memory": {"peak_bytes": max(pre["peak_bytes"],
                                             dec["peak_bytes"])},
                "flops_per_device": flops,
                "trace_s": pre["trace_s"] + dec["trace_s"],
                "kernel_calls": {k: pre["kernels"].get(k, {}).get("calls", 0)
                                 + dec["kernels"].get(k, {}).get("calls", 0)
                                 for k in set(pre["kernels"])
                                 | set(dec["kernels"])}}


def dryrun_worker(name: str, out: str) -> int:
    """``chip_smoke.py --dryrun-worker NAME OUT``: phase 17's dry run of
    cell ``name``, its record written to ``out``."""
    pathlib.Path(out).write_text(json.dumps(dry_cell(name)))
    return 0


def dry_workers() -> dict:
    """Phase 17's dry runs, started at once: a worker for each cell of
    ``DRY_CELLS`` and the dry run's CLI for each of ``DRY_PRODUCTION``;
    {name: (process, its record's path)}."""
    from repro_torch.launch import dryrun
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    DRY_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve()
                                          .parent / "src"))
    cmds = {name: ([sys.executable, __file__, "--dryrun-worker", name,
                    str(DRY_OUT / f"{name}.json")], DRY_OUT / f"{name}.json")
            for name in DRY_CELLS}
    for arch, shape, mp in DRY_PRODUCTION:
        cid = dryrun.cell_id(arch, shape, mp)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(DRY_OUT)]
        if mp:
            cmd += ["--multipod", "--no-cost"]
        cmds[cid] = (cmd, DRY_OUT / f"{cid}.json")
    procs = {}
    for name, (cmd, path) in cmds.items():
        with open(DRY_OUT / f"{name}.err", "w") as err:
            procs[name] = (subprocess.Popen(cmd, env=env,
                                            stdout=subprocess.DEVNULL,
                                            stderr=err), path)
    return procs


def dry_record(procs: dict, name: str, deadline: float) -> dict:
    """Worker ``name``'s record once it has exited 0; it is killed past
    ``deadline``."""
    proc, path = procs[name]
    try:
        proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    err = (DRY_OUT / f"{name}.err").read_text()[-3000:]
    check(proc.returncode == 0 and path.exists(),
          f"dry run {name}: worker exited {proc.returncode}\n{err}")
    return json.loads(path.read_text())


def dry_real(name: str, dev) -> dict:
    """Phase 17's cell ``name`` run once on the card, the state resident
    before the peak is reset: the step's peak of ``max_memory_allocated``
    above what was allocated before the cell, and its launches."""
    from repro_torch.backends import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    cfg, shapes = dry_config(name), dry_shapes(name)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = shapes.get("train") or shapes["prefill"]
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                               shape.seq_len), generator=g,
                           device=dev, dtype=torch.int32)
    train = "train" in shapes
    model = tfm.init_model(cfg, seed=SEED, device=dev, train=train)
    if train:
        step, _ = steps_mod.build_train_step(cfg, shape, device=dev)
        args = (steps_mod.TrainState(model, adamw.init(
            dict(model.named_parameters()), adamw.AdamWConfig()),
            torch.zeros((), dtype=torch.int32, device=dev)),
            {"tokens": tokens})
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    registry.reset_resolution_counts()
    t0 = time.perf_counter()
    if train:
        _, metrics = step(*args)
        loss = float(metrics["loss"])
        check(np.isfinite(loss), f"dry run {name}: the loss is {loss}")
    else:
        pre, _ = steps_mod.build_prefill(cfg, shape, device=dev)
        logits, state = pre(model, {"tokens": tokens},
                            shapes["decode"].seq_len)
        token = torch.argmax(logits, dim=-1)
        del logits
        serve, _ = steps_mod.build_serve_step(cfg, shapes["decode"],
                                              device=dev)
        serve(model, state, token)
        del state, token
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    plain = {op: n for (op, b), n in registry.resolution_counts().items()
             if b == "torch" and n}
    check(not plain, f"dry run {name}: plain versions resolved on the "
          f"card: {plain}")
    out = {"peak_bytes": peak, "resident_bytes": resident, "wall_s": wall,
           "launches": launch_counts()}
    del model, tokens
    if train:
        del args
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fake_branches_held(dev) -> dict:
    """Each of the five kernels on the dry run's path at a phase's shape
    (phase 8's bf16 prefill, its fp32 prefill and its decode step over the
    cache, phase 9's falcon-mamba scan with its state, in fp32 and, phase
    18's, in bf16): the fake branch on
    meta copies of the operands gives outputs of the launch's shapes,
    dtypes and strides, counts one fake call and launches nothing."""
    from repro_torch.kernels import (fake_counts, launch_counts, ops,
                                     reset_fake_counts)
    cfg = lm_config()
    bh, d = LM_BATCH * cfg.n_heads, cfg.head_dim
    cache = LM_PROMPT + LM_GEN
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    scfg = ssm_config()
    di, n = scfg.d_inner, scfg.ssm_state
    cases = {
        "flash_attention_mma": ("flash_attention", tuple(
            randn(bh, LM_PROMPT, d) for _ in range(3)), {"causal": True}),
        "flash_attention_tf32x3": ("flash_attention", tuple(
            randn(bh, LM_PROMPT, d, dtype=torch.float32) for _ in range(3)),
            {"causal": True}),
        "flash_attention_splitkv": ("flash_attention", (
            randn(bh, 1, d), randn(bh, cache, d), randn(bh, cache, d)),
            {"causal": True, "q_offset": LM_PROMPT}),
        "mamba_scan": ("mamba_scan", (
            randn(LM_BATCH, LM_PROMPT, di, dtype=torch.float32),
            torch.rand(LM_BATCH, LM_PROMPT, di, generator=g, device=dev)
            * 0.19 + 0.01,
            -(torch.rand(di, n, generator=g, device=dev) * 1.5 + 0.5),
            randn(LM_BATCH, LM_PROMPT, n, dtype=torch.float32),
            randn(LM_BATCH, LM_PROMPT, n, dtype=torch.float32),
            randn(di, dtype=torch.float32)), {"return_state": True}),
    }
    # phase 18's bf16 state on the same operands
    cases["mamba_scan_bf16_state"] = ("mamba_scan", cases["mamba_scan"][1], {
        "return_state": True, "state_dtype": torch.bfloat16})
    held = {}
    for kernel, (op, args, kw) in cases.items():
        before = launch_counts()
        real = getattr(ops, op)(*args, **kw)
        launched_ = {k: c - before[k] for k, c in launch_counts().items()
                     if c != before[k]}
        check(launched_ == {kernel: 1}, f"fake branch {kernel}: the real "
              f"call launched {launched_}")
        reset_fake_counts()
        before = launch_counts()
        fake = getattr(ops, op)(*(a.to("meta") for a in args), **kw)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        got = [(tuple(f.shape), str(f.dtype), f.stride()) for f in fake]
        want = [(tuple(r.shape), str(r.dtype), r.stride()) for r in real]
        counts = fake_counts()
        log(f"fake branch {kernel}: outputs {got}; launch {want}; "
            f"{counts[kernel]['flops']:.4e} FLOPs, "
            f"{counts[kernel]['bytes']:.4e} bytes counted")
        check(got == want, f"fake branch {kernel}: {got} != {want}")
        check(launch_counts() == before and set(counts) == {kernel}
              and counts[kernel]["calls"] == 1,
              f"fake branch {kernel}: launched or miscounted ({counts})")
        held[kernel] = {"outputs": got, **counts[kernel]}
        del args, real, fake
    reset_fake_counts()
    torch.cuda.empty_cache()
    return held


def dryrun_phase(dev, card: str) -> dict:
    """Phase 17: the dry run's memory model held on the card (the module
    docstring's item 17)."""
    from repro_torch.kernels import fake_counts
    from repro_torch.launch import accounting
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    taken = fake_counts()
    check(not taken, f"dry run: a fake branch was taken before phase 17: "
          f"{taken}")
    procs = dry_workers()
    log(f"dry run: the card's total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B, the dry "
        f"run's H100_BYTES {dryrun.H100_BYTES} B ({card})")
    deadline = time.perf_counter() + DRY_TIMEOUT
    try:
        real = {name: dry_real(name, dev) for name in DRY_CELLS}
        check(not fake_counts(), f"dry run: a CUDA tensor took the fake "
              f"branch: {fake_counts()}")
        launches = {k: sum(r["launches"][k] for r in real.values())
                    for k in real["olmo_train"]["launches"]}
        branches = fake_branches_held(dev)
        cells = {}
        for name in DRY_CELLS:
            dry = dry_record(procs, name, deadline)
            got, want = dry["memory"]["peak_bytes"], real[name]["peak_bytes"]
            ratio = got / want
            cfg, shapes = dry_config(name), dry_shapes(name)
            model_f = sum(accounting.model_flops(cfg, s)
                          for s in shapes.values())
            log(f"dry run {name} ({card}): peak predicted {got} B, measured "
                f"{want} B on the card (state {real[name]['resident_bytes']}"
                f" B), ratio {ratio:.4f}; FLOPs {dry['flops_per_device']:.4e}"
                f" against model FLOPs {model_f:.4e} (ratio "
                f"{model_f / dry['flops_per_device']:.4f}); kernel calls "
                f"{json.dumps(dry['kernel_calls'])}; trace "
                f"{dry['trace_s']:.1f} s, card step {real[name]['wall_s']:.2f}"
                f" s")
            check(abs(ratio - 1) <= DRY_PEAK_TOL,
                  f"dry run {name}: predicted peak {got} B is not within "
                  f"{DRY_PEAK_TOL:.0%} of the card's {want} B")
            cells[name] = {"predicted": got, "measured": want,
                           "ratio": ratio,
                           "flops": dry["flops_per_device"],
                           "model_flops": model_f,
                           "trace_s": dry["trace_s"]}
        production = {}
        for arch, shape, mp in DRY_PRODUCTION:
            cid = dryrun.cell_id(arch, shape, mp)
            rec = dry_record(procs, cid, deadline)
            mem = rec["memory"]
            log(f"dry run {arch} x {shape} on {rec['mesh']} ({card}): "
                f"argument {mem['argument_bytes']} B, peak "
                f"{mem['peak_bytes']} B, fits {mem['fits']}, collectives "
                f"{json.dumps(rec['collectives'])}, roofline "
                f"{json.dumps(rec['roofline'])} -> {rec['dominant']}; "
                f"trace {rec['trace_s']} s")
            check(mem["peak_bytes"] > mem["argument_bytes"] > 0
                  and rec["collective_bytes_per_device"] > 0,
                  f"dry run {cid}: an empty record")
            production[cid] = rec
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t_phase
    log(f"dry run: launches {json.dumps({k: n for k, n in launches.items() if n})}"
        f"; phase {wall:.1f} s")
    return {"cells": cells, "branches": branches, "production": production,
            "launches": launches, "wall_s": wall}


# -- phase 18: ssm_dtype="bfloat16" -------------------------------------------

def bf16_state_config(cfg):
    """``cfg`` with the reference's bf16 scan state."""
    import dataclasses
    return dataclasses.replace(cfg, ssm_dtype="bfloat16")


def bf16_serve(dev) -> dict:
    """falcon-mamba-7b whole with ``ssm_dtype="bfloat16"`` through
    ``serve.generate`` at phase 9's cell: one bf16-state scan a layer a
    prefill and none in decode, the served prefill's scan calls of
    ``BF16_SERVE_HELD_LAYERS`` held at the op; then on the same weights
    and prompt a prefill with the bf16 state and one with the fp32 state,
    their logits' distance."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    cfg = bf16_state_config(ssm_config())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = []
    with scans_held(held, keep=set(BF16_SERVE_HELD_LAYERS), now=False):
        reset_launch_counts()
        gen, line = serve.generate(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                                   gen_len=LM_GEN, seed=SEED, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_scan = counts["mamba_scan_bf16_state"]
    log(f"ssm bf16 state serve: {json.dumps(line)}; prefill_s "
        f"{line['prefill_s']}, decode_per_token_s "
        f"{line['decode_per_token_s']}; mamba_scan_bf16_state launches "
        f"{n_scan} (the prefill's; none in decode); peak device memory "
        f"{peak_gb:.2f} GB")
    served("ssm bf16 state", gen, cfg, counts,
           {"mamba_scan_bf16_state": cfg.n_layers})
    check_scans(held, f"ssm bf16 state serve ({LM_PROMPT}-token prefill, "
                f"layers {list(BF16_SERVE_HELD_LAYERS)})",
                len(BF16_SERVE_HELD_LAYERS))

    model = tfm.init_model(cfg, seed=SEED, device=dev)  # serve's weights
    tokens = torch.as_tensor(lm_prompt(cfg), dtype=torch.int64, device=dev)
    logits = {}
    for name, c in (("bf16", cfg), ("fp32", ssm_config())):
        reset_launch_counts()
        out, _ = tfm.prefill(model, {"tokens": tokens}, c,
                             cache_len=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
        launched(f"ssm {name} state prefill", launch_counts(),
                 {scan_kernel(c): cfg.n_layers})
        logits[name] = out[:, :cfg.vocab_size].float()
        del out
    del model
    torch.cuda.empty_cache()
    l16, l32 = logits["bf16"], logits["fp32"]
    check(bool(torch.isfinite(l16).all() and torch.isfinite(l32).all()),
          "ssm bf16 state: non-finite logits")
    first = l16.argmax(-1).cpu().numpy()
    check(np.array_equal(first, gen[:, 0]), "ssm bf16 state: the prefill "
          "does not give the served first token")
    dist = errors(l16, l32)
    same = int((l16.argmax(-1) == l32.argmax(-1)).sum())
    log(f"ssm bf16 state: the prefill's last logits against the fp32 "
        f"state's on the same weights and prompt: relative Frobenius "
        f"{dist[2]:.4e}, max_abs_err {dist[0]:.4e} ({dist[1]:.4e} of max "
        f"|logit|); the same next token in {same} of {LM_BATCH} rows")
    return {"serve": line, "launches": counts, "peak_gb": peak_gb,
            "held": held, "logits_rel": dist[2], "logits_max_abs": dist[0],
            "same_argmax": same}


def bf16_train(dev, fp32_run: dict) -> dict:
    """falcon-mamba-7b cut to 4 layers with ``ssm_dtype="bfloat16"``
    trained as phase 16's ssm run (``fp32_run``; ``train.run``,
    ``TRAIN_STEPS`` steps): losses finite and falling, two bf16-state
    scans a layer a step (forward, remat), no plain version resolved;
    then the held and profiled step (``family_held_step``: layers 0 and
    3's scan calls at the op) and the extra time a step split
    (``bf16_step_split``)."""
    fp32_losses = fp32_run["losses"]
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import accounting
    arch, _, batch, seq = FAMILY_RUNS["ssm"]
    cfg = bf16_state_config(family_config("ssm"))
    want = family_launches(cfg)
    run = run_train(f"ssm bf16 state {arch} (cut to {cfg.n_layers} "
                    f"layers), B {batch} x {seq}, lr {family_lr('ssm')}",
                    family_argv("ssm"), dev, cfg=cfg)
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
          f"train ssm bf16 state: the loss did not fall ({losses})")
    launched("train ssm bf16 state", run["launches"],
             {k: TRAIN_STEPS * n for k, n in want.items()})
    check(not run["plain"], f"train ssm bf16 state: plain versions ran on "
          f"the path: {run['plain']}")
    step_s = float(np.median(run["times"][1:]))
    tokens = batch * seq
    flops = accounting.model_flops(cfg, ShapeCell("smoke", seq, batch,
                                                  "train"))
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, fp32_losses))
    log(f"train ssm bf16 state: step {step_s:.4f} s (median of steps "
        f"2-{TRAIN_STEPS}), {tokens / step_s:.1f} tokens/s, "
        f"{flops / step_s / PEAK_BF16:.4f} of the bf16 peak; peak device "
        f"memory {run['peak_gb']:.2f} GB; losses against phase 16's fp32 "
        f"state {json.dumps(fp32_losses)}: up to {gap:.4e} relative")
    gc.collect()
    torch.cuda.empty_cache()
    held = family_held_step("ssm", cfg, dev)
    held.pop("kept")
    split = bf16_step_split(held["profile"], fp32_run, step_s, cfg.n_layers)
    return {"losses": losses, "launches": run["launches"], "step_s": step_s,
            "times": run["times"], "peak_gb": run["peak_gb"],
            "fp32_loss_gap": gap, "held_loss": held["loss"],
            "split": split}


def bf16_step_split(prof: dict, fp32_run: dict, step_s: float,
                    n_layers: int) -> dict:
    """The bf16-state train step's extra time over phase 16's fp32-state
    step (medians of the timed runs), split by the two profiled steps:
    the scan kernel's forward and recompute calls (device time a call x
    2 n_layers) and the torch scan backward (its calls' CUDA-event time);
    the rest is the step's other work."""
    f32 = fp32_run["profile"]

    def scan_s(p):
        return sum(p[part]["scan_device_ms"] * p[part]["scan_calls"]
                   for part in ("forward", "backward")
                   if p[part]["scan_device_ms"] is not None) / 1e3

    def bwd_s(p):
        return sum(p["bwd_ms"].get("scan_backward", [])) / 1e3
    extra = step_s - fp32_run["step_s"]
    out = {"extra_s": extra, "scan_kernel_s": scan_s(prof) - scan_s(f32),
           "scan_backward_s": bwd_s(prof) - bwd_s(f32),
           "bf16": {"scan_fwd_device_ms": prof["forward"]["scan_device_ms"],
                    "scan_recompute_device_ms":
                        prof["backward"]["scan_device_ms"],
                    "scan_backward_ms_a_layer": bwd_s(prof) * 1e3 / n_layers,
                    "step_wall_s": prof["step"]["wall_s"]},
           "fp32": {"scan_fwd_device_ms": f32["forward"]["scan_device_ms"],
                    "scan_recompute_device_ms":
                        f32["backward"]["scan_device_ms"],
                    "scan_backward_ms_a_layer": bwd_s(f32) * 1e3 / n_layers,
                    "step_wall_s": f32["step"]["wall_s"]}}
    out["other_s"] = extra - out["scan_kernel_s"] - out["scan_backward_s"]
    log(f"train ssm bf16 state: the step's extra {extra:.4f} s over phase "
        f"16's fp32 state ({step_s:.4f} against {fp32_run['step_s']:.4f}) "
        f"splits into the scan kernel {out['scan_kernel_s']:.4f} s "
        f"(forward and recompute, device time), the torch scan backward "
        f"{out['scan_backward_s']:.4f} s, the rest {out['other_s']:.4f} s; "
        f"profiled steps {json.dumps({k: out[k] for k in ('bf16', 'fp32')})}")
    return out


def bf16_kernel(dev, rows: dict) -> dict:
    """The bf16-state instance at phase 9's shape (fp32 operands, as the
    model passes them): held at the op to the plain version in bf16-state
    mode, timed with CUDA events beside the fp32 state's kernel on the
    same operands, each with its bound."""
    from repro_torch.kernels import launch_counts, ref
    from repro_torch.kernels import mamba_scan as ms
    cfg = ssm_config()
    b, L, di, n = LM_BATCH, LM_PROMPT, cfg.d_inner, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)
    args = (randn(b, L, di), rand(b, L, di) * 0.19 + 0.01,
            -(rand(di, n) * 1.5 + 0.5), randn(b, L, n), randn(b, L, n),
            randn(di))
    bf16 = torch.bfloat16
    before = launch_counts()
    y, state = ms.mamba_scan(*args, return_state=True, state_dtype=bf16)
    moved = {k: c - before[k] for k, c in launch_counts().items()
             if c != before[k]}
    check(moved == {"mamba_scan_bf16_state": 1}, f"mamba_scan[bf16 state] "
          f"launched {moved}")
    plain = []
    t_p = time_ms(lambda: plain.append(ref.mamba_scan(
        *args, return_state=True, state_dtype=bf16)), 1, warmup=0)
    # held against the timed plain call's result (not a second 1.2 s run)
    held = hold_scan(lambda *a, **k: plain[0], 0, args,
                     {"return_state": True, "state_dtype": bf16},
                     (y, state))
    want_y, want_state = plain.pop()
    err = max(float((y - want_y).abs().max()),
              float((state - want_state).abs().max()))
    del want_y, want_state
    t16 = time_ms(lambda: ms.mamba_scan(*args, return_state=True,
                                        state_dtype=bf16), 10)
    t32 = time_ms(lambda: ms.mamba_scan(*args, return_state=True), 10)
    # the profiler's device time or, if its trace holds none (as after
    # phase 16's and this phase's profiled steps), the CUDA events' time
    # over the back-to-back calls: at a millisecond a call the host keeps
    # the queue full, so that is the kernels' time on the card
    d16 = device_ms(lambda: ms.mamba_scan(*args, return_state=True,
                                          state_dtype=bf16), 3)
    d32 = device_ms(lambda: ms.mamba_scan(*args, return_state=True), 3)
    by16 = by32 = "profiler"
    if d16 is None:
        d16, by16 = t16, "CUDA events over back-to-back calls"
    if d32 is None:
        d32, by32 = t32, "CUDA events over back-to-back calls"
    prims = ms.bf16_primitive_mismatches(dev)
    spills = rows["mamba_scan_bf16_state"].get("ptxas") or {}
    b16 = scan_bound(cfg, b, L, bf16_state=True)
    b32 = scan_bound(cfg, b, L)
    shape = f"{b}x{L}x{di} N {n} fp32 operands (falcon-mamba-7b)"
    log(f"mamba_scan_bf16_state[{shape}]: max_abs_err {err:.3e}, y "
        f"relative Frobenius {held['y_rel_frobenius']:.3e} (tol "
        f"{SCAN_BF16_Y_TOL:g}), final state bitwise the plain version's: "
        f"{held['state_bitwise']} (within one bf16 ulp: "
        f"{held['over'] == 0}); kernel_ms {t16:.4f} (device "
        f"{d16:.4f}, {by16}) plain_ms "
        f"{t_p:.4f} library_ms null bound_ms {b16[0]:.4f} ({b16[1]}); the "
        f"fp32 state's kernel on the same operands {t32:.4f} ms (device "
        f"{d32:.4f}, {by32}), bound "
        f"{b32[0]:.4f} ({b32[1]}); bf16 / fp32 state {t16 / t32:.2f}x")
    log(f"mamba_scan_bf16_state: packed primitives against their plain "
        f"counterparts at every input: {json.dumps(prims)}; ptxas "
        f"{json.dumps(spills)}")
    check(held["over"] == 0 and held["state_bitwise"], f"mamba_scan_bf16_"
          f"state: off the plain version beyond its contract or its final "
          f"state not bitwise: {held}")
    check(all(p["mismatches"] == 0 for p in prims.values()),
          f"mamba_scan_bf16_state: a packed primitive differs from its "
          f"plain counterpart: {prims}")
    check(spills.get("spill_stores", 0) == spills.get("spill_loads", 0)
          == 0, f"mamba_scan_bf16_state: ptxas spills {spills}")
    rows["mamba_scan_bf16_state"].update(
        max_abs_err=err, ms=t16, plain_ms=t_p, library_ms=None,
        bound_ms=b16[0], bound_by=b16[1], device_ms=d16,
        device_ms_by=by16, shape=shape,
        y_rel_frobenius=held["y_rel_frobenius"],
        state_bitwise=held["state_bitwise"], fp32_state_ms=t32,
        fp32_state_device_ms=d32, fp32_state_bound_ms=b32[0],
        primitive_mismatches={k: p["mismatches"] for k, p in prims.items()})
    return {"ms": t16, "fp32_ms": t32, "plain_ms": t_p, "bound": b16,
            "fp32_bound": b32, "device_ms": d16, "fp32_device_ms": d32,
            "primitives": prims}


def bf16_state_phase(dev, rows: dict, fp32_run: dict) -> dict:
    """Phase 18: ``ssm_dtype="bfloat16"`` on the card (the module
    docstring's item 18); ``fp32_run``: phase 16's ssm run."""
    t_phase = time.perf_counter()
    served_run = bf16_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    trained = bf16_train(dev, fp32_run)
    kernel = bf16_kernel(dev, rows)
    launches = {k: served_run["launches"][k] + trained["launches"][k]
                for k in served_run["launches"]}
    wall = time.perf_counter() - t_phase
    log(f"bf16 state: launches "
        f"{json.dumps({k: n for k, n in launches.items() if n})}; phase "
        f"{wall:.1f} s")
    return {"serve": served_run, "train": trained, "kernel": kernel,
            "launches": launches, "wall_s": wall}


# -- phase 19: cold start, the persistent executable tier ---------------------

COLD_ROWS = ("cold", "warm_disk", "warmup")   # the three fresh replicas
COLD_DIR = pathlib.Path(__file__).resolve().parent / "build" / "cold_start"
COLD_DEPTH = 3               # max_inflight of the fresh replicas
COLD_TIMEOUT = 300           # seconds a replica may take, nvcc included
# the flush's four kernels as the profiler names them
GRAPH_KERNELS = {"covariance": r"\bgram_kernel\b",
                 "jacobi_sweep": r"\bsweep_grid_kernel\b",
                 "jacobi_sweep_smem": r"\bsweep_smem_kernel\b",
                 "mm_engine_matmul": r"\bmm_kernel\b"}


def cold_spec(cache_dir, depth: int):
    """Phase 6's server as a ``ServerSpec`` with the persistent tier armed
    at ``cache_dir``."""
    from repro_torch.serving import (CacheSpec, ExecutionSpec,
                                     SchedulingSpec, ServerSpec)
    return ServerSpec(
        scheduling=SchedulingSpec(mode="pow2", T=FLUSH_T,
                                  max_batch=FLUSH_REQUESTS,
                                  max_inflight=depth),
        execution=ExecutionSpec(backend=BACKEND, fused=True, sweeps=SWEEPS),
        cache=CacheSpec(cache_dir=str(cache_dir)))


def served_digest(served: list) -> str:
    """SHA-256 of served results, field by field in order."""
    import dataclasses
    import hashlib
    h = hashlib.sha256()
    for res in served:
        for f in dataclasses.fields(res):
            h.update(np.ascontiguousarray(getattr(res, f.name)).tobytes())
    return h.hexdigest()


def burst_profile(burst: list):
    from repro_torch.serving import TrafficProfile
    return TrafficProfile.from_shapes([(op, a.shape, 1) for op, a in burst])


def cold_start_worker(row: str, cache_dir: str, out: str,
                      t_launch: str) -> int:
    """``chip_smoke.py --cold-start-worker ROW CACHE_DIR OUT T_LAUNCH``: one
    fresh replica of phase 19 (``row`` of ``COLD_ROWS``) serving phase 6's
    burst through ``PCAServer.from_spec`` with ``cache_dir`` armed; its
    record is written to ``out``.  ``T_LAUNCH`` is the parent's
    ``time.time()`` when it started this process."""
    t_start = time.monotonic() - (time.time() - float(t_launch))
    from repro_torch.core.precision import ERROR_BUDGETS
    from repro_torch.kernels import build
    from repro_torch.serving import PCAServer
    t_imported = time.monotonic()
    requests = flush_requests()
    burst = [(op, a) for op, mats in requests.items() for a in mats]
    t_server = time.monotonic()
    srv = PCAServer.from_spec(cold_spec(cache_dir, COLD_DEPTH),
                              device="cuda")
    warm = srv.warmup(burst_profile(burst)) if row == "warmup" else None
    t_burst = time.monotonic()
    tickets = [srv.submit(a, op=op) for op, a in burst]
    srv.drain()
    served = [t.result() for t in tickets]
    t_end = time.monotonic()
    first = min(r.t_done for r in srv.stats.records)
    summary = srv.stats.summary()
    budget = ERROR_BUDGETS["fp32"]
    worst = {}
    for (op, a), res in zip(burst, served):
        got = res.S if op == "svd" else res.eigenvalues
        err = rel_frobenius(got, reference_values(op, a))
        worst[op] = max(worst.get(op, 0.0), err)
        check(np.isfinite(got).all() and got.shape == (a.shape[1],)
              and err <= budget["svd" if op == "svd" else "eigh"],
              f"cold start {row} {op} {a.shape}: rel-Frobenius {err:.3e} "
              f"over budget")
    pathlib.Path(out).write_text(json.dumps({
        "row": row, "ttfr_process_s": first - t_start,
        "ttfr_server_s": first - t_server,
        "import_s": t_imported - t_start,
        "requests_s": t_server - t_imported, "warmup": warm,
        "burst_wall_s": t_end - t_burst,
        "requests_per_s": len(burst) / (t_end - t_burst),
        "latency_p50_ms": summary["latency_p50_ms"],
        "latency_p99_ms": summary["latency_p99_ms"],
        "flushes": summary["flushes"], "cache_hits": srv.stats.cache_hits,
        "nvcc_runs": build.nvcc_runs(), "nvcc_s": build.nvcc_seconds(),
        "cache": srv.cache_summary(), "sha256": served_digest(served),
        "worst": worst}))
    return 0


def cold_replicas() -> dict:
    """Phase 19 (a): the three fresh replicas one after the other, each a
    process of its own with an empty build directory: ``cold`` on an empty
    cache directory (nvcc runs, every key captured and stored), then
    ``warm_disk`` and ``warmup`` on the directory ``cold`` seeded."""
    cache = COLD_DIR / "cache"
    cache.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve()
                                          .parent / "src"))
    from repro_torch.kernels import build
    rows = {}
    for row in COLD_ROWS:
        out = COLD_DIR / f"{row}.json"
        env[build.BUILD_ENV] = str(COLD_DIR / f"build_{row}")
        proc = subprocess.run(
            [sys.executable, __file__, "--cold-start-worker", row,
             str(cache), str(out), repr(time.time())],
            env=env, capture_output=True, text=True, timeout=COLD_TIMEOUT)
        check(proc.returncode == 0, f"cold start {row}: exit "
              f"{proc.returncode}\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-4000:]}")
        rec = rows[row] = json.loads(out.read_text())
        disk = rec["cache"]["disk"]
        log(f"cold start {row}: first result {rec['ttfr_process_s']:.3f} s "
            f"after process start, {rec['ttfr_server_s']:.3f} s after "
            f"server construction (imports {rec['import_s']:.3f} s, the "
            f"requests {rec['requests_s']:.3f} s); burst "
            f"{rec['burst_wall_s']:.3f} s, "
            f"{rec['requests_per_s']:.1f} requests/s, p50 "
            f"{rec['latency_p50_ms']:.1f} ms p99 {rec['latency_p99_ms']:.1f} "
            f"ms; nvcc {rec['nvcc_runs']} runs, {rec['nvcc_s']:.1f} s; "
            f"warmup {json.dumps(rec['warmup'])}; disk {json.dumps(disk)}; "
            f"cache hits {rec['cache_hits']} of {rec['flushes']} flushes; "
            f"worst {json.dumps(rec['worst'])}; sha256 {rec['sha256']}")
    cold, warm = rows["cold"], rows["warmup"]
    check(cold["nvcc_runs"] > 0, "cold start cold: nvcc never ran")
    for row in ("warm_disk", "warmup"):
        check(rows[row]["nvcc_runs"] == 0, f"cold start {row}: nvcc ran "
              f"{rows[row]['nvcc_runs']} times")
    keys = cold["flushes"] - cold["cache_hits"]
    check(cold["cache"]["disk"]["stores"] == keys > 0, f"cold start cold: "
          f"stored {cold['cache']['disk']['stores']} of {keys} keys")
    check(rows["warm_disk"]["cache"]["disk"]["hits"] == keys,
          "cold start warm_disk: not every key a disk hit")
    check(warm["warmup"]["disk"] == warm["warmup"]["executables"] == keys
          and warm["warmup"]["compile"] == 0, f"cold start warmup: "
          f"{json.dumps(warm['warmup'])}")
    check(warm["cache_hits"] == warm["flushes"], "cold start warmup: a "
          "flush missed the cache after the warmup")
    digests = {rec["sha256"] for rec in rows.values()}
    check(len(digests) == 1, f"cold start: the replicas' results differ "
          f"({json.dumps({r: rec['sha256'] for r, rec in rows.items()})})")
    return rows


def graph_replays(srv) -> dict:
    """{kernel: launches} the graphs in ``srv``'s cache have replayed so
    far: each graph's replays times its record's launches of one solve."""
    from repro_torch.serving.sharded import GraphedSolver
    counts = {}
    for key in srv._cache:
        graphed = srv._cache[key]
        check(isinstance(graphed, GraphedSolver), f"cold start: {key} is "
              f"served by {type(graphed).__name__}, not a CUDA graph")
        for name, n in graphed.record["launches"].items():
            counts[name] = counts.get(name, 0) + n * graphed.replays
    return counts


def graph_profile(srv, burst: list) -> dict:
    """One warm pass of ``srv`` under torch.profiler (CPU and CUDA): graph
    launches and the flush kernels' launches by name from its Chrome
    trace, the same counted from the graphs' replays (the trace can lose
    a replay's kernels), the device's busy time (kernels, copies, sets)
    against the wall."""
    from torch.profiler import ProfilerActivity, profile
    before = graph_replays(srv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = serve_pass(srv, burst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = COLD_DIR / "graph_profile.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    counts = {name: sum(1 for e in kernels if re.search(pat, e["name"]))
              for name, pat in GRAPH_KERNELS.items()}
    busy = sum(float(e.get("dur", 0.0)) for e in device) / 1e6
    flushes = stats.summary()["flushes"]
    launches = {name: runtime.count(name) for name in sorted(set(runtime))
                if "Launch" in name}
    replayed = {name: n - before.get(name, 0)
                for name, n in graph_replays(srv).items()}
    doc = {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
           "flushes": flushes, "kernels": counts, "replayed": replayed,
           "graph_launches": sum(1 for name in runtime
                                 if name.startswith("cudaGraphLaunch")),
           "runtime_launches": launches}
    log(f"cold start, profiled warm pass of the graphed server: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{doc['idle_share']:.3f}; {flushes} flushes, "
        f"{doc['graph_launches']} graph launches; kernels by name in the "
        f"trace {json.dumps(counts)}, replayed by the graphs "
        f"{json.dumps(replayed)}; runtime launch calls "
        f"{json.dumps(launches)}")
    return doc


def cold_start_phase(dev, serve: dict) -> dict:
    """Phase 19: (a) ``cold_replicas``; (b) phase 6's burst in this
    process through a server with the tier armed, at depths 1 and 3 (the
    first captures and stores every key, the second loads them), each a
    cold and a warm pass with ``executor.submit`` under the sync guard,
    every pass bitwise phase 6's eager results, the warm passes' numbers
    beside phase 6's, and one profiled warm pass."""
    import dataclasses
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import PCAServer
    t0 = time.perf_counter()
    shutil.rmtree(COLD_DIR, ignore_errors=True)
    COLD_DIR.mkdir(parents=True)
    replicas = cold_replicas()
    want = serve["served"]
    check(replicas["cold"]["sha256"] == served_digest(want),
          "cold start: the replicas' results differ from phase 6's")
    burst = serve["burst"]
    guarded = [0]
    runs = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    for depth in SERVE_DEPTHS:
        srv = PCAServer.from_spec(cold_spec(COLD_DIR / "inproc", depth),
                                  device=dev)
        srv.executor.submit = no_sync(srv.executor.submit, guarded)
        run = runs[depth] = {}
        for name in ("cold", "warm"):
            served, wall, stats = serve_pass(srv, burst)
            summary = stats.summary()
            flushes = list(stats.flush_records)
            for (op, _), g, w in zip(burst, served, want):
                for f in dataclasses.fields(w):
                    check(np.array_equal(getattr(g, f.name),
                                         getattr(w, f.name)),
                          f"cold start max_inflight={depth} {name}: "
                          f"{op}.{f.name} differs bitwise from phase 6")
            run[name] = {
                "wall_s": wall, "requests_per_s": summary["requests_per_s"],
                "latency_p50_ms": summary["latency_p50_ms"],
                "latency_p99_ms": summary["latency_p99_ms"],
                "mean_dispatch_ms": 1e3 * float(np.mean(
                    [f.dispatch_s for f in flushes])),
                "cache_hits": stats.cache_hits, "flushes": len(flushes),
                "disk": srv.cache_summary()["disk"]["hits"]}
            eager = serve["runs"][depth][name]
            log(f"cold start[max_inflight={depth} {name}]: graphed wall "
                f"{wall:.3f} s, {summary['requests_per_s']:.1f} requests/s, "
                f"p50 {summary['latency_p50_ms']:.1f} ms p99 "
                f"{summary['latency_p99_ms']:.1f} ms, dispatch "
                f"{run[name]['mean_dispatch_ms']:.2f} ms a flush; phase 6 "
                f"eager {eager['wall_s']:.3f} s, "
                f"{eager['requests_per_s']:.1f} requests/s, p50 "
                f"{eager['latency_p50_ms']:.1f} ms p99 "
                f"{eager['latency_p99_ms']:.1f} ms, dispatch "
                f"{eager['mean_dispatch_ms']:.2f} ms; disk hits "
                f"{run[name]['disk']}")
        check(run["warm"]["cache_hits"] == run["warm"]["flushes"] > 0,
              f"cold start[max_inflight={depth}]: the warm pass missed")
    check(runs[SERVE_DEPTHS[-1]]["cold"]["disk"] > 0, "cold start: the "
          "second in-process server loaded nothing from disk")
    torch.cuda.synchronize()
    captured = launch_counts()
    log(f"cold start: {guarded[0]} executor.submit calls under "
        f"set_sync_debug_mode('error'), none synced the host; wrapper "
        f"counts (captures, not replays) {json.dumps(captured)}")
    profile = graph_profile(srv, burst)
    for name, n in profile["kernels"].items():
        check(n > 0, f"cold start: the graphed pass's trace names no "
              f"{name} kernel")
    check(profile["graph_launches"] == profile["flushes"],
          f"cold start: {profile['graph_launches']} graph launches for "
          f"{profile['flushes']} flushes")
    replayed = profile["replayed"]
    check(replayed.get("jacobi_sweep", 0) + replayed.get(
        "jacobi_sweep_smem", 0) == SWEEPS * profile["flushes"],
          f"cold start: the graphs replayed {json.dumps(replayed)}, not "
          f"{SWEEPS} sweeps a flush")
    for name, n in profile["kernels"].items():
        check(n <= replayed.get(name, 0), f"cold start: the trace names "
              f"{n} {name} kernels, the graphs replayed "
              f"{replayed.get(name, 0)}")
    launches = {name: profile["kernels"].get(name, 0)
                for name in captured}
    wall = time.perf_counter() - t0
    log(f"cold start: phase {wall:.1f} s")
    return {"replicas": replicas, "runs": runs, "profile": profile,
            "launches": launches, "replayed": replayed, "wall_s": wall}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--dryrun-worker":
        return dryrun_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--cold-start-worker":
        return cold_start_worker(*sys.argv[2:6])
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
    rows["mamba_scan_bf16_state"]["ptxas"] = regs.get("fp32 wide bf16-state")
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
    mesh_lm = mesh_lm_phase(trained, lm, families, dev)
    pod = pod_phase(dev, card)
    moe = moe_phase(dev, lm)
    families16 = train_families_phase(dev)
    dry = dryrun_phase(dev, card)
    bf16 = bf16_state_phase(dev, rows, families16["runs"]["ssm"])
    cold = cold_start_phase(dev, serve)
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
    for arch, run in moe["runs"].items():
        mp = run["profile"]
        rows["flash_attention_mma"][f"moe_{arch}"] = {
            "device_ms": mp["mma_device_ms"], "bound_ms": mp["mma_bound"][0]}
        rows["flash_attention_splitkv"][f"moe_{arch}"] = {
            "device_ms": mp["splitkv_device_ms"],
            "bound_ms": mp["splitkv_bound"][0],
            "decode_busy_share": mp["decode_busy_share"]}
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
    for name, run in families16["runs"].items():
        fp = run["profile"]
        if run["launches"]["flash_attention_mma"]:
            rows["flash_attention_mma"][f"train_{name}"] = {
                "device_ms": fp["forward"]["mma_device_ms"],
                "recompute_device_ms": fp["backward"]["mma_device_ms"],
                "bwd_torch_share": run["bwd_shares"].get(
                    "attention_backward"),
                **{f"bwd_torch_ms_{a['label']}": a["bwd_torch_ms"]
                   for a in run["attention"].values()},
                **{f"bwd_bound_ms_{a['label']}": a["bwd_bound"][0]
                   for a in run["attention"].values()}}
        if run["launches"]["mamba_scan"]:
            rows["mamba_scan"][f"train_{name}"] = {
                "device_ms": fp["forward"]["scan_device_ms"],
                "bound_ms": run["scan_bound"][0],
                "bwd_torch_ms": run["scan_bwd_ms"],
                "bwd_bound_ms": run["scan_bwd_bound"][0],
                "bwd_torch_share": run["bwd_shares"].get("scan_backward")}
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
        elif k.name == "mamba_scan_bf16_state":
            row["launches"] = bf16["serve"]["launches"][k.name]
            row["path"] = "phase 18 serve (falcon-mamba-7b, bf16 state)"
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
        row["launches_mesh_lm"] = mesh_lm["launches"][k.name]
        row["launches_pod"] = pod["launches"][k.name]
        row["launches_moe"] = moe["launches"][k.name]
        row["launches_train_families"] = families16["launches"][k.name]
        row["launches_dryrun"] = dry["launches"][k.name]
        row["launches_bf16_state"] = bf16["launches"][k.name]
        row["launches_cold_start"] = cold["launches"].get(k.name, 0)
        row["launches_cold_start_replayed"] = cold["replayed"].get(k.name,
                                                                   0)
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
