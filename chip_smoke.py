#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one CUDA card.

Drives the port's paths at full width and depth, on windows of 5 frames and
4 fields, with random weights drawn from a seed: FiLMAViT-small at 512x512
(patch 16, embed 384, 6 heads, 12 blocks, 9 fluid parameters; its temporal
branch on K1, the mega route), AViT-big at 512x512 (embed 768, 12 heads;
its temporal branch on K3, the core route), AViT-small on the 512x2048
flow-boiling frames (K3 and K2 with rows of 128 tokens), AViT-small at
512x512 with ``attn_impl=fused_block`` (K4), AViT-tiny on the make-demo
grid (K4 at head dim 16), FiLMAViT-small with ``attn_impl=mega`` (K1 and
K5), AViT-small with ``attn_impl=fused_packed`` (K6) and ``fused`` (K7),
AViT-tiny at 512x512 and 512x2048 (K1, K3 and K2 at head dim 16), and
FiLMAViT-small with ``attn_impl=flash`` (K8 in both branches) training on
the loss kernel (K10), the four measurement probes (P1-P4,
``scripts/probe_*_torch.py``) at their default shapes, and the U-Net
baselines at their configs' full width (ModernUnet, 566.7M parameters;
ClassicUnet with its BatchNorm running statistics) training on K10, every
model-path kernel with continuous tables and with none, FiLMAViT-small with
``bias_type=continuous``, a converted reference checkpoint, the data
path (``.npy`` caches, the native batch assembler, training from files and
the physics gate), and data parallelism (DDP: FiLMAViT-small through K1 and
K2, ClassicUnet through K10 with global BatchNorm statistics, the training
CLI under ``torch.distributed.run``).  The
serving path (the autoregressive rollout) and the training path
(``Trainer.fit``: Lion, or AdamW where the config says, with cosine
warmup); and the hand-written kernels on the way, each at the shapes its
paths give it — the rollout's (batch 1) and the training step's:

1. environment: torch, CUDA, the card, ``nvidia-smi`` name and power limit;
2. build: compile ``bubbleformer_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. K1 forward (``mega_temporal_block``) against ``temporal_branch_plain``,
   x (1, 5, 32, 32, 384) and (8, 5, 32, 32, 384), float32 and bfloat16,
   with both times and that of cuBLAS's two products alone (a partial
   yardstick; bf16 K1 runs its products on the hand-written Hopper GEMM,
   ``csrc/hopper_gemm.cuh``);
4. K2 forward (``lane_axial_attention``) against ``axial_attention_plain``,
   qkv (5, 32, 32, 1152) and (40, 32, 32, 1152), likewise (bf16 on the
   Hopper kernels of ``csrc/lane_hopper.cuh``, float32 on the line kernels),
   with ``scaled_dot_product_attention`` over both directions, the tables as
   masks, forward and backward, at the training shape (a partial yardstick
   for K2, K4, K6 and K7);
5. one float32 window of the whole model on the card (kernels) against the
   same model on the CPU (plain versions);
6. a 20-window bfloat16 rollout through ``inference/rollout.py``: finite, and
   each forward kernel launched 12 x 20 times; frames/s after one warm-up
   window;
7. K1 backward (``mega_temporal_block_bwd``) against
   ``temporal_branch_bwd_plain`` at phase 3's two shapes, every gradient,
   float32 and bfloat16, with both times and that of cuBLAS's four products
   alone; then the device time of each launch of K1's bf16 forward and
   backward chains at the training shape (CUDA events around each launch);
8. K2 backward (``lane_axial_attention_bwd``) against
   ``axial_attention_bwd_plain`` at phase 4's two shapes, likewise;
9. one float32 training step, batch 1, the first ``STEP_BLOCKS`` (4) of the
   12 blocks, against the same step in float64 on
   the CPU: the loss and every parameter gradient, on the card through the
   kernels, on the card through the plain versions (the witness of the
   card's own float32) and on the CPU; once with FiLM drawn near identity
   and once with the FiLM projection at O(0.1), where the first
   InstanceNorm's statistics cancel (the same drop-path masks, drawn by a
   CPU generator, on every side);
10. ``Trainer.fit`` in bfloat16 at batch 8 on synthetic batches, Lion and a
   2-step cosine warmup: every loss finite, each of the four kernels
   launched 12 times per step (K1's forward 24: remat), every parameter
   with a gradient moved, the
   checkpoint written and resumed; ms/step, samples/s and peak memory
   after one warm-up step;
11. K3 forward (``core_temporal_attention``) and backward against
   ``core_temporal_plain`` and ``core_temporal_bwd_plain``, every gradient,
   float32 and bfloat16, at AViT-big's rollout shape (1, 5, 32, 32, 768),
   its training shape (8, 5, 32, 32, 768) and FiLMAViT-small 1024x1024's
   (2, 5, 64, 64, 384), which routes to the core too; with the times of
   both and of cuBLAS's products alone (a partial yardstick: the QKV
   product forward, three products backward; bf16 K3 runs its products on
   the Hopper GEMM) and, at the training shape in bf16, each launch's time;
12. K2 forward and backward at AViT-big's 12 heads, qkv (5, 32, 32, 2304)
   and (40, 32, 32, 2304), with the plain versions' times and sdpa over both
   directions at the second;
13. one float32 AViT-big window on the card (kernels) against the CPU (plain
   versions), all 12 blocks;
14. a 20-window bfloat16 AViT-big rollout: finite, K3 and K2 forward each
   launched 12 x 20 times and K1 never; frames/s;
15. ``Trainer.fit`` on AViT-big in bfloat16 at batch 8 with AdamW and a
   2-step cosine warmup, on synthetic batches that carry fluid parameters
   the model ignores (``poolboiling_saturated``'s): every loss finite, K3
   and K2 forward and backward each launched 12 times per step and K1
   never, every parameter with a gradient moved; ms/step, samples/s and
   peak memory;
16. K2 on long lines and at head dim 16 (``LINE_SHAPES``: the 32x128 grid at
   batch 1 and 4, lines of 512 both ways, AViT-tiny's 6 heads of 16 on a
   64x64 grid and on path E's 64x256 training grid, whose rows of 256 take
   the long-line backward), with sdpa over both directions at batch 4 and
   at head dim 16, and
17. K4 (``fused_block_attention``) at its paths' shapes, forward and every
   gradient against the plain versions (``LINE_RTOL``), with both times
   (bfloat16 on the Hopper kernels, float32 on the line kernels); the
   parameter gradients of both phases repeat bit for bit over two calls;
18. one float32 AViT-small window at 512x2048 on the card against the CPU;
19. a 20-window bfloat16 rollout of it: finite, K3 and K2 forward each
   launched 12 x 20 times, K1 never; frames/s;
20. ``Trainer.fit`` on it in bfloat16 at batch 4 with Lion and a 2-step
   warmup: every loss finite, K3 and K2 forward and backward 12 per step, no
   other kernel, every parameter with a gradient moved; ms/step, samples/s,
   peak memory;
21. AViT-small at 512x512 with ``attn_impl=fused_block``: one float32 window
   card vs CPU, and ``Trainer.fit`` in bfloat16 at batch 8: K4 forward and
   backward 12 per step, K1, K2 and K3 never (the temporal branch on the
   JAX package's XLA plain route, plain PyTorch);
22. AViT-tiny at 64x64 through ``auto`` (temporal unrolled, axial K4 at head
   dim 16): ``Trainer.fit`` at batch 8 with AdamW and a 5-window rollout, K4
   in each of the 4 blocks and no temporal kernel;
23. K1 and K3 at head dim 16 (``BRANCH_SHAPES``: K1 at AViT-tiny's 512^2
   training shape, K3 at its 512x2048 flow-boiling shapes), forward and
   every gradient against the plain versions (``KERNEL_RTOL``), both times
   (each with cuBLAS's products alone and its per-launch times);
24. K5 (``mega_axial_block``) likewise at FiLMAViT-small's rollout and
   training shapes and at AViT-tiny's with ``mega`` (head dim 16), bf16 on
   its Hopper chain (the products on the TMA + wgmma GEMM, the attention on
   ``csrc/lane_hopper.cuh``), with the time of cuBLAS's products alone (a
   partial yardstick: the two projections forward, K1's four products
   backward);
25. K6 (``fused_axial_attention_packed``) and K7 (``fused_axial_attention``)
   at ``SPLIT_SHAPES`` (path D's training shape, the rollout's batch,
   AViT-tiny's head dim 16 grid, the 32x128 flow grid at batch 4 and rows
   of 512 tokens), forward and every gradient (``LINE_RTOL``; bfloat16 on
   the Hopper kernels, ``csrc/lane_hopper.cuh``'s ``kFusedPacked`` and
   ``csrc/flash_hopper.cuh`` over rows and columns, K7's backward on rows
   of 512 on the line kernels, each launch counted on the path its shape
   chooses; float32 on the line kernels), with both times and sdpa over
   both directions (the partial yardstick); the bf16 table and scale
   gradients repeat bit for bit over two calls, and a strided ``v`` view
   (the layer's) gives the bits of its contiguous copy;
26. path C, FiLMAViT-small at 512^2 with ``attn_impl=mega``: one float32
   window card vs CPU, a 20-window bfloat16 rollout (K1 and K5 forward 12 x
   20 times each, no other kernel) and ``Trainer.fit`` in bfloat16 at batch
   8 with Lion (K1 and K5 forward and backward 12 per step, no other
   kernel);
27. path D, AViT-small at 512^2 with ``attn_impl=fused_packed`` and with
   ``fused`` (the temporal branch on the XLA plain route): one float32
   window each, card vs CPU (the line kernels), and ``Trainer.fit`` in
   bfloat16 at batch 8: the route's Hopper kernels forward and backward 12
   per step, no other kernel;
28. path E, AViT-tiny through ``auto``: at 512^2 (64x64 tokens: K1 at head
   dim 16 and the axial kernel the copied lane gate picks, asserted) one
   float32 window card vs CPU and ``Trainer.fit`` in bfloat16 at batch 8
   with AdamW; at 512x2048 (64x256 tokens: K3 at head dim 16)
   ``Trainer.fit`` at batch 4;
29. K8 (``flash_packed_attention``) forward and every gradient against
   ``flash_plain`` and ``flash_bwd_plain`` at path F's shapes (the temporal
   lines (6, B*1024, 5, 64) and the axial rows and columns (6, B*5*32, 32,
   64), B = 1 and 8) and at AViT-tiny's (6, 8*5*64, 64, 16), float32
   against the plain version in float64 (the line kernels) and bfloat16
   against it in bfloat16 (the Hopper kernels; ``LINE_RTOL``), the bias and
   scale gradients repeating bit for bit over two calls, with both times and
   that of ``scaled_dot_product_attention`` with the bias as its mask,
   forward and backward (K8 without the blend: a partial yardstick);
30. K10 (``plane_norms``, the loss's plane sums) forward and backward
   against the plain versions at pred and target (8, 5, 4, 512, 512), the
   prediction in bfloat16 and in float32, the target in float32; the loss
   through it repeats bit for bit;
31. path F, FiLMAViT-small at 512^2 with ``attn_impl=flash``: one float32
   window card vs CPU (FiLM near identity);
32. a 20-window bfloat16 rollout of it: finite, K8 forward launched 36 x 20
   times (12 temporal and 24 axial calls a window), no other kernel;
   frames/s;
33. ``Trainer.fit`` on it in bfloat16 at batch 8, Lion, 2-step warmup, with
   ``BUBBLEFORMER_LOSS_KERNEL=1``: every loss finite, K8 forward and backward
   36 each and K10 forward and backward once each per step, no other kernel,
   every parameter with a gradient moved; ms/step, samples/s, peak memory;
34. one float32 training step of path F on the card with
   ``loss_layout="nhwc"`` against ``"nchw"``: the loss and every gradient;
35. K9 (``lane_px_attention``, the lane route with the QKV projection in the
   kernel) forward and every gradient against ``lane_px_plain`` and
   ``lane_px_bwd_plain`` at ``PX_SHAPES`` (FiLMAViT-small's rollout and
   training shapes, the flow-boiling grid at batch 4 and 8, AViT-tiny at
   512^2), float32 against the plain version in float64 and bfloat16
   against it in bfloat16 (``LINE_RTOL``; the k-LayerNorm bias's gradient
   in bfloat16 held to the plain version's own noise, as K5's), bf16 on its
   Hopper chain, with both times and that of cuBLAS's products alone (a
   partial yardstick: the QKV product forward; the recompute, both
   directions' dW and dx products backward);
36. path G, FiLMAViT-small at 512^2 (the default config) with
   ``BUBBLEFORMER_LANE_PROJ=kernel`` (temporal K1, axial K9): one float32
   window card vs CPU, a 20-window bfloat16 rollout (K1 and K9 forward 12 x
   20 times, no other kernel), ``Trainer.fit`` in bfloat16 at batch 8 with
   Lion under the default remat ``"dots"`` (K1 forward 24 and backward 12,
   K9 forward and backward 12 a step, no other kernel), and the default
   route (K1, K2) likewise in the same call;
37. one float32 training step of FiLMAViT-small at batch 8 on the card with
   ``remat=False`` (twice), ``"dots"`` and ``"full"``: the loss and every
   gradient within 3x the spread of the repeated no-remat step; the peak
   memory and ms/step of each, and the forward launches each makes; then
   AViT-small at 512x2048 (K3, K9) at batch 1 with remat off (twice) and
   ``"dots"``, held alike;
38. AViT-small on the 512x2048 flow-boiling frames (temporal K3, axial K9)
   in ``Trainer.fit``, bfloat16, batch 8, Lion, remat ``"dots"``: it fits on
   the card; and batch 4 with remat off on the K2 route (PR 6's step);
39. the probes' kernels (``bubbleformer_tpu_torch/probes/``,
   ``csrc/probe_*.cu``) against their plain versions at each probe's default
   shape: P1a ``within_roll`` (float32 and bfloat16) and P1b ``lane_core``
   (q (20, 384, 1024)), P2a ``dot_combos``, P2b ``perm_product`` and P2c
   ``chunk_core`` (FiLMAViT-small's width, 32x32 tokens, chunks of 128), P3
   ``stage`` (the embed pyramid's second stage, (20, 256, 256, 96)), and
   P4's ``gram``, ``view_copy`` and ``chunk_gram_apply`` under all 14 layout
   bodies; the rolls, the permutation product and the copies bit-exact,
   the rest within ``KERNEL_RTOL``, P3's statistics the same bits on a
   second call; with the times of both and of the one
   PyTorch call that computes the same function where there is one
   (``torch.roll``, ``torch.matmul``, ``permute().contiguous()``; the Gram
   also in bfloat16 at ``bf16_dot`` beside ``torch.mm`` with a float32
   output), and the device time of each launch of P1a (both dtypes), P2c
   (the chunk kernel's two passes), P1b (``core_kernel``'s column and row
   passes), the Gram (``reshape_col``, ``bf16_dot``) and P4's chunk
   products (both ``chunked_ref_reads_bf16`` launches);
40. the four probe CLIs through their ``main`` at their default flags, each
   with the counters set to 0 before and read after: every check OK, a
   card time in each JSON line, each of the probe's kernels launched and no
   other, every bfloat16 ``lane_core`` and ``chunk_gram_apply`` call on its
   Hopper kernel (``lane_core_hopper``, ``chunk_gram_hopper``; the float32
   ones, ``lane_core_line`` and ``chunk_gram_line``, never);
41. for ClassicUnet (``model_cfg/unet_classic.yaml``) and then ModernUnet
   (``unet_modern.yaml``), with weights from a seed: one float32 window card
   vs CPU in eval mode (the running statistics), ClassicUnet at 512^2 and
   ModernUnet on 128x128 frames (its widths do not depend on the frame),
   no kernel launched;
42. a 20-window bfloat16 rollout of each at 512^2, batch 1: finite, no
   kernel launched, frames/s after one warm-up window; then the heat flux
   of its 100 frames (``utils/heatflux.py:heatflux_torch``, channel 0 the
   distance function, channel 1 the temperature) and the per-field
   relative L2 (``utils/metrics.py:relative_l2_per_field``) against the
   same rollout in float32, both finite;
43. ``Trainer.fit`` of each in bfloat16 at batch 8 at 512^2, Lion, a 2-step
   cosine warmup, ``BUBBLEFORMER_LOSS_KERNEL=1``: every loss finite, K10
   forward and backward once a step and no other kernel, every parameter
   with a gradient moved, ClassicUnet's running statistics moved, and
   ``last.pt`` restored into a fresh module with the step and every tensor
   (the statistics too) equal; ms/step, samples/s, peak memory and each
   phase's seconds.  K10's entries in the kernels line count these
   launches with path F's;
44. K1-K9 once more at their training shapes (``TABLE_SHAPES``) in
   bfloat16, forward and every gradient against the plain versions
   (``KERNEL_RTOL``): with tables from a seeded ``ContinuousPositionBias1D``
   (values about 0.3 to 15.7, ``CPB_DRAW``) and with none, where every
   table gradient must come back None;
45. FiLMAViT-small at 512^2 with ``bias_type=continuous`` on the default
   route (K1, K2), seeded weights (the MLPs as phase 44 draws them, FiLM
   near identity): one float32 window and one float32 training step at
   batch 1, the card's kernels against the plain route on the card (the
   window within ``NEW_WINDOW_RTOL``, the loss and every gradient, the 72
   ``cpb_mlp`` ones among them, within ``SLICE_STEP_RTOL``);
   ``Trainer.fit`` in bfloat16 at batch 8 under remat "dots" for 4 steps
   and a validation batch, with ``transfer_dtype=bfloat16``, a profiler
   window over steps (1, 3) whose trace must name K1's and K2's kernels and
   no other step, ``use_wandb`` with ``wandb`` kept from importing where
   it is installed (no run may reach a network; the CSV must still be
   written) and the validation panels where ``matplotlib`` imports
   (printed which); launches as phase 10's plus a validation
   window's; then a 20-window bfloat16 rollout, frames/s;
46. a Lightning-style ``.ckpt`` of AViT-small at full width (seeded
   weights under ``model.``, ``hyper_parameters.normalization_constants``,
   ``global_step``) through ``scripts/convert_reference_checkpoint_torch.py``
   in a subprocess; the result restored into a training module (every
   tensor, both constant tables and the step equal to what went in) and
   rolled out for 10 windows in bfloat16 on K1 and K2;
47. the data path's environment: the port's C/OpenMP batch assembler
   (``bubbleformer_tpu_torch/native/batch_assembler.c``) built by the
   machine's C compiler with ``-fopenmp`` (the phase fails without one),
   whether ``import h5py`` works (printed), two 40-frame trajectories at
   512x512 written as ``.npy`` field caches with numpy alone, a dataset over
   them opened with ``h5py`` hidden, and its native batches equal to the
   numpy path's bit for bit at factors 1 and 2 under every ``norm``;
48. ``Trainer.fit`` of FiLMAViT-small from those caches through
   ``scripts/train_torch.py`` (``data_cfg=samples_smoke``, fluid parameters,
   ``native_loader=true``; bf16, ``"dots"``, batch 8, 2 epochs of 3 steps
   and a validation batch each): "native loader: enabled", every loss
   finite, K1 and K2 launched as in phase 10 plus the validation windows';
   ms/step and samples/s beside phase 10's, and the loader's ms/batch;
49. the physics gate (``scripts/physics_gate_torch.py``: AViT-tiny at 64x64
   through ``auto``, K4 at head dim 16) cut to 3 epochs (the full gate
   takes longer than the phase may): every key of its JSON, every metric
   finite, K4 launched as its steps, validation batches and float32
   rollouts ask and no other kernel;
50. a one-rank NCCL world in this process: FiLMAViT-small in bfloat16 at
   batch 8, 3 Lion steps through ``DistributedDataParallel`` and the same 3
   steps without it from the same seeded weights and batches: the losses
   and every parameter bit for bit, K1 and K2 launched as 3 steps ask, and
   no "bucket view" warning (a gradient DDP would copy);
51. two ranks on the one card over gloo (NCCL refuses two ranks on one
   GPU; ``chip_smoke.py --dp-worker`` with torchrun's variables), batch 4
   each, against this process at batch 8: FiLMAViT-small's float32 step
   (O(1) weights, FiLM near identity) every gradient within
   ``KERNEL_RTOL``, then 3 bfloat16 Lion steps from the seeded init, the
   losses within the bfloat16 bound and every parameter within 2 lr a step,
   the share of elements apart held to a witness (the one process taking
   each batch as the ranks' two halves, their gradients accumulated;
   ``DP_WITNESS``), both ranks' parameters equal bit for bit after each
   step, K1 and K2 launched as 3 steps ask on each rank;
52. the same world, ClassicUnet in float32 through K10: each rank's output
   its rows of the one process's, the gradients against the same step in
   float64 within 3x the one process's own error, the BatchNorm running
   statistics (global-batch statistics) the one process's;
53. ``scripts/train_torch.py`` under ``python -m torch.distributed.run
   --standalone --nproc_per_node 1`` with ``mesh_cfg=single`` on synthetic
   batches: its world line, ``last.pt`` and ``metrics.csv`` once.

K2's, K4's, K5's, K6's, K7's, K8's and K9's wrappers count every call on
the card (``lane_axial_attention``, ``fused_block_attention``,
``mega_axial_block``, ``fused_axial_attention_packed``,
``fused_axial_attention``, ``flash_packed_attention``, ``lane_px_attention``
and their ``_bwd``) and each dtype's kernels their own launches (bfloat16:
``lane_hopper_fwd``, ``fused_block_hopper_fwd``, ``mega_hopper_fwd``,
``fused_packed_hopper_fwd``, ``fused_hopper_fwd``, ``flash_hopper_fwd``,
``px_hopper_fwd`` and their ``_bwd``; float32: ``lane_line_fwd``,
``fused_block_line_fwd``, ``mega_line_fwd``, ``fused_packed_line_fwd``,
``fused_line_fwd``, ``flash_line_fwd``, ``px_line_fwd`` and theirs;
``DTYPE_PATHS``): every bf16 rollout and
training run holds them to the Hopper kernels and every float32 window and
step to the first chains.  Times are CUDA events around 20 calls
after half a second of warm-up calls (``WARMUP_S``).

Every training step runs under the models' default remat ``"dots"``
(``layers/remat.py``): K1 and K5 launch their forward kernels twice a step
(the backward reruns them, as the JAX policy has it), every other kernel
once (``DOTS_RERUN``).

Prints the run's seconds, a JSON line of the kernels at the training
step's shapes of the path that launches them (with each one's least
possible time on the card from its bytes and operations there), the card's
name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero at the first failed
phase, without a CUDA card, or without the repository beside it.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
IMAGE = 512
TIME_WINDOW = 5
FIELDS = 4
WINDOWS = 20
TRAIN_BATCH = 8
TRAIN_STEPS = 6
BIG_TRAIN_STEPS = 4
# H100 SXM peaks (NVIDIA's data sheet): bf16 dense tensor cores, float32
# outside them, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# Seconds of warm-up calls before each kernel's timing (``cuda_ms``).  Three
# calls alone left a float32 kernel's time dependent on the load before it
# (3.0-3.9% after slow calls, scripts/time_kernels_torch.py, which warms up
# for 1 s); half a second keeps the whole run within its time limit.  The
# plain versions and library calls keep three warm-up calls (``ref_ms``).
WARMUP_S = 0.5
# scripts/make_sample_data.py:77-86, trajectory 0, in FLUID_PARAM_KEYS order.
FLUID_PARAMS = [0.0084, 0.83, 1.0, 0.0083, 0.25, 0.063, 8.34, 0.4, 91.0]
# Forward launches per block and training step under the models' default
# remat ("dots", bubbleformer_tpu_torch/layers/remat.py): K1 and K5 keep
# residuals of their own kernels' making, which the JAX policy does not save,
# so the backward reruns their forward kernels (the JAX package's gradient
# jaxpr has two of their forward pallas_calls a block); every other kernel's
# VJP keeps only its inputs and its output is kept: one launch.
DOTS_RERUN = {"mega_temporal_block": 2, "mega_axial_block": 2}

# Kernel vs plain on the card.  Float32: both sides compute in float32 and
# differ only in summation order (rtol 1e-4 of the output's max).  bfloat16:
# both round at the same points, so what remains are single-ulp bf16 rounding
# flips (2^-8 relative) where reassociated float32 sums straddle a rounding
# boundary, and their propagation: 2e-2 of the output's max.
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Whole float32 window, card (kernels) vs CPU (plain versions): 12 blocks of
# InstanceNorms amplify float32 reassociation; the port's own float32 run is
# ~1e-4 of the output's max from a float64 run on a cut-down model.
WINDOW_RTOL = 2e-3
# The backward kernels against their plain versions: the same two bounds,
# each gradient against its own largest magnitude.  Their parameter
# gradients are float32 atomic sums, reordered from run to run, which the
# float32 bound covers.  The k-LayerNorm bias's gradient is zero up to
# rounding (a shift of every key leaves each softmax row unchanged), so it
# has no scale of its own: it is held against a hundredth of the largest
# gradient of the call.
ZERO_GRADS = ("kn_bias",)
# One float32 training step against the same step in float64 on the CPU,
# every gradient against its own largest magnitude (one that is zero up to
# rounding in float64 against a hundredth of the largest).  Its witnesses
# are the same step on the card through the plain versions and on the CPU.
# FiLM near identity: float32 reassociation through 12 blocks and ~40
# InstanceNorm backwards sets how close any float32 step comes (~2e-5 on
# an H100 and on the CPU); the card through the kernels must stay within 3x
# the worse witness's worst gradient error, plus 1e-5.  FiLM at O(0.1): the
# first InstanceNorm after FiLM (K1's IN1) sees channels whose mean is far
# above their spread, where a single-pass float32 variance cancels: both
# witnesses land 3e-3 to 6e-3 from float64 on the FiLM gradients, and so
# did the kernels while they summed unshifted values (9.2e-3).  The
# kernels' statistics sum values shifted by a sample of the plane and read
# 4.1e-5 here, so the card is held to 1e-4.
STEP_RTOL = {"loss": 1e-4, "vs_witness": 3.0, "abs": 1e-5, "film_o01": 1e-4}
# Phase 9's depth: the first 4 of the 12 blocks (all 12 took 56.5 s of the
# run, most of it the CPU's float64 and float32 steps).  The
# width, the routes and both FiLM cases stay; the other float32 steps
# (phases 37 and 45) keep all 12 blocks.
STEP_BLOCKS = 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def random_state_dict(model, seed: int):
    """Non-trivial weights from a seed: LayerScale gammas, attn scales,
    feature scales and T5 tables at O(1) (the model's own 1e-6 gammas would
    make every block near-identity and a comparison blind to the kernels);
    projections lecun-normal; norms near identity."""
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "gamma_att", "gamma_mlp") or leaf.startswith("attn_scale_factor"):
            a = rng.uniform(0.5, 1.5, p.shape)
        elif leaf in ("low_freq_scalar", "high_freq_scalar"):
            a = rng.uniform(-1.0, 1.0, p.shape)
        elif name.endswith("relative_attention_bias.weight"):
            a = rng.standard_normal(p.shape)
        elif p.ndim >= 2:
            fan_in = int(np.prod(p.shape[1:])) if "debed" not in name else int(
                p.shape[0] * np.prod(p.shape[2:]))
            a = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        elif leaf == "weight":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            a = 0.1 * rng.standard_normal(p.shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def film_near_identity(weights, seed: int):
    """``weights`` with the FiLM projection drawn near identity (gamma ~1,
    beta ~0.1), as the CPU parity tests draw it.  ``random_state_dict``
    draws gamma and beta both at O(0.1); there channels with |beta| >>
    |gamma| put the next InstanceNorm's single-pass float32 variance in
    cancellation, which only shifted sums (the kernels') escape."""
    import torch

    rng = np.random.default_rng(seed)
    out = dict(weights)
    w, b = out["film_embed.film_net.1.weight"], out["film_embed.film_net.1.bias"]
    c = b.shape[0] // 2
    out["film_embed.film_net.1.weight"] = 0.1 * w
    out["film_embed.film_net.1.bias"] = torch.from_numpy(
        (np.concatenate([np.ones(c), np.zeros(c)]) + 0.1 * rng.standard_normal(2 * c))
        .astype(np.float32))
    return out


def cuda_ms(fn, iters: int = 20, warmup_s: float = WARMUP_S) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls,
    after at least three calls and ``warmup_s`` seconds of warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ref_ms(fn) -> float:
    """:func:`cuda_ms` for a plain version or a library call: three warm-up
    calls and no timed warm-up, which was added for the kernels' times."""
    return cuda_ms(fn, warmup_s=0.0)


def k1_gemm_ms(x, wqkv, wout, do=None, qkv=None) -> float:
    """cuBLAS (``torch.matmul``) on K1's products alone at x's shape, a
    partial yardstick: the forward's two (xn W_qkv^T, y2 W_out^T; x stands
    in for xn and y2), or with the output gradient ``do`` and a (R, 3C)
    tensor ``qkv`` standing in for dqkv, the backward's four (do W_out,
    do^T y2, dqkv W_qkv, dqkv^T xn)."""
    import torch

    x2 = x.reshape(-1, x.shape[-1])
    if do is None:
        return ref_ms(lambda: (torch.matmul(x2, wqkv.t()), torch.matmul(x2, wout.t())))
    d2 = do.reshape(x2.shape)
    return ref_ms(lambda: (torch.matmul(d2, wout), torch.matmul(d2.t(), x2),
                            torch.matmul(qkv, wqkv), torch.matmul(qkv.t(), x2)))


def k3_gemm_ms(xn, wqkv, dqkv=None) -> float:
    """cuBLAS (``torch.matmul``) on K3's products alone at xn's shape, a
    partial yardstick: the forward's one (xn W_qkv^T), or with a (R, 3C)
    tensor ``dqkv`` standing in for the raw qkv gradient, the backward's
    three (xn W_qkv^T again, dqkv^T xn, dqkv W_qkv)."""
    import torch

    x2 = xn.reshape(-1, xn.shape[-1])
    if dqkv is None:
        return ref_ms(lambda: torch.matmul(x2, wqkv.t()))
    return ref_ms(lambda: (torch.matmul(x2, wqkv.t()), torch.matmul(dqkv.t(), x2),
                            torch.matmul(dqkv, wqkv)))


def lane_sdpa_ms(qkv, bias_x, bias_y, heads: int):
    """(forward ms, backward ms) of ``scaled_dot_product_attention`` over
    K2's two directions at qkv's shape (BT, H, W, 3C): once over the rows
    (table ``bias_x`` as an additive mask) and once over the columns
    (``bias_y``), the two times summed; the backward by autograd to q, k and
    v.  A partial yardstick (no qk-LN, no blend, no table gradient) for K2,
    K4, K6 and K7, which compute the same two-direction attention; the port
    never calls it."""
    import torch
    import torch.nn.functional as F

    bt, h, w, c3 = qkv.shape
    d = c3 // 3 // heads
    q5 = qkv.detach().reshape(bt, h, w, heads, 3, d)
    fwd = bwd = 0.0
    for perm, bias in (((0, 1, 3, 2, 4), bias_x), ((0, 2, 3, 1, 4), bias_y)):
        q, k, v = (q5[..., i, :].permute(*perm).contiguous() for i in range(3))
        q, k, v = (x.reshape(-1, *x.shape[2:]).requires_grad_() for x in (q, k, v))
        n = q.shape[-2]
        mask = bias.to(qkv.dtype)[None].expand(q.shape[0], heads, n, n)
        fwd += ref_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        grad = torch.randn_like(out)
        bwd += ref_ms(lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True))
        del q, k, v, mask, out, grad
    return fwd, bwd


def launch_line(label: str, args: dict, do, heads: int) -> None:
    """Prints each launch's device time (CUDA events around each launch of
    the C entries, the mean of 5 calls after one warm-up) of the bf16
    forward and backward chains of K1 (``args`` has ``x``) or K3 (``xn``)
    on ``args``."""
    from bubbleformer_tpu_torch.ops import temporal_block_mega as k13

    if "x" in args:
        names, fwd, bwd = k13.PARAM_NAMES, k13.mega_temporal_block_fwd, k13.mega_temporal_block_bwd
    else:
        names, fwd = k13.CORE_PARAM_NAMES, k13.core_temporal_attention_fwd
        bwd = k13.core_temporal_attention_bwd
    act = args["x"] if "x" in args else args["xn"]
    params = [args[k] for k in names]
    acc_f, acc_b = {}, {}
    for i in range(6):
        lf, lb = {}, {}
        out = fwd(act, *params, heads=heads, launch_ms=lf)
        # K1's forward returns its residuals for the backward; K3's keeps none.
        kept = {"residuals": out[1]} if isinstance(out, tuple) else {}
        bwd(do, act, *params, heads=heads, launch_ms=lb, **kept)
        for acc, one in ((acc_f, lf), (acc_b, lb)):
            for k, v in one.items():
                acc[k] = acc.get(k, 0.0) + (v / 5 if i else 0.0)
    for what, acc in (("forward", acc_f), ("backward", acc_b)):
        print(f"  {label} {tuple(act.shape)} per-launch ms ({what}, CUDA events, sum "
              f"{sum(acc.values()):.4f}): " + json.dumps({k: round(v, 4) for k, v in acc.items()}),
              flush=True)


def compare(name: str, got, ref, rtol: float):
    """Max abs / rel error of ``got`` vs ``ref``; fails above ``rtol`` of the
    reference's max."""
    import torch

    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite output")
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    rel = err / max(scale, 1e-30)
    ok = rel <= rtol
    print(f"  {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} rel={rel:.3e} "
          f"(tol {rtol:.0e}) {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_grads(name: str, names, got, ref, rtol: float, zero_noise: bool = False) -> float:
    """``compare`` for a tuple of gradients: each within ``rtol`` of its
    reference's largest magnitude, those in ``ZERO_GRADS`` within ``rtol``
    of a hundredth of the largest of all.  ``zero_noise``: where the two
    sides' rounding noise is uncorrelated (K5 in bfloat16: its ``dao`` comes
    out of an InstanceNorm backward whose reassociated sums flip bfloat16
    roundings; K9 in bfloat16: its qkv comes out of projections summed in
    other orders), a ``ZERO_GRADS`` gradient is held to the reference's own
    noise instead: at most three times its largest magnitude, plus ``rtol``
    of the floor (reported as that ratio).  Prints each gradient's error and
    scale; returns the largest absolute error."""
    import torch

    pairs = [(n, g.float(), r.float()) for n, g, r in zip(names, got, ref) if r is not None]
    floor = 1e-2 * max(r.abs().max().item() for _, _, r in pairs)
    worst, worst_rel, rows = 0.0, 0.0, []
    for n, g, r in pairs:
        if not torch.isfinite(g).all():
            fail(f"{name} {n}: non-finite gradient")
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        if zero_noise and n in ZERO_GRADS:
            rel = rtol * g.abs().max().item() / (3 * scale + rtol * floor)
        else:
            rel = err / (floor if n in ZERO_GRADS else max(scale, 1e-30))
        rows.append(f"{n} {rel:.1e}/{scale:.1e}")
        if rel > rtol:
            print("  " + ", ".join(rows))
            fail(f"{name} {n}: rel {rel:.3e} above {rtol:.0e}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"  {name}: {len(pairs)} gradients, max_abs_err={worst:.3e} max rel={worst_rel:.3e} "
          f"(tol {rtol:.0e}) ok; rel/scale: " + ", ".join(rows), flush=True)
    return worst


def check_repeat(name: str, names, first, again, params: int) -> None:
    """The parameter gradients (from index ``params`` on) of two backward
    calls on the same inputs carry the same bits: they are sums in a fixed
    order (``csrc/param_sums.cuh``)."""
    import torch

    for n, a, b in list(zip(names, first, again))[params:]:
        if a is not None and not torch.equal(a, b):
            fail(f"{name}: the gradient of {n} differs between two calls")
    print(f"  {name}: parameter gradients repeat bit for bit", flush=True)


@contextlib.contextmanager
def plain_attention():
    """Route the model's two attention branches through their plain PyTorch
    versions, differentiated by autograd, on whatever device the model is:
    the witness that tells the kernels' rounding from the rest of the
    card's float32."""
    from bubbleformer_tpu_torch.layers import attention as layers
    from bubbleformer_tpu_torch.ops.axial_lane import axial_attention_plain, project_qkv
    from bubbleformer_tpu_torch.ops.temporal_block_mega import temporal_branch_plain

    def axial(x, wqkv, bqkv, *rest, heads):
        return axial_attention_plain(project_qkv(x, wqkv, bqkv), *rest, heads=heads)

    saved = layers.mega_temporal_block, layers.lane_axial_attention_from_x
    layers.mega_temporal_block, layers.lane_axial_attention_from_x = temporal_branch_plain, axial
    try:
        yield
    finally:
        layers.mega_temporal_block, layers.lane_axial_attention_from_x = saved


def train_step_grads(train_cfgs, weights, batch, where: str, dtype, plain: bool = False,
                     loss_layout: str = "nchw"):
    """``(loss, {name: gradient in float64 on the CPU}, seconds)`` of one
    training step from ``weights`` on ``batch`` with the module's
    ``loss_layout``; ``plain`` takes :func:`plain_attention`."""
    import torch
    from bubbleformer_tpu_torch.training import ConditionedForecastModule

    module = ConditionedForecastModule(*train_cfgs, total_steps=8, device=where, seed=SEED,
                                       loss_layout=loss_layout)
    module.model.load_state_dict(weights)
    module.model.to(dtype)
    with plain_attention() if plain else contextlib.nullcontext():
        t0 = time.perf_counter()
        m = module.train_step(tuple(torch.from_numpy(a).to(where, dtype) for a in batch),
                              torch.Generator().manual_seed(SEED))
        loss = float(m["loss"])
        seconds = time.perf_counter() - t0
    return loss, {n: p.grad.double().cpu() for n, p in module.model.named_parameters()}, seconds


def step_errors(ref, grads):
    """``({name: error}, zero)``: each gradient's max abs error over its
    float64 reference's largest magnitude; for the names in ``zero``, whose
    float64 gradient is zero up to rounding (below 1e-9 of the largest),
    over a hundredth of the largest instead."""
    top = max(r.abs().max().item() for r in ref.values())
    out, zero = {}, []
    for n, r in ref.items():
        scale = r.abs().max().item()
        if scale <= 1e-9 * top:
            zero.append(n)
            scale = 1e-2 * top
        out[n] = (grads[n] - r).abs().max().item() / scale
    return out, zero


def bound(flops: float, nbytes: float, dtype: str):
    """(least ms, what binds): the larger of operations over the card's peak
    for the dtype and bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_work(key: str, shape, dtype: str):
    """(FLOPs, bytes) each kernel must do at ``shape`` in ``dtype``: every
    input read once, every output written once; the weights in the
    activation dtype, the other parameters and their gradients float32.  A
    key's " d16" suffix (head dim 16) changes only the qk-LN vectors.

    K3 (xn of (B, T, H, W, C)): the QKV product and the attention; it reads
    xn and W_qkv and writes ao.  Its backward does three products (the
    projection again, dW_qkv, dxn) and the T x T contractions; it reads dao,
    xn and W_qkv and writes dxn and the float32 dW_qkv.
    K1 (x of (B, T, H, W, C), R = B*T*H*W tokens): the QKV product 2R*C*3C,
    the output product 2R*C*C, the attention 4R*T*C; it reads x and writes
    the output and, for the backward, the rounded qkv (R, 3C) and ao (R, C)
    (its float32 ao is scratch).  The backward does four products (dy2,
    dW_out, dxn, dW_qkv) and five T x T contractions; it reads do, x, qkv
    and ao and writes dx and the float32 weight gradients.  K2 and K4 (qkv of (BT, H,
    W, 3C)): per direction, logits and values 4R*L*C forward, and five L x L
    contractions 10R*L*C backward, with L = W for rows and H for columns;
    they read qkv (and dout) and write out (dqkv).  K6 and K7 (q of (BT, H,
    W, C)): K4's work from q, k and v.  K5 (x of (BT, H, W, C)): K1's two
    products and K4's attention; it reads x and writes the output and, for
    the backward, the rounded qkv (R, 3C) and ao (R, C); its backward reads
    do, x, qkv and ao and writes dx and the float32 weight gradients.
    K9 (x of (BT, H, W, C)): K2's attention and the QKV product 2R*C*3C; it
    reads x and W_qkv and writes out (the qkv is scratch).  Its backward does
    three such products (the projection again, dW, dx) and K2's five
    contractions; it reads x, dout and W_qkv and writes dx and the float32
    dW_qkv.  K8 (q of (heads, M, n, d)): logits and values 4*M*n*n*d per head
    forward, five n x n contractions backward; it reads q, k, v (and dout)
    and writes out (dq, dk, dv), the float32 tables aside.  K10 (pred of
    (B, T, C, H, W), the target float32): ~3 operations a value forward, 2
    backward; it reads pred and the target and writes the (m, 2) sums
    (dpred)."""
    e = 2 if dtype == "bfloat16" else 4
    if key.startswith("P"):
        return probe_work(key, shape, e)
    d = 16 if key.endswith(" d16") or key.endswith(" d16 bwd") else 64
    key = key.replace(" d16", "")
    if key.startswith("K8"):
        heads, m, n, d = shape
        size, tables = heads * m * n * d, 4 * heads * (n * n + 1)
        if key == "K8":
            return 4 * heads * m * n * n * d, 4 * e * size + tables
        return 10 * heads * m * n * n * d, 7 * e * size + 2 * tables
    if key.startswith("K9"):
        bt, h, w, c = shape
        r, heads = bt * h * w, c // d
        vectors = 4 * (3 * c + 4 * d + heads * (h * h + w * w + 2))
        proj = 2 * r * c * 3 * c
        if key == "K9":
            return proj + 4 * r * (h + w) * c, 2 * e * r * c + e * 3 * c * c + vectors
        return (3 * proj + 10 * r * (h + w) * c,
                3 * e * r * c + e * 3 * c * c + 4 * 3 * c * c + 2 * vectors)
    if key.startswith("K10"):
        values, m = int(np.prod(shape)), int(np.prod(shape[:3]))
        if key == "K10":
            return 3 * values, (e + 4) * values + 8 * m
        return 2 * values, (2 * e + 4) * values + 4 * m
    if key.startswith("K3"):
        b, t, h, w, c = shape
        r = b * t * h * w
        params = e * 3 * c * c + 4 * (3 * c + 4 * d)
        if key == "K3":
            return 2 * r * c * 3 * c + 4 * r * t * c, 2 * e * r * c + params
        return 2 * r * c * 3 * c * 3 + 10 * r * t * c, 3 * e * r * c + params + 4 * 3 * c * c
    if key.startswith("K1"):
        b, t, h, w, c = shape
        r = b * t * h * w
        params = 4 * (8 * c + 4 * d + 4 * c + c) + e * 4 * c * c  # vectors + W_qkv, W_out
        if key == "K1":
            return (2 * r * c * 4 * c + 4 * r * t * c,
                    3 * e * r * c + e * r * 3 * c + params)
        return (2 * r * c * 3 * c * 2 + 2 * r * c * c * 2 + 10 * r * t * c,
                4 * e * r * c + e * r * 3 * c + params + 4 * 4 * c * c)
    if key.startswith("K5"):
        bt, h, w, c = shape
        r = bt * h * w
        params = 4 * (8 * c + 4 * d + (h * h + w * w) * c // d) + e * 4 * c * c
        if key == "K5":
            return 2 * r * c * 4 * c + 4 * r * (h + w) * c, 3 * e * r * c + e * r * 3 * c + params
        return (2 * r * c * 4 * c * 2 + 10 * r * (h + w) * c,
                4 * e * r * c + e * r * 3 * c + params + 4 * 4 * c * c)
    bt, h, w, c = shape
    if key[:2] in ("K2", "K4"):
        c //= 3
    r = bt * h * w
    if not key.endswith("bwd"):
        return 4 * r * (h + w) * c, e * r * 4 * c
    return 10 * r * (h + w) * c, e * r * 7 * c


def probe_work(key: str, shape, e: int):
    """(FLOPs, bytes) of the probes' kernels (P1-P4), ``e`` bytes a value of
    the kernel's dtype, tables and statistics float32; every input read
    once, every output written once.

    P1a (x of (rows, total)): reads x, writes two rolls; no arithmetic.
    P1b ((BT, C, H, W, heads)): per axis, logits and values 4*L*C a token
    (L the line); reads q, kv and both (L*heads, N) tables, writes out.
    P2a ((d, ch)): S and pv, 4*d*ch^2; reads the three (d, ch) slices,
    writes S and pv in float32.  P2b ((rows, n)): the product 2*rows*n^2
    with P read as the dense operand the kernel takes; reads x and P, writes
    out.  P2c ((BT, C, N, heads, ch)): per frame the four relayout products
    (q, kv, o_col: 4C rows of 2*N^2) and both passes' chunk products
    (8*C*ch*N); reads q, kv, P and the tables, writes out.  P3 ((bt, H, W,
    C, F)): the stage product 2*(H/2)(W/2)*4C*F an image; reads y0, the
    statistics and k, writes out, mu and var.  P4 gram ((rows, cols)):
    2*rows^2*cols; reads a, writes the float32 Gram.  P4 view_copy ((n,
    accumulate)): one multiply a value; reads src (and dst when it adds),
    writes dst.  P4 chunk_gram ((numel, R, accumulate)): 4*R*numel for
    chunks of R rows; reads x (and out when it adds), writes out."""
    if key == "P1a":
        rows, total = shape
        return 0, 3 * e * rows * total
    if key == "P1b":
        bt, c, h, w, heads = shape
        n = h * w
        return 4 * bt * n * (h + w) * c, 4 * e * bt * c * n + 4 * heads * (h + w) * n + 8 * c
    if key == "P2a":
        d, ch = shape
        return 4 * d * ch * ch, 3 * e * d * ch + 4 * (ch * ch + d * ch)
    if key == "P2b":
        rows, n = shape
        return 2 * rows * n * n, e * (2 * rows * n + n * n)
    if key == "P2c":
        bt, c, n, heads, ch = shape
        return (bt * (8 * c * n * n + 8 * c * ch * n),
                e * (4 * bt * c * n + n * n) + 4 * (2 * heads * ch * ch + 2 * ch * ch + 2 * heads))
    if key == "P3":
        bt, h, w, c, f = shape
        pix = bt * (h // 2) * (w // 2)
        return 2 * pix * 4 * c * f, e * (bt * h * w * c + pix * f + 4 * c * f) + 8 * bt * (c + f)
    if key == "P4 gram":
        rows, cols = shape
        return 2 * rows * rows * cols, e * rows * cols + 4 * rows * rows
    if key == "P4 view_copy":
        n, accumulate = shape
        return n, e * n * (3 if accumulate else 2)
    if key == "P4 chunk_gram":
        numel, r, accumulate = shape
        return 4 * r * numel, e * numel * (3 if accumulate else 2)
    raise KeyError(key)


# The line kernels on the new paths (phases 16 and 17) against their plain
# versions: float32 against the plain version in float64 on the same inputs
# (so that the bound is the kernel's own float32 error, not the sum of two),
# within 2e-5 of each output's or gradient's largest magnitude; bfloat16
# against the plain version in bfloat16 (the same rounding points), within
# 1e-2: single-ulp flips where reassociated float32 sums straddle a rounding
# edge.  The k-LayerNorm bias's gradient is zero up to rounding and is held
# against a hundredth of the largest gradient of the call, as above.
LINE_RTOL = {"float32": 2e-5, "bfloat16": 1e-2}
# Whole float32 windows of the new paths, card (kernels) vs CPU (plain
# versions): 1e-4 of max|out| (the AViT-big window of phase 13 reads ~4.5e-6).
NEW_WINDOW_RTOL = 1e-4
FLOW_HEIGHT, FLOW_WIDTH = 512, 2048  # flowboiling_chf frames (scripts/bench_matrix.py:44)
FLOW_TRAIN_BATCH = 4
# Two steps: each batch of 8 at 512x2048 takes 7.3 s to draw on the host,
# and the run's time limit is shared.
FLOW_TRAIN_STEPS = 2
FUSED_TRAIN_STEPS = 4
DEMO_SIZE, DEMO_BATCH, DEMO_STEPS, DEMO_WINDOWS = 64, 8, 4, 5  # the make-demo run, cut


def line_kernel_phase(key: str, cases: dict, dev, results: dict) -> None:
    """K2 (``key="K2 long"``) or K4 (``key="K4"``) forward and backward at
    each ``cases`` shape ``(BT, H, W, 3C)`` (6 heads), float32 and
    bfloat16 (bfloat16 alone for ``LINE_BF16_ONLY``), against the plain versions (``LINE_RTOL``); times of the
    kernels and of the plain versions in the kernel's dtype."""
    import torch
    from bubbleformer_tpu_torch.ops.axial_fused_block import (
        fused_block_attention,
        fused_block_attention_bwd,
        fused_block_bwd_plain,
        fused_block_plain,
    )
    from bubbleformer_tpu_torch.ops.axial_lane import (
        axial_attention_bwd_plain,
        axial_attention_plain,
        lane_axial_attention,
        lane_axial_attention_bwd,
    )

    fwd, bwd, plain, bwd_plain = (
        (fused_block_attention, fused_block_attention_bwd, fused_block_plain,
         fused_block_bwd_plain) if key == "K4" else
        (lane_axial_attention, lane_axial_attention_bwd, axial_attention_plain,
         axial_attention_bwd_plain))
    heads = 6
    for i, (where, shape) in enumerate(cases.items()):
        bt, h, w, c3 = shape
        d = c3 // 3 // heads
        rng = np.random.default_rng(SEED + 20 + i)

        def n(*s, scale=1.0, offset=0.0):
            return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

        base = dict(qkv=n(*shape), qn_scale=n(d, scale=0.1, offset=1.0), qn_bias=n(d, scale=0.1),
                    kn_scale=n(d, scale=0.1, offset=1.0), kn_bias=n(d, scale=0.1),
                    bias_x=n(heads, w, w), bias_y=n(heads, h, h),
                    scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
                    scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)))
        base = {k: v.to(dev) for k, v in base.items()}
        do32 = n(bt, h, w, c3 // 3).to(dev)
        for dt in ((torch.bfloat16,) if where in LINE_BF16_ONLY else
                   (torch.float32, torch.bfloat16)):
            name = str(dt).split(".")[-1]
            args = dict(base, qkv=base["qkv"].to(dt))
            do = do32.to(dt)
            ref_args, ref_do = ((args, do) if dt == torch.bfloat16 else
                                ({k: v.double() for k, v in args.items()}, do.double()))
            got = fwd(**args, heads=heads)
            ref = plain(**ref_args, heads=heads)
            torch.cuda.synchronize()
            err_f = compare(f"{key} {name} {where} {shape}", got, ref, LINE_RTOL[name])
            del got, ref
            got = bwd(do, *args.values(), heads=heads)
            ref = bwd_plain(ref_do, **ref_args, heads=heads)
            torch.cuda.synchronize()
            err_b = compare_grads(f"{key} bwd {name} {where}", tuple(args), got, ref,
                                  LINE_RTOL[name])
            check_repeat(f"{key} bwd {name} {where}", tuple(args), got,
                         bwd(do, *args.values(), heads=heads), 1)
            del got, ref, ref_args, ref_do
            ms_f = cuda_ms(lambda: fwd(**args, heads=heads))
            plain_f = ref_ms(lambda: plain(**args, heads=heads))
            ms_b = cuda_ms(lambda: bwd(do, *args.values(), heads=heads))
            plain_b = ref_ms(lambda: bwd_plain(do, **args, heads=heads))
            print(f"  {key} {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), "
                  f"backward {ms_b:.4f} ms (plain {plain_b:.4f})", flush=True)
            results[(key, name, where)] = (err_f, ms_f, plain_f)
            results[(key + " bwd", name, where)] = (err_b, ms_b, plain_b)
            if key == "K2 long" and where in ("training", "d16", "d16_flow"):
                lib = lane_sdpa_ms(args["qkv"], args["bias_x"], args["bias_y"], heads)
                results[(key + " sdpa", name, where)] = lib[0]
                results[(key + " bwd sdpa", name, where)] = lib[1]
                print(f"  {key} {name} {where}: sdpa over both directions (partial yardstick) "
                      f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms", flush=True)
        del base, do32


def dots_step(per_window: dict) -> dict:
    """A path's forward launches per training step under remat "dots", from
    its launches per window (``DOTS_RERUN``)."""
    return {name: n * DOTS_RERUN.get(name, 1) for name, n in per_window.items()}


def all_counters():
    """Every kernel wrapper's launch counter, by the wrapper's name."""
    from bubbleformer_tpu_torch.ops.axial_block_mega import (
        mega_axial_block,
        mega_axial_block_bwd,
        mega_hopper_bwd,
        mega_hopper_fwd,
        mega_line_bwd,
        mega_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.axial_fused import (
        fused_axial_attention,
        fused_axial_attention_bwd,
        fused_hopper_bwd,
        fused_hopper_fwd,
        fused_line_bwd,
        fused_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.axial_fused_block import (
        fused_block_attention,
        fused_block_attention_bwd,
        fused_block_hopper_bwd,
        fused_block_hopper_fwd,
        fused_block_line_bwd,
        fused_block_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.axial_fused_packed import (
        fused_axial_attention_packed,
        fused_axial_attention_packed_bwd,
        fused_packed_hopper_bwd,
        fused_packed_hopper_fwd,
        fused_packed_line_bwd,
        fused_packed_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.axial_lane import (
        lane_axial_attention,
        lane_axial_attention_bwd,
        lane_hopper_bwd,
        lane_hopper_fwd,
        lane_line_bwd,
        lane_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.axial_lane_px import (
        lane_px_attention,
        lane_px_attention_bwd,
        px_hopper_bwd,
        px_hopper_fwd,
        px_line_bwd,
        px_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.temporal_block_mega import (
        core_temporal_attention,
        core_temporal_attention_bwd,
        mega_temporal_block,
        mega_temporal_block_bwd,
    )

    from bubbleformer_tpu_torch.ops.axial_pallas import (
        flash_hopper_bwd,
        flash_hopper_fwd,
        flash_line_bwd,
        flash_line_fwd,
        flash_packed_attention,
        flash_packed_attention_bwd,
    )
    from bubbleformer_tpu_torch.ops.lp_loss import plane_norms, plane_norms_bwd

    return (*probe_counters(), mega_temporal_block, mega_temporal_block_bwd, lane_axial_attention,
            lane_axial_attention_bwd, core_temporal_attention, core_temporal_attention_bwd,
            fused_block_attention, fused_block_attention_bwd, mega_axial_block,
            mega_axial_block_bwd, fused_axial_attention_packed, fused_axial_attention_packed_bwd,
            fused_axial_attention, fused_axial_attention_bwd, flash_packed_attention,
            flash_packed_attention_bwd, plane_norms, plane_norms_bwd, lane_px_attention,
            lane_px_attention_bwd, lane_hopper_fwd, lane_hopper_bwd, lane_line_fwd, lane_line_bwd,
            mega_hopper_fwd, mega_hopper_bwd, mega_line_fwd, mega_line_bwd, px_hopper_fwd,
            px_hopper_bwd, px_line_fwd, px_line_bwd, fused_block_hopper_fwd,
            fused_block_hopper_bwd, fused_block_line_fwd, fused_block_line_bwd,
            flash_hopper_fwd, flash_hopper_bwd, flash_line_fwd, flash_line_bwd,
            fused_packed_hopper_fwd, fused_packed_hopper_bwd, fused_packed_line_fwd,
            fused_packed_line_bwd, fused_hopper_fwd, fused_hopper_bwd, fused_line_fwd,
            fused_line_bwd)


def probe_counters():
    """The probes' kernel wrappers (P1-P4), whose counters count launches
    like the others'."""
    from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid

    return (lane_axial.within_roll, lane_axial.lane_core, lane_axial.lane_core_hopper,
            lane_axial.lane_core_line, chunk_axial.dot_combos, chunk_axial.perm_product,
            chunk_axial.chunk_core, pyramid.stage, mosaic.gram, mosaic.view_copy,
            mosaic.chunk_gram_apply, mosaic.chunk_gram_hopper, mosaic.chunk_gram_line)


def zero_counters() -> None:
    for fn in all_counters():
        fn.launches = 0


def read_counters() -> dict:
    return {fn.__name__: fn.launches for fn in all_counters()}


# The wrappers whose calls on the card go to one chain a dtype (K2:
# ``ops/axial_lane.py:lane_kernels``, K4: ``ops/axial_fused_block.py:
# fused_block_kernels``, K5: ``ops/axial_block_mega.py:mega_kernels``, K6:
# ``ops/axial_fused_packed.py:fused_packed_kernels``, K7: ``ops/
# axial_fused.py:fused_kernels``, K8: ``ops/axial_pallas.py:flash_kernels``,
# K9: ``ops/axial_lane_px.py:px_kernels``): bfloat16 the Hopper kernels,
# float32 the first chain (K7's and K8's bfloat16 backward too on lines the
# Hopper backward does not stage: none on these paths).
DTYPE_PATHS = {"lane_axial_attention": ("lane_hopper_fwd", "lane_line_fwd"),
               "lane_axial_attention_bwd": ("lane_hopper_bwd", "lane_line_bwd"),
               "fused_block_attention": ("fused_block_hopper_fwd", "fused_block_line_fwd"),
               "fused_block_attention_bwd": ("fused_block_hopper_bwd", "fused_block_line_bwd"),
               "fused_axial_attention_packed": ("fused_packed_hopper_fwd",
                                                "fused_packed_line_fwd"),
               "fused_axial_attention_packed_bwd": ("fused_packed_hopper_bwd",
                                                    "fused_packed_line_bwd"),
               "fused_axial_attention": ("fused_hopper_fwd", "fused_line_fwd"),
               "fused_axial_attention_bwd": ("fused_hopper_bwd", "fused_line_bwd"),
               "flash_packed_attention": ("flash_hopper_fwd", "flash_line_fwd"),
               "flash_packed_attention_bwd": ("flash_hopper_bwd", "flash_line_bwd"),
               "mega_axial_block": ("mega_hopper_fwd", "mega_line_fwd"),
               "mega_axial_block_bwd": ("mega_hopper_bwd", "mega_line_bwd"),
               "lane_px_attention": ("px_hopper_fwd", "px_line_fwd"),
               "lane_px_attention_bwd": ("px_hopper_bwd", "px_line_bwd")}


def with_dtype_paths(per: dict, dtype: str) -> dict:
    """``per`` with K2's, K4's to K9's per-path counters: every call of their
    wrappers in ``dtype`` goes to that dtype's kernels (``DTYPE_PATHS``), the
    other path's never."""
    at = 0 if dtype == "bfloat16" else 1
    return dict(per, **{paths[at]: per[name] for name, paths in DTYPE_PATHS.items()
                        if name in per})


def check_launches(what: str, got: dict, per: dict, times: int) -> None:
    """Each kernel in ``per`` launched ``per[name] * times`` times, every
    other one never."""
    want = {name: per.get(name, 0) * times for name in got}
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")


def window_phase(label: str, model_cfg, data_cfg, weights, x, dev, per_window: dict,
                 cond=None):
    """One float32 window of a model on the card (kernels) against the same
    model on the CPU (plain versions), conditioned on ``cond`` where it is
    given; returns the card's output."""
    import torch
    from bubbleformer_tpu_torch.models import build_model

    cpu = build_model(model_cfg, data_cfg).eval()
    cpu.load_state_dict(weights)
    gpu = build_model(model_cfg, data_cfg).eval().to(dev)
    gpu.load_state_dict(weights)
    zero_counters()
    with torch.no_grad():
        extra = () if cond is None else (cond,)
        t0 = time.perf_counter()
        y_gpu = gpu(x.to(dev), *(a.to(dev) for a in extra))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        launches = read_counters()
        t0 = time.perf_counter()
        y_cpu = cpu(x, *extra)
        t_cpu = time.perf_counter() - t0
    check_launches(f"{label} window", launches, with_dtype_paths(per_window, "float32"), 1)
    if tuple(y_gpu.shape) != tuple(x.shape):
        fail(f"{label} window output shape {tuple(y_gpu.shape)}")
    print(f"  card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s; launches {launches}")
    compare(f"{label} window f32 card vs CPU", y_gpu.cpu(), y_cpu, NEW_WINDOW_RTOL)
    return y_gpu


def rollout_phase(label: str, model, init, windows: int, per_window: dict, card: str,
                  reference=None, cond=None, on_preds=None) -> float:
    """A bfloat16 rollout of ``windows`` windows after one warm-up window
    (conditioned on ``cond`` where it is given): finite, the right shape and
    launches; ``on_preds`` is then called with the predictions.  Returns
    frames/s."""
    import torch
    from bubbleformer_tpu_torch.inference import make_rollout_fn

    extra, conditioned = (() if cond is None else (cond,)), cond is not None
    warm = make_rollout_fn(model, 1, conditioned)(init, *extra)
    torch.cuda.synchronize()
    if reference is not None:
        rel_l2 = ((warm[0].float() - reference).norm() / reference.norm()).item()
        print(f"  warm-up window: bf16 vs f32 relative L2 {rel_l2:.4f}")
        if rel_l2 > 0.25:
            fail(f"{label}: bf16 window is {rel_l2:.3f} (relative L2) from the f32 window")
    rollout = make_rollout_fn(model, windows, conditioned)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = rollout(init, *extra)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    if tuple(preds.shape) != (windows, *init.shape):
        fail(f"{label} rollout shape {tuple(preds.shape)}")
    if not torch.isfinite(preds).all():
        fail(f"{label} rollout produced non-finite values")
    check_launches(f"{label} rollout", launches, with_dtype_paths(per_window, "bfloat16"), windows)
    frames = windows * init.shape[1] * init.shape[0]
    print(f"  {frames} frames in {seconds:.3f} s: {frames / seconds:.2f} frames/s, "
          f"{1000 * seconds / windows:.2f} ms/window ({card}); launches {launches}", flush=True)
    if on_preds is not None:
        on_preds(preds)
    return frames / seconds


@functools.lru_cache(maxsize=12)
def _drawn_batch(batch: int, t: int, fields: int, height: int, width: int, seed: int):
    from bubbleformer_tpu_torch.data import synthetic_batch

    return synthetic_batch(batch, t, fields, height, width, 9, seed=seed)


def cached_batch(batch: int, t: int, fields: int, height: int, width: int, fluid, seed: int):
    """``synthetic_batch(...)``, its arrays drawn once a run: phases that ask
    for the same batch share it (host set-up, 1.9 s for a batch of 8 at
    512^2 and 7.3 s at 512x2048, which phases 10-49 asked for ~60 times).
    Without fluid parameters, or with 9, the same inputs and targets (the
    draws come first); the arrays are read, never written."""
    from bubbleformer_tpu_torch.data import synthetic_batch

    if fluid not in (None, 9):
        return synthetic_batch(batch, t, fields, height, width, fluid, seed=seed)
    drawn = _drawn_batch(batch, t, fields, height, width, seed)
    return drawn if fluid == 9 else drawn[:2]


def cached_loader(steps: int, batch: int, t: int, fields: int, height: int, width: int, fluid,
                  seed: int):
    """A ``SyntheticLoader`` of ``cached_batch``es: batch ``i`` from seed
    ``seed + i``, as the loader draws them."""
    from bubbleformer_tpu_torch.data import SyntheticLoader

    loader = SyntheticLoader(0, batch, t, fields, height, fluid, width=width)
    loader.batches = [cached_batch(batch, t, fields, height, width, fluid, seed + i)
                      for i in range(steps)]
    return loader


def fit_phase(label: str, train_cfgs, batch: int, steps: int, frame, per_step: dict,
              log_dir: Path, dev, card: str, fluid=None, on_module=None, trainer_kw=None,
              val_launches=None) -> dict:
    """``Trainer.fit`` in bfloat16 on ``steps`` synthetic batches of
    ``frame`` = (H, W) pixels (with ``fluid`` fluid parameters, which an
    unconditioned model ignores) after one warm-up step: every loss finite,
    the launches ``per_step``, every parameter with a gradient moved; then
    ``on_module(module, log_dir)`` where it is given.  ``trainer_kw`` goes to
    the ``Trainer``; with ``val_launches`` (a validation batch's launches)
    the run also validates on one synthetic batch.  The peak memory covers
    the steady steps (its statistics reset after the warm-up step).  Returns
    ms/step, samples/s, peak GB and the launches."""
    import torch
    from bubbleformer_tpu_torch.training import Trainer, module_class

    shutil.rmtree(log_dir, ignore_errors=True)
    model_cfg, data_cfg = train_cfgs[:2]
    module = module_class(model_cfg, data_cfg)(*train_cfgs, total_steps=steps + 1,
                                               compute_dtype="bfloat16", device=dev.type,
                                               seed=SEED)
    trainer = Trainer(module, log_dir=str(log_dir), limit_train_batches=steps, seed=SEED,
                      log_every=1, **(trainer_kw or {}))
    t, fields = data_cfg["time_window"], len(data_cfg["input_fields"])
    warm = cached_batch(batch, t, fields, *frame, fluid, SEED + 30)
    module.train_step(tuple(torch.from_numpy(a).to(dev) for a in warm),
                      torch.Generator(device=dev).manual_seed(SEED))
    before = {n: p.detach().clone() for n, p in module.model.named_parameters()}
    zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    val = None if val_launches is None else cached_loader(1, batch, t, fields, *frame, fluid,
                                                           SEED + 41)
    trainer.fit(cached_loader(steps, batch, t, fields, *frame, fluid, SEED + 31), val,
                max_epochs=1)
    torch.cuda.synchronize()
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds = trainer.last_epoch_seconds
    with open(log_dir / "metrics.csv") as f:
        rows = [row.split(",") for row in f.read().splitlines()[1:]]
    losses = [float(r[3]) for r in rows if r[2] == "train"]
    print(f"  losses {losses}" + ("" if val is None else
                                  f", validation {[float(r[3]) for r in rows if r[2] == 'val']}"))
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"{label}: expected {steps} finite losses, got {losses}")
    val_launches = val_launches or {}
    want = {k: per_step.get(k, 0) * steps + val_launches.get(k, 0)
            for k in set(per_step) | set(val_launches)}
    check_launches(f"{label} Trainer.fit", launches, with_dtype_paths(want, "bfloat16"), 1)
    unmoved = [(n, p) for n, p in module.model.named_parameters() if torch.equal(before[n], p)]
    stuck = [n for n, p in unmoved if p.grad is not None and bool(p.grad.any())]
    if stuck:
        fail(f"{label}: {len(stuck)} parameters with a gradient did not move: {stuck[:5]}")
    out = {"ms_per_step": 1000 * seconds / steps, "samples_per_s": batch * steps / seconds,
           "peak_gb": peak_gb, "launches": launches, "steps": steps}
    print(f"  {steps} steps at batch {batch} in {seconds:.3f} s: {out['ms_per_step']:.1f} ms/step, "
          f"{out['samples_per_s']:.2f} samples/s; peak memory {peak_gb:.2f} GB; "
          f"{len(before) - len(unmoved)}/{len(before)} parameters moved ({card}); "
          f"launches {launches}", flush=True)
    if on_module is not None:
        on_module(module, log_dir)
    del module, trainer
    shutil.rmtree(log_dir, ignore_errors=True)
    return out


def new_path_phases(repo: Path, dev, card: str, results: dict) -> dict:
    """Phases 16-22: the line kernels at the new paths' shapes, the
    flow-boiling path (A: AViT-small at 512x2048, K3 and K2 with rows of
    128 tokens) and the fused_block path (B: AViT-small at 512^2 with
    ``attn_impl=fused_block``, and AViT-tiny on the make-demo grid through
    ``auto``).  Returns the training runs' numbers by path."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.models import build_model

    t = TIME_WINDOW
    print("== phase 16: K2 on long lines and at head dim 16 vs plain, forward and backward",
          flush=True)
    line_kernel_phase("K2 long", LINE_SHAPES["K2 long"], dev, results)
    print("== phase 17: K4 fused_block_attention vs plain, forward and backward", flush=True)
    line_kernel_phase("K4", LINE_SHAPES["K4"], dev, results)

    runs = {}
    flow_cfg = load_config(["model_cfg=avit_small", "data_cfg=flowboiling_chf",
                            "scheduler_cfg.params.warmup_iters=2"])
    flow_train = (flow_cfg["model_cfg"], flow_cfg["data_cfg"], flow_cfg["optim_cfg"],
                  flow_cfg["scheduler_cfg"])
    if (flow_cfg["model_cfg"]["params"]["embed_dim"], flow_cfg["optim_cfg"]["name"]) != (384,
                                                                                         "lion"):
        fail("model_cfg/avit_small.yaml with the default optimizer is not AViT-small with Lion")
    data_cfg = flow_cfg["data_cfg"]
    blocks = flow_cfg["model_cfg"]["params"]["processor_blocks"]
    model = build_model(flow_cfg["model_cfg"], data_cfg)
    weights = random_state_dict(model, SEED + 40)
    del model
    x = torch.from_numpy(np.random.default_rng(SEED + 41).standard_normal(
        (1, t, FIELDS, FLOW_HEIGHT, FLOW_WIDTH)).astype(np.float32))
    fwd_a = {"core_temporal_attention": blocks, "lane_axial_attention": blocks}
    print(f"== phase 18: one float32 window, card vs CPU, AViT-small at "
          f"{FLOW_HEIGHT}x{FLOW_WIDTH}", flush=True)
    y_flow = window_phase("AViT-small 512x2048", flow_cfg["model_cfg"], data_cfg, weights, x,
                          dev, fwd_a)
    print(f"== phase 19: {WINDOWS}-window bfloat16 rollout, AViT-small at "
          f"{FLOW_HEIGHT}x{FLOW_WIDTH}", flush=True)
    bf = build_model(flow_cfg["model_cfg"], data_cfg, compute_dtype="bfloat16").eval().to(dev)
    bf.load_state_dict(weights)
    runs["A rollout"] = rollout_phase("AViT-small 512x2048", bf, x.to(dev), WINDOWS, fwd_a, card,
                                      reference=y_flow)
    del bf, y_flow
    print(f"== phase 20: Trainer.fit AViT-small at {FLOW_HEIGHT}x{FLOW_WIDTH}, bfloat16, batch "
          f"{FLOW_TRAIN_BATCH}, Lion, {FLOW_TRAIN_STEPS} steps after 1 warm-up step", flush=True)
    per_step_a = dict(fwd_a, core_temporal_attention_bwd=blocks, lane_axial_attention_bwd=blocks)
    runs["A"] = fit_phase("AViT-small 512x2048", flow_train, FLOW_TRAIN_BATCH, FLOW_TRAIN_STEPS,
                          (FLOW_HEIGHT, FLOW_WIDTH), per_step_a, repo / "build" / "smoke_flow",
                          dev, card)

    fb_cfg = load_config(["model_cfg=avit_small", "model_cfg.params.attn_impl=fused_block",
                          "scheduler_cfg.params.warmup_iters=2"])
    fb_train = (fb_cfg["model_cfg"], fb_cfg["data_cfg"], fb_cfg["optim_cfg"],
                fb_cfg["scheduler_cfg"])
    model = build_model(fb_cfg["model_cfg"], fb_cfg["data_cfg"])
    weights = random_state_dict(model, SEED + 42)
    del model
    x = torch.from_numpy(np.random.default_rng(SEED + 43).standard_normal(
        (1, t, FIELDS, IMAGE, IMAGE)).astype(np.float32))
    print(f"== phase 21: AViT-small at {IMAGE}^2 with attn_impl=fused_block: one float32 "
          f"window card vs CPU, Trainer.fit bfloat16 batch {TRAIN_BATCH}", flush=True)
    window_phase("AViT-small fused_block", fb_cfg["model_cfg"], fb_cfg["data_cfg"], weights, x,
                 dev, {"fused_block_attention": blocks})
    runs["B"] = fit_phase("AViT-small fused_block", fb_train, TRAIN_BATCH, FUSED_TRAIN_STEPS,
                          (IMAGE, IMAGE), {"fused_block_attention": blocks,
                                           "fused_block_attention_bwd": blocks},
                          repo / "build" / "smoke_fused_block", dev, card)

    demo_cfg = load_config(["model_cfg=avit_tiny", "optim_cfg=adamw", "data_cfg=samples_smoke",
                            "scheduler_cfg.params.warmup_iters=2"])
    demo_train = (demo_cfg["model_cfg"], demo_cfg["data_cfg"], demo_cfg["optim_cfg"],
                  demo_cfg["scheduler_cfg"])
    tiny_blocks = demo_cfg["model_cfg"]["params"]["processor_blocks"]
    print(f"== phase 22: the make-demo grid, AViT-tiny at {DEMO_SIZE}^2 through auto (temporal "
          f"unrolled, axial fused_block at head dim 16): Trainer.fit bfloat16 batch {DEMO_BATCH}, "
          f"AdamW, and a {DEMO_WINDOWS}-window rollout", flush=True)
    per_demo = {"fused_block_attention": tiny_blocks, "fused_block_attention_bwd": tiny_blocks}
    runs["demo"] = fit_phase("AViT-tiny demo", demo_train, DEMO_BATCH, DEMO_STEPS,
                             (DEMO_SIZE, DEMO_SIZE), per_demo, repo / "build" / "smoke_demo", dev,
                             card)
    tiny = build_model(demo_cfg["model_cfg"], demo_cfg["data_cfg"],
                       compute_dtype="bfloat16").eval().to(dev)
    tiny.load_state_dict(random_state_dict(tiny, SEED + 44))
    x = torch.from_numpy(np.random.default_rng(SEED + 45).standard_normal(
        (1, t, len(demo_cfg["data_cfg"]["input_fields"]), DEMO_SIZE, DEMO_SIZE))
        .astype(np.float32)).to(dev)
    runs["demo rollout"] = rollout_phase("AViT-tiny demo", tiny, x, DEMO_WINDOWS,
                                         {"fused_block_attention": tiny_blocks}, card)
    return runs


# The line kernels' cases: K2 on path A (the 32x128 flow-boiling grid at the
# rollout's batch 1 and the training step's batch 4), lines of 512 both ways
# and head dim 16 (a 64x64 grid, and path E's AViT-tiny training step at
# 512x2048, 64x256 tokens at batch 4); K4 on path B (FiLMAViT-small's grid at batch 1 and 8,
# 384^2 px at patch 16, the make-demo grid at head dim 16, batch 2).
# Cases held in bfloat16 alone: none.  Path E's training step at 512x2048
# (``d16_flow``) is bfloat16, and is held in float32 too: there the k-LN bias
# gradient (zero up to rounding, ``ZERO_GRADS``) sums over 20 x 64 x 256
# tokens and 6 heads; while the line kernels added it with float32 atomics
# it came out 2.3e-5 of the floor against the float64 reference, above
# LINE_RTOL's 2e-5, and summed in a fixed order it reads below it (NVIDIA
# H100 80GB HBM3, 700.00 W; ROADMAP Queue 3).
LINE_BF16_ONLY = ()
LINE_SHAPES = {
    "K2 long": {"rollout": (TIME_WINDOW, 32, 128, 1152),
                "training": (FLOW_TRAIN_BATCH * TIME_WINDOW, 32, 128, 1152),
                "rows_512": (1, 16, 512, 1152), "cols_512": (1, 512, 16, 1152),
                "d16": (TIME_WINDOW, 64, 64, 288),
                "d16_flow": (FLOW_TRAIN_BATCH * TIME_WINDOW, 64, 256, 288)},
    "K4": {"rollout": (TIME_WINDOW, 32, 32, 1152), "training": (8 * TIME_WINDOW, 32, 32, 1152),
           "grid_24": (TIME_WINDOW, 24, 24, 1152), "demo_d16": (2 * TIME_WINDOW, 8, 8, 288)},
}


# Phases 23-25: K1 and K3 at head dim 16 (AViT-tiny: 6 heads of 16; K1 at
# its 512^2 training shape, K3 at its 512x2048 flow-boiling shapes, batch 1
# and 4), K5 on path C (FiLMAViT-small at batch 1 and 8) and at AViT-tiny's
# 512^2 training shape with ``mega``, K6 and K7 on path D (AViT-small's).
BRANCH_SHAPES = {
    "K1 d16": {"training": (TRAIN_BATCH, TIME_WINDOW, 64, 64, 96)},
    "K3 d16": {"rollout": (1, TIME_WINDOW, 64, 256, 96),
               "training": (4, TIME_WINDOW, 64, 256, 96)},
    "K5": {"rollout": (TIME_WINDOW, 32, 32, 384), "training": (8 * TIME_WINDOW, 32, 32, 384),
           "d16": (8 * TIME_WINDOW, 64, 64, 96)},
}
# K6 and K7 (6 heads): path D's training shape, the rollout's batch,
# AViT-tiny's 64x64 grid at head dim 16, the 32x128 flow grid at batch 4 and
# rows of 512 tokens at head dim 64 (as phase 16's; K7's bf16 backward there
# on the line kernels).
SPLIT_SHAPES = {"training": (8 * TIME_WINDOW, 32, 32, 384), "rollout": (TIME_WINDOW, 32, 32, 384),
                "d16": (8 * TIME_WINDOW, 64, 64, 96),
                "flow": (FLOW_TRAIN_BATCH * TIME_WINDOW, 32, 128, 384),
                "rows_512": (2, 8, 512, 384)}


def branch_args(key: str, shape, heads: int, rng):
    """Seeded float32 arguments of K1 (``"K1..."``, x of (B, T, H, W, C)), K3
    (``"K3..."``, xn) or K5 (``"K5"``, x of (BT, H, W, C)), in the order of
    their PARAM_NAMES, the activation first."""
    import torch

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

    c = shape[-1]
    d = c // heads
    w_qkv = dict(wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.1))
    ln = dict(qn_scale=n(d, scale=0.1, offset=1.0), qn_bias=n(d, scale=0.1),
              kn_scale=n(d, scale=0.1, offset=1.0), kn_bias=n(d, scale=0.1))

    def scale():
        return torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32))

    if key.startswith("K3"):
        return dict(xn=n(*shape), **w_qkv, **ln, bias=n(heads, shape[1], shape[1]),
                    scale_factor=scale())
    args = dict(x=n(*shape), in1_scale=n(c, scale=0.1, offset=1.0), in1_bias=n(c, scale=0.1),
                **w_qkv, **ln, in2_scale=n(c, scale=0.1, offset=1.0), in2_bias=n(c, scale=0.1),
                wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.1))
    if key.startswith("K1"):
        return dict(args, bias=n(heads, shape[1], shape[1]), scale_factor=scale())
    return dict(args, bias_x=n(heads, shape[2], shape[2]), bias_y=n(heads, shape[1], shape[1]),
                scale_x=scale(), scale_y=scale())


def branch_kernel_phase(key: str, dev, results: dict) -> None:
    """K1 or K3 at head dim 16, or K5: forward and every gradient at each
    ``BRANCH_SHAPES[key]`` shape, float32 and bfloat16, against the plain
    versions on the card (``KERNEL_RTOL``), with the times of the kernels
    and of the plain versions (and, for K5, of cuBLAS's two projections
    alone)."""
    import torch
    from bubbleformer_tpu_torch.ops import axial_block_mega as k5
    from bubbleformer_tpu_torch.ops import temporal_block_mega as k13

    fwd, bwd, plain, bwd_plain = {
        "K1": (k13.mega_temporal_block_fwd, k13.mega_temporal_block_bwd,
               k13.temporal_branch_plain, k13.temporal_branch_bwd_plain),
        "K3": (k13.core_temporal_attention_fwd, k13.core_temporal_attention_bwd,
               k13.core_temporal_plain, k13.core_temporal_bwd_plain),
        "K5": (k5.mega_axial_block_fwd, k5.mega_axial_block_bwd, k5.mega_axial_plain,
               k5.mega_axial_bwd_plain),
    }[key[:2]]
    for i, (where, shape) in enumerate(BRANCH_SHAPES[key].items()):
        heads = 6
        base = {k: v.to(dev) for k, v in branch_args(key, shape, heads,
                                                      np.random.default_rng(SEED + 60 + i)).items()}
        do32 = torch.from_numpy(np.random.default_rng(SEED + 70 + i).standard_normal(shape)
                                .astype(np.float32)).to(dev)
        first = next(iter(base))
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            args = dict(base, **{first: base[first].to(dt)})
            params = list(args.values())[1:]
            act, do = args[first], do32.to(dt)
            got = fwd(act, *params, heads=heads)
            # K1's and K5's residuals for their backward; K3 keeps none.
            got, res = got if isinstance(got, tuple) else (got, None)
            kept = {} if res is None else {"residuals": res}
            ref = plain(**args, heads=heads)
            torch.cuda.synchronize()
            err_f = compare(f"{key} {name} {where} {shape}", got, ref, KERNEL_RTOL[name])
            del got, ref
            got = bwd(do, act, *params, heads=heads, **kept)
            ref = bwd_plain(do, **args, heads=heads)
            torch.cuda.synchronize()
            err_b = compare_grads(f"{key} bwd {name} {where}", tuple(args), got, ref,
                                  KERNEL_RTOL[name], zero_noise=key == "K5" and name == "bfloat16")
            del got, ref
            ms_f = cuda_ms(lambda: fwd(act, *params, heads=heads))
            plain_f = ref_ms(lambda: plain(**args, heads=heads))
            ms_b = cuda_ms(lambda: bwd(do, act, *params, heads=heads, **kept))
            plain_b = ref_ms(lambda: bwd_plain(do, **args, heads=heads))
            extra = ""
            if key.startswith("K1"):
                w1, w2 = args["wqkv"].to(dt), args["wout"].to(dt)
                gemm_f = k1_gemm_ms(act, w1, w2)
                gemm_b = k1_gemm_ms(act, w1, w2, do, res[1])
                results[(key + " gemm", name, where)] = gemm_f
                results[(key + " bwd gemm", name, where)] = gemm_b
                extra = (f"; cuBLAS's products alone (partial yardstick) forward {gemm_f:.4f}, "
                         f"backward {gemm_b:.4f} ms")
            if key.startswith("K3"):
                w1 = args["wqkv"].to(dt)
                gemm_f = k3_gemm_ms(act, w1)
                stand_in = torch.matmul(act.reshape(-1, shape[-1]), w1.t())  # a (R, 3C) dqkv
                gemm_b = k3_gemm_ms(act, w1, stand_in)
                del stand_in
                results[(key + " gemm", name, where)] = gemm_f
                results[(key + " bwd gemm", name, where)] = gemm_b
                extra = (f"; cuBLAS's products alone (partial yardstick) forward {gemm_f:.4f}, "
                         f"backward {gemm_b:.4f} ms")
            if key == "K5":
                # K1's products: the two projections forward, dy2, dW_out,
                # dxn and dW_qkv backward (the qkv residual standing in for
                # dqkv).
                w1, w2 = args["wqkv"].to(dt), args["wout"].to(dt)
                gemm_f = k1_gemm_ms(act, w1, w2)
                gemm_b = k1_gemm_ms(act, w1, w2, do, res[1])
                results[("K5 gemm", name, where)] = gemm_f
                results[("K5 bwd gemm", name, where)] = gemm_b
                extra = (f"; cuBLAS's products alone (partial yardstick) forward {gemm_f:.4f}, "
                         f"backward {gemm_b:.4f} ms")
            print(f"  {key} {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), "
                  f"backward {ms_b:.4f} ms (plain {plain_b:.4f}){extra}", flush=True)
            results[(key, name, where)] = (err_f, ms_f, plain_f)
            results[(key + " bwd", name, where)] = (err_b, ms_b, plain_b)
            if key[:2] in ("K1", "K3") and dt == torch.bfloat16 and where == "training":
                launch_line(f"{key} bf16 {where}", args, do, heads)
            del res, kept, args, params, act, do
        del base, do32


def split_kernel_phase(dev, results: dict) -> None:
    """K6 and K7 forward and every gradient at each ``SPLIT_SHAPES`` q/k/v
    shape (6 heads), float32 against the plain version in float64 and
    bfloat16 against it in bfloat16 (``LINE_RTOL``), each call's launches
    held to the kernels its dtype and shape choose, with both times and, in
    bfloat16, sdpa over both directions (the partial yardstick); at the
    training shape the bf16 table and scale gradients repeat bit for bit
    over two calls, and the layer's strided ``v`` view (of the Dense's
    ``(BT, H, W, heads, 3, d)`` output) gives the bits of its contiguous
    copy."""
    import torch
    from bubbleformer_tpu_torch.ops import axial_fused as k7
    from bubbleformer_tpu_torch.ops import axial_fused_packed as k6

    kernels = {"K6": (k6.fused_axial_attention_packed, k6.fused_axial_attention_packed_bwd,
                      k6.fused_packed_plain, k6.fused_packed_bwd_plain),
               "K7": (k7.fused_axial_attention, k7.fused_axial_attention_bwd, k7.fused_plain,
                      k7.fused_bwd_plain)}
    # Each kernel's (Hopper forward, Hopper backward, line forward, line
    # backward) counters.
    paths = {"K6": (k6.fused_packed_hopper_fwd, k6.fused_packed_hopper_bwd,
                    k6.fused_packed_line_fwd, k6.fused_packed_line_bwd),
             "K7": (k7.fused_hopper_fwd, k7.fused_hopper_bwd, k7.fused_line_fwd,
                    k7.fused_line_bwd)}
    heads = 6
    for i, (where, shape) in enumerate(SPLIT_SHAPES.items()):
        bt, h, w, c = shape
        rng = np.random.default_rng(SEED + 80 + i)

        def n(*s):
            return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

        qkv5 = (bt, h, w, heads, c // heads)
        base = dict(q=n(*qkv5), k=n(*qkv5), v=n(*qkv5), bias_x=n(heads, w, w),
                    bias_y=n(heads, h, h),
                    scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
                    scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)))
        base = {k: v.to(dev) for k, v in base.items()}
        do32 = n(*qkv5)
        for key, (fwd, bwd, plain, bwd_plain) in kernels.items():
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                args = dict(base, **{k: base[k].to(dt) for k in "qkv"})
                do = do32.to(dt)
                ref_args, ref_do = ((args, do) if dt == torch.bfloat16 else
                                    ({k: v.double() for k, v in args.items()}, do.double()))
                before = [fn.launches for fn in paths[key]]
                got = fwd(**args)
                ref = plain(**ref_args)
                torch.cuda.synchronize()
                err_f = compare(f"{key} {name} {where} {shape}", got, ref, LINE_RTOL[name])
                del got, ref
                got = bwd(do, *args.values())
                # bf16: the Hopper kernels, K7's backward on the line kernels
                # past the Hopper backward's lines (head dim 64, > 256
                # tokens); float32: the line kernels.
                hopper = (dt == torch.bfloat16, dt == torch.bfloat16 and (
                    key == "K6" or c // heads == 16 or max(h, w) <= 256))
                want = [1 if hopper[0] else 0, 1 if hopper[1] else 0, 0 if hopper[0] else 1,
                        0 if hopper[1] else 1]
                moved = [fn.launches - b for fn, b in zip(paths[key], before)]
                if moved != want:
                    fail(f"{key} {name} {where}: launches {moved} of (Hopper fwd, Hopper bwd, "
                         f"line fwd, line bwd), expected {want}")
                ref = bwd_plain(ref_do, **ref_args)
                torch.cuda.synchronize()
                err_b = compare_grads(f"{key} bwd {name} {where}", tuple(args), got, ref,
                                      LINE_RTOL[name])
                del ref, ref_args, ref_do
                if dt == torch.bfloat16 and where == "training":
                    check_repeat(f"{key} bwd {name} {where}", tuple(args), got,
                                 bwd(do, *args.values()), 3)
                    dense = torch.stack([args[k] for k in "qkv"], dim=-2)
                    strided = dict(args, v=dense[..., 2, :])
                    if strided["v"].is_contiguous() or not all(
                            torch.equal(a, b) for a, b in zip(
                                (fwd(**args), *got[:3]),
                                (fwd(**strided), *bwd(do, *strided.values())[:3]))):
                        fail(f"{key} {name}: the strided v view reads other bits than v")
                    print(f"  {key} {name} {where}: the strided v view of a (BT, H, W, heads, "
                          "3, d) tensor gives v's bits, forward and backward", flush=True)
                    del dense, strided
                del got
                ms_f = cuda_ms(lambda: fwd(**args))
                plain_f = ref_ms(lambda: plain(**args))
                ms_b = cuda_ms(lambda: bwd(do, *args.values()))
                plain_b = ref_ms(lambda: bwd_plain(do, **args))
                print(f"  {key} {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), "
                      f"backward {ms_b:.4f} ms (plain {plain_b:.4f})", flush=True)
                results[(key, name, where)] = (err_f, ms_f, plain_f)
                results[(key + " bwd", name, where)] = (err_b, ms_b, plain_b)
        qkv = torch.stack([base[k] for k in "qkv"], dim=-2).to(torch.bfloat16).reshape(
            bt, h, w, 3 * c)
        lib = lane_sdpa_ms(qkv, base["bias_x"], base["bias_y"], heads)
        del qkv
        for key in kernels:
            results[(key + " sdpa", "bfloat16", where)] = lib[0]
            results[(key + " bwd sdpa", "bfloat16", where)] = lib[1]
        print(f"  K6, K7 bfloat16 {where}: sdpa over both directions (partial yardstick) "
              f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms", flush=True)
        del base, do32


def slice5_phases(repo: Path, dev, card: str, results: dict) -> dict:
    """Phases 23-28: the kernels at head dim 16, K5, K6 and K7 against their
    plain versions, and paths C (FiLMAViT-small on ``mega``: K1 and K5), D
    (AViT-small on ``fused_packed`` and ``fused``: K6, K7) and E (AViT-tiny
    through ``auto`` at 512^2 and 512x2048: K1, K3 and the axial kernel at
    head dim 16).  Returns the runs' numbers by path."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.layers.attention import resolve_axial_impl, resolve_temporal_impl
    from bubbleformer_tpu_torch.models import build_model

    t = TIME_WINDOW
    print("== phase 23: K1 and K3 at head dim 16 vs plain, forward and backward", flush=True)
    branch_kernel_phase("K1 d16", dev, results)
    branch_kernel_phase("K3 d16", dev, results)
    print("== phase 24: K5 mega_axial_block vs plain, forward and backward", flush=True)
    branch_kernel_phase("K5", dev, results)
    print("== phase 25: K6 and K7 vs plain, forward and backward", flush=True)
    split_kernel_phase(dev, results)

    def cfgs(*overrides):
        cfg = load_config([*overrides, "scheduler_cfg.params.warmup_iters=2"])
        return cfg, (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])

    def frames(seed, height, width, fields=FIELDS):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, t, fields, height, width)).astype(np.float32))

    runs = {}
    cfg, train = cfgs("model_cfg.params.attn_impl=mega")
    params = cfg["model_cfg"]["params"]
    if (cfg["model_cfg"]["name"], params["embed_dim"], cfg["optim_cfg"]["name"]) != (
            "filmavit", 384, "lion"):
        fail("the default composition is not FiLMAViT-small with Lion")
    blocks = params["processor_blocks"]
    model = build_model(cfg["model_cfg"], cfg["data_cfg"])
    weights = random_state_dict(model, SEED + 50)
    del model
    x, cond = frames(SEED + 51, IMAGE, IMAGE), torch.tensor([FLUID_PARAMS], dtype=torch.float32)
    per_c = {"mega_temporal_block": blocks, "mega_axial_block": blocks}
    print(f"== phase 26: path C, FiLMAViT-small at {IMAGE}^2 with attn_impl=mega: one float32 "
          f"window card vs CPU, a {WINDOWS}-window bfloat16 rollout, Trainer.fit bfloat16 batch "
          f"{TRAIN_BATCH}", flush=True)
    # FiLM near identity for the card-vs-CPU window: at FiLM O(0.1) these
    # weights put the CPU's single-pass float32 InstanceNorms (the plain K1
    # and K5) in cancellation, where the card's shifted statistics are not
    # (phase 9 holds that regime against float64); near identity the two
    # agree as on the other paths.
    y_c = window_phase("FiLMAViT-small mega", cfg["model_cfg"], cfg["data_cfg"],
                       film_near_identity(weights, SEED + 50), x, dev, per_c, cond=cond)
    bf = build_model(cfg["model_cfg"], cfg["data_cfg"], compute_dtype="bfloat16").eval().to(dev)
    bf.load_state_dict(film_near_identity(weights, SEED + 50))
    runs["C rollout"] = rollout_phase("FiLMAViT-small mega", bf, x.to(dev), WINDOWS, per_c, card,
                                      reference=y_c, cond=cond.to(dev))
    del bf, y_c
    runs["C"] = fit_phase("FiLMAViT-small mega", train, TRAIN_BATCH, FUSED_TRAIN_STEPS,
                          (IMAGE, IMAGE), dict(dots_step(per_c), mega_temporal_block_bwd=blocks,
                                               mega_axial_block_bwd=blocks),
                          repo / "build" / "smoke_mega", dev, card, fluid=len(FLUID_PARAMS))

    print(f"== phase 27: path D, AViT-small at {IMAGE}^2 with attn_impl=fused_packed and fused: "
          f"one float32 window card vs CPU, Trainer.fit bfloat16 batch {TRAIN_BATCH}", flush=True)
    for impl, kernel in (("fused_packed", "fused_axial_attention_packed"),
                         ("fused", "fused_axial_attention")):
        cfg, train = cfgs("model_cfg=avit_small", f"model_cfg.params.attn_impl={impl}")
        model = build_model(cfg["model_cfg"], cfg["data_cfg"])
        weights = random_state_dict(model, SEED + 52)
        del model
        window_phase(f"AViT-small {impl}", cfg["model_cfg"], cfg["data_cfg"], weights,
                     frames(SEED + 53, IMAGE, IMAGE), dev, {kernel: blocks})
        runs["D " + impl] = fit_phase(f"AViT-small {impl}", train, TRAIN_BATCH, FUSED_TRAIN_STEPS,
                                      (IMAGE, IMAGE), {kernel: blocks, kernel + "_bwd": blocks},
                                      repo / "build" / f"smoke_{impl}", dev, card)

    cfg, train = cfgs("model_cfg=avit_tiny", "optim_cfg=adamw")
    params = cfg["model_cfg"]["params"]
    tiny_blocks, c, heads = params["processor_blocks"], params["embed_dim"], params["num_heads"]
    grid = IMAGE // params["patch_size"]
    temporal = resolve_temporal_impl("auto", t, grid, grid, c)
    axial = resolve_axial_impl("auto", grid, grid, c, heads)
    axial_kernel = {"lane": "lane_axial_attention", "fused_block": "fused_block_attention"}[axial]
    print(f"== phase 28: path E, AViT-tiny through auto at {IMAGE}^2 ({grid}x{grid} tokens, "
          f"heads of {c // heads}: temporal {temporal}, axial {axial}) and at "
          f"{FLOW_HEIGHT}x{FLOW_WIDTH}", flush=True)
    if temporal != "mega":
        fail(f"AViT-tiny at {IMAGE}^2 resolves its temporal branch to {temporal}, not mega")
    model = build_model(cfg["model_cfg"], cfg["data_cfg"])
    weights = random_state_dict(model, SEED + 54)
    del model
    per_e = {"mega_temporal_block": tiny_blocks, axial_kernel: tiny_blocks}
    window_phase("AViT-tiny 512^2", cfg["model_cfg"], cfg["data_cfg"], weights,
                 frames(SEED + 55, IMAGE, IMAGE), dev, per_e)
    runs["E"] = fit_phase("AViT-tiny 512^2", train, TRAIN_BATCH, FUSED_TRAIN_STEPS, (IMAGE, IMAGE),
                          dict(dots_step(per_e), mega_temporal_block_bwd=tiny_blocks,
                               **{axial_kernel + "_bwd": tiny_blocks}),
                          repo / "build" / "smoke_tiny", dev, card)
    runs["E axial"] = axial_kernel
    flow_h, flow_w = FLOW_HEIGHT // params["patch_size"], FLOW_WIDTH // params["patch_size"]
    if resolve_temporal_impl("auto", t, flow_h, flow_w, c) != "core":
        fail(f"AViT-tiny at {FLOW_HEIGHT}x{FLOW_WIDTH} does not resolve its temporal branch "
             f"to core")
    flow_axial = {"lane": "lane_axial_attention", "fused_block": "fused_block_attention"}[
        resolve_axial_impl("auto", flow_h, flow_w, c, heads)]
    runs["E flow"] = fit_phase(
        f"AViT-tiny {FLOW_HEIGHT}x{FLOW_WIDTH}", train, FLOW_TRAIN_BATCH, 2,
        (FLOW_HEIGHT, FLOW_WIDTH), {"core_temporal_attention": tiny_blocks,
                                    "core_temporal_attention_bwd": tiny_blocks,
                                    flow_axial: tiny_blocks, flow_axial + "_bwd": tiny_blocks},
        repo / "build" / "smoke_tiny_flow", dev, card)
    return runs


# Phases 29-34: K8 at path F's shapes (FiLMAViT-small at 512^2 with
# ``attn_impl=flash``: the temporal lines (heads, B*32*32, T, d) and the axial
# rows and columns (heads, B*T*32, 32, d), B = 1 for the rollout and 8 for
# the training step), at AViT-tiny's on that route (the axial lines of its
# 64x64 grid at 512^2, head dim 16, batch 8) and K10 at its training step's
# pred and target.
FLASH_SHAPES = {"temporal rollout": (6, 32 * 32, TIME_WINDOW, 64),
                "temporal training": (6, TRAIN_BATCH * 32 * 32, TIME_WINDOW, 64),
                "axial rollout": (6, TIME_WINDOW * 32, 32, 64),
                "axial training": (6, TRAIN_BATCH * TIME_WINDOW * 32, 32, 64),
                "axial d16": (6, TRAIN_BATCH * TIME_WINDOW * 64, 64, 16)}
LOSS_SHAPE = (TRAIN_BATCH, TIME_WINDOW, FIELDS, IMAGE, IMAGE)
# K10's plane sums against float64: float32 sums of 512^2 values in blocks
# of 8192 and a fixed order, 1e-5 of each column's largest; its gradient
# rounds one product, as the plain version does (KERNEL_RTOL).
LOSS_RTOL = 1e-5
# Path F's float32 step with loss_layout="nhwc" against "nchw" on the card:
# the same function, its plane sums in another order, and both steps' float32
# atomic sums (K8's tables) reordered from run to run: the loss within 1e-5,
# each gradient within 1e-4 of its largest magnitude (one that is zero up to
# rounding, below 1e-4 of the largest of all, within 1e-4 of a hundredth of
# the largest).
LAYOUT_RTOL = {"loss": 1e-5, "grads": 1e-4}


def flash_kernel_phase(dev, results: dict) -> None:
    """K8 forward and every gradient at each ``FLASH_SHAPES`` shape, float32
    against the plain version in float64 and bfloat16 against it in bfloat16
    (``LINE_RTOL``), with the times of the kernels, the plain versions and
    ``scaled_dot_product_attention`` with the bias as its mask."""
    import torch
    import torch.nn.functional as F
    from bubbleformer_tpu_torch.ops import axial_pallas as k8

    for i, (where, shape) in enumerate(FLASH_SHAPES.items()):
        heads, _, n, _ = shape
        rng = np.random.default_rng(SEED + 90 + i)

        def draw(*s):
            return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

        base = dict(q=draw(*shape), k=draw(*shape), v=draw(*shape), bias=draw(heads, n, n),
                    scale_factor=torch.from_numpy(rng.uniform(0.5, 1.5, heads)
                                                  .astype(np.float32)).to(dev))
        do32 = draw(*shape)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            args = dict(base, **{k: base[k].to(dt) for k in "qkv"})
            do = do32.to(dt)
            ref_args, ref_do = ((args, do) if dt == torch.bfloat16 else
                                ({k: v.double() for k, v in args.items()}, do.double()))
            got = k8.flash_packed_attention(**args)
            ref = k8.flash_plain(**ref_args)
            torch.cuda.synchronize()
            err_f = compare(f"K8 {name} {where} {shape}", got, ref, LINE_RTOL[name])
            del got, ref
            got = k8.flash_packed_attention_bwd(do, *args.values())
            ref = k8.flash_bwd_plain(ref_do, **ref_args)
            torch.cuda.synchronize()
            err_b = compare_grads(f"K8 bwd {name} {where}", tuple(args), got, ref,
                                  LINE_RTOL[name])
            check_repeat(f"K8 bwd {name} {where}", tuple(args), got,
                         k8.flash_packed_attention_bwd(do, *args.values()), 3)
            del got, ref, ref_args, ref_do
            ms_f = cuda_ms(lambda: k8.flash_packed_attention(**args))
            plain_f = ref_ms(lambda: k8.flash_plain(**args))
            ms_b = cuda_ms(lambda: k8.flash_packed_attention_bwd(do, *args.values()))
            plain_b = ref_ms(lambda: k8.flash_bwd_plain(do, **args))
            # The library yardstick: attention with the bias as an additive
            # mask, without the blend; its backward through autograd (q, k, v).
            q, k, v = (args[c].detach().requires_grad_() for c in "qkv")
            mask = args["bias"].to(dt)[:, None].expand(*shape[:2], n, n)
            sdpa_f = ref_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            sdpa_b = ref_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True))
            del q, k, v, mask, out
            print(f"  K8 {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}, sdpa "
                  f"{sdpa_f:.4f}), backward {ms_b:.4f} ms (plain {plain_b:.4f}, sdpa {sdpa_b:.4f})",
                  flush=True)
            results[("K8", name, where)] = (err_f, ms_f, plain_f)
            results[("K8 bwd", name, where)] = (err_b, ms_b, plain_b)
            results[("K8 sdpa", name, where)] = sdpa_f
            results[("K8 bwd sdpa", name, where)] = sdpa_b
            del args, do
        del base, do32


def loss_kernel_phase(dev, results: dict) -> None:
    """K10 forward and backward at ``LOSS_SHAPE``, the prediction in
    bfloat16 (as the bfloat16 step gives it) and in float32, the target in
    float32: the plane sums against float64 (``LOSS_RTOL``), the gradient
    against the plain version (``KERNEL_RTOL``), the loss bit for bit on a
    second call; with both times."""
    import torch
    from bubbleformer_tpu_torch.ops import lp_loss as k10

    rng = np.random.default_rng(SEED + 95)
    tgt = torch.from_numpy(rng.standard_normal(LOSS_SHAPE).astype(np.float32)).to(dev)
    pred32 = tgt + 0.3 * torch.from_numpy(rng.standard_normal(LOSS_SHAPE)
                                          .astype(np.float32)).to(dev)
    m = int(np.prod(LOSS_SHAPE[:3]))
    coef = torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(np.float32)).to(dev)
    t3 = tgt.reshape(m, -1)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        p3 = pred32.to(dt).reshape(m, -1)
        got = k10.plane_norms(p3, t3)
        d64, t64 = p3.double() - t3.double(), t3.double()
        ref = torch.stack([(d64 * d64).sum(-1), (t64 * t64).sum(-1)], dim=-1)
        rel = ((got.double() - ref).abs().max(dim=0).values / ref.abs().max(dim=0).values).max()
        err_f = (got.double() - ref).abs().max().item()
        print(f"  K10 {name} {LOSS_SHAPE}: plane sums rel {rel.item():.3e} against float64 "
              f"(tol {LOSS_RTOL:.0e})", flush=True)
        if not torch.isfinite(got).all() or rel.item() > LOSS_RTOL:
            fail(f"K10 {name}: plane sums {rel.item():.3e} from float64")
        del d64, t64, ref
        got_b = k10.plane_norms_bwd(p3, t3, coef)
        err_b = compare(f"K10 bwd {name} {LOSS_SHAPE}", got_b,
                        k10.plane_norms_bwd_plain(p3, t3, coef), KERNEL_RTOL[name])
        pred = pred32.to(dt)
        if not torch.equal(k10.training_lp_loss(pred, tgt), k10.training_lp_loss(pred, tgt)):
            fail(f"K10 {name}: the loss differs between two calls on the same inputs")
        ms_f = cuda_ms(lambda: k10.plane_norms_fwd_cuda(p3, t3))
        plain_f = ref_ms(lambda: k10.plane_norms_plain(p3, t3))
        ms_b = cuda_ms(lambda: k10.plane_norms_bwd_cuda(p3, t3, coef))
        plain_b = ref_ms(lambda: k10.plane_norms_bwd_plain(p3, t3, coef))
        print(f"  K10 {name}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), backward {ms_b:.4f} "
              f"ms (plain {plain_b:.4f}); the loss repeats bit for bit", flush=True)
        results[("K10", name, "training")] = (err_f, ms_f, plain_f)
        results[("K10 bwd", name, "training")] = (err_b, ms_b, plain_b)
        del p3, pred, got, got_b


@contextlib.contextmanager
def env_var(name: str, value):
    """The environment variable ``name`` set to ``value`` (None: unset)
    inside, as it was after."""
    import os

    def put(v):
        if v is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = v

    saved = os.environ.get(name)
    put(value)
    try:
        yield
    finally:
        put(saved)


def slice6_phases(repo: Path, dev, card: str, results: dict) -> dict:
    """Phases 29-34: K8 and K10 against their plain versions, and path F
    (FiLMAViT-small at 512^2 with ``attn_impl=flash``: K8 in both branches,
    the loss through K10 in training).  Returns the runs' numbers."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.data import synthetic_batch
    from bubbleformer_tpu_torch.models import build_model

    print("== phase 29: K8 flash_packed_attention vs plain, forward and backward", flush=True)
    flash_kernel_phase(dev, results)
    print(f"== phase 30: K10 plane_norms vs plain at {LOSS_SHAPE}, forward and backward",
          flush=True)
    loss_kernel_phase(dev, results)

    cfg = load_config(["model_cfg.params.attn_impl=flash", "scheduler_cfg.params.warmup_iters=2"])
    train = (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])
    params = cfg["model_cfg"]["params"]
    if (cfg["model_cfg"]["name"], params["embed_dim"], cfg["optim_cfg"]["name"]) != (
            "filmavit", 384, "lion"):
        fail("the default composition is not FiLMAViT-small with Lion")
    blocks = params["processor_blocks"]
    model = build_model(cfg["model_cfg"], cfg["data_cfg"])
    weights = film_near_identity(random_state_dict(model, SEED + 56), SEED + 56)
    del model
    x = torch.from_numpy(np.random.default_rng(SEED + 57).standard_normal(
        (1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)).astype(np.float32))
    cond = torch.tensor([FLUID_PARAMS], dtype=torch.float32)
    per_f = {"flash_packed_attention": 3 * blocks}  # one temporal and two axial calls a block
    runs = {}
    print(f"== phase 31: path F, FiLMAViT-small at {IMAGE}^2 with attn_impl=flash: one float32 "
          f"window card vs CPU", flush=True)
    y_f = window_phase("FiLMAViT-small flash", cfg["model_cfg"], cfg["data_cfg"], weights, x,
                       dev, per_f, cond=cond)
    print(f"== phase 32: path F, {WINDOWS}-window bfloat16 rollout", flush=True)
    bf = build_model(cfg["model_cfg"], cfg["data_cfg"], compute_dtype="bfloat16").eval().to(dev)
    bf.load_state_dict(weights)
    runs["F rollout"] = rollout_phase("FiLMAViT-small flash", bf, x.to(dev), WINDOWS, per_f,
                                      card, reference=y_f, cond=cond.to(dev))
    del bf, y_f
    print(f"== phase 33: path F, Trainer.fit bfloat16 batch {TRAIN_BATCH}, Lion, "
          f"{FUSED_TRAIN_STEPS} steps after 1 warm-up step, BUBBLEFORMER_LOSS_KERNEL=1",
          flush=True)
    with env_var("BUBBLEFORMER_LOSS_KERNEL", "1"):
        runs["F"] = fit_phase("FiLMAViT-small flash", train, TRAIN_BATCH, FUSED_TRAIN_STEPS,
                              (IMAGE, IMAGE),
                              dict(per_f, flash_packed_attention_bwd=3 * blocks, plane_norms=1,
                                   plane_norms_bwd=1),
                              repo / "build" / "smoke_flash", dev, card, fluid=len(FLUID_PARAMS))

    print(f"== phase 34: path F, one float32 training step on the card, loss_layout nhwc vs "
          f"nchw, batch 1 at {IMAGE}^2", flush=True)
    batch = synthetic_batch(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE, len(FLUID_PARAMS), seed=SEED + 58)
    steps = {layout: train_step_grads(train, weights, batch, "cuda", torch.float32,
                                      loss_layout=layout) for layout in ("nchw", "nhwc")}
    (loss_c, grads_c, _), (loss_h, grads_h, _) = steps["nchw"], steps["nhwc"]
    rel_loss = abs(loss_h - loss_c) / abs(loss_c)
    top = max(g.abs().max().item() for g in grads_c.values())
    worst, zero = 0.0, []
    for n, g in grads_c.items():
        scale = g.abs().max().item()
        if scale <= LAYOUT_RTOL["grads"] * top:
            zero.append(n)
            scale = 1e-2 * top
        err = (grads_h[n] - g).abs().max().item() / scale
        worst = max(worst, err)
        if not torch.isfinite(grads_h[n]).all() or err > LAYOUT_RTOL["grads"]:
            fail(f"path F nhwc step: gradient {n} {err:.3e} from the nchw step")
    if rel_loss > LAYOUT_RTOL["loss"]:
        fail(f"path F nhwc step: loss {loss_h} vs {loss_c} (nchw)")
    print(f"  loss nchw {loss_c:.7f}, nhwc {loss_h:.7f} (rel {rel_loss:.2e}); {len(grads_c)} "
          f"gradients, worst rel {worst:.3e} (tol {LAYOUT_RTOL['grads']:.0e}; {len(zero)} zero up "
          f"to rounding) ok", flush=True)
    runs["F nhwc"] = {"loss_rel": rel_loss, "grads_rel": worst}
    return runs


# Phases 35-38: K9 at its paths' shapes (x of (BT, H, W, C), 6 heads):
# FiLMAViT-small's rollout and training step (path G), the flow-boiling
# 32x128 grid at batch 4 and 8, AViT-tiny's 64x64 grid at 512^2 (heads of 16).
PX_SHAPES = {"rollout": (TIME_WINDOW, 32, 32, 384),
             "training": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 384),
             "flow b4": (FLOW_TRAIN_BATCH * TIME_WINDOW, 32, 128, 384),
             "flow b8": (TRAIN_BATCH * TIME_WINDOW, 32, 128, 384),
             "tiny d16": (TRAIN_BATCH * TIME_WINDOW, 64, 64, 96)}
# The remat steps (phase 37): each policy's loss and gradients against the
# no-remat step's, within 3x the no-remat step's own spread (its float32
# atomic parameter sums, K1's or K3's and K9's, reorder from run to run),
# plus 1e-6 of each gradient's scale for a spread that happens to be nought.
REMAT_RTOL = {"spread": 3.0, "floor": 1e-6}
FLOW_BIG_BATCH = 8


def px_kernel_phase(dev, results: dict) -> None:
    """K9 forward and every gradient at each ``PX_SHAPES`` shape, float32
    and bfloat16, against the plain versions (``LINE_RTOL``), dW unrounded in
    bfloat16; the times of the kernels, the plain versions and cuBLAS's QKV
    product alone.  In bfloat16 the card's and the plain version's
    projections sum in other orders, so their qkv differ by single ulps and
    the k-LayerNorm bias's gradient, zero up to rounding, is independent
    noise on each side: it is held to the plain version's own noise
    (``compare_grads``' ``zero_noise``), as K5's is."""
    import torch
    from bubbleformer_tpu_torch.ops import axial_lane_px as k9

    heads = 6
    for i, (where, shape) in enumerate(PX_SHAPES.items()):
        bt, h, w, c = shape
        d = c // heads
        rng = np.random.default_rng(SEED + 100 + i)

        def n(*s, scale=1.0, offset=0.0):
            return torch.from_numpy((offset + scale * rng.standard_normal(s))
                                    .astype(np.float32)).to(dev)

        base = dict(x=n(*shape), wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.1),
                    qn_scale=n(d, scale=0.1, offset=1.0), qn_bias=n(d, scale=0.1),
                    kn_scale=n(d, scale=0.1, offset=1.0), kn_bias=n(d, scale=0.1),
                    bias_x=n(heads, w, w), bias_y=n(heads, h, h),
                    scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32))
                    .to(dev),
                    scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32))
                    .to(dev))
        do32 = n(*shape)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            args = dict(base, x=base["x"].to(dt))
            do = do32.to(dt)
            ref_args, ref_do = ((args, do) if dt == torch.bfloat16 else
                                ({k: v.double() for k, v in args.items()}, do.double()))
            got = k9.lane_px_attention(**args, heads=heads)
            ref = k9.lane_px_plain(**ref_args, heads=heads)
            torch.cuda.synchronize()
            err_f = compare(f"K9 {name} {where} {shape}", got, ref, LINE_RTOL[name])
            del got, ref
            got = k9.lane_px_attention_bwd(do, *args.values(), heads=heads)
            ref = k9.lane_px_bwd_plain(ref_do, **ref_args, heads=heads)
            torch.cuda.synchronize()
            err_b = compare_grads(f"K9 bwd {name} {where}", tuple(args), got, ref,
                                  LINE_RTOL[name], zero_noise=name == "bfloat16")
            if dt == torch.bfloat16 and torch.equal(got[1], got[1].bfloat16().float()):
                fail(f"K9 bwd {name} {where}: dW is rounded to bfloat16")
            del got, ref, ref_args, ref_do
            ms_f = cuda_ms(lambda: k9.lane_px_attention(**args, heads=heads))
            plain_f = ref_ms(lambda: k9.lane_px_plain(**args, heads=heads))
            ms_b = cuda_ms(lambda: k9.lane_px_attention_bwd(do, *args.values(), heads=heads))
            plain_b = ref_ms(lambda: k9.lane_px_bwd_plain(do, **args, heads=heads))
            x2, w2 = args["x"].reshape(-1, c), args["wqkv"].to(dt)
            gemm = ref_ms(lambda: torch.matmul(x2, w2.t()))
            # The backward's products: the recompute, both directions' dW
            # and dx (two (R, 3C) stand-ins for the directions' dqkv).
            g_r = torch.matmul(x2, w2.t())
            g_c = torch.flip(g_r, (0,))
            gemm_b = ref_ms(lambda: (torch.matmul(x2, w2.t()), torch.matmul(g_r.t(), x2),
                                     torch.matmul(g_c.t(), x2), torch.matmul(g_r, w2),
                                     torch.matmul(g_c, w2)))
            del g_r, g_c
            print(f"  K9 {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), backward "
                  f"{ms_b:.4f} ms (plain {plain_b:.4f}); cuBLAS's products alone (partial "
                  f"yardstick) forward {gemm:.4f}, backward {gemm_b:.4f} ms", flush=True)
            results[("K9", name, where)] = (err_f, ms_f, plain_f)
            results[("K9 bwd", name, where)] = (err_b, ms_b, plain_b)
            results[("K9 gemm", name, where)] = gemm
            results[("K9 bwd gemm", name, where)] = gemm_b
            del args, do
        del base, do32


def remat_phase(label: str, train_cfgs, weights, batch: int, frame, dev, card: str,
                forwards: dict, fluid=None, timed: bool = True) -> dict:
    """One float32 training step of ``label`` on the card at ``batch``
    synthetic samples of ``frame`` = (H, W) pixels with remat off (twice)
    and under each policy other than "off" in ``forwards``, from the same
    weights: the loss and every gradient against the first no-remat step's
    (``REMAT_RTOL``), and each step's forward launches per block
    (``forwards[policy]``).  When ``timed``, three more steps of each for
    ms/step and the peak memory."""
    import torch
    from bubbleformer_tpu_torch.data import synthetic_batch
    from bubbleformer_tpu_torch.training import module_class

    model_cfg, data_cfg = train_cfgs[:2]
    blocks = model_cfg["params"]["processor_blocks"]
    arrays = synthetic_batch(batch, data_cfg["time_window"], len(data_cfg["input_fields"]),
                             *frame, fluid, seed=SEED + 110)
    runs = {}
    for run, policy in (("off", "off"), ("off again", "off"),
                        *((p, p) for p in forwards if p != "off")):
        params = dict(model_cfg["params"], remat=policy != "off",
                      remat_policy="dots" if policy == "off" else policy)
        cfg = dict(model_cfg, params=params)
        module = module_class(cfg, data_cfg)(cfg, *train_cfgs[1:], total_steps=8, device="cuda",
                                             seed=SEED)
        module.model.load_state_dict(weights)
        data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        zero_counters()
        m = module.train_step(data, torch.Generator().manual_seed(SEED))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counters().items() if v}
        grads = {n: p.grad.double().cpu() for n, p in module.model.named_parameters()}
        want = {k: n * blocks for k, n in forwards[policy].items()}
        if {k: launches.get(k) for k in want} != want:
            fail(f"{label} remat {run}: forward launches {launches}, expected {want}")
        runs[run] = dict(loss=loss, grads=grads, launches=launches)
        if timed:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                module.train_step(data, torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            runs[run].update(ms_per_step=1000 * (time.perf_counter() - t0) / 3,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        timing = (f", {runs[run]['ms_per_step']:.1f} ms/step, peak {runs[run]['peak_gb']:.2f} GB"
                  if timed else "")
        print(f"  {label} remat {run}: loss {loss:.7f}{timing} (batch {batch}, float32, {card}); "
              f"launches {launches}", flush=True)
        del module, data
    ref = runs["off"]
    spread_grads, _ = step_errors(ref["grads"], runs["off again"]["grads"])
    spread = max(spread_grads.values())
    spread_loss = abs(runs["off again"]["loss"] - ref["loss"])
    out = {"spread": {"loss": spread_loss, "grads_rel": spread}}
    for run in runs:
        if run.startswith("off"):
            continue
        errs, zero = step_errors(ref["grads"], runs[run]["grads"])
        worst = max(errs.values())
        d_loss = abs(runs[run]["loss"] - ref["loss"])
        limit = REMAT_RTOL["spread"] * spread + REMAT_RTOL["floor"]
        print(f"  {label} remat {run} vs off: loss {d_loss:.2e} (off repeated {spread_loss:.2e}), "
              f"worst gradient {worst:.3e} (off repeated {spread:.3e}; tol {limit:.3e}; "
              f"{len(zero)} zero up to rounding)", flush=True)
        if d_loss > REMAT_RTOL["spread"] * spread_loss + 1e-7 * abs(ref["loss"]):
            fail(f"{label} remat {run}: loss {runs[run]['loss']} vs {ref['loss']} without remat")
        if worst > limit or not all(torch.isfinite(g).all() for g in runs[run]["grads"].values()):
            fail(f"{label} remat {run}: gradients {worst:.3e} from the no-remat step, above "
                 f"{limit:.3e}")
        out[run] = {"loss_diff": d_loss, "grads_rel": worst}
    if timed:
        out.update({run: dict(out.get(run, {}), ms_per_step=r["ms_per_step"],
                              peak_gb=r["peak_gb"]) for run, r in runs.items()})
    return out


def slice7_phases(repo: Path, dev, card: str, results: dict) -> dict:
    """Phases 35-38: K9 against its plain version, path G (FiLMAViT-small
    with ``BUBBLEFORMER_LANE_PROJ=kernel``: K1 and K9) with the default
    route beside it, the remat step, and AViT-small at 512x2048 at batch 8
    under remat "dots" on K3 and K9.  Returns the runs' numbers."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.models import build_model

    print("== phase 35: K9 lane_px_attention vs plain, forward and backward", flush=True)
    px_kernel_phase(dev, results)

    cfg = load_config(["scheduler_cfg.params.warmup_iters=2"])
    train = (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])
    params = cfg["model_cfg"]["params"]
    if (cfg["model_cfg"]["name"], params["embed_dim"], cfg["optim_cfg"]["name"]) != (
            "filmavit", 384, "lion"):
        fail("the default composition is not FiLMAViT-small with Lion")
    blocks = params["processor_blocks"]
    model = build_model(cfg["model_cfg"], cfg["data_cfg"])
    if not (model.remat and model.remat_policy == "dots"):
        fail("the default model does not checkpoint its blocks under remat 'dots'")
    weights = film_near_identity(random_state_dict(model, SEED + 120), SEED + 120)
    del model
    x = torch.from_numpy(np.random.default_rng(SEED + 121).standard_normal(
        (1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)).astype(np.float32))
    cond = torch.tensor([FLUID_PARAMS], dtype=torch.float32)
    per_g = {"mega_temporal_block": blocks, "lane_px_attention": blocks}
    runs = {}
    with env_var("BUBBLEFORMER_LANE_PROJ", "kernel"):
        print(f"== phase 36: path G, FiLMAViT-small at {IMAGE}^2 with "
              f"BUBBLEFORMER_LANE_PROJ=kernel: one float32 window card vs CPU, a {WINDOWS}-window "
              f"bfloat16 rollout, Trainer.fit bfloat16 batch {TRAIN_BATCH} under remat 'dots'",
              flush=True)
        y_g = window_phase("FiLMAViT-small K9", cfg["model_cfg"], cfg["data_cfg"], weights, x,
                           dev, per_g, cond=cond)
        bf = build_model(cfg["model_cfg"], cfg["data_cfg"],
                         compute_dtype="bfloat16").eval().to(dev)
        bf.load_state_dict(weights)
        runs["G rollout"] = rollout_phase("FiLMAViT-small K9", bf, x.to(dev), WINDOWS, per_g,
                                          card, reference=y_g, cond=cond.to(dev))
        del bf, y_g
        runs["G"] = fit_phase("FiLMAViT-small K9", train, TRAIN_BATCH, FUSED_TRAIN_STEPS,
                              (IMAGE, IMAGE), dict(dots_step(per_g), mega_temporal_block_bwd=blocks,
                                                   lane_px_attention_bwd=blocks),
                              repo / "build" / "smoke_px", dev, card, fluid=len(FLUID_PARAMS))
    with env_var("BUBBLEFORMER_LANE_PROJ", None):
        per_k2 = {"mega_temporal_block": blocks, "lane_axial_attention": blocks}
        runs["G default"] = fit_phase(
            "FiLMAViT-small default route", train, TRAIN_BATCH, FUSED_TRAIN_STEPS, (IMAGE, IMAGE),
            dict(dots_step(per_k2), mega_temporal_block_bwd=blocks,
                 lane_axial_attention_bwd=blocks),
            repo / "build" / "smoke_default", dev, card, fluid=len(FLUID_PARAMS))
        print(f"== phase 37: one float32 training step of FiLMAViT-small at batch {TRAIN_BATCH} "
              f"with remat off, 'dots' and 'full'; AViT-small at {FLOW_HEIGHT}x{FLOW_WIDTH} "
              f"(K3, K9) with remat off and 'dots'", flush=True)
        runs["remat"] = remat_phase(
            "FiLMAViT-small", train, weights, TRAIN_BATCH, (IMAGE, IMAGE), dev, card,
            {"off": {"mega_temporal_block": 1, "lane_axial_attention": 1},
             "dots": {"mega_temporal_block": 2, "lane_axial_attention": 1},
             "full": {"mega_temporal_block": 2, "lane_axial_attention": 2}},
            fluid=len(FLUID_PARAMS))
    flow_cfg = load_config(["model_cfg=avit_small", "data_cfg=flowboiling_chf",
                            "scheduler_cfg.params.warmup_iters=2"])
    flow_train = (flow_cfg["model_cfg"], flow_cfg["data_cfg"], flow_cfg["optim_cfg"],
                  flow_cfg["scheduler_cfg"])
    flow_blocks = flow_cfg["model_cfg"]["params"]["processor_blocks"]
    flow_model = build_model(flow_cfg["model_cfg"], flow_cfg["data_cfg"])
    flow_weights = random_state_dict(flow_model, SEED + 130)
    del flow_model
    with env_var("BUBBLEFORMER_LANE_PROJ", "kernel"):
        runs["remat flow"] = remat_phase(
            f"AViT-small {FLOW_HEIGHT}x{FLOW_WIDTH} K9", flow_train, flow_weights, 1,
            (FLOW_HEIGHT, FLOW_WIDTH), dev, card,
            {"off": {"core_temporal_attention": 1, "lane_px_attention": 1},
             "dots": {"core_temporal_attention": 1, "lane_px_attention": 1}}, timed=False)
    del flow_weights

    print(f"== phase 38: Trainer.fit AViT-small at {FLOW_HEIGHT}x{FLOW_WIDTH}, bfloat16, batch "
          f"{FLOW_BIG_BATCH}, Lion, remat 'dots', BUBBLEFORMER_LANE_PROJ=kernel (K3, K9); then "
          f"batch {FLOW_TRAIN_BATCH} with remat off on K2", flush=True)
    with env_var("BUBBLEFORMER_LANE_PROJ", "kernel"):
        runs["flow b8"] = fit_phase(
            f"AViT-small {FLOW_HEIGHT}x{FLOW_WIDTH} K9 batch {FLOW_BIG_BATCH}", flow_train,
            FLOW_BIG_BATCH, FLOW_TRAIN_STEPS, (FLOW_HEIGHT, FLOW_WIDTH),
            {"core_temporal_attention": flow_blocks, "core_temporal_attention_bwd": flow_blocks,
             "lane_px_attention": flow_blocks, "lane_px_attention_bwd": flow_blocks},
            repo / "build" / "smoke_flow_px", dev, card)
    off_cfg = dict(flow_cfg["model_cfg"], params=dict(flow_cfg["model_cfg"]["params"],
                                                       remat=False))
    with env_var("BUBBLEFORMER_LANE_PROJ", None):
        runs["flow b4 off"] = fit_phase(
            f"AViT-small {FLOW_HEIGHT}x{FLOW_WIDTH} K2 batch {FLOW_TRAIN_BATCH} remat off",
            (off_cfg, *flow_train[1:]), FLOW_TRAIN_BATCH, FLOW_TRAIN_STEPS,
            (FLOW_HEIGHT, FLOW_WIDTH),
            {"core_temporal_attention": flow_blocks, "core_temporal_attention_bwd": flow_blocks,
             "lane_axial_attention": flow_blocks, "lane_axial_attention_bwd": flow_blocks},
            repo / "build" / "smoke_flow_off", dev, card)
    return runs


# Phases 39-40: the probes' kernels (P1-P4, csrc/probe_*.cu) at each probe's
# default shape: FiLMAViT-small's width (B = 4, T = 5, a 32x32 token grid, C =
# 384, 6 heads of 64) for P1 and P2, the second stage of its embed pyramid
# (20, 256, 256, 96) for P3, the layout bodies' own for P4.  Each is held to
# its plain version on the same card tensors: bit-exact where the probe asks
# for exactness (P2b) and for every P4 copy and P1a roll, else KERNEL_RTOL
# by the output's working type (P2a's S, P3's statistics and P4's Gram are
# float32 sums of exact products: 1e-4).
PROBE_ROWS = (
    # key, counter, source, the TPU kernel, dtype of the kernels-line row
    ("P1a", "within_roll", "probe_lane_axial.cu", "scripts/probe_lane_axial.py:86", "bfloat16"),
    ("P1b", "lane_core", "probe_lane_axial.cu", "scripts/probe_lane_axial.py:193", "bfloat16"),
    ("P2a", "dot_combos", "probe_chunk_axial.cu", "scripts/probe_chunk_axial.py:83", "bfloat16"),
    ("P2b", "perm_product", "hopper_gemm.cuh", "scripts/probe_chunk_axial.py:124",
     "bfloat16"),
    ("P2c", "chunk_core", "probe_chunk_axial.cu", "scripts/probe_chunk_axial.py:260",
     "bfloat16"),
    ("P3", "stage", "probe_pyramid.cu", "scripts/probe_pyramid_pallas.py:103", "bfloat16"),
    ("P4 gram", "gram", "probe_layout.cu", "scripts/probe_mosaic.py:36", "float32"),
    ("P4 view_copy", "view_copy", "probe_layout.cu", "scripts/probe_mosaic.py:36", "float32"),
    ("P4 chunk_gram", "chunk_gram_apply", "probe_layout.cu", "scripts/probe_mosaic.py:36",
     "bfloat16"),
)
# The P4 body each P4 kernel is timed at (one call of the kernel each).
PROBE_TIMED_BODY = {"P4 gram": "reshape_col", "P4 view_copy": "transpose_full",
                    "P4 chunk_gram": "head_slice_dot_bf16"}


def probe_kernel_phase(dev, results: dict) -> dict:
    """Every probe kernel against its plain version on the card, with the
    times of both and of the one PyTorch call that computes the same
    function where there is one; ``results[(key, dtype)] = (max_abs_err, ms,
    plain_ms, library_ms)``.  Returns each row's work shape."""
    import torch
    from bubbleformer_tpu_torch import probes
    from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid

    def card(inputs):
        return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in inputs.items()}

    def record(key, dtype, err, kernel, plain, library=None):
        ms, plain_ms = cuda_ms(kernel), ref_ms(plain)
        lib_ms = ref_ms(library) if library is not None else None
        results[(key, dtype)] = (err, ms, plain_ms, lib_ms)
        print(f"  {key} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""), flush=True)

    shapes = {}
    rs = lane_axial.ROLL_SHAPE
    rolls = (5, rs.W, 3 * rs.W, rs.H * rs.W)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        x = lane_axial.within_roll_input(dt).to(dev)
        got = lane_axial.within_roll(x, *rolls)

        def plain(x=x):
            return (lane_axial.within_roll_plain(x, *rolls[:2]),
                    lane_axial.within_roll_plain(x, *rolls[2:]))

        torch.cuda.synchronize()
        err = max(compare(f"P1a within_roll {name} {tuple(x.shape)} roll {i}", g, r, 0.0)
                  for i, (g, r) in enumerate(zip(got, plain())))
        x1, x2 = x.view(rs.C, rs.T * rs.H, rs.W), x.view(rs.C, rs.T, rs.H * rs.W)
        record("P1a", name, err, lambda x=x: lane_axial.within_roll(x, *rolls), plain,
               lambda x1=x1, x2=x2: (torch.roll(x1, -5, 2), torch.roll(x2, -3 * rs.W, 2)))
        launches = probes.launch_ms(lambda x=x: lane_axial.within_roll(x, *rolls))
        print(f"  P1a {name} device ms a launch (torch.profiler, 5 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in launches.items()), flush=True)
    shapes["P1a"] = tuple(x.shape)

    args = lane_axial.parser().parse_args([])
    inp = card(lane_axial.make_inputs(args))
    got = lane_axial.lane_core(**inp)
    ref = lane_axial.lane_core_plain(**inp)
    torch.cuda.synchronize()
    err = compare(f"P1b lane_core bfloat16 q {tuple(inp['q'].shape)}", got, ref,
                  KERNEL_RTOL["bfloat16"])
    record("P1b", "bfloat16", err, lambda: lane_axial.lane_core(**inp),
           lambda: lane_axial.lane_core_plain(**inp))
    launches = probes.launch_ms(lambda: lane_axial.lane_core(**inp))
    print("  P1b device ms a launch (torch.profiler, 5 calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in launches.items()), flush=True)
    bt, c, _ = inp["q"].shape
    shapes["P1b"] = (bt, c, inp["h"], inp["w"], inp["heads"])
    del inp, got, ref

    x, y = (t.to(dev) for t in chunk_axial.dot_combos_input())
    (s, pv), (s_ref, pv_ref) = chunk_axial.dot_combos(x, y), chunk_axial.dot_combos_plain(x, y)
    torch.cuda.synchronize()
    err = max(compare("P2a dot_combos S", s, s_ref, KERNEL_RTOL["float32"]),
              compare("P2a dot_combos pv", pv, pv_ref, KERNEL_RTOL["bfloat16"]))
    record("P2a", "bfloat16", err, lambda: chunk_axial.dot_combos(x, y),
           lambda: chunk_axial.dot_combos_plain(x, y))
    shapes["P2a"] = (chunk_axial.DOT_D, chunk_axial.DOT_CH)

    x, p = (t.to(dev) for t in chunk_axial.perm_input())
    err = compare(f"P2b perm_product {tuple(x.shape)}", chunk_axial.perm_product(x, p),
                  chunk_axial.perm_product_plain(x, p), 0.0)
    record("P2b", "bfloat16", err, lambda: chunk_axial.perm_product(x, p),
           lambda: chunk_axial.perm_product_plain(x, p), lambda: torch.matmul(x, p))
    shapes["P2b"] = tuple(x.shape)

    args = chunk_axial.parser().parse_args([])
    inp = card(chunk_axial.make_inputs(args))
    got = chunk_axial.chunk_core(**inp)
    ref = chunk_axial.chunk_core_plain(**inp)
    torch.cuda.synchronize()
    err = compare(f"P2c chunk_core bfloat16 q {tuple(inp['q'].shape)}", got, ref,
                  KERNEL_RTOL["bfloat16"])
    record("P2c", "bfloat16", err, lambda: chunk_axial.chunk_core(**inp),
           lambda: chunk_axial.chunk_core_plain(**inp))
    launches = probes.launch_ms(lambda: chunk_axial.chunk_core(**inp))
    print("  P2c device ms a launch (torch.profiler, 5 calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in launches.items()), flush=True)
    bt, c, n = inp["q"].shape
    shapes["P2c"] = (bt, c, n, inp["heads"], inp["ch"])
    del inp, got, ref

    args = pyramid.parser().parse_args([])
    inp = card(pyramid.make_inputs(args))
    got, ref = pyramid.stage(**inp), pyramid.stage_plain(**inp)
    torch.cuda.synchronize()
    err = max(compare(f"P3 stage out {tuple(got[0].shape)}", got[0], ref[0],
                      KERNEL_RTOL["bfloat16"]),
              compare("P3 stage mu", got[1], ref[1], KERNEL_RTOL["float32"]),
              compare("P3 stage var", got[2], ref[2], KERNEL_RTOL["float32"]))
    again = pyramid.stage(**inp)
    torch.cuda.synchronize()
    if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
        raise RuntimeError("P3 stage: mu and var differ between two calls (the tiles' "
                           "statistics are summed in a fixed order)")
    print("  P3 stage mu and var repeat bit for bit", flush=True)
    record("P3", "bfloat16", err, lambda: pyramid.stage(**inp),
           lambda: pyramid.stage_plain(**inp))
    shapes["P3"] = (*inp["y0"].shape, inp["k"].shape[-1])
    del inp, got, ref

    errs = {}
    for name, (_, _, shape, dt, _) in mosaic.BODIES.items():
        key = "P4 " + mosaic.BODY_KERNEL[name].replace("_apply", "")
        x = mosaic.body_input(name).to(dev)
        got = mosaic.run_body(name, x)
        ref = mosaic.run_body(name, x, mosaic.PLAIN)
        torch.cuda.synchronize()
        rtol = 0.0 if key == "P4 view_copy" else KERNEL_RTOL[
            "float32" if key == "P4 gram" else str(dt).split(".")[-1]]
        errs[key] = max(errs.get(key, 0.0),
                        compare(f"{key} {name} {tuple(shape)}", got, ref, rtol))
    for key, name in PROBE_TIMED_BODY.items():
        x = mosaic.body_input(name).to(dev)
        library = {"P4 gram": lambda x=x: torch.matmul(x.view(-1, mosaic.D), x.view(-1, mosaic.D).t()),
                   "P4 view_copy": lambda x=x: x.permute(1, 0, 2).contiguous()}.get(key)
        record(key, str(x.dtype).split(".")[-1], errs[key],
               lambda x=x, name=name: mosaic.run_body(name, x),
               lambda x=x, name=name: mosaic.run_body(name, x, mosaic.PLAIN), library)
        shapes[key] = {"P4 gram": (x.numel() // mosaic.D, mosaic.D),
                       "P4 view_copy": (x.numel(), False),
                       "P4 chunk_gram": (x.numel(), mosaic.CHUNK * mosaic.W, False)}[key]
    # The Gram in bfloat16 (bf16_dot) beside torch.mm with a float32 output
    # where this torch takes out_dtype (else the bf16 torch.matmul, whose
    # output is rounded to bf16: a partial yardstick), and each Gram body's
    # launch.
    x = mosaic.body_input("bf16_dot").to(dev)
    try:
        torch.mm(x, x.t(), out_dtype=torch.float32)
        library, lib_name = (lambda: torch.mm(x, x.t(), out_dtype=torch.float32),
                             "torch.mm(out_dtype=float32)")
    except (TypeError, RuntimeError):
        library, lib_name = lambda: torch.matmul(x, x.t()), "torch.matmul in bf16 (partial)"
    record("P4 gram", "bfloat16", errs["P4 gram"], lambda: mosaic.run_body("bf16_dot", x),
           lambda: mosaic.run_body("bf16_dot", x, mosaic.PLAIN), library)
    bf_ms, bf_by = bound(*kernel_work("P4 gram", shapes["P4 gram"], "bfloat16"), "bfloat16")
    print(f"  P4 gram bfloat16 (bf16_dot): bound {bf_ms:.6f} ms ({bf_by}); library "
          f"{lib_name}", flush=True)
    for name in ("reshape_col", "bf16_dot"):
        x = mosaic.body_input(name).to(dev)
        launches = probes.launch_ms(lambda x=x, name=name: mosaic.run_body(name, x))
        print(f"  P4 gram device ms a launch at {name} (torch.profiler, 5 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in launches.items()), flush=True)
    x = mosaic.body_input("chunked_ref_reads_bf16").to(dev)
    launches = probes.launch_ms(lambda: mosaic.run_body("chunked_ref_reads_bf16", x))
    print("  P4 chunk_gram device ms a launch at chunked_ref_reads_bf16 (torch.profiler, 5 "
          "calls): " + ", ".join(f"{k} {v:.4f}" for k, v in launches.items()), flush=True)
    return shapes


def probe_cli_phase() -> dict:
    """The four probe CLIs through their ``main`` on the card at their
    default flags, each run with every launch counter set to 0 just before
    and read just after: each probe's checks pass and each of its kernels
    launched, no other.  Returns the launches by counter."""
    from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid

    launches = {}
    # The bfloat16 path counter that must match each wrapper's count.
    hopper = {"lane_core": "lane_core_hopper", "chunk_gram_apply": "chunk_gram_hopper"}
    for module, kernels in ((lane_axial, ("within_roll", "lane_core", "lane_core_hopper")),
                            (chunk_axial, ("dot_combos", "perm_product", "chunk_core")),
                            (pyramid, ("stage",)),
                            (mosaic, ("gram", "view_copy", "chunk_gram_apply",
                                      "chunk_gram_hopper"))):
        label = module.__name__.rsplit(".", 1)[-1]
        print(f"  -- scripts/probe_{label}_torch.py (probes/{label}.py main)", flush=True)
        zero_counters()
        out = module.main([])
        got = read_counters()
        if module is mosaic:
            failed = [n for n, (ok, _) in out.items() if not ok]
        else:  # the pyramid probe asserts its agreement itself
            failed = [n for n, ok in out.items() if module is not pyramid and n != "bench"
                      and not ok]
            line = out if module is pyramid else out["bench"]
            ms = [v for k, v in line.items() if k.endswith("ms_per_call") or k.endswith("_fwd_ms")]
            if not ms or not all(isinstance(v, float) and v > 0 for v in ms):
                fail(f"probe {label}: no card time in its JSON line {line}")
        if failed:
            fail(f"probe {label}: {failed} failed")
        if any(got[k] == 0 for k in kernels) or any(v for k, v in got.items() if k not in kernels):
            fail(f"probe {label}: launches {got}, expected each of {kernels} and nothing else")
        if any(got[w] != got[p] for w, p in hopper.items() if w in kernels):
            fail(f"probe {label}: launches {got}, every bfloat16 call on its Hopper kernel")
        launches.update({k: got[k] for k in kernels})
        print(f"  probe {label}: launches {({k: got[k] for k in kernels})}", flush=True)
    return launches


def slice8_phases(dev, results: dict) -> tuple:
    """Phases 39-40: the probes' kernels against their plain versions, then
    the four probe CLIs on the card.  Returns (work shapes, launches)."""
    print("== phase 39: the probes' kernels (P1-P4) vs plain at the probes' default shapes",
          flush=True)
    shapes = probe_kernel_phase(dev, results)
    print("== phase 40: the probe CLIs on the card (scripts/probe_*_torch.py)", flush=True)
    return shapes, probe_cli_phase()


# Phases 41-43: the U-Nets at their configs' full width (``model_cfg/
# unet_modern.yaml``: hidden 32, ch_mults (1, 2, 2, 4, 4), widths up to 2048
# at 32x32, 566,747,956 parameters; ``unet_classic.yaml``: hidden 32, a
# 512-channel bottleneck, 7,768,564 parameters and BatchNorm running
# statistics).  No hand-written kernel lies on their forward (convolutions,
# norms and GELU are plain PyTorch, as they are XLA in the JAX package); their
# training step runs the loss through K10 under BUBBLEFORMER_LOSS_KERNEL=1.
UNETS = ("unet_classic", "unet_modern")
# ModernUnet's float32 window is held card against CPU on 128x128 frames
# (its widths do not depend on the frame; the CPU side stays short).
UNET_WINDOW_FRAME = {"unet_classic": IMAGE, "unet_modern": 128}
UNET_TRAIN_BATCH, UNET_TRAIN_STEPS = 8, 3
# The rollout's heat flux reads channel 0 as the distance function and
# channel 1 as the temperature (the data configs' field order: dfun,
# temperature, velx, vely), with the heater at 1 in the windows' units.
UNET_HEATER_TEMP = 1.0


def unet_state_dict(model, seed: int):
    """A U-Net's weights from a seed (torch's generator on the CPU, fast at
    566M parameters): convolutions lecun-normal (fan-in: input channels times
    the kernel's area), biases 0.1 N, norm weights 1 + 0.1 N; running means
    0.1 N and variances U(0.5, 1.5)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    # (I, O, kh, kw) weights: the input channels lead.
    transposed = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            out[name] = 0.5 + torch.rand(p.shape, generator=gen)
            continue
        a = torch.randn(p.shape, generator=gen)
        if p.ndim == 4:
            a /= (p.shape[0 if name in transposed else 1] * p.shape[2] * p.shape[3]) ** 0.5
        elif leaf == "weight":
            a = 1.0 + 0.1 * a
        else:
            a *= 0.1
        out[name] = a
    return out


def running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def unet_phases(repo: Path, dev, card: str) -> dict:
    """Phases 41-43, for ClassicUnet then ModernUnet: one float32 window card
    vs CPU, a 20-window bfloat16 rollout at 512^2 with its heat flux and its
    per-field relative L2 against the same rollout in float32, and
    ``Trainer.fit`` in bfloat16 at batch 8 with Lion, a 2-step warmup and
    ``BUBBLEFORMER_LOSS_KERNEL=1``: K10 forward and backward once a step and
    no other kernel, the running statistics moved, the checkpoint resumed
    with them equal.  Returns each model's numbers and each phase's
    seconds."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.inference import make_rollout_fn
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.training import module_class, restore_checkpoint
    from bubbleformer_tpu_torch.utils.heatflux import heatflux_torch
    from bubbleformer_tpu_torch.utils.metrics import relative_l2_per_field

    runs = {}
    for i, name in enumerate(UNETS):
        cfg = load_config([f"model_cfg={name}", "scheduler_cfg.params.warmup_iters=2"])
        model_cfg, data_cfg = cfg["model_cfg"], cfg["data_cfg"]
        train = (model_cfg, data_cfg, cfg["optim_cfg"], cfg["scheduler_cfg"])
        if cfg["optim_cfg"]["name"] != "lion" or data_cfg["input_fields"][:2] != [
                "dfun", "temperature"]:
            fail("the default composition is not Lion on (dfun, temperature, ...) fields")
        model = build_model(model_cfg, data_cfg)
        count = sum(p.numel() for p in model.parameters())
        weights = unet_state_dict(model, SEED + 80 + i)
        del model
        run = {"parameters": count}
        frame = UNET_WINDOW_FRAME[name]
        x = torch.from_numpy(np.random.default_rng(SEED + 90 + i).standard_normal(
            (1, TIME_WINDOW, FIELDS, frame, frame)).astype(np.float32))
        t0 = time.perf_counter()
        print(f"== phase 41: {name} ({count:,} parameters), one float32 window at {frame}^2, "
              f"card vs CPU (eval mode: running statistics)", flush=True)
        y_f32 = window_phase(name, model_cfg, data_cfg, weights, x, dev, {})
        run["window_s"] = time.perf_counter() - t0
        if frame != IMAGE:
            x = torch.from_numpy(np.random.default_rng(SEED + 90 + i).standard_normal(
                (1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)).astype(np.float32))
            y_f32 = None

        t0 = time.perf_counter()
        print(f"== phase 42: {name}, {WINDOWS}-window bfloat16 rollout at {IMAGE}^2, its heat "
              f"flux and its relative L2 against the float32 rollout", flush=True)
        f32 = build_model(model_cfg, data_cfg).eval().to(dev)
        f32.load_state_dict(weights)
        init = x.to(dev)
        want = make_rollout_fn(f32, WINDOWS)(init)
        del f32
        bf = build_model(model_cfg, data_cfg, compute_dtype="bfloat16").eval().to(dev)
        bf.load_state_dict(weights)

        def physics(preds, want=want, run=run, name=name):
            frames = preds[:, 0].reshape(-1, *preds.shape[3:])  # (windows * T, C, H, W)
            mean, peak = heatflux_torch(frames[:, 0], frames[:, 1], UNET_HEATER_TEMP)
            rel = relative_l2_per_field(frames.float(), want[:, 0].reshape(frames.shape))
            if not (torch.isfinite(mean) and torch.isfinite(peak) and torch.isfinite(rel).all()):
                fail(f"{name} rollout: non-finite heat flux or relative L2")
            run["heatflux"] = (mean.item(), peak.item())
            run["rel_l2_first_last"] = (rel[:TIME_WINDOW].mean().item(),
                                        rel[-TIME_WINDOW:].mean().item())
            print(f"  heat flux (channels 0 dfun, 1 temperature, heater {UNET_HEATER_TEMP}): "
                  f"mean {run['heatflux'][0]:.6g}, max {run['heatflux'][1]:.6g}; relative L2 of "
                  f"the bf16 rollout against the f32 one, per field {tuple(rel.shape)}: first "
                  f"window {run['rel_l2_first_last'][0]:.4f}, last "
                  f"{run['rel_l2_first_last'][1]:.4f}", flush=True)

        run["rollout_fps"] = rollout_phase(name, bf, init, WINDOWS, {}, card, reference=y_f32,
                                           on_preds=physics)
        del bf, want, y_f32
        run["rollout_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print(f"== phase 43: {name}, Trainer.fit bfloat16 batch {UNET_TRAIN_BATCH} at {IMAGE}^2, "
              f"Lion, {UNET_TRAIN_STEPS} steps after 1 warm-up step, BUBBLEFORMER_LOSS_KERNEL=1",
              flush=True)

        def resumed(module, log_dir, name=name):
            stats = running_stats(module.model)
            if name == "unet_classic":
                still = [k for k, v in stats.items() if torch.equal(
                    v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))]
                if not stats or still:
                    fail(f"{name}: running statistics did not move: {still[:4]}")
            fresh = module_class(model_cfg, data_cfg)(*train, total_steps=UNET_TRAIN_STEPS + 1,
                                                      compute_dtype="bfloat16", device=dev.type,
                                                      seed=SEED + 1)
            restore_checkpoint(str(log_dir / "last.pt"), fresh)
            state, own = fresh.model.state_dict(), module.model.state_dict()
            differ = [k for k in own if not torch.equal(state[k], own[k])]
            if fresh.step != module.step or differ:
                fail(f"{name}: resumed step {fresh.step} (want {module.step}), "
                     f"{len(differ)} tensors differ: {differ[:4]}")
            print(f"  last.pt resumed: step {fresh.step}, {len(own)} tensors equal, of which "
                  f"{len(stats)} running statistics", flush=True)

        with env_var("BUBBLEFORMER_LOSS_KERNEL", "1"):
            run.update(fit_phase(name, train, UNET_TRAIN_BATCH, UNET_TRAIN_STEPS, (IMAGE, IMAGE),
                                 {"plane_norms": 1, "plane_norms_bwd": 1},
                                 repo / "build" / f"smoke_{name}", dev, card,
                                 on_module=resumed))
        run["fit_s"] = time.perf_counter() - t0
        runs[name] = run
        torch.cuda.empty_cache()
    return runs


# Phases 44-46: ``bias_type``.  Phase 44 runs each model-path kernel once
# more at its training shape in bfloat16, forward and backward against its
# plain version (``KERNEL_RTOL``): with a table from a seeded
# ``ContinuousPositionBias1D`` (values in (0, 16), up to 16 added to the
# logits where the T5 tables of ``branch_args`` add N(0, 1)), and with no
# table, where the table gradient must come back None.  The shapes are those
# of the training paths that launch each kernel: K1 and K2 FiLMAViT-small's,
# K3 AViT-big's (12 heads), K4-K7 and K9 AViT-small's or FiLMAViT-small's
# (6 heads on 32x32 tokens, batch 8), K8 path F's temporal and axial lines.
TABLE_SHAPES = {"K1": (TRAIN_BATCH, TIME_WINDOW, 32, 32, 384),
                "K2": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 1152),
                "K3": (TRAIN_BATCH, TIME_WINDOW, 32, 32, 768),
                "K4": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 1152),
                "K5": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 384),
                "K6": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 6, 64),
                "K7": (TRAIN_BATCH * TIME_WINDOW, 32, 32, 6, 64),
                "K8 temporal": FLASH_SHAPES["temporal training"],
                "K8 axial": FLASH_SHAPES["axial training"],
                "K9": PX_SHAPES["training"]}
# The continuous MLP's draw: fc1 N(0, 2^2) with N(0, 1) biases and fc2
# N(0, 1.5^2 / 512), so its logits spread over about a unit either way and
# the tables over most of (0, 16), about 0.7 to 15.2 (the module's own init
# leaves them near 8, a constant that no softmax sees).
CPB_DRAW = {"fc1": 2.0, "fc2": 1.5}
# The kernels' activation arguments, cast to bfloat16 (the rest, parameters
# and tables, stay float32 as the layers pass them).
ACTIVATIONS = ("x", "xn", "qkv", "q", "k", "v")


def seeded_continuous_bias(heads: int, seed: int, dev):
    """A ``ContinuousPositionBias1D`` of ``heads`` on ``dev`` with weights
    drawn from ``seed`` (``CPB_DRAW``)."""
    import torch
    from bubbleformer_tpu_torch.layers.positional import ContinuousPositionBias1D

    rng = np.random.default_rng(seed)
    cpb = ContinuousPositionBias1D(heads)
    fc1, fc2 = cpb.cpb_mlp[0], cpb.cpb_mlp[2]
    with torch.no_grad():
        for p, scale in ((fc1.weight, CPB_DRAW["fc1"]), (fc1.bias, 1.0),
                         (fc2.weight, CPB_DRAW["fc2"] / fc2.weight.shape[1] ** 0.5)):
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
    return cpb.to(dev)


def table_kernel_args(key: str, rng, dev):
    """``(fwd, bwd, plain, bwd_plain, args, heads, tables, zero_noise)`` of a
    model-path kernel at ``TABLE_SHAPES[key]``: its entry points (the
    forward returning residuals for K1 and K5), float32 arguments in call
    order (the activation first), the heads keyword (None where the kernel
    takes none), each table argument's length, and whether the k-LayerNorm
    bias's gradient is held to the plain version's noise (K5 and K9, as
    phases 24 and 35 hold them)."""
    import torch
    from bubbleformer_tpu_torch.ops import axial_block_mega as k5
    from bubbleformer_tpu_torch.ops import axial_fused as k7
    from bubbleformer_tpu_torch.ops import axial_fused_block as k4
    from bubbleformer_tpu_torch.ops import axial_fused_packed as k6
    from bubbleformer_tpu_torch.ops import axial_lane as k2
    from bubbleformer_tpu_torch.ops import axial_lane_px as k9
    from bubbleformer_tpu_torch.ops import axial_pallas as k8
    from bubbleformer_tpu_torch.ops import temporal_block_mega as k13

    shape = TABLE_SHAPES[key]

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

    def scale(heads):
        return torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32))

    fns = {"K1": (k13.mega_temporal_block_fwd, k13.mega_temporal_block_bwd,
                  k13.temporal_branch_plain, k13.temporal_branch_bwd_plain),
           "K3": (k13.core_temporal_attention_fwd, k13.core_temporal_attention_bwd,
                  k13.core_temporal_plain, k13.core_temporal_bwd_plain),
           "K5": (k5.mega_axial_block_fwd, k5.mega_axial_block_bwd, k5.mega_axial_plain,
                  k5.mega_axial_bwd_plain),
           "K2": (k2.lane_axial_attention, k2.lane_axial_attention_bwd,
                  k2.axial_attention_plain, k2.axial_attention_bwd_plain),
           "K4": (k4.fused_block_attention, k4.fused_block_attention_bwd, k4.fused_block_plain,
                  k4.fused_block_bwd_plain),
           "K6": (k6.fused_axial_attention_packed, k6.fused_axial_attention_packed_bwd,
                  k6.fused_packed_plain, k6.fused_packed_bwd_plain),
           "K7": (k7.fused_axial_attention, k7.fused_axial_attention_bwd, k7.fused_plain,
                  k7.fused_bwd_plain),
           "K8": (k8.flash_packed_attention, k8.flash_packed_attention_bwd, k8.flash_plain,
                  k8.flash_bwd_plain),
           "K9": (k9.lane_px_attention, k9.lane_px_attention_bwd, k9.lane_px_plain,
                  k9.lane_px_bwd_plain)}[key[:2]]
    if key[:2] in ("K1", "K3", "K5"):
        heads = shape[-1] // 64
        args = branch_args(key[:2], shape, heads, rng)
        tables = ({"bias": shape[1]} if key[:2] != "K5" else
                  {"bias_x": shape[2], "bias_y": shape[1]})
    elif key[:2] in ("K2", "K4", "K9"):
        bt, h, w, c = shape
        heads = 6
        d = (c // 3 if key[:2] != "K9" else c) // heads
        first = (dict(qkv=n(*shape)) if key[:2] != "K9" else
                 dict(x=n(*shape), wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.1)))
        args = dict(first, qn_scale=n(d, scale=0.1, offset=1.0), qn_bias=n(d, scale=0.1),
                    kn_scale=n(d, scale=0.1, offset=1.0), kn_bias=n(d, scale=0.1),
                    bias_x=None, bias_y=None, scale_x=scale(heads), scale_y=scale(heads))
        tables = {"bias_x": w, "bias_y": h}
    elif key[:2] in ("K6", "K7"):
        bt, h, w, heads, d = shape
        args = dict(q=n(*shape), k=n(*shape), v=n(*shape), bias_x=None, bias_y=None,
                    scale_x=scale(heads), scale_y=scale(heads))
        tables, heads = {"bias_x": w, "bias_y": h}, None
    else:
        heads_, _, length, _ = shape
        args = dict(q=n(*shape), k=n(*shape), v=n(*shape), bias=None,
                    scale_factor=scale(heads_))
        tables, heads = {"bias": length}, None
    args = {k: None if v is None else v.to(dev) for k, v in args.items()}
    return (*fns, args, heads, tables, key[:2] in ("K5", "K9"))


def table_kernel_phase(dev) -> None:
    """Phase 44: every model-path kernel (``TABLE_SHAPES``) in bfloat16,
    forward and every gradient against its plain version (``KERNEL_RTOL``),
    with seeded continuous tables and with none (the table gradients None
    on both sides)."""
    import torch

    cpbs = {}  # one seeded MLP per head count
    for i, key in enumerate(TABLE_SHAPES):
        fwd, bwd, plain, bwd_plain, base, heads, tables, zero_noise = table_kernel_args(
            key, np.random.default_rng(SEED + 120 + i), dev)
        kw = {} if heads is None else {"heads": heads}
        acts = {k: base[k].to(torch.bfloat16) for k in ACTIVATIONS if k in base}
        table_heads = heads or next(v for k, v in base.items() if "scale" in k).shape[0]
        if table_heads not in cpbs:
            cpbs[table_heads] = seeded_continuous_bias(table_heads, SEED + 140 + table_heads, dev)
        with torch.no_grad():
            cont = {k: cpbs[table_heads](n, n) for k, n in tables.items()}
        for case, given in (("continuous", cont), ("none", dict.fromkeys(tables))):
            args = dict(base, **given, **acts)
            got = fwd(*args.values(), **kw)
            got, res = got if isinstance(got, tuple) else (got, None)
            kept = {} if res is None else {"residuals": res}
            ref = plain(**args, **kw)
            torch.cuda.synchronize()
            compare(f"{key} bfloat16 {case} tables {TABLE_SHAPES[key]}", got, ref,
                    KERNEL_RTOL["bfloat16"])
            do = torch.from_numpy(np.random.default_rng(SEED + 130 + i).standard_normal(
                tuple(got.shape)).astype(np.float32)).to(dev, torch.bfloat16)
            del got, ref
            got = bwd(do, *args.values(), **kw, **kept)
            ref = bwd_plain(do, **args, **kw)
            torch.cuda.synchronize()
            names = tuple(args)
            compare_grads(f"{key} bwd bfloat16 {case} tables", names, got, ref,
                          KERNEL_RTOL["bfloat16"], zero_noise=zero_noise)
            for t in tables:
                g, r = got[names.index(t)], ref[names.index(t)]
                if (g is None) != (case == "none") or (r is None) != (case == "none"):
                    fail(f"{key} {case} tables: the gradient of {t} is "
                         f"{'None' if g is None else 'a tensor'} (plain: "
                         f"{'None' if r is None else 'a tensor'})")
            if case == "continuous":
                lo = min(float(v.min()) for v in cont.values())
                hi = max(float(v.max()) for v in cont.values())
                print(f"  {key}: continuous tables in [{lo:.3f}, {hi:.3f}]", flush=True)
            del got, ref, do, res, kept, args
        del base, cont, acts



# Phase 45: the slice at full width.  A float32 window and a float32
# training step (batch 1, FiLM near identity) of FiLMAViT-small with
# ``bias_type=continuous``, the card's kernels against the plain route on the
# card: summation order alone, so the window is held to NEW_WINDOW_RTOL and
# each gradient to 1e-3 of its own largest magnitude (phase 9 reads each
# side within ~4e-5 of float64; a wrong table gradient would be O(1)).
SLICE_STEP_RTOL = {"loss": 1e-4, "grads": 1e-3}
SLICE_TRAIN_STEPS = 4
SLICE_PROFILE_STEPS = (1, 3)
REFERENCE_WINDOWS = 10
# The forward kernels of the default route's window (K1, K2), one a block.
DEFAULT_WINDOW = {"mega_temporal_block": 12, "lane_axial_attention": 12}


@contextlib.contextmanager
def without_module(name: str):
    """``import name`` fails inside (``sys.modules[name] = None``), whether
    or not the package is installed; as it was after."""
    saved = sys.modules.get(name)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def continuous_weights(weights, seed: int):
    """``weights`` with every ``cpb_mlp`` drawn as ``seeded_continuous_bias``
    draws it, so the tables spread over most of (0, 16)."""
    import torch

    rng = np.random.default_rng(seed)
    out = dict(weights)
    for name, p in weights.items():
        if ".cpb_mlp." in name:
            scale = {"0.weight": CPB_DRAW["fc1"], "0.bias": 1.0,
                     "2.weight": CPB_DRAW["fc2"] / p.shape[-1] ** 0.5}[name.split(".cpb_mlp.")[1]]
            out[name] = torch.from_numpy((scale * rng.standard_normal(p.shape))
                                         .astype(np.float32))
    return out


def continuous_slice_phase(repo: Path, dev, card: str) -> dict:
    """Phase 45: FiLMAViT-small at 512^2 with ``bias_type=continuous`` on the
    default route (K1, K2): a float32 window and a float32 training step's
    gradients (the ``cpb_mlp`` ones among them), card against the plain
    route on the card; ``Trainer.fit`` in bfloat16 at batch 8 under remat
    "dots" with ``transfer_dtype=bfloat16``, a profiler window whose trace
    must name K1's and K2's kernels, ``use_wandb`` with ``wandb`` kept from
    importing whether or not it is installed (no run may reach a network;
    the CSV must still be written) and the validation panels where
    ``matplotlib`` imports; a 20-window bfloat16 rollout."""
    import importlib.util

    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.data import synthetic_batch
    from bubbleformer_tpu_torch.models import build_model

    cfg = load_config(["model_cfg.params.bias_type=continuous",
                       "scheduler_cfg.params.warmup_iters=2"])
    model_cfg, data_cfg = cfg["model_cfg"], cfg["data_cfg"]
    train = (model_cfg, data_cfg, cfg["optim_cfg"], cfg["scheduler_cfg"])
    model = build_model(model_cfg, data_cfg)
    if model_cfg["name"] != "filmavit" or model.embed_dim != 384 or len(model.blocks) != 12:
        fail("the default composition's model is not FiLMAViT-small")
    weights = continuous_weights(film_near_identity(random_state_dict(model, SEED + 150),
                                                    SEED + 151), SEED + 152)
    mlp = [k for k in weights if ".cpb_mlp." in k]
    if len(mlp) != 3 * 2 * 12:
        fail(f"expected 72 cpb_mlp tensors, found {len(mlp)}")
    del model
    run = {}
    rng = np.random.default_rng(SEED + 153)
    x = torch.from_numpy(rng.standard_normal((1, TIME_WINDOW, FIELDS, IMAGE, IMAGE))
                         .astype(np.float32))
    cond = torch.tensor([FLUID_PARAMS], dtype=torch.float32)

    t0 = time.perf_counter()
    print(f"== phase 45: FiLMAViT-small bias_type=continuous at {IMAGE}^2: a float32 window "
          "and a training step's gradients, card vs the plain route on the card", flush=True)
    gpu = build_model(model_cfg, data_cfg).eval().to(dev)
    gpu.load_state_dict(weights)
    with torch.no_grad():
        zero_counters()
        y = gpu(x.to(dev), cond.to(dev))
        torch.cuda.synchronize()
        check_launches("continuous window", read_counters(),
                       with_dtype_paths(DEFAULT_WINDOW, "float32"), 1)
        with plain_attention():
            y_plain = gpu(x.to(dev), cond.to(dev))
    compare("continuous window f32 card vs plain route", y, y_plain, NEW_WINDOW_RTOL)
    del gpu, y_plain
    batch = synthetic_batch(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE, 9, seed=SEED + 154)
    loss, grads, secs = train_step_grads(train, weights, batch, dev.type, torch.float32)
    loss_p, grads_p, _ = train_step_grads(train, weights, batch, dev.type, torch.float32,
                                          plain=True)
    if abs(loss - loss_p) > SLICE_STEP_RTOL["loss"] * abs(loss_p):
        fail(f"continuous step: loss {loss} on the kernels, {loss_p} on the plain route")
    errs, zero = step_errors(grads_p, grads)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    mlp_err = max(errs[k] for k in mlp)
    if worst[0][1] > SLICE_STEP_RTOL["grads"] or any(not grads[k].any() for k in mlp):
        fail(f"continuous step gradients vs the plain route: worst {worst}, cpb_mlp {mlp_err}")
    print(f"  step {secs:.2f} s, loss {loss:.7f} (plain {loss_p:.7f}); gradients vs the plain "
          f"route: worst " + ", ".join(f"{n} {e:.2e}" for n, e in worst) + f"; the 72 cpb_mlp "
          f"gradients within {mlp_err:.2e} (tol {SLICE_STEP_RTOL['grads']:.0e}); {len(zero)} "
          "zero up to rounding", flush=True)
    del grads, grads_p
    run["window_step_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    installed = importlib.util.find_spec("wandb") is not None
    plot = importlib.util.find_spec("matplotlib") is not None
    print(f"== phase 45: Trainer.fit bfloat16 batch {TRAIN_BATCH}, {SLICE_TRAIN_STEPS} steps, "
          f"transfer_dtype=bfloat16, profiler window {SLICE_PROFILE_STEPS}, use_wandb=True with "
          f"wandb kept from importing (installed here: {installed}), plot_val_samples={plot} "
          f"(matplotlib {'imports' if plot else 'absent'})", flush=True)
    log_dir = repo / "build" / "smoke_continuous"
    trace_dir = log_dir / "trace"

    def inspect(module, log_dir):
        trace = trace_dir / "train_steps_{}-{}.pt.trace.json".format(*SLICE_PROFILE_STEPS)
        if not trace.exists():
            fail(f"no profiler trace at {trace}")
        text = trace.read_text()
        found = {k: text.count(k) for k in ("temporal_attention_kernel", "temporal_attention_bwd",
                                            "lane_fwd_kernel", "lane_bwd_")}
        steps = [s for s in range(SLICE_TRAIN_STEPS + 2) if f'"train_step {s}"' in text]
        if not all(found.values()) or steps != list(range(*SLICE_PROFILE_STEPS)):
            fail(f"the trace names kernels {found} and steps {steps}")
        panels = sorted(p.name for p in (log_dir / "val_epoch_0").glob("*.png")) if plot else []
        if plot and len(panels) != 6:
            fail(f"validation panels {panels}")
        print(f"  trace {trace.stat().st_size / 1e6:.1f} MB over steps {steps}: K1's and K2's "
              f"kernels named {found}; validation panels {panels or 'not asked for'}", flush=True)

    per_step = dict(dots_step(DEFAULT_WINDOW), mega_temporal_block_bwd=12,
                    lane_axial_attention_bwd=12)
    with without_module("wandb"):
        run.update(fit_phase(
            "FiLMAViT-small continuous", train, TRAIN_BATCH, SLICE_TRAIN_STEPS, (IMAGE, IMAGE),
            per_step, log_dir, dev, card, fluid=9, on_module=inspect,
            val_launches=DEFAULT_WINDOW,
            trainer_kw=dict(transfer_dtype="bfloat16", profile_dir=str(trace_dir),
                            profile_steps=SLICE_PROFILE_STEPS, use_wandb=True,
                            plot_val_samples=plot)))
    run["fit_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print(f"== phase 45: {WINDOWS}-window bfloat16 rollout, bias_type=continuous", flush=True)
    bf = build_model(model_cfg, data_cfg, compute_dtype="bfloat16").eval().to(dev)
    bf.load_state_dict(weights)
    run["rollout_fps"] = rollout_phase("FiLMAViT-small continuous", bf, x.to(dev), WINDOWS,
                                       DEFAULT_WINDOW, card, reference=y, cond=cond.to(dev))
    del bf, y
    run["rollout_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return run


def reference_ckpt_phase(repo: Path, dev, card: str) -> float:
    """Phase 46: a reference Lightning-style ``.ckpt`` of AViT-small at full
    width (seeded weights under ``model.``, ``hyper_parameters.
    normalization_constants``, ``global_step``) through
    ``scripts/convert_reference_checkpoint_torch.py`` in a subprocess, the
    result restored into a training module with every tensor, both constant
    tables and the step equal to what went in, then a bfloat16 rollout of
    ``REFERENCE_WINDOWS`` windows on the card.  Returns its seconds."""
    import torch
    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.training import module_class, restore_checkpoint

    t0 = time.perf_counter()
    print("== phase 46: a reference Lightning checkpoint of AViT-small converted, restored "
          f"and rolled out for {REFERENCE_WINDOWS} windows", flush=True)
    cfg = load_config(["model_cfg=avit_small"])
    model_cfg, data_cfg = cfg["model_cfg"], cfg["data_cfg"]
    weights = random_state_dict(build_model(model_cfg, data_cfg), SEED + 160)
    fields = data_cfg["output_fields"]
    norm = ({f: 0.125 * (i + 1) for i, f in enumerate(fields)},
            {f: 1.5 + i for i, f in enumerate(fields)})
    work = repo / "build" / "smoke_reference"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt, out = work / "avit_small.ckpt", work / "avit_small.pt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in weights.items()}, "global_step": 1234,
                "epoch": 3, "hyper_parameters": {"normalization_constants": norm, "lr": 5e-5}},
               ckpt)
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "convert_reference_checkpoint_torch.py"),
         "--ckpt", str(ckpt), "--patch-size", "16", "--blocks", "12", "--out", str(out)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"the converter exited {proc.returncode}: {proc.stderr[-2000:]}")
    print("  " + "\n  ".join(proc.stdout.strip().splitlines()), flush=True)
    module = module_class(model_cfg, data_cfg)(model_cfg, data_cfg, cfg["optim_cfg"],
                                               cfg["scheduler_cfg"], total_steps=1,
                                               compute_dtype="bfloat16", device=dev.type,
                                               seed=SEED + 161)
    restore_checkpoint(str(out), module)
    state = module.model.state_dict()
    differ = [k for k, v in weights.items() if not torch.equal(state[k].cpu(), v)]
    if differ or len(state) != len(weights) or module.step != 1234 or tuple(
            module.normalization_constants) != norm:
        fail(f"restored: {len(differ)} tensors differ ({differ[:4]}), step {module.step}, "
             f"constants {module.normalization_constants}")
    print(f"  restored {len(state)} tensors equal, step {module.step}, both constant tables "
          "equal", flush=True)
    x = torch.from_numpy(np.random.default_rng(SEED + 162).standard_normal(
        (1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)).astype(np.float32)).to(dev)
    rollout_phase("AViT-small reference checkpoint", module.model.eval(), x, REFERENCE_WINDOWS,
                  DEFAULT_WINDOW, card)
    del module
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


# Phases 47-49: the data path.  Trajectories written as ``.npy`` field
# caches with numpy alone (``scripts/make_sample_data_torch.py --format
# npy``: the card has no h5py), read through the native C/OpenMP batch
# assembler (``bubbleformer_tpu_torch/native/batch_assembler.c``, host code,
# no TPU kernel), trained on and rolled out.
DATA_TRAJ_FRAMES = 40
DATA_NORMS = ("none", "std", "minmax", "tanh")
DATA_FACTORS = (1, 2)
# Dataset indices of phase 47's batches: both files (26 windows each at
# start 5), one file's last and the other's first among them.
DATA_BATCH = (0, 7, 25, 26, 40, 51, 3, 30)
DATA_TRAIN_EPOCHS = 2  # 3 batches of 8 an epoch on sample_1's 26 windows
DATA_FIELDS = ["dfun", "temperature", "velx", "vely"]
# Phase 49 runs the gate cut to 3 epochs of 16 steps, which checks the path
# alone: the full gate (30 epochs) took 83 s of wall time at its default seed
# on the card (NVIDIA H100 80GB HBM3, 700.00 W), more than this phase's 60 s,
# and has a call of its own (scripts/physics_gate_torch.py, whose exit code
# asserts the tolerances).
GATE_EPOCHS = 3


def data_phase(repo: Path) -> dict:
    """Phase 47: the environment of the data path, caches-only datasets, and
    the native batches against the numpy path's, bit for bit."""
    import os

    from bubbleformer_tpu_torch.data import BubbleForecast, native

    print("== phase 47: the data path's environment, caches alone, native batches vs numpy",
          flush=True)
    t0 = time.perf_counter()
    compilers = {cc: shutil.which(cc) for cc in native.COMPILERS}
    if not native.available():
        fail(f"the native batch assembler does not build: {native.unavailable_reason()}")
    cc = next(c for c, where in compilers.items() if where)
    version = subprocess.run([cc, "--version"], capture_output=True, text=True).stdout
    print(f"  compilers {compilers}; {cc}: {version.splitlines()[0] if version else '?'}; "
          f"built {native.library_path().name} with {' '.join(native.CFLAGS)}", flush=True)
    try:
        import h5py  # noqa: F401

        print(f"  import h5py: imports ({h5py.__version__}); the caches are read with it hidden")
    except ImportError as exc:
        print(f"  import h5py: fails ({exc})")
    print(f"  numpy {np.__version__}, {os.cpu_count()} CPUs", flush=True)

    data_dir = repo / "build" / "chip_smoke_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    from scripts.make_sample_data_torch import main as make_samples

    make_samples(["--out", str(data_dir), "--n", "2", "--frames", str(DATA_TRAJ_FRAMES),
                  "--size", str(IMAGE), "--format", "npy"])
    files = [str(data_dir / f"sample_{i}.hdf5") for i in (1, 2)]
    ms = {}
    with without_module("h5py"):
        for factor in DATA_FACTORS:
            for norm in DATA_NORMS:
                ds = BubbleForecast(files, input_fields=DATA_FIELDS, output_fields=DATA_FIELDS,
                                    norm=norm, downsample_factor=factor,
                                    time_window=TIME_WINDOW, start_time=5,
                                    return_fluid_params=True)
                if not all(isinstance(f, dict) for f in ds.data) or len(ds) != 52:
                    fail(f"the caches-only dataset opened {[type(f) for f in ds.data]}, "
                         f"{len(ds)} windows")
                ds.normalize()
                t1 = time.perf_counter()
                ref = ds.get_batch(DATA_BATCH)
                t2 = time.perf_counter()
                if not ds.enable_native():
                    fail(f"enable_native: {native.unavailable_reason()}")
                got = ds.get_batch(DATA_BATCH)
                t3 = time.perf_counter()
                for name, a, b in zip(("input", "target", "fluid"), got, ref):
                    if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                        fail(f"native {name} batch (factor {factor}, norm {norm}) differs from "
                             f"the numpy path's: {a.dtype} {a.shape} vs {b.dtype} {b.shape}, "
                             f"max diff {np.abs(a.astype(np.float64) - b).max()}")
                ms[(factor, norm)] = (1000 * (t2 - t1), 1000 * (t3 - t2))
    numpy_ms, native_ms = ms[(1, "std")]
    print(f"  {len(ms)} cases (factors {DATA_FACTORS}, norms {DATA_NORMS}): native batches equal "
          f"the numpy path's bit for bit; one batch of {len(DATA_BATCH)} at {IMAGE}^2, std: "
          f"numpy {numpy_ms:.1f} ms, native {native_ms:.1f} ms (first calls, caches warm)",
          flush=True)
    return {"dir": data_dir, "numpy_ms": numpy_ms, "native_ms": native_ms,
            "seconds": time.perf_counter() - t0}


def files_fit_phase(repo: Path, data: dict, synthetic: dict, card: str) -> dict:
    """Phase 48: ``Trainer.fit`` of FiLMAViT-small from phase 47's caches
    through ``scripts/train_torch.py`` with the native loader; every loss
    finite, K1 and K2 launched as in phase 10, plus a validation window."""
    import io

    import torch

    from bubbleformer_tpu_torch.data import BubbleForecast, DataLoader
    from scripts.train_torch import main as train_main

    print(f"== phase 48: Trainer.fit from files, FiLMAViT-small, bf16, batch {TRAIN_BATCH} at "
          f"{IMAGE}^2, native loader, {DATA_TRAIN_EPOCHS} epochs", flush=True)
    t0 = time.perf_counter()
    log_dir = repo / "build" / "chip_smoke_files"
    shutil.rmtree(log_dir, ignore_errors=True)
    out = io.StringIO()
    zero_counters()
    with env_var("BUBBLEML_SAMPLES", str(data["dir"])), contextlib.redirect_stdout(out):
        trainer = train_main([
            "data_cfg=samples_smoke", "data_cfg.return_fluid_params=true", "native_loader=true",
            f"batch_size={TRAIN_BATCH}", f"max_epochs={DATA_TRAIN_EPOCHS}",
            "limit_val_batches=1", "scheduler_cfg.params.warmup_iters=2",
            f"log_dir={log_dir}", "device=cuda"])
    torch.cuda.synchronize()
    launches = read_counters()
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("native loader", "epoch", "3 train batches")):
            print(f"  train_torch.py: {line}")
    if "native loader: enabled" not in text:
        fail("train_torch.py did not enable the native loader")
    (metrics_csv,) = log_dir.glob("*/metrics.csv")
    rows = [r.split(",") for r in metrics_csv.read_text().splitlines()[1:]]
    losses = {split: [float(r[3]) for r in rows if r[2] == split] for split in ("train", "val")}
    print(f"  losses {losses}")
    if (len(losses["train"]) != DATA_TRAIN_EPOCHS or len(losses["val"]) != DATA_TRAIN_EPOCHS
            or not np.all(np.isfinite(losses["train"] + losses["val"]))):
        fail(f"expected {DATA_TRAIN_EPOCHS} finite train and validation losses, got {losses}")
    steps = DATA_TRAIN_EPOCHS * 3
    per_step = dict(dots_step(DEFAULT_WINDOW), mega_temporal_block_bwd=12,
                    lane_axial_attention_bwd=12)
    want = {k: per_step.get(k, 0) * steps + DEFAULT_WINDOW.get(k, 0) * DATA_TRAIN_EPOCHS
            for k in set(per_step) | set(DEFAULT_WINDOW)}
    check_launches("Trainer.fit from files", launches, with_dtype_paths(want, "bfloat16"), 1)
    seconds = trainer.last_epoch_seconds
    last_steps = 3
    run = {"ms_per_step": 1000 * seconds / last_steps,
           "samples_per_s": TRAIN_BATCH * last_steps / seconds, "launches": launches}
    del trainer
    # The loader alone on the same caches, as the trainer drives it.
    train_ds = BubbleForecast([str(data["dir"] / "sample_1.hdf5")], input_fields=DATA_FIELDS,
                              output_fields=DATA_FIELDS, norm="std", time_window=TIME_WINDOW,
                              start_time=5, return_fluid_params=True)
    train_ds.normalize()
    train_ds.enable_native()
    loader = DataLoader(train_ds, TRAIN_BATCH, shuffle=True, num_workers=8)
    t1 = time.perf_counter()
    n = sum(1 for _ in loader)
    run["loader_ms"] = 1000 * (time.perf_counter() - t1) / n
    print(f"  last epoch: {last_steps} steps in {seconds:.3f} s: {run['ms_per_step']:.1f} ms/step, "
          f"{run['samples_per_s']:.2f} samples/s from files (phase 10, synthetic batches: "
          f"{synthetic['ms_per_step']:.1f} ms/step, {synthetic['samples_per_s']:.2f} samples/s); "
          f"the loader alone {run['loader_ms']:.1f} ms/batch over an epoch of {n} batches "
          f"({card}); launches {launches}", flush=True)
    shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    run["seconds"] = time.perf_counter() - t0
    return run


def physics_gate_phase(repo: Path, card: str) -> dict:
    """Phase 49: the physics gate on the card (``scripts/physics_gate_torch.py``:
    AViT-tiny at 64x64 through ``auto``, K4 at head dim 16), cut to
    ``GATE_EPOCHS``: every key of its JSON there, every metric finite, K4
    launched as its steps, validation batches and rollouts ask and no other
    kernel."""
    import torch

    from scripts.physics_gate_torch import METRIC_KEYS
    from scripts.physics_gate_torch import main as gate_main

    print("== phase 49: the physics gate on the card (AViT-tiny, K4 at head dim 16)", flush=True)
    t0 = time.perf_counter()

    work = repo / "build" / "chip_smoke_gate"
    shutil.rmtree(work, ignore_errors=True)
    epochs, windows = GATE_EPOCHS, 10
    zero_counters()
    metrics = gate_main(["--workdir", str(work), "--out", str(work / "physics.json"),
                         "--epochs", str(epochs), "--windows", str(windows)])
    torch.cuda.synchronize()
    launches = read_counters()
    written = json.loads((work / "physics.json").read_text())
    missing = [k for k in METRIC_KEYS if k not in written]
    if missing:
        fail(f"the gate's JSON lacks {missing}")
    numbers = [v for k, v in written.items() if k.startswith(("rollout_", "eikonal", "vapor",
                                                             "heatflux"))]
    flat = [x for v in numbers for x in (v if isinstance(v, list) else [v])]
    if not all(x is not None and np.isfinite(x) for x in flat):
        fail(f"non-finite gate metrics: {written}")
    # 66 windows of 5 at start 5 in each 80-frame file: 16 batches of 4 an
    # epoch, 2 validation batches; two 10-window float32 rollouts.
    steps = epochs * 16
    blocks = 4
    want = {"fused_block_attention": blocks * (steps + 2 * epochs + 2 * windows),
            "fused_block_attention_bwd": blocks * steps}
    want = dict(with_dtype_paths(want, "bfloat16"),
                fused_block_hopper_fwd=blocks * (steps + 2 * epochs),
                fused_block_line_fwd=blocks * 2 * windows)
    check_launches("the physics gate", launches, want, 1)
    if (written["train_steps"], written["train_batches_per_epoch"]) != (steps, 16):
        fail(f"the gate ran {written['train_steps']} steps, "
             f"{written['train_batches_per_epoch']} an epoch; want {steps}, 16")
    seconds = time.perf_counter() - t0
    print(f"  the gate cut to {epochs} epochs of 16 steps in "
          f"{seconds:.1f} s (training {metrics['train_seconds']:.1f} s, rollouts "
          f"{metrics['rollout_seconds']:.2f} s; {card}): rel-L2 final "
          f"{metrics['rollout_rel_l2_final']:.4f}, mean {metrics['rollout_rel_l2_mean']:.4f} vs "
          f"untrained {metrics['rollout_rel_l2_untrained_mean']:.4f}, eikonal "
          f"{metrics['eikonal_residual_mean']:.4f}, drift {metrics['vapor_fraction_drift']:.5f}, "
          f"heat flux {metrics['heatflux_pred_mean']:.2f} vs sim "
          f"{metrics['heatflux_sim_mean']:.2f}, KL {metrics['heatflux_kl_sim_vs_model']}; "
          f"its tolerances' failures (a cut run's) {metrics['failures']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"seconds": seconds, "launches": launches}


# Data parallelism (phases 50-53): FiLMAViT-small at full width through K1
# and K2, ClassicUnet through K10, each across two processes on the one card
# over gloo (NCCL refuses two ranks on one GPU) against one process at the
# global batch; a one-rank NCCL world against the same steps without DDP;
# the training CLI under torchrun.
DP_RANKS = 2
DP_BATCH = 8  # the global batch: DP_BATCH // DP_RANKS a rank
DP_STEPS = 3
DP_TIMEOUT_S = 420
DP_KINDS = ("filmavit", "unet")
# The default path's kernel launches a training step under remat "dots".
DP_PER_STEP = {"mega_temporal_block": 12 * DOTS_RERUN["mega_temporal_block"],
               "mega_temporal_block_bwd": 12, "lane_axial_attention": 12,
               "lane_axial_attention_bwd": 12}
# Two ranks against one process at the global batch.  The first step in
# float32: each gradient within KERNEL_RTOL["float32"] of its largest (the
# batch's sums split in two and added by the all-reduce: reassociation; one
# zero up to rounding against a hundredth of the largest of all).  Then
# DP_STEPS bf16 Lion steps: the losses within KERNEL_RTOL["bfloat16"]; a
# Lion update is lr * sign(.), and bf16 roundings flip where reassociated
# sums straddle a boundary, so a sign can flip where its argument is near
# zero: every parameter within 2 lr a step of one process's.  How many flip
# is held to a witness: the same process taking each batch as the ranks'
# two halves, their gradients accumulated (what DDP computes), whose share
# of elements apart from the one pass bounds the ranks' (DP_WITNESS times
# it, plus DP_FLIP_FLOOR); the ranks against that accumulation, within
# DP_FLIP_FLOOR (the same sums, but for float atomics' order: the T5
# table's gradient; 0 of 28.9M elements read apart on the card), and their
# losses within 1e-6.  (A fixed 1% limit, from a tiny model's CPU run,
# failed: 1.71% of FiLMAViT-small's elements differ from the one pass on
# the card, as the witness's do.)  ClassicUnet in float32: its output within
# KERNEL_RTOL["float32"]; its gradients against the same step in float64,
# within 3x the one process's own error (``dp_compare_grads_64``: a
# convolution's weight gradient before a BatchNorm sums terms whose
# per-rank parts cancel over the global batch: on the card the one
# process's own float32 gradient lies 7.1e-3 from float64 there, the
# ranks' 8.3e-3, so no fixed float32 bound holds it); the running
# statistics within DP_STATS_RTOL of their largest (one BatchNorm over the
# global batch against two halves summed).
DP_WITNESS = 3.0
DP_FLIP_FLOOR = 1e-3
DP_STATS_RTOL = 1e-5
# What only the leader of a world writes (every rank's parameters are the
# leader's, as each step checks).
DP_LEADER_ONLY = ("f32_grads", "params", "grads", "stats")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_cfgs(kind: str):
    """The training configs of a DP phase: FiLMAViT-small (the default
    composition) or ClassicUnet on ``singlebubble``'s 4 fields, Lion with a
    2-step warmup."""
    from bubbleformer_tpu_torch.config import load_config

    extra = ["model_cfg=unet_classic"] if kind == "unet" else []
    cfg = load_config(extra + ["scheduler_cfg.params.warmup_iters=2"])
    return (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])


def dp_batches(kind: str, n: int, rows: slice, dev):
    """``n`` global synthetic batches of DP_BATCH windows at 512^2, the
    process's ``rows`` of each, on ``dev``."""
    import torch

    fluid = None if kind == "unet" else 9
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
                  for a in cached_batch(DP_BATCH, TIME_WINDOW, FIELDS, IMAGE, IMAGE, fluid,
                                        SEED + 60 + i)) for i in range(n)]


def dp_run(kind: str, out_dir: Path) -> dict:
    """One process's part of a DP phase, in a world of two or alone (the
    reference at the global batch); writes its results to ``out_dir`` and
    returns them.  ``filmavit``: one float32 step's gradients, then
    DP_STEPS bf16 Lion steps (losses, the launches, parameters, and in a
    world whether every rank holds the leader's parameters bit for bit after
    each step).  ``unet``: ClassicUnet's float32 forward and backward in
    train mode through K10 (output, gradients, running statistics)."""
    import torch
    import torch.distributed as dist
    from bubbleformer_tpu_torch.parallel import batch_sharding, host_mean, make_mesh
    from bubbleformer_tpu_torch.training import module_class

    mesh = make_mesh(device="cuda")
    dev = mesh.device
    rows = batch_sharding(mesh, DP_BATCH)
    out = {"rank": mesh.rank, "world": mesh.data}

    def module(dtype):
        cfgs = dp_cfgs(kind)
        return module_class(*cfgs[:2])(*cfgs, total_steps=DP_STEPS + 1, compute_dtype=dtype,
                                       seed=SEED, mesh=mesh)

    def same_on_every_rank(model) -> bool:
        flat = torch.cat([t.detach().flatten().float() for t in
                          (*model.parameters(), *model.buffers())])
        if mesh.data == 1:
            return True
        leader = flat.clone()
        dist.broadcast(leader, src=0)
        return torch.equal(flat, leader)

    if kind == "filmavit":
        m = module(None)
        # O(1) weights, FiLM near identity, as every float32 step here draws
        # them: the seeded init's FiLM can put the next InstanceNorms' float32
        # statistics in cancellation, which no two summation orders share.
        m.model.load_state_dict(film_near_identity(random_state_dict(m.model, SEED + 70),
                                                   SEED + 70))
        out["ddp"] = type(m.train_model).__name__
        batch = dp_batches(kind, 1, rows, dev)[0]
        m.train_model.train()
        pred = m.train_model(*m.inputs(batch), generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
        loss = m._loss(pred, m.target(batch))
        loss.backward()
        out["f32_loss"] = host_mean(float(loss.detach()))
        out["f32_grads"] = {n: p.grad.cpu() for n, p in m.model.named_parameters()}
        del m, pred, loss
        m = module("bfloat16")
        batches = dp_batches(kind, DP_STEPS, rows, dev)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, equal = [], []
        for i, b in enumerate(batches):
            metrics = m.train_step(b, torch.Generator(device=dev).manual_seed(SEED + i))
            losses.append(host_mean(float(metrics["loss"])))
            equal.append(same_on_every_rank(m.model))
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=read_counters(), losses=losses,
                   equal=equal, lr_sum=sum(m.schedule(i) for i in range(DP_STEPS)),
                   params={n: p.detach().cpu() for n, p in m.model.named_parameters()})
        if mesh.data == 1:  # the witness: the same steps, each batch as the ranks' halves
            m = module("bfloat16")
            out["halves"] = [accumulated_step(m, b, SEED + i) for i, b in enumerate(batches)]
            out["halves_params"] = {n: p.detach().cpu() for n, p in m.model.named_parameters()}
    else:
        m = module(None)
        out["ddp"] = type(m.train_model).__name__
        inp, tgt = dp_batches(kind, 1, rows, dev)[0]
        zero_counters()
        t0 = time.perf_counter()
        m.train_model.train()
        pred = m.train_model(inp)
        with env_var("BUBBLEFORMER_LOSS_KERNEL", "1"):
            m._loss(pred, tgt).backward()
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=read_counters(), pred=pred.cpu(),
                   grads={n: p.grad.cpu() for n, p in m.model.named_parameters()},
                   stats={k: v.cpu() for k, v in m.model.state_dict().items() if "running" in k},
                   equal=[same_on_every_rank(m.model)])
        if mesh.data == 1:  # the witness: the same step in float64 (LpLoss: K10 is float32)
            m = module(None)
            m.model.double().train()
            m._loss(m.model(inp.double()), tgt.double()).backward()
            out["grads64"] = {n: p.grad.cpu() for n, p in m.model.named_parameters()}
    if mesh.data > 1:  # the leader's tensors; every rank's output (ClassicUnet's rows)
        keep = DP_LEADER_ONLY if mesh.rank else ()
        torch.save({k: v for k, v in out.items() if k not in keep},
                   out_dir / f"{kind}_{mesh.rank}.pt")
    return out


def accumulated_step(m, batch, seed: int) -> float:
    """One training step of module ``m`` (one process) on ``batch`` taken as
    DP_RANKS shares in turn, each share's gradient divided by DP_RANKS and
    accumulated, its drop-path masks its rows of the global batch's: what
    DDP computes across DP_RANKS ranks, in one process.  Returns the loss."""
    import torch

    lr = m.schedule(m.step)
    for group in m.optimizer.param_groups:
        group["lr"] = lr
    m.model.train()
    m.optimizer.zero_grad(set_to_none=True)
    local, loss = batch[0].shape[0] // DP_RANKS, 0.0
    for r in range(DP_RANKS):
        part = tuple(t[r * local:(r + 1) * local] for t in batch)
        m.model.batch_shard = (r, DP_RANKS)
        pred = m.model(*m.inputs(part), generator=torch.Generator(device=part[0].device)
                       .manual_seed(seed))
        share = m._loss(pred, m.target(part)) / DP_RANKS
        share.backward()
        loss += float(share.detach())
    m.model.batch_shard = (0, 1)
    m.optimizer.step()
    m.step += 1
    return loss


def dp_worker(out_dir: str) -> None:
    """A rank of phases 51-52 (``chip_smoke.py --dp-worker``): the world from
    torchrun's variables the parent set, over gloo; both phases' runs."""
    import torch

    from bubbleformer_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo")
    for kind in DP_KINDS:
        out = dp_run(kind, Path(out_dir))
        launched = {k: v for k, v in out["launches"].items() if v}
        print(f"rank {out['rank']} of {out['world']} {kind}: {out['ddp']}, "
              f"{out['seconds']:.2f} s, launches {launched}", flush=True)
    torch.distributed.destroy_process_group()


def dp_launch(out_dir: Path) -> float:
    """Start DP_RANKS workers on the card with torchrun's variables and wait
    for them (each stopped at DP_TIMEOUT_S); fails unless every rank exits
    0.  Returns the seconds."""
    import os

    port = str(_free_port())
    t0 = time.perf_counter()
    procs = []
    for rank in range(DP_RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-worker", str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            left = max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        outs.append("(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, p in enumerate(procs):
        text = outs[rank] if rank < len(outs) else "(no output)"
        print("\n".join(f"  [rank {rank}] {line}" for line in text.splitlines()[-12:]))
        if p.returncode != 0:
            fail(f"DP rank {rank} exited {p.returncode}")
    return time.perf_counter() - t0


def dp_compare_grads(name: str, got: dict, ref: dict) -> float:
    """Each float32 gradient within KERNEL_RTOL["float32"] of its
    reference's largest, those zero up to rounding (``step_errors``) of a
    hundredth of the largest of all."""
    errors, zero = step_errors({n: g.double() for n, g in ref.items()},
                               {n: g.double() for n, g in got.items()})
    worst = max(errors, key=errors.get)
    print(f"  {name}: {len(errors)} gradients, worst {worst} {errors[worst]:.2e} (tol "
          f"{KERNEL_RTOL['float32']:.0e}; {len(zero)} zero up to rounding)", flush=True)
    if errors[worst] > KERNEL_RTOL["float32"]:
        fail(f"{name}: {worst} at {errors[worst]:.3e}")
    return errors[worst]


def dp_compare_grads_64(name: str, got: dict, one: dict, ref64: dict) -> None:
    """Float32 gradients of the ranks and of one process against the same
    step in float64 (``step_errors``): the ranks' worst within
    ``STEP_RTOL["vs_witness"]`` times the one process's own, plus
    ``STEP_RTOL["abs"]``, as phase 9 holds the card's step."""
    errors = {side: step_errors(ref64, {n: g.double() for n, g in grads.items()})[0]
              for side, grads in (("ranks", got), ("one process", one))}
    worst = {side: max(e, key=e.get) for side, e in errors.items()}
    ranks, one = (errors[side][worst[side]] for side in ("ranks", "one process"))
    limit = STEP_RTOL["vs_witness"] * one + STEP_RTOL["abs"]
    print(f"  {name} vs float64: 2 ranks {worst['ranks']} {ranks:.2e}, 1 process "
          f"{worst['one process']} {one:.2e} (limit {limit:.2e})", flush=True)
    if ranks > limit:
        fail(f"{name}: the ranks' {worst['ranks']} at {ranks:.3e}")


def dp_compare_lion(name: str, got: dict, ref: dict, lr_sum: float,
                    limit: float = 1.0) -> float:
    """Parameters after Lion steps whose learning rates sum to ``lr_sum``:
    each element within ``2 lr_sum`` of the reference's (a flipped sign), and
    at most the share ``limit`` of all elements apart.  Returns the share."""
    import torch

    apart = total = 0
    worst = 0.0
    for n, r in ref.items():
        d = (got[n].float() - r.float()).abs()
        worst = max(worst, float(d.max()))
        apart += int((d > 1e-3 * lr_sum).sum())
        total += d.numel()
    share = apart / total
    print(f"  {name}: {apart} of {total} elements apart ({share:.2e}, limit {limit:.2e}), the "
          f"largest by {worst:.3e} (limit 2 lr = {2 * lr_sum:.3e})", flush=True)
    if worst > 2 * lr_sum * (1 + 1e-3) or share > limit or not torch.isfinite(
            torch.tensor(worst)):
        fail(f"{name}: apart by {worst:.3e} in {share:.2e} of the elements")
    return share


def dp_compare_params(name: str, got: dict, ref: dict, rtol: float) -> float:
    """Each tensor of ``got`` within ``rtol`` of its reference's largest."""
    names = list(ref)
    return compare_grads(name, names, [got[n] for n in names], [ref[n] for n in names], rtol)


def dp_one_rank_phase(card: str) -> dict:
    """Phase 50: a one-rank NCCL world in this process: DP_STEPS bf16 Lion
    steps of FiLMAViT-small at batch DP_BATCH through DDP, then the same
    steps without it from the same seeded weights and batches; losses and
    every parameter bit for bit, K1's and K2's launches those of DP_STEPS
    steps.  Returns the launches and seconds."""
    import warnings

    import torch
    import torch.distributed as dist
    from bubbleformer_tpu_torch.training import module_class

    print(f"== phase 50: a one-rank NCCL world, FiLMAViT-small bf16 batch {DP_BATCH}, "
          f"{DP_STEPS} Lion steps with and without DDP", flush=True)
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    runs = {}
    try:
        cfgs = dp_cfgs("filmavit")
        batches = dp_batches("filmavit", DP_STEPS, slice(None), dev)
        for ddp in (True, False):
            module = module_class(*cfgs[:2])(*cfgs, total_steps=DP_STEPS + 1,
                                             compute_dtype="bfloat16", device="cuda:0",
                                             seed=SEED, ddp=ddp)
            if (type(module.train_model).__name__ == "DistributedDataParallel") != ddp:
                fail(f"ddp={ddp} trained {type(module.train_model).__name__}")
            zero_counters()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                losses = [float(module.train_step(b, torch.Generator(device=dev)
                                                  .manual_seed(SEED + i))["loss"])
                          for i, b in enumerate(batches)]
            torch.cuda.synchronize()
            runs[ddp] = dict(losses=losses, seconds=time.perf_counter() - t1,
                             launches=read_counters(),
                             params={n: p.detach().clone()
                                     for n, p in module.model.named_parameters()},
                             warnings=[str(w.message) for w in caught])
            del module
    finally:
        dist.destroy_process_group()
    with_ddp, without = runs[True], runs[False]
    if any("bucket view" in w for w in with_ddp["warnings"]):
        fail(f"DDP copied gradients to its buckets: {with_ddp['warnings']}")
    check_launches("the one-rank DDP steps", with_ddp["launches"],
                   with_dtype_paths(DP_PER_STEP, "bfloat16"), DP_STEPS)
    if with_ddp["losses"] != without["losses"] or not np.all(np.isfinite(with_ddp["losses"])):
        fail(f"DDP losses {with_ddp['losses']} against {without['losses']} without")
    differ = [n for n, p in with_ddp["params"].items() if not torch.equal(p, without["params"][n])]
    if differ:
        fail(f"{len(differ)} parameters differ with DDP on one rank: {differ[:5]}")
    seconds = time.perf_counter() - t0
    print(f"  losses {with_ddp['losses']} both; all {len(without['params'])} parameters bit for "
          f"bit; DDP {1000 * with_ddp['seconds'] / DP_STEPS:.1f} ms/step, without "
          f"{1000 * without['seconds'] / DP_STEPS:.1f} ms/step (the first run pays the "
          f"allocations; {card}); warnings {with_ddp['warnings'] or 'none'}; phase 50 took "
          f"{seconds:.1f} s", flush=True)
    return {"launches": with_ddp["launches"], "seconds": seconds}


def dp_two_rank_phases(repo: Path, card: str) -> list:
    """Phases 51 (FiLMAViT-small) and 52 (ClassicUnet): DP_RANKS processes on
    the one card over gloo, each at DP_BATCH // DP_RANKS, one world running
    both, against this process at DP_BATCH (tolerances above).  Returns each
    phase's launches (summed over the ranks) and the seconds of both."""
    import torch

    print(f"== phase 51: {DP_RANKS} ranks on one card over gloo at batch "
          f"{DP_BATCH // DP_RANKS} each against one process at {DP_BATCH}: FiLMAViT-small, K1 + "
          f"K2, a float32 step then {DP_STEPS} bf16 Lion steps", flush=True)
    print(f"== phase 52: the same world, ClassicUnet's float32 forward and backward through "
          f"K10 with global BatchNorm statistics", flush=True)
    t0 = time.perf_counter()
    out_dir = repo / "build" / "chip_smoke_dp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    refs = {kind: dp_run(kind, out_dir) for kind in DP_KINDS}
    torch.cuda.empty_cache()
    ranks_s = dp_launch(out_dir)
    got = {kind: [torch.load(out_dir / f"{kind}_{r}.pt", weights_only=False)
                  for r in range(DP_RANKS)] for kind in DP_KINDS}
    for kind, ranks in got.items():
        if ranks[0]["ddp"] != "DistributedDataParallel" or refs[kind]["ddp"] == ranks[0]["ddp"]:
            fail(f"the ranks trained {ranks[0]['ddp']}, the one process {refs[kind]['ddp']}")
        if not all(all(r["equal"]) for r in ranks):
            fail(f"the ranks' {kind} parameters differ bit for bit: {[r['equal'] for r in ranks]}")

    ref, ranks = refs["filmavit"], got["filmavit"]
    lead = ranks[0]
    for r in ranks:
        check_launches(f"rank {r['rank']}'s DP steps", r["launches"],
                       with_dtype_paths(DP_PER_STEP, "bfloat16"), DP_STEPS)
    dp_compare_grads("DP float32 step, 2 ranks vs 1 process", lead["f32_grads"],
                     ref["f32_grads"])
    rel = abs(lead["f32_loss"] - ref["f32_loss"]) / abs(ref["f32_loss"])
    losses = np.array(lead["losses"])
    loss_rel = float(np.abs(losses - ref["losses"]).max() / np.abs(ref["losses"]).max())
    print(f"  float32 loss {lead['f32_loss']:.6f} vs {ref['f32_loss']:.6f} (rel {rel:.1e}); "
          f"bf16 losses {lead['losses']} vs {ref['losses']} (rel {loss_rel:.1e})")
    if rel > KERNEL_RTOL["float32"] or loss_rel > KERNEL_RTOL["bfloat16"]:
        fail("the DP losses disagree with one process's")
    witness = dp_compare_lion("the halves' accumulation vs the one pass (the witness)",
                              ref["halves_params"], ref["params"], ref["lr_sum"])
    dp_compare_lion(f"DP {DP_STEPS} bf16 Lion steps' parameters, 2 ranks vs 1 process",
                    lead["params"], ref["params"], ref["lr_sum"],
                    DP_WITNESS * witness + DP_FLIP_FLOOR)
    dp_compare_lion(f"DP {DP_STEPS} bf16 Lion steps' parameters, 2 ranks vs the halves' "
                    "accumulation", lead["params"], ref["halves_params"], ref["lr_sum"],
                    DP_FLIP_FLOOR)
    if np.abs(np.array(ref["halves"]) - lead["losses"]).max() > 1e-6 * np.abs(lead["losses"]).max():
        fail(f"DP losses {lead['losses']} against the halves' accumulation {ref['halves']}")
    print(f"  bf16 steps: one process {1000 * ref['seconds'] / DP_STEPS:.1f} ms/step, a rank "
          f"{1000 * max(r['seconds'] for r in ranks) / DP_STEPS:.1f} ms/step (gloo's all-reduce "
          f"through the host; {card})", flush=True)

    ref, ranks = refs["unet"], got["unet"]
    lead = ranks[0]
    for r in ranks:
        check_launches(f"rank {r['rank']}'s ClassicUnet step", r["launches"],
                       {"plane_norms": 1, "plane_norms_bwd": 1}, 1)
        local = DP_BATCH // DP_RANKS
        rows = slice(r["rank"] * local, (r["rank"] + 1) * local)
        compare(f"ClassicUnet output, rank {r['rank']} vs its rows of one process",
                r["pred"], ref["pred"][rows], KERNEL_RTOL["float32"])
    dp_compare_grads_64("ClassicUnet gradients", lead["grads"], ref["grads"], ref["grads64"])
    dp_compare_params("ClassicUnet running statistics, 2 ranks vs 1 process",
                      lead["stats"], ref["stats"], DP_STATS_RTOL)
    shutil.rmtree(out_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  the ranks' processes {ranks_s:.1f} s (start-up included; {card}); phases 51-52 "
          f"took {seconds:.1f} s", flush=True)
    return [{"launches": {k: sum(r["launches"][k] for r in got[kind])
                          for k in got[kind][0]["launches"]}, "seconds": seconds}
            for kind in DP_KINDS]


def dp_cli_phase(repo: Path, card: str) -> float:
    """Phase 53: ``scripts/train_torch.py`` under ``torch.distributed.run``
    (one process, ``mesh_cfg=single``) on synthetic batches: its world line,
    and ``last.pt`` and ``metrics.csv`` written once, by the leader."""
    print("== phase 53: the training CLI under torch.distributed.run, mesh_cfg=single",
          flush=True)
    t0 = time.perf_counter()
    log_dir = repo / "build" / "chip_smoke_torchrun"
    shutil.rmtree(log_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "scripts/train_torch.py", "synthetic_batches=3", "limit_train_batches=3",
           "scheduler_cfg.params.warmup_iters=2", "mesh_cfg=single", f"log_dir={log_dir}"]
    try:
        res = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("the torchrun CLI did not finish in 300 s")
    lines = res.stdout.splitlines()
    world = [line for line in lines if line.startswith("process ")]
    print("\n".join(f"  {line}" for line in world + lines[-3:]))
    if res.returncode != 0:
        print(res.stderr[-3000:])
        fail(f"the torchrun CLI exited {res.returncode}")
    written = sorted(p.relative_to(log_dir).as_posix() for p in log_dir.rglob("*")
                     if p.name in ("last.pt", "metrics.csv"))
    want = ["filmavit_singlebubble_saturated_local/last.pt",
            "filmavit_singlebubble_saturated_local/metrics.csv"]
    if len(world) != 1 or not world[0].startswith("process 0/1:") or written != want:
        fail(f"the torchrun CLI printed {world} and wrote {written}")
    shutil.rmtree(log_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  {written} written by the leader; phase 53 took {seconds:.1f} s ({card})",
          flush=True)
    return seconds


def main() -> None:
    t_run = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    repo = Path(__file__).resolve().parent
    if not (repo / "bubbleformer_tpu_torch" / "csrc").is_dir():
        fail(f"bubbleformer_tpu_torch/ is not beside {Path(__file__).name}: run it from the repo")
    sys.path.insert(0, str(repo))
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phases 51-52, started below
        dp_worker(sys.argv[2])
        return

    from bubbleformer_tpu_torch import _build
    from bubbleformer_tpu_torch.config import FILM_AVIT_SMALL, load_config
    from bubbleformer_tpu_torch.data import SyntheticLoader, synthetic_batch
    from bubbleformer_tpu_torch.inference import make_rollout_fn
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.ops.axial_lane import (
        axial_attention_bwd_plain,
        axial_attention_plain,
        lane_axial_attention,
        lane_axial_attention_bwd,
        lane_hopper_bwd,
        lane_hopper_fwd,
        lane_line_bwd,
        lane_line_fwd,
    )
    from bubbleformer_tpu_torch.ops.temporal_block_mega import (
        CORE_PARAM_NAMES,
        PARAM_NAMES,
        core_temporal_attention,
        core_temporal_attention_bwd,
        core_temporal_bwd_plain,
        core_temporal_plain,
        mega_temporal_block,
        mega_temporal_block_bwd,
        mega_temporal_block_fwd,
        temporal_branch_bwd_plain,
        temporal_branch_plain,
    )
    from bubbleformer_tpu_torch.training import (
        ConditionedForecastModule,
        Trainer,
        module_class,
        restore_checkpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    print("== phase 1: environment", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}  count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else f"{kind}, unknown"
    print(f"  nvidia-smi: {card}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    heads, c, grid, t = 6, 384, IMAGE // 16, TIME_WINDOW
    d = c // heads
    results = {}

    # Each kernel at the shapes its paths give it: the rollout's (batch 1)
    # and the training step's (batch 8).  The training inputs come from a
    # generator of their own, so the rollout phases draw what they always drew.
    shapes = {"K1": {"rollout": (1, t, grid, grid, c), "training": (TRAIN_BATCH, t, grid, grid, c)},
              "K2": {"rollout": (t, grid, grid, 3 * c),
                     "training": (TRAIN_BATCH * t, grid, grid, 3 * c)}}
    rng_train = np.random.default_rng(SEED + 1)

    def randn_train(*shape):
        return torch.from_numpy(rng_train.standard_normal(shape).astype(np.float32))

    print(f"== phase 3: K1 mega_temporal_block vs plain, x {shapes['K1']['rollout']} and "
          f"{shapes['K1']['training']}", flush=True)
    k1 = dict(
        x=randn(1, t, grid, grid, c), in1_scale=randn(c, scale=0.1, offset=1.0),
        in1_bias=randn(c, scale=0.1), wqkv=randn(3 * c, c, scale=c**-0.5),
        bqkv=randn(3 * c, scale=0.1), qn_scale=randn(d, scale=0.1, offset=1.0),
        qn_bias=randn(d, scale=0.1), kn_scale=randn(d, scale=0.1, offset=1.0),
        kn_bias=randn(d, scale=0.1), in2_scale=randn(c, scale=0.1, offset=1.0),
        in2_bias=randn(c, scale=0.1), wout=randn(c, c, scale=c**-0.5),
        bout=randn(c, scale=0.1), bias=randn(heads, t, t),
        scale_factor=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    k1 = {k: v.to(dev) for k, v in k1.items()}
    k1_x = {"rollout": k1.pop("x"), "training": randn_train(*shapes["K1"]["training"]).to(dev)}
    for where, x in k1_x.items():
        for dt in (torch.float32, torch.bfloat16):
            args = dict(x=x.to(dt), **k1)
            got = mega_temporal_block(**args, heads=heads)
            ref = temporal_branch_plain(**args, heads=heads)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            err = compare(f"K1 {name} {where}", got, ref, KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: mega_temporal_block(**args, heads=heads))
            plain_ms = ref_ms(lambda: temporal_branch_plain(**args, heads=heads))
            gemm = k1_gemm_ms(args["x"], k1["wqkv"].to(dt), k1["wout"].to(dt))
            print(f"  K1 {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; cuBLAS's two "
                  f"products alone (partial yardstick) {gemm:.4f} ms", flush=True)
            results[("K1", name, where)] = (err, ms, plain_ms)
            results[("K1 gemm", name, where)] = gemm

    print(f"== phase 4: K2 lane_axial_attention vs plain, qkv {shapes['K2']['rollout']} and "
          f"{shapes['K2']['training']}", flush=True)
    k2 = dict(
        qkv=randn(t, grid, grid, 3 * c), qn_scale=k1["qn_scale"].cpu(),
        qn_bias=k1["qn_bias"].cpu(), kn_scale=k1["kn_scale"].cpu(), kn_bias=k1["kn_bias"].cpu(),
        bias_x=randn(heads, grid, grid), bias_y=randn(heads, grid, grid),
        scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
        scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    k2 = {k: v.to(dev) for k, v in k2.items()}
    k2_qkv = {"rollout": k2.pop("qkv"), "training": randn_train(*shapes["K2"]["training"]).to(dev)}
    for where, qkv in k2_qkv.items():
        for dt in (torch.float32, torch.bfloat16):
            args = dict(qkv=qkv.to(dt), **k2)
            got = lane_axial_attention(**args, heads=heads)
            ref = axial_attention_plain(**args, heads=heads)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            err = compare(f"K2 {name} {where}", got, ref, KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: lane_axial_attention(**args, heads=heads))
            plain_ms = ref_ms(lambda: axial_attention_plain(**args, heads=heads))
            print(f"  K2 {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            results[("K2", name, where)] = (err, ms, plain_ms)
            if where == "training":
                lib = lane_sdpa_ms(args["qkv"], args["bias_x"], args["bias_y"], heads)
                results[("K2 sdpa", name, where)], results[("K2 bwd sdpa", name, where)] = lib
                print(f"  K2 {name} {where}: sdpa over both directions (partial yardstick) "
                      f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms", flush=True)

    print(f"== phase 5: one float32 window, card vs CPU, FiLMAViT-small at {IMAGE}^2", flush=True)
    data_cfg = {"input_fields": ["f"] * FIELDS, "output_fields": ["f"] * FIELDS,
                "time_window": TIME_WINDOW}
    model_cpu = build_model(FILM_AVIT_SMALL, data_cfg).eval()
    weights = random_state_dict(model_cpu, SEED)
    model_cpu.load_state_dict(weights)
    x0 = randn(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)
    cond = torch.tensor([FLUID_PARAMS], dtype=torch.float32)
    model_gpu = build_model(FILM_AVIT_SMALL, data_cfg).eval().to(dev)
    model_gpu.load_state_dict(weights)
    with torch.no_grad():
        t0 = time.perf_counter()
        y_gpu = model_gpu(x0.to(dev), cond.to(dev))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        y_cpu = model_cpu(x0, cond)
        t_cpu = time.perf_counter() - t0
    if tuple(y_gpu.shape) != (1, TIME_WINDOW, FIELDS, IMAGE, IMAGE):
        fail(f"window output shape {tuple(y_gpu.shape)}")
    print(f"  card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s")
    compare("window f32 card vs CPU", y_gpu.cpu(), y_cpu, WINDOW_RTOL)
    del model_cpu, y_cpu

    print(f"== phase 6: {WINDOWS}-window bfloat16 rollout", flush=True)
    model = build_model(FILM_AVIT_SMALL, data_cfg, compute_dtype="bfloat16").eval().to(dev)
    model.load_state_dict(weights)
    init, cond = x0.to(dev), cond.to(dev)
    warm = make_rollout_fn(model, 1, conditioned=True)(init, cond)
    torch.cuda.synchronize()
    rel_l2 = ((warm[0].float() - y_gpu).norm() / y_gpu.norm()).item()
    print(f"  warm-up window: bf16 vs f32 relative L2 {rel_l2:.4f}")
    rollout = make_rollout_fn(model, WINDOWS, conditioned=True)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = rollout(init, cond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"K1": mega_temporal_block.launches, "K2": lane_axial_attention.launches,
                "K2 Hopper": lane_hopper_fwd.launches}
    if lane_line_fwd.launches:
        fail(f"the bf16 rollout launched K2's line kernels {lane_line_fwd.launches} times")
    if tuple(preds.shape) != (WINDOWS, 1, TIME_WINDOW, FIELDS, IMAGE, IMAGE):
        fail(f"rollout shape {tuple(preds.shape)}")
    if not torch.isfinite(preds).all():
        fail("rollout produced non-finite values")
    expected = len(model.blocks) * WINDOWS
    for k, n in launches.items():
        if n != expected:
            fail(f"{k} launched {n} times in the rollout, expected {expected}")
    frames = WINDOWS * TIME_WINDOW
    print(f"  {frames} frames in {seconds:.3f} s: {frames / seconds:.2f} frames/s, "
          f"{1000 * seconds / WINDOWS:.2f} ms/window ({card}); launches {launches}", flush=True)
    if rel_l2 > 0.25:
        fail(f"bf16 window is {rel_l2:.3f} (relative L2) from the f32 window")

    print(f"== phase 7: K1 backward vs plain, x {shapes['K1']['rollout']} and "
          f"{shapes['K1']['training']}", flush=True)
    k1_do = {"rollout": randn(*shapes["K1"]["rollout"]),
             "training": randn_train(*shapes["K1"]["training"])}
    for where, x in k1_x.items():
        for dt in (torch.float32, torch.bfloat16):
            args = dict(x=x.to(dt), **k1)
            params = [args[k] for k in PARAM_NAMES]
            do = k1_do[where].to(dev, dt)
            _, res = mega_temporal_block_fwd(args["x"], *params, heads=heads)
            got = mega_temporal_block_bwd(do, args["x"], *params, heads=heads, residuals=res)
            ref = temporal_branch_bwd_plain(do, **args, heads=heads)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            err = compare_grads(f"K1 bwd {name} {where}", ("x",) + PARAM_NAMES, got, ref,
                                KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: mega_temporal_block_bwd(do, args["x"], *params, heads=heads,
                                                         residuals=res))
            plain_ms = ref_ms(lambda: temporal_branch_bwd_plain(do, **args, heads=heads))
            gemm = k1_gemm_ms(args["x"], args["wqkv"].to(dt), args["wout"].to(dt), do, res[1])
            print(f"  K1 bwd {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                  f"cuBLAS's four products alone (partial yardstick) {gemm:.4f} ms", flush=True)
            results[("K1 bwd", name, where)] = (err, ms, plain_ms)
            results[("K1 bwd gemm", name, where)] = gemm
            del res
    args = dict(x=k1_x["training"].to(torch.bfloat16), **k1)
    launch_line("K1 bf16 training", args, k1_do["training"].to(dev, torch.bfloat16), heads)
    del k1_x, k1_do, args

    print(f"== phase 8: K2 backward vs plain, qkv {shapes['K2']['rollout']} and "
          f"{shapes['K2']['training']}", flush=True)
    k2_do = {"rollout": randn(t, grid, grid, c),
             "training": randn_train(TRAIN_BATCH * t, grid, grid, c)}
    for where, qkv in k2_qkv.items():
        for dt in (torch.float32, torch.bfloat16):
            args = dict(qkv=qkv.to(dt), **k2)
            do = k2_do[where].to(dev, dt)
            got = lane_axial_attention_bwd(do, *args.values(), heads=heads)
            ref = axial_attention_bwd_plain(do, **args, heads=heads)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            err = compare_grads(f"K2 bwd {name} {where}", tuple(args), got, ref,
                                KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: lane_axial_attention_bwd(do, *args.values(), heads=heads))
            plain_ms = ref_ms(lambda: axial_attention_bwd_plain(do, **args, heads=heads))
            print(f"  K2 bwd {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            results[("K2 bwd", name, where)] = (err, ms, plain_ms)
    del k2_qkv, k2_do

    print(f"== phase 9: one float32 training step vs float64, batch 1 at {IMAGE}^2, the first "
          f"{STEP_BLOCKS} blocks", flush=True)
    cfg = load_config(["scheduler_cfg.params.warmup_iters=2"])
    train_cfgs = (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])
    if train_cfgs[0] != FILM_AVIT_SMALL:
        fail("the default composition's model is not FiLMAViT-small")
    step_cfgs = (dict(cfg["model_cfg"], params=dict(cfg["model_cfg"]["params"],
                                                    processor_blocks=STEP_BLOCKS)),
                 *train_cfgs[1:])
    step_weights = {k: v for k, v in weights.items()
                    if not k.startswith("blocks.") or int(k.split(".")[1]) < STEP_BLOCKS}
    batch = synthetic_batch(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE, 9, seed=SEED)
    counters = (mega_temporal_block, mega_temporal_block_bwd, lane_axial_attention,
                lane_axial_attention_bwd)
    # K2's path in float32: the line kernels (their counters move with K2's).
    step_counters = counters + (lane_line_fwd, lane_line_bwd)
    sides = (("card", "cuda", False), ("card plain", "cuda", True), ("CPU", "cpu", False))
    for case, case_weights in (("FiLM near identity", film_near_identity(step_weights, SEED)),
                               ("FiLM at O(0.1)", step_weights)):
        ref_loss, ref, t64 = train_step_grads(step_cfgs, case_weights, batch, "cpu",
                                              torch.float64)
        print(f"  {case}: CPU float64 step {t64:.2f} s, loss {ref_loss:.7f}")
        worst = {}
        for side, where, plain in sides:
            counts = [fn.launches for fn in step_counters]
            loss, grads, secs = train_step_grads(step_cfgs, case_weights, batch, where,
                                                 torch.float32, plain)
            launched = [fn.launches - n for fn, n in zip(step_counters, counts)]
            if where == "cuda" and (any(launched) if plain else not all(launched)):
                fail(f"{case}, {side}: kernel launches {launched}")
            if not np.isfinite(loss) or abs(loss - ref_loss) > STEP_RTOL["loss"] * abs(ref_loss):
                fail(f"{case}: training-step loss {loss} on the {side} vs {ref_loss} in float64")
            if not all(torch.isfinite(g).all() for g in grads.values()):
                fail(f"{case}: non-finite gradient on the {side}")
            errs, zero = step_errors(ref, grads)
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
            worst[side] = top[0][1]
            print(f"  {case}, {side} float32: {secs:.2f} s, loss {loss:.7f}; worst gradients "
                  f"vs float64 " + ", ".join(f"{n} {e:.2e}" for n, e in top), flush=True)
        print(f"  {case}: {len(zero)} gradients zero up to rounding in float64: "
              + ", ".join(sorted({n.split('.', 2)[-1] for n in zero})))
        witness = max(worst["card plain"], worst["CPU"])
        limit = (STEP_RTOL["film_o01"] if case == "FiLM at O(0.1)"
                 else STEP_RTOL["vs_witness"] * witness + STEP_RTOL["abs"])
        if worst["card"] > limit:
            fail(f"{case}: card gradients {worst['card']:.3e} from float64, above {limit:.3e} "
                 f"(witnesses: card plain {worst['card plain']:.3e}, CPU {worst['CPU']:.3e})")
        print(f"  {case}: grads vs float64, card {worst['card']:.3e}, card plain "
              f"{worst['card plain']:.3e}, CPU {worst['CPU']:.3e} (tol {limit:.3e}) ok",
              flush=True)
        del ref, grads

    print(f"== phase 10: Trainer.fit, bfloat16, batch {TRAIN_BATCH} at {IMAGE}^2, Lion, "
          f"{TRAIN_STEPS} steps after 1 warm-up step", flush=True)
    log_dir = repo / "build" / "chip_smoke_train"
    shutil.rmtree(log_dir, ignore_errors=True)
    module = ConditionedForecastModule(*train_cfgs, total_steps=TRAIN_STEPS + 1,
                                       compute_dtype="bfloat16", device="cuda", seed=SEED)
    trainer = Trainer(module, log_dir=str(log_dir), limit_train_batches=TRAIN_STEPS,
                      seed=SEED, log_every=1)
    warm = synthetic_batch(TRAIN_BATCH, TIME_WINDOW, FIELDS, IMAGE, IMAGE, 9, seed=SEED + 1)
    module.train_step(tuple(torch.from_numpy(a).to(dev) for a in warm),
                      torch.Generator(device=dev).manual_seed(SEED))
    before = {n: p.detach().clone() for n, p in module.model.named_parameters()}
    # K2's path in bfloat16: the Hopper kernels, every call (the line
    # kernels never).
    fit_counters = counters + (lane_hopper_fwd, lane_hopper_bwd, lane_line_fwd, lane_line_bwd)
    zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(SyntheticLoader(TRAIN_STEPS, TRAIN_BATCH, TIME_WINDOW, FIELDS, IMAGE, 9,
                                seed=SEED + 2), max_epochs=1)
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in fit_counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds = trainer.last_epoch_seconds
    with open(log_dir / "metrics.csv") as f:
        losses = [float(row.split(",")[3]) for row in f.read().splitlines()[1:]]
    print(f"  losses {losses}")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    for fn_name, n in train_launches.items():
        per_step = 0 if fn_name.startswith("lane_line") else 12 * DOTS_RERUN.get(fn_name, 1)
        want = per_step * TRAIN_STEPS
        if n != want:
            fail(f"{fn_name} launched {n} times in {TRAIN_STEPS} steps, expected {want}")
    unmoved = [(n, p) for n, p in module.model.named_parameters() if torch.equal(before[n], p)]
    stuck = [n for n, p in unmoved if p.grad is not None and bool(p.grad.any())]
    if stuck:
        fail(f"{len(stuck)} parameters with a gradient did not move in training: {stuck[:5]}")
    moved = len(before) - len(unmoved)
    resumed = ConditionedForecastModule(*train_cfgs, total_steps=TRAIN_STEPS + 1,
                                        compute_dtype="bfloat16", device="cuda", seed=SEED + 9)
    restore_checkpoint(str(log_dir / "last.pt"), resumed)
    probe = "blocks.0.temporal.input_head.weight"
    if resumed.step != module.step or not torch.equal(
            resumed.model.state_dict()[probe], module.model.state_dict()[probe]):
        fail("the checkpoint did not resume the run's step and parameters")
    synthetic_fit = {"ms_per_step": 1000 * seconds / TRAIN_STEPS,
                     "samples_per_s": TRAIN_BATCH * TRAIN_STEPS / seconds}
    print(f"  {TRAIN_STEPS} steps in {seconds:.3f} s: {1000 * seconds / TRAIN_STEPS:.1f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} samples/s; peak memory {peak_gb:.2f} GB; "
          f"{moved}/{len(before)} parameters moved; resumed at step {resumed.step} "
          f"({card}); launches {train_launches}", flush=True)
    del module, resumed, trainer
    shutil.rmtree(log_dir, ignore_errors=True)

    # ---- AViT-big (C=768): the temporal branch on the core route (K3).
    c_big = 768
    heads_big = c_big // 64
    shapes["K3"] = {"rollout": (1, t, grid, grid, c_big),
                    "training": (TRAIN_BATCH, t, grid, grid, c_big),
                    "grid_1024": (2, t, 2 * grid, 2 * grid, c)}
    shapes["K2 big"] = {"rollout": (t, grid, grid, 3 * c_big),
                        "training": (TRAIN_BATCH * t, grid, grid, 3 * c_big)}
    rng_big = np.random.default_rng(SEED + 3)

    def randn_big(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy(
            (offset + scale * rng_big.standard_normal(shape)).astype(np.float32))

    print(f"== phase 11: K3 core_temporal_attention forward and backward vs plain, xn "
          f"{', '.join(str(v) for v in shapes['K3'].values())}", flush=True)
    for where, shape in shapes["K3"].items():
        cc = shape[-1]
        hh, dd = cc // 64, 64
        k3 = dict(
            wqkv=randn_big(3 * cc, cc, scale=cc**-0.5), bqkv=randn_big(3 * cc, scale=0.1),
            qn_scale=randn_big(dd, scale=0.1, offset=1.0), qn_bias=randn_big(dd, scale=0.1),
            kn_scale=randn_big(dd, scale=0.1, offset=1.0), kn_bias=randn_big(dd, scale=0.1),
            bias=randn_big(hh, t, t),
            scale_factor=torch.from_numpy(rng_big.uniform(0.5, 1.5, hh).astype(np.float32)),
        )
        k3 = {k: v.to(dev) for k, v in k3.items()}
        xn32, dao32 = randn_big(*shape).to(dev), randn_big(*shape).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            args = dict(xn=xn32.to(dt), **k3)
            params = [args[k] for k in CORE_PARAM_NAMES]
            got = core_temporal_attention(**args, heads=hh)
            ref = core_temporal_plain(**args, heads=hh)
            torch.cuda.synchronize()
            err = compare(f"K3 {name} {where}", got, ref, KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: core_temporal_attention(**args, heads=hh))
            plain_ms = ref_ms(lambda: core_temporal_plain(**args, heads=hh))
            w2 = k3["wqkv"].to(dt)
            gemm_ms = k3_gemm_ms(args["xn"], w2)
            print(f"  K3 {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                  f"cuBLAS QKV product alone (partial yardstick) {gemm_ms:.4f} ms", flush=True)
            results[("K3", name, where)] = (err, ms, plain_ms)
            results[("K3 gemm", name, where)] = gemm_ms

            dao = dao32.to(dt)
            got = core_temporal_attention_bwd(dao, args["xn"], *params, heads=hh)
            ref = core_temporal_bwd_plain(dao, **args, heads=hh)
            torch.cuda.synchronize()
            err = compare_grads(f"K3 bwd {name} {where}", ("xn",) + CORE_PARAM_NAMES, got, ref,
                                KERNEL_RTOL[name])
            del got, ref
            ms = cuda_ms(lambda: core_temporal_attention_bwd(dao, args["xn"], *params,
                                                             heads=hh))
            plain_ms = ref_ms(lambda: core_temporal_bwd_plain(dao, **args, heads=hh))
            stand_in = torch.matmul(args["xn"].reshape(-1, cc), w2.t())  # a (R, 3C) dqkv
            gemm_ms = k3_gemm_ms(args["xn"], w2, stand_in)
            del stand_in
            print(f"  K3 bwd {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                  f"cuBLAS's three products alone (partial yardstick) {gemm_ms:.4f} ms",
                  flush=True)
            results[("K3 bwd", name, where)] = (err, ms, plain_ms)
            results[("K3 bwd gemm", name, where)] = gemm_ms
            if dt == torch.bfloat16 and where == "training":
                launch_line(f"K3 bf16 {where}", args, dao, hh)
            del args, params, dao, w2
        del k3, xn32, dao32

    print(f"== phase 12: K2 at {heads_big} heads vs plain, forward and backward, qkv "
          f"{shapes['K2 big']['rollout']} and {shapes['K2 big']['training']}", flush=True)
    k2b = dict(
        qn_scale=randn_big(64, scale=0.1, offset=1.0), qn_bias=randn_big(64, scale=0.1),
        kn_scale=randn_big(64, scale=0.1, offset=1.0), kn_bias=randn_big(64, scale=0.1),
        bias_x=randn_big(heads_big, grid, grid), bias_y=randn_big(heads_big, grid, grid),
        scale_x=torch.from_numpy(rng_big.uniform(0.5, 1.5, heads_big).astype(np.float32)),
        scale_y=torch.from_numpy(rng_big.uniform(0.5, 1.5, heads_big).astype(np.float32)),
    )
    k2b = {k: v.to(dev) for k, v in k2b.items()}
    for where, shape in shapes["K2 big"].items():
        qkv32, do32 = randn_big(*shape).to(dev), randn_big(*shape[:-1], c_big).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            args = dict(qkv=qkv32.to(dt), **k2b)
            got = lane_axial_attention(**args, heads=heads_big)
            ref = axial_attention_plain(**args, heads=heads_big)
            torch.cuda.synchronize()
            err_f = compare(f"K2 {name} {where} C={c_big}", got, ref, KERNEL_RTOL[name])
            del got, ref
            do = do32.to(dt)
            got = lane_axial_attention_bwd(do, *args.values(), heads=heads_big)
            ref = axial_attention_bwd_plain(do, **args, heads=heads_big)
            torch.cuda.synchronize()
            err_b = compare_grads(f"K2 bwd {name} {where} C={c_big}", tuple(args), got, ref,
                                  KERNEL_RTOL[name])
            del got, ref
            ms_f = cuda_ms(lambda: lane_axial_attention(**args, heads=heads_big))
            ms_b = cuda_ms(lambda: lane_axial_attention_bwd(do, *args.values(), heads=heads_big))
            plain_f = ref_ms(lambda: axial_attention_plain(**args, heads=heads_big))
            plain_b = ref_ms(lambda: axial_attention_bwd_plain(do, **args, heads=heads_big))
            print(f"  K2 C={c_big} {name} {where}: forward {ms_f:.4f} ms (plain {plain_f:.4f}), "
                  f"backward {ms_b:.4f} ms (plain {plain_b:.4f})", flush=True)
            results[("K2 big", name, where)] = (err_f, ms_f, err_b, ms_b)
            results[("K2 big plain", name, where)] = (plain_f, plain_b)
            if where == "training":
                results[("K2 big sdpa", name, where)] = lane_sdpa_ms(
                    args["qkv"], args["bias_x"], args["bias_y"], heads_big)
            del args, do
        del qkv32, do32

    print(f"== phase 13: one float32 window, card vs CPU, AViT-big at {IMAGE}^2", flush=True)
    big_cfg = load_config(["model_cfg=avit_big", "optim_cfg=adamw",
                           "data_cfg=poolboiling_saturated", "scheduler_cfg.params.warmup_iters=2"])
    big_train_cfgs = (big_cfg["model_cfg"], big_cfg["data_cfg"], big_cfg["optim_cfg"],
                      big_cfg["scheduler_cfg"])
    if big_cfg["model_cfg"]["params"]["embed_dim"] != c_big:
        fail("model_cfg/avit_big.yaml is not AViT-big")
    big_cpu = build_model(big_cfg["model_cfg"], data_cfg).eval()
    big_weights = random_state_dict(big_cpu, SEED + 4)
    big_cpu.load_state_dict(big_weights)
    big_gpu = build_model(big_cfg["model_cfg"], data_cfg).eval().to(dev)
    big_gpu.load_state_dict(big_weights)
    xb = randn_big(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE)
    for fn in counters + (core_temporal_attention, core_temporal_attention_bwd):
        fn.launches = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        yb_gpu = big_gpu(xb.to(dev))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        yb_cpu = big_cpu(xb)
        t_cpu = time.perf_counter() - t0
    if (core_temporal_attention.launches, mega_temporal_block.launches) != (12, 0):
        fail(f"the AViT-big window launched K3 {core_temporal_attention.launches} and K1 "
             f"{mega_temporal_block.launches} times, expected 12 and 0")
    print(f"  card {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s, 12 of 12 blocks on both")
    compare("AViT-big window f32 card vs CPU", yb_gpu.cpu(), yb_cpu, WINDOW_RTOL)
    del big_cpu, yb_cpu, big_gpu

    print(f"== phase 14: {WINDOWS}-window bfloat16 AViT-big rollout", flush=True)
    big = build_model(big_cfg["model_cfg"], data_cfg, compute_dtype="bfloat16").eval().to(dev)
    big.load_state_dict(big_weights)
    init_b = xb.to(dev)
    warm_b = make_rollout_fn(big, 1)(init_b)
    torch.cuda.synchronize()
    rel_l2_b = ((warm_b[0].float() - yb_gpu).norm() / yb_gpu.norm()).item()
    print(f"  warm-up window: bf16 vs f32 relative L2 {rel_l2_b:.4f}")
    rollout = make_rollout_fn(big, WINDOWS)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = rollout(init_b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    big_launches = {"K3": core_temporal_attention.launches, "K2": lane_axial_attention.launches,
                    "K2 Hopper": lane_hopper_fwd.launches, "K2 line": lane_line_fwd.launches,
                    "K1": mega_temporal_block.launches}
    if tuple(preds.shape) != (WINDOWS, 1, TIME_WINDOW, FIELDS, IMAGE, IMAGE):
        fail(f"AViT-big rollout shape {tuple(preds.shape)}")
    if not torch.isfinite(preds).all():
        fail("the AViT-big rollout produced non-finite values")
    want = {"K3": 12 * WINDOWS, "K2": 12 * WINDOWS, "K2 Hopper": 12 * WINDOWS, "K2 line": 0,
            "K1": 0}
    if big_launches != want:
        fail(f"AViT-big rollout launches {big_launches}, expected {want}")
    print(f"  {frames} frames in {seconds:.3f} s: {frames / seconds:.2f} frames/s, "
          f"{1000 * seconds / WINDOWS:.2f} ms/window ({card}); launches {big_launches}",
          flush=True)
    if rel_l2_b > 0.25:
        fail(f"AViT-big bf16 window is {rel_l2_b:.3f} (relative L2) from the f32 window")
    del big, preds, warm_b, yb_gpu

    print(f"== phase 15: Trainer.fit AViT-big, bfloat16, batch {TRAIN_BATCH} at {IMAGE}^2, "
          f"AdamW, {BIG_TRAIN_STEPS} steps after 1 warm-up step", flush=True)
    if module_class(big_cfg["model_cfg"], big_cfg["data_cfg"]).conditioned:
        fail("AViT-big got the conditioned module")
    big_run = fit_phase("AViT-big", big_train_cfgs, TRAIN_BATCH, BIG_TRAIN_STEPS, (IMAGE, IMAGE),
                        {"core_temporal_attention": 12, "core_temporal_attention_bwd": 12,
                         "lane_axial_attention": 12, "lane_axial_attention_bwd": 12},
                        repo / "build" / "chip_smoke_train_big", dev, card, fluid=9)
    big_train_launches = big_run["launches"]

    for where, shape in shapes["K2 big"].items():
        for dt in ("float32", "bfloat16"):
            _, ms_f, _, ms_b = results[("K2 big", dt, where)]
            b_f = bound(*kernel_work("K2", shape, dt), dt)[0]
            b_b = bound(*kernel_work("K2 bwd", shape, dt), dt)[0]
            lib = results.get(("K2 big sdpa", dt, where))
            extra = (f"; sdpa over both directions (partial yardstick) {lib[0]:.4f} / "
                     f"{lib[1]:.4f} ms" if lib else "")
            p_f, p_b = results[("K2 big plain", dt, where)]
            print(f"  lane_axial_attention C={c_big} {where} {shape} {dt}: forward {ms_f:.4f} ms "
                  f"(plain {p_f:.4f}, bound {b_f:.5f}), backward {ms_b:.4f} ms (plain "
                  f"{p_b:.4f}, bound {b_b:.5f}){extra}")

    runs = new_path_phases(repo, dev, card, results)

    for key in ("K2 long", "K2 long bwd"):
        for where, shape in LINE_SHAPES["K2 long"].items():
            for dt in ("bfloat16",) if where in LINE_BF16_ONLY else ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(key, shape, dt), dt)
                _, k_ms, p_ms = results[(key, dt, where)]
                lib = results.get((key + " sdpa", dt, where))
                extra = f", sdpa (partial yardstick) {lib:.4f} ms" if lib else ""
                print(f"  {key} {where} {shape} {dt}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"bound {b_ms:.5f} ms ({b_by}){extra}")
    print(f"  lane_axial_attention at 512x2048: launches per rollout window 12, per training "
          f"step {runs['A']['launches']['lane_axial_attention'] // runs['A']['steps']}")

    kernels = []
    # K2 in bf16: the Hopper kernels (C entries: axial_lane_hopper.cu).
    lane_cu = "bubbleformer_tpu_torch/csrc/lane_hopper.cuh"
    # K2's and K4's launches on their paths are their bf16 kernels'
    # (lane_kernels, fused_block_kernels).
    counter_of = {"lane_axial_attention": "lane_hopper_fwd",
                  "lane_axial_attention_bwd": "lane_hopper_bwd",
                  "fused_block_attention": "fused_block_hopper_fwd",
                  "fused_block_attention_bwd": "fused_block_hopper_bwd"}
    # K2 and K4 compute the same two-direction attention at these training
    # shapes: one sdpa yardstick (phase 4) for both (K6 and K7: phase 25's).
    k2_sdpa = {"fwd": results[("K2 sdpa", "bfloat16", "training")],
               "bwd": results[("K2 bwd sdpa", "bfloat16", "training")]}
    for key, name, source, replaces in (
        ("K1", "mega_temporal_block", "bubbleformer_tpu_torch/csrc/temporal_block.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:238"),
        ("K2", "lane_axial_attention", lane_cu, "bubbleformer_tpu/ops/axial_lane.py:236"),
        ("K1 bwd", "mega_temporal_block_bwd",
         "bubbleformer_tpu_torch/csrc/temporal_block_bwd.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:269"),
        ("K2 bwd", "lane_axial_attention_bwd", lane_cu, "bubbleformer_tpu/ops/axial_lane.py:370"),
        ("K3", "core_temporal_attention", "bubbleformer_tpu_torch/csrc/temporal_block.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:452"),
        ("K3 bwd", "core_temporal_attention_bwd",
         "bubbleformer_tpu_torch/csrc/temporal_block_bwd.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:476"),
        ("K4", "fused_block_attention", lane_cu, "bubbleformer_tpu/ops/axial_fused_block.py:85"),
        ("K4 bwd", "fused_block_attention_bwd", lane_cu,
         "bubbleformer_tpu/ops/axial_fused_block.py:138"),
    ):
        # The launches are the training run of the path that launches the
        # kernel (FiLMAViT-small for K1 and K2, AViT-big for K3, AViT-small
        # with attn_impl=fused_block for K4), so every number beside them is
        # taken at that step's shape.
        if key.startswith("K4"):
            cases, run_launches, steps, per_window = LINE_SHAPES["K4"], runs["B"]["launches"], \
                runs["B"]["steps"], "none (path B has no rollout; 4 on AViT-tiny's)"
        else:
            on_big = key.startswith("K3")
            cases = shapes[key[:2]]
            run_launches, steps = ((big_train_launches, BIG_TRAIN_STEPS) if on_big
                                   else (train_launches, TRAIN_STEPS))
            per_window = (big_launches if on_big else launches).get(key, 0) // WINDOWS
        err, ms, plain_ms = results[(key, "bfloat16", "training")]
        bound_ms, bound_by = bound(*kernel_work(key, cases["training"], "bfloat16"), "bfloat16")
        # K1 and K3: cuBLAS on their products alone; K2 and K4: sdpa over
        # both directions (partial yardsticks).
        library = (results.get((key + " gemm", "bfloat16", "training")) if key[:2] in ("K1", "K3")
                   else k2_sdpa["bwd" if key.endswith("bwd") else "fwd"])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": run_launches[counter_of.get(name, name)], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library})
        for where in cases:
            for dt in ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(key, cases[where], dt), dt)
                _, k_ms, p_ms = results[(key, dt, where)]
                sdpa = results.get((key[:2] + (" bwd" if key.endswith("bwd") else "") + " sdpa",
                                    dt, where))
                extra = (f", cuBLAS's products alone {results[(key + ' gemm', dt, where)]:.4f} ms"
                         if key[:2] in ("K1", "K3") else
                         f", sdpa (partial yardstick) {sdpa:.4f} ms" if sdpa else "")
                print(f"  {name} {where} {cases[where]} {dt}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}){extra}")
        print(f"  {name}: launches per rollout window {per_window}, "
              f"per training step {run_launches[counter_of.get(name, name)] // steps}")
    # This slice's kernels, their launches from its paths' training runs:
    # K5 on path C, K6 and K7 on path D (their bf16 Hopper kernels: K6 on
    # lane_hopper.cuh, C entries axial_lane_hopper.cu; K7 on flash_hopper.cuh,
    # C entries axial_flash_hopper.cu), K1 and K3 at head dim 16 on path E.
    runs5 = slice5_phases(repo, dev, card, results)
    mega_cu = "bubbleformer_tpu_torch/csrc/axial_block_mega.cu"
    flash_cu = "bubbleformer_tpu_torch/csrc/flash_hopper.cuh"
    jax_ops = "bubbleformer_tpu/ops/"
    for key, name, counter, source, replaces, run, cases in (
        ("K5", "mega_axial_block", "mega_axial_block", mega_cu,
         jax_ops + "axial_block_mega.py:143", runs5["C"], BRANCH_SHAPES["K5"]),
        ("K5 bwd", "mega_axial_block_bwd", "mega_axial_block_bwd", mega_cu,
         jax_ops + "axial_block_mega.py:193", runs5["C"], BRANCH_SHAPES["K5"]),
        ("K6", "fused_axial_attention_packed", "fused_packed_hopper_fwd", lane_cu,
         jax_ops + "axial_fused_packed.py:133", runs5["D fused_packed"], SPLIT_SHAPES),
        ("K6 bwd", "fused_axial_attention_packed_bwd", "fused_packed_hopper_bwd",
         lane_cu, jax_ops + "axial_fused_packed.py:230", runs5["D fused_packed"], SPLIT_SHAPES),
        ("K7", "fused_axial_attention", "fused_hopper_fwd", flash_cu,
         jax_ops + "axial_fused.py:103", runs5["D fused"], SPLIT_SHAPES),
        ("K7 bwd", "fused_axial_attention_bwd", "fused_hopper_bwd", flash_cu,
         jax_ops + "axial_fused.py:179", runs5["D fused"], SPLIT_SHAPES),
        ("K1 d16", "mega_temporal_block (head dim 16)", "mega_temporal_block",
         "bubbleformer_tpu_torch/csrc/temporal_block.cu", jax_ops + "temporal_block_mega.py:238",
         runs5["E"], BRANCH_SHAPES["K1 d16"]),
        ("K1 d16 bwd", "mega_temporal_block_bwd (head dim 16)", "mega_temporal_block_bwd",
         "bubbleformer_tpu_torch/csrc/temporal_block_bwd.cu",
         jax_ops + "temporal_block_mega.py:269", runs5["E"], BRANCH_SHAPES["K1 d16"]),
        ("K3 d16", "core_temporal_attention (head dim 16)", "core_temporal_attention",
         "bubbleformer_tpu_torch/csrc/temporal_block.cu", jax_ops + "temporal_block_mega.py:452",
         runs5["E flow"], BRANCH_SHAPES["K3 d16"]),
        ("K3 d16 bwd", "core_temporal_attention_bwd (head dim 16)", "core_temporal_attention_bwd",
         "bubbleformer_tpu_torch/csrc/temporal_block_bwd.cu",
         jax_ops + "temporal_block_mega.py:476", runs5["E flow"], BRANCH_SHAPES["K3 d16"]),
    ):
        err, ms, plain_ms = results[(key, "bfloat16", "training")]
        bound_ms, bound_by = bound(*kernel_work(key, cases["training"], "bfloat16"), "bfloat16")
        launches_run = run["launches"][counter]
        if launches_run == 0:
            fail(f"{name} was not launched on its path")
        # K1, K3, K5: cuBLAS's products alone; K6, K7: sdpa over both
        # directions, phase 25 (partial yardsticks).
        yardstick = " gemm" if key[:2] in ("K1", "K3", "K5") else " sdpa"
        library = results.get((key + yardstick, "bfloat16", "training"))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches_run, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library})
        for where in cases:
            for dt in ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(key, cases[where], dt), dt)
                _, k_ms, p_ms = results[(key, dt, where)]
                lib = results.get((key + yardstick, dt, where))
                extra = ("" if lib is None else
                         f", cuBLAS's products alone {lib:.4f} ms" if yardstick == " gemm" else
                         f", sdpa (partial yardstick) {lib:.4f} ms")
                print(f"  {name} {where} {cases[where]} {dt}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}){extra}")
        print(f"  {name}: launches per training step {launches_run // run['steps']}")
    print(f"  path E at {IMAGE}^2: axial branch on {runs5['E axial']}")
    for label in ("C", "D fused_packed", "D fused", "E", "E flow"):
        r = runs5[label]
        print(f"  path {label} training: {r['ms_per_step']:.2f} ms/step, "
              f"{r['samples_per_s']:.2f} samples/s, peak {r['peak_gb']:.2f} GB")
    print(f"  path C rollout: {runs5['C rollout']:.2f} frames/s")
    # This slice's kernels: K8 at path F's temporal and axial shapes (one
    # wrapper, so each row carries the path's launches of both), K10 at its
    # step's pred and target; launches from path F's training run.
    runs6 = slice6_phases(repo, dev, card, results)
    # K8 in bf16: the Hopper kernels (C entries: axial_flash_hopper.cu).
    flash_cu = "bubbleformer_tpu_torch/csrc/flash_hopper.cuh"
    loss_cu = "bubbleformer_tpu_torch/csrc/lp_loss.cu"
    run_f = runs6["F"]
    for key, name, counter, source, replaces, shape, where in (
        ("K8", "flash_packed_attention (temporal)", "flash_hopper_fwd", flash_cu,
         jax_ops + "axial_pallas.py:66", FLASH_SHAPES["temporal training"], "temporal training"),
        ("K8", "flash_packed_attention (axial)", "flash_hopper_fwd", flash_cu,
         jax_ops + "axial_pallas.py:66", FLASH_SHAPES["axial training"], "axial training"),
        ("K8 bwd", "flash_packed_attention_bwd (temporal)", "flash_hopper_bwd",
         flash_cu, jax_ops + "axial_pallas.py:82", FLASH_SHAPES["temporal training"],
         "temporal training"),
        ("K8 bwd", "flash_packed_attention_bwd (axial)", "flash_hopper_bwd", flash_cu,
         jax_ops + "axial_pallas.py:82", FLASH_SHAPES["axial training"], "axial training"),
        ("K10", "plane_norms", "plane_norms", loss_cu, jax_ops + "lp_loss.py:31", LOSS_SHAPE,
         "training"),
        ("K10 bwd", "plane_norms_bwd", "plane_norms_bwd", loss_cu, jax_ops + "lp_loss.py:44",
         LOSS_SHAPE, "training"),
    ):
        err, ms, plain_ms = results[(key, "bfloat16", where)]
        bound_ms, bound_by = bound(*kernel_work(key, shape, "bfloat16"), "bfloat16")
        launches_run = run_f["launches"][counter]
        if launches_run == 0:
            fail(f"{name} was not launched on its path")
        library = results.get((key + " sdpa", "bfloat16", where))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches_run, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library})
        cases = ({w: sh for w, sh in FLASH_SHAPES.items() if w.startswith(where.split()[0])}
                 if key.startswith("K8") else {"training": LOSS_SHAPE})
        for w, sh in cases.items():
            for dt in ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(key, sh, dt), dt)
                _, k_ms, p_ms = results[(key, dt, w)]
                lib = results.get((key + " sdpa", dt, w))
                extra = f", sdpa with the bias (partial yardstick) {lib:.4f} ms" if lib else ""
                print(f"  {name} {w} {sh} {dt}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"bound {b_ms:.5f} ms ({b_by}){extra}")
        print(f"  {name}: launches per training step {launches_run // run_f['steps']}")
    print(f"  path F training: {run_f['ms_per_step']:.2f} ms/step, "
          f"{run_f['samples_per_s']:.2f} samples/s, peak {run_f['peak_gb']:.2f} GB; rollout "
          f"{runs6['F rollout']:.2f} frames/s; nhwc step vs nchw: loss "
          f"{runs6['F nhwc']['loss_rel']:.2e}, gradients {runs6['F nhwc']['grads_rel']:.2e}")
    # This slice's kernel: K9 at path G's training shape, its launches from
    # path G's training run.
    runs7 = slice7_phases(repo, dev, card, results)
    px_cu = "bubbleformer_tpu_torch/csrc/axial_lane_px.cu"
    run_g = runs7["G"]
    for key, name, replaces in (
        ("K9", "lane_px_attention", jax_ops + "axial_lane.py:399"),
        ("K9 bwd", "lane_px_attention_bwd", jax_ops + "axial_lane.py:426"),
    ):
        err, ms, plain_ms = results[(key, "bfloat16", "training")]
        bound_ms, bound_by = bound(*kernel_work(key, PX_SHAPES["training"], "bfloat16"),
                                   "bfloat16")
        launches_run = run_g["launches"][name]
        if launches_run == 0:
            fail(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": px_cu, "replaces": replaces,
                        "launches": launches_run, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": results[(key + " gemm", "bfloat16", "training")]})
        for where, shape in PX_SHAPES.items():
            k = key.replace("K9", "K9 d16") if where == "tiny d16" else key
            for dt in ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(k, shape, dt), dt)
                _, k_ms, p_ms = results[(key, dt, where)]
                extra = f", cuBLAS's products alone {results[(key + ' gemm', dt, where)]:.4f} ms"
                print(f"  {name} {where} {shape} {dt}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"bound {b_ms:.5f} ms ({b_by}){extra}")
        print(f"  {name}: launches per rollout window "
              f"{12 if key == 'K9' else 0}, per training step {launches_run // run_g['steps']}")
    for label in ("G", "G default", "flow b8", "flow b4 off"):
        r = runs7[label]
        print(f"  {label} training: {r['ms_per_step']:.2f} ms/step, "
              f"{r['samples_per_s']:.2f} samples/s, peak {r['peak_gb']:.2f} GB")
    print(f"  path G rollout: {runs7['G rollout']:.2f} frames/s")
    rm = runs7["remat"]
    print("  remat step (float32, batch 8): " + ", ".join(
        f"{k} {rm[k]['ms_per_step']:.1f} ms/step {rm[k]['peak_gb']:.2f} GB"
        for k in ("off", "off again", "dots", "full")) + f"; dots vs off gradients "
        f"{rm['dots']['grads_rel']:.2e}, full {rm['full']['grads_rel']:.2e}, off repeated "
        f"{rm['spread']['grads_rel']:.2e}")
    rf = runs7["remat flow"]
    print(f"  remat step (float32, AViT-small {FLOW_HEIGHT}x{FLOW_WIDTH}, K3 and K9, batch 1): "
          f"dots vs off gradients {rf['dots']['grads_rel']:.2e}, off repeated "
          f"{rf['spread']['grads_rel']:.2e}")
    # This slice's kernels: the probes' (P1-P4), their launches from the
    # four probe CLIs' runs.
    t0 = time.perf_counter()
    probe_shapes, probe_launches = slice8_phases(dev, results)
    for key, counter, source, replaces, dt in PROBE_ROWS:
        err, ms, plain_ms, lib_ms = results[(key, dt)]
        bound_ms, bound_by = bound(*kernel_work(key, probe_shapes[key], dt), dt)
        kernels.append({"name": counter, "route": "cuda",
                        "source": "bubbleformer_tpu_torch/csrc/" + source, "replaces": replaces,
                        "launches": probe_launches[counter], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})
        print(f"  {counter} ({key}) {probe_shapes[key]} {dt}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f"; launches in its probe's run {probe_launches[counter]}")
    print(f"  phases 39-40 took {time.perf_counter() - t0:.1f} s", flush=True)
    # This slice's path: the U-Nets, whose training steps add K10's launches.
    unets = unet_phases(repo, dev, card)
    for entry in kernels:
        if entry["name"] in ("plane_norms", "plane_norms_bwd"):
            entry["launches"] += sum(r["launches"][entry["name"]] for r in unets.values())
    for name, r in unets.items():
        print(f"  {name} ({r['parameters']:,} parameters): rollout {r['rollout_fps']:.2f} "
              f"frames/s; training {r['ms_per_step']:.2f} ms/step, {r['samples_per_s']:.2f} "
              f"samples/s, peak {r['peak_gb']:.2f} GB (batch {UNET_TRAIN_BATCH}); K10 "
              f"{r['launches']['plane_norms']} + {r['launches']['plane_norms_bwd']} launches; "
              f"phases 41 / 42 / 43 took {r['window_s']:.1f} / {r['rollout_s']:.1f} / "
              f"{r['fit_s']:.1f} s", flush=True)
    # This slice: bias_type through the kernels, the continuous slice at full
    # width, a reference checkpoint.
    t0 = time.perf_counter()
    print(f"== phase 44: every model-path kernel in bfloat16 with continuous tables and with "
          f"none, {', '.join(TABLE_SHAPES)}", flush=True)
    table_kernel_phase(dev)
    t_tables = time.perf_counter() - t0
    cont = continuous_slice_phase(repo, dev, card)
    t_reference = reference_ckpt_phase(repo, dev, card)
    print(f"  FiLMAViT-small continuous: rollout {cont['rollout_fps']:.2f} frames/s; training "
          f"{cont['ms_per_step']:.2f} ms/step, {cont['samples_per_s']:.2f} samples/s, peak "
          f"{cont['peak_gb']:.2f} GB (batch {TRAIN_BATCH}, transfer_dtype=bfloat16, profiler "
          f"on for steps {SLICE_PROFILE_STEPS})", flush=True)
    print(f"  phases 44 / 45 (window and step, fit, rollout) / 46 took {t_tables:.1f} / "
          f"{cont['window_step_s']:.1f}, {cont['fit_s']:.1f}, {cont['rollout_s']:.1f} / "
          f"{t_reference:.1f} s", flush=True)
    # This slice: the data path (phases 47-49), whose training runs and
    # rollouts add K1's, K2's and K4's launches.
    data = data_phase(repo)
    files = files_fit_phase(repo, data, synthetic_fit, card)
    gate = physics_gate_phase(repo, card)
    for entry in kernels:
        counter = counter_of.get(entry["name"], entry["name"])
        entry["launches"] += sum(r["launches"].get(counter, 0) for r in (files, gate))
    print(f"  phases 47 / 48 / 49 took {data['seconds']:.1f} / {files['seconds']:.1f} / "
          f"{gate['seconds']:.1f} s", flush=True)
    # This slice: data parallelism (phases 50-53), whose runs add K1's, K2's
    # and K10's launches.
    dp = [dp_one_rank_phase(card), *dp_two_rank_phases(repo, card)]
    t_cli = dp_cli_phase(repo, card)
    for entry in kernels:
        counter = counter_of.get(entry["name"], entry["name"])
        entry["launches"] += sum(r["launches"].get(counter, 0) for r in dp)
    print(f"  phases 50 / 51-52 / 53 took {dp[0]['seconds']:.1f} / {dp[1]['seconds']:.1f} / "
          f"{t_cli:.1f} s", flush=True)
    print(f"  the run took {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
