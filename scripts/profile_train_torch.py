#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one card.

Builds the training module of a composition — by default the default one,
FiLMAViT-small with Lion and cosine warmup; ``--model-cfg`` and
``--optim-cfg`` pick other config groups (``avit_big`` and ``adamw`` for the
README's quick-start) — with bfloat16 activations and float32 parameters at
``--batch`` on synthetic 512x512 batches already on the card, runs warm-up
steps, times ``--steps`` steps with CUDA events (ms/step, samples/s, peak
memory), then traces ``--profile-steps`` more with ``torch.profiler`` and
sums the device time of every kernel by part: the forward and backward
kernels of the temporal branch (K1, or K3 where the branch takes the core
route: both build on the same kernels) and of K2, matrix products
(cuBLAS), the optimizer's foreach kernels, and the rest (elementwise,
reductions, copies).  The idle share is one minus the summed kernel time
over the host-clock wall time of the traced steps.

Prints one JSON object (and writes it to ``--out`` if given).  Needs a
CUDA card.

    python scripts/profile_train_torch.py --batch 8 --steps 5 --profile-steps 2
    python scripts/profile_train_torch.py --model-cfg avit_big --optim-cfg adamw --batch 8
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.training import module_class

# Kernel-name fragments of each part, checked in this order.
PARTS = (
    ("temporal backward (K1 or K3)", ("gemm_nt_kernel", "wgrad_kernel", "plane_sums_kernel",
                                      "attention_bwd_kernel", "in_apply_kernel")),
    ("temporal forward (K1 or K3)", ("qkv_attention_kernel", "out_proj_kernel",
                                     "plane_stats_kernel")),
    ("K2 backward", ("axial_line_bwd_kernel",)),
    ("K2 forward", ("axial_line_kernel",)),
    ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sgemm")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise and copies", ("elementwise", "Elementwise", "copy", "Copy", "memcpy",
                                "Memcpy", "memset", "Memset", "fill", "Fill", "cat", "index")),
)


def part_of(name: str) -> str:
    for part, fragments in PARTS:
        if any(f in name for f in fragments):
            return part
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-cfg", default=None, help="model config group (default: the default's)")
    ap.add_argument("--optim-cfg", default=None, help="optimizer config group")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON summary to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    cfg = load_config([f"{group}={name}" for group, name in (
        ("model_cfg", args.model_cfg), ("optim_cfg", args.optim_cfg)) if name])
    module = module_class(cfg["model_cfg"], cfg["data_cfg"])(
        cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"],
        total_steps=10_000, compute_dtype="bfloat16", device="cuda", seed=args.seed)
    module.step = 2 * cfg["scheduler_cfg"]["params"]["warmup_iters"]  # lr > 0: every update moves
    batch = tuple(torch.from_numpy(a).to(dev) for a in synthetic_batch(
        args.batch, cfg["data_cfg"]["time_window"], len(cfg["data_cfg"]["input_fields"]),
        args.size, args.size, cfg["model_cfg"]["params"].get("num_fluid_params", 9),
        seed=args.seed))
    gen = torch.Generator(device=dev)

    def step(i):
        return module.train_step(batch, gen.manual_seed(args.seed + i))

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(args.steps):
        step(args.warmup + i)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.profile_steps):
            step(args.warmup + args.steps + i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_part, per_kernel, launches = defaultdict(float), defaultdict(float), 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            per_part[part_of(evt.name)] += us / 1e3
            per_kernel[evt.name] += us / 1e3
            launches += 1
    busy_ms = sum(per_part.values())
    n = args.profile_steps
    out = {
        "card": card, "model": cfg["model_cfg"]["name"],
        "embed_dim": cfg["model_cfg"]["params"]["embed_dim"], "optimizer": cfg["optim_cfg"]["name"],
        "batch": args.batch, "size": args.size,
        "ms_per_step": ms, "samples_per_s": 1e3 * args.batch / ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled_wall_ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "kernels_per_step": launches / n,
        "parts_ms_per_step": {k: v / n for k, v in sorted(per_part.items(),
                                                        key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k[:120]: v / n for k, v in sorted(
            per_kernel.items(), key=lambda kv: -kv[1])[:25]},
    }
    if not busy_ms:
        out["note"] = "torch.profiler recorded no device time; only the CUDA-event step time holds"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
