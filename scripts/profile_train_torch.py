#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one card.

Builds the training module of a composition — by default the default one,
FiLMAViT-small with Lion and cosine warmup; ``--model-cfg`` and
``--optim-cfg`` pick other config groups (``avit_big`` and ``adamw`` for the
README's quick-start) and further ``key=value`` overrides follow as
arguments (``data_cfg=flowboiling_chf`` for the README's flow-boiling
command) — with bfloat16 activations and float32 parameters at ``--batch``
on synthetic batches already on the card, of ``--height`` x ``--width``
pixels (``--size`` for square frames, 512 by default), runs warm-up steps,
times ``--steps`` steps with CUDA events (ms/step, samples/s, peak memory),
then traces ``--profile-steps`` more with ``torch.profiler`` and sums the
device time of every kernel by part: the port's hand-written kernels (K1's
and K3's bf16 chains run their products on the Hopper GEMM,
``csrc/hopper_gemm.cuh``; the whole-branch kernels K1 and K3 (in float32)
and K5 and the in-kernel projection of K9 share their products and
statistics kernels, ``csrc/block_ops.cuh``; K2's bf16 path runs on its
Hopper kernels, ``csrc/lane_hopper.cuh``, and so do K4's and K5's and K9's
bf16 attention, K5's and K9's products on the Hopper GEMM; K8's bf16 path
runs on ``csrc/flash_hopper.cuh``; the line kernels serve K2, K4, K5, K8
and K9 in float32 and K6, K7; K10 is the loss's plane norms), matrix
products (cuBLAS), the
optimizer's foreach kernels, and the rest (elementwise, reductions,
copies); and by kernel wrapper (``WRAPPERS``:
each call of a wrapper is traced as one range, whose device time is that
of every kernel it launched).  The idle share is one minus the summed
kernel time over the host-clock wall time of the traced steps.  The
training module's knobs apply: ``loss_layout=nhwc`` as an override, K10
with ``BUBBLEFORMER_LOSS_KERNEL=1`` in the environment; so do the model's:
per-block activation checkpointing with ``model_cfg.params.remat=false``
or ``model_cfg.params.remat_policy=full`` (default: on, ``"dots"``), K9 (the
lane route's projection in the kernel) with ``BUBBLEFORMER_LANE_PROJ=kernel``.
The JSON records each.

Prints one JSON object (and writes it to ``--out`` if given).  Needs a
CUDA card.

    python scripts/profile_train_torch.py --batch 8 --steps 5 --profile-steps 2
    python scripts/profile_train_torch.py --model-cfg avit_big --optim-cfg adamw --batch 8
    python scripts/profile_train_torch.py --model-cfg avit_small --height 512 --width 2048 \
        --batch 4 data_cfg=flowboiling_chf
    python scripts/profile_train_torch.py --model-cfg avit_small \
        model_cfg.params.attn_impl=fused_block --batch 8
    python scripts/profile_train_torch.py --batch 8 model_cfg.params.attn_impl=mega
    BUBBLEFORMER_LOSS_KERNEL=1 python scripts/profile_train_torch.py --batch 8 \
        model_cfg.params.attn_impl=flash
    python scripts/profile_train_torch.py --batch 8 model_cfg.params.attn_impl=flash \
        loss_layout=nhwc
    BUBBLEFORMER_LANE_PROJ=kernel python scripts/profile_train_torch.py --batch 8
    python scripts/profile_train_torch.py --batch 8 model_cfg.params.remat=false
    python scripts/profile_train_torch.py --batch 8 model_cfg.params.remat_policy=full
    BUBBLEFORMER_LANE_PROJ=kernel python scripts/profile_train_torch.py --model-cfg avit_small \
        --height 512 --width 2048 --batch 8 data_cfg=flowboiling_chf
    BUBBLEFORMER_LOSS_KERNEL=1 python scripts/profile_train_torch.py --model-cfg unet_modern \
        --batch 8
    BUBBLEFORMER_LOSS_KERNEL=1 python scripts/profile_train_torch.py --model-cfg unet_classic \
        --batch 8

The U-Nets have no attention, embedding or remat: their JSON has
``embed_dim``, ``attn_impl``, ``lane_proj``, ``remat`` and ``remat_policy``
null and names the absent fields in ``fields_absent``; their convolutions
(cuDNN) are a part of their own.
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
    ("K1, K3, K5, K9 bf16 products (Hopper GEMM)", ("hg::gemm_kernel", "splitk_sum_kernel")),
    ("K1, K3 bf16 attention passes; norm apply and plane totals (K1, K5)", (
        "temporal_attention", "in_norm_kernel", "plane_totals_kernel")),
    ("branch products and norms, backward (K1, K3, K5, K9)", (
        "gemm_nt_kernel", "wgrad_kernel", "plane_sums_kernel", "in_apply_kernel")),
    ("temporal attention backward (K1, K3 float32)", ("attention_bwd_kernel",)),
    ("branch products and norms, forward (K1, K3, K5, K9)", ("norm_proj_kernel",
                                                             "plane_stats_kernel")),
    ("temporal QKV and attention forward (K1, K3 float32)", ("qkv_attention",)),
    ("K2, K4, K5, K9 bf16 lane kernels (Hopper)", ("lane_fwd_kernel", "lane_bwd_short_kernel",
                                                    "lane_bwd_long_kernel")),
    ("K8 bf16 flash kernels (Hopper)", ("flash_fwd_kernel", "flash_bwd_kernel")),
    ("attention parameter sums, fixed order (K2, K4-K9)", ("param_sum_kernel",)),
    ("line kernels backward (f32 K2, K4, K5, K8, K9; K6, K7)", ("line_bwd_q_kernel",
                                                               "line_bwd_kv_kernel")),
    ("line kernels forward (f32 K2, K4, K5, K8, K9; K6, K7)", ("line_fwd_kernel",
                                                              "line_short_fwd_kernel")),
    ("loss plane norms (K10)", ("norms_partial_kernel", "norms_finish_kernel", "dpred_kernel")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "nchwToNhwc",
                              "nhwcToNchw")),
    ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sgemm")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise and copies", ("elementwise", "Elementwise", "copy", "Copy", "memcpy",
                                "Memcpy", "memset", "Memset", "fill", "Fill", "cat", "index")),
)


# The JSON's fields only the AViTs have (null for the U-Nets).
VIT_FIELDS = ("embed_dim", "attn_impl", "lane_proj", "remat", "remat_policy")


def part_of(name: str) -> str:
    for part, fragments in PARTS:
        if any(f in name for f in fragments):
            return part
    return "other"


# The kernel wrappers by module: the functions a forward or a backward of
# each kernel goes through, looked up by name when they are called, so a
# traced range can wrap each call.
WRAPPERS = {
    "temporal_block_mega": {"mega_temporal_block_fwd": "K1 forward",
                            "mega_temporal_block_bwd": "K1 backward",
                            "core_temporal_attention_fwd": "K3 forward",
                            "core_temporal_attention_bwd": "K3 backward"},
    "axial_lane": {"_lane_fwd": "K2 forward", "lane_axial_attention_bwd": "K2 backward"},
    "axial_lane_px": {"_px_fwd": "K9 forward", "lane_px_attention_bwd": "K9 backward"},
    "axial_fused_block": {"_fused_block_fwd": "K4 forward",
                          "fused_block_attention_bwd": "K4 backward"},
    "axial_block_mega": {"mega_axial_block_fwd": "K5 forward",
                         "mega_axial_block_bwd": "K5 backward"},
    "axial_fused_packed": {"_packed_fwd": "K6 forward",
                           "fused_axial_attention_packed_bwd": "K6 backward"},
    "axial_fused": {"_fused_fwd": "K7 forward", "fused_axial_attention_bwd": "K7 backward"},
    "axial_pallas": {"_flash_fwd": "K8 forward", "flash_packed_attention_bwd": "K8 backward"},
    "lp_loss": {"plane_norms_fwd_cuda": "K10 forward", "plane_norms_bwd": "K10 backward"},
}


def trace_wrappers() -> None:
    """Wrap each function of ``WRAPPERS`` in a ``torch.profiler`` range of
    its label (the profile's only instrumentation; the port has none)."""
    import functools
    import importlib

    def traced(fn, label):
        @functools.wraps(fn)  # keeps the launch counter some wrappers add to by name
        def call(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call

    for module, names in WRAPPERS.items():
        mod = importlib.import_module(f"bubbleformer_tpu_torch.ops.{module}")
        for name, label in names.items():
            setattr(mod, name, traced(getattr(mod, name), label))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-cfg", default=None, help="model config group (default: the default's)")
    ap.add_argument("--optim-cfg", default=None, help="optimizer config group")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512, help="square frames of this many pixels")
    ap.add_argument("--height", type=int, default=None, help="frame height (default --size)")
    ap.add_argument("--width", type=int, default=None, help="frame width (default --size)")
    ap.add_argument("overrides", nargs="*", help="further config overrides, key=value")
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

    trace_wrappers()
    height, width = args.height or args.size, args.width or args.size
    cfg = load_config([f"{group}={name}" for group, name in (
        ("model_cfg", args.model_cfg), ("optim_cfg", args.optim_cfg)) if name] + args.overrides)
    module = module_class(cfg["model_cfg"], cfg["data_cfg"])(
        cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"],
        total_steps=10_000, compute_dtype="bfloat16", device="cuda", seed=args.seed,
        loss_layout=cfg.get("loss_layout"))
    module.step = 2 * cfg["scheduler_cfg"]["params"]["warmup_iters"]  # lr > 0: every update moves
    is_vit = hasattr(module.model, "blocks")  # an AViT: attention routes and remat
    batch = tuple(torch.from_numpy(a).to(dev) for a in synthetic_batch(
        args.batch, cfg["data_cfg"]["time_window"], len(cfg["data_cfg"]["input_fields"]),
        height, width, cfg["model_cfg"]["params"].get("num_fluid_params", 9),
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
    # The wrappers' ranges also appear on the device timeline, as annotations
    # spanning the kernels launched inside them: not kernels themselves, but
    # each one's span there is the wrapper's device time (its kernels run
    # back to back on one stream).
    labels = {label for names in WRAPPERS.values() for label in names.values()}
    per_part, per_kernel, per_wrapper = defaultdict(float), defaultdict(float), defaultdict(float)
    unlabelled = defaultdict(float)
    launches = 0
    for evt in prof.events():
        if evt.name in labels:
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                per_wrapper[evt.name] += evt.time_range.elapsed_us() / 1e3
        elif getattr(evt, "is_user_annotation", False):
            # A range that did not come back by its label: not a kernel.
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                unlabelled[evt.name[:60]] += evt.time_range.elapsed_us() / 1e3
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            per_part[part_of(evt.name)] += us / 1e3
            per_kernel[evt.name] += us / 1e3
            launches += 1
    busy_ms = sum(per_part.values())
    n = args.profile_steps
    out = {
        "card": card, "model": cfg["model_cfg"]["name"],
        "embed_dim": module.model.embed_dim if is_vit else None,
        "optimizer": cfg["optim_cfg"]["name"],
        "attn_impl": cfg["model_cfg"]["params"].get("attn_impl", "auto") if is_vit else None,
        "loss_layout": module.loss_layout,
        "loss_kernel": os.environ.get("BUBBLEFORMER_LOSS_KERNEL", "0") == "1",
        "lane_proj": os.environ.get("BUBBLEFORMER_LANE_PROJ", "xla") if is_vit else None,
        "remat": module.model.remat if is_vit else None,
        "remat_policy": module.model.remat_policy if is_vit else None,
        "fields_absent": [] if is_vit else list(VIT_FIELDS),
        "batch": args.batch, "height": height, "width": width,
        "ms_per_step": ms, "samples_per_s": 1e3 * args.batch / ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled_wall_ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "kernels_per_step": launches / n,
        "parts_ms_per_step": {k: v / n for k, v in sorted(per_part.items(),
                                                        key=lambda kv: -kv[1])},
        "kernel_wrappers_ms_per_step": {k: v / n for k, v in sorted(per_wrapper.items(),
                                                                  key=lambda kv: -kv[1])},
        "unlabelled_ranges_ms_per_step": {k: v / n for k, v in unlabelled.items()},
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
