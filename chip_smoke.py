#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one CUDA card.

Drives the port's serving path — the autoregressive rollout of FiLMAViT-small
(patch 16, embed 384, 6 heads, 12 blocks) on 512x512 windows of 5 frames, 4
fields and 9 fluid parameters — with random weights drawn from a seed, and
checks its hand-written kernels on the way:

1. environment: torch, CUDA, the card, ``nvidia-smi`` name and power limit;
2. build: compile ``bubbleformer_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. K1 (``mega_temporal_block``) against ``temporal_branch_plain`` at the
   slice shape, float32 and bfloat16, with both times;
4. K2 (``lane_axial_attention``) against ``axial_attention_plain``, likewise;
5. one float32 window of the whole model on the card (kernels) against the
   same model on the CPU (plain versions);
6. a 20-window bfloat16 rollout through ``inference/rollout.py``: finite, and
   each kernel launched 12 x 20 times; frames/s after one warm-up window.

Prints a JSON line of the kernels, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.  Exits non-zero at the first
failed phase, without a CUDA card, or without the repository beside it.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
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
# scripts/make_sample_data.py:77-86, trajectory 0, in FLUID_PARAM_KEYS order.
FLUID_PARAMS = [0.0084, 0.83, 1.0, 0.0083, 0.25, 0.063, 8.34, 0.4, 91.0]

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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def main() -> None:
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

    from bubbleformer_tpu_torch import _build
    from bubbleformer_tpu_torch.config import FILM_AVIT_SMALL
    from bubbleformer_tpu_torch.inference import make_rollout_fn
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.ops.axial_lane import (
        axial_attention_plain,
        lane_axial_attention,
    )
    from bubbleformer_tpu_torch.ops.temporal_block_mega import (
        mega_temporal_block,
        temporal_branch_plain,
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

    print(f"== phase 3: K1 mega_temporal_block vs plain, (1, {t}, {grid}, {grid}, {c})",
          flush=True)
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
    for dt in (torch.float32, torch.bfloat16):
        args = dict(k1, x=k1["x"].to(dt))
        got = mega_temporal_block(**args, heads=heads)
        ref = temporal_branch_plain(**args, heads=heads)
        torch.cuda.synchronize()
        name = str(dt).split(".")[-1]
        err = compare(f"K1 {name}", got, ref, KERNEL_RTOL[name])
        ms = cuda_ms(lambda: mega_temporal_block(**args, heads=heads))
        plain_ms = cuda_ms(lambda: temporal_branch_plain(**args, heads=heads))
        print(f"  K1 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        results[("K1", name)] = (err, ms, plain_ms)

    print(f"== phase 4: K2 lane_axial_attention vs plain, ({t}, {grid}, {grid}, {3 * c})",
          flush=True)
    k2 = dict(
        qkv=randn(t, grid, grid, 3 * c), qn_scale=k1["qn_scale"].cpu(),
        qn_bias=k1["qn_bias"].cpu(), kn_scale=k1["kn_scale"].cpu(), kn_bias=k1["kn_bias"].cpu(),
        bias_x=randn(heads, grid, grid), bias_y=randn(heads, grid, grid),
        scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
        scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    k2 = {k: v.to(dev) for k, v in k2.items()}
    for dt in (torch.float32, torch.bfloat16):
        args = dict(k2, qkv=k2["qkv"].to(dt))
        got = lane_axial_attention(**args, heads=heads)
        ref = axial_attention_plain(**args, heads=heads)
        torch.cuda.synchronize()
        name = str(dt).split(".")[-1]
        err = compare(f"K2 {name}", got, ref, KERNEL_RTOL[name])
        ms = cuda_ms(lambda: lane_axial_attention(**args, heads=heads))
        plain_ms = cuda_ms(lambda: axial_attention_plain(**args, heads=heads))
        print(f"  K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        results[("K2", name)] = (err, ms, plain_ms)

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
    mega_temporal_block.launches = 0
    lane_axial_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = rollout(init, cond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"K1": mega_temporal_block.launches, "K2": lane_axial_attention.launches}
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

    kernels = []
    for key, name, source, replaces in (
        ("K1", "mega_temporal_block", "bubbleformer_tpu_torch/csrc/temporal_block.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:238"),
        ("K2", "lane_axial_attention", "bubbleformer_tpu_torch/csrc/axial_attention.cu",
         "bubbleformer_tpu/ops/axial_lane.py:236"),
    ):
        err, ms, plain_ms = results[(key, "bfloat16")]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[key], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
