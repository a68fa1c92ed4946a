#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one CUDA card.

Drives the port's two paths on FiLMAViT-small (patch 16, embed 384, 6 heads,
12 blocks) on 512x512 windows of 5 frames, 4 fields and 9 fluid parameters,
with random weights drawn from a seed: the serving path (the autoregressive
rollout) and the training path (``Trainer.fit`` with Lion and cosine
warmup), and checks the hand-written kernels on the way, each at both shapes
its paths give it — the rollout's (batch 1) and the training step's
(batch 8):

1. environment: torch, CUDA, the card, ``nvidia-smi`` name and power limit;
2. build: compile ``bubbleformer_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. K1 forward (``mega_temporal_block``) against ``temporal_branch_plain``,
   x (1, 5, 32, 32, 384) and (8, 5, 32, 32, 384), float32 and bfloat16,
   with both times;
4. K2 forward (``lane_axial_attention``) against ``axial_attention_plain``,
   qkv (5, 32, 32, 1152) and (40, 32, 32, 1152), likewise;
5. one float32 window of the whole model on the card (kernels) against the
   same model on the CPU (plain versions);
6. a 20-window bfloat16 rollout through ``inference/rollout.py``: finite, and
   each forward kernel launched 12 x 20 times; frames/s after one warm-up
   window;
7. K1 backward (``mega_temporal_block_bwd``) against
   ``temporal_branch_bwd_plain`` at phase 3's two shapes, every gradient,
   float32 and bfloat16, with both times;
8. K2 backward (``lane_axial_attention_bwd``) against
   ``axial_attention_bwd_plain`` at phase 4's two shapes, likewise;
9. one float32 training step, batch 1, against the same step in float64 on
   the CPU: the loss and every parameter gradient, on the card through the
   kernels, on the card through the plain versions (the witness of the
   card's own float32) and on the CPU; once with FiLM drawn near identity
   and once with the FiLM projection at O(0.1), where the first
   InstanceNorm's statistics cancel (the same drop-path masks, drawn by a
   CPU generator, on every side);
10. ``Trainer.fit`` in bfloat16 at batch 8 on synthetic batches, Lion and a
   2-step cosine warmup: every loss finite, each of the four kernels
   launched 12 times per step, every parameter with a gradient moved, the
   checkpoint written and resumed; ms/step, samples/s and peak memory
   after one warm-up step.

Prints a JSON line of the kernels at the training step's shapes (with each
one's least possible time on the card from its bytes and operations there),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero at the first failed
phase, without a CUDA card, or without the repository beside it.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
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
# H100 SXM peaks (NVIDIA's data sheet): bf16 dense tensor cores, float32
# outside them, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
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


def compare_grads(name: str, names, got, ref, rtol: float) -> float:
    """``compare`` for a tuple of gradients: each within ``rtol`` of its
    reference's largest magnitude, those in ``ZERO_GRADS`` within ``rtol``
    of a hundredth of the largest of all.  Prints each gradient's error and
    scale; returns the largest absolute error."""
    import torch

    pairs = [(n, g.float(), r.float()) for n, g, r in zip(names, got, ref) if r is not None]
    floor = 1e-2 * max(r.abs().max().item() for _, _, r in pairs)
    worst, worst_rel, rows = 0.0, 0.0, []
    for n, g, r in pairs:
        if not torch.isfinite(g).all():
            fail(f"{name} {n}: non-finite gradient")
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        rel = err / (floor if n in ZERO_GRADS else max(scale, 1e-30))
        rows.append(f"{n} {rel:.1e}/{scale:.1e}")
        if rel > rtol:
            print("  " + ", ".join(rows))
            fail(f"{name} {n}: rel {rel:.3e} above {rtol:.0e}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"  {name}: {len(pairs)} gradients, max_abs_err={worst:.3e} max rel={worst_rel:.3e} "
          f"(tol {rtol:.0e}) ok; rel/scale: " + ", ".join(rows), flush=True)
    return worst


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


def train_step_grads(train_cfgs, weights, batch, where: str, dtype, plain: bool = False):
    """``(loss, {name: gradient in float64 on the CPU}, seconds)`` of one
    training step from ``weights`` on ``batch``; ``plain`` takes
    :func:`plain_attention`."""
    import torch
    from bubbleformer_tpu_torch.training import ConditionedForecastModule

    module = ConditionedForecastModule(*train_cfgs, total_steps=8, device=where, seed=SEED)
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
    activation dtype, the other parameters and their gradients float32.

    K1 (x of (B, T, H, W, C), R = B*T*H*W tokens): the QKV product 2R*C*3C,
    the output product 2R*C*C, the attention 4R*T*C; it reads x and writes
    the output and, for the backward, the rounded qkv (R, 3C) and the
    float32 ao (R, C).  The backward does four products (dy2, dW_out, dxn,
    dW_qkv) and five T x T contractions; it reads do, x, qkv and ao and
    writes dx and the float32 weight gradients.  K2 (qkv of (BT, H, W, 3C)):
    per direction, logits and values 4R*L*C forward, and five L x L
    contractions 10R*L*C backward, with L = W for rows and H for columns."""
    e = 2 if dtype == "bfloat16" else 4
    if key.startswith("K1"):
        b, t, h, w, c = shape
        r = b * t * h * w
        params = 4 * (8 * c + 4 * 64 + 4 * c + c) + e * 4 * c * c  # vectors + W_qkv, W_out
        if key == "K1":
            return (2 * r * c * 4 * c + 4 * r * t * c,
                    2 * e * r * c + e * r * 3 * c + 4 * r * c + params)
        return (2 * r * c * 3 * c * 2 + 2 * r * c * c * 2 + 10 * r * t * c,
                3 * e * r * c + e * r * 3 * c + 4 * r * c + params + 4 * 4 * c * c)
    bt, h, w, c3 = shape
    c = c3 // 3
    r = bt * h * w
    if key == "K2":
        return 4 * r * (h + w) * c, e * r * (c3 + c)
    return 10 * r * (h + w) * c, e * r * (2 * c3 + c)


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
    from bubbleformer_tpu_torch.config import FILM_AVIT_SMALL, load_config
    from bubbleformer_tpu_torch.data import SyntheticLoader, synthetic_batch
    from bubbleformer_tpu_torch.inference import make_rollout_fn
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.ops.axial_lane import (
        axial_attention_bwd_plain,
        axial_attention_plain,
        lane_axial_attention,
        lane_axial_attention_bwd,
    )
    from bubbleformer_tpu_torch.ops.temporal_block_mega import (
        PARAM_NAMES,
        mega_temporal_block,
        mega_temporal_block_bwd,
        mega_temporal_block_fwd,
        temporal_branch_bwd_plain,
        temporal_branch_plain,
    )
    from bubbleformer_tpu_torch.training import (
        ConditionedForecastModule,
        Trainer,
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
            plain_ms = cuda_ms(lambda: temporal_branch_plain(**args, heads=heads))
            print(f"  K1 {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            results[("K1", name, where)] = (err, ms, plain_ms)

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
            plain_ms = cuda_ms(lambda: axial_attention_plain(**args, heads=heads))
            print(f"  K2 {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            results[("K2", name, where)] = (err, ms, plain_ms)

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
            plain_ms = cuda_ms(lambda: temporal_branch_bwd_plain(do, **args, heads=heads))
            print(f"  K1 bwd {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            results[("K1 bwd", name, where)] = (err, ms, plain_ms)
            del res
    del k1_x, k1_do

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
            plain_ms = cuda_ms(lambda: axial_attention_bwd_plain(do, **args, heads=heads))
            print(f"  K2 bwd {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            results[("K2 bwd", name, where)] = (err, ms, plain_ms)
    del k2_qkv, k2_do

    print(f"== phase 9: one float32 training step vs float64, batch 1 at {IMAGE}^2", flush=True)
    cfg = load_config(["scheduler_cfg.params.warmup_iters=2"])
    train_cfgs = (cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"])
    if train_cfgs[0] != FILM_AVIT_SMALL:
        fail("the default composition's model is not FiLMAViT-small")
    batch = synthetic_batch(1, TIME_WINDOW, FIELDS, IMAGE, IMAGE, 9, seed=SEED)
    counters = (mega_temporal_block, mega_temporal_block_bwd, lane_axial_attention,
                lane_axial_attention_bwd)
    sides = (("card", "cuda", False), ("card plain", "cuda", True), ("CPU", "cpu", False))
    for case, case_weights in (("FiLM near identity", film_near_identity(weights, SEED)),
                               ("FiLM at O(0.1)", weights)):
        ref_loss, ref, t64 = train_step_grads(train_cfgs, case_weights, batch, "cpu",
                                              torch.float64)
        print(f"  {case}: CPU float64 step {t64:.2f} s, loss {ref_loss:.7f}")
        worst = {}
        for side, where, plain in sides:
            counts = [fn.launches for fn in counters]
            loss, grads, secs = train_step_grads(train_cfgs, case_weights, batch, where,
                                                 torch.float32, plain)
            launched = [fn.launches - n for fn, n in zip(counters, counts)]
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
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(SyntheticLoader(TRAIN_STEPS, TRAIN_BATCH, TIME_WINDOW, FIELDS, IMAGE, 9,
                                seed=SEED + 2), max_epochs=1)
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds = trainer.last_epoch_seconds
    with open(log_dir / "metrics.csv") as f:
        losses = [float(row.split(",")[3]) for row in f.read().splitlines()[1:]]
    print(f"  losses {losses}")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    for fn_name, n in train_launches.items():
        if n != 12 * TRAIN_STEPS:
            fail(f"{fn_name} launched {n} times in {TRAIN_STEPS} steps, "
                 f"expected {12 * TRAIN_STEPS}")
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
    print(f"  {TRAIN_STEPS} steps in {seconds:.3f} s: {1000 * seconds / TRAIN_STEPS:.1f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} samples/s; peak memory {peak_gb:.2f} GB; "
          f"{moved}/{len(before)} parameters moved; resumed at step {resumed.step} "
          f"({card}); launches {train_launches}", flush=True)
    del module, resumed, trainer
    shutil.rmtree(log_dir, ignore_errors=True)

    kernels = []
    for key, name, source, replaces in (
        ("K1", "mega_temporal_block", "bubbleformer_tpu_torch/csrc/temporal_block.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:238"),
        ("K2", "lane_axial_attention", "bubbleformer_tpu_torch/csrc/axial_attention.cu",
         "bubbleformer_tpu/ops/axial_lane.py:236"),
        ("K1 bwd", "mega_temporal_block_bwd",
         "bubbleformer_tpu_torch/csrc/temporal_block_bwd.cu",
         "bubbleformer_tpu/ops/temporal_block_mega.py:269"),
        ("K2 bwd", "lane_axial_attention_bwd", "bubbleformer_tpu_torch/csrc/axial_attention.cu",
         "bubbleformer_tpu/ops/axial_lane.py:370"),
    ):
        # The launches are the training run's, so every number beside them is
        # taken at the training step's shape.
        shape = shapes[key[:2]]["training"]
        err, ms, plain_ms = results[(key, "bfloat16", "training")]
        bound_ms, bound_by = bound(*kernel_work(key, shape, "bfloat16"), "bfloat16")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
        for where in ("rollout", "training"):
            for dt in ("float32", "bfloat16"):
                b_ms, b_by = bound(*kernel_work(key, shapes[key[:2]][where], dt), dt)
                _, k_ms, p_ms = results[(key, dt, where)]
                print(f"  {name} {where} {shapes[key[:2]][where]} {dt}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        print(f"  {name}: launches per rollout window {launches.get(key, 0) // WINDOWS}, "
              f"per training step {train_launches[name] // TRAIN_STEPS}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
