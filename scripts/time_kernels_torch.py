#!/usr/bin/env python3
"""Time the port's whole-branch and projection kernels at their training
steps' shapes, to compare two checkouts on one card.

K1 (the temporal branch, ``mega_temporal_block``) at x (8, 5, 32, 32, 384),
FiLMAViT-small's, and at head dim 16, x (8, 5, 64, 64, 96), AViT-tiny's at
512x512; K2 (the lane axial attention, ``lane_axial_attention``) at qkv (40,
32, 32, 1152), FiLMAViT-small's, AViT-big's (40, 32, 32, 2304) at 12 heads,
the flow-boiling grid's at batch 4 and 8, (20, 32, 128, 1152) and (40, 32,
128, 1152), and AViT-tiny's at 512x2048 at head dim 16, (20, 64, 256, 288),
and at the bf16 rollouts' batch 1 (BT = 5): FiLMAViT-small's (5, 32, 32,
1152), AViT-big's (5, 32, 32, 2304) and AViT-small's at 512x2048 (5, 32,
128, 1152);
K3 (the streamed temporal core, ``core_temporal_attention``)
at AViT-big's xn (8, 5, 32, 32, 768), AViT-small's on the flow-boiling grid
at batch 4 and 8, (4, 5, 32, 128, 384) and (8, 5, 32, 128, 384), and
AViT-tiny's there at head dim 16, (4, 5, 64, 256, 96), through its autograd
Function as a training step without remat calls it (the backward alone by
``torch.autograd.grad`` on a kept graph); K5 (the mega axial block,
``mega_axial_block``) and K9 (the lane route with the projection in the
kernel, ``lane_px_attention``) at x (40, 32, 32, 384), and at the other
shapes chip_smoke.py holds them at: K5 at the rollout's (5, 32, 32, 384)
and AViT-tiny's (40, 64, 64, 96), K9 at the rollout's, the flow-boiling
grid's at batch 4 and 8, (20, 32, 128, 384) and (40, 32, 128, 384), and
AViT-tiny's; and the other line-kernel routes at their training steps'
shapes: K4 (``fused_block_attention``) at qkv (40, 32, 32, 1152), K6 and K7
(``fused_axial_attention_packed``, ``fused_axial_attention``) at q (40, 32,
32, 6, 64), K8 (``flash_packed_attention``) at the axial lines (6, 1280,
32, 64) and the temporal ones (6, 8192, 5, 64).  Forward and
backward, in bfloat16 and float32, by CUDA events (20 calls after at least
``WARMUP_S`` seconds of warm-up calls), from the checkout given by
``--repo`` (default: this one), whose kernels it builds first.  Then, in
bfloat16 at K1's first shape and at K3's AViT-big shape, K2's at
FiLMAViT-small's and the flow-boiling grid's at batch 4, K5's and K9's at x
(40, 32, 32, 384), and in float32 K4's and K8's temporal backward, the
device time of each kernel one forward and one
backward launch, by ``torch.profiler`` (the mean of 5 traced calls; names
shortened), which reads any checkout alike.  Comparing two versions of the
kernels takes two processes on one card, one per checkout, in turns:

    python3 scripts/time_kernels_torch.py --repo build/parent --label parent
    python3 scripts/time_kernels_torch.py --label change

``--only K2`` times only the entries whose key starts with a given prefix
(``--only K5`` and ``--only K9`` time K5 and K9 at all their shapes).
Prints one JSON line with the card's name and power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

# Seconds of warm-up calls before each timing.  Three calls alone left a
# float32 kernel's time dependent on the load that ran before it: the same
# SASS read 3% apart after three calls and within 0.4% after one second.
WARMUP_S = 1.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="", help="time only the keys with this prefix")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_kernels_torch.py needs a CUDA card")
    from bubbleformer_tpu_torch import _build
    from bubbleformer_tpu_torch.ops import axial_block_mega as k5
    from bubbleformer_tpu_torch.ops import axial_fused as k7
    from bubbleformer_tpu_torch.ops import axial_fused_block as k4
    from bubbleformer_tpu_torch.ops import axial_fused_packed as k6
    from bubbleformer_tpu_torch.ops import axial_pallas as k8
    from bubbleformer_tpu_torch.ops import axial_lane as k2
    from bubbleformer_tpu_torch.ops import axial_lane_px as k9
    from bubbleformer_tpu_torch.ops import temporal_block_mega as k1

    _build.library()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32)).to(
            dev)

    def ln(d):
        return [n(d, scale=0.1, offset=1.0), n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
                n(d, scale=0.1)]

    def branch(shape, heads):
        """K1's arguments at x of (B, T, H, W, C), or K5's at x of (BT, H, W, C)."""
        c, d = shape[-1], shape[-1] // heads
        p = [n(c, scale=0.1, offset=1.0), n(c, scale=0.1), n(3 * c, c, scale=c**-0.5),
             n(3 * c, scale=0.1), *ln(d), n(c, scale=0.1, offset=1.0), n(c, scale=0.1),
             n(c, c, scale=c**-0.5), n(c, scale=0.1)]
        if len(shape) == 5:
            return n(*shape), p + [n(heads, shape[1], shape[1]), n(heads, scale=0.2, offset=1.0)]
        return n(*shape), p + [n(heads, shape[2], shape[2]), n(heads, shape[1], shape[1]),
                               n(heads, scale=0.2, offset=1.0), n(heads, scale=0.2, offset=1.0)]

    heads, c, d, t = 6, 384, 64, 5
    k2_args = dict(qkv=n(40, 32, 32, 3 * c), qn_scale=n(d, scale=0.1, offset=1.0),
                   qn_bias=n(d, scale=0.1), kn_scale=n(d, scale=0.1, offset=1.0),
                   kn_bias=n(d, scale=0.1), bias_x=n(heads, 32, 32), bias_y=n(heads, 32, 32),
                   scale_x=n(heads, scale=0.2, offset=1.0), scale_y=n(heads, scale=0.2, offset=1.0))
    k9_x, k9_params = n(40, 32, 32, c), [n(3 * c, c, scale=c**-0.5), n(3 * c, scale=0.1), *ln(d),
                                         n(heads, 32, 32), n(heads, 32, 32),
                                         n(heads, scale=0.2, offset=1.0),
                                         n(heads, scale=0.2, offset=1.0)]

    def wanted(key):
        return key.startswith(args.only)

    def k9_args(shape, h):
        """K9's arguments after x of (BT, H, W, C)."""
        cc, hh, ww = shape[-1], shape[1], shape[2]
        return [n(3 * cc, cc, scale=cc**-0.5), n(3 * cc, scale=0.1), *ln(cc // h),
                n(h, ww, ww), n(h, hh, hh), n(h, scale=0.2, offset=1.0),
                n(h, scale=0.2, offset=1.0)]

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARMUP_S:
            fn()
            torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    out = {"label": args.label, "repo": args.repo, "card": card}
    branches = {"K1": ((8, t, 32, 32, c), 6, k1.mega_temporal_block_fwd,
                       k1.mega_temporal_block_bwd),
                "K1 d16": ((8, t, 64, 64, 96), 6, k1.mega_temporal_block_fwd,
                           k1.mega_temporal_block_bwd),
                "K5": ((40, 32, 32, c), 6, k5.mega_axial_block_fwd, k5.mega_axial_block_bwd),
                "K5 rollout": ((5, 32, 32, c), 6, k5.mega_axial_block_fwd,
                               k5.mega_axial_block_bwd),
                "K5 d16": ((40, 64, 64, 96), 6, k5.mega_axial_block_fwd,
                           k5.mega_axial_block_bwd)}
    for key, (shape, h, fwd, bwd) in branches.items():
        if not wanted(key):
            continue
        x32, params = branch(shape, h)
        do32 = n(*shape)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            x, do = x32.to(dt), do32.to(dt)
            _, res = fwd(x, *params, heads=h)
            out[f"{key} {name}"] = ms(lambda: fwd(x, *params, heads=h))
            out[f"{key} bwd {name}"] = ms(lambda: bwd(do, x, *params, heads=h, residuals=res))
            del res
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        qkv, p2 = k2_args["qkv"].to(dt), list(k2_args.values())[1:]
        do2 = torch.randn(40, 32, 32, c, device=dev, dtype=dt)
        if wanted("K2"):
            out[f"K2 {name}"] = ms(lambda: k2.lane_axial_attention(qkv, *p2, heads=heads))
            out[f"K2 bwd {name}"] = ms(lambda: k2.lane_axial_attention_bwd(do2, qkv, *p2,
                                                                           heads=heads))
        if wanted("K9"):
            x9 = k9_x.to(dt)
            out[f"K9 {name}"] = ms(lambda: k9.lane_px_attention(x9, *k9_params, heads=heads))
            out[f"K9 bwd {name}"] = ms(lambda: k9.lane_px_attention_bwd(do2, x9, *k9_params,
                                                                        heads=heads))
    # K9 at the other paths' shapes: x (BT, H, W, C), 6 heads.
    k9_cases = {"rollout": (5, 32, 32, c), "flow_b4": (20, 32, 128, c),
                "flow_b8": (40, 32, 128, c), "d16": (40, 64, 64, 96)}
    for case, shape in k9_cases.items() if wanted("K9") else ():
        p9 = k9_args(shape, heads)
        x32, do32 = n(*shape), n(*shape)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            x9, do9 = x32.to(dt), do32.to(dt)
            out[f"K9 {case} {name}"] = ms(lambda: k9.lane_px_attention(x9, *p9, heads=heads))
            out[f"K9 bwd {case} {name}"] = ms(lambda: k9.lane_px_attention_bwd(do9, x9, *p9,
                                                                               heads=heads))
            del x9, do9
        del x32, do32
    # K4, K6, K7 and K8 (the line kernels' other flavours).
    tables = [n(heads, 32, 32), n(heads, 32, 32), n(heads, scale=0.2, offset=1.0),
              n(heads, scale=0.2, offset=1.0)]
    line_cases = {"K4": (k4.fused_block_attention, k4.fused_block_attention_bwd,
                         [(40, 32, 32, 3 * c)], [*ln(d), *tables], (40, 32, 32, c), True),
                  "K6": (k6.fused_axial_attention_packed, k6.fused_axial_attention_packed_bwd,
                         [(40, 32, 32, heads, d)] * 3, tables, (40, 32, 32, heads, d), False),
                  "K7": (k7.fused_axial_attention, k7.fused_axial_attention_bwd,
                         [(40, 32, 32, heads, d)] * 3, tables, (40, 32, 32, heads, d), False),
                  "K8 axial": (k8.flash_packed_attention, k8.flash_packed_attention_bwd,
                               [(heads, 1280, 32, d)] * 3,
                               [n(heads, 32, 32), n(heads, scale=0.2, offset=1.0)],
                               (heads, 1280, 32, d), False),
                  "K8 temporal": (k8.flash_packed_attention, k8.flash_packed_attention_bwd,
                                  [(heads, 8192, t, d)] * 3,
                                  [n(heads, t, t), n(heads, scale=0.2, offset=1.0)],
                                  (heads, 8192, t, d), False)}
    for key, (fwd, bwd, shapes, rest, out_shape, with_heads) in line_cases.items():
        if not wanted(key):
            continue
        acts32, do32 = [n(*sh) for sh in shapes], n(*out_shape)
        kw = {"heads": heads} if with_heads else {}
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            acts, dol = [a.to(dt) for a in acts32], do32.to(dt)
            out[f"{key} {name}"] = ms(lambda: fwd(*acts, *rest, **kw))
            out[f"{key} bwd {name}"] = ms(lambda: bwd(dol, *acts, *rest, **kw))
            del acts, dol
        del acts32, do32
    # K2 at the other paths' shapes: qkv (BT, H, W, 3C) and heads.
    k2_cases = {"avit_big": ((40, 32, 32, 2304), 12), "flow_b4": ((20, 32, 128, 1152), 6),
                "flow_b8": ((40, 32, 128, 1152), 6), "d16": ((20, 64, 256, 288), 6),
                "rollout": ((5, 32, 32, 1152), 6), "big_rollout": ((5, 32, 32, 2304), 12),
                "flow_rollout": ((5, 32, 128, 1152), 6)}
    for case, (shape, h) in k2_cases.items() if wanted("K2") else ():
        dd, (_, hh, ww, c3) = shape[-1] // 3 // h, shape
        p2 = [*ln(dd), n(h, ww, ww), n(h, hh, hh), n(h, scale=0.2, offset=1.0),
              n(h, scale=0.2, offset=1.0)]
        qkv32, do32 = n(*shape), n(*shape[:-1], c3 // 3)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            qkv, do2 = qkv32.to(dt), do32.to(dt)
            out[f"K2 {case} {name}"] = ms(lambda: k2.lane_axial_attention(qkv, *p2, heads=h))
            out[f"K2 bwd {case} {name}"] = ms(lambda: k2.lane_axial_attention_bwd(do2, qkv, *p2,
                                                                                  heads=h))
            del qkv, do2
        del qkv32, do32
    k3_cases = {"avit_big": ((8, t, 32, 32, 768), 12), "flow_b4": ((4, t, 32, 128, 384), 6),
                "flow_b8": ((8, t, 32, 128, 384), 6), "flow_d16": ((4, t, 64, 256, 96), 6)}

    def k3_args(shape, h):
        cc = shape[-1]
        return [n(3 * cc, cc, scale=cc**-0.5), n(3 * cc, scale=0.1), *ln(cc // h), n(h, t, t),
                n(h, scale=0.2, offset=1.0)]

    for case, (shape, h) in k3_cases.items() if wanted("K3") else ():
        k3_params = k3_args(shape, h)
        xn32 = n(*shape)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            inputs = [xn32.to(dt).requires_grad_(), *(a.requires_grad_() for a in k3_params)]
            y = k1.core_temporal_attention(*inputs, heads=h)
            dao = torch.randn_like(y)
            out[f"K3 {case} {name}"] = ms(lambda: k1.core_temporal_attention(*inputs, heads=h))
            out[f"K3 bwd {case} {name}"] = ms(
                lambda: torch.autograd.grad(y, inputs, dao, retain_graph=True))
            del inputs, y, dao

    # K1's and K3's kernels, one forward and one backward call each, by
    # device time.
    x32, params = branch(branches["K1"][0], 6)
    x, do = x32.to(torch.bfloat16), n(*x32.shape).to(torch.bfloat16)
    _, res = k1.mega_temporal_block_fwd(x, *params, heads=6)
    shape3, h3 = k3_cases["avit_big"]
    xn, p3, dao = n(*shape3).to(torch.bfloat16), k3_args(shape3, h3), n(*shape3).to(torch.bfloat16)
    calls = {"K1 bfloat16 fwd": lambda: k1.mega_temporal_block_fwd(x, *params, heads=6),
             "K1 bfloat16 bwd": lambda: k1.mega_temporal_block_bwd(do, x, *params, heads=6,
                                                                   residuals=res),
             "K3 avit_big bfloat16 fwd": lambda: k1.core_temporal_attention_fwd(xn, *p3,
                                                                                heads=h3),
             "K3 avit_big bfloat16 bwd": lambda: k1.core_temporal_attention_bwd(dao, xn, *p3,
                                                                                heads=h3)}
    qkv2, p2 = k2_args["qkv"].to(torch.bfloat16), list(k2_args.values())[1:]
    do2 = n(*qkv2.shape[:-1], c).to(torch.bfloat16)
    shape_f = k2_cases["flow_b4"][0]
    qkv_f = n(*shape_f).to(torch.bfloat16)
    do_f = n(*shape_f[:-1], shape_f[-1] // 3).to(torch.bfloat16)
    p_f = [*ln(d), n(heads, 128, 128), n(heads, 32, 32), n(heads, scale=0.2, offset=1.0),
           n(heads, scale=0.2, offset=1.0)]
    calls.update({
        "K2 bfloat16 fwd": lambda: k2.lane_axial_attention(qkv2, *p2, heads=heads),
        "K2 bfloat16 bwd": lambda: k2.lane_axial_attention_bwd(do2, qkv2, *p2, heads=heads),
        "K2 flow_b4 bfloat16 fwd": lambda: k2.lane_axial_attention(qkv_f, *p_f, heads=heads),
        "K2 flow_b4 bfloat16 bwd": lambda: k2.lane_axial_attention_bwd(do_f, qkv_f, *p_f,
                                                                       heads=heads)})
    x5, p5 = branch(branches["K5"][0], 6)
    x5, do5 = x5.to(torch.bfloat16), n(*x5.shape).to(torch.bfloat16)
    _, res5 = k5.mega_axial_block_fwd(x5, *p5, heads=6)
    x9, do9 = k9_x.to(torch.bfloat16), n(*k9_x.shape).to(torch.bfloat16)
    calls.update({
        "K5 bfloat16 fwd": lambda: k5.mega_axial_block_fwd(x5, *p5, heads=6),
        "K5 bfloat16 bwd": lambda: k5.mega_axial_block_bwd(do5, x5, *p5, heads=6,
                                                           residuals=res5),
        "K9 bfloat16 fwd": lambda: k9.lane_px_attention(x9, *k9_params, heads=heads),
        "K9 bfloat16 bwd": lambda: k9.lane_px_attention_bwd(do9, x9, *k9_params, heads=heads)})
    # The line kernels' float32 backward (K4 and K8's temporal lines at their
    # training shapes).
    fwd4, bwd4, shapes4, rest4, out4, _ = line_cases["K4"]
    acts4, do4 = [n(*sh) for sh in shapes4], n(*out4)
    fwd8, bwd8, shapes8, rest8, out8, _ = line_cases["K8 temporal"]
    acts8, do8 = [n(*sh) for sh in shapes8], n(*out8)
    calls.update({
        "K4 float32 bwd": lambda: bwd4(do4, *acts4, *rest4, heads=heads),
        "K8 temporal float32 bwd": lambda: bwd8(do8, *acts8, *rest8)})
    for what, fn in calls.items():
        if not wanted(what):
            continue
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        per = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                short = re.sub(r"\(.*", "", re.sub(r"^void |bft::|\(anonymous namespace\)::", "",
                                                   evt.name))[:70]
                per[short] += evt.time_range.elapsed_us() / 1e3 / 5
        out[f"{what} kernels"] = {k: round(v, 4) for k, v in per.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
