#!/usr/bin/env python3
"""Time the port's K1, K2 and K3 kernels at their training steps' shapes.

K1 (the temporal branch, ``mega_temporal_block``) at x (8, 5, 32, 32, 384)
and K2 (the lane axial attention, ``lane_axial_attention``) at qkv (40, 32,
32, 1152), FiLMAViT-small's; K3 (the streamed temporal core,
``core_temporal_attention``) at AViT-big's xn (8, 5, 32, 32, 768) and
AViT-small's on the flow-boiling grid at batch 4, (4, 5, 32, 128, 384),
through its autograd Function as a training step without remat calls it
(the backward alone by ``torch.autograd.grad`` on a kept graph); forward
and backward, in bfloat16 and float32, by CUDA events (20 calls after 3
warm-up), from the checkout given by ``--repo`` (default: this one), whose
kernels it builds first.  Comparing two versions of the
kernels takes two processes on one card, one per checkout, in turns:

    python3 scripts/time_kernels_torch.py --repo build/parent --label parent
    python3 scripts/time_kernels_torch.py --label change

Prints one JSON line with the card's name and power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_kernels_torch.py needs a CUDA card")
    from bubbleformer_tpu_torch import _build
    from bubbleformer_tpu_torch.ops import axial_lane as k2
    from bubbleformer_tpu_torch.ops import temporal_block_mega as k1

    _build.library()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32)).to(
            dev)

    heads, c, d, t = 6, 384, 64, 5
    k1_args = dict(x=n(8, t, 32, 32, c), in1_scale=n(c, scale=0.1, offset=1.0),
                   in1_bias=n(c, scale=0.1), wqkv=n(3 * c, c, scale=c**-0.5),
                   bqkv=n(3 * c, scale=0.1), qn_scale=n(d, scale=0.1, offset=1.0),
                   qn_bias=n(d, scale=0.1), kn_scale=n(d, scale=0.1, offset=1.0),
                   kn_bias=n(d, scale=0.1), in2_scale=n(c, scale=0.1, offset=1.0),
                   in2_bias=n(c, scale=0.1), wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.1),
                   bias=n(heads, t, t), scale_factor=n(heads, scale=0.2, offset=1.0))
    k2_args = dict(qkv=n(40, 32, 32, 3 * c), qn_scale=n(d, scale=0.1, offset=1.0),
                   qn_bias=n(d, scale=0.1), kn_scale=n(d, scale=0.1, offset=1.0),
                   kn_bias=n(d, scale=0.1), bias_x=n(heads, 32, 32), bias_y=n(heads, 32, 32),
                   scale_x=n(heads, scale=0.2, offset=1.0), scale_y=n(heads, scale=0.2, offset=1.0))

    def ms(fn):
        for _ in range(3):
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
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        x, p1 = k1_args["x"].to(dt), list(k1_args.values())[1:]
        do1 = torch.randn_like(x)
        _, res = k1.mega_temporal_block_fwd(x, *p1, heads=heads)
        out[f"K1 {name}"] = ms(lambda: k1.mega_temporal_block_fwd(x, *p1, heads=heads))
        out[f"K1 bwd {name}"] = ms(lambda: k1.mega_temporal_block_bwd(do1, x, *p1, heads=heads,
                                                                      residuals=res))
        qkv, p2 = k2_args["qkv"].to(dt), list(k2_args.values())[1:]
        do2 = torch.randn(40, 32, 32, c, device=dev, dtype=dt)
        out[f"K2 {name}"] = ms(lambda: k2.lane_axial_attention(qkv, *p2, heads=heads))
        out[f"K2 bwd {name}"] = ms(lambda: k2.lane_axial_attention_bwd(do2, qkv, *p2,
                                                                       heads=heads))
        del res
    for case, (shape, h) in {"avit_big": ((8, t, 32, 32, 768), 12),
                             "flow_b4": ((4, t, 32, 128, 384), 6)}.items():
        cc = shape[-1]
        k3_params = [n(3 * cc, cc, scale=cc**-0.5), n(3 * cc, scale=0.1),
                     n(d, scale=0.1, offset=1.0), n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
                     n(d, scale=0.1), n(h, t, t), n(h, scale=0.2, offset=1.0)]
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
