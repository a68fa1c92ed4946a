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
32, 64) and the temporal ones (6, 8192, 5, 64), and K4 and K8 at the other
shapes of chip_smoke.py's phases 17 and 29 (K4 at qkv (5, 32, 32, 1152),
(5, 24, 24, 1152) and (10, 8, 8, 288); K8 at (6, 160, 32, 64), (6, 1024,
5, 64) and (6, 2560, 64, 16); K6 and K7 at AViT-tiny's (40, 64, 64, 6, 16)
and the flow grid's (20, 32, 128, 6, 64), and in bfloat16 at their training
shape on the q, k, v the block hands over, v a strided view, beside sdpa
over both directions there).  Forward and
backward, in bfloat16 and float32, by CUDA events (20 calls after at least
``WARMUP_S`` seconds of warm-up calls), from the checkout given by
``--repo`` (default: this one), whose kernels it builds first.  Then, in
bfloat16 at K1's first shape and at K3's AViT-big shape, K2's at
FiLMAViT-small's and the flow-boiling grid's at batch 4, K5's and K9's at x
(40, 32, 32, 384), K4's, K6's, K7's and K8's (axial and temporal) at their
training shapes, and in float32 K4's and K8's temporal backward, the device
time of each kernel one forward and one backward launch, by
``torch.profiler`` (the mean of 5 traced calls; names shortened, a kernel
launched more than once a call numbered by its place), which reads any
checkout alike.  The probes' kernels, under keys
starting with ``P`` (``--only P``): P2b (``perm_product``) at the probe's
(384, 1024) and at P2c's relayouts (7680 and 15360 rows), beside
``torch.matmul``; P2c
(``chunk_core``), P2a (``dot_combos``) and P3 (``stage``) at their probes'
default inputs; P1a (``within_roll``, both dtypes) beside its two
``torch.roll`` calls and P4's Gram at the ``reshape_col`` body (float32)
beside ``torch.matmul`` and at ``bf16_dot`` beside ``torch.mm`` with a
float32 output (``out_dtype``, or the bf16 ``torch.matmul`` where this
torch lacks it), each with its host microseconds to enqueue one call and
its ``torch.profiler`` breakdown, and each host step of a float32 Gram and
P1a call alone (``P4 gram and P1a host steps``); P4's copy bodies
``transpose_full`` (float32, beside ``permute().contiguous()``) and
``head_slice_bf16`` (CUDA events over ``P_ITERS`` calls, these calls
being host-bound), each also as host microseconds to enqueue one call
(a host clock around 1000 calls with no synchronise), with each host step of
the ``transpose_full`` body timed alone (``P4 host steps``); each with its
``torch.profiler`` breakdown; P1b (``lane_core``, bfloat16) at its probe's
default inputs and P4's chunk products (``chunk_gram_apply``) at the
``head_slice_dot_bf16`` and ``chunked_ref_reads_bf16`` bodies, each with
its host microseconds to enqueue one call and its ``torch.profiler``
breakdown (the device time of each launch).  The JSON line also carries
the ``ptxas`` registers and spill bytes of every Hopper GEMM
instantiation, of every kernel of ``lane_hopper.cuh`` and
``flash_hopper.cuh`` and of the probes' chunk, stage, P1b, chunk-Gram, Gram
and roll kernels in the checkout's build (``ptxas``).
Comparing two versions of the
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
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Calls a probe kernel's CUDA-event time is taken over: a call at the probes'
# shapes is host-bound (~10-20 us of launch work), and 20 calls of it read
# up to 10% apart between runs.
P_ITERS = 200
# Seconds of warm-up calls before each timing.  Three calls alone left a
# float32 kernel's time dependent on the load that ran before it: the same
# SASS read 3% apart after three calls and within 0.4% after one second.
WARMUP_S = 1.0


def ptxas_registers(log: Path) -> dict:
    """Registers, stack frame and spill bytes (stores, loads) of every
    kernel of the Hopper GEMM, of lane_hopper.cuh and flash_hopper.cuh (in
    every source that builds them) and of the probes' chunk, stage, P1b
    core, chunk-Gram, Gram and roll kernels, from the ``-Xptxas -v`` output
    kept beside
    the library; keyed by mangled
    name with each anonymous namespace's per-build hash cut out, so two
    builds' keys match."""
    out, name, spill = {}, None, (0, 0, 0)
    for line in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N_\1",
                          m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            spill = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(r"gemm_kernel|chunk_attention|stage_kernel|lane_fwd|lane_bwd|"
                                    r"flash_fwd|flash_bwd|core_kernel|chunk_gram|gram_tc|"
                                    r"within_roll", name):
            out[name] = [int(m.group(1)), *spill]
    return out


def own_probes():
    """This checkout's ``bubbleformer_tpu_torch.probes`` (its timing helpers),
    loaded under a name of its own: the package ``--repo`` names still
    imports as itself, and every checkout's launches are broken down by the
    same code."""
    path = Path(__file__).resolve().parents[1] / "bubbleformer_tpu_torch" / "probes" / "__init__.py"
    spec = importlib.util.spec_from_file_location("_time_kernels_probes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="", help="time only the keys with this prefix")
    args = ap.parse_args(argv)
    own = own_probes()
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

    def ms(fn, iters=None):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARMUP_S:
            fn()
            torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        iters = iters or args.iters
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"label": args.label, "repo": args.repo, "card": card,
           "ptxas": ptxas_registers(_build.library_path().with_suffix(".log"))}
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
    # K6 and K7 at the other shapes of chip_smoke.py's phase 25 (AViT-tiny's
    # head dim 16 grid, the 32x128 flow grid at batch 4).
    for case, shape6 in {"d16": (40, 64, 64, heads, 16), "flow": (20, 32, 128, heads, d)}.items():
        tables6 = [n(heads, shape6[2], shape6[2]), n(heads, shape6[1], shape6[1]),
                   n(heads, scale=0.2, offset=1.0), n(heads, scale=0.2, offset=1.0)]
        for key, (f6, b6) in {"K6": (k6.fused_axial_attention_packed,
                                     k6.fused_axial_attention_packed_bwd),
                              "K7": (k7.fused_axial_attention,
                                     k7.fused_axial_attention_bwd)}.items():
            line_cases[f"{key} {case}"] = (f6, b6, [shape6] * 3, tables6, shape6, False)
    # K4 and K8 at the other shapes chip_smoke.py holds them at (phases 17 and
    # 29): K4 at the rollout's batch, the 24x24 grid and the make-demo grid
    # (head dim 16); K8 at the rollout's lines and AViT-tiny's axial lines.
    for case, (qkv_shape, h4) in {"rollout": ((t, 32, 32, 3 * c), heads),
                                  "grid_24": ((t, 24, 24, 3 * c), heads),
                                  "demo_d16": ((2 * t, 8, 8, 288), heads)}.items():
        d4, hh, ww = qkv_shape[-1] // 3 // h4, qkv_shape[1], qkv_shape[2]
        line_cases[f"K4 {case}"] = (k4.fused_block_attention, k4.fused_block_attention_bwd,
                                    [qkv_shape], [*ln(d4), n(h4, ww, ww), n(h4, hh, hh),
                                                  n(h4, scale=0.2, offset=1.0),
                                                  n(h4, scale=0.2, offset=1.0)],
                                    (*qkv_shape[:-1], qkv_shape[-1] // 3), True)
    for case, shape8 in {"axial rollout": (heads, t * 32, 32, d),
                         "temporal rollout": (heads, 32 * 32, t, d),
                         "axial d16": (heads, 8 * t * 64, 64, 16)}.items():
        line_cases[f"K8 {case}"] = (k8.flash_packed_attention, k8.flash_packed_attention_bwd,
                                    [shape8] * 3, [n(heads, shape8[2], shape8[2]),
                                                   n(heads, scale=0.2, offset=1.0)],
                                    shape8, False)
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
    # K6 and K7 in bf16 on the q, k, v the block hands over (v a strided view
    # of the Dense's (BT, H, W, heads, 3, d) output), and sdpa over both
    # directions with the tables as masks at that shape (a partial
    # yardstick: no blend, no table gradient; the port never calls it).
    shape6 = (40, 32, 32, heads, d)
    dense = n(*shape6[:-1], 3, d).to(torch.bfloat16)
    q6, k6_, v6 = dense[..., 0, :].contiguous(), dense[..., 1, :].contiguous(), dense[..., 2, :]
    do6 = n(*shape6).to(torch.bfloat16)
    for key, (f6, b6) in {"K6 layer": (k6.fused_axial_attention_packed,
                                       k6.fused_axial_attention_packed_bwd),
                          "K7 layer": (k7.fused_axial_attention,
                                       k7.fused_axial_attention_bwd)}.items():
        if wanted(key):
            out[f"{key} bfloat16"] = ms(lambda: f6(q6, k6_, v6, *tables))
            out[f"{key} bwd bfloat16"] = ms(lambda: b6(do6, q6, k6_, v6, *tables))
    if wanted("sdpa"):
        import torch.nn.functional as F

        for dt in (torch.bfloat16, torch.float32):
            fwd_ms = bwd_ms = 0.0
            for perm, bias in (((0, 1, 3, 2, 4), tables[0]), ((0, 2, 3, 1, 4), tables[1])):
                qs, ks, vs = (x.to(dt).permute(*perm).contiguous() for x in (q6, k6_, v6))
                qs, ks, vs = (x.reshape(-1, *x.shape[2:]).requires_grad_() for x in (qs, ks, vs))
                mask = bias.to(dt)[None].expand(qs.shape[0], heads, 32, 32)
                fwd_ms += ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
                o6 = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
                g6 = torch.randn_like(o6)
                bwd_ms += ms(lambda: torch.autograd.grad(o6, (qs, ks, vs), g6, retain_graph=True))
                del qs, ks, vs, mask, o6, g6
            name = str(dt).split(".")[-1]
            out[f"sdpa K6 K7 {name}"], out[f"sdpa K6 K7 bwd {name}"] = fwd_ms, bwd_ms
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

    # The probes' kernels (P2b, P2c, P4 copy): the calls timed here, and
    # their profiler breakdowns below.
    probe_calls = {}
    if wanted("P"):
        from bubbleformer_tpu_torch import probes
        from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid

        def host_us(fn, calls=1000):
            """Host microseconds to enqueue one call (no synchronise)."""
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return (t1 - t0) / calls * 1e6

        perm = chunk_axial.permutation(32, 32, torch.bfloat16).to(dev)
        xb, _ = chunk_axial.perm_input()
        xb = xb.to(dev)
        probe_calls["P2b"] = lambda: chunk_axial.perm_product(xb, perm)
        out["P2b bfloat16"] = ms(probe_calls["P2b"], P_ITERS)
        out["P2b matmul bfloat16"] = ms(lambda: torch.matmul(xb, perm), P_ITERS)
        out["P2b host_us"] = host_us(probe_calls["P2b"])
        out["P2b matmul host_us"] = host_us(lambda: torch.matmul(xb, perm))
        relayouts = {"P2b q relayout": n(7680, 1024).to(torch.bfloat16),
                     "P2b kv relayout": n(15360, 1024).to(torch.bfloat16)}
        for key, xr in relayouts.items():
            out[f"{key} bfloat16"] = ms(lambda: chunk_axial.perm_product(xr, perm), P_ITERS)
            out[f"{key} matmul bfloat16"] = ms(lambda: torch.matmul(xr, perm), P_ITERS)
        # Each host step of a P2b call, alone.
        lib = _build.library()
        pout = torch.empty_like(xb)
        handle = _build.stream_handle(xb.device)
        steps = {"torch.empty_like": lambda: torch.empty_like(xb),
                 "stream_handle": lambda: _build.stream_handle(xb.device),
                 "C call (launch)": lambda: lib.bf_probe_perm_product(
                     xb.data_ptr(), perm.data_ptr(), 0, None, pout.data_ptr(), 384, 1024,
                     handle)}
        if hasattr(chunk_axial, "perm_operands"):
            steps["perm_operands"] = lambda: chunk_axial.perm_operands("perm_product", xb, perm)
        steps["perm_product wrapper"] = probe_calls["P2b"]
        steps["torch.matmul"] = lambda: torch.matmul(xb, perm)
        out["P2b host steps"] = {k: round(host_us(f), 3) for k, f in steps.items()}
        inp_c = {k: v.to(dev) if torch.is_tensor(v) else v
                 for k, v in chunk_axial.make_inputs(chunk_axial.parser().parse_args([])).items()}
        probe_calls["P2c"] = lambda: chunk_axial.chunk_core(**inp_c)
        out["P2c bfloat16"] = ms(probe_calls["P2c"], P_ITERS)
        # P2a (one block of the chunk kernel), P3 (the fused stage), and
        # P1a and P4's Gram beside their PyTorch calls.
        xd, yd = (t.to(dev) for t in chunk_axial.dot_combos_input())
        probe_calls["P2a"] = lambda: chunk_axial.dot_combos(xd, yd)
        out["P2a bfloat16"] = ms(probe_calls["P2a"], P_ITERS)
        inp_s = {k: v.to(dev) for k, v in
                 pyramid.make_inputs(pyramid.parser().parse_args([])).items()}
        probe_calls["P3"] = lambda: pyramid.stage(**inp_s)
        out["P3 bfloat16"] = ms(probe_calls["P3"], P_ITERS)
        rs = lane_axial.ROLL_SHAPE
        rolls = (5, rs.W, 3 * rs.W, rs.H * rs.W)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            xr = lane_axial.within_roll_input(dt).to(dev)
            x1, x2 = xr.view(rs.C, rs.T * rs.H, rs.W), xr.view(rs.C, rs.T, rs.H * rs.W)
            probe_calls[f"P1a {name}"] = lambda xr=xr: lane_axial.within_roll(xr, *rolls)
            two_rolls = lambda x1=x1, x2=x2: (torch.roll(x1, -5, 2),  # noqa: E731
                                              torch.roll(x2, -3 * rs.W, 2))
            out[f"P1a {name}"] = ms(probe_calls[f"P1a {name}"], P_ITERS)
            out[f"P1a torch.roll {name}"] = ms(two_rolls, P_ITERS)
            out[f"P1a {name} host_us"] = host_us(probe_calls[f"P1a {name}"])
            out[f"P1a torch.roll {name} host_us"] = host_us(two_rolls)
        # P4's Gram at reshape_col (float32) beside torch.matmul, and at
        # bf16_dot beside torch.mm with a float32 output where this torch
        # takes out_dtype (else the bf16 torch.matmul: a partial yardstick,
        # its output rounded to bf16).
        for body in ("reshape_col", "bf16_dot"):
            xg = mosaic.body_input(body).to(dev)
            xg2 = xg.view(-1, mosaic.D)
            name = str(xg.dtype).split(".")[-1]
            library = lambda xg2=xg2: torch.matmul(xg2, xg2.t())  # noqa: E731
            lib_name = "matmul"
            if xg.dtype == torch.bfloat16:
                try:
                    torch.mm(xg2, xg2.t(), out_dtype=torch.float32)
                    library = lambda xg2=xg2: torch.mm(xg2, xg2.t(),  # noqa: E731
                                                       out_dtype=torch.float32)
                    lib_name = "mm out_dtype=float32"
                except (TypeError, RuntimeError):
                    lib_name = "matmul bf16 (partial)"
            probe_calls[f"P4 gram {name}"] = lambda xg=xg, body=body: mosaic.run_body(body, xg)
            out[f"P4 gram {name}"] = ms(probe_calls[f"P4 gram {name}"], P_ITERS)
            out[f"P4 gram {lib_name} {name}"] = ms(library, P_ITERS)
            out[f"P4 gram {name} host_us"] = host_us(probe_calls[f"P4 gram {name}"])
            out[f"P4 gram {lib_name} {name} host_us"] = host_us(library)
        # Each host step of a float32 Gram call and of a float32 P1a call,
        # alone.
        xg = mosaic.body_input("reshape_col").to(dev).view(-1, mosaic.D)
        gout = torch.empty(256, 256, device=dev)
        lib = _build.library()
        handle = _build.stream_handle(xg.device)
        steps = {"torch.empty": lambda: torch.empty((256, 256), device=xg.device),
                 "stream_handle": lambda: _build.stream_handle(xg.device)}
        if hasattr(mosaic, "gram_operands"):
            steps["gram_operands (cached)"] = lambda: mosaic.gram_operands(xg)
            steps["C call (launch)"] = lambda: lib.bf_probe_gram(
                0, xg.data_ptr(), 256, 64, 64, 1, 1, gout.data_ptr(), handle)
        else:
            steps["int64_array x2"] = lambda: (_build.int64_array(xg.stride()),
                                               _build.int64_array(xg.shape))
        steps["gram wrapper"] = lambda: mosaic.gram(xg)
        xr = lane_axial.within_roll_input(torch.float32).to(dev)
        steps["P1a new_empty (2, 16, 512)"] = lambda: xr.new_empty((2, 16, 512))
        if hasattr(lane_axial, "within_roll_plan"):
            rout = torch.empty((2, 16, 512), device=dev)
            plan = lambda: lane_axial.within_roll_plan(  # noqa: E731
                xr.shape, xr.dtype, xr.data_ptr() % 16, *rolls)
            rdesc = plan()[1]
            steps["P1a within_roll_plan (cached)"] = plan
            steps["P1a C call (launch)"] = lambda: lib.bf_probe_within_roll(
                rdesc, xr.data_ptr(), rout.data_ptr(), handle)
        steps["P1a wrapper"] = lambda: lane_axial.within_roll(xr, *rolls)
        out["P4 gram and P1a host steps"] = {k: round(host_us(f), 3) for k, f in steps.items()}
        for body in ("transpose_full", "head_slice_bf16"):
            xm = mosaic.body_input(body).to(dev)
            name = str(xm.dtype).split(".")[-1]
            probe_calls[f"P4 {body}"] = lambda xm=xm, body=body: mosaic.run_body(body, xm)
            out[f"P4 copy {body} {name}"] = ms(probe_calls[f"P4 {body}"], P_ITERS)
            out[f"P4 copy {body} host_us"] = host_us(probe_calls[f"P4 {body}"])
        xm = mosaic.body_input("transpose_full").to(dev)
        library = lambda: xm.permute(1, 0, 2).contiguous()  # noqa: E731
        out["P4 copy transpose_full library float32"] = ms(library, P_ITERS)
        out["P4 copy transpose_full library host_us"] = host_us(library)
        # Each host step of the transpose_full body, alone.
        v, dst = xm.permute(1, 0, 2), torch.empty(32, 32, 64, device=dev)
        lib = _build.library()
        steps = {"torch.empty": lambda: torch.empty((32, 32, 64), dtype=xm.dtype,
                                                    device=xm.device),
                 "permute": lambda: xm.permute(1, 0, 2),
                 "check_device": lambda: probes.check_device("view_copy", v),
                 "data_ptr x2": lambda: (v.data_ptr(), dst.data_ptr()),
                 "stream_handle": lambda: _build.stream_handle(v.device),
                 "int64_array x3": lambda: (_build.int64_array(v.stride()),
                                            _build.int64_array(dst.stride()),
                                            _build.int64_array(v.shape))}
        handle = _build.stream_handle(v.device)
        if hasattr(mosaic, "copy_descriptor"):
            desc = mosaic.copy_descriptor(v.shape, v.stride(), dst.stride(), v.dtype, dst.dtype,
                                          v.data_ptr() % 16, dst.data_ptr() % 16, 1.0, False)
            steps.update({
                "copy_descriptor (cached)": lambda: mosaic.copy_descriptor(
                    v.shape, v.stride(), dst.stride(), v.dtype, dst.dtype, v.data_ptr() % 16,
                    dst.data_ptr() % 16, 1.0, False),
                "C call (launch)": lambda: lib.bf_probe_view_copy(desc, v.data_ptr(),
                                                                  dst.data_ptr(), handle)})
        else:
            arrays = (_build.int64_array(v.stride()), _build.int64_array(dst.stride()),
                      _build.int64_array(v.shape))
            steps["C call (launch)"] = lambda: lib.bf_probe_view_copy(
                0, v.data_ptr(), arrays[0], 0, dst.data_ptr(), arrays[1], arrays[2], 3, 1.0, 0,
                handle)
        steps["view_copy wrapper"] = lambda: mosaic.view_copy(v, dst)
        out["P4 host steps"] = {k: round(host_us(f), 3) for k, f in steps.items()}
        # P1b at its probe's inputs, P4's chunk products at their two bodies.
        inp_l = {k: v.to(dev) if torch.is_tensor(v) else v
                 for k, v in lane_axial.make_inputs(lane_axial.parser().parse_args([])).items()}
        probe_calls["P1b"] = lambda: lane_axial.lane_core(**inp_l)
        out["P1b bfloat16"] = ms(probe_calls["P1b"], P_ITERS)
        out["P1b host_us"] = host_us(probe_calls["P1b"], 200)
        for body in ("head_slice_dot_bf16", "chunked_ref_reads_bf16"):
            xm = mosaic.body_input(body).to(dev)
            probe_calls[f"P4 {body}"] = lambda xm=xm, body=body: mosaic.run_body(body, xm)
            out[f"P4 chunk {body} bfloat16"] = ms(probe_calls[f"P4 {body}"], P_ITERS)
            out[f"P4 chunk {body} host_us"] = host_us(probe_calls[f"P4 {body}"])

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
    acts4h, do4h = [a.to(torch.bfloat16) for a in acts4], do4.to(torch.bfloat16)
    acts8h, do8h = [a.to(torch.bfloat16) for a in acts8], do8.to(torch.bfloat16)
    _, _, shapes8a, rest8a, out8a, _ = line_cases["K8 axial"]
    acts8a, do8a = [n(*sh).to(torch.bfloat16) for sh in shapes8a], n(*out8a).to(torch.bfloat16)
    calls.update({
        "K4 float32 bwd": lambda: bwd4(do4, *acts4, *rest4, heads=heads),
        "K8 temporal float32 bwd": lambda: bwd8(do8, *acts8, *rest8),
        "K4 bfloat16 fwd": lambda: fwd4(*acts4h, *rest4, heads=heads),
        "K4 bfloat16 bwd": lambda: bwd4(do4h, *acts4h, *rest4, heads=heads),
        "K8 axial bfloat16 fwd": lambda: fwd8(*acts8a, *rest8a),
        "K8 axial bfloat16 bwd": lambda: bwd8(do8a, *acts8a, *rest8a),
        "K8 temporal bfloat16 fwd": lambda: fwd8(*acts8h, *rest8),
        "K8 temporal bfloat16 bwd": lambda: bwd8(do8h, *acts8h, *rest8)})
    # K6 and K7 in bf16 at the training shape, on the layer's views.
    calls.update({
        "K6 bfloat16 fwd": lambda: k6.fused_axial_attention_packed(q6, k6_, v6, *tables),
        "K6 bfloat16 bwd": lambda: k6.fused_axial_attention_packed_bwd(do6, q6, k6_, v6, *tables),
        "K7 bfloat16 fwd": lambda: k7.fused_axial_attention(q6, k6_, v6, *tables),
        "K7 bfloat16 bwd": lambda: k7.fused_axial_attention_bwd(do6, q6, k6_, v6, *tables)})
    calls.update({key if key.endswith(("float32", "bfloat16")) else f"{key} bfloat16": fn
                  for key, fn in probe_calls.items()})
    for what, fn in calls.items():
        if not wanted(what):
            continue
        per = own.launch_ms(fn)
        out[f"{what} kernels"] = {k: round(v, 4) for k, v in per.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
