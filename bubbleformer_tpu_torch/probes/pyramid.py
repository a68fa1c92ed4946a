"""P3: the fused pyramid stage probe on the port's kernel.

Counterpart of ``scripts/probe_pyramid_pallas.py``: its stage kernel
(``pallas_call :103`` in ``_make_stage :85``, body ``_stage_kernel :50``,
entry ``stage_pallas :120``) as ``csrc/probe_pyramid.cu``.  One stage of the
embed pyramid, forward: InstanceNorm-apply with the previous stage's
statistics, tanh-GELU, rounded, the 2x2 space-to-depth fold, the stage
product (float32 sums, bf16 out) and the new stage's statistics.

- :func:`stage_plain` — the PyTorch form of ``stage_xla`` (``:135``);
- :func:`stage` — the kernel wrapper (``stage_pallas``'s counterpart), on
  operands :func:`stage_operands` passes and tiles :func:`stage_tiles`
  picks;

with the probe's inputs (:func:`make_inputs`) and its command line
(:func:`main`, run by ``scripts/probe_pyramid_torch.py``).  tanh-GELU is the
probe's choice (Mosaic has no erf); the models' embed uses exact GELU
(``layers/patching.py``), so this kernel is not wired into them.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.probes import announce, build_seconds, check_device, cuda_ms, log

MAX_OUT_CHANNELS = 192  # two 128-wide product tiles, F a multiple of 8
TILE_PIXELS = 128  # output pixels a tile: two wgmma warpgroups of 64 rows


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, term for term."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * (x * x * x))))
    return x * cdf


def stage_plain(y0, mean, inv, k):
    """Plain PyTorch version of the stage (``stage_xla``): y0 (bt, h, w, c),
    mean and inv (bt, c) float32, k (2, 2, c, f) -> (out (bt, h/2, w/2, f) in
    y0's dtype, mu, var (bt, f) float32 of the unrounded product)."""
    bt, h, w, c = y0.shape
    yn = gelu_tanh((y0.float() - mean[:, None, None, :]) * inv[:, None, None, :]).to(y0.dtype)
    yn = yn.reshape(bt, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    out = yn.reshape(bt, h // 2, w // 2, 4 * c).float() @ k.reshape(4 * c, -1).float()
    mu = out.mean(dim=(1, 2))
    var = torch.clamp((out * out).mean(dim=(1, 2)) - mu * mu, min=0.0)
    return out.to(y0.dtype), mu, var


def stage_tiles(h: int, w: int) -> tuple:
    """The kernel's tile of (h/2, w/2) output pixels: ``(bx, by, tiles)``,
    bx pixels of a row by by rows (bx by at most :data:`TILE_PIXELS`, by > 1
    where a row is narrower than a tile, neither past the image) and the
    tiles an image takes.  A tile is one TMA box of ``y0`` per 64 channels:
    its rows are read once, and the pixels past the image are zero fill."""
    ho, wo = h // 2, w // 2
    bx = min(wo, TILE_PIXELS)
    by = min(TILE_PIXELS // bx, ho)
    return bx, by, -(-wo // bx) * -(-ho // by)


def stage_operands(what: str, y0: torch.Tensor, k: torch.Tensor) -> None:
    """Raise unless y0 (bt, h, w, c) and k (2, 2, c, f) can be the stage
    kernel's TMA sources: each contiguous with a 16-byte aligned base, and
    their rows a multiple of 16 bytes, the 2c channels of a pixel pair of y0
    (c a multiple of 4) and the f of k (f a multiple of 8).  The message
    names the tensor that fails (``_build.check_tma``)."""
    c, f = y0.shape[-1], k.shape[-1]
    _build.check_tma(what, y0=y0.view(-1, 2 * c) if y0.is_contiguous() else y0,
                     k=k.view(-1, f) if k.is_contiguous() else k)


def stage(y0, mean, inv, k):
    """The stage: :func:`stage_plain` on the CPU; on a card (bfloat16)
    ``csrc/probe_pyramid.cu``, one launch of the fused stage (TMA and
    ``wgmma`` on the tiles of :func:`stage_tiles`) and one that adds the
    tiles' statistics in a fixed order, counted once in ``stage.launches``.
    y0 and k are made contiguous; where TMA still cannot read them
    (:func:`stage_operands`), or y0 has more channels than the kernel's
    shared memory stages statistics for (``bf_probe_stage_max_channels``),
    it raises naming the tensor."""
    if not check_device("stage", y0):
        return stage_plain(y0, mean, inv, k)
    bt, h, w, c = y0.shape
    f = k.shape[-1]
    what = f"stage at y0 {tuple(y0.shape)}, k {tuple(k.shape)}"
    if y0.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes bfloat16 y0 and k, not {y0.dtype}, {k.dtype}")
    if h % 2 or w % 2 or f > MAX_OUT_CHANNELS:
        raise ValueError(f"{what}: needs even h and w and at most {MAX_OUT_CHANNELS} output "
                         f"channels")
    _build.check_shapes(what, mean=(mean, (bt, c)), inv=(inv, (bt, c)), k=(k, (2, 2, c, f)))
    dev = y0.device
    y0, k = y0.contiguous(), k.contiguous()
    stage_operands(what, y0, k)
    mean, inv = mean.float().contiguous(), inv.float().contiguous()
    bx, by, tiles = stage_tiles(h, w)
    lib = _build.library()
    most = lib.bf_probe_stage_max_channels()
    if c > most:
        raise ValueError(f"{what}: y0 has {c} channels, more than the {most} whose statistics "
                         "a block stages")
    partial = torch.empty(bt, tiles, 2, f, device=dev)
    out = torch.empty(bt, h // 2, w // 2, f, device=dev, dtype=y0.dtype)
    mu, var = torch.empty(bt, f, device=dev), torch.empty(bt, f, device=dev)
    err = lib.bf_probe_stage(y0.data_ptr(), mean.data_ptr(), inv.data_ptr(), k.data_ptr(),
                             out.data_ptr(), partial.data_ptr(), mu.data_ptr(), var.data_ptr(),
                             bt, h, w, c, f, bx, by, _build.stream_handle(dev))
    _build.check(lib, err, f"{what} (bf_probe_stage)")
    stage.launches += 1
    return out, mu, var


stage.launches = 0


def make_inputs(args) -> dict:
    """The probe's inputs, drawn as the JAX probe draws them
    (``default_rng(0)``: y0 bf16, mean at 0.1, inv in [0.8, 1.2), k at 0.05
    in bf16), on the CPU: the arguments of :func:`stage`."""
    rng = np.random.default_rng(0)
    y0 = torch.from_numpy(rng.standard_normal((args.bt, args.size, args.size, args.cin)).astype(
        np.float32)).to(torch.bfloat16)
    mean = torch.from_numpy(rng.standard_normal((args.bt, args.cin)).astype(np.float32)) * 0.1
    inv = torch.from_numpy(rng.uniform(0.8, 1.2, (args.bt, args.cin)).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((2, 2, args.cin, args.cout)) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    return dict(y0=y0, mean=mean, inv=inv, k=k)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="P3, the fused pyramid stage probe")
    ap.add_argument("--bt", type=int, default=20)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--cin", type=int, default=96)
    ap.add_argument("--cout", type=int, default=96)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hb", type=int, default=32,
                    help="the TPU kernel's output rows a grid step; the CUDA kernel's tile is "
                         "stage_tiles' choice whatever --hb is (kept so the JAX command lines run)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    return ap


def main(argv=None) -> dict:
    """The probe: the kernel against the plain version on the first two
    images (out and var within 0.05, as the JAX probe asserts), then both
    timed over ``--steps`` calls by CUDA events, one JSON line (also written
    to ``--out``).  Returns the JSON line."""
    from bubbleformer_tpu_torch.training.module import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    announce(dev)
    build_seconds(dev)
    inputs = {k: v.to(dev) for k, v in make_inputs(args).items()}
    y0, mean, inv, k = inputs["y0"], inputs["mean"], inputs["inv"], inputs["k"]
    o_x, _, var_x = stage_plain(y0[:2], mean[:2], inv[:2], k)
    o_p, _, var_p = stage(y0[:2], mean[:2], inv[:2], k)
    err = (o_x.float() - o_p.float()).abs().max().item()
    err_s = (var_x - var_p).abs().max().item()
    log(f"stage agreement: out {err:.2e}, var {err_s:.2e}")
    if not (err < 0.05 and err_s < 0.05):
        raise RuntimeError(f"stage: the kernel and the plain version disagree: out {err:.3e}, "
                           f"var {err_s:.3e} (bound 0.05)")
    results = {"agreement_out": err, "agreement_var": err_s}
    for name, fn in (("plain", stage_plain), ("kernel", stage)):
        ms = cuda_ms(lambda: fn(**inputs), args.steps, dev)
        if ms is not None:
            log(f"{name}: {ms:.4f} ms per stage fwd")
        results[name + "_fwd_ms"] = ms
    results["device"] = str(dev)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return results
