"""P1: the lane-roll axial attention probe on the port's kernels.

Counterpart of ``scripts/probe_lane_axial.py``: its two Pallas kernels as
``csrc/probe_lane_axial.cu``,

- :func:`within_roll` — ``probe_within_roll``'s kernel (``:86``, helper
  ``_within_roll :62``): circular rolls within blocks of lanes, two at once
  into one buffer, each row of x staged once by 16-byte copies where
  :func:`within_roll_operands` allows;
- :func:`lane_core` — ``bench_core``'s kernel (``:193``, body
  ``_core_kernel :104``): the row and column attention over every circular
  offset of channel-major slabs, averaged and rounded once; bfloat16 on
  ``core_kernel`` (:func:`lane_core_hopper`, tensor cores, a band of lines a
  block, each line's table slice staged by :func:`line_table`'s map),
  float32 on ``lane_core_kernel`` (:func:`lane_core_line`);

with their plain versions, the probe's inputs (:func:`make_inputs`,
:func:`within_roll_input`) and its command line (:func:`main`, run by
``scripts/probe_lane_axial_torch.py``).
"""
from __future__ import annotations

import argparse
import functools
import json
import struct
from types import SimpleNamespace

import numpy as np
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.probes import announce, build_seconds, check_device, cuda_ms, log

MAX_LINE = 128  # tokens a line (lane_core keeps a line's q, k, v on chip)
# Bytes of a row the staged roll kernel takes (csrc/probe_lane_axial.cu:
# kRollSmem).
ROLL_SMEM = 48 * 1024
MAX_INT = 2**31 - 1
HOPPER_HEAD_DIMS = (16, 64)  # head dims of the bfloat16 kernel (core_kernel)


def _roll_index(r: int, block: int, total: int, device) -> torch.Tensor:
    """Lane g*block + w reads lane g*block + (w + r) % block."""
    lane = torch.arange(total, device=device)
    return lane - lane % block + (lane % block + r) % block


def within_roll_plain(x: torch.Tensor, r: int, block: int) -> torch.Tensor:
    """Plain PyTorch version of ``_within_roll(x, r, block, total)``: the
    last axis rolled left by ``r`` within each block of ``block`` lanes."""
    return x[..., _roll_index(r, block, x.shape[-1], x.device)]


@functools.lru_cache(maxsize=64)
def within_roll_plan(shape, dtype, offset: int, r1: int, block1: int, r2: int,
                     block2: int) -> tuple:
    """How :func:`within_roll`'s kernels take a contiguous x of ``shape``
    (rows, total) and ``dtype`` whose base address is ``offset`` modulo 16,
    and the two rolls (each ``0 <= r < block``, ``block`` dividing
    ``total``): (vec, desc).  vec is the elements a thread moves, 16 bytes'
    worth (``within_roll_vec_kernel``: each row staged once) where a row is
    a multiple of 16 bytes of at most ``ROLL_SMEM`` and x is aligned, else 1
    (``within_roll_kernel``, one element a thread); desc the packed
    ``RollDesc`` of ``csrc/probe_lane_axial.cu``.  Raises, naming the shape
    or the roll, for what the kernels do not take.  Cached: a probe repeats
    its call."""
    what = f"within_roll at {tuple(shape)}"
    if len(shape) != 2 or not all(1 <= n <= MAX_INT for n in shape):
        raise ValueError(f"{what}: x (rows, total), each from 1 to 2^31 - 1")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, not {dtype}")
    rows, total = shape
    for r, b in ((r1, block1), (r2, block2)):
        if b < 1 or total % b or not 0 <= r < b:
            raise ValueError(f"{what}: roll {r} in blocks of {b} does not fit lanes of "
                             f"{total}")
    vec = 16 // dtype.itemsize
    if total % vec or total * dtype.itemsize > ROLL_SMEM or offset % 16:
        vec = 1
    return vec, struct.pack("<8i", _build.DTYPE_CODES[dtype], rows, total, r1, block1, r2,
                            block2, int(vec > 1))


def within_roll_operands(x: torch.Tensor, r1: int, block1: int, r2: int, block2: int) -> int:
    """Raise unless :func:`within_roll`'s kernels take x, contiguous, and the
    rolls (:func:`within_roll_plan`); returns the elements a thread moves."""
    if not x.is_contiguous():
        raise ValueError(f"within_roll at {tuple(x.shape)}: x of strides {x.stride()} is not "
                         "contiguous")
    return within_roll_plan(x.shape, x.dtype, x.data_ptr() % 16, r1, block1, r2, block2)[0]


def within_roll(x: torch.Tensor, r1: int, block1: int, r2: int, block2: int):
    """Both rolls of ``probe_within_roll``'s kernel, ``(within_roll_plain(x,
    r1, block1), within_roll_plain(x, r2, block2))``, as the two halves of
    one (2, rows, total) buffer, for x (rows, total) float32 or bfloat16: one
    launch of ``csrc/probe_lane_axial.cu`` on a card, as
    :func:`within_roll_plan` plans it (counted in ``within_roll.launches``),
    the plain version on the CPU."""
    if not check_device("within_roll", x):
        return torch.stack((within_roll_plain(x, r1, block1),
                            within_roll_plain(x, r2, block2))).unbind()
    if not x.is_contiguous():
        x = x.contiguous()
    _, desc = within_roll_plan(x.shape, x.dtype, x.data_ptr() % 16, r1, block1, r2, block2)
    out = x.new_empty((2, *x.shape))
    lib = _build.library()
    err = lib.bf_probe_within_roll(desc, x.data_ptr(), out.data_ptr(),
                                   _build.stream_handle(x.device))
    if err:
        _build.check(lib, err, f"within_roll at {tuple(x.shape)} (bf_probe_within_roll)")
    within_roll.launches += 1
    return out.unbind()


within_roll.launches = 0


def lane_core_plain(q, kv, bx, by, sc, heads: int, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of ``_core_kernel`` over every frame: q (BT, C,
    N) and kv (BT, 2C, N) channel-major (N = h*w), bx (w*heads, N), by
    (h*heads, N) and sc (C, 2) float32; returns (BT, C, N) in q's dtype.  The
    TPU kernel's loop, offset by offset."""
    bt, c, n = q.shape
    d = c // heads
    scaling = d**-0.5
    qf = q.float()
    k, v = kv[:, :c], kv[:, c:]
    out = None
    for noff, block, stride, table, s_col in ((w, w, 1, bx, sc[:, 0:1]),
                                             (h, n, w, by, sc[:, 1:2])):
        idx = [_roll_index(r * stride, block, n, q.device) for r in range(noff)]
        logits = [(qf * k[..., idx[r]].float()).reshape(bt, heads, d, n).sum(2) * scaling
                  + table[r * heads:(r + 1) * heads] for r in range(noff)]
        m = logits[0]
        for r in range(1, noff):
            m = torch.maximum(m, logits[r])
        exps = [torch.exp(lg - m) for lg in logits]
        z = exps[0]
        for r in range(1, noff):
            z = z + exps[r]
        inv_z = 1.0 / z
        pv = vmean = None
        for r in range(noff):
            v_r = v[..., idx[r]].float()
            p = (exps[r] * inv_z)[:, :, None, :].expand(bt, heads, d, n).reshape(bt, c, n)
            pv = p * v_r if pv is None else pv + p * v_r
            vmean = v_r if vmean is None else vmean + v_r
        vmean = vmean * (1.0 / noff)
        o = s_col * pv + (1.0 - s_col) * vmean
        out = o if out is None else (out + o) * 0.5
    return out.to(q.dtype)


def line_table(table: torch.Tensor, heads: int, head: int, h: int, w: int, axis: int,
               line: int) -> torch.Tensor:
    """The (L, L) bias of one line of one head, as ``core_kernel`` stages it
    from the (L*heads, N) offset table (bx for rows, axis 0, L = w; by for
    columns, axis 1, L = h): entry (i, j), query i and key j of the line, is
    ``table[((j - i) mod L) * heads + head, pos(i)]``, pos(i) the query's
    position (``line * w + i`` on a row, ``i * w + line`` on a column) —
    the TPU kernel adds ``table[r * heads + head, p]`` to the logit of the
    query at p and the key r offsets on."""
    n = h * w
    length = w if axis == 0 else h
    i = torch.arange(length, device=table.device)
    pos = line * w + i if axis == 0 else i * w + line
    r = (i[None, :] - i[:, None]) % length
    return table.view(length, heads, n)[r, head, pos[:, None]]


def lane_core_operands(q, kv, bx, by, sc, heads: int, h: int, w: int) -> str:
    """Raise unless :func:`lane_core`'s kernels take these operands (the
    shapes, both types, the lines, the bfloat16 kernel's head dims), naming
    the tensor or the shape; returns the call's label."""
    bt, c, n = q.shape
    what = f"lane_core at q {tuple(q.shape)}, heads {heads}, grid {h}x{w}"
    if c % heads or n != h * w or max(h, w) > MAX_LINE:
        raise ValueError(f"{what}: needs C a multiple of heads, N = h*w, lines of at most "
                         f"{MAX_LINE}")
    if q.dtype not in _build.DTYPE_CODES or kv.dtype != q.dtype:
        raise TypeError(f"{what}: q and kv float32 or bfloat16 alike, not {q.dtype}, {kv.dtype}")
    _build.check_shapes(what, kv=(kv, (bt, 2 * c, n)), bx=(bx, (w * heads, n)),
                        by=(by, (h * heads, n)), sc=(sc, (c, 2)))
    if q.dtype == torch.bfloat16 and c // heads not in HOPPER_HEAD_DIMS:
        raise ValueError(f"{what}: the bfloat16 kernel takes head dims {HOPPER_HEAD_DIMS}, "
                         f"not {c // heads}")
    return what


def _lane_core_call(entry: str, q, kv, bx, by, sc, heads: int, h: int, w: int, lead=(),
                    tail=()) -> torch.Tensor:
    """One call of a C entry of ``csrc/probe_lane_axial.cu``: one direction
    into a float32 scratch of the output's size, the other adding it and
    rounding once into the output."""
    bt, c, n = q.shape
    what = lane_core_operands(q, kv, bx, by, sc, heads, h, w)
    q, kv = q.contiguous(), kv.contiguous()
    bx, by, sc = (t.float().contiguous() for t in (bx, by, sc))
    scratch = torch.empty(bt, c, n, device=q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    err = getattr(lib, entry)(*lead, q.data_ptr(), kv.data_ptr(), bx.data_ptr(), by.data_ptr(),
                              sc.data_ptr(), scratch.data_ptr(), out.data_ptr(), bt, h, w, c,
                              heads, *tail, _build.stream_handle(q.device))
    _build.check(lib, err, f"{what} ({entry})")
    return out


def lane_core_hopper(q, kv, bx, by, sc, heads: int, h: int, w: int) -> torch.Tensor:
    """bfloat16 ``bench_core`` on ``core_kernel`` (C entry
    ``bf_probe_lane_core_hopper``; the column pass, then the row pass): head
    dims 16 and 64; counts ``lane_core_hopper.launches``."""
    out = _lane_core_call("bf_probe_lane_core_hopper", q, kv, bx, by, sc, heads, h, w,
                          lead=(q.shape[1] // heads,))
    lane_core_hopper.launches += 1
    return out


def lane_core_line(q, kv, bx, by, sc, heads: int, h: int, w: int) -> torch.Tensor:
    """float32 ``bench_core`` on ``lane_core_kernel`` (C entry
    ``bf_probe_lane_core``); counts ``lane_core_line.launches``."""
    out = _lane_core_call("bf_probe_lane_core", q, kv, bx, by, sc, heads, h, w,
                          tail=((q.shape[1] // heads)**-0.5,))
    lane_core_line.launches += 1
    return out


def lane_core_kernels(dtype: torch.dtype):
    """:func:`lane_core`'s kernel on the card for ``dtype``: bfloat16
    :func:`lane_core_hopper`, float32 :func:`lane_core_line`."""
    if dtype == torch.bfloat16:
        return lane_core_hopper
    if dtype == torch.float32:
        return lane_core_line
    raise TypeError(f"lane_core kernel takes float32 or bfloat16, not {dtype}")


def lane_core(q, kv, bx, by, sc, heads: int, h: int, w: int) -> torch.Tensor:
    """``bench_core``'s kernel: :func:`lane_core_plain` on the CPU; on a card
    the kernel :func:`lane_core_kernels` picks by dtype (one direction into
    a float32 scratch, the other adding it and rounding once), counted in
    ``lane_core.launches``.  q and kv float32 or bfloat16, lines of at most
    ``MAX_LINE`` tokens (:func:`lane_core_operands`)."""
    if not check_device("lane_core", q):
        return lane_core_plain(q, kv, bx, by, sc, heads, h, w)
    out = lane_core_kernels(q.dtype)(q, kv, bx, by, sc, heads, h, w)
    lane_core.launches += 1
    return out


lane_core.launches = lane_core_hopper.launches = lane_core_line.launches = 0

# probe_within_roll's slab: C lanes rows of T frames of H x W tokens.
ROLL_SHAPE = SimpleNamespace(C=16, H=8, W=32, T=2)


def within_roll_input(dtype) -> torch.Tensor:
    """``probe_within_roll``'s x: (16, 512) from ``default_rng(0)``."""
    s = ROLL_SHAPE
    x = np.random.default_rng(0).standard_normal((s.C, s.T * s.H * s.W)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def probe_within_roll(dtype, device) -> tuple:
    """``probe_within_roll(dtype)`` on ``device``: (ok, detail)."""
    s = ROLL_SHAPE
    tn = s.T * s.H * s.W
    x = within_roll_input(dtype).to(device)
    o1, o2 = within_roll(x, 5, s.W, 3 * s.W, s.H * s.W)
    xf = x.float().cpu().numpy()
    ref1 = np.roll(xf.reshape(s.C, s.T * s.H, s.W), -5, axis=2).reshape(s.C, tn)
    ref2 = np.roll(xf.reshape(s.C, s.T, s.H, s.W), -3, axis=2).reshape(s.C, tn)
    e1 = float(np.max(np.abs(o1.float().cpu().numpy() - ref1)))
    e2 = float(np.max(np.abs(o2.float().cpu().numpy() - ref2)))
    return max(e1, e2) < 1e-6, f"row_err={e1:.1e} col_err={e2:.1e}"


def make_inputs(args) -> dict:
    """``bench_core``'s inputs, drawn as the JAX probe draws them
    (``default_rng(0)``: q, kv in bfloat16, the two bias tables at 0.1, sc
    in [0.5, 1.5)), on the CPU: the arguments of :func:`lane_core`."""
    heads, d = args.heads, args.embed_dim // args.heads
    c, h, w = heads * d, args.grid, args.grid
    n, bt = h * w, args.batch * args.tw
    rng = np.random.default_rng(0)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    q = bf16(rng.standard_normal((bt, c, n)))
    kv = bf16(rng.standard_normal((bt, 2 * c, n)))
    bx = torch.from_numpy(rng.standard_normal((w * heads, n)).astype(np.float32) * 0.1)
    by = torch.from_numpy(rng.standard_normal((h * heads, n)).astype(np.float32) * 0.1)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (c, 2)).astype(np.float32))
    return dict(q=q, kv=kv, bx=bx, by=by, sc=sc, heads=heads, h=h, w=w)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="P1, the lane-roll axial attention probe")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tw", type=int, default=5)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--embed-dim", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    return ap


def main(argv=None) -> dict:
    """The probe: both rolls in float32 and bfloat16, then (unless
    ``--skip-bench``) ``lane_core`` timed over ``--steps`` calls by CUDA
    events, one JSON line.  Returns the probe results and the JSON line."""
    from bubbleformer_tpu_torch.training.module import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    announce(dev)
    compile_s = build_seconds(dev)
    results = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ok, detail = probe_within_roll(dt, dev)
        log(f"within_roll {name}: {'OK' if ok else 'MISMATCH'} {detail}")
        results[f"within_roll {name}"] = ok
    if not args.skip_bench:
        inputs = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in make_inputs(args).items()}
        ms = cuda_ms(lambda: lane_core(**inputs), args.steps, dev)
        line = {"probe": "lane_axial_core_fwd", "ms_per_call": ms, "compile_s": compile_s,
                "batch": args.batch, "offsets": 2 * args.grid, "device": str(dev),
                "note": "one call = rows+cols attention core fwd for the whole (B, C, T*N) "
                        "activation set; ms_per_call by CUDA events (null off the card)"}
        print(json.dumps(line), flush=True)
        results["bench"] = line
    return results
