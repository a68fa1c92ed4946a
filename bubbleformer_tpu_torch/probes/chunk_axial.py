"""P2: the chunk-matmul axial attention probe on the port's kernels.

Counterpart of ``scripts/probe_chunk_axial.py``: its three Pallas kernels as
``csrc/probe_chunk_axial.cu`` (bfloat16),

- :func:`dot_combos` — ``probe_dot_combos``' kernel (``:83``): S = q^T k over
  slab rows, pv = v . bf16(softmax(S))^T;
- :func:`perm_product` — ``probe_perm_matmul``'s kernel (``:124``): bf16(x .
  P) for a 0/1 permutation P, bit-exact, on the Hopper GEMM
  (``csrc/hopper_gemm.cuh``, whose TMA loads need 16-byte aligned operands
  with rows a multiple of 16 bytes: :func:`perm_operands` checks them);
- :func:`chunk_core` — ``bench_core``'s kernel (``:260``, bodies
  ``_core_kernel :176``, ``_axis_pass :140``): per (head, chunk) attention
  on the slabs (rows) and on their P-relayouts (columns), averaged;

with their plain versions, the probe's inputs (:func:`make_inputs`,
:func:`dot_combos_input`, :func:`perm_input`) and its command line
(:func:`main`, run by ``scripts/probe_chunk_axial_torch.py``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.probes import announce, build_seconds, check_device, cuda_ms, log

# probe_dot_combos' slab slices: rows [0, D) and [D, 2D), tokens [0, CH).
DOT_D, DOT_CH = 64, 128


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(s - max) / sum."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def dot_combos_plain(x: torch.Tensor, y: torch.Tensor, d: int = DOT_D, ch: int = DOT_CH):
    """Plain PyTorch version of ``probe_dot_combos``' kernel: (S (ch, ch),
    pv (d, ch)) float32 from slabs x, y."""
    q, k, v = x[0:d, 0:ch].float(), y[0:d, 0:ch].float(), y[d:2 * d, 0:ch]
    s = q.t() @ k
    pv = v.float() @ _softmax(s).to(v.dtype).float().t()
    return s, pv


def perm_product_plain(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``probe_perm_matmul``'s kernel: x . P in
    float32, rounded to x's dtype (x (..., n), P (n, n))."""
    return (x.float() @ p.float()).to(x.dtype)


def _axis_pass_plain(q, k, v, bias, mblk, s_col, heads: int, ch: int) -> torch.Tensor:
    """``_axis_pass`` over every frame: (BT, C, N) float32."""
    bt, c, n = q.shape
    d, nch = c // heads, n // ch

    def split(x):  # (BT, heads, d, chunks, ch)
        return x.reshape(bt, heads, d, nch, ch).float()

    s = torch.einsum("bhdci,bhdcj->bhcij", split(q), split(k))
    s = s * d**-0.5 + bias.reshape(heads, 1, ch, ch)
    p = _softmax(s)
    s_h = s_col.reshape(heads, 1, 1, 1)
    pb = (s_h * p + mblk * (1.0 - s_h)).to(v.dtype)
    return torch.einsum("bhdcj,bhcij->bhdci", split(v), pb.float()).reshape(bt, c, n)


def chunk_core_plain(q, kv, br, bc, mrs, mcs, perm, sc, heads: int, ch: int) -> torch.Tensor:
    """Plain PyTorch version of ``bench_core``'s kernel over every frame: q
    (BT, C, N), kv (BT, 2C, N), perm (N, N) in one dtype; br, bc (heads*ch,
    ch), mrs, mcs (ch, ch), sc (heads, 2) float32.  Returns (BT, C, N) in q's
    dtype."""
    c = q.shape[1]
    k, v = kv[:, :c], kv[:, c:]
    o_row = _axis_pass_plain(q, k, v, br, mrs, sc[:, 0], heads, ch)
    qt, kt, vt = (perm_product_plain(x, perm) for x in (q, k, v))
    o_col_t = _axis_pass_plain(qt, kt, vt, bc, mcs, sc[:, 1], heads, ch)
    o_col = o_col_t.to(q.dtype).float() @ perm.float().t()
    return (0.5 * (o_row + o_col)).to(q.dtype)


def _chunk_attention(q, k, v, frames, heads, d, nchunks, ch, q_fs, kv_fs, ld, out, out_fs,
                     out_ld, bias=None, mblk=None, sc=None, sc_col=0, scaling=1.0, s_out=None):
    """Launch ``chunk_attention_kernel`` (bf16 views given by their first
    elements and strides, which TMA reads as 4-D views (tokens, d, heads,
    frames): every base 16-byte aligned, ld and the frame strides multiples
    of 8, as the callers' checks ensure); with ``s_out`` its P2a form."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    err = lib.bf_probe_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_fs, kv_fs, ld, ptr(bias), ptr(mblk),
        ptr(sc), sc_col, scaling, ptr(s_out), out.data_ptr(), int(out.dtype == torch.bfloat16),
        out_fs, out_ld, frames, heads, d, nchunks, ch, _build.stream_handle(q.device))
    _build.check(lib, err, "bf_probe_chunk_attention")


def _perm_product(x, p, out, addend=None):
    """Launch the permutation product on the Hopper GEMM: out = bf16(x . P),
    or with ``addend`` bf16((addend + x . P^T) / 2); x, out, addend (rows,
    n) contiguous, x and p as :func:`perm_operands` passes them."""
    rows, n = x.shape
    lib = _build.library()
    err = lib.bf_probe_perm_product(x.data_ptr(), p.data_ptr(), int(addend is not None),
                                    None if addend is None else addend.data_ptr(),
                                    out.data_ptr(), rows, n, _build.stream_handle(x.device))
    if err:
        _build.check(lib, err, "bf_probe_perm_product")


def _need_bf16(what, *ts):
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what} kernel takes bfloat16, not {[t.dtype for t in ts]}")


def dot_combos(x: torch.Tensor, y: torch.Tensor, d: int = DOT_D, ch: int = DOT_CH):
    """``probe_dot_combos``' kernel on slabs x, y (rows, n): the plain version
    on the CPU; on a card one block of ``chunk_attention_kernel`` reading the
    slices in place by TMA (counted in ``dot_combos.launches``): x and y are
    made contiguous, and where TMA still cannot read them (rows not a
    multiple of 16 bytes, a base not 16-byte aligned) it raises naming the
    slab (``_build.check_tma``)."""
    if not check_device("dot_combos", x):
        return dot_combos_plain(x, y, d, ch)
    _need_bf16("dot_combos", x, y)
    rows, n = x.shape
    if y.shape != x.shape or 2 * d > rows or ch > n or ch % 32 or ch > 128 or d > 128:
        raise ValueError(f"dot_combos: slabs {tuple(x.shape)}, {tuple(y.shape)} with d {d}, "
                         f"chunk {ch} (a multiple of 32 up to 128)")
    x, y = x.contiguous(), y.contiguous()
    _build.check_tma("dot_combos", x=x, y=y)
    s = torch.empty(ch, ch, device=x.device)
    pv = torch.empty(d, ch, device=x.device)
    _chunk_attention(x, y, y[d:], 1, 1, d, 1, ch, 0, 0, n, pv, 0, ch, s_out=s)
    dot_combos.launches += 1
    return s, pv


def perm_operands(what: str, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Raise unless x (..., n) and P (n, n) can be the Hopper GEMM's
    operands: bfloat16, P of x's width, each contiguous with its base
    16-byte aligned and its rows a multiple of 16 bytes (n a multiple of 8),
    as its TMA loads need (``_build.check_tma``, which names the tensor that
    fails).  Returns x as (rows, n)."""
    n = x.shape[-1]
    if x.dtype != torch.bfloat16 or p.dtype != torch.bfloat16:
        _need_bf16(what, x, p)
    if p.shape != (n, n):
        _build.check_shapes(what, p=(p, (n, n)))
    x2 = x if x.dim() == 2 else x.reshape(-1, n)
    _build.check_tma(what, x=x2, p=p)
    return x2


def perm_product(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``probe_perm_matmul``'s kernel, bf16(x . P) for x (..., n) and P (n,
    n) bfloat16: the plain version on the CPU; on a card the Hopper GEMM's
    NN layout (counted in ``perm_product.launches``), on operands that
    :func:`perm_operands` passes."""
    if not check_device("perm_product", x):
        return perm_product_plain(x, p)
    x2 = perm_operands("perm_product", x, p)
    out = torch.empty_like(x2)
    _perm_product(x2, p, out)
    perm_product.launches += 1
    return out if x2 is x else out.view(x.shape)


def table_operands(what: str, **tables) -> None:
    """Raise unless each contiguous float32 table of the chunk kernel (the
    bias and Mblk tables, which it reads 16 bytes at a time) starts 16-byte
    aligned; the message names the table that fails."""
    for name, t in tables.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} starts at {t.data_ptr():#x}, which is not "
                             "16-byte aligned (the kernel reads it 16 bytes at a time)")


def chunk_core(q, kv, br, bc, mrs, mcs, perm, sc, heads: int, ch: int) -> torch.Tensor:
    """``bench_core``'s kernel: :func:`chunk_core_plain` on the CPU; on a card
    (bfloat16) five launches, counted once in ``chunk_core.launches``: the
    row pass (``chunk_attention_kernel``, TMA and ``wgmma``, into float32
    o_row), the relayouts bf16(q . P) and bf16(kv . P), the column pass
    (bf16 o_col_t), and bf16((o_row + o_col_t . P^T) / 2), the three
    products on the Hopper GEMM (q, kv and P as :func:`perm_operands` passes
    them, the tables as :func:`table_operands` does)."""
    if not check_device("chunk_core", q):
        return chunk_core_plain(q, kv, br, bc, mrs, mcs, perm, sc, heads, ch)
    bt, c, n = q.shape
    d = c // heads
    what = f"chunk_core at q {tuple(q.shape)}, heads {heads}, chunk {ch}"
    _need_bf16(what, q, kv, perm)
    if c % heads or n % ch or ch % 32 or ch > 128 or d > 128:
        raise ValueError(f"{what}: needs C a multiple of heads (head dim up to 128) and N a "
                         f"multiple of the chunk, a multiple of 32 up to 128")
    _build.check_shapes(what, kv=(kv, (bt, 2 * c, n)), br=(br, (heads * ch, ch)),
                        bc=(bc, (heads * ch, ch)), mrs=(mrs, (ch, ch)), mcs=(mcs, (ch, ch)),
                        perm=(perm, (n, n)), sc=(sc, (heads, 2)))
    q, kv = q.contiguous(), kv.contiguous()
    perm_operands(what, q, perm)
    perm_operands(what, kv, perm)
    br, bc, mrs, mcs, sc = (t.float().contiguous() for t in (br, bc, mrs, mcs, sc))
    table_operands(what, br=br, bc=bc, mrs=mrs, mcs=mcs)
    scaling = d**-0.5
    common = dict(frames=bt, heads=heads, d=d, nchunks=n // ch, ch=ch, ld=n, out_ld=n,
                  scaling=scaling)
    o_row = torch.empty(bt, c, n, device=q.device)
    _chunk_attention(q, kv, kv[:, c:], q_fs=c * n, kv_fs=2 * c * n, out=o_row, out_fs=c * n,
                     bias=br, mblk=mrs, sc=sc, sc_col=0, **common)
    qt, kvt = torch.empty_like(q), torch.empty_like(kv)
    _perm_product(q.view(-1, n), perm, qt.view(-1, n))
    _perm_product(kv.view(-1, n), perm, kvt.view(-1, n))
    o_col_t = torch.empty_like(q)
    _chunk_attention(qt, kvt, kvt[:, c:], q_fs=c * n, kv_fs=2 * c * n, out=o_col_t,
                     out_fs=c * n, bias=bc, mblk=mcs, sc=sc, sc_col=1, **common)
    out = torch.empty_like(q)
    _perm_product(o_col_t.view(-1, n), perm, out.view(-1, n), addend=o_row.view(-1, n))
    chunk_core.launches += 1
    return out


dot_combos.launches = 0
perm_product.launches = 0
chunk_core.launches = 0


def dot_combos_input():
    """``probe_dot_combos``' slabs x, y (384, 1024) bf16 from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((384, 1024)).astype(np.float32)
    y = rng.standard_normal((384, 1024)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y).to(torch.bfloat16)


def permutation(h: int, w: int, dtype) -> torch.Tensor:
    """P[i, j] = 1 where j = (i % w) * h + i // w: lane i of an h-major
    (h, w) grid to its w-major place."""
    n = h * w
    i = np.arange(n)
    p = np.zeros((n, n), np.float32)
    p[i, (i % w) * h + i // w] = 1.0
    return torch.from_numpy(p).to(dtype)


def perm_input():
    """``probe_perm_matmul``'s x (384, 1024) bf16 from ``default_rng(1)`` and
    P for the 32 x 32 grid."""
    x = np.random.default_rng(1).standard_normal((384, 32 * 32)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), permutation(32, 32, torch.bfloat16)


def probe_dot_combos(device) -> tuple:
    """``probe_dot_combos()`` on ``device``: (ok, detail), the JAX probe's
    references and bounds."""
    x, y = (t.to(device) for t in dot_combos_input())
    s, pv = dot_combos(x, y)
    d, ch = DOT_D, DOT_CH
    xf, yf = x.float().cpu(), y.float().cpu()
    s_ref = xf[0:d, 0:ch].t() @ yf[0:d, 0:ch]
    e1 = (s.cpu() - s_ref).abs().max().item()
    pv_ref = yf[d:2 * d, 0:ch] @ _softmax(s_ref).t()
    e2 = (pv.cpu() - pv_ref).abs().max().item()
    return e1 < 0.25 and e2 < 0.25, f"s_err={e1:.2e} pv_err={e2:.2e}"


def probe_perm_matmul(device) -> tuple:
    """``probe_perm_matmul()`` on ``device``: (ok, detail); exact or not."""
    x, p = (t.to(device) for t in perm_input())
    o = perm_product(x, p)
    ref = x.float().cpu().reshape(384, 32, 32).transpose(1, 2).reshape(384, 1024)
    err = (o.float().cpu() - ref).abs().max().item()
    return err == 0.0, f"perm_err={err:.1e}"


def make_inputs(args) -> dict:
    """``bench_core``'s inputs, drawn as the JAX probe draws them
    (``default_rng(0)``: q, kv bf16, per-head bias tables at 0.1 with -1e9
    off the line blocks, the kron window means, P, sc in [0.5, 1.5)), on the
    CPU: the arguments of :func:`chunk_core`."""
    heads, d = args.heads, args.embed_dim // args.heads
    c, h, w, ch = heads * d, args.grid, args.grid, args.chunk
    n, bt = h * w, args.batch * args.tw
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((bt, c, n)).astype(np.float32)).to(torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((bt, 2 * c, n)).astype(np.float32)).to(
        torch.bfloat16)

    def mk_bias(blk):
        t = np.full((heads, ch, ch), -1e9, np.float32)
        for hd in range(heads):
            bias = rng.standard_normal((blk, blk)).astype(np.float32) * 0.1
            for g in range(ch // blk):
                t[hd, g * blk:(g + 1) * blk, g * blk:(g + 1) * blk] = bias
        return torch.from_numpy(t.reshape(heads * ch, ch))

    br = mk_bias(w)
    bc = mk_bias(h)
    mrs = torch.from_numpy(np.kron(np.eye(ch // w, dtype=np.float32), np.full((w, w), 1.0 / w)))
    mcs = torch.from_numpy(np.kron(np.eye(ch // h, dtype=np.float32), np.full((h, h), 1.0 / h)))
    perm = permutation(h, w, torch.bfloat16)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (heads, 2)).astype(np.float32))
    return dict(q=q, kv=kv, br=br, bc=bc, mrs=mrs.float(), mcs=mcs.float(), perm=perm, sc=sc,
                heads=heads, ch=ch)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="P2, the chunk-matmul axial attention probe")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tw", type=int, default=5)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--embed-dim", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    return ap


def main(argv=None) -> dict:
    """The probe: ``dot_combos`` and ``perm_matmul``, then (unless
    ``--skip-bench``) ``chunk_core`` timed over ``--steps`` calls by CUDA
    events, one JSON line.  Returns the probe results and the JSON line."""
    from bubbleformer_tpu_torch.training.module import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    announce(dev)
    compile_s = build_seconds(dev)
    results = {}
    for name, fn in (("dot_combos", probe_dot_combos), ("perm_matmul", probe_perm_matmul)):
        ok, detail = fn(dev)
        log(f"{name}: {'OK' if ok else 'MISMATCH'} {detail}")
        results[name] = ok
    if not args.skip_bench:
        inputs = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in make_inputs(args).items()}
        ms = cuda_ms(lambda: chunk_core(**inputs), args.steps, dev)
        line = {"probe": "chunk_axial_core_fwd", "ms_per_call": ms, "compile_s": compile_s,
                "batch": args.batch, "chunk": args.chunk, "device": str(dev),
                "note": "one call = rows+cols per-head chunk-matmul attention core fwd (incl. "
                        "transposes, window means, attn_scale blend) for the whole (B, C, N) "
                        "per-frame set; ms_per_call by CUDA events (null off the card)"}
        print(json.dumps(line), flush=True)
        results["bench"] = line
    return results
