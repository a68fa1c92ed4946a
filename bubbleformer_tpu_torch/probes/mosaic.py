"""P4: the layout probes on the port's kernels.

Counterpart of ``scripts/probe_mosaic.py``, whose 14 kernel bodies
(``:44-:310``) run through one ``pallas_call`` (``_run :36``) to ask whether
Mosaic lowers in-kernel reshapes, slices, transposes and per-head views.  On
Hopper a view is a shape and strides, so the bodies run on three kernels of
``csrc/probe_layout.cu`` that take strided views:

- :func:`gram` — ``a . a^T`` in float32 of a (rows, cols) view, on
  ``gram_tc_kernel``: one triangle of 32 x 32 tiles, each written to both
  places; bfloat16 products on the tensor cores with float32 sums, float32
  ones as three TF32 products of the split a = hi + lo
  (:func:`tf32_round`); the view folded to 2-D where its rows allow
  (:func:`gram_operands`) and staged by 16-byte copies where it is
  aligned;
- :func:`view_copy` — ``dst = dtype(scale * src)``, or added to ``dst``,
  between the views as :func:`fold_views` folds them, 16 bytes a thread
  where both allow it (:func:`copy_vector`), described to the kernel by one
  packed descriptor (:func:`copy_descriptor`);
- :func:`chunk_gram_apply` — per chunk ``(c . c^T) . c`` over row or column
  chunks of a (B, H, W, heads, D) tensor, written or added in its dtype:
  bfloat16 on ``chunk_gram_hopper_kernel`` (:func:`chunk_gram_hopper`, the
  chunk staged once a block, both products on the tensor cores), float32
  on ``chunk_gram_kernel`` (:func:`chunk_gram_line`);

each with its plain version.  ``BODIES`` holds the 14 bodies on them and
the ``probe_*`` functions (the JAX names) check each against its reference
on a device, returning ``(ok, detail)`` with the JAX probe's bounds.  Two
JAX references stack the heads on axis 2 and then transpose
(``probe_mosaic.py:254``, ``:304``), which does not match the (1, H, W,
heads, D) the kernels write: they raise there, so those two kernels were
never checked.  The references here keep the kernels' layout, without the
transpose.  :func:`main` is the command line of
``scripts/probe_mosaic_torch.py``.
"""
from __future__ import annotations

import argparse
import functools
import math
import struct
from types import SimpleNamespace

import numpy as np
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.probes import announce, build_seconds, check_device

H, W, D = 32, 32, 64
WC = 8
HEADS = 6
CHUNK = 8  # rows (or columns) a chunk of the per-head bodies
HOPPER_HEAD_DIMS = (16, 64)  # head dims of the bfloat16 chunk kernel
# Shared memory a block of the chunk kernels may take, and the rows the
# bfloat16 one stages a chunk in (a multiple of its 32-row key chunks).
SMEM_MAX = 232448
STAGE_ROWS = 32
MAX_DIMS = 5
# Bytes a thread of view_copy_kernel moves where both views allow it.
VECTOR_BYTES = 16
# The offsets of view_copy_kernel are 32-bit.
MAX_OFFSET = 2**31 - 1
# The most rows a Gram launch takes (csrc/probe_layout.cu: kMaxGramRows).
MAX_GRAM_ROWS = 65535 * 32


def _dtype_code(what, t):
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {t.dtype}")
    return _build.DTYPE_CODES[t.dtype]


def gram_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Gram bodies: ``a . a^T`` in float32 of
    ``a`` seen as (rows, cols), its last dimension the contraction."""
    a2 = a.reshape(-1, a.shape[-1]).float()
    return a2 @ a2.t()


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as float32: half a TF32 unit added to the bits and the
    13 low bits cleared (``cvt.rna.tf32.f32``'s rounding).  The float32
    Gram kernel splits a into hi = tf32_round(a) and lo = tf32_round(a -
    hi) and sums ``lo . hi^T + hi . lo^T + hi . hi^T`` on TF32 tensor
    cores: within ~2^-21 of a . a^T, where hi . hi^T alone is ~2^-11."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=256)
def gram_plan(shape, stride, dtype, offset: int) -> tuple:
    """How ``gram_tc_kernel`` takes a view of ``shape`` and ``stride``
    (elements) of ``dtype`` whose base address is ``offset`` modulo 16:
    (rows, cols, row_stride, col_stride, vec), the last dimension the
    contraction.  The rows (the other dimensions) are folded
    (:func:`fold_views`); where they fold to one stride, ``row_stride`` is
    it (0 for one row) and ``vec`` says whether 16-byte copies stage it
    (col_stride 1, cols and row_stride multiples of 16 bytes, the base
    aligned), else one element a thread of the 2-D view; where they do not,
    ``row_stride`` is None: one element a thread over the view's own shape
    and strides (``bf_probe_gram_view``).  Raises for other types than
    float32 and bfloat16, outside 2 to 5 dimensions, for no elements and
    past ``MAX_GRAM_ROWS`` rows or 2^31 columns.  Cached: a probe body
    repeats its view."""
    what = f"gram at {tuple(shape)}"
    if not 2 <= len(shape) <= MAX_DIMS:
        raise ValueError(f"{what}: a view of 2 to {MAX_DIMS} dimensions")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, not {dtype}")
    rows, cols, col_stride = math.prod(shape[:-1]), shape[-1], stride[-1]
    if rows == 0 or cols == 0:
        raise ValueError(f"{what}: no elements")
    if rows > MAX_GRAM_ROWS or cols > MAX_OFFSET:
        raise ValueError(f"{what}: past {MAX_GRAM_ROWS} rows or 2^31 columns")
    fshape, fstride, _ = fold_views(shape[:-1], stride[:-1], stride[:-1])
    if len(fshape) > 1:
        return rows, cols, None, col_stride, False
    row_stride = fstride[0] if rows > 1 else 0
    vec = VECTOR_BYTES // dtype.itemsize
    return rows, cols, row_stride, col_stride, (
        col_stride == 1 and not cols % vec and not row_stride % vec and not offset % 16)


def gram_operands(a: torch.Tensor) -> tuple:
    """:func:`gram_plan` of the view ``a``."""
    return gram_plan(tuple(a.shape), a.stride(), a.dtype, a.data_ptr() % 16)


def gram(a: torch.Tensor) -> torch.Tensor:
    """:func:`gram_plain` on the CPU; on a card ``gram_tc_kernel`` reading the
    view in place, as :func:`gram_operands` plans it (counted in
    ``gram.launches``)."""
    if not check_device("gram", a):
        return gram_plain(a)
    rows, cols, row_stride, col_stride, vec = gram_operands(a)
    out = torch.empty((rows, rows), device=a.device)
    lib = _build.library()
    code, ptr, stream = _build.DTYPE_CODES[a.dtype], a.data_ptr(), _build.stream_handle(a.device)
    if row_stride is None:
        entry = "bf_probe_gram_view"
        err = lib.bf_probe_gram_view(code, ptr, _build.int64_array(a.shape),
                                     _build.int64_array(a.stride()), a.dim(), out.data_ptr(),
                                     stream)
    else:
        entry = "bf_probe_gram"
        err = lib.bf_probe_gram(code, ptr, rows, cols, row_stride, col_stride, vec,
                                out.data_ptr(), stream)
    if err:
        _build.check(lib, err, f"gram at {tuple(a.shape)} ({entry})")
    gram.launches += 1
    return out


def view_copy_plain(src: torch.Tensor, dst: torch.Tensor, scale: float = 1.0,
                    accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the copy bodies: ``dst = dtype(scale * src)``
    or, with ``accumulate``, ``dtype(dst + scale * src)``, in float32, in
    place; returns ``dst``."""
    v = src.float() * scale
    if accumulate:
        v = dst.float() + v
    return dst.copy_(v)


def fold_views(shape, src_stride, dst_stride) -> tuple:
    """The fewest dimensions that address the same elements of two views of
    one shape in the same order: dimensions of size 1 dropped, and each
    dimension merged into the one before it where that one's stride is its
    size times its stride in both views.  Returns (shape, src_stride,
    dst_stride) as tuples of at least one dimension."""
    dims = [[n, s, d] for n, s, d in zip(shape, src_stride, dst_stride) if n != 1]
    folded = dims[:1] or [[1, 1, 1]]
    for n, s, d in dims[1:]:
        outer = folded[-1]
        if outer[1] == n * s and outer[2] == n * d:
            outer[:] = [outer[0] * n, s, d]
        else:
            folded.append([n, s, d])
    return tuple(map(tuple, zip(*folded)))


def copy_vector(shape, src_stride, dst_stride, src_size: int, dst_size: int,
                src_offset: int = 0, dst_offset: int = 0) -> int:
    """Elements a thread of ``view_copy_kernel`` moves over folded views:
    :data:`VECTOR_BYTES` of the wider element type where the innermost run
    is contiguous in both views, its length and every outer stride are
    multiples of that many elements, and both bases (``*_offset``, their
    addresses modulo 16) are aligned to a vector; else 1."""
    vec = VECTOR_BYTES // max(src_size, dst_size)
    if src_stride[-1] != 1 or dst_stride[-1] != 1 or shape[-1] % vec:
        return 1
    if any(s % vec for s in src_stride[:-1] + dst_stride[:-1]):
        return 1
    return 1 if src_offset % (vec * src_size) or dst_offset % (vec * dst_size) else vec


@functools.lru_cache(maxsize=256)
def copy_descriptor(shape, src_stride, dst_stride, src_dtype, dst_dtype, src_offset: int,
                    dst_offset: int, scale: float, accumulate: bool) -> bytes:
    """The packed ``CopyDesc`` of ``csrc/probe_layout.cu`` for a copy between
    views of ``shape`` with the given strides (elements), element types and
    base addresses modulo 16: folded (:func:`fold_views`), with its vector
    (:func:`copy_vector`).  Raises past :data:`MAX_DIMS` dimensions, for
    other element types than float32 and bfloat16, and past 32-bit offsets.
    Cached: a probe body repeats its views."""
    what = f"view_copy at {tuple(shape)}"
    if not 1 <= len(shape) <= MAX_DIMS or len(src_stride) != len(shape) or (
            len(dst_stride) != len(shape)):
        raise ValueError(f"{what}: views of one shape of 1 to {MAX_DIMS} dimensions")
    codes = [_build.DTYPE_CODES.get(t) for t in (src_dtype, dst_dtype)]
    if None in codes:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, not {src_dtype}, "
                        f"{dst_dtype}")
    numel = 1
    for n in shape:
        numel *= n
    if numel == 0:
        raise ValueError(f"{what}: no elements")
    for strides in (src_stride, dst_stride):
        if numel > MAX_OFFSET or sum((n - 1) * abs(s) for n, s in zip(shape, strides)) > (
                MAX_OFFSET):
            raise ValueError(f"{what}: past 2^31 elements (the kernel's offsets are 32-bit)")
    fshape, fs, fd = fold_views(shape, src_stride, dst_stride)
    vec = copy_vector(fshape, fs, fd, src_dtype.itemsize, dst_dtype.itemsize, src_offset,
                      dst_offset)
    pad = (0,) * (MAX_DIMS - len(fshape))
    return struct.pack(f"<5if{3 * MAX_DIMS}i", len(fshape), vec, *codes, int(accumulate),
                       scale, *fshape, *pad, *fs, *pad, *fd, *pad)


def view_copy(src: torch.Tensor, dst: torch.Tensor, scale: float = 1.0,
              accumulate: bool = False) -> torch.Tensor:
    """:func:`view_copy_plain` on the CPU; on a card ``view_copy_kernel``
    between the two views in place (counted in ``view_copy.launches``),
    both on one card."""
    if not check_device("view_copy", src):
        return view_copy_plain(src, dst, scale, accumulate)
    index = src.get_device()
    if dst.get_device() != index or src.shape != dst.shape:
        raise ValueError(f"view_copy: views of one shape on one card, not {tuple(src.shape)} "
                         f"on {src.device}, {tuple(dst.shape)} on {dst.device}")
    sp, dp = src.data_ptr(), dst.data_ptr()
    desc = copy_descriptor(src.shape, src.stride(), dst.stride(), src.dtype, dst.dtype, sp % 16,
                           dp % 16, scale, accumulate)
    lib = _build.library()
    err = lib.bf_probe_view_copy(desc, sp, dp, _build.stream_handle(src.device))
    if err:
        _build.check(lib, err, f"view_copy at {tuple(src.shape)} (bf_probe_view_copy)")
    view_copy.launches += 1
    return dst


def _chunk(t: torch.Tensor, axis: int, ci: int, chunk: int) -> torch.Tensor:
    sl = slice(ci * chunk, (ci + 1) * chunk)
    return t[:, sl] if axis == 1 else t[:, :, sl]


def chunk_gram_apply_plain(x: torch.Tensor, out: torch.Tensor, axis: int, chunk: int,
                           accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the per-head chunk bodies: for x and out (B,
    H, W, heads, D), per (b, head) and chunk c of ``chunk`` rows (axis 1) or
    columns (axis 2), its (row, column) positions in raster order, o = (c .
    c^T) . c in float32, written as dtype(o) or added as dtype(out +
    dtype(o)); in place, returns ``out``."""
    b, _, _, heads, d = x.shape
    for ci in range(x.shape[axis] // chunk):
        c = _chunk(x, axis, ci, chunk)
        n1, n2 = c.shape[1], c.shape[2]
        cf = c.permute(0, 3, 1, 2, 4).reshape(b, heads, n1 * n2, d).float()
        o = (cf @ cf.transpose(-1, -2)) @ cf
        o = o.reshape(b, heads, n1, n2, d).permute(0, 2, 3, 1, 4)
        dst = _chunk(out, axis, ci, chunk)
        dst.copy_(dst.float() + o.to(out.dtype).float() if accumulate else o)
    return out


def chunk_gram_operands(x: torch.Tensor, out: torch.Tensor, axis: int, chunk: int) -> str:
    """Raise unless :func:`chunk_gram_apply`'s kernels take these operands:
    x and out (B, H, W, heads, D) contiguous alike, chunks dividing axis 1
    or 2, for bfloat16 head dims 16 and 64 and a chunk's staged rows within
    a block's shared memory; names the tensor or the shape.  Returns the
    call's label."""
    what = f"chunk_gram_apply at {tuple(x.shape)}, axis {axis}, chunk {chunk}"
    if x.dim() != 5 or axis not in (1, 2) or chunk < 1 or x.shape[axis] % chunk:
        raise ValueError(f"{what}: x (B, H, W, heads, D), chunks dividing axis 1 or 2")
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"{what}: out is {tuple(out.shape)} {out.dtype}, not x's shape and "
                         f"dtype ({x.dtype})")
    for name, t in (("x", x), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} of strides {t.stride()} is not contiguous")
    _dtype_code(what, x)
    if x.dtype == torch.bfloat16:
        d = x.shape[4]
        rows = -(-(x.shape[1] * x.shape[2] // x.shape[axis] * chunk) // STAGE_ROWS) * STAGE_ROWS
        if d not in HOPPER_HEAD_DIMS:
            raise ValueError(f"{what}: the bfloat16 kernel takes head dims {HOPPER_HEAD_DIMS}, "
                             f"not {d}")
        if rows * d * x.element_size() > SMEM_MAX:
            raise ValueError(f"{what}: a chunk of {rows} staged rows of {d} does not fit a "
                             f"block's {SMEM_MAX} bytes of shared memory")
    return what


def _chunk_gram_call(entry: str, x, out, axis: int, chunk: int, accumulate: bool,
                     lead=()) -> torch.Tensor:
    what = chunk_gram_operands(x, out, axis, chunk)
    lib = _build.library()
    err = getattr(lib, entry)(*lead, x.data_ptr(), out.data_ptr(), _build.int64_array(x.shape),
                              _build.int64_array(x.stride()), axis, chunk, int(accumulate),
                              _build.stream_handle(x.device))
    _build.check(lib, err, f"{what} ({entry})")
    return out


def chunk_gram_hopper(x: torch.Tensor, out: torch.Tensor, axis: int, chunk: int,
                      accumulate: bool = False) -> torch.Tensor:
    """bfloat16 chunk products on ``chunk_gram_hopper_kernel`` (C entry
    ``bf_probe_chunk_gram_hopper``); counts ``chunk_gram_hopper.launches``."""
    _chunk_gram_call("bf_probe_chunk_gram_hopper", x, out, axis, chunk, accumulate,
                     lead=(x.shape[-1],))
    chunk_gram_hopper.launches += 1
    return out


def chunk_gram_line(x: torch.Tensor, out: torch.Tensor, axis: int, chunk: int,
                    accumulate: bool = False) -> torch.Tensor:
    """float32 chunk products on ``chunk_gram_kernel`` (C entry
    ``bf_probe_chunk_gram``); counts ``chunk_gram_line.launches``."""
    _chunk_gram_call("bf_probe_chunk_gram", x, out, axis, chunk, accumulate)
    chunk_gram_line.launches += 1
    return out


def chunk_gram_kernels(dtype: torch.dtype):
    """:func:`chunk_gram_apply`'s kernel on the card for ``dtype``: bfloat16
    :func:`chunk_gram_hopper`, float32 :func:`chunk_gram_line`."""
    if dtype == torch.bfloat16:
        return chunk_gram_hopper
    if dtype == torch.float32:
        return chunk_gram_line
    raise TypeError(f"chunk_gram_apply kernel takes float32 or bfloat16, not {dtype}")


def chunk_gram_apply(x: torch.Tensor, out: torch.Tensor, axis: int, chunk: int,
                     accumulate: bool = False) -> torch.Tensor:
    """:func:`chunk_gram_apply_plain` on the CPU; on a card one launch over
    every chunk of the kernel :func:`chunk_gram_kernels` picks by dtype
    (counted in ``chunk_gram_apply.launches``).  x and out contiguous alike
    (:func:`chunk_gram_operands`)."""
    if not check_device("chunk_gram_apply", x):
        return chunk_gram_apply_plain(x, out, axis, chunk, accumulate)
    chunk_gram_kernels(x.dtype)(x, out, axis, chunk, accumulate)
    chunk_gram_apply.launches += 1
    return out


gram.launches = 0
view_copy.launches = 0
chunk_gram_apply.launches = chunk_gram_hopper.launches = chunk_gram_line.launches = 0


KERNELS = SimpleNamespace(gram=gram, view_copy=view_copy, chunk_gram_apply=chunk_gram_apply)
PLAIN = SimpleNamespace(gram=gram_plain, view_copy=view_copy_plain,
                        chunk_gram_apply=chunk_gram_apply_plain)


def _like(shape, x):
    return x.new_empty(shape)


def _concat(x, ops, scales, axis):
    out = _like(tuple(s * len(scales) if i == axis else s for i, s in enumerate(x.shape)), x)
    n = x.shape[axis]
    for i, scale in enumerate(scales):
        ops.view_copy(x, out.narrow(axis, i * n, n), scale)
    return out


def _write_strided_slice(x, ops):
    out = _concat(x, ops, (1.0, 2.0, 3.0, 4.0), 1)
    ops.view_copy(x, out[:, 0:WC], 1.0, accumulate=True)
    return out


def _head_slices(x, ops):
    out = torch.empty_like(x)
    for hd in range(x.shape[3]):
        ops.view_copy(x[0, :, :, hd, :], out[0, :, :, hd, :], hd + 1.0)
    return out


def _head_slice_dot(x, ops):
    return ops.chunk_gram_apply(x, torch.empty_like(x), 1, CHUNK)


def _chunked_ref_reads(x, ops):
    out = ops.chunk_gram_apply(x, torch.empty_like(x), 1, CHUNK)
    return ops.chunk_gram_apply(x, out, 2, CHUNK, accumulate=True)


# The 14 bodies in the JAX probe's order: name -> (its printed label, the
# input's seed, shape and dtype, the body: f(x, ops) on ``KERNELS`` (the
# wrappers) or ``PLAIN`` (the plain versions on any device)).
BODIES = {
    "reshape_col": ("reshape_col (H,Wc,d)->(H*Wc,d) + dot", 0, (H, WC, D), torch.float32,
                    lambda x, ops: ops.gram(x.reshape(H * WC, D))),
    "reshape_row": ("reshape_row (Gr,W,d)->(Gr*W,d) + dot", 1, (8, W, D), torch.float32,
                    lambda x, ops: ops.gram(x.reshape(8 * W, D))),
    "transpose": ("transpose (H,Wc,d)->(Wc,H,d)", 2, (H, WC, D), torch.float32,
                  lambda x, ops: ops.view_copy(x.permute(1, 0, 2), _like((WC, H, D), x))),
    "sliced_block_dot": ("sliced 5D block -> 2D dot", 3, (1, H, WC, 1, D), torch.float32,
                         lambda x, ops: ops.gram(x[0, :, :, 0, :])),
    "bf16_dot": ("bf16 in, f32 dot", 4, (256, D), torch.bfloat16, lambda x, ops: ops.gram(x)),
    "split_reshape": ("split (128,64)->(4,32,64)", 5, (128, 64), torch.float32,
                      lambda x, ops: ops.view_copy(x.reshape(4, 32, 64), _like((4, 32, 64), x),
                                                   2.0)),
    "concat0": ("concat axis0 3D", 6, (4, 32, 64), torch.float32,
                lambda x, ops: _concat(x, ops, (1.0, 2.0), 0)),
    "concat1": ("concat axis1 3D", 7, (32, 8, 64), torch.float32,
                lambda x, ops: _concat(x, ops, (1.0, 2.0, 3.0, 4.0), 1)),
    "write_strided_slice": ("write strided slices + rmw", 8, (32, 8, 64), torch.float32,
                            _write_strided_slice),
    "transpose_full": ("transpose (32,32,64) maj", 9, (32, 32, 64), torch.float32,
                       lambda x, ops: ops.view_copy(x.permute(1, 0, 2), _like((32, 32, 64), x))),
    "merge_full": ("merge (32,32,64)->(1024,64)", 10, (32, 32, 64), torch.float32,
                   lambda x, ops: ops.view_copy(x.reshape(1024, 64), _like((1024, 64), x), 2.0)),
    "head_slice_bf16": ("per-head slice r/w bf16 5D", 11, (1, H, W, HEADS, D), torch.bfloat16,
                        _head_slices),
    "head_slice_dot_bf16": ("per-head slice+dot+concat bf16", 12, (1, H, W, HEADS, D),
                            torch.bfloat16, _head_slice_dot),
    "chunked_ref_reads_bf16": ("chunked ref reads/writes bf16 (v3)", 13, (1, H, W, HEADS, D),
                               torch.bfloat16, _chunked_ref_reads),
}
# The kernel each body runs on.
BODY_KERNEL = {name: ("gram" if name in ("reshape_col", "reshape_row", "sliced_block_dot",
                                         "bf16_dot")
                      else "chunk_gram_apply" if name in ("head_slice_dot_bf16",
                                                          "chunked_ref_reads_bf16")
                      else "view_copy") for name in BODIES}


def run_body(name: str, x: torch.Tensor, ops=KERNELS) -> torch.Tensor:
    """A body on x with ``ops``: the kernels' wrappers (default) or
    ``PLAIN``."""
    return BODIES[name][4](x, ops)


def body_input(name: str) -> torch.Tensor:
    """The body's input as the JAX probe draws it (``default_rng(seed)``,
    float64 normals converted to the body's dtype), on the CPU."""
    _, seed, shape, dtype, _ = BODIES[name]
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _chunk_products(a, axis):
    """Per chunk (c . c^T) . c of a (H, W, D) head slice, float32, in place
    of the chunk: the JAX references' loops."""
    parts = []
    for ci in range(a.shape[axis] // CHUNK):
        c = a.narrow(axis, ci * CHUNK, CHUNK)
        c2 = c.reshape(-1, D)
        parts.append(((c2 @ c2.t()) @ c2).reshape(c.shape))
    return torch.cat(parts, dim=axis)


def reference(name: str, x: torch.Tensor):
    """The JAX probe's reference for a body (float32 on the CPU, as its
    ``jnp`` reference runs there) and its bound: (ref, bound, relative).
    The two per-head dot references keep the kernels' (1, H, W, heads, D)
    layout: the JAX ones transpose it away (``probe_mosaic.py:254``,
    ``:304``)."""
    x = x.cpu()
    xf = x.float()
    if name in ("reshape_col", "reshape_row", "sliced_block_dot"):
        a = xf.reshape(-1, D)
        return a @ a.t(), 1e-3, False
    if name == "bf16_dot":
        return xf @ xf.t(), 1e-1, False
    if name in ("transpose", "transpose_full"):
        return xf.permute(1, 0, 2), 1e-3 if name == "transpose" else 1e-6, False
    if name == "split_reshape":
        return xf.reshape(4, 32, 64) * 2.0, 1e-6, False
    if name == "merge_full":
        return xf.reshape(1024, 64) * 2.0, 1e-6, False
    if name == "concat0":
        return torch.cat([xf, xf * 2.0], 0), 1e-6, False
    if name == "concat1":
        return torch.cat([xf, xf * 2.0, xf * 3.0, xf * 4.0], 1), 1e-6, False
    if name == "write_strided_slice":
        return torch.cat([xf * 2.0, xf * 2.0, xf * 3.0, xf * 4.0], 1), 1e-6, False
    scale = torch.arange(1, HEADS + 1, dtype=torch.float32)[None, None, None, :, None]
    if name == "head_slice_bf16":
        return (xf * scale).to(torch.bfloat16).float(), 1e-2, False
    heads = [xf[0, :, :, hd, :] for hd in range(HEADS)]
    if name == "head_slice_dot_bf16":
        outs = [_chunk_products(a, 0) for a in heads]
        return torch.stack(outs, dim=2)[None].to(torch.bfloat16).float(), 2e-2, True
    assert name == "chunked_ref_reads_bf16", name
    outs = [_chunk_products(a, 0).to(torch.bfloat16).float() + _chunk_products(a, 1)
            for a in heads]
    return torch.stack(outs, dim=2)[None].to(torch.bfloat16).float(), 5e-2, True


def check(name: str, device) -> tuple:
    """Run a body on ``device`` and hold it to its reference: (ok, detail),
    as the JAX probe words it."""
    x = body_input(name)
    out = run_body(name, x.to(device))
    ref, bound, relative = reference(name, x)
    err = (out.float().cpu() - ref).abs().max().item()
    if relative:
        rel = err / (ref.abs().max().item() + 1e-9)
        return rel < bound, f"rel={rel:.2e}"
    return err < bound, f"max_err={err:.2e}"


def _probe(name: str):
    def run(device="cuda") -> tuple:
        return check(name, device)

    run.__name__ = run.__qualname__ = f"probe_{name}"
    run.__doc__ = f"``probe_mosaic.probe_{name}`` on ``device``: (ok, detail)."
    return run


probe_reshape_col = _probe("reshape_col")
probe_reshape_row = _probe("reshape_row")
probe_transpose = _probe("transpose")
probe_sliced_block_dot = _probe("sliced_block_dot")
probe_bf16_dot = _probe("bf16_dot")
probe_split_reshape = _probe("split_reshape")
probe_concat0 = _probe("concat0")
probe_concat1 = _probe("concat1")
probe_write_strided_slice = _probe("write_strided_slice")
probe_transpose_full = _probe("transpose_full")
probe_merge_full = _probe("merge_full")
probe_head_slice_bf16 = _probe("head_slice_bf16")
probe_head_slice_dot_bf16 = _probe("head_slice_dot_bf16")
probe_chunked_ref_reads_bf16 = _probe("chunked_ref_reads_bf16")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="P4, the layout probes")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    return ap


def main(argv=None) -> dict:
    """Every body, in the JAX probe's order, one line each as it prints
    them.  Returns {name: (ok, detail)}."""
    from bubbleformer_tpu_torch.training.module import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    announce(dev)
    build_seconds(dev)
    results = {}
    for name, (label, *_) in BODIES.items():
        ok, detail = check(name, dev)
        print(f"{label}: {'OK' if ok else 'MISMATCH'} {detail}", flush=True)
        results[name] = (ok, detail)
    return results
