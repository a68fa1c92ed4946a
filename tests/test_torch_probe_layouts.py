"""The host side of the two redesigned probe kernels, on the CPU.

P4's ``view_copy`` folds its two views before the launch
(``probes/mosaic.py:fold_views``) and picks 16-byte vectors where both
folded views allow them (``copy_vector``); the kernel is told both in one
packed descriptor (``copy_descriptor``).  Each folded view must address the
same elements in the same order as the view it came from: held here with
``torch.as_strided`` over an ``arange`` storage (an element's value is its
address) for the views of each of the eight copy bodies, as the bodies
hand them to the wrapper, and for the ragged strided views of the card
test.  P2b's ``perm_product`` runs on the Hopper GEMM, whose TMA loads need
16-byte aligned operands with rows a multiple of 16 bytes:
``chunk_axial.perm_operands`` raises for an operand that fails, naming it,
and ``table_operands`` for a bias or Mblk table the chunk kernel cannot
read 16 bytes at a time.
P3's ``stage`` reads its tiles as TMA boxes of bx pixels of a row by by rows
(``probes/pyramid.py:stage_tiles``): the tiles must cover every output
pixel once, and ``stage_operands`` raises, naming the tensor, where TMA
cannot read y0 or k.
P4's ``gram`` folds its view's rows before the launch
(``mosaic.gram_operands``): every Gram body reaches the kernel as a (256,
64) view of row stride 64 staged by 16-byte copies; other views take one
element a thread, of a 2-D view or of the view's own shape and strides.
P1a's ``within_roll`` stages each row of x once by 16-byte copies where its
rows are a multiple of 16 bytes (``lane_axial.within_roll_operands``), for
any block size, else takes one element a thread.
"""
import struct
from types import SimpleNamespace

import pytest
import torch

from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid

COPY_BODIES = [name for name, kernel in mosaic.BODY_KERNEL.items() if kernel == "view_copy"]
GRAM_BODIES = [name for name, kernel in mosaic.BODY_KERNEL.items() if kernel == "gram"]


def _addresses(shape, stride, offset, size):
    """The storage index of each element of a view, in row-major order."""
    return torch.arange(size).as_strided(tuple(shape), tuple(stride), offset).reshape(-1)


def _copy_calls(name):
    """The (src, dst, scale, accumulate) of every ``view_copy`` call of a
    body, recorded while the body runs on its plain versions."""
    calls = []

    def record(src, dst, scale=1.0, accumulate=False):
        calls.append((src, dst, scale, accumulate))
        return mosaic.view_copy_plain(src, dst, scale, accumulate)

    ops = SimpleNamespace(gram=mosaic.gram_plain, view_copy=record,
                          chunk_gram_apply=mosaic.chunk_gram_apply_plain)
    mosaic.run_body(name, mosaic.body_input(name), ops)
    return calls


def _ragged_views():
    """The card test's accumulating copy: a permuted ``src`` (innermost
    stride 5) into every other row of ``dst``."""
    src = torch.randn(6, 7, 5).permute(2, 0, 1)
    dst = torch.randn(5, 12, 7)[:, ::2]
    return src, dst


def _assert_fold_keeps_order(src, dst):
    shape, fs, fd = mosaic.fold_views(src.shape, src.stride(), dst.stride())
    assert 1 not in shape or shape == (1,)
    assert len(shape) <= src.dim() and len(fs) == len(fd) == len(shape)
    for view, folded in ((src, fs), (dst, fd)):
        size = view.untyped_storage().nbytes() // view.element_size()
        assert torch.equal(_addresses(shape, folded, view.storage_offset(), size),
                           _addresses(view.shape, view.stride(), view.storage_offset(), size))
    return shape, fs, fd


@pytest.mark.parametrize("name", COPY_BODIES)
def test_fold_views_addresses_the_same_elements_in_order(name):
    calls = _copy_calls(name)
    assert calls
    for src, dst, _, _ in calls:
        shape, _, _ = _assert_fold_keeps_order(src, dst)
        # Every copy body keeps a contiguous run of 64 values innermost.
        assert shape[-1] % 64 == 0


def test_fold_views_of_the_ragged_strided_copy():
    src, dst = _ragged_views()
    assert _assert_fold_keeps_order(src, dst) == ((5, 6, 7), (1, 35, 5), (84, 14, 1))


@pytest.mark.parametrize("shape, src, dst, want", [
    ((32, 32, 64), (64, 2048, 1), (2048, 64, 1), ((32, 32, 64), (64, 2048, 1), (2048, 64, 1))),
    ((32, 32, 64), (2048, 64, 1), (2048, 64, 1), ((65536,), (1,), (1,))),
    ((1, 32, 1, 64), (9, 64, 5, 1), (7, 64, 3, 1), ((2048,), (1,), (1,))),
    ((1, 32, 1, 64), (9, 384, 5, 1), (7, 64, 3, 1), ((32, 64), (384, 1), (64, 1))),
    ((4, 1, 1), (3, 2, 1), (1, 7, 7), ((4,), (3,), (1,))),
    ((1, 1), (4, 1), (1, 1), ((1,), (1,), (1,))),
], ids=["transpose", "contiguous", "unit_dims", "unit_dims_strided", "one_dim",
        "one_element"])
def test_fold_views_merges_exactly_what_both_views_allow(shape, src, dst, want):
    assert mosaic.fold_views(shape, src, dst) == want


@pytest.mark.parametrize("name", COPY_BODIES)
def test_every_copy_body_takes_16_byte_vectors(name):
    for src, dst, _, _ in _copy_calls(name):
        shape, fs, fd = mosaic.fold_views(src.shape, src.stride(), dst.stride())
        vec = mosaic.copy_vector(shape, fs, fd, src.element_size(), dst.element_size())
        assert vec * src.element_size() == mosaic.VECTOR_BYTES


@pytest.mark.parametrize("case, args, want", [
    ("f32", ((8, 64), (64, 1), (64, 1), 4, 4), 4),
    ("bf16", ((8, 64), (64, 1), (64, 1), 2, 2), 8),
    ("f32_to_bf16", ((8, 64), (64, 1), (64, 1), 4, 2), 4),
    ("bf16_to_f32", ((8, 64), (64, 1), (64, 1), 2, 4), 4),
    ("src_strided_inner", ((5, 6, 7), (1, 35, 5), (84, 14, 1), 4, 4), 1),
    ("dst_strided_inner", ((8, 64), (64, 1), (128, 2), 4, 4), 1),
    ("inner_not_a_vector", ((8, 66), (66, 1), (66, 1), 4, 4), 1),
    ("outer_stride_not_a_vector", ((8, 64), (65, 1), (64, 1), 4, 4), 1),
    ("src_offset_one_element", ((8, 64), (64, 1), (64, 1), 4, 4, 4, 0), 1),
    ("dst_offset_one_element", ((8, 64), (64, 1), (64, 1), 2, 2, 0, 2), 1),
    ("offset_8_bytes_bf16", ((8, 64), (64, 1), (64, 1), 2, 2, 8, 0), 1),
    ("offset_16_bytes", ((8, 64), (64, 1), (64, 1), 4, 4, 16, 16), 4),
])
def test_copy_vector_is_16_bytes_exactly_where_both_views_allow(case, args, want):
    assert mosaic.copy_vector(*args) == want


def test_copy_descriptor_packs_the_folded_views():
    x = torch.zeros(32, 32, 64)
    v = x.permute(1, 0, 2)
    desc = mosaic.copy_descriptor(v.shape, v.stride(), (2048, 64, 1), torch.float32,
                                  torch.bfloat16, 0, 4, 2.5, True)
    fields = struct.unpack("<5if15i", desc)
    assert fields[:6] == (3, 1, 0, 1, 1, 2.5)  # ndim, vec (dst off by 4 bytes), dtypes, add
    assert fields[6:] == (32, 32, 64, 0, 0, 64, 2048, 1, 0, 0, 2048, 64, 1, 0, 0)
    desc = mosaic.copy_descriptor(v.shape, v.stride(), (2048, 64, 1), torch.bfloat16,
                                  torch.bfloat16, 0, 0, 1.0, False)
    assert struct.unpack("<5if15i", desc)[:2] == (3, 8)


def test_copy_descriptor_raises_outside_the_kernels_envelope():
    with pytest.raises(ValueError, match="2\\^31"):
        mosaic.copy_descriptor((2**16, 2**15 + 1), (2**15 + 1, 1), (2**15 + 1, 1),
                               torch.float32, torch.float32, 0, 0, 1.0, False)
    with pytest.raises(ValueError, match="2\\^31"):
        mosaic.copy_descriptor((2, 4), (2**31, 1), (4, 1), torch.float32, torch.float32, 0, 0,
                               1.0, False)
    with pytest.raises(ValueError, match="1 to 5 dimensions"):
        mosaic.copy_descriptor((1,) * 6, (1,) * 6, (1,) * 6, torch.float32, torch.float32, 0, 0,
                               1.0, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mosaic.copy_descriptor((4,), (1,), (1,), torch.float16, torch.float32, 0, 0, 1.0, False)


@pytest.mark.parametrize("n", [1024, 200, 64], ids=["probe", "ragged", "p2c_small"])
def test_perm_operands_pass_the_probes_shapes(n):
    x = torch.zeros(3, 5, n, dtype=torch.bfloat16)
    p = torch.zeros(n, n, dtype=torch.bfloat16)
    x2 = chunk_axial.perm_operands("perm_product", x, p)
    assert x2.shape == (15, n) and x2.data_ptr() == x.data_ptr()


def test_perm_operands_name_the_tensor_tma_cannot_read():
    n = 64
    p = torch.zeros(n, n, dtype=torch.bfloat16)
    flat = torch.zeros(4 * n + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="perm_product: x starts at .* not 16-byte aligned"):
        chunk_axial.perm_operands("perm_product", flat[1:1 + 4 * n].view(4, n), p)
    with pytest.raises(ValueError, match="perm_product: p starts at .* not 16-byte aligned"):
        chunk_axial.perm_operands("perm_product", flat[:4 * n].view(4, n),
                                  torch.zeros(n * n + 1, dtype=torch.bfloat16)[1:].view(n, n))
    with pytest.raises(ValueError, match="perm_product: p of shape .* is not contiguous"):
        chunk_axial.perm_operands("perm_product", flat[:4 * n].view(4, n), p.t())
    with pytest.raises(ValueError, match="perm_product: x of shape .* is not contiguous"):
        chunk_axial.perm_operands("perm_product",
                                  torch.zeros(4, 2 * n, dtype=torch.bfloat16)[:, :n], p)
    with pytest.raises(ValueError, match="perm_product: x has rows of 24 bytes"):
        chunk_axial.perm_operands("perm_product", torch.zeros(4, 12, dtype=torch.bfloat16),
                                  torch.zeros(12, 12, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="perm_product: p has shape"):
        chunk_axial.perm_operands("perm_product", flat[:4 * n].view(4, n), p[:8, :8])
    with pytest.raises(TypeError, match="bfloat16"):
        chunk_axial.perm_operands("perm_product", torch.zeros(4, n), p)



CHUNK_TABLES = ["br", "bc", "mrs", "mcs"]


def chunk_tables(ch=32, heads=2):
    """Contiguous float32 bias and Mblk tables as ``chunk_core`` passes them."""
    return dict(br=torch.zeros(heads * ch, ch), bc=torch.zeros(heads * ch, ch),
                mrs=torch.zeros(ch, ch), mcs=torch.zeros(ch, ch))


def test_table_operands_pass_aligned_tables():
    chunk_axial.table_operands("chunk_core", **chunk_tables())


@pytest.mark.parametrize("name", CHUNK_TABLES)
def test_table_operands_name_a_misaligned_table(name):
    """The chunk kernel reads the bias and Mblk tables 16 bytes at a time: a
    contiguous table one float off a 16-byte boundary raises, naming it,
    where the kernel would fault."""
    tables = chunk_tables()
    t = tables[name]
    flat = torch.zeros(t.numel() + 4)
    assert flat.data_ptr() % 16 == 0
    tables[name] = flat[1:1 + t.numel()].view(t.shape)
    with pytest.raises(ValueError, match=f"chunk_core: {name} starts at .* not 16-byte aligned"):
        chunk_axial.table_operands("chunk_core", **tables)

# (h, w) of y0 -> (bx, by, tiles): the probe's stage, a row narrower than a
# tile (several rows a tile), the card test's ragged 10 x 14, rows of two
# tiles, one pixel, and a wide image of three output rows.
STAGE_TILES = [((256, 256), (128, 1, 128)), ((64, 64), (32, 4, 8)), ((10, 14), (7, 5, 1)),
               ((512, 512), (128, 1, 512)), ((2, 2), (1, 1, 1)), ((6, 300), (128, 1, 6)),
               ((14, 40), (20, 6, 2))]


@pytest.mark.parametrize("hw, want", STAGE_TILES,
                         ids=["probe", "rows", "ragged", "wide", "one", "short", "ragged_rows"])
def test_stage_tiles_cover_every_output_pixel_once(hw, want):
    """The tiles as the kernel walks them (tile t at ((t % tiles_x) bx, (t //
    tiles_x) by), pixel m of a tile at (m // bx, m % bx) from there, m < bx
    by, kept where it lies in the image): each of the (h/2)(w/2) pixels
    exactly once, in boxes TMA can take (at most 128 pixels, by > 1 only
    where a row is narrower than a tile)."""
    h, w = hw
    bx, by, tiles = pyramid.stage_tiles(h, w)
    assert (bx, by, tiles) == want
    ho, wo = h // 2, w // 2
    assert bx * by <= pyramid.TILE_PIXELS and bx <= wo and by <= ho
    assert by == 1 or wo < pyramid.TILE_PIXELS
    tiles_x = -(-wo // bx)
    seen = torch.zeros(ho, wo, dtype=torch.int64)
    for t in range(tiles):
        oy0, ox0 = (t // tiles_x) * by, (t % tiles_x) * bx
        for m in range(bx * by):
            oy, ox = oy0 + m // bx, ox0 + m % bx
            if oy < ho and ox < wo:
                seen[oy, ox] += 1
    assert torch.equal(seen, torch.ones(ho, wo, dtype=torch.int64))


@pytest.mark.parametrize("c, f", [(96, 96), (8, 24), (36, 192), (4, 8)],
                         ids=["probe", "ragged", "wide", "least"])
def test_stage_operands_pass_what_tma_reads(c, f):
    pyramid.stage_operands("stage", torch.zeros(2, 4, 6, c, dtype=torch.bfloat16),
                           torch.zeros(2, 2, c, f, dtype=torch.bfloat16))


def test_stage_operands_name_the_tensor_tma_cannot_read():
    y0 = torch.zeros(2, 4, 6, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 8, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stage: y0 has rows of 24 bytes"):
        pyramid.stage_operands("stage", torch.zeros(2, 4, 6, 6, dtype=torch.bfloat16),
                               torch.zeros(2, 2, 6, 24, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="stage: k has rows of 24 bytes"):
        pyramid.stage_operands("stage", y0, torch.zeros(2, 2, 8, 12, dtype=torch.bfloat16))
    flat = torch.zeros(y0.numel() + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stage: y0 starts at .* not 16-byte aligned"):
        pyramid.stage_operands("stage", flat[1:1 + y0.numel()].view(y0.shape), k)
    with pytest.raises(ValueError, match="stage: k of shape .* is not contiguous"):
        pyramid.stage_operands("stage", y0, torch.zeros(2, 2, 24, 8, dtype=torch.bfloat16)
                               .transpose(2, 3))


def _gram_view(name):
    """The view a Gram body hands to ``gram``."""
    views = []
    ops = SimpleNamespace(gram=lambda a: views.append(a) or mosaic.gram_plain(a))
    mosaic.run_body(name, mosaic.body_input(name), ops)
    (view,) = views
    return view


@pytest.mark.parametrize("name", GRAM_BODIES)
def test_every_gram_body_folds_to_one_16_byte_view(name):
    """(rows, cols, row stride, col stride, 16-byte copies) of each body's
    view, and the folded view addresses its elements in the same order."""
    a = _gram_view(name)
    assert mosaic.gram_operands(a) == (256, 64, 64, 1, True)
    size = a.untyped_storage().nbytes() // a.element_size()
    assert torch.equal(_addresses((256, 64), (64, 1), a.storage_offset(), size),
                       _addresses(a.shape, a.stride(), a.storage_offset(), size))


def test_gram_operands_take_other_views_one_element_a_thread():
    """The card test's ragged transposed slice (a 2-D view, contraction
    stride 90), a misaligned contiguous view, rows that do not fold to one
    stride, and one row."""
    big = torch.randn(50, 90)
    assert mosaic.gram_operands(big.t()[:70, 5:45]) == (70, 40, 1, 90, False)
    base = torch.zeros(256 * 64 + 4)
    assert mosaic.gram_operands(base[1:1 + 256 * 64].view(256, 64)) == (256, 64, 64, 1, False)
    assert mosaic.gram_operands(base[4:].view(256, 64)) == (256, 64, 64, 1, True)
    assert mosaic.gram_operands(torch.zeros(8, 12, 40)[:, :10]) == (80, 40, None, 1, False)
    assert mosaic.gram_operands(torch.zeros(8, 12, 40)[:, :, :36]) == (96, 36, 40, 1, True)
    assert mosaic.gram_operands(torch.zeros(12, 40, dtype=torch.bfloat16)[:, :36]) == (
        12, 36, 40, 1, False)  # 36 bf16 columns: not a multiple of 16 bytes
    assert mosaic.gram_operands(torch.zeros(1, 1, 64)) == (1, 64, 0, 1, True)


@pytest.mark.parametrize("a,error,match", [
    (torch.zeros(64), ValueError, "2 to 5 dimensions"),
    (torch.zeros((1,) * 6), ValueError, "2 to 5 dimensions"),
    (torch.zeros(4, 8, dtype=torch.float16), TypeError, "float32 or bfloat16"),
    (torch.zeros(0, 8), ValueError, "no elements"),
    (torch.zeros(4, 0), ValueError, "no elements"),
    (torch.empty(mosaic.MAX_GRAM_ROWS + 1, 1, device="meta"), ValueError, "rows"),
], ids=["1d", "6d", "float16", "no_rows", "no_cols", "too_many_rows"])
def test_gram_operands_raise_outside_the_kernels_envelope(a, error, match):
    with pytest.raises(error, match=match):
        mosaic.gram_operands(a)


@pytest.mark.parametrize("rows,total,dtype,rolls,offset,want", [
    (16, 512, torch.float32, (5, 32, 96, 256), 0, 4),
    (16, 512, torch.bfloat16, (5, 32, 96, 256), 0, 8),
    (7, 120, torch.float32, (7, 40, 0, 120), 0, 4),
    (7, 120, torch.bfloat16, (7, 40, 23, 24), 0, 8),
    (5, 36, torch.float32, (5, 12, 8, 9), 0, 4),
    (5, 36, torch.bfloat16, (5, 12, 8, 9), 0, 1),
    (5, 30, torch.float32, (4, 10, 14, 15), 0, 1),
    (16, 512, torch.float32, (5, 32, 96, 256), 1, 1),
    (2, 12800, torch.float32, (5, 32, 96, 256), 0, 1),
], ids=["probe_f32", "probe_bf16", "b40", "b24_bf16", "row36_f32", "row36_bf16", "row30",
        "misaligned", "past_smem"])
def test_within_roll_operands_pick_vectors_where_rows_allow(rows, total, dtype, rolls, offset,
                                                           want):
    """16 bytes a thread for any block size (40, 24, 12 and 9 are not
    powers of two) where a row is a multiple of 16 bytes of at most 48 KB
    and x is aligned; else one element a thread."""
    x = torch.zeros(rows * total + offset, dtype=dtype)[offset:].view(rows, total)
    assert lane_axial.within_roll_operands(x, *rolls) == want
    o1, o2 = lane_axial.within_roll(x.normal_(generator=torch.Generator().manual_seed(0)),
                                    *rolls)
    assert torch.equal(o1, lane_axial.within_roll_plain(x, *rolls[:2]))
    assert torch.equal(o2, lane_axial.within_roll_plain(x, *rolls[2:]))


@pytest.mark.parametrize("x,rolls,error,match", [
    (torch.zeros(2, 4, 8), (1, 8, 0, 8), ValueError, "x \\(rows, total\\)"),
    (torch.zeros(2, 8, dtype=torch.float16), (1, 8, 0, 8), TypeError, "float32 or bfloat16"),
    (torch.zeros(8, 2).t(), (1, 8, 0, 8), ValueError, "not contiguous"),
    (torch.zeros(2, 8), (8, 8, 0, 8), ValueError, "roll 8 in blocks of 8"),
    (torch.zeros(2, 8), (1, 8, 0, 3), ValueError, "roll 0 in blocks of 3"),
], ids=["3d", "float16", "strided", "r_past_block", "block_not_dividing"])
def test_within_roll_operands_name_what_the_kernels_do_not_take(x, rolls, error, match):
    with pytest.raises(error, match=match):
        lane_axial.within_roll_operands(x, *rolls)
