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
``chunk_axial.perm_operands`` raises for an operand that fails, naming it.
"""
import struct
from types import SimpleNamespace

import pytest
import torch

from bubbleformer_tpu_torch.probes import chunk_axial, mosaic

COPY_BODIES = [name for name, kernel in mosaic.BODY_KERNEL.items() if kernel == "view_copy"]


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
