"""The host plans of the attention kernels' parameter-gradient sums, on the
CPU: pure functions of the shapes and of the blocks a card keeps resident.

The line kernels' backward (``ops/axial_lane.py:line_bwd_plan``) gives a
block a line (a run of lines, a line a launch, where the partials would
pass their cap) and writes one partial of the table, scale and qk-LN
gradients a line and tile; the bf16 Hopper kernels of K4
(``lane_bwd_layout``) and K8 (``ops/axial_pallas.py:flash_bwd_plan``) give
a block a run of lines (K8: of segments of packed lines), sum the gradients
over them inside the launch and write one partial a block.  Held here: the
line kernels' partials take 79 MB at FiLMAViT-small's training shape, K4's,
K6's, K7's and K8's bf16 paths write at least 4x fewer bytes than the line
kernels wrote for them, every line lies in exactly one block, K8's packing
places every token of the M lines in exactly one staged row, and K7's rows
and columns place every token of a ``(BT, H, W)`` grid in exactly one
staged row a direction.

The residents are an H100's: 132 multiprocessors, ``LINE_BLOCKS_PER_SM``
blocks each for the line kernels (``line_bwd_resident``), 2 for the Hopper
backward kernels at head dim 64.
"""
import pytest
import torch

from bubbleformer_tpu_torch.ops.axial_fused import (
    fused_bwd_layout,
    fused_hopper_bwd,
    fused_hopper_fwd,
    fused_kernels,
    fused_line_bwd,
    fused_line_fwd,
    fused_rows,
)
from bubbleformer_tpu_torch.ops.axial_fused_block import (
    fused_block_hopper_bwd,
    fused_block_hopper_fwd,
    fused_block_kernels,
    fused_block_line_bwd,
    fused_block_line_fwd,
)
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    fused_packed_hopper_bwd,
    fused_packed_hopper_fwd,
    fused_packed_kernels,
    fused_packed_line_bwd,
    fused_packed_line_fwd,
)
from bubbleformer_tpu_torch.ops.axial_lane import (
    LINE_BLOCKS_PER_SM,
    LINE_PARTIAL_FLOATS,
    lane_bwd_layout,
    line_bwd_plan,
)
from bubbleformer_tpu_torch.ops.axial_pallas import (
    flash_bwd_plan,
    flash_geometry,
    flash_hopper_bwd,
    flash_hopper_bwd_fits,
    flash_hopper_fwd,
    flash_kernels,
    flash_line_bwd,
    flash_line_fwd,
    flash_rows,
)

SMS = 132
LINE_RESIDENT = LINE_BLOCKS_PER_SM * SMS  # line_bwd_resident on an H100
HOPPER_RESIDENT = 2 * SMS


def _per_line(*args, **kw):
    """The line kernels' plan on an H100: a block, and a partial, a line at
    the training shapes."""
    return line_bwd_plan(*args[:5], LINE_RESIDENT, **kw)


# (bt, h, w, heads, d, ln): FiLMAViT-small's training grid with the qk-LN
# (K2 float32, K4 float32) and without (K6, K7), AViT-big's 12 heads, the
# flow-boiling grid at batch 4 (rows of 128: two tiles, two kernels).
LINE_CASES = [(40, 32, 32, 6, 64, True), (40, 32, 32, 6, 64, False), (40, 32, 32, 12, 64, True),
              (20, 32, 128, 6, 64, True)]


@pytest.mark.parametrize("bt,h,w,heads,d,ln", LINE_CASES,
                         ids=["training", "training_no_ln", "avit_big", "flow"])
def test_line_kernel_partials_are_a_line_each(bt, h, w, heads, d, ln):
    """A partial a line and tile where the cap allows (79 MB at
    FiLMAViT-small's training shape, both directions), and never more than
    the cap of table partials a pass."""
    size, plan = line_bwd_plan(bt, h, w, heads, d, LINE_RESIDENT, ln=ln)
    for (groups, per), length in zip((plan[:2], plan[2:]), (w, h)):
        assert groups * heads * length * length <= LINE_PARTIAL_FLOATS
        assert per == 1 or groups * heads * length * length * 2 > LINE_PARTIAL_FLOATS
    if (bt, h, w, heads, d, ln) == LINE_CASES[0]:
        assert plan == [1280, 1, 1280, 1]  # a block a line
        assert 4 * size == pytest.approx(79e6, rel=0.01)  # bytes


@pytest.mark.parametrize("bt,h,w,heads,d,ln", LINE_CASES + [(5, 32, 128, 6, 64, True),
                                                            (1, 16, 512, 6, 64, True),
                                                            (2, 100, 72, 2, 64, True)],
                         ids=["training", "training_no_ln", "avit_big", "flow", "flow_rollout",
                              "rows_512", "ragged"])
def test_line_kernel_runs_hold_every_line_once(bt, h, w, heads, d, ln):
    """Block grp of a head and tile takes the lines grp * per to (grp + 1)
    * per of its pass: every line in exactly one block, none without a line,
    and at most the resident blocks (at least one a head and tile)."""
    _, plan = line_bwd_plan(bt, h, w, heads, d, LINE_RESIDENT, ln=ln)
    for (groups, per), (length, lines) in zip((plan[:2], plan[2:]), ((w, bt * h), (h, bt * w))):
        owned = [li for g in range(groups) for li in range(g * per, min((g + 1) * per, lines))]
        assert owned == list(range(lines))
        assert (groups - 1) * per < lines
        tiles = -(-length // 64)
        assert groups * heads * tiles <= max(LINE_RESIDENT, heads * tiles)


# K8 at path F's training shapes (the axial rows and columns, the temporal
# lines) and at AViT-tiny's head dim 16 (lines of 64 at 512^2).
FLASH_CASES = [(6, 1280, 32, 64), (6, 8192, 5, 64), (6, 2560, 64, 16)]


@pytest.mark.parametrize("heads,m,n,d", FLASH_CASES, ids=["axial", "temporal", "d16"])
def test_flash_partials_fall_fourfold(heads, m, n, d):
    """K8's bf16 backward writes one partial a block of a wave: at least 4x
    fewer bytes than its line kernels wrote, one partial a line."""
    size, groups, per = flash_bwd_plan(m, n, heads, HOPPER_RESIDENT)
    before, _ = _per_line(1, m, n, heads, d, ln=False, passes=1)
    assert 4 * size <= before, (size, before)
    assert size == groups * heads * (n * n + 1)


def test_fused_block_partials_fall_fourfold():
    """K4's bf16 backward (K2's Hopper kernels in K4's rounding) at its
    training shape: one partial a block of a wave, at least 4x fewer bytes
    than its line kernels wrote."""
    size, _ = lane_bwd_layout(40, 32, 32, 6, 64, (HOPPER_RESIDENT, HOPPER_RESIDENT))
    before, _ = _per_line(40, 32, 32, 6, 64)
    assert 4 * size <= before, (size, before)


# (M, n): the temporal lines at path F's rollout and training batch plus a
# ragged M, the make-demo grid's lines of 8, lines of 13 (one a tile), of 20
# and 32 (one a unit of 32), of 40 and 64 (two units a block), of 77 and 100
# (a unit of 96 and 128), of 200 and 512 (a block a line).
ROW_CASES = [(1024, 5), (8192, 5), (1027, 5), (37, 8), (10, 13), (9, 20), (7, 32), (5, 40),
             (3, 64), (7, 77), (3, 100), (2, 200), (2, 512)]


@pytest.mark.parametrize("m,n", ROW_CASES, ids=[f"{m}x{n}" for m, n in ROW_CASES])
def test_flash_packing_covers_every_line_once(m, n):
    """The segments' staged rows hold every (line, position) of the M lines
    exactly once; a line of at most 16 tokens lies in one 16-row tile, a
    longer one in consecutive rows of one unit."""
    g = flash_geometry(n)
    segments = -(-m // g["lps"])
    seen = []
    for seg in range(segments):
        rows = flash_rows(m, n, seg)
        assert len(rows) == g["rows"]
        where = {}
        for r, cell in enumerate(rows):
            if cell is None:
                continue
            seen.append(cell)
            where.setdefault(cell[0], []).append(r)
        for line, rs in where.items():
            assert rs == list(range(rs[0], rs[0] + n)), line  # consecutive, in order
            span = 16 if n <= 16 else g["ru"]
            assert rs[0] // span == rs[-1] // span, line
    assert sorted(seen) == [(li, p) for li in range(m) for p in range(n)]


@pytest.mark.parametrize("heads,m,n,d", FLASH_CASES + [(3, 7, 77, 16), (2, 1027, 5, 64)],
                         ids=["axial", "temporal", "d16", "ragged", "ragged_t"])
def test_flash_backward_plan_gives_every_segment_to_one_block(heads, m, n, d):
    """Block g of a head owns segments g * per .. (g + 1) * per: each one
    once, no block without one, at most one wave of the resident blocks."""
    _, groups, per = flash_bwd_plan(m, n, heads, HOPPER_RESIDENT)
    segments = -(-m // flash_geometry(n)["lps"])
    owned = [s for g in range(groups) for s in range(g * per, min((g + 1) * per, segments))]
    assert owned == list(range(segments))
    assert (groups - 1) * per < segments
    assert groups * heads <= max(HOPPER_RESIDENT, heads)


def test_flash_kernels_are_chosen_by_dtype_and_line():
    """bfloat16 takes the Hopper kernels (the backward while its four staged
    tiles fit: every line at head dim 16, up to 256 tokens at 64), float32
    the line kernels; any other dtype has no kernel."""
    assert flash_kernels(torch.bfloat16, 32, 64) == (flash_hopper_fwd, flash_hopper_bwd)
    assert flash_kernels(torch.bfloat16, 256, 64) == (flash_hopper_fwd, flash_hopper_bwd)
    assert flash_kernels(torch.bfloat16, 257, 64) == (flash_hopper_fwd, flash_line_bwd)
    assert flash_kernels(torch.bfloat16, 512, 16) == (flash_hopper_fwd, flash_hopper_bwd)
    assert flash_kernels(torch.float32, 5, 64) == (flash_line_fwd, flash_line_bwd)
    assert [flash_hopper_bwd_fits(n, 64) for n in (1, 5, 224, 256, 257, 512)] == [
        True, True, True, True, False, False]
    with pytest.raises(TypeError, match="float16"):
        flash_kernels(torch.float16)


def test_fused_block_kernels_are_chosen_by_dtype():
    """bfloat16 K4 takes the Hopper kernels, float32 the line kernels."""
    assert fused_block_kernels(torch.bfloat16) == (fused_block_hopper_fwd,
                                                   fused_block_hopper_bwd)
    assert fused_block_kernels(torch.float32) == (fused_block_line_fwd, fused_block_line_bwd)
    with pytest.raises(TypeError, match="float16"):
        fused_block_kernels(torch.float16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_fused_block_line_kernels_take_float32_alone(kernel):
    """The line kernels' fused_block flavour is built in float32 alone: a
    bfloat16 call raises before it reaches a card, naming the Hopper
    kernels."""
    qkv = torch.zeros(1, 4, 4, 96, dtype=torch.bfloat16)
    params = (torch.ones(16), torch.zeros(16), torch.ones(16), torch.zeros(16), None, None, None,
              None)
    with pytest.raises(TypeError, match="fused_block_hopper"):
        if kernel == "fwd":
            fused_block_line_fwd(qkv, *params, heads=2)
        else:
            fused_block_line_bwd(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16), qkv, *params,
                                 heads=2)


def test_fused_packed_partials_fall_fourfold():
    """K6's bf16 backward (K4's Hopper kernels without the qk-LN, so no LN
    partials) at its training shape: one partial a block of a wave, at least
    4x fewer bytes than its line kernels wrote."""
    size, plan = lane_bwd_layout(40, 32, 32, 6, 64, (HOPPER_RESIDENT, HOPPER_RESIDENT), ln=False)
    before, _ = _per_line(40, 32, 32, 6, 64, ln=False)
    assert 4 * size <= before, (size, before)
    assert size == sum(g * 6 * (32 * 32 + 1) for g in plan[::2])


def test_fused_partials_fall_fourfold():
    """K7's bf16 backward (K8's kernels over the rows and the columns) at its
    training shape: one partial a block of a wave a direction, at least 4x
    fewer bytes than its line kernels wrote."""
    size, plan = fused_bwd_layout(40, 32, 32, 6, (HOPPER_RESIDENT, HOPPER_RESIDENT))
    before, _ = _per_line(40, 32, 32, 6, 64, ln=False)
    assert 4 * size <= before, (size, before)
    assert plan[::2] == [flash_bwd_plan(1280, 32, 6, HOPPER_RESIDENT)[1]] * 2


# K7's grids: path D's training grid, AViT-tiny's 64x64 (head dim 16), the
# 32x128 flow-boiling grid, rows of 512, a ragged grid and the make-demo
# grid (lines of 8, packed two to a tile).
PLANE_CASES = [(40, 32, 32), (40, 64, 64), (20, 32, 128), (2, 8, 512), (2, 100, 72), (5, 8, 8)]


@pytest.mark.parametrize("direction", [0, 1], ids=["rows", "columns"])
@pytest.mark.parametrize("bt,h,w", PLANE_CASES, ids=["training", "d16", "flow", "rows_512",
                                                     "ragged", "demo"])
def test_fused_plane_covers_every_token_once(bt, h, w, direction):
    """Over its segments, each direction of K7 stages every token of the
    (BT, H, W) grid exactly once, each where K8's packing puts its (line,
    position): a row's tokens are a row of one frame, a column's a column."""
    m, n = (bt * h, w) if direction == 0 else (bt * w, h)
    seen = []
    for seg in range(-(-m // flash_geometry(n)["lps"])):
        for tok, cell in zip(fused_rows(bt, h, w, direction, seg), flash_rows(m, n, seg)):
            assert (tok is None) == (cell is None)
            if tok is None:
                continue
            frame, y, x = tok // (h * w), tok // w % h, tok % w
            line, pos = cell
            assert (frame * h + y, x) == (line, pos) if direction == 0 else (
                (frame * w + x, y) == (line, pos))
            seen.append(tok)
    assert sorted(seen) == list(range(bt * h * w))


def test_fused_packed_kernels_are_chosen_by_dtype():
    """bfloat16 K6 takes the Hopper kernels, float32 the line kernels; any
    other dtype has no kernel."""
    assert fused_packed_kernels(torch.bfloat16) == (fused_packed_hopper_fwd,
                                                    fused_packed_hopper_bwd)
    assert fused_packed_kernels(torch.float32) == (fused_packed_line_fwd, fused_packed_line_bwd)
    with pytest.raises(TypeError, match="float16"):
        fused_packed_kernels(torch.float16)


def test_fused_kernels_are_chosen_by_dtype_and_line():
    """bfloat16 K7 takes the Hopper kernels, its backward while K8's Hopper
    backward stages the longer direction's lines (every line at head dim 16,
    up to 256 tokens at 64; longer ones the line kernels' kFused flavour),
    float32 the line kernels; any other dtype has no kernel."""
    assert fused_kernels(torch.bfloat16, 32, 64) == (fused_hopper_fwd, fused_hopper_bwd)
    assert fused_kernels(torch.bfloat16, 256, 64) == (fused_hopper_fwd, fused_hopper_bwd)
    assert fused_kernels(torch.bfloat16, 512, 64) == (fused_hopper_fwd, fused_line_bwd)
    assert fused_kernels(torch.bfloat16, 512, 16) == (fused_hopper_fwd, fused_hopper_bwd)
    assert fused_kernels(torch.float32, 32, 64) == (fused_line_fwd, fused_line_bwd)
    with pytest.raises(TypeError, match="float16"):
        fused_kernels(torch.float16)
