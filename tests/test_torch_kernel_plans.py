"""The launch plans of the port's B4 and B5 kernels: pure Python, so they
are held here on the CPU at every shape of the opt-in serving path (the
kernels themselves are tested on the card in test_torch_cuda_kernels.py).
"""

import pytest

from chip_smoke import CONV_SHAPES, W8_SHAPES
from genima_torch.kernels import fused_conv as fc
from genima_torch.kernels import w8_matmul as w8

# what the H100 gives one block: 227 KB of shared memory
SMEM_LIMIT = 232448

# shapes the card tests add to the path's: one token, K that is not a
# multiple of the 128-wide K tile, N of one 8-column group
W8_EXTRA = [(1, 1024, 8), (77, 1040, 320), (256, 1040, 1280), (5, 48, 24)]


@pytest.mark.parametrize("m,k,n", W8_SHAPES + W8_EXTRA)
def test_w8_plan_fills_the_card_or_says_why(m, k, n):
    p = w8.plan(m, k, n)
    assert p.blocks == p.grid[0] * p.grid[1] * p.grid[2]
    if p.blocks < w8.SMS:
        # under a wave only when a split already reaches half a wave, or
        # cannot split further
        assert p.why_short
        assert (p.blocks >= -(-w8.SMS // 2) or p.split == min(p.k_tiles, w8.MAX_SPLIT))
    else:
        assert not p.why_short


@pytest.mark.parametrize("m,k,n", W8_SHAPES + W8_EXTRA)
def test_w8_plan_covers_k_exactly_and_fits(m, k, n):
    p = w8.plan(m, k, n)
    assert p.k_tiles * w8.BK >= k > (p.k_tiles - 1) * w8.BK
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == p.k_tiles
    assert all(a < b for a, b in ranges)  # no split is empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert p.grid[0] * w8.BN >= n and p.grid[1] * p.bt >= m
    assert p.smem_bytes == w8.smem_bytes(p.bt, p.stages) <= SMEM_LIMIT
    longest = max(b - a for a, b in ranges)
    assert 1 <= p.stages <= max(longest, 2)
    if longest > 1:
        assert p.stages >= 2  # a stage is handed back one group late
    if p.split > 1:
        assert p.workspace_floats == p.split * p.tiles * w8.BN * p.bt
        assert p.tickets == p.tiles
    else:
        assert p.workspace_floats == p.tickets == 0


def test_w8_plans_past_a_wave_fit_two_blocks_on_an_sm():
    """Past one wave, a plan sizes its ring so that two blocks share an
    SM's shared memory."""
    for m, k, n in W8_SHAPES:
        p = w8.plan(m, k, n)
        if p.blocks > w8.SMS:
            assert 2 * (p.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("m,k,n", [(4, 40, 8), (4, 48, 20), (0, 48, 8), (4, 0, 8)])
def test_w8_plan_rejects_unsupported_shapes(m, k, n):
    with pytest.raises(ValueError):
        w8.plan(m, k, n)


def test_w8_make_plan_rejects_impossible_launches():
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=64, split=9)  # 8 K tiles
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=96)
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=64, split=1, stages=1)


@pytest.mark.parametrize("shape", CONV_SHAPES + [(2, 33, 66, 136, 256), (2, 33, 130, 136, 3)])
def test_conv_plan_fills_the_card_or_says_why(shape):
    b, h, w, c, o = shape
    p = fc.plan(*shape)
    assert p.tiles[0] * p.rows * fc.TILE_W >= h * w
    assert p.tiles[1] * p.bn >= o and p.tiles[2] == b
    assert p.blocks == min(p.n_tiles, fc.SMS)
    if p.n_tiles < fc.SMS:
        assert p.why_short
    else:
        assert not p.why_short
    assert p.chunks * fc.CHUNK >= c > (p.chunks - 1) * fc.CHUNK
    assert p.smem_bytes == fc.smem_bytes(p.bn, p.rows) <= SMEM_LIMIT


def test_conv_plan_tiles():
    """conv_out's 3 channels take the 16-channel, four-row tile; the rest
    128 channels over two rows."""
    for shape in CONV_SHAPES:
        p = fc.plan(*shape)
        assert (p.bn, p.rows) == ((16, 4) if shape[-1] <= 16 else (128, 2))
    assert fc.plan(1, 64, 64, 512, 512).blocks == 128  # 32 pixel tiles x 4


@pytest.mark.parametrize("bn,rows", fc.TILES)
def test_every_conv_tile_fits(bn, rows):
    assert fc.make_plan(1, 64, 64, 512, 512, bn, rows).smem_bytes <= SMEM_LIMIT


def test_conv_make_plan_rejects_a_tile_with_no_kernel():
    with pytest.raises(ValueError):
        fc.make_plan(1, 64, 64, 512, 512, 64, 2)


@pytest.mark.parametrize("shape", [(1, 4, 4, 12, 8), (1, 0, 4, 8, 8), (1, 4, 4, 8, 0)])
def test_conv_plan_rejects_unsupported_shapes(shape):
    with pytest.raises(ValueError):
        fc.plan(*shape)
