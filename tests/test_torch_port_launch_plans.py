"""The launch plans of the redesigned K6 (``mhsa_plan``) and K7
(``vit_post_w8_plan``): threads, shared memory, ring stages and the
persistent grid's row split, at DeiT-Tiny's shapes (tight pads: 200 rows,
Dp 192; loose pads: 256 rows, Dp 256; the deploy path's 197 rows) and
around them. The kernels compute the same plans on the card; the card test
holds them to these functions."""

import pytest

from dlq_tpu_torch.ops.attention import MAX_KEYS, mhsa_plan
from dlq_tpu_torch.ops.vit_block import SMEM_MAX, vit_post_w8_plan

H100_SMS = 132


@pytest.mark.parametrize("rows,n_valid,hd,want", [
    (200, 197, 64, (416, 179712)),    # DeiT tight pads: 13 warps, 2 x (208 + 2 x 208) x 72 x 2
    (256, 197, 64, (512, 193536)),    # loose pads: 16 warps
    (197, 197, 64, (416, 179712)),    # the deploy path's unpadded rows
    (24, 21, 32, (64, 15360)),        # 2 x (32 + 2 x 32) x 40 x 2
])
def test_mhsa_plan_at_deit_shapes(rows, n_valid, hd, want):
    assert mhsa_plan(rows, n_valid, hd) == want


@pytest.mark.parametrize("hd", [32, 64])
def test_mhsa_plan_fits_every_row_count(hd):
    """Every row count the kernel takes (1..256, any n_valid) fits one block:
    at most 16 warps and the ring within the opt-in shared memory."""
    for rows in range(1, MAX_KEYS + 1):
        for n_valid in {1, rows // 2 or 1, rows}:
            threads, smem = mhsa_plan(rows, n_valid, hd)
            assert 32 <= threads <= 512 and threads % 32 == 0
            assert threads // 32 * 16 >= rows
            assert smem <= SMEM_MAX


@pytest.mark.parametrize("dp,hp,m,want", [
    (192, 768, 256 * 200, (7, 226416, 132, 388)),   # DeiT W8A8 block path at batch 256
    (256, 768, 256 * 256, (3, 231472, 132, 497)),   # the split forward's loose pads
    (256, 768, 64 * 256, (3, 231472, 132, 125)),    # loose pads at batch 64
    (128, 384, 72, (8, 160896, 2, 64)),             # at least 64 rows a block
])
def test_vit_post_w8_plan_at_deit_shapes(dp, hp, m, want):
    assert vit_post_w8_plan(dp, hp, m, H100_SMS) == want


@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200, 65536])
def test_vit_post_w8_plan_covers_rows(dp, m):
    """At DeiT's Hp the ring has at least 3 stages within the opt-in shared
    memory, and the blocks' contiguous row runs cover M with none empty and
    no more blocks than SMs."""
    stages, smem, grid, rows = vit_post_w8_plan(dp, 768, m, H100_SMS)
    assert 3 <= stages <= 8 and smem <= SMEM_MAX
    assert grid <= H100_SMS and rows >= 64
    assert (grid - 1) * rows < m <= grid * rows
