"""The launch plans of the redesigned K6 (``mhsa_plan``), K7
(``vit_post_w8_plan``), K10 (``matmul_int4a8_plan``) and K13
(``matmul_int4_plan``): threads, shared memory, ring stages and the
persistent grid's walk, at DeiT-Tiny's shapes (tight pads: 200 rows, Dp
192; loose pads: 256 rows, Dp 256; the deploy path's 197 rows and its six
dense sites) and around them. The kernels compute the same plans on the
card; the card tests hold them to these functions."""

import pytest

from dlq_tpu_torch.ops.attention import MAX_KEYS, mhsa_plan
from dlq_tpu_torch.ops.vit_block import SMEM_MAX, vit_post_w8_plan
from dlq_tpu_torch.ops.w4plan import W4_TILE, matmul_int4_plan, matmul_int4a8_plan

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


# ---- K10 and K13: the Hopper form's plan (ops.w4plan.w4_plan) ----

def _kp(k):
    return -(-k // 64) * 64


@pytest.mark.parametrize("m,k,n,want", [
    (256 * 196, 768, 192, (192, 1, 5, 232016, 132)),   # patch
    (256 * 197, 768, 192, (192, 1, 5, 232016, 132)),   # l*.fc2
    (256 * 197, 192, 576, (192, 3, 7, 217712, 132)),   # l*.qkv: 3 slices of 192
    (256 * 197, 192, 192, (192, 1, 7, 217712, 132)),   # l*.proj
    (256 * 197, 192, 768, (256, 3, 5, 221264, 132)),   # l*.fc1: 3 slices of 256
    (256, 192, 1000, (64, 16, 8, 124544, 32)),         # head: 2 tiles, narrowed to 64
])
def test_matmul_int4a8_plan_at_deit_sites(m, k, n, want):
    """K10 at DeiT-Tiny's six deploy sites at batch 256: slice width,
    slices, ring stages, shared-memory bytes (the source note's budgets) and
    blocks on an H100's 132 SMs."""
    assert matmul_int4a8_plan(m, n, _kp(k), H100_SMS) == want


@pytest.mark.parametrize("m,g,want", [
    (256 * 196, 128, (192, 1, 4, 213056, 132)),   # patch, G128
    (256 * 197, 128, (192, 1, 4, 213056, 132)),   # l*.fc2, G128
])
def test_matmul_int4_plan_at_deit_sites(m, g, want):
    """K13 at DeiT-Tiny's two G128 deploy sites (K 768, N 192) at batch 256:
    one slice of 192 columns, so each block reads its A rows once."""
    assert matmul_int4_plan(m, 192, 768, 768 // g, H100_SMS) == want


def _w4_walk(plan, m):
    """The kernels' persistent walk (csrc/w4gemm.cuh): for each block, its
    (M tile, slice) items in order; item i is tile i // slices, slice i %
    slices, and block b takes items b, b + grid, ..."""
    slices, grid = plan[1], plan[4]
    items = -(-m // W4_TILE) * slices
    return [[divmod(i, slices) for i in range(b, items, grid)] for b in range(grid)]


def _check_walk(plan, m, n):
    """Every output tile (128-row tile, slice) exactly once, the slices
    covering N, at most one block per SM within the opt-in shared memory,
    a ring of at least 3 stages; where the slices fit the SMs, every block
    keeps one slice."""
    ns, slices, stages, smem, grid = plan
    assert ns in (64, 128, 192, 256) and slices == -(-n // ns)
    assert 3 <= stages <= 8 and smem <= SMEM_MAX
    assert 1 <= grid <= H100_SMS
    walk = _w4_walk(plan, m)
    seen = [it for block in walk for it in block]
    assert sorted(seen) == [(t, s) for t in range(-(-m // 128)) for s in range(slices)]
    if slices <= H100_SMS:
        assert all(len({s for _, s in block}) == 1 for block in walk)


@pytest.mark.parametrize("k", [18, 192, 768, 3072])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 256, 50176, 50432])
def test_matmul_int4a8_plan_covers_outputs(m, k):
    """K10's walk at ragged and DeiT row counts, N from 1 to 1000 and K
    from 18 (the plan the C entry reports; the launch takes the first form
    there) to 3072."""
    for n in (1, 63, 64, 65, 192, 576, 768, 1000):
        _check_walk(matmul_int4a8_plan(m, n, _kp(k), H100_SMS), m, n)


@pytest.mark.parametrize("k,g", [(16, 16), (192, 16), (192, 32), (192, 128), (768, 16),
                                 (768, 32), (768, 128)])
@pytest.mark.parametrize("m", [1, 127, 129, 50432])
def test_matmul_int4_plan_covers_outputs(m, k, g):
    """K13's walk at every (K, group) the card test takes (G = ceil(Kp / g)
    scale groups a row, 192 per slice column at K 768, g 16)."""
    for n in (1, 21, 64, 192, 1000):
        _check_walk(matmul_int4_plan(m, n, _kp(k), -(-_kp(k) // g), H100_SMS), m, n)


def test_w4_plan_leaves_the_first_form_past_its_budget():
    """A Kp whose 64-column packed slice does not fit beside the smallest
    ring has no plan: the kernels run their first form there."""
    assert matmul_int4a8_plan(50432, 1000, 8192, H100_SMS) == (0,) * 5
    assert matmul_int4a8_plan(50432, 1000, 4096, H100_SMS)[0] == 64
