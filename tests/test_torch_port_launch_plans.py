"""The launch plans of the redesigned K6 (``mhsa_plan``), K7
(``vit_post_w8_plan``), K10 (``matmul_int4a8_plan``), K13
(``matmul_int4_plan``), K2 (``matmul_int8_plan``) and K1
(``conv_int8_plan`` and its slab geometry): threads, shared memory, ring
stages and the persistent grid's walk, at DeiT-Tiny's shapes (tight pads:
200 rows, Dp 192; loose pads: 256 rows, Dp 256; the deploy path's 197 rows
and its six dense sites), ResNet-18/50's ``fused2`` convs and denses, and
around them; and K1's halo-slab design emulated in numpy against a direct
conv. The kernels compute the same plans on the card; the card tests hold
them to these functions."""

import numpy as np
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


# ---- K2 and K1: the int8 Hopper form's plan (ops.i8plan) ----

from dlq_tpu_torch.ops import i8plan  # noqa: E402

# ResNet-50 fused2's 1x1/s1 convs and both fcs, DeiT-Tiny's six deploy
# sites: (rows per image, K, N, int8 out)
K2_SITES = [
    (1, 512, 1000, False), (3136, 64, 64, True), (3136, 64, 256, True), (3136, 256, 64, True),
    (3136, 256, 128, True), (784, 128, 512, True), (784, 512, 128, True), (784, 512, 256, True),
    (196, 256, 1024, True), (196, 1024, 256, True), (196, 1024, 512, True), (49, 512, 2048, True),
    (49, 512, 2048, False), (49, 2048, 512, True), (1, 2048, 1000, False),
    (196, 768, 192, False), (197, 192, 576, False), (197, 192, 192, False),
    (197, 192, 768, False), (197, 768, 192, False), (1, 192, 1000, False)]

# ResNet-18 / -50 fused2's convs on K1: (H, C, OC, k, stride, int8 out)
K1_SITES = [
    (56, 64, 64, 3, 1, True), (56, 64, 128, 3, 2, True), (56, 64, 128, 1, 2, True),
    (28, 128, 128, 3, 1, True), (28, 128, 256, 3, 2, True), (28, 128, 256, 1, 2, True),
    (14, 256, 256, 3, 1, True), (14, 256, 512, 3, 2, True), (14, 256, 512, 1, 2, True),
    (7, 512, 512, 3, 1, True), (7, 512, 512, 3, 1, False), (56, 128, 128, 3, 2, True),
    (28, 256, 256, 3, 2, True), (14, 512, 512, 3, 2, True), (56, 256, 512, 1, 2, True),
    (28, 512, 1024, 1, 2, True), (14, 1024, 2048, 1, 2, True)]


def _i8_check_plan(p, n, resident_ok=True):
    """A fitting plan: a slice width covering N, stage counts in range, a
    resident slice only with one slice, shared memory within the opt-in
    limit, at most one block per SM and a grid that is a multiple of the
    slice count (or all SMs)."""
    assert p.ns in i8plan.I8_WIDTHS and p.slices == -(-n // p.ns)
    assert p.smem <= i8plan.SMEM_MAX and 1 <= p.grid <= H100_SMS
    if p.b_stages == 0:
        assert resident_ok and p.slices == 1 and 4 <= p.a_stages <= 8
    else:
        assert 3 <= p.b_stages <= 8 and 2 <= p.a_stages <= 8
    assert p.grid % p.slices == 0 or p.grid == H100_SMS


@pytest.mark.parametrize("hw,k,n,i8", K2_SITES)
@pytest.mark.parametrize("batch", [64, 256])
def test_matmul_int8_plan_at_main_sites(hw, k, n, i8, batch):
    """K2 at every ResNet-50 ``fused2`` and DeiT-Tiny deploy site: the
    Hopper form (K % 16 == 0) with a plan that fits."""
    assert i8plan.matmul_int8_form(k) == "hopper"
    p = i8plan.matmul_int8_plan(batch * hw, n, -(-k // 64) * 64, i8, H100_SMS)
    _i8_check_plan(p, n)


@pytest.mark.parametrize("m,k,n,i8,want", [
    (256 * 3136, 64, 64, True, (64, 1, 8, 0, 75408, 132)),        # R50 layer1.0.conv1: resident
    (256 * 3136, 256, 128, True, (128, 1, 8, 0, 108688, 132)),    # layer2.0.conv1
    (256 * 196, 1024, 256, True, (256, 1, 8, 8, 216336, 132)),    # layer3 conv1: streamed
    (256 * 49, 512, 2048, False, (256, 8, 6, 6, 217296, 128)),    # the fp32 final junction
    (256, 2048, 1000, False, (64, 16, 8, 8, 117520, 32)),         # the fc: narrowed to 64
    (256 * 197, 192, 768, False, (256, 3, 6, 6, 217296, 132)),    # DeiT l*.fc1
])
def test_matmul_int8_plan_values(m, k, n, i8, want):
    """K2's plan at a few sites, value for value (slice width, slices, A
    stages, B stages (0: resident slice), shared memory, blocks)."""
    assert tuple(i8plan.matmul_int8_plan(m, n, -(-k // 64) * 64, i8, H100_SMS)) == want


@pytest.mark.parametrize("k", [16, 48, 64, 1024, 2048, 4096])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 256, 50432, 802816])
def test_matmul_int8_plan_covers_outputs(m, k):
    """K2's walk: every (128-row tile, slice) item exactly once over the
    blocks, each block on one slice; N from 1 to 2048, int8 and fp32."""
    for n in (1, 63, 64, 65, 256, 520, 1000, 2048):
        for i8 in (False, True):
            p = i8plan.matmul_int8_plan(m, n, -(-k // 64) * 64, i8, H100_SMS)
            _i8_check_plan(p, n)
            units = -(-m // 128)
            walk = [list(range(b, units * p.slices, p.grid)) for b in range(p.grid)]
            seen = sorted(it for blk in walk for it in blk)
            assert seen == list(range(units * p.slices))
            if p.slices <= H100_SMS:
                assert all(len({it % p.slices for it in blk}) <= 1 for blk in walk)


def test_matmul_int8_first_form_rule():
    """K % 16 != 0 takes the first form (rows of x not 16-byte aligned)."""
    assert [i8plan.matmul_int8_form(k) for k in (8, 18, 24, 40, 16, 32, 768)] == \
        ["first"] * 4 + ["hopper"] * 3


@pytest.mark.parametrize("h,c,oc,k,s,i8", K1_SITES)
@pytest.mark.parametrize("batch", [1, 3, 256])
def test_conv_int8_plan_at_resnet_sites(h, c, oc, k, s, i8, batch):
    """K1 at every ResNet-18/-50 ``fused2`` conv: the Hopper form, a plan
    that fits, the slab within its chunk (the last sum row plus the largest
    tap shift), a resident weight exactly where its one slice fits (OC 64 and
    128 at 3x3, the 1x1/s2 at 56^2 and 28^2)."""
    pad = k // 2
    assert i8plan.conv_int8_form(h, h, c, oc, k, s, pad, i8) == "hopper"
    g = i8plan.conv_geometry(h, h, c, k, s, pad)
    p = i8plan.conv_int8_plan(batch, h, h, c, oc, k, s, pad, i8, H100_SMS)
    _i8_check_plan(p, oc)
    rows = 128 if g.imgs == 1 else 64
    assert max(sh for _, sh in i8plan.conv_taps(k, s, g.gw)) + rows <= g.spx
    assert (p.b_stages == 0) == (p.ns * k * k * c + 4 * i8plan.conv_a_bytes(g) + 8 * p.ns
                                 + 64 * i8plan.staging_row(p.ns, i8) + 16 * 5 <= i8plan.SMEM_MAX
                                 and oc <= p.ns)


@pytest.mark.parametrize("h,c,k,s,want,waste", [
    (56, 64, 3, 1, (58, 2, 28, 1, 248, 1), 16 / 128),   # 2 rows of 58: 116 sum rows, 112 valid
    (28, 128, 3, 1, (30, 4, 7, 1, 192, 1), 16 / 128),   # 4 rows of 30: 120, 112 valid
    (14, 256, 3, 1, (16, 7, 2, 1, 168, 1), 30 / 128),   # 7 rows of 16: 112, 98 valid
    (7, 512, 3, 1, (9, 7, 1, 2, 88, 1), 15 / 64),       # a whole image a consumer: 63, 49 valid
    (56, 64, 3, 2, (29, 4, 7, 1, 160, 4), 16 / 128),    # four phase planes
    (28, 128, 3, 2, (15, 7, 2, 1, 144, 4), 30 / 128),
    (14, 256, 3, 2, (8, 7, 1, 2, 80, 4), 15 / 64),
    (56, 64, 1, 2, (28, 4, 7, 1, 128, 1), 16 / 128),    # 1x1/s2: one plane, no halo
    (28, 128, 1, 2, (14, 7, 2, 1, 128, 1), 30 / 128),
    (14, 256, 1, 2, (7, 7, 1, 2, 64, 1), 15 / 64),
])
def test_conv_geometry_per_layer(h, c, k, s, want, waste):
    """K1's slab per ResNet layer: grid width, output rows an item, row
    blocks an image, images an item, slab pixels a chunk, planes; and the
    share of an item's wgmma rows (128, or 64 a consumer) that are computed
    and dropped (halo columns and rows past TOH x GW)."""
    g = i8plan.conv_geometry(h, h, c, k, s, k // 2)
    assert tuple(g) == want
    oh = (h + 2 * (k // 2) - k) // s + 1
    rows = 128 if g.imgs == 1 else 64
    assert (rows - g.toh * oh) / rows == pytest.approx(waste)


@pytest.mark.parametrize("h,c,oc,k,s,pad", [
    (224, 3, 64, 7, 2, 3),     # the deploy / pallas stem
    (56, 3, 64, 3, 1, 1),      # C % 64 != 0
    (28, 32, 64, 3, 1, 1),
    (28, 96, 64, 3, 2, 1),
    (14, 64, 64, 5, 1, 2),     # a 5x5 kernel
    (14, 64, 64, 3, 1, 0),     # pad != k // 2
    (14, 64, 64, 3, 3, 1),     # stride 3
    (260, 64, 64, 3, 1, 1),    # a grid wider than 128
])
def test_conv_int8_first_form_rule(h, c, oc, k, s, pad):
    """What the Hopper form does not take runs the first form."""
    assert i8plan.conv_geometry(h, h, c, k, s, pad) == i8plan.NO_GEO
    assert i8plan.conv_int8_form(h, h, c, oc, k, s, pad, True) == "first"
    assert i8plan.conv_int8_plan(256, h, h, c, oc, k, s, pad, True, H100_SMS) == i8plan.NO_PLAN


def _emulate_hopper_conv(x, w, stride, pad, rng):
    """K1's Hopper form in numpy: for each item and consumer, the slab as
    the TMA boxes land it (planes of GW x (TOH + e) pixels, out-of-bounds
    pixels zero, the rest of the chunk's SPX pixels stale: random), each
    sum row the sum over taps of its shifted slab row against the tap's
    weights, and the valid rows written to their output pixels."""
    n, h, wd, c = x.shape
    k, oc = w.shape[0], w.shape[3]
    g = i8plan.conv_geometry(h, wd, c, k, stride, pad)
    oh, ow = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    e = (k - 1) // stride
    taps = i8plan.conv_taps(k, stride, g.gw)
    out = np.full((n, oh, ow, oc), np.iinfo(np.int64).min)
    for unit in range(-(-n // g.imgs) * g.rb):
        ug, rbk = divmod(unit, g.rb)
        oh0 = rbk * g.toh
        for cw in (0, 1):
            rb0, img = (64 * cw, ug) if g.imgs == 1 else (0, ug * 2 + cw)
            if img >= n:
                continue
            slab = rng.integers(-127, 128, (g.planes, g.spx, c))
            for p in range(g.planes):
                pa, pb = divmod(p, 2)
                for r in range(g.toh + e):
                    for cc in range(g.gw):
                        ih = stride * oh0 + pa - pad + stride * r
                        iw = pb - pad + stride * cc
                        inb = 0 <= ih < h and 0 <= iw < wd
                        slab[p, r * g.gw + cc] = x[img, ih, iw] if inb else 0
            for q in range(rb0, rb0 + 64):
                ohl, j = divmod(q, g.gw)
                acc = np.zeros(oc, np.int64)
                for t, (plane, shift) in enumerate(taps):
                    assert q + shift < g.spx
                    acc += slab[plane, q + shift] @ w[t // k, t % k]
                if j < ow and ohl < g.toh and oh0 + ohl < oh:
                    assert out[img, oh0 + ohl, j, 0] == np.iinfo(np.int64).min
                    out[img, oh0 + ohl, j] = acc
    return out


@pytest.mark.parametrize("n,h,k,s", [(3, 7, 3, 1), (1, 15, 3, 1), (2, 12, 3, 2), (3, 9, 3, 2),
                                     (2, 14, 1, 2), (3, 7, 1, 2), (1, 20, 3, 1)])
def test_conv_hopper_slab_emulation(n, h, k, s):
    """The halo-slab design gives the conv's exact sums at every output
    pixel, written once each: the geometry (grid width, rows an item, two
    images an item, phase planes), the tap shifts, the stale slab pixels
    reaching only dropped rows, at small shapes of each kind (C = 64)."""
    rng = np.random.default_rng(n * 100 + h * 10 + k + s)
    c, oc, pad = 64, 5, k // 2
    x = rng.integers(-127, 128, (n, h, h, c))
    w = rng.integers(-127, 128, (k, k, c, oc))
    got = _emulate_hopper_conv(x, w, s, pad, rng)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    oh = (h + 2 * pad - k) // s + 1
    ref = np.zeros((n, oh, oh, oc), np.int64)
    for kh in range(k):
        for kw in range(k):
            ref += xp[:, kh:kh + s * oh:s, kw:kw + s * oh:s] @ w[kh, kw]
    assert np.array_equal(got, ref)


# ---- K5: the Hopper form's plan (ops.vit_block.vit_pre_w8_plan) ----

from dlq_tpu_torch.ops.vit_block import vit_pre_w8_form, vit_pre_w8_plan  # noqa: E402


@pytest.mark.parametrize("dp,m,want", [
    (192, 256 * 200, (1, 0, 3, 227952, 132, 388)),   # DeiT W8A8 block path at batch 256: resident
    (256, 64 * 256, (0, 8, 2, 221376, 132, 125)),    # the split forward's loose pads at batch 64
    (256, 256 * 256, (0, 8, 2, 221376, 132, 497)),   # loose pads at batch 256
    (128, 72, (1, 0, 4, 152720, 2, 64)),             # at least 64 rows a block
])
def test_vit_pre_w8_plan_at_deit_shapes(dp, m, want):
    """K5's plan at DeiT-Tiny's shapes: the weight resident at Dp 128 and 192
    beside 3-4 y stages a consumer (the source note's budgets), streamed in
    8 stages beside 2 y stages at Dp 256."""
    assert vit_pre_w8_plan(dp, m, H100_SMS) == want


@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200, 51272, 65536])
def test_vit_pre_w8_plan_covers_rows(dp, m):
    """The resident weight (Dp 128, 192) or a ring of 3 to 8 stages (Dp 256)
    beside 2 to 4 y stages a consumer, within the opt-in shared memory; the
    blocks' contiguous runs, walked in 128-row tiles split 64 / 64 between
    the consumers, cover every row once with no block empty and no more
    blocks than SMs; each consumer's y stages (8 fp32 or 16 bf16 rows) cover
    its rows once, in the order the producer loads them."""
    resident, stages, ystages, smem, grid, rows = vit_pre_w8_plan(dp, m, H100_SMS)
    assert smem <= SMEM_MAX and resident == (dp < 256) and 2 <= ystages <= 4
    assert resident or 3 <= stages <= 8
    assert grid <= H100_SMS and rows >= 64
    seen = []
    for b in range(grid):
        m_begin, m_end = b * rows, min(m, (b + 1) * rows)
        assert m_end > m_begin
        for m0 in range(m_begin, m_end, 128):
            for cw in (0, 1):
                r0 = m0 + 64 * cw
                n = max(0, min(64, m_end - r0))
                for yr in (8, 16):   # y stages of the consumer's rows
                    got = [r0 + k + i for k in range(0, 64, yr) for i in range(max(0, min(yr, n - k)))]
                    assert got == list(range(r0, r0 + n))
                seen += range(r0, r0 + n)
    assert seen == list(range(m))


def test_vit_pre_w8_form_rule():
    """The Hopper form takes Dp 128, 192 and 256; every other Dp (multiples
    of 64 up to 512) runs the first form."""
    assert [dp for dp in range(64, 513, 64) if vit_pre_w8_form(dp) == "hopper"] == [128, 192, 256]


# ---- K4: the Hopper form's items, plan and walk (ops.block_fused) ----

import torch  # noqa: E402

from dlq_tpu_torch.ops.block_fused import (  # noqa: E402
    NO_BN_PLAN, _requant_plain, bottleneck_block_plain, bottleneck_form, bottleneck_geometry,
    bottleneck_plan, pack_bottleneck_block,
)


@pytest.mark.parametrize("h,c4,cm,geo,plan", [
    # layer1: strips of 2 rows, conv1 in 2 passes, the three weights resident
    (56, 256, 64, (58, 2, 28, 1, 224, 2, 248), (256, 64, 256, 4, 0, 144208, 7168, 132)),
    # layer2: strips of 4 rows, streamed weights in 8 B stages of 256 x 64
    (28, 512, 128, (30, 4, 7, 1, 168, 2, 192), (256, 128, 256, 4, 8, 222672, 1792, 132)),
    # layer3: strips of 7 rows, one conv1 pass
    (14, 1024, 256, (16, 7, 2, 1, 126, 1, 168), (256, 256, 256, 4, 6, 224688, 512, 132)),
    # layer4: two whole images an item, 128-wide slices, 6 B stages beside 2 A stages
    (7, 2048, 512, (9, 7, 1, 2, 63, 1, 88), (128, 128, 128, 2, 6, 230800, 128, 128)),
])
def test_bottleneck_plan_at_r50_stages(h, c4, cm, geo, plan):
    """K4 at ResNet-50's four identity-block shapes at batch 256: the item
    geometry and the plan (the source note's shared-memory budgets)."""
    assert tuple(bottleneck_geometry(h, h)) == geo
    assert tuple(bottleneck_plan(256, h, h, c4, cm, H100_SMS)) == plan
    assert bottleneck_form(h, h, c4, cm) == "hopper"


@pytest.mark.parametrize("h", [1, 2, 5, 6, 7, 9, 12, 13, 14, 20, 28, 31, 56, 100, 126])
@pytest.mark.parametrize("c4,cm", [(256, 64), (512, 128), (1024, 256), (2048, 512), (192, 320)])
def test_bottleneck_plan_or_first_form(h, c4, cm):
    """Where no plan fits (CM 512 with a slab of W >= 100: h1 and h2 alone
    outgrow the shared memory), the rule gives the first form."""
    p = bottleneck_plan(3, h, h, c4, cm, H100_SMS)
    want = "first" if (cm, h) in ((512, 100), (512, 126)) else "hopper"
    assert bottleneck_form(h, h, c4, cm) == want and (p == NO_BN_PLAN) == (want == "first")


@pytest.mark.parametrize("h", [1, 2, 5, 6, 7, 9, 12, 13, 14, 20, 28, 31, 56])
@pytest.mark.parametrize("c4,cm", [(256, 64), (512, 128), (1024, 256), (2048, 512), (192, 320)])
def test_bottleneck_plan_covers_outputs(h, c4, cm):
    """Every output pixel of every image in exactly one item and consumer
    region; conv1's passes cover the region's (TOH + 2) x W rows; a
    consumer's sum rows plus the largest tap shift stay within the slab;
    the plan within the opt-in shared memory with 2 to 4 A stages and
    resident weights or 3 to 8 B stages."""
    n = 3
    g = bottleneck_geometry(h, h)
    p = bottleneck_plan(n, h, h, c4, cm, H100_SMS)
    assert p != NO_BN_PLAN and p.smem <= SMEM_MAX
    assert 2 <= p.a_stages <= 4 and (p.b_stages == 0 or 3 <= p.b_stages <= 8)
    assert cm % p.ns12 == 0 and c4 % p.ns3 == 0
    rows = 64 if g.imgs == 2 else 128
    assert g.toh * g.gw <= rows and g.passes * 128 >= g.m1 and (g.imgs == 1 or g.m1 <= 64)
    assert g.spx >= rows + 2 * g.gw + 2 and g.spx >= (g.toh + 2) * g.gw
    seen = np.zeros((n, h, h), int)
    for it in range(p.items):
        for cw in (0, 1):
            img, oh0 = (it // g.rb, (it % g.rb) * g.toh) if g.imgs == 1 else (2 * it + cw, 0)
            rb0 = 64 * cw if g.imgs == 1 else 0
            for q in range(rb0, rb0 + 64):
                ohl, j = divmod(q, g.gw)
                if img < n and j < h and ohl < g.toh and oh0 + ohl < h:
                    seen[img, oh0 + ohl, j] += 1
    assert (seen == 1).all()


def test_bottleneck_first_form_rule():
    """An output grid wider than 128 sum rows (W > 126) runs the first form."""
    assert bottleneck_form(126, 126, 256, 64) == "hopper"
    assert bottleneck_form(127, 127, 256, 64) == "first"
    assert bottleneck_geometry(130, 130).gw == 0


def _bottleneck_pack(rng, c4, cm):
    from dlq_tpu_torch.quant.model_quant import quantize_weights
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL

    flat = {}
    for name, shape in (("b.conv1", (1, 1, c4, cm)), ("b.conv2", (3, 3, cm, cm)),
                        ("b.conv3", (1, 1, cm, c4))):
        flat[name] = {"w": torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32)),
                      "b": torch.from_numpy(rng.normal(0, 0.2, shape[-1]).astype(np.float32))}
    scales = {n: torch.tensor(v, dtype=torch.float32)
              for n, v in (("b.conv1", 0.05), ("b.conv2", 0.08), ("b.conv3", 0.04),
                           ("n.conv1", 0.07))}
    return pack_bottleneck_block(quantize_weights(flat, INT8_PER_CHANNEL), scales, "b", "n.conv1")


def _emulate_hopper_bottleneck(x, pack, rng):
    """K4's Hopper form in numpy, item by item and consumer by consumer: the
    conv1 rows each consumer's A boxes hold (x viewed as [N H W, C4] from
    the strip's row above, rows past the tensor zero, rows of a neighbouring
    image computed and dropped), their sums mapped to slab pixels (h1's
    codes, 0 for rows outside the image; the padding columns zero since the
    start; the rest of the slab stale: random, carried from item to item),
    conv2's sum rows as the nine shifted slab rows, conv3 on h2's rows (the
    dropped rows' h2 never reach out), and the valid rows written to their
    output pixels, each once: both consumers on one item, 64 rows each of
    each 128-row conv1 pass and of the 128 sum rows (two images an item:
    one each). The requants are the plain version's own on the assembled
    [N, H, W, C] sums, which must reach every pixel."""
    n, h, wd, c4 = x.shape
    cm = pack["w1"].oc
    g = bottleneck_geometry(h, wd)
    p = bottleneck_plan(n, h, wd, c4, cm, H100_SMS)
    inv_h1, inv_h2, inv_nxt, rs = pack["inv"]
    xf = x.numpy().astype(np.int64).reshape(n * h * wd, c4)
    w1 = pack["w1"].hwio()[0, 0].numpy().astype(np.int64)
    w2 = pack["w2"].hwio().numpy().astype(np.int64)
    w3 = pack["w3"].hwio()[0, 0].numpy().astype(np.int64)
    taps = [((t // 3) * g.gw + t % 3, w2[t // 3, t % 3]) for t in range(9)]
    unset = np.iinfo(np.int64).min

    def jobs(it):
        """(consumer, image, first output row, conv1 (box row, first q1)
        pairs, first sum row) of each consumer's share of item ``it``."""
        for cw in (0, 1):
            if g.imgs == 1:
                img, oh0 = it // g.rb, (it % g.rb) * g.toh
                c1 = [((img * h + oh0 - 1) * wd + 128 * q + 64 * cw, 128 * q + 64 * cw)
                      for q in range(g.passes)]
                yield cw, img, oh0, c1, 64 * cw
            else:
                img = 2 * it + cw
                yield cw, img, 0, [((img * h - 1) * wd, 0)], 0

    def requant(acc, s, b, inv, lo):
        return _requant_plain(torch.from_numpy(acc.astype(np.float64)), s, b, inv, lo).numpy()

    # conv1: each consumer's rows of each pass, from its A boxes
    acc1 = np.full((n, h, wd, cm), unset)
    for it in range(p.items):
        for _, img, oh0, c1, _ in jobs(it):
            for start, q0 in c1:
                rows = np.arange(start, start + 64)
                a = np.where(((rows >= 0) & (rows < n * h * wd))[:, None],
                             xf[np.clip(rows, 0, n * h * wd - 1)], 0)
                sums = a @ w1
                for r in range(64):
                    q1 = q0 + r
                    if q1 >= g.m1 or img >= n:
                        continue
                    hr, c = divmod(q1, wd)
                    ih = oh0 - 1 + hr
                    if 0 <= ih < h:   # a recomputed halo row gives the same sums
                        assert acc1[img, ih, c, 0] in (unset, sums[r, 0])
                        acc1[img, ih, c] = sums[r]
    assert (acc1 != unset).all()
    h1 = requant(acc1, pack["s1"], pack["b1"], inv_h1, 0.0)
    # conv2 on the slab, then conv3 on h2's rows
    acc2 = np.full((n, h, wd, cm), unset)
    slabs = [rng.integers(0, 128, (g.spx, cm)) for _ in range(g.imgs)]
    for sl in slabs:
        for hr in range(g.toh + 2):
            sl[hr * g.gw] = sl[hr * g.gw + g.gw - 1] = 0
    written = []
    for it in range(p.items):
        for cw, img, oh0, _, rb0 in jobs(it):
            slab = slabs[cw if g.imgs == 2 else 0]
            if img < n and (g.imgs == 2 or cw == 0):   # the conv1 epilogue's writes
                for hr in range(g.toh + 2):
                    ih = oh0 - 1 + hr
                    slab[hr * g.gw + 1: hr * g.gw + 1 + wd] = h1[img, ih] if 0 <= ih < h else 0
            for q in range(rb0, rb0 + 64):
                ohl, j = divmod(q, g.gw)
                assert q + taps[-1][0] < g.spx
                if img < n and j < wd and ohl < g.toh and oh0 + ohl < h:
                    assert acc2[img, oh0 + ohl, j, 0] == unset
                    acc2[img, oh0 + ohl, j] = sum(slab[q + sh] @ wt for sh, wt in taps)
                    written.append((img, oh0 + ohl, j))
    assert (acc2 != unset).all()
    h2 = requant(acc2, pack["s2"], pack["b2"], inv_h2, 0.0)
    acc3 = np.full((n, h, wd, c4), unset)
    for img, oh, j in written:   # a valid row's h2 codes; the dropped rows' never reach out
        acc3[img, oh, j] = h2[img, oh, j].astype(np.int64) @ w3
    z = requant(acc3, pack["s3"], pack["b3"], inv_nxt, -127.0)
    r = np.clip(np.round(x.numpy().astype(np.float32) * np.float32(rs)), -127, 127)
    return torch.from_numpy(np.clip(z + r, 0, 127).astype(np.int8))


@pytest.mark.parametrize("n,h,c4,cm", [
    (1, 9, 64, 64),     # one strip an image (rb 1), one conv1 pass
    (2, 13, 64, 64),    # a partial last strip (toh 7: rows 7..12 of 13)
    (2, 12, 128, 64),   # 12^2: strips of 6 rows
    (1, 20, 64, 128),   # two conv1 passes (7 x 20 = 140 rows)
    (3, 7, 64, 64),     # two whole images an item, the last item one image
    (2, 5, 64, 64),     # two whole images an item, 5^2
])
def test_bottleneck_hopper_item_emulation(n, h, c4, cm):
    """The Hopper form's item walk gives the plain version's block output
    bit for bit: strips and whole images, the haloed conv1 rows, h1 zeroed
    outside the image, the nine slab taps, the valid rows written once."""
    rng = np.random.default_rng(n * 1000 + h * 10 + cm)
    pack = _bottleneck_pack(rng, c4, cm)
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, h, c4)).astype(np.int8))
    assert torch.equal(_emulate_hopper_bottleneck(x, pack, rng), bottleneck_block_plain(x, pack))
