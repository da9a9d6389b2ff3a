"""K3's Hopper form (``csrc/basic_block.cu``, namespace ``hop``) on the CPU:
the launch plan and form rule (``basic_block_plan``, ``basic_block_form``)
at ResNet-18/34's packed shapes, the slabs' coverage of every read, and
the form's order emulated in numpy (strips of full-width rows, x and h on
the W + 2 slab grid with zero halo rows and columns, both convs as nine
shifted reads over each consumer's 64-row tiles, columns W and W + 1 and
rows past the image dropped, the skip as a 256-entry table and a
saturating byte add) bit for bit against ``basic_block_plain`` and the
JAX ``basic_block_fused`` in interpret mode. The kernel computes the same
plan on the card; the card tests hold it to these functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops.pallas_block import basic_block_fused as j_basic_block_fused
from dlq_tpu.ops.pallas_block import pack_basic_block as j_pack_basic_block
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as J_INT8_PC
from dlq_tpu.quant.quantize import quantize_tensor as j_quantize_tensor
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.ops import block_fused as bf
from dlq_tpu_torch.ops.block_fused import (
    BasicGeo, BasicPlan, basic_block_form, basic_block_geometry, basic_block_plain,
    basic_block_plan, pack_basic_block,
)

H100_SMS = 132


# ---- the plan and the form rule ----

@pytest.mark.parametrize("n,h,c,geo,plan", [
    # ResNet-18/34 layer2.x: strips of 6 rows (5 an image, the last 4 rows)
    (256, 28, 128, (30, 6, 5, 240, 180, 2, 2, 320, 320), (128, 8, 157072, 1280, 132)),
    (1, 28, 128, (30, 6, 5, 240, 180, 2, 2, 320, 320), (128, 8, 157072, 5, 5)),
    # layer3.x: a whole image an item, four conv1 tiles and four conv2 tiles
    (256, 14, 256, (16, 14, 1, 256, 224, 2, 2, 296, 296), (128, 8, 226704, 256, 132)),
    (1, 14, 256, (16, 14, 1, 256, 224, 2, 2, 296, 296), (128, 8, 226704, 1, 1)),
    # ResNet-34 layer4.1: one tile a consumer, 8 B stages beside 152 KB of slabs
    (256, 7, 512, (9, 7, 1, 81, 63, 1, 1, 152, 152), (128, 8, 230800, 256, 132)),
    (1, 7, 512, (9, 7, 1, 81, 63, 1, 1, 152, 152), (128, 8, 230800, 1, 1)),
])
def test_basic_block_plan_at_resnet_shapes(n, h, c, geo, plan):
    """The geometry and plan at the packed shapes, batch 1 and 256, and the
    plan's bytes as a hand sum: the B ring (NS x 64 a stage), the x and h
    slabs (C x SPX each), the output staging (64 rows of NS + 16), the
    skip's 256-byte table, 16 bytes of mbarriers a stage and 16 more,
    within the 232,448-byte opt-in."""
    g = basic_block_geometry(h, h)
    p = basic_block_plan(n, h, h, c, H100_SMS)
    assert g == BasicGeo(*geo) and p == BasicPlan(*plan)
    ring = p.b_stages * p.ns * 64
    assert p.smem == ring + c * (g.spx1 + g.spx2) + 64 * (p.ns + 16) + 256 + 16 * p.b_stages + 16
    assert p.smem <= 232448
    # the accumulators of a consumer: MT tiles x NS / 2 registers, at most 128
    assert max(g.mt1, g.mt2) * p.ns // 2 <= 128
    assert basic_block_form(h, h, c) == "hopper"


@pytest.mark.parametrize("h,w,c", [
    (56, 56, 64),     # C = 64: the first form (the reference fuses no such block)
    (14, 14, 192),    # C not a multiple of 128
    (90, 90, 128),    # W + 2 > 85: no strip of four conv1 tiles
    (14, 14, 1024),   # the slabs alone exceed the shared memory
])
def test_basic_block_form_rule_first(h, w, c):
    assert basic_block_form(h, w, c) == "first"
    assert basic_block_plan(3, h, w, c, H100_SMS) == bf.NO_BB_PLAN


@pytest.mark.parametrize("h,w", [(28, 28), (14, 14), (7, 7), (56, 56), (13, 13), (20, 9),
                                 (1, 1), (3, 83), (100, 5)])
def test_basic_block_geometry_covers_reads(h, w):
    """Every strip covers the image once; conv1's sum rows fit 2 MT1 tiles
    and conv2's 2 MT2 (MT <= 2); each slab chunk holds its TMA box (x: TOH
    + 4 rows, h: TOH + 2, GW pixels each) and every pixel a tile's nine
    taps read (sum row + kh GW + kw); a kept sum row (column < W, row in
    the strip) reads only written pixels."""
    g = basic_block_geometry(h, w)
    assert g.gw == w + 2 and g.rb * g.toh >= h > (g.rb - 1) * g.toh
    assert (g.toh + 2) * g.gw <= 256 and g.mt1 <= 2 and g.mt2 <= 2
    assert g.r1 <= 128 * g.mt1 and g.r2 <= 128 * g.mt2
    shift = 2 * g.gw + 2
    assert g.spx1 >= (g.toh + 4) * g.gw and g.spx1 >= 128 * g.mt1 + shift and g.spx1 % 8 == 0
    assert g.spx2 >= (g.toh + 2) * g.gw and g.spx2 >= 128 * g.mt2 + shift and g.spx2 % 8 == 0
    kept1 = max(q for q in range(g.r1) if q % g.gw < w)
    kept2 = max(q for q in range(g.r2) if q % g.gw < w)
    assert kept1 + shift < (g.toh + 4) * g.gw and kept2 + shift < (g.toh + 2) * g.gw


# ---- the Hopper form's order, emulated ----

def _requant(acc, s, b, inv, lo):
    """The blocks' epilogue (the plain version's own), on int64 sums."""
    return bf._requant_plain(torch.from_numpy(acc), s, b, inv, lo).numpy().astype(np.int64)


def _slab_sums(slab, wk, c, gw, rows):
    """One conv over a flat slab [spx, C]: sum row q takes slab pixel q + kh
    GW + kw for tap (kh, kw), against the K-major weight [C, 9 C] (K =
    (kh, kw, c)); int64 sums for the consumers' rows 0 .. rows - 1."""
    acc = np.zeros((rows, wk.shape[0]), np.int64)
    for tap in range(9):
        shift = (tap // 3) * gw + tap % 3
        acc += slab[shift: shift + rows] @ wk[:, tap * c:(tap + 1) * c].T
    return acc


def _hopper_block(x, pack, rng):
    """K3's Hopper form on int8 NHWC x, item by item: the x slab (rows oh0 -
    2 .. oh0 + TOH + 1, columns -1 .. W, zeros outside the image; past the
    box, stale bytes), conv1's sums on the consumers' tiles, h's codes into
    the h slab at (row, column + 1) for kept rows (0 outside the image),
    columns -1 and W zero (past its rows, stale bytes), conv2's sums, and
    for kept rows clip(z + lut[x], 0, 127) by a saturating add."""
    n, h, w, c = x.shape
    g = basic_block_geometry(h, w)
    inv_mid, inv_nxt, rs = pack["inv"]
    wk1 = pack["w1"].wk.numpy().astype(np.int64)
    wk2 = pack["w2"].wk.numpy().astype(np.int64)
    xs = torch.arange(-128, 128, dtype=torch.float32)
    lut = torch.clamp(torch.round(xs * rs), -127, 127).numpy().astype(np.int64)   # lut[x + 128]
    out = np.full((n, h, w, c), -1, np.int64)
    xi = x.numpy().astype(np.int64)
    for it in range(n * g.rb):
        img, oh0 = it // g.rb, (it % g.rb) * g.toh
        box = np.zeros((g.toh + 4, g.gw, c), np.int64)
        for r in range(g.toh + 4):
            ih = oh0 - 2 + r
            if 0 <= ih < h:
                box[r, 1:w + 1] = xi[img, ih]
        slab = rng.integers(-128, 128, (g.spx1, c)).astype(np.int64)
        slab[:box.shape[0] * g.gw] = box.reshape(-1, c)
        acc1 = _slab_sums(slab, wk1, c, g.gw, 128 * g.mt1)
        hq = _requant(acc1, pack["s1"], pack["b1"], inv_mid, 0.0)
        hs = rng.integers(0, 128, (g.spx2, c)).astype(np.int64)
        for hr in range(g.toh + 2):
            hs[hr * g.gw] = hs[hr * g.gw + g.gw - 1] = 0
        for q in range(g.r1):
            hr, col = divmod(q, g.gw)
            if col < w:
                hs[hr * g.gw + col + 1] = hq[q] if 0 <= oh0 - 1 + hr < h else 0
        acc2 = _slab_sums(hs, wk2, c, g.gw, 128 * g.mt2)
        z = _requant(acc2, pack["s2"], pack["b2"], inv_nxt, -127.0)
        for q in range(128 * g.mt2):
            ohl, jc = divmod(q, g.gw)
            if jc < w and ohl < g.toh and oh0 + ohl < h:
                sat = np.clip(z[q] + lut[xi[img, oh0 + ohl, jc] + 128], -128, 127)
                out[img, oh0 + ohl, jc] = np.maximum(sat, 0)
    assert (out >= 0).all()   # every output written once
    return out.astype(np.int8)


def _fields(qw):
    """numpy views of a JAX QTensor's fields, for dlq_tpu_torch.interop."""
    return {f: (np.asarray(v) if hasattr(v, "shape") else v) for f, v in vars(qw).items()}


def _block_case(h, c, n, seed):
    """One identity block's quantized sites and act scales, JAX and port."""
    rng = np.random.default_rng(seed)
    jq = {}
    for name in ("b.conv1", "b.conv2"):
        w = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
        qw = j_quantize_tensor(jnp.asarray(w), J_INT8_PC.weights)
        qw.orig_shape = (3, 3, c, c)
        jq[name] = {"qw": qw, "b": jnp.asarray(rng.normal(0, 0.2, c).astype(np.float32))}
    scales = {"b.conv1": np.float32(0.05), "b.conv2": np.float32(0.35),
              "n.conv1": np.float32(0.08)}
    tq, ts = from_jax_qflat({k: {"qw": _fields(p["qw"]), "b": np.asarray(p["b"])}
                             for k, p in jq.items()}, scales, device="cpu")
    x = rng.integers(0, 128, (n, h, h, c)).astype(np.int8)
    return jq, {k: jnp.asarray(v) for k, v in scales.items()}, tq, ts, x, rng


@pytest.mark.parametrize("h,c,n,jax_too", [(14, 128, 2, True), (7, 256, 2, True),
                                           (28, 128, 1, False)])
def test_hopper_order_against_plain_and_jax(h, c, n, jax_too):
    """The Hopper form's order bit for bit against the plain version (and,
    at 14^2 x 128 and 7^2 x 256, the JAX kernel in interpret mode): a whole
    image an item at 14^2 (four tiles of each conv, stale slab bytes past
    the rows read only by dropped sums) and 7^2 (one tile a consumer), and
    28^2's strips of 6 rows with a partial last strip."""
    jq, jscales, tq, ts, x, rng = _block_case(h, c, n, seed=1700 + h + c)
    pack = pack_basic_block(tq, ts, "b", "n.conv1")
    xt = torch.from_numpy(x)
    got = _hopper_block(xt, pack, rng)
    plain = basic_block_plain(xt, pack).numpy()
    assert float((plain == 0).mean()) < 0.95 and float(plain.astype(np.float64).std()) > 5.0
    np.testing.assert_array_equal(got, plain)
    if jax_too:
        ref = np.asarray(j_basic_block_fused(
            jnp.asarray(x), j_pack_basic_block(jq, jscales, "b", "n.conv1"), interpret=True))
        np.testing.assert_array_equal(got, ref)


def test_hopper_order_negative_skip():
    """The skip table and the saturating add over the whole int8 range of
    x (a negative input's skip), against the plain version."""
    _, _, tq, ts, _, rng = _block_case(7, 128, 1, seed=1799)
    pack = pack_basic_block(tq, ts, "b", "n.conv1")
    xt = torch.from_numpy(rng.integers(-128, 128, (2, 7, 7, 128)).astype(np.int8))
    np.testing.assert_array_equal(_hopper_block(xt, pack, rng), basic_block_plain(xt, pack).numpy())
