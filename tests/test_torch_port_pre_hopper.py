"""K8's and K14's Hopper forms on the CPU: the launch plans and form rules
(``vit_pre_w4a8_plan`` / ``_form``: K5's body, ``csrc/vit_pre_iw.cuh``;
``vit_pre_bf16_plan`` / ``_form``: K11's body, ``csrc/vit_pre_hw.cuh``) at
DeiT-Tiny's shapes against a hand-written sum of their shared memory; K8's
producer filling K5's resident int8 weight from the packed bytes, emulated
bit for bit against the reference's own ``_unpack_halves_i8``, and the
int32 sums over it against ``_dot_w4a8``'s; K14's stage walk (one TMA box a
stage with 128-byte swizzle, read through swizzled ``wgmma`` descriptors)
against the consumers' K steps; and K14's tensor-core sum order in numpy
against its plain version. The kernels compute the same plans on the card;
the card tests hold them to these functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops.pallas_vit_block import _dot_w4a8, _unpack_halves_i8
from dlq_tpu_torch.ops import vit_block as vb
from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor
from dlq_tpu_torch.ops.vit_block import (
    SMEM_MAX, vit_block_pre_bf16_plain, vit_block_pre_plain, vit_pre_bf16_form,
    vit_pre_bf16_plan, vit_pre_w4a8_form, vit_pre_w4a8_plan, vit_pre_w8_plan,
)
from test_torch_port_post_h import BF16_TOL, _bf16, _f32, _ln_lanes
from test_torch_port_w4_hopper import _walk, core_off, nib_sx

H100_SMS = 132
DEIT_M = (1, 63, 64, 65, 72, 400, 51200, 65536)
STAGING = 2 * 8 * 8 * (2 * 192 + 16)   # each consumer warp's two 8-row output buffers


# ---- the plans and the form rules ----

@pytest.mark.parametrize("dp,m,want", [
    (192, 256 * 200, (1, 0, 3, 227952, 132, 388)),   # DeiT-Tiny tight pads, batch 256
    (128, 256 * 200, (1, 0, 4, 152720, 132, 388)),
    (192, 256 * 256, (1, 0, 3, 227952, 132, 497)),
    (256, 256 * 256, (0, 0, 0, 0, 0, 0)),            # the first form: no resident weight
])
def test_vit_pre_w4a8_plan_at_deit_shapes(dp, m, want):
    """K8's plan is K5's where the weight is resident (its packed bytes
    unpack into K5's int8 copy): the weight 3·Dp x Dp, the codes of a
    128-row tile, the {s, s, b, b} table, the output staging, one mbarrier
    pair for the weight and the y stages (32·Dp bytes and two mbarriers
    each); all 0 at Dp 256, where K5 streams its weight and K8 takes its
    first form."""
    got = vit_pre_w4a8_plan(dp, m, H100_SMS)
    assert got == want
    if got[0]:
        assert got == vit_pre_w8_plan(dp, m, H100_SMS)
        ny, smem = got[2], got[3]
        assert smem == (3 * dp * dp + 128 * dp + 3 * dp * 8 + STAGING + 16
                        + 2 * ny * (32 * dp + 16)) <= SMEM_MAX


@pytest.mark.parametrize("dp,m,want", [
    (192, 256 * 200, (4, 2, 227968, 132, 388)),   # DeiT-Tiny tight pads, batch 256
    (256, 256 * 256, (3, 2, 229488, 132, 497)),   # loose pads
    (128, 256 * 200, (5, 2, 226448, 132, 388)),
])
def test_vit_pre_bf16_plan_at_deit_shapes(dp, m, want):
    """K14's plan is K11's: weight stages of 192 rows x 128 bytes (64 bf16 K
    values a row, one TMA box) at the start of shared memory, each a whole
    number of 1,024-byte swizzle atoms, so every stage base has the
    alignment the 128-byte swizzle needs; then bf16 h1 for 128 rows, the
    table, the staging and the y stages."""
    got = vit_pre_bf16_plan(dp, m, H100_SMS)
    assert got == want == vb.vit_pre_w4_plan(dp, m, H100_SMS)
    stages, ny, smem = got[:3]
    stage = 192 * 128
    assert stage % 1024 == 0 and all((i * stage) % 1024 == 0 for i in range(stages))
    assert smem == (stages * (stage + 16) + 128 * dp * 2 + 3 * dp * 8 + STAGING
                    + 2 * ny * (32 * dp + 16)) <= SMEM_MAX


@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", DEIT_M)
def test_pre_hopper_plans_cover_rows(dp, m):
    """Every row of a launch lies in exactly one block's run of 128-row
    tiles, with no block empty and no more blocks than SMs (K14 at each
    Dp, K8 where it takes the Hopper form)."""
    plans = [vit_pre_bf16_plan(dp, m, H100_SMS)[3:]]
    if vit_pre_w4a8_form(dp) == "hopper":
        plans.append(vit_pre_w4a8_plan(dp, m, H100_SMS)[4:])
    for grid, rows in plans:
        assert grid <= H100_SMS and rows >= 64
        assert _walk(grid, rows, m) == list(range(m))


def test_pre_hopper_form_rules():
    """K8 takes its Hopper form at Dp 128 and 192 (the resident weight) and
    K14 at Dp 128, 192 and 256; every other Dp (multiples of 64 up to 512)
    runs the first form, with an all-zero plan. K14's rule and plan are
    K11's."""
    dps = range(64, 513, 64)
    assert [dp for dp in dps if vit_pre_w4a8_form(dp) == "hopper"] == [128, 192]
    assert [dp for dp in dps if vit_pre_bf16_form(dp) == "hopper"] == [128, 192, 256]
    for dp in (64, 256, 320, 512):
        assert vit_pre_w4a8_plan(dp, 1000, H100_SMS) == (0,) * 6
    for dp in (64, 320, 512):
        assert vit_pre_bf16_plan(dp, 1000, H100_SMS) == (0,) * 5
    assert vit_pre_bf16_plan is vb.vit_pre_w4_plan and vit_pre_bf16_form is vb.vit_pre_w4_form


# ---- K8: the producer's resident fill ----

PT, BATCH_UNITS = 96, 4   # K8's fill threads (warps 0-2), units a thread holds at once


def k8_fill(pk, dp):
    """K8's producer (vit_pre_iw.cuh) on the packed K-major weight pk (uint8
    [3 Dp, Dp / 2]): thread pt's loop over its units c = c0 + 96 i (c0 =
    pt, pt + 384, ..), unit c at row 8 (g / UPR) + c % 8 and packed bytes
    q = 16 (g % UPR) (g = c / 8, UPR = Dp / 32), its low nibbles
    sign-extended to columns q .., its high ones to Dp/2 + q ..; returns the
    resident copy decoded [3 Dp, Dp] int8 and the number of writes to each
    of its bytes."""
    n_rows, upr = 3 * dp, dp // 32
    units = n_rows * upr
    res = np.zeros(n_rows * dp, np.uint8)
    writes = np.zeros(n_rows * dp, np.int64)
    visits = np.zeros(units, np.int64)
    for pt in range(PT):
        for c0 in range(pt, units, PT * BATCH_UNITS):
            for i in range(BATCH_UNITS):
                c = c0 + PT * i
                if c >= units:
                    continue
                visits[c] += 1
                g = c >> 3
                n, q = 8 * (g // upr) + (c & 7), 16 * (g % upr)
                words = np.ascontiguousarray(pk[n, q: q + 16]).view("<u4")
                for off, vals in ((core_off(n, q, dp), nib_sx(words)),
                                  (core_off(n, dp // 2 + q, dp), nib_sx(words >> np.uint32(4)))):
                    res[off: off + 16] = vals.view(np.uint8)
                    writes[off: off + 16] += 1
    assert (visits == 1).all()
    idx = core_off(np.arange(n_rows)[:, None], np.arange(dp)[None, :], dp)
    return res[idx].view(np.int8), writes


@pytest.mark.parametrize("dp", [128, 192])
def test_k8_resident_fill_matches_reference(dp):
    """K8's producer writes every byte of K5's resident int8 weight exactly
    once, and what it writes is the reference's ``_unpack_halves_i8`` of
    the same packed bytes: column k < Dp/2 of row n the low half's
    [k, n], column Dp/2 + k the high half's (every nibble value, at Dp
    128 and 192: DeiT-Tiny's tight pads)."""
    rng = np.random.default_rng(1500 + dp)
    n = 3 * dp
    packed = rng.integers(0, 256, (dp // 2, n), dtype=np.uint8)   # the reference's [Kp/2, N]
    packed[0, :16] = np.arange(0, 256, 16, dtype=np.uint8) + np.arange(16, dtype=np.uint8)
    got, writes = k8_fill(np.ascontiguousarray(packed.T), dp)
    assert (writes == 1).all()
    lo, hi = (np.asarray(h) for h in _unpack_halves_i8(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, np.concatenate([lo, hi]).T)


@pytest.mark.parametrize("ydt", ["bfloat16", "float32"])
def test_k8_resident_sums_equal_reference(ydt):
    """The int32 sums K8's consumers take over the resident copy (the codes
    of LN1 against its columns, exact in any order) equal the reference's
    ``_dot_w4a8`` on the same codes and packed bytes, and with the
    epilogue they give ``vit_block_pre_plain`` on the W4A8 pack bit for bit
    (Dp 192 with d_valid 160, 120 rows)."""
    rng = np.random.default_rng(1510 + (ydt == "float32"))
    dp, d, rows = 192, 160, 120
    n = 3 * dp
    w = rng.integers(-8, 8, (dp, n)).astype(np.int8)               # [K, N]
    w[d:] = 0
    pk = pack_halves_kmajor(torch.from_numpy(w), dp, n)            # K-major [N, Kp/2]
    s = (rng.uniform(0.5, 1.5, n) / (40.0 * 4.6 * np.sqrt(dp))).astype(np.float32)
    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    blk = {"wqkv": pk, "sqkv": torch.from_numpy(s),
           "bqkv": torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)),
           "ln1": torch.from_numpy(ln), "inv_act": (40.0, 30.0, 40.0, 30.0)}
    x = rng.normal(0, 1, (2, rows // 2, dp)).astype(np.float32)
    x[..., d:] = 0
    y = torch.from_numpy(x).to(getattr(torch, ydt))
    h1 = vb._ln_f32(y.float().reshape(-1, dp), blk["ln1"][0], blk["ln1"][1], d)
    codes = vb._quant_i8(h1, 40.0).numpy().astype(np.int64)
    res, _ = k8_fill(pk.numpy(), dp)
    acc = codes @ res.astype(np.int64).T
    ref = jax.jit(lambda q, p: _dot_w4a8(q, p, jnp.float32(1.0), jnp.float32(0.0)))(
        jnp.asarray(codes.astype(np.int8)), jnp.asarray(np.ascontiguousarray(pk.numpy().T)))
    np.testing.assert_array_equal(acc.astype(np.float32), np.asarray(ref))
    got = vb._epi(torch.from_numpy(acc.astype(np.float32)), blk["sqkv"], blk["bqkv"])
    assert torch.equal(got.to(torch.bfloat16).reshape(2, rows // 2, n),
                       vit_block_pre_plain(y, blk, d))


# ---- K14: the TMA boxes and the swizzled descriptors ----

def sw128(addr):
    """The 128-byte swizzle of a shared-memory byte address: its 16-byte
    chunk (bits 4-6) XORed with its row in the 1,024-byte atom (bits 7-9),
    as the TMA engine writes a box and wgmma reads a descriptor."""
    return addr ^ (((addr >> 7) & 7) << 4)


def k14_box(w_bytes, n0, k0):
    """K14's producer's TMA box for a stage: bytes 2 k0 .. 2 k0 + 127 of
    weight rows n0 .. n0 + 191 (w_bytes: the bf16 weight as uint8 [3 Dp,
    2 Dp]), row r's byte b landing at sw128(128 r + b) of a 1,024-byte
    aligned stage."""
    stage = np.zeros(192 * 128, np.uint8)
    r, b = np.meshgrid(np.arange(192), np.arange(128), indexing="ij")
    stage[sw128(128 * r + b)] = w_bytes[n0 + r, 2 * k0 + b]
    return stage


def k14_read(stage, kk):
    """What k16 step kk of a consumer's wgmma reads from the stage through
    its descriptor (start + 32 kk, leading byte offset unused, stride 1,024
    bytes between 8-row groups, 128-byte swizzle): [192, 16] bf16 (as
    float32 values) of B."""
    r, j = np.meshgrid(np.arange(192), np.arange(32), indexing="ij")
    addr = 32 * kk + (r >> 3) * 1024 + (r & 7) * 128 + j
    bts = stage[sw128(addr)].astype(np.uint32)
    bits = bts[:, 0::2] | (bts[:, 1::2] << 8)
    return (bits << 16).view(np.float32)


def _bf16_weight(rng, n, k):
    w = _bf16(rng.normal(0, 1.0 / np.sqrt(k), (n, k)).astype(np.float32))
    return w, np.ascontiguousarray((w.view(np.uint32) >> 16).astype("<u2")).view(np.uint8)


@pytest.mark.parametrize("dp", [128, 192, 256])
def test_k14_stages_cover_weight_in_consumer_order(dp):
    """K14's stages (per 192-column slice, K values k0 = 0, 64, ..) land
    the weight so that k16 step kk of each stage reads weight columns k0 +
    16 kk .. of the slice's rows, which are h1's columns the consumer
    pairs with that step (acol = k0 + 16 kk): every (row, K value) of wqkv
    is read exactly once, in the consumers' slice-major, K-ascending
    order, bit for bit."""
    rng = np.random.default_rng(1520 + dp)
    w, wb = _bf16_weight(rng, 3 * dp, dp)
    seen = np.zeros((3 * dp, dp), int)
    order = []
    for n0 in range(0, 3 * dp, 192):
        for k0 in range(0, dp, 64):
            stage = k14_box(wb, n0, k0)
            for kk in range(4):
                acol = k0 + 16 * kk                     # vit_pre_hw.cuh: acol (K14)
                got = k14_read(stage, kk)
                np.testing.assert_array_equal(got.view(np.uint32),
                                              w[n0: n0 + 192, acol: acol + 16].view(np.uint32))
                seen[n0: n0 + 192, acol: acol + 16] += 1
                order.append((n0, acol))
    assert (seen == 1).all()
    assert order == sorted(order)


@pytest.mark.parametrize("ydt", ["bfloat16", "float32"])
def test_k14_body_order_against_plain(ydt):
    """K14's Hopper body in numpy, in its order (Dp 128 with d_valid 96,
    300 rows): h1 = bf16(LN1) in the first form's lane order, then per
    192-column slice and stage the four k16 steps read through the
    swizzled descriptors, each step's 16 exact products summed and rounded
    to fp32 once and added in fp32, then bf16(fma(acc, 1, b)). Within
    BF16_TOL of the plain version (exact sums, rounded once)."""
    rng = np.random.default_rng(1530 + (ydt == "float32"))
    dp, d, rows = 128, 96, 300
    n = 3 * dp
    w, wb = _bf16_weight(rng, n, dp)
    w[:, d:] = 0
    wb = np.ascontiguousarray((w.view(np.uint32) >> 16).astype("<u2")).view(np.uint8)
    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    b = rng.normal(0, 0.1, n).astype(np.float32)
    blk = {"wqkv": torch.from_numpy(w).to(torch.bfloat16), "bqkv": torch.from_numpy(b),
           "ln1": torch.from_numpy(ln)}
    x = rng.normal(0, 1, (3, rows // 3, dp)).astype(np.float32)
    x[..., d:] = 0
    y = torch.from_numpy(x).to(getattr(torch, ydt))
    h1 = _ln_lanes(y.float().reshape(-1, dp).numpy(), ln[0], ln[1], d)
    acc = np.zeros((rows, n), np.float32)
    for n0 in range(0, n, 192):
        for k0 in range(0, dp, 64):
            stage = k14_box(wb, n0, k0)
            for kk in range(4):
                col = k0 + 16 * kk
                step = h1[:, col: col + 16].astype(np.float64) @ \
                    k14_read(stage, kk).astype(np.float64).T
                acc[:, n0: n0 + 192] = _f32(acc[:, n0: n0 + 192] + _f32(step))
    got = torch.from_numpy(_f32(acc.astype(np.float64) * 1.0 + b)).to(torch.bfloat16)
    plain = vit_block_pre_bf16_plain(y, blk, d).reshape(-1, n)
    diff = (got.float() - plain.float()).abs()
    assert float(diff.max()) <= BF16_TOL[1]
    assert float((diff == 0).float().mean()) >= BF16_TOL[0]
