"""K9's and K11's Hopper forms on the CPU: the launch plans and form rules
(``vit_post_w4a8_plan`` / ``_form``, ``vit_pre_w4_plan`` / ``_form``) at
DeiT-Tiny's shapes; each producer's stage unpack (``csrc/vit_post_iw.cuh``:
the int4 nibbles sign-extended to int8; ``csrc/vit_pre_w4.cu``: to exact
bf16), emulated bit for bit and placed in the core-matrix layout, against
the reference's own ``_unpack_halves_i8`` and ``_unpack_halves_bf16``; each
producer's stage sequence against the consumers' K steps (the K slots paired
across the packed halves); K11's tensor-core sum order in numpy against
its plain version; and K9's paired-chunk walk, with exact integer sums,
against its plain version bit for bit. The kernels compute the same plans
on the card; the card tests hold them to these functions."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops.pallas_vit_block import _unpack_halves_bf16, _unpack_halves_i8
from dlq_tpu_torch.ops import vit_block as vb
from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor
from dlq_tpu_torch.ops.vit_block import (
    SMEM_MAX, vit_block_post_plain, vit_block_pre_w4_plain, vit_post_w4a8_form,
    vit_post_w4a8_plan, vit_pre_w4_form, vit_pre_w4_plan,
)
from test_torch_port_post_h import W4A16_TOL, _bf16, _f32, _ln_lanes

H100_SMS = 132
DEIT_M = (1, 63, 64, 65, 72, 400, 51200)


# ---- the plans and the form rules ----

@pytest.mark.parametrize("dp,hp,m,want", [
    (192, 768, 256 * 200, (7, 226416, 132, 388)),   # DeiT-Tiny tight pads, batch 256
    (256, 768, 256 * 256, (3, 231472, 132, 497)),   # loose pads: three stages
    (128, 384, 72, (8, 160896, 2, 64)),             # at least 64 rows a block
])
def test_vit_post_w4a8_plan_at_deit_shapes(dp, hp, m, want):
    """K9's plan is K7's: its int8 stages of Dp x 64 bytes, so its shared
    memory (z1, the codes, the GELU chunk's codes, the {s, s, b, b} rows,
    the ring and its mbarriers)."""
    got = vit_post_w4a8_plan(dp, hp, m, H100_SMS)
    assert got == want == vb.vit_post_w8_plan(dp, hp, m, H100_SMS)
    stages, smem = got[:2]
    assert smem == 128 * dp * 5 + 128 * 64 + (2 * dp + hp) * 8 + stages * (dp * 64 + 16)


@pytest.mark.parametrize("dp,m,want", [
    (192, 256 * 200, (4, 2, 227968, 132, 388)),   # DeiT-Tiny tight pads, batch 256
    (128, 256 * 200, (5, 2, 226448, 132, 388)),
    (256, 256 * 256, (3, 2, 229488, 132, 497)),   # loose pads
])
def test_vit_pre_w4_plan_at_deit_shapes(dp, m, want):
    """K11's plan: bf16 h1 for 128 rows, the {s, s, b, b} table, K5's
    output staging, weight stages of 192 columns x 128 bytes (32 packed
    bytes of each row unpacked to bf16) and two y stages a consumer."""
    got = vit_pre_w4_plan(dp, m, H100_SMS)
    assert got == want
    stages, ny, smem = got[:3]
    assert smem == (128 * dp * 2 + 3 * dp * 8 + 2 * 8 * 8 * 400 + stages * (192 * 128 + 16)
                    + 2 * ny * (32 * dp + 16))


def _walk(grid, rows, m):
    """Every row the blocks' contiguous runs cover, walked in 128-row tiles
    split 64 / 64 between the two consumers, in the order they take them."""
    seen = []
    for b in range(grid):
        m_begin, m_end = b * rows, min(m, (b + 1) * rows)
        assert m_end > m_begin
        for m0 in range(m_begin, m_end, 128):
            for cw in (0, 1):
                r0 = m0 + 64 * cw
                seen += range(r0, r0 + max(0, min(64, m_end - r0)))
    return seen


@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", DEIT_M)
def test_w4_hopper_plans_cover_rows(dp, m):
    """At DeiT-Tiny's Hp both plans have 3 to 8 ring stages within the
    opt-in shared memory (K11 also 2 to 4 y stages a consumer), and their
    blocks' runs cover every row once, with no block empty and no more
    blocks than SMs."""
    stages, smem, grid, rows = vit_post_w4a8_plan(dp, 768, m, H100_SMS)
    assert 3 <= stages <= 8 and smem <= SMEM_MAX and grid <= H100_SMS and rows >= 64
    assert _walk(grid, rows, m) == list(range(m))
    stages, ny, smem, grid, rows = vit_pre_w4_plan(dp, m, H100_SMS)
    assert 3 <= stages <= 8 and 2 <= ny <= 4 and smem <= SMEM_MAX
    assert grid <= H100_SMS and rows >= 64
    assert _walk(grid, rows, m) == list(range(m))


def test_w4_hopper_form_rules():
    """K9's Hopper form takes Dp 128, 192 and 256 where Hp is a multiple of
    the 64-lane chunk and the ring holds at least 3 stages (not Dp 256 at
    Hp 1024: 2 stages); K11's takes Dp 128, 192 and 256. Every other Dp
    (multiples of 64 up to 512) runs the first form, with an all-zero plan."""
    for hp in (384, 768):
        assert [dp for dp in range(64, 513, 64) if vit_post_w4a8_form(dp, hp) == "hopper"] == \
            [128, 192, 256]
    assert vit_post_w4a8_form(256, 1024) == "first" and vit_post_w4a8_form(192, 96) == "first"
    assert vit_post_w4a8_plan(256, 1024, 1000, H100_SMS) == (0, 0, 0, 0)
    assert vit_post_w4a8_plan(320, 768, 1000, H100_SMS) == (0, 0, 0, 0)
    assert [dp for dp in range(64, 513, 64) if vit_pre_w4_form(dp) == "hopper"] == [128, 192, 256]
    assert vit_pre_w4_plan(64, 1000, H100_SMS) == (0, 0, 0, 0, 0)
    assert vit_pre_w4_plan(320, 1000, H100_SMS) == (0, 0, 0, 0, 0)


# ---- the producers' stage unpack, bit for bit ----

def core_off(r, k, kb):
    """Byte offset of (row r, K byte k) in a K-major tile kb bytes wide, in
    8-row x 16-byte core matrices (sm90.cuh: core_off)."""
    return ((r >> 3) * (kb >> 4) + (k >> 4)) * 128 + (r & 7) * 16 + (k & 15)


def _units(rows):
    """The producer's 16-byte packed units of a stage: unit u -> (row n,
    unit j of the row), eight consecutive threads on eight rows."""
    u = np.arange(2 * rows)
    grp = u >> 3
    return (u & 7) + 8 * (grp >> 1), grp & 1


def nib_sx(w):
    """igemm.cuh's nib_sx on uint32 words: the low nibble of each byte
    sign-extended to the byte, x | (bit 3 of x) x 30 per byte."""
    x = w & np.uint32(0x0F0F0F0F)
    return (x | (x & np.uint32(0x08080808)) * np.uint32(30)).astype(np.uint32)


def k9_stage(packed, src_rows, b0):
    """K9's producer (vit_post_iw.cuh) on one stage: packed bytes b0 ..
    b0 + 31 of weight rows ``src_rows`` (packed uint8 [N, Kp/2]) written
    as the kernel writes them (the low nibbles' int8 at the unit's core-
    matrix offset, the high ones' 256 bytes on); returns the stage decoded
    [rows, 64] int8 (K slots)."""
    rows = len(src_rows)
    stage = np.zeros(rows * 64, np.uint8)
    n, j = _units(rows)
    for nn, jj in zip(n, j):
        words = np.ascontiguousarray(packed[src_rows[nn], b0 + 16 * jj: b0 + 16 * jj + 16]).view("<u4")
        off = core_off(nn, 16 * jj, 64)
        stage[off: off + 16] = nib_sx(words).view(np.uint8)
        stage[off + 256: off + 272] = nib_sx(words >> 4).view(np.uint8)
    return stage[core_off(np.arange(rows)[:, None], np.arange(64)[None, :], 64)].view(np.int8)


def nib2_bf16(v):
    """hgemm.cuh's nib2_bf16 on one 16-bit lane: (nibble ^ 0x4308) read as
    bf16 is 136 + nibble (signed), minus 136 in bf16 (exact)."""
    bits = ((v & 0xF) ^ 0x4308).astype(np.uint32) << 16
    return _f32(bits.view(np.float32) - np.float32(136.0))


def k11_stage(packed, n0, b0):
    """K11's producer (vit_pre_w4.cu) on one stage: packed bytes b0 .. b0 +
    31 of weight rows n0 .. n0 + 191, each unit unpacked as unpack16 does
    (the low nibbles' 16 bf16 at the unit's offset and 128 bytes on, the
    high ones' 512 and 640 bytes on); returns the stage decoded [192, 64]
    (K slots, as float32 values of the bf16 bits)."""
    stage = np.zeros(192 * 128, np.uint8)
    n, j = _units(192)
    for nn, jj in zip(n, j):
        unit = packed[n0 + nn, b0 + 16 * jj: b0 + 16 * jj + 16].astype(np.uint32)
        off = core_off(nn, 32 * jj, 128)
        for sh, base in ((0, off), (4, off + 512)):
            vals = _bf16(nib2_bf16(unit >> sh)).view(np.uint32) >> 16   # bf16 bits, bytes 0-15
            b = vals.astype("<u2").view(np.uint8)
            stage[base: base + 16] = b[:16]              # bytes 0-7 of the unit
            stage[base + 128: base + 144] = b[16:]       # bytes 8-15
    idx = core_off(np.arange(192)[:, None], 2 * np.arange(64)[None, :], 128)
    lo = stage[idx].astype(np.uint32)
    hi = stage[idx + 1].astype(np.uint32)
    return ((lo | (hi << 8)) << 16).view(np.float32)


@pytest.mark.parametrize("kh,n", [(96, 192), (64, 256), (128, 256), (384, 192)])
def test_k9_stage_unpack_matches_reference(kh, n):
    """Every stage K9's producer writes (packed bytes b0 .. b0 + 31 of every
    row) holds the reference's ``_unpack_halves_i8``: K slots 0-31 its low
    half at K values b0 .., slots 32-63 its high half (b0 + Kp/2 ..); every
    byte value, at DeiT-Tiny's proj / FC1 (Kp/2 = 96) and FC2 (384) rows
    and the small and loose pads."""
    rng = np.random.default_rng(kh + n)
    packed = rng.integers(0, 256, (kh, n), dtype=np.uint8)   # the reference's [Kp/2, N]
    packed[0, :16] = np.arange(0, 256, 16, dtype=np.uint8) + np.arange(16, dtype=np.uint8)
    lo, hi = (np.asarray(h) for h in _unpack_halves_i8(jnp.asarray(packed)))
    pk = np.ascontiguousarray(packed.T)                     # K-major [N, Kp/2]
    rows = np.arange(min(n, 192))
    for b0 in range(0, kh, 32):
        got = k9_stage(pk, rows, b0)
        np.testing.assert_array_equal(got[:, :32], lo[b0: b0 + 32, rows].T)
        np.testing.assert_array_equal(got[:, 32:], hi[b0: b0 + 32, rows].T)


@pytest.mark.parametrize("kh", [64, 96, 128])
def test_k11_stage_unpack_matches_reference(kh):
    """Every stage K11's producer writes (a 192-column slice, packed bytes
    b0 .. b0 + 31 of each row) holds the reference's
    ``_unpack_halves_bf16`` bit for bit: K slots 0-31 the low half at K
    values b0 .., slots 32-63 the high half (Dp/2 + b0 ..), at Dp 128, 192
    and 256 (3·Dp rows: every slice)."""
    rng = np.random.default_rng(kh)
    n = 6 * kh
    packed = rng.integers(0, 256, (kh, n), dtype=np.uint8)
    packed[0, :16] = np.arange(0, 256, 16, dtype=np.uint8) + np.arange(16, dtype=np.uint8)
    lo, hi = (np.asarray(h.astype(jnp.float32)) for h in _unpack_halves_bf16(jnp.asarray(packed)))
    pk = np.ascontiguousarray(packed.T)
    for n0 in range(0, n, 192):
        for b0 in range(0, kh, 32):
            got = k11_stage(pk, n0, b0)
            want = np.concatenate([lo[b0: b0 + 32, n0: n0 + 192], hi[b0: b0 + 32, n0: n0 + 192]]).T
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- the producers' stage sequences against the consumers' K steps ----

def k9_stages(dp, hp):
    """K9's producer's stages for one tile, in its order: (weight, source
    rows, first packed byte), and the consumer's A column of each K slot
    (vit_post_iw.cuh: acol for proj and FC1; FC2 reads the GELU chunk's
    codes, whose column n is hidden lane hid(c0, n))."""
    out = []
    slot = np.arange(64)

    def acol(k):   # the codes' columns of a stage's K slots (k: its K byte)
        return np.where(slot < 32, k // 2 + slot, dp // 2 + k // 2 + slot - 32)

    for k in range(0, dp, 64):
        out.append(("proj", np.arange(dp), k // 2, acol(k)))
    for c in range(0, hp // 2, 32):
        hid = np.where(slot < 32, c + slot, c + hp // 2 - 32 + slot)
        for k in range(0, dp, 64):
            out.append(("fc1", hid, k // 2, acol(k)))
        out.append(("fc2", np.arange(dp), c, hid))
    return out


@pytest.mark.parametrize("dp,hp", [(128, 384), (192, 768), (256, 768)])
def test_k9_stages_cover_weights_in_consumer_order(dp, hp):
    """K9's stages cover every (row, K value) of wproj, wfc1 and wfc2
    exactly once, each K slot's value is the consumer's A column for it
    (so every k32 step pairs the right codes), the stage counts are the
    consumers' (Dp/64 for proj and for each chunk's FC1, one for its FC2),
    and FC1's rows of a chunk are FC2's K values of the same chunk."""
    kvals = {"proj": dp, "fc1": dp, "fc2": hp}
    seen = {"proj": np.zeros((dp, dp), int), "fc1": np.zeros((hp, dp), int),
            "fc2": np.zeros((dp, hp), int)}
    stages = k9_stages(dp, hp)
    assert len(stages) == dp // 64 + (hp // 64) * (dp // 64 + 1)
    fc1_rows = None
    for name, rows, b0, acol in stages:
        kh = kvals[name] // 2
        k = np.where(np.arange(64) < 32, b0 + np.arange(64), kh + b0 + np.arange(64) - 32)
        assert b0 + 32 <= kh
        np.testing.assert_array_equal(acol, k)
        if name == "fc1":
            fc1_rows = rows
        if name == "fc2":
            np.testing.assert_array_equal(acol, fc1_rows)
        np.add.at(seen[name], (rows[:, None], k[None, :]), 1)
    assert all((c == 1).all() for c in seen.values())


@pytest.mark.parametrize("dp", [128, 192, 256])
def test_k11_stages_cover_weight_in_consumer_order(dp):
    """K11's stages (192-column slices by 32 packed bytes) cover every
    (row, K value) of wqkv once, in the consumers' order (slice by slice,
    Dp/64 stages a slice), and k16 step kk of a stage reads h1's columns
    acol(b0, kk) .. + 15, the K values of its slots 16 kk .. 16 kk + 15."""
    kh = dp // 2
    seen = np.zeros((3 * dp, dp), int)
    order = []
    for n0 in range(0, 3 * dp, 192):
        for b0 in range(0, kh, 32):
            order.append(n0)
            for kk in range(4):
                col = (0 if kk < 2 else kh - 32) + b0 + 16 * kk   # vit_pre_w4.cu: acol
                slots = 16 * kk + np.arange(16)
                k = np.where(slots < 32, b0 + slots, kh + b0 + slots - 32)
                np.testing.assert_array_equal(col + np.arange(16), k)
                np.add.at(seen, (np.arange(n0, n0 + 192)[:, None], k[None, :]), 1)
    assert (seen == 1).all()
    assert order == sorted(order) and len(order) == (3 * dp // 192) * (kh // 32)


# ---- the bodies' arithmetic ----

def _w4_layer(rng, dp, hp, d, a8):
    """A K8/K9 (``a8``) or K11/K12 layer at Dp/Hp: int4 weights
    halves-packed K-major, per-OC scales near unit outputs, biases and LN
    rows, every lane past d_valid zero."""
    blk = {}
    for name, (n, k) in (("qkv", (3 * dp, dp)), ("proj", (dp, dp)), ("fc1", (hp, dp)),
                         ("fc2", (dp, hp))):
        w = rng.integers(-8, 8, (k, n)).astype(np.int8)
        unit = 40.0 * 4.6 if a8 else 4.6   # int8 codes ~40 rms, bf16 activations ~1
        s = (rng.uniform(0.5, 1.5, n) / (unit * math.sqrt(k))).astype(np.float32)
        b = rng.normal(0, 0.1, n).astype(np.float32)
        if k == dp:
            w[d:] = 0
        if name != "fc1":   # output lanes past d_valid (each of q, k, v's)
            pad = np.arange(n) % dp >= d
            w[:, pad], s[pad], b[pad] = 0, 0, 0
        blk["w" + name] = pack_halves_kmajor(torch.from_numpy(w), k, n)
        blk["s" + name], blk["b" + name] = torch.from_numpy(s), torch.from_numpy(b)
    for name in ("ln1", "ln2"):
        ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
        ln[:, d:] = 0
        blk[name] = torch.from_numpy(ln)
    if a8:
        blk["inv_act"] = (40.0, 30.0, 40.0, 30.0)
    return blk


def _stream(rng, shape, d):
    x = rng.normal(0, 1, shape).astype(np.float32)
    x[..., d:] = 0
    return torch.from_numpy(x)


@pytest.mark.parametrize("ydt", ["bfloat16", "float32"])
def test_k11_body_order_against_plain(ydt):
    """K11's Hopper body in numpy, in its order (Dp 128 with d_valid 96,
    300 rows): h1 = bf16(LN1) in the first form's lane order, then per
    192-column slice and stage the four k16 steps (K values b0 .., b0 + 16
    .., Dp/2 + b0 .., Dp/2 + b0 + 16 ..), each step's 16 exact products
    summed and rounded to fp32 once and added in fp32, then bf16(fma(acc,
    s, b)) from the stages the producer writes. Within W4A16_TOL of the
    plain version (exact sums, rounded once) on every output."""
    rng = np.random.default_rng(1400 + (ydt == "float32"))
    dp, d, rows = 128, 96, 300
    blk = _w4_layer(rng, dp, 256, d, False)
    y = _stream(rng, (3, rows // 3, dp), d).to(getattr(torch, ydt))
    x = y.reshape(-1, dp).float().numpy()
    ln = blk["ln1"].numpy()
    h1 = _ln_lanes(x, ln[0], ln[1], d)                   # bf16 values
    pk = blk["wqkv"].numpy()
    kh = dp // 2
    acc = np.zeros((x.shape[0], 3 * dp), np.float32)
    for n0 in range(0, 3 * dp, 192):
        for b0 in range(0, kh, 32):
            st = k11_stage(pk, n0, b0).astype(np.float64)   # [192, 64]
            for kk in range(4):
                col = (0 if kk < 2 else kh - 32) + b0 + 16 * kk
                step = h1[:, col: col + 16].astype(np.float64) @ st[:, 16 * kk: 16 * kk + 16].T
                acc[:, n0: n0 + 192] = _f32(acc[:, n0: n0 + 192] + _f32(step))
    s, b = blk["sqkv"].numpy(), blk["bqkv"].numpy()
    got = torch.from_numpy(_f32(acc.astype(np.float64) * s + b)).to(torch.bfloat16)
    plain = vit_block_pre_w4_plain(y, blk, d).reshape(-1, 3 * dp)
    diff = (got.float() - plain.float()).abs()
    frac, max_diff = W4A16_TOL["bf16"]
    assert float(diff.max()) <= max_diff
    assert float((diff == 0).float().mean()) >= frac


@pytest.mark.parametrize("gelu_tanh", [True, False])
@pytest.mark.parametrize("ydt,odt", [("bfloat16", "bfloat16"), ("float32", "float32")])
def test_k9_paired_walk_equals_plain(gelu_tanh, ydt, odt):
    """K9's Hopper walk (Dp 128 with d_valid 96, Hp 256, 200 rows): proj's
    int32 sums over the producer's stages, two k32 steps each on the
    paired code columns; per hidden chunk (lanes c .. c + 31 and c + Hp/2
    ..) FC1's sums over its stages, bias, GELU and int8 codes in the
    chunk's column order, FC2's sums accumulated chunk by chunk on the
    paired stages; then z1 + fma(acc, s, b). Every sum is an exact integer
    and each elementwise step is the plain version's own, so the output
    equals ``vit_block_post_plain`` with ``multi`` bit for bit."""
    rng = np.random.default_rng(1410 + 2 * gelu_tanh + (ydt == "float32"))
    dp, hp, d, rows = 128, 256, 96, 200
    blk = _w4_layer(rng, dp, hp, d, True)
    y = _stream(rng, (2, rows // 2, dp), d).to(getattr(torch, ydt))
    attn = _stream(rng, (2, rows // 2, dp), d).to(torch.bfloat16)
    inv = blk["inv_act"]
    pk = {k: blk[k].numpy() for k in ("wproj", "wfc1", "wfc2")}

    def sums(codes, wname, src_rows, b0s):
        """The int sums of the code columns against the stages at b0s."""
        acc = np.zeros((codes.shape[0], len(src_rows)), np.int64)
        kh = pk[wname].shape[1]
        for b0 in b0s:
            st = k9_stage(pk[wname], src_rows, b0).astype(np.int64)
            acc += codes[:, b0: b0 + 32] @ st[:, :32].T
            acc += codes[:, kh + b0: kh + b0 + 32] @ st[:, 32:].T
        return torch.from_numpy(acc.astype(np.float32))   # exact: |acc| < 2^24

    xf = y.reshape(-1, dp).float()
    a_codes = vb._quant_i8(attn.reshape(-1, dp).float(), inv[1]).numpy().astype(np.int64)
    z1 = xf + vb._epi(sums(a_codes, "wproj", np.arange(dp), range(0, dp // 2, 32)),
                      blk["sproj"], blk["bproj"])
    h2 = vb._ln_f32(z1, blk["ln2"][0], blk["ln2"][1], d)
    l_codes = vb._quant_i8(h2, inv[2]).numpy().astype(np.int64)
    acc2 = np.zeros((xf.shape[0], dp), np.int64)
    slot = np.arange(64)
    for c in range(0, hp // 2, 32):
        hid = np.where(slot < 32, c + slot, c + hp // 2 - 32 + slot)
        acc1 = sums(l_codes, "wfc1", hid, range(0, dp // 2, 32))
        f = vb._epi(acc1, blk["sfc1"][hid], blk["bfc1"][hid])
        g_codes = vb._quant_i8(vb._gelu_f32(f, gelu_tanh), inv[3]).numpy().astype(np.int64)
        st = k9_stage(pk["wfc2"], np.arange(dp), c).astype(np.int64)
        acc2 += g_codes @ st.T
    out = z1 + vb._epi(torch.from_numpy(acc2.astype(np.float32)), blk["sfc2"], blk["bfc2"])
    got = out.to(getattr(torch, odt)).reshape(y.shape)
    plain = vit_block_post_plain(y, attn, blk, d, gelu_tanh, getattr(torch, odt), True)
    assert torch.equal(got, plain)
