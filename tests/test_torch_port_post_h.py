"""K12's and K15's Hopper form (``csrc/vit_post_hw.cuh``) on the CPU: the
unpack of K12's int4 weight stages against the reference's cache-unpack,
the launch plan and form rule (``vit_post_h_plan``, ``vit_post_h_form``) at
DeiT-Tiny's shapes, the producer's stages against the consumers' K steps,
the FC1-sums-as-FC2-operand register mapping, and the body's order of
arithmetic emulated in numpy against the plain versions. The kernels
compute the same plans on the card; the card tests hold them to these
functions."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops.pallas_vit_block import _unpack_halves_bf16
from dlq_tpu_torch.ops import vit_block as vb
from dlq_tpu_torch.ops.layernorm import ln_f32
from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor
from dlq_tpu_torch.ops.vit_block import (
    K15_STAGE_K, SMEM_MAX, unpack_w4_bf16, vit_block_post_bf16_plain, vit_block_post_w4_plain,
    vit_post_h_form, vit_post_h_plan,
)

H100_SMS = 132
# the kernels' tolerances against their plain versions (chip_smoke.py):
# (fraction of outputs equal, largest difference), or (fraction within
# near x (1 + |plain|), largest difference, near) for fp32 outputs
BF16_TOL = (0.997, 0.0625)
W4A16_TOL = {"bf16": (0.999, 0.0625), "fp32": (0.999, 0.0625, 2.0 ** -12)}


# ---- the unpack: K12's producer writes the reference's bf16 scratches ----

@pytest.mark.parametrize("kh,n", [(96, 192), (96, 768), (384, 192), (64, 128), (128, 256)])
def test_unpack_w4_bf16_matches_reference(kh, n):
    """``unpack_w4_bf16`` (the plain version of K12's Hopper stage unpack)
    is bit-identical to ``_unpack_halves_bf16`` (low halves, then high
    halves along K), K-major: every byte value, at DeiT-Tiny's proj / FC1
    (Kp/2 = 96), FC2 (384) and the loose and small pads."""
    rng = np.random.default_rng(kh + n)
    packed = rng.integers(0, 256, (kh, n), dtype=np.uint8)   # the reference's [Kp/2, N]
    packed[0, :16] = np.arange(0, 256, 16, dtype=np.uint8) + np.arange(16, dtype=np.uint8)
    lo, hi = _unpack_halves_bf16(jnp.asarray(packed))
    ref = np.asarray(jnp.concatenate([lo, hi], axis=0).astype(jnp.float32))   # [Kp, N]
    got = unpack_w4_bf16(torch.from_numpy(np.ascontiguousarray(packed.T)))     # [N, Kp]
    assert got.dtype == torch.bfloat16 and got.shape == (n, 2 * kh)
    np.testing.assert_array_equal(got.float().numpy().T.view(np.uint32), ref.view(np.uint32))


# ---- the plan and the form rule ----

@pytest.mark.parametrize("dp,hp,m,want", [
    (192, 768, 256 * 200, (64, 6, 230496, 132, 388)),   # K12 and K15 tight pads, batch 256
    (256, 768, 256 * 256, (32, 3, 231472, 132, 497)),   # K15 loose pads, batch 256
    (128, 384, 72, (64, 8, 169088, 2, 64)),             # at least 64 rows a block
])
def test_vit_post_h_plan_at_deit_shapes(dp, hp, m, want):
    """The plan at DeiT-Tiny's shapes: z1 (fp32) and the bf16 A operand for
    128 rows, the {s, s, b, b} rows, and the ring: six 192 x 64-byte stages
    at the tight pads, three 256 x 32-byte stages (one k16 step each) at the
    loose pads, the GELU chunk in registers."""
    got = vit_post_h_plan(dp, hp, m, H100_SMS)
    assert got == want
    ks, stages, smem = got[:3]
    assert smem == 128 * dp * 4 + 128 * dp * 2 + (2 * dp + hp) * 8 + stages * (dp * ks + 16)


@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200, 65536])
def test_vit_post_h_plan_covers_rows(dp, m):
    """At DeiT's Hp the ring has 3 to 8 stages within the opt-in shared
    memory, and the blocks' contiguous runs, walked in 128-row tiles split 64
    / 64 between the consumers, cover every row once with no block empty
    and no more blocks than SMs."""
    ks, stages, smem, grid, rows = vit_post_h_plan(dp, 768, m, H100_SMS)
    assert ks == K15_STAGE_K[dp] and 3 <= stages <= 8 and smem <= SMEM_MAX
    assert grid <= H100_SMS and rows >= 64
    seen = []
    for b in range(grid):
        m_begin, m_end = b * rows, min(m, (b + 1) * rows)
        assert m_end > m_begin
        for m0 in range(m_begin, m_end, 128):
            for cw in (0, 1):
                r0 = m0 + 64 * cw
                seen += range(r0, r0 + max(0, min(64, m_end - r0)))
    assert seen == list(range(m))


def test_vit_post_h_form_rule():
    """The Hopper form takes Dp 128, 192 and 256 at DeiT-Tiny's Hp (and at
    the card tests' 384); every other Dp (multiples of 64 up to 512) and a
    Dp whose ring would hold fewer than 3 stages (Dp 256 at Hp 1024) run the
    first form, with an all-zero plan."""
    for hp in (384, 768):
        assert [dp for dp in range(64, 513, 64) if vit_post_h_form(dp, hp) == "hopper"] == \
            [128, 192, 256]
    assert vit_post_h_form(256, 1024) == "first" and vit_post_h_form(192, 32) == "first"
    assert vit_post_h_plan(256, 1024, 1000, H100_SMS) == (0, 0, 0, 0, 0)
    assert vit_post_h_plan(64, 768, 1000, H100_SMS) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("dp,hp", [(128, 384), (192, 768), (256, 768)])
def test_vit_post_h_stages_cover_k(dp, hp):
    """The producer's stages, in its order, are the consumers' k16 steps:
    proj's stages cover K = Dp once (KS / 2 values each), each 64-lane
    chunk's FC1 stages (64 rows x KS·Dp/64 bytes) cover Dp once and its FC2
    stages cover the chunk's 64 hidden lanes once; a stage never straddles
    the halves split of K12's packed rows (Kp / 2), so each reads one nibble
    of consecutive bytes."""
    ks = K15_STAGE_K[dp]
    kb1 = ks * dp // 64
    stages = []
    stages += [("proj", k, ks // 2, dp) for k in range(0, dp, ks // 2)]
    for c in range(0, hp, 64):
        stages += [("fc1", k, kb1 // 2, dp) for k in range(0, dp, kb1 // 2)]
        stages += [("fc2", k, ks // 2, hp) for k in range(c, c + 64, ks // 2)]
    proj = [k for name, k0, n, _ in stages if name == "proj" for k in range(k0, k0 + n)]
    assert proj == list(range(dp))
    per_chunk = 2 * 128 // ks
    assert len(stages) == 2 * dp // ks + hp // 64 * per_chunk   # the consumers' count
    for i in range(hp // 64):
        chunk = stages[2 * dp // ks + i * per_chunk:][:per_chunk]
        fc1 = [k for name, k0, n, _ in chunk if name == "fc1" for k in range(k0, k0 + n)]
        fc2 = [k for name, k0, n, _ in chunk if name == "fc2" for k in range(k0, k0 + n)]
        assert fc1 == list(range(dp)) and fc2 == list(range(64 * i, 64 * i + 64))
    for _, k0, n, kp in stages:
        assert (k0 < kp // 2) == (k0 + n - 1 < kp // 2) and n % 16 == 0


def test_fc1_sums_are_fc2_register_operand():
    """Thread 32 w + 4 g + t's FC1 sums acc1[8 kk + 2 q + e] (the m64n64
    accumulator: d[4 j + q'] at row 16 w + g + 8 (q' >> 1), column 8 j + 2 t
    + (q' & 1)) are exactly the elements its register q of FC2's k16 step kk
    carries (wgmma's register A: rows 16 w + g (+ 8 for q odd), K 2 t + e
    (+ 8 for q >= 2) of the step): no shuffle between the two products."""
    for tid in range(128):
        w, g, t = tid >> 5, (tid & 31) >> 2, tid & 3
        for kk in range(4):
            for q in range(4):
                for e in range(2):
                    i = 8 * kk + 2 * q + e
                    j, qq = i // 4, i % 4
                    acc = (16 * w + g + 8 * (qq >> 1), 8 * j + 2 * t + (qq & 1))
                    frag = (16 * w + g + 8 * (q & 1), 16 * kk + 2 * t + e + 8 * (q >> 1))
                    assert acc == frag


# ---- the body's order of arithmetic, emulated in numpy ----

def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _bf16(x):
    """float32 -> bf16, round to nearest even, as float32 values."""
    u = _f32(x).view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


def _fma(a, s, b):
    return _f32(a.astype(np.float64) * s.astype(np.float64) + b.astype(np.float64))


def _k16(a, w, acc=None):
    """acc (fp32) += a [M, K] @ w [N, K]^T one k16 step at a time: each
    step's 16 exact products summed and rounded to fp32 once, the steps
    added in fp32 (the wgmma order the emulation stands for)."""
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32) if acc is None else acc
    for k in range(0, a.shape[1], 16):
        step = a[:, k:k + 16].astype(np.float64) @ w[:, k:k + 16].astype(np.float64).T
        acc = _f32(acc + _f32(step))
    return acc


def _ln_lanes(z, g, b, d_valid):
    """LN2 in the first form's lane order: lane l sums columns l + 32 j in
    j order (x and x·x in fp32), a xor butterfly over the 32 lanes, the two
    moments with 1/d_valid, ((x - mu) r) g + b, bf16."""
    m, dp = z.shape
    v = z.reshape(m, dp // 32, 32)
    s = np.zeros((m, 32), np.float32)
    sq = np.zeros((m, 32), np.float32)
    for j in range(dp // 32):
        s = _f32(s + v[:, j])
        sq = _f32(sq + _f32(v[:, j] * v[:, j]))
    for o in (16, 8, 4, 2, 1):
        perm = np.arange(32) ^ o
        s, sq = _f32(s + s[:, perm]), _f32(sq + sq[:, perm])
    inv_n = np.float32(1.0 / d_valid)
    mu = _f32(s[:, :1] * inv_n)
    var = np.maximum(_f32(_f32(sq[:, :1] * inv_n) - _f32(mu * mu)), np.float32(0))
    r = _f32(1.0 / np.sqrt(_f32(var + np.float32(1e-6)).astype(np.float64)))
    return _bf16(_f32(_f32(_f32(_f32(z - mu) * r) * g) + b))


def _gelu(f, tanh_approx):
    """GELU in fp32 steps; tanh and erfc from the plain version's library
    (``torch.tanh``, ``torch.erfc`` on fp32), so that both sides take the
    same value for an argument they share: numpy's fp32 tanh sits 1 to 2
    ulp from PyTorch's on about a third of this test's arguments, and the
    test holds the body's order of sums and roundings, not a tanh."""
    if tanh_approx:
        f3 = _f32(_f32(_f32(np.float32(0.044715) * f) * f) * f)
        th = torch.tanh(torch.from_numpy(_f32(np.float32(0.7978845608028654) * _f32(f + f3))))
        return _f32(_f32(np.float32(0.5) * f) * _f32(np.float32(1.0) + th.numpy()))
    erfc = torch.erfc(torch.from_numpy(_f32(-f * np.float32(0.7071067811865476)))).numpy()
    return _f32(_f32(np.float32(0.5) * f) * erfc)


def _hopper_body(y, attn, blk, d_valid, gelu_tanh, w4):
    """K12's (``w4``) or K15's Hopper body in numpy, in its order: proj's
    k16 sums into z1 (fp32), LN2 in lane order, then 64-lane hidden chunks:
    FC1's sums, bias and GELU rounded to bf16 (FC2's register operand), FC2's
    fp32 partial sums added chunk by chunk and step by step; FC2's residual
    in the format's association. Returns (the fp32 output, h2) as [M, Dp]."""
    def weight(name):
        w = blk[name]
        return (unpack_w4_bf16(w) if w4 else w).float().numpy()

    def scale(name, n):
        return blk[name].numpy() if w4 else np.ones(n, np.float32)

    wproj, wfc1, wfc2 = weight("wproj"), weight("wfc1"), weight("wfc2")
    dp, hp = wproj.shape[0], wfc1.shape[0]
    x = y.reshape(-1, dp).float().numpy()
    a = attn.reshape(-1, dp).float().numpy()
    z1 = _f32(x + _fma(_k16(a, wproj), scale("sproj", dp), blk["bproj"].numpy()))
    ln = blk["ln2"].numpy()
    h2 = _ln_lanes(z1, ln[0], ln[1], d_valid)
    s1, b1 = scale("sfc1", hp), blk["bfc1"].numpy()
    acc2 = np.zeros_like(z1)
    for c0 in range(0, hp, 64):
        acc1 = _k16(h2, wfc1[c0:c0 + 64])
        f = _bf16(_gelu(_fma(acc1, s1[c0:c0 + 64], b1[c0:c0 + 64]), gelu_tanh))
        acc2 = _k16(f, wfc2[:, c0:c0 + 64], acc2)
    b2 = blk["bfc2"].numpy()
    if w4:
        return _f32(z1 + _fma(acc2, scale("sfc2", dp), b2)), h2
    return _f32(_f32(z1 + acc2) + b2), h2


def _layer(rng, dp, hp, d, w4):
    """A K12 (int4, per-OC scales) or K15 (bf16) layer, zero past d_valid."""
    def w(n, k):
        if w4:
            q = rng.integers(-8, 8, (k, n)).astype(np.int8)
            q[d if k == dp else k:] = 0
            q[:, d if n == dp else n:] = 0
            return pack_halves_kmajor(torch.from_numpy(q), k, n)
        a = rng.normal(0, 1.0 / math.sqrt(k), (n, k)).astype(np.float32)
        a[:, d if k == dp else k:] = 0
        a[d if n == dp else n:] = 0
        return torch.from_numpy(a).to(torch.bfloat16)

    def s(n, k):
        return torch.from_numpy((rng.uniform(0.5, 1.5, n) / (4.6 * math.sqrt(k)))
                                .astype(np.float32))

    def b(n):
        v = rng.normal(0, 0.1, n).astype(np.float32)
        v[d if n == dp else n:] = 0
        return torch.from_numpy(v)

    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    blk = {"wproj": w(dp, dp), "bproj": b(dp), "ln2": torch.from_numpy(ln),
           "wfc1": w(hp, dp), "bfc1": b(hp), "wfc2": w(dp, hp), "bfc2": b(dp)}
    if w4:
        blk.update(sproj=s(dp, dp), sfc1=s(hp, dp), sfc2=s(dp, hp))
    return blk


@pytest.mark.parametrize("w4", [False, True], ids=["k15_bf16", "k12_w4"])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("gelu_tanh", [True, False])
def test_hopper_body_order_against_plain(w4, out, gelu_tanh):
    """The Hopper body's order (Dp 128 with d_valid 96, Hp 256, 300 rows)
    against the plain version (exact sums, rounded once): bf16 outputs
    within BF16_TOL (K15) and W4A16_TOL (K12), the largest difference of
    every output within 0.0625. fp32 outputs: W4A16_TOL's fraction within
    2^-12 x (1 + |plain|) over the rows whose LN2 output (bf16) agrees with
    the plain version's, and at most 1% of rows where it does not. LN2
    sums in the first form's lane order and the plain version in PyTorch's,
    so an LN2 value on a bf16 rounding boundary lands one step apart in
    about 1 row in 150 here; the bf16 GELU values then round apart across
    the row and move its fp32 outputs by up to ~0.008, past the near bound
    that DeiT-Tiny's 51,200-row layer (where chip_smoke.py applies it to
    every output) leaves room for. The first form shares that LN2 order."""
    rng = np.random.default_rng(1300 + 2 * w4 + gelu_tanh)
    dp, hp, d, rows = 128, 256, 96, 300
    blk = _layer(rng, dp, hp, d, w4)
    yn = rng.normal(0, 1, (3, rows // 3, dp)).astype(np.float32)
    yn[..., d:] = 0
    y = torch.from_numpy(yn).to(torch.bfloat16)
    an = rng.normal(0, 1, (3, rows // 3, dp)).astype(np.float32)
    an[..., d:] = 0
    attn = torch.from_numpy(an).to(torch.bfloat16)
    odt = getattr(torch, out)
    body, h2 = _hopper_body(y, attn, blk, d, gelu_tanh, w4)
    got = torch.from_numpy(body).reshape(y.shape).to(odt)
    plain = (vit_block_post_w4_plain if w4 else vit_block_post_bf16_plain)(
        y, attn, blk, d, gelu_tanh, odt)
    diff = (got.float() - plain.float()).abs()
    assert float(diff.max()) <= 0.0625
    z1 = y.float() + vb._epi(vb._hgemm(attn, blk["wproj"]), blk.get("sproj"), blk["bproj"])
    h2_plain = ln_f32(z1, blk["ln2"][0], blk["ln2"][1], d).to(torch.bfloat16)
    same = (torch.from_numpy(h2) == h2_plain.float().reshape(-1, dp)).all(1)
    if out == "float32":
        frac_ok, _, near = W4A16_TOL["fp32"]
        assert float(same.float().mean()) >= 0.99
        ok = (diff <= near * (1.0 + plain.float().abs())).reshape(-1, dp)[same]
        assert float(ok.float().mean()) >= frac_ok
    else:
        frac_ok, _ = W4A16_TOL["bf16"] if w4 else BF16_TOL
        equal = float((diff == 0).float().mean())
        assert equal >= frac_ok, (f"equal {equal:.5f}, LN2 apart in {int((~same).sum())} of "
                                  f"{rows} rows, ATen {torch.backends.cpu.get_cpu_capability()}")
