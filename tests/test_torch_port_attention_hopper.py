"""The Hopper forms of ``mhsa_f32`` and K18 (``mhsa_i8``) on the CPU.

The launch plans and form rules (``mhsa_f32_plan`` / ``_form``,
``csrc/mhsa.cu``; ``mhsa_i8_plan`` / ``_form``, ``csrc/mhsa_i8.cu``) at
DeiT-Tiny's shapes against a hand-written sum of their shared memory, and at
every row count 1..256; an index-level emulation of ``mhsa_f32``'s tile walk
(every score and every output produced once, its d steps and key steps in
ascending order, every softmax row by one warp); K18's staging emulated in
torch and numpy (the amaxes and codes taken from a staged copy, with the
kernel's clip-then-round on the full-rate pipes, equal ``dyn_quant``'s and
the reference's, the in-kernel form's amax over the pad rows; V's permuted
layout written by the kernel's unit walk, round-tripped through ``vpos``,
and its int32 A V sums equal the plain ones); K18's key chunks; and the
persistent item walks. The kernels compute the same plans on the card; the
card tests hold them to these functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu_torch.ops import attention as A
from dlq_tpu_torch.ops import int8_attention as I

H100_SMS = 132
SMEM_MAX = 232448


def jax_dyn(a):
    """The reference's dynamic quantizer (``int8_attention.py:60-63``)."""
    amax = jnp.max(jnp.abs(a), axis=(2, 3), keepdims=True) + 1e-9
    return jnp.clip(jnp.round(a * (127.0 / amax)), -127, 127).astype(jnp.int8), amax


# ---- the plans and the form rules ----

@pytest.mark.parametrize("rows,n_valid,hd,want", [
    (197, 197, 64, (256, 220928, 100, 2, 200)),   # the fp32 fused_ln forward (DeiT-Tiny)
    (200, 197, 64, (256, 220928, 100, 2, 200)),   # the tight block stream
    (256, 197, 64, (256, 210048, 90, 3, 200)),    # the loose pads
    (256, 256, 64, (0, 0, 0, 0, 0)),              # 256 keys: the first form
    (24, 21, 32, (256, 13824, 25, 1, 24)),
])
def test_mhsa_f32_plan_at_deit_shapes(rows, n_valid, hd, want):
    """K and V resident over kp = n_valid rounded up to 8 keys (K and the Q
    tile at hd + 4 fp32 lanes a row, V at hd), the Q tile and its scores
    ([qt][kp + 4], and a scratch row for each of the 8 softmax warps) over
    query tiles of at most 100 rows; all 0 where the first form serves."""
    got = A.mhsa_f32_plan(rows, n_valid, hd)
    assert got == want
    assert A.mhsa_f32_form(rows, n_valid, hd) == ("hopper" if got[0] else "first")
    if got[0]:
        threads, smem, qt, nt, kp = got
        hand = 4 * (kp * (hd + 4) + kp * hd + qt * (hd + 4) + (qt + 8) * (kp + 4))
        assert smem == hand <= SMEM_MAX
        assert threads == A.F32_THREADS and qt * nt >= rows and qt <= A.F32_QT_MAX
    else:
        kp, qt, _, _ = A._f32_layout(rows, n_valid, hd)
        assert 4 * (kp * (hd + 4) + kp * hd + qt * (hd + 4) + (qt + 8) * (kp + 4)) > SMEM_MAX


@pytest.mark.parametrize("rows,n_valid,in_f32,want", [
    (200, 197, False, (416, 86400, 49920, 136512)),    # in-kernel, tight block stream
    (256, 197, False, (512, 110592, 53760, 164544)),   # zero-pad, the split forward's loose pads
    (197, 197, False, (416, 85104, 49920, 135216)),    # zero-pad, xla_int8 deploy
    (197, 197, True, (416, 160752, 49920, 210864)),    # zero-pad, the fp32 forward
    (256, 197, True, (0, 0, 0, 0)),                    # fp32 at 256 rows: the first form
])
def test_mhsa_i8_plan_at_deit_shapes(rows, n_valid, in_f32, want):
    """One warp per 16 query rows; the raw stage (Q, K and V over every row
    at hd x esize + 16 bytes), the codes of Q (rows rounded up to 16) and K
    (n_valid rounded up to 32) at hd + 16 bytes a row, V^T (hd rows of
    round32(n_valid) + 16 bytes) and 3 x 16 fp32 amax slots."""
    hd = 64
    got = I.mhsa_i8_plan(rows, n_valid, hd, in_f32)
    assert got == want
    assert I.mhsa_i8_form(rows, n_valid, hd, in_f32) == ("hopper" if got[0] else "first")
    nq, nk = -(-rows // 16) * 16, -(-n_valid // 32) * 32
    stage = 3 * rows * (hd * (4 if in_f32 else 2) + 16)
    codes = nq * (hd + 16) + nk * (hd + 16) + hd * (nk + 16)
    smem = stage + codes + 3 * 16 * 4
    if got[0]:
        assert got == (nq // 16 * 32, stage, codes, smem) and smem <= SMEM_MAX
    else:
        assert smem > SMEM_MAX


def test_form_rules_refuse_other_head_widths():
    """hd other than 32 or 64, rows past 256 and n_valid outside 1..rows
    take the first form (whose own checks then raise)."""
    for hd in (16, 48, 128):
        assert A.mhsa_f32_form(197, 197, hd) == "first"
        assert I.mhsa_i8_form(197, 197, hd, False) == "first"
    assert A.mhsa_f32_form(257, 197, 64) == I.mhsa_i8_form(257, 197, 64, False) == "first"
    assert A.mhsa_f32_form(197, 0, 64) == I.mhsa_i8_form(197, 198, 64, False) == "first"


@pytest.mark.parametrize("hd", [32, 64])
def test_mhsa_f32_plans_cover_rows(hd):
    """At every row count 1..256 (n_valid = rows and rows - 3): the query
    tiles cover the rows with fewer than one tile's rows to spare, each tile
    a multiple of the Q K^T row group and at most 100 rows; the keys
    resident cover n_valid in groups of 8; the rule takes the Hopper form
    exactly where its keys fit the softmax's registers (224) and its layout
    a block's shared memory."""
    for rows in range(1, 257):
        for n_valid in {rows, max(1, rows - 3)}:
            kp, qt, nt, smem = A._f32_layout(rows, n_valid, hd)
            assert qt % A.F32_TM == 0 and qt <= A.F32_QT_MAX
            assert qt * nt >= rows > qt * (nt - 1)
            assert kp % 8 == 0 and n_valid <= kp < n_valid + 8
            fits = kp <= A.F32_KEYS and smem <= SMEM_MAX
            assert (A.mhsa_f32_form(rows, n_valid, hd) == "hopper") == fits
            if rows <= 200:
                assert fits


@pytest.mark.parametrize("in_f32", [False, True])
@pytest.mark.parametrize("hd", [32, 64])
def test_mhsa_i8_plans_cover_rows(hd, in_f32):
    """At every row count 1..256: one warp per 16 query rows (at most 16),
    the stage holds every row, the Q codes every warp's rows and the K codes
    and V^T the keys in whole 32-key steps; bf16 takes the Hopper form at
    every row count, fp32 up to where its stage stops fitting."""
    fits = []
    for rows in range(1, 257):
        for n_valid in {rows, max(1, rows - 3)}:
            threads, stage, codes, smem = I._i8_layout(rows, n_valid, hd, in_f32)
            assert threads == -(-rows // 16) * 32 <= 512
            assert stage == 3 * rows * (hd * (4 if in_f32 else 2) + 16)
            hop = I.mhsa_i8_form(rows, n_valid, hd, in_f32) == "hopper"
            assert hop == (smem <= SMEM_MAX)
            fits.append(hop)
    if not in_f32 or hd == 32:
        assert all(fits)
    else:
        assert I.mhsa_i8_form(200, 197, hd, True) == "hopper"
        assert not all(fits)


# ---- mhsa_f32's tile walk ----

def _f32_walk(rows, n_valid, hd):
    """The Hopper form's walk of one (sample, head), at index level: for
    each score (row, key) the d of each FMA in its chain, for each output
    (row, lane) the key of each FMA in its chain, and for each softmax row
    the warps that take it (csrc/mhsa.cu: mhsa_f32_hopper)."""
    _, _, qt, nt, kp = A.mhsa_f32_plan(rows, n_valid, hd)
    threads, tm, tn = A.F32_THREADS, A.F32_TM, A.F32_TN
    warps = threads // 32
    score_d, out_k, soft = {}, {}, {}
    for t in range(nt):
        q0 = t * qt
        n_rows = min(qt, rows - q0)
        rg_n = qt // tm
        for tid in range(threads):   # Q K^T: unit (rg, kg) of tm rows x tn keys
            for u in range(tid, rg_n * (kp // tn), threads):
                rg, kg = u % rg_n, u // rg_n
                for d0 in range(0, hd, 4):
                    for dd in range(4):
                        for i in range(tm):
                            for j in range(tn):
                                score_d.setdefault((q0 + rg * tm + i, kg * tn + j), []).append(
                                    d0 + dd)
        for warp in range(warps):   # softmax: all of a warp's rows, w + 8 i, at once
            for r in range(warp, n_rows, warps):
                soft.setdefault(q0 + r, []).append(warp)
        lw = hd // warps   # A V: warp w the lanes w * lw.., lane i the rows i + 32 m
        for warp in range(warps):
            for lane in range(32):
                for kk in range(0, kp, 4):
                    for m in range(4):
                        for mr in range(-(-A.F32_QT_MAX // 32)):
                            r = lane + 32 * mr
                            if r >= n_rows:
                                continue
                            for e in range(lw):
                                out_k.setdefault((q0 + r, warp * lw + e), []).append(kk + m)
    return kp, score_d, out_k, soft


@pytest.mark.parametrize("rows,n_valid,hd", [(197, 197, 64), (200, 197, 64), (24, 21, 32),
                                             (1, 1, 64), (101, 99, 32)])
def test_mhsa_f32_walk_each_score_and_output_once_in_order(rows, n_valid, hd):
    """Every score of the padded tiles (every row of every query tile, keys
    0..kp-1) is one FMA chain over d = 0..hd-1 in ascending order; every
    output of a real row is one chain over keys 0..kp-1 in ascending order
    (the first form's order: keys past n_valid carry p = 0 and add exact
    zeros); every real row's softmax is taken once, by one warp."""
    kp, score_d, out_k, soft = _f32_walk(rows, n_valid, hd)
    _, _, qt, nt, _ = A.mhsa_f32_plan(rows, n_valid, hd)
    assert set(score_d) == {(r, k) for r in range(qt * nt) for k in range(kp)}
    assert all(ds == list(range(hd)) for ds in score_d.values())
    assert set(out_k) == {(r, d) for r in range(rows) for d in range(hd)}
    assert all(ks == list(range(kp)) for ks in out_k.values())
    assert set(soft) == set(range(rows)) and all(len(w) == 1 for w in soft.values())


def test_mhsa_f32_orders_reproduce_the_plain_version():
    """The walk's orders in float32 arithmetic, emulated with numpy on a
    small item (each score an FMA chain in d order, scaled and masked; the
    row max; expf of the difference; each lane's keys lane + 32 j in j order
    and the warp butterfly; the division; each output an FMA chain in key
    order) against ``mhsa_plain`` (torch's sum order): within 1e-6 of each
    output, the outputs being averages of unit-scale V rows."""
    rng = np.random.default_rng(3)
    n, n_valid, hd = 37, 33, 32
    q, k, v = (rng.normal(0, 1, (n, hd)).astype(np.float32) for _ in range(3))
    scale = np.float32(A.softmax_scale(hd))
    kp = -(-n_valid // 8) * 8
    f32 = np.float32

    def fma(a, b, c):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))

    out = np.zeros((n, hd), np.float32)
    for r in range(n):
        s = np.zeros(kp, np.float32)
        for key in range(kp):
            acc = f32(0)
            if key < n:
                for d in range(hd):
                    acc = fma(q[r, d], k[key, d], acc)
            s[key] = f32(acc * scale) if key < n_valid else f32(-1e30)
        mx = s.max()
        p = np.exp((s - mx).astype(np.float32)).astype(np.float32)
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            for key in range(lane, kp, 32):
                lanes[lane] = f32(lanes[lane] + p[key])
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        a = (p / lanes[0]).astype(np.float32)
        for d in range(hd):
            acc = f32(0)
            for key in range(kp):
                acc = fma(a[key], v[key, d] if key < n else 0.0, acc)
            out[r, d] = acc
    t = lambda x: torch.from_numpy(x)[None]  # noqa: E731
    ref = A.mhsa_plain(t(q), t(k), t(v), 1, n_valid)[0].numpy()
    assert np.abs(out - ref).max() <= 1e-6


# ---- K18's staging, codes and V layout ----

def _code_bits(x: np.ndarray, lo: float) -> np.ndarray:
    """The kernel's code: x clipped to [lo, 127] by fmaxf / fminf (np.fmax
    and np.fmin: a NaN yields the other operand), plus 1.5 * 2^23 in fp32;
    the low byte of its bits as an int8."""
    y = (np.fmin(np.fmax(x, np.float32(lo)), np.float32(127.0)).astype(np.float32)
         + np.float32(12582912.0)).astype(np.float32)
    return (y.view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)


def _staged_codes(x: np.ndarray, rows: int) -> tuple:
    """One (sample, head)'s [N, hd] values as the Hopper form codes them:
    the stage holds rows 0..rows-1, the amax is the max of |x| over it plus
    1e-9, the inverse scale 127 / amax (IEEE division), each code
    _code_bits(x * inv, -127); rows past the stage code 0."""
    st = x[:rows].astype(np.float32)
    amax = np.float32(np.abs(st).max() + np.float32(1e-9))
    inv = np.float32(np.float32(127.0) / amax)
    codes = np.zeros(x.shape, np.int8)
    codes[:rows] = _code_bits((st * inv).astype(np.float32), -127.0)
    return codes, amax


@pytest.mark.parametrize("case", ["normal", "halves", "bf16", "zeros"])
@pytest.mark.parametrize("zero_pad", [False, True])
def test_mhsa_i8_staged_codes_equal_dyn_quant(case, zero_pad):
    """Amaxes and codes from the staged copy equal ``dyn_quant``'s and the
    reference's quantizer (``jax_dyn``) on the same values: the in-kernel
    form's amax over every row of the padded stream, pad rows included; the
    zero-pad form's over the n_valid rows it stages, on the reference's
    zeroed tensor. "halves" puts values on exact halves of a code (round
    half to even through the 1.5 * 2^23 addend)."""
    rng = np.random.default_rng(11)
    B, N, heads, hd, n_valid = 2, 24, 3, 32, 19
    x = rng.normal(0, 1.5, (B, N, heads * hd)).astype(np.float32)
    if case == "halves":
        x = (np.round(rng.uniform(-254, 254, x.shape)) / 2.0).astype(np.float32)
        x[:, 0, ::hd] = 127.0
    elif case == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    elif case == "zeros":
        x[1, :, :hd] = 0.0
    ref_in = x.copy()
    if zero_pad:
        ref_in[:, n_valid:] = 0.0
    split = torch.from_numpy(ref_in).reshape(B, N, heads, hd).permute(0, 2, 1, 3)
    tq, ta = I.dyn_quant(split.float())
    jq, ja = jax.jit(jax_dyn)(jnp.asarray(split.numpy()))
    rows = n_valid if zero_pad else N
    for b in range(B):
        for h in range(heads):
            codes, amax = _staged_codes(x[b, :, h * hd:(h + 1) * hd], rows)
            np.testing.assert_array_equal(codes, tq[b, h].numpy().astype(np.int8))
            np.testing.assert_array_equal(codes, np.asarray(jq[b, h]))
            assert amax == ta[b, h, 0, 0].item() == np.asarray(ja)[b, h, 0, 0]


def test_code_bits_is_clip_of_rint():
    """The 1.5 * 2^23 addend rounds half to even: _code_bits(x, lo) equals
    clip(rint(x), lo, 127) for every half step in [-160, 160], and for the
    probability codes (lo 0) on [0, 127]; NaN codes lo either way."""
    x = (np.arange(-320, 321) / 2.0).astype(np.float32)
    for lo in (-127.0, 0.0):
        want = np.clip(np.rint(x), lo, 127).astype(np.int8)
        np.testing.assert_array_equal(_code_bits(x, lo), want)
    assert _code_bits(np.array([np.nan], np.float32), -127.0)[0] == -127


def test_i2f_exact_on_int32_scores():
    """float(n) as (bits(1.5 * 2^23) + n) reinterpreted, minus 1.5 * 2^23:
    exact for every int32 score of hd 64 (|n| <= 64 x 127^2)."""
    n = np.concatenate([np.arange(-70000, 70001, 7), [-1032256, 1032256, -1, 0, 1]])
    n = n.astype(np.int32)
    got = ((np.int32(0x4B400000) + n).view(np.float32) - np.float32(12582912.0))
    np.testing.assert_array_equal(got.astype(np.float32), n.astype(np.float32))


def _vpos(k: int) -> int:
    r = k & 31
    return (k & ~31) + 16 * (r >> 4) + 4 * ((r & 7) >> 1) + (r & 1) + 2 * ((r >> 3) & 1)


@pytest.mark.parametrize("n_valid,rows,ve", [(197, 200, 8), (197, 197, 4), (17, 24, 8),
                                             (256, 256, 8)])
def test_mhsa_i8_v_layout_round_trips(n_valid, rows, ve):
    """The kernel's V^T walk (unit (lane chunk dc, 32-key group ks, half,
    tt) writing the codes of keys k0, k0 + 1, k0 + 8, k0 + 9 as one word
    at position 32 ks + 16 half + 4 tt) writes every (lane, position) once,
    each position holds the key ``vpos`` maps there, keys past the stage
    code 0; the A fragments of a8 (thread (g, t) holds keys 8 j + 2 t + {0,
    1} of its C fragment, packed as the first form packs them) meet V^T's
    positions, so the int32 A V sums equal a8 V8's."""
    rng = np.random.default_rng(n_valid)
    hd = 64
    nk = -(-n_valid // 32) * 32
    v8 = rng.integers(-127, 128, (rows, hd)).astype(np.int8)
    vt = np.full((hd, nk), 99, np.int16)
    written = np.zeros((hd, nk), np.int32)
    nks = nk // 32
    for u in range(hd // ve * nks * 8):
        tt, half, rest = u & 3, (u >> 2) & 1, u >> 3
        ks, dc = rest % nks, rest // nks
        k0 = 32 * ks + 16 * half + 2 * tt
        for e in range(ve):
            d = dc * ve + e
            for b, key in enumerate((k0, k0 + 1, k0 + 8, k0 + 9)):
                pos = 32 * ks + 16 * half + 4 * tt + b
                vt[d, pos] = v8[key, d] if key < rows else 0
                written[d, pos] += 1
    assert (written == 1).all()
    for key in range(nk):
        want = v8[key] if key < rows else np.zeros(hd, np.int8)
        np.testing.assert_array_equal(vt[:, _vpos(key)], want)
    # the A fragment of one 16-row warp tile: byte position of each key
    a8 = rng.integers(0, 128, (16, nk)).astype(np.int64)
    a8[:, n_valid:] = 0
    apos = np.zeros((16, nk), np.int64)
    for g in range(8):
        for t in range(4):
            for ks in range(nks):
                for half in range(2):
                    j0 = 4 * ks + 2 * half
                    keys = (8 * j0 + 2 * t, 8 * j0 + 2 * t + 1, 8 * j0 + 8 + 2 * t,
                            8 * j0 + 9 + 2 * t)
                    for b, key in enumerate(keys):
                        for row in (g, g + 8):
                            apos[row, 32 * ks + 16 * half + 4 * t + b] = a8[row, key]
    v8k = np.pad(v8.astype(np.int64), ((0, max(0, nk - rows)), (0, 0)))[:nk]
    np.testing.assert_array_equal(apos @ vt.astype(np.int64).T, a8 @ v8k)


@pytest.mark.parametrize("n_valid", [1, 31, 32, 33, 63, 64, 65, 96, 128, 129, 197, 224, 256])
def test_mhsa_i8_key_chunks(n_valid):
    """K18's Hopper chunks: 64-key chunks over the keys rounded up to 32, in
    key order, each whole 32-key steps; only the last chunk is masked, and
    every key before it is below n_valid."""
    nk32 = -(-n_valid // 32)
    last = (nk32 - 1) // 2 * 64
    chunks = [(kb, 2, False) for kb in range(0, last, 64)]
    chunks.append((last, 1 if nk32 - last // 32 == 1 else 2, True))
    keys = [k for kb, ns, _ in chunks for k in range(kb, kb + 32 * ns)]
    assert keys == list(range(32 * nk32))
    assert all(k < n_valid for kb, ns, masked in chunks if not masked
               for k in range(kb, kb + 32 * ns))


# ---- the persistent walks ----

@pytest.mark.parametrize("items", [1, 3, 131, 132, 133, 768, 1000])
def test_persistent_item_walk_covers_every_item_once(items):
    """Both Hopper forms launch min(items, SMs x blocks an SM) blocks (one
    block an SM: their shared memory is over half an SM's), and block b
    takes items b, b + grid, ...: every (sample, head) once; at DeiT's 768
    items on 132 SMs no block takes more than 6."""
    grid = min(items, H100_SMS)
    seen = [it for b in range(grid) for it in range(b, items, grid)]
    assert sorted(seen) == list(range(items))
    assert max(len(range(b, items, grid)) for b in range(grid)) == -(-items // grid)
    assert A.mhsa_f32_plan(197, 197, 64)[1] > SMEM_MAX // 2
    assert I.mhsa_i8_plan(200, 197, 64, False)[3] > SMEM_MAX // 2


def test_first_forms_need_a_card():
    """The first forms are callable only on CUDA tensors (the wrappers run
    the plain version for a CPU tensor; the first forms have none), after
    the same checks as the wrappers."""
    q, k, v = (torch.zeros(2, 17, 96) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        A.mhsa_f32_first(q, k, v, 3, 17)
    with pytest.raises(ValueError, match="CUDA"):
        I.mhsa_i8_first(q, k, v, 3, 17)
    with pytest.raises(ValueError, match="share a dtype"):
        I.mhsa_i8_first(q, k, v.to(torch.bfloat16), 3, 17)
    with pytest.raises(ValueError, match="n_valid"):
        A.mhsa_f32_first(q, k, v, 3, 18)
