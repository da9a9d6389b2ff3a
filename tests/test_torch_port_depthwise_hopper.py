"""K23's Hopper form on the CPU: its plan mirror and form rule, and an
emulation of its walk (``csrc/depthwise_int8.cu: depthwise_hopper_kernel``)
held bit for bit against the plain version and its sums against JAX's.

The emulation follows the kernel step for step, in integers: block b's
items b, b + grid, ...; an item's (slice, band, image); its TMA box of
(TH - 1) s + 3 rows x WB columns x CS channels at (image, oh0 s - 1, -1,
c0), out-of-image rows and columns as zeros; thread t's channel quad t % Q
and pixel groups t / Q, t / Q + PG, ...; a pixel group's R outputs from the
(R - 1) s + 3 words of each tap row, transposed four pixels at a time into
channel streams; output j's three taps of a row as one ``__dp4a`` of the
stream's window of pixels j s .. j s + 3 and the tap-row weight word;
the epilogue as ``epi_f`` and ``requant4`` order it (the fma on float(acc);
int8 codes from the unclipped y / s clipped to [lo, qhi] where a quad's
check admits the division's fast path, else the activation on y and
``requant_exact``); the stores, each output once. No card, no ``nvcc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops import qops as JO
from dlq_tpu_torch.ops import depthwise_int8 as D
from dlq_tpu_torch.ops.conv_int8 import out_hw
from dlq_tpu_torch.quant.quantize import fdiv

SMS = 132  # an H100's SMs

# MobileNetV2 1.0x at 224 px: its ten depthwise shapes (H, C, stride), and
# the plan each takes at batch 256 (R, CS, TH, threads, stages, grid)
MNV2_DW = {(112, 32, 1): (7, 32, 8, 256, 3, 264), (112, 96, 2): (7, 96, 1, 192, 3, 264),
           (56, 144, 1): (4, 144, 2, 252, 3, 264), (56, 144, 2): (7, 144, 1, 144, 4, 264),
           (28, 192, 1): (4, 96, 7, 240, 4, 264), (28, 192, 2): (7, 64, 7, 224, 4, 264),
           (14, 384, 1): (7, 64, 7, 224, 4, 264), (14, 576, 1): (7, 144, 14, 252, 3, 264),
           (14, 576, 2): (7, 144, 7, 252, 3, 264), (7, 960, 1): (7, 96, 7, 168, 4, 260)}
# odd shapes the Hopper form takes: (N, H, W, C, stride)
ODD = [(2, 15, 15, 16, 2), (2, 13, 11, 32, 2), (1, 9, 20, 48, 1), (2, 5, 3, 16, 1),
       (1, 1, 1, 16, 1), (1, 30, 30, 208, 1)]
ACC_MAX = 9 * 128 * 128      # the largest |acc| of a 3x3 int8 depthwise sum
MAGIC_F = np.float32(12582912.0)   # 1.5 x 2^23: requant_code's rounding add


def _draw(seed, n, h, w, c, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        x = rng.choice(np.array([-128, 127], np.int8), (n, h, w, c))
        wq = rng.choice(np.array([-127, 127], np.int8), (3, 3, 1, c))
    else:
        x = rng.integers(-128, 128, (n, h, w, c)).astype(np.int8)
        wq = rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32) * np.float32(0.05 / (73 * 73 * 3))
    bias = rng.normal(0, 0.02, c).astype(np.float32)
    return x, wq, scale, bias


def dp4a(xw: np.ndarray, ww: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """__dp4a(a, b, c) on int32 words: c + the sum of the four signed byte products."""
    xb = xw.astype(np.uint32).view(np.uint8).reshape(*xw.shape, 4).view(np.int8).astype(np.int32)
    wb = ww.astype(np.uint32).view(np.uint8).reshape(*ww.shape, 4).view(np.int8).astype(np.int32)
    return acc + (xb * wb).sum(-1)


def row_words(w9c: np.ndarray) -> np.ndarray:
    """[9, C] int8 -> [3, C] uint32: tap row u's word for channel c, (w[u, 0,
    c], w[u, 1, c], w[u, 2, c], 0), as the kernel builds it by byte permutes."""
    b = w9c.reshape(3, 3, -1).view(np.uint8).astype(np.uint32)
    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16


def transpose4(x: np.ndarray) -> np.ndarray:
    """[..., 4] words of four pixels (four channels each) -> [..., 4] words of
    four channels (four pixels each): the kernel's 4 x 4 byte transpose."""
    b = x.astype(np.uint32).view(np.uint8).reshape(*x.shape, 4)      # [..., pixel, channel]
    return np.ascontiguousarray(np.swapaxes(b, -1, -2)).view(np.uint32).reshape(x.shape)


def window(lo: np.ndarray, hi: np.ndarray, o: int) -> np.ndarray:
    """Bytes o .. o + 3 of the 8-byte pairs (lo, hi): ``__byte_perm(lo, hi,
    0x4321 / 0x5432 / 0x6543)``."""
    pair = lo.astype(np.uint64) | hi.astype(np.uint64) << np.uint64(32)
    return ((pair >> np.uint64(8 * o)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def tma_box(x: np.ndarray, n: int, row0: int, col0: int, c0: int, rb: int, wb: int, cs: int):
    """A 4-D TMA box [1, rb, wb, cs] at (n, row0, col0, c0) of x: bytes
    outside the tensor land as zeros."""
    _, h, w, _ = x.shape
    box = np.zeros((rb, wb, cs), np.int8)
    r = np.arange(row0, row0 + rb)
    c = np.arange(col0, col0 + wb)
    rv, cv = (r >= 0) & (r < h), (c >= 0) & (c < w)
    box[np.ix_(rv, cv)] = x[n][np.ix_(r[rv], c[cv])][..., c0:c0 + cs]
    return box


def hopper_walk(x, wq, stride, plan):
    """The Hopper form's int32 sums, by its walk (the block's threads side by
    side); returns (acc, writes): the sums at every output and how many
    times each output was stored."""
    n, h, w, c = x.shape
    oh, ow = out_hw(h, w, 3, 3, stride, 1)
    r, cs, th, q, pg = plan.r, plan.cs, plan.th, plan.q, plan.pg
    assert plan.threads == q * pg and plan.grid % plan.slices == 0
    acc = np.zeros((n, oh, ow, c), np.int32)
    writes = np.zeros((n, oh, ow, c), np.int32)
    wt_all = row_words(wq.reshape(9, c))                     # [3, C]
    xw_n = (r - 1) * stride + 3                              # words a tap row reads
    xt = (xw_n + 4) // 4                                     # 4-pixel blocks, pad included
    tid = np.arange(plan.threads)
    qq, g0 = tid % q, tid // q                               # a thread's quad and first group
    lanes = 4 * qq[:, None] + np.arange(4)                   # its channels in the slice
    for b in range(plan.grid):
        slice_ = b % plan.slices
        wt = wt_all[:, slice_ * cs + lanes]                  # [3, threads, 4] tap-row words
        for item in range(b, plan.items, plan.grid):
            assert item % plan.slices == slice_              # the block keeps its slice
            rest = item // plan.slices
            band, img = rest % plan.bands, rest // plan.bands
            box = tma_box(x, img, band * th * stride - 1, -1, slice_ * cs, plan.rb, plan.wb, cs)
            words = box.view(np.uint32)                      # [rb, wb, q]: a quad a word
            for g in range(0, th * plan.cg, pg):             # a round: task g0 + g a thread
                task = g0 + g
                ohl, cgi = task // plan.cg, task % plan.cg
                o_h = band * th + ohl
                live = (task < th * plan.cg) & (o_h < oh)
                rows0, cols0 = np.where(live, ohl * stride, 0), np.where(live, cgi * r * stride, 0)
                s = np.zeros((plan.threads, r, 4), np.int32)
                for u in range(3):
                    cols = cols0[:, None] + np.arange(4 * xt)
                    xw = np.where(np.arange(4 * xt) < xw_n,        # the pad words are zeros
                                  words[rows0[:, None] + u, np.minimum(cols, plan.wb - 1),
                                        qq[:, None]], 0).astype(np.uint32)
                    t = transpose4(xw.reshape(-1, xt, 4))           # [threads, m, channel k]
                    for j in range(r):
                        pj = j * stride
                        lo, hi = t[:, pj // 4], t[:, pj // 4 + (1 if pj % 4 else 0)]
                        s[:, j] = dp4a(window(lo, hi, pj % 4), wt[u], s[:, j])
                for j in range(r):
                    o_w = cgi * r + j
                    ok = live & (o_w < ow)
                    ch = slice_ * cs + lanes[ok]
                    acc[img, o_h[ok, None], o_w[ok, None], ch] = s[ok, j]
                    np.add.at(writes, (img, o_h[ok, None], o_w[ok, None], ch), 1)
    return acc, writes


def fast_quads(scale, bias, s) -> np.ndarray:
    """Per channel, whether its quad (channels 4k .. 4k + 3, one thread's)
    takes requant4's fast path: s_fast(s) (2^-30 <= s <= 2^30) and
    ACC_MAX |scale| + |bias| <= 2^59 for all four channels, so |y| <= 2^60
    and the division's fast path is the correctly rounded quotient."""
    ok = 2.0 ** -30 <= float(s) <= 2.0 ** 30
    big = ACC_MAX * np.abs(scale.astype(np.float64)) + np.abs(bias.astype(np.float64)) > 2.0 ** 59
    return np.repeat(~big.reshape(-1, 4).any(-1), 4) & ok


def _act(y, relu, relu6):
    if relu6:
        return torch.clamp(y, 0.0, 6.0)
    return torch.clamp_min(y, 0.0) if relu else y


def _walk_out(acc, scale, bias, relu, out_scale, relu6):
    """The Hopper form's epilogue on the walk's sums, in the kernel's order
    (``depthwise_int8.cu``: ``epi_f``, ``requant4``): y = fma(float(acc),
    scale, bias) (float(acc) exact, |acc| <= 9 x 128 x 128 < 2^24). fp32
    out: the activation on y. int8 out, a quad on the fast path: q = y / s
    of the unclipped y (the division's fast path is the IEEE quotient under
    ``fast_quads``; the card tests hold that part), clipped to [lo, qhi],
    qhi = min(6 / s, 127) with relu6, else 127; a quad off it: the
    activation on y, then ``requant_exact`` (a zero y skips the division),
    clipped to [lo, 127]. The code: the low byte of q + 1.5 x 2^23."""
    f = torch.from_numpy(acc.astype(np.float32))
    assert np.array_equal(f.numpy().astype(np.int64), acc)
    y = torch.addcmul(torch.from_numpy(bias), f, torch.from_numpy(scale))
    if out_scale is None:
        return _act(y, relu, relu6)
    s = torch.tensor(out_scale, dtype=torch.float32)
    lo = 0.0 if (relu or relu6) else -127.0
    qhi = min(float(fdiv(torch.tensor([6.0]), s)), 127.0) if relu6 else 127.0
    q_fast = torch.clamp(fdiv(y, s), lo, qhi)
    ya = _act(y, relu, relu6)
    zero = ya == 0
    q_exact = torch.where(zero, 0.0, fdiv(torch.where(zero, 1.0, ya), s)).clamp(lo, 127.0)
    q = torch.where(torch.from_numpy(fast_quads(scale, bias, s)), q_fast, q_exact)
    bits = (q.numpy() + MAGIC_F).astype(np.float32).view(np.uint32)
    return torch.from_numpy((bits & np.uint32(0xFF)).astype(np.uint8).view(np.int8))


def _plain(x, wq, stride, scale, bias, relu, out_scale, relu6):
    return D.depthwise_int8_plain(torch.from_numpy(x),
                                  D.pack_depthwise_weight(torch.from_numpy(wq)), stride, 1,
                                  torch.from_numpy(scale), torch.from_numpy(bias), relu,
                                  out_scale, relu6)


# ---------------------------------------------------------------------------
# plan and form rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(MNV2_DW))
def test_plan_at_mobilenetv2_shapes(shape):
    """The plan of each MobileNetV2 depthwise shape at batch 256 on 132 SMs:
    the recorded (R, CS, TH, threads, stages, grid), and what the kernel
    needs of any plan: CS a multiple of 16 dividing C, C or at least 64; a
    box within 256 a side whose columns cover every pixel group; a stage
    within 36 KB, the ring within 113 KB; Q x PG threads, at most 256; a
    grid that is a multiple of the slices, at most the items."""
    h, c, s = shape
    p = D.depthwise_hopper_plan(256, h, h, c, s, SMS)
    assert (p.r, p.cs, p.th, p.threads, p.stages, p.grid) == MNV2_DW[shape]
    oh, ow = out_hw(h, h, 3, 3, s, 1)
    assert p.ok and c % p.cs == 0 and p.cs % 16 == 0 and (p.cs >= 64 or p.cs == c)
    assert p.cg == -(-ow // p.r) and p.wb == (p.cg * p.r - 1) * s + 3 <= D.BOX_MAX
    assert p.rb == (p.th - 1) * s + 3 <= D.BOX_MAX and p.th <= oh
    assert p.stage == p.cs * p.wb * p.rb <= D.STAGE_MAX and p.pitch % 128 == 0
    assert 3 <= p.stages <= D.MAX_STAGES and p.stages * p.pitch <= D.RING_MAX
    assert p.smem == p.stages * p.pitch + 8 * p.stages
    assert p.q == p.cs // 4 and p.threads == p.q * p.pg <= D.HOP_THREADS
    assert p.pg == min(p.th * p.cg, D.HOP_THREADS // p.q)
    assert p.bands == -(-oh // p.th) and p.slices == c // p.cs
    assert p.items == 256 * p.bands * p.slices
    assert p.grid % p.slices == 0 and p.slices <= p.grid <= p.items


@pytest.mark.parametrize("case", ODD)
def test_plan_at_odd_shapes(case):
    """Odd shapes the Hopper form takes (stride 2 from an odd H, W unlike
    H, one pixel, a wide C of 13 x 16): a plan that fits, whose grid never
    exceeds the items."""
    n, h, w, c, s = case
    p = D.depthwise_hopper_plan(n, h, w, c, s, SMS)
    assert p.ok and p.grid <= p.items and p.grid % p.slices == 0
    assert p.stage <= D.STAGE_MAX and p.wb <= D.BOX_MAX
    assert D.depthwise_form(n, h, w, c, 3, 3, s, 1) == "hopper"


@pytest.mark.parametrize("case,form", [
    ((2, 9, 9, 40, 3, 3, 1, 1), "first"),     # C % 16 == 8
    ((2, 7, 5, 24, 3, 3, 2, 1), "first"),     # C % 16 == 8
    ((2, 9, 9, 32, 5, 5, 1, 2), "first"),     # 5x5
    ((2, 9, 9, 32, 3, 3, 1, 0), "first"),     # pad 0
    ((2, 9, 9, 32, 3, 3, 3, 1), "first"),     # stride 3
    ((1, 8, 300, 32, 3, 3, 1, 1), "first"),   # a box wider than 256 columns
    ((1, 8, 120, 192, 3, 3, 1, 1), "hopper"),  # narrower slices fit
    ((2, 15, 15, 16, 3, 3, 2, 1), "hopper"),
    ((256, 112, 112, 32, 3, 3, 1, 1), "hopper"),
])
def test_form_rule(case, form):
    """3x3, pad 1, stride 1 or 2, C % 16 == 0 and a plan that fits take the
    Hopper form; everything else the first form."""
    assert D.depthwise_form(*case) == form


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(MNV2_DW))
@pytest.mark.parametrize("epi", ["fp32", "int8_relu6"])
def test_walk_equals_plain_at_mobilenetv2_shapes(shape, epi):
    """The emulated walk at each MobileNetV2 depthwise shape (batch 1, on the
    batch-1 plan), with the deploy path's epilogue (fp32 out, no activation)
    and fused2's (int8 out, relu6, y spread past 6): every output stored
    exactly once, bit-identical to ``depthwise_int8_plain``."""
    h, c, s = shape
    x, wq, scale, bias = _draw(h * 7 + c + s, 1, h, h, c)
    relu6, osc = (True, 0.1) if epi == "int8_relu6" else (False, None)
    if relu6:
        scale = scale * np.float32(80.0)
    p = D.depthwise_hopper_plan(1, h, h, c, s, SMS)
    acc, writes = hopper_walk(x, wq, s, p)
    assert (writes == 1).all()
    if relu6:
        assert fast_quads(scale, bias, osc).all()   # fused2's launches take the fast path
    got = _walk_out(acc, scale, bias, False, osc, relu6)
    ref = _plain(x, wq, s, scale, bias, False, osc, relu6)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if relu6:
        assert (ref == 60).any() and (ref == 0).any()   # the clip at 6 (6 / 0.1) and at 0


@pytest.mark.parametrize("case", ODD)
@pytest.mark.parametrize("relu,relu6,osc", [(False, False, None), (True, False, 0.05),
                                             (False, True, 0.1), (False, False, 0.05)])
def test_walk_equals_plain_at_odd_shapes(case, relu, relu6, osc):
    """The walk at odd shapes (partial pixel groups past OW, bands past OH,
    out-of-image rows and columns as zero fill), at batch 1-2, with every
    epilogue: each output once, bit-identical to the plain version."""
    n, h, w, c, s = case
    x, wq, scale, bias = _draw(n * 1000 + h * 31 + w + c + s, n, h, w, c)
    if relu6:
        scale = scale * np.float32(80.0)
    acc, writes = hopper_walk(x, wq, s, D.depthwise_hopper_plan(n, h, w, c, s, SMS))
    assert (writes == 1).all()
    got = _walk_out(acc, scale, bias, relu, osc, relu6)
    ref = _plain(x, wq, s, scale, bias, relu, osc, relu6)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


def forced_epilogue(scale, bias, force):
    """Scale, bias and output scale that send requant4 off its fast path,
    with y / s spread over the int8 range as fused2's (scale x 80, s = 0.1)
    spreads it: "s_small" / "s_large" an output scale of 2^-31 / 2^31
    (s_fast fails for every quad; scale and bias scaled with s), "quad" s =
    0.1 with one channel of some quads past the check's bound (a bias of
    +-1e18 in channel 8k, a scale of 1e13 in channel 16k + 5), so those
    quads' other channels, which carry ordinary values, take requant_exact
    while the remaining quads take the fast path in the same launch."""
    scale = scale * np.float32(80.0)
    if force == "quad":
        bias = bias.copy()
        scale = scale.copy()
        bias[0::8] = np.float32(1e18) * np.where(np.arange(bias[0::8].size) % 2, -1, 1)
        scale[5::16] = np.float32(1e13)
        return scale, bias, 0.1
    s = 2.0 ** -31 if force == "s_small" else 2.0 ** 31
    k = np.float32(s / 0.1)
    return scale * k, bias * k, s


@pytest.mark.parametrize("case", [(2, 15, 15, 16, 2), (1, 9, 20, 48, 1)])
@pytest.mark.parametrize("act", ["relu6", "relu", "none"])
@pytest.mark.parametrize("force", ["s_small", "s_large", "quad"])
def test_walk_exact_fallback_equals_plain(case, act, force):
    """requant4's exact fall-back (``requant_exact`` after the activation on
    y) where its check refuses the fast path: an output scale outside
    [2^-30, 2^30], or a quad whose |scale| or |bias| could put |y| past
    2^60, with relu6, relu and no activation; the walk's int8 codes
    bit-identical to the plain version, each output stored once."""
    n, h, w, c, s = case
    x, wq, scale, bias = _draw(n * 100 + h + w + c + s, n, h, w, c)
    scale, bias, osc = forced_epilogue(scale, bias, force)
    fast = fast_quads(scale, bias, osc)
    assert (fast.any() and not fast.all()) if force == "quad" else not fast.any()
    relu, relu6 = act == "relu", act == "relu6"
    acc, writes = hopper_walk(x, wq, s, D.depthwise_hopper_plan(n, h, w, c, s, SMS))
    assert (writes == 1).all()
    got = _walk_out(acc, scale, bias, relu, osc, relu6)
    ref = _plain(x, wq, s, scale, bias, relu, osc, relu6)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if not (relu6 and force == "s_large"):       # there y <= 6 makes every code 0
        slow = torch.from_numpy(~fast).expand_as(ref)
        assert len(torch.unique(ref[slow])) > 2  # the fall-back's codes are not all one value


@pytest.mark.parametrize("n,h,w,c,stride,extreme", [
    (2, 14, 14, 32, 1, False), (2, 15, 15, 16, 2, False), (1, 13, 11, 48, 2, False),
    (2, 7, 7, 64, 1, True), (1, 9, 20, 48, 1, False),
])
def test_walk_sums_match_jax(n, h, w, c, stride, extreme):
    """The walk's int32 sums == JAX's int8 grouped conv (``_conv_int8``,
    depthwise "int8") and its stencil, bit for bit, on the same numpy-seeded
    inputs (at ±128 / ±127 too)."""
    x, wq, _, _ = _draw(h * 100 + w * 10 + c + stride, n, h, w, c, extreme)
    acc, writes = hopper_walk(x, wq, stride, D.depthwise_hopper_plan(n, h, w, c, stride, SMS))
    assert (writes == 1).all()
    ref = np.asarray(jax.jit(lambda a, b: JO._conv_int8(a, b, stride, 1, c, depthwise="int8"))(
        x, wq))
    sten = np.asarray(JO._depthwise_int8_stencil(jnp.asarray(x), jnp.asarray(wq),
                                                 (stride, stride), [(1, 1), (1, 1)]))
    np.testing.assert_array_equal(acc, ref)
    np.testing.assert_array_equal(acc, sten)
    if extreme:
        assert np.abs(acc).max() >= 9 * 127 * 127


def test_acc_conversion_exact():
    """float(acc) (``__int2float_rn``) is exact at every |acc| <= 9 x 128 x
    128, the most a 3x3 depthwise sum reaches (the form rule takes no other
    kernel size): the fma sees the exact sum, and ACC_MAX |scale| + |bias|
    bounds |y| in requant4's check."""
    acc = np.arange(-ACC_MAX, ACC_MAX + 1, dtype=np.int32)
    np.testing.assert_array_equal(acc.astype(np.float32).astype(np.int64), acc)


def test_transpose_window_dp4a():
    """The product step on every int8 value: four pixels' channel quads
    transposed into channel words, the window of pixels o .. o + 3 of one
    channel, and __dp4a with a tap-row word (the fourth weight byte 0) give
    the three taps' sum of products for that channel."""
    rng = np.random.default_rng(11)
    v = np.arange(-128, 128)
    px = np.stack([rng.permutation(v) for _ in range(32)]).astype(np.int8)   # [32, 256]
    quads = px.reshape(8, 4, 256).transpose(2, 0, 1)         # [256 draws, 8 pixels, 4 channels]
    words = np.ascontiguousarray(quads).view(np.uint32)[..., 0]            # [256, 8]
    t = transpose4(words.reshape(256, 2, 4))                 # [256, m, channel]
    w9 = rng.integers(-127, 128, (9, 4)).astype(np.int8)
    wt = row_words(w9)                                       # [3, 4]
    for o in range(4):
        for k in range(4):
            got = dp4a(window(t[:, 0, k], t[:, 1, k], o), np.full(256, wt[1, k]),
                       np.zeros(256, np.int32))
            want = (quads[:, o:o + 3, k].astype(np.int32) * w9[3:6, k]).sum(-1)
            np.testing.assert_array_equal(got, want)


def _ys(s: float) -> torch.Tensor:
    """fp32 y values: a dense sweep over [-20, 20], the rounding ties of y / s
    and their neighbours, 6 and its neighbours, zeros and large values."""
    sweep = torch.linspace(-20.0, 20.0, 200001, dtype=torch.float32)
    k = torch.arange(-130, 131, dtype=torch.float32)
    ties = (k + 0.5) * torch.tensor(s, dtype=torch.float32)
    six = torch.tensor([6.0, 0.0, -0.0, 1e-30, -1e-30, 1e6, -1e6, 3e30, -3e30])
    near = torch.cat([ties, six])
    up = torch.nextafter(near, torch.tensor(float("inf")))
    down = torch.nextafter(near, torch.tensor(float("-inf")))
    return torch.cat([sweep, near, up, down])


@pytest.mark.parametrize("s", [0.1, 0.025, 0.05 / 40.0, 0.0473, 1.0 / 3.0, 7.0])
@pytest.mark.parametrize("act", ["relu6", "relu", "none"])
def test_merged_clips_equal_the_plain_requant(s, act):
    """The Hopper form's int8 codes on its fast path: y / s clipped to [qlo,
    qhi] and rounded, with no clip of y (relu6: qlo = 0, qhi = min(6 / s,
    127); relu: 0, 127; none: -127, 127), equal the plain epilogue's
    (clip y, divide, round, clip) at every y swept, the ties of y / s and
    their neighbours included: division by s > 0 is monotone, so clip(y, 0,
    6) / s = clip(y / s, 0, 6 / s)."""
    y = _ys(s)
    ref = D.epilogue_plain(y.view(1, -1), torch.ones(1), torch.zeros(1), act == "relu", s,
                           act == "relu6").view(-1)  # the plain epilogue with unit scale
    ref_direct = torch.clamp(torch.round(fdiv(torch.clamp(y, 0.0, 6.0) if act == "relu6" else
                                              torch.clamp_min(y, 0.0) if act == "relu" else y, s)),
                             -127.0 if act == "none" else 0.0, 127.0).to(torch.int8)
    q = fdiv(y, s)
    qlo = -127.0 if act == "none" else 0.0
    qhi = min(float(fdiv(torch.tensor([6.0]), s)), 127.0) if act == "relu6" else 127.0
    got = torch.round(torch.clamp(q, qlo, qhi)).to(torch.int8)
    assert torch.equal(ref_direct, got)
    assert torch.equal(ref, got)
