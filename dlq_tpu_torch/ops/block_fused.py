"""K3 and K4: one identity ResNet block, int8 in to int8 out, in one kernel.

K3 replaces ``dlq_tpu/ops/pallas_block.py:basic_block_fused`` (kernel in
``csrc/basic_block.cu``) and follows its formulas exactly
(``pallas_block.py:125-150``): with int32 conv sums acc1, acc2,

    h   = clip(rint(fma(acc1, s1, b1) * inv_mid), 0, 127), zero outside the image
    z   = clip(rint(fma(acc2, s2, b2) * inv_nxt), -127, 127)
    r   = clip(rint(x * rs), -127, 127)
    out = clip(z + r, 0, 127)

K4 replaces ``pallas_block.py:bottleneck_block_fused`` (kernel in
``csrc/bottleneck_block.cu``; formulas of ``pallas_block.py:207-238``):
conv1 1x1 (C4 -> CM), conv2 3x3 (CM -> CM), conv3 1x1 (CM -> C4),

    h1  = clip(rint(fma(acc1, s1, b1) * inv_h1), 0, 127), zero outside the image
    h2  = clip(rint(fma(acc2, s2, b2) * inv_h2), 0, 127)
    z   = clip(rint(fma(acc3, s3, b3) * inv_nxt), -127, 127)
    out = clip(z + clip(rint(x * rs), -127, 127), 0, 127)

The epilogues multiply by the inverse scales where the FullFusedCtx
composition divides, so about 1e-4 of elements may differ from the
composition by one step; the tests hold them to >= 0.999 agreement.

``pack_fused_blocks`` selects the same sites as the reference
(``pallas_block.py:343-372``): identity blocks with an int8 junction —
BasicBlocks with at least 128 channels (``{"layer2.1", "layer3.1"}`` on
ResNet-18), every such Bottleneck (11 on ResNet-50). The reference pads a
Bottleneck's mid width to 128 lanes (``pallas_block.py:383-388``); the
padded channels are zeros and change no output, so the port keeps CM.

``basic_block_fused`` / ``bottleneck_block_fused`` launch their kernel for a
CUDA tensor and run ``basic_block_plain`` / ``bottleneck_block_plain`` for a
CPU tensor. Each counts kernel launches (``.launches``), launches per
(N, H, W, C) or (N, H, W, C4, CM) (``.by_shape``) and per form
(``.by_form``).

K3 has two forms, picked by a static shape rule (``basic_block_form``,
mirroring ``dlq_basic_block_form``): the Hopper form wherever its item
geometry exists (strips whose conv1 rows on the W + 2 grid fit four 64-row
tiles: W + 2 <= 85), C is a multiple of 128 up to 512 and a plan fits
(``basic_block_plan``, mirroring ``csrc/basic_block.cu``'s
``hop::make_plan``: every ResNet-18/34 identity BasicBlock the reference
fuses), else the first form (one block per image and 8x8 tile), which stays
callable as ``basic_block_first``. Both give the same output on every
element.

K4 has two forms, picked by a static shape rule (``bottleneck_form``,
mirroring ``dlq_bottleneck_block_form``): the Hopper form wherever its
item geometry exists (an output grid W + 2 <= 128 wide) and a plan fits
(``bottleneck_plan``, mirroring ``csrc/bottleneck_block.cu``'s
``hop::make_plan``: every ResNet-50/101/152 identity Bottleneck), else the
first form (one block per image and 8x8 tile).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import (
    PackedConv, check_launch_args, check_weights, conv_acc_plain,
)
from dlq_tpu_torch.ops.qops import bias_or_zeros, combined_scale, int_weight_packed
from dlq_tpu_torch.quant.quantize import f32

Pack = Dict[str, object]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _site(qflat, act_scales, name):
    """K-major weights, combined epilogue scales and bias of one conv site."""
    p = qflat[name]
    pk = int_weight_packed(p["qw"])
    comb = combined_scale(f32(act_scales[name]), p["qw"], pk.oc)
    return pk, comb, bias_or_zeros(p.get("b"), pk.oc, pk.wk.device)


def pack_basic_block(qflat, act_scales, site: str, nxt: str) -> Pack:
    """Pack one identity BasicBlock (site.conv1/site.conv2). ``nxt`` is the
    junction consumer site (the next block's conv1). The inverse scales are
    taken in double precision and rounded once to fp32, as the reference
    packs them."""
    w1, s1, b1 = _site(qflat, act_scales, f"{site}.conv1")
    w2, s2, b2 = _site(qflat, act_scales, f"{site}.conv2")
    s_in = float(act_scales[f"{site}.conv1"])
    s_mid = float(act_scales[f"{site}.conv2"])
    s_nxt = float(act_scales[nxt])
    inv = (f32(1.0 / s_mid), f32(1.0 / s_nxt), f32(s_in / s_nxt))
    return {"inv": inv, "w1": w1, "s1": s1, "b1": b1, "w2": w2, "s2": s2, "b2": b2}


def pack_bottleneck_block(qflat, act_scales, site: str, nxt: str) -> Pack:
    """Pack one identity Bottleneck (site.conv1/conv2/conv3). The four
    inverse scales (1/s(conv2), 1/s(conv3), 1/s(nxt), s_in/s(nxt)) are taken
    in double precision and rounded once to fp32, as the reference packs
    them (``pallas_block.py:389-393``)."""
    w1, s1, b1 = _site(qflat, act_scales, f"{site}.conv1")
    w2, s2, b2 = _site(qflat, act_scales, f"{site}.conv2")
    w3, s3, b3 = _site(qflat, act_scales, f"{site}.conv3")
    s_in = float(act_scales[f"{site}.conv1"])
    s_nxt = float(act_scales[nxt])
    inv = (f32(1.0 / float(act_scales[f"{site}.conv2"])),
           f32(1.0 / float(act_scales[f"{site}.conv3"])), f32(1.0 / s_nxt), f32(s_in / s_nxt))
    return {"inv": inv, "w1": w1, "s1": s1, "b1": b1, "w2": w2, "s2": s2, "b2": b2,
            "w3": w3, "s3": s3, "b3": b3}


def pack_fused_blocks(qflat, act_scales, cfg) -> Dict[str, Pack]:
    """Pack every identity (stride-1, no-downsample) block that has an int8
    junction consumer — BasicBlocks only with >= 128 channels; {site: pack}.
    Mirrors qforward_fused2's site/nxt naming."""
    packs: Dict[str, Pack] = {}
    nb = cfg.blocks_per_stage
    for s in range(4):
        for b in range(nb[s]):
            stride = 2 if (s > 0 and b == 0) else 1
            site = f"layer{s+1}.{b}"
            if b + 1 < nb[s]:
                nxt = f"layer{s+1}.{b+1}.conv1"
            elif s < 3:
                nxt = f"layer{s+2}.0.conv1"
            else:
                nxt = None  # final junction stays fp32 (see qforward_fused2)
            if stride != 1 or nxt is None or f"{site}.down" in qflat:
                continue
            if cfg.bottleneck:
                packs[site] = pack_bottleneck_block(qflat, act_scales, site, nxt)
            elif qflat[f"{site}.conv1"]["qw"].layout_shape[2] >= 128:
                # the reference's selection leaves C=64 BasicBlocks out
                packs[site] = pack_basic_block(qflat, act_scales, site, nxt)
    return packs


def _requant_plain(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, inv: float,
                   lo: float) -> torch.Tensor:
    """clip(rint(fma(acc, scale, bias) * inv), lo, 127): the blocks' epilogue."""
    return torch.clamp(torch.round(torch.addcmul(bias, acc.float(), scale) * inv), lo, 127.0)


def basic_block_plain(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Plain PyTorch version of K3 (exact conv sums, the kernel's epilogues).
    Zero padding of h for conv2 is the reference's zeroed halo."""
    inv_mid, inv_nxt, rs = pack["inv"]
    w1: PackedConv = pack["w1"]
    w2: PackedConv = pack["w2"]
    acc1 = conv_acc_plain(x, w1.hwio(), 1, 1)
    h = _requant_plain(acc1, pack["s1"], pack["b1"], inv_mid, 0.0).to(torch.int8)
    acc2 = conv_acc_plain(h, w2.hwio(), 1, 1)
    z = _requant_plain(acc2, pack["s2"], pack["b2"], inv_nxt, -127.0)
    r = torch.clamp(torch.round(x.float() * rs), -127.0, 127.0)
    return torch.clamp(z + r, 0.0, 127.0).to(torch.int8).contiguous()


# K3's Hopper form (csrc/basic_block.cu: hop::geometry, hop::make_plan; a
# change to one is made in both places, and the card test holds the
# kernel's own plan to these): conv1 sum rows an item at most (four 64-row
# tiles, two a consumer), slices of 128 channels, 64-byte K stages, 3 to 8
# B stages, the opt-in shared-memory limit
BB_ROWS1, BB_NS, BB_STAGE, BB_SMEM_MAX = 256, 128, 64, 232448
BB_MAX_B, BB_MIN_B = 8, 3
SKIP_LUT = 256   # K3's and K4's table: the skip's requant of each int8 value


class BasicGeo(NamedTuple):
    gw: int      # grid width W + 2 (0: no geometry, the first form)
    toh: int     # output rows an item
    rb: int      # strips an image
    r1: int      # conv1 sum rows: (toh + 2) x gw
    r2: int      # conv2 sum rows: toh x gw
    mt1: int     # conv1 64-row tiles a consumer
    mt2: int     # conv2 64-row tiles a consumer
    spx1: int    # x slab pixels a 16-channel chunk
    spx2: int    # h slab pixels a 16-channel chunk


class BasicPlan(NamedTuple):
    ns: int        # slice width (0: no plan, the first form)
    b_stages: int
    smem: int
    items: int
    grid: int


NO_BB_GEO = BasicGeo(0, 0, 0, 0, 0, 0, 0, 0, 0)
NO_BB_PLAN = BasicPlan(0, 0, 0, 0, 0)


def basic_block_geometry(h: int, w: int) -> BasicGeo:
    """K3's items: strips of TOH full-width output rows of one image, the
    most with (TOH + 2) x (W + 2) <= 256 conv1 sum rows, balanced over the
    image. Each consumer takes MT contiguous 64-row tiles of a conv's sum
    rows. A slab chunk holds the TMA box's rows x GW pixels (x: TOH + 4
    rows, h: TOH + 2) and the pixels the tiles read (2 MT x 64 rows plus the
    largest tap shift 2 GW + 2), rounded up to 8."""
    gw = w + 2
    if h <= 0 or w <= 0:
        return NO_BB_GEO
    t0 = BB_ROWS1 // gw - 2
    if t0 < 1:
        return NO_BB_GEO
    rb = _cdiv(h, t0)
    toh = _cdiv(h, rb)
    r1, r2 = (toh + 2) * gw, toh * gw
    mt1, mt2 = _cdiv(_cdiv(r1, 64), 2), _cdiv(_cdiv(r2, 64), 2)
    spx1 = _cdiv(max((toh + 4) * gw, 128 * mt1 + 2 * gw + 2), 8) * 8
    spx2 = _cdiv(max((toh + 2) * gw, 128 * mt2 + 2 * gw + 2), 8) * 8
    return BasicGeo(gw, toh, rb, r1, r2, mt1, mt2, spx1, spx2)


def basic_block_plan(n: int, h: int, w: int, c: int, sms: int) -> BasicPlan:
    """K3's Hopper plan for a batch of n images on ``sms`` SMs: C a multiple
    of 128 up to 512, slices of 128 channels; the most B stages that fit (3
    to 8) beside the x and h slabs (C x SPX each), the output staging (64
    rows of NS + 16 bytes), the skip's 256-byte table and 16 bytes of
    mbarriers a stage and 16 more. One block per SM at most, walking items
    b, b + grid, ..."""
    g = basic_block_geometry(h, w)
    if g.gw == 0 or c <= 0 or c % BB_NS or c > 512:
        return NO_BB_PLAN
    fixed = c * (g.spx1 + g.spx2) + 64 * (BB_NS + 16) + SKIP_LUT + 16
    sb = min(BB_MAX_B, (BB_SMEM_MAX - fixed) // (BB_NS * BB_STAGE + 16))
    if sb < BB_MIN_B:
        return NO_BB_PLAN
    items = n * g.rb
    return BasicPlan(BB_NS, sb, fixed + sb * (BB_NS * BB_STAGE + 16), items, min(items, sms))


def basic_block_form(h: int, w: int, c: int) -> str:
    """K3's form: ``"hopper"`` where the geometry exists and a plan fits
    (neither depends on the batch or the card), else ``"first"``."""
    return "hopper" if basic_block_plan(1, h, w, c, 1).ns else "first"


@functools.cache
def basic_block_launch_form(h: int, w: int, c: int) -> str:
    """The form the kernel library takes for this block (its own rule)."""
    fn = _build.library("basic_block").dlq_basic_block_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return "hopper" if fn(h, w, c) else "first"


@functools.cache
def _entry(name: str = "dlq_basic_block"):
    fn = getattr(_build.library("basic_block"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return fn


def _launch_basic(x: torch.Tensor, pack: Pack, name: str) -> torch.Tensor:
    w1: PackedConv = pack["w1"]
    w2: PackedConv = pack["w2"]
    check_launch_args("basic_block_fused", x, w1, pack["s1"], pack["b1"])
    check_launch_args("basic_block_fused", x, w2, pack["s2"], pack["b2"])
    n, h, w, c = x.shape
    if (w1.kh, w1.kw, w1.oc) != (3, 3, c) or (w2.kh, w2.kw, w2.oc) != (3, 3, c):
        raise ValueError("basic_block_fused: identity block needs 3x3 C->C convs")
    if c % 64 or c > 512:
        raise ValueError(f"basic_block_fused: C={c} must be a multiple of 64 up to 512")
    if name == "dlq_basic_block" and basic_block_launch_form(h, w, c) == "hopper":
        for key in ("s1", "b1", "s2", "b2"):   # the Hopper epilogue's float2 loads
            if pack[key].data_ptr() % 8:
                raise ValueError(f"basic_block_fused: {key} must be 8-byte aligned")
    out = torch.empty_like(x)
    inv_mid, inv_nxt, rs = pack["inv"]
    rc = _entry(name)(x.data_ptr(), w1.wk.data_ptr(), pack["s1"].data_ptr(), pack["b1"].data_ptr(),
                      w2.wk.data_ptr(), pack["s2"].data_ptr(), pack["b2"].data_ptr(),
                      out.data_ptr(), n, h, w, c, w1.wk.shape[1], inv_mid, inv_nxt, rs,
                      _build.stream_ptr(x.device))
    _build.check(rc, name)
    return out


def basic_block_fused(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Identity BasicBlock on int8 NHWC activations at the conv1 site scale;
    returns int8 NHWC at the next site's scale. x is 16-byte aligned (as
    every int8 kernel takes it); where the Hopper form is taken, s1, b1,
    s2 and b2 are 8-byte aligned too."""
    if x.device.type == "cpu":
        return basic_block_plain(x, pack)
    out = _launch_basic(x, pack, "dlq_basic_block")
    n, h, w, c = x.shape
    basic_block_fused.launches += 1
    basic_block_fused.by_shape[(n, h, w, c)] += 1
    basic_block_fused.by_form[basic_block_launch_form(h, w, c)] += 1
    return out


def basic_block_first(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """K3's first form at any shape it takes (a CUDA tensor only; not
    counted): what the card tests and ``chip_smoke.py`` hold the Hopper
    form to, output for output."""
    if x.device.type != "cuda":
        raise ValueError("basic_block_first: a CUDA tensor (the kernel's first form)")
    return _launch_basic(x, pack, "dlq_basic_block_first")


basic_block_fused.launches = 0
basic_block_fused.by_shape = collections.Counter()
basic_block_fused.by_form = collections.Counter()


def bottleneck_block_plain(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Plain PyTorch version of K4 (exact conv sums, the kernel's epilogues).
    Zero padding of h1 for conv2 is the reference's zeroed halo."""
    inv_h1, inv_h2, inv_nxt, rs = pack["inv"]
    acc1 = conv_acc_plain(x, pack["w1"].hwio(), 1, 0)
    h1 = _requant_plain(acc1, pack["s1"], pack["b1"], inv_h1, 0.0).to(torch.int8)
    acc2 = conv_acc_plain(h1, pack["w2"].hwio(), 1, 1)
    h2 = _requant_plain(acc2, pack["s2"], pack["b2"], inv_h2, 0.0).to(torch.int8)
    acc3 = conv_acc_plain(h2, pack["w3"].hwio(), 1, 0)
    z = _requant_plain(acc3, pack["s3"], pack["b3"], inv_nxt, -127.0)
    r = torch.clamp(torch.round(x.float() * rs), -127.0, 127.0)
    return torch.clamp(z + r, 0.0, 127.0).to(torch.int8).contiguous()


# K4's Hopper form (csrc/bottleneck_block.cu: hop::geometry, hop::make_plan;
# a change to one is made in both places, and the card test holds the
# kernel's own plan to these): 128 sum rows a pass (two consumers of 64),
# 64-byte K stages, A stages of two 64-row boxes, slice widths widest first,
# 4 down to 2 A stages, 3 to 8 B stages, the opt-in shared-memory limit
BN_PASS, BN_STAGE, BN_SMEM_MAX = 128, 64, 232448
BN_A_STAGE = BN_PASS * BN_STAGE
BN_WIDTHS = (256, 128, 64)
BN_MAX_A, BN_MIN_A, BN_MAX_B, BN_MIN_B = 4, 2, 8, 3


class BottleneckGeo(NamedTuple):
    gw: int       # grid width W + 2 (0: no geometry, the first form)
    toh: int      # output rows an item (an image's, when imgs == 2)
    rb: int       # strips an image
    imgs: int     # images an item (2: one per consumer)
    m1: int       # conv1 rows a region: (toh + 2) x W
    passes: int   # conv1 passes of 128 rows
    spx: int      # slab pixels a 16-channel chunk


class BottleneckPlan(NamedTuple):
    nsmax: int     # the widest slice (0: no plan, the first form)
    ns12: int      # conv1 / conv2 slice: min(CM, nsmax)
    ns3: int       # conv3 slice
    a_stages: int
    b_stages: int  # 0: the three weights are resident
    smem: int
    items: int
    grid: int


NO_BN_GEO = BottleneckGeo(0, 0, 0, 0, 0, 0, 0)
NO_BN_PLAN = BottleneckPlan(0, 0, 0, 0, 0, 0, 0, 0)


def bottleneck_geometry(h: int, w: int) -> BottleneckGeo:
    """K4's items: where a whole image's conv1 rows ((H + 2) x W, the halo
    rows included) and conv2 sum rows (H x (W + 2), on the slab's grid)
    each fit 64, two images an item, one per consumer; else strips of TOH
    full-width output rows of one image, at most 128 // (W + 2), balanced
    over the image. A slab chunk holds the item's (TOH + 2) x GW pixels and
    the sum rows plus the largest tap shift, rounded up to 8."""
    gw = w + 2
    if h <= 0 or w <= 0:
        return NO_BN_GEO
    if (h + 2) * w <= 64 and h * gw <= 64:
        imgs, toh, rb = 2, h, 1
    else:
        t0 = BN_PASS // gw
        if t0 == 0:
            return NO_BN_GEO
        rb = _cdiv(h, t0)
        imgs, toh = 1, _cdiv(h, rb)
    m1 = (toh + 2) * w
    passes = 1 if imgs == 2 else _cdiv(m1, BN_PASS)
    rows = 64 if imgs == 2 else BN_PASS
    spx = _cdiv(max(rows + 2 * gw + 2, (toh + 2) * gw), 8) * 8
    return BottleneckGeo(gw, toh, rb, imgs, m1, passes, spx)


def bottleneck_plan(n: int, h: int, w: int, c4: int, cm: int, sms: int) -> BottleneckPlan:
    """K4's Hopper plan for a batch of n images on ``sms`` SMs. Of the
    widths 256, 128, 64 (conv1/conv2 slices min(CM, width), conv3 slices
    the width, each dividing its N), the widest that fits: the three
    weights resident with the most A stages (4 down to 2), else a B ring
    of max(ns12, ns3) x 64-byte stages, the most that fit (3 to 8), beside
    the most A stages that leave them. Shared memory: weights or B ring, A
    ring (8,192 a stage), the h1 slabs (imgs x CM x SPX), h2 (128 x CM),
    the output staging (64 rows of NS3 + 16 bytes), the skip's 256-byte
    table, 16 bytes of mbarriers a stage and 16 more. One block per SM at
    most, walking items b, b + grid, ..."""
    g = bottleneck_geometry(h, w)
    if g.gw == 0 or cm <= 0 or cm % 64 or cm > 512 or c4 <= 0 or c4 % 64:
        return NO_BN_PLAN
    wb = 2 * cm * c4 + 9 * cm * cm
    best = None
    for nsmax in BN_WIDTHS:
        ns12, ns3 = min(cm, nsmax), nsmax
        if cm % ns12 or c4 % ns3 or ns12 not in BN_WIDTHS:
            continue
        fixed = g.imgs * cm * g.spx + BN_PASS * cm + 64 * (ns3 + 16) + SKIP_LUT
        for sa in range(BN_MAX_A, BN_MIN_A - 1, -1):
            nbytes = wb + sa * BN_A_STAGE + fixed + 16 * (sa + 1)
            if nbytes <= BN_SMEM_MAX:
                best = (nsmax, ns12, ns3, sa, 0, nbytes)
                break
        if best is None:
            bst = max(ns12, ns3) * BN_STAGE

            def b_stages(sa):
                return (BN_SMEM_MAX - fixed - sa * BN_A_STAGE - 16 * (sa + 1)) // (bst + 16)

            for sa in range(BN_MAX_A, BN_MIN_A - 1, -1):
                sb = min(BN_MAX_B, b_stages(sa))
                # the most B stages first, then the most A stages beside them
                if sb >= BN_MIN_B and (sa == BN_MIN_A or sb >= BN_MAX_B
                                       or b_stages(sa - 1) == sb):
                    best = (nsmax, ns12, ns3, sa, sb,
                            fixed + sa * BN_A_STAGE + sb * bst + 16 * (sa + sb + 1))
                    break
        if best is not None:
            break
    if best is None:
        return NO_BN_PLAN
    items = _cdiv(n, g.imgs) * g.rb
    return BottleneckPlan(*best, items, min(items, sms))


def bottleneck_form(h: int, w: int, c4: int, cm: int) -> str:
    """K4's form: ``"hopper"`` where the geometry exists and a plan fits
    (neither depends on the batch or the card), else ``"first"``."""
    return "hopper" if bottleneck_plan(1, h, w, c4, cm, 1).nsmax else "first"


@functools.cache
def bottleneck_launch_form(h: int, w: int, c4: int, cm: int) -> str:
    """The form the kernel library takes for this block (its own rule)."""
    fn = _build.library("bottleneck_block").dlq_bottleneck_block_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return "hopper" if fn(h, w, c4, cm) else "first"


@functools.cache
def _bottleneck_entry():
    fn = _build.library("bottleneck_block").dlq_bottleneck_block
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def bottleneck_block_fused(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Identity Bottleneck on int8 NHWC activations at the conv1 site scale;
    returns int8 NHWC at the next site's scale."""
    if x.device.type == "cpu":
        return bottleneck_block_plain(x, pack)
    w1: PackedConv = pack["w1"]
    w2: PackedConv = pack["w2"]
    w3: PackedConv = pack["w3"]
    n, h, w, c4 = x.shape
    cm = w1.oc
    check_launch_args("bottleneck_block_fused", x, w1, pack["s1"], pack["b1"])
    if ((w1.kh, w1.kw) != (1, 1) or (w2.kh, w2.kw, w2.c, w2.oc) != (3, 3, cm, cm)
            or (w3.kh, w3.kw, w3.c, w3.oc) != (1, 1, cm, c4)):
        raise ValueError("bottleneck_block_fused: identity block needs 1x1 C4->CM, "
                         "3x3 CM->CM and 1x1 CM->C4 convs")
    check_weights("bottleneck_block_fused", x.device, w2, pack["s2"], pack["b2"])
    check_weights("bottleneck_block_fused", x.device, w3, pack["s3"], pack["b3"])
    if cm % 64 or cm > 512 or c4 % 64:
        raise ValueError(f"bottleneck_block_fused: CM={cm} must be a multiple of 64 up to 512 "
                         f"and C4={c4} a multiple of 64")
    for name in ("s1", "b1", "s2", "b2", "s3", "b3"):
        if pack[name].data_ptr() % 8:
            raise ValueError(f"bottleneck_block_fused: {name} must be 8-byte aligned")
    out = torch.empty_like(x)
    inv_h1, inv_h2, inv_nxt, rs = pack["inv"]
    rc = _bottleneck_entry()(
        x.data_ptr(), w1.wk.data_ptr(), pack["s1"].data_ptr(), pack["b1"].data_ptr(),
        w2.wk.data_ptr(), pack["s2"].data_ptr(), pack["b2"].data_ptr(),
        w3.wk.data_ptr(), pack["s3"].data_ptr(), pack["b3"].data_ptr(), out.data_ptr(),
        n, h, w, c4, cm, inv_h1, inv_h2, inv_nxt, rs, _build.stream_ptr(x.device))
    _build.check(rc, "bottleneck_block_fused")
    bottleneck_block_fused.launches += 1
    bottleneck_block_fused.by_shape[(n, h, w, c4, cm)] += 1
    bottleneck_block_fused.by_form[bottleneck_launch_form(h, w, c4, cm)] += 1
    return out


bottleneck_block_fused.launches = 0
bottleneck_block_fused.by_shape = collections.Counter()
bottleneck_block_fused.by_form = collections.Counter()
