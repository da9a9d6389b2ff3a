"""The launch plan of the Hopper form that K1 (``csrc/conv_int8.cu``) and K2
(``csrc/matmul_int8.cu``) share (``csrc/i8plan.cuh``: make_plan, conv_geo),
mirrored on the host, and the static rule that picks each launch's form.
The constants and the byte count below are the source's; a change to one is
made in both places, and the card tests hold the kernels' own plans
(``dlq_matmul_int8_plan``, ``dlq_conv_int8_plan``) and forms
(``dlq_matmul_int8_form``, ``dlq_conv_int8_form``) to these functions.

The forms: K2 takes the Hopper form when K % 16 == 0 (TMA needs the rows of
x 16-byte aligned), else its first form. K1 takes it for a 1x1 or 3x3 conv
with pad k // 2 at stride 1 or 2 whose C is a multiple of 64 (a 64-byte
weight stage holds one tap's channels) and whose output grid (OW plus the
halo) is at most 128 wide, else its first form (the C=3 stems, small CPU
shapes). Every conv and dense of ResNet-18/50 ``fused2`` and of DeiT-Tiny's
deploy path takes the Hopper form.
"""

from __future__ import annotations

from typing import NamedTuple

# 128 sum rows an item (two consumers of 64), 64-byte K stages, slice widths
# widest first, 8 down to 3 ring stages, at least 4 A stages beside a
# resident slice, K1's 2 A stages beside a streamed ring, the opt-in
# shared-memory limit, 8 consumer warps each staging 8 output rows
I8_TILE, I8_STAGE, SMEM_MAX = 128, 64, 232448
I8_WIDTHS = (256, 192, 128, 64)
MAX_STAGES, MIN_STAGES, RES_A_STAGES, CONV_A_STAGES = 8, 3, 4, 2
STAGED_ROWS = 8 * 8
K2_A_STAGE = I8_TILE * I8_STAGE


class Plan(NamedTuple):
    ns: int          # slice width (0: no plan fits)
    slices: int
    a_stages: int
    b_stages: int    # 0: the weight's one slice is resident
    smem: int
    grid: int


class ConvGeo(NamedTuple):
    gw: int          # grid width: OW plus the halo columns (0: the first form)
    toh: int         # output rows an item (an image's, when imgs == 2)
    rb: int          # row blocks an image
    imgs: int        # images an item (2: one per consumer)
    spx: int         # slab pixels a 16-channel chunk
    planes: int      # phase planes (4 at 3x3 / stride 2)


NO_PLAN = Plan(0, 0, 0, 0, 0, 0)
NO_GEO = ConvGeo(0, 0, 0, 0, 0, 0)


def staging_row(ns: int, int8_out: bool) -> int:
    """Bytes of a staged output row: int8 rows ns + 16, fp32 rows 4 ns + 32
    (padded so that a warp's stores of 8 rows hit distinct banks)."""
    return ns + 16 if int8_out else 4 * ns + 32


def plan_bytes(ns: int, sa: int, sb: int, kp: int, a_bytes: int, int8_out: bool) -> int:
    """Shared-memory bytes: the B ring (sb stages of ns x 64) or the resident
    slice (ns x Kp), the A ring, the epilogue table (8 bytes a column), the
    output staging, 16 bytes of mbarriers a stage and 16 more."""
    b = sb * ns * I8_STAGE if sb > 0 else ns * kp
    return (b + sa * a_bytes + 8 * ns + STAGED_ROWS * staging_row(ns, int8_out)
            + 16 * (sa + sb + 1))


def make_plan(units: int, n: int, kp: int, taps: int, a_bytes: int, int8_out: bool,
              sms: int) -> Plan:
    """The plan for ``units`` A units, N columns, padded depth Kp, ``taps`` B
    stages an A stage and A stages of ``a_bytes``, on ``sms`` SMs. Each width
    up to N rounded up to 64 takes, with one slice, a resident slice and the
    most A stages (8 down to 4) that fit; else a streamed ring: K2 (taps 1)
    the most paired stages (8 down to 3), K1 two A stages and the most B
    stages. Of those the fewest padded columns wins, the wider on a tie; when
    that leaves fewer items than SMs, width 64. The grid is a multiple of the
    slice count (a block keeps its slice), at most one block per SM."""
    best = narrow = None
    for ns in I8_WIDTHS:
        if ns > -(-n // 64) * 64:
            continue
        slices = -(-n // ns)
        p = None
        if slices == 1:
            for sa in range(MAX_STAGES, RES_A_STAGES - 1, -1):
                nbytes = plan_bytes(ns, sa, 0, kp, a_bytes, int8_out)
                if nbytes <= SMEM_MAX:
                    p = (ns, 1, sa, 0, nbytes)
                    break
        if p is None:
            for sb in range(MAX_STAGES, MIN_STAGES - 1, -1):
                sa = sb if taps == 1 else CONV_A_STAGES
                nbytes = plan_bytes(ns, sa, sb, kp, a_bytes, int8_out)
                if nbytes <= SMEM_MAX:
                    p = (ns, slices, sa, sb, nbytes)
                    break
        if p is None:
            continue
        if best is None or p[1] * p[0] < best[1] * best[0]:
            best = p
        if ns == 64:
            narrow = p
    if best is None:
        return NO_PLAN
    if units * best[1] < sms and narrow is not None:
        best = narrow
    slices = best[1]
    grid = slices * min(units, sms // slices) if slices <= sms else sms
    return Plan(*best, grid)


def matmul_int8_form(k: int) -> str:
    """K2's form: ``"hopper"``, or ``"first"`` for K % 16 != 0."""
    return "hopper" if k % 16 == 0 else "first"


def matmul_int8_plan(m: int, n: int, kp: int, int8_out: bool, sms: int) -> Plan:
    """K2's Hopper plan for x [M, K] @ [K, N] (Kp: K padded to 64): A stages
    of 128 rows x 64 bytes paired with B stages."""
    return make_plan(-(-m // I8_TILE), n, kp, 1, K2_A_STAGE, int8_out, sms)


def conv_geometry(h: int, w: int, c: int, k: int, stride: int, pad: int) -> ConvGeo:
    """K1's slab geometry for an H x W x C input and a k x k kernel, or
    ``NO_GEO`` where the Hopper form does not take the conv. The output
    rows of an item lie on a grid GW = OW + e wide (e = (k - 1) // stride
    halo columns, computed and dropped); an image whose OH x GW rows fit 64
    goes to one consumer whole (two images an item), else items of TOH rows
    (at most 128 // GW, balanced over the image); a chunk's slab holds the
    128 (or 64) sum rows plus the largest tap shift, rounded up to 8."""
    if c % 64 or k not in (1, 3) or pad != k // 2 or stride not in (1, 2):
        return NO_GEO
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    e = (k - 1) // stride
    gw = ow + e
    if oh <= 0 or ow <= 0 or gw > I8_TILE:
        return NO_GEO
    if oh * gw <= 64:
        imgs, toh, rb = 2, oh, 1
    else:
        t0 = I8_TILE // gw
        rb = -(-oh // t0)
        imgs, toh = 1, -(-oh // rb)
    spx = -(-((I8_TILE if imgs == 1 else 64) + e * gw + e) // 8) * 8
    return ConvGeo(gw, toh, rb, imgs, spx, 4 if stride == 2 and k == 3 else 1)


def conv_a_bytes(g: ConvGeo) -> int:
    """Bytes of K1's A stage: the item's slabs for 64 channels (four
    16-channel chunks a plane and image)."""
    return g.imgs * g.planes * 4 * g.spx * 16


def conv_int8_plan(n: int, h: int, w: int, c: int, oc: int, k: int, stride: int, pad: int,
                   int8_out: bool, sms: int) -> Plan:
    """K1's Hopper plan (``NO_PLAN``: the first form)."""
    g = conv_geometry(h, w, c, k, stride, pad)
    if g.gw == 0:
        return NO_PLAN
    units = -(-n // g.imgs) * g.rb
    return make_plan(units, oc, k * k * c, k * k, conv_a_bytes(g), int8_out, sms)


def conv_int8_form(h: int, w: int, c: int, oc: int, k: int, stride: int, pad: int,
                   int8_out: bool) -> str:
    """K1's form: ``"hopper"`` where the slab geometry exists and a plan
    fits (neither depends on the batch or the card), else ``"first"``."""
    return "hopper" if conv_int8_plan(1, h, w, c, oc, k, stride, pad, int8_out, 1).ns else "first"


def conv_taps(k: int, stride: int, gw: int):
    """(plane, shift) of each tap (kh, kw) in K order: the slab plane it
    reads and how many pixels its rows lie past the sum row's (conv_int8.cu
    computes each tap's byte offset as (plane x 4 x spx + shift) x 16)."""
    planes = 4 if stride == 2 and k == 3 else 1
    out = []
    for t in range(k * k):
        kh, kw = divmod(t, k)
        plane = (kh % 2) * 2 + kw % 2 if planes == 4 else 0
        out.append((plane, (kh // stride) * gw + kw // stride))
    return out
