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
CPU tensor. Each counts kernel launches (``.launches``) and launches per
(N, H, W, C) or (N, H, W, C4, CM) (``.by_shape``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import (
    PackedConv, check_launch_args, check_weights, conv_acc_plain,
)
from dlq_tpu_torch.ops.qops import bias_or_zeros, combined_scale, int_weight_packed
from dlq_tpu_torch.quant.quantize import f32

Pack = Dict[str, object]


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


@functools.cache
def _entry():
    fn = _build.library("basic_block").dlq_basic_block
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return fn


def basic_block_fused(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Identity BasicBlock on int8 NHWC activations at the conv1 site scale;
    returns int8 NHWC at the next site's scale."""
    if x.device.type == "cpu":
        return basic_block_plain(x, pack)
    w1: PackedConv = pack["w1"]
    w2: PackedConv = pack["w2"]
    check_launch_args("basic_block_fused", x, w1, pack["s1"], pack["b1"])
    check_launch_args("basic_block_fused", x, w2, pack["s2"], pack["b2"])
    n, h, w, c = x.shape
    if (w1.kh, w1.kw, w1.oc) != (3, 3, c) or (w2.kh, w2.kw, w2.oc) != (3, 3, c):
        raise ValueError("basic_block_fused: identity block needs 3x3 C->C convs")
    if c % 64 or c > 512:
        raise ValueError(f"basic_block_fused: C={c} must be a multiple of 64 up to 512")
    out = torch.empty_like(x)
    inv_mid, inv_nxt, rs = pack["inv"]
    rc = _entry()(x.data_ptr(), w1.wk.data_ptr(), pack["s1"].data_ptr(), pack["b1"].data_ptr(),
                  w2.wk.data_ptr(), pack["s2"].data_ptr(), pack["b2"].data_ptr(),
                  out.data_ptr(), n, h, w, c, w1.wk.shape[1], inv_mid, inv_nxt, rs,
                  _build.stream_ptr(x.device))
    _build.check(rc, "basic_block_fused")
    basic_block_fused.launches += 1
    basic_block_fused.by_shape[(n, h, w, c)] += 1
    return out


basic_block_fused.launches = 0
basic_block_fused.by_shape = collections.Counter()


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
    return out


bottleneck_block_fused.launches = 0
bottleneck_block_fused.by_shape = collections.Counter()
