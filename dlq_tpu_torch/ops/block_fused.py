"""K3: one identity ResNet BasicBlock, int8 in to int8 out, in one kernel.

Replaces ``dlq_tpu/ops/pallas_block.py:basic_block_fused`` (kernel in
``csrc/basic_block.cu``) and follows its formulas exactly
(``pallas_block.py:125-150``): with int32 conv sums acc1, acc2,

    h   = clip(rint(fma(acc1, s1, b1) * inv_mid), 0, 127), zero outside the image
    z   = clip(rint(fma(acc2, s2, b2) * inv_nxt), -127, 127)
    r   = clip(rint(x * rs), -127, 127)
    out = clip(z + r, 0, 127)

The epilogues multiply by the inverse scales where the FullFusedCtx
composition divides, so about 1e-4 of elements may differ from the
composition by one step; the test holds them to >= 0.999 agreement.

``pack_fused_blocks`` selects the same sites as the reference
(``pallas_block.py:343-372``): identity blocks with an int8 junction and at
least 128 channels — ``{"layer2.1", "layer3.1"}`` on ResNet-18.

``basic_block_fused`` launches the kernel for a CUDA tensor and runs
``basic_block_plain`` for a CPU tensor. ``basic_block_fused.launches``
counts kernel launches, ``basic_block_fused.by_shape`` counts them per
(N, H, W, C).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import PackedConv, check_launch_args, conv_acc_plain
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


def pack_fused_blocks(qflat, act_scales, cfg) -> Dict[str, Pack]:
    """Pack every identity (stride-1, no-downsample) BasicBlock that has an
    int8 junction consumer and >= 128 channels; {site: pack}. Mirrors
    qforward_fused2's site/nxt naming."""
    if cfg.bottleneck:
        raise NotImplementedError(
            "bottleneck_block_fused is not ported yet (ROADMAP.md, queue B)")
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
            if qflat[f"{site}.conv1"]["qw"].layout_shape[2] < 128:
                continue  # the reference's selection leaves C=64 blocks out
            packs[site] = pack_basic_block(qflat, act_scales, site, nxt)
    return packs


def basic_block_plain(x: torch.Tensor, pack: Pack) -> torch.Tensor:
    """Plain PyTorch version of K3 (exact conv sums, the kernel's epilogues).
    Zero padding of h for conv2 is the reference's zeroed halo."""
    inv_mid, inv_nxt, rs = pack["inv"]
    w1: PackedConv = pack["w1"]
    w2: PackedConv = pack["w2"]
    acc1 = conv_acc_plain(x, w1.hwio(), 1, 1)
    h = torch.round(torch.addcmul(pack["b1"], acc1.float(), pack["s1"]) * inv_mid)
    h = torch.clamp(h, 0.0, 127.0).to(torch.int8)
    acc2 = conv_acc_plain(h, w2.hwio(), 1, 1)
    z = torch.round(torch.addcmul(pack["b2"], acc2.float(), pack["s2"]) * inv_nxt)
    z = torch.clamp(z, -127.0, 127.0)
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
