"""MobileNetV2 in NHWC (the counterpart of ``dlq_tpu.models.mobilenetv2``):
stem conv3x3/s2 -> 17 inverted residual blocks (expand 1x1 -> depthwise 3x3
-> project 1x1, residual when stride 1 and cin == cout) -> head conv1x1
(1280) -> GAP -> FC, relu6 activations; depthwise = grouped conv with
groups == C (HWIO weights ``[3, 3, 1, C]``).

The quantized forwards run every 1x1 conv and the fc on K2, the stem on K1
and every depthwise conv on K23 (``ops.depthwise_int8``). The training
forward and ``apply_bn_updates`` are not ported yet (ROADMAP.md, A.12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dlq_tpu_torch.models.common import (
    batchnorm_inference,
    conv2d,
    dense,
    fold_bn,
    global_avgpool,
    init_bn,
    kaiming_normal,
    relu6,
)
from dlq_tpu_torch.models.registry import register

Params = Dict[str, Any]

# (expansion t, out channels c, repeats n, stride s): MobileNetV2 paper, table 2
_BLOCKS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@dataclasses.dataclass(frozen=True)
class MobileNetV2Config:
    num_classes: int = 1000
    in_channels: int = 3
    width_mult: float = 1.0
    small_input: bool = False  # CIFAR variant: stem stride 1

    def ch(self, c: int) -> int:
        v = int(c * self.width_mult + 4) // 8 * 8
        return max(8, v)


def block_meta(cfg: MobileNetV2Config) -> List[Dict[str, Any]]:
    """Static per-block topology: stride, residual, expansion presence,
    channel counts."""
    meta: List[Dict[str, Any]] = []
    cin = cfg.ch(32)
    for t, c, n, s in _BLOCKS:
        cout = cfg.ch(c)
        for i in range(n):
            stride = s if i == 0 else 1
            meta.append({
                "stride": stride,
                "has_res": stride == 1 and cin == cout,
                "expand": t != 1,
                "cin": cin, "cout": cout, "hidden": cin * t,
            })
            cin = cout
    return meta


def _init_conv_bn(rng, kh: int, kw: int, cin: int, cout: int, groups: int = 1) -> Params:
    return {"w": kaiming_normal(rng, (kh, kw, cin // groups, cout),
                                fan_out=kh * kw * cout // groups),
            "bn": init_bn(cout)}


def init_mobilenetv2(seed: int, cfg: MobileNetV2Config) -> Params:
    """Random weights from a numpy generator seeded with ``seed`` (CPU
    tensors; engines move them to their device)."""
    rng = np.random.default_rng(seed)
    params: Params = {"stem": _init_conv_bn(rng, 3, 3, cfg.in_channels, cfg.ch(32))}
    blocks: List[Params] = []
    for m in block_meta(cfg):
        bp: Params = {}
        if m["expand"]:
            bp["expand"] = _init_conv_bn(rng, 1, 1, m["cin"], m["hidden"])
        bp["dw"] = _init_conv_bn(rng, 3, 3, m["hidden"], m["hidden"], groups=m["hidden"])
        bp["project"] = _init_conv_bn(rng, 1, 1, m["hidden"], m["cout"])
        blocks.append(bp)
    params["blocks"] = blocks
    cin, chead = block_meta(cfg)[-1]["cout"], cfg.ch(1280)
    params["head"] = _init_conv_bn(rng, 1, 1, cin, chead)
    bound = 1.0 / (chead ** 0.5)
    params["fc"] = {
        "w": torch.from_numpy(rng.uniform(-bound, bound, (chead, cfg.num_classes))
                              .astype(np.float32)),
        "b": torch.zeros(cfg.num_classes),
    }
    return params


def _conv_bn_act(x, p, stride=1, padding=0, groups=1, act=True):
    y = batchnorm_inference(conv2d(x, p["w"], stride=stride, padding=padding, groups=groups),
                            p["bn"])
    return relu6(y) if act else y


def mobilenetv2_forward(params: Params, x: torch.Tensor, cfg: MobileNetV2Config,
                        taps: bool = False):
    """NHWC input -> logits (fp32, inference BN). With taps, also the output
    of the stem and of every block, the pooled vector and the logits."""
    t: Dict[str, torch.Tensor] = {}
    y = _conv_bn_act(x, params["stem"], stride=1 if cfg.small_input else 2, padding=1)
    if taps:
        t["stem"] = y
    for i, (bp, m) in enumerate(zip(params["blocks"], block_meta(cfg))):
        inp = y
        if "expand" in bp:
            y = _conv_bn_act(y, bp["expand"])
        y = _conv_bn_act(y, bp["dw"], stride=m["stride"], padding=1, groups=m["hidden"])
        y = _conv_bn_act(y, bp["project"], act=False)
        if m["has_res"]:
            y = y + inp
        if taps:
            t[f"block{i}"] = y
    y = _conv_bn_act(y, params["head"])
    g = global_avgpool(y)
    logits = dense(g, params["fc"]["w"], params["fc"]["b"])
    if taps:
        t["gap"], t["logits"] = g, logits
        return logits, t
    return logits


# ---------------------------------------------------------------------------
# folded / quantized path
# ---------------------------------------------------------------------------

def fold_mobilenetv2(params: Params) -> Params:
    """Fold BN into convs -> flat {site: {w, b}} for the quantizer."""
    flat: Params = {}

    def fold(name, p):
        w, b = fold_bn(p["w"], None, p["bn"])
        flat[name] = {"w": w, "b": b}

    fold("stem", params["stem"])
    for i, bp in enumerate(params["blocks"]):
        if "expand" in bp:
            fold(f"block{i}.expand", bp["expand"])
        fold(f"block{i}.dw", bp["dw"])
        fold(f"block{i}.project", bp["project"])
    fold("head", params["head"])
    flat["fc"] = {"w": params["fc"]["w"], "b": params["fc"]["b"]}
    return flat


def make_qforward(meta: List[Dict[str, Any]]):
    """The ctx-based quantized forward for a topology: every conv quantizes
    its input, depthwise convs on the grouped route (K23), relu6 on the fp32
    interchange between ops."""

    def qforward(ctx, x, cfg, taps: bool = False):
        t: Dict[str, torch.Tensor] = {}
        y = relu6(ctx.conv("stem", x, stride=1 if cfg.small_input else 2, padding=1))
        for i, m in enumerate(meta):
            inp = y
            if m["expand"]:
                y = relu6(ctx.conv(f"block{i}.expand", y))
            y = relu6(ctx.conv(f"block{i}.dw", y, stride=m["stride"], padding=1,
                               groups=m["hidden"]))
            y = ctx.conv(f"block{i}.project", y)
            if m["has_res"]:
                y = y + inp
            if taps:
                t[f"block{i}"] = y
        y = relu6(ctx.conv("head", y))
        g = global_avgpool(y)
        logits = ctx.dense("fc", g)
        if taps:
            t["gap"], t["logits"] = g, logits
            return logits, t
        return logits

    return qforward


def make_qforward_fused(meta: List[Dict[str, Any]]):
    """Fully-int8 interchange MobileNetV2 (use with FullFusedCtx): every
    expand / dw / project tensor travels int8 with relu6 folded into the
    requantizing epilogue; residual adds use shared-scale int arithmetic.
    The consumer-scale chain: expand feeds dw, dw feeds project, project
    feeds the next block's first conv (or the head)."""

    def next_site(i: int) -> str:
        if i + 1 < len(meta):
            return f"block{i+1}.expand" if meta[i + 1]["expand"] else f"block{i+1}.dw"
        return "head"

    def qforward(ctx, x, cfg, taps: bool = False):
        t: Dict[str, torch.Tensor] = {}
        first = "block0.expand" if meta[0]["expand"] else "block0.dw"
        y = ctx.conv("stem", x, stride=1 if cfg.small_input else 2, padding=1,
                     fuse_relu6=True, out_site=first)
        for i, m in enumerate(meta):
            inp = y
            nxt = next_site(i)
            if m["expand"]:
                y = ctx.conv(f"block{i}.expand", y, fuse_relu6=True, out_site=f"block{i}.dw")
            y = ctx.conv(f"block{i}.dw", y, stride=m["stride"], padding=1, groups=m["hidden"],
                         fuse_relu6=True, out_site=f"block{i}.project")
            y = ctx.conv(f"block{i}.project", y, out_site=nxt)
            if m["has_res"]:
                y = ctx.add(y, ctx.requant(inp, nxt))
            if taps:
                t[f"block{i}"] = y.q.to(torch.float32) * y.scale
        y = ctx.conv("head", y, fuse_relu6=True, out_site="fc")
        logits = ctx.gap_dense("fc", y)
        if taps:
            t["logits"] = logits
            return logits, t
        return logits

    return qforward


@register("mobilenetv2")
def _build_mnv2(**kw):
    return MobileNetV2Config(**kw), init_mobilenetv2, mobilenetv2_forward
