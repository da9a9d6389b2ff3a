"""ResNet-18/34/50/101/152 in NHWC with per-stage taps (the counterpart of
``dlq_tpu.models.resnet``): stem conv7x7/s2/p3 -> bn -> relu ->
maxpool3x3/s2/p1 (or the 3x3/s1 ``small_input`` stem without maxpool), then
four stages of residual blocks, then GAP -> FC.

ResNet-18/34 stack BasicBlocks (3x3 -> 3x3); 50/101/152 stack torchvision
Bottlenecks (1x1 reduce -> 3x3 -> 1x1 expand x4, the stride on the 3x3).
The first block of a stage takes a 1x1 conv+BN downsample shortcut when it
strides or changes width: stages 2-4, and on a Bottleneck net also
``layer1.0`` (1x1/s1, 64 -> 256).

``qforward_fused`` (int8 inside each block, fp32 junctions) is
BasicBlock-only, as the reference's is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dlq_tpu_torch.models.common import (
    BN_EPS,
    batchnorm_inference,
    conv2d,
    dense,
    fold_bn,
    global_avgpool,
    init_bn,
    kaiming_normal,
    maxpool2d,
    relu,
)
from dlq_tpu_torch.models.registry import register

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    num_classes: int = 1000
    in_channels: int = 3
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    # CIFAR variant: 3x3/s1 stem, no maxpool
    small_input: bool = False

    def __post_init__(self):
        if self.depth not in _BLOCKS:
            raise ValueError(f"unsupported ResNet depth {self.depth} "
                             f"(one of {sorted(_BLOCKS)})")

    @property
    def blocks_per_stage(self) -> Tuple[int, ...]:
        return _BLOCKS[self.depth]

    @property
    def bottleneck(self) -> bool:
        return self.depth >= 50

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1


_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
           101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _init_block(rng, cin: int, cout: int, stride: int) -> Params:
    p: Params = {
        "conv1": kaiming_normal(rng, (3, 3, cin, cout), fan_out=9 * cout),
        "bn1": init_bn(cout),
        "conv2": kaiming_normal(rng, (3, 3, cout, cout), fan_out=9 * cout),
        "bn2": init_bn(cout),
    }
    if stride != 1 or cin != cout:
        p["down_conv"] = kaiming_normal(rng, (1, 1, cin, cout), fan_out=cout)
        p["down_bn"] = init_bn(cout)
    return p


def _init_bottleneck(rng, cin: int, width: int, stride: int) -> Params:
    """1x1 reduce -> 3x3 -> 1x1 expand (x4), torchvision Bottleneck layout."""
    cout = width * 4
    p: Params = {
        "conv1": kaiming_normal(rng, (1, 1, cin, width), fan_out=width),
        "bn1": init_bn(width),
        "conv2": kaiming_normal(rng, (3, 3, width, width), fan_out=9 * width),
        "bn2": init_bn(width),
        "conv3": kaiming_normal(rng, (1, 1, width, cout), fan_out=cout),
        "bn3": init_bn(cout),
    }
    if stride != 1 or cin != cout:
        p["down_conv"] = kaiming_normal(rng, (1, 1, cin, cout), fan_out=cout)
        p["down_bn"] = init_bn(cout)
    return p


def init_resnet(seed: int, cfg: ResNetConfig) -> Params:
    """Random weights from a numpy generator seeded with ``seed`` (CPU
    tensors; engines move them to their device)."""
    rng = np.random.default_rng(seed)
    k = 3 if cfg.small_input else 7
    stem_w = kaiming_normal(rng, (k, k, cfg.in_channels, cfg.widths[0]),
                            fan_out=k * k * cfg.widths[0])
    params: Params = {"stem": {"conv": stem_w, "bn": init_bn(cfg.widths[0])}}
    cin = cfg.widths[0]
    for s, (width, nblocks) in enumerate(zip(cfg.widths, cfg.blocks_per_stage)):
        blocks: List[Params] = []
        for b in range(nblocks):
            stride = 2 if (s > 0 and b == 0) else 1
            if cfg.bottleneck:
                blocks.append(_init_bottleneck(rng, cin, width, stride))
            else:
                blocks.append(_init_block(rng, cin, width, stride))
            cin = width * cfg.expansion
        params[f"layer{s+1}"] = blocks
    bound = 1.0 / (cin ** 0.5)
    params["fc"] = {
        "w": torch.from_numpy(rng.uniform(-bound, bound, (cin, cfg.num_classes)).astype(np.float32)),
        "b": torch.zeros(cfg.num_classes),
    }
    return params


def bottleneck_block(x: torch.Tensor, p: Params, stride: int, eps: float = BN_EPS) -> torch.Tensor:
    """1x1->bn->relu -> 3x3(stride)->bn->relu -> 1x1->bn (+shortcut) -> relu."""
    y = relu(batchnorm_inference(conv2d(x, p["conv1"]), p["bn1"], eps))
    y = relu(batchnorm_inference(conv2d(y, p["conv2"], stride=stride, padding=1), p["bn2"], eps))
    y = batchnorm_inference(conv2d(y, p["conv3"]), p["bn3"], eps)
    if "down_conv" in p:
        sc = batchnorm_inference(conv2d(x, p["down_conv"], stride=stride), p["down_bn"], eps)
    else:
        sc = x
    return relu(y + sc)


def basic_block(x: torch.Tensor, p: Params, stride: int, eps: float = BN_EPS) -> torch.Tensor:
    """conv3x3->bn->relu->conv3x3->bn (+ optional 1x1/s2 conv+bn shortcut)->add->relu."""
    y = relu(batchnorm_inference(conv2d(x, p["conv1"], stride=stride, padding=1), p["bn1"], eps))
    y = batchnorm_inference(conv2d(y, p["conv2"], stride=1, padding=1), p["bn2"], eps)
    if "down_conv" in p:
        sc = batchnorm_inference(conv2d(x, p["down_conv"], stride=stride, padding=0),
                                 p["down_bn"], eps)
    else:
        sc = x
    return relu(y + sc)


def resnet_forward(params: Params, x: torch.Tensor, cfg: ResNetConfig, taps: bool = False):
    """NHWC input -> logits. With taps, also return stage checkpoints."""
    t: Dict[str, torch.Tensor] = {}
    if cfg.small_input:
        y = conv2d(x, params["stem"]["conv"], stride=1, padding=1)
    else:
        y = conv2d(x, params["stem"]["conv"], stride=2, padding=3)
    y = relu(batchnorm_inference(y, params["stem"]["bn"]))
    if not cfg.small_input:
        y = maxpool2d(y, 3, 2, 1)
    if taps:
        t["stem"] = y
    block_fn = bottleneck_block if cfg.bottleneck else basic_block
    for s in range(4):
        for b, bp in enumerate(params[f"layer{s+1}"]):
            y = block_fn(y, bp, 2 if (s > 0 and b == 0) else 1)
        if taps:
            t[f"layer{s+1}"] = y
    g = global_avgpool(y)
    logits = dense(g, params["fc"]["w"], params["fc"]["b"])
    if taps:
        t["gap"], t["logits"] = g, logits
        return logits, t
    return logits


def fold_resnet(params: Params, cfg: ResNetConfig) -> Params:
    """Fold every inference BN into its conv -> deployment params."""
    out: Params = {}
    w, b = fold_bn(params["stem"]["conv"], None, params["stem"]["bn"])
    out["stem"] = {"w": w, "b": b}
    for s in range(4):
        blocks = []
        for bp in params[f"layer{s+1}"]:
            fb: Params = {}
            fb["conv1_w"], fb["conv1_b"] = fold_bn(bp["conv1"], None, bp["bn1"])
            fb["conv2_w"], fb["conv2_b"] = fold_bn(bp["conv2"], None, bp["bn2"])
            if "conv3" in bp:
                fb["conv3_w"], fb["conv3_b"] = fold_bn(bp["conv3"], None, bp["bn3"])
            if "down_conv" in bp:
                fb["down_w"], fb["down_b"] = fold_bn(bp["down_conv"], None, bp["down_bn"])
            blocks.append(fb)
        out[f"layer{s+1}"] = blocks
    out["fc"] = {"w": params["fc"]["w"], "b": params["fc"]["b"]}
    return out


def folded_forward(folded: Params, x: torch.Tensor, cfg: ResNetConfig, taps: bool = False):
    """Forward through BN-folded params — the fp32 deployment path."""
    t: Dict[str, torch.Tensor] = {}
    stem = folded["stem"]
    if cfg.small_input:
        y = conv2d(x, stem["w"], stride=1, padding=1, bias=stem["b"])
    else:
        y = conv2d(x, stem["w"], stride=2, padding=3, bias=stem["b"])
    y = relu(y)
    if not cfg.small_input:
        y = maxpool2d(y, 3, 2, 1)
    if taps:
        t["stem"] = y
    for s in range(4):
        for b, fb in enumerate(folded[f"layer{s+1}"]):
            stride = 2 if (s > 0 and b == 0) else 1
            if "conv3_w" in fb:  # bottleneck
                z = relu(conv2d(y, fb["conv1_w"], bias=fb["conv1_b"]))
                z = relu(conv2d(z, fb["conv2_w"], stride=stride, padding=1, bias=fb["conv2_b"]))
                z = conv2d(z, fb["conv3_w"], bias=fb["conv3_b"])
            else:
                z = relu(conv2d(y, fb["conv1_w"], stride=stride, padding=1, bias=fb["conv1_b"]))
                z = conv2d(z, fb["conv2_w"], stride=1, padding=1, bias=fb["conv2_b"])
            if "down_w" in fb:
                sc = conv2d(y, fb["down_w"], stride=stride, padding=0, bias=fb["down_b"])
            else:
                sc = y
            y = relu(z + sc)
        if taps:
            t[f"layer{s+1}"] = y
    g = global_avgpool(y)
    logits = dense(g, folded["fc"]["w"], folded["fc"]["b"])
    if taps:
        t["gap"], t["logits"] = g, logits
        return logits, t
    return logits


def flatten_folded(folded: Params) -> Dict[str, Dict[str, torch.Tensor]]:
    """Nested folded params -> flat {site: {"w", "b"}} for the quantizer."""
    flat = {"stem": {"w": folded["stem"]["w"], "b": folded["stem"]["b"]}}
    for s in range(4):
        for b, fb in enumerate(folded[f"layer{s+1}"]):
            flat[f"layer{s+1}.{b}.conv1"] = {"w": fb["conv1_w"], "b": fb["conv1_b"]}
            flat[f"layer{s+1}.{b}.conv2"] = {"w": fb["conv2_w"], "b": fb["conv2_b"]}
            if "conv3_w" in fb:
                flat[f"layer{s+1}.{b}.conv3"] = {"w": fb["conv3_w"], "b": fb["conv3_b"]}
            if "down_w" in fb:
                flat[f"layer{s+1}.{b}.down"] = {"w": fb["down_w"], "b": fb["down_b"]}
    flat["fc"] = {"w": folded["fc"]["w"], "b": folded["fc"]["b"]}
    return flat


def qforward(ctx, x: torch.Tensor, cfg: ResNetConfig, taps: bool = False):
    """The quantized-topology definition shared by the observe / deploy
    contexts. Residual adds stay in the fp32 interchange; convs and the fc
    quantize at their inputs."""
    t: Dict[str, torch.Tensor] = {}
    if cfg.small_input:
        y = ctx.conv("stem", x, stride=1, padding=1, fuse_relu=True)
    else:
        y = ctx.conv("stem", x, stride=2, padding=3, fuse_relu=True)
        y = maxpool2d(y, 3, 2, 1)
    if taps:
        t["stem"] = y
    for s in range(4):
        for b in range(cfg.blocks_per_stage[s]):
            stride = 2 if (s > 0 and b == 0) else 1
            site = f"layer{s+1}.{b}"
            if cfg.bottleneck:
                z = ctx.conv(f"{site}.conv1", y, fuse_relu=True)
                z = ctx.conv(f"{site}.conv2", z, stride=stride, padding=1, fuse_relu=True)
                z = ctx.conv(f"{site}.conv3", z)
            else:
                z = ctx.conv(f"{site}.conv1", y, stride=stride, padding=1, fuse_relu=True)
                z = ctx.conv(f"{site}.conv2", z, stride=1, padding=1)
            down = f"{site}.down"
            sc = ctx.conv(down, y, stride=stride, padding=0) if ctx.has(down) else y
            y = relu(z + sc)
        if taps:
            t[f"layer{s+1}"] = y
    g = global_avgpool(y)
    logits = ctx.dense("fc", g)
    if taps:
        t["gap"], t["logits"] = g, logits
        return logits, t
    return logits


def qforward_fused(ctx, x: torch.Tensor, cfg: ResNetConfig, taps: bool = False):
    """INT8-interchange inside each BasicBlock (use with FusedDeployCtx):
    conv1 emits the int8 tensor conv2 consumes; block-boundary tensors stay
    fp32. The 1x1 downsample shares conv1's quantized input. BasicBlock nets
    only, as the reference's (``nb = {18: ..., 34: ...}[cfg.depth]``)."""
    if cfg.bottleneck:
        raise NotImplementedError(
            f"qforward_fused is BasicBlock-only (ResNet-18/34), as the reference's; "
            f"run ResNet-{cfg.depth} with qforward_fused2 (ctx='fused2') or qforward")
    t: Dict[str, torch.Tensor] = {}
    if cfg.small_input:
        y = ctx.conv("stem", x, stride=1, padding=1, fuse_relu=True)
    else:
        y = ctx.conv("stem", x, stride=2, padding=3, fuse_relu=True)
        y = maxpool2d(y, 3, 2, 1)
    if taps:
        t["stem"] = y
    for s in range(4):
        for b in range(cfg.blocks_per_stage[s]):
            stride = 2 if (s > 0 and b == 0) else 1
            site = f"layer{s+1}.{b}"
            yq = ctx.quant(f"{site}.conv1", y)
            z = ctx.conv(f"{site}.conv1", yq, stride=stride, padding=1,
                         fuse_relu=True, out_site=f"{site}.conv2")
            z = ctx.conv(f"{site}.conv2", z, stride=1, padding=1)
            down = f"{site}.down"
            sc = ctx.conv(down, yq, stride=stride, padding=0) if ctx.has(down) else y
            y = relu(z + sc)
        if taps:
            t[f"layer{s+1}"] = y
    g = global_avgpool(y)
    logits = ctx.dense("fc", g)
    if taps:
        t["gap"], t["logits"] = g, logits
        return logits, t
    return logits


def _dequant_tap(y) -> torch.Tensor:
    return y.q.to(torch.float32) * y.scale if hasattr(y, "q") else y


def qforward_fused2(ctx, x: torch.Tensor, cfg: ResNetConfig, taps: bool = False):
    """Fully-int8 interchange (use with FullFusedCtx / PallasBlockCtx):
    stem, maxpool, every block tensor and the residual junctions are int8;
    the only fp32 tensors are the input, the final junction, the pooled
    feature vector and the logits. The 224 px stem is the bf16 stem; a
    uint8 image takes the stem with the preprocess fold
    (``conv_stem_bf16_u8``, ``dlq_tpu/models/resnet.py:423``)."""
    t: Dict[str, torch.Tensor] = {}
    nb = cfg.blocks_per_stage
    first = "layer1.0.conv1"
    if cfg.small_input:
        y = ctx.conv("stem", x, stride=1, padding=1, fuse_relu=True, out_site=first)
    else:
        u8 = x.dtype == torch.uint8 and hasattr(ctx, "conv_stem_bf16_u8")
        y = (ctx.conv_stem_bf16_u8 if u8 else ctx.conv_stem_bf16)("stem", x, out_site=first)
        y = ctx.maxpool(y, 3, 2, 1)
    if taps:
        t["stem"] = _dequant_tap(y)
    for s in range(4):
        for b in range(nb[s]):
            stride = 2 if (s > 0 and b == 0) else 1
            site = f"layer{s+1}.{b}"
            # the junction scale: next consumer's calibrated input scale
            if b + 1 < nb[s]:
                nxt = f"layer{s+1}.{b+1}.conv1"
            elif s < 3:
                nxt = f"layer{s+2}.0.conv1"
            else:
                # the final junction has no conv consumer whose calibrated
                # scale covers the unpooled activations: it stays fp32
                nxt = None
            down = f"{site}.down"
            if (nxt is not None and stride == 1 and not ctx.has(down)
                    and getattr(ctx, "fused_block", None) is not None):
                fb = ctx.fused_block(site, y, nxt)
                if fb is not None:
                    y = fb
                    continue
            if cfg.bottleneck:
                z = ctx.conv(f"{site}.conv1", y, fuse_relu=True, out_site=f"{site}.conv2")
                z = ctx.conv(f"{site}.conv2", z, stride=stride, padding=1,
                             fuse_relu=True, out_site=f"{site}.conv3")
                z = ctx.conv(f"{site}.conv3", z, out_site=nxt)
            else:
                z = ctx.conv(f"{site}.conv1", y, stride=stride, padding=1,
                             fuse_relu=True, out_site=f"{site}.conv2")
                z = ctx.conv(f"{site}.conv2", z, stride=1, padding=1, out_site=nxt)
            if nxt is None:
                if ctx.has(down):
                    y = relu(z + ctx.conv(down, y, stride=stride, padding=0))
                else:
                    # z + q * s, one fused multiply-add as XLA contracts it
                    y = relu(torch.addcmul(z, y.q.to(torch.float32), ctx.scale_t[f"{site}.conv1"]))
            else:
                sc = (ctx.conv(down, y, stride=stride, padding=0, out_site=nxt)
                      if ctx.has(down) else ctx.requant(y, nxt))
                y = ctx.add_relu(z, sc)
        if taps:
            t[f"layer{s+1}"] = _dequant_tap(y)
    logits = ctx.gap_dense("fc", y) if hasattr(y, "q") else ctx.dense("fc", global_avgpool(y))
    if taps:
        t["logits"] = logits
        return logits, t
    return logits


def _resnet_builder(depth: int):
    def build(**kw):
        return ResNetConfig(depth=depth, **kw), init_resnet, resnet_forward

    return build


for _depth in sorted(_BLOCKS):
    register(f"resnet{_depth}")(_resnet_builder(_depth))
