"""LeNet-5 for MNIST (the counterpart of ``dlq_tpu.models.lenet``):
conv5x5(6) -> avgpool -> conv5x5(16) -> avgpool -> fc120 -> fc84 -> fc10,
NHWC, relu, a 28x28 input zero-padded to 32x32, the NHWC flatten."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch.models.common import avgpool2d, conv2d, dense, he_uniform, relu
from dlq_tpu_torch.models.registry import register

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    num_classes: int = 10
    in_channels: int = 1
    dtype: torch.dtype = torch.float32


def init_lenet(seed: int, cfg: LeNetConfig) -> Params:
    """Random weights from a numpy generator seeded with ``seed`` (CPU tensors)."""
    rng = np.random.default_rng(seed)
    c = cfg.in_channels
    shapes = {"conv1": ((5, 5, c, 6), 25 * c), "conv2": ((5, 5, 6, 16), 25 * 6),
              "fc1": ((16 * 5 * 5, 120), 400), "fc2": ((120, 84), 120),
              "fc3": ((84, cfg.num_classes), 84)}
    return {k: {"w": he_uniform(rng, shape, fan_in=fan_in).to(cfg.dtype),
                "b": torch.zeros(shape[-1], dtype=cfg.dtype)}
            for k, (shape, fan_in) in shapes.items()}


def _pad28(x: torch.Tensor) -> torch.Tensor:
    """A 28x28 NHWC input zero-padded to 32x32."""
    return F.pad(x, (0, 0, 2, 2, 2, 2)) if x.shape[1] == 28 else x


def lenet_forward(params: Params, x: torch.Tensor, cfg: LeNetConfig = LeNetConfig(),
                  taps: bool = False):
    """x: [B, 28, 28, C] (padded to 32 here) or [B, 32, 32, C] -> logits."""
    t = {}
    x = _pad28(x)
    y = avgpool2d(relu(conv2d(x, params["conv1"]["w"], bias=params["conv1"]["b"])), 2, 2)
    if taps:
        t["conv1"] = y
    y = avgpool2d(relu(conv2d(y, params["conv2"]["w"], bias=params["conv2"]["b"])), 2, 2)
    if taps:
        t["conv2"] = y
    y = y.reshape(y.shape[0], -1)
    y = relu(dense(y, params["fc1"]["w"], params["fc1"]["b"]))
    y = relu(dense(y, params["fc2"]["w"], params["fc2"]["b"]))
    logits = dense(y, params["fc3"]["w"], params["fc3"]["b"])
    if taps:
        t["logits"] = logits
        return logits, t
    return logits


def flatten_params(params: Params) -> Params:
    """Flat quantization sites, one per layer."""
    return {k: {"w": v["w"], "b": v["b"]} for k, v in params.items()}


def qforward(ctx, x: torch.Tensor, cfg: LeNetConfig = LeNetConfig(), taps: bool = False):
    """The quantized-topology definition shared by every context; flat
    MNIST rows ([B, 784 * C]) are reshaped to images first."""
    t = {}
    if x.ndim == 2:
        x = x.reshape(x.shape[0], 28, 28, cfg.in_channels)
    x = _pad28(x)
    y = avgpool2d(ctx.conv("conv1", x, fuse_relu=True), 2, 2)
    if taps:
        t["conv1"] = y
    y = avgpool2d(ctx.conv("conv2", y, fuse_relu=True), 2, 2)
    if taps:
        t["conv2"] = y
    y = y.reshape(y.shape[0], -1)
    y = ctx.dense("fc1", y, fuse_relu=True)
    y = ctx.dense("fc2", y, fuse_relu=True)
    logits = ctx.dense("fc3", y)
    if taps:
        t["logits"] = logits
        return logits, t
    return logits


@register("lenet5")
def _build_lenet(**kw):
    return LeNetConfig(**kw), init_lenet, lenet_forward
