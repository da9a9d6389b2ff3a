"""MNIST MLP 784-256-10 (the counterpart of ``dlq_tpu.models.mlp``): the
reference's training-ladder model, He-uniform init, relu between layers.
Dense weights are IO. ``softmax_cross_entropy`` is training (queue A.12)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dlq_tpu_torch.models.common import dense, he_uniform, relu
from dlq_tpu_torch.models.registry import register

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (256,)
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


def init_mlp(seed: int, cfg: MLPConfig) -> Params:
    """Random weights from a numpy generator seeded with ``seed`` (CPU tensors)."""
    rng = np.random.default_rng(seed)
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.num_classes,)
    return {"layers": [{"w": he_uniform(rng, (din, dout), fan_in=din).to(cfg.dtype),
                        "b": torch.zeros(dout, dtype=cfg.dtype)}
                       for din, dout in zip(dims[:-1], dims[1:])]}


def mlp_forward(params: Params, x: torch.Tensor, cfg: MLPConfig = MLPConfig(),
                taps: bool = False):
    """x: [B, in_dim] -> logits [B, classes]; relu between layers."""
    t = {}
    y = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        y = dense(y, layer["w"], layer["b"])
        if i < n - 1:
            y = relu(y)
        if taps:
            t[f"fc{i+1}"] = y
    return (y, t) if taps else y


def flatten_params(params: Params) -> Params:
    """Flat {site: {"w", "b"}} for the quantizer."""
    return {f"fc{i+1}": {"w": l["w"], "b": l["b"]} for i, l in enumerate(params["layers"])}


def qforward(ctx, x: torch.Tensor, cfg: MLPConfig = MLPConfig(), taps: bool = False):
    """The quantized-topology definition shared by every context."""
    t = {}
    y = x
    n = len(cfg.hidden) + 1
    for i in range(n):
        y = ctx.dense(f"fc{i+1}", y, fuse_relu=(i < n - 1))
        if taps:
            t[f"fc{i+1}"] = y
    return (y, t) if taps else y


@register("mlp")
def _build_mlp(**kw):
    return MLPConfig(**kw), init_mlp, mlp_forward
