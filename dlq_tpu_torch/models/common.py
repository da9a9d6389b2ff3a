"""Shared layer primitives (the counterpart of ``dlq_tpu.models.common``).

Conventions kept from the reference so tensors compare without layout
shuffles: activations NHWC, conv weights HWIO, dense weights IO. PyTorch's
own ops are NCHW/OIHW, so the float convs permute around ``F.conv2d``.

fp32 convs run with cuDNN's TF32 off (``fp32_conv``): TF32 keeps about three
decimal digits, and the fp32 paths here are references for the quantized
ones.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
IntPair = Union[int, Tuple[int, int]]

BN_EPS = 1e-5  # torch BatchNorm2d default, as in the reference


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def fp32_conv():
    """Run cuDNN convolutions in full fp32 (TF32 off) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# initializers (numpy-seeded: the same generator gives the same weights on
# every device)
# ---------------------------------------------------------------------------

def he_uniform(rng: np.random.Generator, shape: Tuple[int, ...], fan_in: int) -> torch.Tensor:
    """He/Kaiming uniform: U(-sqrt(6/fan_in), +sqrt(6/fan_in)) (the MLP's and
    LeNet-5's init, ``dlq_tpu/models/common.py:33``)."""
    bound = float(np.sqrt(6.0 / fan_in))
    return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))


def kaiming_normal(rng: np.random.Generator, shape: Tuple[int, ...], fan_out: int) -> torch.Tensor:
    """fan_out-mode kaiming normal — torch's Conv2d default in resnet."""
    std = float(np.sqrt(2.0 / fan_out))
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))


def init_bn(c: int) -> Params:
    return {
        "gamma": torch.ones(c),
        "beta": torch.zeros(c),
        "mean": torch.zeros(c),
        "var": torch.ones(c),
    }


# ---------------------------------------------------------------------------
# layer primitives (pure functions over param dicts)
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0,
           groups: int = 1, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC x HWIO float conv, symmetric padding, TF32 off."""
    with fp32_conv():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=_pair(stride),
                     padding=_pair(padding), groups=groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    return y.contiguous()


@contextlib.contextmanager
def fp32_matmul():
    """Run CUDA fp32 matrix products in full fp32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x[..., I] @ w[I, O] + b (IO weight layout), with the reference's dtype
    contract (``dlq_tpu/models/common.py:84-86``): the product is taken in
    fp32 (operands promoted, TF32 off), cast back to ``x.dtype``, then the
    bias is added with type promotion (a bf16 ``x`` and an fp32 bias give
    fp32)."""
    with fp32_matmul():
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b
    return y


def batchnorm_inference(x: torch.Tensor, bn: Params, eps: float = BN_EPS) -> torch.Tensor:
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over the last axis,
    with the reference's dtype contract (``dlq_tpu/models/common.py:95-98``):
    scale and shift are computed in fp32, then cast to ``x.dtype``, so a
    bf16 ``x`` gives a bf16 result."""
    inv = torch.rsqrt(bn["var"].float() + eps)
    scale = (bn["gamma"] * inv).to(x.dtype)
    shift = (bn["beta"] - bn["mean"] * bn["gamma"] * inv).to(x.dtype)
    return x * scale + shift


def fold_bn(w: torch.Tensor, bias: Optional[torch.Tensor], bn: Params, eps: float = BN_EPS):
    """Fold inference BN into the preceding conv/dense weight (output
    channel = last axis): w' = w * g/sqrt(v+eps), b' = beta + (b - mean) * g/sqrt(v+eps)."""
    inv = torch.rsqrt(bn["var"].float() + eps)
    scale = bn["gamma"].float() * inv
    w2 = w.float() * scale
    b0 = bias.float() if bias is not None else 0.0
    b2 = bn["beta"].float() + (b0 - bn["mean"].float()) * scale
    return w2, b2


def maxpool2d(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    """NHWC maxpool. Integer inputs pool an exact float copy: the padding
    then acts as -inf, which equals the reference's int8-min padding since
    every window holds at least one real element."""
    xf = x.permute(0, 3, 1, 2)
    if not xf.is_floating_point():
        xf = xf.float()
    y = F.max_pool2d(xf, window, stride, padding).permute(0, 2, 3, 1)
    return y.to(x.dtype).contiguous()


def avgpool2d(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """NHWC average pool with zero padding (``dlq_tpu/models/common.py:168``):
    the window's taps summed in row-major order, as XLA's ``reduce_window``
    sums them, then divided by ``window * window`` (exact for LeNet-5's
    2x2 window: a power of two)."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    oh = (x.shape[1] - window) // stride + 1
    ow = (x.shape[2] - window) // stride + 1
    s = None
    for i in range(window):
        for j in range(window):
            t = x[:, i: i + stride * (oh - 1) + 1: stride, j: j + stride * (ow - 1) + 1: stride]
            s = t if s is None else s + t
    return s / (window * window)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC mean over H and W, in fp32."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 6) (``dlq_tpu/models/mobilenetv2.py:56``)."""
    return torch.clamp(x, 0, 6)
