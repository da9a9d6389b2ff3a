"""K23: int8 depthwise convolution with K1's fused fp32 / int8 epilogue.

Replaces no Pallas kernel: the reference leaves the depthwise conv to XLA,
the grouped branch of ``dlq_tpu/ops/qops.py:182 _conv_int8`` (``groups ==
C``, HWIO weights ``[kh, kw, 1, C]``; its oracle ``_depthwise_int8_stencil``,
``:162-179``), which MobileNetV2's deploy paths run (kernel in
``csrc/depthwise_int8.cu``). Computes, on int8 NHWC input,

    acc[n, oh, ow, c] = sum_{u, v} x[n, oh*s - p + u, ow*s - p + v, c] * w[u, v, 0, c]   (int32)
    y = fma(float(acc), scale[c], bias[c]);  relu or relu6 (clip to [0, 6])
    out = y (fp32)   or   clip(rint(y / out_scale), relu|relu6 ? 0 : -127, 127) (int8)

for any kernel size, stride and symmetric zero padding: K1's epilogue
(``ops.conv_int8.epilogue_plain``) on the exact sums.

The weight is kept as the int8 ``[kh * kw, C]`` view of its HWIO layout,
tap-major and channel-contiguous (``pack_depthwise_weight``, once per site).

``depthwise_int8`` launches the kernel for a CUDA tensor and runs
``depthwise_int8_plain`` (an exact int32 stencil, never ``F.conv2d`` on
int8) for a CPU tensor. The kernel takes C % 16 == 0 in 16-byte channel
granules and C % 16 == 8 in 8-byte ones; it refuses any other C, and a
refused launch raises. ``depthwise_int8.launches`` counts kernel launches,
``depthwise_int8.by_shape`` counts them per (N, H, W, C, KH, KW, stride,
pad, activation (``act_key``), int8 out).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import act_code, act_key, epilogue_plain, out_hw


@dataclasses.dataclass
class PackedDepthwise:
    """Depthwise conv weight for K23: ``w[u * kw + v, c] = w_hwio[u, v, 0, c]``."""

    w: torch.Tensor  # [kh * kw, C] int8, contiguous
    kh: int
    kw: int

    @property
    def c(self) -> int:
        return self.w.shape[1]

    @property
    def oc(self) -> int:
        return self.c

    def hwio(self) -> torch.Tensor:
        """The int8 weight back in the reference's HWIO layout ``[kh, kw, 1, C]``."""
        return self.w.reshape(self.kh, self.kw, 1, self.c)


def is_depthwise_weight(shape) -> bool:
    """Is an HWIO weight of this shape a depthwise conv's (``[kh, kw, 1, C]``, C > 1)?"""
    return len(shape) == 4 and shape[2] == 1 and shape[3] > 1


def pack_depthwise_weight(w_hwio: torch.Tensor) -> PackedDepthwise:
    """[KH, KW, 1, C] int8 -> PackedDepthwise (done once per site, at load)."""
    if w_hwio.dtype != torch.int8 or not is_depthwise_weight(tuple(w_hwio.shape)):
        raise ValueError(f"expected int8 depthwise HWIO weights [kh, kw, 1, C], got "
                         f"{w_hwio.dtype} {tuple(w_hwio.shape)}")
    kh, kw, _, c = w_hwio.shape
    return PackedDepthwise(w_hwio.reshape(kh * kw, c).contiguous(), kh, kw)


def depthwise_acc_plain(x: torch.Tensor, pk: PackedDepthwise, stride: int,
                        pad: int) -> torch.Tensor:
    """Exact int32 depthwise sums, NHWC: the reference's stencil (zero-padded
    input, one strided slice a tap, widened and multiplied by the tap's
    per-channel weight)."""
    n, h, w, c = x.shape
    oh, ow = out_hw(h, w, pk.kh, pk.kw, stride, pad)
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, 0, pad, pad, pad, pad))
    w32 = pk.w.to(torch.int32)
    acc = torch.zeros((n, oh, ow, c), dtype=torch.int32, device=x.device)
    for u in range(pk.kh):
        for v in range(pk.kw):
            sl = xp[:, u: u + (oh - 1) * stride + 1: stride, v: v + (ow - 1) * stride + 1: stride]
            acc += sl * w32[u * pk.kw + v]
    return acc


def depthwise_int8_plain(x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
                         scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                         out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K23 (same inputs, same outputs)."""
    acc = depthwise_acc_plain(x, pk, stride, pad)
    return epilogue_plain(acc, scale, bias, relu, out_scale, relu6)


def check_depthwise_args(x: torch.Tensor, pk: PackedDepthwise, scale: torch.Tensor,
                         bias: torch.Tensor, granule: int) -> None:
    """Raise on what K23 does not take: a CUDA, contiguous int8 NHWC input
    with the weights' C channels, aligned to the channel granule, C a
    multiple of 8, and contiguous weights and fp32 [C] scale and bias on the
    input's device."""
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_int8: unsupported device {x.device}")
    if granule == 0:
        raise ValueError(f"depthwise_int8: C = {pk.c} is not a multiple of 8")
    if (x.dtype != torch.int8 or x.ndim != 4 or not x.is_contiguous() or x.shape[-1] != pk.c
            or x.data_ptr() % granule):
        raise ValueError(f"depthwise_int8: need contiguous, {granule}-byte aligned int8 NHWC "
                         f"input with {pk.c} channels, got {x.dtype} {tuple(x.shape)}")
    for t, name in ((pk.w, "weights"), (scale, "scale"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"depthwise_int8: {name} must be contiguous on {x.device}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (pk.c,) or bias.shape != (pk.c,):
        raise ValueError(f"depthwise_int8: scale and bias must be fp32 [{pk.c}]")


@functools.cache
def _entry():
    fn = _build.library("depthwise_int8").dlq_depthwise_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.cache
def launch_granule(c: int) -> int:
    """The channel granule in bytes the kernel library takes for C (its own
    rule: 16, 8, or 0 for a refused C)."""
    fn = _build.library("depthwise_int8").dlq_depthwise_int8_granule
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(c)


def depthwise_int8(x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
                   scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                   out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """int8 NHWC depthwise conv with the fused epilogue. ``scale``/``bias``:
    fp32 [C]; ``relu`` / ``relu6``: the activation; ``out_scale``: None for
    an fp32 output, else the consumer's activation scale for an int8 one."""
    if x.device.type == "cpu":
        return depthwise_int8_plain(x, pk, stride, pad, scale, bias, relu, out_scale, relu6)
    check_depthwise_args(x, pk, scale, bias, launch_granule(pk.c))
    n, h, w, c = x.shape
    if h + 2 * pad < pk.kh or w + 2 * pad < pk.kw or stride < 1 or pad < 0:
        raise ValueError(f"depthwise_int8: no output for {tuple(x.shape)}, "
                         f"{pk.kh}x{pk.kw}/s{stride}/p{pad}")
    oh, ow = out_hw(h, w, pk.kh, pk.kw, stride, pad)
    out = torch.empty((n, oh, ow, c), device=x.device,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    rc = _entry()(x.data_ptr(), pk.w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), n, h, w, c, pk.kh, pk.kw, stride, pad,
                  act_code(relu, relu6), int(out_scale is not None),
                  float(out_scale) if out_scale is not None else 1.0,
                  _build.stream_ptr(x.device))
    _build.check(rc, "depthwise_int8")
    depthwise_int8.launches += 1
    depthwise_int8.by_shape[(n, h, w, c, pk.kh, pk.kw, stride, pad, act_key(relu, relu6),
                             out_scale is not None)] += 1
    return out


depthwise_int8.launches = 0
depthwise_int8.by_shape = collections.Counter()
