"""K1: int8 implicit-GEMM convolution with a fused fp32 / int8 epilogue.

Replaces ``dlq_tpu/ops/pallas_conv.py:int8_conv3x3_s1`` and
``int8_conv3x3_s1_dp`` (kernel in ``csrc/conv_int8.cu``). Computes

    acc[n, oh, ow, oc] = sum_{kh, kw, c} x[n, oh*s - p + kh, ow*s - p + kw, c] * w[oc, kh, kw, c]
    y = fma(float(acc), scale[oc], bias[oc]);  y = max(y, 0) if relu, clip(y, 0, 6) if relu6
    out = y (fp32)   or   clip(rint(y / out_scale), relu|relu6 ? 0 : -127, 127) (int8)

on int8 NHWC input with int32 accumulation, for any kernel size, stride and
symmetric zero padding (ResNet uses 3x3/s1, 3x3/s2 and 1x1/s2; the 7x7/s2
and 3x3 C=3 stems of the fp32-interchange paths take the same kernel). The
epilogue's multiply-add is one fused multiply-add, as XLA contracts it in
the reference, and the requant divides (``y / out_scale``), as the
reference's epilogue does.

Weights are repacked once, at load, into a K-major ``[OC, Kp]`` int8 copy
(``pack_conv_weight``): K runs (kh, kw, c), zero-padded to a multiple of 64,
the layout the tensor-core fragments read.

``conv_int8`` launches the kernel for a CUDA tensor (and raises on what the
kernel does not take) and runs ``conv_int8_plain`` for a CPU tensor. The
kernel takes its Hopper form (a halo slab per item by TMA, nine shifted
int8 ``wgmma`` walks, ``csrc/i8gemm.cuh``) for 1x1 and 3x3 convs with pad
k // 2 at stride 1 or 2 and C % 64 == 0, and its first form otherwise (the
C=3 stems), by a static shape rule the kernel library reports
(``dlq_conv_int8_form``; mirrored with the plan in ``ops.i8plan``): a
refused launch raises, it never falls back. ``conv_int8.launches`` counts
kernel launches, ``conv_int8.by_shape`` counts them per (N, H, W, C, OC,
KH, KW, stride, pad, activation (``act_key``), int8 out),
``conv_int8.by_form`` per form (``"hopper"``, ``"first"``). A relu6 launch
takes kernels of its own (a compile-time activation), so the others
compile to the epilogue without it.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dlq_tpu_torch import _build
from dlq_tpu_torch.quant.quantize import fdiv

K_ALIGN = 64  # the kernel's K tile (bytes of int8)


@dataclasses.dataclass
class PackedConv:
    """Conv weight repacked for K1: ``wk[oc, (kh*KW + kw)*C + c] = w[kh, kw, c, oc]``,
    zero-padded along K to a multiple of 64."""

    wk: torch.Tensor  # [OC, Kp] int8, contiguous
    kh: int
    kw: int
    c: int

    @property
    def oc(self) -> int:
        return self.wk.shape[0]

    @property
    def k(self) -> int:
        return self.kh * self.kw * self.c

    def hwio(self) -> torch.Tensor:
        """The int8 weight back in the reference's HWIO layout."""
        w = self.wk[:, : self.k].reshape(self.oc, self.kh, self.kw, self.c)
        return w.permute(1, 2, 3, 0)


def pack_conv_weight(w_hwio: torch.Tensor) -> PackedConv:
    """[KH, KW, C, OC] int8 -> PackedConv (done once per site, at load)."""
    if w_hwio.dtype != torch.int8 or w_hwio.ndim != 4:
        raise ValueError(f"expected int8 HWIO weights, got {w_hwio.dtype} {tuple(w_hwio.shape)}")
    kh, kw, c, oc = w_hwio.shape
    k = kh * kw * c
    kp = -(-k // K_ALIGN) * K_ALIGN
    wk = torch.zeros((oc, kp), dtype=torch.int8, device=w_hwio.device)
    wk[:, :k] = w_hwio.permute(3, 0, 1, 2).reshape(oc, k)
    return PackedConv(wk, kh, kw, c)


def out_hw(h: int, w: int, kh: int, kw: int, stride: int, pad: int):
    return (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1


def conv_acc_plain(x: torch.Tensor, w_hwio: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact int8 conv sums as float64 NHWC (exact while K*127^2 < 2^53).
    Never ``F.conv2d`` on int8 tensors: on the CPU it returns int8 and wraps.
    cuDNN is kept out: it may pick a Winograd or FFT algorithm, whose
    fractional transforms would make the sums inexact; PyTorch's own
    im2col + GEMM conv is exact on integers."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w_hwio.permute(3, 2, 0, 1).double(),
                       stride=stride, padding=pad)
    finally:
        torch.backends.cudnn.enabled = prev
    return acc.permute(0, 2, 3, 1)


def act_code(relu: bool, relu6: bool) -> int:
    """The kernels' activation argument: 0 none, 1 relu, 2 relu6 (relu6
    clips y to [0, 6], so it takes relu's place)."""
    return 2 if relu6 else int(bool(relu))


def act_key(relu: bool, relu6: bool):
    """The activation in a ``by_shape`` key: ``bool(relu)``, or ``"relu6"``."""
    return "relu6" if relu6 else bool(relu)


def epilogue_plain(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, relu: bool,
                   out_scale: Optional[float], relu6: bool = False) -> torch.Tensor:
    """The kernels' shared epilogue on exact sums: fp32 fused multiply-add
    (``addcmul``), relu or relu6 (a clip to [0, 6] before the requant
    divides, as the reference's ``fuse_relu6``), then fp32 out or an int8
    requant that divides, clipped at 0 below under either activation."""
    y = torch.addcmul(bias, acc.float(), scale)
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    elif relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is None:
        return y.contiguous()
    q = torch.round(fdiv(y, out_scale))
    return torch.clamp(q, 0.0 if (relu or relu6) else -127.0, 127.0).to(torch.int8).contiguous()


def conv_int8_plain(x: torch.Tensor, pk: PackedConv, stride: int, pad: int,
                    scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                    out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1 (same inputs, same outputs)."""
    acc = conv_acc_plain(x, pk.hwio(), stride, pad)
    return epilogue_plain(acc, scale, bias, relu, out_scale, relu6)


def check_launch_args(what: str, x: torch.Tensor, pk: PackedConv, scale: torch.Tensor,
                      bias: torch.Tensor) -> None:
    """Raise on what the int8 kernels do not take: a CUDA, contiguous,
    16-byte aligned int8 input whose last axis is the weights' C, and
    contiguous weights and fp32 [OC] scale and bias on the input's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.int8 or not x.is_contiguous() or x.shape[-1] != pk.c or x.data_ptr() % 16:
        raise ValueError(f"{what}: need contiguous, 16-byte aligned int8 input with "
                         f"{pk.c} channels last, got {x.dtype} {tuple(x.shape)}")
    check_weights(what, x.device, pk, scale, bias)


def check_weights(what: str, device: torch.device, pk: PackedConv, scale: torch.Tensor,
                  bias: torch.Tensor) -> None:
    """Raise unless the packed weights and the fp32 [OC] scale and bias are
    contiguous on ``device``."""
    for t, name in ((pk.wk, "weights"), (scale, "scale"), (bias, "bias")):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {device}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (pk.oc,) or bias.shape != (pk.oc,):
        raise ValueError(f"{what}: scale and bias must be fp32 [{pk.oc}]")


@functools.cache
def _entry():
    fn = _build.library("conv_int8").dlq_conv_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.cache
def launch_form(h: int, w: int, c: int, oc: int, kh: int, kw: int, stride: int, pad: int,
                int8_out: bool) -> str:
    """The form the kernel library takes for this conv (its own rule)."""
    fn = _build.library("conv_int8").dlq_conv_int8_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 9
    return "hopper" if fn(h, w, c, oc, kh, kw, stride, pad, int(int8_out)) else "first"


def conv_int8(x: torch.Tensor, pk: PackedConv, stride: int, pad: int,
              scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
              out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """int8 NHWC conv with fused epilogue. ``scale``/``bias``: fp32 [OC]
    (combined act*weight scale and folded bias); ``relu`` / ``relu6``: the
    activation; ``out_scale``: None for an fp32 output, else the consumer's
    activation scale for an int8 output."""
    if x.device.type == "cpu":
        return conv_int8_plain(x, pk, stride, pad, scale, bias, relu, out_scale, relu6)
    check_launch_args("conv_int8", x, pk, scale, bias)
    n, h, w, c = x.shape
    oc = pk.oc
    oh, ow = out_hw(h, w, pk.kh, pk.kw, stride, pad)
    out = torch.empty((n, oh, ow, oc), device=x.device,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    rc = _entry()(x.data_ptr(), pk.wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, w, c, oc, pk.kh, pk.kw, stride, pad, pk.wk.shape[1],
            act_code(relu, relu6), int(out_scale is not None),
            float(out_scale) if out_scale is not None else 1.0,
            _build.stream_ptr(x.device))
    _build.check(rc, "conv_int8")
    conv_int8.launches += 1
    conv_int8.by_shape[(n, h, w, c, oc, pk.kh, pk.kw, stride, pad, act_key(relu, relu6),
                        out_scale is not None)] += 1
    conv_int8.by_form[launch_form(h, w, c, oc, pk.kh, pk.kw, stride, pad,
                                  out_scale is not None)] += 1
    return out


conv_int8.launches = 0
conv_int8.by_shape = collections.Counter()
conv_int8.by_form = collections.Counter()
