"""Quantized conv / dense ops (the counterpart of ``dlq_tpu.ops.qops``).

Numerics contract, shared with the reference:
  * activations quantized symmetric int8 with a static per-site scale,
    round half-to-even;
  * int8 x int8 -> int32 accumulation;
  * fp32 epilogue y = fma(float(acc), act_scale * w_scale[oc], bias[oc]),
    then relu — one fused multiply-add, as XLA contracts ``acc * s + b``.

Every int8 dense goes through K2 (``ops.matmul_int8``), every per-OC int4
dense with an activation scale (W4A8) through K10 (``ops.matmul_int4a8``),
its weight kept 4-bit on the card. A groups-1
1x1/s1/p0 conv takes the reference's ``mm1x1`` rewrite (``qops.py:384-387``,
on by default in its deploy contexts): K2 on the free ``[N*H*W, C]`` view of
the NHWC input (``conv1x1_int8``). Every other int8 conv (3x3, the 1x1/s2
downsamples, the stems) goes through K1 (``ops.conv_int8``), and every
depthwise conv (``groups == C``, HWIO ``[kh, kw, 1, C]``) through K23
(``ops.depthwise_int8``, ``resolve_depthwise``). A per-OC int4
conv weight is unpacked to int8 once, when its context is built, and runs on
K1/K2; the reference unpacks it in the graph on every forward
(``dlq_tpu/ops/qops.py:380``). Both are exact, and no Pallas kernel is
involved.
Weight-only schemes (no activation scale), and group-wise int4 weights with
one (the activations fake-quantized first, as the reference's
``qops.py:416-422``): a group-wise int4 dense goes
through K13 (``ops.matmul_int4``), its weight kept 4-bit, as the reference
sends it to ``int4_matmul`` on its accelerator (``dlq_tpu/ops/qops.py:469-481``);
so the port computes ``int4_matmul``'s rounding (the weight dequantized to
bf16 from the bf16-rounded group scale, bf16 activations) on the card and on
the CPU alike, where the reference's CPU route dequantizes in fp32 and rounds
the weight once to ``x.dtype`` (``:482-487``): a difference inside the
reference (ROADMAP.md C). Every other weight-only site (per-OC int4, int8,
convs) dequantizes and runs a float conv/matmul, as the reference leaves it
to XLA.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from dlq_tpu_torch.models.common import conv2d, fp32_matmul
from dlq_tpu_torch.ops.conv_int8 import PackedConv, conv_int8, epilogue_plain, pack_conv_weight
from dlq_tpu_torch.ops.depthwise_int8 import (
    PackedDepthwise, depthwise_int8, is_depthwise_weight, pack_depthwise_weight,
)
from dlq_tpu_torch.ops.matmul_int4 import PackedInt4G, matmul_int4, pack_int4_weight
from dlq_tpu_torch.ops.matmul_int4a8 import PackedInt4, matmul_int4a8, pack_int4a8_weight
from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, pack_dense_weight
from dlq_tpu_torch.quant.quantize import QTensor, dequantize, quantize_act, unpack_to_layout


def int_weight_packed(qw: QTensor) -> PackedConv:
    """K-major packed int8 weights of a conv (HWIO) or dense (IO) site;
    int4 per-OC weights unpack exactly to int8 first."""
    if qw.group is not None:
        raise ValueError("group-wise scales cannot fold into the int8 epilogue; "
                         "use the weight-only path")
    w = unpack_to_layout(qw).to(torch.int8)
    return pack_dense_weight(w) if w.ndim == 2 else pack_conv_weight(w)


def resolve_depthwise(impl: Optional[str] = None) -> str:
    """The depthwise-conv implementation, resolved once when an engine or a
    context is built (``dlq_tpu/ops/qops.py:64 resolve_depthwise``): a given
    name is used as it is; None takes the ``DLQ_DEPTHWISE`` environment
    variable, default ``"int8"``; any other name raises ValueError.

    ``"int8"`` and ``"stencil"`` both run K23 on the card (its plain version,
    an exact int32 stencil, on the CPU): they are the same exact int32 sums,
    and the reference tells them apart only to dodge a TPU miscompile, which
    its one-time canary guards against by falling back to the stencil. Here
    K23 is held to its plain version on the card instead, so a wrong kernel
    fails loudly and nothing falls back. ``"fp32"`` is the reference's A/B
    route (``dlq_tpu/ops/qops.py:142-159``): an fp32 grouped conv of the
    integer values with TF32 off, then the same epilogue; exact, as every
    sum satisfies |sum| <= 9 * 127^2 < 2^24."""
    if impl is None:
        impl = os.environ.get("DLQ_DEPTHWISE", "int8")
    if impl not in ("int8", "fp32", "stencil"):
        raise ValueError(f"DLQ_DEPTHWISE must be int8|fp32|stencil, got {impl!r}")
    return impl


def depthwise_weight_packed(qw: QTensor) -> PackedDepthwise:
    """The ``[kh * kw, C]`` int8 weight of a depthwise site for K23; int4
    per-OC weights (quantized on the ``[kh * kw, C]`` view) unpack exactly
    to int8 first."""
    if qw.group is not None:
        raise ValueError("group-wise scales cannot fold into the int8 epilogue; "
                         "use the weight-only path")
    return pack_depthwise_weight(unpack_to_layout(qw).to(torch.int8))


def depthwise_conv(xq: torch.Tensor, pk: PackedDepthwise, stride, padding, scale: torch.Tensor,
                   bias: torch.Tensor, impl: str, relu: bool = False, relu6: bool = False,
                   out_scale: Optional[float] = None) -> torch.Tensor:
    """An int8 depthwise conv with the fused epilogue by the resolved
    ``impl``: K23 for ``"int8"`` and ``"stencil"``; for ``"fp32"`` an fp32
    grouped conv of the integer values (TF32 off) and the plain epilogue."""
    if impl == "fp32":
        acc = conv2d(xq.float(), pk.hwio().float(), stride=stride, padding=padding, groups=pk.c)
        return epilogue_plain(acc, scale, bias, relu, out_scale, relu6)
    return depthwise_int8(xq, pk, _int(stride), _int(padding), scale, bias, relu=relu,
                          out_scale=out_scale, relu6=relu6)


def is_depthwise(qw: QTensor, groups: int) -> bool:
    """Is this conv a depthwise one (``groups == C`` on a ``[kh, kw, 1, C]`` weight)?"""
    return (groups > 1 and is_depthwise_weight(tuple(qw.layout_shape))
            and qw.layout_shape[3] == groups)


def site_weight_packed(qw: QTensor):
    """The packed weight a context keeps for a site: a per-OC int4 dense
    stays 4-bit for K10 (``PackedInt4``), every other site is K-major int8
    for K1/K2 (``int_weight_packed``)."""
    if qw.bits == 4 and qw.group is None and len(qw.layout_shape) == 2:
        return pack_int4a8_weight(qw)
    return int_weight_packed(qw)


def weight_only_packed(qw: QTensor) -> Optional[PackedInt4G]:
    """The packed weight a context keeps for a site that takes the
    weight-only route: a group-wise int4 dense repacked for K13 when K and
    the group are multiples of 16 (the kernel's 16-wide K steps), else None
    (dequantized, as the reference routes what its kernel does not tile,
    ``dlq_tpu/ops/qops.py:469-487``)."""
    if (qw.bits == 4 and qw.group is not None and len(qw.layout_shape) == 2
            and qw.shape[0] % 16 == 0 and qw.group % 16 == 0):
        return pack_int4_weight(qw)
    return None


def dense_int(xq: torch.Tensor, pk, scale: torch.Tensor, bias: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    """int8 [M, K] against a site's packed weight: K10 for int4, K2 for int8."""
    if isinstance(pk, PackedInt4):
        return matmul_int4a8(xq, pk, scale, bias, relu=relu)
    return matmul_int8(xq, pk, scale, bias, relu=relu)


def combined_scale(act_scale: float, qw: QTensor, n: int) -> torch.Tensor:
    """fp32 [n] act_scale * w_scale (per-tensor scales broadcast)."""
    return torch.broadcast_to(qw.scale.float() * act_scale, (n,)).contiguous()


def bias_or_zeros(bias: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    return torch.zeros(n, device=device) if bias is None else bias.float().contiguous()


def _int(v) -> int:
    if isinstance(v, int):
        return v
    if v[0] != v[1]:
        raise NotImplementedError("asymmetric stride/padding is not ported")
    return int(v[0])


def is_mm1x1(pk: PackedConv, stride, padding) -> bool:
    """Does this (groups-1) conv take the ``mm1x1`` route: 1x1/s1/p0?"""
    return (pk.kh, pk.kw) == (1, 1) and _int(stride) == 1 and _int(padding) == 0


def conv1x1_int8(xq: torch.Tensor, pk: PackedConv, scale: torch.Tensor, bias: torch.Tensor,
                 relu: bool = False, out_scale: Optional[float] = None,
                 relu6: bool = False) -> torch.Tensor:
    """A 1x1/s1 int8 conv as K2 on the ``[N*H*W, C]`` view (a free reshape of
    contiguous NHWC); returns NHWC, fp32 or int8 at ``out_scale``."""
    lead = xq.shape[:-1]
    y = matmul_int8(xq.reshape(-1, xq.shape[-1]), pk, scale, bias, relu=relu,
                    out_scale=out_scale, relu6=relu6)
    return y.reshape(lead + (pk.oc,))


def qconv2d(x: torch.Tensor, qw: QTensor, bias: Optional[torch.Tensor], act_scale: float,
            stride=1, padding=0, groups: int = 1, fuse_relu: bool = False,
            act_qmax: int = 127, packed=None, depthwise: Optional[str] = None) -> torch.Tensor:
    """W8A8 conv: quantize the input with the calibrated static scale, int8
    conv with int32 accumulation (K2 for a 1x1/s1 conv, K23 for a depthwise
    conv, by ``depthwise`` (``resolve_depthwise``), K1 otherwise), fp32
    per-channel epilogue (+bias, +relu). Any other grouped conv raises: no
    model of the repo has one.
    ``packed``: the site's packed weights, when the caller keeps them."""
    if groups != 1:
        if not is_depthwise(qw, groups):
            raise NotImplementedError(
                f"grouped int8 conv with groups={groups} on a {tuple(qw.layout_shape)} weight: "
                "only depthwise convs (groups == C, [kh, kw, 1, C]) are ported")
        pk = depthwise_weight_packed(qw) if packed is None else packed
        xq = quantize_act(x, act_scale, act_qmax)
        return depthwise_conv(xq, pk, stride, padding, combined_scale(act_scale, qw, pk.c),
                              bias_or_zeros(bias, pk.c, x.device), resolve_depthwise(depthwise),
                              relu=fuse_relu)
    pk = int_weight_packed(qw) if not isinstance(packed, PackedConv) else packed
    xq = quantize_act(x, act_scale, act_qmax)
    comb = combined_scale(act_scale, qw, pk.oc)
    b = bias_or_zeros(bias, pk.oc, x.device)
    if is_mm1x1(pk, stride, padding):
        return conv1x1_int8(xq, pk, comb, b, relu=fuse_relu)
    return conv_int8(xq, pk, _int(stride), _int(padding), comb, b, relu=fuse_relu)


def qdense(x: torch.Tensor, qw: QTensor, bias: Optional[torch.Tensor],
           act_scale: Optional[float] = None, fuse_relu: bool = False,
           act_qmax: int = 127, packed=None) -> torch.Tensor:
    """Quantized dense. int8/int2 weights + act_scale -> W8A8 int8 GEMM (K2)
    with int32 accumulation; per-OC int4 weights + act_scale -> W4A8 (K10);
    group-wise int4 weights + act_scale -> the activations fake-quantized
    (``quantize_act(x)·s`` in ``x.dtype``), then weight-only, as the
    reference (``dlq_tpu/ops/qops.py:416-422``): group scales cannot fold
    into an int epilogue; no act_scale -> weight-only: group-wise int4
    weights on K13 (W4A16, ``int4_matmul``'s rounding; K and the group
    multiples of 16), any other weights dequantized to ``x.dtype`` with an
    fp32 product. Group-wise int8 weights with an act_scale raise the
    reference's ValueError.
    qw.values: [I, O]. The result is cast to ``x.dtype`` after the bias and
    relu, as the reference's (``dlq_tpu/ops/qops.py:488-492``): a bf16 input
    gives a bf16 output. ``packed``: the site's kernel weight, when the
    caller keeps it."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if act_scale is not None and qw.bits == 4 and qw.group is not None:
        x2 = (quantize_act(x2, act_scale, act_qmax).float() * act_scale).to(x.dtype)
        act_scale = None
    if act_scale is not None:
        pk = site_weight_packed(qw) if packed is None else packed
        xq = quantize_act(x2, act_scale, act_qmax)
        y = dense_int(xq, pk, combined_scale(act_scale, qw, pk.oc),
                      bias_or_zeros(bias, pk.oc, x.device), relu=fuse_relu)
    elif (pk := weight_only_packed(qw) if packed is None else packed) is not None:
        y = matmul_int4(x2, pk, None if bias is None else bias.float().contiguous(),
                        relu=fuse_relu)
    else:
        w = dequantize(qw).reshape(qw.layout_shape).to(x.dtype)
        with fp32_matmul():
            y = torch.matmul(x2.float(), w.float())
        if bias is not None:
            y = y + bias
        if fuse_relu:
            y = torch.clamp_min(y, 0.0)
    y = y.to(x.dtype)
    return y.reshape(lead + (y.shape[-1],))


def dequant_conv2d(x: torch.Tensor, qw: QTensor, bias: Optional[torch.Tensor],
                   stride=1, padding=0, groups: int = 1, fuse_relu: bool = False) -> torch.Tensor:
    """Weight-only conv: dequantized weights, float conv (TF32 off)."""
    w = dequantize(qw).reshape(qw.layout_shape).to(x.dtype)
    y = conv2d(x, w, stride=stride, padding=padding, groups=groups, bias=bias)
    return torch.clamp_min(y, 0.0) if fuse_relu else y
