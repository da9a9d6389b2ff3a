"""K13: W4A16 GEMM, bf16 activations against int4 weights with group-wise
scales.

Replaces ``dlq_tpu/ops/pallas_matmul.py:int4_matmul`` and
``int4_matmul_cached`` (kernel in ``csrc/matmul_int4.cu``), which compute one
function: for x [M, K] and a group-wise int4 weight W [K, N] with fp32
scales s [K/g, N],

    y = bf16(x) @ bf16(bf16(W) * bf16(s[k // g]))   (fp32 sums)
    y = y + bias;  y = max(y, 0) if relu            -> fp32 [M, N]

the dequantized weight rounded to bf16 once, after the exact product of the
nibble and the bf16-rounded group scale. It serves every group-wise int4
weight-only dense (``qops.qdense`` under ``DeployCtx`` on an
``INT4_WEIGHT_ONLY_G128`` store) at any M and N, K and g multiples of 16;
the reference's TPU tiling (the de-interleaved ``xe``/``xo`` columns, M
padding, ``int4_shapes_ok``) has no counterpart here.

The weight stays 4-bit on the card. ``pack_int4_weight`` repacks the store's
adjacent-row bytes once, at load: stored K-major, ``[N, Kp/2]`` bytes (Kp: K
rounded up to 64, zero past K), byte j of row n holding W[2j, n] and
W[2j + 1, n] as the store has them; the scales bf16 ``[N, G]``, G =
ceil(Kp / g), zero past K / g.

The sums are fp32 in the tensor core's order on the card, in XLA's order in
the reference, and exact (float64, one rounding to fp32) in the plain
version: outputs agree to a sum-order tolerance, not bit for bit.

``matmul_int4`` launches the kernel for a CUDA tensor and runs
``matmul_int4_plain`` for a CPU tensor. ``matmul_int4.launches`` counts kernel
launches, ``matmul_int4.by_shape`` counts them per (M, K, N, relu).
``ops.w4plan.matmul_int4_plan`` mirrors the kernel's launch plan.
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
from dlq_tpu_torch.ops.conv_int8 import K_ALIGN
from dlq_tpu_torch.quant.quantize import QTensor, unpack_int4


@dataclasses.dataclass
class PackedInt4G:
    """A group-wise int4 dense weight repacked for K13."""

    wp: torch.Tensor  # [N, Kp/2] uint8, adjacent nibbles, contiguous
    sc: torch.Tensor  # [N, G] bf16 group scales, contiguous
    k: int            # the logical K
    group: int

    @property
    def oc(self) -> int:
        return self.wp.shape[0]

    @property
    def kp(self) -> int:
        return 2 * self.wp.shape[1]


def pack_int4_weight(qw: QTensor) -> PackedInt4G:
    """A group-wise int4 dense weight (the store's ``[K/2, N]`` adjacent-row
    bytes, fp32 scales ``[K/g, N]``) -> ``PackedInt4G`` (once per site, at
    load)."""
    if qw.bits != 4 or qw.group is None or len(qw.shape) != 2:
        raise ValueError("pack_int4_weight: needs a group-wise int4 [K, N] weight")
    k, n = qw.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    g = qw.group
    wp = F.pad(qw.values, (0, 0, 0, (kp - k) // 2)).t().contiguous()
    sc = qw.scale.to(torch.bfloat16)
    sc = F.pad(sc, (0, 0, 0, -(-kp // g) - sc.shape[0])).t().contiguous()
    return PackedInt4G(wp, sc, k, g)


def dequantize_bf16(pk: PackedInt4G) -> torch.Tensor:
    """The weight as the kernel dequantizes it: bf16 [K, N], each value
    bf16(n · s) of the exact product of the nibble and the bf16 scale."""
    w = unpack_int4(pk.wp.t(), (pk.kp, pk.oc))[: pk.k].float()
    s = pk.sc.t().float().repeat_interleave(pk.group, dim=0)[: pk.k]
    return (w * s).to(torch.bfloat16)


def matmul_int4_plain(x: torch.Tensor, pk: PackedInt4G, bias: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K13: the exact sum (float64) of the bf16
    products, rounded once to fp32, then the fp32 bias add and relu."""
    y = torch.matmul(x.to(torch.bfloat16).double(), dequantize_bf16(pk).double()).float()
    if bias is not None:
        y = y + bias
    return torch.clamp_min(y, 0.0) if relu else y


@functools.cache
def _entry():
    fn = _build.library("matmul_int4").dlq_matmul_int4
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def matmul_int4(x: torch.Tensor, pk: PackedInt4G, bias: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
    """x [M, K] (bf16, or cast to bf16 first as the reference does) @ the
    packed weight, + bias (fp32 [N] or None), relu; fp32 [M, N]."""
    if x.device.type == "cpu":
        return matmul_int4_plain(x, pk, bias, relu)
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    x = x.contiguous()
    m, k = x.shape
    n = pk.oc
    if k != pk.k or k % 16 or pk.group % 16 or x.data_ptr() % 16:
        raise ValueError(f"matmul_int4: need a 16-byte aligned bf16 [M, {pk.k}] input with K and "
                         f"the group ({pk.group}) multiples of 16, got {tuple(x.shape)}")
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32, device=x.device)
    for t, name in ((pk.wp, "weights"), (pk.sc, "scales"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"matmul_int4: {name} must be contiguous on {x.device}")
    if bias.dtype != torch.float32 or bias.shape != (n,):
        raise ValueError(f"matmul_int4: bias must be fp32 [{n}]")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    rc = _entry()(x.data_ptr(), pk.wp.data_ptr(), pk.sc.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, n, k, pk.kp, pk.sc.shape[1], pk.group, int(relu),
                  _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int4")
    matmul_int4.launches += 1
    matmul_int4.by_shape[(m, k, n, bool(relu))] += 1
    return out


matmul_int4.launches = 0
matmul_int4.by_shape = collections.Counter()
