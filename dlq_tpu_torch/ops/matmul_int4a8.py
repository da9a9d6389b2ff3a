"""K10: W4A8 GEMM, int8 activations against int4 per-OC weights.

Replaces ``dlq_tpu/ops/pallas_matmul.py:int4a8_matmul`` and
``int4a8_matmul_cached`` (kernel in ``csrc/matmul_int4a8.cu``), which
compute one function: for x int8 [M, K] and int4 weights W [K, N],

    acc = x @ W  (int32),  y = fma(float(acc), scale[n], bias[n]);  y = max(y, 0) if relu

to fp32 [M, N]. It serves every per-OC int4 dense with an activation scale
(``qops.qdense`` under ``DeployCtx`` on an INT4A8 store), at any M, N and
even K: the reference's TPU tiling condition (``dlq_tpu/ops/qops.py:433-435``)
has no counterpart here.

The weight stays 4-bit on the card. ``pack_int4a8_weight`` repacks the
store's adjacent-row bytes once, at load: unpacked to int8, zero-padded
along K to a multiple of 64, halves-packed (``pack_int4_halves``) and
stored K-major, ``[N, Kp/2]`` bytes, byte k of row n holding W[k, n] and
W[k + Kp/2, n]: the layout the kernel streams.

``matmul_int4a8`` launches the kernel for a CUDA tensor and runs
``matmul_int4a8_plain`` for a CPU tensor. ``matmul_int4a8.launches`` counts
kernel launches, ``matmul_int4a8.by_shape`` counts them per (M, K, N, relu).
``ops.w4plan.matmul_int4a8_plan`` mirrors the kernel's launch plan.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import K_ALIGN, epilogue_plain
from dlq_tpu_torch.quant.quantize import (
    QTensor, pack_int4_halves, unpack_int4, unpack_int4_halves,
)


def pack_halves_kmajor(w: torch.Tensor, kp: int, n: int) -> torch.Tensor:
    """int8 [K', N'] (values in [-8, 7]) -> zero-padded to [kp, n],
    halves-packed along K and stored K-major: uint8 [n, kp/2]."""
    w = F.pad(w, (0, n - w.shape[1], 0, kp - w.shape[0]))
    return pack_int4_halves(w).t().contiguous()


def unpack_halves_kmajor(wp: torch.Tensor) -> torch.Tensor:
    """uint8 [N, Kp/2] -> the int8 K-major weight [N, Kp]."""
    return unpack_int4_halves(wp.t()).t()


@dataclasses.dataclass
class PackedInt4:
    """A dense int4 weight repacked for K10."""

    wp: torch.Tensor  # [N, Kp/2] uint8, contiguous
    k: int            # the logical K

    @property
    def oc(self) -> int:
        return self.wp.shape[0]

    @property
    def kp(self) -> int:
        return 2 * self.wp.shape[1]


def pack_int4a8_weight(qw: QTensor) -> PackedInt4:
    """A per-OC int4 dense weight (the store's ``[K/2, N]`` adjacent-row
    bytes) -> ``PackedInt4`` (done once per site, at load)."""
    if qw.bits != 4 or qw.group is not None or len(qw.shape) != 2:
        raise ValueError("pack_int4a8_weight: needs a per-OC int4 [K, N] weight")
    k, n = qw.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    return PackedInt4(pack_halves_kmajor(unpack_int4(qw.values, qw.shape), kp, n), k)


def matmul_int4a8_plain(x: torch.Tensor, pk: PackedInt4, scale: torch.Tensor,
                        bias: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K10: exact float64 GEMM (K·127·8 < 2^53) on
    the unpacked weight, then the fp32 epilogue."""
    w = unpack_halves_kmajor(pk.wp)[:, : pk.k]
    return epilogue_plain(x.double() @ w.double().t(), scale, bias, relu, None)


@functools.cache
def _entry():
    fn = _build.library("matmul_int4a8").dlq_matmul_int4a8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def matmul_int4a8(x: torch.Tensor, pk: PackedInt4, scale: torch.Tensor, bias: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """int8 [M, K] @ packed int4 weights with the fused fp32 epilogue; fp32
    [M, N]. ``scale``/``bias``: fp32 [N] (combined act·weight scale, bias)."""
    if x.device.type == "cpu":
        return matmul_int4a8_plain(x, pk, scale, bias, relu)
    m, k = x.shape
    if x.dtype != torch.int8 or not x.is_contiguous() or k != pk.k or x.data_ptr() % 16:
        raise ValueError(f"matmul_int4a8: need a contiguous, 16-byte aligned int8 [M, {pk.k}] "
                         f"input, got {x.dtype} {tuple(x.shape)}")
    n = pk.oc
    for t, name in ((pk.wp, "weights"), (scale, "scale"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"matmul_int4a8: {name} must be contiguous on {x.device}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"matmul_int4a8: scale and bias must be fp32 [{n}]")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    rc = _entry()(x.data_ptr(), pk.wp.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, n, k, pk.kp, int(relu), _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int4a8")
    matmul_int4a8.launches += 1
    matmul_int4a8.by_shape[(m, k, n, bool(relu))] += 1
    return out


matmul_int4a8.launches = 0
matmul_int4a8.by_shape = collections.Counter()
