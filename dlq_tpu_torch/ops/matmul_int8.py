"""K2: int8 GEMM with K1's fused fp32 epilogue.

Replaces ``dlq_tpu/ops/pallas_matmul.py:int8_matmul`` (kernel in
``csrc/matmul_int8.cu``). Computes, for x int8 [M, K] and int8 weights,

    acc = x @ w  (int32),  out = fma(float(acc), scale[n], bias[n])  (fp32)

It serves the W8A8 dense (the ResNet fc). The weight is a ``PackedConv`` of
a 1x1 kernel: K-major ``[N, Kp]``, repacked once at load
(``pack_dense_weight``). The relu and int8-requant epilogues of the
reference's ``mm1x1`` traffic come with the Bottleneck slice; ResNet-18/34
have no 1x1/s1 conv.

``matmul_int8`` launches the kernel for a CUDA tensor and runs
``matmul_int8_plain`` for a CPU tensor. ``matmul_int8.launches`` counts
kernel launches, ``matmul_int8.by_shape`` counts them per (M, K, N).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import (
    PackedConv, check_launch_args, epilogue_plain, pack_conv_weight,
)


def pack_dense_weight(w_ko: torch.Tensor) -> PackedConv:
    """[K, N] int8 (IO layout) -> K-major PackedConv of a 1x1 kernel."""
    k, n = w_ko.shape
    return pack_conv_weight(w_ko.reshape(1, 1, k, n))


def matmul_int8_plain(x: torch.Tensor, pk: PackedConv, scale: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: exact float64 GEMM (K*127^2 < 2^53), then
    the shared fp32 epilogue."""
    acc = x.double() @ pk.wk[:, : pk.k].double().t()
    return epilogue_plain(acc, scale, bias, False, None)


@functools.cache
def _entry():
    fn = _build.library("matmul_int8").dlq_matmul_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def matmul_int8(x: torch.Tensor, pk: PackedConv, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ packed int8 weights with the fused epilogue; fp32 [M, N]."""
    if pk.kh != 1 or pk.kw != 1:
        raise ValueError("matmul_int8: weights must be a packed 1x1 / dense kernel")
    if x.device.type == "cpu":
        return matmul_int8_plain(x, pk, scale, bias)
    check_launch_args("matmul_int8", x, pk, scale, bias)
    m, k = x.shape
    n = pk.oc
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    rc = _entry()(x.data_ptr(), pk.wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, n, k, pk.wk.shape[1], _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int8")
    matmul_int8.launches += 1
    matmul_int8.by_shape[(m, k, n)] += 1
    return out


matmul_int8.launches = 0
matmul_int8.by_shape = collections.Counter()
