"""K2: int8 GEMM with K1's fused fp32 / int8 epilogue.

Replaces ``dlq_tpu/ops/pallas_matmul.py:int8_matmul`` (kernel in
``csrc/matmul_int8.cu``). Computes, for x int8 [M, K] and int8 weights,

    acc = x @ w  (int32),  y = fma(float(acc), scale[n], bias[n]);  then relu or relu6
    out = y (fp32)   or   clip(rint(y / out_scale), relu|relu6 ? 0 : -127, 127) (int8)

It serves the W8A8 dense (the ResNet fc, ``int8_matmul``'s fp32 epilogue
with its ``fuse_relu``) and every 1x1/s1 conv as the reference's ``mm1x1``
rewrite: the conv on the free ``[N*H*W, C]`` view of NHWC, fp32 out under
the fp32-interchange contexts, int8 out (the consumer's requant) under the
int8-interchange ones. The weight is a ``PackedConv`` of a 1x1 kernel:
K-major ``[N, Kp]``, repacked once at load (``pack_dense_weight``).

``matmul_int8`` launches the kernel for a CUDA tensor and runs
``matmul_int8_plain`` for a CPU tensor. The kernel takes its Hopper form
(persistent, TMA-fed int8 ``wgmma``, ``csrc/i8gemm.cuh``) for K % 16 == 0
and its first form otherwise, by a static shape rule the kernel library
reports (``dlq_matmul_int8_form``; mirrored with the plan in
``ops.i8plan``): a refused launch raises, it never falls back.
``matmul_int8.launches`` counts kernel launches, ``matmul_int8.by_shape``
counts them per (M, K, N, activation (``act_key``), int8 out), ``matmul_int8.by_form`` per
form (``"hopper"``, ``"first"``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import (
    PackedConv, act_code, act_key, check_launch_args, epilogue_plain, pack_conv_weight,
)


def pack_dense_weight(w_ko: torch.Tensor) -> PackedConv:
    """[K, N] int8 (IO layout) -> K-major PackedConv of a 1x1 kernel."""
    k, n = w_ko.shape
    return pack_conv_weight(w_ko.reshape(1, 1, k, n))


def matmul_int8_plain(x: torch.Tensor, pk: PackedConv, scale: torch.Tensor,
                      bias: torch.Tensor, relu: bool = False,
                      out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2: exact float64 GEMM (K*127^2 < 2^53), then
    the shared epilogue."""
    acc = x.double() @ pk.wk[:, : pk.k].double().t()
    return epilogue_plain(acc, scale, bias, relu, out_scale, relu6)


@functools.cache
def _entry():
    fn = _build.library("matmul_int8").dlq_matmul_int8
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def launch_form(k: int) -> str:
    """The form the kernel library takes for depth K (its own rule)."""
    fn = _build.library("matmul_int8").dlq_matmul_int8_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return "hopper" if fn(k) else "first"


def matmul_int8(x: torch.Tensor, pk: PackedConv, scale: torch.Tensor,
                bias: torch.Tensor, relu: bool = False,
                out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """int8 [M, K] @ packed int8 weights with the fused epilogue (relu or
    relu6); fp32 [M, N], or int8 [M, N] at ``out_scale`` (the consumer's
    activation scale)."""
    if pk.kh != 1 or pk.kw != 1:
        raise ValueError("matmul_int8: weights must be a packed 1x1 / dense kernel")
    if x.device.type == "cpu":
        return matmul_int8_plain(x, pk, scale, bias, relu, out_scale, relu6)
    check_launch_args("matmul_int8", x, pk, scale, bias)
    m, k = x.shape
    n = pk.oc
    out = torch.empty((m, n), device=x.device,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    rc = _entry()(x.data_ptr(), pk.wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, n, k, pk.wk.shape[1], act_code(relu, relu6),
                  int(out_scale is not None),
                  float(out_scale) if out_scale is not None else 1.0,
                  _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int8")
    matmul_int8.launches += 1
    matmul_int8.by_shape[(m, k, n, act_key(relu, relu6), out_scale is not None)] += 1
    matmul_int8.by_form[launch_form(k)] += 1
    return out


matmul_int8.launches = 0
matmul_int8.by_shape = collections.Counter()
matmul_int8.by_form = collections.Counter()
