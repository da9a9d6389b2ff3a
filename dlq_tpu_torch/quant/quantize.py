"""Quantize/dequantize primitives and the QTensor container.

Same numeric contract as ``dlq_tpu.quant.quantize``: scales are fp32,
rounding is half-to-even (``torch.round``), symmetric schemes clip to
``[-qmax, qmax]``, int4 values are nibble-packed along axis 0 (the
contraction axis of a [K, O] weight): byte ``[k, o]`` holds row ``2k`` in
the low nibble and row ``2k+1`` in the high nibble. The W4A8 kernels read a
second packing, halves (``pack_int4_halves``), made once at load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch.quant.qconfig import QScheme


@dataclasses.dataclass
class QTensor:
    """A quantized tensor: integer values + scale (+ optional zero point).

    values: int8 tensor, or uint8 nibble-packed when bits == 4 (packed along
            the FIRST axis — the contraction axis of a [K, O] weight).
    scale:  fp32, per-tensor ``()``, per-channel ``(O,)`` or group-wise
            ``(K//g, O)``.
    shape:  logical (unpacked) shape.
    orig_shape: original layout shape (e.g. HWIO) when ``shape`` is a
            flattened [K, O] view.
    """

    values: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor]
    bits: int
    axis: Optional[int]
    group: Optional[int]
    shape: Tuple[int, ...]
    orig_shape: Optional[Tuple[int, ...]] = None

    @property
    def layout_shape(self) -> Tuple[int, ...]:
        return self.orig_shape if self.orig_shape is not None else self.shape

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scale) if t is not None)

    def to(self, device) -> "QTensor":
        zp = None if self.zero_point is None else self.zero_point.to(device)
        return dataclasses.replace(self, values=self.values.to(device),
                                   scale=self.scale.to(device), zero_point=zp)


def f32(v) -> float:
    """A Python float holding the fp32 rounding of ``v`` (a tensor on any
    device, a numpy scalar or a number). Host-side scale arithmetic done on
    ``np.float32`` values of these rounds as the reference's fp32 math does."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return float(np.float32(v))


def fdiv(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as an fp32 division. The divisor is made a tensor on ``a``'s
    device: CUDA divides by a host scalar as a multiply by its reciprocal,
    which can differ in the last bit from the reference's division."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def _amax_per(arr: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """abs-max reduced over all dims except `axis` (None = all dims)."""
    a = arr.abs()
    if axis is None:
        return a.max()
    axis = axis % arr.ndim
    red = tuple(i for i in range(arr.ndim) if i != axis)
    return a.amax(dim=red)


def quantize_tensor(arr: torch.Tensor, scheme: QScheme,
                    amax: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric (or affine per-tensor) quantization of a weight/activation.

    For group-wise int4 the array must be 2D [K, O]; groups run along K.
    """
    arr = torch.as_tensor(arr).to(torch.float32)
    if scheme.group is not None:
        if arr.ndim != 2:
            raise ValueError("group-wise quantization expects a 2D [K, O] view")
        K, O = arr.shape
        g = scheme.group
        if K % g != 0:
            raise ValueError(f"K={K} not divisible by group={g}")
        grouped = arr.reshape(K // g, g, O)
        amax_g = grouped.abs().amax(dim=1)  # [K//g, O]
        scale = torch.clamp_min(fdiv(amax_g, scheme.qmax), 1e-12)
        q = torch.clamp(torch.round(fdiv(grouped, scale[:, None, :])), scheme.qmin, scheme.qmax)
        q = q.reshape(K, O).to(torch.int8)
        values = pack_int4(q) if scheme.bits == 4 else q
        return QTensor(values, scale, None, scheme.bits, scheme.axis, g, tuple(arr.shape))

    if not scheme.symmetric:
        if scheme.axis is not None:
            raise NotImplementedError("affine quantization is per-tensor only")
        lo = torch.clamp_max(arr.min(), 0.0)
        hi = torch.clamp_min(arr.max(), 0.0)
        scale = torch.clamp_min(fdiv(hi - lo, scheme.qmax - scheme.qmin), 1e-12)
        zp = torch.round(scheme.qmin - fdiv(lo, scale)).to(torch.int32)
        q = torch.clamp(torch.round(fdiv(arr, scale)) + zp, scheme.qmin, scheme.qmax).to(torch.int8)
        return QTensor(q, scale, zp, scheme.bits, None, None, tuple(arr.shape))

    a = _amax_per(arr, scheme.axis) if amax is None else amax
    scale = torch.clamp_min(fdiv(a, scheme.qmax), 1e-12)
    if scheme.axis is not None:
        bshape = [1] * arr.ndim
        bshape[scheme.axis % arr.ndim] = -1
        s = scale.reshape(bshape)
    else:
        s = scale
    q = torch.clamp(torch.round(fdiv(arr, s)), scheme.qmin, scheme.qmax).to(torch.int8)
    values = pack_int4(q) if scheme.bits == 4 else q
    return QTensor(values, scale, None, scheme.bits, scheme.axis, None, tuple(arr.shape))


def dequantize(qt: QTensor) -> torch.Tensor:
    """fp32 reconstruction."""
    q = unpack_int4(qt.values, qt.shape) if qt.bits == 4 else qt.values
    q = q.to(torch.float32)
    if qt.zero_point is not None:
        q = q - qt.zero_point
    if qt.group is not None:
        K, O = qt.shape
        g = qt.group
        return (q.reshape(K // g, g, O) * qt.scale[:, None, :]).reshape(K, O)
    if qt.axis is not None:
        bshape = [1] * len(qt.shape)
        bshape[qt.axis % len(qt.shape)] = -1
        return q * qt.scale.reshape(bshape)
    return q * qt.scale


def effective_weight_scheme(shape: Tuple[int, ...], scheme: QScheme) -> QScheme:
    """The scheme a weight of `shape` actually quantizes under: the odd-K /
    non-divisible-group int8 fallbacks. [K, O] view: K = prod(shape[:-1])."""
    K = 1
    for d in shape[:-1]:
        K *= d
    if scheme.group is not None:
        if K % scheme.group != 0 or (scheme.bits == 4 and K % 2 != 0):
            return dataclasses.replace(scheme, group=None, bits=8)
        return scheme
    if scheme.bits == 4 and K % 2 != 0:
        return dataclasses.replace(scheme, bits=8)  # nibble packing needs even K
    return scheme


def unpack_to_layout(qt: QTensor) -> torch.Tensor:
    """Integer weight values in the tensor's original layout: int8 (and
    int2-stored-as-int8) as-is; int4 unpacked from nibbles (exact)."""
    if qt.bits == 4:
        return unpack_int4(qt.values, qt.shape).reshape(qt.layout_shape)
    return qt.values.reshape(qt.layout_shape)


def quantize_act(x: torch.Tensor, scale, qmax: int = 127) -> torch.Tensor:
    """Static symmetric activation quantization: fp -> int8 with given scale
    (fp32 divide, round half-to-even, clip)."""
    return torch.clamp(torch.round(fdiv(x.to(torch.float32), scale)), -qmax, qmax).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 tensor with values in [-8, 7] -> uint8 packed, axis-0 halved."""
    if q.shape[0] % 2 != 0:
        raise ValueError(f"axis 0 ({q.shape[0]}) must be even to pack")
    lo = q[0::2].view(torch.uint8) & 0xF
    hi = (q[1::2].view(torch.uint8) & 0xF) << 4
    return lo | hi


def unpack_int4(packed: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """uint8 packed -> int8 [-8, 7] with logical `shape` (axis-0 doubled)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(packed.shape[1:]))
    return out[: shape[0]].reshape(shape)


# Halves packing (the W4A8 kernels' operand): byte k holds values[k] in the
# low nibble and values[k + K/2] in the high nibble, so a kernel contracts
# the two halves against two contiguous slices of the activation.

def pack_int4_halves(q: torch.Tensor) -> torch.Tensor:
    """int8 [-8, 7] tensor [K, ...] -> uint8 [K/2, ...], top/bottom halves."""
    if q.shape[0] % 2 != 0:
        raise ValueError(f"axis 0 ({q.shape[0]}) must be even to pack")
    h = q.shape[0] // 2
    return (q[:h].view(torch.uint8) & 0xF) | ((q[h:].view(torch.uint8) & 0xF) << 4)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4_halves``: uint8 [K/2, ...] -> int8 [K, ...]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=0)
