"""K6: fused multi-head self-attention, bf16 in and out (the counterpart of
``dlq_tpu/ops/pallas_attention.py``).

Replaces ``pallas_attention.fused_mhsa`` (kernel in ``csrc/mhsa.cu``) and
the attention inside the W8A8 block kernels
(``pallas_vit_block._mhsa_batched_into_scratch``, ``sm_mode="exact"``). Per
(sample, head), with bf16 Q, K, V of head width hd:

    s = (Q Kᵀ) · fp32(1/√hd)          fp32 sums of the exact bf16 products
    s[:, j] = -1e30 for keys j >= n_valid
    p = exp(s - max_j s);  a = bf16(p / Σ_j p)     (a division, not a reciprocal)
    out = bf16(a V)                    fp32 sums

``mhsa`` reads Q, K and V through their strides, so one kernel takes both
the block path's ``[B, Np, 3·Dp]`` qkv stream (three lane slices of one
tensor) and the deploy path's q/k/v (three slices of the qkv dense's
``[B, N, 3·D]`` output). It writes ``[B, rows, out_lanes]`` with the lanes
past ``heads·hd`` zero (the block path's pad-head lanes,
``pallas_vit_block.py:141-142``). Every query row is computed; rows past
``n_valid`` are the padded stream's and carry no meaning.

``mhsa`` launches the kernel for a CUDA tensor and runs ``mhsa_plain`` for a
CPU tensor. ``mhsa.launches`` counts kernel launches, ``mhsa.by_shape``
counts them per (B, rows, heads, hd, n_valid).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from dlq_tpu_torch import _build

HEAD_DIMS = (32, 64)   # the kernel's compiled head widths
MAX_KEYS = 256         # the kernel keeps a row's scores in registers


def softmax_scale(hd: int) -> float:
    """fp32(1/√hd), formed in double as the reference does (``:82``)."""
    return float(np.float32(1.0 / float(hd) ** 0.5))


def mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
               out_lanes: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K6 (same arithmetic, torch's sum order);
    probabilities and output in ``v.dtype`` (bf16 on both main paths)."""
    B, N, hw = q.shape
    hd = hw // heads

    def split(t):
        return t.reshape(B, N, heads, hd).permute(0, 2, 1, 3).float()

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * softmax_scale(hd)
    if n_valid < N:
        s[..., n_valid:] = -1e30
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    o = torch.matmul(a.float(), split(v)).to(v.dtype)
    o = o.permute(0, 2, 1, 3).reshape(B, N, hw)
    lanes = hw if out_lanes is None else out_lanes
    if lanes == hw:
        return o
    out = torch.zeros((B, N, lanes), dtype=o.dtype, device=q.device)
    out[..., :hw] = o
    return out


@functools.cache
def _entry():
    fn = _build.library("mhsa").dlq_mhsa
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_view(name: str, t: torch.Tensor, dev) -> None:
    if t.device != dev or t.dtype != torch.bfloat16 or t.ndim != 3:
        raise ValueError(f"mhsa: {name} must be a bf16 [B, rows, lanes] tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"mhsa: {name} needs unit lane stride, row and batch strides that are "
                         "multiples of 8 and a 16-byte aligned start (16-byte loads)")


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
         out_lanes: Optional[int] = None) -> torch.Tensor:
    """softmax(QKᵀ/√hd)V over ``heads`` heads of [B, rows, heads·hd] bf16
    views (any batch/row strides); returns bf16 [B, rows, out_lanes]
    (default heads·hd), lanes past heads·hd zero."""
    B, N, hw = q.shape
    if k.shape != q.shape or v.shape != q.shape or hw % heads:
        raise ValueError(f"mhsa: q/k/v shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} with {heads} heads")
    lanes = hw if out_lanes is None else out_lanes
    if not 0 < n_valid <= N or lanes < hw:
        raise ValueError(f"mhsa: n_valid {n_valid} of {N} rows, out_lanes {lanes} < {hw}")
    if q.device.type == "cpu":
        return mhsa_plain(q, k, v, heads, n_valid, out_lanes)
    hd = hw // heads
    if hd not in HEAD_DIMS or N > MAX_KEYS:
        raise ValueError(f"mhsa: head width {hd} (compiled: {HEAD_DIMS}) and {N} rows "
                         f"(at most {MAX_KEYS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.device)
    out = torch.empty((B, N, lanes), dtype=torch.bfloat16, device=q.device)
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                  out.stride(0), out.stride(1), B, N, heads, hd, n_valid, lanes,
                  softmax_scale(hd), _build.stream_ptr(q.device))
    _build.check(rc, "mhsa")
    mhsa.launches += 1
    mhsa.by_shape[(B, N, heads, hd, n_valid)] += 1
    return out


mhsa.launches = 0
mhsa.by_shape = collections.Counter()


def fused_mhsa(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The reference's interface (``pallas_attention.py:61``): q/v
    [BH, Np, hd], K pre-transposed kt [BH, hd, Np]; returns [BH, Np, hd] in
    ``v.dtype``. One head per batch entry of K6."""
    return mhsa(q, kt.transpose(1, 2).contiguous(), v, 1, n_valid).to(v.dtype)


def attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Drop-in for ``models.vit.attention`` (q/k/v [B, N, D], possibly lane
    slices of one qkv tensor). The reference pads N to a multiple of 128
    and slices the rows back (``pallas_attention.py:108-134``); with the
    key mask at n_valid = N that padding changes nothing, so K6 runs on N
    rows directly."""
    return mhsa(q, k, v, heads, q.shape[1])
