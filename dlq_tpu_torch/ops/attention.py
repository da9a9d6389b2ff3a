"""K6: fused multi-head self-attention, bf16 in and out, and its fp32 form
``mhsa_f32`` (the counterpart of ``dlq_tpu/ops/pallas_attention.py``).

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

The reference's ``fused_mhsa`` takes any float dtype (out in ``v.dtype``);
the fp32 forward with ``attn_impl="fused"`` gives it fp32 q/k/v. ``mhsa``
dispatches on the (shared) dtype: bf16 to K6, fp32 to its fp32 form
(``mhsa_f32``, the same file's second kernel: fp32 products and sums
without the tensor cores, which would round fp32 operands).

``mhsa_f32`` has two forms in that file: its Hopper form (a persistent
grid, K and V resident across 100-row query tiles, register-tiled FFMA
products fed by 16-byte shared loads) wherever ``mhsa_f32_form`` takes a
shape (its layout, ``mhsa_f32_plan``, fits a block's shared memory), and
its first form elsewhere, which stays callable as ``mhsa_f32_first``. Both
take every score as one FMA chain over d in ascending order and every
output as one over the keys in ascending order, with the same softmax, so
they agree on every output.

``mhsa`` launches a kernel for a CUDA tensor and runs ``mhsa_plain`` for a
CPU tensor. ``mhsa.launches`` counts K6's launches and ``mhsa_f32.launches``
its fp32 form's; ``.by_shape`` counts them per (B, rows, heads, hd,
n_valid), and ``mhsa_f32.by_form`` per form.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.models.common import fp32_matmul

HEAD_DIMS = (32, 64)   # the kernel's compiled head widths
MAX_KEYS = 256         # 16 warps of 16 query rows


def softmax_scale(hd: int) -> float:
    """fp32(1/√hd), formed in double as the reference does (``:82``)."""
    return float(np.float32(1.0 / float(hd) ** 0.5))


def mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
               out_lanes: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K6 and of its fp32 form (same arithmetic,
    torch's sum order, fp32 products with TF32 off); probabilities and
    output in ``v.dtype``."""
    B, N, hw = q.shape
    hd = hw // heads

    def split(t):
        return t.reshape(B, N, heads, hd).permute(0, 2, 1, 3).float()

    with fp32_matmul():
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


def mhsa_plan(rows: int, n_valid: int, hd: int) -> Tuple[int, int]:
    """K6's (threads a block, dynamic shared-memory bytes): one warp per 16
    query rows, and a 2-stage ring of Q over the rows and K, V over the
    n_valid keys, each rounded up to 16 rows of hd + 8 bf16 lanes
    (``csrc/mhsa.cu``'s launch, which the card test holds to this)."""
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return r16(rows) // 16 * 32, 2 * (r16(rows) + 2 * r16(n_valid)) * (hd + 8) * 2


# mhsa_f32's Hopper form (csrc/mhsa.cu's plan_f32, which the card test holds
# to this): 256 threads; Q K^T thread tiles of F32_TM query rows x 8 keys;
# query tiles of at most 100 rows, a multiple of F32_TM; the softmax holds a
# lane's keys lane + 32 j in registers, so at most F32_KEYS keys
F32_THREADS, F32_TM, F32_TN, F32_QT_MAX, F32_KEYS = 256, 5, 8, 100, 224
SMEM_MAX = 232448   # the opt-in shared-memory limit (launch.cuh: SMEM_OPT_IN)


def _f32_layout(rows: int, n_valid: int, hd: int) -> Tuple[int, int, int, int]:
    """(keys resident kp, query rows a tile qt, query tiles nt, shared
    bytes): kp = n_valid rounded up to 8; nt = ceil(rows / 100) tiles of qt
    rows (ceil(rows / nt) rounded up to F32_TM); fp32 K [kp][hd + 4], V
    [kp][hd], the Q tile [qt][hd + 4] and its scores [qt][kp + 4] with a
    scratch row for each of the 8 warps' softmax."""
    kp = -(-n_valid // 8) * 8
    nt = -(-rows // F32_QT_MAX)
    per = -(-rows // nt)
    qt = -(-per // F32_TM) * F32_TM
    return kp, qt, nt, 4 * (kp * (hd + 4) + kp * hd + qt * (hd + 4) + (qt + 8) * (kp + 4))


def mhsa_f32_form(rows: int, n_valid: int, hd: int) -> str:
    """``mhsa_f32``'s form, a static shape rule: ``"hopper"`` for hd 32 or
    64, 0 < n_valid <= rows <= 256, where the Hopper form's resident keys
    (at most 224) and layout fit (DeiT's 197 keys; 256 keys do not), else
    ``"first"``."""
    kp, _, _, smem = _f32_layout(rows, n_valid, hd)
    ok = hd in HEAD_DIMS and 0 < n_valid <= rows <= MAX_KEYS and kp <= F32_KEYS and smem <= SMEM_MAX
    return "hopper" if ok else "first"


def mhsa_f32_plan(rows: int, n_valid: int, hd: int) -> Tuple[int, int, int, int, int]:
    """The Hopper form's launch plan: (threads a block, dynamic shared-memory
    bytes, query rows a tile, query tiles, keys resident); all 0 where the
    first form serves."""
    if mhsa_f32_form(rows, n_valid, hd) != "hopper":
        return 0, 0, 0, 0, 0
    kp, qt, nt, smem = _f32_layout(rows, n_valid, hd)
    return F32_THREADS, smem, qt, nt, kp


# the kernel entry of each dtype, and the element count of its 16-byte loads
KERNELS = {torch.bfloat16: ("mhsa", 8), torch.float32: ("mhsa_f32", 4)}


def kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these q/k/v on the card: K6 (``"mhsa"``) for
    bf16, its fp32 form (``"mhsa_f32"``) for fp32. The three must share one
    dtype; anything else raises."""
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"mhsa: q, k and v must share a dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dtype not in KERNELS:
        raise ValueError(f"mhsa: bf16 or fp32 q/k/v, got {q.dtype}")
    return KERNELS[q.dtype][0]


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("mhsa"), f"dlq_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_view(name: str, t: torch.Tensor, dev, grain: int, what: str = "mhsa") -> None:
    if t.device != dev or t.ndim != 3:
        raise ValueError(f"{what}: {name} must be a [B, rows, lanes] tensor on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")
    if t.stride(2) != 1 or t.stride(1) % grain or t.stride(0) % grain or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs unit lane stride, row and batch strides that "
                         f"are multiples of {grain} and a 16-byte aligned start (16-byte loads)")


def _check(q, k, v, heads: int, n_valid: int, out_lanes: Optional[int],
           what: str = "mhsa") -> int:
    """Shape checks shared by both forms (and by K18, ``int8_attention``);
    returns the output lanes."""
    B, N, hw = q.shape
    if k.shape != q.shape or v.shape != q.shape or hw % heads:
        raise ValueError(f"{what}: q/k/v shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} with {heads} heads")
    lanes = hw if out_lanes is None else out_lanes
    if not 0 < n_valid <= N or lanes < hw:
        raise ValueError(f"{what}: n_valid {n_valid} of {N} rows, out_lanes {lanes} < {hw}")
    return lanes


@functools.cache
def _f32_form_entry():
    fn = _build.library("mhsa").dlq_mhsa_f32_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn


def library_f32_form(rows: int, n_valid: int, hd: int) -> str:
    """The form the kernel library takes for ``mhsa_f32`` at this shape (its
    own rule, ``dlq_mhsa_f32_form``)."""
    return "hopper" if _f32_form_entry()(rows, n_valid, hd) else "first"


def _launch(wrapper, q, k, v, heads: int, n_valid: int, lanes: int,
            suffix: str = "") -> torch.Tensor:
    """Launch K6 or its fp32 form on CUDA views and count it on ``wrapper``
    (none with ``suffix`` "_first": ``mhsa_f32``'s first form)."""
    name = kernel_for(q, k, v)
    B, N, hw = q.shape
    hd = hw // heads
    if hd not in HEAD_DIMS or N > MAX_KEYS:
        raise ValueError(f"mhsa: head width {hd} (compiled: {HEAD_DIMS}) and {N} rows "
                         f"(at most {MAX_KEYS})")
    for what, t in (("q", q), ("k", k), ("v", v)):
        _check_view(what, t, q.device, KERNELS[q.dtype][1])
    out = torch.empty((B, N, lanes), dtype=q.dtype, device=q.device)
    rc = _entry(name + suffix)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                               v.stride(1), out.stride(0), out.stride(1), B, N, heads, hd,
                               n_valid, lanes, softmax_scale(hd), _build.stream_ptr(q.device))
    _build.check(rc, name + suffix)
    if wrapper is None:
        return out
    wrapper.launches += 1
    wrapper.by_shape[(B, N, heads, hd, n_valid)] += 1
    return out


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
         out_lanes: Optional[int] = None) -> torch.Tensor:
    """softmax(QKᵀ/√hd)V over ``heads`` heads of [B, rows, heads·hd] views
    (any batch/row strides) of one dtype, bf16 (K6) or fp32 (``mhsa_f32``);
    returns [B, rows, out_lanes] (default heads·hd) in that dtype, lanes past
    heads·hd zero."""
    if kernel_for(q, k, v) == "mhsa_f32":
        return mhsa_f32(q, k, v, heads, n_valid, out_lanes)
    lanes = _check(q, k, v, heads, n_valid, out_lanes)
    if q.device.type == "cpu":
        return mhsa_plain(q, k, v, heads, n_valid, out_lanes)
    return _launch(mhsa, q, k, v, heads, n_valid, lanes)


def mhsa_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
             out_lanes: Optional[int] = None) -> torch.Tensor:
    """K6's fp32 form on fp32 q/k/v views, as ``mhsa``: the Hopper form where
    ``mhsa_f32_form`` takes the shape, else the first form."""
    lanes = _check(q, k, v, heads, n_valid, out_lanes)
    if kernel_for(q, k, v) != "mhsa_f32":
        raise ValueError(f"mhsa_f32: fp32 q/k/v, got {q.dtype}")
    if q.device.type == "cpu":
        return mhsa_plain(q, k, v, heads, n_valid, out_lanes)
    out = _launch(mhsa_f32, q, k, v, heads, n_valid, lanes)
    mhsa_f32.by_form[library_f32_form(q.shape[1], n_valid, q.shape[2] // heads)] += 1
    return out


def mhsa_f32_first(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
                   out_lanes: Optional[int] = None) -> torch.Tensor:
    """``mhsa_f32``'s first form at any shape (a CUDA tensor only; not
    counted): what the card tests and ``chip_smoke.py`` hold the Hopper
    form to, output for output."""
    lanes = _check(q, k, v, heads, n_valid, out_lanes)
    if kernel_for(q, k, v) != "mhsa_f32" or q.device.type != "cuda":
        raise ValueError("mhsa_f32_first: fp32 q/k/v on a CUDA device (the kernel's first form)")
    return _launch(None, q, k, v, heads, n_valid, lanes, "_first")


for _f in (mhsa, mhsa_f32):
    _f.launches = 0
    _f.by_shape = collections.Counter()
mhsa_f32.by_form = collections.Counter()


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
