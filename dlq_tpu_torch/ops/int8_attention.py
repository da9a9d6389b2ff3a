"""K18: dynamically quantized int8 multi-head self-attention (the counterpart
of ``dlq_tpu/ops/int8_attention.py`` and of the ``attn_int8`` arm of
``pallas_vit_block._mhsa_batched_i8_into_scratch``).

Per (sample, head), with Q, K, V of head width hd read widened to fp32:

    aX  = max |X| + 1e-9                 over the (sample, head)'s rows
    X8  = clip(rint(X · (127 / aX)), ±127)                 (X = Q, K, V)
    s   = f32(Q8 K8ᵀ) · ((aq · ak) · c),  c = f32(1/√hd / 127²)   int32 sums
    s[:, j] = -1e30 for keys j >= n_valid
    p   = exp(s - max_j s);  a = p / Σ_j p                 (a division)
    a8  = clip(rint(a · 127), 0, 127)
    out = f32(a8 V8) · (av · f32(1/127²))                   int32 sums

in two forms, one flag:

  * ``zero_pad=True`` is ``attention_int8_dynamic`` (``int8_attention.py:
    34-82``; ``attn_impl="xla_int8"`` and the split-attention block): rows
    ``>= n_valid`` of Q, K and V are set to 0 before the amax;
  * ``zero_pad=False`` is the fused block's arm (``pallas_vit_block.py:
    237-276``): the amax runs over every row of the padded stream, pad rows
    included, and nothing is zeroed.

The reference writes the last rescale ``av / (127.0 * 127.0)``; XLA, which
compiles every reference function that reaches it (the forwards are
jitted, the Pallas arm's interpret mode too), turns that division by a
constant into a multiply by the constant's fp32 reciprocal, and so does
the port. Every integer step (the codes, both int32 sums) and the float
score ``s`` are exact functions of the inputs; only ``exp`` and the order of the row
sum differ between XLA, PyTorch and the kernel, and they flip a
probability code where ``a·127`` lies within an ulp of a half. A flipped
code moves its output row by ``v8_j · av / 127²``, at most ``av / 127``.

``mhsa_i8`` reads Q, K and V through their strides (lane slices of the
block path's ``[B, Np, 3·Dp]`` qkv stream, or of the deploy path's
``[B, N, 3·D]`` qkv dense) in bf16 or fp32, and writes
``[B, rows, out_lanes]`` in ``out_dtype`` with the lanes past ``heads·hd``
zero. It launches K18 (``csrc/mhsa_i8.cu``) for a CUDA tensor and runs
``mhsa_i8_plain`` for a CPU tensor; ``mhsa_i8.launches`` counts K18's
launches and ``.by_shape`` counts them per (B, rows, heads, hd, n_valid,
form, dtype in, dtype out), ``.by_form`` per kernel form.

K18 has two kernel forms of one arithmetic: its Hopper form (a persistent
grid; each item's raw Q, K and V read once into one stage, the amaxes and
the codes taken from it, the next item's load overlapping this item's
attention; one warp per 16 query rows over 64-key chunks) wherever
``mhsa_i8_form`` takes a shape (its stage and codes, ``mhsa_i8_plan``, fit
a block's shared memory), and its first form elsewhere, which stays
callable as ``mhsa_i8_first``. The two agree on every output.

``attention_bf16_masked`` (``int8_attention.py:85-113``, the split path's
control arm) is ``_mhsa_batched_into_scratch``'s exact softmax on bf16
operands: K6 (``ops.attention.mhsa``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.attention import _check, _check_view, mhsa
from dlq_tpu_torch.quant.quantize import fdiv

HEAD_DIMS = (32, 64)   # the kernel's compiled head widths
MAX_ROWS = 256         # 16 warps of 16 query rows (the first form: a score row in registers)
SMEM_MAX = 232448      # the opt-in shared-memory limit (launch.cuh: SMEM_OPT_IN)
H_MAX_WARPS = 16
DTYPES = {torch.bfloat16: 8, torch.float32: 4}   # dtype -> elements per 16-byte load
Q127 = 127.0 * 127.0
INV_Q127 = float(np.float32(1.0 / Q127))   # what XLA multiplies by for ``/ (127.0 * 127.0)``


def qk_scale(hd: int) -> float:
    """c = f32(1/√hd / 127²), formed in double as the reference's weakly
    typed constant ``scale / (127.0 * 127.0)`` is."""
    return float(np.float32((1.0 / float(hd) ** 0.5) / Q127))


def _split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    B, N, _ = t.shape
    return t.reshape(B, N, heads, hd).permute(0, 2, 1, 3)


def dyn_quant(a: torch.Tensor, dims=(2, 3)) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``a`` -> (int8 codes as fp32, amax): ``amax = max|a| + 1e-9``
    over ``dims``, ``clip(rint(a · (127 / amax)), ±127)`` (the division a
    tensor one: ``quantize.fdiv``)."""
    amax = a.abs().amax(dim=dims, keepdim=True) + 1e-9
    return torch.clamp(torch.round(a * fdiv(torch.full_like(amax, 127.0), amax)),
                       -127.0, 127.0), amax


def _int_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 codes held as floats, as fp32 (the float64
    product is exact: 256 · 127² < 2^53, and the sums fit fp32's 2^24)."""
    return torch.matmul(a.double(), b.double()).float()


def mhsa_i8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
                  out_lanes: Optional[int] = None, zero_pad: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K18 (both forms; arguments as ``mhsa_i8``)."""
    B, N, hw = q.shape
    hd = hw // heads
    qf, kf, vf = (_split_heads(t, heads, hd).float() for t in (q, k, v))
    if zero_pad and n_valid < N:
        qf, kf, vf = (torch.where(torch.arange(N, device=t.device)[:, None] < n_valid, t, 0.0)
                      for t in (qf, kf, vf))
    q8, aq = dyn_quant(qf)
    k8, ak = dyn_quant(kf)
    v8, av = dyn_quant(vf)
    s = _int_sums(q8, k8.transpose(-1, -2)) * ((aq * ak) * qk_scale(hd))
    if n_valid < N:
        s[..., n_valid:] = -1e30
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a8 = torch.clamp(torch.round((p / p.sum(-1, keepdim=True)) * 127.0), 0.0, 127.0)
    o = _int_sums(a8, v8) * (av * INV_Q127)
    o = o.permute(0, 2, 1, 3).reshape(B, N, hw).to(out_dtype or q.dtype)
    lanes = hw if out_lanes is None else out_lanes
    if lanes == hw:
        return o
    out = torch.zeros((B, N, lanes), dtype=o.dtype, device=q.device)
    out[..., :hw] = o
    return out


def _r(n: int, m: int) -> int:
    return -(-n // m) * m


def _i8_layout(rows: int, n_valid: int, hd: int, in_f32: bool) -> Tuple[int, int, int, int]:
    """(threads, raw stage bytes, code bytes, shared bytes) of the Hopper
    form: one warp per 16 query rows; the stage holds Q, K and V over the
    rows at hd x (4 or 2) + 16 bytes a row; the codes of Q over the rows
    rounded up to 16 and of K over n_valid rounded up to 32 at hd + 16
    bytes a row, and V^T (hd rows of n_valid rounded up to 32, + 16
    bytes); then 3 x 16 fp32 amax slots."""
    nq, nk = _r(rows, 16), _r(n_valid, 32)
    stage = 3 * rows * (hd * (4 if in_f32 else 2) + 16)
    codes = (nq + nk) * (hd + 16) + hd * (nk + 16)
    return nq // 16 * 32, stage, codes, stage + codes + 3 * H_MAX_WARPS * 4


def mhsa_i8_form(rows: int, n_valid: int, hd: int, in_f32: bool) -> str:
    """K18's form, a static shape rule (both zero_pad settings): ``"hopper"``
    for hd 32 or 64, 0 < n_valid <= rows <= 256, where the Hopper form's
    stage and codes fit a block's shared memory (bf16 at any rows, fp32 at
    DeiT's 197 and 200; at hd 64, fp32 at 256 rows does not fit), else
    ``"first"``."""
    ok = (hd in HEAD_DIMS and 0 < n_valid <= rows <= MAX_ROWS
          and _i8_layout(rows, n_valid, hd, in_f32)[3] <= SMEM_MAX)
    return "hopper" if ok else "first"


def mhsa_i8_plan(rows: int, n_valid: int, hd: int, in_f32: bool) -> Tuple[int, int, int, int]:
    """The Hopper form's launch plan (``csrc/mhsa_i8.cu``'s plan_i8, which the
    card test holds to this): (threads a block, raw stage bytes, code bytes,
    dynamic shared-memory bytes); all 0 where the first form serves."""
    if mhsa_i8_form(rows, n_valid, hd, in_f32) != "hopper":
        return 0, 0, 0, 0
    return _i8_layout(rows, n_valid, hd, in_f32)


@functools.cache
def _entry(suffix: str = ""):
    fn = getattr(_build.library("mhsa_i8"), f"dlq_mhsa_i8{suffix}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def _form_entry():
    fn = _build.library("mhsa_i8").dlq_mhsa_i8_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn


def library_form(rows: int, n_valid: int, hd: int, in_f32: bool) -> str:
    """The form the kernel library takes at this shape (its own rule,
    ``dlq_mhsa_i8_form``)."""
    return "hopper" if _form_entry()(rows, n_valid, hd, int(in_f32)) else "first"


def _launch(q, k, v, heads: int, n_valid: int, lanes: int, zero_pad: bool,
            out_dtype: torch.dtype, suffix: str = "") -> torch.Tensor:
    B, N, hw = q.shape
    hd = hw // heads
    if hd not in HEAD_DIMS or N > MAX_ROWS:
        raise ValueError(f"mhsa_i8: head width {hd} (compiled: {HEAD_DIMS}) and {N} rows "
                         f"(at most {MAX_ROWS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.device, DTYPES[q.dtype], "mhsa_i8")
    out = torch.empty((B, N, lanes), dtype=out_dtype, device=q.device)
    in_f32 = q.dtype == torch.float32
    rc = _entry(suffix)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                        v.stride(1), out.stride(0), out.stride(1), B, N, heads, hd, n_valid,
                        lanes, int(zero_pad), int(in_f32), int(out_dtype == torch.float32),
                        qk_scale(hd), _build.stream_ptr(q.device))
    _build.check(rc, "mhsa_i8" + suffix)
    if suffix:
        return out
    mhsa_i8.launches += 1
    mhsa_i8.by_shape[(B, N, heads, hd, n_valid, "zero_pad" if zero_pad else "in_kernel",
                      str(q.dtype)[6:], str(out_dtype)[6:])] += 1
    mhsa_i8.by_form[library_form(N, n_valid, hd, in_f32)] += 1
    return out


def _dtypes(q, k, v, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """Checks the input dtypes; returns the output dtype."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise ValueError(f"mhsa_i8: q, k and v must share a dtype, bf16 or fp32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPES:
        raise ValueError(f"mhsa_i8: bf16 or fp32 output, got {out_dtype}")
    return out_dtype


def mhsa_i8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
            out_lanes: Optional[int] = None, zero_pad: bool = False,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dynamically quantized int8 attention over ``heads`` heads of
    [B, rows, heads·hd] views (any batch/row strides) of one dtype, bf16 or
    fp32; keys ``>= n_valid`` masked, and with ``zero_pad`` rows ``>=
    n_valid`` zeroed before the amax. Returns [B, rows, out_lanes] (default
    heads·hd) in ``out_dtype`` (default ``q.dtype``), lanes past heads·hd
    zero."""
    out_dtype = _dtypes(q, k, v, out_dtype)
    lanes = _check(q, k, v, heads, n_valid, out_lanes, "mhsa_i8")
    if q.device.type == "cpu":
        return mhsa_i8_plain(q, k, v, heads, n_valid, out_lanes, zero_pad, out_dtype)
    return _launch(q, k, v, heads, n_valid, lanes, zero_pad, out_dtype)


def mhsa_i8_first(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, n_valid: int,
                  out_lanes: Optional[int] = None, zero_pad: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K18's first form at any shape it takes (a CUDA tensor only; not
    counted), arguments as ``mhsa_i8``: what the card tests and
    ``chip_smoke.py`` hold the Hopper form to, output for output."""
    out_dtype = _dtypes(q, k, v, out_dtype)
    lanes = _check(q, k, v, heads, n_valid, out_lanes, "mhsa_i8")
    if q.device.type != "cuda":
        raise ValueError("mhsa_i8_first: a CUDA tensor (the kernel's first form)")
    return _launch(q, k, v, heads, n_valid, lanes, zero_pad, out_dtype, "_first")


mhsa_i8.launches = 0
mhsa_i8.by_shape = collections.Counter()
mhsa_i8.by_form = collections.Counter()


def attention_int8_dynamic(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                           n_valid: Optional[int] = None,
                           out_dtype: Optional[torch.dtype] = None,
                           out_lanes: Optional[int] = None) -> torch.Tensor:
    """softmax(QKᵀ/√hd)V with both products int8 (``int8_attention.py:34``):
    q/k/v [B, N, heads·hd] (head-concatenated, fp32 or bf16); ``n_valid``
    masks the key columns past the real sequence and zeroes those rows
    first. Returns [B, N, out_lanes] (default heads·hd; the lanes past
    heads·hd zero, the split block's pad to Dp) in ``out_dtype`` (default
    q.dtype). K18, zero-pad form."""
    n = q.shape[1] if n_valid is None else n_valid
    return mhsa_i8(q, k, v, heads, n, out_lanes, zero_pad=True, out_dtype=out_dtype)


def attention_bf16_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          n_valid: Optional[int] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          out_lanes: Optional[int] = None) -> torch.Tensor:
    """The split path's bf16 control arm (``int8_attention.py:85``): bf16
    operands, fp32 scores, exact softmax, bf16 probabilities into the AV
    product: K6's arithmetic, so K6 (``ops.attention.mhsa``). Returns
    [B, N, out_lanes] (default heads·hd, lanes past heads·hd zero) in
    ``out_dtype`` (default q.dtype)."""
    bf = torch.bfloat16
    out = mhsa(q.to(bf), k.to(bf), v.to(bf), heads, q.shape[1] if n_valid is None else n_valid,
               out_lanes)
    return out.to(out_dtype or q.dtype)
