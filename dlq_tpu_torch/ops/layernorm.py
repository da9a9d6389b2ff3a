"""K16 ``layernorm_fused`` and K17 ``residual_layernorm``: the fused
LayerNorms (the counterpart of ``dlq_tpu/ops/pallas_layernorm.py``).

``ViTConfig(fused_ln=True)`` runs every LayerNorm of the DeiT encoder
through them (``models.vit._encoder``): the first LN1 as ``layernorm_fused``,
every later ``y += delta; h = LN(y)`` junction (LN1 of the next layer, LN2,
the final norm) as ``residual_layernorm``. What they compute, per row of
``[..., D]`` in fp32 (``_ln_body`` :29-41 with ``d_valid = D``):

    mu = Σx · (1/D),  m2 = Σx² · (1/D),  var = max(m2 − mu², 0)
    h  = (x − mu) · rsqrt(var + eps) · g + b                  -> x.dtype

and for ``residual_layernorm`` ``z = f32(y) + f32(delta)``, stored in
``y.dtype``, with ``h = LN(z)`` taken from the unrounded fp32 z and written
in ``y.dtype`` (``_res_ln_kernel`` :50-55). g and b come in the stream's
dtype (another raises) and are read widened to fp32. The reference's row padding to 8 and
``_rows_block`` are TPU tiling and have no counterpart.

Each wrapper launches its kernel (``csrc/layernorm.cu``) for a CUDA tensor
and runs its plain version for a CPU tensor; ``.launches`` counts kernel
launches and ``.by_shape`` counts them per (rows, D, dtypes).

K16 has two forms, picked by a static rule (``layernorm_form``, mirroring
``dlq_layernorm_form``): the Hopper form (a persistent grid whose blocks
keep tiles of rows in flight into shared memory by bulk copies, each warp's
row read from there in the first form's lane order, the columns a lane
compiled and g and b held in registers) where D <= 512, rows are a
multiple of 16 bytes and x and out are 16-byte aligned, in bf16 and fp32;
else the first form (one warp a row, straight from device memory), which
stays callable as ``layernorm_fused_first``. Both forms run the same
arithmetic in the same order, so they agree on every output;
``layernorm_fused.by_form`` counts launches per form. K17 has one form.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from dlq_tpu_torch import _build

LN_EPS = 1e-6
DTYPES = (torch.bfloat16, torch.float32)
# K16's Hopper form (csrc/layernorm.cu: hopper_takes, launch_hopper_t; a
# change to one is made in both places): the largest row it takes (the
# first form's ROW_REGS x 32 lanes), the bytes of a tile of rows, tiles in
# flight a block, blocks an SM
HOPPER_MAX_D = 512
HOPPER_STAGE_BYTES, HOPPER_STAGES, HOPPER_BLOCKS = 12288, 4, 4


def ln_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, d_valid: int,
           eps: float = LN_EPS) -> torch.Tensor:
    """The reference's two-moment LayerNorm on fp32 rows, exact over the
    d_valid prefix (pad lanes zero on entry, and on exit where g/b are
    zero-padded): ``inv_n = 1/d_valid`` and every step in fp32, as
    ``_ln_body`` and ``pallas_vit_block._ln_f32`` write it."""
    inv_n = 1.0 / float(d_valid)
    mu = x.sum(-1, keepdim=True) * inv_n
    m2 = (x * x).sum(-1, keepdim=True) * inv_n
    var = torch.clamp_min(m2 - mu * mu, 0.0)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def layernorm_fused_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                          eps: float = LN_EPS) -> torch.Tensor:
    """Plain PyTorch version of K16."""
    return ln_f32(x.float(), g.float(), b.float(), x.shape[-1], eps).to(x.dtype)


def residual_layernorm_plain(y: torch.Tensor, delta: torch.Tensor, g: torch.Tensor,
                             b: torch.Tensor, eps: float = LN_EPS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K17: (z, h), both in ``y.dtype``, h from
    the unrounded fp32 z."""
    z = y.float() + delta.float()
    return z.to(y.dtype), ln_f32(z, g.float(), b.float(), y.shape[-1], eps).to(y.dtype)


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("layernorm"), f"dlq_{name}")
    fn.restype = ctypes.c_int
    if name != "residual_layernorm":   # x, x_f32, g, b, out, M, D, eps, stream
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    else:                          # y, y_f32, delta, d_f32, g, b, z, h, M, D, eps, stream
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def layernorm_form(m: int, d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """K16's form for m rows of D in ``dtype`` (bf16 or fp32): ``"hopper"``
    where D <= 512 and rows are a multiple of 16 bytes, x and out 16-byte
    aligned, else ``"first"`` (not the batch or the card)."""
    esize = torch.finfo(dtype).bits // 8
    takes = d <= HOPPER_MAX_D and d * esize % 16 == 0
    return "hopper" if m > 0 and aligned and takes else "first"


def layernorm_hopper_tiles(m: int, d: int, dtype: torch.dtype, sms: int) -> Tuple[int, int, int, int]:
    """The Hopper form's walk for m rows of D: (rows a tile, tiles, blocks,
    shared-memory bytes). Block b takes tiles b, b + blocks, ...; the grid
    is at most HOPPER_BLOCKS an SM and never more than the tiles."""
    rb = d * (torch.finfo(dtype).bits // 8)
    rows = HOPPER_STAGE_BYTES // rb
    tiles = -(-m // rows)
    return rows, tiles, min(tiles, HOPPER_BLOCKS * sms), HOPPER_STAGES * rows * rb + 8 * HOPPER_STAGES


@functools.cache
def _form_entry():
    fn = _build.library("layernorm").dlq_layernorm_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn


@functools.cache
def library_form(m: int, d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The form the kernel library takes for K16 here (its own rule)."""
    return "hopper" if _form_entry()(m, d, _f32_dtype(dtype), int(aligned)) else "first"


def _check(what: str, t: torch.Tensor, dev, d: int) -> None:
    if t.device != dev or t.dtype not in DTYPES or t.shape[-1] != d or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous bf16 or fp32 [..., {d}] tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_affine(what: str, g: torch.Tensor, b: torch.Tensor, dtype: torch.dtype, d: int) -> None:
    """g and b [D] in the stream's dtype, as ``make_qforward`` casts them."""
    if g.dtype != dtype or b.dtype != dtype or g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"{what}: g and b must be [{d}] in the stream's {dtype}, got {g.dtype} "
                         f"{tuple(g.shape)}, {b.dtype} {tuple(b.shape)}")


def _f32_dtype(dtype: torch.dtype) -> int:
    return int(dtype == torch.float32)


def _f32(t: torch.Tensor) -> int:
    return _f32_dtype(t.dtype)


def _short(dt: torch.dtype) -> str:
    return str(dt)[6:]


def layernorm_fused(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float = LN_EPS) -> torch.Tensor:
    """LN over the last axis of x [..., D] (bf16 or fp32, g and b in its
    dtype), one read and one write (K16); out in ``x.dtype``."""
    d = x.shape[-1]
    _check_affine("layernorm_fused", g, b, x.dtype, d)
    if x.device.type == "cpu":
        return layernorm_fused_plain(x, g, b, eps)
    out = _launch_ln(x, g, b, eps, "layernorm")
    m = x.numel() // d
    layernorm_fused.launches += 1
    layernorm_fused.by_shape[(m, d, _short(x.dtype))] += 1
    aligned = (x.data_ptr() | out.data_ptr()) % 16 == 0
    layernorm_fused.by_form[library_form(m, d, x.dtype, aligned)] += 1
    return out


def _launch_ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float,
               name: str) -> torch.Tensor:
    d = x.shape[-1]
    for t in (x, g, b):
        _check(name, t, x.device, d)
    out = torch.empty_like(x)
    rc = _entry(name)(x.data_ptr(), _f32(x), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                      x.numel() // d, d, eps, _build.stream_ptr(x.device))
    _build.check(rc, name)
    return out


def layernorm_fused_first(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                          eps: float = LN_EPS) -> torch.Tensor:
    """K16's first form at any shape (a CUDA tensor only; not counted): what
    the card tests and ``chip_smoke.py`` hold the Hopper form to, output for
    output."""
    _check_affine("layernorm_first", g, b, x.dtype, x.shape[-1])
    if x.device.type != "cuda":
        raise ValueError("layernorm_fused_first: a CUDA tensor (the kernel's first form)")
    return _launch_ln(x, g, b, eps, "layernorm_first")


def residual_layernorm(y: torch.Tensor, delta: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                       eps: float = LN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, h) = (y + delta, LN(y + delta)·g + b) in one pass (K17): y and
    delta [..., D] of one shape, each bf16 or fp32, g and b in ``y.dtype``;
    both outputs in ``y.dtype``."""
    d = y.shape[-1]
    _check_affine("residual_layernorm", g, b, y.dtype, d)
    if y.device.type == "cpu":
        return residual_layernorm_plain(y, delta, g, b, eps)
    for t in (y, delta, g, b):
        _check("residual_layernorm", t, y.device, d)
    if delta.shape != y.shape:
        raise ValueError(f"residual_layernorm: y {tuple(y.shape)} and delta "
                         f"{tuple(delta.shape)} differ")
    z, h = torch.empty_like(y), torch.empty_like(y)
    m = y.numel() // d
    rc = _entry("residual_layernorm")(y.data_ptr(), _f32(y), delta.data_ptr(), _f32(delta),
                                      g.data_ptr(), b.data_ptr(), z.data_ptr(), h.data_ptr(),
                                      m, d, eps, _build.stream_ptr(y.device))
    _build.check(rc, "residual_layernorm")
    residual_layernorm.launches += 1
    residual_layernorm.by_shape[(m, d, _short(y.dtype), _short(delta.dtype))] += 1
    return z, h


for _f in (layernorm_fused, residual_layernorm):
    _f.launches = 0
    _f.by_shape = collections.Counter()
layernorm_fused.by_form = collections.Counter()
