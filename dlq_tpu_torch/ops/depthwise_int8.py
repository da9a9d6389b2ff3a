"""K23: int8 depthwise convolution with K1's fused fp32 / int8 epilogue.

Replaces no Pallas kernel: the reference leaves the depthwise conv to XLA,
the grouped branch of ``dlq_tpu/ops/qops.py:182 _conv_int8`` (``groups ==
C``, HWIO weights ``[kh, kw, 1, C]``; its oracle ``_depthwise_int8_stencil``,
``:162-179``), which MobileNetV2's deploy paths run (kernel in
``csrc/depthwise_int8.cu``). Computes, on int8 NHWC input,

    acc[n, oh, ow, c] = sum_{u, v} x[n, oh*s - p + u, ow*s - p + v, c] * w[u, v, 0, c]   (int32)
    y = fma(float(acc), scale[c], bias[c]);  relu or relu6 (clip to [0, 6])
    out = y (fp32)   or   clip(rint(y / out_scale), relu|relu6 ? 0 : -127, 127) (int8)

for any kernel size, stride and symmetric zero padding: K1's epilogue
(``ops.conv_int8.epilogue_plain``) on the exact sums.

The weight is kept as the int8 ``[kh * kw, C]`` view of its HWIO layout,
tap-major and channel-contiguous (``pack_depthwise_weight``, once per site).

``depthwise_int8`` launches the kernel for a CUDA tensor and runs
``depthwise_int8_plain`` (an exact int32 stencil, never ``F.conv2d`` on
int8) for a CPU tensor. The kernel has two forms, taken by a static shape
rule (``depthwise_form``, the library's ``dlq_depthwise_int8_form``): the
Hopper form for 3x3, pad 1, stride 1 or 2 and C % 16 == 0 (every MobileNetV2
width), on the plan ``depthwise_hopper_plan`` (the mirror of the C
``make_plan``); the first form for every other shape, in 16-byte channel
granules for C % 16 == 0 and 8-byte ones for C % 16 == 8. Any other C is
refused, and a refused launch raises. ``depthwise_int8_first`` runs the
first form at any shape it takes (a CUDA tensor only, not counted).
``depthwise_int8.launches`` counts kernel launches,
``depthwise_int8.by_shape`` counts them per (N, H, W, C, KH, KW, stride,
pad, activation (``act_key``), int8 out), ``depthwise_int8.by_form`` per
form.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.ops.conv_int8 import act_code, act_key, epilogue_plain, out_hw


@dataclasses.dataclass
class PackedDepthwise:
    """Depthwise conv weight for K23: ``w[u * kw + v, c] = w_hwio[u, v, 0, c]``."""

    w: torch.Tensor  # [kh * kw, C] int8, contiguous
    kh: int
    kw: int

    @property
    def c(self) -> int:
        return self.w.shape[1]

    @property
    def oc(self) -> int:
        return self.c

    def hwio(self) -> torch.Tensor:
        """The int8 weight back in the reference's HWIO layout ``[kh, kw, 1, C]``."""
        return self.w.reshape(self.kh, self.kw, 1, self.c)


def is_depthwise_weight(shape) -> bool:
    """Is an HWIO weight of this shape a depthwise conv's (``[kh, kw, 1, C]``, C > 1)?"""
    return len(shape) == 4 and shape[2] == 1 and shape[3] > 1


def pack_depthwise_weight(w_hwio: torch.Tensor) -> PackedDepthwise:
    """[KH, KW, 1, C] int8 -> PackedDepthwise (done once per site, at load)."""
    if w_hwio.dtype != torch.int8 or not is_depthwise_weight(tuple(w_hwio.shape)):
        raise ValueError(f"expected int8 depthwise HWIO weights [kh, kw, 1, C], got "
                         f"{w_hwio.dtype} {tuple(w_hwio.shape)}")
    kh, kw, _, c = w_hwio.shape
    return PackedDepthwise(w_hwio.reshape(kh * kw, c).contiguous(), kh, kw)


# The Hopper form's plan constants (csrc/depthwise_int8.cu)
HOP_THREADS = 256
HOP_MIN_THREADS = 128
STAGE_MAX = 36 * 1024
RING_MAX = 113 * 1024
MAX_STAGES = 4
CS_MAX = 192
BOX_MAX = 256
SMEM_SM = 233472
SMEM_RESERVED = 1024
REG_BLOCKS = 16
R_CAND = (4, 7)


class DepthwisePlan(NamedTuple):
    """The Hopper form's plan (the C ``Plan``, field for field): output
    pixels a pixel group (r), channels a slice (cs), output rows a band
    (th), its input rows (rb) and columns (wb), pixel groups a row (cg),
    channel quads a slice (q), pixel groups at once (pg), threads, a stage's
    bytes and pitch, stages, dynamic shared memory, bands an image, slices,
    items and blocks."""

    ok: int
    r: int
    cs: int
    th: int
    rb: int
    wb: int
    cg: int
    q: int
    pg: int
    threads: int
    stage: int
    pitch: int
    stages: int
    smem: int
    bands: int
    slices: int
    items: int
    grid: int


NO_PLAN = DepthwisePlan(*([0] * 18))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def depthwise_hopper_plan(n: int, h: int, w: int, c: int, stride: int,
                          sms: int) -> DepthwisePlan:
    """The Hopper form's plan for a 3x3, pad-1 depthwise conv of N x H x W x
    C at ``stride`` on ``sms`` SMs (the C ``make_plan``, step for step):
    every (R, CS, TH) scored (CS at least 64 or C where one fits, else any
    multiple of 16 dividing C) by the lanes' useful share, the last wave's,
    the square root of a band's useful input rows and threads / 128 up to
    1; the highest score wins, a later candidate on a tie. ``NO_PLAN``
    (ok 0) where none fits: the first form's shape."""
    best, best_score = NO_PLAN, -1.0
    if stride not in (1, 2) or c % 16 or n < 1 or h < 1 or w < 1 or sms < 1:
        return best
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    for narrow in (False, True):
        if narrow and best.ok:
            break
        for r in R_CAND:
            cg = _cdiv(ow, r)
            wb = (cg * r - 1) * stride + 3
            if wb > BOX_MAX:
                continue
            for cs in range(16, min(c, CS_MAX) + 1, 16):
                if c % cs or (not narrow and cs < 64 and cs != c):
                    continue
                q, slices = cs // 4, c // cs
                pg0 = HOP_THREADS // q
                for th in range(1, oh + 1):
                    rb = (th - 1) * stride + 3
                    stage = cs * wb * rb
                    if stage > STAGE_MAX or rb > BOX_MAX:
                        break
                    tasks = th * cg
                    pg = min(tasks, pg0)
                    threads = q * pg
                    pitch = _cdiv(stage, 128) * 128
                    stages = min(RING_MAX // pitch, MAX_STAGES)
                    smem = stages * pitch + 8 * stages
                    warps = _cdiv(threads, 32)
                    bps = max(1, min(SMEM_SM // (smem + SMEM_RESERVED), REG_BLOCKS // warps))
                    bands = _cdiv(oh, th)
                    items = n * bands * slices
                    if items > 0x7FFFFFFF:
                        return NO_PLAN
                    grid = max(slices, min(items, bps * sms) // slices * slices)
                    lane = (float(oh) * ow / r) / (float(bands) * _cdiv(tasks, pg) * pg)
                    blk = float(items) / (float(_cdiv(items, grid)) * grid)
                    halo = math.sqrt(float(th * stride) / rb)
                    occ = threads / HOP_MIN_THREADS if threads < HOP_MIN_THREADS else 1.0
                    score = lane * blk * halo * occ
                    if score >= best_score:
                        best_score = score
                        best = DepthwisePlan(1, r, cs, th, rb, wb, cg, q, pg, threads, stage, pitch,
                                             stages, smem, bands, slices, items, grid)
    return best


def depthwise_form(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int,
                   pad: int) -> str:
    """K23's form for a launch (the library's rule): ``"hopper"`` for 3x3,
    pad 1, stride 1 or 2, C % 16 == 0 and a plan that fits, else
    ``"first"`` (not the card: the plan's fit does not depend on the SMs)."""
    takes = kh == 3 and kw == 3 and pad == 1 and depthwise_hopper_plan(n, h, w, c, stride, 1).ok
    return "hopper" if takes else "first"


def depthwise_acc_plain(x: torch.Tensor, pk: PackedDepthwise, stride: int,
                        pad: int) -> torch.Tensor:
    """Exact int32 depthwise sums, NHWC: the reference's stencil (zero-padded
    input, one strided slice a tap, widened and multiplied by the tap's
    per-channel weight)."""
    n, h, w, c = x.shape
    oh, ow = out_hw(h, w, pk.kh, pk.kw, stride, pad)
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, 0, pad, pad, pad, pad))
    w32 = pk.w.to(torch.int32)
    acc = torch.zeros((n, oh, ow, c), dtype=torch.int32, device=x.device)
    for u in range(pk.kh):
        for v in range(pk.kw):
            sl = xp[:, u: u + (oh - 1) * stride + 1: stride, v: v + (ow - 1) * stride + 1: stride]
            acc += sl * w32[u * pk.kw + v]
    return acc


def depthwise_int8_plain(x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
                         scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                         out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K23 (same inputs, same outputs)."""
    acc = depthwise_acc_plain(x, pk, stride, pad)
    return epilogue_plain(acc, scale, bias, relu, out_scale, relu6)


def check_depthwise_args(x: torch.Tensor, pk: PackedDepthwise, scale: torch.Tensor,
                         bias: torch.Tensor, granule: int) -> None:
    """Raise on what K23 does not take: a CUDA, contiguous int8 NHWC input
    with the weights' C channels, aligned to the channel granule, C a
    multiple of 8, and contiguous weights and fp32 [C] scale and bias on the
    input's device."""
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_int8: unsupported device {x.device}")
    if granule == 0:
        raise ValueError(f"depthwise_int8: C = {pk.c} is not a multiple of 8")
    if (x.dtype != torch.int8 or x.ndim != 4 or not x.is_contiguous() or x.shape[-1] != pk.c
            or x.data_ptr() % granule):
        raise ValueError(f"depthwise_int8: need contiguous, {granule}-byte aligned int8 NHWC "
                         f"input with {pk.c} channels, got {x.dtype} {tuple(x.shape)}")
    for t, name in ((pk.w, "weights"), (scale, "scale"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"depthwise_int8: {name} must be contiguous on {x.device}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or \
            scale.shape != (pk.c,) or bias.shape != (pk.c,):
        raise ValueError(f"depthwise_int8: scale and bias must be fp32 [{pk.c}]")


@functools.cache
def _entry(name: str = "dlq_depthwise_int8"):
    fn = getattr(_build.library("depthwise_int8"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.cache
def launch_granule(c: int) -> int:
    """The channel granule in bytes the first form takes for C (the
    library's own rule: 16, 8, or 0 for a refused C)."""
    fn = _build.library("depthwise_int8").dlq_depthwise_int8_granule
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(c)


@functools.cache
def library_form(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int,
                 pad: int) -> str:
    """The form the kernel library takes for a launch (its own rule)."""
    fn = _build.library("depthwise_int8").dlq_depthwise_int8_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 8
    return "hopper" if fn(n, h, w, c, kh, kw, stride, pad) else "first"


def library_plan(n: int, h: int, w: int, c: int, stride: int, sms: int) -> DepthwisePlan:
    """The kernel library's own Hopper plan (what the card tests hold
    ``depthwise_hopper_plan`` to)."""
    fn = _build.library("depthwise_int8").dlq_depthwise_int8_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = (ctypes.c_int * 18)()
    fn(n, h, w, c, stride, sms, ctypes.addressof(out))
    return DepthwisePlan(*out)


def _launch(name: str, x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
            scale: torch.Tensor, bias: torch.Tensor, relu: bool, out_scale: Optional[float],
            relu6: bool) -> torch.Tensor:
    check_depthwise_args(x, pk, scale, bias, launch_granule(pk.c))
    n, h, w, c = x.shape
    if h + 2 * pad < pk.kh or w + 2 * pad < pk.kw or stride < 1 or pad < 0:
        raise ValueError(f"depthwise_int8: no output for {tuple(x.shape)}, "
                         f"{pk.kh}x{pk.kw}/s{stride}/p{pad}")
    oh, ow = out_hw(h, w, pk.kh, pk.kw, stride, pad)
    out = torch.empty((n, oh, ow, c), device=x.device,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    rc = _entry(name)(x.data_ptr(), pk.w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      out.data_ptr(), n, h, w, c, pk.kh, pk.kw, stride, pad,
                      act_code(relu, relu6), int(out_scale is not None),
                      float(out_scale) if out_scale is not None else 1.0,
                      _build.stream_ptr(x.device))
    _build.check(rc, "depthwise_int8")
    return out


def depthwise_int8(x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
                   scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                   out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """int8 NHWC depthwise conv with the fused epilogue. ``scale``/``bias``:
    fp32 [C]; ``relu`` / ``relu6``: the activation; ``out_scale``: None for
    an fp32 output, else the consumer's activation scale for an int8 one."""
    if x.device.type == "cpu":
        return depthwise_int8_plain(x, pk, stride, pad, scale, bias, relu, out_scale, relu6)
    out = _launch("dlq_depthwise_int8", x, pk, stride, pad, scale, bias, relu, out_scale, relu6)
    n, h, w, c = x.shape
    depthwise_int8.launches += 1
    depthwise_int8.by_shape[(n, h, w, c, pk.kh, pk.kw, stride, pad, act_key(relu, relu6),
                             out_scale is not None)] += 1
    depthwise_int8.by_form[library_form(n, h, w, c, pk.kh, pk.kw, stride, pad)] += 1
    return out


def depthwise_int8_first(x: torch.Tensor, pk: PackedDepthwise, stride: int, pad: int,
                         scale: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                         out_scale: Optional[float] = None, relu6: bool = False) -> torch.Tensor:
    """K23's first form at any shape it takes (a CUDA tensor only; not
    counted): what the card tests and ``chip_smoke.py`` hold the Hopper form
    to, output for output."""
    if x.device.type != "cuda":
        raise ValueError("depthwise_int8_first: a CUDA tensor (the kernel's first form)")
    return _launch("dlq_depthwise_int8_first", x, pk, stride, pad, scale, bias, relu, out_scale,
                   relu6)


depthwise_int8.launches = 0
depthwise_int8.by_shape = collections.Counter()
depthwise_int8.by_form = collections.Counter()
