"""K21: the port of ``tools/probe_block_patterns.py`` (its ``run`` helper's
``pallas_call``, ``:38/:40``): the patterns of fused residual-block kernels,
each as one hand-written kernel in ``csrc/probe_block.cu``.

  A1  pair-row merge  int8 [232, 920] -> [116, 1840]
  A2  the same on fp32
  S   stride-2 slices of a 4D slab  int8 [1, 18, 18, 128] -> [1, 8, 8, 128]
  L   lane split and half  int8 [232, 928] -> [232, 116, 8][..., 4:]
  O   int8 requant out: clip(rint(f32(x) * f32(0.11)), -127, 127) (a
      thread per ``O_BYTES`` bytes on every SM, the bytes in registers:
      ``o_launch``; the scale settable by the caller, ``scale=``)
  D   K3's core: conv3x3 (9 int8 taps of [180, 128] x [128, 128]),
      h = clip(rint(f32(acc) * s1), 0, 127) int8, conv3x3 over h,
      out = clip(rint(f32(acc2) * s2) + res, 0, 127) int8

O and D are bit-identical to the reference's kernels, which multiply in
fp32. O's own numpy expectation multiplies in float64 and sits one step
off (the reference's ``atol=1.0`` allows it); the port follows the kernel.
Inputs are ``default_rng(0)`` draws in the reference's order; the check is
the reference's (``max_abs <= 0.5``, 1.0 for O and D). A1, A2, S and L run
on ``probe_common.cuh``'s Hopper ``stage_kernel``, O on ``requant_kernel``,
D on ``double_conv_cluster_kernel``, a cluster of ``D_RANKS`` blocks, rank
r owning output channels ``D_CS`` r .. of both convs; ``probe_block.first``
runs their first forms.

    python -m dlq_tpu_torch.tools.probe_block_patterns [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools._probe import Spec, Window

SOURCE = "probe_block"
I8, F32 = torch.int8, torch.float32
TOH, OW, C = 8, 16, 128
S1, S2 = np.float32(0.013), np.float32(0.017)
O_SCALE = np.float32(0.11)
_MERGE = "x.reshape(116, 1840).clone(memory_format=torch.contiguous_format)"

SPEC = {
    "A1": Spec("A1 reshape [232,920]->[116,1840] i8", (((232, 920), I8),), ((116, 1840), I8),
               True, 0.5, library=_MERGE),
    "A2": Spec("A2 reshape [232,920]->[116,1840] f32", (((232, 920), F32),),
               ((116, 1840), F32), True, 0.5, library=_MERGE),
    "S": Spec("S strided(2) sublane slices 4D i8", (((1, 18, 18, 128), I8),),
              ((1, 8, 8, 128), I8), True, 0.5, read_bytes=8 * 8 * 128,
              library="x[:, 1:17:2, 1:17:2, :].contiguous()"),
    "L": Spec("L lane split [232,928]->[232,116,8] + half i8", (((232, 928), I8),),
              ((232, 116, 4), I8), True, 0.5, read_bytes=232 * 116 * 4,
              library="x.reshape(232, 116, 8)[:, :, 4:].contiguous()"),
    "O": Spec("O int8 out blockspec + requant", (((256, 1024), I8),), ((256, 1024), I8),
              True, 1.0, scalars=(float(O_SCALE), 0.0), settable=True,
              library="none: the fp32 product, rint and clip to +-127 take three calls"),
    "D": Spec("D fused double-conv + i8 interchange",
              (((1, TOH + 4, OW + 4, C), I8), ((9, C, C), I8), ((9, C, C), I8)),
              ((1, TOH, OW, C), I8), True, 1.0,
              flops=2 * 9 * C * C * ((TOH + 2) * (OW + 2) + TOH * OW), peak="int8",
              scalars=(float(S1), float(S2)),
              library="none: two int8 convs with their epilogues take a dozen calls"),
}


def requant_plain(x: torch.Tensor, scale: float = O_SCALE) -> torch.Tensor:
    """O: the fp32 product, rounded half to even, clipped (a float scalar
    multiplies a float32 tensor as float32: the product is f32(x) *
    f32(scale), by default f32(0.11))."""
    y = x.float() * float(np.float32(scale))
    return torch.clamp(torch.round(y), -127, 127).to(I8)


def _conv3x3(src: torch.Tensor, w: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Exact int sums (float64) of the 9 taps of a valid 3x3 conv, [oh, ow, OC]."""
    acc = torch.zeros((oh, ow, w.shape[2]), dtype=torch.float64, device=src.device)
    for kh in range(3):
        for kw in range(3):
            acc += src[kh: kh + oh, kw: kw + ow, :].double() @ w[kh * 3 + kw].double()
    return acc


def double_conv_plain(slab: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """D: the probe kernel's BasicBlock core with its fp32 epilogues."""
    x = slab[0]
    acc = _conv3x3(x, w1, TOH + 2, OW + 2).float()
    h = torch.clamp(torch.round(acc * float(S1)), 0, 127).to(I8)
    acc2 = _conv3x3(h, w2, TOH, OW).float()
    res = x[2: 2 + TOH, 2: 2 + OW, :].float()
    return torch.clamp(torch.round(acc2 * float(S2)) + res, 0, 127).to(I8)[None]


PLAIN = {
    "A1": lambda x: _probe.copy_of(x.reshape(116, 1840)),
    "A2": lambda x: _probe.copy_of(x.reshape(116, 1840)),
    "S": lambda x: _probe.copy_of(x[:, 1:17:2, 1:17:2, :]),
    "L": lambda x: _probe.copy_of(x.reshape(232, 116, 8)[:, :, 4:]),
    "O": requant_plain,
    "D": double_conv_plain,
}

LIBRARY = {
    "A1": lambda x: x.reshape(116, 1840).clone(memory_format=torch.contiguous_format),
    "A2": lambda x: x.reshape(116, 1840).clone(memory_format=torch.contiguous_format),
    "S": lambda x: x[:, 1:17:2, 1:17:2, :].contiguous(),
    "L": lambda x: x.reshape(232, 116, 8)[:, :, 4:].contiguous(),
}

# the copy patterns on probe_common.cuh's stage_kernel (csrc/probe_block.cu's
# kStaged; the card tests hold the two equal): key -> (window over the
# input's bytes, x 2 in bf16)
WINDOWS = {
    "A1": (Window(0, 1840, 0, 116, 1, 1840), False),
    "A2": (Window(0, 7360, 0, 116, 1, 7360), False),
    "S": (Window(19 * 128, 2 * 18 * 128, 2 * 128, 8, 8, 128), False),
    "L": (Window(4, 928, 8, 232, 116, 4), False),
}
# the patterns on a Hopper form whose first form stays callable (probe_block.first)
FIRST_FORMS = (*WINDOWS, "O", "D")

# O's Hopper form (csrc/probe_block.cu: requant_kernel): a thread per O_BYTES
# bytes (one load, one store), blocks of O_THREADS
O_THREADS, O_BYTES = 256, 8
O_N = 256 * 1024
# the scales the card holds O's two forms equal at on every int8 value: the
# probe's, 0.5 (exact ties: half to even shows), 1.7 (the clip binds), 1/127
O_SCALES = tuple(np.float32(s) for s in (0.11, 0.5, 1.7, 1 / 127))


def o_launch() -> Tuple[int, int, int]:
    """(grid, threads, bytes a thread): what the C side's
    ``dlq_probe_block_o_plan`` reports."""
    return (O_N // (O_THREADS * O_BYTES), O_THREADS, O_BYTES)


def o_bytes(t: torch.Tensor) -> torch.Tensor:
    """The byte offsets thread ``t`` (global index) loads and stores, [...,
    O_BYTES], in the order of its 32-bit words' bytes."""
    return (t * O_BYTES)[..., None] + torch.arange(O_BYTES)


def o_exhaustive_input() -> torch.Tensor:
    """An int8 [256, 1024] holding each of the 256 values 1,024 times, in a
    seeded order."""
    v = np.random.default_rng(0).permutation(np.arange(O_N) % 256) - 128
    return torch.from_numpy(v.astype(np.int8)).reshape(256, 1024)


def exhaustive_cases():
    """(label, key, input, scale) of the card's exhaustive check of O."""
    x = o_exhaustive_input()
    return [(f"O s={float(s):.9g}", "O", x, s) for s in O_SCALES]

# D's Hopper form (csrc/probe_block.cu: double_conv_cluster_kernel): a
# cluster of D_RANKS blocks of D_THREADS threads, rank r owning output
# channels D_CS r .. D_CS r + D_CS - 1 of both convs
D_RANKS, D_THREADS = 8, 256
D_CS = C // D_RANKS
D_LDB = C + 16         # bytes a transposed weight row (one output channel's 128 cin, padded)
D_XBOX = 32            # slab pixels a TMA box (128-byte swizzle)
D_HSLICE = (TOH + 2) * (OW + 2) * D_CS   # a rank's slice of h: 180 pixels x D_CS channels


def d_smem() -> dict:
    """The Hopper form's shared memory from a 1,024-byte aligned base (the
    C side's ``dc`` layout), name -> (offset, bytes): the slab in 8 boxes of
    32 pixels (pixels 240..255 land zeros), both weight slices as landed
    ([conv][tap][cin][D_CS]), both transposed ([conv][tap][cout][D_LDB]), h
    as D_RANKS rank slices, the output tile, the 4 mbarriers (slab, w1, w2,
    h) and a word a warp for the loads' landing stores."""
    parts = (("slab", -(-(TOH + 4) * (OW + 4) // D_XBOX) * D_XBOX * C),
             ("slices", 2 * 9 * C * D_CS), ("transposed", 2 * 9 * D_CS * D_LDB),
             ("h", D_RANKS * D_HSLICE), ("out", TOH * OW * D_CS), ("mbarriers", 4 * 8),
             ("sink", D_THREADS // 32 * 4))
    out, at = {}, 0
    for name, size in parts:
        out[name] = (at, size)
        at += size
    return out


D_SMEM = 1024 + sum(size for _, size in d_smem().values())


probe_block = _probe.make_wrapper(SOURCE, SPEC, PLAIN, FIRST_FORMS)
CHECK = _probe.check_max_abs   # the reference's check


def _expect_d(slab2: np.ndarray, w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    """The reference's ``refD`` (int64 sums, float64 epilogue products)."""
    xpad = slab2.astype(np.int64)[0]
    w1f = w1.astype(np.int64).reshape(3, 3, C, C)
    w2f = w2.astype(np.int64).reshape(3, 3, C, C)
    acc = np.zeros((TOH + 2, OW + 2, C), np.int64)
    for kh in range(3):
        for kw in range(3):
            acc += np.einsum("hwc,cd->hwd", xpad[kh: kh + TOH + 2, kw: kw + OW + 2, :],
                             w1f[kh, kw])
    h = np.clip(np.round(acc * S1), 0, 127)
    acc2 = np.zeros((TOH, OW, C), np.float64)
    for kh in range(3):
        for kw in range(3):
            acc2 += np.einsum("hwc,cd->hwd", h[kh: kh + TOH, kw: kw + OW, :], w2f[kh, kw])
    res = xpad[2: 2 + TOH, 2: 2 + OW, :]
    return np.clip(np.round(acc2 * S2) + res, 0, 127)[None]


def cases():
    """(key, inputs, the reference's numpy expectation) per pattern."""
    rng = np.random.default_rng(0)
    x8 = rng.integers(-127, 127, (232, 920))
    slab = rng.integers(-127, 127, (1, 18, 18, 128))
    y8 = rng.integers(-127, 127, (232, 928))
    a8 = rng.integers(-127, 127, (256, 1024))
    slab2 = rng.integers(-20, 20, (1, TOH + 4, OW + 4, C))
    w1 = rng.integers(-8, 8, (9, C, C))
    w2 = rng.integers(-8, 8, (9, C, C))
    t8 = _probe.i8(x8)
    exp_o = np.clip(np.round(a8.astype(np.float64) * O_SCALE), -127, 127)
    return [
        ("A1", (t8,), x8.reshape(116, 1840)),
        ("A2", (t8.float(),), x8.reshape(116, 1840).astype(np.float64)),
        ("S", (_probe.i8(slab),), slab[:, 1:17:2, 1:17:2, :]),
        ("L", (_probe.i8(y8),), y8.reshape(232, 116, 8)[:, :, 4:]),
        ("O", (_probe.i8(a8),), exp_o),
        ("D", (_probe.i8(slab2), _probe.i8(w1), _probe.i8(w2)), _expect_d(slab2, w1, w2)),
    ]


def results(device=None):
    """Run the six block patterns; one ``_probe.Result`` each."""
    return _probe.run(probe_block, SPEC, PLAIN, cases(), CHECK, device)


def main(device=None) -> int:
    """Run the six block patterns; returns the number of FAILs."""
    return _probe.fails(results(device))


if __name__ == "__main__":
    sys.exit(_probe.cli(main))
