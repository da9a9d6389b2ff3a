"""K22: the port of ``tools/probe_stem_patterns.py`` (its ``run`` helper's
``pallas_call``, ``:36/:38``): the patterns of a fused int8 ResNet stem,
each as one hand-written kernel in ``csrc/probe_stem.cu``.

  A  pair-row merge  int8 [232, 920] -> [116, 1840]
  B  lane -> row split  x[:112, :896] -> [12544, 8]
  C  row / lane offset slice  merge(x)[3:115, 928:1824] -> [112, 896]
  D  writes into shared memory at 8-lane offsets  x[:128, :128]
  E  int8 dot [12544, 256] x [256, 64] -> int32 (int8 wgmma m64n64k32 on
     64-row tiles, a by TMA, b transposed once a block: ``int_dot_plan``)
  J  the im2col cols build: 32 pieces (r, a, b) of merge(x),
     m[a:a+112, 920r + 8b : +896] -> [12544, 8], into cols [12544, 256]
     (no staging: a thread per 16-byte output granule from two 8-byte
     loads, ``cols_granules`` / ``cols_sources``)
  K  3x3/s2 max pool with -128 padding  [112, 112, 64] -> [56, 3584] (a
     thread per 16 output bytes, its 9 taps as 16-byte loads: ``pool_taps``)

Inputs are ``default_rng(0)`` draws in the reference's order; the check is
the reference's (``max_abs <= 0.5``, finite). A, B, C and D run on
``probe_common.cuh``'s Hopper ``stage_kernel``, E on
``int_dot_hopper_kernel``, J on ``cols_kernel``, K on ``maxpool_kernel``;
``probe_stem.first`` runs their first forms.

    python -m dlq_tpu_torch.tools.probe_stem_patterns [--device cpu]
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools._probe import Spec, Window

SOURCE = "probe_stem"
I8 = torch.int8
X = (((232, 920), I8),)

SPEC = {
    "A": Spec("A reshape [232,920]->[116,1840] i8", X, ((116, 1840), I8), True, 0.5,
              library="x.reshape(116, 1840).clone(memory_format=torch.contiguous_format)"),
    "B": Spec("B reshape [112,896]->[12544,8] i8", X, ((12544, 8), I8), True, 0.5,
              read_bytes=112 * 896, library="x[:112, :896].contiguous() (then a view)"),
    "C": Spec("C slice rows@3 lanes@928 i8", X, ((112, 896), I8), True, 0.5,
              read_bytes=112 * 896,
              library="x.reshape(116, 1840)[3:115, 928:1824].contiguous()"),
    "D": Spec("D 8-lane-offset scratch writes i8", X, ((128, 128), I8), True, 0.5,
              read_bytes=128 * 128, library="x[:128, :128].contiguous()"),
    "E": Spec("E i8 dot M12544 K256 N64 -> i32", (((12544, 256), I8), ((256, 64), I8)),
              ((12544, 64), torch.int32), True, 0.5, flops=2 * 12544 * 256 * 64, peak="int8",
              library="torch._int_mm(a, b)"),
    "J": Spec("J full cols build (32 pieces)", X, ((12544, 256), I8), True, 0.5,
              library="x.as_strided(COLS_VIEW, COLS_STRIDES).contiguous() (then a view)"),
    "K": Spec("K in-VMEM 3x3/s2 maxpool i8", (((12544, 64), I8),), ((56, 3584), I8), True,
              0.5, library="none: F.max_pool2d has no int8 kernel on CUDA"),
}

PIECES = [(r, a, b) for r in range(2) for a in range(4) for b in range(4)]
# J's cols as one strided view of x: cols[112 p + q, 8 t + e] with t = (r, a,
# b) is merge(x)[a + p, 920 r + 8 b + 8 q + e], merge(x)'s rows 1840 apart
COLS_VIEW = (112, 112, 2, 4, 4, 8)
COLS_STRIDES = (1840, 8, 920, 1840, 8, 1)


def cols_plain(x: torch.Tensor) -> torch.Tensor:
    """J: piece t = (r, a, b) goes to lanes 8t..8t+7 of every cols row."""
    m = x.reshape(116, 1840)
    cols = torch.empty((12544, 256), dtype=I8, device=x.device)
    for t, (r, a, b) in enumerate(PIECES):
        lane = r * 920 + 8 * b
        cols[:, 8 * t: 8 * t + 8] = m[a: a + 112, lane: lane + 896].reshape(12544, 8)
    return cols


def maxpool_plain(c: torch.Tensor) -> torch.Tensor:
    """K: 3x3/s2 max over the -128-padded [114, 114, 64] map."""
    yp = torch.full((114, 114, 64), -128, dtype=I8, device=c.device)
    yp[1:113, 1:113] = c.reshape(112, 112, 64)
    out = yp[0:111:2, 0:111:2]
    for kh in range(3):
        for kw in range(3):
            out = torch.maximum(out, yp[kh: kh + 111: 2, kw: kw + 111: 2])
    return out.reshape(56, 3584)


PLAIN = {
    "A": lambda x: _probe.copy_of(x.reshape(116, 1840)),
    "B": lambda x: _probe.copy_of(x[:112, :896]).reshape(12544, 8),
    "C": lambda x: _probe.copy_of(x.reshape(116, 1840)[3:115, 928:1824]),
    "D": lambda x: _probe.copy_of(x[:128, :128]),
    "E": lambda a, b: (a.double() @ b.double()).to(torch.int32),
    "J": cols_plain,
    "K": maxpool_plain,
}

LIBRARY = {
    "A": lambda x: x.reshape(116, 1840).clone(memory_format=torch.contiguous_format),
    "B": lambda x: x[:112, :896].contiguous().view(12544, 8),
    "C": lambda x: x.reshape(116, 1840)[3:115, 928:1824].contiguous(),
    "D": lambda x: x[:128, :128].contiguous(),
    "E": lambda a, b: torch._int_mm(a, b),
    "J": lambda x: x.as_strided(COLS_VIEW, COLS_STRIDES).contiguous().view(12544, 256),
}

# the copy patterns on probe_common.cuh's stage_kernel (csrc/probe_stem.cu's
# kStaged; the card tests hold the two equal): key -> (window over the
# input's bytes, x 2 in bf16)
WINDOWS = {
    "A": (Window(0, 1840, 0, 116, 1, 1840), False),
    "B": (Window(0, 920, 0, 112, 1, 896), False),
    "C": (Window(3 * 1840 + 928, 1840, 0, 112, 1, 896), False),
    "D": (Window(0, 920, 8, 128, 16, 8), False),
}
# the patterns on a Hopper form whose first form stays callable (probe_stem.first)
FIRST_FORMS = (*WINDOWS, "E", "J", "K")

# E's Hopper form (csrc/probe_stem.cu: int_dot_hopper_kernel)
EM, EK, EN = 12544, 256, 64
ID_ROWS = 64                 # rows of a and out a block
ID_BOX = ID_ROWS * 128       # an a box (a K half) and a half of b^T: 8 KB
ID_SMEM = 1024 + 4 * ID_BOX + 8   # aligning room; a and b^T, two boxes each; the mbarrier


def int_dot_plan() -> List[range]:
    """``int_dot_hopper_kernel``'s grid: the rows of a and out each block
    owns."""
    return [range(m0, min(m0 + ID_ROWS, EM)) for m0 in range(0, EM, ID_ROWS)]


def int_dot_launch() -> Tuple[int, ...]:
    """(grid, threads, rows a block, bytes of an a box, bytes of shared
    memory, bytes the mbarrier counts): what the C side's
    ``dlq_probe_stem_int_plan`` reports."""
    return (len(int_dot_plan()), 128, ID_ROWS, ID_BOX, ID_SMEM, 2 * ID_BOX)


# J's Hopper form (csrc/probe_stem.cu: cols_kernel): a thread per 16-byte
# granule of cols
COLS_THREADS = 256
COLS_GRANULES = 12544 * 256 // 16


def cols_launch() -> Tuple[int, int, int]:
    """(grid, threads, output bytes a thread): what the C side's
    ``dlq_probe_stem_cols_plan`` reports."""
    return (COLS_GRANULES // COLS_THREADS, COLS_THREADS, 16)


def cols_granules() -> torch.Tensor:
    """``cols_kernel``'s walk: [block, thread], the output granule (16 bytes
    at byte 16 g of cols) that thread ``thread`` of block ``block``
    stores."""
    grid, threads, _ = cols_launch()
    return torch.arange(grid)[:, None] * threads + torch.arange(threads)[None, :]


def cols_sources(g: torch.Tensor) -> torch.Tensor:
    """The byte offsets in x of the two 8-byte loads that fill granule
    ``g``, [..., 2]: cols[112 i + j, 128 r + 32 a + 16 h ..+16] is
    merge(x)[a + i, 920 r + 8 j + 16 h ..+16]."""
    p, q = g >> 4, g & 15
    i, j = p // 112, p % 112
    src = (((q >> 1) & 3) + i) * 1840 + 920 * (q >> 3) + 8 * j + 16 * (q & 1)
    return torch.stack((src, src + 8), -1)


# K's Hopper form (csrc/probe_stem.cu: maxpool_kernel): a thread per 16-byte
# output granule (16 channels of one output pixel)
POOL_THREADS = 32
POOL_GRANULES = 56 * 56 * 64 // 16


def pool_launch() -> Tuple[int, int, int]:
    """(grid, threads, output bytes a thread): what the C side's
    ``dlq_probe_stem_pool_plan`` reports."""
    return (POOL_GRANULES // POOL_THREADS, POOL_THREADS, 16)


def pool_taps(t: torch.Tensor) -> torch.Tensor:
    """For thread ``t`` (global index; it stores output bytes 16 t ..+16),
    the byte offset in the [112, 112, 64] map of each of its 9 taps'
    16-byte loads, in (kh, kw) order, [..., 9]; -1 for a tap in the padding
    (above row 0 or left of column 0), which the kernel takes as -128."""
    oi, oj, c16 = t // 224, (t >> 2) % 56, 16 * (t & 3)
    taps = []
    for kh in range(3):
        for kw in range(3):
            ir, ic = 2 * oi - 1 + kh, 2 * oj - 1 + kw
            taps.append(torch.where((ir >= 0) & (ic >= 0), (ir * 112 + ic) * 64 + c16, -1))
    return torch.stack(taps, -1)


probe_stem = _probe.make_wrapper(SOURCE, SPEC, PLAIN, FIRST_FORMS)
CHECK = _probe.check_max_abs   # the reference's check


def _expect_j(xf: np.ndarray) -> np.ndarray:
    mref = xf.reshape(116, 1840)
    exp = np.zeros((12544, 256), np.int32)
    for t, (r, a, b) in enumerate(PIECES):
        exp[:, 8 * t: 8 * t + 8] = (
            mref[a: a + 112, r * 920 + 8 * b: r * 920 + 8 * b + 896].reshape(12544, 8))
    return exp


def _expect_k(c8: np.ndarray) -> np.ndarray:
    y = c8.astype(np.int64).reshape(112, 112, 64)
    yp = np.full((114, 114, 64), -128, np.int64)
    yp[1:113, 1:113] = y
    exp = np.zeros((56, 56, 64), np.int64)
    for i in range(56):
        for j in range(56):
            exp[i, j] = yp[2 * i: 2 * i + 3, 2 * j: 2 * j + 3].max((0, 1))
    return exp.reshape(56, 3584)


def cases():
    """(key, inputs, the reference's numpy expectation) per pattern."""
    rng = np.random.default_rng(0)
    xf = rng.integers(-127, 127, (232, 920))
    a8 = rng.integers(-127, 127, (12544, 256))
    b8 = rng.integers(-5, 5, (256, 64))
    c8 = rng.integers(-127, 127, (12544, 64))
    x8 = _probe.i8(xf)
    return [
        ("A", (x8,), xf.reshape(116, 1840)),
        ("B", (x8,), xf[:112, :896].reshape(12544, 8)),
        ("C", (x8,), xf.reshape(116, 1840)[3:115, 928:1824]),
        ("D", (x8,), xf[:128, :128]),
        ("E", (_probe.i8(a8), _probe.i8(b8)), a8 @ b8),
        ("J", (x8,), _expect_j(xf)),
        ("K", (_probe.i8(c8),), _expect_k(c8)),
    ]


def results(device=None):
    """Run the seven stem patterns; one ``_probe.Result`` each."""
    return _probe.run(probe_stem, SPEC, PLAIN, cases(), CHECK, device)


def main(device=None) -> int:
    """Run the seven stem patterns; returns the number of FAILs."""
    return _probe.fails(results(device))


if __name__ == "__main__":
    sys.exit(_probe.cli(main))
