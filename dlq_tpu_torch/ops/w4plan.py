"""The launch plan of the Hopper form that K10 (``csrc/matmul_int4a8.cu``)
and K13 (``csrc/matmul_int4.cu``) share (``csrc/w4gemm.cuh``: make_plan),
mirrored on the host. The constants and the byte count below are the
source's; a change to one is made in both places, and the card tests hold
the kernels' own plans (``dlq_matmul_int4a8_plan``,
``dlq_matmul_int4_plan``) to these functions."""

from __future__ import annotations

from typing import Callable, Tuple

# 128-row items, stages of 64 bytes a row, slice widths (wgmma widths)
# widest first, 8 down to 3 ring stages, the opt-in shared-memory limit,
# 8 consumer warps each staging 8 output rows
W4_TILE, W4_STAGE, SMEM_MAX = 128, 64, 232448
W4_WIDTHS = (256, 192, 128, 64)
W4_STAGES = range(8, 2, -1)
STAGED_ROWS = 8 * 8

Plan = Tuple[int, int, int, int, int]


def w4_plan_bytes(ns: int, stages: int, kp: int, fixed: int) -> int:
    """Shared-memory bytes of a slice width and ring depth: the ring (an A
    stage of 128 rows x 64 bytes and a B stage of ns x 64 bytes each), the
    packed slice (rows of Kp/2 + 16 bytes), the kernel's ``fixed`` bytes
    (scales, epilogue table), the output staging (rows of ns x 4 + 32
    bytes) and 16 bytes of mbarriers a stage."""
    return (stages * (W4_TILE + ns) * W4_STAGE + ns * (kp // 2 + 16) + fixed
            + STAGED_ROWS * (4 * ns + 32) + 16 * stages)


def w4_plan(m: int, n: int, kp: int, sms: int, fixed: Callable[[int], int]) -> Plan:
    """(slice width, slices, ring stages, shared-memory bytes, blocks) of the
    Hopper form for an M x N product with padded depth Kp on ``sms`` SMs, or
    all zeros when no slice fits (the kernel's first form). Each width up
    to N rounded up to 64 takes the most stages that fit; of those the
    fewest padded columns wins, the wider on a tie; when that leaves fewer
    items (128-row tiles x slices) than SMs, width 64. The grid is a
    multiple of the slice count, so a block keeps its slice, at most one
    block per SM."""
    best = narrow = None
    for ns in W4_WIDTHS:
        if ns > -(-n // 64) * 64:
            continue
        for stages in W4_STAGES:
            nbytes = w4_plan_bytes(ns, stages, kp, fixed(ns))
            if nbytes <= SMEM_MAX:
                p = (ns, -(-n // ns), stages, nbytes)
                if best is None or p[1] * p[0] < best[1] * best[0]:
                    best = p
                if ns == 64:
                    narrow = p
                break
    if best is None:
        return (0, 0, 0, 0, 0)
    mt = -(-m // W4_TILE)
    if mt * best[1] < sms:
        best = narrow
    slices = best[1]
    grid = slices * min(mt, sms // slices) if slices <= sms else sms
    return (*best, grid)


def matmul_int4a8_plan(m: int, n: int, kp: int, sms: int) -> Plan:
    """K10's plan: its fixed bytes are the epilogue table, {scale, scale,
    bias, bias} per column pair. K % 16 != 0 runs the first form whatever
    the plan (TMA needs 16-byte aligned rows of A)."""
    return w4_plan(m, n, kp, sms, lambda ns: 8 * ns)


def matmul_int4_plan(m: int, n: int, kp: int, groups: int, sms: int) -> Plan:
    """K13's plan: its fixed bytes are the slice's bf16 scales (``groups`` a
    row, padded to 16 bytes) and the bias table (8 bytes a column pair)."""
    return w4_plan(m, n, kp, sms, lambda ns: -(-ns * groups * 2 // 16) * 16 + 4 * ns)
