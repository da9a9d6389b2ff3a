"""The int8 requant of the Hopper form of K1 and K2 (``csrc/i8gemm.cuh``:
``requant_exact`` / ``requant_fast`` through ``requant_code``), emulated in
float32 numpy step for step: the IEEE division (on the card, where the
operands allow, the division's own fast path, whose reciprocal seed has no
CPU counterpart, so the card tests hold that part), a zero dividend kept out
of the exact division, the quotient clipped to [lo, 127], rounded to the
nearest integer (ties to even) by adding 1.5 x 2^23, and the sum's low byte
taken as the int8 code. It must give the plain version's
``clip(rint(y / s), lo, 127)`` (``ops.conv_int8.epilogue_plain``) for every
input: random values over many magnitudes, exact ties, the floats next to
ties, zeros of both signs, and values around the clip bounds; with relu,
for every y, not only y >= 0 (the kernel leaves relu to the clip's lower
bound)."""

import numpy as np
import pytest
import torch

from dlq_tpu_torch.ops.conv_int8 import epilogue_plain

MAGIC = np.float32(12582912.0)   # 1.5 x 2^23


def requant_code(y: np.ndarray, s: np.float32, lo: int) -> np.ndarray:
    """i8gemm.cuh's requant_exact in float32 numpy: the int8 codes."""
    zero = y == 0
    q = np.where(zero, np.float32(1.0), y) / s
    qc = np.clip(np.where(zero, np.float32(0.0), q), np.float32(lo), np.float32(127.0))
    bits = (qc + MAGIC).astype(np.float32).view(np.uint32)
    return (bits & np.uint32(0xFF)).astype(np.uint8).view(np.int8).astype(np.int32)


def _inputs(rng, s: np.float32) -> np.ndarray:
    """y values: random over several magnitudes; every half-integer multiple
    of s in [-140, 140] rounded to float32, and the 4 floats on each side of
    it; zeros of both signs; values near +-127.5 and +-130 and far beyond."""
    mags = rng.normal(0, 1, 20000) * 10.0 ** rng.uniform(-8, 3, 20000)
    ties = ((np.arange(-280, 281) / 2.0) * s).astype(np.float32)
    near = [ties]
    up, down = ties.copy(), ties.copy()
    for _ in range(4):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        near += [up, down]
    edges = (np.array([127.5, -127.5, 130.0, -130.0, 1e6, -1e6, 0.49999997, 0.5]) * s)
    return np.concatenate([mags.astype(np.float32), *near, edges.astype(np.float32),
                           np.array([0.0, -0.0], np.float32)]).astype(np.float32)


@pytest.mark.parametrize("s", [0.05 / 40, 0.025, 0.1, 0.3, 1.0 / 3.0, 0.0078125, 7.1e-4])
@pytest.mark.parametrize("relu", [False, True])
def test_requant_code_equals_the_dividing_requant(s, relu):
    """The kernel's codes == clip(rint(y / s), lo, 127) at every input (with
    relu: of max(y, 0), which the kernel reaches through lo = 0 alone), and
    equal the plain version's int8 epilogue (which K1 and K2 are held to on
    the card)."""
    rng = np.random.default_rng(int(s * 1e6) + relu)
    s = np.float32(s)
    y = _inputs(rng, s)
    lo = 0 if relu else -127
    got = requant_code(y, s, lo)
    yr = np.maximum(y, np.float32(0.0)) if relu else y
    want = np.clip(np.rint(yr / s), lo, 127).astype(np.int32)
    assert np.array_equal(got, want)
    # the plain version's epilogue on the same y (scale 1, bias 0: y is the sum)
    acc = torch.from_numpy(y.astype(np.float64))
    plain = epilogue_plain(acc, torch.ones(1), torch.zeros(1), relu, float(s))
    assert np.array_equal(got, plain.numpy().astype(np.int32))


def test_magic_rounding_is_rint_with_ties_to_even():
    """Adding 1.5 x 2^23 rounds every float32 in [-130, 130] to the nearest
    integer, ties to even, as rint does."""
    q = np.concatenate([np.arange(-260, 261) / 2.0,
                        np.random.default_rng(0).uniform(-130, 130, 100000)]).astype(np.float32)
    n = (q + MAGIC).astype(np.float32).view(np.int32) - np.int32(0x4B400000)
    assert np.array_equal(n, np.rint(q).astype(np.int32))
