"""The Hopper forms of the probes' two elementwise kernels, K21 O's requant
(``requant_kernel``) and K19 5's tanh (``tanh_kernel``), on the CPU.

Both inputs have few distinct values (256 int8, 65,536 bf16), so every
check here runs on all of them:

O: ``o_launch`` / ``o_bytes`` (a thread per ``O_BYTES`` bytes) cover every
output byte once; the kernel's walk, emulated in torch from its own
arithmetic (each byte of a 32-bit word sign-extended, the fp32 product,
rint half to even, the clip in fp32, the bytes packed back by the C
side's ``__byte_perm`` selectors), equals ``requant_plain`` bit for bit at
the card's four scales on every int8 value; the recorded JAX kernel ``kO``
equals ``requant_plain`` on every value at f32(0.11).

5: ``tanh_launch`` / ``tanh_values`` cover every output once; the
kernel's ``cvt.rn.bf16x2.f32`` takes the word's high half as its first
operand (read from the source); the recorded JAX kernel ``k5`` is within
the reference's tolerance of the plain version on every pattern.
The card (tests/test_torch_port_card.py, ``chip_smoke.py``'s
``probe_exhaustive``) holds each Hopper form equal to its first form on
every input.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_port_probes import _bits, _record, _to_jnp

from dlq_tpu_torch.tools import probe_block_patterns as PK
from dlq_tpu_torch.tools import probe_mosaic_patterns as PM


def _byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte k of the result
    is byte (s >> 4k) & 7 of the 8 bytes {y:x} (no sign-replicate mode)."""
    both = (y.astype(np.uint64) << 32) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for k in range(4):
        sel = (s >> (4 * k)) & 0xF
        assert sel < 8
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def _requant1(q: np.ndarray, scale) -> np.ndarray:
    """The kernel's arithmetic on int values ``q``: the fp32 product,
    rintf, the clip in fp32, then the int (its low byte stored)."""
    p = np.float32(q.astype(np.float32) * np.float32(scale))
    return np.minimum(np.maximum(np.rint(p), np.float32(-127)), np.float32(127)).astype(np.int32)


def _o_walk(x: torch.Tensor, scale) -> torch.Tensor:
    """``requant_kernel`` thread by thread: each thread's O_BYTES bytes as
    little-endian 32-bit words, each byte requantized, the four packed back
    by the C side's __byte_perm selectors, stored at the thread's bytes."""
    grid, threads, nbytes = PK.o_launch()
    flat = x.reshape(-1).view(torch.uint8).numpy()
    offs = PK.o_bytes(torch.arange(grid * threads)).numpy()
    words = flat[offs].reshape(-1, nbytes // 4, 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    r = []
    for k in range(4):
        byte = (words >> (8 * k)) & 0xFF
        q = byte.astype(np.uint8).view(np.int8).astype(np.int32)   # static_cast<int8_t>
        r.append(_requant1(q, scale).astype(np.uint32))
    packed = _byte_perm(_byte_perm(r[0], r[1], 0x0040), _byte_perm(r[2], r[3], 0x0040), 0x5410)
    out = np.zeros(PK.O_N, np.uint8)
    out[offs] = np.ascontiguousarray(packed).view(np.uint8).reshape(offs.shape)
    return torch.from_numpy(out.view(np.int8)).reshape(256, 1024)


def test_o_plan_covers_outputs_once():
    grid, threads, nbytes = PK.o_launch()
    assert grid * threads * nbytes == PK.O_N and nbytes == 8
    offs = PK.o_bytes(torch.arange(grid * threads))
    assert torch.equal(offs.reshape(-1).sort().values, torch.arange(PK.O_N))
    # one aligned load and store a thread; a warp's 32 are contiguous
    assert bool((offs[:, 0] % nbytes == 0).all())
    assert torch.equal(offs[:32].reshape(-1), torch.arange(32 * nbytes))


def test_o_exhaustive_input_holds_every_value():
    x = PK.o_exhaustive_input()
    counts = torch.bincount(x.view(torch.uint8).reshape(-1).long(), minlength=256)
    assert x.shape == (256, 1024) and x.dtype == torch.int8
    assert torch.equal(counts, torch.full((256,), 1024))


@pytest.mark.parametrize("scale", PK.O_SCALES, ids=[f"{float(s):.4g}" for s in PK.O_SCALES])
def test_o_walk_equals_plain_on_every_value(scale):
    """The walk against requant_plain on every int8 value: at 0.5 the
    products are exact halves (half to even: 3 * 0.5 -> 2, 5 * 0.5 -> 2), at
    1.7 the clip binds, at 1/127 most round to 0."""
    x = PK.o_exhaustive_input()
    want = PK.requant_plain(x, scale=scale)
    assert torch.equal(_o_walk(x, scale), want)
    q = torch.arange(-128, 128, dtype=torch.int8)
    got = PK.requant_plain(q, scale=scale)
    if float(scale) == 0.5:
        assert got[128 + 3] == 2 and got[128 + 5] == 2 and got[128 - 3] == -2
    if float(scale) == np.float32(1.7):
        assert got[0] == -127 and got[-1] == 127


def test_o_scale_is_taken_as_fp32():
    """A float64 scale reaches the kernel and the plain version as f32(s):
    the wrapper's scale= on the CPU equals requant_plain at np.float32(s)."""
    x = PK.o_exhaustive_input()
    got = PK.probe_block("O", x, scale=0.11)
    assert torch.equal(got, PK.requant_plain(x, scale=np.float32(0.11)))
    assert torch.equal(got, PK.probe_block("O", x))
    with pytest.raises(ValueError):
        PK.probe_block("A1", torch.zeros((232, 920), dtype=torch.int8), scale=0.5)


@pytest.fixture(scope="module")
def recorded():
    """tool -> {key: the recorded JAX pallas_call callable}."""
    cache = {}

    def get(tool, mod):
        if tool not in cache:
            _, recs = _record(tool)
            cache[tool] = {k: fn for k, (fn, _) in zip(mod.SPEC, recs)}
        return cache[tool]

    return get


def test_o_jax_kernel_equals_plain_on_every_value(recorded):
    kO = recorded("probe_block_patterns", PK)["O"]
    x = PK.o_exhaustive_input()
    want = jax.jit(kO)(_to_jnp(x))
    got = PK.requant_plain(x)
    assert np.array_equal(_bits(got), _bits(want))


def test_tanh_plan_covers_outputs_once():
    grid, threads, values = PM.tanh_launch()
    assert grid * threads * values == PM.TANH_N and values == 4
    offs = PM.tanh_values(torch.arange(grid * threads))
    assert torch.equal(offs.reshape(-1).sort().values, torch.arange(PM.TANH_N))
    # one aligned load and store a thread; a warp's 32 are contiguous
    assert bool((offs[:, 0] % values == 0).all())
    assert torch.equal(offs[:32].reshape(-1), torch.arange(32 * values))


def test_tanh_pairs_pack_as_the_kernel():
    """The operand order of tanh_kernel's cvt.rn.bf16x2.f32 in the source:
    PTX's ``cvt.rn.bf16x2.f32 d, a, b`` puts bf16(a) in d's high half, so
    ``a`` must be the value taken from the word's high half (``w &
    0xffff0000``) and ``b`` the one from its low half (``w << 16``). The
    card's exhaustive check proves the packing; this catches a swap before
    a build."""
    src = (Path(PM.__file__).parents[1] / "csrc" / "probe_mosaic.cu").read_text()
    body = src[src.index("uint32_t tanh2(uint32_t w)"):]
    body = body[:body.index("\n}\n")]
    (a, b), = re.findall(r'asm\("cvt\.rn\.bf16x2\.f32 %0, %1, %2;"\s*:\s*"=r"\(\w+\)\s*:'
                         r'\s*"f"\((\w+)\),\s*"f"\((\w+)\)\)', body)
    half = dict(re.findall(r"const float (\w+) = tanhf\(__uint_as_float\(([^;]+)\)\);", body))
    assert half[a] == "w & 0xffff0000u" and half[b] == "w << 16", (a, b, half)


def test_tanh_exhaustive_input_holds_every_pattern():
    x = PM.tanh_exhaustive_input().view(torch.int16).reshape(3, 65536).long() & 0xFFFF
    assert torch.equal(x[0], torch.arange(65536))
    assert torch.equal(x[1], torch.arange(65535, -1, -1))
    assert torch.equal(x[2].sort().values, torch.arange(65536))


def test_tanh_jax_kernel_within_reference_tolerance(recorded):
    """The recorded JAX k5 against PLAIN["5"] on every bf16 pattern (three
    times): within the reference's max_abs < 2e-2 on the non-NaN inputs,
    NaN for NaN."""
    k5 = recorded("probe_mosaic_patterns", PM)["5"]
    x = PM.tanh_exhaustive_input()
    want = torch.from_numpy(np.asarray(jax.jit(k5)(_to_jnp(x))).astype(np.float32))
    got = PM.PLAIN["5"](x).float()
    nan = torch.isnan(x.float())
    differ = int((got[~nan] != want[~nan]).sum())
    err = float((got[~nan] - want[~nan]).abs().max())
    assert err < PM.ATOL, f"max_abs {err}, {differ} outputs differ"
    assert bool(torch.isnan(got[nan]).all() and torch.isnan(want[nan]).all())
