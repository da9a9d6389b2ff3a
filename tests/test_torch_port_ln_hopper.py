"""K16's Hopper form (``csrc/layernorm.cu``, ``ln_hopper_kernel``) on the
CPU: the form rule (``layernorm_form``), the persistent tile walk
(``layernorm_hopper_tiles``), and the form's order emulated in numpy (each
block's tiles staged, each warp's rows read from the stage in the first
form's lane order, lane l summing columns l + 32 j in j order, the xor
butterfly, the two moments with 1/D, ((x - mu) r) g + b) against
``layernorm_fused_plain`` and the JAX ``layernorm_fused`` in interpret
mode, in bf16 and fp32. The card tests hold the kernel to its first form,
output for output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops import pallas_layernorm as JL
from dlq_tpu_torch.ops.layernorm import (
    HOPPER_BLOCKS, HOPPER_STAGE_BYTES, HOPPER_STAGES, LN_EPS, layernorm_form,
    layernorm_fused_plain, layernorm_hopper_tiles,
)

H100_SMS = 132
LN_REL = 2.0 ** -19   # fp32 LN outputs: |got - ref| <= LN_REL * (1 + |ref|)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _ordinal(a: np.ndarray) -> np.ndarray:
    """bf16 values (held in fp32) as integers in their order."""
    b = torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    b = b.view(torch.int16).numpy().astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _held(got: np.ndarray, ref: np.ndarray, bf16: bool) -> None:
    """As the port's LayerNorm tests hold K16 (rsqrtf and the sums' order
    move an fp32 value a few ulp of the row's unit scale): fp32 within
    LN_REL of 1 + |ref|; bf16 >= 0.999 equal, none more than one bf16 step
    at that scale apart (2^-8 x (1 + |ref|): near zero, where (x - mu) r g
    cancels against b, one such step spans several of the value's own)."""
    if bf16:
        steps = np.abs(_ordinal(got) - _ordinal(ref))
        err = np.abs(got - ref)
        assert (steps == 0).mean() >= 0.999 and (err <= 2.0 ** -8 * (1.0 + np.abs(ref))).all(), (
            float((steps == 0).mean()), float(err.max()))
    else:
        err = np.abs(got - ref)
        assert (err <= LN_REL * (1.0 + np.abs(ref))).all(), float(err.max())


# ---- the form rule and the walk ----

@pytest.mark.parametrize("m,d,dtype,aligned,want", [
    (50432, 192, torch.bfloat16, True, "hopper"),    # DeiT-Tiny at batch 256
    (50432, 192, torch.float32, True, "hopper"),
    (1, 192, torch.bfloat16, True, "hopper"),
    (37, 200, torch.bfloat16, True, "hopper"),       # 400-byte rows
    (37, 100, torch.bfloat16, True, "first"),        # 200-byte rows: no multiple of 16
    (37, 100, torch.float32, True, "hopper"),
    (37, 512, torch.float32, True, "hopper"),
    (37, 600, torch.bfloat16, True, "first"),        # past the registers' 512
    (50432, 192, torch.bfloat16, False, "first"),    # x or out not 16-byte aligned
    (0, 192, torch.bfloat16, True, "first"),
])
def test_layernorm_form_rule(m, d, dtype, aligned, want):
    assert layernorm_form(m, d, dtype, aligned) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 33, 4111, 50431, 50432])
def test_layernorm_hopper_walk_covers_rows(m, dtype):
    """The persistent walk at D = 192: tiles of 32 bf16 / 16 fp32 rows
    (12,288 bytes), at most 4 blocks an SM and never more than the tiles,
    block b taking tiles b, b + grid, ... (the kernel's count of its tiles,
    (tiles - 1 - b) / grid + 1): every row once; four stages within the
    shared memory."""
    rows, tiles, grid, smem = layernorm_hopper_tiles(m, 192, dtype, H100_SMS)
    assert rows * 192 * (torch.finfo(dtype).bits // 8) == HOPPER_STAGE_BYTES
    assert grid == min(tiles, HOPPER_BLOCKS * H100_SMS) and tiles * rows >= m > (tiles - 1) * rows
    seen = np.zeros(m, np.int64)
    for b in range(grid):
        mine = (tiles - 1 - b) // grid + 1
        for i in range(mine):
            r0 = (b + i * grid) * rows
            seen[r0: min(r0 + rows, m)] += 1
    assert (seen == 1).all()
    assert smem == HOPPER_STAGES * HOPPER_STAGE_BYTES + 8 * HOPPER_STAGES <= 232448


# ---- the form's order, emulated ----

def _hopper_ln(x: np.ndarray, g: np.ndarray, b: np.ndarray, dtype) -> np.ndarray:
    """K16's Hopper form on x [M, D] (fp32 values of ``dtype``): the walk's
    tiles staged in turn, each warp's rows (w, w + 8, ...) from the stage,
    lane l summing columns l + 32 j (j < NJ = D / 32 rounded up) in j
    order in fp32, x and x·x, the xor butterfly, mu = s · (1/D), var =
    max(m2 - mu², 0), r = 1/sqrt(var + eps) (the card's rsqrtf is within
    an ulp or two of it), ((x - mu) r) g + b, rounded to ``dtype``."""
    m, d = x.shape
    rows, tiles, grid, _ = layernorm_hopper_tiles(m, d, dtype, H100_SMS)
    nj = -(-d // 32)
    lanes = np.arange(32)
    inv_n = np.float32(1.0 / d)
    out = np.full((m, d), np.nan, np.float32)
    for blk in range(grid):
        for i in range((tiles - 1 - blk) // grid + 1):
            r0 = (blk + i * grid) * rows
            stage = x[r0: r0 + rows].copy()
            for warp in range(8):
                for r in range(warp, stage.shape[0], 8):
                    s = np.zeros(32, np.float32)
                    sq = np.zeros(32, np.float32)
                    for j in range(nj):
                        c = lanes + 32 * j
                        v = np.where(c < d, stage[r, np.minimum(c, d - 1)], np.float32(0))
                        keep = c < d
                        s = np.where(keep, _f32(s + v), s)
                        sq = np.where(keep, _f32(sq + _f32(v * v)), sq)
                    for o in (16, 8, 4, 2, 1):
                        s, sq = _f32(s + s[lanes ^ o]), _f32(sq + sq[lanes ^ o])
                    mu = _f32(s[0] * inv_n)
                    var = np.maximum(_f32(_f32(sq[0] * inv_n) - _f32(mu * mu)), np.float32(0))
                    rr = _f32(1.0 / np.sqrt(np.float64(_f32(var + np.float32(LN_EPS)))))
                    stage[r] = _f32(_f32(_f32(_f32(stage[r] - mu) * rr) * g) + b)
            out[r0: r0 + stage.shape[0]] = stage
    assert not np.isnan(out).any()   # every row written
    return torch.from_numpy(out).to(dtype).float().numpy()


@pytest.mark.parametrize("m", [33, 301])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_hopper_lane_order_against_plain_and_jax(dtype, m):
    """The emulated order against the plain version and the JAX kernel in
    interpret mode at D = 192 (bf16: 32-row tiles, fp32: 16-row tiles; a
    partial last tile), x and g, b in ``dtype``."""
    bf16 = dtype == torch.bfloat16
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    gen = np.random.default_rng(4100 + m + bf16)
    xn = (gen.normal(0, 1, (m, 192)) * 3 + 1).astype(np.float32)
    gn = (gen.normal(0, 1, 192) * 0.2 + 1).astype(np.float32)
    bn = (gen.normal(0, 1, 192) * 0.1).astype(np.float32)
    x, g, b = (torch.from_numpy(a).to(dtype) for a in (xn, gn, bn))
    got = _hopper_ln(x.float().numpy(), g.float().numpy(), b.float().numpy(), dtype)
    _held(got, layernorm_fused_plain(x, g, b).float().numpy(), bf16)
    ref = JL.layernorm_fused(*(jnp.asarray(a).astype(jdt) for a in (xn, gn, bn)), interpret=True)
    _held(got, np.asarray(ref.astype(jnp.float32)), bf16)
