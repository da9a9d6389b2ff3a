"""The Hopper forms of the stem probe's cols build (K22 J, ``cols_kernel``)
and max pool (K22 K, ``maxpool_kernel``) on the CPU.

Each kernel's walk is emulated in torch from the kernel's own index math,
mirrored in ``probe_stem_patterns``:

J: ``cols_granules`` (a thread per 16-byte output granule) covers every
byte of cols [12544, 256] once, a warp's stores are 512 contiguous bytes,
and the two 8-byte loads of each granule (``cols_sources``: the (r, a)
runs of merge(x) and their offsets) are 8-aligned, inside x, and fill cols
equal to ``cols_plain`` bit for bit.

K: a thread per 16-byte output granule (``pool_launch``) covers every byte
of [56, 3584] once, and its 9 taps (``pool_taps``: the byte offset of each
tap's 16-byte load, -1 for a tap in the padding, taken as -128) give a max
equal to ``maxpool_plain`` bit for bit. On a map whose every value is
negative, a 0 padding in place of -128 would change the top row and the
left column: the emulation shows that it does, so the check sees the pad.

Each runs on the probe's own inputs and on two more seeded draws over the
whole int8 range (-128 included). The card tests hold the kernels to their
first forms and the C launch constants to these mirrors;
``tests/test_torch_port_probes.py`` holds ``PLAIN["J"]`` and ``PLAIN["K"]``
to the recorded JAX kernels.
"""

import numpy as np
import pytest
import torch

from dlq_tpu_torch.tools import probe_stem_patterns as PS


def _x(draw):
    """J's input x [232, 920] int8: the probe's own (seed 0) or a draw over
    the whole int8 range."""
    if draw == "probe":
        (xs,) = [xs for k, xs, _ in PS.cases() if k == "J"]
        return xs[0]
    rng = np.random.default_rng(draw)
    return torch.from_numpy(rng.integers(-128, 128, (232, 920)).astype(np.int8))


def _c(draw):
    """K's input [12544, 64] int8: the probe's own, a draw over the whole
    int8 range, or a map whose every value is negative."""
    if draw == "probe":
        (xs,) = [xs for k, xs, _ in PS.cases() if k == "K"]
        return xs[0]
    if draw == "negative":
        rng = np.random.default_rng(3)
        return torch.from_numpy(rng.integers(-128, 0, (12544, 64)).astype(np.int8))
    rng = np.random.default_rng(draw)
    return torch.from_numpy(rng.integers(-128, 128, (12544, 64)).astype(np.int8))


def _cols_walk(x: torch.Tensor) -> torch.Tensor:
    """``cols_kernel`` block by block: each thread's granule from its two
    8-byte loads, stored at byte 16 g of cols."""
    flat = x.reshape(-1)
    g = PS.cols_granules()
    src = PS.cols_sources(g)                                   # [grid, threads, 2]
    loaded = flat[src[..., None] + torch.arange(8)]            # [grid, threads, 2, 8]
    out = torch.empty(PS.COLS_GRANULES * 16, dtype=torch.int8)
    out[(16 * g)[..., None] + torch.arange(16)] = loaded.reshape(*g.shape, 16)
    return out.reshape(12544, 256)


def _pool_walk(c: torch.Tensor, pad: int = -128) -> torch.Tensor:
    """``maxpool_kernel`` thread by thread: the 9 taps' 16-byte loads, a
    padded tap taken as ``pad``, their max stored at byte 16 t."""
    grid, threads, nbytes = PS.pool_launch()
    t = torch.arange(grid * threads)
    taps = PS.pool_taps(t)                                     # [n, 9]
    flat = c.reshape(-1)
    got = flat[taps.clamp_min(0)[..., None] + torch.arange(nbytes)]
    got = torch.where((taps >= 0)[..., None], got, torch.tensor(pad, dtype=torch.int8))
    out = torch.empty(PS.POOL_GRANULES * nbytes, dtype=torch.int8)
    out[(16 * t)[:, None] + torch.arange(nbytes)] = got.amax(1)
    return out.reshape(56, 3584)


def test_cols_plan_covers_outputs_once():
    grid, threads, nbytes = PS.cols_launch()
    assert (grid, threads, nbytes) == (784, 256, 16)
    g = PS.cols_granules()
    assert g.shape == (grid, threads)
    assert grid * threads * nbytes == 12544 * 256
    assert torch.equal(g.reshape(-1).sort().values, torch.arange(PS.COLS_GRANULES))
    # a warp's 32 lanes store 32 neighbouring granules: 512 contiguous
    # bytes, two cols rows
    warps = g.reshape(grid, threads // 32, 32)
    assert torch.equal(warps - warps[..., :1], torch.arange(32).expand_as(warps))
    assert bool((warps[..., 0] % 32 == 0).all())


def test_cols_sources_aligned_and_inside():
    src = PS.cols_sources(PS.cols_granules())
    assert bool((src % 8 == 0).all())
    assert int(src.min()) == 0 and int(src.max()) + 8 <= 232 * 920
    # each granule's two loads are the 16 contiguous bytes of one (r, a) run
    assert torch.equal(src[..., 1] - src[..., 0], torch.full_like(src[..., 0], 8))
    # neighbouring cols rows (j, j + 1) read runs 8 bytes apart: 24 shared bytes
    g = torch.arange(0, 16 * 111, 16)
    assert torch.equal(PS.cols_sources(g + 16)[:, 0] - PS.cols_sources(g)[:, 0],
                       torch.full((111,), 8))


@pytest.mark.parametrize("draw", ["probe", 1, 2])
def test_cols_walk_equals_plain(draw):
    x = _x(draw)
    assert torch.equal(_cols_walk(x), PS.cols_plain(x))


def test_cols_walk_equals_numpy_expectation():
    x = _x("probe")
    (expect,) = [e for k, _, e in PS.cases() if k == "J"]
    assert np.array_equal(_cols_walk(x).numpy().astype(np.int64), expect)


def test_pool_plan_covers_outputs_once():
    grid, threads, nbytes = PS.pool_launch()
    assert (grid, threads, nbytes) == (392, 32, 16)
    assert grid * threads == PS.POOL_GRANULES
    t = torch.arange(grid * threads)
    # thread t's store (bytes 16 t ..+16) is 16 channels of the output pixel
    # whose taps it reads: pixel (oi, oj), channels c16 ..+16
    oi, oj, c16 = t // 224, (t >> 2) % 56, 16 * (t & 3)
    assert torch.equal((oi * 56 + oj) * 64 + c16, 16 * t)
    assert int(oi.max()) == 55 and int(oj.max()) == 55


def test_pool_taps_pad_and_inside():
    taps = PS.pool_taps(torch.arange(PS.POOL_GRANULES))
    inside = taps[taps >= 0]
    assert bool((inside % 16 == 0).all()) and int(inside.max()) + 16 <= 12544 * 64
    # the centre tap always lies inside; padded taps only at oi = 0 (kh 0)
    # or oj = 0 (kw 0)
    assert bool((taps[:, 4] >= 0).all())
    t = torch.arange(PS.POOL_GRANULES)
    oi, oj = t // 224, (t >> 2) % 56
    padded = taps < 0
    kh = torch.arange(9) // 3
    kw = torch.arange(9) % 3
    want = ((oi[:, None] == 0) & (kh == 0)) | ((oj[:, None] == 0) & (kw == 0))
    assert torch.equal(padded, want)


@pytest.mark.parametrize("draw", ["probe", 1, 2, "negative"])
def test_pool_walk_equals_plain(draw):
    c = _c(draw)
    got = _pool_walk(c)
    assert torch.equal(got, PS.maxpool_plain(c))
    assert np.array_equal(got.numpy().astype(np.int64), PS._expect_k(c.numpy()))


def test_pool_zero_pad_shows_on_negative_map():
    """On a map whose every value is negative, a 0 padding differs from
    -128 exactly where a padded tap exists: the top row and the left
    column of the output, every channel; the emulation with -128 does
    not."""
    c = _c("negative")
    zero = _pool_walk(c, pad=0).reshape(56, 56, 64)
    plain = PS.maxpool_plain(c).reshape(56, 56, 64)
    differ = (zero != plain).all(-1)
    edge = torch.zeros(56, 56, dtype=torch.bool)
    edge[0, :] = True
    edge[:, 0] = True
    assert torch.equal(differ, edge)
    assert torch.equal((zero != plain).any(-1), edge)
