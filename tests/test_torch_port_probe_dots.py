"""The Hopper forms of the probes' dots and double conv on the CPU: the NT
dot (K19 3, K20 A, ``nt_dot_hopper_kernel``), the NN dot (K20 B,
``nn_dot_hopper_kernel``), the int8 dot (K22 E, ``int_dot_hopper_kernel``)
and the double conv (K21 D, ``double_conv_cluster_kernel``).

Each kernel's walk is emulated in numpy/torch from the kernel's own index
math: the TMA boxes landed with their swizzle (128-byte: 16-byte chunk c of
a 128-byte row r at c ^ (r & 7); 64-byte: at c ^ ((r >> 1) & 3)), every
ldmatrix as the 8-row gathers its lanes address (lanes 8j..8j+7 give matrix
j's rows), the mma.sync fragments assembled from those matrices, the tile
plans, the 4 x 4-byte transposes by ``__byte_perm`` (K21 D's weight slices,
K22 E's b), the stores from the fragments, and for K21 D the rank slices of
h and their exchange between the cluster's 8 ranks.

K19 3 and K20 A: the plan (``_probe.nt_dot_plan``, 16 x 32 output tiles)
covers every (sample, row, column) once at both shapes, and the walk
stores nothing past M or N;
its fp32 sums (each k16 step's 16 exact products added to the sum and
rounded once, as every emulation here takes an mma) equal the first form's
walk on the probes' seed-0 inputs, and both sit within ``_probe.held``'s
limit of the plain version. K20 B likewise (``probe_batched_dot.
nn_dot_plan``, the k16 steps 0..12 in order).

K22 E: the plan (``probe_stem_patterns.int_dot_plan``) covers each of the
12,544 rows once; b's transpose as the kernel's lanes make it equals b.T
byte for byte, a warp's 32-bit stores on 32 banks; the int32 sums on the
transposed copy equal ``PLAIN["E"]`` exactly, and the accumulator's
stores write each output of a block once.

K21 D: the partition (per-rank channel slices, the transposes, conv1 into
the rank's slice of h, the bulk copies, conv2 per rank with the skip from
the rank's slab) equals ``double_conv_plain`` byte for byte and the
reference's numpy expectation within its ``atol`` (1.0). The card tests
hold the kernels to their first forms and the C launch constants to these
mirrors.
"""

import numpy as np
import pytest
import torch

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools import probe_batched_dot as PB
from dlq_tpu_torch.tools import probe_block_patterns as PK
from dlq_tpu_torch.tools import probe_mosaic_patterns as PM
from dlq_tpu_torch.tools import probe_stem_patterns as PS

LANES = np.arange(32)
HI = LANES >> 4


def _land(logical: np.ndarray, span: int) -> np.ndarray:
    """TMA's landing of a box region's bytes (base 1,024-byte aligned) with
    the 128-byte (span 128) or 64-byte (span 64) swizzle: bits 7.. of the
    byte offset XORed into its 16-byte chunk index."""
    o = np.arange(logical.shape[-1])
    mask = 7 if span == 128 else 3
    phys = o ^ (((o >> 7) & mask) << 4)
    out = np.empty_like(logical)
    out[..., phys] = logical
    return out


def swz128(r, c):
    """probe_common.cuh's swz: 16-byte chunk c of 128-byte row r."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def swz64(r, c):
    """probe_batched_dot.cu's swz64: 16-byte chunk c of 64-byte row r."""
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def _ldsm(rows: np.ndarray) -> np.ndarray:
    """ldmatrix.x4 at the matrix level: the 32 lanes' rows ([..., 32, R])
    as its four 8-row matrices [..., 4, 8, R]."""
    return rows.reshape(rows.shape[:-2] + (4, 8) + rows.shape[-1:])


def byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """__byte_perm(x, y, s) for selectors of bytes 0..7: byte n of the
    result is byte (s >> 4n) & 7 of y:x."""
    xy = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(xy[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def transpose4x4(w):
    """probe_block.cu's transpose4x4 on uint32 words."""
    t0, t1 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[2], w[3], 0x5140)
    t2, t3 = byte_perm(w[0], w[1], 0x7362), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632), byte_perm(t2, t3, 0x5410),
            byte_perm(t2, t3, 0x7632)]


@pytest.mark.parametrize("span,rows", [(128, 32), (128, 256), (64, 64)])
def test_swizzled_reads_invert_tma_landing(span, rows):
    """The kernels' read addresses (swz, swz64) find every 16-byte chunk of a
    box where TMA's swizzle lands it."""
    rng = np.random.default_rng(span + rows)
    logical = rng.integers(0, 256, rows * span)
    landed = _land(logical, span)
    r, c = np.meshgrid(np.arange(rows), np.arange(span // 16), indexing="ij")
    f = swz128 if span == 128 else swz64
    got = landed[f(r, c)[..., None] + np.arange(16)]
    want = logical.reshape(rows, span // 16, 16)
    assert np.array_equal(got, want)


# ---- K20 B ----

def test_nn_dot_plan_covers_outputs_once():
    """112 blocks of 32 x 32 outputs, 4 warps of 16 x 16: every (sample, row
    < 200, column < 64) owned by one warp with rows, no warp past row 200
    runs a step, and every warp with rows walks the k16 steps 0..12 in
    order (the chunks of 64 keys: steps 0-3, 4-7, 8-11, 12)."""
    tiles = PB.nn_dot_plan()
    assert PB.nn_dot_launch() == (7, 2, 8, 128, 4, 4096) and len(tiles) == 7 * 2 * 8
    assert [list(c) for c in PB.nn_dot_chunks()] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                     [8, 9, 10, 11], [12]]
    owned = np.zeros((PB.B, PB.NP, PB.HD), np.int64)
    for t in tiles:
        for r0, c0, steps in t.warps:
            assert t.m0 <= r0 < t.m0 + PB.NN_TILE and t.n0 <= c0 < t.n0 + PB.NN_TILE
            if r0 >= PB.NP:
                assert steps == ()
                continue
            assert steps == tuple(range(PB.NN_KP // 16))
            rows = np.arange(r0, min(r0 + 16, PB.NP))
            owned[t.b, rows[:, None], c0 + np.arange(16)] += 1
    assert (owned == 1).all()
    # static shared memory: the aligned boxes, the fp32 tile, the mbarriers
    smem = 1024 + 2 * len(PB.nn_dot_chunks()) * PB.NN_BOX + 32 * 40 * 4 + 4 * 8
    assert smem <= 48 * 1024


def _mma(acc, a, b):
    """One mma.sync m16n8k16 step as both emulations take it: each output's
    16 exact bf16 products summed in float64, added to the fp32 sum and
    rounded to fp32."""
    return (acc.double() + a.double() @ b.double()).float()


def _bf16(raw: np.ndarray) -> np.ndarray:
    """Bytes [..., 2n] as the n bf16 values they hold, in float64."""
    t = torch.from_numpy(np.ascontiguousarray(raw.astype(np.uint8))).view(torch.bfloat16)
    return t.double().numpy()


def _nn_hopper_walk(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """nn_dot_hopper_kernel's walk: per block the a and v boxes of each key
    chunk (zeros past 200 rows or keys) landed swizzled, each warp's A
    fragments by ldmatrix from the a boxes and B fragments by ldmatrix.trans
    from the v boxes, the k16 steps in the plan's order, the tile stored
    through shared memory with rows >= 200 dropped. Returns fp32 [8, 200,
    64]; raises on an output stored twice or never."""
    tiles = PB.nn_dot_plan()
    nch = len(PB.nn_dot_chunks())
    a_pad = torch.zeros(PB.B, 7 * PB.NN_TILE, nch * PB.NN_CHUNK, dtype=torch.bfloat16)
    a_pad[:, :PB.NP, :PB.NP] = a
    v_pad = torch.zeros(PB.B, nch * PB.NN_CHUNK, PB.HD, dtype=torch.bfloat16)
    v_pad[:, :PB.NP] = v
    abox = np.stack([np.stack([a_pad[t.b, t.m0:t.m0 + 32, 64 * c:64 * c + 64].contiguous()
                               .view(torch.uint8).reshape(-1).numpy() for c in range(nch)])
                     for t in tiles])
    vbox = np.stack([np.stack([v_pad[t.b, 64 * c:64 * c + 64, t.n0:t.n0 + 32].contiguous()
                               .view(torch.uint8).reshape(-1).numpy() for c in range(nch)])
                     for t in tiles])
    abox, vbox = _land(abox, 128), _land(vbox, 64)   # [tiles, chunks, 4096]
    out = torch.full((PB.B, PB.NP, PB.HD), float("nan"))
    for w in range(4):
        wm, wn = w >> 1, w & 1
        acc = torch.zeros(len(tiles), 16, 16)
        for ks in range(PB.NN_KP // 16):
            c, kl = divmod(ks, PB.NN_CHUNK // 16)
            am = _ldsm(_bf16(abox[:, c][:, swz128(wm * 16 + (LANES & 15), 2 * kl + HI)[:, None]
                                         + np.arange(16)]))   # [T, 4, 8, 8]
            bm = _ldsm(_bf16(vbox[:, c][:, swz64(16 * kl + (LANES & 15), 2 * wn + HI)[:, None]
                                         + np.arange(16)]))
            A = torch.from_numpy(np.concatenate([np.concatenate([am[:, 0], am[:, 2]], 2),
                                                 np.concatenate([am[:, 1], am[:, 3]], 2)], 1))
            for j in range(2):   # n8 tile j: keys 0-7 from matrix 2j, 8-15 from 2j + 1
                Bj = torch.from_numpy(np.concatenate([bm[:, 2 * j], bm[:, 2 * j + 1]], 1))
                acc[:, :, 8 * j:8 * j + 8] = _mma(acc[:, :, 8 * j:8 * j + 8], A, Bj)
        for ti, t in enumerate(tiles):
            r0, c0, steps = t.warps[w]
            if not steps:
                continue
            n = min(16, PB.NP - r0)
            assert bool(out[t.b, r0:r0 + n, c0:c0 + 16].isnan().all())
            out[t.b, r0:r0 + n, c0:c0 + 16] = acc[ti, :n]
    assert not bool(out.isnan().any())
    return out


def _nn_first_walk(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """nn_dot_kernel's walk: each output's k16 steps 0..12 over the 208 keys,
    200..207 zero (the blocks' and warps' split does not enter a sum)."""
    a_pad = torch.zeros(PB.B, PB.NP, PB.NN_KP, dtype=torch.bfloat16)
    a_pad[..., :PB.NP] = a
    v_pad = torch.zeros(PB.B, PB.NN_KP, PB.HD, dtype=torch.bfloat16)
    v_pad[:, :PB.NP] = v
    acc = torch.zeros(PB.B, PB.NP, PB.HD)
    for ks in range(PB.NN_KP // 16):
        acc = _mma(acc, a_pad[..., 16 * ks:16 * ks + 16], v_pad[:, 16 * ks:16 * ks + 16])
    return acc


def test_nn_dot_hopper_walk_equals_first_walk():
    """K20 B on the probe's seed-0 inputs: the Hopper walk equal to the first
    form's on every output, both within _probe.held's fp32 limit of the
    plain version and the reference's check against its expectation."""
    (a, v), expect = [(xs, e) for k, xs, e in PB.cases() if k == "B"][0]
    hop, first = _nn_hopper_walk(a, v), _nn_first_walk(a, v)
    assert torch.equal(hop, first)
    plain = PB.PLAIN["B"](a, v)
    for got in (hop, first):
        ok, text, _ = _probe.held(got, plain, PB.SPEC["B"])
        assert ok, text
        ok, text = PB.CHECK(got, expect, PB.SPEC["B"].atol)
        assert ok, text


# ---- K19 3, K20 A ----

NT_SHAPES = {"3": (1, 256, 256), "A": (PB.B, PB.NP, PB.NP)}


def _nt_case(key):
    """The pattern's seed-0 inputs as [batch, rows, 64], its module and its
    expectation."""
    mod = PM if key == "3" else PB
    (q, k), expect = [(xs, e) for kk, xs, e in mod.cases() if kk == key][0]
    batch = NT_SHAPES[key][0]
    return mod, q.reshape(batch, -1, 64), k.reshape(batch, -1, 64), expect


@pytest.mark.parametrize("key", ["3", "A"])
def test_nt_dot_plan_covers_outputs_once(key):
    """K19 3 (8 x 16 = 128 blocks of 16 x 32 outputs) and K20 A (7 x 13 x 8
    = 728): every (sample, row < M, column < N) owned by one running warp
    of 16 x 16, every warp whose rows and columns start inside M, N runs,
    and the launch (which the card tests hold the C side's to) matches."""
    batch, m, n = NT_SHAPES[key]
    rows = _probe.NT_ROWS
    tiles = _probe.nt_dot_plan(batch, m, n)
    launch = _probe.nt_dot_launch(batch, m, n)
    assert launch == {"3": (8, 16, 1, 64, 16, 32, 6144), "A": (7, 13, 8, 64, 16, 32, 6144)}[key]
    assert len(tiles) == launch[0] * launch[1] * batch
    owned = np.zeros((batch, m, n), np.int64)
    for t in tiles:
        assert len(t.warps) == rows // 16 * 2
        for r0, c0, runs in t.warps:
            assert t.m0 <= r0 < t.m0 + rows and t.n0 <= c0 < t.n0 + _probe.NT_COLS
            assert runs == (r0 < m and c0 < n)
            if runs:
                owned[t.b, r0:min(r0 + 16, m), c0:min(c0 + 16, n)] += 1
    assert (owned == 1).all()


def _nt_hopper_walk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """nt_dot_hopper_kernel's walk on q [B, M, 64], k [B, N, 64]: per block
    the q box (16 rows) and k box (32 rows) landed swizzled, zeros past
    a sample's rows; each running warp's A fragments by ldmatrix from the q
    box, B fragments by ldmatrix from the k box (key rows, d contiguous),
    the k16 steps 0..3 in order; each lane's pairs stored from its
    fragments, rows >= M and columns >= N skipped. Returns fp32 [B, M, N];
    raises on an output stored twice or never."""
    batch, m, _ = q.shape
    n = k.shape[1]
    rows, cols = _probe.NT_ROWS, _probe.NT_COLS
    tiles = _probe.nt_dot_plan(batch, m, n)
    q_pad = torch.zeros(batch, -(-m // rows) * rows, 64, dtype=torch.bfloat16)
    q_pad[:, :m] = q
    k_pad = torch.zeros(batch, -(-n // cols) * cols, 64, dtype=torch.bfloat16)
    k_pad[:, :n] = k
    qbox = _land(np.stack([q_pad[t.b, t.m0:t.m0 + rows].contiguous().view(torch.uint8)
                           .reshape(-1).numpy() for t in tiles]), 128)
    kbox = _land(np.stack([k_pad[t.b, t.n0:t.n0 + cols].contiguous().view(torch.uint8)
                           .reshape(-1).numpy() for t in tiles]), 128)
    out = torch.full((batch, m, n), float("nan"))
    g, t4 = LANES >> 2, LANES & 3
    for w in range(rows // 16 * 2):
        wm, wn = w >> 1, w & 1
        acc = torch.zeros(len(tiles), 16, 16)
        for kk in range(4):
            am = _ldsm(_bf16(qbox[:, swz128(16 * wm + (LANES & 15), 2 * kk + HI)[:, None]
                                  + np.arange(16)]))   # [T, 4, 8, 8]
            bm = _ldsm(_bf16(kbox[:, swz128(16 * wn + 8 * HI + (LANES & 7),
                                            2 * kk + ((LANES >> 3) & 1))[:, None]
                                  + np.arange(16)]))
            A = torch.from_numpy(np.concatenate([np.concatenate([am[:, 0], am[:, 2]], 2),
                                                 np.concatenate([am[:, 1], am[:, 3]], 2)], 1))
            for j in range(2):   # key tile 2 wn + j: its d 0-7 from matrix 2j, 8-15 from 2j + 1
                Bj = torch.from_numpy(np.concatenate([bm[:, 2 * j], bm[:, 2 * j + 1]], 2))
                acc[:, :, 8 * j:8 * j + 8] = _mma(acc[:, :, 8 * j:8 * j + 8], A,
                                                  Bj.transpose(1, 2))
        for ti, t in enumerate(tiles):
            if not t.warps[w][2]:
                continue
            for hh in range(2):
                for j in range(2):   # lane (g, t4): row g + 8 hh, columns 8 j + 2 t4, + 1
                    row = t.m0 + 16 * wm + g + 8 * hh
                    col = t.n0 + 16 * wn + 8 * j + 2 * t4
                    keep = (row < m) & (col < n)
                    for e in range(2):
                        dst = out[t.b, row[keep], col[keep] + e]
                        assert bool(dst.isnan().all())
                        out[t.b, row[keep], col[keep] + e] = acc[ti, (g + 8 * hh)[keep],
                                                                 (8 * j + 2 * t4 + e)[keep]]
    assert not bool(out.isnan().any())
    return out


def _nt_first_walk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """nt_dot_kernel's walk: each output's k16 steps 0..3 from fp32 zero
    (the blocks' and warps' split does not enter a sum)."""
    acc = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
    for ks in range(4):
        acc = _mma(acc, q[..., 16 * ks:16 * ks + 16], k[..., 16 * ks:16 * ks + 16].transpose(1, 2))
    return acc


@pytest.mark.parametrize("key", ["3", "A"])
def test_nt_dot_hopper_walk_equals_first_walk(key):
    """K19 3 and K20 A on the probes' seed-0 inputs: the Hopper walk equal to
    the first form's on every output, both within _probe.held's fp32 limit
    of the plain version and the reference's check against its
    expectation."""
    mod, q, k, expect = _nt_case(key)
    hop, first = _nt_hopper_walk(q, k), _nt_first_walk(q, k)
    assert torch.equal(hop, first)
    shape = mod.SPEC[key].out[0]
    plain = mod.PLAIN[key](q.reshape(mod.SPEC[key].ins[0][0]), k.reshape(mod.SPEC[key].ins[1][0]))
    for got in (hop.reshape(shape), first.reshape(shape)):
        ok, text, _ = _probe.held(got, plain, mod.SPEC[key])
        assert ok, text
        ok, text = mod.CHECK(got, expect, mod.SPEC[key].atol)
        assert ok, text


# ---- K22 E ----

def test_int_dot_plan_covers_rows_once():
    """196 blocks of 64 rows: each of the 12,544 rows of a and out owned by
    one block; the shared memory (aligning room, the a tile, b^T, the
    mbarrier) fits two blocks on an SM; the launch (which the card tests
    hold the C side's to) as the kernel's notes give it."""
    plan = PS.int_dot_plan()
    assert PS.int_dot_launch() == (196, 128, 64, 8192, 33800, 16384)
    rows = np.concatenate([np.asarray(r) for r in plan])
    assert np.array_equal(np.sort(rows), np.arange(PS.EM)) and len(rows) == PS.EM
    assert 2 * PS.ID_SMEM <= _probe.SMEM_MAX


def _int_dot_bt(b: np.ndarray) -> np.ndarray:
    """int_dot_hopper_kernel's b^T fill on b [256][64] int8: warp w, its K
    half w & 1 and pieces w >> 1 and 2 + (w >> 1) of 16 columns, lane = K
    quad kb & 31; each lane's 4 rows' 16 bytes as 4 little-endian words,
    transpose4x4 per 4-column block, 32-bit stores at [K half][n][128]
    with the 128-byte swizzle. Returns the 16 KB (-1: never stored); raises
    on a byte stored twice or on a warp's store off 32 distinct banks."""
    bt = np.full(2 * PS.ID_BOX, -1, np.int64)
    bu = b.astype(np.uint8).astype(np.int64)
    for warp in range(4):
        h = warp & 1
        kb = 32 * h + LANES
        for it in range(2):
            piece = 2 * it + (warp >> 1)
            words = [(bu[4 * kb + i, 16 * piece:16 * piece + 16].reshape(32, 4, 4)
                      << (8 * np.arange(4))).sum(-1) for i in range(4)]   # [lane][q] each
            for q in range(4):
                wt = transpose4x4([words[i][:, q] for i in range(4)])
                for j in range(4):
                    addr = h * PS.ID_BOX + swz128(16 * piece + 4 * q + j, LANES >> 2) \
                        + 4 * (LANES & 3)
                    assert len(set((addr // 4 % 32).tolist())) == 32
                    for by in range(4):
                        assert (bt[addr + by] == -1).all()
                        bt[addr + by] = (wt[j] >> (8 * by)) & 0xFF
    return bt


def test_int_dot_transpose_and_sums_equal_plain():
    """K22 E on the probe's seed-0 inputs: b^T as the kernel's lanes store
    it, read back through the swizzled layout wgmma's descriptors read,
    equals b.T byte for byte; the int32 sums of a and that copy equal
    PLAIN["E"] exactly; the accumulator's pairs, stored by the kernel's
    8-byte stores, write each output of a block's 64 rows once."""
    (a, b), expect = [(xs, e) for k, xs, e in PS.cases() if k == "E"][0]
    bt = _int_dot_bt(b.numpy())
    assert (bt >= 0).all()
    n, kk = np.meshgrid(np.arange(PS.EN), np.arange(PS.EK), indexing="ij")
    logical = bt[(kk >> 7) * PS.ID_BOX + swz128(n, (kk & 127) >> 4) + (kk & 15)]   # [n][k]
    b_t = logical.astype(np.uint8).view(np.int8)
    assert np.array_equal(b_t, b.numpy().T)
    sums = a.double() @ torch.from_numpy(b_t.T.astype(np.float64))
    plain = PS.PLAIN["E"](a, b)
    assert torch.equal(sums.to(torch.int32), plain)
    ok, text = PS.CHECK(plain, expect, PS.SPEC["E"].atol)
    assert ok, text
    # acc[4 j + q] of thread 32 w + 4 g + t: row 16 w + g + 8 (q >> 1), column
    # 8 j + 2 t + (q & 1); pair (q, q + 1) at q = 2 hh, one 8-byte store
    stored = np.zeros((PS.ID_ROWS, PS.EN), np.int64)
    g, t4 = LANES >> 2, LANES & 3
    for w in range(4):
        for j in range(8):
            for hh in range(2):
                for e in range(2):
                    np.add.at(stored, (16 * w + g + 8 * hh, 8 * j + 2 * t4 + e), 1)
    assert (stored == 1).all()


# ---- K21 D ----

TOH, OW, C = PK.TOH, PK.OW, PK.C
SH, SW, H1, W1 = TOH + 4, OW + 4, TOH + 2, OW + 2
M1 = H1 * W1
CS, LDB, R = PK.D_CS, PK.D_LDB, PK.D_RANKS
TAPB, HSL = CS * LDB, PK.D_HSLICE


def _transposed(w: np.ndarray, rank: int) -> np.ndarray:
    """transpose_slice on rank `rank`'s slice of a [9][cin][cout] stack as
    TMA lands it ([tap][cin][16 couts]): the items (tap, 4 cin rows), the
    16-byte rows as 4 little-endian words, transpose4x4 per 4-cout block,
    32-bit stores at [tap][cout][cin] (rows LDB apart). Returns the bytes
    [9 * TAPB]; bytes never stored hold 0xAA."""
    sl = w[:, :, CS * rank:CS * rank + CS].astype(np.uint8).astype(np.int64)   # [9][128][16]
    out = np.full(9 * TAPB, 0xAA, np.int64)
    words = (sl.reshape(9, C, 4, 4) << (8 * np.arange(4))).sum(-1)   # [tap][cin][nb]
    for c in range(9 * (C // 4)):
        tap, kb = c >> 5, c & 31
        for nb in range(4):
            t = transpose4x4([words[tap, 4 * kb + i, nb] for i in range(4)])
            for j in range(4):
                at = tap * TAPB + (4 * nb + j) * LDB + 4 * kb
                out[at:at + 4] = [(t[j] >> (8 * i)) & 0xFF for i in range(4)]
    return out


def test_double_conv_transpose_by_byte_perm():
    """Every rank's transposed slices hold w[tap][cin][16 r + n] at [tap][n]
    [cin], from 4 x 4-byte blocks: the pad bytes past cin 127 are never
    stored (nor read: B fragments read bytes 0..127), and a warp's 32 stores
    of one (nb, j) land on 32 distinct banks (row stride LDB = 144 bytes,
    kb = lane)."""
    (_, w1, _), = [xs for k, xs, _ in PK.cases() if k == "D"]
    w = w1.numpy()
    for r in range(R):
        bt = _transposed(w, r).reshape(9, CS, LDB)
        assert np.array_equal(bt[:, :, :C].astype(np.uint8).view(np.int8),
                              np.transpose(w[:, :, CS * r:CS * r + CS], (0, 2, 1)))
        assert (bt[:, :, C:] == 0xAA).all()
    for nb in range(4):
        for j in range(4):
            banks = ((4 * nb + j) * LDB + 4 * LANES) // 4 % 32
            assert len(set(banks.tolist())) == 32


def _slab_landed(slab: np.ndarray) -> np.ndarray:
    """The slab's 8 boxes of 32 pixels (pixels 240..255 zeros) landed with
    the 128-byte swizzle: bytes [256 * 128]."""
    px = np.zeros((8 * PK.D_XBOX, C), np.int64)
    px[:SH * SW] = slab.reshape(SH * SW, C).astype(np.uint8)
    return _land(px.reshape(-1), 128)


def _as_i8(b: np.ndarray) -> np.ndarray:
    return b.astype(np.uint8).view(np.int8).astype(np.int64)


def _a_rows(m: np.ndarray) -> np.ndarray:
    """The s8 A operand (16 rows x 32 k bytes) from ldmatrix's 4 matrices:
    rows 0-7 / 8-15 from matrices 0 / 1 (k 0-15) and 2 / 3 (k 16-31)."""
    return np.concatenate([np.concatenate([m[..., 0, :, :], m[..., 2, :, :]], -1),
                           np.concatenate([m[..., 1, :, :], m[..., 3, :, :]], -1)], -2)


def _b_cols(m: np.ndarray) -> np.ndarray:
    """Both n8 tiles' s8 B operands from one x4 (rows n = (lane & 7) + 8 hi,
    k half (lane >> 3) & 1): [16 n][32 k]."""
    return np.concatenate([np.concatenate([m[..., 0, :, :], m[..., 1, :, :]], -1),
                           np.concatenate([m[..., 2, :, :], m[..., 3, :, :]], -1)], -2)


def _epi(acc: np.ndarray, s: np.float32) -> np.ndarray:
    """rintf(__fmul_rn(__int2float_rn(acc), s)), in fp32."""
    return np.rint(acc.astype(np.float32) * np.float32(s))


def _double_conv_cluster(slab: np.ndarray, w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    """double_conv_cluster_kernel's partition, rank by rank: conv1 on warps
    0-3 (3 m16 tiles x both n8 tiles each, rows padded to 192 by repeating
    row 179) from the swizzled slab and the transposed w1 slice into the
    rank's slice of h; the bulk copies into the other ranks' h (each slice
    of each rank's h written once); conv2 on warps 0-3 (2 output rows each)
    from the rank's own h and transposed w2, the skip read from the rank's
    swizzled slab. Returns out [1, 8, 16, 128] int8."""
    xs = _slab_landed(slab)
    bt = [(_transposed(w1, r), _transposed(w2, r)) for r in range(R)]
    bn = ((LANES & 7) + 8 * HI) * LDB + 16 * ((LANES >> 3) & 1)
    h = np.full((R, R, M1 * CS), -1, np.int64)   # [rank's h][slice][bytes]; -1: never written
    writes = np.zeros((R, R), np.int64)
    for r in range(R):
        for w in range(4):
            acc = np.zeros((3, 16, 16), np.int64)
            rows = np.minimum((3 * w + np.arange(3)[:, None]) * 16 + (LANES & 15), M1 - 1)
            pix = (rows // W1) * SW + rows % W1   # [3 tiles][32 lanes]
            for tap in range(9):
                p = pix + (tap // 3) * SW + tap % 3
                for ks in range(4):
                    addr = p * C + (((2 * ks) ^ (HI ^ (p & 7))) << 4)
                    A = _a_rows(_ldsm(_as_i8(xs[addr[..., None] + np.arange(16)])))
                    B = _b_cols(_ldsm(_as_i8(bt[r][0][(tap * TAPB + bn + 32 * ks)[:, None]
                                                      + np.arange(16)])))
                    acc += A @ B.T
            hv = np.clip(_epi(acc, PK.S1), 0, 127).astype(np.int64)   # [3][16 rows][16 ch]
            for i in range(3):
                for rr in range(16):
                    row = (3 * w + i) * 16 + rr
                    if row < M1:
                        h[r, r, row * CS:(row + 1) * CS] = hv[i, rr]
        writes[r, r] += 1
    for r in range(R):   # thread 0's bulk copies: rank r's slice into rank (r + d) % 8
        for d in range(1, R):
            h[(r + d) % R, r] = h[r, r]
            writes[(r + d) % R, r] += 1
    assert (writes == 1).all() and (h[:, :, :M1 * CS] >= 0).all()
    out = np.zeros((TOH, OW, C), np.int64)
    for r in range(R):
        hr = h[r].reshape(-1)   # [slice][pixel][16]: slices kHSlice apart
        for w in range(4):
            acc = np.zeros((2, 16, 16), np.int64)
            hb = HI * HSL + (2 * w * W1 + (LANES & 15)) * CS
            for tap in range(9):
                toff = ((tap // 3) * W1 + tap % 3) * CS
                for ks in range(4):
                    addr = hb + 2 * ks * HSL + toff + (np.arange(2)[:, None] * W1 * CS)
                    rows = hr[addr[..., None] + np.arange(16)]
                    assert (rows >= 0).all()   # only bytes some rank wrote
                    A = _a_rows(_ldsm(_as_i8(rows)))
                    B = _b_cols(_ldsm(_as_i8(bt[r][1][(tap * TAPB + bn + 32 * ks)[:, None]
                                                      + np.arange(16)])))
                    acc += A @ B.T
            y = _epi(acc, PK.S2)   # [2 rows][16 pixels][16 ch]
            for i in range(2):
                oi = 2 * w + i
                oj = np.arange(16)[:, None]
                ch = CS * r + np.arange(16)[None, :]
                p = (oi + 2) * SW + oj + 2
                res = _as_i8(xs[p * C + ((((ch >> 4) ^ (p & 7)) << 4) | (ch & 15))])
                out[oi, :, CS * r:CS * r + CS] = np.clip(y[i] + res.astype(np.float32), 0, 127)
    return out.astype(np.int8)[None]


def test_double_conv_cluster_partition_equals_plain():
    """K21 D on the probe's seed-0 inputs: the cluster partition equals
    double_conv_plain byte for byte and the reference's expectation within
    its atol (1.0)."""
    (slab, w1, w2), expect = [(xs, e) for k, xs, e in PK.cases() if k == "D"][0]
    got = torch.from_numpy(_double_conv_cluster(slab.numpy(), w1.numpy(), w2.numpy()))
    assert torch.equal(got, PK.PLAIN["D"](slab, w1, w2))
    ok, text = PK.CHECK(got, expect, PK.SPEC["D"].atol)
    assert ok, text


def test_double_conv_smem_and_reads():
    """The shared-memory layout fits the card's 232,448 bytes with every
    region 16-byte aligned (TMA boxes and ldmatrix rows) and the swizzled
    slab 1,024-byte aligned; conv1's A gathers of 8 pixels put their
    distinct rows on distinct 16-byte bank groups except where a matrix
    spans an h row's end (at most 2 rows a group; the pad rows repeat row
    179, one address), conv2's and every B gather always on 8."""
    layout = PK.d_smem()
    assert PK.D_SMEM <= _probe.SMEM_MAX and layout["slab"][0] % 1024 == 0
    assert all(off % 16 == 0 for off, _ in layout.values())
    worst = 0
    for w in range(4):
        rows = np.minimum((3 * w + np.arange(3)[:, None]) * 16 + (LANES & 15), M1 - 1)
        pix = (rows // W1) * SW + rows % W1
        for tap in range(9):
            p = pix + (tap // 3) * SW + tap % 3
            for ks in range(4):
                addr = p * C + (((2 * ks) ^ (HI ^ (p & 7))) << 4)
                for m in addr.reshape(3, 4, 8):
                    for grp in m:   # one 8-row phase: its distinct rows by bank group
                        rows8 = np.unique(grp)
                        worst = max(worst, np.bincount((rows8 // 16) % 8).max())
    assert worst <= 2
    bn = ((LANES & 7) + 8 * HI) * LDB + 16 * ((LANES >> 3) & 1)
    assert all(len(set(((bn[8 * j:8 * j + 8]) // 16 % 8).tolist())) == 8 for j in range(4))
    for w in range(4):
        hb = HI * HSL + (2 * w * W1 + (LANES & 15)) * CS
        for j in range(4):
            assert len(set((hb[8 * j:8 * j + 8] // 16 % 8).tolist())) == 8
