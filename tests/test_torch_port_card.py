"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs an NVIDIA card and nvcc, and skips without them. It imports no JAX,
so it also runs on a machine without JAX, with the JAX-side conftest left
out:

    python -m pytest --noconftest -m gpu -q tests/test_torch_port_card.py
"""

import numpy as np
import pytest
import torch

from dlq_tpu_torch.ops.block_fused import (
    basic_block_fused, basic_block_plain, bottleneck_block_fused, bottleneck_block_plain,
    pack_basic_block, pack_bottleneck_block,
)
from dlq_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, pack_conv_weight
from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight
from dlq_tpu_torch.quant.model_quant import quantize_weights
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL


def _i8(rng, shape, lo=-127):
    return torch.from_numpy(rng.integers(lo, 128, shape).astype(np.int8))


def _epi(rng, oc, k, dev):
    """Per-OC scales putting y near unit scale, and biases."""
    scale = (rng.uniform(0.5, 1.5, oc) / (73.0 * 73.0 * np.sqrt(k))).astype(np.float32)
    bias = rng.normal(0, 0.3, oc).astype(np.float32)
    return torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev)


@pytest.mark.gpu
def test_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # (H, C, OC, k, stride, relu, out_scale): the main path's 3x3/s1, 3x3/s2
    # and 1x1/s2 geometries, the C=3 stem, and a 1x1/s1 conv
    for (h, c, oc, k, s, relu, osc) in [(12, 64, 64, 3, 1, True, 0.025), (12, 64, 128, 3, 2, False, None),
                                        (12, 128, 256, 1, 2, False, 0.025), (20, 3, 64, 7, 2, True, None),
                                        (12, 128, 256, 1, 1, True, 0.025)]:
        x = _i8(rng, (3, h, h, c)).to(dev)
        pk = pack_conv_weight(_i8(rng, (k, k, c, oc)).to(dev))
        args = (x, pk, s, k // 2, *_epi(rng, oc, k * k * c, dev), relu, osc)
        assert torch.equal(conv_int8(*args), conv_int8_plain(*args))
    # the fc, and 1x1/s1 body convs with relu and int8 epilogues (N = 64 takes
    # the 128x64 tile)
    for (m, k, n, relu, osc) in [(37, 512, 1000, False, None), (300, 256, 64, True, 0.025),
                                 (300, 64, 256, False, 0.025), (300, 128, 512, True, None)]:
        x = _i8(rng, (m, k)).to(dev)
        pk = pack_dense_weight(_i8(rng, (k, n)).to(dev))
        args = (x, pk, *_epi(rng, n, k, dev), relu, osc)
        assert torch.equal(matmul_int8(*args), matmul_int8_plain(*args))
    # one identity block at 14x14x128 with quantized weights and site scales
    flat = {n: {"w": torch.from_numpy(rng.normal(0, 0.05, (3, 3, 128, 128)).astype(np.float32)),
                "b": torch.from_numpy(rng.normal(0, 0.2, 128).astype(np.float32))}
            for n in ("b.conv1", "b.conv2")}
    qflat = {n: {"qw": p["qw"].to(dev), "b": p["b"].to(dev)}
             for n, p in quantize_weights(flat, INT8_PER_CHANNEL).items()}
    scales = {n: torch.tensor(v, dtype=torch.float32, device=dev)
              for n, v in (("b.conv1", 0.05), ("b.conv2", 0.35), ("n.conv1", 0.08))}
    pack = pack_basic_block(qflat, scales, "b", "n.conv1")
    xb = _i8(rng, (3, 14, 14, 128), lo=0).to(dev)
    assert torch.equal(basic_block_fused(xb, pack), basic_block_plain(xb, pack))


@pytest.mark.gpu
def test_bottleneck_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    # (H, C4, CM): a partial 8x8 tile edge (12), the 7x7 stage, CM = 64 and 512
    for h, c4, cm in [(12, 256, 64), (7, 512, 128), (7, 2048, 512)]:
        flat = {}
        for name, shape in (("b.conv1", (1, 1, c4, cm)), ("b.conv2", (3, 3, cm, cm)),
                            ("b.conv3", (1, 1, cm, c4))):
            flat[name] = {"w": torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32)),
                          "b": torch.from_numpy(rng.normal(0, 0.2, shape[-1]).astype(np.float32))}
        qflat = {n: {"qw": p["qw"].to(dev), "b": p["b"].to(dev)}
                 for n, p in quantize_weights(flat, INT8_PER_CHANNEL).items()}
        scales = {n: torch.tensor(v, dtype=torch.float32, device=dev)
                  for n, v in (("b.conv1", 0.05), ("b.conv2", 0.08), ("b.conv3", 0.04),
                               ("n.conv1", 0.07))}
        pack = pack_bottleneck_block(qflat, scales, "b", "n.conv1")
        x = _i8(rng, (3, h, h, c4), lo=0).to(dev)
        assert torch.equal(bottleneck_block_fused(x, pack), bottleneck_block_plain(x, pack))


def _vit_block(rng, dp, hp, dev):
    """One packed W8A8 ViT layer at Dp/Hp (K-major int8 weights, folded
    scales near unit outputs, biases, LN rows zero past d_valid)."""
    def w(n, k):
        return _i8(rng, (n, k)).to(dev)

    def s(n, k):
        return torch.from_numpy((rng.uniform(0.5, 1.5, n) / (60.0 * 73.0 * np.sqrt(k)))
                                .astype(np.float32)).to(dev)

    def b(n):
        return torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(dev)

    ln = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)])
                          .astype(np.float32)).to(dev)
    return {"inv_act": (40.0, 30.0, 40.0, 30.0),
            "wqkv": w(3 * dp, dp), "sqkv": s(3 * dp, dp), "bqkv": b(3 * dp),
            "wproj": w(dp, dp), "sproj": s(dp, dp), "bproj": b(dp), "ln1": ln, "ln2": ln.clone(),
            "wfc1": w(hp, dp), "sfc1": s(hp, dp), "bfc1": b(hp),
            "wfc2": w(dp, hp), "sfc2": s(dp, hp), "bfc2": b(dp)}


def _agree(got, ref, min_equal, atol, near=0.0):
    """Kernel vs plain version: the kernel sums in another order than
    PyTorch, so a value on a rounding boundary (an int8 code, a bf16 step)
    may land one step apart; held to ``min_equal`` of the elements equal
    (or, with ``near``, within near * (1 + |ref|): an fp32 output of fp32
    sums) and ``atol`` at most."""
    g, r = got.float(), ref.float()
    eq = float(((g - r).abs() <= near * (1.0 + r.abs())).float().mean())
    err = float((g - r).abs().max())
    assert eq >= min_equal and err <= atol, (eq, err)


@pytest.mark.gpu
def test_vit_kernels_on_card():
    """K5, K6, K7 against their plain versions: Dp 128 with d_valid 96
    (pad lanes), 3 heads of 32 in Dp 128 (a pad-head slot), and Dp 192 /
    hd 64; 3 x 24 = 72 and 2 x 200 = 400 rows (not multiples of the 64-row
    tiles); n_valid < rows (masked keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_plain
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w8, vit_block_pre_plain, vit_block_pre_w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    for (bsz, rows, d, dp, hp, heads) in [(3, 24, 96, 128, 384, 3), (2, 200, 192, 192, 768, 3)]:
        n_valid = rows - 3
        blk = _vit_block(rng, dp, hp, dev)
        blk["ln1"][:, d:] = 0
        blk["ln2"][:, d:] = 0
        yn = rng.normal(0, 1, (bsz, rows, dp)).astype(np.float32)
        yn[..., d:] = 0
        for dt in (torch.bfloat16, torch.float32):
            y = torch.from_numpy(yn).to(dev, dt)
            _agree(vit_block_pre_w8(y, blk, d), vit_block_pre_plain(y, blk, d), 0.99, 0.25)
        qkv = vit_block_pre_plain(torch.from_numpy(yn).to(dev), blk, d)
        hd = d // heads
        views = (qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d])
        a = mhsa(*views, heads, n_valid, out_lanes=dp)
        _agree(a, mhsa_plain(*views, heads, n_valid, out_lanes=dp), 0.99, 0.05)
        assert not a[..., heads * hd:].float().abs().any()
        for dt, out_dt, multi in ((torch.bfloat16, torch.float32, True),
                                  (torch.float32, torch.bfloat16, True),
                                  (torch.bfloat16, torch.bfloat16, False)):
            y = torch.from_numpy(yn).to(dev, dt)
            got = vit_block_post_w8(y, a, blk, d, True, out_dt, multi)
            assert got.dtype == out_dt
            _agree(got, vit_block_post_plain(y, a, blk, d, True, out_dt, multi), 0.95, 0.25)


@pytest.mark.gpu
def test_w4a8_kernels_on_card():
    """K8, K9 and K10 against their plain versions. K8/K9: Dp 128 with
    d_valid 96 (Kp/2 = 64, pad lanes) and Dp 192 (Kp/2 = 96, not a multiple
    of K5/K7's 64-byte stage), 72 and 400 rows. K10 (bit-identical, the
    int32 sums are exact): K = 192 (Kp/2 = 96), K = 96 (padded to Kp 128),
    K = 10 (the byte path), N = 64 (the 128 x 64 tile) and N = 1000, relu on
    and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import mhsa_plain
    from dlq_tpu_torch.ops.matmul_int4a8 import (
        matmul_int4a8, matmul_int4a8_plain, pack_halves_kmajor, pack_int4a8_weight,
    )
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w4a8, vit_block_pre_plain, vit_block_pre_w4a8,
    )
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL
    from dlq_tpu_torch.quant.quantize import quantize_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for (bsz, rows, d, dp, hp, heads) in [(3, 24, 96, 128, 384, 3), (2, 200, 192, 192, 768, 3)]:
        blk = _vit_block(rng, dp, hp, dev)
        for name, (n, k) in (("wqkv", (3 * dp, dp)), ("wproj", (dp, dp)), ("wfc1", (hp, dp)),
                             ("wfc2", (dp, hp))):
            w = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
            blk[name] = pack_halves_kmajor(w, k, n).to(dev)
            s = blk["s" + name[1:]]
            s.mul_(73.0 / 4.6)   # int4 weights: rms ~4.6 against int8's ~73
        blk["ln1"][:, d:] = 0
        blk["ln2"][:, d:] = 0
        yn = rng.normal(0, 1, (bsz, rows, dp)).astype(np.float32)
        yn[..., d:] = 0
        for dt in (torch.bfloat16, torch.float32):
            y = torch.from_numpy(yn).to(dev, dt)
            _agree(vit_block_pre_w4a8(y, blk, d), vit_block_pre_plain(y, blk, d), 0.99, 0.25)
        qkv = vit_block_pre_plain(torch.from_numpy(yn).to(dev), blk, d)
        a = mhsa_plain(qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d], heads,
                       rows - 3, out_lanes=dp)
        for dt, out_dt, multi in ((torch.bfloat16, torch.float32, True),
                                  (torch.float32, torch.bfloat16, True),
                                  (torch.bfloat16, torch.bfloat16, True),
                                  (torch.float32, torch.float32, False)):
            y = torch.from_numpy(yn).to(dev, dt)
            got = vit_block_post_w4a8(y, a, blk, d, True, out_dt, multi)
            assert got.dtype == out_dt
            _agree(got, vit_block_post_plain(y, a, blk, d, True, out_dt, multi), 0.95, 0.25)
    for (m, k, n, relu) in [(300, 192, 576, False), (37, 96, 1000, True), (300, 128, 64, True),
                            (50, 10, 20, False), (129, 768, 192, True)]:
        qw = quantize_tensor(torch.from_numpy(rng.normal(0, 0.1, (k, n)).astype(np.float32)),
                             INT4A8_PER_CHANNEL.weights)
        pk = pack_int4a8_weight(qw.to(dev))
        x = _i8(rng, (m, k)).to(dev)
        scale, bias = _epi(rng, n, k, dev)
        args = (x, pk, scale * 16.0, bias, relu)
        assert torch.equal(matmul_int4a8(*args), matmul_int4a8_plain(*args))


@pytest.mark.gpu
def test_w4a16_kernels_on_card():
    """K11, K12 and K13 against their plain versions (fp32 sums in another
    order: bf16 outputs >= 0.99 equal, fp32 outputs >= 0.99 within 2^-12 of
    their unit-plus-magnitude scale, all within 0.25). K11/K12: Dp 128 with
    d_valid 96 (Kp/2 = 64, pad lanes) and Dp 192 (Kp/2 = 96), 72 and 400
    rows, every dtype form. K13 (each output within 2^-14 of the sum of its
    products' magnitudes): group 128 at K = 768 (the DeiT sites), group 64
    at K = 256, group 16 at K = 48 (a zero-padded last stage), M = 300 and
    37 (no multiples of the 128-row tile), N = 192, 1000 and 21 (odd), relu
    on and off, bias and none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import mhsa_plain
    from dlq_tpu_torch.ops.matmul_int4 import (
        dequantize_bf16, matmul_int4, matmul_int4_plain, pack_int4_weight,
    )
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_w4, vit_block_post_w4_plain, vit_block_pre_w4, vit_block_pre_w4_plain,
    )
    from dlq_tpu_torch.quant.qconfig import QScheme
    from dlq_tpu_torch.quant.quantize import quantize_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for (bsz, rows, d, dp, hp, heads) in [(3, 24, 96, 128, 384, 3), (2, 200, 192, 192, 768, 3)]:
        blk = _vit_block(rng, dp, hp, dev)
        del blk["inv_act"]
        for name, (n, k) in (("wqkv", (3 * dp, dp)), ("wproj", (dp, dp)), ("wfc1", (hp, dp)),
                             ("wfc2", (dp, hp))):
            w = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
            blk[name] = pack_halves_kmajor(w, k, n).to(dev)
            blk["s" + name[1:]].mul_(73.0 / 4.6)   # int4 weights: rms ~4.6 against int8's ~73
        blk["ln1"][:, d:] = 0
        blk["ln2"][:, d:] = 0
        yn = rng.normal(0, 1, (bsz, rows, dp)).astype(np.float32)
        yn[..., d:] = 0
        for dt in (torch.bfloat16, torch.float32):
            y = torch.from_numpy(yn).to(dev, dt)
            _agree(vit_block_pre_w4(y, blk, d), vit_block_pre_w4_plain(y, blk, d), 0.99, 0.25)
        qkv = vit_block_pre_w4_plain(torch.from_numpy(yn).to(dev), blk, d)
        a = mhsa_plain(qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d], heads,
                       rows - 3, out_lanes=dp)
        for dt, out_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                           (torch.float32, torch.float32), (torch.float32, torch.bfloat16)):
            y = torch.from_numpy(yn).to(dev, dt)
            got = vit_block_post_w4(y, a, blk, d, True, out_dt)
            assert got.dtype == out_dt
            near = 2.0 ** -12 if out_dt == torch.float32 else 0.0
            _agree(got, vit_block_post_w4_plain(y, a, blk, d, True, out_dt), 0.99, 0.25, near)
    for (m, k, n, g, relu, bias) in [(300, 768, 192, 128, False, True), (37, 256, 1000, 64, True, False),
                                     (129, 48, 21, 16, True, True)]:
        qw = quantize_tensor(torch.from_numpy(rng.normal(0, 0.1, (k, n)).astype(np.float32)),
                             QScheme(4, True, -1, group=g))
        pk = pack_int4_weight(qw.to(dev))
        x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev) if bias else None
        got = matmul_int4(x, pk, b, relu)
        ref = matmul_int4_plain(x, pk, b, relu)
        mag = x.double().abs() @ dequantize_bf16(pk).double().abs()
        assert ((got.double() - ref.double()).abs() <= 2.0 ** -14 * mag + 1e-30).all()


def _bf16_block(rng, dp, hp, d, dev):
    """One bf16 ViT layer as ``pack_vit_blocks`` packs it: bf16 K-major
    weights (std putting the products near unit scale), zero past d_valid in
    K; fp32 biases and LN rows zero past d_valid."""
    def w(n, k):
        a = rng.normal(0, 1.0 / np.sqrt(k), (n, k)).astype(np.float32)
        a[:, d if k == dp else k:] = 0
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    def b(n):
        return torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(dev)

    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    ln = torch.from_numpy(ln).to(dev)
    return {"wqkv": w(3 * dp, dp), "bqkv": b(3 * dp), "wproj": w(dp, dp), "bproj": b(dp),
            "ln1": ln, "ln2": ln.clone(), "wfc1": w(hp, dp), "bfc1": b(hp),
            "wfc2": w(dp, hp), "bfc2": b(dp)}


@pytest.mark.gpu
def test_bf16_block_kernels_on_card():
    """K14 and K15 against their plain versions (fp32 sums in another order:
    bf16 outputs >= 0.99 equal, fp32 outputs >= 0.99 within 2^-12 of their
    unit-plus-magnitude scale, all within 0.25): Dp 128 with d_valid 96 (pad
    lanes, a pad head slot), the tight Dp 192 and the loose Dp 256 (216 KB of
    K15 shared memory), 72, 400 and 512 rows, every dtype form; then K6 at
    the loose pads' 256 rows (its 32-tile score rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_plain
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_bf16, vit_block_post_bf16_plain, vit_block_pre_bf16,
        vit_block_pre_bf16_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for (bsz, rows, d, dp, hp, heads) in [(3, 24, 96, 128, 384, 3), (2, 200, 192, 192, 768, 3),
                                          (2, 256, 192, 256, 768, 3)]:
        blk = _bf16_block(rng, dp, hp, d, dev)
        yn = rng.normal(0, 1, (bsz, rows, dp)).astype(np.float32)
        yn[..., d:] = 0
        for dt in (torch.bfloat16, torch.float32):
            y = torch.from_numpy(yn).to(dev, dt)
            _agree(vit_block_pre_bf16(y, blk, d), vit_block_pre_bf16_plain(y, blk, d), 0.99, 0.25)
        qkv = vit_block_pre_bf16_plain(torch.from_numpy(yn).to(dev), blk, d)
        views = (qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d])
        n_valid = min(rows - 3, 197)
        a = mhsa(*views, heads, n_valid, out_lanes=dp)
        _agree(a, mhsa_plain(*views, heads, n_valid, out_lanes=dp), 0.99, 0.05)
        for dt, out_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                           (torch.float32, torch.float32), (torch.float32, torch.bfloat16)):
            y = torch.from_numpy(yn).to(dev, dt)
            got = vit_block_post_bf16(y, a, blk, d, True, out_dt)
            assert got.dtype == out_dt
            near = 2.0 ** -12 if out_dt == torch.float32 else 0.0
            _agree(got, vit_block_post_bf16_plain(y, a, blk, d, True, out_dt), 0.99, 0.25, near)


@pytest.mark.gpu
def test_layernorm_kernels_on_card():
    """K16 and K17 against their plain versions: D 192 (DeiT), 100 (the
    reference test's, no multiple of 32) and 600 (past the registers: the
    two-read form); every dtype of x / y and delta, g and b in the
    stream's. fp32 outputs
    within 2^-19 of 1 + |plain| (rsqrtf and the lane-order sums: a few ulp),
    bf16 outputs >= 0.99 equal and none more than one step (2^-7 at the
    unit scale) apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.layernorm import (
        layernorm_fused, layernorm_fused_plain, residual_layernorm, residual_layernorm_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def held(got, ref):
        assert got.dtype == ref.dtype
        if got.dtype == torch.float32:
            _agree(got, ref, 1.0, 1e-4, 2.0 ** -19)
        else:
            _agree(got, ref, 0.99, 2.0 ** -7 * (1.0 + float(ref.float().abs().max())))

    for shape in ((3, 101, 192), (37, 100), (50, 600)):
        d = shape[-1]
        xn = rng.normal(0.3, 1.0, shape).astype(np.float32)
        dn = rng.normal(0, 0.5, shape).astype(np.float32)
        gn, bn = rng.uniform(0.5, 1.5, d).astype(np.float32), rng.normal(0, 0.1, d).astype(np.float32)
        for xdt in (torch.float32, torch.bfloat16):
            g, b = (torch.from_numpy(v).to(dev, xdt) for v in (gn, bn))
            x = torch.from_numpy(xn).to(dev, xdt)
            held(layernorm_fused(x, g, b), layernorm_fused_plain(x, g, b))
            for ddt in (torch.float32, torch.bfloat16):
                dl = torch.from_numpy(dn).to(dev, ddt)
                z, h = residual_layernorm(x, dl, g, b)
                zp, hp = residual_layernorm_plain(x, dl, g, b)
                assert torch.equal(z, zp)
                held(h, hp)


@pytest.mark.gpu
def test_mhsa_f32_and_routing_on_card():
    """K6's fp32 form against the plain version (fp32 products and sums in
    another order: within 1e-5 of each output, the outputs being averages of
    unit-scale V rows): hd 32 and 64, 24, 197 and 256 rows, masked keys, pad
    lanes zero, lane-slice views of one [B, N, 3D] tensor; mixed dtypes
    raise. Then a group-wise int4 dense whose group (24 at K = 96) K13 does
    not take: the dequantized route, no K13 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops import qops
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_f32, mhsa_plain
    from dlq_tpu_torch.ops.matmul_int4 import matmul_int4
    from dlq_tpu_torch.quant.qconfig import QScheme
    from dlq_tpu_torch.quant.quantize import dequantize, quantize_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for (bsz, rows, heads, hd, lanes) in [(3, 24, 3, 32, 128), (2, 197, 3, 64, 192),
                                          (2, 256, 3, 64, 256)]:
        qkv = torch.from_numpy(rng.normal(0, 1, (bsz, rows, 3 * heads * hd)).astype(np.float32))
        qkv = qkv.to(dev)
        hw = heads * hd
        views = (qkv[..., :hw], qkv[..., hw: 2 * hw], qkv[..., 2 * hw:])
        n_valid = rows - 3
        before = mhsa_f32.launches
        got = mhsa(*views, heads, n_valid, out_lanes=lanes)
        assert got.dtype == torch.float32 and mhsa_f32.launches == before + 1
        ref = mhsa_plain(*views, heads, n_valid, out_lanes=lanes)
        assert float((got - ref).abs().max()) <= 1e-5
        assert not got[..., hw:].abs().any()
    with pytest.raises(ValueError, match="share a dtype"):
        mhsa(views[0], views[1], views[2].to(torch.bfloat16), heads, n_valid)
    qw = quantize_tensor(torch.from_numpy(rng.normal(0, 0.1, (96, 40)).astype(np.float32)),
                         QScheme(4, True, -1, group=24)).to(dev)
    assert qops.weight_only_packed(qw) is None
    x = torch.from_numpy(rng.normal(0, 1, (33, 96)).astype(np.float32)).to(dev)
    before = matmul_int4.launches
    y = qops.qdense(x, qw, None)
    assert matmul_int4.launches == before
    ref = x.double() @ dequantize(qw).double()
    assert float((y.double() - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_int8_attention_on_card():
    """K18 against its plain version in both forms: the in-kernel form on
    lane slices of a bf16 [B, Np, 3·Dp] block stream (hd 32 with a pad-head
    slot, hd 64), and the zero-pad form on fp32 and bf16 lane slices of a
    [B, N, 3·D] qkv dense, masked and not; >= 0.99 of the outputs equal, the
    rest within 2·av/127 (av: the (sample, head)'s V amax); the pad lanes
    zero; one launch counted per call, none for the plain version, and a
    CUDA tensor never reaches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops import int8_attention as TI

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)

    def held(got, ref, v, heads, n_valid, zero_pad):
        hw = v.shape[-1]
        vv = v.float()[:, :n_valid] if zero_pad else v.float()
        av = vv.reshape(v.shape[0], -1, heads, hw // heads).abs().amax(dim=(1, 3))
        av = av.repeat_interleave(hw // heads, dim=1)[:, None, :]
        d = (got[..., :hw].float() - ref[..., :hw].float()).abs()
        assert float((d == 0).float().mean()) >= 0.99
        assert bool((d <= 2.0 * av / 127.0).all())

    plain = TI.mhsa_i8_plain
    TI.mhsa_i8_plain = None     # a CUDA tensor must launch K18, never the plain version
    try:
        cases = [(3, 24, 3, 32, 128, torch.bfloat16, False, 17, torch.bfloat16),
                 (2, 200, 3, 64, 192, torch.bfloat16, False, 197, torch.bfloat16),
                 (2, 256, 3, 64, 256, torch.bfloat16, True, 197, torch.bfloat16),
                 (2, 197, 3, 64, 192, torch.float32, True, 197, torch.float32),
                 (3, 24, 3, 32, 96, torch.float32, True, 20, torch.bfloat16)]
        outs = []
        for (bsz, rows, heads, hd, dp, dt, zero_pad, n_valid, odt) in cases:
            qkv = torch.from_numpy(rng.normal(0, 1.5, (bsz, rows, 3 * dp)).astype(np.float32))
            qkv = qkv.to(dev, dt)
            hw = heads * hd
            views = (qkv[..., :hw], qkv[..., dp: dp + hw], qkv[..., 2 * dp: 2 * dp + hw])
            before = TI.mhsa_i8.launches
            got = TI.mhsa_i8(*views, heads, n_valid, out_lanes=dp, zero_pad=zero_pad,
                             out_dtype=odt)
            torch.cuda.synchronize()
            assert TI.mhsa_i8.launches == before + 1 and got.dtype == odt
            assert not got[..., hw:].float().abs().any()
            outs.append((got, views, heads, n_valid, dp, zero_pad, odt))
    finally:
        TI.mhsa_i8_plain = plain
    for got, views, heads, n_valid, dp, zero_pad, odt in outs:
        before = TI.mhsa_i8.launches
        ref = plain(*views, heads, n_valid, dp, zero_pad, odt)
        assert TI.mhsa_i8.launches == before
        held(got, ref, views[2], heads, n_valid, zero_pad)


@pytest.mark.gpu
def test_probe_kernels_on_card():
    """K19-K22: each of the 23 probe patterns on the card, on the probe's own
    inputs, launches its kernel (one count per call) and never the plain
    version; then the kernel against the plain version (_probe.held:
    bit-identical where the pattern is exact, else by the pattern's own
    limit) and against the reference's numpy expectation with the
    reference's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import importlib

    from dlq_tpu_torch.tools import _probe

    dev = torch.device("cuda")
    n = 0
    for mod_name, name in (("probe_mosaic_patterns", "probe_mosaic"),
                           ("probe_batched_dot", "probe_batched_dot"),
                           ("probe_block_patterns", "probe_block"),
                           ("probe_stem_patterns", "probe_stem")):
        mod = importlib.import_module(f"dlq_tpu_torch.tools.{mod_name}")
        fn = getattr(mod, name)
        plain = dict(mod.PLAIN)

        def refuse(*xs):
            raise AssertionError("a CUDA tensor reached a plain version")

        outs = []
        try:
            for key in mod.PLAIN:
                mod.PLAIN[key] = refuse
            for key, inputs, expect in mod.cases():
                xs = tuple(x.to(dev) for x in inputs)
                before = fn.launches
                got = fn(key, *xs)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                outs.append((key, xs, expect, got))
        finally:
            mod.PLAIN.update(plain)
        for key, xs, expect, got in outs:
            spec = mod.SPEC[key]
            same, text, _ = _probe.held(got, mod.PLAIN[key](*xs), spec)
            assert same, f"{name} {key}: {text}"
            ok, text = mod.CHECK(got, expect, spec.atol)
            assert ok, f"{name} {key}: {text}"
            n += 1
    assert n == 23


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("rows", [1, 17, 64, 65, 197, 200, 256])
def test_mhsa_persistent_walk_on_card(rows, hd):
    """K6 against its plain version at every row count its query tiles and
    key chunks split differently (one row, a partial 16-row tile, a whole
    64-key chunk and one key past it, DeiT's 197 and 200, the loose 256):
    n_valid < rows (masked keys); q/k/v as lane slices of one [B, N, 3 Dp]
    stream with out_lanes = Dp > heads * hd (pad lanes zero), and as three
    separate tensors; B * heads below and well above two items per SM
    (132 SMs), so the persistent walk runs one item and several per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import ctypes

    from dlq_tpu_torch import _build
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_plain, mhsa_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(100 + rows + hd)
    heads = 3
    hw = heads * hd
    dp = (hw + 63) // 64 * 64 + 64   # lanes past the last head
    n_valid = max(1, rows - 3)
    for bsz in (2, 200):
        x = torch.from_numpy(rng.normal(0, 1.5, (bsz, rows, 3 * dp)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        forms = [((x[..., :hw], x[..., dp: dp + hw], x[..., 2 * dp: 2 * dp + hw]), dp),
                 (tuple(t.contiguous() for t in (x[..., :hw], x[..., dp: dp + hw],
                                                 x[..., 2 * dp: 2 * dp + hw])), None)]
        for views, lanes in forms:
            before, shape = mhsa.launches, mhsa.by_shape[(bsz, rows, heads, hd, n_valid)]
            got = mhsa(*views, heads, n_valid, out_lanes=lanes)
            assert mhsa.launches == before + 1
            assert mhsa.by_shape[(bsz, rows, heads, hd, n_valid)] == shape + 1
            ref = mhsa_plain(*views, heads, n_valid, out_lanes=lanes)
            assert got.shape == ref.shape and got.dtype == torch.bfloat16
            _agree(got, ref, 0.99, 0.05)
            assert not got[..., hw:].float().abs().any()
    out = (ctypes.c_int * 2)()
    fn = _build.library("mhsa").dlq_mhsa_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    _build.check(fn(rows, n_valid, hd, ctypes.cast(out, ctypes.c_void_p)), "mhsa_plan")
    assert tuple(out) == mhsa_plan(rows, n_valid, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200])
def test_vit_post_w8_persistent_tiles_on_card(m, dp):
    """K7 against its plain version at row counts on both sides of its
    64-row warpgroup halves and 128-row tiles (1, 63, 64, 65, 72, 400) and
    at DeiT-Tiny batch 256 (51,200 rows: about 388 rows a block on 132
    SMs, so each block's last tile is short), Dp 128/192/256 with d_valid
    < Dp (pad lanes), every residual/output dtype pair, both FC2
    associations and both GELUs; then the launch plan the kernel takes
    against ``vit_post_w8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import ctypes

    from dlq_tpu_torch import _build
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w8, vit_post_w8_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 + m + dp)
    d, hp = dp - 32, 384
    blk = _vit_block(rng, dp, hp, dev)
    for k in ("wproj", "wfc1"):
        blk[k][:, d:] = 0
    for k in ("wproj", "sproj", "bproj", "wfc2", "sfc2", "bfc2"):
        blk[k][d:] = 0
    blk["ln2"][:, d:] = 0
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    attn = torch.from_numpy(rng.normal(0, 1, (1, m, dp)).astype(np.float32)).to(dev, torch.bfloat16)
    for din in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, din)
        for dout in (torch.bfloat16, torch.float32):
            for multi in (False, True):
                for tanh in (False, True):
                    got = vit_block_post_w8(y, attn, blk, d, tanh, dout, multi)
                    assert got.dtype == dout and got.shape == y.shape
                    _agree(got, vit_block_post_plain(y, attn, blk, d, tanh, dout, multi), 0.95, 0.25)
    out = (ctypes.c_int * 4)()
    fn = _build.library("vit_post_w8").dlq_vit_post_w8_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    _build.check(fn(dp, hp, m, 0, ctypes.cast(out, ctypes.c_void_p)), "vit_post_w8_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tuple(out) == vit_post_w8_plan(dp, hp, m, sms)


def _plan_on_card(lib: str, name: str, args):
    """A kernel library's own launch plan (its C entry ``dlq_<name>``)."""
    import ctypes

    from dlq_tpu_torch import _build

    out = (ctypes.c_int * 5)()
    fn = getattr(_build.library(lib), f"dlq_{name}")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    _build.check(fn(*args, ctypes.cast(out, ctypes.c_void_p)), name)
    return tuple(out)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [18, 192, 768])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 50432])
def test_matmul_int4a8_persistent_walk_on_card(m, k):
    """K10 bit-identical to its plain version (exact int32 sums) at row
    counts on both sides of its 128-row items and at DeiT-Tiny batch 256
    (50,432 rows: 394 tiles, so every block walks several items), K = 18
    (A rows not 16-byte aligned: the first form), 192 and 768, N = 1, 63,
    64, 192, 576 and 1000 (one slice to 16; N % 4 != 0 takes scalar stores), relu on and off;
    then the launch plan the kernel takes against ``matmul_int4a8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.matmul_int4a8 import (
        PackedInt4, matmul_int4a8, matmul_int4a8_plain, pack_halves_kmajor,
    )
    from dlq_tpu_torch.ops.w4plan import matmul_int4a8_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(2000 + m + k)
    kp = -(-k // 64) * 64
    x = _i8(rng, (m, k)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (1, 63, 64, 192, 576, 1000):
        w = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
        pk = PackedInt4(pack_halves_kmajor(w, kp, n).to(dev), k)
        scale, bias = _epi(rng, n, k, dev)
        for relu in (False, True):
            before = matmul_int4a8.launches
            got = matmul_int4a8(x, pk, scale * 16.0, bias, relu)
            assert matmul_int4a8.launches == before + 1
            assert torch.equal(got, matmul_int4a8_plain(x, pk, scale * 16.0, bias, relu))
        assert _plan_on_card("matmul_int4a8", "matmul_int4a8_plan", (m, n, kp, 0)) == \
            matmul_int4a8_plan(m, n, kp, sms)


@pytest.mark.gpu
@pytest.mark.parametrize("k,g", [(16, 16), (192, 16), (192, 32), (192, 128), (768, 16),
                                 (768, 32), (768, 128)])
@pytest.mark.parametrize("m", [1, 127, 129, 50432])
def test_matmul_int4_persistent_walk_on_card(m, k, g):
    """K13 against its plain version, each output within 2^-14 of the sum of
    its products' magnitudes (fp32 sums in another order), at K = 16, 192
    and 768 with groups of 16, 32 and 128 (a last group past K at K 192,
    g 128), ragged M (1, 127, 129) and DeiT-Tiny batch 256 (50,432 rows:
    394 tiles), N = 1, 21, 192 and 1000, relu on and off, bias and none;
    then the launch plan the kernel takes against ``matmul_int4_plan``. The
    packed weight and its bf16 scales are random bytes (zero past K)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.matmul_int4 import (
        PackedInt4G, dequantize_bf16, matmul_int4, matmul_int4_plain,
    )
    from dlq_tpu_torch.ops.w4plan import matmul_int4_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(3000 + m + k + g)
    kp = -(-k // 64) * 64
    groups = -(-kp // g)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, relu, with_bias in ((1, True, True), (21, False, False), (192, False, True),
                               (1000, True, True)):
        wp = rng.integers(0, 256, (n, kp // 2)).astype(np.uint8)
        wp[:, k // 2:] = 0
        sc = rng.uniform(0.005, 0.015, (n, groups)).astype(np.float32)
        pk = PackedInt4G(torch.from_numpy(wp).to(dev),
                         torch.from_numpy(sc).to(dev, torch.bfloat16), k, g)
        b = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev) if with_bias else None
        before = matmul_int4.launches
        got = matmul_int4(x, pk, b, relu)
        assert matmul_int4.launches == before + 1
        ref = matmul_int4_plain(x, pk, b, relu)
        mag = x.double().abs() @ dequantize_bf16(pk).double().abs()
        assert ((got.double() - ref.double()).abs() <= 2.0 ** -14 * mag + 1e-30).all()
        assert _plan_on_card("matmul_int4", "matmul_int4_plan", (m, n, kp, groups, 0)) == \
            matmul_int4_plan(m, n, kp, groups, sms)


@pytest.mark.gpu
def test_int4_first_forms_on_card():
    """The first forms of K10 and K13 (the block-tile kernels that serve a
    Kp whose 64-column packed slice does not fit beside the Hopper form's
    ring, and K10's K % 16 != 0, held in the persistent-walk test at K =
    18): K = 8192 (K13 with groups of 16, 512 scales a column), ragged M
    and N, against the plain versions as the other card tests hold them;
    both plans say 0 there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.matmul_int4 import (
        PackedInt4G, dequantize_bf16, matmul_int4, matmul_int4_plain,
    )
    from dlq_tpu_torch.ops.matmul_int4a8 import (
        PackedInt4, matmul_int4a8, matmul_int4a8_plain, pack_halves_kmajor,
    )
    from dlq_tpu_torch.ops.w4plan import matmul_int4_plan, matmul_int4a8_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(4000)
    m, k, n, g = 129, 8192, 70, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert matmul_int4a8_plan(m, n, k, sms)[0] == 0
    assert _plan_on_card("matmul_int4a8", "matmul_int4a8_plan", (m, n, k, 0))[0] == 0
    x = _i8(rng, (m, k)).to(dev)
    w = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
    pk = PackedInt4(pack_halves_kmajor(w, k, n).to(dev), k)
    scale, bias = _epi(rng, n, k, dev)
    for relu in (False, True):
        assert torch.equal(matmul_int4a8(x, pk, scale * 16.0, bias, relu),
                           matmul_int4a8_plain(x, pk, scale * 16.0, bias, relu))
    groups = k // g
    assert matmul_int4_plan(m, n, k, groups, sms)[0] == 0
    assert _plan_on_card("matmul_int4", "matmul_int4_plan", (m, n, k, groups, 0))[0] == 0
    wp = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    sc = rng.uniform(0.005, 0.015, (n, groups)).astype(np.float32)
    pk4 = PackedInt4G(torch.from_numpy(wp).to(dev), torch.from_numpy(sc).to(dev, torch.bfloat16), k, g)
    xb = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
    got, ref = matmul_int4(xb, pk4, b, True), matmul_int4_plain(xb, pk4, b, True)
    mag = xb.double().abs() @ dequantize_bf16(pk4).double().abs()
    assert ((got.double() - ref.double()).abs() <= 2.0 ** -14 * mag + 1e-30).all()
