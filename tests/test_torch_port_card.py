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


def _bottleneck_pack(rng, c4, cm, dev):
    """One identity Bottleneck's pack from seeded fp32 weights quantized
    per channel and fixed site scales."""
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
    return pack_bottleneck_block(qflat, scales, "b", "n.conv1")


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,c4,cm", [
    (2, 56, 256, 64), (2, 28, 512, 128), (3, 14, 1024, 256), (3, 7, 2048, 512),
    (2, 13, 512, 128), (3, 12, 256, 64), (5, 7, 512, 64), (1, 20, 256, 512),
])
def test_bottleneck_hopper_on_card(n, h, c4, cm):
    """K4's Hopper form bit-identical to its plain version at every
    ResNet-50 stage at small batch (56^2: strips of 2 rows, resident
    weights; 28^2 and 14^2: strips of 4 and 7 rows, streamed weights; 7^2:
    two images an item, an odd batch leaving the last item one image), a
    partial last strip (13^2), 12^2, CM 64 and 512 at other widths; inputs
    over the whole int8 range (the skip of a negative input) and post-relu;
    every launch takes the Hopper form (its counter), and the plan and
    geometry the kernel takes equal ``bottleneck_plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.block_fused import (
        bottleneck_form, bottleneck_geometry, bottleneck_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(9800 + n + h + c4 + cm)
    pack = _bottleneck_pack(rng, c4, cm, dev)
    assert bottleneck_form(h, h, c4, cm) == "hopper"
    for lo in (0, -127):
        x = _i8(rng, (n, h, h, c4), lo=lo).to(dev)
        before = bottleneck_block_fused.by_form["hopper"]
        got = bottleneck_block_fused(x, pack)
        assert bottleneck_block_fused.by_form["hopper"] == before + 1
        ref = bottleneck_block_plain(x, pack)
        assert torch.equal(got, ref), (lo, int((got != ref).sum()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = (*bottleneck_plan(n, h, h, c4, cm, sms), *bottleneck_geometry(h, h))
    assert _plan_on_card_n("bottleneck_block", "bottleneck_block_plan",
                           (n, h, h, c4, cm, 0), 15) == want


@pytest.mark.gpu
def test_bottleneck_first_form_on_card():
    """K4's first form by the static rule (an output grid wider than 128:
    W = 130) bit-identical to its plain version, counted as such."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.block_fused import bottleneck_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(9900)
    pack = _bottleneck_pack(rng, 64, 64, dev)
    x = _i8(rng, (1, 130, 130, 64), lo=0).to(dev)
    assert bottleneck_form(130, 130, 64, 64) == "first"
    before = bottleneck_block_fused.by_form["first"]
    assert torch.equal(bottleneck_block_fused(x, pack), bottleneck_block_plain(x, pack))
    assert bottleneck_block_fused.by_form["first"] == before + 1


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


PROBES = (("probe_mosaic_patterns", "probe_mosaic"), ("probe_batched_dot", "probe_batched_dot"),
          ("probe_block_patterns", "probe_block"), ("probe_stem_patterns", "probe_stem"))


def _probe_mods():
    import importlib

    return [(importlib.import_module(f"dlq_tpu_torch.tools.{m}"), n) for m, n in PROBES]


@pytest.mark.gpu
def test_probe_hopper_forms_equal_first_forms_on_card():
    """The redesigned probe patterns, all 23 (K19 6 and K20 D on
    attention_kernel, K19 3 and K20 A on nt_dot_hopper_kernel, K20 B on
    nn_dot_hopper_kernel, K21 D on double_conv_cluster_kernel, K22 E on
    int_dot_hopper_kernel, K22 J on cols_kernel, K22 K on maxpool_kernel,
    K21 O on requant_kernel, K19 5 on tanh_kernel, the 12 copy patterns on
    stage_kernel) on their Hopper forms equal to their first forms on every
    output, the copies also to their plain versions; the launches counted
    by form: the wrapper's launch on .launches and .by_form["hopper"],
    .first on .by_form["first"] only, a pattern with one form (none is
    left) on neither form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    n = 0
    for mod, name in _probe_mods():
        fn = getattr(mod, name)
        for key, inputs, _ in mod.cases():
            xs = tuple(x.to(dev) for x in inputs)
            launches, forms = fn.launches, dict(fn.by_form)
            got = fn(key, *xs)
            if key not in mod.FIRST_FORMS:
                assert (fn.launches, dict(fn.by_form)) == (launches + 1, forms), (name, key)
                with pytest.raises(KeyError):
                    fn.first(key, *xs)
                continue
            first = fn.first(key, *xs)
            torch.cuda.synchronize()
            assert fn.launches == launches + 1
            assert fn.by_form["hopper"] == forms.get("hopper", 0) + 1
            assert fn.by_form["first"] == forms.get("first", 0) + 1
            assert torch.equal(got, first), (name, key, int((got != first).sum()))
            if key in mod.WINDOWS:
                assert torch.equal(got, mod.PLAIN[key](*xs)), (name, key)
            n += 1
    assert n == 23


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_nn_dot_and_double_conv_hopper_on_card(seed):
    """K20 B's and K21 D's Hopper forms on the probe's own inputs (seed 0)
    and on other draws (seeds 1, 2: K20 B's a and v from a normal draw; K21
    D's slab and weights over the whole int8 range, so h and out clip at
    both ends): K21 D identical to double_conv_plain and to its first form,
    K20 B within _probe.held's fp32 limit (1e-4 of max|plain|) and equal to
    its first form; each launch counted once on .launches and
    .by_form["hopper"], .first only on .by_form["first"]. The C side's
    launch constants equal the Python mirrors the CPU tests hold
    (probe_batched_dot.nn_dot_launch; probe_block_patterns.D_*)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe
    from dlq_tpu_torch.tools import probe_batched_dot as PB
    from dlq_tpu_torch.tools import probe_block_patterns as PK

    dev = torch.device("cuda")
    assert _probe.c_plan("probe_batched_dot", "nn_plan", 6) == PB.nn_dot_launch()
    assert _probe.c_plan("probe_block", "d_plan", 4) == (PK.D_RANKS, PK.D_THREADS, PK.D_SMEM,
                                                         PK.D_CS)
    rng = np.random.default_rng(seed)
    if seed == 0:
        (b_in,), (d_in,) = ([xs for k, xs, _ in mod.cases() if k == key]
                            for mod, key in ((PB, "B"), (PK, "D")))
    else:
        b_in = tuple(_probe.bf16(rng.normal(0, 1, s)) for s in ((8, 200, 200), (8, 200, 64)))
        d_in = (_i8(rng, (1, 12, 20, 128)), _i8(rng, (9, 128, 128)), _i8(rng, (9, 128, 128)))
    for mod, fn, key, inputs in ((PB, PB.probe_batched_dot, "B", b_in),
                                 (PK, PK.probe_block, "D", d_in)):
        xs = tuple(x.to(dev) for x in inputs)
        launches, forms, shapes = fn.launches, dict(fn.by_form), dict(fn.by_shape)
        got = fn(key, *xs)
        assert fn.launches == launches + 1 and fn.by_shape[key] == shapes.get(key, 0) + 1
        assert fn.by_form["hopper"] == forms.get("hopper", 0) + 1
        first = fn.first(key, *xs)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1 and fn.by_form["first"] == forms.get("first", 0) + 1
        assert torch.equal(got, first), (key, int((got != first).sum()))
        ref = mod.PLAIN[key](*xs)
        if key == "D":
            assert torch.equal(got, ref), int((got != ref).sum())
        else:
            ok, text, _ = _probe.held(got, ref, mod.SPEC[key])
            assert ok, text


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_nt_dot_and_int_dot_hopper_on_card(seed):
    """K19 3's and K20 A's NT dot (nt_dot_hopper_kernel) and K22 E's int8
    dot (int_dot_hopper_kernel) on the probes' own inputs (seed 0) and on
    other draws (seeds 1, 2: the dots' q and k from a normal draw, E's a and
    b over the whole int8 range, -128 included): each Hopper form equal to
    its first form on every output, E also to PLAIN["E"], the dots within
    _probe.held's fp32 limit (1e-4 of max|plain|); each launch counted once
    on .launches and .by_form["hopper"], .first only on .by_form["first"];
    200 launches in a row give the same output every time. The C side's
    launch constants equal the Python mirrors the CPU tests hold
    (_probe.nt_dot_launch, probe_stem_patterns.int_dot_launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe
    from dlq_tpu_torch.tools import probe_batched_dot as PB
    from dlq_tpu_torch.tools import probe_mosaic_patterns as PM
    from dlq_tpu_torch.tools import probe_stem_patterns as PS

    dev = torch.device("cuda")
    dots = ((PM, PM.probe_mosaic, "3", (1, 256, 256)),
            (PB, PB.probe_batched_dot, "A", (8, 200, 200)))
    for mod, fn, key, shape in dots:
        assert _probe.c_plan(mod.SOURCE, "nt_plan", 7) == _probe.nt_dot_launch(*shape)
    assert _probe.c_plan("probe_stem", "int_plan", 6) == PS.int_dot_launch()
    rng = np.random.default_rng(seed)
    cases = []
    for mod, fn, key, shape in dots + ((PS, PS.probe_stem, "E", None),):
        if seed == 0:
            (inputs,) = [xs for k, xs, _ in mod.cases() if k == key]
        elif key == "E":
            inputs = (_i8(rng, (12544, 256), lo=-128), _i8(rng, (256, 64), lo=-128))
        else:
            inputs = tuple(_probe.bf16(rng.normal(0, 1, shp)) for shp, _ in mod.SPEC[key].ins)
        cases.append((mod, fn, key, tuple(x.to(dev) for x in inputs)))
    for mod, fn, key, xs in cases:
        launches, forms, shapes = fn.launches, dict(fn.by_form), dict(fn.by_shape)
        got = fn(key, *xs)
        assert fn.launches == launches + 1 and fn.by_shape[key] == shapes.get(key, 0) + 1
        assert fn.by_form["hopper"] == forms.get("hopper", 0) + 1
        first = fn.first(key, *xs)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1 and fn.by_form["first"] == forms.get("first", 0) + 1
        assert torch.equal(got, first), (key, int((got != first).sum()))
        ref = mod.PLAIN[key](*xs)
        if key == "E":
            assert torch.equal(got, ref), int((got != ref).sum())
        else:
            ok, text, _ = _probe.held(got, ref, mod.SPEC[key])
            assert ok, text
        outs = [fn(key, *xs) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, got) for o in outs), key


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_cols_and_maxpool_hopper_on_card(seed):
    """K22 J's cols build (cols_kernel) and K22 K's max pool
    (maxpool_kernel) on the probe's own inputs (seed 0) and on the CPU
    tests' draws (seeds 1, 2: the whole int8 range, -128 included; for K
    also the all-negative map, where a 0 padding would show on the top row
    and the left column): each Hopper form equal to its first form and to
    PLAIN on every output; each launch counted once on .launches and
    .by_form["hopper"], .first only on .by_form["first"]; 200 launches in a
    row give the same output every time. The C side's launch constants
    equal the Python mirrors the CPU tests hold
    (probe_stem_patterns.cols_launch, pool_launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe
    from dlq_tpu_torch.tools import probe_stem_patterns as PS

    dev = torch.device("cuda")
    assert _probe.c_plan("probe_stem", "cols_plan", 3) == PS.cols_launch()
    assert _probe.c_plan("probe_stem", "pool_plan", 3) == PS.pool_launch()
    if seed == 0:
        cases = [(k, xs) for k, xs, _ in PS.cases() if k in ("J", "K")]
    else:
        cases = [(key, (_i8(np.random.default_rng(seed), shape, lo=-128),))
                 for key, shape in (("J", (232, 920)), ("K", (12544, 64)))]
        if seed == 1:
            neg = np.random.default_rng(3).integers(-128, 0, (12544, 64)).astype(np.int8)
            cases.append(("K", (torch.from_numpy(neg),)))
    fn = PS.probe_stem
    for key, inputs in cases:
        xs = tuple(x.to(dev) for x in inputs)
        launches, forms, shapes = fn.launches, dict(fn.by_form), dict(fn.by_shape)
        got = fn(key, *xs)
        assert fn.launches == launches + 1 and fn.by_shape[key] == shapes.get(key, 0) + 1
        assert fn.by_form["hopper"] == forms.get("hopper", 0) + 1
        first = fn.first(key, *xs)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1 and fn.by_form["first"] == forms.get("first", 0) + 1
        assert torch.equal(got, first), (key, int((got != first).sum()))
        ref = PS.PLAIN[key](*xs)
        assert torch.equal(got, ref), (key, int((got != ref).sum()))
        outs = [fn(key, *xs) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, got) for o in outs), key


def _elementwise_cases(draw):
    """(module, key, input, scale) of K21 O and K19 5: the probe's own
    inputs (seed 0), other draws (seeds 1, 2: O over the whole int8 range
    at a drawn scale, 5 a normal draw of sigma 3), or the exhaustive inputs
    (O's 256 values at its four scales, 5's 65,536 bit patterns)."""
    from dlq_tpu_torch.tools import probe_block_patterns as PK
    from dlq_tpu_torch.tools import probe_mosaic_patterns as PM

    if draw == "exhaustive":
        return [(mod, key, x, s) for mod in (PK, PM) for _, key, x, s in mod.exhaustive_cases()]
    if draw == 0:
        return [(mod, key, xs[0], None) for mod, key in ((PK, "O"), (PM, "5"))
                for k, xs, _ in mod.cases() if k == key]
    from dlq_tpu_torch.tools import _probe

    rng = np.random.default_rng(draw)
    return [(PK, "O", _i8(rng, (256, 1024), lo=-128), float(rng.uniform(0.01, 2.0))),
            (PM, "5", _probe.bf16(rng.normal(0, 3, (256, 768))), None)]


@pytest.mark.gpu
@pytest.mark.parametrize("draw", [0, 1, 2, "exhaustive"])
def test_probe_requant_and_tanh_hopper_on_card(draw):
    """K21 O's requant (requant_kernel) and K19 5's tanh (tanh_kernel) on
    the probe's own inputs (seed 0), other draws (seeds 1, 2) and every
    input value (O's 256 int8 values at four scales, 5's 65,536 bf16 bit
    patterns, NaN and +-inf included): each Hopper form equal to its first
    form bit for bit, NaN for NaN, and to its plain version (O bit for bit,
    5 by _probe.held on the non-NaN inputs, NaN for NaN); each launch
    counted once on .launches and .by_form["hopper"], .first only on
    .by_form["first"]; 200 launches in a row give the same output every
    time. The C side's launch constants equal the Python mirrors the CPU
    tests hold (probe_block_patterns.o_launch,
    probe_mosaic_patterns.tanh_launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe
    from dlq_tpu_torch.tools import probe_block_patterns as PK
    from dlq_tpu_torch.tools import probe_mosaic_patterns as PM

    dev = torch.device("cuda")
    assert _probe.c_plan("probe_block", "o_plan", 3) == PK.o_launch()
    assert _probe.c_plan("probe_mosaic", "tanh_plan", 3) == PM.tanh_launch()
    for mod, key, x, scale in _elementwise_cases(draw):
        fn = getattr(mod, mod.SOURCE)
        x = x.to(dev)
        launches, forms, shapes = fn.launches, dict(fn.by_form), dict(fn.by_shape)
        got = fn(key, x, scale=scale)
        assert fn.launches == launches + 1 and fn.by_shape[key] == shapes.get(key, 0) + 1
        assert fn.by_form["hopper"] == forms.get("hopper", 0) + 1
        first = fn.first(key, x, scale=scale)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1 and fn.by_form["first"] == forms.get("first", 0) + 1
        assert _probe.differing(got, first) == 0, (key, scale, _probe.differing(got, first))
        (row,) = _probe.exhaustive(fn, mod.SPEC, mod.PLAIN, [(str(draw), key, x, scale)])
        assert row["ok"], row
        outs = [fn(key, x, scale=scale) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(_probe.differing(o, got) == 0 for o in outs), (key, scale)


# windows beside the probes' own (as tests/test_torch_port_probe_hopper.py
# holds their plans on the CPU): rows across block edges and shares that
# split rows, one row, 4-byte pieces (one block and 250), 8-aligned pieces,
# a doubled bf16 window
ODD_WINDOWS = [
    (0, 1040, 16, 301, 3, 48, False),
    (32, 0, 64, 1, 5, 64, False),
    (20, 944, 8, 37, 12, 4, False),
    (4, 1024, 8, 2000, 128, 4, False),
    (8, 920, 24, 50, 3, 16, False),
    (0, 400, 0, 300, 1, 192, True),
]


@pytest.mark.gpu
def test_probe_stage_plans_and_windows_on_card():
    """The C side's windows of the 12 copy patterns equal each module's
    WINDOWS, and its stage_plan equals _probe.stage_plan at each of them and
    at the odd windows (one source of the plan: the kernel's launch is
    held to the function the CPU tests hold)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe

    n = 0
    for mod, name in _probe_mods():
        keys = tuple(mod.SPEC)
        for key, (w, x2) in mod.WINDOWS.items():
            assert _probe.c_window(name, keys.index(key)) == (w, x2), (name, key)
            assert _probe.c_stage_plan(name, w) == _probe.stage_plan(w), (name, key)
            n += 1
        for v in ODD_WINDOWS:
            w = _probe.Window(*v[:6])
            assert _probe.c_stage_plan(name, w) == _probe.stage_plan(w), (name, w)
    assert n == 12


@pytest.mark.gpu
@pytest.mark.parametrize("v", ODD_WINDOWS)
def test_probe_stage_odd_windows_on_card(v):
    """Odd windows on stage_kernel, through every probe library: identical to
    the window read by torch's as_strided (x 2 in bf16 where asked), to
    _probe.stage_apply's block walk and to the first form; a window the
    plan refuses (2-byte aligned pieces) raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import _probe

    dev = torch.device("cuda")
    w, x2 = _probe.Window(*v[:6]), v[6]
    total = w.I * w.J * w.E // 16
    size = int(_probe.stage_sources(w, torch.arange(total)).max()) + 17
    size += size % 2
    rng = np.random.default_rng(sum(v[:6]))
    if x2:
        src = torch.from_numpy(rng.normal(0, 3, size // 2).astype(np.float32))
        src = src.to(torch.bfloat16).view(torch.uint8)
    else:
        src = torch.from_numpy(rng.integers(0, 256, size).astype(np.uint8))
    ref = torch.as_strided(src, (w.I, w.J, w.E), (w.si, w.sj, 1), w.base).flatten()
    if x2:
        ref = (ref.view(torch.bfloat16) * 2).view(torch.uint8)
    assert torch.equal(_probe.stage_apply(src, w, x2), ref)
    for _, name in PROBES:
        got = _probe.stage_window(name, src.to(dev), w, x2)
        first = _probe.stage_window(name, src.to(dev), w, x2, first=True)
        assert torch.equal(got.cpu(), ref), name
        assert torch.equal(first.cpu(), ref), name
    with pytest.raises(RuntimeError):
        _probe.stage_window("probe_block", src.to(dev), w._replace(base=2, E=8, sj=8), x2)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 65, 200, 400, 51272])
def test_vit_pre_w8_hopper_on_card(m, dp):
    """K5's Hopper form bit-identical to its first form (the same LN order
    and codes, exact int32 sums, the same fma and bf16 rounding) and within
    the stated agreement of its plain version (which sums the LN in another
    order): Dp 128 and 192 (resident weight) and 256 (streamed), d_valid <
    Dp (pad lanes), bf16 and fp32 residuals, row counts on both sides of
    the 64-row halves and 128-row tiles (1, 63, 65, 200, 400) and DeiT-Tiny
    batch 256 plus 72 rows (more tiles than SMs, each block's last tile
    short); every launch takes the Hopper form (its counter), and the plan
    the kernel takes equals ``vit_pre_w8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_plain, vit_block_pre_w8, vit_block_pre_w8_first, vit_pre_w8_form,
        vit_pre_w8_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(9000 + m + dp)
    d = dp - 32
    blk = _vit_block(rng, dp, 384, dev)
    blk["wqkv"][:, d:] = 0
    blk["ln1"][:, d:] = 0
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    assert vit_pre_w8_form(dp) == "hopper"
    for dt in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, dt)
        before = vit_block_pre_w8.by_form["hopper"]
        got = vit_block_pre_w8(y, blk, d)
        assert vit_block_pre_w8.by_form["hopper"] == before + 1
        assert got.shape == (1, m, 3 * dp) and got.dtype == torch.bfloat16
        assert torch.equal(got, vit_block_pre_w8_first(y, blk, d)), dt
        _agree(got, vit_block_pre_plain(y, blk, d), 0.99, 0.25)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n("vit_pre_w8", "vit_pre_w8_plan", (dp, m, 0), 6) == \
        vit_pre_w8_plan(dp, m, sms)


@pytest.mark.gpu
def test_vit_pre_w8_first_form_on_card():
    """K5's first form by the static rule (Dp other than 128, 192, 256: 64
    and 320) within the stated agreement of its plain version, counted as
    such."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import vit_block_pre_plain, vit_block_pre_w8, vit_pre_w8_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(9500)
    for dp in (64, 320):
        blk = _vit_block(rng, dp, 256, dev)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev)
        assert vit_pre_w8_form(dp) == "first"
        before = vit_block_pre_w8.by_form["first"]
        _agree(vit_block_pre_w8(y, blk, dp), vit_block_pre_plain(y, blk, dp), 0.99, 0.25)
        assert vit_block_pre_w8.by_form["first"] == before + 1


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


def _plan_on_card_n(lib: str, name: str, args, n_out: int):
    """A kernel library's own plan (its C entry ``dlq_<name>``, ``n_out`` ints)."""
    import ctypes

    from dlq_tpu_torch import _build

    out = (ctypes.c_int * n_out)()
    fn = getattr(_build.library(lib), f"dlq_{name}")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    _build.check(fn(*args, ctypes.cast(out, ctypes.c_void_p)), name)
    return tuple(out)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [18, 48, 64, 256, 2048])
@pytest.mark.parametrize("m", [1, 127, 129, 3136 * 3 + 5])
def test_matmul_int8_hopper_on_card(m, k):
    """K2 bit-identical to its plain version (exact int32 sums, the same
    fp32 fma and dividing requant) at ragged M on both sides of the 128-row
    items and over several walks (9,413 rows: 74 tiles), K = 18 (rows of x
    not 16-byte aligned: the first form), 48, 64, 256 and 2048, N = 1, 64,
    192, 256, 520 and 1000 (resident and streamed slices, the narrow
    64-column plan, 2- and 4-byte stores where a row is not a 16-byte
    multiple), int8 and fp32 out, relu on and off; the form each launch took
    (its counter) and the plan the kernel takes against ``ops.i8plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.i8plan import matmul_int8_form, matmul_int8_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(5000 + m + k)
    kp = -(-k // 64) * 64
    x = _i8(rng, (m, k)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (1, 64, 192, 256, 520, 1000):
        pk = pack_dense_weight(_i8(rng, (k, n)).to(dev))
        scale, bias = _epi(rng, n, k, dev)
        for relu, osc in ((False, None), (True, None), (False, 0.025), (True, 0.025)):
            before = dict(matmul_int8.by_form)
            got = matmul_int8(x, pk, scale, bias, relu, osc)
            assert torch.equal(got, matmul_int8_plain(x, pk, scale, bias, relu, osc)), (n, relu, osc)
            form = matmul_int8_form(k)
            assert matmul_int8.by_form[form] == before.get(form, 0) + 1
            assert _plan_on_card_n("matmul_int8", "matmul_int8_plan",
                                   (m, n, kp, int(osc is not None), 0), 6) == \
                tuple(matmul_int8_plan(m, n, kp, osc is not None, sms))


@pytest.mark.gpu
@pytest.mark.parametrize("h,c,oc,k,s", [
    (56, 64, 64, 3, 1), (28, 128, 128, 3, 1), (14, 256, 256, 3, 1), (7, 512, 512, 3, 1),
    (56, 64, 128, 3, 2), (28, 256, 256, 3, 2), (14, 512, 512, 3, 2),
    (56, 64, 128, 1, 2), (28, 512, 1024, 1, 2), (14, 1024, 2048, 1, 2),
    (13, 64, 192, 3, 1), (9, 128, 64, 3, 2), (30, 64, 1000, 3, 1),
])
def test_conv_int8_hopper_on_card(h, c, oc, k, s):
    """K1's Hopper form bit-identical to its plain version: the 3x3/s1 convs
    at all four ResNet widths (56^2 x 64 with the resident weight, 28^2 x
    128, 14^2 x 256 and 7^2 x 512 with two images an item), 3x3/s2 (four
    phase planes) and 1x1/s2, and off-path shapes (odd sizes, OC 192 and
    1000), at batch 3 (the last item of a two-image walk is one image) and
    batch 1 at 56^2; int8 and fp32 out, relu on and off; every launch takes
    the Hopper form (its counter), and its plan and slab geometry on the card
    equal ``ops.i8plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.i8plan import conv_geometry, conv_int8_form, conv_int8_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(6000 + h + c + oc + k + s)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pad = k // 2
    pk = pack_conv_weight(_i8(rng, (k, k, c, oc)).to(dev))
    scale, bias = _epi(rng, oc, k * k * c, dev)
    for nb in ((1, 3) if h == 56 else (3,)):
        x = _i8(rng, (nb, h, h, c)).to(dev)
        for relu, osc in ((False, None), (True, None), (False, 0.025), (True, 0.025)):
            assert conv_int8_form(h, h, c, oc, k, s, pad, osc is not None) == "hopper"
            before = conv_int8.by_form["hopper"]
            got = conv_int8(x, pk, s, pad, scale, bias, relu, osc)
            assert conv_int8.by_form["hopper"] == before + 1
            ref = conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc)
            assert torch.equal(got, ref), (nb, relu, osc, float((got.float() - ref.float()).abs().max()))
            want = (*conv_int8_plan(nb, h, h, c, oc, k, s, pad, osc is not None, sms),
                    *conv_geometry(h, h, c, k, s, pad))
            assert _plan_on_card_n("conv_int8", "conv_int8_plan",
                                   (nb, h, h, c, oc, k, k, s, pad, int(osc is not None), 0),
                                   12) == want


@pytest.mark.gpu
def test_conv_int8_first_form_on_card():
    """K1's first form by the static rule (C % 64 != 0: C = 3, 16 and 96;
    a 7x7 kernel) bit-identical to its plain version, counted as such."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.i8plan import conv_int8_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(7000)
    for (h, c, oc, k, s) in [(20, 3, 64, 7, 2), (15, 16, 64, 3, 1), (12, 96, 128, 3, 2),
                             (12, 64, 64, 5, 1)]:
        x = _i8(rng, (2, h, h, c)).to(dev)
        pk = pack_conv_weight(_i8(rng, (k, k, c, oc)).to(dev))
        args = (x, pk, s, k // 2, *_epi(rng, oc, k * k * c, dev), True, 0.025)
        assert conv_int8_form(h, h, c, oc, k, s, k // 2, True) == "first"
        before = conv_int8.by_form["first"]
        assert torch.equal(conv_int8(*args), conv_int8_plain(*args))
        assert conv_int8.by_form["first"] == before + 1


@pytest.mark.gpu
def test_int8_requant_division_paths_on_card():
    """The Hopper form's int8 requant divides by the IEEE division's fast
    path where its operands' exponents lie within +-60 and by the exact
    division for a warp's half-tile that holds one outside: K1 and K2
    bit-identical to their plain versions with ordinary scales, with an
    output scale far from 1 (2^-70, 2^70: every launch takes the exact
    division), and with sums scaled to exponents near -100 (tiny y)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8000)
    x = _i8(rng, (300, 256)).to(dev)
    pk = pack_dense_weight(_i8(rng, (256, 128)).to(dev))
    xc = _i8(rng, (2, 14, 14, 128)).to(dev)
    pc = pack_conv_weight(_i8(rng, (3, 3, 128, 128)).to(dev))
    scale, bias = _epi(rng, 128, 256, dev)
    for mult, osc in ((1.0, 0.025), (1.0, 2.0 ** -70), (1.0, 2.0 ** 70), (2.0 ** -100, 2.0 ** -100),
                      (2.0 ** -100, 0.025)):
        for relu in (False, True):
            args = (scale * mult, bias * mult, relu, osc)
            assert torch.equal(matmul_int8(x, pk, *args), matmul_int8_plain(x, pk, *args))
            cargs = (xc, pc, 1, 1, scale * mult, bias * mult, relu, osc)
            assert torch.equal(conv_int8(*cargs), conv_int8_plain(*cargs))


def _post_h_block(rng, dp, hp, d, w4, dev):
    """One K12 (``w4``: halves-packed int4 weights, per-OC scales) or K15
    (bf16 weights, no scales) layer at Dp/Hp, zero past d_valid in its pad
    lanes, the products near unit scale."""
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor

    def w(n, k):
        if w4:
            a = rng.integers(-8, 8, (k, n)).astype(np.int8)
            a[d if k == dp else k:] = 0
            a[:, d if n == dp else n:] = 0
            return pack_halves_kmajor(torch.from_numpy(a), k, n).to(dev)
        a = rng.normal(0, 1.0 / np.sqrt(k), (n, k)).astype(np.float32)
        a[:, d if k == dp else k:] = 0
        a[d if n == dp else n:] = 0
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    def s(n, k):
        return torch.from_numpy((rng.uniform(0.5, 1.5, n) / (4.6 * np.sqrt(k)))
                                .astype(np.float32)).to(dev)

    def b(n):
        v = rng.normal(0, 0.1, n).astype(np.float32)
        v[d if n == dp else n:] = 0
        return torch.from_numpy(v).to(dev)

    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    blk = {"wproj": w(dp, dp), "bproj": b(dp), "ln2": torch.from_numpy(ln).to(dev),
           "wfc1": w(hp, dp), "bfc1": b(hp), "wfc2": w(dp, hp), "bfc2": b(dp)}
    if w4:
        blk.update(sproj=s(dp, dp), sfc1=s(hp, dp), sfc2=s(dp, hp))
    return blk


def _post_h_fns(w4):
    from dlq_tpu_torch.ops import vit_block as vb

    if w4:
        return ("vit_post_w4", vb.vit_block_post_w4, vb.vit_block_post_w4_first,
                vb.vit_block_post_w4_plain)
    return ("vit_post_bf16", vb.vit_block_post_bf16, vb.vit_block_post_bf16_first,
            vb.vit_block_post_bf16_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("w4", [False, True], ids=["k15_bf16", "k12_w4"])
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200, 65536])
def test_vit_post_h_hopper_on_card(m, dp, w4):
    """K15 and K12 on their Hopper form against their plain versions and
    their first forms (fp32 sums in other orders: bf16 outputs >= 0.99
    equal, fp32 outputs >= 0.99 within 2^-12 of their unit-plus-magnitude
    scale, all within 0.25): Dp 128, 192 and 256 with d_valid = Dp - 32 (pad
    lanes), Hp 384 (768 at DeiT-Tiny's 51,200 and 65,536 rows), row counts
    on both sides of the 64-row halves and 128-row tiles (1, 63, 64, 65, 72,
    400: a lone consumer, a short last tile) and DeiT-Tiny batch 256 at the
    tight and loose pads (each block's last tile short), every residual /
    output dtype pair, both GELUs; every launch takes the Hopper form (the
    rule, its counter) and the plan the library takes equals
    ``vit_post_h_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import vit_post_h_form, vit_post_h_plan

    name, kern, first, plain = _post_h_fns(w4)
    dev = torch.device("cuda")
    rng = np.random.default_rng(13000 + m + dp + 7 * w4)
    d, hp = dp - 32, (768 if m >= 51200 else 384)
    blk = _post_h_block(rng, dp, hp, d, w4, dev)
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    an = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    an[..., d:] = 0
    attn = torch.from_numpy(an).to(dev, torch.bfloat16)
    assert vit_post_h_form(dp, hp) == "hopper"
    for din in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, din)
        for dout in (torch.bfloat16, torch.float32):
            near = 2.0 ** -12 if dout == torch.float32 else 0.0
            for tanh in (False, True):
                before = kern.by_form["hopper"]
                got = kern(y, attn, blk, d, tanh, dout)
                assert kern.by_form["hopper"] == before + 1
                assert got.dtype == dout and got.shape == y.shape
                _agree(got, plain(y, attn, blk, d, tanh, dout), 0.99, 0.25, near)
                _agree(got, first(y, attn, blk, d, tanh, dout), 0.99, 0.25, near)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n(name, f"{name}_plan", (dp, hp, m, 0), 5) == \
        vit_post_h_plan(dp, hp, m, sms)


@pytest.mark.gpu
@pytest.mark.parametrize("w4", [False, True], ids=["k15_bf16", "k12_w4"])
def test_vit_post_h_first_form_on_card(w4):
    """K15 and K12 on their first form by the static rule (Dp 64 and 320)
    within the stated agreement of their plain versions, counted as such;
    the library's plan is all zeros there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import vit_post_h_form

    name, kern, _, plain = _post_h_fns(w4)
    dev = torch.device("cuda")
    rng = np.random.default_rng(13500 + w4)
    for dp, hp in ((64, 256), (320, 256)):
        blk = _post_h_block(rng, dp, hp, dp, w4, dev)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev, torch.bfloat16)
        attn = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev, torch.bfloat16)
        assert vit_post_h_form(dp, hp) == "first"
        assert _plan_on_card_n(name, f"{name}_plan", (dp, hp, 140, 0), 5) == (0,) * 5
        before = kern.by_form["first"]
        _agree(kern(y, attn, blk, dp), plain(y, attn, blk, dp), 0.99, 0.25)
        assert kern.by_form["first"] == before + 1


def _w4_block(rng, dp, hp, d, dev, a8):
    """One W4A8 (``a8``: K8/K9, with _vit_block's inverse activation scales)
    or W4A16 (K11/K12) layer at Dp/Hp: random int4 weights halves-packed
    K-major, per-OC scales that put the products near unit scale, biases
    and LN rows, every weight, scale, bias and LN lane zero past d_valid."""
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor

    blk = _vit_block(rng, dp, hp, dev)
    if not a8:
        del blk["inv_act"]
    for name, (n, k) in (("wqkv", (3 * dp, dp)), ("wproj", (dp, dp)), ("wfc1", (hp, dp)),
                         ("wfc2", (dp, hp))):
        w = rng.integers(-8, 8, (k, n)).astype(np.int8)
        if k == dp:
            w[d:] = 0
        if n == dp:
            w[:, d:] = 0
        if name == "wqkv":
            w[:, np.arange(n) % dp >= d] = 0
        blk[name] = pack_halves_kmajor(torch.from_numpy(w), k, n).to(dev)
        s = blk["s" + name[1:]]
        s.mul_(73.0 / 4.6)   # int4 weights: rms ~4.6 against int8's ~73
        if not a8:
            s.mul_(60.0)   # bf16 activations at unit scale, not int8 codes
    for k in ("sproj", "bproj", "sfc2", "bfc2"):
        blk[k][d:] = 0
    blk["ln1"][:, d:] = 0
    blk["ln2"][:, d:] = 0
    return blk


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200])
def test_vit_post_w4a8_hopper_on_card(m, dp):
    """K9's Hopper form (vit_post_iw.cuh, K7's body) bit-identical to its
    first form (exact int32 sums in the paired K order, the same LN2 order,
    codes and roundings) and within K9's stated agreement of its plain
    version: Dp 128, 192 and 256 with d_valid = Dp - 32 (pad lanes), Hp 384
    (768 at DeiT-Tiny batch 256), row counts on both sides of the 64-row
    halves and 128-row tiles (1, 63, 64, 65, 72, 400) and 51,200 (each
    block's last tile short), every residual / output dtype pair, both FC2
    associations and both GELUs; every launch takes the Hopper form (the
    rule, its counter) and the plan the library takes equals
    ``vit_post_w4a8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w4a8, vit_block_post_w4a8_first,
        vit_post_w4a8_form, vit_post_w4a8_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(14000 + m + dp)
    d, hp = dp - 32, (768 if m >= 51200 else 384)
    blk = _w4_block(rng, dp, hp, d, dev, True)
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    attn = torch.from_numpy(rng.normal(0, 1, (1, m, dp)).astype(np.float32)).to(dev, torch.bfloat16)
    assert vit_post_w4a8_form(dp, hp) == "hopper"
    for din in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, din)
        for dout in (torch.bfloat16, torch.float32):
            for multi in (False, True):
                for tanh in (False, True):
                    before = vit_block_post_w4a8.by_form["hopper"]
                    got = vit_block_post_w4a8(y, attn, blk, d, tanh, dout, multi)
                    assert vit_block_post_w4a8.by_form["hopper"] == before + 1
                    assert got.dtype == dout and got.shape == y.shape
                    first = vit_block_post_w4a8_first(y, attn, blk, d, tanh, dout, multi)
                    assert torch.equal(got, first), (din, dout, multi, tanh,
                                                     int((got != first).sum()))
                    _agree(got, vit_block_post_plain(y, attn, blk, d, tanh, dout, multi), 0.95,
                           0.25)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n("vit_post_w4a8", "vit_post_w4a8_plan", (dp, hp, m, 0), 4) == \
        vit_post_w4a8_plan(dp, hp, m, sms)


@pytest.mark.gpu
def test_vit_post_w4a8_first_form_on_card():
    """K9's first form by the static rule (Dp 64 and 320; Dp 256 at Hp 1024,
    whose ring would hold 2 stages) within the stated agreement of its plain
    version, counted as such; the library's plan is all zeros there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w4a8, vit_post_w4a8_form,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(14500)
    for dp, hp in ((64, 256), (320, 256), (256, 1024)):
        blk = _w4_block(rng, dp, hp, dp, dev, True)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev, torch.bfloat16)
        attn = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev, torch.bfloat16)
        assert vit_post_w4a8_form(dp, hp) == "first"
        assert _plan_on_card_n("vit_post_w4a8", "vit_post_w4a8_plan", (dp, hp, 140, 0), 4) == (0,) * 4
        before = vit_block_post_w4a8.by_form["first"]
        _agree(vit_block_post_w4a8(y, attn, blk, dp), vit_block_post_plain(y, attn, blk, dp,
                                                                           multi=True), 0.95, 0.25)
        assert vit_block_post_w4a8.by_form["first"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 72, 400, 51200])
def test_vit_pre_w4_hopper_on_card(m, dp):
    """K11's Hopper form against its plain version and its first form (fp32
    sums in other orders: >= 0.99 of the bf16 outputs equal, none more than
    0.0625 apart, W4A16's tolerance): Dp 128, 192 and 256 with d_valid =
    Dp - 32 (pad lanes), bf16 and fp32 residuals, row counts on both sides
    of the 64-row halves, the 16- and 8-row y stages and the 128-row tiles
    (1, 63, 64, 65, 72, 400) and DeiT-Tiny batch 256 (51,200: each block's
    last tile short); every launch takes the Hopper form (its counter), and
    the plan the library takes equals ``vit_pre_w4_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_w4, vit_block_pre_w4_first, vit_block_pre_w4_plain, vit_pre_w4_form,
        vit_pre_w4_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(14100 + m + dp)
    d = dp - 32
    blk = _w4_block(rng, dp, 256, d, dev, False)
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    assert vit_pre_w4_form(dp) == "hopper"
    for dt in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, dt)
        before = vit_block_pre_w4.by_form["hopper"]
        got = vit_block_pre_w4(y, blk, d)
        assert vit_block_pre_w4.by_form["hopper"] == before + 1
        assert got.shape == (1, m, 3 * dp) and got.dtype == torch.bfloat16
        _agree(got, vit_block_pre_w4_first(y, blk, d), 0.99, 0.0625)
        _agree(got, vit_block_pre_w4_plain(y, blk, d), 0.99, 0.0625)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n("vit_pre_w4", "vit_pre_w4_plan", (dp, m, 0), 5) == \
        vit_pre_w4_plan(dp, m, sms)


@pytest.mark.gpu
def test_vit_pre_w4_first_form_on_card():
    """K11's first form by the static rule (Dp 64 and 320) within the
    stated agreement of its plain version, counted as such; the library's
    plan is all zeros there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import vit_block_pre_w4, vit_block_pre_w4_plain, vit_pre_w4_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(14600)
    for dp in (64, 320):
        blk = _w4_block(rng, dp, 256, dp, dev, False)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev)
        assert vit_pre_w4_form(dp) == "first"
        assert _plan_on_card_n("vit_pre_w4", "vit_pre_w4_plan", (dp, 140, 0), 5) == (0,) * 5
        before = vit_block_pre_w4.by_form["first"]
        _agree(vit_block_pre_w4(y, blk, dp), vit_block_pre_w4_plain(y, blk, dp), 0.99, 0.0625)
        assert vit_block_pre_w4.by_form["first"] == before + 1


# the ViT kernels' agreement with their plain versions at batch 256
# (chip_smoke.py): (fraction of outputs equal, largest difference)
VIT_TOL = (0.999, 0.0625)
BF16_TOL = (0.997, 0.0625)
PRE_M = (1, 63, 64, 65, 127, 128, 129, 51200)


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", PRE_M)
def test_vit_pre_w4a8_hopper_on_card(m, dp):
    """K8 at the form its rule gives (the Hopper form at Dp 128 and 192:
    K5's body, the packed weight unpacked once a block into its resident
    int8 copy; the first form at 256) bit-identical to its first form (the
    same LN order and codes, exact int32 sums, the same epilogue), with
    d_valid = Dp - 32 (pad lanes), bf16 and fp32 residuals, row counts on
    both sides of the 64-row halves and 128-row tiles and DeiT-Tiny batch
    256 (each block's last tile short). Against its plain version (which
    sums LN1 in another order): no output more than VIT_TOL[1] apart, and
    at 51,200 rows VIT_TOL's equal fraction (at a few rows one code that
    lands a step apart moves much of its row, so the fraction says nothing
    there). Every launch is counted on its form, and the plan the library
    takes equals ``vit_pre_w4a8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_plain, vit_block_pre_w4a8, vit_block_pre_w4a8_first, vit_pre_w4a8_form,
        vit_pre_w4a8_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(15000 + m + dp)
    d = dp - 32
    blk = _w4_block(rng, dp, 256, d, dev, True)
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    form = vit_pre_w4a8_form(dp)
    assert form == ("hopper" if dp in (128, 192) else "first")
    for dt in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, dt)
        before = vit_block_pre_w4a8.by_form[form]
        got = vit_block_pre_w4a8(y, blk, d)
        assert vit_block_pre_w4a8.by_form[form] == before + 1
        assert got.shape == (1, m, 3 * dp) and got.dtype == torch.bfloat16
        first = vit_block_pre_w4a8_first(y, blk, d)
        assert torch.equal(got, first), (dt, int((got != first).sum()))
        _agree(got, vit_block_pre_plain(y, blk, d), VIT_TOL[0] if m >= 51200 else 0.0, VIT_TOL[1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n("vit_pre_w4a8", "vit_pre_w4a8_plan", (dp, m, 0), 6) == \
        vit_pre_w4a8_plan(dp, m, sms)


@pytest.mark.gpu
def test_vit_pre_w4a8_first_form_on_card():
    """K8's first form by the static rule (Dp 64 and 320) bit-identical to
    its own entry and within VIT_TOL[1] of its plain version, counted as
    such; the library's plan is all zeros there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_plain, vit_block_pre_w4a8, vit_block_pre_w4a8_first, vit_pre_w4a8_form,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(15500)
    for dp in (64, 320):
        blk = _w4_block(rng, dp, 256, dp, dev, True)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev)
        assert vit_pre_w4a8_form(dp) == "first"
        assert _plan_on_card_n("vit_pre_w4a8", "vit_pre_w4a8_plan", (dp, 140, 0), 6) == (0,) * 6
        before = vit_block_pre_w4a8.by_form["first"]
        got = vit_block_pre_w4a8(y, blk, dp)
        assert vit_block_pre_w4a8.by_form["first"] == before + 1
        assert torch.equal(got, vit_block_pre_w4a8_first(y, blk, dp))
        _agree(got, vit_block_pre_plain(y, blk, dp), 0.0, VIT_TOL[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [128, 192, 256])
@pytest.mark.parametrize("m", PRE_M + (65536,))
def test_vit_pre_bf16_hopper_on_card(m, dp):
    """K14's Hopper form (K11's body, vit_pre_hw.cuh: the bf16 weight by
    one TMA box a stage with 128-byte swizzle) against its first form (the
    same LN, fp32 sums in another order) within BF16_TOL, and against its
    plain version (exact sums; LN1 in another order) with no output more
    than BF16_TOL[1] apart and, at 51,200 and 65,536 rows, BF16_TOL's equal
    fraction: Dp 128, 192 and 256 with d_valid = Dp - 32, bf16 and fp32
    residuals, row counts on both sides of the 64-row halves and 128-row
    tiles, DeiT-Tiny batch 256 at the tight (51,200) and loose (65,536)
    row counts; every launch takes the Hopper form (its counter), and the
    plan the library takes equals ``vit_pre_bf16_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_bf16, vit_block_pre_bf16_first, vit_block_pre_bf16_plain,
        vit_pre_bf16_form, vit_pre_bf16_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(15100 + m + dp)
    d = dp - 32
    blk = _bf16_block(rng, dp, 64, d, dev)
    yn = rng.normal(0, 1, (1, m, dp)).astype(np.float32)
    yn[..., d:] = 0
    assert vit_pre_bf16_form(dp) == "hopper"
    for dt in (torch.bfloat16, torch.float32):
        y = torch.from_numpy(yn).to(dev, dt)
        before = vit_block_pre_bf16.by_form["hopper"]
        got = vit_block_pre_bf16(y, blk, d)
        assert vit_block_pre_bf16.by_form["hopper"] == before + 1
        assert got.shape == (1, m, 3 * dp) and got.dtype == torch.bfloat16
        _agree(got, vit_block_pre_bf16_first(y, blk, d), *BF16_TOL)
        _agree(got, vit_block_pre_bf16_plain(y, blk, d), BF16_TOL[0] if m >= 51200 else 0.0,
               BF16_TOL[1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan_on_card_n("vit_pre_bf16", "vit_pre_bf16_plan", (dp, m, 0), 5) == \
        vit_pre_bf16_plan(dp, m, sms)


@pytest.mark.gpu
def test_vit_pre_bf16_first_form_on_card():
    """K14's first form by the static rule (Dp 64 and 320) equal to its own
    entry and within BF16_TOL[1] of its plain version, counted as such; the
    library's plan is all zeros there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_pre_bf16, vit_block_pre_bf16_first, vit_block_pre_bf16_plain, vit_pre_bf16_form,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(15600)
    for dp in (64, 320):
        blk = _bf16_block(rng, dp, 64, dp, dev)
        y = torch.from_numpy(rng.normal(0, 1, (2, 70, dp)).astype(np.float32)).to(dev)
        assert vit_pre_bf16_form(dp) == "first"
        assert _plan_on_card_n("vit_pre_bf16", "vit_pre_bf16_plan", (dp, 140, 0), 5) == (0,) * 5
        before = vit_block_pre_bf16.by_form["first"]
        got = vit_block_pre_bf16(y, blk, dp)
        assert vit_block_pre_bf16.by_form["first"] == before + 1
        assert torch.equal(got, vit_block_pre_bf16_first(y, blk, dp))
        _agree(got, vit_block_pre_bf16_plain(y, blk, dp), 0.0, BF16_TOL[1])


@pytest.mark.gpu
def test_vit_pre_w8_w4_unchanged_on_card():
    """K5's and K11's outputs over every form they take, on seeded inputs
    (``tools/pre_digest.py``), equal bit for bit to those of the sources
    before K8 and K14 took their Hopper bodies (fixed digests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.tools import pre_digest

    assert pre_digest.digests(torch.device("cuda")) == pre_digest.EXPECTED


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,rows,n_valid,hd", [(256, 197, 197, 64), (7, 200, 197, 64),
                                                 (5, 24, 21, 32), (3, 1, 1, 64),
                                                 (4, 256, 253, 64)])
def test_mhsa_f32_hopper_on_card(bsz, rows, n_valid, hd):
    """``mhsa_f32``'s Hopper form equal to its first form on every output
    (each score one FMA chain over d in ascending order, each output one
    over the keys, the same softmax) and within MHSA_F32_TOL of its plain
    version (1e-5 x (1 + |plain|), at most 1e-5), at DeiT-Tiny's [256, 197,
    3 x 64] and at shapes its tiles split differently, pad lanes zero; the
    launch took the rule's form (253 keys at hd 64: the first form), and the
    plan the library takes equals ``mhsa_f32_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import (
        mhsa, mhsa_f32, mhsa_f32_first, mhsa_f32_form, mhsa_f32_plan, mhsa_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(200 + rows + hd)
    heads = 3
    hw = heads * hd
    qkv = torch.from_numpy(rng.normal(0, 1, (bsz, rows, 3 * hw)).astype(np.float32)).to(dev)
    views = (qkv[..., :hw], qkv[..., hw: 2 * hw], qkv[..., 2 * hw:])
    lanes = hw + 64
    mhsa_f32.by_form.clear()
    got = mhsa(*views, heads, n_valid, out_lanes=lanes)
    assert dict(mhsa_f32.by_form) == {mhsa_f32_form(rows, n_valid, hd): 1}
    mhsa_f32.by_form.clear()
    assert torch.equal(got, mhsa_f32_first(*views, heads, n_valid, out_lanes=lanes))
    ref = mhsa_plain(*views, heads, n_valid, out_lanes=lanes)
    d = (got - ref).abs()
    assert float(d.max()) <= 1e-5 and bool((d <= 1e-5 * (1.0 + ref.abs())).all())
    assert not got[..., hw:].abs().any()
    assert _plan_on_card_n("mhsa", "mhsa_f32_plan", (rows, n_valid, hd), 5) == \
        mhsa_f32_plan(rows, n_valid, hd)


def _i8_held(got, ref, v, heads, n_valid, zero_pad):
    """K18's gate: >= 0.99 of the outputs equal, every other one within
    2 av / 127 (av: the (sample, head)'s V amax over the rows its form reads)."""
    hw = v.shape[-1]
    vv = v.float()[:, :n_valid] if zero_pad else v.float()
    av = vv.reshape(v.shape[0], -1, heads, hw // heads).abs().amax(dim=(1, 3)) + 1e-9
    av = av.repeat_interleave(hw // heads, dim=1)[:, None, :]
    d = (got[..., :hw].float() - ref[..., :hw].float()).abs()
    assert float((d == 0).float().mean()) >= 0.99
    assert bool((d <= 2.0 * av / 127.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,rows,hd,dp,din,zero_pad,n_valid,dout", [
    (256, 200, 64, 192, "bfloat16", False, 197, "bfloat16"),   # attn_int8 block stream
    (256, 256, 64, 256, "bfloat16", True, 197, "bfloat16"),    # the split forward's loose pads
    (256, 197, 64, 192, "bfloat16", True, 197, "bfloat16"),    # xla_int8 deploy
    (256, 197, 64, 192, "float32", True, 197, "float32"),      # the fp32 forward's xla_int8
    (3, 24, 32, 128, "bfloat16", False, 17, "float32"),        # hd 32, a pad-head slot
    (2, 256, 64, 256, "float32", True, 197, "float32"),        # fp32 at 256 rows: the first form
])
def test_mhsa_i8_hopper_on_card(bsz, rows, hd, dp, din, zero_pad, n_valid, dout):
    """K18's Hopper form equal to its first form on every output (the same
    codes, exact int32 sums, each thread's row sum in the first form's key
    order) in all four of DeiT-Tiny's cases at batch 256 and at hd 32, and
    held to its plain version (I8_ATTN_EQUAL, 2 av/127), pad lanes zero; the
    launch took the rule's form (fp32 in at 256 rows: the first form), and
    the plan the library takes equals ``mhsa_i8_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops import int8_attention as TI

    dev = torch.device("cuda")
    rng = np.random.default_rng(300 + rows + hd)
    heads = 3
    hw = heads * hd
    dt, odt = getattr(torch, din), getattr(torch, dout)
    qkv = torch.from_numpy(rng.normal(0, 1.5, (bsz, rows, 3 * dp)).astype(np.float32)).to(dev, dt)
    views = (qkv[..., :hw], qkv[..., dp: dp + hw], qkv[..., 2 * dp: 2 * dp + hw])
    in_f32 = din == "float32"
    TI.mhsa_i8.by_form.clear()
    got = TI.mhsa_i8(*views, heads, n_valid, out_lanes=dp, zero_pad=zero_pad, out_dtype=odt)
    assert dict(TI.mhsa_i8.by_form) == {TI.mhsa_i8_form(rows, n_valid, hd, in_f32): 1}
    TI.mhsa_i8.by_form.clear()
    first = TI.mhsa_i8_first(*views, heads, n_valid, out_lanes=dp, zero_pad=zero_pad,
                             out_dtype=odt)
    assert torch.equal(got, first)
    _i8_held(got, TI.mhsa_i8_plain(*views, heads, n_valid, dp, zero_pad, odt), views[2], heads,
             n_valid, zero_pad)
    assert not got[..., hw:].float().abs().any()
    assert _plan_on_card_n("mhsa_i8", "mhsa_i8_plan", (rows, n_valid, hd, int(in_f32)), 4) == \
        TI.mhsa_i8_plan(rows, n_valid, hd, in_f32)


@pytest.mark.gpu
def test_attention_first_form_guards_on_card():
    """The first forms' wrappers check as the wrappers do on CUDA tensors:
    q/k/v of one dtype, a bf16 or fp32 output, n_valid within the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.attention import mhsa_f32_first
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8, mhsa_i8_first

    dev = torch.device("cuda")
    q, k, v = (torch.randn(2, 17, 96, device=dev) for _ in range(3))
    for fn in (mhsa_i8, mhsa_i8_first):
        with pytest.raises(ValueError, match="share a dtype"):
            fn(q, k, v.to(torch.bfloat16), 3, 17)
        with pytest.raises(ValueError, match="output"):
            fn(q, k, v, 3, 17, out_dtype=torch.float16)
        with pytest.raises(ValueError, match="n_valid"):
            fn(q, k, v, 3, 18)
    with pytest.raises(ValueError, match="n_valid"):
        mhsa_f32_first(q, k, v, 3, 18)
    with pytest.raises(ValueError, match="fp32"):
        mhsa_f32_first(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), 3, 17)


def _basic_pack(rng, c, dev):
    """One identity BasicBlock's pack from seeded fp32 weights quantized per
    channel and fixed site scales (outputs spread over the int8 range)."""
    flat = {n: {"w": torch.from_numpy(rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)),
                "b": torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32))}
            for n in ("b.conv1", "b.conv2")}
    qflat = {n: {"qw": p["qw"].to(dev), "b": p["b"].to(dev)}
             for n, p in quantize_weights(flat, INT8_PER_CHANNEL).items()}
    scales = {n: torch.tensor(v, dtype=torch.float32, device=dev)
              for n, v in (("b.conv1", 0.05), ("b.conv2", 0.35), ("n.conv1", 0.08))}
    return pack_basic_block(qflat, scales, "b", "n.conv1")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("h,c", [(28, 128), (14, 256), (7, 512)])
def test_basic_block_hopper_on_card(h, c, n):
    """K3's Hopper form at every ResNet-18/34 packed shape (28^2 x 128:
    strips of 6 rows, the last one partial; 14^2 x 256 and 7^2 x 512: a
    whole image an item) at batch 1, 3 and 256, inputs over the whole int8
    range (the skip of a negative input) and post-relu: equal on every
    output to its first form and to its plain version; every launch counted
    on the Hopper form; the plan and geometry the kernel takes equal
    ``basic_block_plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.block_fused import (
        basic_block_first, basic_block_form, basic_block_geometry, basic_block_plan,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(9700 + n + h + c)
    pack = _basic_pack(rng, c, dev)
    assert basic_block_form(h, h, c) == "hopper"
    for lo in (0, -127):
        x = _i8(rng, (n, h, h, c), lo=lo).to(dev)
        before = basic_block_fused.by_form["hopper"]
        got = basic_block_fused(x, pack)
        assert basic_block_fused.by_form["hopper"] == before + 1
        first = basic_block_first(x, pack)
        assert torch.equal(got, first), (lo, int((got != first).sum()))
        ref = basic_block_plain(x, pack)
        assert torch.equal(got, ref), (lo, int((got != ref).sum()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = (*basic_block_plan(n, h, h, c, sms), *basic_block_geometry(h, h))
    got_plan = _plan_on_card_n("basic_block", "basic_block_plan", (n, h, h, c, 0), 14)
    assert got_plan == want


@pytest.mark.gpu
def test_basic_block_first_form_on_card():
    """K3's first form by the static rule (C = 64; C = 192, no multiple of
    128; an output grid W + 2 > 85 wide) equal to its plain version,
    counted as such; ``basic_block_first`` refuses a CPU tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.block_fused import basic_block_first, basic_block_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(9750)
    for (n, h, c) in ((2, 56, 64), (1, 14, 192), (1, 90, 128)):
        pack = _basic_pack(rng, c, dev)
        x = _i8(rng, (n, h, h, c), lo=0).to(dev)
        assert basic_block_form(h, h, c) == "first"
        before = basic_block_fused.by_form["first"]
        assert torch.equal(basic_block_fused(x, pack), basic_block_plain(x, pack))
        assert basic_block_fused.by_form["first"] == before + 1
    with pytest.raises(ValueError, match="CUDA"):
        basic_block_first(x.cpu(), pack)


@pytest.mark.gpu
def test_basic_block_scale_alignment_on_card():
    """K3's scales and biases at 4-byte alignment (views one float in): the
    first form takes them (C = 192) and equals its plain version; the
    Hopper form (14^2 x 256) refuses them, its epilogue reading pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9760)
    for c, form in ((192, "first"), (256, "hopper")):
        pack = dict(_basic_pack(rng, c, dev))
        for key in ("s1", "b1", "s2", "b2"):
            pack[key] = torch.cat([pack[key][:1], pack[key]])[1:]
            assert pack[key].data_ptr() % 8 == 4
        x = _i8(rng, (1, 14, 14, c), lo=0).to(dev)
        if form == "first":
            assert torch.equal(basic_block_fused(x, pack), basic_block_plain(x, pack))
        else:
            with pytest.raises(ValueError, match="8-byte aligned"):
                basic_block_fused(x, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 33, 4111, 50431, 50432])
def test_layernorm_hopper_on_card(m, dt):
    """K16's Hopper form at DeiT-Tiny's D = 192, at [50432, 192] (batch 256)
    and ragged M (one row, partial tiles of 32 bf16 / 16 fp32 rows, a tail
    past the persistent grid's last full round): equal on every output to
    its first form, counted on the Hopper form; a misaligned x (a view one
    element in) takes the first form, counted so, with the same outputs;
    from 4111 rows, each form's output within the LayerNorm test's
    tolerance of the plain version of its own x."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.layernorm import (
        layernorm_form, layernorm_fused, layernorm_fused_first, layernorm_fused_plain,
    )

    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    rng = np.random.default_rng(9600 + m)
    d = 192
    base = torch.from_numpy(rng.normal(0.3, 1.0, (m * d + 1,)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev, dtype)
    assert layernorm_form(m, d, dtype) == "hopper"
    for off, form in ((0, "hopper"), (1, "first")):
        x = base[off: off + m * d].view(m, d)
        before = layernorm_fused.by_form[form]
        got = layernorm_fused(x, g, b)
        assert layernorm_fused.by_form[form] == before + 1
        first = layernorm_fused_first(x, g, b)
        assert torch.equal(got, first), int((got != first).sum())
        if m < 4111:   # the plain version's agreement is a fraction: held where it means one
            continue
        plain = layernorm_fused_plain(x, g, b)
        _agree(got, plain, 0.99 if dtype == torch.bfloat16 else 1.0,
               1e-4 if dtype == torch.float32 else 2.0 ** -7 * (1.0 + float(plain.float().abs().max())),
               2.0 ** -19 if dtype == torch.float32 else 0.0)


@pytest.mark.gpu
def test_layernorm_first_form_rule_on_card():
    """K16's first form by the static rule: rows not a multiple of 16 bytes
    (bf16 D = 100) and rows past the registers (D = 600), counted as such,
    equal to ``layernorm_fused_first``; the first form refuses a CPU tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.layernorm import layernorm_form, layernorm_fused, layernorm_fused_first

    dev = torch.device("cuda")
    for d in (100, 600):
        x = torch.randn(37, d, device=dev).to(torch.bfloat16)
        g, b = torch.ones(d, device=dev, dtype=torch.bfloat16), torch.zeros(d, device=dev,
                                                                            dtype=torch.bfloat16)
        assert layernorm_form(37, d, torch.bfloat16) == "first"
        before = layernorm_fused.by_form["first"]
        assert torch.equal(layernorm_fused(x, g, b), layernorm_fused_first(x, g, b))
        assert layernorm_fused.by_form["first"] == before + 1
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_fused_first(x.cpu(), g.cpu(), b.cpu())


# MobileNetV2 1.0x's ten distinct depthwise shapes (H, C, stride), and odd
# ones: C = 40 (8-byte granules), odd H and W, stride 2 from an odd H
MNV2_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1), (28, 192, 2),
           (14, 384, 1), (14, 576, 1), (14, 576, 2), (7, 960, 1)]
DW_ODD = [(9, 40, 1, 9), (13, 40, 2, 11), (7, 24, 2, 5), (15, 16, 2, 15)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MNV2_DW + DW_ODD)
def test_depthwise_kernel_on_card(case):
    """K23 bit-identical to its plain version with both epilogues (fp32 out,
    no activation; int8 out with relu6, y spread past 6, at output scales
    whose 6 / s is above and below 127; int8 out with relu), counted once a
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.depthwise_int8 import (
        depthwise_int8, depthwise_int8_plain, pack_depthwise_weight,
    )

    h, c, s, w = case if len(case) == 4 else (*case, case[0])
    dev = torch.device("cuda")
    rng = np.random.default_rng(h * 1000 + c + s)
    x = _i8(rng, (2, h, w, c)).to(dev)
    pk = pack_depthwise_weight(_i8(rng, (3, 3, 1, c)).to(dev))
    scale, bias = _epi(rng, c, 9, dev)
    for relu, relu6, osc in ((False, False, None), (False, True, 0.025), (True, False, 0.1),
                             (False, True, 0.1)):
        sc = scale * 6.0 if relu6 else scale
        before = depthwise_int8.launches
        got = depthwise_int8(x, pk, s, 1, sc, bias, relu=relu, out_scale=osc, relu6=relu6)
        assert depthwise_int8.launches == before + 1
        ref = depthwise_int8_plain(x, pk, s, 1, sc, bias, relu=relu, out_scale=osc,
                                   relu6=relu6)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (relu, relu6, osc)


@pytest.mark.gpu
def test_depthwise_kernel_refuses_on_card():
    """K23 raises on a C that is not a multiple of 8, a misaligned input and
    a scale of the wrong length, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.depthwise_int8 import depthwise_int8, pack_depthwise_weight

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    before = depthwise_int8.launches
    pk = pack_depthwise_weight(_i8(rng, (3, 3, 1, 12)).to(dev))
    scale, bias = _epi(rng, 12, 9, dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        depthwise_int8(_i8(rng, (1, 8, 8, 12)).to(dev), pk, 1, 1, scale, bias)
    pk = pack_depthwise_weight(_i8(rng, (3, 3, 1, 16)).to(dev))
    scale, bias = _epi(rng, 16, 9, dev)
    buf = _i8(rng, (1 * 8 * 8 * 16 + 8,)).to(dev)
    with pytest.raises(ValueError, match="aligned"):
        depthwise_int8(buf[8:].view(1, 8, 8, 16), pk, 1, 1, scale, bias)
    with pytest.raises(ValueError, match="fp32"):
        depthwise_int8(_i8(rng, (1, 8, 8, 16)).to(dev), pk, 1, 1, scale[:8].contiguous(), bias)
    assert depthwise_int8.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", MNV2_DW + DW_ODD)
def test_depthwise_hopper_form_on_card(case):
    """K23 at each case on the form its rule names (the library's rule equal
    to the mirror ``depthwise_form``: the Hopper form at every MobileNetV2
    shape and at 15 x 15 x 16 / s2, the first form at C = 40 and 24),
    counted in ``by_form``; bit-identical to the plain version and to
    ``depthwise_int8_first`` with both epilogues and relu; the library's
    plan equal to the mirror ``depthwise_hopper_plan`` at batch 2 and 256 on
    this card's SMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.depthwise_int8 import (
        depthwise_form, depthwise_hopper_plan, depthwise_int8, depthwise_int8_first,
        depthwise_int8_plain, library_form, library_plan, pack_depthwise_weight,
    )

    h, c, s, w = case if len(case) == 4 else (*case, case[0])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    form = depthwise_form(2, h, w, c, 3, 3, s, 1)
    assert library_form(2, h, w, c, 3, 3, s, 1) == form
    assert form == ("first" if c % 16 else "hopper")
    for n in (2, 256):
        assert library_plan(n, h, w, c, s, sms) == depthwise_hopper_plan(n, h, w, c, s, sms)
    rng = np.random.default_rng(h * 1000 + c + s + 7)
    x = _i8(rng, (2, h, w, c)).to(dev)
    pk = pack_depthwise_weight(_i8(rng, (3, 3, 1, c)).to(dev))
    scale, bias = _epi(rng, c, 9, dev)
    for relu, relu6, osc in ((False, False, None), (False, True, 0.025), (True, False, 0.1),
                             (False, True, 0.1), (True, False, None)):
        sc = scale * 6.0 if relu6 else scale
        args = (x, pk, s, 1, sc, bias, relu, osc, relu6)
        before = depthwise_int8.by_form[form]
        got = depthwise_int8(*args)
        assert depthwise_int8.by_form[form] == before + 1
        assert torch.equal(got, depthwise_int8_plain(*args)), (relu, relu6, osc)
        assert torch.equal(got, depthwise_int8_first(*args)), (relu, relu6, osc)
    with pytest.raises(ValueError, match="CUDA"):
        depthwise_int8_first(x.cpu(), pk, s, 1, scale, bias)


def _dw_forced(scale, bias, force):
    """K23's epilogue parameters off requant4's fast path, y / s spread over
    the int8 range: "s_small" / "s_large" an output scale of 2^-31 / 2^31
    (scale and bias scaled with it), "quad" s = 0.1 with a bias of +-1e18 in
    channel 8k and a scale of 1e13 in channel 16k + 5 (those quads take
    requant_exact, the others the fast path, in one launch)."""
    scale = scale * 6.0
    if force == "quad":
        scale, bias = scale.clone(), bias.clone()
        sign = torch.where(torch.arange(bias[0::8].numel(), device=bias.device) % 2 == 1, -1.0, 1.0)
        bias[0::8] = 1e18 * sign
        scale[5::16] = 1e13
        return scale, bias, 0.1
    s = 2.0 ** -31 if force == "s_small" else 2.0 ** 31
    return scale * (s / 0.1), bias * (s / 0.1), s


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(112, 32, 1), (14, 576, 2), (15, 16, 2, 15)])
@pytest.mark.parametrize("force", ["s_small", "s_large", "quad"])
def test_depthwise_hopper_exact_fallback_on_card(case, force):
    """K23's Hopper form off its int8 fast path (``requant4``'s
    ``requant_exact`` branch: an output scale outside [2^-30, 2^30], or a
    quad whose |scale| or |bias| could put |y| past 2^60), with relu6, relu
    and no activation: on the Hopper form, bit-identical to the plain
    version and to ``depthwise_int8_first``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.depthwise_int8 import (
        depthwise_int8, depthwise_int8_first, depthwise_int8_plain, pack_depthwise_weight,
    )

    h, c, s, w = case if len(case) == 4 else (*case, case[0])
    dev = torch.device("cuda")
    rng = np.random.default_rng(h * 1000 + c + s + 11)
    x = _i8(rng, (2, h, w, c)).to(dev)
    pk = pack_depthwise_weight(_i8(rng, (3, 3, 1, c)).to(dev))
    scale, bias, osc = _dw_forced(*_epi(rng, c, 9, dev), force)
    for relu, relu6 in ((False, True), (True, False), (False, False)):
        args = (x, pk, s, 1, scale, bias, relu, osc, relu6)
        before = depthwise_int8.by_form["hopper"]
        got = depthwise_int8(*args)
        assert depthwise_int8.by_form["hopper"] == before + 1
        assert torch.equal(got, depthwise_int8_plain(*args)), (force, relu, relu6)
        assert torch.equal(got, depthwise_int8_first(*args)), (force, relu, relu6)


@pytest.mark.gpu
def test_relu6_epilogues_of_k1_k2_on_card():
    """K1 and K2 with relu6 and int8 out (and fp32 out) bit-identical to
    their plain versions at MobileNetV2's shapes: the C = 3 -> 32 3x3/s2/p1
    stem (first form), expand convs K = 16 -> 96 (Hopper form) and K = 24
    -> 144 (first form, K % 16 != 0), a project conv to N = 24 (int8 rows
    not 16-byte multiples: the unaligned store branch) and N = 16, the head
    320 -> 1280, at output scales whose 6 / s is below and above 127."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(0, 1, (2, 31, 33, 3)).astype(np.float32))
    xq = torch.clamp(torch.round(x / 0.02), -127, 127).to(torch.int8).to(dev)
    pk = pack_conv_weight(_i8(rng, (3, 3, 3, 32)).to(dev))
    scale, bias = _epi(rng, 32, 27, dev)
    for osc in (0.025, 0.1, None):
        args = (xq, pk, 2, 1, scale * 6.0, bias, False, osc)
        assert torch.equal(conv_int8(*args, relu6=True), conv_int8_plain(*args, relu6=True))
    for (m, k, n) in [(700, 16, 96), (700, 24, 144), (700, 144, 24), (700, 96, 16),
                      (98, 320, 1280)]:
        xm = _i8(rng, (m, k)).to(dev)
        pk = pack_dense_weight(_i8(rng, (k, n)).to(dev))
        scale, bias = _epi(rng, n, k, dev)
        for relu6, osc in ((True, 0.025), (True, 0.1), (True, None), (False, 0.025)):
            args = (xm, pk, scale * 6.0 if relu6 else scale, bias, False, osc)
            assert torch.equal(matmul_int8(*args, relu6=relu6),
                               matmul_int8_plain(*args, relu6=relu6)), (m, k, n, relu6, osc)


def _dynamic_comb(x: torch.Tensor, w_scale: torch.Tensor):
    """The int8 codes of ``x`` at its run-time scale and the combined
    epilogue scale, as DynamicDeployCtx computes them on the card (the
    scale a 0-dim device tensor that never reaches the host)."""
    from dlq_tpu_torch.quant.quantize import quantize_act

    lo, hi = torch.aminmax(x)
    s = torch.clamp_min(torch.maximum(hi, -lo) * torch.tensor(np.float32(1) / np.float32(127),
                                                               device=x.device), 1e-12)
    return quantize_act(x, s), (w_scale * s).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 256])
def test_lenet_convs_on_card(n):
    """K1 at LeNet-5's two convs (5x5, pad 0: C = 1 -> 6 on the zero-padded
    32^2 input, C = 6 -> 16 at 14^2; both on the first form, OC 6 and 16:
    scalar stores), with the input's codes and the epilogue scale from a
    run-time scale computed on the card, bit-identical to the plain version
    with fp32 and int8 out, relu on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import torch.nn.functional as F

    from dlq_tpu_torch.ops.i8plan import conv_int8_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(8100 + n)
    x1 = F.pad(torch.from_numpy(rng.normal(0, 1, (n, 28, 28, 1)).astype(np.float32)).to(dev),
               (0, 0, 2, 2, 2, 2))
    x2 = torch.from_numpy(rng.uniform(0, 2, (n, 14, 14, 6)).astype(np.float32)).to(dev)
    for x, c, oc in ((x1, 1, 6), (x2, 6, 16)):
        pk = pack_conv_weight(_i8(rng, (5, 5, c, oc)).to(dev))
        w_scale = torch.from_numpy(rng.uniform(0.002, 0.01, oc).astype(np.float32)).to(dev)
        xq, comb = _dynamic_comb(x, w_scale)
        assert xq.data_ptr() % 16 == 0
        bias = torch.from_numpy(rng.normal(0, 0.3, oc).astype(np.float32)).to(dev)
        h = x.shape[1]
        for relu, osc in ((False, None), (True, None), (False, 0.05), (True, 0.05)):
            assert conv_int8_form(h, h, c, oc, 5, 1, 0, osc is not None) == "first"
            before = conv_int8.by_form["first"]
            args = (xq, pk, 1, 0, comb, bias, relu, osc)
            assert torch.equal(conv_int8(*args), conv_int8_plain(*args)), (c, relu, osc)
            assert conv_int8.by_form["first"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [84, 120, 400, 784])
@pytest.mark.parametrize("n", [10, 84, 120, 256])
def test_mnist_dense_on_card(k, n):
    """K2 at the MNIST models' dense shapes and their neighbours: N = 10,
    84, 120, 256 against K = 84, 120 (first form: K % 16 != 0), 400 and
    784 (Hopper form), at M = 256 and a ragged 37, fp32 (N = 10: 40-byte
    rows) and int8 out (rows not 16-byte multiples but at 256), relu on
    and off; the codes and epilogue scale from a run-time scale computed on
    the card; bit-identical to the plain version, counted on its form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.ops.i8plan import matmul_int8_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(8200 + k + n)
    pk = pack_dense_weight(_i8(rng, (k, n)).to(dev))
    w_scale = torch.from_numpy(rng.uniform(0.002, 0.01, n).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)).to(dev)
    for m in (256, 37):
        x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
        xq, comb = _dynamic_comb(x, w_scale)
        for relu, osc in ((False, None), (True, None), (False, 0.05), (True, 0.05)):
            form = matmul_int8_form(k)
            before = matmul_int8.by_form[form]
            args = (xq, pk, comb, bias, relu, osc)
            assert torch.equal(matmul_int8(*args), matmul_int8_plain(*args)), (m, relu, osc)
            assert matmul_int8.by_form[form] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["lenet5", "mlp"])
def test_mnist_engines_on_card(model, tmp_path):
    """LeNet-5 and the MLP quantized on the card (Engine.quantized,
    save_quantized), served by Engine.from_store under ctx="deploy" and
    "dynamic": logits bit-identical to the same stores served on the CPU
    (the plain versions), the dynamic forward making no synchronizing call
    (set_sync_debug_mode("error")), and the launches per forward (LeNet-5:
    K1 2, K2 3; MLP: K2 2, no K1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models import get_model, lenet, mlp
    from dlq_tpu_torch.quant.store import save_quantized

    mod = lenet if model == "lenet5" else mlp
    cfg, init, _ = get_model(model)
    rng = np.random.default_rng(8300)
    shape = (28, 28, 1) if model == "lenet5" else (784,)
    calib = [rng.normal(0, 1, (8,) + shape).astype(np.float32)]
    x = rng.normal(0, 1, (64,) + shape).astype(np.float32)
    q = Engine.quantized(mod.qforward, mod.flatten_params(init(0, cfg)), cfg, INT8_PER_CHANNEL,
                         calib_batches=calib, batch=64)
    meta = {"config": {"num_classes": 10, "in_channels": 1}} if model == "lenet5" else {}
    save_quantized(str(tmp_path), model, q.qflat, q.act_scales, INT8_PER_CHANNEL, meta=meta)
    want = {"lenet5": (2, 3), "mlp": (0, 2)}[model]
    for ctx in ("deploy", "dynamic"):
        eng = Engine.from_store(str(tmp_path), ctx=ctx, batch=64)
        cpu = Engine.from_store(str(tmp_path), ctx=ctx, batch=64, device="cpu")
        xt = torch.from_numpy(x).to(eng.device)
        eng._fn(eng.params, xt)
        conv_int8.launches = matmul_int8.launches = 0
        torch.cuda.synchronize()
        with torch.inference_mode():
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = eng._fn(eng.params, xt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert (conv_int8.launches, matmul_int8.launches) == want, ctx
        assert torch.equal(got.cpu(), cpu(x)), ctx
