"""uint8 image ingest in the port: the preprocess fold in ResNet's
``FullFusedCtx.conv_stem_bf16_u8`` (through ``qforward_fused2``) and in
DeiT's ``embed_tokens``, against the JAX package's on the same
numpy-seeded weights and images, and against the normalized fp32 input.

Tolerances: the stem's int8 codes and the patch embedding's bf16 values
are fp32 sums of the same bf16 operands in another order, so at most 1e-3
of them land one step apart (none further); the logits against the
reference's on uint8 at cosine >= 0.9999 and top-1 1.0; against the
port's own forward on the normalized image at cosine > 0.999 and top-1 1.0
(the reference's ``tests/test_uint8_ingest.py:39-40``), the stem taps on
> 0.93 of elements equal and at most one step apart (``:64-67``).

Sizes: ResNet-18 at 64 px (the 7x7/s2 stem and maxpool) with widths
16-128, 16 classes, batch 2; DeiT at 32 px, patch 8, dim 96, depth 2,
batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.data.preprocess import IMAGENET_MEAN as J_MEAN
from dlq_tpu.data.preprocess import IMAGENET_STD as J_STD
from dlq_tpu.models import resnet as JR
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu_torch import numerics
from dlq_tpu_torch import preprocess as TPP
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ
from test_torch_port_vit_kernels import qfields, quantized_vit

FIRST = "layer1.0.conv1"
STEP_SHARE = 1e-3   # codes / bf16 values one step apart (sum order)


def _images(seed, n, size):
    u8 = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    xn = ((u8.astype(np.float32) / 255.0 - J_MEAN) / J_STD).astype(np.float32)
    return u8, xn


def test_port_constants_are_the_references():
    np.testing.assert_array_equal(TPP.IMAGENET_MEAN, J_MEAN)
    np.testing.assert_array_equal(TPP.IMAGENET_STD, J_STD)
    assert TPP.IMAGENET_MEAN.dtype == TPP.IMAGENET_STD.dtype == np.float32


@pytest.fixture(scope="module")
def r18():
    widths = (16, 32, 64, 128)
    cfg_t = TR.ResNetConfig(depth=18, num_classes=16, widths=widths)
    cfg_j = JR.ResNetConfig(depth=18, num_classes=16, widths=widths)
    flat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(0, cfg_t), cfg_t))
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in flat.items()}
    u8, xn = _images(0, 2, 64)
    scales = j_calibrate(JM.make_sites_fn(JR.qforward, cfg_j), jflat, [jnp.asarray(xn)], JQ)
    qflat = JM.quantize_weights(jflat, JQ)
    tq, ts = from_jax_qflat(qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, qflat=qflat, scales=scales, u8=u8, xn=xn,
                tctx=TM.FullFusedCtx(tq, ts, TQ))


def _step_apart(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    return float((d != 0).mean()), int(d.max())


def test_u8_stem_and_fused2_match_jax(r18):
    """The folded stem's int8 codes and the fused2 logits on uint8 against
    the reference's jitted forward on the same store."""
    u8 = r18["u8"]
    jstem = jax.jit(lambda q, s, x: JM.FullFusedCtx(q, s, JQ).conv_stem_bf16_u8(
        "stem", x, out_site=FIRST).q)(r18["qflat"], r18["scales"], jnp.asarray(u8))
    with torch.inference_mode():
        tstem = r18["tctx"].conv_stem_bf16_u8("stem", torch.from_numpy(u8), out_site=FIRST)
    assert tstem.q.dtype == torch.int8 and tstem.scale == np.float32(r18["scales"][FIRST])
    share, worst = _step_apart(tstem.q.numpy(), np.asarray(jstem))
    assert share <= STEP_SHARE and worst <= 1, (share, worst)
    ref = np.asarray(jax.jit(lambda q, s, x: JR.qforward_fused2(JM.FullFusedCtx(q, s, JQ), x,
                                                                r18["cfg_j"]))(
        r18["qflat"], r18["scales"], jnp.asarray(u8)))
    with torch.inference_mode():
        got = TR.qforward_fused2(r18["tctx"], torch.from_numpy(u8), r18["cfg_t"])
    assert numerics.diff(got, ref).cosine >= 0.9999
    assert numerics.top1_agreement(got, ref) == 1.0


def test_u8_matches_normalized_fp32(r18):
    """The port on uint8 against the port on the normalized fp32 image (the
    same bf16 stem, the normalize in another order), and the two stems'
    taps (``tests/test_uint8_ingest.py``)."""
    ctx, cfg = r18["tctx"], r18["cfg_t"]
    with torch.inference_mode():
        got = TR.qforward_fused2(ctx, torch.from_numpy(r18["u8"]), cfg)
        ref = TR.qforward_fused2(ctx, torch.from_numpy(r18["xn"]), cfg)
        a = ctx.conv_stem_bf16("stem", torch.from_numpy(r18["xn"]), out_site=FIRST).q.numpy()
        b = ctx.conv_stem_bf16_u8("stem", torch.from_numpy(r18["u8"]), out_site=FIRST).q.numpy()
    assert numerics.diff(got, ref).cosine > 0.999
    assert numerics.top1_agreement(got, ref) == 1.0
    assert float((a == b).mean()) > 0.93
    assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 1


def test_u8_fold_other_mean_std(r18):
    """Caller-given mean and std fold the same way in both packages."""
    mean = np.array([0.5, 0.4, 0.3], np.float32)
    std = np.array([0.25, 0.2, 0.3], np.float32)
    u8 = r18["u8"]
    jstem = jax.jit(lambda q, s, x: JM.FullFusedCtx(q, s, JQ).conv_stem_bf16_u8(
        "stem", x, out_site=FIRST, mean=mean, std=std).q)(r18["qflat"], r18["scales"],
                                                          jnp.asarray(u8))
    with torch.inference_mode():
        t = r18["tctx"].conv_stem_bf16_u8("stem", torch.from_numpy(u8), out_site=FIRST,
                                          mean=mean, std=std)
    share, worst = _step_apart(t.q.numpy(), np.asarray(jstem))
    assert share <= STEP_SHARE and worst <= 1, (share, worst)


@pytest.fixture(scope="module")
def deit():
    m = quantized_vit("d96", depth=2, bias_std=0.05)
    m["jpack"] = JB.pack_vit_blocks_w8(m["qflat"], m["scales"], m["ex"], m["jcfg"], tight=True)
    m["tpack"] = TB.pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"], tight=True)
    m["u8"], m["xn"] = _images(5, 4, 32)
    return m


def _bf16_steps(got: torch.Tensor, ref) -> tuple:
    """Share of bf16 values that differ, and the largest difference in bf16
    steps (units in the last place of the larger magnitude)."""
    g = got.float().numpy()
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    mag = np.maximum(np.abs(g), np.abs(r))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7), 1.0)
    return float((g != r).mean()), float((np.abs(g - r) / ulp).max())


def test_embed_tokens_u8_matches_jax(deit):
    """``embed_tokens`` on uint8 (the fold into the bf16 patch weights and
    the shift) against the reference's conv form, jitted as its forwards
    run it (XLA keeps the shifted image unrounded inside the fused conv)."""
    embed = jax.jit(JB.embed_tokens, static_argnums=2)
    ref = embed(deit["jpack"], jnp.asarray(deit["u8"]), deit["jcfg"])
    got = TB.embed_tokens(deit["tpack"], torch.from_numpy(deit["u8"]), deit["tcfg"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(ref.shape)
    share, steps = _bf16_steps(got, ref)
    assert share <= STEP_SHARE and steps <= 1.0, (share, steps)
    mean, std = np.array([0.5, 0.5, 0.5], np.float32), np.array([0.5, 0.25, 0.2], np.float32)
    ref = jax.jit(lambda p, x: JB.embed_tokens(p, x, deit["jcfg"], mean=mean, std=std))(
        deit["jpack"], jnp.asarray(deit["u8"]))
    got = TB.embed_tokens(deit["tpack"], torch.from_numpy(deit["u8"]), deit["tcfg"], mean=mean,
                          std=std)
    share, steps = _bf16_steps(got, ref)
    assert share <= STEP_SHARE and steps <= 1.0, (share, steps)


def test_deit_block_u8_matches_jax_and_normalized(deit):
    """The W8A8 block forward (plain versions) on uint8 against the
    reference's (interpret mode) on uint8, and against the port's own on
    the normalized image (the cosine the CPU finds here is what the card's
    gate sits under: see ``chip_smoke.py``'s ptq phase)."""
    x = deit["u8"]
    ref = np.asarray(JB.vit_forward_blockfused_w8(deit["jpack"], jnp.asarray(x), deit["jcfg"],
                                                  tight=True, interpret=True))
    got = TB.vit_forward_blockfused_w8(deit["tpack"], torch.from_numpy(x), deit["tcfg"],
                                       tight=True)
    assert numerics.diff(got, ref).cosine >= 0.9999
    assert numerics.top1_agreement(got, ref) == 1.0
    norm = TB.vit_forward_blockfused_w8(deit["tpack"], torch.from_numpy(deit["xn"]), deit["tcfg"],
                                        tight=True)
    assert numerics.diff(got, norm).cosine > 0.999
