"""The JAX reference's own errors on the weights, calibration sets and
inputs of ``chip_smoke.py``'s ``ptq`` phase, on the CPU.

- ResNet-18 (224 px, 1000 classes, the port's numpy-seeded ``init_resnet``,
  seed 0; calibration on 8 images of seed 18): ``ptq_auto(smooth="off")``
  at INT8_PER_CHANNEL as round-to-nearest, GPTQ, and GPTQ + bias
  correction, each under ``DeployCtx`` (``qforward``) and ``FullFusedCtx``
  (``qforward_fused2``), jitted, against the fp32 folded forward.
- DeiT-Tiny (224 px, seed 0; calibration on two batches of 8 images of
  seeds 26 and 27): ``ptq_auto(smooth="auto",
  smooth_site_filter=VIT_LN_FOLDABLE)`` at INT8_PER_CHANNEL (the chosen
  alpha), the vectors folded into the LN affines, the W8A8 block forward
  (``vit_forward_multiblock_w8``, 6 layers per chunk, interpret mode)
  against the sitewise ``SmoothDeployCtx`` forward (tanh GELU, jitted) and
  both against the fp32 forward (tanh GELU); the same smoothed weights at
  INT4A8_PER_CHANNEL through ``vit_forward_blockfused_w4a8c`` against their
  sitewise forward and fp32.
- QAT: three ``make_qat_step`` steps on ResNet-18 at 224 px, batch 32 (the
  first 32 images, labels of seed 32), INT4A8_PER_CHANNEL, lr 0.001; then
  ``qforward(QATCtx)`` against ``DeployCtx(quantize_weights(flat))`` on the
  trained weights. The reference's step cannot differentiate this
  topology's maxpool (``lax.reduce_window``); the line then carries the
  error.
- Mixed precision: ``auto_mixed_qconfig`` over the ResNet-18 Hessians at
  INT4A8_PER_CHANNEL with a budget halfway between all-int4 and all-int8,
  under ``DeployCtx``, against fp32.
- uint8: ResNet-18 ``fused2`` on the round-to-nearest store and the DeiT
  block forward on the smoothed W8A8 pack, each on uint8 images (seed 8)
  against the normalized fp32 images; and the two ResNet stems' int8 codes.

So the numbers say how close to fp32 (and to each other) the card's PTQ
paths can be asked to come.

    python scripts/ptq_reference_error.py [--images 16] [--parts resnet18,qat,deit]

Prints one JSON line per path: logits cosine, largest logit difference and
top-1 agreement.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dlq_tpu.data.preprocess import IMAGENET_MEAN, IMAGENET_STD  # noqa: E402
from dlq_tpu.models import resnet as JR  # noqa: E402
from dlq_tpu.models import vit as JV  # noqa: E402
from dlq_tpu.ops import pallas_vit_block as JB  # noqa: E402
from dlq_tpu.quant import model_quant as JM  # noqa: E402
from dlq_tpu.quant.calibrate import calibrate  # noqa: E402
from dlq_tpu.quant.gptq import collect_hessians  # noqa: E402
from dlq_tpu.quant.qat import QATCtx, make_qat_step  # noqa: E402
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL, INT8_PER_CHANNEL  # noqa: E402
from dlq_tpu.quant.recipe import VIT_LN_FOLDABLE, ptq_auto  # noqa: E402
from dlq_tpu.quant.sensitivity import _stored_bytes, auto_mixed_qconfig  # noqa: E402
from dlq_tpu.quant.quantize import effective_weight_scheme  # noqa: E402
from dlq_tpu.quant.smooth import (  # noqa: E402
    SmoothDeployCtx, apply_smooth, fold_smooth_into_ln_extras, search_smooth_alpha,
)
from dlq_tpu_torch.models.resnet import ResNetConfig, init_resnet  # noqa: E402
from dlq_tpu_torch.models.vit import ViTConfig, init_vit  # noqa: E402

SEED = 0
R18_CALIB_SEED = SEED + 18            # chip_smoke.py: the ResNet-18 calibration batch
DEIT_CALIB_SEEDS = (SEED + 26, SEED + 27)   # chip_smoke.py: PTQ_DEIT_CALIB_SEEDS
QAT_LABEL_SEED = SEED + 32            # chip_smoke.py: PTQ_QAT_LABEL_SEED
U8_SEED = SEED + 8                    # chip_smoke.py: PTQ_U8_SEED
QAT_BATCH = 32
QAT_LR = 0.001                        # chip_smoke.py: PTQ_QAT_LR
FIRST = "layer1.0.conv1"


def diff(got, ref) -> dict:
    """Logits cosine, largest difference and top-1 agreement."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    a, b = got.reshape(-1), ref.reshape(-1)
    return {"logits_cosine": float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)),
            "logit_err_max": float(np.abs(got - ref).max()),
            "top1_agreement": float((got.argmax(-1) == ref.argmax(-1)).mean())}


def jtree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def emit(obj) -> None:
    print(json.dumps({**obj, "platform": "cpu"}), flush=True)


def normalized(u8):
    return ((u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def resnet18(x, u8):
    cfg = JR.ResNetConfig(depth=18, num_classes=1000)
    params = jtree(init_resnet(SEED, ResNetConfig(depth=18, num_classes=1000)))
    folded = JR.fold_resnet(params, cfg)
    flat = JR.flatten_folded(folded)
    calib = [np.random.default_rng(R18_CALIB_SEED).normal(0, 1, (8, 224, 224, 3))
             .astype(np.float32)]
    ref = np.asarray(jax.jit(lambda p, xb: JR.folded_forward(p, xb, cfg))(folded, x))
    deploy = jax.jit(lambda q, s, xb: JR.qforward(JM.DeployCtx(q, s, INT8_PER_CHANNEL), xb, cfg))
    fused2 = jax.jit(lambda q, s, xb: JR.qforward_fused2(JM.FullFusedCtx(q, s, INT8_PER_CHANNEL),
                                                         xb, cfg))
    stores = {}
    for name, kw in (("rtn", dict(gptq=False, bias_correct=False)),
                     ("gptq", dict(bias_correct=False)), ("gptq_bc", {})):
        qflat, scales, _ = ptq_auto(JR.qforward, flat, cfg, calib, INT8_PER_CHANNEL,
                                    smooth="off", **kw)
        stores[name] = (qflat, scales)
        for ctx, fn in (("deploy", deploy), ("fused2", fused2)):
            emit({"path": f"resnet18_{name}_{ctx}", "images": len(x), "vs": "fp32",
                  **diff(fn(qflat, scales, jnp.asarray(x)), ref)})

    col = collect_hessians(JR.qforward, flat, cfg, calib)
    qlo = INT4A8_PER_CHANNEL
    lo = sum(_stored_bytes(int(np.prod(p["w"].shape)),
                           effective_weight_scheme(p["w"].shape, qlo.scheme_for(s)))
             for s, p in flat.items())
    hi = sum(int(np.prod(p["w"].shape)) for p in flat.values())
    mixed = auto_mixed_qconfig(flat, col, qlo, budget_bytes=(lo + hi) // 2)
    scales = stores["rtn"][1]
    got = jax.jit(lambda q, s, xb: JR.qforward(JM.DeployCtx(q, s, mixed), xb, cfg))(
        JM.quantize_weights(flat, mixed), scales, jnp.asarray(x))
    emit({"path": "resnet18_mixed_deploy", "images": len(x), "vs": "fp32",
          "budget_bytes": (lo + hi) // 2, "all_int4_bytes": lo, "all_int8_bytes": hi,
          "int8_sites": [s for s, _ in mixed.weight_overrides], **diff(got, ref)})

    qflat, scales = stores["rtn"]
    xn = normalized(u8)
    a = fused2(qflat, scales, jnp.asarray(u8))
    b = fused2(qflat, scales, jnp.asarray(xn))
    stem = jax.jit(lambda q, s, xb: JM.FullFusedCtx(q, s, INT8_PER_CHANNEL).conv_stem_bf16(
        "stem", xb, out_site=FIRST).q)
    stem_u8 = jax.jit(lambda q, s, xb: JM.FullFusedCtx(q, s, INT8_PER_CHANNEL)
                      .conv_stem_bf16_u8("stem", xb, out_site=FIRST).q)
    qa = np.asarray(stem(qflat, scales, jnp.asarray(xn)), np.int32)
    qb = np.asarray(stem_u8(qflat, scales, jnp.asarray(u8)), np.int32)
    emit({"path": "resnet18_rtn_fused2_uint8", "images": len(u8), "vs": "normalized fp32",
          "stem_codes_equal": float((qa == qb).mean()),
          "stem_codes_max_diff": int(np.abs(qa - qb).max()), **diff(a, b)})


def qat(x):
    cfg = JR.ResNetConfig(depth=18, num_classes=1000)
    params = jtree(init_resnet(SEED, ResNetConfig(depth=18, num_classes=1000)))
    flat = JR.flatten_folded(JR.fold_resnet(params, cfg))
    qcfg = INT4A8_PER_CHANNEL
    xb = jnp.asarray(x[:QAT_BATCH])
    y = jnp.asarray(np.random.default_rng(QAT_LABEL_SEED).integers(0, 1000, QAT_BATCH),
                    jnp.int32)
    scales = calibrate(JM.make_sites_fn(JR.qforward, cfg), flat, [xb], qcfg)
    step = make_qat_step(JR.qforward, cfg, qcfg, lr=QAT_LR)
    vel = jax.tree_util.tree_map(jnp.zeros_like, flat)
    losses = []
    try:
        for _ in range(3):
            flat, vel, scales, loss, _ = step(flat, vel, scales, xb, y)
            losses.append(float(loss))
    except ValueError as e:
        # the 224 px topology's maxpool (lax.reduce_window) does not
        # linearize in the reference's training step
        emit({"path": "resnet18_qat_deploy_parity", "images": QAT_BATCH,
              "error": f"{type(e).__name__}: {str(e).splitlines()[0]}"})
        return
    sim = jax.jit(lambda f, s, xx: JR.qforward(QATCtx(f, s, qcfg), xx, cfg))(flat, scales, xb)
    dep = jax.jit(lambda q, s, xx: JR.qforward(JM.DeployCtx(q, s, qcfg), xx, cfg))(
        JM.quantize_weights(flat, qcfg), scales, xb)
    emit({"path": "resnet18_qat_deploy_parity", "images": QAT_BATCH, "steps": 3,
          "losses": losses, "vs": "QATCtx", **diff(dep, sim)})


def deit(x, u8):
    cfg = JV.ViTConfig()
    params = jtree(init_vit(SEED, ViTConfig()))
    flat, ex = JV.flatten_vit(params), JV.vit_extras(params)
    qf = JV.make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    qf_tanh = JV.make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim, gelu="tanh")
    calib = [np.random.default_rng(s).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
             for s in DEIT_CALIB_SEEDS]
    ref = np.asarray(jax.jit(lambda p, xb: JV.vit_forward(p, xb, JV.ViTConfig(gelu="tanh")))(
        params, jnp.asarray(x)))
    sm_search, alpha = search_smooth_alpha(qf, flat, cfg, calib, INT8_PER_CHANNEL,
                                           site_filter=VIT_LN_FOLDABLE)
    qflat, scales, sm = ptq_auto(qf, flat, cfg, calib, INT8_PER_CHANNEL,
                                 smooth_site_filter=VIT_LN_FOLDABLE)
    emit({"path": "deit_ptq_auto", "alpha": alpha, "smooth_sites": len(sm),
          "same_vectors_as_search": all(np.array_equal(sm[k], sm_search[k]) for k in sm)})
    folded = fold_smooth_into_ln_extras(ex, sm)
    block = JB.vit_forward_multiblock_w8(JB.pack_vit_blocks_w8(qflat, scales, folded, cfg,
                                                               tight=True),
                                         jnp.asarray(x), cfg, layers_per_kernel=6,
                                         interpret=True)
    site = jax.jit(lambda q, s, xb: qf_tanh(SmoothDeployCtx(q, s, INT8_PER_CHANNEL, sm), xb, cfg))(
        qflat, scales, jnp.asarray(x))
    emit({"path": "deit_smooth_block", "images": len(x), "vs": "fp32 (tanh)", **diff(block, ref)})
    emit({"path": "deit_smooth_sitewise", "images": len(x), "vs": "fp32 (tanh)",
          **diff(site, ref)})
    emit({"path": "deit_smooth_block", "images": len(x), "vs": "sitewise SmoothDeployCtx",
          **diff(block, site)})

    q4 = JM.quantize_weights(apply_smooth(flat, sm), INT4A8_PER_CHANNEL)
    block4 = JB.vit_forward_blockfused_w4a8c(
        JB.pack_vit_blocks_w4a8(q4, scales, ex, cfg, tight=True, smooth=sm), jnp.asarray(x), cfg,
        tight=True, interpret=True)
    site4 = jax.jit(lambda q, s, xb: qf_tanh(SmoothDeployCtx(q, s, INT4A8_PER_CHANNEL, sm), xb,
                                             cfg))(q4, scales, jnp.asarray(x))
    emit({"path": "deit_smooth_w4a8_block", "images": len(x), "vs": "fp32 (tanh)",
          **diff(block4, ref)})
    emit({"path": "deit_smooth_w4a8_block", "images": len(x), "vs": "sitewise SmoothDeployCtx",
          **diff(block4, site4)})

    pack = JB.pack_vit_blocks_w8(qflat, scales, folded, cfg, tight=True)
    a = JB.vit_forward_multiblock_w8(pack, jnp.asarray(u8), cfg, layers_per_kernel=6,
                                     interpret=True)
    b = JB.vit_forward_multiblock_w8(pack, jnp.asarray(normalized(u8)), cfg,
                                     layers_per_kernel=6, interpret=True)
    emit({"path": "deit_smooth_block_uint8", "images": len(u8), "vs": "normalized fp32",
          **diff(a, b)})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--parts", default="resnet18,qat,deit",
                    help="comma-separated subset of resnet18, qat, deit")
    args = ap.parse_args()
    n, parts = args.images, args.parts.split(",")
    x = np.random.default_rng(SEED).normal(0, 1, (max(n, QAT_BATCH), 224, 224, 3)).astype(
        np.float32)
    u8 = np.random.default_rng(U8_SEED).integers(0, 256, (n, 224, 224, 3)).astype(np.uint8)
    if "resnet18" in parts:
        resnet18(x[:n], u8)
    if "qat" in parts:
        qat(x)
    if "deit" in parts:
        deit(x[:n], u8)


if __name__ == "__main__":
    main()
