"""The JAX reference's own quantization error on random-weight DeiT-Tiny.

Its ``ctx="deploy"`` engine (the DeployCtx forward, jitted, on the CPU) on a
store written by ``save_quantized``, against its fp32 forward (exact GELU,
as the deploy forward), for INT8_PER_CHANNEL, INT4A8_PER_CHANNEL and the
weight-only INT4_WEIGHT_ONLY_PER_OC and INT4_WEIGHT_ONLY_G128 (no
calibration, no activation scales; on the CPU the reference dequantizes
each weight-only site in fp32, its ``int4_matmul`` being a TPU route). Then
the bf16 deploy forward ``vit_forward_blockfused`` (``pack_vit_blocks``,
loose and tight pads, Pallas in interpret mode) against the fp32 forward
with the tanh GELU, and the INT8_PER_CHANNEL ``make_qforward`` with
``fused_ln=True, attn_impl="fused"`` under ``DeployCtx`` (jitted, the same
scales) against the fp32 forward and against the unfused deploy forward.
Then the int8-attention paths on the INT8_PER_CHANNEL weights and scales:
the multiblock forward ``vit_forward_multiblock_w8`` with ``attn_int8=True``
(tight pads, 6 layers per chunk, Pallas in interpret mode; and, as its
control, the same forward with bf16 attention) against the fp32 forward with
the tanh GELU; ``make_qforward(attn_impl="xla_int8")`` under ``DeployCtx``
(jitted) against the fp32 forward (exact GELU); and the split-attention
forward ``vit_forward_blockfused_w8_split`` (its defaults: loose pads, int8
attention; interpret mode) against the fp32 forward with the tanh GELU.
The weights, the calibration batch and the images are those of
``chip_smoke.py`` (the port's numpy-seeded ``init_vit``, seed 0), so the
numbers say how close to fp32 the card's DeiT paths can be asked to come.

    python tools/deit_reference_error.py [--images 16]

Prints one JSON line per scheme or path: logits cosine, largest logit
difference and top-1 agreement against fp32 (and, for the fused-LN deploy,
against the unfused one).
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dlq_tpu.engine import Engine  # noqa: E402
from dlq_tpu.models import vit as JV  # noqa: E402
from dlq_tpu.ops import pallas_vit_block as JB  # noqa: E402
from dlq_tpu.quant import model_quant as JM  # noqa: E402
from dlq_tpu.quant.calibrate import calibrate  # noqa: E402
from dlq_tpu.quant.qconfig import (  # noqa: E402
    INT4_WEIGHT_ONLY_G128, INT4_WEIGHT_ONLY_PER_OC, INT4A8_PER_CHANNEL, INT8_PER_CHANNEL,
)
from dlq_tpu.quant.store import save_quantized  # noqa: E402
from dlq_tpu_torch.models.vit import ViTConfig, init_vit  # noqa: E402

SEED = 0
META = ("num_classes", "image_size", "patch", "dim", "depth", "heads", "mlp_ratio")


def diff(got, ref) -> dict:
    """Logits cosine, largest difference and top-1 agreement."""
    a, b = got.reshape(-1).astype(np.float64), ref.reshape(-1).astype(np.float64)
    return {"logits_cosine": float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)),
            "logit_err_max": float(np.abs(got - ref).max()),
            "top1_agreement": float((got.argmax(-1) == ref.argmax(-1)).mean())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=16)
    n = ap.parse_args().images
    cfg = JV.ViTConfig()
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), init_vit(SEED, ViTConfig()))
    flat, ex = JV.flatten_vit(params), JV.vit_extras(params)
    x = np.random.default_rng(SEED).normal(0, 1, (n, 224, 224, 3)).astype(np.float32)
    calib = [jnp.asarray(np.random.default_rng(SEED + 12).normal(0, 1, (8, 224, 224, 3)),
                         jnp.float32)]
    ref = np.asarray(JV.vit_forward(params, jnp.asarray(x), cfg))
    qf = JV.make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    deploy = {}
    for name, qcfg in (("INT8_PER_CHANNEL", INT8_PER_CHANNEL),
                       ("INT4A8_PER_CHANNEL", INT4A8_PER_CHANNEL),
                       ("INT4_WEIGHT_ONLY_PER_OC", INT4_WEIGHT_ONLY_PER_OC),
                       ("INT4_WEIGHT_ONLY_G128", INT4_WEIGHT_ONLY_G128)):
        scales = None if qcfg.weight_only else calibrate(JM.make_sites_fn(qf, cfg), flat, calib,
                                                         qcfg)
        with tempfile.TemporaryDirectory() as tmp:
            save_quantized(tmp, "deit_tiny", JM.quantize_weights(flat, qcfg), scales, qcfg,
                           extras=ex, meta={"config": {k: getattr(cfg, k) for k in META}})
            got = np.asarray(Engine.from_store(tmp, ctx="deploy", batch=n)(x), np.float32)
        deploy[name] = (got, scales)
        d = diff(got, ref)
        print(json.dumps({"scheme": name, "images": n, "platform": "cpu",
                          "logits_cosine_vs_fp32": d["logits_cosine"],
                          "logit_err_max": d["logit_err_max"],
                          "top1_agreement_vs_fp32": d["top1_agreement"]}), flush=True)

    # the bf16 deploy forward on the fused block kernel, against fp32 (tanh GELU)
    ref_tanh = np.asarray(JV.vit_forward(params, jnp.asarray(x),
                                         JV.ViTConfig(gelu="tanh")))
    for tight in (False, True):
        got = np.asarray(JB.vit_forward_blockfused(JB.pack_vit_blocks(params, cfg, tight=tight),
                                                   jnp.asarray(x), cfg, tight=tight,
                                                   interpret=True), np.float32)
        d = diff(got, ref_tanh)
        print(json.dumps({"path": "vit_forward_blockfused", "tight": tight, "images": n,
                          "platform": "cpu", "fp32_gelu": "tanh",
                          "logits_cosine_vs_fp32": d["logits_cosine"],
                          "logit_err_max": d["logit_err_max"],
                          "top1_agreement_vs_fp32": d["top1_agreement"]}), flush=True)

    # W8A8 deploy with the fused LayerNorms (the same store's weights and scales)
    qflat = JM.quantize_weights(flat, INT8_PER_CHANNEL)
    unfused, scales = deploy["INT8_PER_CHANNEL"]
    qf_ln = JV.make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim, fused_ln=True,
                             attn_impl="fused")
    ctx = JM.DeployCtx(qflat, scales, INT8_PER_CHANNEL)
    got = np.asarray(jax.jit(lambda xx: qf_ln(ctx, xx, cfg))(jnp.asarray(x)), np.float32)
    d, du = diff(got, ref), diff(got, unfused)
    print(json.dumps({"path": "deploy_fused_ln", "scheme": "INT8_PER_CHANNEL", "images": n,
                      "platform": "cpu", "logits_cosine_vs_fp32": d["logits_cosine"],
                      "logit_err_max": d["logit_err_max"],
                      "top1_agreement_vs_fp32": d["top1_agreement"],
                      "logits_cosine_vs_unfused_deploy": du["logits_cosine"],
                      "top1_agreement_vs_unfused_deploy": du["top1_agreement"]}), flush=True)

    # the int8-attention paths on the same weights and scales
    def emit(path, got, fp32, gelu, **kw):
        d = diff(np.asarray(got, np.float32), fp32)
        print(json.dumps({"path": path, "scheme": "INT8_PER_CHANNEL", **kw, "images": n,
                          "platform": "cpu", "fp32_gelu": gelu,
                          "logits_cosine_vs_fp32": d["logits_cosine"],
                          "logit_err_max": d["logit_err_max"],
                          "top1_agreement_vs_fp32": d["top1_agreement"]}), flush=True)

    tight = JB.pack_vit_blocks_w8(qflat, scales, ex, cfg, tight=True)
    for attn_int8 in (True, False):
        emit("vit_forward_multiblock_w8",
             JB.vit_forward_multiblock_w8(tight, jnp.asarray(x), cfg, layers_per_kernel=6,
                                          attn_int8=attn_int8, interpret=True),
             ref_tanh, "tanh", attn_int8=attn_int8, tight=True, layers_per_kernel=6)
    qf_i8 = JV.make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim, attn_impl="xla_int8")
    emit("deploy_xla_int8", jax.jit(lambda xx: qf_i8(ctx, xx, cfg))(jnp.asarray(x)), ref,
         "exact", attn_impl="xla_int8")
    emit("vit_forward_blockfused_w8_split",
         JB.vit_forward_blockfused_w8_split(JB.pack_vit_blocks_w8(qflat, scales, ex, cfg),
                                            jnp.asarray(x), cfg, attn="int8", interpret=True),
         ref_tanh, "tanh", attn="int8", tight=False)


if __name__ == "__main__":
    main()
