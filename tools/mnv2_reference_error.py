"""The JAX reference's own quantization error on random-weight MobileNetV2.

MobileNetV2 1.0x at 224 px, 1000 classes, with the weights, the calibration
batch and the images of ``chip_smoke.py`` (the port's numpy-seeded
``init_mobilenetv2``, seed 0; 8 calibration images from seed 2; the first
images of seed 0's draw), carried into the JAX package on the CPU:

- its ``ctx="deploy"`` engine (``make_qforward`` under ``DeployCtx``, the
  int8 grouped conv for the depthwise sites, jitted) on an INT8_PER_CHANNEL
  store written by ``save_quantized``, against its fp32 forward;
- ``make_qforward_fused`` under ``FullFusedCtx`` (int8 interchange, relu6
  folded into the requants; jitted) on the same weights and scales, against
  the deploy forward and against fp32.

So the numbers say how close to fp32, and to each other, the card's
MobileNetV2 paths can be asked to come.

    python tools/mnv2_reference_error.py [--images 16]

Prints one JSON line per path: logits cosine, largest logit difference and
top-1 agreement.
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
from dlq_tpu.models import mobilenetv2 as JMN  # noqa: E402
from dlq_tpu.quant import model_quant as JM  # noqa: E402
from dlq_tpu.quant.calibrate import calibrate  # noqa: E402
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL  # noqa: E402
from dlq_tpu.quant.store import save_quantized  # noqa: E402
from dlq_tpu_torch.models.mobilenetv2 import MobileNetV2Config, init_mobilenetv2  # noqa: E402

SEED = 0
CALIB_SEED = SEED + 2   # chip_smoke.py: MNV2_CALIB_SEED


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
    cfg = JMN.MobileNetV2Config()
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    init_mobilenetv2(SEED, MobileNetV2Config()))
    flat, meta = JMN.fold_mobilenetv2(params), JMN.block_meta(cfg)
    x = np.random.default_rng(SEED).normal(0, 1, (n, 224, 224, 3)).astype(np.float32)
    calib = [jnp.asarray(np.random.default_rng(CALIB_SEED).normal(0, 1, (8, 224, 224, 3)),
                         jnp.float32)]
    ref = np.asarray(jax.jit(lambda p, xx: JMN.mobilenetv2_forward(p, xx, cfg))(params, x))
    scales = calibrate(JM.make_sites_fn(JMN.make_qforward(meta), cfg), flat, calib,
                       INT8_PER_CHANNEL)
    qflat = JM.quantize_weights(flat, INT8_PER_CHANNEL)
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, "mobilenetv2", qflat, scales, INT8_PER_CHANNEL,
                       meta={"config": {"num_classes": cfg.num_classes, "small_input": False}})
        deploy = np.asarray(Engine.from_store(tmp, ctx="deploy", depthwise="int8",
                                              batch=n)(x), np.float32)
    d = diff(deploy, ref)
    print(json.dumps({"path": "deploy", "scheme": "INT8_PER_CHANNEL", "images": n,
                      "platform": "cpu", "depthwise": "int8",
                      "logits_cosine_vs_fp32": d["logits_cosine"],
                      "logit_err_max": d["logit_err_max"],
                      "top1_agreement_vs_fp32": d["top1_agreement"]}), flush=True)
    qf = JMN.make_qforward_fused(meta)
    fused = np.asarray(jax.jit(lambda q, s, xx: qf(JM.FullFusedCtx(q, s, INT8_PER_CHANNEL,
                                                                   depthwise="int8"), xx, cfg))(
        qflat, scales, x), np.float32)
    d, df = diff(fused, deploy), diff(fused, ref)
    print(json.dumps({"path": "make_qforward_fused", "ctx": "FullFusedCtx",
                      "scheme": "INT8_PER_CHANNEL", "images": n, "platform": "cpu",
                      "logits_cosine_vs_deploy": d["logits_cosine"],
                      "logit_err_max_vs_deploy": d["logit_err_max"],
                      "top1_agreement_vs_deploy": d["top1_agreement"],
                      "logits_cosine_vs_fp32": df["logits_cosine"],
                      "top1_agreement_vs_fp32": df["top1_agreement"]}), flush=True)


if __name__ == "__main__":
    main()
