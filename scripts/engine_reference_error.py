"""The JAX reference's own errors on the weights and inputs of
``chip_smoke.py``'s engine paths, on the CPU.

- ResNet-18 (224 px, 1000 classes, the port's numpy-seeded
  ``init_resnet``, seed 0; the first images of seed 0's draw): its
  ``Engine.bf16`` on the folded ``qforward(ObserveCtx)`` forward (as
  ``bench.py`` times it) and on the unfolded ``resnet_forward``, and its
  jitted ``DynamicDeployCtx`` forward on INT8_PER_CHANNEL weights, each
  against the fp32 folded forward; the dynamic forward also against the
  static ``DeployCtx`` on scales calibrated on 8 images of seed 18.
- MobileNetV2 1.0x (224 px, 1000 classes, seed 0): its jitted
  ``DynamicDeployCtx`` forward against fp32.
- LeNet-5 and the MLP (seed 0; 28 x 28 x 1 images of seed 28, the MLP on
  the same pixels as 784-wide rows; calibration on 8 images of seed 5):
  ``DeployCtx`` and ``DynamicDeployCtx`` against fp32.

So the numbers say how close to fp32 the card's paths can be asked to come.

    python scripts/engine_reference_error.py [--images 16] [--mnist-images 256]

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

from dlq_tpu.engine import Engine  # noqa: E402
from dlq_tpu.models import lenet as JL  # noqa: E402
from dlq_tpu.models import mlp as JP  # noqa: E402
from dlq_tpu.models import mobilenetv2 as JMN  # noqa: E402
from dlq_tpu.models import resnet as JR  # noqa: E402
from dlq_tpu.quant import model_quant as JM  # noqa: E402
from dlq_tpu.quant.calibrate import calibrate  # noqa: E402
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL  # noqa: E402
from dlq_tpu_torch.models import lenet as TL  # noqa: E402
from dlq_tpu_torch.models import mlp as TP  # noqa: E402
from dlq_tpu_torch.models.mobilenetv2 import MobileNetV2Config, init_mobilenetv2  # noqa: E402
from dlq_tpu_torch.models.resnet import ResNetConfig, init_resnet  # noqa: E402

SEED = 0
R18_CALIB_SEED = SEED + 18      # chip_smoke.py: main_paths' calibration for ResNet-18
MNIST_SEED = SEED + 28          # chip_smoke.py: MNIST_SEED
MNIST_CALIB_SEED = SEED + 5     # chip_smoke.py: MNIST_CALIB_SEED


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
    print(json.dumps(obj), flush=True)


def resnet18(x):
    cfg = ResNetConfig(depth=18, num_classes=1000)
    jcfg = JR.ResNetConfig(depth=18, num_classes=1000)
    params = jtree(init_resnet(SEED, cfg))
    folded = JR.fold_resnet(params, jcfg)
    flat = JR.flatten_folded(folded)
    ref = np.asarray(jax.jit(lambda p, xb: JR.folded_forward(p, xb, jcfg))(folded, x))

    def observe(p, xb, c):
        return JR.qforward(JM.ObserveCtx(p), xb, c)

    for what, fwd, p in (("resnet18_bf16_folded_observe", observe, flat),
                         ("resnet18_bf16_resnet_forward", JR.resnet_forward, params)):
        got = np.asarray(Engine.bf16(fwd, p, jcfg, batch=len(x))(x))
        emit({"path": what, "images": len(x), "vs": "fp32", **diff(got, ref)})
    dyn = np.asarray(Engine.quantized(JR.qforward, flat, jcfg, INT8_PER_CHANNEL, dynamic=True,
                                      batch=len(x))(x))
    emit({"path": "resnet18_dynamic", "images": len(x), "vs": "fp32", **diff(dyn, ref)})
    calib = [np.random.default_rng(R18_CALIB_SEED).normal(0, 1, (8, 224, 224, 3))
             .astype(np.float32)]
    dep = np.asarray(Engine.quantized(JR.qforward, flat, jcfg, INT8_PER_CHANNEL,
                                      calib_batches=calib, batch=len(x))(x))
    emit({"path": "resnet18_deploy", "images": len(x), "vs": "fp32", **diff(dep, ref)})
    emit({"path": "resnet18_dynamic", "images": len(x), "vs": "deploy", **diff(dyn, dep)})


def mobilenetv2(x):
    cfg = MobileNetV2Config()
    jcfg = JMN.MobileNetV2Config()
    params = jtree(init_mobilenetv2(SEED, cfg))
    ref = np.asarray(jax.jit(lambda p, xb: JMN.mobilenetv2_forward(p, xb, jcfg))(params, x))
    qf = JMN.make_qforward(JMN.block_meta(jcfg))
    dyn = np.asarray(Engine.quantized(qf, JMN.fold_mobilenetv2(params), jcfg, INT8_PER_CHANNEL,
                                      dynamic=True, depthwise="int8", batch=len(x))(x))
    emit({"path": "mobilenetv2_dynamic", "images": len(x), "vs": "fp32", **diff(dyn, ref)})


def mnist(n):
    x = np.random.default_rng(MNIST_SEED).normal(0, 1, (n, 28, 28, 1)).astype(np.float32)
    calib = np.random.default_rng(MNIST_CALIB_SEED).normal(0, 1, (8, 28, 28, 1)).astype(
        np.float32)
    for name, jmod, jcfg, params, xs, cs in (
            ("lenet5", JL, JL.LeNetConfig(), jtree(TL.init_lenet(SEED, TL.LeNetConfig())),
             x, calib),
            ("mlp", JP, JP.MLPConfig(), jtree(TP.init_mlp(SEED, TP.MLPConfig())),
             x.reshape(n, -1), calib.reshape(8, -1))):
        fwd = JL.lenet_forward if name == "lenet5" else JP.mlp_forward
        ref = np.asarray(jax.jit(lambda p, xb: fwd(p, xb, jcfg))(params, xs))
        flat = jmod.flatten_params(params)
        for ctx, kw in (("deploy", dict(calib_batches=[cs])), ("dynamic", dict(dynamic=True))):
            got = np.asarray(Engine.quantized(jmod.qforward, flat, jcfg, INT8_PER_CHANNEL,
                                              batch=n, **kw)(xs))
            emit({"path": f"{name}_{ctx}", "images": n, "vs": "fp32", **diff(got, ref)})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--mnist-images", type=int, default=256)
    args = ap.parse_args()
    mnist(args.mnist_images)
    x = np.random.default_rng(SEED).normal(0, 1, (args.images, 224, 224, 3)).astype(np.float32)
    resnet18(x)
    mobilenetv2(x)


if __name__ == "__main__":
    main()
