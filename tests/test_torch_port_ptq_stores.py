"""Stores written by the reference's PTQ toolbox, served by the port: the
JAX tools write them (``export_weights`` -> ``quantize_model --gptq
--bias-correct`` for LeNet-5 at W4A8, ``--auto`` for DeiT-Tiny at W8A8:
SmoothQuant on the LN-foldable sites folded into the stored LN affines,
GPTQ, bias correction), and the port's ``Engine.from_store`` must give the
JAX engine's predictions on the same store and images.

DeiT-Tiny is the registry's (224 px, depth 12); its calibration is one
batch of two images, so the alpha search holds one image out.
"""

import sys

import numpy as np
import pytest

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.manifest import Manifest


def _write(tmp_path_factory, model, extra):
    from tools import export_weights, quantize_model

    root = tmp_path_factory.mktemp(model)
    exp, qdir = str(root / "fp32"), str(root / "q")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["export_weights.py", "--model", model, "--out", exp,
                                 "--num_classes", "10"])
        export_weights.main()
        mp.setattr(sys, "argv", ["quantize_model.py", "--manifest", exp, "--out", qdir,
                                 "--calib_batches", "1", "--batch", "2", *extra])
        quantize_model.main()
    return qdir


def test_lenet_gptq_bias_correct_store(tmp_path_factory):
    """W4A8 (conv1's odd K at int8), GPTQ codes and corrected biases: the
    port's deploy engine gives the JAX engine's logits (within 1e-4) and
    predictions."""
    qdir = _write(tmp_path_factory, "lenet5",
                  ["--scheme", "int4a8", "--gptq", "--bias-correct"])
    assert Manifest.load(qdir).meta["rounding"] == "gptq"
    x = np.random.default_rng(0).normal(0, 1, (6, 28, 28, 1)).astype(np.float32)
    jeng = JEngine.from_store(qdir, ctx="deploy", batch=6)
    eng = Engine.from_store(qdir, ctx="deploy", device="cpu", batch=6)
    assert eng.params.qflat["conv1"]["qw"].bits == 8 and eng.params.qflat["fc1"]["qw"].bits == 4
    np.testing.assert_allclose(eng(x).numpy(), np.asarray(jeng(x)), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(eng.classify(x), jeng.classify(x))


def test_deit_auto_store(tmp_path_factory):
    """The ``--auto`` store (LN affines folded, no smooth field): the port's
    ``deploy`` engine gives the JAX deploy engine's predictions (logits at
    cosine >= 0.998: XLA skips bf16 roundings inside its fusions, as
    ``tests/test_torch_port_vit.py`` states), its ``block`` engine (the
    folded LN rows feed K5/K7 unchanged in layout) the JAX block engine's
    (top-1 1.0, cosine >= 0.999: over 12 random-weight layers at 224 px a
    code one step apart in a sum-order tie grows, and an unsmoothed
    ``int8_pc`` store of the same weights sits at 0.99933 on these images)."""
    qdir = _write(tmp_path_factory, "deit_tiny", ["--scheme", "int8_pc", "--auto"])
    meta = Manifest.load(qdir).meta
    assert meta["rounding"] == "ptq_auto" and meta["smooth_sites"]
    assert all(s.endswith((".qkv", ".fc1")) for s in meta["smooth_sites"])
    x = np.random.default_rng(1).normal(0, 1, (3, 224, 224, 3)).astype(np.float32)
    jeng = JEngine.from_store(qdir, ctx="deploy", batch=3)
    ref = np.asarray(jeng(x))
    dep = Engine.from_store(qdir, ctx="deploy", device="cpu", batch=3)
    np.testing.assert_array_equal(dep.classify(x), jeng.classify(x))
    assert numerics.diff(dep(x), ref).cosine >= 0.998
    blk = Engine.from_store(qdir, ctx="block", device="cpu", batch=3)
    assert blk.name == "deit_tiny_block"
    jblk = np.asarray(JEngine.from_store(qdir, ctx="block", batch=3)(x))
    got = blk(x)
    assert numerics.diff(got, jblk).cosine >= 0.999
    assert numerics.top1_agreement(got, jblk) == 1.0
