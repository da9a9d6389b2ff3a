"""The port's CLI journey for every registry model: the JAX tools write the
store exactly as ``tests/test_cli_journey.py`` does (``export_weights`` ->
``quantize_model --scheme int8_pc``), then the port's
``Engine.from_store(ctx="deploy").classify`` serves it on the CPU and must
give the JAX engine's predictions on the same store and images.

One export per model, shared through a module-scoped fixture.
"""

import sys

import numpy as np
import pytest

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import available
from dlq_tpu_torch.engine import Engine

# models whose builders take small_input (32x32 CIFAR-style stem)
SMALL = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "mobilenetv2")


def run_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()


def input_for(model, cfg, rng):
    if model == "mlp":
        return rng.normal(0, 1, (5, cfg.in_dim)).astype(np.float32)
    if model == "lenet5":
        return rng.normal(0, 1, (5, 28, 28, cfg.in_channels)).astype(np.float32)
    size = 32 if model in SMALL else cfg.image_size
    return rng.normal(0, 1, (5, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=available())
def journey(request, tmp_path_factory):
    """(model, quantized store, images, the JAX engine's predictions)."""
    from tools import export_weights, quantize_model

    model = request.param
    root = tmp_path_factory.mktemp(model)
    exp, qdir = str(root / "fp32"), str(root / "int8")
    with pytest.MonkeyPatch.context() as mp:
        argv = ["export_weights.py", "--model", model, "--out", exp, "--num_classes", "10"]
        if model in SMALL:
            argv.append("--small_input")
        run_cli(export_weights, argv, mp)
        run_cli(quantize_model, ["quantize_model.py", "--manifest", exp, "--out", qdir,
                                 "--scheme", "int8_pc", "--calib_batches", "1", "--batch", "4"],
                mp)
    jeng = JEngine.from_store(qdir, ctx="deploy", batch=5)
    x = input_for(model, jeng.model_cfg, np.random.default_rng(0))
    return model, qdir, x, jeng.classify(x)


def test_port_cli_journey(journey):
    """The port serves the CLI-written store: 5 classes in [0, 10), equal
    to the JAX engine's on the same store and images."""
    model, qdir, x, ref = journey
    eng = Engine.from_store(qdir, ctx="deploy", device="cpu", batch=5)
    assert eng.name.startswith(model)
    preds = eng.classify(x)
    assert preds.shape == (5,) and preds.dtype.kind in "iu"
    assert (preds >= 0).all() and (preds < 10).all()
    np.testing.assert_array_equal(preds, ref)
