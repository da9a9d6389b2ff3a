"""The port's numeric contract against the JAX package: quantization
primitives, the store format both ways, calibration, diff metrics, and the
port's import and device rules."""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu import numerics as jnum
from dlq_tpu.models.resnet import ResNetConfig as JResNetConfig, qforward as j_qforward
from dlq_tpu.quant import qconfig as jqc
from dlq_tpu.quant import quantize as jqz
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.model_quant import make_sites_fn as j_sites, quantize_weights as j_qw
from dlq_tpu.quant.store import load_quantized as j_load, save_quantized as j_save
from dlq_tpu_torch import numerics as tnum
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_flat
from dlq_tpu_torch.models.resnet import (
    ResNetConfig, flatten_folded, fold_resnet, init_resnet, qforward,
)
from dlq_tpu_torch.quant import qconfig as tqc
from dlq_tpu_torch.quant import quantize as tqz
from dlq_tpu_torch.quant.calibrate import calibrate
from dlq_tpu_torch.quant.model_quant import make_sites_fn, quantize_weights
from dlq_tpu_torch.quant.store import load_quantized, save_quantized

REPO = pathlib.Path(__file__).resolve().parent.parent
SCHEMES = ["INT8_PER_TENSOR", "INT8_PER_CHANNEL", "INT4_WEIGHT_ONLY_G128",
           "INT4_WEIGHT_ONLY_PER_OC", "INT4A8_PER_CHANNEL"]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("preset", SCHEMES)
def test_quantize_tensor_matches(preset):
    rng = np.random.default_rng(len(preset))
    w = rng.normal(0, 0.05, (3, 3, 128, 64)).astype(np.float32)
    jscheme, tscheme = getattr(jqc, preset).weights, getattr(tqc, preset).weights
    assert dataclasses.asdict(jscheme) == dataclasses.asdict(tscheme)
    view = w.reshape(-1, 64) if (jscheme.group or jscheme.bits == 4) else w
    jq = jqz.quantize_tensor(jnp.asarray(view), jscheme)
    tq = tqz.quantize_tensor(torch.from_numpy(view), tscheme)
    np.testing.assert_array_equal(_np(tq.values), np.asarray(jq.values))
    np.testing.assert_array_equal(_np(tq.scale), np.asarray(jq.scale))
    np.testing.assert_array_equal(tqz.dequantize(tq).numpy(), np.asarray(jqz.dequantize(jq)))
    if jscheme.bits == 4:
        np.testing.assert_array_equal(
            tqz.unpack_int4(tq.values, tq.shape).numpy(),
            np.asarray(jqz.unpack_int4(jq.values, jq.shape)))


def test_quantize_affine_per_tensor_matches():
    x = np.random.default_rng(1).normal(0.3, 1, (64, 33)).astype(np.float32)
    scheme = dict(bits=8, symmetric=False, axis=None)
    jq = jqz.quantize_tensor(jnp.asarray(x), jqc.QScheme(**scheme))
    tq = tqz.quantize_tensor(torch.from_numpy(x), tqc.QScheme(**scheme))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.zero_point.numpy(), np.asarray(jq.zero_point))


def test_quantize_act_rounds_half_to_even():
    s = np.float32(0.5)
    x = np.array([0.25, 0.75, -0.25, -0.75, 1.25, 63.25, 63.75, -63.75, 70.0],
                 np.float32)  # x / s = +-0.5, +-1.5, 2.5, 126.5, 127.5, -127.5, 140
    got = tqz.quantize_act(torch.from_numpy(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, [0, 2, 0, -2, 2, 126, 127, -127, 127])
    np.testing.assert_array_equal(got, np.asarray(jqz.quantize_act(jnp.asarray(x), s)))


def _port_flat(seed=0):
    """fp32 flat params of a narrow ResNet-18 (numpy-seeded, port init)."""
    cfg = ResNetConfig(depth=18, num_classes=10, small_input=True, widths=(16, 32, 32, 64))
    return cfg, flatten_folded(fold_resnet(init_resnet(seed, cfg), cfg))


def _small_store(tmp_path, preset="INT8_PER_CHANNEL"):
    """A quantized ResNet-18 store (narrow widths) written by the JAX package:
    weights quantized with the port (tested equal to the JAX quantizer
    above), handed to dlq_tpu as its own QTensors."""
    _, flat = _port_flat()
    qcfg = getattr(jqc, preset)
    qflat = {}
    for site, p in quantize_weights(flat, getattr(tqc, preset)).items():
        qw = p["qw"]
        qflat[site] = {"qw": jqz.QTensor(jnp.asarray(qw.values.numpy()), jnp.asarray(qw.scale.numpy()),
                                         None, qw.bits, qw.axis, qw.group, qw.shape, qw.orig_shape),
                       "b": jnp.asarray(p["b"].numpy())}
    scales = {site: jnp.float32(0.01 * (i + 1)) for i, site in enumerate(sorted(flat))}
    root = str(tmp_path / preset)
    j_save(root, "resnet18", qflat, scales, qcfg, meta={"config": {"small_input": True}})
    return root, qflat, scales, qcfg


def _assert_qflat_equal(a, b):
    """a: JAX qflat, b: port qflat."""
    assert set(a) == set(b)
    for site in a:
        ja, tb = a[site]["qw"], b[site]["qw"]
        np.testing.assert_array_equal(tb.values.numpy(), np.asarray(ja.values))
        np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(ja.scale))
        assert (tb.bits, tb.axis, tb.group, tuple(tb.shape), tuple(tb.layout_shape)) == \
            (ja.bits, ja.axis, ja.group, tuple(ja.shape), tuple(ja.layout_shape))
        np.testing.assert_array_equal(b[site]["b"].numpy(), np.asarray(a[site]["b"]))


@pytest.mark.parametrize("preset", ["INT8_PER_CHANNEL", "INT4A8_PER_CHANNEL"])
def test_store_from_jax_loads_into_port(tmp_path, preset):
    root, qflat, scales, qcfg = _small_store(tmp_path, preset)
    tq, ts, tcfg, _ = load_quantized(root)
    _assert_qflat_equal(qflat, tq)
    assert set(ts) == set(scales)
    for k in scales:
        assert ts[k].shape == () and ts[k].dtype == torch.float32
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(scales[k]))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(qcfg)


def test_store_from_port_loads_into_jax(tmp_path):
    root, _, _, _ = _small_store(tmp_path)
    tq, ts, tcfg, _ = load_quantized(root)
    root2 = str(tmp_path / "port")
    save_quantized(root2, "resnet18", tq, ts, tcfg, meta={"config": {"small_input": True}})
    jq, js, jcfg, _ = j_load(root2)
    _assert_qflat_equal(jq, tq)
    for k in ts:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


@pytest.mark.parametrize("method", ["minmax", "percentile", "mse"])
def test_calibrate_stats_match(method):
    """The same site activations give the same scales."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32) for _ in range(2)]
    jcfg = dataclasses.replace(jqc.INT8_PER_CHANNEL, calibration=method)
    tcfg = dataclasses.replace(tqc.INT8_PER_CHANNEL, calibration=method)
    ref = j_calibrate(lambda p, x: {"a": x, "b": jnp.maximum(x, 0) * p}, jnp.float32(3.0),
                      [jnp.asarray(x) for x in xs], jcfg)
    got = calibrate(lambda p, x: {"a": x, "b": torch.clamp_min(x, 0) * p}, 3.0,
                    [torch.from_numpy(x) for x in xs], tcfg)
    for k in ref:
        # minmax is exact; the quantile's interpolation and the MSE mean may
        # round differently from XLA's, by an fp32 ulp or so
        rtol = 0 if method == "minmax" else 1e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=rtol, atol=0)


@pytest.mark.parametrize("method", ["minmax", "percentile", "mse"])
def test_calibrate_model_matches(method):
    cfg, tflat = _port_flat(seed=1)
    jcfg_model = JResNetConfig(depth=18, num_classes=10, small_input=True, widths=(16, 32, 32, 64))
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in tflat.items()}
    rng = np.random.default_rng(1)
    xs = [rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2)]
    jcfg = dataclasses.replace(jqc.INT8_PER_CHANNEL, calibration=method)
    tcfg = dataclasses.replace(tqc.INT8_PER_CHANNEL, calibration=method)
    ref = j_calibrate(j_sites(j_qforward, jcfg_model), jflat, [jnp.asarray(x) for x in xs], jcfg)
    got = calibrate(make_sites_fn(qforward, cfg), tflat, [torch.from_numpy(x) for x in xs], tcfg)
    assert set(got) == set(ref)
    for k in ref:
        # the fp32 convs that produce the site activations sum in another
        # order than XLA's, so deep sites differ by a few fp32 ulps
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-4, atol=0)


def test_quantize_weights_matches():
    _, tflat = _port_flat(seed=2)
    sites = ("stem", "layer2.0.conv1", "layer2.0.down", "fc")
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in tflat[k].items()} for k in sites}
    _assert_qflat_equal(j_qw(jflat, jqc.INT8_PER_CHANNEL),
                        quantize_weights({k: tflat[k] for k in sites}, tqc.INT8_PER_CHANNEL))


def test_numerics_match():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(4, 10)), rng.normal(size=(4, 10))
    assert tnum.diff(torch.from_numpy(a), b).to_json() == jnum.diff(a, b).to_json()
    assert tnum.top1_agreement(a, b) == jnum.top1_agreement(a, b)
    with pytest.raises(AssertionError):
        tnum.check(a, b, atol=1e-4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node in tree.body
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, node in tree.body


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "dlq_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name, top_level in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "dlq_tpu"), f"{f}: imports {name}"
            assert not (root == "ml_dtypes" and top_level), f"{f}: module-level ml_dtypes"


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    root, _, _, _ = _small_store(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine.from_store(root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_flat({})
    eng = Engine.from_store(root, ctx="fused2", device="cpu", batch=2)
    assert eng.device.type == "cpu"
