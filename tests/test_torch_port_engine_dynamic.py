"""The rest of the engine: DynamicDeployCtx (run-time activation scales),
SimulateCtx, Engine.quantized's dynamic= / simulate= and their guards,
Engine.bf16 and batchnorm_inference's dtype contract, against the JAX
package on the same numpy-seeded weights and inputs.

The JAX forwards are jitted with params as arguments, as its Engine runs
them: jitted XLA folds the dynamic scale's ``amax / 127`` into a multiply by
the fp32 reciprocal, where eager JAX divides (ROADMAP.md C), and the port
follows the jitted form. The port runs on the CPU, where every kernel
wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import common as JC
from dlq_tpu.models import lenet as JL
from dlq_tpu.models import mobilenetv2 as JMN
from dlq_tpu.models import resnet as JR
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT4_WEIGHT_ONLY_G128 as JQW
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.models import common as TC
from dlq_tpu_torch.models import lenet as TL
from dlq_tpu_torch.models import mobilenetv2 as TMN
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT4_WEIGHT_ONLY_G128 as TQW
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ
from dlq_tpu_torch.quant.quantize import QTensor


def _qfields(qflat):
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": np.asarray(p["b"])} for k, p in qflat.items()}


def _np(taps):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in taps.items()}


def _tflat(jflat):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in p.items()} for k, p in jflat.items()}


def _resnet(seed=0):
    """ResNet-18 (full widths, 10 classes, 32 px small-input stem) from the
    port's init, folded and flattened, as jnp."""
    tcfg = TR.ResNetConfig(depth=18, num_classes=10, small_input=True)
    jcfg = JR.ResNetConfig(depth=18, num_classes=10, small_input=True)
    params = TR.init_resnet(seed, tcfg)
    flat = TR.flatten_folded(TR.fold_resnet(params, tcfg))
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in flat.items()}
    x = np.random.default_rng(seed + 1).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    return dict(jqf=JR.qforward, tqf=TR.qforward, jcfg=jcfg, tcfg=tcfg, jflat=jflat, x=x,
                params=params)


def _mobilenetv2(seed=0):
    tcfg = TMN.MobileNetV2Config(num_classes=10, small_input=True)
    jcfg = JMN.MobileNetV2Config(num_classes=10, small_input=True)
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    TMN.init_mobilenetv2(seed, tcfg))
    x = np.random.default_rng(seed + 1).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    return dict(jqf=JMN.make_qforward(JMN.block_meta(jcfg)),
                tqf=TMN.make_qforward(TMN.block_meta(tcfg)), jcfg=jcfg, tcfg=tcfg,
                jflat=JMN.fold_mobilenetv2(params), x=x)


def _lenet(seed=0):
    tcfg, jcfg = TL.LeNetConfig(), JL.LeNetConfig()
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), TL.init_lenet(seed, tcfg))
    x = np.random.default_rng(seed + 1).normal(0, 1, (4, 28, 28, 1)).astype(np.float32)
    return dict(jqf=JL.qforward, tqf=TL.qforward, jcfg=jcfg, tcfg=tcfg,
                jflat=JL.flatten_params(params), x=x)


BUILDERS = {"resnet18": _resnet, "mobilenetv2": _mobilenetv2, "lenet5": _lenet}


def _scale_ctx():
    """A DynamicDeployCtx on one dummy site (the scale needs no weights)."""
    qw = QTensor(torch.zeros(2, 2, dtype=torch.int8), torch.ones(2), None, 8, -1, None, (2, 2))
    return TM.DynamicDeployCtx({"a": {"qw": qw, "b": None}}, TQ)


def test_dynamic_scale_bit_for_bit_with_jitted_reference():
    """The port's per-site scale equals the jitted reference's
    ``max(amax(|x|) / 127, 1e-12)`` bit for bit on 10,000 random tensors
    (magnitudes 1e-6 to 1e6, and all-zero ones, which take the 1e-12
    floor); the IEEE division amax / 127, eager JAX's, differs on some."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(10_000, 64)) * 10.0 ** rng.uniform(-6, 6, (10_000, 1))).astype(
        np.float32)
    x[:8] = 0.0
    jscale = JM.DynamicDeployCtx({}, JQ)._scale
    ref = np.asarray(jax.jit(jax.vmap(jscale))(jnp.asarray(x)))
    ctx = _scale_ctx()
    got = np.array([ctx.act_scale(torch.from_numpy(r)).numpy() for r in x])
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and (got[:8] == np.float32(1e-12)).all()
    amax = np.abs(x).max(axis=1)
    ieee = np.maximum(amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
    assert (ieee != ref).sum() >= 1
    eager = np.array([np.asarray(jscale(jnp.asarray(r))) for r in x[8:1008]])
    assert (eager == ieee[8:1008]).all()


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def q(request):
    """A model quantized by the JAX package (weights only: dynamic needs no
    calibration), with the port's copy of its weights."""
    mm = BUILDERS[request.param]()
    mm["name"] = request.param
    mm["qflat"] = JM.quantize_weights(mm["jflat"], JQ)
    mm["tq"], _ = from_jax_qflat(_qfields(mm["qflat"]), {}, device="cpu")
    return mm


def test_dynamic_forward_matches_jitted_reference(q):
    """qforward under DynamicDeployCtx: fp32 taps within 1e-5, logits
    within 1e-4 of the reference's jitted DynamicDeployCtx forward, top-1
    1.0 (ResNet-18 at 32 px and full widths, MobileNetV2 1.0x at 32 px,
    LeNet-5)."""
    jl, jt = jax.jit(lambda p, x: q["jqf"](JM.DynamicDeployCtx(p, JQ, depthwise="int8"), x,
                                            q["jcfg"], taps=True))(q["qflat"], q["x"])
    with torch.inference_mode():
        tl, tt = q["tqf"](TM.DynamicDeployCtx(q["tq"], TQ), torch.from_numpy(q["x"]), q["tcfg"],
                          taps=True)
    jt = _np(jt)
    assert set(_np(tt)) == set(jt)
    for k, v in jt.items():
        numerics.check(tt[k].numpy(), v, atol=1e-4 if k == "logits" else 1e-5, what=k)
    numerics.check(tl.numpy(), np.asarray(jl), atol=1e-4, what="logits")
    assert numerics.top1_agreement(tl.numpy(), np.asarray(jl)) == 1.0


class _Recording(TM.DynamicDeployCtx):
    """DynamicDeployCtx that keeps each site's run-time scale."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = {}

    def conv(self, name, x, **kw):
        self.seen[name] = self.act_scale(x)
        return super().conv(name, x, **kw)

    def dense(self, name, x, **kw):
        self.seen[name] = self.act_scale(x)
        return super().dense(name, x, **kw)


def test_dynamic_is_deploy_at_the_run_time_scales(q):
    """DynamicDeployCtx is DeployCtx at the scales it finds: DeployCtx on
    the scales one dynamic forward computed gives its logits bit for bit.
    (The reference's docstring also promises DeployCtx's logits on a minmax
    calibration batch; its jitted engine does not keep that, since
    calibration divides by 127 where the jitted scale multiplies by the
    reciprocal, and calibration reads the fp32 forward's activations:
    ROADMAP.md C.)"""
    x = torch.from_numpy(q["x"])
    rec = _Recording(q["tq"], TQ)
    with torch.inference_mode():
        dyn = q["tqf"](rec, x, q["tcfg"])
        static = q["tqf"](TM.DeployCtx(q["tq"], rec.seen, TQ), x, q["tcfg"])
    assert len(rec.seen) == len(q["tq"])
    np.testing.assert_array_equal(dyn.numpy(), static.numpy())


@pytest.mark.parametrize("name", ["resnet18", "lenet5"])
def test_engine_quantized_dynamic_and_simulate_match_jax(name):
    """Engine.quantized(dynamic=True) with no calibration data, and
    simulate=True on calibrated scales, against the reference's engines on
    the same weights: logits within 1e-4, top-1 1.0."""
    m = BUILDERS[name]()
    flat = _tflat(m["jflat"])
    ref = np.asarray(JEngine.quantized(m["jqf"], m["jflat"], m["jcfg"], JQ, dynamic=True,
                                       batch=len(m["x"]))(m["x"]))
    got = Engine.quantized(m["tqf"], flat, m["tcfg"], TQ, dynamic=True, batch=len(m["x"]),
                           device="cpu")(m["x"]).numpy()
    numerics.check(got, ref, atol=1e-4, what=f"{name} dynamic")
    assert numerics.top1_agreement(got, ref) == 1.0
    jsim = JEngine.quantized(m["jqf"], m["jflat"], m["jcfg"], JQ, calib_batches=[m["x"]],
                             simulate=True, batch=len(m["x"]))
    tsim = Engine.quantized(m["tqf"], flat, m["tcfg"], TQ, batch=len(m["x"]), device="cpu",
                            act_scales={k: torch.from_numpy(np.array(v))
                                        for k, v in jsim.act_scales.items()}, simulate=True)
    assert isinstance(tsim.params, TM.SimulateCtx)
    ref = np.asarray(jsim(m["x"]))
    got = tsim(m["x"]).numpy()
    if name == "lenet5":
        numerics.check(got, ref, atol=1e-4, what=f"{name} simulate")
    else:   # fp32 convs in another order flip int8 codes downstream
        assert numerics.diff(got, ref).cosine >= 0.9998   # (test_simulate_ctx_taps_match_jax)
    assert numerics.top1_agreement(got, ref) == 1.0


def test_simulate_ctx_taps_match_jax():
    """SimulateCtx on ResNet-18 (fake-quantized activations, dequantized
    weights, fp32 convs) against the reference's jitted SimulateCtx on the
    same scales: the stem (the first site) bit for bit. Its fp32 convs sum
    in another order than XLA's, and a sum that lands across a rounding
    boundary of the next site's quantizer moves that code by one step, so
    every later stage and the logits are held at cosine >= 0.9998 (0.99987
    to 0.99999 here, 0.99989 on the engine test's weights; the reference's
    own jitted and eager forwards agree within 5e-7: one order)."""
    m = _resnet(seed=4)
    scales = j_calibrate(JM.make_sites_fn(JR.qforward, m["jcfg"]), m["jflat"],
                         [jnp.asarray(m["x"])], JQ)
    qflat = JM.quantize_weights(m["jflat"], JQ)
    tq, ts = from_jax_qflat(_qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    jl, jt = jax.jit(lambda p, s, x: JR.qforward(JM.SimulateCtx(p, s, JQ), x, m["jcfg"],
                                                 taps=True))(qflat, scales, m["x"])
    with torch.inference_mode():
        tl, tt = TR.qforward(TM.SimulateCtx(tq, ts, TQ), torch.from_numpy(m["x"]), m["tcfg"],
                             taps=True)
    jt, tt = _np(jt), _np(tt)
    np.testing.assert_array_equal(tt["stem"], jt["stem"])
    for k in ("layer1", "layer2", "layer3", "layer4", "gap"):
        assert numerics.diff(tt[k], jt[k]).cosine >= 0.9998, k
    assert numerics.diff(tl.numpy(), np.asarray(jl)).cosine >= 0.9998


def test_engine_quantized_guards():
    """The reference's three guards raise as its own do (ValueError):
    dynamic on a weight-only config, dynamic with simulate, and activation
    quantization with neither calibration data, scales nor dynamic."""
    m = _lenet()
    flat = _tflat(m["jflat"])
    cases = [(TQW, JQW, dict(dynamic=True), "weight-only"),
             (TQ, JQ, dict(dynamic=True, simulate=True), "no dynamic variant"),
             (TQ, JQ, dict(), "calib_batches")]
    for tq, jq, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            Engine.quantized(TL.qforward, flat, m["tcfg"], tq, device="cpu", **kw)
        with pytest.raises(ValueError):
            JEngine.quantized(JL.qforward, m["jflat"], m["jcfg"], jq, **kw)


def test_from_store_dynamic_weight_only_raises(tmp_path):
    """ctx="dynamic" on a weight-only store raises the reference's
    ValueError."""
    m = _lenet()
    root = str(tmp_path / "wo")
    j_save(root, "lenet5", JM.quantize_weights(m["jflat"], JQW), {}, JQW,
           meta={"config": {"num_classes": 10, "in_channels": 1}})
    with pytest.raises(ValueError, match="weight-only"):
        JEngine.from_store(root, ctx="dynamic")
    with pytest.raises(ValueError, match="weight-only"):
        Engine.from_store(root, ctx="dynamic", device="cpu")


def test_batchnorm_inference_keeps_bf16():
    """batchnorm_inference casts scale and shift to x.dtype, as the
    reference does: a bf16 x gives a bf16 result equal to JAX's; fp32
    stays fp32 (within 1e-6 of JAX's: rsqrt may differ by an ulp)."""
    rng = np.random.default_rng(7)
    bn = {"gamma": rng.uniform(0.5, 1.5, 16), "beta": rng.normal(0, 0.3, 16),
          "mean": rng.normal(0, 0.3, 16), "var": rng.uniform(0.5, 2.0, 16)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    x = rng.normal(0, 1, (2, 5, 5, 16)).astype(np.float32)
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    jbn = {k: jnp.asarray(v) for k, v in bn.items()}
    got = TC.batchnorm_inference(torch.from_numpy(x).to(torch.bfloat16), tbn)
    ref = JC.batchnorm_inference(jnp.asarray(x, jnp.bfloat16), jbn)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    got32 = TC.batchnorm_inference(torch.from_numpy(x), tbn)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(JC.batchnorm_inference(
        jnp.asarray(x), jbn)), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def bf16_resnet():
    """ResNet-18 at 32 px with non-trivial BN statistics (so the unfolded
    forward's BN is not an identity), its fp32 JAX copy and inputs."""
    tcfg = TR.ResNetConfig(depth=18, num_classes=10, small_input=True)
    jcfg = JR.ResNetConfig(depth=18, num_classes=10, small_input=True)
    params = TR.init_resnet(5, tcfg)
    rng = np.random.default_rng(5)

    def perturb(t):
        if isinstance(t, dict) and set(t) == {"gamma", "beta", "mean", "var"}:
            c = t["gamma"].shape[0]
            return {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                    "beta": torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)),
                    "mean": torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)),
                    "var": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))}
        if isinstance(t, dict):
            return {k: perturb(v) for k, v in t.items()}
        if isinstance(t, list):
            return [perturb(v) for v in t]
        return t

    params = perturb(params)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    return dict(tcfg=tcfg, jcfg=jcfg, params=params, jparams=jparams, x=x)


@pytest.mark.parametrize("folded", [False, True])
def test_engine_bf16_matches_jax(bf16_resnet, folded):
    """Engine.bf16 on ResNet-18: the unfolded resnet_forward (bf16 through
    every BN) and the folded qforward(ObserveCtx) that bench.py times, at
    cosine >= 0.9999 of the reference's Engine.bf16 and of the fp32
    forward, fp32 logits out."""
    m = bf16_resnet
    if folded:
        tp = TR.flatten_folded(TR.fold_resnet(m["params"], m["tcfg"]))
        jp = JR.flatten_folded(JR.fold_resnet(m["jparams"], m["jcfg"]))

        def tfwd(p, x, cfg):
            return TR.qforward(TM.ObserveCtx(p), x, cfg)

        def jfwd(p, x, cfg):
            return JR.qforward(JM.ObserveCtx(p), x, cfg)
    else:
        tp, jp = m["params"], m["jparams"]
        tfwd, jfwd = TR.resnet_forward, JR.resnet_forward
    eng = Engine.bf16(tfwd, tp, m["tcfg"], batch=4, device="cpu")
    assert eng.input_dtype == torch.bfloat16
    got = eng(m["x"])
    assert got.dtype == torch.float32
    ref = np.asarray(JEngine.bf16(jfwd, jp, m["jcfg"], batch=4)(m["x"]))
    fp32 = TR.resnet_forward(m["params"], torch.from_numpy(m["x"]), m["tcfg"]).numpy()
    assert numerics.diff(got.numpy(), ref).cosine >= 0.9999
    assert numerics.diff(got.numpy(), fp32).cosine >= 0.9999
    assert numerics.top1_agreement(got.numpy(), ref) == 1.0
