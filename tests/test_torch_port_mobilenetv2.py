"""The MobileNetV2 slice: K23's plain version (the int8 depthwise conv),
the relu6 epilogues of K1/K2/K23, the deploy contexts and the engines,
against the JAX package on the same numpy-seeded inputs.

The model is MobileNetV2 at width 1.0, ``small_input`` (stem stride 1),
32 px, 10 classes: the port's numpy-seeded ``init_mobilenetv2`` carried into
JAX, folded, calibrated and quantized by the JAX package, its weights and
scales carried back into the port with ``from_jax_qflat``. The width is the
full 1.0 because the reference's ``from_store`` builds the 1.0x topology
from any store (it reads no width multiplier), and the store tests need
both packages to read the same topology. The JAX forwards
are jitted with params and scales as arguments, as its Engine runs them.
The port runs on the CPU, where every kernel wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import mobilenetv2 as JMN
from dlq_tpu.ops import qops as JO
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JQ4
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import mobilenetv2 as TMN
from dlq_tpu_torch.ops import qops as TO
from dlq_tpu_torch.ops.depthwise_int8 import (
    depthwise_acc_plain, depthwise_int8, pack_depthwise_weight,
)
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ

SIZE, CLASSES, WIDTH = 32, 10, 1.0


def _qfields(qflat):
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": np.asarray(p["b"])} for k, p in qflat.items()}


def _np(taps):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in taps.items()}


def _quantized(qcfg, seed=0, scales=None):
    """MobileNetV2 from the port's init, calibrated on 4 images (unless
    ``scales`` are given) and quantized by the JAX package; returns JAX
    params and the port's copies."""
    jcfg = JMN.MobileNetV2Config(num_classes=CLASSES, width_mult=WIDTH, small_input=True)
    tcfg = TMN.MobileNetV2Config(num_classes=CLASSES, width_mult=WIDTH, small_input=True)
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    TMN.init_mobilenetv2(seed, tcfg))
    flat = JMN.fold_mobilenetv2(params)
    meta = JMN.block_meta(jcfg)
    x = np.random.default_rng(seed).normal(0, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    if scales is None:
        scales = j_calibrate(JM.make_sites_fn(JMN.make_qforward(meta), jcfg), flat,
                             [jnp.asarray(x)], qcfg)
    qflat = JM.quantize_weights(flat, qcfg)
    tq, ts = from_jax_qflat(_qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, x=x, qflat=qflat, scales=scales,
                tq=tq, ts=ts, meta=meta, tmeta=TMN.block_meta(tcfg))


@pytest.fixture(scope="module")
def m():
    return _quantized(JQ)


@pytest.fixture(scope="module")
def store(m, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mnv2") / "store")
    j_save(root, "mobilenetv2", m["qflat"], m["scales"], JQ,
           meta={"config": {"num_classes": CLASSES, "small_input": True}})
    return root


@pytest.fixture(scope="module")
def jax_deploy_logits(m, store):
    """JAX's from_store(depthwise="int8") logits on the fixture's images."""
    return np.asarray(JEngine.from_store(store, ctx="deploy", depthwise="int8", batch=4)(m["x"]))


# ---------------------------------------------------------------------------
# K23's plain version: exact sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w,c,stride,extreme", [
    (2, 9, 9, 16, 1, False), (2, 9, 9, 16, 2, False), (1, 7, 11, 24, 2, False),
    (2, 8, 5, 40, 1, False), (1, 13, 6, 40, 2, False), (1, 6, 6, 24, 1, True),
])
def test_depthwise_sums_match_jax(n, h, w, c, stride, extreme):
    """K23's plain int32 sums == JAX's int8 grouped conv and its stencil,
    bit for bit (odd H and W, stride 2 from odd H, C 16/24/40, ±127)."""
    rng = np.random.default_rng(h * 100 + w * 10 + c + stride)
    if extreme:
        x = rng.choice(np.array([-127, 127], np.int8), (n, h, w, c))
        wq = rng.choice(np.array([-127, 127], np.int8), (3, 3, 1, c))
    else:
        x = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
        wq = rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    got = depthwise_acc_plain(torch.from_numpy(x), pack_depthwise_weight(torch.from_numpy(wq)),
                              stride, 1).numpy()
    ref = np.asarray(jax.jit(lambda a, b: JO._conv_int8(a, b, stride, 1, c, depthwise="int8"))(
        x, wq))
    sten = np.asarray(JO._depthwise_int8_stencil(jnp.asarray(x), jnp.asarray(wq),
                                                 (stride, stride), [(1, 1), (1, 1)]))
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sten)
    if extreme:
        assert np.abs(got).max() == 9 * 127 * 127


@pytest.mark.parametrize("relu,relu6,int8_out", [(False, False, False), (True, False, True),
                                                 (False, True, True), (False, True, False),
                                                 (False, False, True)])
def test_depthwise_wrapper_epilogues_on_cpu(relu, relu6, int8_out):
    """On a CPU tensor the wrapper runs its plain version: the epilogue of
    the fused contexts, computed here in float64 from exact sums."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 7, 7, 24)).astype(np.int8))
    pk = pack_depthwise_weight(torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, 24))
                                                .astype(np.int8)))
    scale = torch.from_numpy(rng.uniform(1e-4, 3e-4, 24).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, 24).astype(np.float32))
    osc = 0.05 if int8_out else None
    got = depthwise_int8(x, pk, 2, 1, scale, bias, relu=relu, out_scale=osc, relu6=relu6)
    y = (depthwise_acc_plain(x, pk, 2, 1).double() * scale.double() + bias.double()).float()
    if relu6:
        y = y.clamp(0, 6)
    elif relu:
        y = y.clamp_min(0)
    if int8_out:
        y = torch.clamp(torch.round(y / np.float32(osc)), 0 if (relu or relu6) else -127, 127)
        assert got.dtype == torch.int8
    assert float((got.double() - y.double()).abs().max()) <= (1 if int8_out else 1e-6)
    assert depthwise_int8.launches == 0


def test_resolve_depthwise_contract(monkeypatch):
    """The reference's names and ValueError; None reads DLQ_DEPTHWISE
    (default "int8") with no canary and no fall-back."""
    assert TO.resolve_depthwise("stencil") == "stencil"
    assert TO.resolve_depthwise("fp32") == "fp32"
    assert TO.resolve_depthwise("int8") == "int8"
    with pytest.raises(ValueError, match="int8|fp32|stencil"):
        TO.resolve_depthwise("bogus")
    monkeypatch.delenv("DLQ_DEPTHWISE", raising=False)
    assert TO.resolve_depthwise(None) == "int8"
    monkeypatch.setenv("DLQ_DEPTHWISE", "stencil")
    assert TO.resolve_depthwise(None) == "stencil"
    assert TM.DeployCtx({}, {}, TQ).depthwise == "stencil"
    monkeypatch.setenv("DLQ_DEPTHWISE", "bogus")
    with pytest.raises(ValueError):
        TM.DeployCtx({}, {}, TQ)


@pytest.mark.parametrize("impl", ["int8", "stencil", "fp32"])
@pytest.mark.parametrize("stride,relu", [(1, False), (2, True)])
def test_qconv2d_depthwise_matches_jax(m, impl, stride, relu):
    """qconv2d on a depthwise site against the JAX package's qconv2d, for
    each implementation; and a grouped conv that is not depthwise raises."""
    site = "block2.dw"
    p = m["qflat"][site]
    c = p["qw"].layout_shape[-1]
    x = np.random.default_rng(5).normal(0, 1, (2, 9, 9, c)).astype(np.float32)
    s = m["scales"][site]
    ref = np.asarray(jax.jit(lambda xx, q, b, sc: JO.qconv2d(
        xx, q, b, sc, stride, 1, c, fuse_relu=relu, depthwise=impl))(x, p["qw"], p["b"], s))
    tp = m["tq"][site]
    got = TO.qconv2d(torch.from_numpy(x), tp["qw"], tp["b"], m["ts"][site], stride, 1, c,
                     fuse_relu=relu, depthwise=impl).numpy()
    numerics.check(got, ref, atol=1e-4, what=f"qconv2d depthwise {impl}")
    with pytest.raises(NotImplementedError, match="depthwise"):
        TO.qconv2d(torch.from_numpy(x), tp["qw"], tp["b"], m["ts"][site], 1, 1, c // 2)


# ---------------------------------------------------------------------------
# FusedDeployCtx.conv with relu6 and the int8 requant, bit for bit
# ---------------------------------------------------------------------------

def _site_input(m, site, rng):
    """fp32 images for the stem, else int8 codes at the site's scale."""
    if site == "stem":
        return m["x"][:2], None
    if site == "head":
        c = m["meta"][-1]["cout"]
    elif site.endswith(".dw"):
        c = m["meta"][int(site[5:].split(".")[0])]["hidden"]
    else:
        c = m["meta"][int(site[5:].split(".")[0])]["cin"]
    return None, rng.integers(-127, 128, (2, 8, 8, c)).astype(np.int8)


@pytest.mark.parametrize("site,out_site,stride", [
    ("stem", "block0.dw", 1),               # K1 (plain), C = 3
    ("block1.expand", "block1.dw", 1),      # K2 (plain)
    ("block3.dw", "block3.project", 2),     # K23 (plain), stride 2
    ("block4.dw", "block4.project", 1),     # K23, stride 1
    ("head", "fc", 1),                      # K2
])
@pytest.mark.parametrize("big_out_scale", [False, True])
def test_fused_conv_relu6_bit_identical(m, site, out_site, stride, big_out_scale):
    """FusedDeployCtx.conv(fuse_relu6=True, out_site=...) == the reference's,
    bit for bit; with ``big_out_scale`` the consumer's scale is 0.1, so
    6 / s = 60 < 127 and clipping y at 6 before the division differs from
    clipping the code: the order shows."""
    rng = np.random.default_rng(7)
    xf, xq = _site_input(m, site, rng)
    scales = dict(m["scales"])
    ts = dict(m["ts"])
    if big_out_scale:
        scales[out_site] = jnp.float32(0.1)
        ts[out_site] = torch.tensor(0.1, dtype=torch.float32)
    groups = m["qflat"][site]["qw"].layout_shape[-1] if site.endswith(".dw") else 1
    pad = 1 if (site == "stem" or site.endswith(".dw")) else 0
    kw = dict(stride=stride, padding=pad, groups=groups, fuse_relu6=True, out_site=out_site)
    s_in = m["scales"][site]

    def jfn(q, sc, a):
        ctx = JM.FusedDeployCtx(q, sc, JQ, depthwise="int8")
        inp = a if site == "stem" else JM.QAct(a, sc[site])
        return ctx.conv(site, inp, **kw).q

    ref = np.asarray(jax.jit(jfn)(m["qflat"], scales, xf if site == "stem" else xq))
    ctx = TM.FusedDeployCtx(m["tq"], ts, TQ)
    inp = (torch.from_numpy(xf) if site == "stem"
           else TM.QAct(torch.from_numpy(xq), float(np.float32(s_in))))
    got = ctx.conv(site, inp, **kw)
    assert got.scale == float(np.float32(scales[out_site]))
    np.testing.assert_array_equal(got.q.numpy(), ref)
    assert got.q.min() >= 0
    if big_out_scale:
        # the clip order is visible: no code reaches 61 (60 = 6 / 0.1)
        assert int(got.q.max()) <= 60
    # without out_site: fp32 clip(y, 0, 6)
    y = ctx.conv(site, inp, **{**kw, "out_site": None})
    assert y.dtype == torch.float32 and float(y.min()) >= 0 and float(y.max()) <= 6


# ---------------------------------------------------------------------------
# the model and its forwards
# ---------------------------------------------------------------------------

def test_fp32_forward_and_fold_carried_from_jax(m):
    """JAX params (BN statistics made non-trivial) carried by from_jax_tree:
    mobilenetv2_forward's taps within 1e-4 of JAX's, relative to each tap's
    largest magnitude where that exceeds 1 (fp32 conv sums in another order;
    the perturbed BN grows the deep blocks' activations to ~20), and
    fold_mobilenetv2 equal to JAX's fold."""
    rng = np.random.default_rng(9)

    def perturb(tree):
        if isinstance(tree, dict) and "gamma" in tree:
            c = tree["gamma"].shape[0]
            return {"gamma": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                    "beta": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
                    "mean": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree

    jparams = perturb(m["params"])
    x = m["x"][:2]
    _, jt = jax.jit(lambda p, xx: JMN.mobilenetv2_forward(p, xx, m["jcfg"], taps=True))(
        jparams, x)
    tparams = from_jax_tree(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with torch.inference_mode():
        _, tt = TMN.mobilenetv2_forward(tparams, torch.from_numpy(x), m["tcfg"], taps=True)
    assert set(tt) == set(jt)
    for k in jt:
        ref = np.asarray(jt[k])
        numerics.check(tt[k].numpy(), ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                       what=k)
    jflat = JMN.fold_mobilenetv2(jparams)
    tflat = TMN.fold_mobilenetv2(tparams)
    assert set(tflat) == set(jflat)
    for site, p in tflat.items():
        for n, v in p.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jflat[site][n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{site}.{n}")
    assert TMN.block_meta(m["tcfg"]) == JMN.block_meta(m["jcfg"])


@pytest.mark.parametrize("ctx,impl", [("deploy", "int8"), ("deploy", "stencil"),
                                      ("deploy", "fp32"), ("pallas", "int8"),
                                      ("fused", "int8"), ("fused2", "int8")])
def test_from_store_matches_jax(m, store, jax_deploy_logits, ctx, impl):
    """A JAX-written store through the port's Engine.from_store on the CPU:
    logits within 1e-4 of JAX's from_store(ctx="deploy", depthwise="int8")
    (every context runs make_qforward; the three implementations give the
    same exact sums); the GAP mean's sum order may move the fc's input
    code by one step."""
    eng = Engine.from_store(store, ctx=ctx, depthwise=impl, device="cpu", batch=4)
    assert eng.params.depthwise == impl
    got = eng(m["x"]).numpy()
    numerics.check(got, jax_deploy_logits, atol=1e-4, what=f"{ctx} {impl}")
    assert numerics.top1_agreement(got, jax_deploy_logits) == 1.0


def test_from_store_fused2_matches_jax_fused2(m, store):
    """ctx="fused2" against the reference's own fused2 engine on the store."""
    ref = np.asarray(JEngine.from_store(store, ctx="fused2", depthwise="int8", batch=4)(m["x"]))
    got = Engine.from_store(store, ctx="fused2", device="cpu", batch=4)(m["x"]).numpy()
    numerics.check(got, ref, atol=1e-4, what="fused2")


def test_from_store_guards(m, store):
    """ctx="dynamic" serves the store (run-time scales, K23 for the
    depthwise convs) within 1e-4 of JAX's from_store(ctx="dynamic"); an
    unknown ctx and an unknown depthwise implementation raise."""
    ref = np.asarray(JEngine.from_store(store, ctx="dynamic", depthwise="int8", batch=4)(m["x"]))
    got = Engine.from_store(store, ctx="dynamic", device="cpu", batch=4)(m["x"]).numpy()
    numerics.check(got, ref, atol=1e-4, what="dynamic")
    assert numerics.top1_agreement(got, ref) == 1.0
    with pytest.raises(ValueError, match="ctx must be one of"):
        Engine.from_store(store, ctx="block", device="cpu")
    with pytest.raises(ValueError, match="int8|fp32|stencil"):
        Engine.from_store(store, depthwise="bogus", device="cpu")


def test_deploy_taps_match_jax(m):
    """make_qforward under DeployCtx: every block's fp32 output within 1e-5
    of JAX's (each depthwise, expand and project conv's sums are exact; the
    fp32 epilogues are the same fused multiply-add)."""
    jl, jt = jax.jit(lambda q, s, x: JMN.make_qforward(m["meta"])(
        JM.DeployCtx(q, s, JQ, depthwise="int8"), x, m["jcfg"], taps=True))(
        m["qflat"], m["scales"], m["x"])
    with torch.inference_mode():
        tl, tt = TMN.make_qforward(m["tmeta"])(TM.DeployCtx(m["tq"], m["ts"], TQ),
                                               torch.from_numpy(m["x"]), m["tcfg"], taps=True)
    for k, v in _np(jt).items():
        numerics.check(tt[k].numpy(), v, atol=1e-4 if k == "logits" else 1e-5, what=k)


def test_fused_forward_int8_taps_bit_identical(m):
    """make_qforward_fused under FullFusedCtx (int8 everywhere, relu6 in the
    requants, int-domain residual adds): every block's int8 tap bit-identical
    to JAX's FullFusedCtx; logits within 1e-4."""
    jl, jt = jax.jit(lambda q, s, x: JMN.make_qforward_fused(m["meta"])(
        JM.FullFusedCtx(q, s, JQ, depthwise="int8"), x, m["jcfg"], taps=True))(
        m["qflat"], m["scales"], m["x"])
    with torch.inference_mode():
        tl, tt = TMN.make_qforward_fused(m["tmeta"])(
            TM.FullFusedCtx(m["tq"], m["ts"], TQ), torch.from_numpy(m["x"]), m["tcfg"],
            taps=True)
    jt = _np(jt)
    blocks = [k for k in jt if k.startswith("block")]
    assert len(blocks) == len(m["meta"]) == 17
    for k in blocks:
        np.testing.assert_array_equal(tt[k].numpy(), jt[k], err_msg=k)
    numerics.check(tl.numpy(), np.asarray(jl), atol=1e-4, what="logits")
    assert numerics.top1_agreement(tl.numpy(), np.asarray(jl)) == 1.0


def test_int4a8_store_deploy_matches_jax(m, tmp_path):
    """An INT4A8_PER_CHANNEL store through deploy: its 1x1 convs are int4
    per-OC (unpacked once, K1/K2), its depthwise sites fall back to int8 as
    the reference's ``effective_weight_scheme`` has it (K = 9 on the
    ``[9, C]`` view is odd, and int4 packs pairs along K); the logits are
    within 1e-4 of the reference's from_store."""
    m4 = _quantized(JQ4, scales=m["scales"])
    assert m4["qflat"]["block2.expand"]["qw"].bits == 4
    assert m4["qflat"]["block2.dw"]["qw"].bits == 8
    root = str(tmp_path / "int4")
    j_save(root, "mobilenetv2", m4["qflat"], m4["scales"], JQ4,
           meta={"config": {"num_classes": CLASSES, "small_input": True}})
    ref = np.asarray(JEngine.from_store(root, ctx="deploy", depthwise="int8", batch=4)(m4["x"]))
    eng = Engine.from_store(root, ctx="deploy", device="cpu", batch=4)
    got = eng(m4["x"]).numpy()
    numerics.check(got, ref, atol=1e-4, what="int4a8 deploy")
    assert eng.params.packed["block2.expand"].wk.dtype == torch.int8


def test_int4_depthwise_weight_unpacks_exactly():
    """A per-OC int4 depthwise weight where K is even (a 2x2 kernel: K = 4
    on the [kh * kw, C] view) unpacks to the reference's [2, 2, 1, C] int8
    layout exactly; and K23's plain sums on it equal JAX's stencil."""
    from dlq_tpu.quant.quantize import quantize_tensor as j_quantize
    from dlq_tpu.quant.quantize import unpack_to_layout as j_unpack

    rng = np.random.default_rng(13)
    w = rng.normal(0, 0.3, (2, 2, 1, 16)).astype(np.float32)
    q = j_quantize(jnp.asarray(w.reshape(4, 16)), JQ4.weights)
    q.orig_shape = w.shape
    assert q.bits == 4 and tuple(q.layout_shape) == (2, 2, 1, 16)
    tq, _ = from_jax_qflat(_qfields({"dw": {"qw": q, "b": np.zeros(16, np.float32)}}),
                           device="cpu")
    pk = TO.depthwise_weight_packed(tq["dw"]["qw"])
    w8 = np.asarray(j_unpack(q))
    np.testing.assert_array_equal(pk.hwio().numpy(), w8)
    x = rng.integers(-127, 128, (1, 5, 7, 16)).astype(np.int8)
    got = depthwise_acc_plain(torch.from_numpy(x), pk, 2, 1).numpy()
    ref = np.asarray(JO._depthwise_int8_stencil(jnp.asarray(x), jnp.asarray(w8), (2, 2),
                                                [(1, 1), (1, 1)]))
    np.testing.assert_array_equal(got, ref)


def test_engine_quantized_depthwise_on_cpu(m, jax_deploy_logits):
    """Engine.quantized takes depthwise= (resolved once): the port quantizes
    the JAX-folded weights itself, with the reference's calibrated scales,
    and each implementation gives logits within 1e-4 of the reference's
    deploy engine, the three equal to each other."""
    tcfg, meta = m["tcfg"], m["tmeta"]
    flat = {k: {n: torch.from_numpy(np.array(v)) for n, v in p.items()}
            for k, p in JMN.fold_mobilenetv2(m["params"]).items()}
    logits = {}
    for impl in ("int8", "stencil", "fp32"):
        q = Engine.quantized(TMN.make_qforward(meta), flat, tcfg, TQ, act_scales=m["ts"],
                             depthwise=impl, batch=4, device="cpu")
        assert q.params.depthwise == impl
        logits[impl] = q(m["x"]).numpy()
        numerics.check(logits[impl], jax_deploy_logits, atol=1e-4, what=impl)
    np.testing.assert_array_equal(logits["int8"], logits["stencil"])
    np.testing.assert_array_equal(logits["int8"], logits["fp32"])
    with pytest.raises(ValueError, match="int8|fp32|stencil"):
        Engine.quantized(TMN.make_qforward(meta), flat, tcfg, TQ, act_scales=m["ts"],
                         depthwise="bogus", device="cpu")
