"""The Bottleneck slice of the port (ResNet-50/101/152) against the JAX
package, on the same weights, act scales and numpy-seeded inputs: K4's
plain version against ``bottleneck_block_fused``, K2's relu and int8
epilogues against ``int8_matmul`` and the ``mm1x1`` epilogue, and ResNet-50
through every deploy context.

The model tests share one quantized ResNet-50 (``small_input``, 10 classes,
batch 2, 32 px, widths 16/32/64/128: the Bottleneck topology at a quarter of
the published widths, to keep the file quick on one worker). The JAX kernels
run as the JAX package's own tests run them (interpret-mode Pallas); the JAX
forwards are jitted with params and scales as arguments, as its Engine runs
them. The port runs on the CPU, where every kernel wrapper runs its plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import resnet as JR
from dlq_tpu.ops.pallas_block import bottleneck_block_fused as j_bottleneck_block_fused
from dlq_tpu.ops.pallas_block import pack_bottleneck_block as j_pack_bottleneck_block
from dlq_tpu.ops.pallas_block import pack_fused_blocks as j_pack_fused_blocks
from dlq_tpu.ops.pallas_matmul import int8_matmul
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.quantize import quantize_tensor as j_quantize_tensor
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_flat, from_jax_qflat
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.ops.block_fused import (
    bottleneck_block_fused, bottleneck_block_plain, pack_bottleneck_block, pack_fused_blocks,
)
from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ

INT8_STAGES = ("stem", "layer1", "layer2", "layer3")
WIDTHS = (16, 32, 64, 128)
IDENTITY_SITES = {"layer1.1", "layer1.2", "layer2.1", "layer2.2", "layer2.3", "layer3.1",
                  "layer3.2", "layer3.3", "layer3.4", "layer3.5", "layer4.1"}


def _i8(rng, shape, lo=-127):
    return rng.integers(lo, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _qfields(qflat):
    """numpy views of JAX QTensor fields and biases, for dlq_tpu_torch.interop."""
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": np.asarray(p["b"])} for k, p in qflat.items()}


def _assert_spread(q):
    """int8 outputs that exercise the requant: neither all zero nor saturated."""
    assert float((q == 0).mean()) < 0.95 and float((np.abs(q) == 127).mean()) < 0.5
    assert float(q.astype(np.float64).std()) > 5.0


def _quantized(depth=50, small_input=True, size=32, seed=0, widths=WIDTHS):
    """A ResNet calibrated and quantized by the JAX package from the port's
    numpy-seeded weights; returns JAX params and the port's copies."""
    jcfg = JR.ResNetConfig(depth=depth, num_classes=10, small_input=small_input, widths=widths)
    tcfg = TR.ResNetConfig(depth=depth, num_classes=10, small_input=small_input, widths=widths)
    tflat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(seed, tcfg), tcfg))
    flat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in tflat.items()}
    x = np.random.default_rng(seed).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    scales = j_calibrate(JM.make_sites_fn(JR.qforward, jcfg), flat, [jnp.asarray(x)], JQ)
    qflat = JM.quantize_weights(flat, JQ)
    tq, ts = from_jax_qflat(_qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, x=x, qflat=qflat, scales=scales, tq=tq, ts=ts)


@pytest.fixture(scope="module")
def r50():
    return _quantized()


def _np(taps):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in taps.items()}


def _jax_taps(qf, Ctx, m, *extra):
    fwd = jax.jit(lambda q, s, x, *e: qf(Ctx(q, s, JQ, *e), x, m["jcfg"], taps=True))
    logits, taps = fwd(m["qflat"], m["scales"], jnp.asarray(m["x"]), *extra)
    return np.asarray(logits), _np(taps)


def _port_taps(qf, ctx, m):
    with torch.inference_mode():
        logits, taps = qf(ctx, torch.from_numpy(m["x"]), m["tcfg"], taps=True)
    return logits.numpy(), _np(taps)


def _assert_slice(got, ref, exact_stages):
    (gl, gt), (rl, rt) = got, ref
    assert set(gt) == set(rt)
    for k in rt:
        if k in exact_stages:
            np.testing.assert_array_equal(gt[k], rt[k], err_msg=k)
        elif k != "logits":
            numerics.check(gt[k], rt[k], atol=1e-5, what=k)
    numerics.check(gl, rl, atol=1e-4, what="logits")
    assert numerics.top1_agreement(gl, rl) == 1.0


# ---------------------------------------------------------------------------
# K4: bottleneck_block
# ---------------------------------------------------------------------------

def _bottleneck_case(h, c4, cm, seed):
    """One identity Bottleneck's quantized sites + act scales, JAX and port."""
    rng = np.random.default_rng(seed)
    jq = {}
    for name, shape in (("b.conv1", (1, 1, c4, cm)), ("b.conv2", (3, 3, cm, cm)),
                        ("b.conv3", (1, 1, cm, c4))):
        w = rng.normal(0, 0.05, shape).astype(np.float32)
        qw = j_quantize_tensor(jnp.asarray(w), JQ.weights)
        qw.orig_shape = shape
        jq[name] = {"qw": qw, "b": jnp.asarray(rng.normal(0, 0.2, shape[-1]).astype(np.float32))}
    scales = {"b.conv1": np.float32(0.05), "b.conv2": np.float32(0.08),
              "b.conv3": np.float32(0.04), "n.conv1": np.float32(0.07)}
    jscales = {k: jnp.asarray(v) for k, v in scales.items()}
    tq, ts = from_jax_qflat(_qfields(jq), scales, device="cpu")
    x = _i8(rng, (2, h, h, c4), lo=0)  # block inputs are post-relu
    return jq, jscales, tq, ts, x


@pytest.mark.parametrize("h,c4,cm", [(16, 256, 64), (7, 512, 128)])
def test_bottleneck_block_vs_bottleneck_block_fused(h, c4, cm):
    """K4's plain version is bit-identical to the TPU kernel (interpret mode)
    at layer1's real widths and on a 7x7 stage, packs from the same sites."""
    jq, jscales, tq, ts, x = _bottleneck_case(h, c4, cm, seed=h)
    ref = np.asarray(j_bottleneck_block_fused(
        jnp.asarray(x), j_pack_bottleneck_block(jq, jscales, "b", "n.conv1"), interpret=True))
    pack = pack_bottleneck_block(tq, ts, "b", "n.conv1")
    got = bottleneck_block_fused(_t(x), pack).numpy()
    _assert_spread(ref)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(bottleneck_block_plain(_t(x), pack).numpy(), ref)


def test_bottleneck_block_vs_fullfused_composition():
    """K4 multiplies by inverse scales where FullFusedCtx divides: rounding
    ties may flip one step on ~1e-4 of elements (pallas_block.py:20-28)."""
    jq, jscales, tq, ts, x = _bottleneck_case(16, 256, 64, seed=5)

    @jax.jit
    def composition(q, p, s):
        ctx = JM.FullFusedCtx(p, s, JQ)
        y = JM.QAct(q, s["b.conv1"])
        z = ctx.conv("b.conv1", y, fuse_relu=True, out_site="b.conv2")
        z = ctx.conv("b.conv2", z, stride=1, padding=1, fuse_relu=True, out_site="b.conv3")
        z = ctx.conv("b.conv3", z, out_site="n.conv1")
        return ctx.add_relu(z, ctx.requant(y, "n.conv1")).q

    ref = np.asarray(composition(jnp.asarray(x), jq, jscales))
    got = bottleneck_block_fused(_t(x), pack_bottleneck_block(tq, ts, "b", "n.conv1")).numpy()
    assert float((got == ref).mean()) >= 0.999
    assert int(np.abs(got.astype(np.int32) - ref).max()) <= 1


def test_pack_bottleneck_block_inverse_scales():
    """The four inverse scales come from double quotients rounded once to
    fp32, in the reference's order; the mid width stays unpadded."""
    jq, jscales, tq, ts, _ = _bottleneck_case(8, 256, 64, seed=3)
    jp = j_pack_bottleneck_block(jq, jscales, "b", "n.conv1")
    tp = pack_bottleneck_block(tq, ts, "b", "n.conv1")
    np.testing.assert_array_equal(np.float32(tp["inv"]), np.asarray(jp["inv"])[0])
    assert jp["w2"].shape == (3, 3 * 128, 128)          # the reference's 128-lane pad
    assert (tp["w1"].oc, tp["w2"].oc, tp["w3"].oc) == (64, 64, 256)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(tp[f"s{i}"].numpy(), np.asarray(jp[f"s{i}"])[0, :tp[f"s{i}"].shape[0]])


# ---------------------------------------------------------------------------
# K2: matmul_int8's relu and int8 epilogues
# ---------------------------------------------------------------------------

def _mm_case(seed, m=200, k=128, n=256):
    rng = np.random.default_rng(seed)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    scale = (rng.uniform(0.5, 1.5, n) / (73.0 * 73.0 * np.sqrt(k))).astype(np.float32)
    bias = rng.normal(0, 0.3, n).astype(np.float32)
    return x, w, scale, bias


def test_matmul_int8_relu_vs_int8_matmul():
    x, w, scale, bias = _mm_case(31, m=256)
    ref = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                 jnp.asarray(bias), fuse_relu=True, interpret=True))
    pk = pack_dense_weight(_t(w))
    got = matmul_int8_plain(_t(x), pk, _t(scale), _t(bias), relu=True)
    assert float((ref == 0).mean()) > 0.2
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(matmul_int8(_t(x), pk, _t(scale), _t(bias), relu=True).numpy(),
                                  ref)


@pytest.mark.parametrize("relu", [False, True])
def test_matmul_int8_int8_out_vs_mm1x1_epilogue(relu):
    """K2's int8 output is FullFusedCtx's conv on a 1x1/s1 site: the
    ``mm1x1`` dot, then ``clip(round((acc*s + b) / s_out))``, relu folded
    into the lower bound."""
    x, w, scale, bias = _mm_case(41 + relu, m=2 * 8 * 8, k=128, n=256)
    wq = j_quantize_tensor(jnp.asarray(w.astype(np.float32).reshape(1, 1, 128, 256) * 0.01),
                           JQ.weights)
    wq.orig_shape = (1, 1, 128, 256)
    jq = {"c": {"qw": wq, "b": jnp.asarray(bias)}}
    jscales = {"c": jnp.float32(0.03), "o": jnp.float32(0.5)}

    @jax.jit
    def conv(q, p, s):
        ctx = JM.FullFusedCtx(p, s, JQ)
        return ctx.conv("c", JM.QAct(q, s["c"]), fuse_relu=relu, out_site="o").q

    ref = np.asarray(conv(jnp.asarray(x.reshape(2, 8, 8, 128)), jq, jscales)).reshape(-1, 256)
    tq, ts = from_jax_qflat(_qfields(jq), {k: np.asarray(v) for k, v in jscales.items()},
                            device="cpu")
    ctx = TM.FullFusedCtx(tq, ts, TQ)
    got = matmul_int8_plain(_t(x), ctx.packed["c"], ctx.comb("c", ctx.scale["c"]), ctx.bias("c"),
                            relu=relu, out_scale=ctx.scale["o"])
    assert got.dtype == torch.int8
    _assert_spread(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    y = ctx.conv("c", TM.QAct(_t(x.reshape(2, 8, 8, 128)), ctx.scale["c"]), fuse_relu=relu,
                 out_site="o")
    np.testing.assert_array_equal(y.q.numpy().reshape(-1, 256), ref)


# ---------------------------------------------------------------------------
# ResNet-50 through the deploy contexts
# ---------------------------------------------------------------------------

def test_fused2_int8_stages_bit_identical(r50):
    """FullFusedCtx (mm1x1 on, the reference's default): every int8
    interchange tensor through layer3 is bit-identical; the fp32 final
    junction within 1e-5, logits 1e-4."""
    ref = _jax_taps(JR.qforward_fused2, JM.FullFusedCtx, r50)
    got = _port_taps(TR.qforward_fused2, TM.FullFusedCtx(r50["tq"], r50["ts"], TQ), r50)
    _assert_slice(got, ref, INT8_STAGES)


def test_block_ctx_int8_stages_bit_identical(r50):
    """PallasBlockCtx: the 11 identity Bottlenecks run as K4 (plain version)
    in the port and as bottleneck_block_fused (interpret mode) in JAX."""
    jpacks = j_pack_fused_blocks(r50["qflat"], r50["scales"], r50["jcfg"])
    tpacks = pack_fused_blocks(r50["tq"], r50["ts"], r50["tcfg"])
    assert set(tpacks) == set(jpacks) == IDENTITY_SITES
    ref = _jax_taps(JR.qforward_fused2, JM.PallasBlockCtx, r50, jpacks)
    got = _port_taps(TR.qforward_fused2, TM.PallasBlockCtx(r50["tq"], r50["ts"], TQ, tpacks), r50)
    _assert_slice(got, ref, INT8_STAGES)


@pytest.mark.parametrize("name", ["deploy", "pallas"])
def test_fp32_interchange_ctxs(r50, name):
    """DeployCtx (mm1x1 on K2) and PallasDeployCtx (int8_matmul_padded for
    the 1x1/s1 convs in the reference) against their JAX contexts."""
    jctx = {"deploy": JM.DeployCtx, "pallas": JM.PallasDeployCtx}[name]
    tctx = {"deploy": TM.DeployCtx, "pallas": TM.PallasDeployCtx}[name]
    ref = _jax_taps(JR.qforward, jctx, r50)
    got = _port_taps(TR.qforward, tctx(r50["tq"], r50["ts"], TQ), r50)
    _assert_slice(got, ref, ())


def _perturb_bn(tree, rng, key=""):
    """Random BN statistics. The last BN of each residual branch (bn3) gets
    gamma in [0.2, 0.6], as deep ResNets keep the residual stream near unit
    scale (torchvision's zero_init_residual): with gamma ~ 1 there, 16
    Bottlenecks of random weights grow it to ~5e3, where fp32 reordering
    alone exceeds any absolute tolerance."""
    if isinstance(tree, dict) and "gamma" in tree:
        c = tree["gamma"].shape[0]
        lo, hi = (0.2, 0.6) if key == "bn3" else (0.5, 1.5)
        return {"gamma": torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)),
                "beta": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
                "mean": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
                "var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))}
    if isinstance(tree, dict):
        return {k: _perturb_bn(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_bn(v, rng) for v in tree]
    return tree


def test_weights_carried_across_fp32(r50):
    """ResNet-50's fp32 paths on the same weights, BN statistics made
    non-trivial: resnet_forward within 1e-4 of JAX's; with the weights
    carried across (flat params by from_jax_flat, conv3 sites included),
    folded_forward and the ObserveCtx forward within 1e-4 of JAX's
    folded_forward; the port's fold gives JAX's folded weights."""
    jcfg, tcfg = r50["jcfg"], r50["tcfg"]
    rng = np.random.default_rng(9)
    params = _perturb_bn(TR.init_resnet(9, tcfg), rng)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    stages = ("stem", "layer1", "layer2", "layer3", "layer4", "gap", "logits")
    _, jt = jax.jit(lambda p, xx: JR.resnet_forward(p, xx, jcfg, taps=True))(jparams, x)
    with torch.inference_mode():
        _, tt = TR.resnet_forward(params, torch.from_numpy(x), tcfg, taps=True)
    for k in stages:
        numerics.check(tt[k].numpy(), np.asarray(jt[k]), atol=1e-4, what=f"resnet_forward {k}")

    folded = JR.fold_resnet(jparams, jcfg)
    _, rt = jax.jit(lambda p, xx: JR.folded_forward(p, xx, jcfg, taps=True))(folded, x)
    flat_np = {k: {n: np.asarray(v) for n, v in p.items()}
               for k, p in JR.flatten_folded(folded).items()}
    assert sum(k.endswith(".conv3") for k in flat_np) == 16
    tflat = from_jax_flat(flat_np, device="cpu")
    nested = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), folded)
    with torch.inference_mode():
        _, gt = TR.folded_forward(nested, torch.from_numpy(x), tcfg, taps=True)
        _, ot = TR.qforward(TM.ObserveCtx(tflat), torch.from_numpy(x), tcfg, taps=True)
    for k in stages:
        numerics.check(gt[k].numpy(), np.asarray(rt[k]), atol=1e-4, what=k)
        numerics.check(ot[k].numpy(), np.asarray(rt[k]), atol=1e-4, what=k)
    tfold = TR.flatten_folded(TR.fold_resnet(params, tcfg))
    assert set(tfold) == set(flat_np)
    for site, p in tfold.items():
        for n, v in p.items():
            np.testing.assert_allclose(v.numpy(), flat_np[site][n], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{site}.{n}")


def test_resnet50_from_store(tmp_path):
    """A JAX-written resnet50 store (full widths, 10 classes) at 64 px through
    Engine.from_store: the bf16 7x7 stem, int8 maxpool, the 1x1/s1
    ``layer1.0.down`` on K2. The bf16 stem's fp32 sums come in another order
    than XLA's, so its int8 output may differ by one step on <= 1e-3 of
    elements; the logits agree to cosine 0.9999 and top-1."""
    m = _quantized(small_input=False, size=64, seed=3, widths=(64, 128, 256, 512))
    root = str(tmp_path / "r50")
    j_save(root, "resnet50", m["qflat"], m["scales"], JQ,
           meta={"config": {"num_classes": 10, "small_input": False}})
    x = np.random.default_rng(4).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_logits = np.asarray(JEngine.from_store(root, ctx="fused2", batch=2)(x))
    eng = Engine.from_store(root, ctx="fused2", device="cpu", batch=2)
    assert eng.model_cfg.bottleneck and eng.model_cfg.blocks_per_stage == (3, 4, 6, 3)
    logits = eng(x).numpy()
    assert numerics.diff(logits, ref_logits).cosine >= 0.9999
    assert numerics.top1_agreement(logits, ref_logits) == 1.0

    m["x"] = x
    _, rt = _jax_taps(JR.qforward_fused2, JM.FullFusedCtx, m)
    with torch.inference_mode():
        _, gt = TR.qforward_fused2(eng.params, torch.from_numpy(x), eng.model_cfg, taps=True)
    s = float(m["scales"]["layer1.0.conv1"])
    dq = np.rint(gt["stem"].numpy() / s) - np.rint(rt["stem"] / s)
    assert np.abs(dq).max() <= 1 and float((dq != 0).mean()) <= 1e-3
    with pytest.raises(NotImplementedError, match="BasicBlock-only"):
        Engine.from_store(root, ctx="fused", device="cpu", batch=2)


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_bottleneck_topology_matches_reference(depth):
    """ResNet-50/101/152 differ only in depth: the port's config, folded flat
    sites and their weight shapes equal the JAX package's, and the fused
    block selection picks every identity Bottleneck with an int8 junction
    (the same set as the reference's on ResNet-50: the PallasBlockCtx test)."""
    widths = (8, 16, 16, 32)
    jcfg = JR.ResNetConfig(depth=depth, num_classes=10, small_input=True, widths=widths)
    tcfg = TR.ResNetConfig(depth=depth, num_classes=10, small_input=True, widths=widths)
    assert tcfg.bottleneck and tcfg.expansion == 4
    assert tcfg.blocks_per_stage == jcfg.blocks_per_stage
    jflat = jax.eval_shape(lambda: JR.flatten_folded(
        JR.fold_resnet(JR.init_resnet(jax.random.PRNGKey(0), jcfg), jcfg)))
    tflat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(0, tcfg), tcfg))
    assert {k: {n: tuple(v.shape) for n, v in p.items()} for k, p in tflat.items()} == \
        {k: {n: tuple(v.shape) for n, v in p.items()} for k, p in jflat.items()}
    assert "layer1.0.down" in tflat and tflat["layer1.0.down"]["w"].shape[:2] == (1, 1)
    identity = {f"layer{s + 1}.{b}" for s, n in enumerate(tcfg.blocks_per_stage)
                for b in range(1, n)} - {f"layer4.{tcfg.blocks_per_stage[3] - 1}"}
    tpacks = pack_fused_blocks(TM.quantize_weights(tflat, TQ),
                               {k: torch.tensor(0.05) for k in tflat}, tcfg)
    assert set(tpacks) == identity and len(identity) == sum(tcfg.blocks_per_stage) - 5
    with pytest.raises(NotImplementedError, match="BasicBlock-only"):
        TR.qforward_fused(None, None, tcfg)
