"""The ported slice end to end: ResNet-18 W8A8 through the port's deploy
contexts against the JAX package's, on the same weights, act scales and
numpy-seeded inputs.

The JAX forwards are jitted with params and scales as arguments, as its
Engine runs them (a captured scale would let XLA turn a division into a
multiply by the reciprocal). The port runs on the CPU, where every kernel
wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import resnet as JR
from dlq_tpu.ops.pallas_block import pack_fused_blocks as j_pack_fused_blocks
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_flat, from_jax_qflat
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.ops.block_fused import pack_fused_blocks
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ

INT8_STAGES = ("stem", "layer1", "layer2", "layer3")


def _jflat(cfg_t, seed):
    """Folded fp32 flat params from the port's numpy-seeded init, as jnp."""
    flat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(seed, cfg_t), cfg_t))
    return {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in flat.items()}


def _qfields(qflat):
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": np.asarray(p["b"])} for k, p in qflat.items()}


def _quantized(small_input, size, seed=0):
    """ResNet-18 (full widths, 10 classes) calibrated and quantized by the
    JAX package; returns JAX params and the port's copies of them."""
    jcfg = JR.ResNetConfig(depth=18, num_classes=10, small_input=small_input)
    tcfg = TR.ResNetConfig(depth=18, num_classes=10, small_input=small_input)
    flat = _jflat(tcfg, seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, size, size, 3)).astype(np.float32)
    scales = j_calibrate(JM.make_sites_fn(JR.qforward, jcfg), flat, [jnp.asarray(x)], JQ)
    qflat = JM.quantize_weights(flat, JQ)
    tq, ts = from_jax_qflat(_qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, flat=flat, x=x, qflat=qflat, scales=scales, tq=tq, ts=ts)


@pytest.fixture(scope="module")
def small():
    return _quantized(small_input=True, size=32)


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


def test_fused2_int8_stages_bit_identical(small):
    """FullFusedCtx: every int8 interchange tensor through layer3 is
    bit-identical; the fp32 final junction within 1e-5, logits 1e-4."""
    ref = _jax_taps(JR.qforward_fused2, JM.FullFusedCtx, small)
    got = _port_taps(TR.qforward_fused2, TM.FullFusedCtx(small["tq"], small["ts"], TQ), small)
    _assert_slice(got, ref, INT8_STAGES)


def test_block_ctx_int8_stages_bit_identical(small):
    """PallasBlockCtx: layer2.1 and layer3.1 run as K3 in the port and as
    basic_block_fused (interpret mode) in JAX; same formulas, same bits."""
    jpacks = j_pack_fused_blocks(small["qflat"], small["scales"], small["jcfg"])
    tpacks = pack_fused_blocks(small["tq"], small["ts"], small["tcfg"])
    assert set(tpacks) == set(jpacks) == {"layer2.1", "layer3.1"}
    ref = _jax_taps(JR.qforward_fused2, JM.PallasBlockCtx, small, jpacks)
    got = _port_taps(TR.qforward_fused2, TM.PallasBlockCtx(small["tq"], small["ts"], TQ, tpacks),
                     small)
    _assert_slice(got, ref, INT8_STAGES)


@pytest.mark.parametrize("name", ["deploy", "pallas", "fused"])
def test_fp32_interchange_ctxs(small, name):
    qf = {"fused": (JR.qforward_fused, TR.qforward_fused)}.get(name, (JR.qforward, TR.qforward))
    jctx = {"deploy": JM.DeployCtx, "pallas": JM.PallasDeployCtx, "fused": JM.FusedDeployCtx}[name]
    tctx = {"deploy": TM.DeployCtx, "pallas": TM.PallasDeployCtx, "fused": TM.FusedDeployCtx}[name]
    ref = _jax_taps(qf[0], jctx, small)
    got = _port_taps(qf[1], tctx(small["tq"], small["ts"], TQ), small)
    _assert_slice(got, ref, ())


def test_224_topology_from_store(tmp_path):
    """7x7/s2 bf16 stem + int8 maxpool at 64 px through Engine.from_store.
    The bf16 stem's fp32 sums come in another order than XLA's, so its
    int8 output may differ by one step on <= 1e-3 of elements."""
    m = _quantized(small_input=False, size=64, seed=3)
    root = str(tmp_path / "r18")
    j_save(root, "resnet18", m["qflat"], m["scales"], JQ,
           meta={"config": {"num_classes": 10, "small_input": False}})
    x = np.random.default_rng(4).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_logits = np.asarray(JEngine.from_store(root, ctx="fused2", batch=2)(x))
    eng = Engine.from_store(root, ctx="fused2", device="cpu", batch=2)
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

    # streaming: 5 images through batch-2 engine (padding on the last batch)
    imgs = np.random.default_rng(5).normal(0, 1, (5, 64, 64, 3)).astype(np.float32)
    preds = eng.classify(imgs)
    direct = np.concatenate([eng(imgs[i:i + 2]).numpy().argmax(-1) for i in range(0, 5, 2)])
    np.testing.assert_array_equal(preds, direct)
    assert eng.stats.images == 2 + 5 + 5 and preds.shape == (5,)


def test_weights_carried_across_fp32(small):
    """The fp32 paths on the same weights, BN statistics made non-trivial:
    the port's resnet_forward within 1e-4 of JAX's, and, with the weights
    carried across by from_jax_flat, the port's folded forward (nested
    params, and flat params through ObserveCtx) within 1e-4 of JAX's
    folded_forward."""
    jcfg, tcfg = small["jcfg"], small["tcfg"]
    rng = np.random.default_rng(9)
    params = TR.init_resnet(9, tcfg)

    def perturb_bn(tree):
        if isinstance(tree, dict) and "gamma" in tree:
            c = tree["gamma"].shape[0]
            return {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                    "beta": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
                    "mean": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
                    "var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))}
        if isinstance(tree, dict):
            return {k: perturb_bn(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb_bn(v) for v in tree]
        return tree

    params = perturb_bn(params)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    stages = ("stem", "layer1", "layer2", "layer3", "layer4", "gap", "logits")
    _, jt = jax.jit(lambda p, xx: JR.resnet_forward(p, xx, jcfg, taps=True))(jparams, x)
    with torch.inference_mode():
        _, tt = TR.resnet_forward(params, torch.from_numpy(x), tcfg, taps=True)
    for k in stages:
        numerics.check(tt[k].numpy(), np.asarray(jt[k]), atol=1e-4, what=f"resnet_forward {k}")

    folded = JR.fold_resnet(jparams, jcfg)
    rl, rt = jax.jit(lambda p, xx: JR.folded_forward(p, xx, jcfg, taps=True))(folded, x)
    flat_np = {k: {n: np.asarray(v) for n, v in p.items()}
               for k, p in JR.flatten_folded(folded).items()}
    tflat = from_jax_flat(flat_np, device="cpu")
    nested = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), folded)
    with torch.inference_mode():
        gl, gt = TR.folded_forward(nested, torch.from_numpy(x), tcfg, taps=True)
        ol, ot = TR.qforward(TM.ObserveCtx(tflat), torch.from_numpy(x), tcfg, taps=True)
    for k in stages:
        numerics.check(gt[k].numpy(), np.asarray(rt[k]), atol=1e-4, what=k)
        numerics.check(ot[k].numpy(), np.asarray(rt[k]), atol=1e-4, what=k)
    # the port's own fold gives the same folded weights as JAX's
    tfold = TR.flatten_folded(TR.fold_resnet(params, tcfg))
    for site, p in tfold.items():
        for n, v in p.items():
            np.testing.assert_allclose(v.numpy(), flat_np[site][n], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{site}.{n}")


def test_engine_pads_tensor_batches_in_place():
    """A tensor batch is padded with zero rows where it lies; numpy and
    tensor inputs give the same results through __call__ and classify."""
    seen = []

    def fwd(p, x):
        seen.append(x)
        return x.reshape(x.shape[0], -1)[:, :3] * p

    eng = Engine(fwd, torch.tensor(2.0), batch=4, device="cpu")
    x = np.random.default_rng(12).normal(0, 1, (3, 2, 2, 3)).astype(np.float32)
    out_t, out_n = eng(torch.from_numpy(x)), eng(x)
    assert seen[0].shape == (4, 2, 2, 3) and not seen[0][3].any()
    torch.testing.assert_close(out_t, out_n, rtol=0, atol=0)
    assert out_t.shape == (3, 3)
    imgs = np.random.default_rng(13).normal(0, 1, (7, 2, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(eng.classify(torch.from_numpy(imgs)), eng.classify(imgs))


def test_engine_quantized_on_cpu(small):
    """Engine.quantized (calibration + W8A8 DeployCtx) agrees with the fp32
    engine on random weights, as the reference's pipeline test asks."""
    tcfg = small["tcfg"]
    folded = TR.fold_resnet(TR.init_resnet(11, tcfg), tcfg)
    flat = TR.flatten_folded(folded)
    x = np.random.default_rng(11).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    q = Engine.quantized(TR.qforward, flat, tcfg, TQ, calib_batches=[x], batch=4, device="cpu")
    f = Engine.fp32(TR.folded_forward, folded, tcfg, batch=4, device="cpu")
    lq, lf = q(x).numpy(), f(x).numpy()
    assert numerics.top1_agreement(lq, lf) == 1.0
    assert numerics.diff(lq, lf).cosine > 0.999
    assert TR.ResNetConfig(depth=50).bottleneck and not tcfg.bottleneck
    with pytest.raises(ValueError, match="unsupported ResNet depth"):
        TR.ResNetConfig(depth=42)
