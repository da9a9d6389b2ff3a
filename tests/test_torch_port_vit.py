"""The DeiT slice of the port against the JAX package: the dtype contract of
``dense``/``qdense``, the fp32 forward, calibration, the store with ViT
extras both ways, and ``Engine.from_store(ctx="block"|"deploy")`` on a
JAX-written store against JAX's own engines, on numpy-seeded weights and
inputs. The port runs on the CPU, where every kernel wrapper runs its
plain version; the JAX block kernels run in interpret mode, as the JAX
package's own tests run them.

Sizes: the JAX tests' (``ViTConfig(image_size=32, patch=8, dim=96, ...)``
with pad lanes, and ``image_size=64, patch=16, dim=192`` with the
full-width head), depth 2 or 6, 10 classes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import common as JC
from dlq_tpu.models import vit as JV
from dlq_tpu.ops import qops as JO
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT4_WEIGHT_ONLY_G128 as JG128
from dlq_tpu.quant.qconfig import INT4_WEIGHT_ONLY_PER_OC as JWO4
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JQ4
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.quantize import quantize_tensor as j_quantize_tensor
from dlq_tpu.quant.store import load_quantized as j_load
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.models import common as TC
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import qops as TO
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.calibrate import calibrate
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ
from dlq_tpu_torch.quant.store import load_quantized, save_quantized
from test_torch_port_vit_kernels import CONFIGS, np_tree, qfields, quantized_vit

META_KEYS = ("num_classes", "image_size", "patch", "dim", "depth", "heads")


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the dtype contract of dense / qdense (fails before the fix: a bf16 x
# against an fp32 weight raised, and qdense always returned fp32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_dtype_contract(dtype):
    """fp32 product, cast to x.dtype, then the fp32 bias with promotion: a
    bf16 x gives fp32 (``dlq_tpu/models/common.py:84-86``)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (5, 7, 48)).astype(np.float32)
    w = rng.normal(0, 0.1, (48, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, 24).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for bias in (b, None):
        ref = JC.dense(jx, jnp.asarray(w), None if bias is None else jnp.asarray(bias))
        got = TC.dense(tx, torch.from_numpy(w), None if bias is None else torch.from_numpy(bias))
        assert str(got.dtype)[6:] == str(ref.dtype)
        np.testing.assert_allclose(got.float().numpy(), _bf16_np(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qdense_dtype_contract(dtype):
    """W8A8 and weight-only qdense return x.dtype after bias and relu
    (``dlq_tpu/ops/qops.py:488-492``); the values are the reference's."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (6, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, 32).astype(np.float32)
    jqw = j_quantize_tensor(jnp.asarray(w), JQ.weights)
    tq, _ = from_jax_qflat(qfields({"s": {"qw": jqw, "b": b}}), device="cpu")
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for scale, relu in ((0.021, False), (0.021, True), (None, False)):
        # jitted, as the JAX engines run it (XLA then contracts acc*s + b)
        ref = jax.jit(lambda xx, bb: JO.qdense(xx, jqw, bb, act_scale=None if scale is None else
                                               jnp.float32(scale), fuse_relu=relu))(
            jx, jnp.asarray(b))
        got = TO.qdense(tx, tq["s"]["qw"], tq["s"]["b"], act_scale=None if scale is None else
                        torch.tensor(scale, dtype=torch.float32), fuse_relu=relu)
        assert got.dtype == tx.dtype and str(ref.dtype) == dtype
        tol = 0 if scale is not None else 1e-6
        np.testing.assert_allclose(got.float().numpy(), _bf16_np(ref), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# fp32 forward and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_vit_forward_fp32_matches_jax(name, gelu):
    """The port's fp32 forward against ``vit_forward`` within 1e-4 (sums
    in another order)."""
    kw = CONFIGS[name]
    tcfg = TV.ViTConfig(depth=2, gelu=gelu, **kw)
    params = TV.init_vit(0, tcfg)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    s = kw["image_size"]
    x = np.random.default_rng(1).normal(0, 1, (3, s, s, 3)).astype(np.float32)
    ref = np.asarray(JV.vit_forward(jparams, jnp.asarray(x), JV.ViTConfig(depth=2, gelu=gelu,
                                                                            **kw)))
    got = TV.vit_forward(params, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_init_vit_is_the_reference_layout():
    cfg = TV.ViTConfig(depth=2, **CONFIGS["d96"])
    p = TV.init_vit(3, cfg)
    j = JV.init_vit(jax.random.PRNGKey(0), JV.ViTConfig(depth=2, **CONFIGS["d96"]))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), j)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == shapes
    w = p["layers"][0]["fc1"]["w"]
    assert float(w.abs().max()) <= 0.04 and abs(float(w.std()) - 0.0176) < 0.002


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_calibration_matches_jax(name):
    """Act scales of ``make_qforward`` under the port's calibration against
    ``dlq_tpu.quant.calibrate`` on the same weights and batches. The
    calibration context promotes the bf16 interchange to fp32 after the
    patch embed in both packages (``common.dense``); the scales are abs-max
    over bf16/fp32 activations whose sums run in another order: relative
    1e-3."""
    m = quantized_vit(name)
    tcfg = m["tcfg"]
    tflat = TV.flatten_vit(m["tparams"])
    qf = TV.make_qforward(TV.vit_extras(m["tparams"]), tcfg.depth, tcfg.heads, tcfg.patch,
                          tcfg.dim)
    s = tcfg.image_size
    calib = np.random.default_rng(0).normal(0, 1, (8, s, s, 3)).astype(np.float32)
    # quantized_vit drew its calibration batch after the weights from the
    # same generator; redo it here from a fresh one on both sides
    jsc = j_calibrate(JM.make_sites_fn(m["qf"], m["jcfg"]), JV.flatten_vit(m["jparams"]),
                      [jnp.asarray(calib)], JQ)
    tsc = calibrate(TM.make_sites_fn(qf, tcfg), tflat, [torch.from_numpy(calib)], TQ)
    assert set(tsc) == set(jsc) and len(tsc) == 4 * tcfg.depth + 2
    for k in jsc:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-3)


def test_engine_quantized_vit():
    """``Engine.quantized`` calibrates ``make_qforward`` through
    ``make_sites_fn`` and deploys it under DeployCtx (K2 dense sites)."""
    cfg = TV.ViTConfig(depth=2, **CONFIGS["d192"])
    params = TV.init_vit(0, cfg)
    qf = TV.make_qforward(TV.vit_extras(params), cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    rng = np.random.default_rng(2)
    calib = [rng.normal(0, 1, (8, 64, 64, 3)).astype(np.float32)]
    eng = Engine.quantized(qf, TV.flatten_vit(params), cfg, TQ, calib_batches=calib, batch=4,
                           device="cpu")
    assert len(eng.act_scales) == 4 * cfg.depth + 2
    x = rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    ref = TV.vit_forward(params, torch.from_numpy(x), cfg)
    assert numerics.diff(eng(x), ref).cosine > 0.999


# ---------------------------------------------------------------------------
# stores and engines
# ---------------------------------------------------------------------------

def _jax_store(root, m, qcfg=JQ):
    meta = {"config": {k: getattr(m["jcfg"], k) for k in META_KEYS}}
    qflat = m["qflat"] if qcfg is JQ else JM.quantize_weights(JV.flatten_vit(m["jparams"]), qcfg)
    return j_save(root, "deit_tiny", qflat, m["scales"], qcfg, extras=m["ex"], meta=meta)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def store6(request, tmp_path_factory):
    """A depth-6 DeiT written by the JAX package (``save_quantized`` with
    extras)."""
    m = quantized_vit(request.param, depth=6, batch=4)
    root = str(tmp_path_factory.mktemp(f"deit6_{request.param}") / "q")
    _jax_store(root, m)
    return m, root


def test_from_store_block_matches_jax_engine(store6):
    """``Engine.from_store(ctx="block")`` on a JAX-written store against
    JAX's own engine on the same store: 6 layers per chunk (depth 6), the
    K5/K6/K7 plain versions against the interpret-mode stacked kernel.
    Gates: logits cosine >= 0.9999 and top-1 1.0 (the int8 codes agree up
    to sum-order flips, see test_torch_port_vit_kernels.py)."""
    m, root = store6
    ref = np.asarray(JEngine.from_store(root, ctx="block", batch=4)(m["x"]))
    eng = Engine.from_store(root, ctx="block", batch=4, device="cpu")
    assert [len(c) for c in eng.params["_chunks"]] == [6]
    got = eng(m["x"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.9999, d
    assert numerics.top1_agreement(got, ref) == 1.0


def test_from_store_deploy_matches_jax_engine(store6):
    """``Engine.from_store(ctx="deploy")``: ``make_qforward`` under DeployCtx
    with bf16 interchange, against JAX's engine on the same store and
    against the fp32 forward. Every op rounds as the reference's does when
    run alone (checked bit for bit), but XLA fuses a jitted forward and
    skips some bf16 roundings inside a fusion: the JAX engine against the
    same forward run op by op (``jax.disable_jit``) is itself only at
    cosine 0.9992-0.9996 on these random-weight logits. So the gates are
    top-1 1.0 and cosine >= 0.998 against the JAX engine, and the port at
    least as close to the fp32 forward as the JAX engine is (less 1e-4)."""
    m, root = store6
    ref = np.asarray(JEngine.from_store(root, ctx="deploy", batch=4)(m["x"]))
    got = Engine.from_store(root, ctx="deploy", batch=4, device="cpu")(m["x"]).numpy()
    fp32 = np.asarray(JV.vit_forward(m["jparams"], jnp.asarray(m["x"]), m["jcfg"]))
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.998, d
    assert numerics.top1_agreement(got, ref) == 1.0
    assert numerics.diff(got, fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4


def test_store_extras_roundtrip_both_ways(tmp_path):
    """The JAX store's extras load into the port; the port's store (with
    extras) loads into the JAX package with every tensor equal."""
    m = quantized_vit("d96")
    _jax_store(str(tmp_path / "j"), m)
    tq, ts, tcfg, tex = load_quantized(str(tmp_path / "j"))
    assert len(tex) == 2 + 2 + 4 * m["jcfg"].depth
    root = str(tmp_path / "t")
    from dlq_tpu_torch.quant.store import unflatten_extras

    save_quantized(root, "deit_tiny", tq, ts, tcfg, extras=unflatten_extras(tex),
                   meta={"config": {k: getattr(m["jcfg"], k) for k in META_KEYS}})
    jq, js, _, jex = j_load(root)
    assert set(jex) == set(tex)
    for k in tex:
        np.testing.assert_array_equal(np.asarray(jex[k]), tex[k].numpy())
    for k in ts:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy())
    for k, p in tq.items():
        np.testing.assert_array_equal(np.asarray(jq[k]["qw"].values), p["qw"].values.numpy())
    ref = np_tree(JV.vit_extras(m["jparams"]))
    np.testing.assert_array_equal(unflatten_extras(tex)["ln"][1]["ln2"]["g"].numpy(),
                                  ref["ln"][1]["ln2"]["g"])


def test_routing_guards(tmp_path):
    """A depth-2 store runs one layer per chunk; an INT4A8 store builds the
    W4A8 block engine, a weight-only per-OC int4 store the W4A16 one, and a
    group-wise weight-only store raises the reference's ValueError; conv
    contexts are refused; ``fused_ln=True`` and ``attn_impl="xla_int8"``
    run; the SmoothQuant fold takes an LN-foldable vector and refuses any
    other site with the reference's ValueError."""
    m = quantized_vit("d96", depth=2)
    _jax_store(str(tmp_path / "w8"), m)
    eng = Engine.from_store(str(tmp_path / "w8"), ctx="block", batch=4, device="cpu")
    assert [len(c) for c in eng.params["_chunks"]] == [1, 1]
    with pytest.raises(ValueError, match="deploy"):
        Engine.from_store(str(tmp_path / "w8"), ctx="fused2", device="cpu")
    _jax_store(str(tmp_path / "w4"), m, qcfg=JQ4)
    assert Engine.from_store(str(tmp_path / "w4"), ctx="block",
                             device="cpu").name == "deit_tiny_block_w4a8"
    _jax_store(str(tmp_path / "wo4"), m, qcfg=JWO4)
    assert Engine.from_store(str(tmp_path / "wo4"), ctx="block",
                             device="cpu").name == "deit_tiny_block_w4"
    _jax_store(str(tmp_path / "g128"), m, qcfg=JG128)
    with pytest.raises(ValueError, match="weight-only"):
        Engine.from_store(str(tmp_path / "g128"), ctx="block", device="cpu")
    # fused_ln (K16/K17) is ported: the deploy forward runs on it
    qf = TV.make_qforward(m["tex"], 2, 3, 8, 96, fused_ln=True)
    out = qf(TM.DeployCtx(m["tq"], m["ts"], TQ), torch.from_numpy(m["x"]), m["tcfg"])
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    # attn_impl="xla_int8" (K18) is ported: the deploy forward runs on it
    qf = TV.make_qforward(m["tex"], 2, 3, 8, 96, attn_impl="xla_int8")
    out = qf(TM.DeployCtx(m["tq"], m["ts"], TQ), torch.from_numpy(m["x"]), m["tcfg"])
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    from dlq_tpu_torch.ops.vit_block import pack_vit_blocks_w8

    # the SmoothQuant LN fold is ported: a vector of a non-foldable site
    # raises the reference's ValueError, an LN-foldable one packs
    with pytest.raises(ValueError, match="fold"):
        pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"], smooth={"l0.proj": 1.0})
    packed = pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"], smooth={"l0.qkv": 2.0})
    plain = pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"])
    assert torch.equal(packed["blocks"][0]["ln1"], plain["blocks"][0]["ln1"] * 0.5)
    assert torch.equal(packed["blocks"][0]["ln2"], plain["blocks"][0]["ln2"])
