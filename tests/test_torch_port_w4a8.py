"""The W4A8 slice of the port against the JAX package: halves packing,
``materialize_int8``, K10's plain version against ``int4a8_matmul`` and
``int4a8_matmul_cached``, the W4A8 block packing, K8 -> K6 -> K9's plain
versions against ``vit_block_fused_w4a8``, ``_w4a8c`` and
``vit_multiblock_fused_w4a8``, the three W4A8 forwards, and
``Engine.from_store`` on a JAX-written ``INT4A8_PER_CHANNEL`` store. The
same numpy-seeded model goes through both packages; the JAX kernels run in
interpret mode, jitted, as the JAX package's own tests run them; the port
runs on the CPU, where every kernel wrapper runs its plain version.

Sizes: dim 96 (Dp 128, so the halves split at 64 with K rows 96-127 zero,
and a pad-head slot) and dim 192 (Dp 192, the split at 96), depth 2, 32 and
64 px, a random bias on every dense site. The int32 sums are exact, so the
plain versions are held bit for bit where the reference's are; the fp32
two-layer chain keeps the W8A8 tests' stated slack (one FC2 step after an int8
code flips at a rounding boundary).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import vit as JV
from dlq_tpu.ops import pallas_matmul as JMM
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant import quantize as JQZ
from dlq_tpu.quant import store as JS
from dlq_tpu.quant.qconfig import INT4_WEIGHT_ONLY_G128 as JG128
from dlq_tpu.quant.qconfig import INT4_WEIGHT_ONLY_PER_OC as JWO4
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JQ4
from dlq_tpu.quant.qconfig import QScheme as JQScheme
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.ops.matmul_int4a8 import (
    matmul_int4a8, matmul_int4a8_plain, pack_int4a8_weight, unpack_halves_kmajor,
)
from dlq_tpu_torch.quant import quantize as TQZ
from dlq_tpu_torch.quant.store import materialize_int8
from test_torch_port_vit_kernels import assert_close_valid, qfields, quantized_vit, streams, t, tb

META_KEYS = ("num_classes", "image_size", "patch", "dim", "depth", "heads")


@functools.cache
def w4a8_vit(name):
    """``quantized_vit``'s depth-2 model and act scales (random biases), its
    weights quantized ``INT4A8_PER_CHANNEL`` by the JAX package; JAX and
    port views (built once per configuration for the module's fixtures)."""
    m = quantized_vit(name, depth=2, batch=4, bias_std=0.05)
    m["qflat"] = JM.quantize_weights(JV.flatten_vit(m["jparams"]), JQ4)
    m["tq"], _ = from_jax_qflat(qfields(m["qflat"]), device="cpu")
    return m


@pytest.fixture(scope="module", params=["d96", "d192"])
def model(request):
    m = dict(w4a8_vit(request.param))
    m["jpack"] = JB.pack_vit_blocks_w4a8(m["qflat"], m["scales"], m["ex"], m["jcfg"], tight=True)
    m["tpack"] = TB.pack_vit_blocks_w4a8(m["tq"], m["ts"], m["tex"], m["tcfg"], tight=True)
    m["pads"] = JB.vit_pads(m["jcfg"], tight=True)
    return m


def _kw(cfg):
    return dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5), (192, 576), (384, 3)])
def test_halves_pack_matches_jax(shape):
    """``pack_int4_halves`` / ``unpack_int4_halves`` bit-identical to JAX's
    on every nibble value, -8 included; the round trip is exact."""
    rng = np.random.default_rng(shape[0])
    q = rng.integers(-8, 8, shape).astype(np.int8)
    q[0, 0], q[-1, -1] = -8, 7
    ref = np.asarray(JQZ.pack_int4_halves(jnp.asarray(q)))
    got = TQZ.pack_int4_halves(torch.from_numpy(q))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    back = TQZ.unpack_int4_halves(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JQZ.unpack_int4_halves(jnp.asarray(ref))))
    np.testing.assert_array_equal(back.numpy(), q)


def test_materialize_int8_matches_jax():
    """Per-OC int4 sites (dense and conv) unpack to the reference's int8
    QTensors; a group-wise int4 site stays packed."""
    rng = np.random.default_rng(7)
    flat = {"d": {"w": rng.normal(0, 0.1, (64, 32)).astype(np.float32), "b": None},
            "c": {"w": rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32), "b": None}}
    jflat = {k: {"w": jnp.asarray(p["w"]), "b": None} for k, p in flat.items()}
    q4 = JM.quantize_weights(jflat, JQ4)
    q4["g"] = JM.quantize_weights({"g": {"w": jnp.asarray(rng.normal(0, 0.1, (256, 8)),
                                                          jnp.float32), "b": None}},
                                  JG128)["g"]
    ref = JS.materialize_int8(q4)
    got = materialize_int8(from_jax_qflat(qfields(q4), device="cpu")[0])
    for site in ("d", "c", "g"):
        j, p = ref[site]["qw"], got[site]["qw"]
        assert (p.bits, p.axis, p.group, tuple(p.shape), tuple(p.layout_shape)) == \
            (j.bits, j.axis, j.group, tuple(j.shape), tuple(j.layout_shape))
        np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
        np.testing.assert_array_equal(p.scale.numpy(), np.asarray(j.scale))
    assert got["d"]["qw"].bits == 8 and got["g"]["qw"].bits == 4


def test_pack_vit_blocks_w4a8_matches_jax(model):
    """The block weights are the reference's halves-packed bytes, transposed
    (the split at the padded Kp/2); scales (pad lanes 1.0), biases, LN rows
    and inverse scales are the reference's."""
    for jb, tblk in zip(model["jpack"]["blocks"], model["tpack"]["blocks"]):
        for k in ("wqkv", "wproj", "wfc1", "wfc2"):
            assert tblk[k].dtype == torch.uint8
            np.testing.assert_array_equal(tblk[k].t().numpy(), np.asarray(jb[k]))
            np.testing.assert_array_equal(
                unpack_halves_kmajor(tblk[k]).t().numpy(),
                np.asarray(JQZ.unpack_int4_halves(jb[k])))
        for k in ("sqkv", "bqkv", "sproj", "bproj", "sfc1", "bfc1", "sfc2", "bfc2"):
            np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jb[k])[0])
        for k in ("ln1", "ln2"):
            np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jb[k]))
        assert np.array_equal(np.float32(tblk["inv_act"]), np.asarray(jb["inv_act"])[0])
    np.testing.assert_array_equal(model["tpack"]["head"]["w"].numpy(),
                                  np.asarray(model["jpack"]["head"]["w"]))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["int4a8_matmul", "int4a8_matmul_cached"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", ["zero", "random"])
@pytest.mark.parametrize("mkn", [(128, 192, 256), (64, 96, 128)])
def test_matmul_int4a8_matches_jax(fn, relu, bias, mkn):
    """K10's plain version (and its CPU wrapper) bit-identical to the Pallas
    kernels on the store's adjacent-packed weights; K = 96 pads to Kp 128."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = jnp.asarray(rng.normal(0, 0.1, (k, n)), jnp.float32)
    qw = JQZ.quantize_tensor(w, JQ4.weights)
    scale = (rng.uniform(0.5, 1.5, n) / (127.0 * 7.0 * np.sqrt(k))).astype(np.float32)
    b = (np.zeros(n) if bias == "zero" else rng.normal(0, 0.3, n)).astype(np.float32)
    jfn = getattr(JMM, fn)
    ref = np.asarray(jfn(jnp.asarray(x), qw.values, jnp.asarray(scale), jnp.asarray(b),
                         fuse_relu=relu, interpret=True))
    tq, _ = from_jax_qflat(qfields({"s": {"qw": qw, "b": None}}), device="cpu")
    pk = pack_int4a8_weight(tq["s"]["qw"])
    assert pk.wp.dtype == torch.uint8 and pk.wp.shape == (n, -(-k // 64) * 32)
    args = (torch.from_numpy(x), pk, torch.from_numpy(scale), torch.from_numpy(b), relu)
    np.testing.assert_array_equal(matmul_int4a8_plain(*args).numpy(), ref)
    np.testing.assert_array_equal(matmul_int4a8(*args).numpy(), ref)


# ---------------------------------------------------------------------------
# K8 -> K6 -> K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["vit_block_fused_w4a8", "vit_block_fused_w4a8c"])
def test_block_w4a8_matches_jax(model, fn):
    """One W4A8 block (bf16 stream) as K8 -> K6 -> K9's plain versions
    against both reference kernels: every valid element equal."""
    y, _ = streams(model)
    kw = _kw(model["jcfg"])
    ref = getattr(JB, fn)(y, model["jpack"]["blocks"][0], interpret=True, **kw)
    got = getattr(TB, fn)(tb(y), model["tpack"]["blocks"][0], **kw)
    assert got.dtype == torch.bfloat16
    assert_close_valid(got, ref, kw["n_valid"], kw["d_valid"], step=0.0)


def test_block_w4a8_fc2_association(model):
    """On an fp32 stream the output shows every rounding: the reference's
    single-block W4A8 kernel adds FC2's residual as ``z1 + fma(acc, s, b)``
    (the stacked association, not the W8 single block's ``fma(acc, s, z1) +
    b``): the port's block is bit-equal, the other order is not."""
    _, yf = streams(model)
    kw = _kw(model["jcfg"])
    w = model["tpack"]["blocks"][1]
    ref = JB.vit_block_fused_w4a8(yf, model["jpack"]["blocks"][1], interpret=True, **kw)
    got = TB.vit_block_fused_w4a8(t(yf), w, **kw)
    assert got.dtype == torch.float32
    assert_close_valid(got, ref, kw["n_valid"], kw["d_valid"], step=0.0, min_equal=1.0)
    qkv = TB.vit_block_pre_w4a8(t(yf), w, kw["d_valid"])
    a = TB._attention(qkv, kw["heads"], kw["hd"], kw["n_valid"])
    other = TB.vit_block_post_w4a8(t(yf), a, w, kw["d_valid"], multi=False)
    n, d = kw["n_valid"], kw["d_valid"]
    r = np.asarray(ref)[:, :n, :d]
    assert float((other.numpy()[:, :n, :d] != r).mean()) > 0.01


@pytest.mark.parametrize("stream", ["bf16", "fp32"])
def test_multiblock_w4a8_matches_jax(model, stream):
    """Two stacked W4A8 layers against ``vit_multiblock_fused_w4a8`` (L=2),
    with ``test_multiblock_w8_matches_jax``'s gates: fp32 0.97 equal and
    4e-3 (a layer-1 LN sum on a rounding boundary can flip one layer-2
    code), bf16 every valid element equal."""
    y, yf = streams(model)
    yy = y if stream == "bf16" else yf
    kw = _kw(model["jcfg"])
    ref = JB.vit_multiblock_fused_w4a8(yy, JB.stack_vit_blocks_w4a8(model["jpack"], 2)[0],
                                       interpret=True, **kw)
    chunk = TB.stack_vit_blocks_w4a8(model["tpack"], 2)[0]
    got = TB.vit_multiblock_fused_w4a8(t(yy) if stream == "fp32" else tb(yy), chunk, **kw)
    if stream == "fp32":
        assert got.dtype == torch.float32
        assert_close_valid(got, ref, kw["n_valid"], kw["d_valid"], step=4e-3, min_equal=0.97)
    else:
        assert got.dtype == torch.bfloat16
        assert_close_valid(got, ref, kw["n_valid"], kw["d_valid"], step=0.0)


@pytest.mark.parametrize("fn", ["vit_forward_blockfused_w4a8", "vit_forward_blockfused_w4a8c",
                                "vit_forward_multiblock_w4a8"])
def test_forwards_w4a8_match_jax(model, fn):
    """The three W4A8 forwards (the multiblock one with 2 layers per chunk)
    against the reference's."""
    kw = dict(layers_per_kernel=2) if "multiblock" in fn else {}
    ref = np.asarray(getattr(JB, fn)(model["jpack"], jnp.asarray(model["x"]), model["jcfg"],
                                     tight=True, interpret=True, **kw))
    got = getattr(TB, fn)(model["tpack"], torch.from_numpy(model["x"]), model["tcfg"],
                          tight=True, **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# engines on a JAX-written INT4A8 store
# ---------------------------------------------------------------------------

def _store(root, m, qcfg=JQ4, scales=True):
    meta = {"config": {k: getattr(m["jcfg"], k) for k in META_KEYS}}
    qflat = m["qflat"] if qcfg is JQ4 else JM.quantize_weights(JV.flatten_vit(m["jparams"]), qcfg)
    return JS.save_quantized(root, "deit_tiny", qflat, m["scales"] if scales else None, qcfg,
                             extras=m["ex"], meta=meta)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    m = w4a8_vit("d192")
    root = str(tmp_path_factory.mktemp("deit_w4a8") / "q")
    _store(root, m)
    return m, root


def test_from_store_block_w4a8_matches_jax_engine(store):
    """``ctx="block"`` on an INT4A8 store builds ``deit_tiny_block_w4a8``
    (K8 -> K6 -> K9 per layer), against JAX's ``block_w4a8`` engine: cosine
    >= 0.9999 and top-1 1.0, as the W8 block engine's test."""
    m, root = store
    jeng = JEngine.from_store(root, ctx="block", batch=4)
    eng = Engine.from_store(root, ctx="block", batch=4, device="cpu")
    assert jeng.name == eng.name == "deit_tiny_block_w4a8"
    assert eng.params["blocks"][0]["wqkv"].dtype == torch.uint8
    ref = np.asarray(jeng(m["x"]))
    got = eng(m["x"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.9999, d
    assert numerics.top1_agreement(got, ref) == 1.0


def test_from_store_deploy_w4a8(store):
    """``ctx="deploy"``: every dense site on K10's plain version
    (``int4_runtime="packed"``, the default), against JAX's deploy engine
    with ``test_from_store_deploy_matches_jax_engine``'s gates; the
    ``"int8"`` runtime (K2 on the materialized weights) gives bit-identical
    logits, and so does JAX's own ``"int8"`` runtime against its packed one."""
    m, root = store
    ref = np.asarray(JEngine.from_store(root, ctx="deploy", batch=4)(m["x"]))
    packed = Engine.from_store(root, ctx="deploy", batch=4, device="cpu")
    assert {type(p).__name__ for p in packed.params.packed.values()} == {"PackedInt4"}
    got = packed(m["x"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.998, d
    assert numerics.top1_agreement(got, ref) == 1.0
    fp32 = np.asarray(JV.vit_forward(m["jparams"], jnp.asarray(m["x"]), m["jcfg"]))
    assert numerics.diff(got, fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4
    as8 = Engine.from_store(root, ctx="deploy", int4_runtime="int8", batch=4, device="cpu")
    assert {type(p).__name__ for p in as8.params.packed.values()} == {"PackedConv"}
    np.testing.assert_array_equal(as8(m["x"]).numpy(), got)


def test_w4a8_routing_guards(store, tmp_path):
    """``int4_runtime="int8"`` routes an INT4A8 store's block ctx to the W8
    path; weight-only per-OC int4 builds the W4A16 block engine and
    group-wise weight-only int4 raises the reference's ValueError; mixed
    widths raise the reference's ValueError; an unknown runtime raises."""
    m, root = store
    eng8 = Engine.from_store(root, ctx="block", int4_runtime="int8", batch=4, device="cpu")
    assert eng8.name == "deit_tiny_block"
    assert np.isfinite(eng8(m["x"]).numpy()).all()
    with pytest.raises(ValueError, match="int4_runtime"):
        Engine.from_store(root, ctx="block", int4_runtime="int2", device="cpu")
    _store(str(tmp_path / "wo"), m, JWO4, scales=False)
    assert Engine.from_store(str(tmp_path / "wo"), ctx="block",
                             device="cpu").name == "deit_tiny_block_w4"
    _store(str(tmp_path / "g128"), m, JG128, scales=False)
    with pytest.raises(ValueError, match="weight-only"):
        Engine.from_store(str(tmp_path / "g128"), ctx="block", device="cpu")
    mix = dataclasses.replace(JQ4, weight_overrides=(("l*.fc2", JQScheme(8, True, -1)),))
    _store(str(tmp_path / "mix"), m, mix)
    with pytest.raises(ValueError, match="per-channel int8"):
        Engine.from_store(str(tmp_path / "mix"), ctx="block", device="cpu")
    assert Engine.from_store(str(tmp_path / "mix"), ctx="block", int4_runtime="int8",
                             device="cpu").name == "deit_tiny_block"
