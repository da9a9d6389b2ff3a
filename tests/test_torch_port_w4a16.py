"""The W4A16 (weight-only int4) slice of the port against the JAX package:
K13's plain version against ``int4_matmul`` and ``int4_matmul_cached``, the
W4A16 block packing, K11 -> K6 -> K12's plain versions against
``vit_block_fused_w4``, ``_w4c`` and ``vit_multiblock_fused_w4``, the three
W4A16 forwards, and ``Engine.from_store`` on JAX-written
``INT4_WEIGHT_ONLY_PER_OC`` and ``INT4_WEIGHT_ONLY_G128`` stores. The same
numpy-seeded model goes through both packages; the JAX kernels run in
interpret mode, jitted, as the JAX package's own tests run them; the port
runs on the CPU, where every kernel wrapper runs its plain version.

Sizes: dim 96 (Dp 128, so the halves split at 64 with K rows 96-127 zero,
and a pad-head slot) and dim 192 (Dp 192, the split at 96), depth 2, 32 and
64 px, a random bias on every dense site.

Tolerances: every product of a bf16 activation and an int4 (or bf16
dequantized) weight is exact, but the fp32 sums are not: the reference sums
in XLA's order, the plain versions exactly (float64, rounded once). So an
fp32 sum differs by a few units of its last place, a bf16 value rounded from
one may land one bf16 step apart, and that step moves what follows it by far
less than another step. The gates below say how much of that each output
shows; where the sums are exact in any order (the FC2 association test), the
port is held bit for bit.
"""

import functools

import jax
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
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.ops.matmul_int4 import (
    PackedInt4G, dequantize_bf16, matmul_int4, matmul_int4_plain, pack_int4_weight,
)
from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor
from test_torch_port_vit_kernels import CONFIGS, np_tree, qfields, streams, t, tb

META_KEYS = ("num_classes", "image_size", "patch", "dim", "depth", "heads")


@functools.cache
def w4_vit(name):
    """A depth-2 DeiT from the port's numpy-seeded init with a random bias
    on every dense site, its weights quantized ``INT4_WEIGHT_ONLY_PER_OC``
    by the JAX package (no calibration: weight-only); JAX and port views
    (built once per configuration for the module's fixtures)."""
    kw = CONFIGS[name]
    jcfg, tcfg = JV.ViTConfig(depth=2, **kw), TV.ViTConfig(depth=2, **kw)
    rng = np.random.default_rng(0)
    tparams = TV.init_vit(rng, tcfg)
    for lp in tparams["layers"]:
        for site in ("qkv", "proj", "fc1", "fc2"):
            lp[site]["b"] = torch.from_numpy(
                rng.normal(0, 0.05, lp[site]["b"].shape).astype(np.float32))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tparams)
    ex = JV.vit_extras(jparams)
    m = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, ex=ex,
             tex=from_jax_tree(np_tree(ex), device="cpu"),
             x=rng.normal(0, 1, (4, kw["image_size"], kw["image_size"], 3)).astype(np.float32))
    m["qflat"] = JM.quantize_weights(JV.flatten_vit(jparams), JWO4)
    m["tq"], _ = from_jax_qflat(qfields(m["qflat"]), device="cpu")
    # jitted: the same arrays as the eager packer, in a tenth of the time
    m["jpack"] = jax.jit(lambda q, e: JB.pack_vit_blocks_w4(q, e, jcfg, tight=True))(
        m["qflat"], ex)
    m["tpack"] = TB.pack_vit_blocks_w4(m["tq"], m["tex"], m["tcfg"], tight=True)
    m["pads"] = JB.vit_pads(m["jcfg"], tight=True)
    return m


@pytest.fixture(scope="module", params=["d96", "d192"])
def model(request):
    return w4_vit(request.param)


def _kw(cfg):
    return dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)


def _ordinal(a: torch.Tensor) -> np.ndarray:
    """bf16 values as integers in their order: neighbours differ by one."""
    b = a.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def assert_bf16_steps(got: torch.Tensor, ref, n, d, min_equal):
    """Valid rows/lanes of a bf16 output: >= ``min_equal`` equal, none more
    than one bf16 step apart, at its own magnitude or at the stream's unit
    scale (2^-8), whichever is larger: a sum-order difference of an fp32
    value before its rounding is relative to the terms summed, so it spans
    more steps where the terms cancel to a value far below 1."""
    r = torch.from_numpy(np.array(jnp.asarray(ref).astype(jnp.float32)))
    g, r = got[:, :n, :d], r[:, :n, :d]
    steps = np.abs(_ordinal(g) - _ordinal(r))
    eq = float((steps == 0).mean())
    far = (steps > 1) & (np.abs(g.float().numpy() - r.numpy()) > 2.0 ** -8)
    assert eq >= min_equal and not far.any(), (eq, int(steps.max()))
    return eq


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def _g4_weight(rng, k, n, g):
    """A JAX group-wise int4 QTensor with every nibble value (-8 included)
    and random fp32 group scales."""
    q = rng.integers(-8, 8, (k, n)).astype(np.int8)
    q[0, :] = -8
    scale = (rng.uniform(0.5, 1.5, (k // g, n)) * 0.02).astype(np.float32)
    return JQZ.QTensor(JQZ.pack_int4(jnp.asarray(q)), jnp.asarray(scale), None, 4, -1, g, (k, n))


@pytest.mark.parametrize("fn", ["int4_matmul", "int4_matmul_cached"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [None, "random"])
def test_matmul_int4_matches_jax(fn, relu, bias):
    """K13's plain version (and its CPU wrapper) against the Pallas kernels
    on the store's adjacent-packed weights, at group 128 and 64 (K = 256 and
    384; M = 72 and N = 96 are no multiples of the card's tiles). The
    dequantized weight is bf16(n · bf16(s)), as the reference's; the fp32
    sums differ in order only, so each output is within 2^-18 of the sum of
    its products' magnitudes (a weight dequantized in fp32 first, or rounded
    from the unrounded scale, is ~2^-9 of a weight off: ~2^-14 of that sum
    here, and fails)."""
    rng = np.random.default_rng(7 + relu + 2 * (bias is None))
    for m, k, n, g in ((128, 256, 128, 128), (72, 384, 96, 64)):
        qw = _g4_weight(rng, k, n, g)
        x = rng.normal(0, 1, (m, k)).astype(np.float32)
        b = None if bias is None else rng.normal(0, 0.3, n).astype(np.float32)
        ref = np.asarray(getattr(JMM, fn)(jnp.asarray(x), qw.values, qw.scale,
                                          None if b is None else jnp.asarray(b), group=g,
                                          fuse_relu=relu, interpret=True))
        tq, _ = from_jax_qflat(qfields({"s": {"qw": qw, "b": None}}), device="cpu")
        pk = pack_int4_weight(tq["s"]["qw"])
        assert isinstance(pk, PackedInt4G) and pk.wp.dtype == torch.uint8
        assert pk.wp.shape == (n, k // 2) and pk.sc.dtype == torch.bfloat16
        tb_ = None if b is None else torch.from_numpy(b)
        got = matmul_int4_plain(torch.from_numpy(x), pk, tb_, relu).numpy()
        np.testing.assert_array_equal(matmul_int4(torch.from_numpy(x), pk, tb_, relu).numpy(), got)
        xb = np.abs(torch.from_numpy(x).to(torch.bfloat16).double().numpy())
        mag = xb @ np.abs(dequantize_bf16(pk).double().numpy())
        err = np.abs(got.astype(np.float64) - ref)
        assert (err <= 2.0 ** -18 * mag + 1e-30).all(), float((err / (mag + 1e-30)).max())


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_pack_vit_blocks_w4_matches_jax(model):
    """The block weights are the reference's halves-packed bytes, transposed
    (the split at the padded Kp/2); per-OC scales with pad lanes 1.0, biases
    and LN rows are the reference's; no activation scales; the patch weight
    in bf16 and the head in fp32 as the reference's."""
    D = model["jcfg"].dim
    for jb, tblk in zip(model["jpack"]["blocks"], model["tpack"]["blocks"]):
        assert "inv_act" not in tblk
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
        Dp = tblk["sproj"].shape[0]
        assert (tblk["sproj"][D:] == 1.0).all() and (tblk["sqkv"][D:Dp] == 1.0).all()
    for k in ("patch", "head"):
        j, p = model["jpack"][k], model["tpack"][k]
        assert p["w"].dtype == (torch.bfloat16 if k == "patch" else torch.float32)
        np.testing.assert_array_equal(p["w"].float().numpy(),
                                      np.asarray(j["w"].astype(jnp.float32)))
        np.testing.assert_array_equal(p["b"].float().numpy(),
                                      np.asarray(j["b"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# K11 -> K6 -> K12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["vit_block_fused_w4", "vit_block_fused_w4c"])
def test_block_w4_matches_jax(model, fn):
    """One W4A16 block (bf16 stream) as K11 -> K6 -> K12's plain versions
    against both reference kernels: >= 0.99 of the valid outputs equal, none
    more than one bf16 step apart."""
    y, _ = streams(model)
    kw = _kw(model["jcfg"])
    ref = getattr(JB, fn)(y, model["jpack"]["blocks"][0], interpret=True, **kw)
    got = getattr(TB, fn)(tb(y), model["tpack"]["blocks"][0], **kw)
    assert got.dtype == torch.bfloat16
    assert_bf16_steps(got, ref, kw["n_valid"], kw["d_valid"], 0.99)


def _exact_sums(jb, tblk, rng):
    """One layer's packs with proj and FC1 scaled by 0 (z1 = x + b_proj, f =
    gelu(b_fc1)) and b_fc1 in [6, 7.5] in steps of 1/16: tanh saturates to 1,
    so f = b_fc1 exactly, and every FC2 sum (multiples of 1/16 below 2^16)
    is exact in fp32 in any order."""
    jb, tblk = dict(jb), dict(tblk)
    hp = tblk["sfc1"].shape[0]
    b1 = (96 + rng.integers(0, 25, hp)).astype(np.float32) / 16.0
    for k, v in (("sproj", np.zeros(tblk["sproj"].shape[0], np.float32)),
                 ("sfc1", np.zeros(hp, np.float32)), ("bfc1", b1)):
        jb[k] = jnp.asarray(v)[None]
        tblk[k] = torch.from_numpy(v)
    return jb, tblk


def test_block_w4_fc2_association(model):
    """FC2's residual is ``z1 + fma(acc, s, b)`` in all three W4A16
    functions (the helpers return ``acc·s + b``). On layers whose FC2 sums
    are exact in any order (``_exact_sums``), with an fp32 stream: the port
    is bit-equal to ``vit_block_fused_w4``, ``_w4c`` and
    ``vit_multiblock_fused_w4`` (L = 2); the other association,
    ``fma(acc, s, z1) + b``, is not."""
    _, yf = streams(model)
    kw = _kw(model["jcfg"])
    n, d = kw["n_valid"], kw["d_valid"]
    rng = np.random.default_rng(3)
    layers = [_exact_sums(jb, tblk, rng)
              for jb, tblk in zip(model["jpack"]["blocks"], model["tpack"]["blocks"])]
    got = TB.vit_block_fused_w4(t(yf), layers[0][1], **kw)
    assert got.dtype == torch.float32
    for fn in ("vit_block_fused_w4", "vit_block_fused_w4c"):
        ref = np.asarray(getattr(JB, fn)(yf, layers[0][0], interpret=True, **kw))
        np.testing.assert_array_equal(got.numpy()[:, :n, :d], ref[:, :n, :d])
    chunk = JB.stack_vit_blocks_w4({"blocks": [jb for jb, _ in layers]}, 2)[0]
    ref2 = np.asarray(JB.vit_multiblock_fused_w4(yf, chunk, interpret=True, **kw))
    got2 = TB.vit_multiblock_fused_w4(t(yf), [tblk for _, tblk in layers], **kw)
    np.testing.assert_array_equal(got2.numpy()[:, :n, :d], ref2[:, :n, :d])
    w = layers[0][1]
    a = TB._attention(TB.vit_block_pre_w4(t(yf), w, d), kw["heads"], kw["hd"], n)
    z1, acc = TB._post_w4_sums(t(yf), a, w, d, True)
    other = torch.addcmul(z1, acc, w["sfc2"]) + w["bfc2"]
    assert float((other.numpy()[:, :n, :d] != got.numpy()[:, :n, :d]).mean()) > 0.01


@pytest.mark.parametrize("stream", ["bf16", "fp32"])
def test_multiblock_w4_matches_jax(model, stream):
    """Two stacked W4A16 layers against ``vit_multiblock_fused_w4`` (L=2):
    the fp32 stream within 2^-12 of each output's magnitude plus 2^-12 (sum
    order, and a bf16 intermediate one step apart moves the layer's fp32
    output by about one FC2 term), >= 0.99 of bf16 outputs equal, none more
    than one step apart."""
    y, yf = streams(model)
    yy = y if stream == "bf16" else yf
    kw = _kw(model["jcfg"])
    n, d = kw["n_valid"], kw["d_valid"]
    ref = JB.vit_multiblock_fused_w4(yy, JB.stack_vit_blocks_w4(model["jpack"], 2)[0],
                                     interpret=True, **kw)
    chunk = TB.stack_vit_blocks_w4(model["tpack"], 2)[0]
    got = TB.vit_multiblock_fused_w4(t(yy) if stream == "fp32" else tb(yy), chunk, **kw)
    if stream == "fp32":
        assert got.dtype == torch.float32
        g, r = got.numpy()[:, :n, :d], np.asarray(ref)[:, :n, :d]
        assert (np.abs(g - r) <= 2.0 ** -12 * (np.abs(r) + 1.0)).all(), float(np.abs(g - r).max())
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_steps(got, ref, n, d, 0.99)


@pytest.mark.parametrize("fn", ["vit_forward_blockfused_w4", "vit_forward_blockfused_w4c",
                                "vit_forward_multiblock_w4"])
def test_forwards_w4_match_jax(model, fn):
    """The three W4A16 forwards (the multiblock one with 2 layers per chunk)
    against the reference's: the logits within 2^-10 of their scale (a
    one-step bf16 difference in the stream moves a logit by less), top-1
    equal."""
    kw = dict(layers_per_kernel=2) if "multiblock" in fn else {}
    ref = np.asarray(getattr(JB, fn)(model["jpack"], jnp.asarray(model["x"]), model["jcfg"],
                                     tight=True, interpret=True, **kw))
    got = getattr(TB, fn)(model["tpack"], torch.from_numpy(model["x"]), model["tcfg"],
                          tight=True, **kw).numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -10 * np.abs(ref).max(), np.abs(got - ref).max()
    assert numerics.top1_agreement(got, ref) == 1.0


# ---------------------------------------------------------------------------
# engines on JAX-written weight-only stores
# ---------------------------------------------------------------------------

def _store(root, m, qcfg):
    meta = {"config": {k: getattr(m["jcfg"], k) for k in META_KEYS}}
    qflat = m["qflat"] if qcfg is JWO4 else JM.quantize_weights(JV.flatten_vit(m["jparams"]), qcfg)
    return JS.save_quantized(root, "deit_tiny", qflat, None, qcfg, extras=m["ex"], meta=meta)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    m = w4_vit("d192")
    base = tmp_path_factory.mktemp("deit_w4a16")
    roots = {"per_oc": str(base / "per_oc"), "g128": str(base / "g128")}
    _store(roots["per_oc"], m, JWO4)
    _store(roots["g128"], m, JG128)
    return m, roots


def test_from_store_block_w4_matches_jax_engine(stores):
    """``ctx="block"`` on an ``INT4_WEIGHT_ONLY_PER_OC`` store builds
    ``deit_tiny_block_w4`` (K11 -> K6 -> K12 per layer, 4-bit weights),
    against JAX's ``block_w4`` engine: cosine >= 0.99999 and top-1 1.0."""
    m, roots = stores
    jeng = JEngine.from_store(roots["per_oc"], ctx="block", batch=4)
    eng = Engine.from_store(roots["per_oc"], ctx="block", batch=4, device="cpu")
    assert jeng.name == eng.name == "deit_tiny_block_w4"
    assert eng.params["blocks"][0]["wqkv"].dtype == torch.uint8
    ref = np.asarray(jeng(m["x"]))
    got = eng(m["x"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.99999, d
    assert numerics.top1_agreement(got, ref) == 1.0


def test_from_store_g128(stores):
    """``ctx="deploy"`` on an ``INT4_WEIGHT_ONLY_G128`` store: the three
    group-wise sites (patch and each fc2, K = 768) keep 4-bit weights for
    K13, whose plain version computes ``int4_matmul``'s rounding where JAX's
    CPU engine dequantizes in fp32 (ROADMAP.md C); against JAX's deploy
    engine: top-1 1.0, cosine >= 0.998 and at least as close to the fp32
    forward (less 1e-4), the gates of the W8A8 deploy test. ``ctx="block"``
    on it raises the reference's ValueError."""
    m, roots = stores
    eng = Engine.from_store(roots["g128"], ctx="deploy", batch=4, device="cpu")
    assert {k for k, p in eng.params.packed.items() if isinstance(p, PackedInt4G)} == \
        {"patch", "l0.fc2", "l1.fc2"}
    ref = np.asarray(JEngine.from_store(roots["g128"], ctx="deploy", batch=4)(m["x"]))
    got = eng(m["x"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.998, d
    assert numerics.top1_agreement(got, ref) == 1.0
    fp32 = np.asarray(JV.vit_forward(m["jparams"], jnp.asarray(m["x"]), m["jcfg"]))
    assert numerics.diff(got, fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4
    with pytest.raises(ValueError, match="weight-only"):
        Engine.from_store(roots["g128"], ctx="block", device="cpu")
    with pytest.raises(ValueError, match="weight-only"):
        JEngine.from_store(roots["g128"], ctx="block")
