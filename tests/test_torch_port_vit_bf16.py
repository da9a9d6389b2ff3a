"""The bf16 DeiT block and the fused LayerNorms of the port against the JAX
package: K16 ``layernorm_fused`` and K17 ``residual_layernorm`` against
``pallas_layernorm``, ``pack_vit_blocks``, one ``vit_block_fused`` layer (K14
-> K6 -> K15) and ``vit_forward_blockfused`` against ``pallas_vit_block``'s,
the ``fused_ln=True`` forwards (fp32, and W8A8 under ``DeployCtx``), K6's fp32
form against ``fused_mhsa``, and the repairs of group-wise int4 weights with
activation scales (fake-quantized activations, then the weight-only route)
and of K13's shape limits. The same numpy-seeded model goes through both
packages; the JAX kernels run in interpret mode, jitted, as the JAX package's
own tests run them; the port runs on the CPU, where every kernel wrapper runs
its plain version.

Sizes: the reference tests' (``ViTConfig(image_size=32, patch=8, dim=96,
depth=2, heads=3, num_classes=10)``: Dp 128 with pad lanes and a pad-head
slot; tight Np 24, loose Np 128), random biases and LN affines.

Tolerances: every product of two bf16 values is exact, but the fp32 sums
are not: the reference sums in XLA's order, the plain versions exactly
(float64, rounded once), so a bf16 value rounded from a sum may land one
step apart (``assert_bf16_steps``); where the sums are exact in any order
(the FC2 association test) the port is held bit for bit. The LayerNorms'
fp32 moments are summed in PyTorch's order, not XLA's, and rsqrt rounds
differently: an fp32 output sits within 2^-19 of 1 + |ref|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import vit as JV
from dlq_tpu.ops import pallas_attention as JA
from dlq_tpu.ops import pallas_layernorm as JL
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.qconfig import QConfig as JQConfig
from dlq_tpu.quant.qconfig import QScheme as JQScheme
from dlq_tpu_torch import numerics
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import attention as TA
from dlq_tpu_torch.ops import layernorm as TL
from dlq_tpu_torch.ops import qops as TO
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.ops.matmul_int4 import PackedInt4G, matmul_int4
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ
from dlq_tpu_torch.quant.qconfig import QConfig as TQConfig
from dlq_tpu_torch.quant.qconfig import QScheme as TQScheme
from test_torch_port_vit_kernels import np_tree, qfields, quantized_vit, streams, t, tb
from test_torch_port_w4a16 import assert_bf16_steps

TINY = dict(image_size=32, patch=8, dim=96, depth=2, heads=3, num_classes=10)
LN_REL = 2.0 ** -19   # fp32 LN outputs: |got - ref| <= LN_REL * (1 + |ref|)


def _ordinal(a: np.ndarray) -> np.ndarray:
    """bf16 values (held in fp32) as integers in their order."""
    b = torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    b = b.view(torch.int16).numpy().astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _held_ln(got: np.ndarray, ref: np.ndarray, bf16: bool) -> None:
    """fp32: within LN_REL of 1 + |ref| (a few ulp: sum order and rsqrt);
    bf16: >= 0.999 equal, none more than one bf16 step apart."""
    if bf16:
        steps = np.abs(_ordinal(got) - _ordinal(ref))
        assert (steps == 0).mean() >= 0.999 and steps.max() <= 1, (
            float((steps == 0).mean()), int(steps.max()))
    else:
        err = np.abs(got - ref)
        assert (err <= LN_REL * (1.0 + np.abs(ref))).all(), float(err.max())


@functools.cache
def bf16_vit():
    """The tiny DeiT from the port's numpy-seeded init with random biases and
    LN affines on every layer; JAX and port views, both packs (tight and
    loose) from each side."""
    jcfg, tcfg = JV.ViTConfig(**TINY), TV.ViTConfig(**TINY)
    rng = np.random.default_rng(0)
    tparams = TV.init_vit(rng, tcfg)
    for lp in tparams["layers"]:
        for site in ("qkv", "proj", "fc1", "fc2"):
            lp[site]["b"] = torch.from_numpy(
                rng.normal(0, 0.05, lp[site]["b"].shape).astype(np.float32))
        for ln in ("ln1", "ln2"):
            lp[ln]["g"] = torch.from_numpy(rng.uniform(0.5, 1.5, tcfg.dim).astype(np.float32))
            lp[ln]["b"] = torch.from_numpy(rng.normal(0, 0.1, tcfg.dim).astype(np.float32))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tparams)
    m = dict(jcfg=jcfg, tcfg=tcfg, tparams=tparams, jparams=jparams,
             x=rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
    for tight in (True, False):
        key = "tight" if tight else "loose"
        m[f"jpack_{key}"] = JB.pack_vit_blocks(jparams, jcfg, tight=tight)
        # the JAX tree carried over, as a user with JAX-side params would
        m[f"tpack_{key}"] = TB.pack_vit_blocks(from_jax_tree(np_tree(jparams), device="cpu"),
                                               tcfg, tight=tight)
    return m


def _view(m, tight: bool):
    """The fields ``streams`` reads, for one pad choice."""
    key = "tight" if tight else "loose"
    return dict(jcfg=m["jcfg"], x=m["x"], jpack=m[f"jpack_{key}"],
                pads=JB.vit_pads(m["jcfg"], tight=tight))


def _kw(cfg):
    return dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)


# ---------------------------------------------------------------------------
# K16, K17
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [192, 256, 100])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_fused_matches_jax(d, dtype):
    """``layernorm_fused`` against the Pallas kernel at the reference test's
    widths (100: no multiple of 32) and affine, x and g, b in ``dtype``."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    gen = np.random.default_rng(d)
    x = (gen.normal(0, 1, (2, 197, d)) * 3 + 1).astype(np.float32)
    g = (gen.normal(0, 1, d) * 0.2 + 1).astype(np.float32)
    b = (gen.normal(0, 1, d) * 0.1).astype(np.float32)
    ref = JL.layernorm_fused(*(jnp.asarray(a).astype(jdt) for a in (x, g, b)), interpret=True)
    got = TL.layernorm_fused(*(torch.from_numpy(a).to(tdt) for a in (x, g, b)))
    assert got.dtype == tdt and got.shape == x.shape
    _held_ln(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype == "bf16")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residual_layernorm_matches_jax(dtype):
    """``residual_layernorm`` against the Pallas kernel: z = y + delta
    bit-equal, h held as ``_held_ln``. In bf16 the normalized rows come
    from the unrounded fp32 z: the LN of the rounded z differs from the
    reference in many elements where the port's does not."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    gen = np.random.default_rng(11)
    y, dl = (gen.normal(0, 1, (3, 50, 192)).astype(np.float32) for _ in range(2))
    g = (gen.normal(0, 1, 192) * 0.2 + 1).astype(np.float32)
    b = (gen.normal(0, 1, 192) * 0.1).astype(np.float32)
    jz, jh = JL.residual_layernorm(*(jnp.asarray(a).astype(jdt) for a in (y, dl, g, b)),
                                   interpret=True)
    tg, tb_ = (torch.from_numpy(a).to(tdt) for a in (g, b))
    z, h = TL.residual_layernorm(torch.from_numpy(y).to(tdt), torch.from_numpy(dl).to(tdt),
                                 tg, tb_)
    assert z.dtype == h.dtype == tdt
    np.testing.assert_array_equal(z.float().numpy(), np.asarray(jz.astype(jnp.float32)))
    ref = np.asarray(jh.astype(jnp.float32))
    _held_ln(h.float().numpy(), ref, dtype == "bf16")
    if dtype == "bf16":
        rounded = TL.layernorm_fused(z, tg, tb_).float().numpy()
        assert (rounded != ref).mean() > 0.01 > (h.float().numpy() != ref).mean()


def test_residual_layernorm_mixed_dtypes():
    """The calibration pass hands K17 an fp32 stream and a bf16 delta, or
    the reverse: both outputs in ``y.dtype``, z = f32(y) + f32(delta)."""
    gen = np.random.default_rng(12)
    y, dl = (torch.from_numpy(gen.normal(0, 1, (5, 96)).astype(np.float32)) for _ in range(2))
    for yy, dd in ((y, dl.to(torch.bfloat16)), (y.to(torch.bfloat16), dl)):
        g, b = torch.ones(96, dtype=yy.dtype), torch.zeros(96, dtype=yy.dtype)
        z, h = TL.residual_layernorm(yy, dd, g, b)
        assert z.dtype == h.dtype == yy.dtype
        np.testing.assert_array_equal(z.float().numpy(),
                                      (yy.float() + dd.float()).to(yy.dtype).float().numpy())


def test_layernorm_affine_in_stream_dtype():
    """g and b come in the stream's dtype (``make_qforward`` casts them);
    another dtype raises in both wrappers, on the CPU as on the card."""
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    g, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(ValueError, match="stream's"):
        TL.layernorm_fused(x, g, b)
    with pytest.raises(ValueError, match="stream's"):
        TL.residual_layernorm(x, x.float(), g, b)


# ---------------------------------------------------------------------------
# pack_vit_blocks, K14 -> K6 -> K15
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tight", [True, False])
def test_pack_vit_blocks_matches_jax(tight):
    """Block weights are the reference's bf16 values transposed to K-major;
    biases, LN rows, patch, cls, pos, norm and head equal in value and dtype
    (the head weight bf16, as the reference's). The port's own params give
    the same pack as JAX's carried over."""
    m = bf16_vit()
    key = "tight" if tight else "loose"
    jp, tp = m[f"jpack_{key}"], m[f"tpack_{key}"]
    for jb, tblk in zip(jp["blocks"], tp["blocks"]):
        for k in ("wqkv", "wproj", "wfc1", "wfc2"):
            assert tblk[k].dtype == torch.bfloat16 and tblk[k].is_contiguous()
            np.testing.assert_array_equal(tblk[k].t().float().numpy(),
                                          np.asarray(jb[k].astype(jnp.float32)))
        for k in ("bqkv", "bproj", "bfc1", "bfc2", "ln1", "ln2"):
            assert tblk[k].dtype == torch.float32
            np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jb[k]).reshape(tblk[k].shape))
    for k, dt in (("patch", torch.bfloat16), ("norm", torch.float32)):
        for f in ("w", "b") if k == "patch" else ("g", "b"):
            assert tp[k][f].dtype == dt
            np.testing.assert_array_equal(tp[k][f].float().numpy(),
                                          np.asarray(jp[k][f].astype(jnp.float32)))
    assert tp["head"]["w"].dtype == torch.bfloat16 and tp["head"]["b"].dtype == torch.float32
    for k in ("cls", "pos"):
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)))
    own = TB.pack_vit_blocks(m["tparams"], m["tcfg"], tight=tight)
    for a, b in zip(own["blocks"], tp["blocks"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("gelu_tanh", [True, False])
def test_block_fused_matches_jax(tight, gelu_tanh):
    """One bf16 layer on the bf16 token stream as K14 -> K6 -> K15's plain
    versions against ``vit_block_fused``: >= 0.99 of the valid outputs
    equal, none more than one bf16 step apart."""
    m = bf16_vit()
    v = _view(m, tight)
    y, _ = streams(v)
    kw = _kw(m["jcfg"])
    key = "tight" if tight else "loose"
    ref = JB.vit_block_fused(y, m[f"jpack_{key}"]["blocks"][0], gelu_tanh=gelu_tanh,
                             interpret=True, **kw)
    got = TB.vit_block_fused(tb(y), m[f"tpack_{key}"]["blocks"][0], gelu_tanh=gelu_tanh, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(y.shape)
    assert_bf16_steps(got, ref, kw["n_valid"], kw["d_valid"], 0.99)
    # pad lanes stay zero
    assert not got[..., kw["d_valid"]:].float().abs().any()


def test_block_fused_fc2_association():
    """FC2's residual is ``(z1 + acc) + b`` in ``_block_kernel`` (:318-319).
    On a layer whose FC2 sums are exact in any order (proj and FC1 weights
    0, so z1 = x + b_proj and f = gelu(b_fc1) = b_fc1 with b_fc1 in [6, 7.5]
    in steps of 1/16, where tanh saturates to 1; FC2 weights integers in
    [-8, 7] times 2^-6, so every sum is a multiple of 2^-10 below 2^9), with
    an fp32 stream: the port is bit-equal to the reference, and
    ``z1 + (acc + b)`` is not."""
    m = bf16_vit()
    _, yf = streams(_view(m, True))
    kw = _kw(m["jcfg"])
    n, d = kw["n_valid"], kw["d_valid"]
    jb, tblk = dict(m["jpack_tight"]["blocks"][0]), dict(m["tpack_tight"]["blocks"][0])
    gen = np.random.default_rng(3)
    hp = tblk["bfc1"].shape[0]
    dp = tblk["bproj"].shape[0]
    b1 = ((96 + gen.integers(0, 25, hp)) / 16.0).astype(np.float32)
    w2 = (gen.integers(-8, 8, (hp, dp)) / 64.0).astype(np.float32)
    w2[:, d:] = 0
    jb.update(wproj=jnp.zeros_like(jb["wproj"]), wfc1=jnp.zeros_like(jb["wfc1"]),
              bfc1=jnp.asarray(b1)[None], wfc2=jnp.asarray(w2, jnp.bfloat16))
    tblk.update(wproj=torch.zeros_like(tblk["wproj"]), wfc1=torch.zeros_like(tblk["wfc1"]),
                bfc1=torch.from_numpy(b1), wfc2=torch.from_numpy(w2.T.copy()).to(torch.bfloat16))
    got = TB.vit_block_fused(t(yf), tblk, **kw)
    assert got.dtype == torch.float32
    ref = np.asarray(JB.vit_block_fused(yf, jb, interpret=True, **kw))
    np.testing.assert_array_equal(got.numpy()[:, :n, :d], ref[:, :n, :d])
    a = TB._attention(TB.vit_block_pre_bf16(t(yf), tblk, d), kw["heads"], kw["hd"], n)
    z1, acc = TB._post_w4_sums(t(yf), a, tblk, d, True)
    other = z1 + (acc + tblk["bfc2"])
    assert float((other.numpy()[:, :n, :d] != got.numpy()[:, :n, :d]).mean()) > 0.01


# ---------------------------------------------------------------------------
# vit_forward_blockfused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tight", [True, False])
def test_forward_blockfused_matches_jax(tight):
    """The bf16 deploy forward against the reference's (its patch embed in
    conv form, the port's in matmul form: the same products in another sum
    order): cosine >= 0.9999 and top-1 1.0; and both against the fp32
    forward with the tanh GELU, as ``tests/test_vit_blockfused.py``."""
    m = bf16_vit()
    key = "tight" if tight else "loose"
    ref = np.asarray(JB.vit_forward_blockfused(m[f"jpack_{key}"], jnp.asarray(m["x"]), m["jcfg"],
                                               tight=tight, interpret=True))
    got = TB.vit_forward_blockfused(m[f"tpack_{key}"], torch.from_numpy(m["x"]), m["tcfg"],
                                    tight=tight)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    d = numerics.diff(got.numpy(), ref)
    assert d.cosine >= 0.9999, d
    assert numerics.top1_agreement(got.numpy(), ref) == 1.0
    fp32 = TV.vit_forward(m["tparams"], torch.from_numpy(m["x"]),
                          dataclasses.replace(m["tcfg"], gelu="tanh"))
    assert numerics.diff(got, fp32).cosine > 0.9999
    assert numerics.top1_agreement(got, fp32) == 1.0


def test_forward_blockfused_tight_matches_loose_and_batch():
    """Tight pads against loose (cosine >= 0.9999, top-1 1.0, as
    ``test_blockfused_tight_pads_match_loose``), and batch 2 against the
    first two rows of batch 4 (the reference's ``bt`` fallback test,
    atol 2e-3; the port has no ``bt``)."""
    m = bf16_vit()
    x = torch.from_numpy(m["x"])
    loose = TB.vit_forward_blockfused(m["tpack_loose"], x, m["tcfg"])
    tight = TB.vit_forward_blockfused(m["tpack_tight"], x, m["tcfg"], tight=True)
    assert numerics.diff(tight, loose).cosine >= 0.9999
    assert numerics.top1_agreement(tight, loose) == 1.0
    two = TB.vit_forward_blockfused(m["tpack_loose"], x[:2], m["tcfg"])
    np.testing.assert_allclose(two.numpy(), loose[:2].numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# fused_ln forwards
# ---------------------------------------------------------------------------

def test_vit_forward_fused_ln_matches_jax():
    """The fp32 forward with ``fused_ln=True, attn_impl="fused"`` (K16, K17
    and K6's fp32 form) against JAX's, taps included, at max_abs < 1e-5
    (``tests/test_pallas_layernorm.py:39-50``); and against the port's
    non-fused forward at the same gate."""
    m = bf16_vit()
    jcfg = dataclasses.replace(m["jcfg"], fused_ln=True, attn_impl="fused")
    tcfg = dataclasses.replace(m["tcfg"], fused_ln=True, attn_impl="fused")
    x = m["x"][:2]
    ref, rt = jax.jit(lambda xx: JV.vit_forward(m["jparams"], xx, jcfg, taps=True))(
        jnp.asarray(x))
    got, gt = TV.vit_forward(m["tparams"], torch.from_numpy(x), tcfg, taps=True)
    assert set(gt) == set(rt)
    for k in rt:
        assert float(np.abs(gt[k].numpy() - np.asarray(rt[k])).max()) < 1e-5, k
    plain = TV.vit_forward(m["tparams"], torch.from_numpy(x), m["tcfg"])
    assert float((got - plain).abs().max()) < 1e-5


def test_qforward_fused_ln_deploy_matches_jax():
    """``make_qforward(fused_ln=True, attn_impl="fused")`` under W8A8
    ``DeployCtx`` (bf16 stream: K16/K17 in bf16 with bf16 LN affines, K6,
    K2) against JAX's, jitted, at the gates of the deploy test
    (``test_from_store_deploy_matches_jax_engine``): cosine >= 0.998, top-1
    1.0, at least as close to the fp32 forward as JAX's (less 1e-4)."""
    m = quantized_vit("d96", bias_std=0.05)
    cfg = m["jcfg"]
    args = (cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    jqf = JV.make_qforward(m["ex"], *args, fused_ln=True, attn_impl="fused")
    jctx = JM.DeployCtx(m["qflat"], m["scales"], JQ)
    ref = np.asarray(jax.jit(lambda xx: jqf(jctx, xx, cfg))(jnp.asarray(m["x"])))
    tqf = TV.make_qforward(m["tex"], *args, fused_ln=True, attn_impl="fused")
    got = tqf(TM.DeployCtx(m["tq"], m["ts"], TQ), torch.from_numpy(m["x"]), m["tcfg"]).numpy()
    d = numerics.diff(got, ref)
    assert d.cosine >= 0.998, d
    assert numerics.top1_agreement(got, ref) == 1.0
    fp32 = np.asarray(JV.vit_forward(m["jparams"], jnp.asarray(m["x"]), cfg))
    assert numerics.diff(got, fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4


# ---------------------------------------------------------------------------
# K6's fp32 form (C.3)
# ---------------------------------------------------------------------------

def test_mhsa_fp32_matches_jax_fused_mhsa():
    """fp32 q/k/v take K6's fp32 form (``mhsa_f32``: on the CPU its plain
    version) with fp32 products and sums, against the reference's
    ``fused_mhsa`` on fp32 (out fp32): within 1e-5 (the outputs are averages
    of unit-scale V rows; the sums differ in order only). bf16 q/k/v take K6;
    q, k, v of mixed dtypes raise (the parent tree ran them)."""
    gen = np.random.default_rng(4)
    bh, n_p, hd, n_valid = 6, 24, 32, 17
    q, v = (gen.normal(0, 1, (bh, n_p, hd)).astype(np.float32) for _ in range(2))
    kt = gen.normal(0, 1, (bh, hd, n_p)).astype(np.float32)
    ref = np.asarray(JA.fused_mhsa(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), n_valid,
                                   interpret=True))
    tq_, tkt, tv = (torch.from_numpy(a) for a in (q, kt, v))
    assert TA.kernel_for(tq_, tkt, tv) == "mhsa_f32"
    before = (TA.mhsa.launches, TA.mhsa_f32.launches)
    got = TA.fused_mhsa(tq_, tkt, tv, n_valid)
    assert (TA.mhsa.launches, TA.mhsa_f32.launches) == before   # no launch on the CPU
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy()[:, :n_valid] - ref[:, :n_valid]).max()) <= 1e-5
    b16 = tq_.to(torch.bfloat16)
    assert TA.kernel_for(b16, b16, b16) == "mhsa"
    with pytest.raises(ValueError, match="share a dtype"):
        TA.mhsa(tq_, tq_, b16, 1, n_valid)
    with pytest.raises(ValueError, match="fp32"):
        TA.mhsa_f32(b16, b16, b16, 1, n_valid)


# ---------------------------------------------------------------------------
# group-wise int4 weights with activation scales (C.1), K13's limits (C.2)
# ---------------------------------------------------------------------------

def _c1_site(group: int, k: int, n: int, bits: int = 4):
    """One dense site quantized by the JAX package with group-wise weights
    and int8 activations (a calibrated-like static scale); JAX and port
    views."""
    gen = np.random.default_rng(group + k)
    flat = {"fc": {"w": jnp.asarray(gen.normal(0, 0.05, (k, n)).astype(np.float32)),
                   "b": jnp.asarray(gen.normal(0, 0.1, n).astype(np.float32))}}
    scheme = dict(weights=(bits, True, -1, group), acts=(8, True, None))
    jcfg = JQConfig(weights=JQScheme(*scheme["weights"]), acts=JQScheme(*scheme["acts"]))
    tcfg = TQConfig(weights=TQScheme(*scheme["weights"]), acts=TQScheme(*scheme["acts"]))
    qflat = JM.quantize_weights(flat, jcfg)
    scales = {"fc": jnp.float32(3.0 / 127.0)}
    tq, ts = from_jax_qflat(qfields(qflat), {"fc": np.asarray(scales["fc"])}, device="cpu")
    x = gen.normal(0, 1, (4, k)).astype(np.float32)
    return dict(flat=flat, jcfg=jcfg, tcfg=tcfg, qflat=qflat, scales=scales, tq=tq, ts=ts, x=x)


def test_groupwise_int4_with_acts_matches_jax():
    """C.1: ``DeployCtx`` on group-wise int4 weights with activation scales
    (a 256x64 dense, group 128, int8 acts) keeps the site's weight 4-bit for
    K13 and serves it as the reference does: the activations fake-quantized
    (``quantize_act(x)·s`` in ``x.dtype``), then the weight-only route. The
    parent tree raised KeyError from the context and ValueError from
    ``qdense``. Against JAX's jitted ``DeployCtx.dense`` at the G128 gates of
    ``test_from_store_g128`` (cosine >= 0.998, top-1 1.0, at least as close
    to the fp32 product as JAX's, less 1e-4): the port computes
    ``int4_matmul``'s rounding, JAX's CPU route an fp32 dequantization."""
    s = _c1_site(128, 256, 64)
    jctx = JM.DeployCtx(s["qflat"], s["scales"], s["jcfg"])
    ref = np.asarray(jax.jit(lambda xx: jctx.dense("fc", xx))(jnp.asarray(s["x"])))
    ctx = TM.DeployCtx(s["tq"], s["ts"], s["tcfg"])
    assert isinstance(ctx.packed["fc"], PackedInt4G)
    got = ctx.dense("fc", torch.from_numpy(s["x"]))
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    direct = TO.qdense(torch.from_numpy(s["x"]), s["tq"]["fc"]["qw"], s["tq"]["fc"]["b"],
                       act_scale=s["ts"]["fc"])
    np.testing.assert_array_equal(direct.numpy(), got.numpy())
    d = numerics.diff(got.numpy(), ref)
    assert d.cosine >= 0.998, d
    assert numerics.top1_agreement(got.numpy(), ref) == 1.0
    fp32 = s["x"] @ np.asarray(s["flat"]["fc"]["w"]) + np.asarray(s["flat"]["fc"]["b"])
    assert numerics.diff(got.numpy(), fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4
    # the activations are quantized: the same x without its int8 rounding
    # gives another product
    wo = matmul_int4(torch.from_numpy(s["x"]), ctx.packed["fc"], s["tq"]["fc"]["b"].float())
    assert not torch.equal(wo, got)


def test_groupwise_int8_with_acts_raises_as_jax():
    """Group-wise int8 weights with activation scales raise the reference's
    ValueError (``dlq_tpu/ops/qops.py:454-458``), on both sides."""
    s = _c1_site(32, 64, 16, bits=8)
    with pytest.raises(ValueError, match="group-wise"):
        JM.DeployCtx(s["qflat"], s["scales"], s["jcfg"]).dense("fc", jnp.asarray(s["x"]))
    with pytest.raises(ValueError, match="group-wise"):
        TM.DeployCtx(s["tq"], s["ts"], s["tcfg"]).dense("fc", torch.from_numpy(s["x"]))


def test_weight_only_packed_routes_k13_shapes():
    """C.2: K13 takes K and the group in 16-wide steps. A group-wise int4
    dense with group 24 at K = 96 (the quantizer takes it) gets no K13
    weight and the dequantized route, as the reference routes shapes its
    kernel does not tile; group 128 at K = 768 gets a ``PackedInt4G``. The
    parent tree packed both for K13, whose wrapper raises on the card."""
    odd = _c1_site(24, 96, 40)
    assert TO.weight_only_packed(odd["tq"]["fc"]["qw"]) is None
    g128 = _c1_site(128, 768, 64)
    assert isinstance(TO.weight_only_packed(g128["tq"]["fc"]["qw"]), PackedInt4G)
    # the odd site under the context: dequantized route, against JAX
    ctx = TM.DeployCtx(odd["tq"], odd["ts"], odd["tcfg"])
    assert "fc" not in ctx.packed
    before = matmul_int4.launches
    got = ctx.dense("fc", torch.from_numpy(odd["x"])).numpy()
    assert matmul_int4.launches == before
    jctx = JM.DeployCtx(odd["qflat"], odd["scales"], odd["jcfg"])
    ref = np.asarray(jax.jit(lambda xx: jctx.dense("fc", xx))(jnp.asarray(odd["x"])))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
