"""The DeiT W8A8 block kernels of the port (K5 ``vit_block_pre_w8``, K6
``mhsa``, K7 ``vit_block_post_w8``) through their plain versions, against
the JAX package's Pallas kernels run as its own tests run them (interpret
mode on the CPU), on the same packed weights, act scales and numpy-seeded
inputs.

Two configurations, the JAX tests' sizes: dim 96 (hd 32, Dp 128: pad
lanes, a pad head slot of 32 lanes) and dim 192 (hd 64, Dp 192: the
full-width head). Both have Np 24 > N 17 (pad rows, masked keys).

Gates: the plain versions repeat the reference kernels' arithmetic
(two-moment LN, inverse-scale quantization, ``fma(acc, s, b)`` epilogues,
each FC2 residual association as its kernel has it, exact softmax), so
every valid element is held equal; the stated floor of 0.999 of valid
elements equal (and a difference of at most one bf16 step elsewhere) only
allows for sums that XLA and PyTorch order differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import vit as JV
from dlq_tpu.ops import pallas_attention as JA
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import attention as TA
from dlq_tpu_torch.ops import vit_block as TB

CONFIGS = {
    "d96": dict(image_size=32, patch=8, dim=96, heads=3, num_classes=10),
    "d192": dict(image_size=64, patch=16, dim=192, heads=3, num_classes=10),
}
MIN_EQUAL = 0.999   # fraction of valid elements equal (sum-order slack)


def qfields(qflat):
    """numpy views of JAX QTensor fields and biases, for dlq_tpu_torch.interop."""
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": None if p.get("b") is None else np.asarray(p["b"])}
            for k, p in qflat.items()}


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def quantized_vit(name, depth=2, seed=0, batch=4, bias_std=0.0):
    """A DeiT from the port's numpy-seeded init, calibrated and quantized by
    the JAX package; returns JAX and port views of the same model.
    ``bias_std`` > 0 gives every dense site a random bias (init's are 0)."""
    kw = CONFIGS[name]
    jcfg = JV.ViTConfig(depth=depth, **kw)
    tcfg = TV.ViTConfig(depth=depth, **kw)
    rng = np.random.default_rng(seed)
    tparams = TV.init_vit(rng, tcfg)
    if bias_std:
        for lp in tparams["layers"]:
            for s in ("qkv", "proj", "fc1", "fc2"):
                lp[s]["b"] = torch.from_numpy(
                    rng.normal(0, bias_std, lp[s]["b"].shape).astype(np.float32))
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    flat, ex = JV.flatten_vit(jparams), JV.vit_extras(jparams)
    qf = JV.make_qforward(ex, depth, jcfg.heads, jcfg.patch, jcfg.dim)
    s = kw["image_size"]
    calib = [jnp.asarray(rng.normal(0, 1, (8, s, s, 3)).astype(np.float32))]
    scales = j_calibrate(JM.make_sites_fn(qf, jcfg), flat, calib, JQ)
    qflat = JM.quantize_weights(flat, JQ)
    x = rng.normal(0, 1, (batch, s, s, 3)).astype(np.float32)
    tq, ts = from_jax_qflat(qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    tex = from_jax_tree(np_tree(ex), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, qflat=qflat,
                scales=scales, ex=ex, tq=tq, ts=ts, tex=tex, x=x, qf=qf)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    m = quantized_vit(request.param, bias_std=0.05)
    m["jpack"] = JB.pack_vit_blocks_w8(m["qflat"], m["scales"], m["ex"], m["jcfg"], tight=True)
    m["tpack"] = TB.pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"], tight=True)
    m["pads"] = JB.vit_pads(m["jcfg"], tight=True)
    return m


def t(a):
    """fp32 JAX array -> fp32 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tb(a):
    """bf16 JAX array -> bf16 tensor."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def streams(m, seed=1):
    """The model's bf16 token stream for the test batch, and a random fp32
    stream of the same shape (pad lanes zero), as JAX arrays."""
    Np, Dp = m["pads"]
    cfg = m["jcfg"]
    N, D = cfg.seq_len, cfg.dim
    y = JB.embed_tokens(m["jpack"], jnp.asarray(m["x"]), cfg)
    cls = jnp.broadcast_to(m["jpack"]["cls"], (y.shape[0], 1, D)).astype(jnp.bfloat16)
    y = jnp.concatenate([cls, y], axis=1) + m["jpack"]["pos"]
    y = jnp.pad(y, ((0, 0), (0, Np - N), (0, Dp - D)))
    rng = np.random.default_rng(seed)
    yf = rng.normal(0, 1, y.shape).astype(np.float32)
    yf[..., D:] = 0.0
    return y, jnp.asarray(yf)


def assert_close_valid(got: torch.Tensor, ref, n, d, step, min_equal=MIN_EQUAL):
    """Valid rows/lanes: >= ``min_equal`` equal, the rest within ``step``."""
    g = got.float().numpy()[:, :n, :d]
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))[:, :n, :d]
    eq = float((g == r).mean())
    err = float(np.abs(g - r).max())
    assert eq >= min_equal and err <= step, (eq, err)
    return eq


def test_pack_matches_jax(model):
    """K-major int8 weights, folded scales, biases, LN rows and inverse
    scales are the reference's packing, transposed."""
    for jb, tblk in zip(model["jpack"]["blocks"], model["tpack"]["blocks"]):
        for k in ("wqkv", "wproj", "wfc1", "wfc2"):
            np.testing.assert_array_equal(tblk[k].t().numpy(), np.asarray(jb[k]))
        for k in ("sqkv", "bqkv", "sproj", "bproj", "sfc1", "bfc1", "sfc2", "bfc2"):
            np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jb[k])[0])
        for k in ("ln1", "ln2"):
            np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jb[k]))
        assert np.array_equal(np.float32(tblk["inv_act"]), np.asarray(jb["inv_act"])[0])
    for k in ("cls", "pos"):
        assert torch.equal(model["tpack"][k], tb(model["jpack"][k]))
    assert torch.equal(model["tpack"]["patch"]["w"], tb(model["jpack"]["patch"]["w"]))
    np.testing.assert_array_equal(model["tpack"]["head"]["w"].numpy(),
                                  np.asarray(model["jpack"]["head"]["w"]))


def test_embed_tokens_matches_jax(model):
    """bf16 patch embedding (conv form in the reference, product here)."""
    ref = JB.embed_tokens(model["jpack"], jnp.asarray(model["x"]), model["jcfg"])
    got = TB.embed_tokens(model["tpack"], torch.from_numpy(model["x"]), model["tcfg"])
    r = np.asarray(ref.astype(jnp.float32))
    assert float((got.float().numpy() == r).mean()) >= MIN_EQUAL


@pytest.mark.parametrize("stream", ["bf16", "fp32"])
def test_pre_w8_matches_jax(model, stream):
    """K5's plain version against ``vit_block_pre_w8`` on a bf16 stream (a
    chunk's first layer) and an fp32 one (inside a chunk)."""
    y, yf = streams(model)
    yy = y if stream == "bf16" else yf
    cfg = model["jcfg"]
    w, tw = model["jpack"]["blocks"][0], model["tpack"]["blocks"][0]
    ref = JB.vit_block_pre_w8(yy, w, d_valid=cfg.dim, interpret=True)
    got = TB.vit_block_pre_w8(t(yy) if stream == "fp32" else tb(yy), tw, cfg.dim)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    Dp = model["pads"][1]
    assert_close_valid(got, ref, cfg.seq_len, 3 * Dp, step=0.0)


@pytest.mark.parametrize("stream", ["bf16", "fp32"])
def test_post_w8_matches_jax(model, stream):
    """K7's plain version against ``vit_block_post_w8`` (output in the
    residual's dtype, FC2 residual ``fma(acc, s, z1) + b``)."""
    y, yf = streams(model)
    yy = y if stream == "bf16" else yf
    cfg = model["jcfg"]
    Np, Dp = model["pads"]
    rng = np.random.default_rng(2)
    a = rng.normal(0, 0.5, (yy.shape[0], Np, Dp)).astype(np.float32)
    a[..., cfg.dim:] = 0.0
    ja = jnp.asarray(a, jnp.bfloat16)
    w, tw = model["jpack"]["blocks"][1], model["tpack"]["blocks"][1]
    ref = JB.vit_block_post_w8(yy, ja, w, d_valid=cfg.dim, interpret=True)
    got = TB.vit_block_post_w8(t(yy) if stream == "fp32" else tb(yy), tb(ja), tw, cfg.dim)
    assert got.dtype == (torch.float32 if stream == "fp32" else torch.bfloat16)
    assert_close_valid(got, ref, cfg.seq_len, cfg.dim, step=0.0)


@pytest.mark.parametrize("n_valid", [17, 24])
def test_mhsa_matches_fused_mhsa(n_valid):
    """K6's plain version against ``pallas_attention.fused_mhsa`` (q/v
    [BH, Np, hd], kt [BH, hd, Np]), with masked keys (n_valid < Np) and
    without."""
    rng = np.random.default_rng(3)
    BH, Np, hd = 6, 24, 64
    q, k, v = (rng.normal(0, 1.5, (BH, Np, hd)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = JA.fused_mhsa(jq, jnp.swapaxes(jk, 1, 2), jv, n_valid=n_valid, interpret=True)
    got = TA.fused_mhsa(tb(jq), tb(jk).transpose(1, 2), tb(jv), n_valid)
    assert got.dtype == torch.bfloat16
    assert_close_valid(got, ref, Np, hd, step=0.0)


def test_attention_fused_matches_jax():
    """``attention_fused`` on [B, N, D] streams (the deploy path's form; the
    reference pads N to 128 rows, the port runs N rows)."""
    rng = np.random.default_rng(4)
    B, N, D, heads = 2, 17, 96, 3
    q, k, v = (jnp.asarray(rng.normal(0, 1.5, (B, N, D)), jnp.bfloat16) for _ in range(3))
    ref = JA.attention_fused(q, k, v, heads, interpret=True)
    got = TA.attention_fused(tb(q), tb(k), tb(v), heads)
    assert got.shape == (B, N, D)
    assert_close_valid(got, ref, N, D, step=0.0)


def test_block_attention_pad_lanes_zero(model):
    """K6 on the block path's qkv stream writes the lanes past heads·hd
    (and the pad-head slot at dim 96) as zeros."""
    y, _ = streams(model)
    cfg = model["tcfg"]
    qkv = TB.vit_block_pre_w8(tb(y), model["tpack"]["blocks"][0], cfg.dim)
    a = TB._attention(qkv, cfg.heads, cfg.dim // cfg.heads, cfg.seq_len)
    assert a.shape == tuple(y.shape)
    assert not a[..., cfg.dim:].float().abs().any()


def test_block_fused_w8_matches_jax(model):
    """K5 -> K6 -> K7 against ``vit_block_fused_w8`` (one block, bf16 out)."""
    y, _ = streams(model)
    cfg = model["jcfg"]
    kw = dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)
    ref = JB.vit_block_fused_w8(y, model["jpack"]["blocks"][0], interpret=True, **kw)
    got = TB.vit_block_fused_w8(tb(y), model["tpack"]["blocks"][0], **kw)
    assert got.dtype == torch.bfloat16
    assert_close_valid(got, ref, cfg.seq_len, cfg.dim, step=0.0)


@pytest.mark.parametrize("stream", ["bf16", "fp32"])
def test_multiblock_w8_matches_jax(model, stream):
    """Two stacked layers against ``vit_multiblock_fused_w8`` (L=2): fp32
    residual between the layers, FC2 residual ``z1 + fma(acc, s, b)``; on an
    fp32 stream the output stays fp32 and shows every rounding. Each layer
    alone is bit-equal; chained in fp32, a row whose LN sum lands on a
    rounding boundary in a different order in layer 1 can flip one int8
    code of layer 2, which moves that row of the fp32 output by about one
    FC2 step (~1e-3): the fp32 form is held to 0.97 of elements equal and
    4e-3; the bf16 form (the path's) to the 0.999 floor."""
    y, yf = streams(model)
    yy = y if stream == "bf16" else yf
    cfg = model["jcfg"]
    kw = dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)
    chunk = JB.stack_vit_blocks_w8(model["jpack"], 2)[0]
    ref = JB.vit_multiblock_fused_w8(yy, chunk, interpret=True, **kw)
    tchunk = TB.stack_vit_blocks_w8(model["tpack"], 2)[0]
    got = TB.vit_multiblock_fused_w8(t(yy) if stream == "fp32" else tb(yy), tchunk, **kw)
    if stream == "fp32":
        assert got.dtype == torch.float32
        assert_close_valid(got, ref, cfg.seq_len, cfg.dim, step=4e-3, min_equal=0.97)
    else:
        assert got.dtype == torch.bfloat16
        assert_close_valid(got, ref, cfg.seq_len, cfg.dim, step=0.0)


def test_forwards_match_jax(model):
    """``vit_forward_multiblock_w8`` (L=2) and ``vit_forward_blockfused_w8``
    (L=1, bf16 between layers) against the reference forwards."""
    cfg = model["jcfg"]
    x = jnp.asarray(model["x"])
    for jf, tf, kw in ((JB.vit_forward_multiblock_w8, TB.vit_forward_multiblock_w8,
                        dict(layers_per_kernel=2)),
                       (JB.vit_forward_blockfused_w8, TB.vit_forward_blockfused_w8, {})):
        ref = np.asarray(jf(model["jpack"], x, cfg, tight=True, interpret=True, **kw))
        got = tf(model["tpack"], torch.from_numpy(model["x"]), model["tcfg"], tight=True,
                 **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
