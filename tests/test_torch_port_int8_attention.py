"""The int8-attention slice of the port (K18 ``mhsa_i8``, through its plain
version on the CPU) against the JAX package: ``attention_int8_dynamic``,
the ``attn_int8`` arm of ``vit_multiblock_fused_w8`` (interpret mode), the
split-attention block and forward, and ``attn_impl="xla_int8"`` in the fp32
and ``DeployCtx`` forwards, on the same packed weights, act scales and
numpy-seeded inputs. The JAX side runs jitted, as its forwards run (XLA
turns the reference's ``av / (127.0 * 127.0)`` into a multiply by the fp32
reciprocal; eager JAX divides, and differs from its own jitted self in the
last bit of fp32 outputs).

Sizes: the JAX tests' two DeiT configurations (``test_torch_port_vit_kernels``:
dim 96 with hd 32 and a pad-head lane slot, dim 192 with hd 64; Np 24 > N 17).

Gates, stated once:
  * attention outputs: >= 0.99 of them equal, every other one within
    ``2·av/127`` of the reference (``av`` that (sample, head)'s V amax: a
    probability code flipped by ``exp`` or the row sum's order moves its
    row by at most ``av/127``);
  * forwards: logits cosine >= 0.999 and top-1 1.0;
  * the ``DeployCtx`` forward: cosine >= 0.998 and top-1 1.0 against JAX's
    jitted one, and at least as close to the fp32 forward (less 1e-4): a
    jitted bf16 forward skips roundings inside XLA fusions
    (``test_from_store_deploy_matches_jax_engine``).
Measured on the CPU: every attention output, in both forms, equal (1.0);
the block layers, K5's qkv over all Np rows and the bf16 split arm bit for
bit; the forwards at cosine >= 0.9999999999998 with top-1 1.0 (the last
bits are the head's and LN's sums), except the ``DeployCtx`` one (see its
test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import vit as JV
from dlq_tpu.ops import int8_attention as JI
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu_torch import numerics
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import int8_attention as TI
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ
from test_torch_port_vit_kernels import CONFIGS, quantized_vit, streams, tb

MIN_EQUAL = 0.99    # attention outputs equal; the rest within 2·av/127
MIN_COS = 0.999     # forwards: logits cosine (top-1 1.0)
DEPLOY_COS = 0.998  # the DeployCtx forward


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    m = quantized_vit(request.param, bias_std=0.05)
    for tight in (True, False):
        m[("jpack", tight)] = JB.pack_vit_blocks_w8(m["qflat"], m["scales"], m["ex"], m["jcfg"],
                                                   tight=tight)
        m[("tpack", tight)] = TB.pack_vit_blocks_w8(m["tq"], m["ts"], m["tex"], m["tcfg"],
                                                   tight=tight)
    m["jpack"], m["tpack"] = m[("jpack", True)], m[("tpack", True)]
    m["pads"] = JB.vit_pads(m["jcfg"], tight=True)
    return m


def f32np(a) -> np.ndarray:
    """A JAX array or tensor of any float dtype -> fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def v_amax(v, heads: int, n_valid: int, zero_pad: bool) -> np.ndarray:
    """Each (sample, head)'s V amax, broadcast to [B, 1, heads·hd] lanes."""
    v = f32np(v)
    B, N, hw = v.shape
    hd = hw // heads
    if zero_pad:
        v = v[:, :n_valid]
    a = np.abs(v.reshape(B, -1, heads, hd)).max(axis=(1, 3))   # [B, heads]
    return np.repeat(a, hd, axis=1)[:, None, :]


def assert_attention_close(got, ref, av) -> float:
    """>= MIN_EQUAL of the outputs equal, the rest within 2·av/127."""
    g, r = f32np(got), f32np(ref)
    assert g.shape == r.shape
    eq = float((g == r).mean())
    assert eq >= MIN_EQUAL, eq
    assert (np.abs(g - r) <= 2.0 * av / 127.0).all(), float(np.abs(g - r).max())
    return eq


def assert_logits_close(got, ref, min_cos=MIN_COS):
    d = numerics.diff(got, ref)
    assert d.cosine >= min_cos, d
    assert numerics.top1_agreement(got, ref) == 1.0


def jax_dyn(a):
    """The reference's dynamic quantizer, as written in both of its forms
    (``int8_attention.py:60-63``, ``pallas_vit_block.py:249-252``)."""
    amax = jnp.max(jnp.abs(a), axis=(2, 3), keepdims=True) + 1e-9
    return jnp.clip(jnp.round(a * (127.0 / amax)), -127, 127).astype(jnp.int8), amax


@pytest.mark.parametrize("case", ["halves", "normal", "bf16_values", "zeros"])
def test_dyn_quant_matches_reference(case):
    """``dyn_quant`` against the reference's expression, bit for bit (codes
    and amax). "halves" puts values on exact halves of a code (amax 127
    and 63.5, where ``127/amax`` is 1 and 2): round half to even."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1.5, (2, 3, 24, 32)).astype(np.float32)
    if case == "halves":
        a = (np.round(rng.uniform(-254, 254, a.shape)) / 2.0).astype(np.float32)
        a[0, :, 0, 0] = 127.0
        a[1] /= 2.0
        a[1, :, 0, 0] = 63.5
    elif case == "bf16_values":
        a = f32np(jnp.asarray(a, jnp.bfloat16))
    elif case == "zeros":
        a[0, 1] = 0.0
    rq, ra = jax.jit(jax_dyn)(jnp.asarray(a))
    gq, ga = TI.dyn_quant(torch.from_numpy(np.array(a)))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq).astype(np.float32))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    if case == "halves":
        assert (np.abs(a[0] - np.trunc(a[0])) == 0.5).any()


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_int8_dynamic_matches_jax(hd, masked, dtype):
    """The zero-pad form against the jitted ``attention_int8_dynamic``, with
    ``n_valid`` None and N - 4, on fp32 and bf16 [B, N, heads·hd] (output in
    the input's dtype)."""
    rng = np.random.default_rng(hd + 2 * masked)
    B, N, heads = 2, 24, 3
    n_valid = N - 4 if masked else None
    q, k, v = (jnp.asarray(rng.normal(0, 1.5, (B, N, heads * hd)), getattr(jnp, dtype))
               for _ in range(3))
    ref = jax.jit(JI.attention_int8_dynamic, static_argnums=(3, 4))(q, k, v, heads, n_valid)
    tq, tk, tv = (torch.from_numpy(f32np(t)).to(getattr(torch, dtype)) for t in (q, k, v))
    got = TI.attention_int8_dynamic(tq, tk, tv, heads, n_valid)
    assert got.dtype == tq.dtype
    assert_attention_close(got, ref, v_amax(v, heads, N if n_valid is None else n_valid,
                                            masked))


def test_attention_bf16_masked_matches_jax():
    """The split path's bf16 control arm (K6's arithmetic) against
    ``attention_bf16_masked`` on fp32 input, masked keys, bf16 out."""
    rng = np.random.default_rng(5)
    B, N, heads, hd = 2, 24, 3, 64
    q, k, v = (jnp.asarray(rng.normal(0, 1.5, (B, N, heads * hd)), jnp.float32)
               for _ in range(3))
    ref = jax.jit(JI.attention_bf16_masked, static_argnums=(3, 4, 5))(q, k, v, heads, N - 4,
                                                                       jnp.bfloat16)
    got = TI.attention_bf16_masked(*(torch.from_numpy(f32np(t)) for t in (q, k, v)), heads,
                                   N - 4, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32np(got), f32np(ref))


class _Scratch:
    """A mutable stand-in for the Pallas scratch ref that
    ``_mhsa_batched_i8_into_scratch`` writes (traced under ``jax.jit``)."""

    def __init__(self, shape):
        self.a = jnp.zeros(shape, jnp.bfloat16)

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, val):
        self.a = self.a.at[idx].set(val)


def test_in_kernel_attention_matches_jax(model):
    """The in-kernel form (amax over every row of the padded stream) against
    the reference's ``_mhsa_batched_i8_into_scratch`` on the same bf16 qkv
    stream: K5's output, which first equals ``vit_block_pre_w8``'s over all
    Np rows (the pad rows enter the amax)."""
    y, _ = streams(model)
    cfg = model["jcfg"]
    Np, Dp = model["pads"]
    heads, hd, N = cfg.heads, cfg.dim // cfg.heads, cfg.seq_len
    jqkv = JB.vit_block_pre_w8(y, model["jpack"]["blocks"][0], d_valid=cfg.dim, interpret=True)
    qkv = TB.vit_block_pre_w8(tb(y), model["tpack"]["blocks"][0], cfg.dim)
    np.testing.assert_array_equal(f32np(qkv), f32np(jqkv))     # all Np rows
    assert N < Np and f32np(qkv)[:, N:].any()

    @jax.jit
    def ref_fn(qkv):
        scr = _Scratch((qkv.shape[0] * Np, Dp))
        JB._mhsa_batched_i8_into_scratch(qkv.reshape(-1, 3 * Dp), scr, Bt=qkv.shape[0], Np=Np,
                                         Dp=Dp, heads=heads, hd=hd, n_valid=N)
        return scr.a.reshape(qkv.shape[0], Np, Dp)

    ref = ref_fn(jqkv)
    got = TB._attention_i8(qkv, heads, hd, N)
    assert got.dtype == torch.bfloat16 and got.shape == (y.shape[0], Np, Dp)
    assert not got[..., heads * hd:].float().abs().any()
    assert_attention_close(got[..., :heads * hd], f32np(ref)[..., :heads * hd],
                           v_amax(jqkv[..., 2 * Dp: 2 * Dp + heads * hd], heads, N, False))


@pytest.mark.parametrize("layers", [1, 2])
def test_multiblock_attn_int8_matches_jax(model, layers):
    """``vit_multiblock_fused_w8(attn_int8=True)``, K5 -> K18 -> K7 per
    layer, against the reference's chunk of ``layers`` stacked layers on the
    model's bf16 token stream, every row and lane: each layer's pad rows
    feed the next layer's amax."""
    y, _ = streams(model)
    cfg = model["jcfg"]
    kw = dict(n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads, hd=cfg.dim // cfg.heads)
    ref = JB.vit_multiblock_fused_w8(y, JB.stack_vit_blocks_w8(model["jpack"], layers)[0],
                                     attn_int8=True, interpret=True, **kw)
    got = TB.vit_multiblock_fused_w8(tb(y), TB.stack_vit_blocks_w8(model["tpack"], layers)[0],
                                     attn_int8=True, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32np(got), f32np(ref))


def test_forward_multiblock_attn_int8_matches_jax(model):
    """``vit_forward_multiblock_w8(attn_int8=True)`` (tight pads, one chunk
    of two layers) against the reference forward."""
    x = model["x"]
    ref = np.asarray(JB.vit_forward_multiblock_w8(model["jpack"], jnp.asarray(x), model["jcfg"],
                                                  layers_per_kernel=2, attn_int8=True,
                                                  interpret=True))
    got = TB.vit_forward_multiblock_w8(model["tpack"], torch.from_numpy(x), model["tcfg"],
                                       layers_per_kernel=2, attn_int8=True).numpy()
    assert_logits_close(got, ref)


@pytest.mark.parametrize("attn", ["int8", "bf16"])
def test_split_forward_matches_jax(model, attn):
    """``vit_forward_blockfused_w8_split`` at the reference's defaults
    (loose pads: Np 128, so 111 masked keys) against JAX's; the "bf16" arm
    is also ``vit_forward_blockfused_w8`` on the same packing, bit for
    bit."""
    x = model["x"]
    jp, tp = model[("jpack", False)], model[("tpack", False)]
    ref = np.asarray(JB.vit_forward_blockfused_w8_split(jp, jnp.asarray(x), model["jcfg"],
                                                        attn=attn, interpret=True))
    got = TB.vit_forward_blockfused_w8_split(tp, torch.from_numpy(x), model["tcfg"], attn=attn)
    assert_logits_close(got.numpy(), ref)
    if attn == "bf16":
        assert torch.equal(got, TB.vit_forward_blockfused_w8(tp, torch.from_numpy(x),
                                                             model["tcfg"]))
    with pytest.raises(ValueError, match="attn"):
        TB.vit_forward_blockfused_w8_split(tp, torch.from_numpy(x), model["tcfg"], attn="fp8")


@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_vit_forward_xla_int8_matches_jax(model, gelu):
    """The fp32 forward with ``attn_impl="xla_int8"`` (K18's zero-pad form
    on fp32 q/k/v with no ``n_valid``) against JAX's, jitted."""
    jcfg = dataclasses.replace(model["jcfg"], attn_impl="xla_int8", gelu=gelu)
    tcfg = dataclasses.replace(model["tcfg"], attn_impl="xla_int8", gelu=gelu)
    x = model["x"]
    ref = np.asarray(jax.jit(lambda p, xx: JV.vit_forward(p, xx, jcfg))(model["jparams"],
                                                                        jnp.asarray(x)))
    got = TV.vit_forward(model["tparams"], torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32
    assert_logits_close(got.numpy(), ref)


def test_qforward_xla_int8_deploy_matches_jax(model):
    """``make_qforward(attn_impl="xla_int8")`` under W8A8 ``DeployCtx`` (bf16
    stream: K18 on bf16 lane slices of the qkv dense, K2) against JAX's,
    jitted, at the deploy gates. Measured: cosine 0.99992 (d96) and
    0.99983 (d192) against JAX's, top-1 1.0."""
    cfg = model["jcfg"]
    args = (cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    x = model["x"]
    jqf = JV.make_qforward(model["ex"], *args, attn_impl="xla_int8")
    jctx = JM.DeployCtx(model["qflat"], model["scales"], JQ)
    ref = np.asarray(jax.jit(lambda xx: jqf(jctx, xx, cfg))(jnp.asarray(x)))
    tqf = TV.make_qforward(model["tex"], *args, attn_impl="xla_int8")
    got = tqf(TM.DeployCtx(model["tq"], model["ts"], TQ), torch.from_numpy(x),
              model["tcfg"]).numpy()
    assert_logits_close(got, ref, DEPLOY_COS)
    fp32 = np.asarray(JV.vit_forward(model["jparams"], jnp.asarray(x), cfg))
    assert numerics.diff(got, fp32).cosine >= numerics.diff(ref, fp32).cosine - 1e-4


def test_mhsa_i8_guards():
    """The wrapper takes one bf16 or fp32 dtype for q/k/v, a bf16 or fp32
    output, n_valid within the rows; a CPU tensor runs the plain version
    and counts no launch; its fp32 output on bf16 input is the plain value
    before the bf16 rounding."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 17, 96)).astype(np.float32))
               for _ in range(3))
    before = TI.mhsa_i8.launches
    with pytest.raises(ValueError, match="share a dtype"):
        TI.mhsa_i8(q, k, v.to(torch.bfloat16), 3, 17)
    with pytest.raises(ValueError, match="output"):
        TI.mhsa_i8(q, k, v, 3, 17, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="n_valid"):
        TI.mhsa_i8(q, k, v, 3, 18)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    wide = TI.mhsa_i8(qb, kb, vb, 3, 13, zero_pad=True, out_dtype=torch.float32)
    narrow = TI.mhsa_i8(qb, kb, vb, 3, 13, zero_pad=True)
    assert wide.dtype == torch.float32 and torch.equal(wide.to(torch.bfloat16), narrow)
    padded = TI.mhsa_i8(qb, kb, vb, 3, 13, out_lanes=128)
    assert not padded[..., 96:].float().abs().any()
    assert TI.mhsa_i8.launches == before
