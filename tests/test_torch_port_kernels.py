"""The port's kernel modules against the JAX package's TPU kernels.

The same numpy-seeded inputs go through the JAX function (Pallas in
interpret mode on the CPU, as the JAX package's own tests run it) and the
port's wrapper, which on a CPU tensor runs its kernel's plain PyTorch
version. int8 outputs must be bit-identical; fp32 outputs are bit-identical
too, because the port writes the epilogue ``acc * s + b`` as the fused
multiply-add that XLA emits for it.

JAX-side XLA compositions are jitted with the scales passed as arguments,
as an engine passes them: a scale captured as a constant lets XLA turn the
requant's division into a multiply by the reciprocal.

The CUDA kernels themselves are held against the same plain versions in
``test_torch_port_card.py``, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.ops import qops as jqops
from dlq_tpu.ops.pallas_block import basic_block_fused as j_basic_block_fused
from dlq_tpu.ops.pallas_block import pack_basic_block as j_pack_basic_block
from dlq_tpu.ops.pallas_conv import (
    int8_conv3x3_s1, int8_conv3x3_s1_dp, int8_conv3x3_s1_dp2, pack_w_dual,
)
from dlq_tpu.ops.pallas_matmul import int8_matmul
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as J_INT8_PC
from dlq_tpu.quant.quantize import quantize_tensor as j_quantize_tensor
from dlq_tpu_torch.interop import from_jax_qflat
from dlq_tpu_torch.ops.block_fused import basic_block_fused, pack_basic_block
from dlq_tpu_torch.ops.conv_int8 import conv_acc_plain, conv_int8, pack_conv_weight
from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, pack_dense_weight
from dlq_tpu_torch.ops.qops import qdense
from dlq_tpu_torch.quant.quantize import QTensor


def _i8(rng, shape, lo=-127):
    return rng.integers(lo, 128, shape).astype(np.int8)


def _epi(rng, oc, k):
    """Per-OC scales putting y near unit scale, biases, and an output scale
    spreading int8 outputs over the range."""
    scale = (rng.uniform(0.5, 1.5, oc) / (73.0 * 73.0 * np.sqrt(k))).astype(np.float32)
    bias = rng.normal(0, 0.3, oc).astype(np.float32)
    return scale, bias, np.float32(1.0 / 40.0)


def _assert_spread(q):
    """int8 outputs that exercise the requant: neither all zero nor saturated."""
    assert float((q == 0).mean()) < 0.95 and float((np.abs(q) == 127).mean()) < 0.5
    assert float(q.astype(np.float64).std()) > 5.0


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def qtensor_fields(qw):
    """numpy views of a JAX QTensor's fields, for dlq_tpu_torch.interop."""
    return {f: (np.asarray(v) if hasattr(v, "shape") else v) for f, v in vars(qw).items()}


# ---------------------------------------------------------------------------
# K1: conv_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_int8_vs_int8_conv3x3_s1(c, relu):
    rng = np.random.default_rng(c + relu)
    x, w = _i8(rng, (2, 8, 8, c)), _i8(rng, (3, 3, c, 128))
    scale, bias, _ = _epi(rng, 128, 9 * c)
    ref = np.asarray(int8_conv3x3_s1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     jnp.asarray(bias), fuse_relu=relu, interpret=True))
    got = conv_int8(_t(x), pack_conv_weight(_t(w)), 1, 1, _t(scale), _t(bias), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("relu", [False, True])
def test_conv_int8_vs_int8_conv3x3_s1_dp_int8_out(relu):
    rng = np.random.default_rng(7 + relu)
    x, w = _i8(rng, (2, 8, 8, 64)), _i8(rng, (3, 3, 64, 64))
    scale, bias, osc = _epi(rng, 64, 9 * 64)
    ref = np.asarray(int8_conv3x3_s1_dp(
        jnp.asarray(x), pack_w_dual(jnp.asarray(w)), jnp.asarray(scale), jnp.asarray(bias),
        out_scale=jnp.asarray(osc), fuse_relu=relu, out_int8=True, interpret=True))
    got = conv_int8(_t(x), pack_conv_weight(_t(w)), 1, 1, _t(scale), _t(bias), relu=relu,
                    out_scale=float(osc))
    assert got.dtype == torch.int8
    _assert_spread(ref)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("relu", [False, True])
def test_conv_int8_vs_int8_conv3x3_s1_dp2(relu):
    """``_dp2`` computes the same function as ``_dp`` (multi-buffered slabs);
    K1's int8 epilogue at C=64 carries both."""
    rng = np.random.default_rng(17 + relu)
    x, w = _i8(rng, (2, 8, 8, 64)), _i8(rng, (3, 3, 64, 64))
    scale, bias, osc = _epi(rng, 64, 9 * 64)
    ref = np.asarray(int8_conv3x3_s1_dp2(
        jnp.asarray(x), pack_w_dual(jnp.asarray(w)), jnp.asarray(scale), jnp.asarray(bias),
        out_scale=jnp.asarray(osc), fuse_relu=relu, out_int8=True, interpret=True))
    got = conv_int8(_t(x), pack_conv_weight(_t(w)), 1, 1, _t(scale), _t(bias), relu=relu,
                    out_scale=float(osc))
    assert got.dtype == torch.int8
    _assert_spread(ref)
    np.testing.assert_array_equal(got.numpy(), ref)


@jax.jit
def _xla_epilogue(acc, scale, bias, out_scale):
    """FullFusedCtx's conv epilogue (int8 out, no relu), scales as arguments."""
    y = acc.astype(jnp.float32) * scale + bias
    return y, jnp.clip(jnp.round(y / out_scale), -127.0, 127.0).astype(jnp.int8)


@pytest.mark.parametrize("k,stride,pad,c,oc,h", [(3, 2, 1, 64, 128, 10), (1, 2, 0, 128, 256, 9)])
def test_conv_int8_vs_xla_conv_int8_strided(k, stride, pad, c, oc, h):
    rng = np.random.default_rng(k * 10 + h)
    x, w = _i8(rng, (2, h, h, c)), _i8(rng, (k, k, c, oc))
    scale, bias, osc = _epi(rng, oc, k * k * c)
    acc = jqops._conv_int8(jnp.asarray(x), jnp.asarray(w), stride, pad, 1)
    np.testing.assert_array_equal(conv_acc_plain(_t(x), _t(w), stride, pad).numpy(),
                                  np.asarray(acc, np.float64))
    y_ref, q_ref = _xla_epilogue(acc, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(osc))
    pk = pack_conv_weight(_t(w))
    y = conv_int8(_t(x), pk, stride, pad, _t(scale), _t(bias))
    q = conv_int8(_t(x), pk, stride, pad, _t(scale), _t(bias), out_scale=float(osc))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))


@pytest.mark.parametrize("relu", [False, True])
def test_conv_int8_1x1_s1_vs_int8_matmul(relu):
    """K1 computes a 1x1/s1 conv too (the contexts route those to K2, as the
    reference's mm1x1 does); it equals the int8 GEMM on the [N*H*W, C] view."""
    rng = np.random.default_rng(21 + relu)
    x, w = _i8(rng, (2, 8, 8, 128)), _i8(rng, (1, 1, 128, 256))
    scale, bias, _ = _epi(rng, 256, 128)
    ref = np.asarray(int8_matmul(jnp.asarray(x.reshape(-1, 128)), jnp.asarray(w[0, 0]),
                                 jnp.asarray(scale), jnp.asarray(bias), fuse_relu=relu,
                                 interpret=True))
    got = conv_int8(_t(x), pack_conv_weight(_t(w)), 1, 0, _t(scale), _t(bias), relu=relu)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 256), ref)


def test_pack_conv_weight_layout():
    w = _t(_i8(np.random.default_rng(0), (3, 3, 5, 7)))
    pk = pack_conv_weight(w)
    assert pk.wk.shape == (7, 64) and pk.k == 45
    assert torch.equal(pk.wk[:, :45].reshape(7, 3, 3, 5), w.permute(3, 0, 1, 2))
    assert not pk.wk[:, 45:].any()
    assert torch.equal(pk.hwio(), w)


# ---------------------------------------------------------------------------
# K2: matmul_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(256, 512, 1024), (256, 128, 256)])
def test_matmul_int8_vs_int8_matmul(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    scale, bias, _ = _epi(rng, n, k)
    ref = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                 jnp.asarray(bias), interpret=True))
    got = matmul_int8(_t(x), pack_dense_weight(_t(w)), _t(scale), _t(bias))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_qdense_fc_vs_jax_qdense():
    """W8A8 fc at ResNet-18's head shape (M=2, 512 -> 1000)."""
    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(0, 1, (2, 512)), 0).astype(np.float32)
    w = rng.normal(0, 0.05, (512, 1000)).astype(np.float32)
    b = rng.normal(0, 0.1, 1000).astype(np.float32)
    s = np.float32(np.abs(x).max() / 127.0)
    jqw = j_quantize_tensor(jnp.asarray(w), J_INT8_PC.weights)
    ref = jax.jit(lambda xx, qw, bb, ss: jqops.qdense(xx, qw, bb, act_scale=ss))(
        jnp.asarray(x), jqw, jnp.asarray(b), jnp.asarray(s))
    f = qtensor_fields(jqw)
    qw = QTensor(_t(f["values"]), _t(f["scale"]), None, 8, -1, None, tuple(f["shape"]))
    got = qdense(_t(x), qw, _t(b), act_scale=torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# K3: basic_block
# ---------------------------------------------------------------------------

def _block_case(h, c, seed):
    """One identity block's quantized sites + act scales, JAX and port."""
    rng = np.random.default_rng(seed)
    jq = {}
    for name in ("b.conv1", "b.conv2"):
        w = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
        qw = j_quantize_tensor(jnp.asarray(w), J_INT8_PC.weights)
        qw.orig_shape = (3, 3, c, c)
        jq[name] = {"qw": qw, "b": jnp.asarray(rng.normal(0, 0.2, c).astype(np.float32))}
    scales = {"b.conv1": np.float32(0.05), "b.conv2": np.float32(0.35),
              "n.conv1": np.float32(0.08)}
    jscales = {k: jnp.asarray(v) for k, v in scales.items()}
    tq, ts = from_jax_qflat({k: {"qw": qtensor_fields(p["qw"]), "b": np.asarray(p["b"])}
                             for k, p in jq.items()}, scales, device="cpu")
    x = _i8(rng, (2, h, h, c), lo=0)
    return jq, jscales, tq, ts, x


@pytest.mark.parametrize("h,c", [(16, 128), (8, 256)])
def test_basic_block_vs_basic_block_fused(h, c):
    jq, jscales, tq, ts, x = _block_case(h, c, seed=h)
    ref = np.asarray(j_basic_block_fused(
        jnp.asarray(x), j_pack_basic_block(jq, jscales, "b", "n.conv1"), interpret=True))
    got = basic_block_fused(_t(x), pack_basic_block(tq, ts, "b", "n.conv1")).numpy()
    _assert_spread(ref)
    np.testing.assert_array_equal(got, ref)


def test_basic_block_vs_fullfused_composition():
    """K3 multiplies by inverse scales where FullFusedCtx divides: rounding
    ties may flip one step on ~1e-4 of elements (pallas_block.py:20-28)."""
    jq, jscales, tq, ts, x = _block_case(16, 128, seed=5)

    @jax.jit
    def composition(q, p, s):
        ctx = JM.FullFusedCtx(p, s, J_INT8_PC)
        y = JM.QAct(q, s["b.conv1"])
        z = ctx.conv("b.conv1", y, stride=1, padding=1, fuse_relu=True, out_site="b.conv2")
        z = ctx.conv("b.conv2", z, stride=1, padding=1, out_site="n.conv1")
        return ctx.add_relu(z, ctx.requant(y, "n.conv1")).q

    ref = np.asarray(composition(jnp.asarray(x), jq, jscales))
    got = basic_block_fused(_t(x), pack_basic_block(tq, ts, "b", "n.conv1")).numpy()
    assert float((got == ref).mean()) >= 0.999
    assert int(np.abs(got.astype(np.int32) - ref).max()) <= 1
