"""GPTQ and bias correction in the port (``dlq_tpu_torch.quant.gptq``)
against the JAX package's (``dlq_tpu.quant.gptq``) on the same numpy-seeded
weights and inputs.

- ``conv_patches`` (``F.unfold``) against ``lax.conv_general_dilated_patches``
  bit for bit: the channel-major IHW column order.
- The collector: H (fp32 sums in another order: rtol 1e-5), the input sums
  (atol 1e-5 of their magnitude), the column and channel amax (exact at
  the stem, whose input is the image; within 1e-4 of each value and of the
  site's largest where the input is an fp32 activation summed in another
  order).
- ``gptq_rows``: the port's recursion is the reference's float64 numpy line
  for line, so on identical inputs the share of codes that differ is gated
  at 0 (act-order ties from dead columns included). A diagonal H gives
  round-to-nearest.
- ``gptq_quantize_weights``: the RTN baseline's layout, bits and scales;
  on the reference's own Hessians the same codes (0 differ); on the port's
  Hessians the share that differs is gated at GPTQ_OWN_H_SHARE.
- ``bias_correct``: the same biases on the same statistics (1e-7 of their
  scale), within 1e-5 on the port's own.
- Grouped (depthwise) convs keep round-to-nearest.

Sizes: ResNet-18 ``small_input`` at 16 px with widths 8-64, batch 4, and
LeNet-5 at 28 x 28 x 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import lenet as JL
from dlq_tpu.models import resnet as JR
from dlq_tpu.quant import gptq as JG
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JW4A8
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JW8
from dlq_tpu.quant.qconfig import QConfig as JQConfig
from dlq_tpu.quant.qconfig import QScheme as JQScheme
from dlq_tpu_torch.models import lenet as TL
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.quant import gptq as TG
from dlq_tpu_torch.quant.model_quant import quantize_weights
from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL as TW4A8
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TW8
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme

WIDTHS = (8, 16, 32, 64)
# GPTQ codes from the port's own Hessians (fp32 sums in another order than
# XLA's): a code can land on the other side of a rounding boundary, and the
# error feedback carries it along its column; at most this share may differ
# (1.7e-5 of the W4A8 codes and 1.7e-4 of the W8A8 ones differ here)
GPTQ_OWN_H_SHARE = 0.002


def _jflat(flat):
    return {k: {n: jnp.asarray(v.numpy()) for n, v in p.items() if v is not None}
            for k, p in flat.items()}


def _codes(qt):
    """Integer codes of a QTensor of either package, as int8 numpy [K, O]."""
    from dlq_tpu_torch.quant.quantize import unpack_int4

    vals = qt.values
    vals = torch.from_numpy(np.array(vals)) if not isinstance(vals, torch.Tensor) else vals
    q = unpack_int4(vals, tuple(qt.shape)) if qt.bits == 4 else vals
    return q.numpy().reshape(-1, q.shape[-1])


@pytest.fixture(scope="module")
def r18():
    cfg_t = TR.ResNetConfig(depth=18, num_classes=10, small_input=True, widths=WIDTHS)
    cfg_j = JR.ResNetConfig(depth=18, num_classes=10, small_input=True, widths=WIDTHS)
    flat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(0, cfg_t), cfg_t))
    x = np.random.default_rng(0).normal(0, 1, (4, 16, 16, 3)).astype(np.float32)
    jflat = _jflat(flat)
    jcol = JG.collect_hessians(JR.qforward, jflat, cfg_j, [x])
    tcol = TG.collect_hessians(TR.qforward, flat, cfg_t, [x])
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, flat=flat, jflat=jflat, x=x, jcol=jcol, tcol=tcol)


@pytest.mark.parametrize("k,stride,pad", [(7, 2, 3), (3, 1, 1), (3, 2, 1), (1, 2, 0), (5, 1, 0)])
def test_conv_patches_order(k, stride, pad):
    x = np.random.default_rng(k + stride).normal(0, 1, (2, 13, 11, 5)).astype(np.float32)
    ref = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = TG.conv_patches(torch.from_numpy(x), k, k, stride, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).reshape(-1, ref.shape[-1]))


def test_collector_matches_jax(r18):
    """Every site's statistics, conv (IHW columns) and dense."""
    j, t = r18["jcol"], r18["tcol"]
    assert set(t.H) == set(j.H) == set(r18["flat"])
    assert t.meta == j.meta and t.n == j.n
    for site in j.H:
        np.testing.assert_allclose(t.H[site], j.H[site], rtol=1e-5,
                                   atol=1e-5 * np.abs(j.H[site]).max(), err_msg=site)
        np.testing.assert_allclose(t.xsum[site], j.xsum[site], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(j.xsum[site]).max()), err_msg=site)
        # the stem sees the image itself (exact); later sites see fp32
        # activations summed in another order
        tol = 0.0 if site == "stem" else 1e-4
        atol = tol * np.abs(j.col_amax[site]).max()
        np.testing.assert_allclose(t.col_amax[site], j.col_amax[site], rtol=tol, atol=atol,
                                   err_msg=site)
        np.testing.assert_allclose(t.channel_amax(site), j.channel_amax(site), rtol=tol,
                                   atol=atol, err_msg=site)
        np.testing.assert_allclose(t.mean(site), j.mean(site), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(j.mean(site)).max()))
    assert t.channel_amax("stem").shape == (3,) and t.channel_amax("fc").shape == (WIDTHS[-1],)


def _rows_cases(r18):
    """(name, W, H, S, qmax): a ResNet conv site on the reference's own
    Hessian, one with dead columns (diagonal ties at 1.0 for act order),
    and a random correlated dense layer at int2."""
    site = "layer2.0.conv1"
    w = r18["flat"][site]["w"].numpy()
    Wg = w.transpose(2, 0, 1, 3).reshape(-1, w.shape[-1]).astype(np.float64)
    S = np.broadcast_to(np.maximum(np.abs(Wg).max(0) / 7.0, 1e-12), Wg.shape)
    H = r18["jcol"].H[site]
    Hd = H.copy()
    dead = np.arange(0, H.shape[0], 7)
    Hd[dead, :] = 0.0
    Hd[:, dead] = 0.0
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (256, 12)) @ rng.normal(0, 1, (12, 96)) + 0.1 * rng.normal(0, 1, (256, 96))
    W2 = rng.normal(0, 1, (96, 24))
    S2 = np.broadcast_to(np.abs(W2).max(0) / 1.0, W2.shape)
    return [("resnet_conv_int4", Wg, H, S, 7), ("dead_columns_int4", Wg, Hd, S, 7),
            ("dense_int2", W2, X.T @ X, S2, 1)]


@pytest.mark.parametrize("actorder", [True, False])
def test_gptq_rows_identical_inputs(r18, actorder):
    """Identical W, H and scales: the share of codes that differ from the
    reference is 0 (gated), act-order ties included."""
    for name, W, H, S, qmax in _rows_cases(r18):
        ref = JG.gptq_rows(W, H, S, -qmax, qmax, actorder=actorder)
        got = TG.gptq_rows(W, H, S, -qmax, qmax, actorder=actorder)
        share = float((got != ref).mean())
        assert got.dtype == np.int8 and share == 0.0, (name, share)


def test_gptq_rows_diagonal_h_is_rtn():
    rng = np.random.default_rng(0)
    W = rng.normal(0, 1, (32, 8))
    S = np.maximum(np.abs(W).max(0) / 7.0, 1e-12) * np.ones((32, 1))
    Q = TG.gptq_rows(W, np.diag(rng.random(32) + 0.5), S, -7, 7, damp=0.0, actorder=False)
    np.testing.assert_array_equal(Q, np.clip(np.round(W / S), -7, 7).astype(np.int8))


class _JaxH:
    """The reference collector's statistics behind the port's collector
    interface (identical Hessians for the code comparison)."""

    def __init__(self, jcol):
        self.H, self.meta = jcol.H, jcol.meta
        self.mean = jcol.mean


def _gptq_both(r18, qt, qj):
    """The reference's GPTQ on its Hessians, the port's on the same
    Hessians and on its own, and the port's RTN baseline."""
    return dict(ref=JG.gptq_quantize_weights(r18["jflat"], qj, r18["jcol"]),
                same=TG.gptq_quantize_weights(r18["flat"], qt, _JaxH(r18["jcol"])),
                own=TG.gptq_quantize_weights(r18["flat"], qt, r18["tcol"]),
                rtn=quantize_weights(r18["flat"], qt))


@pytest.fixture(scope="module")
def gptq_w4a8(r18):
    return _gptq_both(r18, TW4A8, JW4A8)


@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_quantize_weights_matches_jax(r18, gptq_w4a8, bits):
    """The RTN baseline's storage layout, bits and scales; the reference's
    codes on its own Hessians (0 differ) and on the port's (at most
    GPTQ_OWN_H_SHARE differ); every site's codes differ from RTN's
    somewhere."""
    g = gptq_w4a8 if bits == 4 else _gptq_both(r18, TW8, JW8)
    differ = total = 0
    for site in g["ref"]:
        a, b, r = g["own"][site]["qw"], g["same"][site]["qw"], g["rtn"][site]["qw"]
        assert (a.bits, tuple(a.values.shape), a.values.dtype, a.shape, a.orig_shape, a.axis) == \
            (r.bits, tuple(r.values.shape), r.values.dtype, r.shape, r.orig_shape, r.axis), site
        assert torch.equal(a.scale, r.scale) and torch.equal(b.scale, r.scale)
        c = _codes(g["ref"][site]["qw"])
        np.testing.assert_array_equal(_codes(b), c, err_msg=site)
        differ += int((_codes(a) != c).sum())
        total += c.size
        assert (c != _codes(r)).any(), site
    assert differ / total <= GPTQ_OWN_H_SHARE, differ / total


def test_gptq_lenet_group_wise_and_odd_k():
    """LeNet-5 under a group-wise int4 weight-only config (group 8) and
    W4A8: conv1's odd K falls back to int8 in both packages, group scales
    repeat over the HWI rows; the codes on the reference's Hessians equal
    its codes."""
    cfg_t, cfg_j = TL.LeNetConfig(), JL.LeNetConfig()
    flat = TL.flatten_params(TL.init_lenet(1, cfg_t))
    jflat = _jflat(flat)
    x = np.random.default_rng(1).normal(0, 1, (8, 28, 28, 1)).astype(np.float32)
    jcol = JG.collect_hessians(JL.qforward, jflat, cfg_j, [x])
    for qt, qj in ((QConfig(weights=QScheme(4, True, -1, group=8), acts=None),
                    JQConfig(weights=JQScheme(4, True, -1, group=8), acts=None)),
                   (TW4A8, JW4A8)):
        ref = JG.gptq_quantize_weights(jflat, qj, jcol)
        got = TG.gptq_quantize_weights(flat, qt, _JaxH(jcol))
        for site in ref:
            a, r = got[site]["qw"], ref[site]["qw"]
            assert (a.bits, a.group, tuple(a.values.shape)) == \
                (r.bits, r.group, tuple(r.values.shape)), site
            np.testing.assert_array_equal(_codes(a), _codes(r), err_msg=site)
        assert got["conv1"]["qw"].bits == 8


def test_bias_correct_matches_jax(r18, gptq_w4a8):
    """On the same statistics and codes the corrected biases equal the
    reference's (float64 on the host, stored fp32: within 1e-7 of their
    scale); on the port's own collector within 1e-5."""
    ref = JG.bias_correct(r18["jflat"], gptq_w4a8["ref"], r18["jcol"])
    tq = gptq_w4a8["same"]
    same = TG.bias_correct(r18["flat"], tq, _JaxH(r18["jcol"]))
    own = TG.bias_correct(r18["flat"], tq, r18["tcol"])
    for site in ref:
        rb = np.asarray(ref[site]["b"])
        sc = max(1.0, np.abs(rb).max())
        np.testing.assert_allclose(same[site]["b"].numpy(), rb, rtol=0, atol=1e-7 * sc)
        np.testing.assert_allclose(own[site]["b"].numpy(), rb, rtol=0, atol=1e-5 * sc)
        assert same[site]["qw"] is tq[site]["qw"]


def _dw_forwards():
    """A depthwise conv, a 1x1 conv and a dense head: the grouped site
    keeps round-to-nearest in both packages."""
    def tq(ctx, x, cfg):
        y = ctx.conv("dw", x, padding=1, groups=8, fuse_relu=True)
        y = ctx.conv("pw", y, fuse_relu=True)
        return ctx.dense("fc", y.mean(dim=(1, 2)))

    def jq(ctx, x, cfg):
        y = ctx.conv("dw", x, padding=1, groups=8, fuse_relu=True)
        y = ctx.conv("pw", y, fuse_relu=True)
        return ctx.dense("fc", jnp.mean(y, axis=(1, 2)))

    return tq, jq


def test_grouped_conv_keeps_rtn():
    rng = np.random.default_rng(6)
    flat = {"dw": {"w": torch.from_numpy(rng.normal(0, 0.3, (3, 3, 1, 8)).astype(np.float32)),
                   "b": torch.zeros(8)},
            "pw": {"w": torch.from_numpy(rng.normal(0, 0.3, (1, 1, 8, 16)).astype(np.float32)),
                   "b": torch.zeros(16)},
            "fc": {"w": torch.from_numpy(rng.normal(0, 0.3, (16, 4)).astype(np.float32)),
                   "b": torch.zeros(4)}}
    x = rng.normal(0, 1, (4, 6, 6, 8)).astype(np.float32)
    tq, jq = _dw_forwards()
    tcol = TG.collect_hessians(tq, flat, None, [x])
    jcol = JG.collect_hessians(jq, _jflat(flat), None, [x])
    assert tcol.meta == jcol.meta and tcol.meta["dw"] == {"kind": "grouped"}
    assert "dw" not in tcol.H
    got = TG.gptq_quantize_weights(flat, TW4A8, tcol)
    rtn = quantize_weights(flat, TW4A8)
    np.testing.assert_array_equal(_codes(got["dw"]["qw"]), _codes(rtn["dw"]["qw"]))
    bc = TG.bias_correct(flat, got, tcol)
    assert bc["dw"] is got["dw"] and not torch.equal(bc["pw"]["b"], got["pw"]["b"])
    ref = JM.quantize_weights(_jflat(flat), JW4A8)
    np.testing.assert_array_equal(_codes(got["dw"]["qw"]), _codes(ref["dw"]["qw"]))
