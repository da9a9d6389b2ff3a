"""``ptq_auto`` in the port (``dlq_tpu_torch.quant.recipe``) against the JAX
package's (``dlq_tpu.quant.recipe``) in its three smoothing modes, on the
same numpy-seeded weights and calibration batches, and its block fold.

Per mode: the smoothing vectors (the same sites; within rtol 1e-5: amax of
activations summed in another order), the chosen codes (GPTQ on Hessians
summed in another order: at most CODE_SHARE of them differ), the corrected
biases (1e-5 of their scale), the activation scales (rtol 1e-5), and the
deployed logits under SmoothDeployCtx (cosine >= 0.9999). Then the port's
own block fold: a ptq_auto DeiT restricted to VIT_LN_FOLDABLE, packed with
``smooth=`` for the W8A8 and W4A8 block forwards, against the sitewise
SmoothDeployCtx forward at cosine > 0.999 and top-1 1.0 (the reference's
``tests/test_vit_blockfused.py:142``).

Sizes: the MLP at 64 -> 32 -> 8 with outlier input channels, DeiT at 32 px,
patch 8, dim 96, depth 1, batch 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import mlp as JP
from dlq_tpu.quant import recipe as JR
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JW4A8
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JW8
from dlq_tpu.quant.smooth import SmoothDeployCtx as JSmoothDeployCtx
from dlq_tpu_torch import numerics
from dlq_tpu_torch.models import mlp as TP
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.quant import recipe as TR
from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL as TW4A8
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TW8
from dlq_tpu_torch.quant.smooth import SmoothDeployCtx

CODE_SHARE = 0.01
HOT = [3, 17, 40]


def _outliers(rng, n, dim=64, factor=60.0):
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    x[:, HOT] *= factor
    return x


def _codes(qt):
    from dlq_tpu_torch.quant.quantize import unpack_int4

    v = qt.values if isinstance(qt.values, torch.Tensor) else torch.from_numpy(
        np.array(qt.values))
    return (unpack_int4(v, tuple(qt.shape)) if qt.bits == 4 else v).numpy().reshape(-1)


@pytest.fixture(scope="module")
def mlp():
    cfg_t = TP.MLPConfig(in_dim=64, hidden=(32,), num_classes=8)
    cfg_j = JP.MLPConfig(in_dim=64, hidden=(32,), num_classes=8)
    flat = TP.flatten_params(TP.init_mlp(1, cfg_t))
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in flat.items()}
    rng = np.random.default_rng(11)
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, flat=flat, jflat=jflat,
                cal=[_outliers(rng, 32), _outliers(rng, 32)], x=_outliers(rng, 16))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["auto", "fixed", "off"])
def test_ptq_auto_matches_jax(mlp, mode, bits):
    qt, qj = (TW8, JW8) if bits == 8 else (TW4A8, JW4A8)
    tq, ts, tsm = TR.ptq_auto(TP.qforward, mlp["flat"], mlp["cfg_t"], mlp["cal"], qt, smooth=mode)
    jq, js, jsm = JR.ptq_auto(JP.qforward, mlp["jflat"], mlp["cfg_j"], mlp["cal"], qj,
                              smooth=mode)
    assert set(tsm) == set(jsm) and (mode == "off") == (not tsm)
    for k in jsm:
        np.testing.assert_allclose(tsm[k], jsm[k], rtol=1e-5, err_msg=k)
    differ = total = 0
    for site in jq:
        a, r = tq[site]["qw"], jq[site]["qw"]
        assert (a.bits, a.shape) == (r.bits, tuple(r.shape))
        np.testing.assert_allclose(a.scale.numpy(), np.asarray(r.scale), rtol=1e-5)
        differ += int((_codes(a) != _codes(r)).sum())
        total += _codes(r).size
        rb = np.asarray(jq[site]["b"])
        np.testing.assert_allclose(tq[site]["b"].numpy(), rb, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(rb).max()))
    assert differ / total <= CODE_SHARE, differ / total
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-5, err_msg=k)
    with torch.inference_mode():
        got = TP.qforward(SmoothDeployCtx(tq, ts, qt, tsm), torch.from_numpy(mlp["x"]),
                          mlp["cfg_t"])
    ref = np.asarray(TP_ref(jq, js, qj, jsm, mlp))
    assert numerics.diff(got, ref).cosine >= 0.9999


def TP_ref(jq, js, qj, jsm, mlp):
    return JP.qforward(JSmoothDeployCtx(jq, js, qj, jsm), jnp.asarray(mlp["x"]), mlp["cfg_j"])


def test_ptq_auto_stage_options(mlp):
    """gptq=False, bias_correct=False is round-to-nearest on the smoothed
    weights; bias correction alone changes only the biases; a weight-only
    config neither smooths nor calibrates."""
    from dlq_tpu_torch.quant.model_quant import quantize_weights
    from dlq_tpu_torch.quant.qconfig import INT4_WEIGHT_ONLY_PER_OC
    from dlq_tpu_torch.quant.smooth import apply_smooth

    q0, s0, sm = TR.ptq_auto(TP.qforward, mlp["flat"], mlp["cfg_t"], mlp["cal"], TW8,
                             smooth="fixed", gptq=False, bias_correct=False)
    rtn = quantize_weights(apply_smooth(mlp["flat"], sm), TW8)
    for site in rtn:
        assert torch.equal(q0[site]["qw"].values, rtn[site]["qw"].values)
    q1, _, _ = TR.ptq_auto(TP.qforward, mlp["flat"], mlp["cfg_t"], mlp["cal"], TW8,
                           smooth="fixed", gptq=False)
    for site in rtn:
        assert torch.equal(q1[site]["qw"].values, rtn[site]["qw"].values)
        assert not torch.equal(q1[site]["b"], mlp["flat"][site]["b"])
    qw, sw, smw = TR.ptq_auto(TP.qforward, mlp["flat"], mlp["cfg_t"], mlp["cal"],
                              INT4_WEIGHT_ONLY_PER_OC)
    assert sw is None and smw == {}


def test_ptq_auto_block_fold_matches_sitewise():
    """A ptq_auto DeiT (alpha searched, LN-foldable sites) through the
    W8A8 and W4A8 block forwards with ``smooth=`` against the sitewise
    SmoothDeployCtx forward on the same payload."""
    cfg = TV.ViTConfig(image_size=32, patch=8, dim=96, heads=3, num_classes=10, depth=1)
    params = TV.init_vit(np.random.default_rng(2), cfg)
    flat, ex = TV.flatten_vit(params), TV.vit_extras(params)
    qf = TV.make_qforward(ex, 1, 3, 8, 96, gelu="tanh")
    rng = np.random.default_rng(3)
    cal = [rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    x = torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
    for qcfg, pack, fwd in ((TW8, TB.pack_vit_blocks_w8, TB.vit_forward_blockfused_w8),
                            (TW4A8, TB.pack_vit_blocks_w4a8, TB.vit_forward_blockfused_w4a8c)):
        qa, sa, sm = TR.ptq_auto(qf, flat, cfg, cal, qcfg, smooth="fixed",
                                 smooth_site_filter=TR.VIT_LN_FOLDABLE)
        assert sm and all(TR.VIT_LN_FOLDABLE(k) for k in sm)
        with torch.inference_mode():
            ref = qf(SmoothDeployCtx(qa, sa, qcfg, sm), x, cfg)
            out = fwd(pack(qa, sa, ex, cfg, tight=True, smooth=sm), x, cfg, tight=True)
        d = numerics.diff(out, ref)
        assert d.cosine > 0.999 and numerics.top1_agreement(out, ref) == 1.0, (qcfg, d)
