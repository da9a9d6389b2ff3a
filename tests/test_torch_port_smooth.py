"""SmoothQuant in the port (``dlq_tpu_torch.quant.smooth``) against the JAX
package's (``dlq_tpu.quant.smooth``), and the LN fold in the port's block
packers against ``pallas_vit_block.pack_vit_blocks_w8`` / ``_w4a8`` with
``smooth=``, on the same numpy-seeded weights and inputs.

Tolerances: the amax of a site whose input is the data itself is exact,
later sites' inputs are fp32 activations summed in another order (rtol
1e-5); ``compute_smooth`` on the same amax, ``apply_smooth``, the folded LN
affines and the packed LN rows are bit for bit; the contexts' logits on the
same scales within 1e-5; the alpha ``search_smooth_alpha`` picks is the
reference's; the block forwards on the smoothed packs as the unsmoothed
block tests hold them (1e-6).

Sizes: the MLP at 64 -> 32 -> 8 with outlier input channels, and DeiT at
32 px, patch 8, dim 96, depth 1, 3 heads, batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import mlp as JP
from dlq_tpu.models import vit as JV
from dlq_tpu.ops import pallas_vit_block as JB
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant import smooth as JS
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JW4A8
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JW8
from dlq_tpu.quant.recipe import VIT_LN_FOLDABLE as J_FOLDABLE
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import mlp as TP
from dlq_tpu_torch.models import vit as TV
from dlq_tpu_torch.ops import vit_block as TB
from dlq_tpu_torch.quant import smooth as TS
from dlq_tpu_torch.quant.model_quant import quantize_weights
from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL as TW4A8
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TW8
from dlq_tpu_torch.quant.recipe import VIT_LN_FOLDABLE
from test_torch_port_vit_kernels import np_tree, qfields

HOT = [3, 17, 40]
VIT = dict(image_size=32, patch=8, dim=96, heads=3, num_classes=10, depth=1)


def _outliers(rng, n, dim=64, factor=60.0):
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    x[:, HOT] *= factor
    return x


def _jflat(flat):
    return {k: {n: jnp.asarray(v.numpy()) for n, v in p.items() if v is not None}
            for k, p in flat.items()}


@pytest.fixture(scope="module")
def mlp():
    cfg_t = TP.MLPConfig(in_dim=64, hidden=(32,), num_classes=8)
    cfg_j = JP.MLPConfig(in_dim=64, hidden=(32,), num_classes=8)
    flat = TP.flatten_params(TP.init_mlp(1, cfg_t))
    rng = np.random.default_rng(1)
    cal = [_outliers(rng, 32), _outliers(rng, 32)]
    jflat = _jflat(flat)
    jamax = JS.collect_channel_amax(JP.qforward, jflat, cfg_j, cal)
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, flat=flat, jflat=jflat, cal=cal, jamax=jamax,
                sm=JS.compute_smooth(jflat, jamax))


@pytest.fixture(scope="module")
def vit():
    tcfg, jcfg = TV.ViTConfig(**VIT), JV.ViTConfig(**VIT)
    tparams = TV.init_vit(np.random.default_rng(2), tcfg)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    rng = np.random.default_rng(3)
    cal = [rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    return dict(tcfg=tcfg, jcfg=jcfg, tparams=tparams, jparams=jparams, cal=cal, x=x,
                tflat=TV.flatten_vit(tparams), jflat=JV.flatten_vit(jparams),
                tex=TV.vit_extras(tparams), jex=JV.vit_extras(jparams),
                tqf=TV.make_qforward(TV.vit_extras(tparams), 1, 3, 8, 96),
                jqf=JV.make_qforward(JV.vit_extras(jparams), 1, 3, 8, 96))


def test_amax_vectors_and_rebalance_match_jax(mlp):
    """The per-channel amax (the first site's input is the data: exact),
    the vectors on the same amax (bit for bit), the rebalanced weights."""
    amax = TS.collect_channel_amax(TP.qforward, mlp["flat"], mlp["cfg_t"], mlp["cal"])
    assert set(amax) == set(mlp["jamax"]) == {"fc1", "fc2"}
    np.testing.assert_array_equal(amax["fc1"], np.asarray(mlp["jamax"]["fc1"], np.float32))
    np.testing.assert_allclose(amax["fc2"], np.asarray(mlp["jamax"]["fc2"], np.float32),
                               rtol=1e-5)
    jam = {k: np.asarray(v) for k, v in mlp["jamax"].items()}
    for alpha in (0.25, 0.5, 0.75):
        got = TS.compute_smooth(mlp["flat"], jam, alpha)
        ref = JS.compute_smooth(mlp["jflat"], jam, alpha)
        for k in ref:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k} alpha {alpha}")
    own = TS.compute_smooth(mlp["flat"], amax)
    for k in own:
        np.testing.assert_allclose(own[k], mlp["sm"][k], rtol=1e-5)
    assert own["fc1"][HOT].min() > np.delete(own["fc1"], HOT).max()
    got = TS.apply_smooth(mlp["flat"], mlp["sm"])
    ref = JS.apply_smooth(mlp["jflat"], mlp["sm"])
    for k in ref:
        np.testing.assert_array_equal(got[k]["w"].numpy(), np.asarray(ref[k]["w"]))


@pytest.mark.parametrize("ctx", ["observe", "deploy", "simulate"])
def test_smooth_ctx_logits_match_jax(mlp, ctx):
    """SmoothObserveCtx, SmoothDeployCtx (K2's plain version on the CPU)
    and SmoothSimulateCtx on the smoothed MLP: the calibrated scales
    (rtol 1e-6) and, on the reference's scales, the logits (1e-5)."""
    sm = mlp["sm"]
    tflat_s = TS.apply_smooth(mlp["flat"], sm)
    jflat_s = JS.apply_smooth(mlp["jflat"], sm)
    ts = TS.smooth_calibrate(TP.qforward, tflat_s, mlp["cfg_t"], mlp["cal"], TW8, sm)
    js = JS.smooth_calibrate(JP.qforward, jflat_s, mlp["cfg_j"], mlp["cal"], JW8, sm)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6, err_msg=k)
    ts = {k: torch.tensor(np.float32(v)) for k, v in js.items()}
    x = _outliers(np.random.default_rng(4), 16)
    if ctx == "observe":
        ref = JP.qforward(JS.SmoothObserveCtx(jflat_s, sm), jnp.asarray(x), mlp["cfg_j"])
        got = TP.qforward(TS.SmoothObserveCtx(tflat_s, sm), torch.from_numpy(x), mlp["cfg_t"])
    else:
        JC, TC = {"deploy": (JS.SmoothDeployCtx, TS.SmoothDeployCtx),
                  "simulate": (JS.SmoothSimulateCtx, TS.SmoothSimulateCtx)}[ctx]
        jq = JM.quantize_weights(jflat_s, JW8)
        tq = quantize_weights(tflat_s, TW8)
        ref = jax.jit(lambda q, s, xx: JP.qforward(JC(q, s, JW8, sm), xx, mlp["cfg_j"]))(
            jq, js, jnp.asarray(x))
        with torch.inference_mode():
            got = TP.qforward(TC(tq, ts, TW8, sm), torch.from_numpy(x), mlp["cfg_t"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_fold_smooth_into_ln_extras_bit_for_bit(vit):
    """ln1 <- (g, b) * (1 / s_qkv), ln2 <- (g, b) * (1 / s_fc1), fp32; a
    vector of any other site raises the reference's ValueError."""
    rng = np.random.default_rng(5)
    sm = {"l0.qkv": rng.uniform(0.1, 10, 96).astype(np.float32),
          "l0.fc1": rng.uniform(0.1, 10, 96).astype(np.float32)}
    ex = {**vit["tex"], "ln": [{k: {"g": torch.from_numpy(rng.normal(1, 0.1, 96)
                                                          .astype(np.float32)),
                                    "b": torch.from_numpy(rng.normal(0, 0.1, 96)
                                                          .astype(np.float32))}
                                for k in ("ln1", "ln2")}]}
    got = TS.fold_smooth_into_ln_extras(ex, sm)
    ref = JS.fold_smooth_into_ln_extras(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                                               ex), sm)
    for key in ("ln1", "ln2"):
        for ab in ("g", "b"):
            np.testing.assert_array_equal(got["ln"][0][key][ab].numpy(),
                                          np.asarray(ref["ln"][0][key][ab]))
    assert got["cls"] is ex["cls"]
    with pytest.raises(ValueError, match="fold"):
        TS.fold_smooth_into_ln_extras(ex, {"l0.proj": sm["l0.qkv"]})


def test_search_smooth_alpha_picks_the_references(mlp, vit):
    """The same alpha grid, holdout split and strict ``<``: the MLP with
    outlier channels (whole-model smoothing) and DeiT restricted to the
    LN-foldable sites; the chosen vectors within rtol 1e-5 (amax of
    activations summed in another order)."""
    for tq, jq, tflat, jflat, cfgs, cal, filt in (
            (TP.qforward, JP.qforward, mlp["flat"], mlp["jflat"], (mlp["cfg_t"], mlp["cfg_j"]),
             mlp["cal"], (None, None)),
            (vit["tqf"], vit["jqf"], vit["tflat"], vit["jflat"], (vit["tcfg"], vit["jcfg"]),
             vit["cal"], (VIT_LN_FOLDABLE, J_FOLDABLE))):
        got_sm, got_a = TS.search_smooth_alpha(tq, tflat, cfgs[0], cal, TW8, site_filter=filt[0])
        ref_sm, ref_a = JS.search_smooth_alpha(jq, jflat, cfgs[1], cal, JW8, site_filter=filt[1])
        assert got_a == ref_a and set(got_sm) == set(ref_sm)
        for k in ref_sm:
            np.testing.assert_allclose(got_sm[k], ref_sm[k], rtol=1e-5, err_msg=k)
    assert got_a > 0 and set(got_sm) == {"l0.qkv", "l0.fc1"}


@pytest.fixture(scope="module")
def smoothed_vit(vit):
    """The DeiT smoothed (alpha 0.5, LN-foldable sites), calibrated and
    quantized by the JAX package at W8A8 and W4A8, with the port's copies."""
    amax = JS.collect_channel_amax(vit["jqf"], vit["jflat"], vit["jcfg"], vit["cal"])
    sm = {k: v for k, v in JS.compute_smooth(vit["jflat"], amax).items() if J_FOLDABLE(k)}
    jflat_s = JS.apply_smooth(vit["jflat"], sm)
    scales = JS.smooth_calibrate(vit["jqf"], jflat_s, vit["jcfg"], vit["cal"], JW8, sm)
    out = {"sm": sm, "scales": scales}
    for name, jq in (("w8", JW8), ("w4a8", JW4A8)):
        qflat = JM.quantize_weights(jflat_s, jq)
        tq, ts = from_jax_qflat(qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                                device="cpu")
        out[name] = (qflat, tq, ts)
    out["tex"] = from_jax_tree(np_tree(vit["jex"]), device="cpu")
    return out


@pytest.mark.parametrize("kind", ["w8", "w4a8"])
def test_block_pack_smooth_matches_jax(vit, smoothed_vit, kind):
    """``pack_vit_blocks_{kind}(smooth=)``: the folded LN rows bit for bit
    against the reference's packer, the unsmoothed LN rows where no vector
    is given, and the block forward (plain versions) against the
    reference's smoothed block forward (interpret mode) within 1e-6."""
    sm = smoothed_vit["sm"]
    qflat, tq, ts = smoothed_vit[kind]
    jpack_fn, tpack_fn = {"w8": (JB.pack_vit_blocks_w8, TB.pack_vit_blocks_w8),
                          "w4a8": (JB.pack_vit_blocks_w4a8, TB.pack_vit_blocks_w4a8)}[kind]
    jpack = jpack_fn(qflat, smoothed_vit["scales"], vit["jex"], vit["jcfg"], tight=True,
                     smooth=sm)
    tpack = tpack_fn(tq, ts, smoothed_vit["tex"], vit["tcfg"], tight=True, smooth=sm)
    plain = tpack_fn(tq, ts, smoothed_vit["tex"], vit["tcfg"], tight=True)
    for ln in ("ln1", "ln2"):
        np.testing.assert_array_equal(tpack["blocks"][0][ln].numpy(),
                                      np.asarray(jpack["blocks"][0][ln]), err_msg=ln)
        assert not torch.equal(tpack["blocks"][0][ln], plain["blocks"][0][ln])
    jfwd, tfwd = {"w8": (JB.vit_forward_blockfused_w8, TB.vit_forward_blockfused_w8),
                  "w4a8": (JB.vit_forward_blockfused_w4a8c,
                           TB.vit_forward_blockfused_w4a8c)}[kind]
    ref = np.asarray(jfwd(jpack, jnp.asarray(vit["x"]), vit["jcfg"], tight=True,
                          interpret=True))
    got = tfwd(tpack, torch.from_numpy(vit["x"]), vit["tcfg"], tight=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_block_pack_refuses_unfoldable_and_w4_takes_none(vit, smoothed_vit):
    _, tq, ts = smoothed_vit["w8"]
    with pytest.raises(ValueError, match="fold"):
        TB.pack_vit_blocks_w8(tq, ts, smoothed_vit["tex"], vit["tcfg"],
                              smooth={"l0.fc2": np.ones(384, np.float32)})
    with pytest.raises(TypeError):
        TB.pack_vit_blocks_w4(tq, smoothed_vit["tex"], vit["tcfg"], smooth={})
