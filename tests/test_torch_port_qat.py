"""Quantization-aware training in the port (``dlq_tpu_torch.quant.qat``)
against the JAX package's (``dlq_tpu.quant.qat``) on the same numpy-seeded
weights and batches: the fake-quant values and clipped-STE gradients bit for
bit, the weight fake-quant of every scheme bit for bit (against the jitted
reference, as its training step runs it: XLA makes ``/ qmax`` a multiply
by the fp32 reciprocal), one training step and a two-epoch ``qat_train``
within stated tolerances (gradients are fp32 sums in another order), the
deploy parity of ``tests/test_qat.py`` in the port, and ``SmoothQATCtx``.

Sizes: the MLP at 32 -> 64 -> 10 and LeNet-5 at 28 x 28 x 1, batches of 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu.models import lenet as JL
from dlq_tpu.models import mlp as JP
from dlq_tpu.quant import qat as JQ
from dlq_tpu.quant import smooth as JS
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.model_quant import make_sites_fn as j_sites
from dlq_tpu.quant.qconfig import QConfig as JQConfig
from dlq_tpu.quant.qconfig import QScheme as JQScheme
from dlq_tpu_torch import numerics
from dlq_tpu_torch.models import lenet as TL
from dlq_tpu_torch.models import mlp as TP
from dlq_tpu_torch.quant import qat as TQ
from dlq_tpu_torch.quant import smooth as TS
from dlq_tpu_torch.quant.calibrate import calibrate
from dlq_tpu_torch.quant.model_quant import DeployCtx, make_sites_fn, quantize_weights
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme

STEP_ATOL = 1e-6    # params / velocities after a step (fp32 gradient sums in another order)
TRAIN_ATOL = 1e-5   # after two epochs (eight steps)
LOSS_RTOL = 1e-5
# A calibrated scale puts each site's largest input exactly on the clip
# edge (amax = qmax * scale), where the STE mask turns on the last bit of
# that input's fp32 sums; the step tests give the scales this headroom so
# that no input sits on the edge and the masks agree.
HEADROOM = 1.25


def _headroom(scales):
    return {k: v * HEADROOM for k, v in scales.items()}


def _cfgs(bits, acts=True):
    w = dict(bits=bits, symmetric=True, axis=-1)
    a = dict(bits=8, symmetric=True, axis=None)
    return (QConfig(weights=QScheme(**w), acts=QScheme(**a) if acts else None),
            JQConfig(weights=JQScheme(**w), acts=JQScheme(**a) if acts else None))


def _jtree(flat):
    return {k: {n: jnp.asarray(v.numpy()) for n, v in p.items() if v is not None}
            for k, p in flat.items()}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_tree_close(got, ref, atol):
    assert set(got) == set(ref)
    for site in ref:
        for k in ref[site]:
            np.testing.assert_allclose(_np(got[site][k]), np.asarray(ref[site][k]), rtol=0,
                                       atol=atol, err_msg=f"{site}.{k}")


@pytest.fixture(scope="module")
def mlp():
    cfg_t = TP.MLPConfig(in_dim=32, hidden=(64,), num_classes=10)
    cfg_j = JP.MLPConfig(in_dim=32, hidden=(64,), num_classes=10)
    flat = TP.flatten_params(TP.init_mlp(0, cfg_t))
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (64, 32)).astype(np.float32)
    Y = rng.integers(0, 10, 64).astype(np.int32)
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, flat=flat, jflat=_jtree(flat), X=X, Y=Y)


# ---------------------------------------------------------------------------
# fake_quant_ste and _weight_fq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qmax", [1, 7, 127])
def test_fake_quant_ste_bit_for_bit(qmax):
    """Values and gradients equal bit for bit: exact ties of x / scale
    (half-even rounding), both clip edges (|x| == qmax * scale is inside),
    values just past them, and random values. Gradient 1 inside, 0 out."""
    s = np.float32(0.125)
    ties = (np.arange(-qmax, qmax) + 0.5).astype(np.float32) * s
    edges = np.array([qmax, -qmax], np.float32) * s
    past = np.nextafter(edges, np.float32(np.inf) * np.sign(edges))
    rnd = np.random.default_rng(qmax).normal(0, qmax * s, 200).astype(np.float32)
    x = np.concatenate([ties, edges, past, rnd, [0.0]]).astype(np.float32)
    for scale in (s, np.float32(0.0371)):
        ref = np.asarray(JQ.fake_quant_ste(jnp.asarray(x), jnp.float32(scale), qmax))
        g_ref = np.asarray(jax.grad(lambda v: jnp.sum(
            JQ.fake_quant_ste(v, jnp.float32(scale), qmax)))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = TQ.fake_quant_ste(xt, torch.tensor(scale), qmax)
        got.sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), ref)
        np.testing.assert_array_equal(xt.grad.numpy(), g_ref)
        if scale == s:  # the clip edges are inside, one ulp past them outside
            assert g_ref[len(ties):len(ties) + 4].tolist() == [1.0, 1.0, 0.0, 0.0]


WEIGHT_CASES = {
    "per_tensor_int8": ((48, 16), dict(bits=8, axis=None)),
    "per_oc_int4_dense": ((48, 16), dict(bits=4, axis=-1)),
    "per_oc_int2_conv": ((3, 3, 8, 16), dict(bits=2, axis=-1)),
    "group8_int4_dense": ((48, 16), dict(bits=4, axis=-1, group=8)),
    "group8_int4_conv": ((3, 3, 8, 16), dict(bits=4, axis=-1, group=8)),
    "odd_k_fallback": ((5, 5, 1, 6), dict(bits=4, axis=-1)),
    "group_not_dividing": ((3, 3, 3, 8), dict(bits=4, axis=-1, group=8)),
}


@pytest.mark.parametrize("case", sorted(WEIGHT_CASES))
def test_weight_fq_bit_for_bit(case):
    """Per-tensor, per-OC, group-wise (the C-order [K // g, g, O] view) and
    the odd-K / non-dividing-group int8 fallbacks: the fake-quant weight and
    its gradient equal the jitted reference's bit for bit."""
    shape, kw = WEIGHT_CASES[case]
    w = np.random.default_rng(7).normal(0, 0.2, shape).astype(np.float32)
    r = np.random.default_rng(8).normal(0, 1, shape).astype(np.float32)
    js = JQScheme(symmetric=True, **kw)
    ref = np.asarray(jax.jit(lambda v: JQ._weight_fq(v, js))(jnp.asarray(w)))
    g_ref = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(JQ._weight_fq(v, js) * r)))(
        jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TQ._weight_fq(wt, QScheme(symmetric=True, **kw))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    np.testing.assert_array_equal(wt.grad.numpy(), g_ref)


# ---------------------------------------------------------------------------
# one step, two epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_qat_step_matches_jax(mlp, bits):
    """One make_qat_step from the same params, zero velocities and the
    same calibrated scales (with HEADROOM): loss, accuracy, params, velocities and the EMA
    scales against the jitted reference step."""
    qt, qj = _cfgs(bits)
    x, y = mlp["X"][:16], mlp["Y"][:16]
    js = _headroom(j_calibrate(j_sites(JP.qforward, mlp["cfg_j"]), mlp["jflat"],
                               [jnp.asarray(x)], qj))
    ts = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
    jstep = JQ.make_qat_step(JP.qforward, mlp["cfg_j"], qj, lr=0.05)
    jvel = jax.tree_util.tree_map(jnp.zeros_like, mlp["jflat"])
    jf, jv, jsc, jloss, jacc = jstep(mlp["jflat"], jvel, js, jnp.asarray(x), jnp.asarray(y))
    tstep = TQ.make_qat_step(TP.qforward, mlp["cfg_t"], qt, lr=0.05)
    tvel = {k: {n: torch.zeros_like(v) for n, v in p.items()} for k, p in mlp["flat"].items()}
    tf, tv, tsc, tloss, tacc = tstep(mlp["flat"], tvel, ts, torch.from_numpy(x),
                                     torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tacc) == float(jacc)
    _assert_tree_close(tf, jf, STEP_ATOL)
    _assert_tree_close(tv, jv, STEP_ATOL)
    for k in js:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-6, err_msg=k)
    assert any(not np.array_equal(_np(tf[s]["w"]), _np(mlp["flat"][s]["w"])) for s in tf)


def test_qat_step_conv_and_weight_only():
    """LeNet-5 (the conv path and its odd-K conv1) W4A8 and weight-only:
    one step against the jitted reference."""
    cfg_t, cfg_j = TL.LeNetConfig(), JL.LeNetConfig()
    flat = TL.flatten_params(TL.init_lenet(2, cfg_t))
    jflat = _jtree(flat)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (8, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    for acts in (True, False):
        qt, qj = _cfgs(4, acts)
        js = (_headroom(j_calibrate(j_sites(JL.qforward, cfg_j), jflat, [jnp.asarray(x)], qj))
              if acts else {})
        ts = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
        jvel = jax.tree_util.tree_map(jnp.zeros_like, jflat)
        jf, _, jsc, jloss, _ = JQ.make_qat_step(JL.qforward, cfg_j, qj)(
            jflat, jvel, js, jnp.asarray(x), jnp.asarray(y))
        tvel = {k: {n: torch.zeros_like(v) for n, v in p.items()} for k, p in flat.items()}
        tf, _, tsc, tloss, _ = TQ.make_qat_step(TL.qforward, cfg_t, qt)(
            flat, tvel, ts, torch.from_numpy(x), torch.from_numpy(y))
        assert np.isfinite(float(tloss))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        _assert_tree_close(tf, jf, STEP_ATOL)
        assert set(tsc) == set(jsc)


def test_qat_train_two_epochs_matches_jax(mlp):
    """qat_train over 64 rows in batches of 16 for two epochs (the
    reference's batch order from default_rng(seed).permutation): the
    per-epoch loss and accuracy history, the final params and scales."""
    qt, qj = _cfgs(4)
    jf, jsc, jh = JQ.qat_train(JP.qforward, mlp["jflat"], mlp["cfg_j"], qj, mlp["X"], mlp["Y"],
                               epochs=2, batch=16, lr=0.02, seed=3)
    tf, tsc, th = TQ.qat_train(TP.qforward, mlp["flat"], mlp["cfg_t"], qt, mlp["X"], mlp["Y"],
                               epochs=2, batch=16, lr=0.02, seed=3)
    for a, b in zip(th["epochs"], jh["epochs"]):
        assert a["epoch"] == b["epoch"] and a["acc"] == b["acc"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    _assert_tree_close(tf, jf, TRAIN_ATOL)
    for k in jsc:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# deploy parity, QATCtx against JAX's, SmoothQATCtx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qat_deploy_parity(mlp, bits):
    """``tests/test_qat.py:96`` in the port: the same weights through
    QATCtx and through quantize_weights + DeployCtx agree (cosine > 0.999);
    the port's QATCtx logits equal JAX's within 1e-5."""
    qt, qj = _cfgs(bits)
    x = torch.from_numpy(mlp["X"])
    scales = calibrate(make_sites_fn(TP.qforward, mlp["cfg_t"]), mlp["flat"], [x], qt)
    fq = TP.qforward(TQ.QATCtx(mlp["flat"], scales, qt), x, mlp["cfg_t"])
    with torch.inference_mode():
        dep = TP.qforward(DeployCtx(quantize_weights(mlp["flat"], qt), scales, qt), x,
                          mlp["cfg_t"])
    assert numerics.diff(fq, dep).cosine > 0.999
    js = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    ref = np.asarray(jax.jit(lambda f, s, xx: JP.qforward(JQ.QATCtx(f, s, qj), xx, mlp["cfg_j"]))(
        mlp["jflat"], js, jnp.asarray(mlp["X"])))
    np.testing.assert_allclose(fq.detach().numpy(), ref, rtol=0, atol=1e-5)


def test_qat_deploy_parity_odd_k_conv():
    """LeNet-5's conv1 (K = 25) deploys at int8 under a W4 config; QAT's
    fake-quant takes the same fallback, so the parity holds."""
    cfg = TL.LeNetConfig()
    flat = TL.flatten_params(TL.init_lenet(3, cfg))
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (16, 28, 28, 1))
                         .astype(np.float32))
    qt, _ = _cfgs(4)
    scales = calibrate(make_sites_fn(TL.qforward, cfg), flat, [x], qt)
    qflat = quantize_weights(flat, qt)
    assert qflat["conv1"]["qw"].bits == 8
    fq = TL.qforward(TQ.QATCtx(flat, scales, qt), x, cfg)
    with torch.inference_mode():
        dep = TL.qforward(DeployCtx(qflat, scales, qt), x, cfg)
    assert numerics.diff(fq, dep).cosine > 0.999


def test_smooth_qat_ctx_matches_jax(mlp):
    """SmoothQATCtx (x * (1 / s) before the fake quant, by MRO) on the
    smoothed MLP: logits and one step's loss against JAX's."""
    qt, qj = _cfgs(4)
    amax = TS.collect_channel_amax(TP.qforward, mlp["flat"], mlp["cfg_t"], [mlp["X"]])
    sm = TS.compute_smooth(mlp["flat"], amax)
    flat_s = TS.apply_smooth(mlp["flat"], sm)
    x = torch.from_numpy(mlp["X"])
    scales = TS.smooth_calibrate(TP.qforward, flat_s, mlp["cfg_t"], [x], qt, sm)
    got = TP.qforward(TS.SmoothQATCtx(flat_s, scales, qt, sm), x, mlp["cfg_t"])
    jflat_s = _jtree(flat_s)
    js = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    ref = np.asarray(JP.qforward(JS.SmoothQATCtx(jflat_s, js, qj, sm), jnp.asarray(mlp["X"]),
                                 mlp["cfg_j"]))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5)
    assert [c.__name__ for c in type(TS.SmoothQATCtx(flat_s, scales, qt, sm)).__mro__[:3]] == \
        ["SmoothQATCtx", "_SmoothMixin", "QATCtx"]
