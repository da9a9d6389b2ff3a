"""LeNet-5, the MLP, avgpool2d and the model registry: the port against the
JAX package on the same numpy-seeded weights and inputs.

Weights come from the port's numpy-seeded ``init_lenet`` / ``init_mlp``,
carried into JAX. The quantized forwards take the JAX package's
calibration and weight quantization, carried back with ``from_jax_qflat``;
the JAX forwards are jitted with params and scales as arguments, as its
Engine runs them. The port runs on the CPU, where every kernel wrapper runs
its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu import models as JMODELS
from dlq_tpu.engine import Engine as JEngine
from dlq_tpu.models import common as JC
from dlq_tpu.models import lenet as JL
from dlq_tpu.models import mlp as JP
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JQ
from dlq_tpu.quant.store import save_quantized as j_save
from dlq_tpu_torch import models as TMODELS
from dlq_tpu_torch import numerics
from dlq_tpu_torch.engine import Engine
from dlq_tpu_torch.interop import from_jax_qflat, from_jax_tree
from dlq_tpu_torch.models import common as TC
from dlq_tpu_torch.models import lenet as TL
from dlq_tpu_torch.models import mlp as TP
from dlq_tpu_torch.quant import model_quant as TM
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TQ

MODELS = {"lenet5": (JL, TL, JL.LeNetConfig(), TL.LeNetConfig(), TL.init_lenet, (28, 28, 1)),
          "mlp": (JP, TP, JP.MLPConfig(), TP.MLPConfig(), TP.init_mlp, (784,))}


def _qfields(qflat):
    return {k: {"qw": {f: (np.asarray(v) if hasattr(v, "shape") else v)
                       for f, v in vars(p["qw"]).items()},
                "b": np.asarray(p["b"])} for k, p in qflat.items()}


def _np(taps):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in taps.items()}


def _jtree(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


def _model(name, seed=0, n=4):
    """The port's seeded weights (and their JAX copy), inputs, and the JAX
    package's calibration and quantization of the flat sites."""
    jmod, tmod, jcfg, tcfg, init, shape = MODELS[name]
    tparams = init(seed, tcfg)
    jparams = _jtree(tparams)
    x = np.random.default_rng(seed + 1).normal(0, 1, (n,) + shape).astype(np.float32)
    flat = jmod.flatten_params(jparams)
    scales = j_calibrate(JM.make_sites_fn(jmod.qforward, jcfg), flat, [jnp.asarray(x)], JQ)
    qflat = JM.quantize_weights(flat, JQ)
    tq, ts = from_jax_qflat(_qfields(qflat), {k: np.asarray(v) for k, v in scales.items()},
                            device="cpu")
    return dict(jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg, tparams=tparams, jparams=jparams,
                x=x, qflat=qflat, scales=scales, tq=tq, ts=ts)


@pytest.fixture(scope="module", params=sorted(MODELS))
def m(request):
    return _model(request.param)


def test_he_uniform_bound_and_init_shapes(m):
    """he_uniform draws within ±sqrt(6 / fan_in); the port's init has the
    reference's tree of shapes and dtypes (zero biases)."""
    w = TC.he_uniform(np.random.default_rng(0), (400, 120), fan_in=400)
    assert w.dtype == torch.float32 and float(w.abs().max()) <= np.sqrt(6.0 / 400)
    ref = m["jmod"].init_lenet if m["jmod"] is JL else m["jmod"].init_mlp
    jshapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                     ref(jax.random.PRNGKey(0), m["jcfg"]))
    tshapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                                     m["tparams"])
    assert tshapes == jshapes


@pytest.mark.parametrize("shape,stride", [((2, 28, 28, 6), 2), ((2, 10, 10, 16), 2),
                                          ((1, 7, 9, 3), 1), ((3, 13, 13, 8), 2)])
def test_avgpool2d_matches_jax(shape, stride):
    """avgpool2d at the unpadded 2x2 window (LeNet-5's): the taps summed in
    row-major order, then / 4, equal XLA's reduce_window sum / 4, jitted
    and eager, bit for bit."""
    x = np.random.default_rng(sum(shape)).normal(0, 1, shape).astype(np.float32)
    got = TC.avgpool2d(torch.from_numpy(x), 2, stride).numpy()
    jit = np.asarray(jax.jit(lambda a: JC.avgpool2d(a, 2, stride))(x))
    eager = np.asarray(JC.avgpool2d(jnp.asarray(x), 2, stride))
    assert got.shape == jit.shape
    np.testing.assert_array_equal(got, jit)
    np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("window,stride,padding", [(2, 2, 1), (2, 1, 1), (3, 2, 1), (3, 1, 0)])
def test_avgpool2d_other_windows_within_order(window, stride, padding):
    """Padded or 3x3 windows, which no model of the repo pools: XLA's CPU
    reduce_window sums a padded 2x2 window column-major and a 3x3 window in
    yet another order (ROADMAP.md C), so these are held within 4 fp32 ulps
    of the window's magnitude (the sum's order, then / 9 as a division)."""
    x = np.random.default_rng(window * 10 + stride + padding).normal(
        0, 1, (2, 12, 12, 8)).astype(np.float32)
    got = TC.avgpool2d(torch.from_numpy(x), window, stride, padding).numpy()
    ref = np.asarray(jax.jit(lambda a: JC.avgpool2d(a, window, stride, padding))(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=4 * 2.0 ** -23 * float(np.abs(x).max()))


def test_fp32_forward_and_flatten_match_jax(m):
    """The fp32 forward (with taps) within 1e-5 of JAX's jitted forward on
    the same weights; flatten_params gives the same sites and values."""
    fwd = m["jmod"].lenet_forward if m["jmod"] is JL else m["jmod"].mlp_forward
    tfwd = m["tmod"].lenet_forward if m["tmod"] is TL else m["tmod"].mlp_forward
    jl, jt = jax.jit(lambda p, x: fwd(p, x, m["jcfg"], taps=True))(m["jparams"], m["x"])
    tl, tt = tfwd(m["tparams"], torch.from_numpy(m["x"]), m["tcfg"], taps=True)
    assert set(_np(tt)) == set(_np(jt))
    for k, v in _np(jt).items():
        numerics.check(tt[k].numpy(), v, atol=1e-5, what=k)
    numerics.check(tl.numpy(), np.asarray(jl), atol=1e-5, what="logits")
    jflat = m["jmod"].flatten_params(m["jparams"])
    tflat = m["tmod"].flatten_params(m["tparams"])
    assert set(tflat) == set(jflat)
    for site, p in tflat.items():
        for n, v in p.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[site][n]))


def test_deploy_taps_match_jax(m):
    """qforward under DeployCtx (convs on K1's plain version, dense on
    K2's): fp32 taps within 1e-5, logits within 1e-4 of JAX's jitted
    DeployCtx forward; top-1 1.0."""
    jl, jt = jax.jit(lambda q, s, x: m["jmod"].qforward(JM.DeployCtx(q, s, JQ), x, m["jcfg"],
                                                        taps=True))(
        m["qflat"], m["scales"], m["x"])
    with torch.inference_mode():
        tl, tt = m["tmod"].qforward(TM.DeployCtx(m["tq"], m["ts"], TQ),
                                    torch.from_numpy(m["x"]), m["tcfg"], taps=True)
    for k, v in _np(jt).items():
        numerics.check(tt[k].numpy(), v, atol=1e-4 if k == "logits" else 1e-5, what=k)
    numerics.check(tl.numpy(), np.asarray(jl), atol=1e-4, what="logits")
    assert numerics.top1_agreement(tl.numpy(), np.asarray(jl)) == 1.0


def test_lenet_flat_rows_and_kmajor_conv1():
    """LeNet-5's qforward takes flat MNIST rows as the images they hold;
    conv1's one-input-channel weight [5, 5, 1, 6] is packed for K23 at
    construction and gets one K-major copy for K1 at its first call."""
    m = _model("lenet5", seed=2)
    ctx = TM.DeployCtx(m["tq"], m["ts"], TQ)
    with torch.inference_mode():
        img = TL.qforward(ctx, torch.from_numpy(m["x"]), m["tcfg"])
        rows = TL.qforward(ctx, torch.from_numpy(m["x"].reshape(len(m["x"]), -1)), m["tcfg"])
    np.testing.assert_array_equal(rows.numpy(), img.numpy())
    assert set(ctx._kmajor) == {"conv1"}
    assert ctx.conv_packed("conv1", 1) is ctx._kmajor["conv1"]


def test_registry_matches_reference():
    """available() equals the reference's nine names; every builder returns
    (cfg, init, forward) with the config's fields taking the same keywords."""
    names = JMODELS.available()
    assert TMODELS.available() == names
    assert len(names) == 9
    for name in names:
        kw = {} if name == "mlp" else {"num_classes": 10}
        jcfg, _, _ = JMODELS.get_model(name, **kw)
        tcfg, init, fwd = TMODELS.get_model(name, **kw)
        assert type(tcfg).__name__ == type(jcfg).__name__
        for f in (f for f in vars(jcfg) if f != "dtype"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)
        assert callable(init) and callable(fwd)


def test_registry_mnist_models_run():
    """get_model's LeNet-5 and MLP run their fp32 forwards on seeded weights."""
    for name, shape in (("lenet5", (2, 28, 28, 1)), ("mlp", (2, 784))):
        cfg, init, fwd = TMODELS.get_model(name)
        out = fwd(init(0, cfg), torch.zeros(shape), cfg)
        assert out.shape == (2, 10) and out.dtype == torch.float32


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """JAX-written int8 per-channel stores of both models, with their
    calibration inputs."""
    out = {}
    for name in MODELS:
        mm = _model(name, seed=5, n=5)
        root = str(tmp_path_factory.mktemp(name) / "store")
        meta = {"config": {"num_classes": 10, "in_channels": 1}} if name == "lenet5" else {}
        j_save(root, name, mm["qflat"], mm["scales"], JQ, meta=meta)
        out[name] = (root, mm["x"])
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("ctx", ["deploy", "pallas", "fused", "fused2", "dynamic"])
def test_from_store_matches_jax(stores, name, ctx):
    """Engine.from_store on a JAX-written store, every context: logits
    within 1e-4 of JAX's from_store under the same context, top-1 1.0 (or
    the same exception type where the reference raises)."""
    root, x = stores[name]
    try:
        ref = np.asarray(JEngine.from_store(root, ctx=ctx, batch=5)(x))
    except Exception as e:  # the port must raise the same type
        with pytest.raises(type(e)):
            Engine.from_store(root, ctx=ctx, device="cpu", batch=5)(x)
        return
    eng = Engine.from_store(root, ctx=ctx, device="cpu", batch=5)
    assert eng.name == f"{name}_{ctx}"
    got = eng(x).numpy()
    numerics.check(got, ref, atol=1e-4, what=f"{name} {ctx}")
    assert numerics.top1_agreement(got, ref) == 1.0


def test_interop_carries_mnist_trees():
    """from_jax_tree carries the MLP's {"layers": [...]} tree and LeNet's
    dict unchanged in structure and values."""
    for name, (jmod, _, jcfg, _, _, _) in MODELS.items():
        init = jmod.init_lenet if name == "lenet5" else jmod.init_mlp
        jp = init(jax.random.PRNGKey(1), jcfg)
        tp = from_jax_tree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        assert jax.tree_util.tree_structure(tp) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, jp))
        for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
