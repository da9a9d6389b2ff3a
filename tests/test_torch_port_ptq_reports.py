"""Mixed precision and the error report in the port
(``dlq_tpu_torch.quant.sensitivity``, ``quant.error_report``, ``runlog``)
against the JAX package's, on the same numpy-seeded weights and inputs.

- ``site_sensitivity``: on the reference's Hessians every score equals the
  reference's (the same int codes, float64 on the host: rtol 1e-12); on the
  port's own Hessians within rtol 1e-4 (fp32 sums in another order).
- ``suggest_overrides`` / ``auto_mixed_qconfig``: the same promotions, in
  the same order, at two budgets and a ``top_k``.
- ``quant_error_report``: the port's report of its fp32 and W8A8 deploy
  taps against the reference's of its own (cosines and max_abs within 1e-4
  of each other, the same worst stage and agreements).
- A RunLogger workbook and JSONL written by each package and read by the
  other.

Size: ResNet-18 ``small_input`` at 16 px with widths 8-64, batch 4.
"""

import html
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu import runlog as JRL
from dlq_tpu.models import resnet as JR
from dlq_tpu.quant import error_report as JE
from dlq_tpu.quant import gptq as JG
from dlq_tpu.quant import model_quant as JM
from dlq_tpu.quant import sensitivity as JS
from dlq_tpu.quant.calibrate import calibrate as j_calibrate
from dlq_tpu.quant.qconfig import INT4A8_PER_CHANNEL as JW4A8
from dlq_tpu.quant.qconfig import INT8_PER_CHANNEL as JW8
from dlq_tpu_torch import runlog as TRL
from dlq_tpu_torch.models import resnet as TR
from dlq_tpu_torch.quant import error_report as TE
from dlq_tpu_torch.quant import gptq as TG
from dlq_tpu_torch.quant import sensitivity as TS
from dlq_tpu_torch.quant.calibrate import calibrate
from dlq_tpu_torch.quant.model_quant import DeployCtx, ObserveCtx, make_sites_fn, quantize_weights
from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL as TW4A8
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL as TW8

WIDTHS = (8, 16, 32, 64)


class _JaxH:
    def __init__(self, jcol):
        self.H, self.meta, self.mean = jcol.H, jcol.meta, jcol.mean


@pytest.fixture(scope="module")
def r18():
    cfg_t = TR.ResNetConfig(depth=18, num_classes=10, small_input=True, widths=WIDTHS)
    cfg_j = JR.ResNetConfig(depth=18, num_classes=10, small_input=True, widths=WIDTHS)
    flat = TR.flatten_folded(TR.fold_resnet(TR.init_resnet(4, cfg_t), cfg_t))
    jflat = {k: {n: jnp.asarray(v.numpy()) for n, v in p.items()} for k, p in flat.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (4, 16, 16, 3)).astype(np.float32)
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, flat=flat, jflat=jflat, x=x,
                x2=rng.normal(0, 1, (4, 16, 16, 3)).astype(np.float32),
                jcol=JG.collect_hessians(JR.qforward, jflat, cfg_j, [x]),
                tcol=TG.collect_hessians(TR.qforward, flat, cfg_t, [x]))


def test_site_sensitivity_matches_jax(r18):
    ref = JS.site_sensitivity(r18["jflat"], r18["jcol"], JW4A8)
    same = TS.site_sensitivity(r18["flat"], _JaxH(r18["jcol"]), TW4A8)
    own = TS.site_sensitivity(r18["flat"], r18["tcol"], TW4A8)
    assert set(same) == set(own) == set(ref) == set(r18["flat"])
    for site, r in ref.items():
        for k in ("bytes_lo", "bytes_hi", "lo_bits"):
            assert same[site][k] == own[site][k] == r[k], (site, k)
        for k in ("err_lo", "err_hi"):
            np.testing.assert_allclose(same[site][k], r[k], rtol=1e-12, err_msg=site)
            np.testing.assert_allclose(own[site][k], r[k], rtol=1e-4, err_msg=site)
    assert ref["stem"]["lo_bits"] == 8  # K = 27: the odd-K fallback
    assert TS._stored_bytes(10, TW4A8.weights) == 5 and TS._stored_bytes(10, TW8.weights) == 10


def test_overrides_and_mixed_qconfig_match_jax(r18):
    """The same promoted sites, in the same order, on either Hessians."""
    lo = sum(TS._stored_bytes(int(np.prod(p["w"].shape)),
                              TS.effective_weight_scheme(tuple(p["w"].shape), TW4A8.weights))
             for p in r18["flat"].values())
    hi = sum(int(np.prod(p["w"].shape)) for p in r18["flat"].values())
    cols = (_JaxH(r18["jcol"]), r18["tcol"])
    for budget, top_k in ((lo + (hi - lo) // 4, None), ((lo + hi) // 2, None), (None, 3)):
        ref = JS.suggest_overrides(r18["jflat"], r18["jcol"], JW4A8, budget, top_k)
        for col in cols[1:] if top_k else cols:
            got = TS.suggest_overrides(r18["flat"], col, TW4A8, budget, top_k)
            assert [s for s, _ in got] == [s for s, _ in ref], (budget, top_k)
            assert all((q.bits, q.axis) == (8, -1) for _, q in got)
        assert 0 < len(ref) < len(r18["flat"])
    mixed = TS.auto_mixed_qconfig(r18["flat"], r18["tcol"], TW4A8, budget_bytes=(lo + hi) // 2)
    jmixed = JS.auto_mixed_qconfig(r18["jflat"], r18["jcol"], JW4A8, budget_bytes=(lo + hi) // 2)
    assert [s for s, _ in mixed.weight_overrides] == [s for s, _ in jmixed.weight_overrides]
    qflat = quantize_weights(r18["flat"], mixed)
    assert sum(q["qw"].values.numel() for q in qflat.values()) <= (lo + hi) // 2


def _taps(r18):
    """(port fp32 taps fn, port W8A8 taps fn, JAX fp32 taps fn, JAX W8A8
    taps fn) over ResNet-18's ``qforward``."""
    ts = calibrate(make_sites_fn(TR.qforward, r18["cfg_t"]), r18["flat"],
                   [torch.from_numpy(r18["x"])], TW8)
    tctx = DeployCtx(quantize_weights(r18["flat"], TW8), ts, TW8)
    js = j_calibrate(JM.make_sites_fn(JR.qforward, r18["cfg_j"]), r18["jflat"],
                     [jnp.asarray(r18["x"])], JW8)
    jq = JM.quantize_weights(r18["jflat"], JW8)

    def port(ctx):
        def fn(x):
            with torch.inference_mode():
                return TR.qforward(ctx, torch.from_numpy(x), r18["cfg_t"], taps=True)
        return fn

    jfp = jax.jit(lambda f, x: JR.qforward(JM.ObserveCtx(f), x, r18["cfg_j"], taps=True))
    jdep = jax.jit(lambda q, s, x: JR.qforward(JM.DeployCtx(q, s, JW8), x, r18["cfg_j"],
                                               taps=True))
    return (port(ObserveCtx(r18["flat"])), port(tctx),
            lambda x: jfp(r18["jflat"], jnp.asarray(x)), lambda x: jdep(jq, js, jnp.asarray(x)))


def test_quant_error_report_matches_jax(r18, tmp_path):
    tf, tq, jf, jq = _taps(r18)
    batches = [r18["x"], r18["x2"]]
    got = TE.quant_error_report(tf, tq, batches,
                                logger=TRL.RunLogger(str(tmp_path / "t"), script="report.py"),
                                params_info={"model": "resnet18"})
    ref = JE.quant_error_report(jf, jq, batches)
    assert got["images"] == ref["images"] == 8
    assert set(got["stages"]) == set(ref["stages"])
    assert got["worst_stage"] == ref["worst_stage"]
    for k in ("top1_agreement", "top5_agreement"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["logits_cosine"], ref["logits_cosine"], atol=1e-4)
    for s, d in ref["stages"].items():
        for k in ("cosine", "rel_l2"):
            np.testing.assert_allclose(got["stages"][s][k], d[k], atol=1e-4, err_msg=s)
        np.testing.assert_allclose(got["stages"][s]["max_abs"], d["max_abs"],
                                   rtol=1e-2, atol=1e-4, err_msg=s)
    rows = TRL.RunLogger(str(tmp_path / "t"), script="report.py").rows()
    assert len(rows) == 1 and rows[0]["params"] == {"model": "resnet18"}
    assert rows[0]["m_top1_agreement"] == got["top1_agreement"]
    assert rows[0]["extra"] == {"worst_stage": got["worst_stage"]}
    delta = TE.labeled_accuracy_delta(np.eye(3), np.eye(3)[[0, 2, 1]], np.array([0, 1, 1]))
    assert delta == JE.labeled_accuracy_delta(np.eye(3), np.eye(3)[[0, 2, 1]],
                                              np.array([0, 1, 1]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workbook_read_by_the_other_package(tmp_path, writer):
    """A RunLogger JSONL and xlsx written by one package: rows() and
    read_xlsx_rows of the other read the same cells; the port logs tensors
    (0-dim and on any device) as numbers."""
    W, R = (TRL, JRL) if writer == "port" else (JRL, TRL)
    log = W.RunLogger(str(tmp_path), script="bench_x.py", tag="t1")
    m = {"acc": 0.5, "n": 3}
    if writer == "port":
        m["cos"] = torch.tensor(0.25)
        m["np32"] = np.float32(0.125)
    log.log(m, params={"bits": 4})
    log.log({"acc": 0.75, "n": 4, "extra_col": "x"})
    path = log.export_xlsx()
    reader = R.RunLogger(str(tmp_path), script="bench_x.py")
    rows = reader.rows()
    assert [r["m_acc"] for r in rows] == [0.5, 0.75] and rows[0]["params"] == {"bits": 4}
    if writer == "port":
        assert rows[0]["m_cos"] == 0.25 and rows[0]["m_np32"] == 0.125
    table = R.read_xlsx_rows(path)
    head = table[0]
    assert head[:4] == ["timestamp", "script", "run_id", "tag"] and "m_extra_col" in head
    assert table[1][head.index("m_acc")] == "0.5" and table[2][head.index("m_n")] == "4"
    # both writers escape inline strings; the reader returns them as stored
    assert json.loads(html.unescape(table[1][head.index("params")])) == {"bits": 4}
    assert os.path.basename(path) == "results.xlsx"
