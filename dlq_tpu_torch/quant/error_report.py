"""Per-layer quantization-error harness (the counterpart of
``dlq_tpu.quant.error_report``): per-stage max_abs / mean_abs / cosine
between an fp32 and a quantized forward's taps, top-1 / top-5 agreement and
logits cosine over batches, persisted through ``runlog.RunLogger``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from dlq_tpu_torch import numerics
from dlq_tpu_torch.runlog import RunLogger


def quant_error_report(fp32_taps_fn: Callable[[Any], Any], q_taps_fn: Callable[[Any], Any],
                       batches, logger: Optional[RunLogger] = None,
                       params_info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run both forwards with taps over ``batches`` (``*_taps_fn: x ->
    (logits, {stage: activation})``, tensors or arrays); per shared stage the
    diff of the batch with the largest max_abs. Returns {stages,
    worst_stage, top1_agreement, top5_agreement, logits_cosine, images}."""
    report = numerics.StageReport()
    agree1, agree5, cos, n = 0.0, 0.0, 0.0, 0
    stage_accum: Dict[str, numerics.Diff] = {}
    for x in batches:
        lf, tf = fp32_taps_fn(x)
        lq, tq = q_taps_fn(x)
        lf, lq = numerics._np(lf), numerics._np(lq)
        b = len(lf)
        agree1 += numerics.top1_agreement(lq, lf) * b
        agree5 += numerics.topk_agreement(lq, lf, 5) * b
        cos += numerics.diff(lq, lf).cosine * b
        n += b
        for name in tf.keys() & tq.keys():
            d = numerics.diff(tq[name], tf[name])
            prev = stage_accum.get(name)
            if prev is None or d.max_abs > prev.max_abs:
                stage_accum[name] = d
    report.stages = stage_accum
    out = {"stages": report.to_json(), "worst_stage": report.worst(),
           "top1_agreement": agree1 / n, "top5_agreement": agree5 / n,
           "logits_cosine": cos / n, "images": n}
    if logger is not None:
        flat_metrics = {k: out[k] for k in ("top1_agreement", "top5_agreement", "logits_cosine")}
        for s, d in out["stages"].items():
            flat_metrics[f"{s}_max_abs"] = d["max_abs"]
            flat_metrics[f"{s}_cosine"] = d["cosine"]
        logger.log(flat_metrics, params=params_info, extra={"worst_stage": out["worst_stage"]})
    return out


def labeled_accuracy_delta(fp32_logits, q_logits, labels) -> Dict[str, float]:
    """With labels: absolute top-1 of both paths and their difference."""
    fp32_logits, q_logits = numerics._np(fp32_logits), numerics._np(q_logits)
    labels = numerics._np(labels)
    t1f = float(np.mean(np.argmax(fp32_logits, -1) == labels))
    t1q = float(np.mean(np.argmax(q_logits, -1) == labels))
    return {"top1_fp32": t1f, "top1_quant": t1q, "delta_top1": t1f - t1q}
