"""One-call PTQ recipe composing the toolbox (the counterpart of
``dlq_tpu.quant.recipe``):

    SmoothQuant (auto-alpha) -> GPTQ on the smoothed model ->
    analytic bias correction -> act-scale calibration on smoothed inputs

The stage order is the point: GPTQ Hessians and activation scales are
measured on the smoothed inputs ``x / s``, and bias correction takes the
smoothed fp32 weights as its reference.

    qflat, scales, smooth = ptq_auto(qforward, flat, cfg, batches, qcfg)
    ctx = SmoothDeployCtx(qflat, scales, qcfg, smooth)   # or DeployCtx if
    logits = qforward(ctx, x, cfg)                       # smooth == {}
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dlq_tpu_torch.quant.gptq import (
    HessianCollector, _batches, _device_of, bias_correct as _bias_correct, gptq_quantize_weights,
)
from dlq_tpu_torch.quant.model_quant import FlatParams, quantize_weights
from dlq_tpu_torch.quant.qconfig import QConfig
from dlq_tpu_torch.quant.smooth import (
    _SmoothMixin, apply_smooth, collect_channel_amax, compute_smooth, search_smooth_alpha,
    smooth_calibrate,
)


class SmoothHessianCollector(_SmoothMixin, HessianCollector):
    """Hessians of the smoothed inputs (``x / s``): what GPTQ must see when
    the deployed model runs under a Smooth* context."""

    def __init__(self, flat, smooth):
        super().__init__(flat)
        self._set_smooth(smooth)


def ptq_auto(qforward, flat: FlatParams, cfg, batches, qcfg: QConfig, smooth: str = "auto",
             gptq: bool = True, bias_correct: bool = True,
             smooth_site_filter=None) -> Tuple[FlatParams, Dict[str, Any], Dict[str, Any]]:
    """Returns (qflat, act_scales, smooth_vectors). ``smooth``: "auto" (the
    global alpha search), "fixed" (alpha 0.5) or "off"; weight-only configs
    never smooth. Deploy with ``SmoothDeployCtx(qflat, act_scales, qcfg,
    smooth_vectors)``; an empty smooth dict makes that DeployCtx.
    ``smooth_site_filter(name) -> bool`` restricts smoothing (e.g.
    ``VIT_LN_FOLDABLE``, so the result deploys through the block kernels)."""
    batches = _batches(list(batches), _device_of(flat))
    sm: Dict[str, Any] = {}
    if smooth != "off" and not qcfg.weight_only:
        if smooth == "auto":
            sm, _ = search_smooth_alpha(qforward, flat, cfg, batches, qcfg,
                                        site_filter=smooth_site_filter)
        else:
            amax = collect_channel_amax(qforward, flat, cfg, batches)
            sm = compute_smooth(flat, amax)
            if smooth_site_filter is not None:
                sm = {k: v for k, v in sm.items() if smooth_site_filter(k)}
    flat_s = apply_smooth(flat, sm) if sm else flat

    col = None
    if gptq or bias_correct:
        col = SmoothHessianCollector(flat_s, sm)
        with torch.inference_mode():
            for x in batches:
                qforward(col, x, cfg)

    qflat = gptq_quantize_weights(flat_s, qcfg, col) if gptq else quantize_weights(flat_s, qcfg)
    if bias_correct:
        qflat = _bias_correct(flat_s, qflat, col)

    scales = None
    if not qcfg.weight_only:
        scales = smooth_calibrate(qforward, flat_s, cfg, batches, qcfg, sm)
    return qflat, scales, sm


def VIT_LN_FOLDABLE(site: str) -> bool:
    """ViT sites whose smoothing vector folds exactly into the preceding
    LayerNorm's affine: qkv (after ln1) and fc1 (after ln2)."""
    return site.endswith(".qkv") or site.endswith(".fc1")
