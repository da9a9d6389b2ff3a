"""SmoothQuant: per-input-channel activation-outlier migration (the
counterpart of ``dlq_tpu.quant.smooth``).

Each quantized site gets factors ``s_j = amax_act_j^alpha /
amax_w_j^(1 - alpha)`` and computes ``y = (x / s) (s W)``: the weights
absorb the outliers offline, the activations flatten so a per-tensor int8
scale fits. Pipeline: ``collect_channel_amax`` -> ``compute_smooth`` ->
``apply_smooth`` -> calibrate the smoothed model (``smooth_calibrate``) ->
deploy with ``SmoothDeployCtx``, or, for the LN-foldable ViT sites, fold
the vectors into the LayerNorm affines (``fold_smooth_into_ln_extras``)
and deploy through any path with no runtime divide.

The runtime ``x / s`` is ``x * (1 / s)``: the fp32 reciprocal, then a
multiply, as the reference computes it. The ``Smooth*`` contexts are the
port's contexts with ``_SmoothMixin`` first in the MRO.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dlq_tpu_torch.ops.vit_block import check_smooth_foldable, inverse_smooth, smooth_folded_ln
from dlq_tpu_torch.quant.gptq import _batches, _device_of, _host
from dlq_tpu_torch.quant.model_quant import DeployCtx, FlatParams, ObserveCtx, SimulateCtx
from dlq_tpu_torch.quant.qat import QATCtx


class ChannelAmaxCollector:
    """fp32 forward recording the per-input-channel abs-max at every site
    (channels: the last input axis of both NHWC conv and [.., K] dense)."""

    def __init__(self, flat: FlatParams):
        self._obs = ObserveCtx(flat)
        self.amax: Dict[str, np.ndarray] = {}

    def has(self, name):
        return self._obs.has(name)

    def _record(self, name, x):
        a = _host(x.abs().amax(dim=tuple(range(x.ndim - 1))).float())
        prev = self.amax.get(name)
        self.amax[name] = a if prev is None else np.maximum(prev, a)

    def conv(self, name, x, **kw):
        self._record(name, x)
        return self._obs.conv(name, x, **kw)

    def dense(self, name, x, **kw):
        self._record(name, x)
        return self._obs.dense(name, x, **kw)


@torch.inference_mode()
def collect_channel_amax(qforward, flat: FlatParams, cfg, batches) -> Dict[str, np.ndarray]:
    col = ChannelAmaxCollector(flat)
    for x in _batches(batches, _device_of(flat)):
        qforward(col, x, cfg)
    return col.amax


def compute_smooth(flat: FlatParams, act_amax: Dict[str, np.ndarray],
                   alpha: float = 0.5) -> Dict[str, np.ndarray]:
    """Per-site smoothing vectors ``s [C_in]`` (float64 pow, stored fp32).
    Sites without stats, or grouped convs (the weight's I is 1), are
    skipped."""
    out: Dict[str, np.ndarray] = {}
    for site, a in act_amax.items():
        w = _host(flat[site]["w"]).astype(np.float32)
        cin = w.shape[-2]
        if a.shape[-1] != cin:
            continue
        red = tuple(i for i in range(w.ndim) if i != w.ndim - 2)
        wmax = np.abs(w).max(axis=red)
        a = np.maximum(a.astype(np.float64), 1e-5)
        wmax = np.maximum(wmax.astype(np.float64), 1e-5)
        s = (a ** alpha) / (wmax ** (1.0 - alpha))
        out[site] = np.clip(s, 1e-5, 1e5).astype(np.float32)
    return out


def apply_smooth(flat: FlatParams, smooth: Dict[str, Any]) -> FlatParams:
    """Exact offline rebalance ``W'[.., j, :] = s_j W[.., j, :]`` (fp32); the
    matching ``x / s`` happens at run time in the ``Smooth*`` contexts."""
    out: FlatParams = {}
    for site, p in flat.items():
        s = smooth.get(site)
        if s is None:
            out[site] = p
            continue
        w = p["w"]
        shape = [1] * w.ndim
        shape[-2] = -1
        st = torch.from_numpy(np.asarray(_host(s), np.float32)).to(w.device)
        out[site] = {**p, "w": w * st.reshape(shape)}
    return out


class _SmoothMixin:
    """Applies ``x * (1 / s)`` before the underlying context's
    quantize-and-compute. A bf16 ``x`` against the fp32 reciprocal gives
    fp32, as in the reference."""

    def _set_smooth(self, smooth: Optional[Dict[str, Any]]):
        self.smooth = {k: inverse_smooth(v) for k, v in (smooth or {}).items()}
        self._inv_t: Dict[Any, torch.Tensor] = {}

    def _smoothed(self, name, x):
        inv = self.smooth.get(name)
        if inv is None:
            return x
        key = (name, x.device)
        t = self._inv_t.get(key)
        if t is None:
            t = self._inv_t[key] = torch.from_numpy(inv).to(x.device)
        shape = [1] * x.ndim
        shape[-1] = -1
        return x * t.reshape(shape)

    def conv(self, name, x, **kw):
        return super().conv(name, self._smoothed(name, x), **kw)

    def dense(self, name, x, **kw):
        return super().dense(name, self._smoothed(name, x), **kw)


class SmoothObserveCtx(_SmoothMixin, ObserveCtx):
    """Observe pass over the smoothed model (``x / s`` inputs): what
    calibration must see so the activation scales match deployment."""

    def __init__(self, flat, smooth):
        super().__init__(flat)
        self._set_smooth(smooth)


class SmoothDeployCtx(_SmoothMixin, DeployCtx):
    def __init__(self, qflat, act_scales, qcfg, smooth, depthwise: Optional[str] = None):
        super().__init__(qflat, act_scales, qcfg, depthwise=depthwise)
        self._set_smooth(smooth)


class SmoothSimulateCtx(_SmoothMixin, SimulateCtx):
    def __init__(self, qflat, act_scales, qcfg, smooth):
        super().__init__(qflat, act_scales, qcfg)
        self._set_smooth(smooth)


class SmoothQATCtx(_SmoothMixin, QATCtx):
    """QAT of a smoothed model: the same ``x / s`` the deploy context
    applies. Train on ``apply_smooth``ed params; deploy via
    SmoothDeployCtx."""

    def __init__(self, flat, act_scales, qcfg, smooth):
        super().__init__(flat, act_scales, qcfg)
        self._set_smooth(smooth)


def fold_smooth_into_ln_extras(extras: Dict[str, Any],
                               smooth: Dict[str, Any]) -> Dict[str, Any]:
    """Fold LN-foldable smoothing vectors into a ViT's LayerNorm affines:
    ln1 <- (g / s_qkv, b / s_qkv), ln2 <- (g / s_fc1, b / s_fc1), each as
    ``g * (1 / s)`` in fp32. A store written with the folded extras and the
    smoothed weights deploys the smoothed model through every path with no
    ``SmoothDeployCtx``. Vectors of other sites raise
    (``ops.vit_block.check_smooth_foldable``)."""
    check_smooth_foldable(smooth)
    out = dict(extras)
    out["ln"] = [smooth_folded_ln(ln, smooth, i) for i, ln in enumerate(extras["ln"])]
    return out


def smooth_calibrate(qforward, flat_smoothed: FlatParams, cfg, batches, qcfg,
                     smooth: Dict[str, Any]):
    """calibrate() over the smoothed model: per-site per-tensor activation
    scales measured on the ``x / s`` inputs."""
    from dlq_tpu_torch.quant.calibrate import calibrate

    def sites_fn(fp, x):
        ctx = SmoothObserveCtx(fp, smooth)
        qforward(ctx, x, cfg)
        return ctx.sites

    return calibrate(sites_fn, flat_smoothed, _batches(batches, _device_of(flat_smoothed)),
                     qcfg)


def search_smooth_alpha(qforward, flat: FlatParams, cfg, batches, qcfg,
                        alphas=(0.0, 0.25, 0.4, 0.5, 0.6, 0.75), site_filter=None):
    """Global empirical alpha search: quantize the whole model per
    candidate alpha and score the deployed forward on held-out calibration
    data (the last batch, or the second half of a single batch) against
    fp32 by relative L2; the first alpha with the least error wins (a
    strict ``<``, so a tie keeps the earlier one). ``site_filter`` restricts
    smoothing inside the search. Returns (smooth vectors, alpha); ``{}``
    when alpha 0 wins."""
    from dlq_tpu_torch.quant.model_quant import quantize_weights

    batches = _batches(batches, _device_of(flat))
    if len(batches) >= 2:
        cal, hold = batches[:-1], batches[-1]
    else:
        b = batches[0]
        half = max(1, b.shape[0] // 2)
        cal, hold = [b[:half]], b[half:] if b.shape[0] > 1 else b
    with torch.inference_mode():
        ref = _host(qforward(ObserveCtx(flat), hold, cfg).float()).astype(np.float32)
    amax = collect_channel_amax(qforward, flat, cfg, cal)

    best = (np.inf, {}, 0.0)
    for alpha in alphas:
        sm = compute_smooth(flat, amax, alpha=alpha) if alpha > 0 else {}
        if sm and site_filter is not None:
            sm = {k: v for k, v in sm.items() if site_filter(k)}
        flat_s = apply_smooth(flat, sm) if sm else flat
        scales = smooth_calibrate(qforward, flat_s, cfg, cal, qcfg, sm)
        qflat = quantize_weights(flat_s, qcfg)
        with torch.inference_mode():
            dep = _host(qforward(SmoothDeployCtx(qflat, scales, qcfg, sm), hold, cfg).float())
        err = float(np.linalg.norm(dep - ref) / (np.linalg.norm(ref) + 1e-12))
        if err < best[0]:
            best = (err, sm, alpha)
    return best[1], best[2]
