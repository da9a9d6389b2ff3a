"""Activation calibration: fit per-site static scales from fp32 batches
(the counterpart of ``dlq_tpu.quant.calibrate``).

Methods:
  minmax      running abs-max
  percentile  running max of per-batch |x| quantiles (clips outliers)
  mse         grid-search the clip ratio minimizing int8 quantization MSE
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from dlq_tpu_torch.quant.qconfig import QConfig
from dlq_tpu_torch.quant.quantize import fdiv

Stats = Dict[str, torch.Tensor]

_MSE_GRID = np.linspace(0.3, 1.0, 15).astype(np.float32)


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of a 1-D tensor (``torch.quantile``
    refuses inputs above 2^24 elements)."""
    s = torch.sort(a).values
    pos = q * (s.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    frac = float(np.float32(pos - lo))
    return s[lo] + (s[hi] - s[lo]) * frac


def _batch_stat(x: torch.Tensor, method: str, percentile: float) -> torch.Tensor:
    a = x.to(torch.float32).abs().reshape(-1)
    if method == "minmax":
        return a.max()
    if method == "percentile":
        return _quantile(a, percentile / 100.0)
    if method == "mse":
        amax = a.max()
        errs = []
        for ratio in _MSE_GRID:
            s = torch.clamp_min(fdiv(amax * float(ratio), 127.0), 1e-12)
            q = torch.clamp(torch.round(fdiv(a, s)), -127, 127) * s
            errs.append(torch.mean((q - a) ** 2))
        best = int(torch.argmin(torch.stack(errs)))
        return amax * float(_MSE_GRID[best])
    raise ValueError(f"unknown calibration method {method}")


def merge_stats(running: Optional[Stats], batch: Stats) -> Stats:
    """Running max of per-batch stats (the largest clip any batch wanted)."""
    if running is None:
        return dict(batch)
    return {k: torch.maximum(running[k], v) for k, v in batch.items()}


@torch.inference_mode()
def calibrate(
    sites_fn: Callable[..., Dict[str, torch.Tensor]],
    params,
    batches: Iterable[torch.Tensor],
    qcfg: QConfig,
) -> Dict[str, torch.Tensor]:
    """Run the calibration set through the model, return {site: act_scale}
    (0-dim fp32 tensors on the params' device)."""
    running: Optional[Stats] = None
    n = 0
    for x in batches:
        sites = sites_fn(params, x)
        stats = {k: _batch_stat(v, qcfg.calibration, qcfg.percentile) for k, v in sites.items()}
        running = merge_stats(running, stats)
        n += 1
    if not n:
        raise ValueError("empty calibration set")
    qmax = qcfg.acts.qmax if qcfg.acts is not None else 127
    return {k: torch.clamp_min(fdiv(v, qmax), 1e-12) for k, v in running.items()}
