"""Per-site quantization sensitivity and automatic mixed precision (the
counterpart of ``dlq_tpu.quant.sensitivity``).

Each site's expected layer-output damage is ``tr(dW^T H dW)`` with the
calibration Hessian (GPTQ's objective), in float64 on the host; the sites
with the most damage saved per extra byte are promoted to int8 until a
weight-byte budget is met. The output is a ``QConfig.weight_overrides``
tuple, which ``quantize_weights``, QAT and the store read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch.quant.gptq import _host
from dlq_tpu_torch.quant.model_quant import FlatParams
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme
from dlq_tpu_torch.quant.quantize import dequantize, effective_weight_scheme, quantize_tensor


def _stored_bytes(n: int, scheme: QScheme) -> int:
    """Storage of n weight values: int4 nibble-packs (n/2 bytes); int8 and
    int2 store full bytes."""
    return n // 2 if scheme.bits == 4 else n


def _site_err(w: np.ndarray, H: np.ndarray, scheme: QScheme) -> float:
    """``tr(dW^T H dW)`` for quantizing w under scheme (H in IHW order for
    convs, as ``gptq.HessianCollector`` collects it), in float64: ``H @ dW``
    by BLAS, then the elementwise sum (the reference's three-operand
    ``einsum`` is the same trace, summed in another order)."""
    K = int(np.prod(w.shape[:-1]))
    O = w.shape[-1]
    qt = quantize_tensor(torch.from_numpy(np.ascontiguousarray(w.reshape(K, O), np.float32)),
                         scheme)
    dW = w.astype(np.float64).reshape(K, O) - _host(dequantize(qt)).astype(np.float64)
    if w.ndim == 4:  # reorder HWI rows -> IHW to match H
        kh, kw, ci, co = w.shape
        dW = dW.reshape(kh, kw, ci, co).transpose(2, 0, 1, 3).reshape(K, O)
    return float(np.einsum("ko,ko->", dW, H @ dW))


def site_sensitivity(flat: FlatParams, collector, qcfg: QConfig,
                     hi_scheme: Optional[QScheme] = None) -> Dict[str, Dict[str, float]]:
    """Per site: expected output error under the config's (low) scheme and
    under the int8 promotion target, and the byte cost of each."""
    hi = hi_scheme or QScheme(8, True, -1)
    out: Dict[str, Dict[str, float]] = {}
    for site, p in flat.items():
        H = collector.H.get(site)
        if H is None:
            continue
        w = _host(p["w"]).astype(np.float32)
        lo = effective_weight_scheme(w.shape, qcfg.scheme_for(site))
        hi_eff = effective_weight_scheme(w.shape, hi)
        n = int(np.prod(w.shape))
        out[site] = {"err_lo": _site_err(w, H, lo), "err_hi": _site_err(w, H, hi_eff),
                     "bytes_lo": _stored_bytes(n, lo), "bytes_hi": n, "lo_bits": lo.bits}
    return out


def suggest_overrides(flat: FlatParams, collector, qcfg: QConfig,
                      budget_bytes: Optional[int] = None,
                      top_k: Optional[int] = None) -> Tuple[Tuple[str, QScheme], ...]:
    """Greedy promotion: sites ranked by (damage removed) / (bytes added),
    promoted to int8 until the weight-byte budget (or ``top_k``) is spent.
    Returns a weight_overrides tuple."""
    sens = site_sensitivity(flat, collector, qcfg)
    cands = []
    for site, s in sens.items():
        if s["lo_bits"] >= 8:
            continue
        gain = s["err_lo"] - s["err_hi"]
        extra = max(s["bytes_hi"] - s["bytes_lo"], 1)
        cands.append((gain / extra, site, extra))
    cands.sort(reverse=True)
    # the baseline over every site (sites without a Hessian count too)
    total = sum(_stored_bytes(int(np.prod(p["w"].shape)),
                              effective_weight_scheme(tuple(p["w"].shape), qcfg.scheme_for(site)))
                for site, p in flat.items())
    chosen = []
    for ratio, site, extra in cands:
        if ratio <= 0:
            break
        if top_k is not None and len(chosen) >= top_k:
            break
        if budget_bytes is not None and total + extra > budget_bytes:
            continue
        total += extra
        chosen.append(site)
    return tuple((site, QScheme(8, True, -1)) for site in chosen)


def auto_mixed_qconfig(flat, collector, qcfg: QConfig, budget_bytes: Optional[int] = None,
                       top_k: Optional[int] = None) -> QConfig:
    """qcfg with the suggested int8 promotions installed."""
    ov = suggest_overrides(flat, collector, qcfg, budget_bytes, top_k)
    return dataclasses.replace(qcfg, weight_overrides=ov + tuple(qcfg.weight_overrides))
