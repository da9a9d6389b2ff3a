"""GPTQ: Hessian-aware error-compensated weight rounding, and analytic bias
correction (the counterpart of ``dlq_tpu.quant.gptq``).

``collect_hessians`` drives a model's ``qforward`` with a recording context:
at every quantized site it accumulates ``H = sum X^T X`` over the site's
inputs (conv inputs as im2col patches in the channel-major ``IHW`` column
order of ``lax.conv_general_dilated_patches``, which ``F.unfold`` on NCHW
gives), the input sums and the per-column abs-max. The products run on the
inputs' device in fp32 with TF32 off and are kept on the host in float64.

``gptq_rows``, the recursion, runs in float64 numpy/scipy on the host, the
reference's arithmetic line for line: on the same H, W and scales it gives
the same integer codes. ``gptq_quantize_weights`` is a drop-in for
``quantize_weights`` (the same QTensor, scales and packing; only the grid
assignment changes; grouped convs keep round-to-nearest), and
``bias_correct`` absorbs ``E[(W - What)^T x]`` into each bias.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch.models.common import _pair, conv2d, dense, fp32_matmul, relu
from dlq_tpu_torch.quant.qconfig import QConfig
from dlq_tpu_torch.quant.quantize import (
    QTensor, dequantize, effective_weight_scheme, pack_int4,
)

FlatParams = Dict[str, Dict[str, Any]]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def conv_patches(x: torch.Tensor, kh: int, kw: int, stride=1, padding=0) -> torch.Tensor:
    """NHWC ``x`` -> im2col rows ``[N * OH * OW, C * kh * kw]``, columns
    channel-major (``c * kh * kw + i * kw + j``), rows in NHWC output order:
    ``lax.conv_general_dilated_patches``' layout."""
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), padding=_pair(padding),
                    stride=_pair(stride))
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


class HessianCollector:
    """qforward context that runs fp32 and accumulates each quantized
    site's input Hessian (float64 on the host, IHW-ordered K for convs)."""

    def __init__(self, flat: FlatParams):
        self.flat = flat
        self.H: Dict[str, np.ndarray] = {}
        self.xsum: Dict[str, np.ndarray] = {}      # sum of inputs (for E[x])
        self.col_amax: Dict[str, np.ndarray] = {}  # per-column |x| max
        self.n: Dict[str, int] = {}
        self.meta: Dict[str, Dict[str, Any]] = {}

    def has(self, name):
        return name in self.flat

    def _accum(self, name, X2: torch.Tensor):
        """X2 ``[M, K]``: H in fp32 (TF32 off), widened to float64; the
        column sums in X2's dtype, as the reference sums them."""
        xf = X2.float()
        with fp32_matmul():
            h = _host(xf.t() @ xf).astype(np.float64)
        self.H[name] = self.H.get(name, 0.0) + h
        self.xsum[name] = self.xsum.get(name, 0.0) + _host(X2.sum(0).float()).astype(np.float64)
        self.n[name] = self.n.get(name, 0) + X2.shape[0]
        ca = _host(X2.abs().amax(0).float()).astype(np.float64)
        prev = self.col_amax.get(name)
        self.col_amax[name] = ca if prev is None else np.maximum(prev, ca)

    def mean(self, name) -> Optional[np.ndarray]:
        return (self.xsum[name] / self.n[name]) if name in self.xsum else None

    def channel_amax(self, name) -> Optional[np.ndarray]:
        """Per-input-channel abs-max from the column amax (conv columns are
        channel-major: reshape ``[C, kh * kw]`` and reduce)."""
        a = self.col_amax.get(name)
        if a is None:
            return None
        m = self.meta.get(name, {})
        if m.get("kind") == "conv":
            return a.reshape(m["cin"], -1).max(1)
        return a

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        p = self.flat[name]
        w = p["w"]
        if groups == 1:
            self._accum(name, conv_patches(x, w.shape[0], w.shape[1], stride, padding))
            self.meta[name] = {"kind": "conv", "cin": x.shape[-1]}
        else:
            self.meta[name] = {"kind": "grouped"}  # RTN fallback
        y = conv2d(x, w, stride=stride, padding=padding, groups=groups, bias=p.get("b"))
        return relu(y) if fuse_relu else y

    def dense(self, name, x, *, fuse_relu=False):
        p = self.flat[name]
        self._accum(name, x.reshape(-1, x.shape[-1]))
        self.meta[name] = {"kind": "dense"}
        y = dense(x, p["w"], p.get("b"))
        return relu(y) if fuse_relu else y


def _device_of(flat: FlatParams) -> torch.device:
    """The device of fp32 flat params."""
    return next(v for p in flat.values() for v in p.values() if v is not None).device


def _batches(batches, dev: torch.device):
    """Calibration batches (numpy or tensors) as tensors on ``dev``."""
    return [torch.as_tensor(b if isinstance(b, torch.Tensor) else np.asarray(b)).to(dev)
            for b in batches]


@torch.inference_mode()
def collect_hessians(qforward, flat: FlatParams, cfg, batches) -> HessianCollector:
    col = HessianCollector(flat)
    for x in _batches(batches, _device_of(flat)):
        qforward(col, x, cfg)
    return col


def _scales_from(base: QTensor, w_shape) -> np.ndarray:
    """Per-element scale matrix in the weight's layout, broadcast from the
    RTN QTensor's stored scales (the grid GPTQ rounds on is the grid the
    stored scale dequantizes with)."""
    s = _host(base.scale).astype(np.float64)
    K = int(np.prod(w_shape[:-1]))
    O = w_shape[-1]
    if base.group is not None:
        S2 = np.repeat(s, base.group, axis=0)  # [K//g, O] -> [K, O]
    elif base.axis is not None:
        S2 = np.broadcast_to(s.reshape(1, O), (K, O))
    else:
        S2 = np.full((K, O), float(s))
    return S2.reshape(w_shape)


def gptq_rows(W: np.ndarray, H: np.ndarray, S: np.ndarray, qmin: int, qmax: int,
              damp: float = 0.01, block: int = 128, actorder: bool = True) -> np.ndarray:
    """The GPTQ recursion on a [K, O] weight with per-element scales S, in
    float64 on the host: returns the integer grid assignment Q [K, O] int8.
    Act order is numpy's ``argsort(-diag(H))`` (dead columns' diagonal set
    to 1.0, ties broken as numpy breaks them); rank-1 error propagation
    inside each block, one product to the remainder. A diagonal H gives
    round-to-nearest."""
    import scipy.linalg as sla

    K, O = W.shape
    W = W.astype(np.float64).copy()
    H = H.astype(np.float64).copy()
    dead = np.diag(H) == 0
    if dead.any():
        H[dead, dead] = 1.0
        W[dead] = 0.0
    perm = np.argsort(-np.diag(H)) if actorder else np.arange(K)
    inv = np.argsort(perm)
    W = W[perm]
    S = S[perm]
    H = H[np.ix_(perm, perm)]
    H[np.diag_indices(K)] += damp * float(np.mean(np.diag(H)))
    U = sla.cholesky(np.linalg.inv(H), lower=False)  # Hinv = U^T U, U upper

    Q = np.zeros((K, O), np.float64)
    for b0 in range(0, K, block):
        b1 = min(b0 + block, K)
        Err = np.zeros((b1 - b0, O))
        for i in range(b0, b1):
            q = np.clip(np.round(W[i] / S[i]), qmin, qmax)
            Q[i] = q
            err = (W[i] - q * S[i]) / U[i, i]
            if i + 1 < b1:
                W[i + 1: b1] -= np.outer(U[i, i + 1: b1], err)
            Err[i - b0] = err
        if b1 < K:
            W[b1:] -= U[b0:b1, b1:].T @ Err
    return Q[inv].astype(np.int8)


def gptq_quantize_weights(flat: FlatParams, qcfg: QConfig, collector: HessianCollector,
                          damp: float = 0.01, block: int = 128,
                          actorder: bool = True) -> FlatParams:
    """Drop-in for ``quantize_weights``: the same QTensors (scales, packing,
    fallbacks) with GPTQ grid assignment wherever a Hessian was collected;
    round-to-nearest elsewhere. Values land on each weight's device."""
    from dlq_tpu_torch.quant.model_quant import quantize_weights

    rtn = quantize_weights(flat, qcfg)
    out: FlatParams = {}
    for site, p in flat.items():
        w = _host(p["w"]).astype(np.float32)
        scheme = effective_weight_scheme(w.shape, qcfg.scheme_for(site))
        H = collector.H.get(site)
        kind = collector.meta.get(site, {}).get("kind")
        if H is None or kind == "grouped":
            out[site] = rtn[site]
            continue
        base: QTensor = rtn[site]["qw"]
        S = _scales_from(base, w.shape)
        if w.ndim == 4:  # conv HWIO: H is IHW-ordered (patches layout)
            Wg = w.transpose(2, 0, 1, 3).reshape(-1, w.shape[-1])
            Sg = S.transpose(2, 0, 1, 3).reshape(Wg.shape)
            Q = gptq_rows(Wg, H, Sg, scheme.qmin, scheme.qmax, damp, block, actorder)
            kh, kw, ci, co = w.shape
            q2 = Q.reshape(ci, kh, kw, co).transpose(1, 2, 0, 3).reshape(-1, co)
        else:
            q2 = gptq_rows(w, H, S, scheme.qmin, scheme.qmax, damp, block, actorder)
        dev = base.values.device
        q_t = torch.from_numpy(np.ascontiguousarray(q2)).to(dev)
        # the baseline's storage layout: nibble-packed [K/2, O] for int4,
        # HWIO for a per-OC int8 conv, [K, O] for dense / group-wise
        values = pack_int4(q_t) if scheme.bits == 4 else q_t.reshape(base.values.shape)
        qw = QTensor(values=values, scale=base.scale, zero_point=None, bits=scheme.bits,
                     axis=base.axis, group=base.group, shape=base.shape,
                     orig_shape=base.orig_shape)
        out[site] = {"qw": qw, "b": p.get("b")}
    return out


def bias_correct(flat: FlatParams, qflat: FlatParams, collector: HessianCollector) -> FlatParams:
    """Analytic first-order bias correction: each output channel's mean
    shifts by ``E[(W - What)^T x]`` under weight quantization; absorb it
    into the bias (float64 on the host, stored fp32) from the collector's
    input means. Sites without stats (grouped convs) pass through."""
    out: FlatParams = {}
    for site, p in qflat.items():
        mu = collector.mean(site)
        kind = collector.meta.get(site, {}).get("kind")
        if mu is None or kind == "grouped":
            out[site] = p
            continue
        w = _host(flat[site]["w"]).astype(np.float64)
        qw: QTensor = p["qw"]
        wq = _host(dequantize(qw)).astype(np.float64).reshape(qw.layout_shape)
        if w.ndim == 4:  # collector mean is IHW-ordered (patches layout)
            dw2 = (w - wq).transpose(2, 0, 1, 3).reshape(-1, w.shape[-1])
        else:
            dw2 = w - wq
        delta = mu @ dw2
        b = p.get("b")
        b_new = (0.0 if b is None else _host(b).astype(np.float64)) + delta
        out[site] = {**p, "b": torch.from_numpy(np.asarray(b_new, np.float32))
                     .to(qw.values.device)}
    return out
