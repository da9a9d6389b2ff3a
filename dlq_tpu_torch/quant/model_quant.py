"""Whole-model PTQ and the quantized deploy contexts (the counterpart of
``dlq_tpu.quant.model_quant``).

Models define ONE ``qforward(ctx, x, cfg)``; the context decides the
arithmetic:

  ObserveCtx      fp32 compute; records each quantized op's input (calibration)
  DeployCtx       W8A8: int8 convs on K1, 1x1/s1 convs (``mm1x1``) and int8
                  dense on K2, depthwise convs on K23, W4A8 dense on K10, fp32
                  interchange; weight-only: group-wise int4 dense on K13
                  (W4A16), the rest dequantized
  DynamicDeployCtx DeployCtx with each site's activation scale computed from
                  its input at run time, on the device (no calibration)
  SimulateCtx     the fp32 fake-quant oracle: no kernel runs
  PallasDeployCtx the reference's Pallas-routed deploy path; on this card the
                  same kernels as DeployCtx
  FusedDeployCtx  int8 interchange inside blocks (requant in the epilogue,
                  relu or relu6 folded into it)
  FullFusedCtx    every inter-op tensor int8 (stem, maxpool, junctions)
  PallasBlockCtx  FullFusedCtx + identity BasicBlocks as one K3 launch and
                  identity Bottlenecks as one K4 launch

A context is built once per engine: it repacks every int8 weight K-major for
the kernels when it is constructed (a per-OC int4 dense weight stays 4-bit,
repacked for K10, and so does a group-wise int4 dense, for K13;
an int4 conv weight is unpacked to int8; a depthwise weight, HWIO
``[kh, kw, 1, C]``, is kept as its ``[kh * kw, C]`` int8 view for K23), resolves
its depthwise implementation once (``qops.resolve_depthwise``), keeps the
activation scales both as exact fp32 host values (kernel arguments,
host-side scale arithmetic) and as 0-dim device tensors (divisors of device
ops), and caches the per-site combined epilogue scales.

Not ported yet (ROADMAP.md): tensor-parallel wire routing, the
dpx/s2d/down_mm conv rewrites (a 1x1/s2 downsample runs as a direct
conv on K1, as under the reference's default ``rewrites=("mm1x1",)``), the
s2d stem.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from dlq_tpu_torch.models.common import conv2d, dense, maxpool2d, relu
from dlq_tpu_torch.ops.conv_int8 import conv_int8
from dlq_tpu_torch.ops.depthwise_int8 import PackedDepthwise, is_depthwise_weight
from dlq_tpu_torch.ops.qops import (
    bias_or_zeros, combined_scale, conv1x1_int8, dense_int, depthwise_conv,
    depthwise_weight_packed, dequant_conv2d, int_weight_packed, is_depthwise, is_mm1x1, qconv2d,
    qdense, resolve_depthwise, site_weight_packed, weight_only_packed,
)
from dlq_tpu_torch.quant.qconfig import QConfig
from dlq_tpu_torch.quant.quantize import (
    QTensor, dequantize, effective_weight_scheme, f32, fdiv, quantize_act, quantize_tensor,
)

FlatParams = Dict[str, Dict[str, Any]]  # site -> {"w": f32 | "qw": QTensor, "b": f32}


def quantize_weights(flat: FlatParams, qcfg: QConfig) -> FlatParams:
    """fp32 flat params -> quantized flat params (weights only; biases fp32).
    Conv weights (HWIO) quantize per-OC on axis -1; group-wise and int4
    weights quantize on the 2D [H*W*I, O] view."""
    out: FlatParams = {}
    for site, p in flat.items():
        w = p["w"]
        scheme = effective_weight_scheme(tuple(w.shape), qcfg.scheme_for(site))
        if scheme.group is not None or scheme.bits == 4:
            k = int(np.prod(w.shape[:-1]))
            qw = quantize_tensor(w.reshape(k, w.shape[-1]), scheme)
        else:
            qw = quantize_tensor(w, scheme)
        qw.orig_shape = tuple(w.shape)
        out[site] = {"qw": qw, "b": p.get("b")}
    return out


class ObserveCtx:
    """fp32 forward over folded params; records op inputs at ``self.sites``."""

    def __init__(self, flat: FlatParams):
        self.flat = flat
        self.sites: Dict[str, torch.Tensor] = {}

    def has(self, name):
        return name in self.flat

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        self.sites[name] = x
        p = self.flat[name]
        y = conv2d(x, p["w"], stride=stride, padding=padding, groups=groups, bias=p.get("b"))
        return relu(y) if fuse_relu else y

    def dense(self, name, x, *, fuse_relu=False):
        self.sites[name] = x
        p = self.flat[name]
        y = dense(x, p["w"], p.get("b"))
        return relu(y) if fuse_relu else y


class QAct:
    """A quantized activation traveling between ops: int8 values + scale
    (an exact fp32 value held as a Python float)."""

    def __init__(self, q: torch.Tensor, scale: float):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape


class DeployCtx:
    """W8A8 deploy with fp32 interchange: every int8 conv on K1, every int8
    dense on K2, every depthwise conv on K23 (by ``depthwise``, resolved
    once here: ``qops.resolve_depthwise``), every per-OC int4 dense on K10
    (W4A8; an int4 store read with ``int4_runtime="int8"`` arrives
    materialized to int8 and runs on K2); every group-wise int4 dense runs
    on K13 (W4A16; with activation scales, on fake-quantized activations, as
    the reference), and weight-only schemes dequantize the other sites.

    A site whose weight is ``[kh, kw, 1, C]`` (C > 1) is packed for K23; a
    groups-1 conv on such a weight (one input channel: LeNet-5's conv1) is
    packed K-major for K1 as well, at its first call (``conv_packed``)."""

    def __init__(self, qflat: FlatParams, act_scales: Optional[Dict[str, torch.Tensor]],
                 qcfg: QConfig, depthwise: Optional[str] = None):
        self.qflat = qflat
        self.act_scales = act_scales or {}
        self.qcfg = qcfg
        self.depthwise = resolve_depthwise(depthwise)
        # host fp32 values (kernel arguments, scalar math) and device
        # tensors (divisors of device ops), per calibration site
        self.scale = {k: f32(v) for k, v in self.act_scales.items()}
        self.scale_t = {k: v.float().reshape(()) for k, v in self.act_scales.items()}
        # the kernels' weights, repacked once per site
        self.packed: Dict[str, Any] = {}
        for site, p in qflat.items():
            qw = p["qw"]
            # group-wise weights take the weight-only route with or without
            # activation scales (qops.qdense)
            if qcfg.weight_only or qw.group is not None:
                pk = weight_only_packed(qw)
            elif is_depthwise_weight(tuple(qw.layout_shape)):
                pk = depthwise_weight_packed(qw)
            else:
                pk = site_weight_packed(qw)
            if pk is not None:
                self.packed[site] = pk
        self._kmajor: Dict[str, Any] = {}
        self._comb: Dict[Any, torch.Tensor] = {}
        self._bias: Dict[str, torch.Tensor] = {}

    def has(self, name):
        return name in self.qflat

    def bias(self, name: str) -> torch.Tensor:
        b = self._bias.get(name)
        if b is None:
            p = self.qflat[name]
            b = self._bias[name] = bias_or_zeros(p.get("b"), self.packed[name].oc,
                                                 p["qw"].values.device)
        return b

    def conv_packed(self, name: str, groups: int):
        """The site's packed weight for a conv with ``groups``: a groups-1
        conv on a one-input-channel weight (packed for K23 at
        construction) gets a K-major copy for K1, made once."""
        pk = self.packed.get(name)
        if groups == 1 and isinstance(pk, PackedDepthwise):
            if name not in self._kmajor:
                self._kmajor[name] = int_weight_packed(self.qflat[name]["qw"])
            pk = self._kmajor[name]
        return pk

    def comb(self, name: str, s_in: float) -> torch.Tensor:
        """fp32 [OC] s_in * w_scale for site ``name`` (cached)."""
        key = (name, s_in)
        c = self._comb.get(key)
        if c is None:
            c = self._comb[key] = combined_scale(s_in, self.qflat[name]["qw"],
                                                 self.packed[name].oc)
        return c

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        p = self.qflat[name]
        if self.qcfg.weight_only:
            return dequant_conv2d(x, p["qw"], p.get("b"), stride=stride, padding=padding,
                                  groups=groups, fuse_relu=fuse_relu)
        return qconv2d(x, p["qw"], p.get("b"), self.scale_t[name], stride=stride,
                       padding=padding, groups=groups, fuse_relu=fuse_relu,
                       act_qmax=self.qcfg.acts.qmax, packed=self.conv_packed(name, groups),
                       depthwise=self.depthwise)

    def dense(self, name, x, *, fuse_relu=False):
        p = self.qflat[name]
        if self.qcfg.weight_only:
            return qdense(x, p["qw"], p.get("b"), act_scale=None, fuse_relu=fuse_relu,
                          packed=self.packed.get(name))
        return qdense(x, p["qw"], p.get("b"), act_scale=self.scale_t[name],
                      fuse_relu=fuse_relu, act_qmax=self.qcfg.acts.qmax,
                      packed=self.packed.get(name))


class DynamicDeployCtx(DeployCtx):
    """Calibration-free W8A8 (``dlq_tpu/quant/model_quant.py:216``): each
    site's activation scale is computed from its input at run time,
    ``max(amax(|x|) / qmax, 1e-12)``, then the site runs as under DeployCtx
    (K1, K2, K23, K10) with that scale. fp32 interchange only.

    The scale stays on the device: one ``aminmax`` pass reads the input
    (``max(|x|) == max(max(x), -min(x))`` exactly), and ``/ qmax`` is a
    multiply by the fp32 reciprocal of qmax, held as a device tensor: the
    reference's engine jits this function, and XLA folds the division by
    the constant into that multiply (eager JAX divides; ROADMAP.md C). No
    host value is read, so a forward makes no synchronizing call."""

    def __init__(self, qflat: FlatParams, qcfg: QConfig, depthwise: Optional[str] = None):
        super().__init__(qflat, {}, qcfg, depthwise=depthwise)
        dev = next(iter(qflat.values()))["qw"].values.device
        self.inv_qmax = torch.tensor(np.float32(1.0) / np.float32(qcfg.acts.qmax), device=dev)

    def act_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The 0-dim fp32 device scale of activation ``x``."""
        lo, hi = torch.aminmax(x.float())
        return torch.clamp_min(torch.maximum(hi, -lo) * self.inv_qmax, 1e-12)

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        p = self.qflat[name]
        return qconv2d(x, p["qw"], p.get("b"), self.act_scale(x), stride=stride,
                       padding=padding, groups=groups, fuse_relu=fuse_relu,
                       act_qmax=self.qcfg.acts.qmax, packed=self.conv_packed(name, groups),
                       depthwise=self.depthwise)

    def dense(self, name, x, *, fuse_relu=False):
        p = self.qflat[name]
        return qdense(x, p["qw"], p.get("b"), act_scale=self.act_scale(x),
                      fuse_relu=fuse_relu, act_qmax=self.qcfg.acts.qmax,
                      packed=self.packed.get(name))


class SimulateCtx:
    """The fp32 fake-quant oracle (``dlq_tpu/quant/model_quant.py:246``):
    each site's input quantized to int8 with its static scale and
    dequantized, the weight dequantized, then a float conv or dense (TF32
    off). No kernel runs. The dequantized weights are made once per site."""

    def __init__(self, qflat: FlatParams, act_scales: Optional[Dict[str, torch.Tensor]],
                 qcfg: QConfig):
        self.qflat = qflat
        self.act_scales = act_scales or {}
        self.qcfg = qcfg
        self.scale_t = {k: v.float().reshape(()) for k, v in self.act_scales.items()}
        self._w: Dict[str, torch.Tensor] = {}

    def has(self, name):
        return name in self.qflat

    def weight(self, name: str) -> torch.Tensor:
        w = self._w.get(name)
        if w is None:
            qw: QTensor = self.qflat[name]["qw"]
            w = self._w[name] = dequantize(qw).reshape(qw.layout_shape)
        return w

    def _fake_act(self, name, x):
        if self.qcfg.weight_only:
            return x.float()
        s = self.scale_t[name]
        return quantize_act(x, s, self.qcfg.acts.qmax).float() * s

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        y = conv2d(self._fake_act(name, x), self.weight(name), stride=stride, padding=padding,
                   groups=groups, bias=self.qflat[name].get("b"))
        return relu(y) if fuse_relu else y

    def dense(self, name, x, *, fuse_relu=False):
        y = dense(self._fake_act(name, x), self.weight(name), self.qflat[name].get("b"))
        return relu(y) if fuse_relu else y


class PallasDeployCtx(DeployCtx):
    """The reference's Pallas-routed W8A8 deploy context (``ctx="pallas"``).

    On this card it is the same as DeployCtx: DeployCtx already sends every
    int8 conv through K1 (the port of ``int8_conv3x3_s1``) and every dense
    through K2 (the port of ``int8_matmul``), with the same int32
    accumulation and fp32 epilogue."""


class FusedDeployCtx(DeployCtx):
    """W8A8 with int8 interchange: a conv given ``out_site`` requantizes its
    output to that site's calibrated scale in the kernel epilogue and
    returns a QAct; without ``out_site`` it returns fp32. A 1x1/s1 conv runs
    on K2 (the reference's ``mm1x1``, ``model_quant.py:403-430``), a
    depthwise conv on K23, every other conv on K1. ``fuse_relu6`` clips y to
    [0, 6] before the requant divides (the int8 clip's lower bound is then
    0), as the reference's ``:420-426``; without ``out_site`` the result is
    fp32 ``clip(y, 0, 6)``."""

    def __init__(self, qflat, act_scales, qcfg, depthwise: Optional[str] = None):
        super().__init__(qflat, act_scales, qcfg, depthwise=depthwise)
        if qcfg.weight_only or qcfg.acts.qmax != 127:
            raise NotImplementedError("int8 interchange needs 8-bit activations")

    def quant(self, site: str, y: torch.Tensor) -> QAct:
        return QAct(quantize_act(y, self.scale_t[site], self.qcfg.acts.qmax), self.scale[site])

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False,
             fuse_relu6=False, out_site: Optional[str] = None):
        qw = self.qflat[name]["qw"]
        if groups != 1 and not is_depthwise(qw, groups):
            raise NotImplementedError(
                f"grouped int8 conv with groups={groups} on a {tuple(qw.layout_shape)} weight: "
                "only depthwise convs (groups == C, [kh, kw, 1, C]) are ported")
        if isinstance(x, QAct):
            xq, s_in = x.q, x.scale
        else:
            s_in = self.scale[name]
            xq = quantize_act(x, self.scale_t[name], self.qcfg.acts.qmax)
        out_scale = None if out_site is None else self.scale[out_site]
        pk = self.conv_packed(name, groups)
        if groups != 1:
            y = depthwise_conv(xq, pk, stride, padding, self.comb(name, s_in), self.bias(name),
                               self.depthwise, relu=fuse_relu, relu6=fuse_relu6,
                               out_scale=out_scale)
            return y if out_site is None else QAct(y, out_scale)
        if is_mm1x1(pk, stride, padding):
            y = conv1x1_int8(xq, pk, self.comb(name, s_in), self.bias(name), relu=fuse_relu,
                             out_scale=out_scale, relu6=fuse_relu6)
        else:
            y = conv_int8(xq, pk, stride, padding, self.comb(name, s_in), self.bias(name),
                          relu=fuse_relu, out_scale=out_scale, relu6=fuse_relu6)
        return y if out_site is None else QAct(y, out_scale)

    def add(self, a: QAct, b: QAct) -> QAct:
        """a + b in the int domain (no relu); both at the same scale."""
        qmax = self.qcfg.acts.qmax
        acc = a.q.to(torch.int32) + b.q.to(torch.int32)
        return QAct(torch.clamp(acc, -qmax, qmax).to(torch.int8), a.scale)

    def dense(self, name, x, *, fuse_relu=False):
        if isinstance(x, QAct):
            # int8 GEMM straight on the already-quantized activation
            lead = x.q.shape[:-1]
            y = dense_int(x.q.reshape(-1, x.q.shape[-1]), self.packed[name],
                          self.comb(name, x.scale), self.bias(name), relu=fuse_relu)
            return y.reshape(lead + (y.shape[-1],))
        return super().dense(name, x, fuse_relu=fuse_relu)


class FullFusedCtx(FusedDeployCtx):
    """Fully-int8 interchange: every inter-op tensor is int8, including the
    stem->maxpool chain and the residual junctions, which add in the int
    domain at the consumer's scale (TFLite-style shared-scale adds)."""

    def requant(self, x: QAct, site: str) -> QAct:
        """int8 -> int8 rescale to another site's scale: round(q * (s_in / s_out))."""
        s_out = self.scale[site]
        qmax = self.qcfg.acts.qmax
        r = float(np.float32(x.scale) / np.float32(s_out))
        q = torch.clamp(torch.round(x.q.to(torch.float32) * r), -qmax, qmax)
        return QAct(q.to(torch.int8), s_out)

    def add_relu(self, a: QAct, b: QAct) -> QAct:
        """relu(a + b) in the int domain; both addends share a scale."""
        acc = a.q.to(torch.int32) + b.q.to(torch.int32)
        return QAct(torch.clamp(acc, 0, self.qcfg.acts.qmax).to(torch.int8), a.scale)

    def maxpool(self, x: QAct, window=3, stride=2, padding=1) -> QAct:
        return QAct(maxpool2d(x.q, window, stride, padding), x.scale)

    def conv_stem_bf16(self, name: str, x: torch.Tensor, *, out_site: str,
                       stride=2, padding=3) -> QAct:
        """Mixed-precision stem: bf16 operands (dequantized int8 weights),
        fp32 accumulation and fp32 output, bias, then the int8 requant with
        relu folded into the clip. Computed as an fp32 conv (TF32 off) of the
        bf16-rounded operands: a bf16 conv on CUDA would round its output."""
        qw: QTensor = self.qflat[name]["qw"]
        w = dequantize(qw).reshape(qw.layout_shape).to(torch.bfloat16).float()
        return self._stem(name, x.to(torch.bfloat16).float(), w, out_site, stride, padding)

    def conv_stem_bf16_u8(self, name: str, u8: torch.Tensor, *, out_site: str, mean=None,
                          std=None, stride=2, padding=3) -> QAct:
        """uint8 image ingest with the preprocess fold
        (``dlq_tpu/quant/model_quant.py:581``): the dequantized stem weight
        times ``1 / (255 std)`` along I in fp32, rounded to bf16, against
        ``u - bf16(255 mean)`` unrounded, as the jitted reference
        (``preprocess.fold_u8``; zero padding of the shifted image is zero
        padding of the normalized one); then as ``conv_stem_bf16``."""
        from dlq_tpu_torch.preprocess import fold_u8

        qw: QTensor = self.qflat[name]["qw"]
        w, xb = fold_u8(dequantize(qw).reshape(qw.layout_shape), u8, mean, std)
        return self._stem(name, xb, w, out_site, stride, padding)

    def _stem(self, name: str, xb: torch.Tensor, w: torch.Tensor, out_site: str, stride,
              padding) -> QAct:
        """fp32 conv (TF32 off) of bf16-valued operands, bias, int8 requant
        to ``out_site``'s scale with relu folded into the clip."""
        y = conv2d(xb, w, stride=stride, padding=padding)
        b = self.qflat[name].get("b")
        if b is not None:
            y = y + b
        q = torch.clamp(torch.round(fdiv(y, self.scale_t[out_site])), 0.0, self.qcfg.acts.qmax)
        return QAct(q.to(torch.int8), self.scale[out_site])

    def gap_dense(self, name: str, x: QAct) -> torch.Tensor:
        """int32 global-average pool + quantized fc on the pooled vector."""
        acc = x.q.sum(dim=(1, 2), dtype=torch.int32)
        hw = x.q.shape[1] * x.q.shape[2]
        g = acc.to(torch.float32) * float(np.float32(x.scale) / np.float32(hw))
        return self.dense(name, g)


class PallasBlockCtx(FullFusedCtx):
    """FullFusedCtx + one kernel per identity residual block: blocks present
    in ``block_packs`` (``ops.block_fused.pack_fused_blocks``) run as K3
    (BasicBlock) or K4 (Bottleneck, a pack with ``"w3"``) — conv chain,
    requants, int8 residual add and relu; everything else falls through to
    FullFusedCtx."""

    def __init__(self, qflat, act_scales, qcfg, block_packs=None):
        super().__init__(qflat, act_scales, qcfg)
        self.block_packs = block_packs or {}

    def fused_block(self, site: str, x: QAct, nxt: Optional[str]):
        """Run ``site``'s whole residual block fused if packed; else None."""
        from dlq_tpu_torch.ops.block_fused import basic_block_fused, bottleneck_block_fused

        pack = self.block_packs.get(site)
        if pack is None or nxt is None:
            return None
        fn = bottleneck_block_fused if "w3" in pack else basic_block_fused
        return QAct(fn(x.q, pack), self.scale[nxt])


def make_sites_fn(qforward: Callable, cfg) -> Callable:
    """(flat_params, x) -> {site: input activation}, for ``calibrate``."""

    def sites_fn(flat: FlatParams, x):
        ctx = ObserveCtx(flat)
        qforward(ctx, x, cfg)
        return ctx.sites

    return sites_fn
