"""Quantization-aware training (the counterpart of ``dlq_tpu.quant.qat``):
straight-through-estimator fake-quant fine-tuning on torch autograd.

``QATCtx`` has the qforward context surface (``has`` / ``conv`` / ``dense``),
so any model's single ``qforward`` trains under fake quantization. Weights
fake-quantize from their live fp32 values each step (scales recomputed,
stop-gradient) under the scheme they will deploy with; gradients pass
straight through inside the clip range and are zero outside it (clipped
STE). Activation scales are EMA state updated from each batch's amax.

The arithmetic is the reference's jitted step's: XLA turns a division by a
constant (``/ qmax``) into a multiply by its fp32 reciprocal and contracts
``a * b + c * d`` into one fused multiply-add, so the port multiplies by the
fp32 reciprocal and writes the SGD and EMA updates as ``torch.addcmul``.
On the card the step's convs and matmuls, forward and backward, run with
TF32 off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch.models.common import conv2d, dense, fp32_conv, fp32_matmul, relu
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme
from dlq_tpu_torch.quant.quantize import effective_weight_scheme

FlatParams = Dict[str, Dict[str, Any]]


def _inv(q: int) -> float:
    """The fp32 reciprocal of an integer, as a Python float."""
    return float(np.float32(1.0) / np.float32(q))


def fake_quant_ste(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric fake-quant with clipped straight-through gradients.

    Forward: ``x + (q - x)`` inside ``|x| <= qmax * scale`` (an fp32 sum,
    not always bitwise ``q``) and ``q`` outside, where ``q = scale *
    clip(round(x / scale), -qmax, qmax)``; backward: 1 inside, 0 outside.
    The scale is stop-gradient."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device).detach()
    # JAX promotes by dtype at any rank: a bf16 x against the fp32 scale
    # computes in fp32 (torch would keep bf16 against a 0-dim scale)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    inside = x.abs() <= qmax * scale
    return torch.where(inside, x + (q - x).detach(), q.detach())


def _weight_fq(w: torch.Tensor, scheme: QScheme) -> torch.Tensor:
    """Fake-quant a weight under the scheme it deploys with
    (``effective_weight_scheme``'s odd-K and group fallbacks): group-wise
    amax over the C-order ``[K // g, g, O]`` view, per-axis or per-tensor,
    ``max(amax / qmax, 1e-12)`` with the division as the jitted reference's
    multiply by the fp32 reciprocal."""
    scheme = effective_weight_scheme(tuple(w.shape), scheme)
    a = w.detach().abs()
    r = _inv(scheme.qmax)
    if scheme.group is not None:
        O = w.shape[-1]
        K = w.numel() // O
        g = scheme.group
        amax = a.reshape(K // g, g, O).amax(dim=1, keepdim=True)
        s = amax.expand(K // g, g, O).reshape(w.shape)
        scale = torch.clamp_min(s * r, 1e-12)
    elif scheme.axis is not None:
        axis = scheme.axis % w.ndim
        red = tuple(i for i in range(w.ndim) if i != axis)
        scale = torch.clamp_min(a.amax(dim=red, keepdim=True) * r, 1e-12)
    else:
        scale = torch.clamp_min(a.max() * r, 1e-12)
    return fake_quant_ste(w, scale, scheme.qmax)


class QATCtx:
    """Fake-quant training context over fp32 flat params. Records each
    quantized site's batch activation amax (stop-gradient) in
    ``batch_amax`` for the EMA update."""

    def __init__(self, flat: FlatParams, act_scales: Dict[str, torch.Tensor], qcfg: QConfig):
        self.flat = flat
        # fresh tensors: calibrate() returns inference-mode tensors, which
        # autograd cannot save for the backward pass
        self.act_scales = {k: torch.as_tensor(v, dtype=torch.float32).clone()
                           for k, v in (act_scales or {}).items()}
        self.qcfg = qcfg
        self.batch_amax: Dict[str, torch.Tensor] = {}

    def has(self, name):
        return name in self.flat

    def _fq_act(self, name, x):
        if self.qcfg.weight_only:
            return x
        self.batch_amax[name] = x.detach().abs().max()
        return fake_quant_ste(x, self.act_scales[name], self.qcfg.acts.qmax)

    def _fq_weight(self, name, w):
        return _weight_fq(w, self.qcfg.scheme_for(name))

    def conv(self, name, x, *, stride=1, padding=0, groups=1, fuse_relu=False):
        p = self.flat[name]
        y = conv2d(self._fq_act(name, x), self._fq_weight(name, p["w"]), stride=stride,
                   padding=padding, groups=groups, bias=p.get("b"))
        return relu(y) if fuse_relu else y

    def dense(self, name, x, *, fuse_relu=False):
        p = self.flat[name]
        y = dense(self._fq_act(name, x), self._fq_weight(name, p["w"]), p.get("b"))
        return relu(y) if fuse_relu else y


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -torch.mean(torch.sum(logp * onehot, dim=-1))


def _leaves(flat: FlatParams):
    return [(site, k) for site, p in flat.items() for k, v in p.items() if v is not None]


def make_qat_step(qforward: Callable, cfg, qcfg: QConfig, lr: float = 0.01,
                  momentum: float = 0.9, ema: float = 0.99):
    """One QAT step: fake-quant forward, CE loss, clipped-STE backward,
    ``vel = momentum * vel - lr * g; p = p + vel`` (written as the reference
    computes it, not ``torch.optim.SGD``'s form), then the EMA
    ``ema * s + (1 - ema) * amax / qmax`` of each activation scale.
    ``step(flat, vel, scales, x, y) -> (flat, vel, scales, loss, acc)``; new
    dicts, the inputs untouched."""
    qmax = None if qcfg.weight_only else qcfg.acts.qmax
    m, neg_lr = float(np.float32(momentum)), -float(np.float32(lr))
    e, c = float(np.float32(ema)), float(np.float32(1.0 - ema))
    r = None if qmax is None else _inv(qmax)

    def step(flat, vel, scales, x, y):
        keys = _leaves(flat)
        params = {site: {k: (None if v is None else v.detach().clone().requires_grad_(True))
                         for k, v in p.items()} for site, p in flat.items()}
        leaves = [params[s][k] for s, k in keys]
        with torch.enable_grad(), fp32_conv(), fp32_matmul():
            ctx = QATCtx(params, scales, qcfg)
            logits = qforward(ctx, x, cfg)
            loss = _softmax_ce(logits, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            new_flat = {site: dict(p) for site, p in flat.items()}
            new_vel = {site: dict(p) for site, p in vel.items()}
            m_t = torch.tensor(m, dtype=torch.float32, device=logits.device)
            for (s, k), g in zip(keys, grads):
                p = flat[s][k]
                g = torch.zeros_like(p) if g is None else g
                v = torch.addcmul(g * neg_lr, vel[s][k], m_t)
                new_vel[s][k] = v
                new_flat[s][k] = p + v
            new_scales = scales
            if qmax is not None:
                e_t = torch.tensor(e, dtype=torch.float32, device=logits.device)
                new_scales = {site: torch.addcmul(ctx.batch_amax[site] * r * c,
                                                  ctx.act_scales[site], e_t)
                              for site in scales}
            acc = torch.mean((logits.argmax(-1) == y).float())
        return new_flat, new_vel, new_scales, loss.detach(), acc

    return step


def qat_train(qforward: Callable, flat: FlatParams, cfg, qcfg: QConfig, X: np.ndarray,
              Y: np.ndarray, epochs: int = 3, batch: int = 64, lr: float = 0.01,
              momentum: float = 0.9, ema: float = 0.99,
              act_scales: Optional[Dict[str, torch.Tensor]] = None,
              seed: int = 0) -> Tuple[FlatParams, Dict[str, torch.Tensor], Dict[str, Any]]:
    """QAT fine-tune; returns (flat, act_scales, history). Batches follow
    ``np.random.default_rng(seed).permutation(n)`` per epoch, as the
    reference draws them; tensors live on the device of ``flat``. The
    outputs feed ``quantize_weights(flat, qcfg)`` + DeployCtx directly."""
    dev = next(v for p in flat.values() for v in p.values() if v is not None).device
    if act_scales is None and not qcfg.weight_only:
        from dlq_tpu_torch.quant.calibrate import calibrate
        from dlq_tpu_torch.quant.model_quant import make_sites_fn

        act_scales = calibrate(make_sites_fn(qforward, cfg), flat,
                               [torch.from_numpy(np.asarray(X[:batch], np.float32)).to(dev)],
                               qcfg)
    act_scales = {k: torch.as_tensor(v, dtype=torch.float32).clone().to(dev)
                  for k, v in (act_scales or {}).items()}
    step = make_qat_step(qforward, cfg, qcfg, lr, momentum, ema)
    vel = {site: {k: (None if v is None else torch.zeros_like(v)) for k, v in p.items()}
           for site, p in flat.items()}
    n = (len(X) // batch) * batch
    if n == 0:
        raise ValueError(f"dataset ({len(X)} rows) smaller than one batch ({batch})")
    rng = np.random.default_rng(seed)
    history = []
    for ep in range(epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        for i in range(0, n, batch):
            idx = order[i: i + batch]
            x = torch.from_numpy(np.asarray(X[idx])).to(dev)
            y = torch.from_numpy(np.asarray(Y[idx])).to(dev)
            flat, vel, act_scales, loss, acc = step(flat, vel, act_scales, x, y)
            losses.append(loss)
            accs.append(acc)
        history.append({"epoch": ep, "loss": float(torch.stack(losses).mean()),
                        "acc": float(torch.stack(accs).mean())})
    return flat, act_scales, {"epochs": history}
