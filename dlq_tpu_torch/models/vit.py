"""Tiny ViT / DeiT-Ti (the counterpart of ``dlq_tpu.models.vit``).

Standard ViT: patchify (p = 16) as a dense over flattened patches -> +cls
token +learned pos embed -> L x [LN -> MHSA -> res -> LN -> MLP(GELU) ->
res] -> LN -> head on cls. DeiT-Ti (Touvron et al. 2021, timm
``deit_tiny_patch16_224``): image 224, dim 192, 12 layers, 3 heads, MLP
ratio 4, 1000 classes, the ``ViTConfig`` defaults.

Every dense projection (qkv, proj, fc1, fc2, patch, head) is a ``ctx.dense``
site, quantized W8A8 under a deploy context; LayerNorms, softmax(QKᵀ)V and
the residual adds stay in the interchange dtype. Layouts are the
reference's: NHWC images, IO dense weights, [B, N, D] token streams.

``attn_impl="fused"`` sends attention through K6 (``ops.attention``; its
fp32 form on an fp32 stream); ``"xla_int8"`` through the dynamically
quantized int8 attention, K18 (``ops.int8_attention.attention_int8_dynamic``,
no ``n_valid``, output in the stream's dtype); ``"xla"`` is the plain
einsum form. ``fused_ln=True`` runs every LayerNorm through the fused
kernels (``ops.layernorm``: K16 for the first LN1, K17 for every later
``y += delta; h = LN(y)`` junction).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from dlq_tpu_torch.models.common import dense
from dlq_tpu_torch.models.registry import register

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    dim: int = 192
    depth: int = 12
    heads: int = 3
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_channels: int = 3
    attn_impl: str = "xla"   # "xla" (plain) | "fused" (K6) | "xla_int8" (K18)
    fused_ln: bool = False   # the fused LayerNorm kernels (K16, K17)
    gelu: str = "exact"      # "exact" (erf) | "tanh"

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1  # +cls


def _check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ("xla", "fused", "xla_int8"):
        raise ValueError(f"attn_impl must be 'xla', 'fused' or 'xla_int8', got {attn_impl!r}")


def _trunc_normal(rng: np.random.Generator, shape: Tuple[int, ...], std: float) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2] (resampled), fp32."""
    a = rng.standard_normal(shape)
    bad = np.abs(a) > 2.0
    while bad.any():
        a[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(a) > 2.0
    return torch.from_numpy((std * a).astype(np.float32))


def init_vit(seed, cfg: ViTConfig) -> Params:
    """Random DeiT params (truncated normal, std 0.02; LN g 1, b 0; zero
    biases) from a numpy generator or seed, in the reference's layout."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    D, H = cfg.dim, cfg.mlp_ratio * cfg.dim

    def ln():
        return {"g": torch.ones(D), "b": torch.zeros(D)}

    params: Params = {
        "patch": {"w": _trunc_normal(rng, (cfg.patch * cfg.patch * cfg.in_channels, D), 0.02),
                  "b": torch.zeros(D)},
        "cls": _trunc_normal(rng, (1, 1, D), 0.02),
        "pos": _trunc_normal(rng, (1, cfg.seq_len, D), 0.02),
        "norm": ln(),
        "head": {"w": _trunc_normal(rng, (D, cfg.num_classes), 0.02),
                 "b": torch.zeros(cfg.num_classes)},
    }
    params["layers"] = [{
        "ln1": ln(),
        "qkv": {"w": _trunc_normal(rng, (D, 3 * D), 0.02), "b": torch.zeros(3 * D)},
        "proj": {"w": _trunc_normal(rng, (D, D), 0.02), "b": torch.zeros(D)},
        "ln2": ln(),
        "fc1": {"w": _trunc_normal(rng, (D, H), 0.02), "b": torch.zeros(H)},
        "fc2": {"w": _trunc_normal(rng, (H, D), 0.02), "b": torch.zeros(D)},
    } for _ in range(cfg.depth)]
    return params


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    """Mean/variance LayerNorm as the reference's ``vit.layernorm``, with
    its rounding points on a bf16 stream as XLA compiles it (checked bit for
    bit on the CPU): the moments reduced in fp32 and rounded to ``x.dtype``,
    ``rsqrt(var + eps)`` taken in fp32 and rounded once, the affine chain
    in ``x.dtype``. On fp32 all of it is plain fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    mu, var = mu.to(x.dtype), var.to(x.dtype)
    r = torch.rsqrt(var.float() + eps).to(x.dtype)
    return (x - mu) * r * p["g"] + p["b"]


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC -> [B, N, p*p*C] patch rows (space-to-depth + flatten)."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              impl: str = "xla") -> torch.Tensor:
    """softmax(QKᵀ/√hd)V over ``heads`` heads of [B, N, D] streams; fp32
    scores and sums, probabilities and output in ``v.dtype``."""
    _check_attn_impl(impl)
    if impl == "fused":
        from dlq_tpu_torch.ops.attention import attention_fused

        return attention_fused(q, k, v, heads)
    if impl == "xla_int8":
        from dlq_tpu_torch.ops.int8_attention import attention_int8_dynamic

        return attention_int8_dynamic(q, k, v, heads)
    B, N, D = q.shape
    hd = D // heads

    def split(t):
        return t.reshape(B, N, heads, hd).permute(0, 2, 1, 3).float()  # B h N hd

    s = torch.matmul(split(q), split(k).transpose(-1, -2))
    s = s * (1.0 / torch.sqrt(torch.tensor(float(hd))))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    o = torch.matmul(a.float(), split(v)).to(v.dtype)
    return o.permute(0, 2, 1, 3).reshape(B, N, D)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``jax.nn.gelu`` with its constants in ``x.dtype``: the tanh form
    x·0.5(1 + tanh(√(2/π)(x + 0.044715x³))) op by op, or the erf form
    (0.5x)·erfc(−x√½) with the erfc argument and value in fp32 and rounded
    once, where XLA rounds them on a bf16 stream (checked on the CPU)."""
    if approximate:
        c = float(torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype))
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    sqrt_half = float(torch.tensor(np.sqrt(0.5), dtype=x.dtype))
    return (0.5 * x) * torch.erfc(-x.float() * sqrt_half).to(x.dtype)


def _encoder(y: torch.Tensor, get_ln: Callable, op: Callable, final_norm: Params, depth: int,
             heads: int, attn_impl: str, fused_ln: bool, taps: bool, gelu_kind: str = "exact"):
    """Shared pre-LN encoder loop of the fp32 and quantized paths. With
    ``fused_ln`` each ``y += delta; h = LN(y)`` junction is one K17 pass
    (layer i's MLP residual fuses into layer i+1's LN1, the last one into
    the final norm) and the first LN1 is K16: the reference's fused branch
    (``dlq_tpu/models/vit.py:135-182``), taps at the same points."""
    from dlq_tpu_torch.ops.layernorm import layernorm_fused, residual_layernorm

    _check_attn_impl(attn_impl)
    t: Dict[str, torch.Tensor] = {}
    delta = None
    for i in range(depth):
        ln1, ln2 = get_ln(i)
        if delta is None:
            h = layernorm_fused(y, ln1["g"], ln1["b"]) if fused_ln else layernorm(y, ln1)
        else:
            if fused_ln:
                y, h = residual_layernorm(y, delta, ln1["g"], ln1["b"])
            else:
                y = y + delta
                h = layernorm(y, ln1)
            if taps:
                t[f"block{i - 1}"] = y
        q, k, v = torch.chunk(op(i, "qkv", h), 3, dim=-1)
        a = op(i, "proj", attention(q, k, v, heads, impl=attn_impl))
        if fused_ln:
            y, h2 = residual_layernorm(y, a, ln2["g"], ln2["b"])
        else:
            y = y + a
            h2 = layernorm(y, ln2)
        m = gelu(op(i, "fc1", h2), gelu_kind == "tanh")
        delta = op(i, "fc2", m)
    if fused_ln:
        y, hf = residual_layernorm(y, delta, final_norm["g"], final_norm["b"])
    else:
        y = y + delta
        hf = layernorm(y, final_norm)
    if taps:
        t[f"block{depth - 1}"] = y
    return hf, t


def vit_forward(params: Params, x: torch.Tensor, cfg: ViTConfig, taps: bool = False):
    """fp32 forward (the oracle of the quantized paths)."""
    B = x.shape[0]
    y = dense(patchify(x, cfg.patch), params["patch"]["w"], params["patch"]["b"])
    cls = params["cls"].to(y.dtype).expand(B, 1, cfg.dim)
    y = torch.cat([cls, y], dim=1) + params["pos"].to(y.dtype)
    t0 = {"embed": y} if taps else {}
    layers = params["layers"]
    hf, t = _encoder(
        y, lambda i: (layers[i]["ln1"], layers[i]["ln2"]),
        lambda i, name, xx: dense(xx, layers[i][name]["w"], layers[i][name]["b"]),
        params["norm"], cfg.depth, cfg.heads, cfg.attn_impl, cfg.fused_ln, taps,
        gelu_kind=cfg.gelu)
    logits = dense(hf[:, 0], params["head"]["w"], params["head"]["b"])
    if taps:
        t0.update(t)
        t0["logits"] = logits
        return logits, t0
    return logits


# ---------------------------------------------------------------------------
# quantized path
# ---------------------------------------------------------------------------

def flatten_vit(params: Params) -> Params:
    """Dense sites for the quantizer; LN/pos/cls stay fp32 extras."""
    flat: Params = {"patch": dict(params["patch"])}
    for i, lp in enumerate(params["layers"]):
        for name in ("qkv", "proj", "fc1", "fc2"):
            flat[f"l{i}.{name}"] = {"w": lp[name]["w"], "b": lp[name]["b"]}
    flat["head"] = dict(params["head"])
    return flat


def vit_extras(params: Params) -> Params:
    return {
        "cls": params["cls"],
        "pos": params["pos"],
        "norm": params["norm"],
        "ln": [{"ln1": lp["ln1"], "ln2": lp["ln2"]} for lp in params["layers"]],
    }


def _cast_ln(p: Params, dtype) -> Params:
    return {"g": p["g"].to(dtype), "b": p["b"].to(dtype)}


def make_qforward(extras: Params, depth: int, heads: int, patch: int, dim: int,
                  interchange=torch.bfloat16, attn_impl: str = "xla",
                  fused_ln: bool = False, gelu: str = "exact"):
    """ctx-based quantized forward with ``interchange`` as the inter-op dtype
    (bf16, as the reference). Under a deploy context every ``ctx.dense``
    returns the interchange dtype; under the calibration context the fp32
    dense promotes a bf16 input with its fp32 bias (``common.dense``), so
    the stream turns fp32 after the patch embed there, as in the
    reference."""
    _check_attn_impl(attn_impl)
    ex_ln: List[Params] = extras["ln"]

    def qforward(ctx, x, cfg, taps: bool = False):
        B = x.shape[0]
        x = x.to(interchange)
        y = ctx.dense("patch", patchify(x, patch))
        cls = extras["cls"].to(y.dtype).expand(B, 1, dim)
        y = torch.cat([cls, y], dim=1) + extras["pos"].to(y.dtype)
        dt = y.dtype
        hf, t = _encoder(
            y, lambda i: (_cast_ln(ex_ln[i]["ln1"], dt), _cast_ln(ex_ln[i]["ln2"], dt)),
            lambda i, name, xx: ctx.dense(f"l{i}.{name}", xx),
            _cast_ln(extras["norm"], dt), depth, heads, attn_impl, fused_ln, taps,
            gelu_kind=gelu)
        logits = ctx.dense("head", hf[:, 0]).float()
        if taps:
            t["logits"] = logits
            return logits, t
        return logits

    return qforward


@register("deit_tiny")
def _build_deit_tiny(**kw):
    return ViTConfig(**kw), init_vit, vit_forward
