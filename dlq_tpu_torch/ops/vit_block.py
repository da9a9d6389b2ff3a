"""The bf16, W8A8, W4A8 and W4A16 ViT block paths (the counterpart of
``dlq_tpu/ops/pallas_vit_block.py``).

The reference runs L stacked quantized transformer layers per TPU kernel
(``vit_multiblock_fused_w8``), one grid step holding a batch group's whole
residual, qkv and scratch in VMEM. One sample's bf16 qkv alone (200 x 576 x
2 bytes) is more than a Hopper block's shared memory, so the port cuts each
layer where the reference itself cuts it (``vit_block_pre_w8`` / attention /
``vit_block_post_w8``) into three kernels, each of which fits one block:

  K5 ``vit_block_pre_w8`` (``csrc/vit_pre_w8.cu``): LN1 -> int8 quant -> int8
     QKV GEMM -> ``acc·s + b`` -> bf16 qkv ``[B, Np, 3·Dp]``;
  K6 ``ops.attention.mhsa`` (``csrc/mhsa.cu``): softmax(QKᵀ/√hd)V per head;
  K7 ``vit_block_post_w8`` (``csrc/vit_post_w8.cu``): int8 proj + bias +
     residual -> LN2 -> int8 FC1 + bias -> GELU -> int8 FC2 + bias + residual,
     with the output dtype and the FC2 residual association of the
     reference function it stands in for.

The W4A8 layer (``vit_block_fused_w4a8``, ``_w4a8c``,
``vit_multiblock_fused_w4a8``) is K8 -> K6 -> K9: K8 ``vit_block_pre_w4a8``
(``csrc/vit_pre_w4a8.cu``) and K9 ``vit_block_post_w4a8``
(``csrc/vit_post_w4a8.cu``) are K5 and K7 with int4 weights, halves-packed
on the padded grid (``pack_vit_blocks_w4a8``); the int32 sums and
everything around them are the W8A8 layer's. All three W4A8 functions add
FC2's residual as ``z1 + fma(acc, s, b)``. K9 shares K7's Hopper form
(``csrc/vit_post_iw.cuh``; its producer unpacks the int4 bytes into K7's
int8 stages, the K slots paired across the packed halves), taken by the
static rule ``vit_post_w4a8_form`` (plan mirror ``vit_post_w4a8_plan``),
bit-identical to its first form (``vit_post.cuh``), which serves other
shapes and stays callable as ``vit_block_post_w4a8_first``. K8 shares K5's
Hopper form (``csrc/vit_pre_iw.cuh``; its producer unpacks the int4 bytes
once a block into K5's resident int8 weight), bit-identical to its first
form (``vit_pre.cuh``): rule ``vit_pre_w4a8_form`` (Dp 128 and 192), plan
``vit_pre_w4a8_plan``, first form ``vit_block_pre_w4a8_first``.

The W4A16 (weight-only int4) layer (``vit_block_fused_w4``, ``_w4c``,
``vit_multiblock_fused_w4``) is K11 -> K6 -> K12: K11 ``vit_block_pre_w4``
(``csrc/vit_pre_w4.cu``) and K12 ``vit_block_post_w4``
(``csrc/vit_post_w4.cu``) take the same layer structure with bf16
activations (LN outputs, attention output and GELU output rounded to bf16,
nothing quantized to int8) against the W4A8 packer's int4 bytes
(``pack_vit_blocks_w4``), with fp32 sums. Those sums depend on their order:
the reference's (XLA's), the kernels' (the tensor core's) and the plain
versions' (exact in float64, rounded once) agree up to that order, so
they are held to stated tolerances, not bit for bit. All three W4A16
functions add FC2's residual as ``z1 + fma(acc, s, b)`` too. K11's Hopper
form is K5's in bf16 ``wgmma`` (its producer streams the packed weight from
L2 and unpacks it into bf16 stages), taken by the static rule
``vit_pre_w4_form`` (plan mirror ``vit_pre_w4_plan``); its first form
(``vit_pre_h.cuh``) serves other Dp and stays callable as
``vit_block_pre_w4_first``. K14 shares that Hopper form
(``csrc/vit_pre_hw.cuh``; its producer warp copies the bf16 weight into the
same stages): rule ``vit_pre_bf16_form``, plan ``vit_pre_bf16_plan`` (both
K11's), first form ``vit_block_pre_bf16_first``.

The reference's int8-attention arm (``vit_multiblock_fused_w8(...,
attn_int8=True)``, ``_mhsa_batched_i8_into_scratch``) is K5 -> K18 -> K7,
K18 ``ops.int8_attention.mhsa_i8`` (``csrc/mhsa_i8.cu``) in its in-kernel
form (the dynamic amax over every row of the padded stream). The
split-attention block (``vit_block_w8_splitattn``, the reference's A/B of
attention outside the block kernels) is K5 -> K18 in its zero-pad form
(``attention_int8_dynamic``) or K6 (``attention_bf16_masked``) -> K7's
single-block form: its bf16 arm is ``vit_block_fused_w8``.

The bf16 layer (``vit_block_fused``, the layer of the reference's bf16
deploy forward ``vit_forward_blockfused``) is K14 -> K6 -> K15: K14
``vit_block_pre_bf16`` (``csrc/vit_pre_bf16.cu``) and K15
``vit_block_post_bf16`` (``csrc/vit_post_bf16.cu``) are K11 and K12 with
bf16 K-major weights (``pack_vit_blocks``) and no scales: every epilogue is
``acc + b``, and FC2's residual is added before its bias, ``(z1 + acc) +
b`` (``_block_kernel`` :318-319), a third order beside K7's and K9/K12's.
Its fp32 sums are not exact either, so it too is held to stated
tolerances. K12 and K15 share one Hopper form (``csrc/vit_post_hw.cuh``:
K7's persistent 128-row tiles on bf16 ``wgmma``, the weights streamed as
bf16 stages, K12's unpacked from its int4 bytes on the way in), taken by
the static rule ``vit_post_h_form`` (plan mirror ``vit_post_h_plan``);
their first form (``vit_post_h.cuh``) serves other shapes and stays
callable as ``vit_block_post_w4_first`` / ``vit_block_post_bf16_first``.
``.by_form`` counts their launches per form.

Numerics, as the reference kernels compute them (checked bit for bit against
them on the CPU at the test sizes):

  * ``_ln_f32``: two-moment LayerNorm over the Dp lanes (pad lanes zero),
    ``inv_n = 1/d_valid``, ``var = max(E[x²] − μ², 0)``, ``rsqrt(var + 1e-6)``;
  * ``_quant_i8``: ``clip(rint(x · inv), ±127)`` with ``inv`` the fp32
    rounding of ``1/act_scale`` taken in double (``:870-871``);
  * epilogues ``fma(acc, s, b)`` (XLA contracts ``acc·s + b``); the
    multiblock kernel's FC2 is ``z1 + fma(acc, s, b)`` (``:501``), the W8
    single-block kernels' is ``fma(acc, s, z1) + b`` (``:364``, ``:976``);
  * the residual is fp32 inside a chunk and bf16 at its ends.

Every kernel wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version for a CPU tensor; ``.launches`` counts kernel
launches and ``.by_shape`` counts them per shape.

Weights are packed once (``pack_vit_blocks``, ``pack_vit_blocks_w8``,
``pack_vit_blocks_w4a8``, ``pack_vit_blocks_w4``):
K-major ``[N, K]`` bf16 or int8, or ``[N, K/2]`` halves-packed int4 bytes
(the layout the tensor-core fragments read), [q|k|v] column blocks of Dp
lanes each, heads at hd offsets, zero-padded so pad lanes stay zero.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch import _build
from dlq_tpu_torch.models.common import fp32_matmul
from dlq_tpu_torch.ops.attention import mhsa
from dlq_tpu_torch.ops.int8_attention import attention_bf16_masked, attention_int8_dynamic, mhsa_i8
from dlq_tpu_torch.ops.layernorm import ln_f32 as _ln_f32
from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor, unpack_halves_kmajor
from dlq_tpu_torch.quant.quantize import dequantize, f32, unpack_int4

Block = Dict[str, Any]
GELU_C = 0.7978845608028654  # sqrt(2/pi)
SQRT_HALF = 0.7071067811865476


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vit_pads(cfg, tight: bool = False) -> Tuple[int, int]:
    """(Np, Dp) of the padded token stream, as the reference: tight pads Np
    to 8 rows and Dp to the head-width grain (DeiT-Ti: 200, 192); loose
    pads both to multiples of 128."""
    N, D = cfg.seq_len, cfg.dim
    hd = D // cfg.heads
    if tight:
        Np = _cdiv(max(N, 8), 8) * 8
        gr = hd if hd % 64 == 0 else _cdiv(hd, 64) * 64
        Dp = _cdiv(max(D, 128), gr) * gr
    else:
        Np = _cdiv(max(N, 128), 128) * 128
        Dp = _cdiv(max(D, 128), 128) * 128
    assert Dp % hd == 0, (Dp, hd)
    return Np, Dp


def mlp_pad(cfg) -> int:
    """Hp: the MLP width padded to a multiple of 128."""
    return _cdiv(cfg.mlp_ratio * cfg.dim, 128) * 128


def _gelu_f32(f: torch.Tensor, tanh_approx: bool) -> torch.Tensor:
    if tanh_approx:
        return 0.5 * f * (1.0 + torch.tanh(GELU_C * (f + 0.044715 * f * f * f)))
    return 0.5 * f * torch.erfc(-f * SQRT_HALF)


def _quant_i8(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """clip(rint(x · inv), ±127), as float values of the int8 codes."""
    return torch.clamp(torch.round(x * inv_scale), -127.0, 127.0)


def _igemm(q: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 codes (float) against K-major int8 weights
    [N, K], or int4 halves-packed ones [N, K/2] (uint8), as fp32 (float64
    product: K·127² < 2^53)."""
    if wk.dtype == torch.uint8:
        wk = unpack_halves_kmajor(wk)
    return torch.matmul(q.double(), wk.double().t()).float()


def _hgemm(a: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Sums of bf16 activations against K-major int4 halves-packed weights
    [N, K/2] (uint8) or bf16 weights [N, K]: every product is exact, and the
    float64 sum is rounded once to fp32 (the reference's and the kernels'
    fp32 sums agree with it up to their summation order)."""
    w = unpack_halves_kmajor(wk) if wk.dtype == torch.uint8 else wk
    return torch.matmul(a.double(), w.double().t()).float()


def _epi(acc: torch.Tensor, s: Optional[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """fma(acc, s, b); with no scale (bf16 weights) acc + b."""
    return acc + b if s is None else torch.addcmul(b, acc, s)


# ---------------------------------------------------------------------------
# packing and embedding
# ---------------------------------------------------------------------------

def inverse_smooth(s) -> np.ndarray:
    """``1 / s`` of a smoothing vector (numpy, a tensor or a number) in
    fp32: an IEEE division, as the reference computes it."""
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    return np.asarray(np.float32(1.0) / np.asarray(s, np.float32))


def check_smooth_foldable(smooth: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The smoothing vectors that fold into a ViT's LN affines (``*.qkv`` and
    ``*.fc1``, whose inputs are LN outputs); any other site raises the
    reference's ValueError (``pallas_vit_block.py:789``,
    ``dlq_tpu/quant/smooth.py:143``)."""
    smooth = smooth or {}
    bad = [k for k in smooth if not (k.endswith(".qkv") or k.endswith(".fc1"))]
    if bad:
        raise ValueError(
            f"only *.qkv / *.fc1 smoothing vectors fold into the LN affines; got vectors for "
            f"{bad} — use quant.recipe.VIT_LN_FOLDABLE as the smooth_site_filter, or deploy "
            "sitewise with SmoothDeployCtx")
    return smooth


def smooth_folded_ln(ln: Dict[str, Any], smooth: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s LN affines with its ``l<i>.qkv`` / ``l<i>.fc1``
    smoothing vectors folded in exactly (``pallas_vit_block.py:801``): the
    qkv and fc1 inputs are LN outputs, so ``x / s`` is the LN with ``(g * (1
    / s), b * (1 / s))`` in fp32. The residual stream is untouched."""
    out = {"ln1": ln["ln1"], "ln2": ln["ln2"]}
    for key, site in (("ln1", f"l{i}.qkv"), ("ln2", f"l{i}.fc1")):
        s = smooth.get(site)
        if s is not None:
            g, b = ln[key]["g"], ln[key]["b"]
            inv = torch.from_numpy(inverse_smooth(s)).to(g.device)
            out[key] = {"g": g.float() * inv, "b": b.float() * inv}
    return out


def _pack_vit_blocks(qflat: Dict[str, Any], act_scales: Optional[Dict[str, Any]],
                     extras: Dict[str, Any], cfg, tight: bool,
                     smooth: Optional[Dict[str, Any]], kind: str) -> Dict[str, Any]:
    """The W8 (``kind`` "w8"), W4A8 ("w4a8") and W4A16 ("w4") block
    packings: weights K-major and zero-padded to (Dp, Hp), int8 or
    halves-packed int4 on the padded grid; per-OC weight scales (folded with
    the calibrated activation scales unless weight-only) as one fp32 row per
    GEMM (pad lanes 0 for W8, 1.0 for the int4 packs, as each reference
    packer pads); fp32 biases, LN affines ``[2, Dp]`` and, with activation
    scales, the four inverse activation scales per layer. Tensors stay on
    the device of ``qflat``."""
    what = f"pack_vit_blocks_{kind}"
    smooth = check_smooth_foldable(smooth)
    w4 = kind != "w8"
    _, Dp = vit_pads(cfg, tight)
    Hp = mlp_pad(cfg)
    fill = 1.0 if w4 else 0.0

    def padv(a, n, value=0.0):
        a = a.float().reshape(-1)
        return F.pad(a, (0, n - a.shape[0]), value=value).contiguous()

    def site(name):
        p = qflat[name]
        qw = p["qw"]
        if qw.bits != (4 if w4 else 8) or qw.group is not None:
            raise ValueError(f"{what}: {name} needs per-channel "
                             f"{'int4' if w4 else 'int8'} weights")
        grid = unpack_int4(qw.values, qw.shape) if w4 else qw.values.reshape(qw.shape)
        comb = torch.broadcast_to(qw.scale.float(), (qw.shape[-1],))
        if act_scales is not None:
            comb = torch.as_tensor(act_scales[name], dtype=torch.float32,
                                   device=comb.device) * comb
        b = p.get("b")
        b = torch.zeros(qw.shape[-1], device=comb.device) if b is None else b.float()
        return grid.to(torch.int8), comb, b

    def kmajor(w_io, k, n):
        """[K', N'] int8 IO -> zero-padded K-major [n, k] int8, or [n, k/2]
        halves-packed bytes."""
        if w4:
            return pack_halves_kmajor(w_io, k, n)
        return F.pad(w_io, (0, n - w_io.shape[1], 0, k - w_io.shape[0])).t().contiguous()

    blocks: List[Block] = []
    for i in range(cfg.depth):
        wq, sq, bq = site(f"l{i}.qkv")
        wp, sp, bp = site(f"l{i}.proj")
        wf1, sf1, bf1 = site(f"l{i}.fc1")
        wf2, sf2, bf2 = site(f"l{i}.fc2")
        ln = smooth_folded_ln(extras["ln"][i], smooth, i)
        qkv = torch.cat([F.pad(w, (0, Dp - w.shape[1])) for w in torch.chunk(wq, 3, -1)], -1)
        blk = {
            "wqkv": kmajor(qkv, Dp, 3 * Dp),
            "sqkv": torch.cat([padv(s, Dp, fill) for s in torch.chunk(sq, 3)]),
            "bqkv": torch.cat([padv(b, Dp) for b in torch.chunk(bq, 3)]),
            "wproj": kmajor(wp, Dp, Dp), "sproj": padv(sp, Dp, fill), "bproj": padv(bp, Dp),
            "ln1": torch.stack([padv(ln["ln1"]["g"], Dp), padv(ln["ln1"]["b"], Dp)]),
            "ln2": torch.stack([padv(ln["ln2"]["g"], Dp), padv(ln["ln2"]["b"], Dp)]),
            "wfc1": kmajor(wf1, Dp, Hp), "sfc1": padv(sf1, Hp, fill), "bfc1": padv(bf1, Hp),
            "wfc2": kmajor(wf2, Hp, Dp), "sfc2": padv(sf2, Dp, fill), "bfc2": padv(bf2, Dp),
        }
        if act_scales is not None:
            blk["inv_act"] = tuple(f32(1.0 / float(act_scales[f"l{i}.{s}"]))
                                   for s in ("qkv", "proj", "fc1", "fc2"))
        blocks.append(blk)
    head_b = qflat["head"].get("b")
    return {
        "blocks": blocks,
        "patch": {"w": dequantize(qflat["patch"]["qw"]).to(torch.bfloat16),
                  "b": qflat["patch"]["b"].to(torch.bfloat16)},
        "cls": extras["cls"].to(torch.bfloat16),
        "pos": extras["pos"].to(torch.bfloat16),
        "norm": {"g": extras["norm"]["g"].float(), "b": extras["norm"]["b"].float()},
        "head": {"w": dequantize(qflat["head"]["qw"]).float(),
                 "b": None if head_b is None else head_b.float()},
    }


def pack_vit_blocks_w8(qflat: Dict[str, Any], act_scales: Dict[str, Any],
                       extras: Dict[str, Any], cfg, tight: bool = False,
                       smooth: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Pack a per-channel int8 ViT (``flatten_vit`` sites + ``vit_extras``)
    for K5/K7: int8 K-major weights ``[N, K]`` (``_pack_vit_blocks``)."""
    return _pack_vit_blocks(qflat, act_scales, extras, cfg, tight, smooth, "w8")


def pack_vit_blocks_w4a8(qflat: Dict[str, Any], act_scales: Dict[str, Any],
                         extras: Dict[str, Any], cfg, tight: bool = False,
                         smooth: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Pack an ``INT4A8_PER_CHANNEL`` ViT for K8/K9
    (``pallas_vit_block.py:1600``): the store's adjacent-row nibbles
    unpacked, padded to (Dp, Hp), halves-packed at the padded K and stored
    K-major, ``[N, Kp/2]`` bytes with byte k holding rows (k, k + Kp/2): the
    reference's packing, transposed. The weights stay 4-bit."""
    return _pack_vit_blocks(qflat, act_scales, extras, cfg, tight, smooth, "w4a8")


def pack_vit_blocks_w4(qflat: Dict[str, Any], extras: Dict[str, Any], cfg,
                       tight: bool = False) -> Dict[str, Any]:
    """Pack a weight-only per-OC int4 ViT (``INT4_WEIGHT_ONLY_PER_OC``) for
    K11/K12 (``pallas_vit_block.py:1262``): the W4A8 packer's bytes
    (halves-packed on the padded grid, K-major), the per-OC weight scales
    alone (pad lanes 1.0), no activation scales; the patch weight
    dequantized to bf16 and the head to fp32."""
    return _pack_vit_blocks(qflat, None, extras, cfg, tight, None, "w4")


def pack_vit_blocks(params: Dict[str, Any], cfg, tight: bool = False) -> Dict[str, Any]:
    """Pack fp32 ViT params (``models.vit.init_vit``'s layout, the port's or
    JAX's carried over with ``interop.from_jax_tree``) for K14/K15
    (``pallas_vit_block.py:732-786``): every block weight bf16, K-major
    ``[N, K]`` (the reference's ``[K, N]``, transposed) and zero-padded to
    (Dp, Hp), qkv as [q|k|v] blocks of Dp lanes with heads at hd offsets;
    fp32 bias rows and fp32 ``ln1``/``ln2`` ``[2, Dp]``; the patch weight and
    bias, cls and pos in bf16, the norm in fp32, the head weight in bf16
    (upcast to fp32 for its product) and its bias in fp32. Tensors stay on
    the device of ``params``."""
    _, Dp = vit_pads(cfg, tight)
    Hp = mlp_pad(cfg)

    def padv(a, n):
        a = a.float().reshape(-1)
        return F.pad(a, (0, n - a.shape[0])).contiguous()

    def kmajor(w_io, k, n):
        w = w_io.float()
        return F.pad(w, (0, n - w.shape[1], 0, k - w.shape[0])).t().contiguous().to(torch.bfloat16)

    blocks: List[Block] = []
    for lp in params["layers"]:
        wq = torch.cat([F.pad(w.float(), (0, Dp - w.shape[1]))
                        for w in torch.chunk(lp["qkv"]["w"], 3, -1)], -1)
        blocks.append({
            "wqkv": kmajor(wq, Dp, 3 * Dp),
            "bqkv": torch.cat([padv(b, Dp) for b in torch.chunk(lp["qkv"]["b"], 3)]),
            "wproj": kmajor(lp["proj"]["w"], Dp, Dp), "bproj": padv(lp["proj"]["b"], Dp),
            "ln1": torch.stack([padv(lp["ln1"]["g"], Dp), padv(lp["ln1"]["b"], Dp)]),
            "ln2": torch.stack([padv(lp["ln2"]["g"], Dp), padv(lp["ln2"]["b"], Dp)]),
            "wfc1": kmajor(lp["fc1"]["w"], Dp, Hp), "bfc1": padv(lp["fc1"]["b"], Hp),
            "wfc2": kmajor(lp["fc2"]["w"], Hp, Dp), "bfc2": padv(lp["fc2"]["b"], Dp),
        })
    return {
        "blocks": blocks,
        "patch": {"w": params["patch"]["w"].to(torch.bfloat16),
                  "b": params["patch"]["b"].to(torch.bfloat16)},
        "cls": params["cls"].to(torch.bfloat16),
        "pos": params["pos"].to(torch.bfloat16),
        "norm": {"g": params["norm"]["g"].float(), "b": params["norm"]["b"].float()},
        "head": {"w": params["head"]["w"].to(torch.bfloat16), "b": params["head"]["b"].float()},
    }


def stack_vit_blocks_w8(packed: Dict[str, Any], layers_per_kernel: int) -> List[List[Block]]:
    """Group the per-layer blocks into chunks of ``layers_per_kernel``: the
    residual stays fp32 between the layers of a chunk and is bf16 between
    chunks, as in the reference's stacked kernels. The port launches three
    kernels per layer, so a chunk is the list of its layers' blocks (of
    any pack: ``stack_vit_blocks_w4a8`` and ``stack_vit_blocks_w4`` are this
    function)."""
    blocks = packed["blocks"]
    L = layers_per_kernel
    if len(blocks) % L:
        raise ValueError(f"{len(blocks)} layers do not split into chunks of {L}")
    return [blocks[c: c + L] for c in range(0, len(blocks), L)]


stack_vit_blocks_w4a8 = stack_vit_blocks_w4 = stack_vit_blocks_w8


def embed_tokens(packed: Dict[str, Any], x: torch.Tensor, cfg, mean=None,
                 std=None) -> torch.Tensor:
    """Patch embedding [B, H, W, C] -> bf16 [B, N-1, D]: the bf16-rounded
    image against the bf16 patch weights with fp32 sums (an fp32 product of
    bf16-rounded operands, TF32 off), rounded to bf16, plus the bf16 bias
    (``pallas_vit_block.py:719-730``).

    A uint8 image is ingested raw with the preprocess fold (``:704-716``,
    ``preprocess.fold_u8``): the patch weights times ``1 / (255 std)`` in
    fp32, rounded to bf16, against ``u - bf16(255 mean)``, unrounded as the
    jitted reference keeps it (``mean``/``std`` default to ImageNet's)."""
    from dlq_tpu_torch.models.vit import patchify
    from dlq_tpu_torch.preprocess import fold_u8

    p, D = cfg.patch, packed["patch"]["w"].shape[-1]
    wf = packed["patch"]["w"].float()
    if x.dtype == torch.uint8:
        w4, xb = fold_u8(wf.reshape(p, p, x.shape[-1], D), x, mean, std)
        wf = w4.reshape(-1, D)
    else:
        xb = x.to(torch.bfloat16).float()
    with fp32_matmul():
        y = torch.matmul(patchify(xb, p), wf).to(torch.bfloat16)
    return y + packed["patch"]["b"]


def _token_stream(packed: Dict[str, Any], x: torch.Tensor, cfg, tight: bool) -> torch.Tensor:
    """cls + patch tokens + pos (bf16), zero-padded to [B, Np, Dp]."""
    N, D = cfg.seq_len, cfg.dim
    Np, Dp = vit_pads(cfg, tight)
    y = embed_tokens(packed, x, cfg)
    cls = packed["cls"].to(torch.bfloat16).expand(x.shape[0], 1, D)
    y = torch.cat([cls, y], dim=1) + packed["pos"]
    return F.pad(y, (0, Dp - D, 0, Np - N)).contiguous()


def _head(packed: Dict[str, Any], y: torch.Tensor, cfg) -> torch.Tensor:
    """Final mean/var LayerNorm on the cls row, fp32 head (a bf16 head
    weight upcast, as ``pallas_vit_block.py:1142``)."""
    from dlq_tpu_torch.models.vit import layernorm

    hf = layernorm(y[:, 0, :cfg.dim].float(), packed["norm"])
    with fp32_matmul():
        logits = torch.matmul(hf, packed["head"]["w"].float())
    b = packed["head"]["b"]
    return logits if b is None else logits + b


# ---------------------------------------------------------------------------
# K5 / K8 / K11 / K14: LN1 + QKV
# ---------------------------------------------------------------------------

def vit_block_pre_plain(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """Plain PyTorch version of K5 (``_block_pre_kernel_w8``) and, on a
    W4A8 pack, of K8."""
    xf = y.float()
    h1 = _ln_f32(xf, w["ln1"][0], w["ln1"][1], d_valid)
    acc = _igemm(_quant_i8(h1, w["inv_act"][0]), w["wqkv"])
    return _epi(acc, w["sqkv"], w["bqkv"]).to(torch.bfloat16)


# the weight format of each block kernel: int8 [N, K], int4 halves-packed
# [N, K/2] bytes, or bf16 [N, K]; the activation-quantized ones (K5, K7, K8,
# K9) take inverse activation scales
WEIGHTS = {"vit_pre_w8": torch.int8, "vit_post_w8": torch.int8,
           "vit_pre_w4a8": torch.uint8, "vit_post_w4a8": torch.uint8,
           "vit_pre_w4": torch.uint8, "vit_post_w4": torch.uint8,
           "vit_pre_bf16": torch.bfloat16, "vit_post_bf16": torch.bfloat16}
QUANT = ("vit_pre_w8", "vit_post_w8", "vit_pre_w4a8", "vit_post_w4a8")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.cache
def _pre_entry(name: str, suffix: str = ""):
    """The launch entry of K5, K8, K11 or K14 (K11 and K14 take no inverse
    activation scale; K14's scale pointer is null); ``suffix`` "_first":
    its first form (``dlq_vit_pre_w8_first``, ``_w4a8_first``, ``_w4_first``,
    ``_bf16_first``)."""
    fn = getattr(_build.library(name), f"dlq_{name}{suffix}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + ([ctypes.c_float] if name in QUANT else []) + [ctypes.c_void_p])
    return fn


def _check_stream(what: str, t: torch.Tensor, dev, dtypes, lanes: int) -> None:
    if (t.device != dev or t.dtype not in dtypes or t.ndim != 3 or t.shape[-1] != lanes
            or not t.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous {dtypes} [B, rows, {lanes}] tensor on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_params(what: str, dev, *ts: Optional[torch.Tensor]) -> None:
    for t in ts:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what}: packed parameters must be contiguous on {dev}")


def _check_scales(name: str, *ss: Optional[torch.Tensor]) -> None:
    """Integer weights come with per-OC scale rows, bf16 weights without."""
    if any((s is None) != (WEIGHTS[name] == torch.bfloat16) for s in ss):
        raise ValueError(f"{name}: {WEIGHTS[name]} weights "
                         f"{'take no' if WEIGHTS[name] == torch.bfloat16 else 'need'} scale rows")


def _weight_shape(w: torch.Tensor, n: int, k: int, name: str) -> bool:
    """Is ``w`` the K-major weight [n, k] of kernel ``name``'s format: int8,
    int4 halves-packed [n, k/2] bytes, or bf16?"""
    dt = WEIGHTS[name]
    return w.dtype == dt and w.shape == (n, k // 2 if dt == torch.uint8 else k)


def _pre(wrapper, name: str, y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """Launch K5 (``name`` "vit_pre_w8"), K8 ("vit_pre_w4a8"), K11
    ("vit_pre_w4") or K14 ("vit_pre_bf16") and count it on ``wrapper``."""
    out = _launch_pre(name, y, w, d_valid)
    B, Np, Dp = y.shape
    wrapper.launches += 1
    wrapper.by_shape[(B, Np, Dp, str(y.dtype)[6:])] += 1
    return out


def _launch_pre(name: str, y: torch.Tensor, w: Block, d_valid: int,
                suffix: str = "") -> torch.Tensor:
    B, Np, Dp = y.shape
    _check_stream(name, y, y.device, (torch.bfloat16, torch.float32), Dp)
    if not _weight_shape(w["wqkv"], 3 * Dp, Dp, name) or Dp % 64:
        raise ValueError(f"{name}: wqkv {w['wqkv'].dtype} {tuple(w['wqkv'].shape)} for Dp {Dp} "
                         "(a multiple of 64)")
    sqkv = w.get("sqkv")
    _check_scales(name, sqkv)
    _check_params(name, y.device, w["wqkv"], sqkv, w["bqkv"], w["ln1"])
    out = torch.empty((B, Np, 3 * Dp), dtype=torch.bfloat16, device=y.device)
    inv = [w["inv_act"][0]] if name in QUANT else []
    rc = _pre_entry(name, suffix)(
        y.data_ptr(), int(y.dtype == torch.float32), w["ln1"].data_ptr(), w["wqkv"].data_ptr(),
        _ptr(sqkv), w["bqkv"].data_ptr(), out.data_ptr(), B * Np, Dp, d_valid, *inv,
        _build.stream_ptr(y.device))
    _build.check(rc, name + suffix)
    return out


# K5's and K8's Hopper form (csrc/vit_pre_iw.cuh's make_plan, which the
# card test holds to this): 128-row tiles, 192-column slices of the 3·Dp outputs,
# weight stages of 192 x 64 bytes when the weight is not resident, y stages
# of 32·Dp bytes (8 fp32 or 16 bf16 rows), each consumer warp staging two
# buffers of 8 output rows of 2 x 192 + 16 bytes
K5_TILE, K5_SLICE, K5_STAGE_K, K5_MAX_STAGES = 128, 192, 64, 8
K5_Y_BYTES, K5_MAX_Y, K5_MIN_Y = 32, 4, 2
K5_STAGING = 2 * 8 * 8 * (2 * K5_SLICE + 16)
K5_HOPPER_DP = (128, 192, 256)
K8_HOPPER_DP = (128, 192)   # K8: the resident weight only
SMEM_MAX = 232448   # the opt-in shared-memory limit (launch.cuh: SMEM_OPT_IN)


def vit_pre_w8_form(dp: int) -> str:
    """K5's form, a static shape rule: ``"hopper"`` for Dp 128, 192 and 256
    (3·Dp is a multiple of the 192-column slice and the LN row is Dp / 32
    values a lane), else ``"first"`` (the first form, vit_pre.cuh's body)."""
    return "hopper" if dp in K5_HOPPER_DP else "first"


def vit_pre_w8_plan(dp: int, m: int, sms: int) -> Tuple[int, int, int, int, int, int]:
    """K5's Hopper plan: (resident weight 1/0, weight ring stages, y stages a
    consumer, dynamic shared-memory bytes, blocks, rows a block) for Dp
    lanes and M rows on ``sms`` SMs. Shared memory: the int8 codes of a
    128-row tile, the {s, s, b, b} table (8 bytes a column), the output
    staging, each consumer's ring of y stages (32·Dp bytes and two
    mbarriers a stage), and the weight: resident (3·Dp x Dp bytes and one
    mbarrier) where that fits beside two y stages a consumer (Dp 128 and
    192), with as many y stages as fit (at most 4); else two y stages a
    consumer and as many 192 x 64-byte weight stages as fit (at most 8), two
    mbarriers each. Each block takes a contiguous run of ceil(M / sms) rows
    (at least 64), walked in tiles of 128, the last one short."""
    fixed = K5_TILE * dp + 3 * dp * 8 + K5_STAGING
    ystage = K5_Y_BYTES * dp + 16
    rows = max(_cdiv(m, sms), 64)
    grid = _cdiv(m, rows)
    if 3 * dp * dp + fixed + 16 + 2 * K5_MIN_Y * ystage <= SMEM_MAX:
        ny = min(K5_MAX_Y, (SMEM_MAX - 3 * dp * dp - fixed - 16) // (2 * ystage))
        return 1, 0, ny, 3 * dp * dp + fixed + 16 + 2 * ny * ystage, grid, rows
    ny = K5_MIN_Y
    stages = min(K5_MAX_STAGES, (SMEM_MAX - fixed - 2 * ny * ystage) // (K5_SLICE * K5_STAGE_K + 16))
    return 0, stages, ny, fixed + 2 * ny * ystage + stages * (K5_SLICE * K5_STAGE_K + 16), grid, rows


@functools.cache
def library_form(name: str, *shape: int) -> str:
    """The form kernel library ``name`` takes at ``shape`` (Dp, or Dp and
    Hp): its own static rule, ``dlq_<name>_form``."""
    fn = getattr(_build.library(name), f"dlq_{name}_form")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(shape)
    return "hopper" if fn(*shape) else "first"


def vit_block_pre_w8(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """LN1 + int8 QKV of one layer (K5) on the padded stream y [B, Np, Dp]
    (bf16 or fp32); returns bf16 qkv [B, Np, 3·Dp]. ``.by_form`` counts
    launches per form."""
    if y.device.type == "cpu":
        return vit_block_pre_plain(y, w, d_valid)
    out = _pre(vit_block_pre_w8, "vit_pre_w8", y, w, d_valid)
    vit_block_pre_w8.by_form[library_form("vit_pre_w8", y.shape[-1])] += 1
    return out


def vit_block_pre_w8_first(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """K5's first form at any Dp (a CUDA tensor only; not counted): what
    the card tests and ``chip_smoke.py`` hold the Hopper form to, bit for
    bit (the same LN order, codes, exact sums and epilogue)."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_pre_w8_first: a CUDA tensor (the kernel's first form)")
    return _launch_pre("vit_pre_w8", y, w, d_valid, "_first")


def vit_pre_w4a8_form(dp: int) -> str:
    """K8's form, a static shape rule: ``"hopper"`` for Dp 128 and 192 (K5's
    Hopper body with the weight resident, unpacked once a block), else
    ``"first"`` (vit_pre.cuh's body; Dp 256 among them, where K5 streams its
    weight)."""
    return "hopper" if dp in K8_HOPPER_DP else "first"


def vit_pre_w4a8_plan(dp: int, m: int, sms: int) -> Tuple[int, int, int, int, int, int]:
    """K8's Hopper plan: K5's (``vit_pre_w8_plan``: its int8 weight unpacks
    into K5's resident copy) where the rule takes the Hopper form, all 0
    elsewhere."""
    if vit_pre_w4a8_form(dp) != "hopper":
        return 0, 0, 0, 0, 0, 0
    return vit_pre_w8_plan(dp, m, sms)


def vit_block_pre_w4a8(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """LN1 + QKV of one W4A8 layer (K8; ``pack_vit_blocks_w4a8`` weights),
    as ``vit_block_pre_w8``. ``.by_form`` counts launches per form."""
    if y.device.type == "cpu":
        return vit_block_pre_plain(y, w, d_valid)
    out = _pre(vit_block_pre_w4a8, "vit_pre_w4a8", y, w, d_valid)
    vit_block_pre_w4a8.by_form[library_form("vit_pre_w4a8", y.shape[-1])] += 1
    return out


def vit_block_pre_w4a8_first(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """K8's first form at any Dp (a CUDA tensor only; not counted): what
    the card tests and ``chip_smoke.py`` hold the Hopper form to, bit for
    bit."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_pre_w4a8_first: a CUDA tensor (the kernel's first form)")
    return _launch_pre("vit_pre_w4a8", y, w, d_valid, "_first")


def vit_block_pre_w4_plain(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """Plain PyTorch version of K11 (``_block_kernel_w4`` :1191-1193): h1 =
    bf16(LN1(y)), qkv = bf16(fma(h1 @ W, s, b)) with the exact sum; and, on
    a bf16 pack (no scales), of K14 (``_block_kernel`` :299-303): qkv =
    bf16(h1 @ W + b)."""
    h1 = _ln_f32(y.float(), w["ln1"][0], w["ln1"][1], d_valid).to(torch.bfloat16)
    return _epi(_hgemm(h1, w["wqkv"]), w.get("sqkv"), w["bqkv"]).to(torch.bfloat16)


vit_block_pre_bf16_plain = vit_block_pre_w4_plain


# K11's and K14's Hopper form (csrc/vit_pre_hw.cuh's make_plan, which the
# card test holds to this): K5's tiles, slices, y stages and staging, with
# bf16 h1 and bf16 weight stages of 192 columns x 128 bytes (K11: 32 packed
# bytes of each row unpacked; K14: 64 K values copied), streamed from L2
# (none resident)
K11_STAGE = K5_SLICE * 4 * 32
K11_MAX_STAGES, K11_MIN_STAGES = 8, 3


def vit_pre_w4_form(dp: int) -> str:
    """K11's form (and K14's), a static shape rule: ``"hopper"`` for Dp 128,
    192 and 256 (K5's, where the plan fits), else ``"first"`` (the first
    form, vit_pre_h.cuh's body)."""
    return "hopper" if dp in K5_HOPPER_DP else "first"


def vit_pre_w4_plan(dp: int, m: int, sms: int) -> Tuple[int, int, int, int, int]:
    """K11's and K14's Hopper plan: (weight ring stages, y stages a consumer, dynamic
    shared-memory bytes, blocks, rows a block) for Dp lanes and M rows on
    ``sms`` SMs; all 0 where the first form serves. Shared memory: the bf16
    h1 of a 128-row tile, the {s, s, b, b} table (8 bytes a column), the
    output staging, as many weight stages (192 x 128 bytes and two
    mbarriers each) as fit beside two y stages a consumer (at most 8, at
    least 3), then as many y stages (32·Dp bytes and two mbarriers each) as
    are left room for (at most 4). Each block takes a contiguous run of
    ceil(M / sms) rows (at least 64), walked in tiles of 128."""
    if vit_pre_w4_form(dp) != "hopper":
        return 0, 0, 0, 0, 0
    fixed = K5_TILE * dp * 2 + 3 * dp * 8 + K5_STAGING
    ystage, stage = K5_Y_BYTES * dp + 16, K11_STAGE + 16
    stages = min(K11_MAX_STAGES, (SMEM_MAX - fixed - 2 * K5_MIN_Y * ystage) // stage)
    if stages < K11_MIN_STAGES:
        return 0, 0, 0, 0, 0
    ny = min(K5_MAX_Y, (SMEM_MAX - fixed - stages * stage) // (2 * ystage))
    rows = max(_cdiv(m, sms), 64)
    return stages, ny, fixed + stages * stage + 2 * ny * ystage, _cdiv(m, rows), rows


def vit_block_pre_w4(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """LN1 + QKV of one W4A16 layer (K11; ``pack_vit_blocks_w4`` weights) on
    the padded stream y [B, Np, Dp] (bf16 or fp32); returns bf16 qkv
    [B, Np, 3·Dp]. ``.by_form`` counts launches per form."""
    if y.device.type == "cpu":
        return vit_block_pre_w4_plain(y, w, d_valid)
    out = _pre(vit_block_pre_w4, "vit_pre_w4", y, w, d_valid)
    vit_block_pre_w4.by_form[library_form("vit_pre_w4", y.shape[-1])] += 1
    return out


def vit_block_pre_w4_first(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """K11's first form at any Dp (a CUDA tensor only; not counted): what
    the card tests and ``chip_smoke.py`` hold the Hopper form to (the same
    LN and epilogue, fp32 sums in another order)."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_pre_w4_first: a CUDA tensor (the kernel's first form)")
    return _launch_pre("vit_pre_w4", y, w, d_valid, "_first")


# K14's Hopper form is K11's body (csrc/vit_pre_hw.cuh): the same stages of
# 192 columns x 128 bytes (64 bf16 K values a row, copied, not unpacked), so
# the same rule and plan
vit_pre_bf16_form = vit_pre_w4_form
vit_pre_bf16_plan = vit_pre_w4_plan


def vit_block_pre_bf16(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """LN1 + QKV of one bf16 layer (K14; ``pack_vit_blocks`` weights) on the
    padded stream y [B, Np, Dp] (bf16 or fp32); returns bf16 qkv
    [B, Np, 3·Dp]. ``.by_form`` counts launches per form."""
    if y.device.type == "cpu":
        return vit_block_pre_bf16_plain(y, w, d_valid)
    out = _pre(vit_block_pre_bf16, "vit_pre_bf16", y, w, d_valid)
    vit_block_pre_bf16.by_form[library_form("vit_pre_bf16", y.shape[-1])] += 1
    return out


def vit_block_pre_bf16_first(y: torch.Tensor, w: Block, d_valid: int) -> torch.Tensor:
    """K14's first form at any Dp (a CUDA tensor only; not counted): what
    the card tests and ``chip_smoke.py`` hold the Hopper form to (the same
    LN and epilogue, fp32 sums in another order)."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_pre_bf16_first: a CUDA tensor (the kernel's first form)")
    return _launch_pre("vit_pre_bf16", y, w, d_valid, "_first")


for _f in (vit_block_pre_w8, vit_block_pre_w4a8, vit_block_pre_w4, vit_block_pre_bf16):
    _f.launches = 0
    _f.by_shape = collections.Counter()
    _f.by_form = collections.Counter()


# ---------------------------------------------------------------------------
# K7 / K9 / K12 / K15: proj + residual + LN2 + MLP + residual
# ---------------------------------------------------------------------------

def vit_block_post_plain(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                         gelu_tanh: bool = True, out_dtype: Optional[torch.dtype] = None,
                         multi: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K7 and, on a W4A8 pack, of K9 (arguments
    as ``vit_block_post_w8``)."""
    inv = w["inv_act"]
    xf = y.float()
    acc = _igemm(_quant_i8(attn.float(), inv[1]), w["wproj"])
    z1 = xf + _epi(acc, w["sproj"], w["bproj"])
    h2 = _ln_f32(z1, w["ln2"][0], w["ln2"][1], d_valid)
    f = _epi(_igemm(_quant_i8(h2, inv[2]), w["wfc1"]), w["sfc1"], w["bfc1"])
    acc = _igemm(_quant_i8(_gelu_f32(f, gelu_tanh), inv[3]), w["wfc2"])
    if multi:
        out = z1 + _epi(acc, w["sfc2"], w["bfc2"])
    else:
        out = torch.addcmul(z1, acc, w["sfc2"]) + w["bfc2"]
    return out.to(y.dtype if out_dtype is None else out_dtype)


@functools.cache
def _post_entry(name: str, suffix: str = ""):
    """The launch entry of K7, K9, K12 or K15 (K12 and K15 take no inverse
    activation scales, and each has its format's one FC2 association; K15's
    scale pointers are null); ``suffix`` "_first": K9's, K12's or K15's
    first form."""
    quant = name in QUANT
    fn = getattr(_build.library(name), f"dlq_{name}{suffix}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_float] * (4 if quant else 0) + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * (7 if quant else 6) + [ctypes.c_void_p])
    return fn


def _post(wrapper, name: str, y: torch.Tensor, attn: torch.Tensor, w: Block,
          d_valid: int, gelu_tanh: bool, out_dtype: torch.dtype, multi: bool) -> torch.Tensor:
    """Launch K7 (``name`` "vit_post_w8"), K9 ("vit_post_w4a8"), K12
    ("vit_post_w4") or K15 ("vit_post_bf16"; ``multi`` is bound to the
    format for the last two) and count it on ``wrapper``."""
    out = _launch_post(name, y, attn, w, d_valid, gelu_tanh, out_dtype, multi)
    B, Np, Dp = y.shape
    Hp = w["wfc1"].shape[0]
    wrapper.launches += 1
    wrapper.by_shape[(B, Np, Dp, Hp, str(y.dtype)[6:], str(out_dtype)[6:])] += 1
    return out


def _launch_post(name: str, y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                 gelu_tanh: bool, out_dtype: torch.dtype, multi: bool,
                 suffix: str = "") -> torch.Tensor:
    B, Np, Dp = y.shape
    Hp = w["wfc1"].shape[0]
    _check_stream(name, y, y.device, (torch.bfloat16, torch.float32), Dp)
    _check_stream(name, attn, y.device, (torch.bfloat16,), Dp)
    if (attn.shape != y.shape or attn.data_ptr() % 16
            or out_dtype not in (torch.bfloat16, torch.float32)
            or not _weight_shape(w["wproj"], Dp, Dp, name)
            or not _weight_shape(w["wfc1"], Hp, Dp, name)
            or not _weight_shape(w["wfc2"], Dp, Hp, name) or Dp % 64 or Hp % 64):
        raise ValueError(f"{name}: y {tuple(y.shape)}, attn {tuple(attn.shape)}, "
                         f"Hp {Hp}, out {out_dtype}: Dp and Hp must be multiples of 64")
    sproj, sfc1, sfc2 = w.get("sproj"), w.get("sfc1"), w.get("sfc2")
    _check_scales(name, sproj, sfc1, sfc2)
    _check_params(name, y.device, w["wproj"], sproj, w["bproj"], w["ln2"],
                  w["wfc1"], sfc1, w["bfc1"], w["wfc2"], sfc2, w["bfc2"])
    out = torch.empty((B, Np, Dp), dtype=out_dtype, device=y.device)
    quant = name in QUANT
    rc = _post_entry(name, suffix)(
        y.data_ptr(), int(y.dtype == torch.float32), attn.data_ptr(),
        *(w["inv_act"] if quant else ()),
        w["wproj"].data_ptr(), _ptr(sproj), w["bproj"].data_ptr(),
        w["ln2"].data_ptr(), w["wfc1"].data_ptr(), _ptr(sfc1), w["bfc1"].data_ptr(),
        w["wfc2"].data_ptr(), _ptr(sfc2), w["bfc2"].data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), B * Np, Dp, Hp, d_valid, int(gelu_tanh),
        *((int(multi),) if quant else ()), _build.stream_ptr(y.device))
    _build.check(rc, name + suffix)
    return out


# K7's and K9's launch plan on Hopper (Dp 128, 192, 256; csrc/vit_post_iw.cuh's
# make_plan, which the card tests hold to this): 128-row tiles, int8 weight
# stages of Dp x 64 bytes, chunks of 64 hidden lanes
K7_TILE, K7_STAGE_K, K7_CHUNK, K7_MAX_STAGES, K7_MIN_STAGES = 128, 64, 64, 8, 3


def vit_post_w8_plan(dp: int, hp: int, m: int, sms: int) -> Tuple[int, int, int, int]:
    """K7's and K9's Hopper plan: (ring stages, dynamic shared-memory bytes,
    blocks, rows a block) for Dp and Hp lanes and M rows on ``sms`` SMs;
    all 0 where the first form serves (Dp other than 128, 192, 256, Hp not a
    multiple of the 64-lane chunk, or fewer than 3 stages). Shared memory:
    z1 in fp32, the int8 codes of attn/LN2 and of one GELU chunk for the
    128-row tile, the scales and biases of proj, FC2 and FC1 (8 bytes a
    lane), then as many Dp x 64-byte int8 weight stages as fit (at most 8)
    with two 8-byte mbarriers each (K9's producer unpacks its int4 bytes
    into the same stages). Each block takes a contiguous run of ceil(M /
    sms) rows (at least 64), walked in tiles of 128, the last one short."""
    if dp not in K5_HOPPER_DP or hp <= 0 or hp % K7_CHUNK:
        return 0, 0, 0, 0
    fixed = K7_TILE * dp * 4 + K7_TILE * dp + K7_TILE * K7_CHUNK + (2 * dp + hp) * 8
    stage = dp * K7_STAGE_K
    stages = min(K7_MAX_STAGES, (SMEM_MAX - fixed - 2 * 8 * K7_MAX_STAGES) // stage)
    if stages < K7_MIN_STAGES:
        return 0, 0, 0, 0
    rows = max(_cdiv(m, sms), 64)
    return stages, fixed + stages * stage + 2 * 8 * stages, _cdiv(m, rows), rows


vit_post_w4a8_plan = vit_post_w8_plan


def vit_block_post_w8(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                      gelu_tanh: bool = True, out_dtype: Optional[torch.dtype] = None,
                      multi: bool = False) -> torch.Tensor:
    """proj + residual + LN2 + MLP + residual of one layer (K7): y [B, Np, Dp]
    bf16 or fp32, attn bf16. The defaults are the reference function's
    (``vit_block_post_w8``: output in ``y.dtype``, FC2 residual
    ``fma(acc, s, z1) + b``); ``multi`` takes the stacked kernel's
    ``z1 + fma(acc, s, b)`` and ``out_dtype`` its fp32 in-chunk stream."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if y.device.type == "cpu":
        return vit_block_post_plain(y, attn, w, d_valid, gelu_tanh, out_dtype, multi)
    return _post(vit_block_post_w8, "vit_post_w8", y, attn, w, d_valid, gelu_tanh,
                 out_dtype, multi)


def vit_post_w4a8_form(dp: int, hp: int) -> str:
    """K9's form (and K7's), a static shape rule: ``"hopper"`` where the
    plan fits (DeiT-Tiny's 192/768 and 256/768), else ``"first"``
    (vit_post.cuh's body)."""
    return "hopper" if vit_post_w4a8_plan(dp, hp, 1, 1)[0] else "first"


def vit_block_post_w4a8(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                        gelu_tanh: bool = True, out_dtype: Optional[torch.dtype] = None,
                        multi: bool = True) -> torch.Tensor:
    """The same on a W4A8 pack (K9). Every W4A8 reference function adds
    FC2's residual as ``z1 + fma(acc, s, b)`` (``pallas_vit_block.py:1542``,
    ``:1739``, ``:1896``), so ``multi`` defaults to True here. ``.by_form``
    counts launches per form."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if y.device.type == "cpu":
        return vit_block_post_plain(y, attn, w, d_valid, gelu_tanh, out_dtype, multi)
    out = _post(vit_block_post_w4a8, "vit_post_w4a8", y, attn, w, d_valid, gelu_tanh,
                out_dtype, multi)
    vit_block_post_w4a8.by_form[
        library_form("vit_post_w4a8", y.shape[-1], w["wfc1"].shape[0])] += 1
    return out


def vit_block_post_w4a8_first(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                              gelu_tanh: bool = True, out_dtype: Optional[torch.dtype] = None,
                              multi: bool = True) -> torch.Tensor:
    """K9's first form at any Dp (a CUDA tensor only; not counted): what the
    card tests and ``chip_smoke.py`` hold the Hopper form to, bit for bit
    (exact int32 sums, the same roundings)."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_post_w4a8_first: a CUDA tensor (the kernel's first form)")
    return _launch_post("vit_post_w4a8", y, attn, w, d_valid, gelu_tanh,
                        y.dtype if out_dtype is None else out_dtype, multi, "_first")


# K12's and K15's Hopper form (csrc/vit_post_hw.cuh's make_plan, which the
# card test holds to this): 128-row tiles, chunks of 64 hidden lanes, weight
# stages of Dp rows x KS bytes of bf16 (KS 64 at Dp 128 and 192, 32 at 256)
K15_TILE, K15_CHUNK, K15_MAX_STAGES, K15_MIN_STAGES = 128, 64, 8, 3
K15_STAGE_K = {128: 64, 192: 64, 256: 32}


def vit_post_h_plan(dp: int, hp: int, m: int, sms: int) -> Tuple[int, int, int, int, int]:
    """K12's and K15's Hopper plan: (K bytes a stage row, ring stages,
    dynamic shared-memory bytes, blocks, rows a block) for Dp and Hp lanes
    and M rows on ``sms`` SMs; all 0 where no plan fits (the first form).
    Shared memory: z1 in fp32 and the bf16 A operand (attn, then LN2's
    output) for the 128-row tile, the scales and biases of proj, FC2 and
    FC1 (8 bytes a lane), then as many Dp x KS-byte weight stages as fit (at
    most 8, at least 3) with two 8-byte mbarriers each; the GELU chunk stays
    in registers. Each block takes a contiguous run of ceil(M / sms) rows
    (at least 64), walked in tiles of 128, the last one short."""
    ks = K15_STAGE_K.get(dp, 0)
    if ks == 0 or hp <= 0 or hp % K15_CHUNK:
        return 0, 0, 0, 0, 0
    fixed = K15_TILE * dp * 6 + (2 * dp + hp) * 8
    stage = dp * ks + 16
    stages = min(K15_MAX_STAGES, (SMEM_MAX - fixed) // stage)
    if stages < K15_MIN_STAGES:
        return 0, 0, 0, 0, 0
    rows = max(_cdiv(m, sms), 64)
    return ks, stages, fixed + stages * stage, _cdiv(m, rows), rows


def vit_post_h_form(dp: int, hp: int) -> str:
    """K12's and K15's form, a static shape rule: ``"hopper"`` where the
    Hopper plan fits (Dp 128, 192 or 256, Hp a multiple of 64, at least 3
    ring stages: DeiT-Tiny's 192/768 and 256/768), else ``"first"`` (the
    first form, vit_post_h.cuh's body)."""
    return "hopper" if vit_post_h_plan(dp, hp, 1, 1)[0] else "first"


def unpack_w4_bf16(wk: torch.Tensor) -> torch.Tensor:
    """uint8 [N, Kp/2] halves-packed K-major int4 -> bf16 [N, Kp]: the exact
    nibble values (-8..7), low halves then high halves along K. The plain
    version of what K12's Hopper producer writes into its bf16 weight
    stages (the reference's ``_unpack_halves_bf16``, K-major)."""
    return unpack_halves_kmajor(wk).to(torch.bfloat16)


def _post_w4_sums(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                  gelu_tanh: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12's (and, on a bf16 pack, K15's) plain arithmetic up to FC2's sum:
    (z1, acc_fc2), fp32."""
    z1 = y.float() + _epi(_hgemm(attn, w["wproj"]), w.get("sproj"), w["bproj"])
    h2 = _ln_f32(z1, w["ln2"][0], w["ln2"][1], d_valid).to(torch.bfloat16)
    f = _epi(_hgemm(h2, w["wfc1"]), w.get("sfc1"), w["bfc1"])
    return z1, _hgemm(_gelu_f32(f, gelu_tanh).to(torch.bfloat16), w["wfc2"])


def vit_block_post_w4_plain(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                            gelu_tanh: bool = True,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K12 (``_block_kernel_w4`` :1199-1207): the
    exact sums, each rounding of the reference (h2 and gelu's output to
    bf16), FC2's residual ``z1 + fma(acc, s, b)``."""
    z1, acc = _post_w4_sums(y, attn, w, d_valid, gelu_tanh)
    out = z1 + _epi(acc, w["sfc2"], w["bfc2"])
    return out.to(y.dtype if out_dtype is None else out_dtype)


def vit_block_post_w4(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                      gelu_tanh: bool = True,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """proj + residual + LN2 + MLP + residual of one W4A16 layer (K12): y
    [B, Np, Dp] bf16 or fp32, attn bf16; output in ``out_dtype`` (default
    ``y.dtype``). Every W4A16 reference function adds FC2's residual as
    ``z1 + fma(acc, s, b)`` (``pallas_vit_block.py:1206``, ``:1395``,
    ``:2038``), the only association K12 has."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if y.device.type == "cpu":
        return vit_block_post_w4_plain(y, attn, w, d_valid, gelu_tanh, out_dtype)
    out = _post(vit_block_post_w4, "vit_post_w4", y, attn, w, d_valid, gelu_tanh,
                out_dtype, True)
    vit_block_post_w4.by_form[
        library_form("vit_post_w4", y.shape[-1], w["wfc1"].shape[0])] += 1
    return out


def vit_block_post_bf16_plain(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                              gelu_tanh: bool = True,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K15 (``_block_kernel`` :309-320): the exact
    sums, the reference's roundings (h2 and gelu's output to bf16), FC2's
    residual before its bias, ``(z1 + acc) + b``."""
    z1, acc = _post_w4_sums(y, attn, w, d_valid, gelu_tanh)
    out = (z1 + acc) + w["bfc2"]
    return out.to(y.dtype if out_dtype is None else out_dtype)


def vit_block_post_bf16(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                        gelu_tanh: bool = True,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """proj + residual + LN2 + MLP + residual of one bf16 layer (K15;
    ``pack_vit_blocks`` weights): y [B, Np, Dp] bf16 or fp32, attn bf16;
    output in ``out_dtype`` (default ``y.dtype``, the reference's); FC2's
    residual ``(z1 + acc) + b``, the only association K15 has."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if y.device.type == "cpu":
        return vit_block_post_bf16_plain(y, attn, w, d_valid, gelu_tanh, out_dtype)
    out = _post(vit_block_post_bf16, "vit_post_bf16", y, attn, w, d_valid, gelu_tanh,
                out_dtype, False)
    vit_block_post_bf16.by_form[
        library_form("vit_post_bf16", y.shape[-1], w["wfc1"].shape[0])] += 1
    return out


def vit_block_post_w4_first(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                            gelu_tanh: bool = True,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K12's first form at any Dp (a CUDA tensor only; not counted): what the
    card tests and ``chip_smoke.py`` hold the Hopper form to (the same
    arithmetic, fp32 sums in another order)."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_post_w4_first: a CUDA tensor (the kernel's first form)")
    return _launch_post("vit_post_w4", y, attn, w, d_valid, gelu_tanh,
                        y.dtype if out_dtype is None else out_dtype, True, "_first")


def vit_block_post_bf16_first(y: torch.Tensor, attn: torch.Tensor, w: Block, d_valid: int,
                              gelu_tanh: bool = True,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K15's first form at any Dp (a CUDA tensor only; not counted), as
    ``vit_block_post_w4_first``."""
    if y.device.type != "cuda":
        raise ValueError("vit_block_post_bf16_first: a CUDA tensor (the kernel's first form)")
    return _launch_post("vit_post_bf16", y, attn, w, d_valid, gelu_tanh,
                        y.dtype if out_dtype is None else out_dtype, False, "_first")


for _f in (vit_block_post_w8, vit_block_post_w4a8, vit_block_post_w4, vit_block_post_bf16):
    _f.launches = 0
    _f.by_shape = collections.Counter()
vit_block_post_w4a8.by_form = collections.Counter()
vit_block_post_w4.by_form = collections.Counter()
vit_block_post_bf16.by_form = collections.Counter()


# ---------------------------------------------------------------------------
# compositions and forwards
# ---------------------------------------------------------------------------

def _qkv_slices(qkv: torch.Tensor, heads: int, hd: int):
    """The q, k and v lane slices [B, Np, heads·hd] of the [B, Np, 3·Dp]
    qkv stream (views, no copy)."""
    Dp = qkv.shape[-1] // 3
    hw = heads * hd
    return qkv[..., :hw], qkv[..., Dp: Dp + hw], qkv[..., 2 * Dp: 2 * Dp + hw]


def _attention(qkv: torch.Tensor, heads: int, hd: int, n_valid: int) -> torch.Tensor:
    """K6 on the three lane slices of the qkv stream; [B, Np, Dp] bf16 with
    the pad-head lanes zero."""
    return mhsa(*_qkv_slices(qkv, heads, hd), heads, n_valid, out_lanes=qkv.shape[-1] // 3)


def _attention_i8(qkv: torch.Tensor, heads: int, hd: int, n_valid: int) -> torch.Tensor:
    """K18 in its in-kernel form (the ``attn_int8`` arm,
    ``_mhsa_batched_i8_into_scratch``: the amax over every row of the
    padded stream) on the lane slices; [B, Np, Dp] bf16, pad-head lanes
    zero."""
    return mhsa_i8(*_qkv_slices(qkv, heads, hd), heads, n_valid, out_lanes=qkv.shape[-1] // 3)


def _layer(pre, post, y: torch.Tensor, w: Block, n_valid: int, d_valid: int, heads: int,
           hd: int, gelu_tanh: bool, out_dtype: torch.dtype, attend=_attention) -> torch.Tensor:
    """One layer as pre -> ``attend`` (K6, or K18 in either form) -> post
    (``post`` with its FC2 association bound)."""
    a = attend(pre(y, w, d_valid), heads, hd, n_valid)
    return post(y, a, w, d_valid, gelu_tanh, out_dtype)


def vit_block_fused(y: torch.Tensor, w: Block, *, n_valid: int, d_valid: int, heads: int,
                    hd: int, gelu_tanh: bool = True) -> torch.Tensor:
    """One bf16 transformer block (``_block_kernel``, row 14) as K14 -> K6
    -> K15 on the padded stream y [B, Np, Dp] (bf16 or fp32), output in
    ``y.dtype``; the reference's ``bt`` is TPU tiling and has no
    counterpart."""
    return _layer(vit_block_pre_bf16, vit_block_post_bf16, y, w, n_valid, d_valid, heads, hd,
                  gelu_tanh, y.dtype)


def vit_block_fused_w8(y: torch.Tensor, w: Block, *, n_valid: int, d_valid: int, heads: int,
                       hd: int, gelu_tanh: bool = True) -> torch.Tensor:
    """One W8A8 transformer block (``_block_kernel_w8``) as K5 -> K6 -> K7;
    output in ``y.dtype``, FC2 residual ``fma(acc, s, z1) + b``."""
    return _layer(vit_block_pre_w8, vit_block_post_w8, y, w, n_valid, d_valid, heads, hd,
                  gelu_tanh, y.dtype)


def vit_block_fused_w4a8(y: torch.Tensor, w: Block, *, n_valid: int, d_valid: int, heads: int,
                         hd: int, gelu_tanh: bool = True) -> torch.Tensor:
    """One W4A8 transformer block as K8 -> K6 -> K9, output in ``y.dtype``,
    FC2 residual ``z1 + fma(acc, s, b)``. Ports both ``vit_block_fused_w4a8``
    and ``vit_block_fused_w4a8c``: the same function, bit-identical in the
    reference (the ``c`` kernel only caches the nibble unpack across TPU grid
    steps; its ``bt`` is TPU tiling with no numeric effect)."""
    return _layer(vit_block_pre_w4a8, vit_block_post_w4a8, y, w, n_valid, d_valid, heads, hd,
                  gelu_tanh, y.dtype)


vit_block_fused_w4a8c = vit_block_fused_w4a8


def vit_block_fused_w4(y: torch.Tensor, w: Block, *, n_valid: int, d_valid: int, heads: int,
                       hd: int, gelu_tanh: bool = True) -> torch.Tensor:
    """One W4A16 transformer block as K11 -> K6 -> K12, output in
    ``y.dtype``, FC2 residual ``z1 + fma(acc, s, b)``. Ports both
    ``vit_block_fused_w4`` (row 19) and ``vit_block_fused_w4c`` (row 24, the
    engine's): one function, bit-identical in the reference
    (``tests/test_vit_blockfused.py:654``); the ``c`` kernel only caches the
    unpack across TPU grid steps and ``bt`` is TPU tiling."""
    return _layer(vit_block_pre_w4, vit_block_post_w4, y, w, n_valid, d_valid, heads, hd,
                  gelu_tanh, y.dtype)


vit_block_fused_w4c = vit_block_fused_w4


def _multiblock(pre, post, y: torch.Tensor, chunk: List[Block], n_valid: int, d_valid: int,
                heads: int, hd: int, gelu_tanh: bool, attend=_attention) -> torch.Tensor:
    """L stacked layers: the residual is fp32 between the chunk's layers,
    ``y.dtype`` at its end; ``post`` adds FC2's residual as
    ``z1 + fma(acc, s, b)``."""
    x = y
    for l, w in enumerate(chunk):
        last = l == len(chunk) - 1
        x = _layer(pre, post, x, w, n_valid, d_valid, heads, hd, gelu_tanh,
                   y.dtype if last else torch.float32, attend)
    return x


def vit_multiblock_fused_w8(y: torch.Tensor, chunk: List[Block], *, n_valid: int,
                            d_valid: int, heads: int, hd: int, gelu_tanh: bool = True,
                            attn_int8: bool = False) -> torch.Tensor:
    """One chunk of L stacked W8A8 layers (``_multiblock_kernel_w8``), K5 ->
    K6 -> K7 per layer; with ``attn_int8`` the reference's int8-attention
    arm, K5 -> K18 (in-kernel form) -> K7."""
    return _multiblock(vit_block_pre_w8, functools.partial(vit_block_post_w8, multi=True), y,
                       chunk, n_valid, d_valid, heads, hd, gelu_tanh,
                       _attention_i8 if attn_int8 else _attention)


def vit_multiblock_fused_w4a8(y: torch.Tensor, chunk: List[Block], *, n_valid: int,
                              d_valid: int, heads: int, hd: int,
                              gelu_tanh: bool = True) -> torch.Tensor:
    """One chunk of L stacked W4A8 layers (``_multiblock_kernel_w4a8``),
    K8 -> K6 -> K9 per layer; the reference's ``bt`` has no counterpart."""
    return _multiblock(vit_block_pre_w4a8, vit_block_post_w4a8, y, chunk, n_valid, d_valid,
                       heads, hd, gelu_tanh)


def vit_multiblock_fused_w4(y: torch.Tensor, chunk: List[Block], *, n_valid: int,
                            d_valid: int, heads: int, hd: int,
                            gelu_tanh: bool = True) -> torch.Tensor:
    """One chunk of L stacked W4A16 layers (``_multiblock_kernel_w4``, row
    20), K11 -> K6 -> K12 per layer, the residual fp32 inside the chunk."""
    return _multiblock(vit_block_pre_w4, vit_block_post_w4, y, chunk, n_valid, d_valid, heads,
                       hd, gelu_tanh)


def _forward(blocks, step, packed: Dict[str, Any], x: torch.Tensor, cfg, tight: bool,
             gelu_tanh: bool) -> torch.Tensor:
    """Token stream -> ``step`` over ``blocks`` (layers or chunks) -> head."""
    y = _token_stream(packed, x, cfg, tight)
    for w in blocks:
        y = step(y, w, n_valid=cfg.seq_len, d_valid=cfg.dim, heads=cfg.heads,
                 hd=cfg.dim // cfg.heads, gelu_tanh=gelu_tanh)
    return _head(packed, y, cfg)


def vit_forward_multiblock_w8(packed: Dict[str, Any], x: torch.Tensor, cfg,
                              layers_per_kernel: int = 12, gelu_tanh: bool = True,
                              tight: bool = True, attn_int8: bool = False) -> torch.Tensor:
    """W8A8 forward on chunks of ``layers_per_kernel`` layers (``packed``
    from ``pack_vit_blocks_w8(..., tight=tight)``; precomputed chunks under
    ``"_chunks"`` are used as they are); ``attn_int8`` runs every layer's
    attention as K18. fp32 logits."""
    chunks = packed.get("_chunks") or stack_vit_blocks_w8(packed, layers_per_kernel)
    return _forward(chunks, functools.partial(vit_multiblock_fused_w8, attn_int8=attn_int8),
                    packed, x, cfg, tight, gelu_tanh)


def vit_forward_multiblock_w4a8(packed: Dict[str, Any], x: torch.Tensor, cfg,
                                layers_per_kernel: int = 6, gelu_tanh: bool = True,
                                tight: bool = True) -> torch.Tensor:
    """W4A8 forward on chunks of ``layers_per_kernel`` layers (``packed``
    from ``pack_vit_blocks_w4a8``). fp32 logits."""
    chunks = packed.get("_chunks") or stack_vit_blocks_w4a8(packed, layers_per_kernel)
    return _forward(chunks, vit_multiblock_fused_w4a8, packed, x, cfg, tight, gelu_tanh)


def vit_forward_multiblock_w4(packed: Dict[str, Any], x: torch.Tensor, cfg,
                              layers_per_kernel: int = 6, gelu_tanh: bool = True,
                              tight: bool = True) -> torch.Tensor:
    """W4A16 forward on chunks of ``layers_per_kernel`` layers (``packed``
    from ``pack_vit_blocks_w4``). fp32 logits."""
    chunks = packed.get("_chunks") or stack_vit_blocks_w4(packed, layers_per_kernel)
    return _forward(chunks, vit_multiblock_fused_w4, packed, x, cfg, tight, gelu_tanh)


def vit_forward_blockfused(packed: Dict[str, Any], x: torch.Tensor, cfg,
                           gelu_tanh: bool = True, tight: bool = False) -> torch.Tensor:
    """The bf16 deploy forward (``pallas_vit_block.py:1116``): the token
    stream, one ``vit_block_fused`` (K14 -> K6 -> K15) per layer with the
    residual bf16 between layers, the final norm and the fp32 head.
    ``packed`` from ``pack_vit_blocks(..., tight=tight)``. fp32 logits."""
    return _forward(packed["blocks"], vit_block_fused, packed, x, cfg, tight, gelu_tanh)


def vit_forward_blockfused_w8(packed: Dict[str, Any], x: torch.Tensor, cfg,
                              gelu_tanh: bool = True, tight: bool = False) -> torch.Tensor:
    """W8A8 forward one block at a time (``vit_block_fused_w8``: the residual
    is bf16 between layers). ``tight`` must match the packing. fp32 logits."""
    return _forward(packed["blocks"], vit_block_fused_w8, packed, x, cfg, tight, gelu_tanh)


def vit_block_w8_splitattn(y: torch.Tensor, w: Block, *, n_valid: int, d_valid: int,
                           heads: int, hd: int, gelu_tanh: bool = True,
                           attn: str = "int8") -> torch.Tensor:
    """The W8A8 block with attention outside the block kernels
    (``pallas_vit_block.py:1058``): K5, then on the qkv lane slices
    ``attention_int8_dynamic(..., n_valid, out_dtype=bf16)`` (``attn``
    "int8": K18, zero-pad form) or ``attention_bf16_masked`` ("bf16": K6),
    zero-padded to Dp lanes, then K7's single-block form (output in
    ``y.dtype``, FC2 residual ``fma(acc, s, z1) + b``). The "bf16" arm is
    ``vit_block_fused_w8``, launch for launch."""
    if attn not in ("int8", "bf16"):
        raise ValueError(f"vit_block_w8_splitattn: attn 'int8' or 'bf16', got {attn!r}")
    fn = attention_int8_dynamic if attn == "int8" else attention_bf16_masked

    def attend(qkv, heads, hd, n_valid):
        return fn(*_qkv_slices(qkv, heads, hd), heads, n_valid, out_dtype=torch.bfloat16,
                  out_lanes=qkv.shape[-1] // 3)

    return _layer(vit_block_pre_w8, vit_block_post_w8, y, w, n_valid, d_valid, heads, hd,
                  gelu_tanh, y.dtype, attend)


def vit_forward_blockfused_w8_split(packed: Dict[str, Any], x: torch.Tensor, cfg,
                                    gelu_tanh: bool = True, tight: bool = False,
                                    attn: str = "int8") -> torch.Tensor:
    """W8A8 forward on the split-attention block (``pallas_vit_block.py:
    1087``; ``pack_vit_blocks_w8`` payload, the reference's defaults: loose
    pads, int8 attention), bf16 between layers. fp32 logits."""
    return _forward(packed["blocks"], functools.partial(vit_block_w8_splitattn, attn=attn),
                    packed, x, cfg, tight, gelu_tanh)


def vit_forward_blockfused_w4a8(packed: Dict[str, Any], x: torch.Tensor, cfg,
                                gelu_tanh: bool = True, tight: bool = True) -> torch.Tensor:
    """W4A8 forward one block at a time (K8 -> K6 -> K9 per layer, bf16
    between layers): ``vit_forward_blockfused_w4a8`` and
    ``vit_forward_blockfused_w4a8c`` (the engine's), one function. fp32
    logits."""
    return _forward(packed["blocks"], vit_block_fused_w4a8, packed, x, cfg, tight, gelu_tanh)


vit_forward_blockfused_w4a8c = vit_forward_blockfused_w4a8


def vit_forward_blockfused_w4(packed: Dict[str, Any], x: torch.Tensor, cfg,
                              gelu_tanh: bool = True, tight: bool = True) -> torch.Tensor:
    """W4A16 forward one block at a time (K11 -> K6 -> K12 per layer, bf16
    between layers): ``vit_forward_blockfused_w4`` and
    ``vit_forward_blockfused_w4c`` (the engine's, ``deit_tiny_block_w4``),
    one function. fp32 logits."""
    return _forward(packed["blocks"], vit_block_fused_w4, packed, x, cfg, tight, gelu_tanh)


vit_forward_blockfused_w4c = vit_forward_blockfused_w4
