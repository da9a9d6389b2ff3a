"""Smoke run of the PyTorch/CUDA port on one GPU (ResNet-18, ResNet-50 and
DeiT-Tiny W8A8, DeiT-Tiny W4A8, DeiT-Tiny W4A16, DeiT-Tiny bf16 and the
fused LayerNorms, DeiT-Tiny W8A8 with int8 attention, 224 px; and the four
lowering probes).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, one JSON line each:
  1. environment: torch, nvcc, the card's name and power limit, kernel build time;
  2. every kernel (K1 conv_int8, K2 matmul_int8, K3 basic_block, K4
     bottleneck_block) at every distinct shape and epilogue the main paths of
     both models give it at batch 256, held against its plain PyTorch version
     on the card (int8 and fp32 outputs bit-identical), with CUDA-event times
     of the kernel, the plain version, the library call where one exists
     (torch._int_mm for K2), and the least time the card could take (the bound);
  3. the main path of each model: seeded random weights calibrated and
     quantized with Engine.quantized, saved as a store, loaded with
     Engine.from_store(ctx="fused2") and driven through classify; gates:
     logits cosine >= 0.999 against the port's fp32 engine and, on
     ResNet-18, top-1 agreement 1.0 as bench.py gates it (ResNet-50's
     random-weight logits pick one or two classes for the whole batch, with
     runner-up margins below the int8 logit error, so its agreement is
     reported with those margins); on both, the same forward through the
     kernels' plain versions on the card gives bit-identical int8 stage
     outputs and logits;
     launch counts per forward, per kernel and per shape; then a
     torch.profiler window over a few forwards (device time by kernel,
     device idle share);
  4. the same store under PallasBlockCtx (identity BasicBlocks as K3,
     identity Bottlenecks as K4), gated against fused2 (logits; int8 stage
     outputs on ResNet-18, each K4 block against its FullFusedCtx
     composition on ResNet-50) and its plain-version twin, with its own
     profile;
  5. ctx="deploy" and ctx="pallas" at batch 64, gated as fused2;
  6. DeiT-Tiny (224 px, dim 192, depth 12, 3 heads, 1000 classes, seeded
     random weights): K5 vit_pre_w8, K6 mhsa and K7 vit_post_w8 at every
     shape of its block path and K2 at its deploy shapes, at batch 256,
     held against their plain versions (>= 0.999 of the outputs equal, the
     rest one rounding step apart: the kernels sum in another order), with
     torch._int_mm and scaled_dot_product_attention as yardsticks; then
     Engine.quantized, save_quantized with extras, Engine.from_store(
     ctx="block") driven through classify (K5, K6, K7 12 launches each per
     forward), gated against the fp32 forward (cosine >= 0.998: the
     reference's own W8A8 error on random weights) and its plain-version
     twin (cosine >= 0.9999), with top-1 reported beside the fp32 margins,
     and profiled; vit_forward_blockfused_w8 (one layer per
     launch chain, bf16 between layers) and ctx="deploy" (K2 50 and K6 12
     per forward) at batch 64, gated the same way;
  7. DeiT-Tiny W4A8 (the same weights quantized INT4A8_PER_CHANNEL): K8
     vit_pre_w4a8 and K9 vit_post_w4a8 at every dtype form of its block
     layer and K10 matmul_int4a8 at its six deploy shapes, at batch 256,
     against their plain versions (K10 bit-identical), with torch._int_mm
     on the materialized int8 weights as the yardstick; then the store
     through Engine.from_store(ctx="block") (K8, K6, K9 12 launches each per
     forward, bf16 between layers) driven through classify, gated against
     the fp32 forward (cosine >= DEIT_W4A8_FP32_COS: the reference's own
     W4A8 error on random weights), its plain-version twin and per layer,
     and profiled; ctx="deploy" at batch 64 with int4_runtime="packed" (K10
     50 per forward) and "int8" (K2 50), whose logits must be bit-identical,
     each then timed at batch 256 (the "packed" forward also profiled);
     and ctx="block" with int4_runtime="int8" (the W8 path: K5, K6, K7);
  8. DeiT-Tiny W4A16 (the same weights quantized weight-only): K11
     vit_pre_w4 and K12 vit_post_w4 at every dtype form of its block layer
     and K13 matmul_int4 at its two G128 deploy shapes, at batch 256,
     against their plain versions (fp32 sums in another order: W4A16_TOL,
     K13_REL), with a bf16 torch.matmul on the dequantized weights as the
     yardstick; then an INT4_WEIGHT_ONLY_PER_OC store through
     Engine.from_store(ctx="block") (deit_tiny_block_w4: K11, K6, K12 12
     launches each per forward, 4-bit weights) driven through classify,
     gated against the fp32 forward (DEIT_W4A16_FP32_COS: the reference's
     own weight-only error), its plain-version twin and per layer, and
     profiled; an INT4_WEIGHT_ONLY_G128 store through ctx="deploy" at batch
     64 (K13 13 launches per forward), gated the same way
     (DEIT_G128_FP32_COS), then timed at batch 256 and profiled; then group-wise int4
     sites with and without activation scales on the card (K13, or the
     dequantized route where K13 does not tile the group);
  9. DeiT-Tiny bf16 and the fused LayerNorms (the same fp32 weights): K14
     vit_pre_bf16 and K15 vit_post_bf16 at the tight (200/192) and loose
     (256/256) pads, K6 at 256 rows, K16 layernorm_fused and K17
     residual_layernorm at [256 x 197, 192] in fp32 and bf16 and K6's fp32
     form mhsa_f32 at [256, 197, 3 x 64], at batch 256, against their plain
     versions (BF16_TOL, LN_TOL, MHSA_F32_TOL), with bf16 torch.matmul,
     F.layer_norm and scaled_dot_product_attention as yardsticks; then
     vit_forward_blockfused (pack_vit_blocks; K14, K6, K15 12 launches each
     per forward) through Engine.fp32 and classify at batch 256 with loose
     and tight pads, gated against the fp32 forward (DEIT_BF16_FP32_COS: the
     reference's own bf16 error), its plain-version twin and per layer, the
     two pads against each other, and profiled; the fp32 forward with
     fused_ln=True, attn_impl="fused" at batch 64 (K16 1, K17 24, mhsa_f32 12
     per forward) against the unfused fp32 forward (max_abs < 1e-5); and the
     W8A8 deploy forward with fused_ln=True at batch 64 (K2 50, K6 12, K16 1,
     K17 24) against the unfused deploy forward (DEIT_FUSED_LN_COS) and fp32;
 10. DeiT-Tiny W8A8 with int8 attention: K18 mhsa_i8 in its in-kernel form
     on the tight block stream and its zero-pad form on the split path's
     loose stream and on the deploy path's qkv dense (bf16, and fp32), at
     batch 256, against its plain version (>= 0.99 of the outputs equal,
     the rest within 2 av / 127), with bf16 SDPA as the yardstick (no
     PyTorch call computes int8 attention); then, inside phase 6 on its
     W8A8 store, vit_forward_multiblock_w8(attn_int8=True) (tight pads, 6
     layers per chunk; K5, K18, K7 12 launches each per forward, K6 none)
     through Engine and classify at batch 256, gated against the fp32
     forward (DEIT_ATTN_INT8_FP32_COS: the reference's own int8-attention
     error), its plain-version twin and per layer, timed in turns with the
     bf16-attention block engine and profiled; at batch 64 the
     split-attention forward (loose pads) with attn="int8" (K18) and
     "bf16" (K6; bit-identical to vit_forward_blockfused_w8), and
     make_qforward(attn_impl="xla_int8") under DeployCtx (K2 50, K18 12);
 11. the probes (K19 probe_mosaic, K20 probe_batched_dot, K21 probe_block,
     K22 probe_stem: the ports of tools/probe_*.py): the probe entry point
     itself, each module's results() (its main() without the exit status)
     on the card with every count set to 0 just before and read just after:
     every one of the 23 patterns once at the reference's shapes on its
     numpy-seeded inputs, held against the reference's numpy expectation
     with the reference's own check and against its plain version by its
     own limit (identical for integer and copy patterns; rel 1e-4 for an
     fp32 output, one bf16 step on at most 1% of a bf16 output); then each
     pattern timed on a spinning card (device time of back-to-back
     launches: the kernels are microseconds long, shorter than their
     wrappers' host cost) beside the plain version, the bound and the one
     PyTorch call where one computes the same function.
Each main path is driven with every launch count set to 0 just before it
and read just after. Then the card's name and power limit, the kernel
summary line and, last, {"ok": true, "device": {...}}. Any failed gate
raises before those lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 (hopper-kernels guide table)
PEAK_BF16 = 989e12        # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
PEAK_FP32 = 67e12         # H100 SXM fp32 outside the tensor cores
BATCH = 256
SEED = 0
NB = 4                    # classify batches per main path
NO_INT8_CONV = "none: no PyTorch call computes an int8 conv with int32 accumulation on CUDA"
INT_MM = "torch._int_mm (int32 product only, no epilogue)"
SDPA = "torch.nn.functional.scaled_dot_product_attention (bf16 [B, heads, N, hd], no mask)"
HMM = "torch.matmul in bf16 on the dequantized bf16 weights (no epilogue)"
BMM = "torch.matmul in bf16 on the same bf16 weights (no epilogue)"
LAYER_NORM = "torch.nn.functional.layer_norm (mean/variance form)"
SDPA_F32 = "torch.nn.functional.scaled_dot_product_attention (fp32 [B, heads, N, hd], no mask)"
VIT_TOL = (0.999, 0.0625)  # ViT kernels vs plain: fraction equal, largest difference
DEIT_FP32_COS = 0.998      # DeiT-Tiny W8A8 logits vs fp32 (see deit_paths)
DEIT_TWIN_COS = 0.999      # DeiT-Tiny logits vs the plain-version twin (see deit_paths)
# DeiT-Tiny W4A8 logits vs fp32: the reference's own INT4A8 deploy forward
# on these random weights is at cosine 0.95484 (16 images) and 0.95645 (256)
# on the CPU (tools/deit_reference_error.py), top-1 0.56-0.57
DEIT_W4A8_FP32_COS = 0.95
# DeiT-Tiny W4A16 logits vs fp32, just under the reference's own weight-only
# deploy forward on these random weights (tools/deit_reference_error.py, 16
# images, CPU; PERF.md, Findings): INT4_WEIGHT_ONLY_PER_OC at cosine 0.95648
# (top-1 0.5) for the block path, INT4_WEIGHT_ONLY_G128 at 0.98209 (top-1
# 0.9375) for the G128 deploy path
DEIT_W4A16_FP32_COS = 0.95
DEIT_G128_FP32_COS = 0.98
# W4A16 kernels vs plain (fp32 sums in another order, nothing quantized to
# int8): bf16 outputs as VIT_TOL; fp32 outputs: the fraction within
# 2^-12 x (1 + |plain|), none more than VIT_TOL[1] apart
W4A16_TOL = {"bf16": VIT_TOL, "fp32": (VIT_TOL[0], VIT_TOL[1], 2.0 ** -12)}
# K13 vs plain: each output within 2^-14 of the sum of its products'
# magnitudes (fp32 sums of exact products in another order)
K13_REL = 2.0 ** -14
# the bf16 block kernels K14/K15 vs plain (bf16 outputs): fp32 sums of exact
# bf16 products in another order, as W4A16. The sums of bf16 x bf16
# products (16 significant bits each, where bf16 x int4 has 12) round more
# often than K11/K12's, and K15's bf16 output also carries the one-step
# flips of its two bf16 intermediates (LN2's output, GELU's) through the
# 768-term FC2 sums: 0.99818 (tight) and 0.99872 (loose) of its outputs
# equal on an H100. K15's row carries the witness (check_bf16_kernels;
# PERF.md, Findings): on the same layer and inputs, K12 with the weights
# rounded to int4 agrees on 0.99978 / 0.99984, and the plain version in
# cuBLAS's fp32 order on 0.99912 / 0.99941 (bf16) against 0.99998 (int4).
# So >= 0.997 of bf16 outputs equal, none more than VIT_TOL[1] apart
BF16_TOL = (0.997, VIT_TOL[1])
# K16/K17 vs plain: fp32 outputs within 2^-19 x (1 + |plain|) (rsqrtf and the
# lane-order moment sums: a few ulp), bf16 outputs as VIT_TOL
LN_TOL = {"float32": (1.0, 1e-4, 2.0 ** -19), "bfloat16": VIT_TOL}
# mhsa_f32 vs plain: fp32 products and sums in another order; every output
# (an average of unit-scale V rows) within 1e-5 x (1 + |plain|)
MHSA_F32_TOL = (1.0, 1e-5, 1e-5)
# DeiT-Tiny bf16 block forward vs fp32 (tanh GELU), just under the
# reference's own vit_forward_blockfused on these random weights
# (tools/deit_reference_error.py, 16 images, CPU; PERF.md, Findings)
DEIT_BF16_FP32_COS = 0.9999
DEIT_BF16_TWIN_COS = 0.9999    # vs its plain-version twin, and tight vs loose pads
# DeiT-Tiny W8A8 deploy with fused_ln vs the unfused deploy forward: the two
# LayerNorm forms round differently on a bf16 stream, both the reference's;
# its own two forms sit at cosine 0.99810 of each other on these random
# weights (tools/deit_reference_error.py), so the gate leaves room below that
DEIT_FUSED_LN_COS = 0.997
FUSED_LN_MAX_ABS = 1e-5        # fp32 fused_ln forward vs unfused (the reference's gate)
# one block-path layer (K5 -> K6 -> K7) vs its plain versions on the same
# input: an int8 code that lands one step apart (another sum order in LN,
# softmax or the bf16 rounding of attn) moves its whole row of the layer's
# fp32 output by about one FC2 step (~0.003), so >= 0.97 of valid outputs
# are equal and none is more than VIT_TOL[1] apart
LAYER_TOL = (0.97, VIT_TOL[1])

# K18 vs plain (both forms): >= 0.99 of the outputs equal, every other one
# within 2 av / 127 of the plain value (av: that (sample, head)'s V amax; a
# probability code flipped by expf or the row sum's order moves its row by
# at most av / 127)
I8_ATTN_EQUAL = 0.99
NO_INT8_ATTN = ("none: no PyTorch call computes int8 attention; sdpa_bf16_ms is bf16 SDPA at "
                "the same shape, the yardstick of K6's row")
# DeiT-Tiny W8A8 with int8 attention vs fp32, just under the reference's own
# forwards on these random weights (tools/deit_reference_error.py, CPU, 256 /
# 16 images; PERF.md, Findings): the attn_int8 multiblock forward (tanh) at
# cosine 0.98840 / 0.98840, the split forward (tanh) 0.98847 / 0.98849, the
# xla_int8 DeployCtx forward (exact GELU) 0.98840 / 0.98882; top-1 0.80-0.82.
# Its bf16-attention multiblock forward is at 0.99889: with near-uniform
# attention over 197 keys most probabilities are 0 or 1 in steps of 1/127
DEIT_ATTN_INT8_FP32_COS = 0.987

KERNELS = ("conv_int8", "matmul_int8", "basic_block", "bottleneck_block", "vit_pre_w8", "mhsa",
           "vit_post_w8", "vit_pre_w4a8", "vit_post_w4a8", "matmul_int4a8", "vit_pre_w4",
           "vit_post_w4", "matmul_int4", "vit_pre_bf16", "vit_post_bf16", "layernorm_fused",
           "residual_layernorm", "mhsa_f32", "mhsa_i8")


def _per(**launches):
    return {k: launches.get(k, 0) for k in KERNELS}


# the probe wrappers (K19-K22): name -> (module under dlq_tpu_torch/tools,
# source, the TPU kernel it replaces)
PROBES = {
    "probe_mosaic": ("probe_mosaic_patterns", "dlq_tpu_torch/csrc/probe_mosaic.cu",
                     "tools/probe_mosaic_patterns.py:37 run (its pallas_call :39), row 25"),
    "probe_batched_dot": ("probe_batched_dot", "dlq_tpu_torch/csrc/probe_batched_dot.cu",
                          "tools/probe_batched_dot.py:28 run (its pallas_call :30), row 28"),
    "probe_block": ("probe_block_patterns", "dlq_tpu_torch/csrc/probe_block.cu",
                    "tools/probe_block_patterns.py:38 run (its pallas_call :40), row 27"),
    "probe_stem": ("probe_stem_patterns", "dlq_tpu_torch/csrc/probe_stem.cu",
                   "tools/probe_stem_patterns.py:36 run (its pallas_call :38), row 26"),
}
PROBE_PATTERNS = 23


# launches per forward of each kernel on each path (ResNet-18: 2-2-2-2
# BasicBlocks; ResNet-50: 3-4-6-3 Bottlenecks, 1x1/s1 convs on K2; DeiT-Tiny:
# 12 layers of K5 -> K6 -> K7, 6 per chunk; its deploy path: 50 dense sites;
# DeiT-Tiny W4A8: 12 layers of K8 -> K6 -> K9, its deploy path's 50 dense
# sites on K10, or on K2 with int4_runtime="int8"; DeiT-Tiny W4A16: 12 layers
# of K11 -> K6 -> K12, its G128 deploy path's 13 group-wise sites on K13;
# DeiT-Tiny bf16: 12 layers of K14 -> K6 -> K15 at either pads; the fp32
# fused_ln forward: K16 for the first LN1, K17 for the 23 later junctions and
# the final norm, K6's fp32 form for attention; the W8A8 deploy with fused_ln;
# DeiT-Tiny W8A8 with int8 attention: 12 layers of K5 -> K18 -> K7 (6 per
# chunk), the split-attention forward's 12 layers of K5 -> K18 (or K6) ->
# K7, the xla_int8 deploy path's 50 dense sites and 12 K18)
PER_FORWARD = {
    "r18_fused2": _per(conv_int8=19, matmul_int8=1),
    "r18_block": _per(conv_int8=15, matmul_int8=1, basic_block=2),
    "r18_deploy": _per(conv_int8=20, matmul_int8=1),
    "r50_fused2": _per(conv_int8=19, matmul_int8=34),
    "r50_block": _per(conv_int8=8, matmul_int8=12, bottleneck_block=11),
    "r50_deploy": _per(conv_int8=20, matmul_int8=34),
    "deit_block": _per(vit_pre_w8=12, mhsa=12, vit_post_w8=12),
    "deit_blockfused": _per(vit_pre_w8=12, mhsa=12, vit_post_w8=12),
    "deit_deploy": _per(matmul_int8=50, mhsa=12),
    "deit_block_w4a8": _per(vit_pre_w4a8=12, mhsa=12, vit_post_w4a8=12),
    "deit_deploy_w4a8": _per(matmul_int4a8=50, mhsa=12),
    "deit_deploy_w4a8_int8": _per(matmul_int8=50, mhsa=12),
    "deit_block_w4a8_int8": _per(vit_pre_w8=12, mhsa=12, vit_post_w8=12),
    "deit_block_w4": _per(vit_pre_w4=12, mhsa=12, vit_post_w4=12),
    "deit_deploy_g128": _per(matmul_int4=13, mhsa=12),
    "deit_bf16_loose": _per(vit_pre_bf16=12, mhsa=12, vit_post_bf16=12),
    "deit_bf16_tight": _per(vit_pre_bf16=12, mhsa=12, vit_post_bf16=12),
    "deit_fused_ln": _per(layernorm_fused=1, residual_layernorm=24, mhsa_f32=12),
    "deit_deploy_fused_ln": _per(matmul_int8=50, mhsa=12, layernorm_fused=1,
                                 residual_layernorm=24),
    "deit_block_attn_int8": _per(vit_pre_w8=12, mhsa_i8=12, vit_post_w8=12),
    "deit_split_int8": _per(vit_pre_w8=12, mhsa_i8=12, vit_post_w8=12),
    "deit_split_bf16": _per(vit_pre_w8=12, mhsa=12, vit_post_w8=12),
    "deit_deploy_xla_int8": _per(matmul_int8=50, mhsa_i8=12),
}
# paths run at batch 64 and checked by totals only (the shape tables are at
# batch 256; where a kernel's times are summed per forward on such a path,
# its case table's launches per forward weight them)
TOTALS_ONLY = ("r18_deploy", "r50_deploy", "deit_blockfused", "deit_deploy", "deit_deploy_w4a8",
               "deit_deploy_w4a8_int8", "deit_block_w4a8_int8", "deit_deploy_g128",
               "deit_fused_ln", "deit_deploy_fused_ln", "deit_split_int8", "deit_split_bf16",
               "deit_deploy_xla_int8")
TOTALS_BATCH = 64


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase or kernel-row line also carries the seconds
    since start."""
    if "kernels" not in obj and "ok" not in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def emit_row(row) -> None:
    emit({k: v for k, v in row.items() if k != "key"})


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(ops: float, nbytes: float, peak: float = PEAK_INT8_OPS):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _mhsa_bytes(n: int, n_valid: int, d: int, esize: int) -> int:
    """K6's bytes for the bound: q read and the output written over all n
    query rows (the function's output holds every row, the reference's too;
    n_valid masks keys only), k and v read over the n_valid keys."""
    return BATCH * (2 * n + 2 * n_valid) * d * esize


def time_ms(fn, iters=20, warmup=2, reps=3) -> float:
    from dlq_tpu_torch.timing import time_fn

    return time_fn(fn, iters=iters, warmup=warmup, reps=reps)["ms_median"]


# ---------------------------------------------------------------------------
# the shapes each main path gives each kernel, with launches per forward
# ---------------------------------------------------------------------------

def conv_cases():
    """K1: (H, C, OC, k, stride, relu, int8_out) -> launches per forward per path."""
    return {
        # ResNet-18 (rows of layer1.x.conv1 shared with ResNet-50's layer1.x.conv2)
        (56, 64, 64, 3, 1, True, True): {"r18_fused2": 2, "r18_block": 2,
                                         "r50_fused2": 3, "r50_block": 1},
        (56, 64, 64, 3, 1, False, True): {"r18_fused2": 2, "r18_block": 2},      # layer1.x.conv2
        (56, 64, 128, 3, 2, True, True): {"r18_fused2": 1, "r18_block": 1},      # layer2.0.conv1
        (56, 64, 128, 1, 2, False, True): {"r18_fused2": 1, "r18_block": 1},     # layer2.0.down
        (28, 128, 128, 3, 1, True, True): {"r18_fused2": 1, "r50_fused2": 3},    # l2.1.conv1 / l2.1-3.conv2
        (28, 128, 128, 3, 1, False, True): {"r18_fused2": 2, "r18_block": 1},    # layer2.x.conv2
        (28, 128, 256, 3, 2, True, True): {"r18_fused2": 1, "r18_block": 1},     # layer3.0.conv1
        (28, 128, 256, 1, 2, False, True): {"r18_fused2": 1, "r18_block": 1},    # layer3.0.down
        (14, 256, 256, 3, 1, True, True): {"r18_fused2": 1, "r50_fused2": 5},    # l3.1.conv1 / l3.1-5.conv2
        (14, 256, 256, 3, 1, False, True): {"r18_fused2": 2, "r18_block": 1},    # layer3.x.conv2
        (14, 256, 512, 3, 2, True, True): {"r18_fused2": 1, "r18_block": 1},     # layer4.0.conv1
        (14, 256, 512, 1, 2, False, True): {"r18_fused2": 1, "r18_block": 1},    # layer4.0.down
        (7, 512, 512, 3, 1, True, True): {"r18_fused2": 1, "r18_block": 1,       # l4.1.conv1 /
                                          "r50_fused2": 2, "r50_block": 1},      # l4.1-2.conv2
        (7, 512, 512, 3, 1, False, True): {"r18_fused2": 1, "r18_block": 1},     # layer4.0.conv2
        (7, 512, 512, 3, 1, False, False): {"r18_fused2": 1, "r18_block": 1},    # fp32 final junction
        (224, 3, 64, 7, 2, True, False): {},       # the deploy/pallas stem (byte-gather path)
        # ResNet-50: the strided 3x3 conv2 and the 1x1/s2 downsamples
        (56, 128, 128, 3, 2, True, True): {"r50_fused2": 1, "r50_block": 1},     # layer2.0.conv2
        (28, 256, 256, 3, 2, True, True): {"r50_fused2": 1, "r50_block": 1},     # layer3.0.conv2
        (14, 512, 512, 3, 2, True, True): {"r50_fused2": 1, "r50_block": 1},     # layer4.0.conv2
        (56, 256, 512, 1, 2, False, True): {"r50_fused2": 1, "r50_block": 1},    # layer2.0.down
        (28, 512, 1024, 1, 2, False, True): {"r50_fused2": 1, "r50_block": 1},   # layer3.0.down
        (14, 1024, 2048, 1, 2, False, True): {"r50_fused2": 1, "r50_block": 1},  # layer4.0.down
    }


def matmul_cases():
    """K2: (rows per image, K, N, relu, int8_out) -> launches per forward per
    path; M = batch x rows per image (the 1x1/s1 convs' [N*H*W, C] view)."""
    return {
        (1, 512, 1000, False, False): {"r18_fused2": 1, "r18_block": 1},          # ResNet-18 fc
        (56 * 56, 64, 64, True, True): {"r50_fused2": 1, "r50_block": 1},         # layer1.0.conv1
        (56 * 56, 64, 256, False, True): {"r50_fused2": 4, "r50_block": 2},       # l1 conv3, l1.0.down
        (56 * 56, 256, 64, True, True): {"r50_fused2": 2},                        # layer1.1-2.conv1
        (56 * 56, 256, 128, True, True): {"r50_fused2": 1, "r50_block": 1},       # layer2.0.conv1
        (28 * 28, 128, 512, False, True): {"r50_fused2": 4, "r50_block": 1},      # layer2.x.conv3
        (28 * 28, 512, 128, True, True): {"r50_fused2": 3},                       # layer2.1-3.conv1
        (28 * 28, 512, 256, True, True): {"r50_fused2": 1, "r50_block": 1},       # layer3.0.conv1
        (14 * 14, 256, 1024, False, True): {"r50_fused2": 6, "r50_block": 1},     # layer3.x.conv3
        (14 * 14, 1024, 256, True, True): {"r50_fused2": 5},                      # layer3.1-5.conv1
        (14 * 14, 1024, 512, True, True): {"r50_fused2": 1, "r50_block": 1},      # layer4.0.conv1
        (7 * 7, 512, 2048, False, True): {"r50_fused2": 2, "r50_block": 1},       # layer4.0-1.conv3
        (7 * 7, 512, 2048, False, False): {"r50_fused2": 1, "r50_block": 1},      # fp32 final junction
        (7 * 7, 2048, 512, True, True): {"r50_fused2": 2, "r50_block": 1},        # layer4.1-2.conv1
        (1, 2048, 1000, False, False): {"r50_fused2": 1, "r50_block": 1},         # ResNet-50 fc
        (56 * 56, 256, 64, True, False): {},      # the deploy/pallas routing (fp32 + relu)
        # DeiT-Tiny's deploy paths (checked at batch 64 by totals only)
        (196, 768, 192, False, False): {"deit_deploy_fused_ln": 1,
                                        "deit_deploy_xla_int8": 1},  # patch embed
        (197, 192, 576, False, False): {"deit_deploy_fused_ln": 12,
                                        "deit_deploy_xla_int8": 12},  # l*.qkv
        (197, 192, 192, False, False): {"deit_deploy_fused_ln": 12,
                                        "deit_deploy_xla_int8": 12},  # l*.proj
        (197, 192, 768, False, False): {"deit_deploy_fused_ln": 12,
                                        "deit_deploy_xla_int8": 12},  # l*.fc1
        (197, 768, 192, False, False): {"deit_deploy_fused_ln": 12,
                                        "deit_deploy_xla_int8": 12},  # l*.fc2
        (1, 192, 1000, False, False): {"deit_deploy_fused_ln": 1,
                                        "deit_deploy_xla_int8": 1},  # head
    }


def basic_cases():
    """K3: (H, C) -> launches per forward per path."""
    return {(28, 128): {"r18_block": 1}, (14, 256): {"r18_block": 1}}   # layer2.1, layer3.1


def bottleneck_cases():
    """K4: (H, C4, CM) -> launches per forward per path."""
    return {(56, 256, 64): {"r50_block": 2}, (28, 512, 128): {"r50_block": 3},
            (14, 1024, 256): {"r50_block": 5}, (7, 2048, 512): {"r50_block": 1}}


# DeiT-Tiny at batch 256: Np 200 rows (197 tokens), Dp 192, Hp 768, 3 heads of 64
VIT_NP, VIT_N, VIT_DP, VIT_HP, VIT_HEADS, VIT_HD = 200, 197, 192, 768, 3, 64
# its loose pads (vit_forward_blockfused's default): Np 256, Dp 256
VIT_NP_LOOSE, VIT_DP_LOOSE = 256, 256


def vit_pre_cases():
    """K5: (Np, Dp, residual dtype) -> launches per forward per path (on the
    tight pads bf16 at each of the two chunks' first layer, fp32 inside a
    chunk; bf16 at every layer of the split-attention forward's loose pads,
    driven at batch 64 and checked by totals)."""
    return {(VIT_NP, VIT_DP, "bfloat16"): {"deit_block": 2, "deit_block_attn_int8": 2},
            (VIT_NP, VIT_DP, "float32"): {"deit_block": 10, "deit_block_attn_int8": 10},
            (VIT_NP_LOOSE, VIT_DP_LOOSE, "bfloat16"): {"deit_split_int8": 12,
                                                       "deit_split_bf16": 12}}


def mhsa_cases():
    """K6: (rows, n_valid) -> launches per forward per path (the deploy
    paths' 197 unpadded rows are checked at batch 64 by totals only)."""
    return {(VIT_NP, VIT_N): {"deit_block": 12, "deit_block_w4a8": 12, "deit_block_w4": 12,
                              "deit_bf16_tight": 12},
            # the split path's bf16 arm (K6 on the loose 256 rows, batch 64)
            (VIT_NP_LOOSE, VIT_N): {"deit_bf16_loose": 12, "deit_split_bf16": 12},
            (VIT_N, VIT_N): {"deit_deploy_w4a8": 12, "deit_deploy_g128": 12,
                             "deit_deploy_fused_ln": 12}}


def vit_post_cases():
    """K7: (Np, Dp, residual dtype in, dtype out) -> launches per forward per
    path: on the tight pads a chunk's first layer bf16 -> fp32, its middle
    four fp32 -> fp32, its last fp32 -> bf16; bf16 -> bf16 is the
    single-block form (vit_forward_blockfused_w8's), at every layer of the
    split-attention forward's loose pads (batch 64, checked by totals)."""
    paths = ("deit_block", "deit_block_attn_int8")
    return {(VIT_NP, VIT_DP, "bfloat16", "float32"): dict.fromkeys(paths, 2),
            (VIT_NP, VIT_DP, "float32", "float32"): dict.fromkeys(paths, 8),
            (VIT_NP, VIT_DP, "float32", "bfloat16"): dict.fromkeys(paths, 2),
            (VIT_NP, VIT_DP, "bfloat16", "bfloat16"): {},
            (VIT_NP_LOOSE, VIT_DP_LOOSE, "bfloat16", "bfloat16"): {"deit_split_int8": 12,
                                                                   "deit_split_bf16": 12}}


def vit_pre_w4a8_cases():
    """K8: residual dtype -> launches per forward per path (bf16 at every
    layer of the W4A8 block path; fp32 is the stacked form's)."""
    return {"bfloat16": {"deit_block_w4a8": 12}, "float32": {}}


def vit_post_w4a8_cases():
    """K9: (residual dtype in, dtype out) -> launches per forward per path
    (bf16 -> bf16 at every layer of the W4A8 block path; the others are the
    stacked forms of vit_multiblock_fused_w4a8)."""
    return {("bfloat16", "bfloat16"): {"deit_block_w4a8": 12}, ("bfloat16", "float32"): {},
            ("float32", "float32"): {}, ("float32", "bfloat16"): {}}


# DeiT-Tiny's deploy dense sites: (rows per image, K, N) -> sites per forward
DEIT_DEPLOY_SITES = {(196, 768, 192): 1, (197, 192, 576): 12, (197, 192, 192): 12,
                     (197, 192, 768): 12, (197, 768, 192): 12, (1, 192, 1000): 1}


def matmul_int4a8_cases():
    """K10: (rows per image, K, N, relu) -> launches per forward per path:
    the W4A8 deploy path's sites (patch, l*.qkv, l*.proj, l*.fc1, l*.fc2,
    head), driven at batch 64 and checked by totals."""
    return {(hw, k, n, False): {"deit_deploy_w4a8": c} for (hw, k, n), c in DEIT_DEPLOY_SITES.items()}


def vit_pre_w4_cases():
    """K11: residual dtype -> launches per forward per path (bf16 at every
    layer of the W4A16 block path; fp32 is the stacked form's)."""
    return {"bfloat16": {"deit_block_w4": 12}, "float32": {}}


def vit_post_w4_cases():
    """K12: (residual dtype in, dtype out) -> launches per forward per path
    (bf16 -> bf16 at every layer of the W4A16 block path; the others are the
    stacked forms of vit_multiblock_fused_w4)."""
    return {("bfloat16", "bfloat16"): {"deit_block_w4": 12}, ("bfloat16", "float32"): {},
            ("float32", "float32"): {}, ("float32", "bfloat16"): {}}


def matmul_int4_cases():
    """K13: (rows per image, K, N, relu) -> launches per forward per path:
    the G128 deploy path's group-wise sites (patch and l*.fc2, K = 768; the
    K = 192 sites fall back to int8 weight-only), driven at batch 64 and
    checked by totals."""
    return {(196, 768, 192, False): {"deit_deploy_g128": 1},
            (197, 768, 192, False): {"deit_deploy_g128": 12}}


def vit_pre_bf16_cases():
    """K14: (Np, Dp, residual dtype) -> launches per forward per path (bf16
    at every layer of the bf16 forward, at either pads)."""
    return {(VIT_NP_LOOSE, VIT_DP_LOOSE, "bfloat16"): {"deit_bf16_loose": 12},
            (VIT_NP, VIT_DP, "bfloat16"): {"deit_bf16_tight": 12}}


def vit_post_bf16_cases():
    """K15: (Np, Dp, residual dtype in, dtype out) -> launches per forward
    per path (bf16 -> bf16 at every layer of the bf16 forward)."""
    return {(VIT_NP_LOOSE, VIT_DP_LOOSE, "bfloat16", "bfloat16"): {"deit_bf16_loose": 12},
            (VIT_NP, VIT_DP, "bfloat16", "bfloat16"): {"deit_bf16_tight": 12}}


def layernorm_fused_cases():
    """K16: stream dtype -> launches per forward per path (the first LN1 of
    the fp32 fused_ln forward and of the bf16 W8A8 deploy; both driven at
    batch 64 and checked by totals)."""
    return {"float32": {"deit_fused_ln": 1}, "bfloat16": {"deit_deploy_fused_ln": 1}}


def residual_layernorm_cases():
    """K17: (y dtype, delta dtype) -> launches per forward per path (every
    later LN junction, the final norm included)."""
    return {("float32", "float32"): {"deit_fused_ln": 24},
            ("bfloat16", "bfloat16"): {"deit_deploy_fused_ln": 24}}


def mhsa_f32_cases():
    """K6's fp32 form: (rows, n_valid) -> launches per forward per path."""
    return {(VIT_N, VIT_N): {"deit_fused_ln": 12}}


def mhsa_i8_cases():
    """K18: (rows, n_valid, form, dtype in, dtype out) -> launches per forward
    per path: the in-kernel form on the tight block stream, the zero-pad form
    on the split path's loose 256 rows and on the xla_int8 deploy path's
    unpadded 197 rows (both driven at batch 64, checked by totals); the fp32
    zero-pad form is the fp32 forward's (attn_impl="xla_int8"), timed only."""
    return {(VIT_NP, VIT_N, "in_kernel", "bfloat16", "bfloat16"): {"deit_block_attn_int8": 12},
            (VIT_NP_LOOSE, VIT_N, "zero_pad", "bfloat16", "bfloat16"): {"deit_split_int8": 12},
            (VIT_N, VIT_N, "zero_pad", "bfloat16", "bfloat16"): {"deit_deploy_xla_int8": 12},
            (VIT_N, VIT_N, "zero_pad", "float32", "float32"): {}}


def _conv_key(case):
    h, c, oc, k, s, relu, int8_out = case
    return (BATCH, h, h, c, oc, k, k, s, k // 2, relu, int8_out)


def _mm_key(case):
    hw, k, n, relu, int8_out = case
    return (BATCH * hw, k, n, relu, int8_out)


KEYS = {"conv_int8": (conv_cases, _conv_key),
        "matmul_int8": (matmul_cases, _mm_key),
        "basic_block": (basic_cases, lambda c: (BATCH, c[0], c[0], c[1])),
        "bottleneck_block": (bottleneck_cases, lambda c: (BATCH, c[0], c[0], c[1], c[2])),
        "vit_pre_w8": (vit_pre_cases, lambda c: (BATCH, *c)),
        "mhsa": (mhsa_cases, lambda c: (BATCH, c[0], VIT_HEADS, VIT_HD, c[1])),
        "vit_post_w8": (vit_post_cases, lambda c: (BATCH, c[0], c[1], VIT_HP, *c[2:])),
        "vit_pre_w4a8": (vit_pre_w4a8_cases, lambda c: (BATCH, VIT_NP, VIT_DP, c)),
        "vit_post_w4a8": (vit_post_w4a8_cases, lambda c: (BATCH, VIT_NP, VIT_DP, VIT_HP, *c)),
        "matmul_int4a8": (matmul_int4a8_cases, lambda c: (BATCH * c[0], *c[1:])),
        "vit_pre_w4": (vit_pre_w4_cases, lambda c: (BATCH, VIT_NP, VIT_DP, c)),
        "vit_post_w4": (vit_post_w4_cases, lambda c: (BATCH, VIT_NP, VIT_DP, VIT_HP, *c)),
        "matmul_int4": (matmul_int4_cases, lambda c: (BATCH * c[0], *c[1:])),
        "vit_pre_bf16": (vit_pre_bf16_cases, lambda c: (BATCH, *c)),
        "vit_post_bf16": (vit_post_bf16_cases, lambda c: (BATCH, c[0], c[1], VIT_HP, *c[2:])),
        "layernorm_fused": (layernorm_fused_cases, lambda c: (BATCH * VIT_N, VIT_DP, c)),
        "residual_layernorm": (residual_layernorm_cases,
                               lambda c: (BATCH * VIT_N, VIT_DP, *c)),
        "mhsa_f32": (mhsa_f32_cases, lambda c: (BATCH, c[0], VIT_HEADS, VIT_HD, c[1])),
        "mhsa_i8": (mhsa_i8_cases, lambda c: (BATCH, c[0], VIT_HEADS, VIT_HD, *c[1:]))}


def expected_by_shape(path: str, forwards: int):
    """Launches per kernel and shape key that the case tables give a main
    path over ``forwards`` forwards."""
    return {name: {key(case): per[path] * forwards for case, per in cases().items() if per.get(path)}
            for name, (cases, key) in KEYS.items()}


def _check_tables():
    """The case tables add up to the per-forward totals."""
    for path, totals in PER_FORWARD.items():
        if path in TOTALS_ONLY:
            continue
        got = {k: sum(v.values()) for k, v in expected_by_shape(path, 1).items()}
        if got != totals:
            raise AssertionError(f"{path}: case tables give {got}, expected {totals}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_int8(gen, shape, dev, lo=-127):
    return torch.randint(lo, 128, shape, generator=gen, device=dev, dtype=torch.int8)


def _epi_params(gen, oc, k, dev):
    """Per-OC combined scales and biases that put y at ~0.05 std, and an
    output scale that spreads the int8 outputs over the range."""
    base = 0.05 / (73.0 * 73.0 * math.sqrt(k))
    scale = (base * (0.5 + torch.rand(oc, generator=gen, device=dev))).float().contiguous()
    bias = (0.02 * torch.randn(oc, generator=gen, device=dev)).float().contiguous()
    return scale, bias, 0.05 / 40.0


def _row(kernel, key, shape, got, ref, fn, plain, ops, nbytes, per, plain_iters=2,
         library=None, tol=None, peak=PEAK_INT8_OPS, library_name=INT_MM, rel=None,
         no_library=NO_INT8_CONV, spun=False, **extra):
    """One kernel shape: held against its plain version (bit-identical; or
    with ``tol`` = (fraction of outputs equal, largest difference), or
    (fraction within near x (1 + |plain|), largest difference, near); or
    with ``rel`` = (bound, mag): every difference within bound x mag),
    timed beside the plain version, the library call and the bound. With
    ``spun``, the kernel and the library call are also timed as device time
    (``device_ms``, ``library_device_ms``: the card spins while the host
    enqueues each window), which a launch shorter than its host-side cost
    needs."""
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    equal = float((diff == 0).float().mean())
    checks = {}
    if rel is not None:
        checks["max_rel_err"] = float((diff / rel[1].float().clamp_min(1e-30)).max())
        ok = checks["max_rel_err"] <= rel[0]
    elif tol is None:
        ok = err == 0.0
    else:
        frac = equal
        if len(tol) == 3:
            frac = checks["within_fraction"] = float(
                (diff <= tol[2] * (1.0 + ref.float().abs())).float().mean())
        ok = frac >= tol[0] and err <= tol[1]
    if not ok:
        raise AssertionError(f"{kernel} {shape}: max_abs_err {err}, equal fraction {equal}, "
                             f"{checks} (need {rel[0] if rel else tol or 'bit-identical'})")
    b_ms, b_by = bound(ops, nbytes, peak)
    row = {"kernel": kernel, "key": key, "shape": shape, **extra, "max_abs_err": err,
           "equal_fraction": equal, **checks, "ms": time_ms(fn),
           "plain_ms": time_ms(plain, iters=plain_iters, warmup=1, reps=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(library) if library is not None else None,
           "library": library_name if library is not None else no_library,
           "launches_per_forward": per}
    if spun:
        from dlq_tpu_torch.tools._probe import spun_ms

        row["device_ms"] = spun_ms(fn, 20, warmup=2, reps=3)
        row["library_device_ms"] = spun_ms(library, 20, warmup=2, reps=3) if library else None
    emit_row(row)
    return row


def check_conv_kernels(dev):
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, out_hw, pack_conv_weight

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for case, per in conv_cases().items():
        h, c, oc, k, s, relu, int8_out = case
        pad = k // 2
        x = _rand_int8(gen, (BATCH, h, h, c), dev)
        pk = pack_conv_weight(_rand_int8(gen, (k, k, c, oc), dev))
        scale, bias, osc = _epi_params(gen, oc, k * k * c, dev)
        osc = osc if int8_out else None
        got = conv_int8(x, pk, s, pad, scale, bias, relu, osc)
        ref = conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc)
        oh, ow = out_hw(h, h, k, k, s, pad)
        # input bytes the conv reads: all of x, or for k < stride (the 1x1/s2
        # downsamples) only the pixels under a tap
        x_bytes = min(x.numel(), BATCH * oh * ow * k * k * c)
        rows.append(_row(
            "conv_int8", _conv_key(case), f"{BATCH}x{h}x{h}x{c}->{oc} {k}x{k}/s{s}", got, ref,
            lambda: conv_int8(x, pk, s, pad, scale, bias, relu, osc),
            lambda: conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc),
            2.0 * BATCH * oh * ow * oc * k * k * c,
            x_bytes + k * k * c * oc + 8 * oc + got.numel() * got.element_size(), per,
            relu=relu, out="int8" if int8_out else "fp32"))
        del x, got, ref
    return rows


def check_matmul_kernel(dev):
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    for case, per in matmul_cases().items():
        hw, k, n, relu, int8_out = case
        m = BATCH * hw
        x = _rand_int8(gen, (m, k), dev)
        pk = pack_dense_weight(_rand_int8(gen, (k, n), dev))
        scale, bias, osc = _epi_params(gen, n, k, dev)
        osc = osc if int8_out else None
        got = matmul_int8(x, pk, scale, bias, relu, osc)
        ref = matmul_int8_plain(x, pk, scale, bias, relu, osc)
        wt = pk.wk[:, :k].t()                            # [K, N], column-major
        rows.append(_row(
            "matmul_int8", _mm_key(case), f"{m}x{k}@{k}x{n}", got, ref,
            lambda: matmul_int8(x, pk, scale, bias, relu, osc),
            lambda: matmul_int8_plain(x, pk, scale, bias, relu, osc),
            2.0 * m * n * k, m * k + k * n + 8 * n + got.numel() * got.element_size(), per,
            plain_iters=5, library=lambda: torch._int_mm(x, wt),
            relu=relu, out="int8" if int8_out else "fp32"))
        del x, got, ref
    return rows


def check_block_kernel(dev):
    from dlq_tpu_torch.ops.block_fused import basic_block_fused, basic_block_plain
    from dlq_tpu_torch.ops.conv_int8 import pack_conv_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    for (h, c), per in basic_cases().items():
        x = _rand_int8(gen, (BATCH, h, h, c), dev, lo=0)   # block inputs are post-relu
        s1, b1, _ = _epi_params(gen, c, 9 * c, dev)
        s2, b2, _ = _epi_params(gen, c, 9 * c, dev)
        pack = {"w1": pack_conv_weight(_rand_int8(gen, (3, 3, c, c), dev)), "s1": s1, "b1": b1,
                "w2": pack_conv_weight(_rand_int8(gen, (3, 3, c, c), dev)), "s2": s2, "b2": b2,
                "inv": (float(np.float32(40.0 / 0.05)), float(np.float32(40.0 / 0.05)),
                        float(np.float32(0.7)))}
        rows.append(_row(
            "basic_block", (BATCH, h, h, c), f"{BATCH}x{h}x{h}x{c}",
            basic_block_fused(x, pack), basic_block_plain(x, pack),
            lambda: basic_block_fused(x, pack), lambda: basic_block_plain(x, pack),
            2.0 * 2 * BATCH * h * h * c * 9 * c, 2 * x.numel() + 2 * 9 * c * c + 16 * c, per,
            relu=True, out="int8"))
    return rows


def check_bottleneck_kernel(dev):
    from dlq_tpu_torch.ops.block_fused import bottleneck_block_fused, bottleneck_block_plain
    from dlq_tpu_torch.ops.conv_int8 import pack_conv_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    inv = float(np.float32(40.0 / 0.05))
    rows = []
    for (h, c4, cm), per in bottleneck_cases().items():
        x = _rand_int8(gen, (BATCH, h, h, c4), dev, lo=0)  # block inputs are post-relu
        pack = {"inv": (inv, inv, inv, float(np.float32(0.7)))}
        for i, (k, c, oc) in enumerate(((1, c4, cm), (3, cm, cm), (1, cm, c4)), 1):
            pack[f"w{i}"] = pack_conv_weight(_rand_int8(gen, (k, k, c, oc), dev))
            pack[f"s{i}"], pack[f"b{i}"], _ = _epi_params(gen, oc, k * k * c, dev)
        w_bytes = c4 * cm + 9 * cm * cm + cm * c4
        rows.append(_row(
            "bottleneck_block", (BATCH, h, h, c4, cm), f"{BATCH}x{h}x{h}x{c4} mid {cm}",
            bottleneck_block_fused(x, pack), bottleneck_block_plain(x, pack),
            lambda: bottleneck_block_fused(x, pack), lambda: bottleneck_block_plain(x, pack),
            2.0 * BATCH * h * h * w_bytes, 2 * x.numel() + w_bytes + 8 * (2 * cm + c4), per,
            relu=True, out="int8"))
        del x
    return rows


def _vit_layer(gen, dev, dp=VIT_DP):
    """One packed DeiT-Tiny W8A8 layer at ``dp`` lanes with random int8
    weights (K-major), folded scales that put the GEMM outputs near unit
    scale, biases, LN rows and inverse activation scales; past DeiT-Tiny's
    192 lanes every weight, scale, bias and LN lane is zero, as
    pack_vit_blocks_w8 pads them."""
    hp, d = VIT_HP, VIT_DP

    def w(n, k):
        return _rand_int8(gen, (n, k), dev)

    def sc(n, k):
        return ((0.5 + torch.rand(n, generator=gen, device=dev)) / (60.0 * 73.0 * math.sqrt(k))
                ).float().contiguous()

    def b(n):
        return (0.1 * torch.randn(n, generator=gen, device=dev)).float().contiguous()

    ln = torch.stack([0.5 + torch.rand(dp, generator=gen, device=dev),
                      0.1 * torch.randn(dp, generator=gen, device=dev)]).float().contiguous()
    blk = {"inv_act": (40.0, 30.0, 40.0, 30.0),
           "wqkv": w(3 * dp, dp), "sqkv": sc(3 * dp, dp), "bqkv": b(3 * dp),
           "wproj": w(dp, dp), "sproj": sc(dp, dp), "bproj": b(dp), "ln1": ln, "ln2": ln.clone(),
           "wfc1": w(hp, dp), "sfc1": sc(hp, dp), "bfc1": b(hp),
           "wfc2": w(dp, hp), "sfc2": sc(dp, hp), "bfc2": b(dp)}
    if dp > d:
        pad_qkv = torch.arange(3 * dp, device=dev) % dp >= d
        for k in ("wqkv", "sqkv", "bqkv"):
            blk[k][pad_qkv] = 0
        for k in ("wproj", "sproj", "bproj", "wfc2", "sfc2", "bfc2"):
            blk[k][d:] = 0
        for k in ("wqkv", "wproj", "wfc1", "ln1", "ln2"):
            blk[k][:, d:] = 0
    return blk


def check_vit_kernels(dev):
    """K5, K6 and K7 at every shape and dtype form of DeiT-Tiny's block path
    at batch 256 (and K6 at the deploy path's unpadded 197 rows), K5 and
    K7's single-block form also at the split-attention forward's loose pads
    (256/256, the stream's pad lanes zero). The bound counts the 192 valid
    lanes the kernels are given (products, input bytes), outputs at their
    full padded width, as K14/K15's rows do."""
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_plain
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w8, vit_block_pre_plain, vit_block_pre_w8,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    blk = _vit_layer(gen, dev)
    d, hp, m = VIT_DP, VIT_HP, BATCH * VIT_NP
    y32 = torch.randn((BATCH, VIT_NP, d), generator=gen, device=dev)
    ys = {"float32": y32, "bfloat16": y32.to(torch.bfloat16)}
    pads = {(VIT_NP, VIT_DP): {"blk": blk, "ys": ys, "x1": _rand_int8(gen, (m, d), dev),
                               "x2": _rand_int8(gen, (m, hp), dev)}}
    yl = torch.randn((BATCH, VIT_NP_LOOSE, VIT_DP_LOOSE), generator=gen, device=dev)
    yl[..., d:] = 0.0
    ml = BATCH * VIT_NP_LOOSE
    pads[VIT_NP_LOOSE, VIT_DP_LOOSE] = {
        "blk": _vit_layer(gen, dev, VIT_DP_LOOSE), "ys": {"bfloat16": yl.to(torch.bfloat16)},
        "x1": _rand_int8(gen, (ml, VIT_DP_LOOSE), dev), "x2": _rand_int8(gen, (ml, hp), dev)}
    del yl
    for p in pads.values():
        p["w"] = [p["blk"][k].t() for k in ("wqkv", "wproj", "wfc1", "wfc2")]  # [K, N] views
    rows = []
    for (npad, dp, case), per in vit_pre_cases().items():
        p = pads[npad, dp]
        y, bk, mr = p["ys"][case], p["blk"], BATCH * npad
        rows.append(_row(
            "vit_pre_w8", (BATCH, npad, dp, case), f"{BATCH}x{npad}x{dp} {case} -> qkv",
            vit_block_pre_w8(y, bk, d), vit_block_pre_plain(y, bk, d),
            lambda: vit_block_pre_w8(y, bk, d), lambda: vit_block_pre_plain(y, bk, d),
            2.0 * mr * d * 3 * d,
            mr * d * y.element_size() + 3 * d * d + 8 * 3 * d + 8 * d + mr * 3 * dp * 2, per,
            library=lambda: torch._int_mm(p["x1"], p["w"][0]), tol=VIT_TOL, residual=case,
            out="bf16", pads=f"{npad}/{dp}"))
    qkv = vit_block_pre_plain(y32, blk, d)
    for (n, n_valid), per in mhsa_cases().items():
        # the loose pads' 256 rows: zero rows past the 200 of this stream
        t = torch.nn.functional.pad(qkv, (0, 0, 0, max(0, n - VIT_NP)))[:, :n].contiguous()
        views = (t[..., :d], t[..., d: 2 * d], t[..., 2 * d:])
        q4, k4, v4 = (v.reshape(BATCH, n, VIT_HEADS, VIT_HD).transpose(1, 2).contiguous()
                      for v in views)
        rows.append(_row(
            "mhsa", (BATCH, n, VIT_HEADS, VIT_HD, n_valid),
            f"{BATCH}x{VIT_HEADS} heads x {n} rows x {VIT_HD}, {n_valid} keys",
            mhsa(*views, VIT_HEADS, n_valid), mhsa_plain(*views, VIT_HEADS, n_valid),
            lambda: mhsa(*views, VIT_HEADS, n_valid), lambda: mhsa_plain(*views, VIT_HEADS, n_valid),
            4.0 * BATCH * VIT_HEADS * n * n_valid * VIT_HD, _mhsa_bytes(n, n_valid, d, 2), per,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4),
            tol=VIT_TOL, peak=PEAK_BF16, library_name=SDPA, out="bf16"))
        del t, q4, k4, v4
    pads[VIT_NP, VIT_DP]["a"] = mhsa(qkv[..., :d], qkv[..., d: 2 * d], qkv[..., 2 * d:],
                                     VIT_HEADS, VIT_N)
    del qkv
    p = pads[VIT_NP_LOOSE, VIT_DP_LOOSE]
    qkv = vit_block_pre_plain(p["ys"]["bfloat16"], p["blk"], d)
    dl = VIT_DP_LOOSE
    p["a"] = mhsa(qkv[..., :d], qkv[..., dl: dl + d], qkv[..., 2 * dl: 2 * dl + d], VIT_HEADS,
                  VIT_N, out_lanes=dl)
    del qkv
    for (npad, dp, din, dout), per in vit_post_cases().items():
        p = pads[npad, dp]
        y, a, bk, odt, mr = p["ys"][din], p["a"], p["blk"], getattr(torch, dout), BATCH * npad
        multi = (din, dout) != ("bfloat16", "bfloat16")

        def kern():
            return vit_block_post_w8(y, a, bk, d, True, odt, multi)

        def plain():
            return vit_block_post_plain(y, a, bk, d, True, odt, multi)

        rows.append(_row(
            "vit_post_w8", (BATCH, npad, dp, hp, din, dout),
            f"{BATCH}x{npad}x{dp} {din} -> {dout}, mlp {hp}", kern(), plain(), kern, plain,
            2.0 * mr * (d * d + 2 * d * hp),
            mr * d * (y.element_size() + 2) + d * d + 2 * d * hp + 8 * (3 * d + hp)
            + mr * dp * odt.itemsize, per,
            library=lambda: (torch._int_mm(p["x1"], p["w"][1]), torch._int_mm(p["x1"], p["w"][2]),
                             torch._int_mm(p["x2"], p["w"][3])),
            tol=VIT_TOL, library_name=INT_MM + ", the three products", residual=din, out=dout,
            pads=f"{npad}/{dp}"))
    del pads, ys, y32
    return rows


def _w4a8_layer(gen, dev):
    """One packed DeiT-Tiny W4A8 layer: _vit_layer's scales (times 16: int4
    weights have an rms of ~4.6 against int8's ~73), biases, LN rows and
    inverse scales, with random int4 weights halves-packed K-major."""
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor

    blk = _vit_layer(gen, dev)
    for name in ("wqkv", "wproj", "wfc1", "wfc2"):
        n, k = blk[name].shape
        w = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        blk[name] = pack_halves_kmajor(w, k, n)
        blk["s" + name[1:]] = blk["s" + name[1:]] * 16.0
    return blk


def check_w4a8_kernels(dev):
    """K8 and K9 at every dtype form of DeiT-Tiny's W4A8 layer at batch 256
    (the block path's bf16 -> bf16 and the stacked forms), with
    torch._int_mm on the materialized int8 weights as the yardstick; the
    int4 weights count K/2 bytes in the bound."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w4a8, vit_block_pre_plain, vit_block_pre_w4a8,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    blk = _w4a8_layer(gen, dev)
    dp, hp, m = VIT_DP, VIT_HP, BATCH * VIT_NP
    y32 = torch.randn((BATCH, VIT_NP, dp), generator=gen, device=dev)
    ys = {"float32": y32, "bfloat16": y32.to(torch.bfloat16)}
    x1, x2 = _rand_int8(gen, (m, dp), dev), _rand_int8(gen, (m, hp), dev)
    wq, wp, w1, w2 = (unpack_halves_kmajor(blk[k]).contiguous().t()
                      for k in ("wqkv", "wproj", "wfc1", "wfc2"))   # int8 [K, N] views
    rows = []
    for case, per in vit_pre_w4a8_cases().items():
        y = ys[case]
        rows.append(_row(
            "vit_pre_w4a8", (BATCH, VIT_NP, dp, case), f"{BATCH}x{VIT_NP}x{dp} {case} -> qkv, int4",
            vit_block_pre_w4a8(y, blk, dp), vit_block_pre_plain(y, blk, dp),
            lambda: vit_block_pre_w4a8(y, blk, dp), lambda: vit_block_pre_plain(y, blk, dp),
            2.0 * m * dp * 3 * dp,
            y.numel() * y.element_size() + 3 * dp * dp // 2 + 8 * 3 * dp + 8 * dp + m * 3 * dp * 2,
            per, library=lambda: torch._int_mm(x1, wq), tol=VIT_TOL, residual=case, out="bf16"))
    qkv = vit_block_pre_plain(y32, blk, dp)
    a = mhsa(qkv[..., :dp], qkv[..., dp: 2 * dp], qkv[..., 2 * dp:], VIT_HEADS, VIT_N)
    for (din, dout), per in vit_post_w4a8_cases().items():
        y, odt = ys[din], getattr(torch, dout)

        def kern():
            return vit_block_post_w4a8(y, a, blk, dp, True, odt, True)

        def plain():
            return vit_block_post_plain(y, a, blk, dp, True, odt, True)

        rows.append(_row(
            "vit_post_w4a8", (BATCH, VIT_NP, dp, hp, din, dout),
            f"{BATCH}x{VIT_NP}x{dp} {din} -> {dout}, mlp {hp}, int4", kern(), plain(), kern, plain,
            2.0 * m * (dp * dp + 2 * dp * hp),
            y.numel() * y.element_size() + a.numel() * 2 + (dp * dp + 2 * dp * hp) // 2
            + 8 * (3 * dp + hp) + m * dp * odt.itemsize, per,
            library=lambda: (torch._int_mm(x1, wp), torch._int_mm(x1, w1), torch._int_mm(x2, w2)),
            tol=VIT_TOL, library_name=INT_MM + ", the three products on int8 weights",
            residual=din, out=dout))
    del qkv, a, ys, y32, x1, x2
    return rows


def check_int4a8_matmul(dev):
    """K10 at DeiT-Tiny's six deploy shapes at batch 256, bit-identical to
    its plain version, on int4 weights quantized from random ones and
    repacked as the deploy context repacks them; K10 and `_int_mm` also
    timed as device time."""
    from dlq_tpu_torch.ops.matmul_int4a8 import (
        matmul_int4a8, matmul_int4a8_plain, pack_int4a8_weight, unpack_halves_kmajor,
    )
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL
    from dlq_tpu_torch.quant.quantize import quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = []
    for case, per in matmul_int4a8_cases().items():
        hw, k, n, relu = case
        m = BATCH * hw
        x = _rand_int8(gen, (m, k), dev)
        pk = pack_int4a8_weight(quantize_tensor(torch.randn((k, n), generator=gen, device=dev),
                                                INT4A8_PER_CHANNEL.weights))
        scale, bias, _ = _epi_params(gen, n, k, dev)
        scale = scale * 16.0
        w8 = unpack_halves_kmajor(pk.wp)[:, :k].contiguous().t()   # int8 [K, N], column-major
        got = matmul_int4a8(x, pk, scale, bias, relu)
        rows.append(_row(
            "matmul_int4a8", (m, k, n, relu), f"{m}x{k}@{k}x{n} int4", got,
            matmul_int4a8_plain(x, pk, scale, bias, relu),
            lambda: matmul_int4a8(x, pk, scale, bias, relu),
            lambda: matmul_int4a8_plain(x, pk, scale, bias, relu),
            2.0 * m * n * k, m * k + k * n // 2 + 8 * n + got.numel() * 4, per, plain_iters=5,
            library=lambda: torch._int_mm(x, w8), relu=relu, out="fp32", spun=True))
        del x, got
    return rows


def _w4a16_layer(gen, dev):
    """One packed DeiT-Tiny W4A16 layer: _w4a8_layer's int4 weights, biases
    and LN rows, with per-OC scales that put each GEMM's outputs near unit
    scale for bf16 activations (int4 weights have an rms of ~4.6), and no
    activation scales."""
    blk = _w4a8_layer(gen, dev)
    del blk["inv_act"]
    for name in ("qkv", "proj", "fc1", "fc2"):
        n, kh = blk["w" + name].shape
        blk["s" + name] = ((0.5 + torch.rand(n, generator=gen, device=dev))
                           / (4.6 * math.sqrt(2 * kh))).float().contiguous()
    return blk


def check_w4a16_kernels(dev):
    """K11 and K12 at every dtype form of DeiT-Tiny's W4A16 layer at batch
    256 (the block path's bf16 -> bf16 and the stacked forms), with a bf16
    torch.matmul on the dequantized weights as the yardstick; the int4
    weights count K/2 bytes in the bound, the products bf16's peak."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_w4, vit_block_post_w4_plain, vit_block_pre_w4, vit_block_pre_w4_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    blk = _w4a16_layer(gen, dev)
    dp, hp, m = VIT_DP, VIT_HP, BATCH * VIT_NP
    y32 = torch.randn((BATCH, VIT_NP, dp), generator=gen, device=dev)
    ys = {"float32": y32, "bfloat16": y32.to(torch.bfloat16)}
    h1 = torch.randn((m, dp), generator=gen, device=dev).to(torch.bfloat16)
    h2 = torch.randn((m, hp), generator=gen, device=dev).to(torch.bfloat16)
    wq, wp, w1, w2 = ((unpack_halves_kmajor(blk[k]).float() * blk["s" + k[1:]][:, None])
                      .t().contiguous().to(torch.bfloat16)
                      for k in ("wqkv", "wproj", "wfc1", "wfc2"))   # bf16 [K, N]
    rows = []
    for case, per in vit_pre_w4_cases().items():
        y = ys[case]
        rows.append(_row(
            "vit_pre_w4", (BATCH, VIT_NP, dp, case), f"{BATCH}x{VIT_NP}x{dp} {case} -> qkv, w4a16",
            vit_block_pre_w4(y, blk, dp), vit_block_pre_w4_plain(y, blk, dp),
            lambda: vit_block_pre_w4(y, blk, dp), lambda: vit_block_pre_w4_plain(y, blk, dp),
            2.0 * m * dp * 3 * dp,
            y.numel() * y.element_size() + 3 * dp * dp // 2 + 8 * 3 * dp + 8 * dp + m * 3 * dp * 2,
            per, library=lambda: torch.matmul(h1, wq), tol=W4A16_TOL["bf16"], peak=PEAK_BF16,
            library_name=HMM, residual=case, out="bf16"))
    qkv = vit_block_pre_w4_plain(y32, blk, dp)
    a = mhsa(qkv[..., :dp], qkv[..., dp: 2 * dp], qkv[..., 2 * dp:], VIT_HEADS, VIT_N)
    for (din, dout), per in vit_post_w4_cases().items():
        y, odt = ys[din], getattr(torch, dout)

        def kern():
            return vit_block_post_w4(y, a, blk, dp, True, odt)

        def plain():
            return vit_block_post_w4_plain(y, a, blk, dp, True, odt)

        rows.append(_row(
            "vit_post_w4", (BATCH, VIT_NP, dp, hp, din, dout),
            f"{BATCH}x{VIT_NP}x{dp} {din} -> {dout}, mlp {hp}, w4a16", kern(), plain(), kern, plain,
            2.0 * m * (dp * dp + 2 * dp * hp),
            y.numel() * y.element_size() + a.numel() * 2 + (dp * dp + 2 * dp * hp) // 2
            + 8 * (3 * dp + hp) + m * dp * odt.itemsize, per,
            library=lambda: (torch.matmul(h1, wp), torch.matmul(h1, w1), torch.matmul(h2, w2)),
            tol=W4A16_TOL["fp32" if dout == "float32" else "bf16"], peak=PEAK_BF16,
            library_name=HMM + ", the three products", residual=din, out=dout))
    del qkv, a, ys, y32, h1, h2
    return rows


def check_int4_matmul(dev):
    """K13 at DeiT-Tiny's two G128 deploy shapes at batch 256, on group-wise
    int4 weights quantized from random ones and repacked as the deploy
    context repacks them; each output within K13_REL of the sum of its
    products' magnitudes from the plain version; K13 and the bf16 matmul
    also timed as device time."""
    from dlq_tpu_torch.models.common import fp32_matmul
    from dlq_tpu_torch.ops.matmul_int4 import (
        dequantize_bf16, matmul_int4, matmul_int4_plain, pack_int4_weight,
    )
    from dlq_tpu_torch.quant.qconfig import INT4_WEIGHT_ONLY_G128
    from dlq_tpu_torch.quant.quantize import quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = []
    for case, per in matmul_int4_cases().items():
        hw, k, n, relu = case
        m = BATCH * hw
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        pk = pack_int4_weight(quantize_tensor(0.02 * torch.randn((k, n), generator=gen, device=dev),
                                              INT4_WEIGHT_ONLY_G128.weights))
        bias = (0.02 * torch.randn(n, generator=gen, device=dev)).contiguous()
        w = dequantize_bf16(pk)                                   # bf16 [K, N]
        with fp32_matmul():
            mag = torch.matmul(x.float().abs(), w.float().abs())
        got = matmul_int4(x, pk, bias, relu)
        rows.append(_row(
            "matmul_int4", (m, k, n, relu), f"{m}x{k}@{k}x{n} int4 g{pk.group}", got,
            matmul_int4_plain(x, pk, bias, relu),
            lambda: matmul_int4(x, pk, bias, relu), lambda: matmul_int4_plain(x, pk, bias, relu),
            2.0 * m * n * k, m * k * 2 + k * n // 2 + pk.sc.numel() * 2 + 4 * n + got.numel() * 4,
            per, library=lambda: torch.matmul(x, w), peak=PEAK_BF16, library_name=HMM,
            rel=(K13_REL, mag), relu=relu, out="fp32", spun=True))
        del x, got, mag
    return rows


def _bf16_layer(gen, dev, dp):
    """One packed DeiT-Tiny bf16 layer as pack_vit_blocks packs it: bf16
    K-major weights (std 1/sqrt(K), so each GEMM's outputs sit near unit
    scale), zero in the pad lanes past dim 192; fp32 biases and LN rows."""
    d, hp = VIT_DP, VIT_HP

    def w(n, k):
        a = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        if k == dp:
            a[:, d:] = 0.0
        if n == dp:
            a[d:] = 0.0
        return a.to(torch.bfloat16).contiguous()

    def b(n):
        v = 0.1 * torch.randn(n, generator=gen, device=dev)
        if n == dp:
            v[d:] = 0.0
        return v.float().contiguous()

    ln = torch.stack([0.5 + torch.rand(dp, generator=gen, device=dev),
                      0.1 * torch.randn(dp, generator=gen, device=dev)])
    ln[:, d:] = 0.0
    ln = ln.float().contiguous()
    wqkv = torch.cat([w(dp, dp) for _ in range(3)])
    return {"wqkv": wqkv, "bqkv": torch.cat([b(dp) for _ in range(3)]),
            "wproj": w(dp, dp), "bproj": b(dp), "ln1": ln, "ln2": ln.clone(),
            "wfc1": w(hp, dp), "bfc1": b(hp), "wfc2": w(dp, hp), "bfc2": b(dp)}


def _equal_fraction(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() == b.float()).float().mean())


@contextlib.contextmanager
def _fp32_order_sums():
    """The W4A16 and bf16 plain versions with their exact (float64) sums
    replaced by cuBLAS fp32 sums of the same exact products (TF32 off):
    another fp32 summation order of the same function."""
    from dlq_tpu_torch.models.common import fp32_matmul
    from dlq_tpu_torch.ops import vit_block
    from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor

    exact = vit_block._hgemm

    def hgemm_fp32(a, wk):
        w = unpack_halves_kmajor(wk) if wk.dtype == torch.uint8 else wk
        with fp32_matmul():
            return torch.matmul(a.float(), w.float().t())

    vit_block._hgemm = hgemm_fp32
    try:
        yield
    finally:
        vit_block._hgemm = exact


def _int4_rounded(blk):
    """A packed bf16 layer with each weight rounded to per-OC int4 (s =
    max|w| / 7), halves-packed K-major as pack_vit_blocks_w4 packs it: K12's
    form of the same layer."""
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor

    out = dict(blk)
    for name in ("qkv", "proj", "fc1", "fc2"):
        w = blk["w" + name].float()                              # [N, K]
        n, k = w.shape
        s = w.abs().amax(1) / 7.0
        q = torch.round(w / s.clamp_min(1e-30)[:, None]).clamp(-8, 7).to(torch.int8)
        out["w" + name] = pack_halves_kmajor(q.t().contiguous(), k, n)
        out["s" + name] = s.contiguous()
    return out


def check_bf16_kernels(dev):
    """K14 and K15 at the bf16 forward's tight (200/192) and loose (256/256)
    pads at batch 256, bf16 stream, with bf16 torch.matmul on the same
    weights as the yardstick. The bound counts the d_valid (192) lanes the
    kernels are given: the products and the inputs' bytes of the valid
    lanes (bf16 weights K x N x 2 bytes), the outputs written at their full
    padded width. It counts all Np rows: K14/K15 are not given n_valid, and
    the pad rows carry values (LN1's and the GEMMs' biases), as the
    reference's kernel computes them. K15's row also carries two witnesses
    for BF16_TOL: the plain version with its exact sums replaced by cuBLAS
    fp32 sums (another order, TF32 off) against the plain version, and K12
    on the same layer with its weights rounded to per-OC int4 against K12's
    plain version."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_bf16, vit_block_post_bf16_plain, vit_block_post_w4,
        vit_block_post_w4_plain, vit_block_pre_bf16, vit_block_pre_bf16_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    d, hp = VIT_DP, VIT_HP
    rows = []
    for (npad, dp, din), per in vit_pre_bf16_cases().items():
        blk = _bf16_layer(gen, dev, dp)
        m = BATCH * npad
        y = torch.randn((BATCH, npad, dp), generator=gen, device=dev)
        y[..., d:] = 0.0
        y = y.to(getattr(torch, din))
        h1 = torch.randn((m, dp), generator=gen, device=dev).to(torch.bfloat16)
        h2 = torch.randn((m, hp), generator=gen, device=dev).to(torch.bfloat16)
        wq, wp, w1, w2 = (blk[k].t() for k in ("wqkv", "wproj", "wfc1", "wfc2"))  # [K, N] views
        rows.append(_row(
            "vit_pre_bf16", (BATCH, npad, dp, din),
            f"{BATCH}x{npad}x{dp} {din} -> qkv, bf16 weights",
            vit_block_pre_bf16(y, blk, d), vit_block_pre_bf16_plain(y, blk, d),
            lambda: vit_block_pre_bf16(y, blk, d), lambda: vit_block_pre_bf16_plain(y, blk, d),
            2.0 * m * d * 3 * d,
            m * d * y.element_size() + 3 * d * d * 2 + 4 * 3 * d + 8 * d + m * 3 * dp * 2,
            per, library=lambda: torch.matmul(h1, wq), tol=BF16_TOL, peak=PEAK_BF16,
            library_name=BMM, residual=din, out="bf16", pads=f"{npad}/{dp}"))
        qkv = vit_block_pre_bf16_plain(y, blk, d)
        a = mhsa(qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d], VIT_HEADS,
                 VIT_N, out_lanes=dp)
        dout = "bfloat16"
        post_per = vit_post_bf16_cases()[(npad, dp, din, dout)]
        odt = getattr(torch, dout)

        def kern():
            return vit_block_post_bf16(y, a, blk, d, True, odt)

        def plain():
            return vit_block_post_bf16_plain(y, a, blk, d, True, odt)

        ref = plain()
        with _fp32_order_sums():
            other = plain()
        w4 = _int4_rounded(blk)
        ref4 = vit_block_post_w4_plain(y, a, w4, d, True, odt)
        with _fp32_order_sums():
            other4 = vit_block_post_w4_plain(y, a, w4, d, True, odt)
        witness = {"plain_fp32_order": _equal_fraction(other, ref),
                   "k12_int4_rounded": _equal_fraction(vit_block_post_w4(y, a, w4, d, True, odt),
                                                       ref4),
                   "plain_fp32_order_int4_rounded": _equal_fraction(other4, ref4)}
        del other, w4, ref4, other4
        rows.append(_row(
            "vit_post_bf16", (BATCH, npad, dp, hp, din, dout),
            f"{BATCH}x{npad}x{dp} {din} -> {dout}, mlp {hp}, bf16 weights", kern(), ref, kern,
            plain, 2.0 * m * (d * d + 2 * d * hp),
            2 * m * d * y.element_size() + (d * d + 2 * d * hp) * 2
            + 4 * (2 * d + hp) + 8 * d + m * dp * odt.itemsize, post_per,
            library=lambda: (torch.matmul(h1, wp), torch.matmul(h1, w1), torch.matmul(h2, w2)),
            tol=BF16_TOL, peak=PEAK_BF16, library_name=BMM + ", the three products",
            residual=din, out=dout, pads=f"{npad}/{dp}", bf16_tol_witness_equal_fraction=witness))
        del blk, y, h1, h2, qkv, a, ref
    return rows


def _i8_attn_held(got, ref, v, n_valid, zero_pad):
    """K18's gate: >= I8_ATTN_EQUAL of the outputs equal, every other one
    within 2 av / 127 (av per (sample, head) over the rows the form reads);
    returns (fraction equal, largest difference in units of av / 127)."""
    B, _, hw = v.shape
    vv = v.float()[:, :n_valid] if zero_pad else v.float()
    av = vv.reshape(B, -1, VIT_HEADS, VIT_HD).abs().amax(dim=(1, 3)) + 1e-9
    av = av.repeat_interleave(VIT_HD, dim=1)[:, None, :]
    d = (got[..., :hw].float() - ref[..., :hw].float()).abs()
    equal = float((d == 0).float().mean())
    steps = float((d / (av / 127.0)).max())
    if equal < I8_ATTN_EQUAL or steps > 2.0:
        raise AssertionError(f"mhsa_i8 {tuple(got.shape)}: {equal} of the outputs equal, largest "
                             f"difference {steps} av/127 (need {I8_ATTN_EQUAL}, 2)")
    return equal, steps


def check_int8_attention_kernels(dev):
    """K18 at every shape and form of its paths at batch 256: the in-kernel
    form on the tight block stream [256, 200, 3 x 192] (K5's plain output
    on a random stream), the zero-pad form on the split path's loose
    [256, 256, 3 x 256] stream and on the deploy path's [256, 197, 3 x 192]
    qkv dense in bf16 and (the fp32 forward's) fp32, each against
    mhsa_i8_plain (_i8_attn_held). The bound counts the products over the
    n_valid keys at the int8 peak, and q, k and v read over the rows the
    form needs (all rows in the in-kernel form, whose amax reads the pad
    rows; the n_valid rows in the zero-pad form) and the output written once
    at its full width; no PyTorch call computes int8 attention, so bf16 SDPA
    at the same shape is timed beside it (sdpa_bf16_ms), as on K6's row."""
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8, mhsa_i8_plain
    from dlq_tpu_torch.ops.vit_block import vit_block_pre_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    blk = _vit_layer(gen, dev)
    dp, hw = VIT_DP, VIT_HEADS * VIT_HD
    y = torch.randn((BATCH, VIT_NP, dp), generator=gen, device=dev)
    qkv = vit_block_pre_plain(y, blk, dp)              # [256, 200, 576] bf16, pad rows carry values
    del y
    rows = []
    for (n, n_valid, form, din, dout), per in mhsa_i8_cases().items():
        lanes = VIT_DP_LOOSE if n == VIT_NP_LOOSE else dp
        t = torch.zeros((BATCH, n, 3, lanes), dtype=torch.bfloat16, device=dev)
        m = min(n, VIT_NP)
        t[:, :m, :, :dp] = qkv[:, :m].view(BATCH, m, 3, dp)
        t = t.view(BATCH, n, 3 * lanes).to(getattr(torch, din))
        views = (t[..., :hw], t[..., lanes: lanes + hw], t[..., 2 * lanes: 2 * lanes + hw])
        zero_pad, odt = form == "zero_pad", getattr(torch, dout)
        q4, k4, v4 = (v.to(torch.bfloat16).reshape(BATCH, n, VIT_HEADS, VIT_HD).transpose(1, 2)
                      .contiguous() for v in views)

        def kern():
            return mhsa_i8(*views, VIT_HEADS, n_valid, out_lanes=lanes, zero_pad=zero_pad,
                           out_dtype=odt)

        def plain():
            return mhsa_i8_plain(*views, VIT_HEADS, n_valid, lanes, zero_pad, odt)

        got, ref = kern(), plain()
        equal, steps = _i8_attn_held(got, ref, views[2], n_valid, zero_pad)
        read = n_valid if zero_pad else n
        rows.append(_row(
            "mhsa_i8", (BATCH, n, VIT_HEADS, VIT_HD, n_valid, form, din, dout),
            f"{BATCH}x{VIT_HEADS} heads x {n} rows x {VIT_HD}, {n_valid} keys, {form}, {din}",
            got, ref, kern, plain, 4.0 * BATCH * VIT_HEADS * n * n_valid * VIT_HD,
            BATCH * (3 * read * hw * t.element_size() + n * lanes * odt.itemsize), per,
            tol=(I8_ATTN_EQUAL, math.inf), no_library=NO_INT8_ATTN, form=form, out=dout,
            within_2av_over_127=True, largest_diff_av_over_127=steps,
            sdpa_bf16_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))))
        del t, views, q4, k4, v4, got, ref
    del qkv
    return rows


def check_ln_kernels(dev):
    """K16 and K17 at [256 x 197, 192] in fp32 and bf16 (x, y, delta, g and
    b in the stream's dtype, as make_qforward casts them), with F.layer_norm
    (after y + delta for K17) as the yardstick; then K6's fp32 form at [256,
    197, 3 x 64] with fp32 scaled_dot_product_attention as the yardstick."""
    import torch.nn.functional as F

    from dlq_tpu_torch.ops.attention import mhsa, mhsa_plain
    from dlq_tpu_torch.ops.layernorm import (
        layernorm_fused, layernorm_fused_plain, residual_layernorm, residual_layernorm_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    m, d = BATCH * VIT_N, VIT_DP
    x32 = 0.3 + torch.randn((m, d), generator=gen, device=dev)
    d32 = 0.5 * torch.randn((m, d), generator=gen, device=dev)
    g32 = 0.5 + torch.rand(d, generator=gen, device=dev)
    b32 = 0.1 * torch.randn(d, generator=gen, device=dev)
    rows = []
    for dt, per in layernorm_fused_cases().items():
        x, g, b = (t.to(getattr(torch, dt)) for t in (x32, g32, b32))
        rows.append(_row(
            "layernorm_fused", (m, d, dt), f"{m}x{d} {dt}", layernorm_fused(x, g, b),
            layernorm_fused_plain(x, g, b), lambda: layernorm_fused(x, g, b),
            lambda: layernorm_fused_plain(x, g, b), 8.0 * m * d,
            2 * x.numel() * x.element_size() + 2 * d * g.element_size(), per,
            plain_iters=5, library=lambda: F.layer_norm(x, (d,), g, b, 1e-6),
            tol=LN_TOL[dt], peak=PEAK_FP32, library_name=LAYER_NORM, dtype=dt))
    for (ydt, ddt), per in residual_layernorm_cases().items():
        y, dl = x32.to(getattr(torch, ydt)), d32.to(getattr(torch, ddt))
        g, b = g32.to(y.dtype), b32.to(y.dtype)
        z, h = residual_layernorm(y, dl, g, b)
        zp, hp = residual_layernorm_plain(y, dl, g, b)
        if not torch.equal(z, zp):
            raise AssertionError(f"residual_layernorm {ydt}: z = y + delta differs from plain")
        rows.append(_row(
            "residual_layernorm", (m, d, ydt, ddt), f"{m}x{d} {ydt} + {ddt}", h, hp,
            lambda: residual_layernorm(y, dl, g, b), lambda: residual_layernorm_plain(y, dl, g, b),
            9.0 * m * d,
            y.numel() * y.element_size() + dl.numel() * dl.element_size()
            + 2 * y.numel() * y.element_size() + 2 * d * g.element_size(), per,
            plain_iters=5, library=lambda: F.layer_norm(y + dl, (d,), g, b, 1e-6),
            tol=LN_TOL[ydt], peak=PEAK_FP32, library_name=LAYER_NORM + " after y + delta",
            dtype=f"{ydt}+{ddt}", z_equal_plain=True))
    del x32, d32
    qkv = torch.randn((BATCH, VIT_N, 3 * d), generator=gen, device=dev)
    for (n, n_valid), per in mhsa_f32_cases().items():
        views = (qkv[:, :n, :d], qkv[:, :n, d: 2 * d], qkv[:, :n, 2 * d:])
        q4, k4, v4 = (v.reshape(BATCH, n, VIT_HEADS, VIT_HD).transpose(1, 2).contiguous()
                      for v in views)
        rows.append(_row(
            "mhsa_f32", (BATCH, n, VIT_HEADS, VIT_HD, n_valid),
            f"{BATCH}x{VIT_HEADS} heads x {n} rows x {VIT_HD}, {n_valid} keys, fp32",
            mhsa(*views, VIT_HEADS, n_valid), mhsa_plain(*views, VIT_HEADS, n_valid),
            lambda: mhsa(*views, VIT_HEADS, n_valid),
            lambda: mhsa_plain(*views, VIT_HEADS, n_valid),
            4.0 * BATCH * VIT_HEADS * n * n_valid * VIT_HD, _mhsa_bytes(n, n_valid, d, 4), per,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4),
            tol=MHSA_F32_TOL, peak=PEAK_FP32, library_name=SDPA_F32, out="fp32"))
        del q4, k4, v4
    return rows


def check_groupwise_routes(dev):
    """Group-wise int4 dense sites on the card: with activation scales the
    activations are fake-quantized and K13 runs (launch counted, held
    against its plain version); a group K13 does not tile (24 at K = 96)
    takes the dequantized route (no K13 launch), held against the float64
    product."""
    from dlq_tpu_torch.ops import qops
    from dlq_tpu_torch.ops.matmul_int4 import PackedInt4G, matmul_int4
    from dlq_tpu_torch.quant.qconfig import QScheme
    from dlq_tpu_torch.quant.quantize import dequantize, quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for group, k, n, act in ((128, 768, 192, 3.0 / 127.0), (24, 96, 40, None)):
        qw = quantize_tensor(0.02 * torch.randn((k, n), generator=gen, device=dev),
                             QScheme(4, True, -1, group=group))
        x = torch.randn((300, k), generator=gen, device=dev)
        scale = None if act is None else torch.tensor(act, device=dev)
        pk = qops.weight_only_packed(qw)
        if (pk is None) != (k % 16 != 0 or group % 16 != 0):
            raise AssertionError(f"group {group} at K = {k}: K13 weight {type(pk)}")
        before = matmul_int4.launches
        y = qops.qdense(x, qw, None, act_scale=scale, packed=pk)
        torch.cuda.synchronize()
        launched = matmul_int4.launches - before
        if launched != (1 if isinstance(pk, PackedInt4G) else 0):
            raise AssertionError(f"group {group} at K = {k}: {launched} K13 launches")
        with plain_kernels():
            yp = qops.qdense(x, qw, None, act_scale=scale, packed=pk)
        xr = x if scale is None else (qops.quantize_act(x, scale).float() * scale)
        mag = xr.double().abs() @ dequantize(qw).double().abs()
        err = float(((y.double() - yp.double()).abs() / mag.clamp_min(1e-30)).max())
        if err > K13_REL:
            raise AssertionError(f"group {group} at K = {k}: relative error {err} vs plain")
        out[f"g{group}_k{k}"] = {"acts": act is not None, "k13_launches": launched,
                                 "max_rel_err_vs_plain": err}
    emit({"phase": "groupwise_int4_routes", **out})


# ---------------------------------------------------------------------------
# phases 3-5: the main paths
# ---------------------------------------------------------------------------

def _wrappers():
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_f32
    from dlq_tpu_torch.ops.block_fused import basic_block_fused, bottleneck_block_fused
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8
    from dlq_tpu_torch.ops.conv_int8 import conv_int8
    from dlq_tpu_torch.ops.layernorm import layernorm_fused, residual_layernorm
    from dlq_tpu_torch.ops.matmul_int4 import matmul_int4
    from dlq_tpu_torch.ops.matmul_int4a8 import matmul_int4a8
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_bf16, vit_block_post_w4, vit_block_post_w4a8, vit_block_post_w8,
        vit_block_pre_bf16, vit_block_pre_w4, vit_block_pre_w4a8, vit_block_pre_w8,
    )

    ws = {"conv_int8": conv_int8, "matmul_int8": matmul_int8, "basic_block": basic_block_fused,
          "bottleneck_block": bottleneck_block_fused, "vit_pre_w8": vit_block_pre_w8,
          "mhsa": mhsa, "vit_post_w8": vit_block_post_w8, "vit_pre_w4a8": vit_block_pre_w4a8,
          "vit_post_w4a8": vit_block_post_w4a8, "matmul_int4a8": matmul_int4a8,
          "vit_pre_w4": vit_block_pre_w4, "vit_post_w4": vit_block_post_w4,
          "matmul_int4": matmul_int4, "vit_pre_bf16": vit_block_pre_bf16,
          "vit_post_bf16": vit_block_post_bf16, "layernorm_fused": layernorm_fused,
          "residual_layernorm": residual_layernorm, "mhsa_f32": mhsa_f32, "mhsa_i8": mhsa_i8}
    assert tuple(ws) == KERNELS
    return ws


def _probe_modules():
    import importlib

    return {name: importlib.import_module(f"dlq_tpu_torch.tools.{mod}")
            for name, (mod, _, _) in PROBES.items()}


def reset_counts():
    probes = [getattr(mod, name) for name, mod in _probe_modules().items()]
    for fn in [*_wrappers().values(), *probes]:
        fn.launches = 0
        fn.by_shape.clear()


def read_counts():
    """(launches per kernel, launches per kernel and shape key)."""
    ws = _wrappers()
    return ({k: fn.launches for k, fn in ws.items()},
            {k: dict(fn.by_shape) for k, fn in ws.items()})


def expect_counts(got, path, forwards, what):
    want = {k: v * forwards for k, v in PER_FORWARD[path].items()}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} ({forwards} forwards)")


def expect_by_shape(got, path, forwards, what):
    want = expected_by_shape(path, forwards)
    if got != want:
        raise AssertionError(f"{what}: launches per shape {got}, expected {want}")


def gate(logits, ref, what, min_cos, top1=True):
    """Cosine >= ``min_cos`` and, with ``top1``, top-1 agreement 1.0."""
    from dlq_tpu_torch import numerics

    agree = numerics.top1_agreement(logits, ref)
    cos = numerics.diff(logits, ref).cosine
    if (top1 and agree < 1.0) or cos < min_cos:
        raise AssertionError(f"{what}: top-1 agreement {agree}, cosine {cos} "
                             f"(need {1.0 if top1 else 'any'}, {min_cos})")
    return agree, cos


def top1_report(logits, ref):
    """Why top-1 agreement is not a gate on a random-weight ResNet-50: how
    many distinct classes the reference logits pick over the batch, and, for
    each disagreeing image, the reference margin between its top two
    classes beside the largest logit difference on that image."""
    top2 = np.sort(ref, -1)[:, -2:]
    err = np.abs(logits - ref).max(-1)
    bad = np.nonzero(logits.argmax(-1) != ref.argmax(-1))[0]
    return {"ref_argmax_classes": int(len(np.unique(ref.argmax(-1)))),
            "ref_logit_std_over_classes": float(ref.std(-1).mean()),
            "ref_margin_median": float(np.median(top2[:, 1] - top2[:, 0])),
            "logit_err_max": float(err.max()),
            "disagreeing": [{"image": int(i), "ref_margin": float(top2[i, 1] - top2[i, 0]),
                             "logit_err": float(err[i])} for i in bad]}


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel call of the contexts to its plain PyTorch version
    (on the same card): the reference numerics of the same forward."""
    from dlq_tpu_torch.ops import (
        attention, block_fused, conv_int8, int8_attention, layernorm, matmul_int4, matmul_int4a8,
        matmul_int8, qops, vit_block,
    )
    from dlq_tpu_torch.quant import model_quant

    subs = [(vit_block, "vit_block_pre_bf16", vit_block.vit_block_pre_bf16_plain),
            (vit_block, "vit_block_post_bf16", vit_block.vit_block_post_bf16_plain),
            (layernorm, "layernorm_fused", layernorm.layernorm_fused_plain),
            (layernorm, "residual_layernorm", layernorm.residual_layernorm_plain),
            (vit_block, "vit_block_pre_w8", vit_block.vit_block_pre_plain),
            (vit_block, "vit_block_post_w8", vit_block.vit_block_post_plain),
            (vit_block, "vit_block_pre_w4a8", vit_block.vit_block_pre_plain),
            (vit_block, "vit_block_post_w4a8", vit_block.vit_block_post_plain),
            (vit_block, "vit_block_pre_w4", vit_block.vit_block_pre_w4_plain),
            (vit_block, "vit_block_post_w4", vit_block.vit_block_post_w4_plain),
            (vit_block, "mhsa", attention.mhsa_plain),
            (attention, "mhsa", attention.mhsa_plain),
            (vit_block, "mhsa_i8", int8_attention.mhsa_i8_plain),
            (int8_attention, "mhsa_i8", int8_attention.mhsa_i8_plain),
            (int8_attention, "mhsa", attention.mhsa_plain),
            (model_quant, "conv_int8", conv_int8.conv_int8_plain),
            (qops, "conv_int8", conv_int8.conv_int8_plain),
            (qops, "matmul_int8", matmul_int8.matmul_int8_plain),
            (qops, "matmul_int4a8", matmul_int4a8.matmul_int4a8_plain),
            (qops, "matmul_int4", matmul_int4.matmul_int4_plain),
            (block_fused, "basic_block_fused", block_fused.basic_block_plain),
            (block_fused, "bottleneck_block_fused", block_fused.bottleneck_block_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in subs]
    for m, n, f in subs:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def plain_equivalence(eng, x, cfg, qf, logits, taps, stages, what):
    """The forward through the kernels equals the same forward through the
    plain versions: int8 stage taps and logits bit-identical (no kernel may
    launch inside the plain run)."""
    reset_counts()
    with plain_kernels():
        lp, tp = _taps(eng, x, cfg, qf)
    if any(read_counts()[0].values()):
        raise AssertionError(f"{what}: a kernel launched inside the plain run {read_counts()[0]}")
    diff = {k: float(np.abs(taps[k] - tp[k]).max()) for k in stages}
    diff["logits"] = float(np.abs(logits - lp).max())
    if any(diff.values()):
        raise AssertionError(f"{what}: kernels vs plain versions differ {diff}")
    return diff


def block_contract(ctx, packs, x, cfg):
    """Each packed Bottleneck against the FullFusedCtx composition on the
    same int8 input: the fused2 forward's own block inputs, taken where it
    reaches each block. Returns {site: (fraction of equal int8 outputs,
    largest difference in steps)}; pallas_block.py:20-28 lets ~1e-4 of the
    elements of one block differ by one step."""
    from dlq_tpu_torch.models.resnet import qforward_fused2
    from dlq_tpu_torch.ops.block_fused import bottleneck_block_fused

    out = {}

    def probe(site, y, nxt):
        if site not in packs:
            return None
        z = ctx.conv(f"{site}.conv1", y, fuse_relu=True, out_site=f"{site}.conv2")
        z = ctx.conv(f"{site}.conv2", z, stride=1, padding=1, fuse_relu=True,
                     out_site=f"{site}.conv3")
        ref = ctx.add_relu(ctx.conv(f"{site}.conv3", z, out_site=nxt), ctx.requant(y, nxt))
        got = bottleneck_block_fused(y.q, packs[site])
        out[site] = (float((got == ref.q).float().mean()),
                     int((got.int() - ref.q.int()).abs().max()))
        return ref

    ctx.fused_block = probe
    try:
        with torch.inference_mode():
            qforward_fused2(ctx, torch.from_numpy(x).to(ctx.scale_t["stem"].device), cfg)
    finally:
        del ctx.fused_block
    return out


def drive(eng, images, path, what):
    """Warm, then classify ``NB`` batches with the counts set to 0 just
    before and read just after; checks the launches per kernel and shape."""
    eng.classify(images[:BATCH])                   # warm (first launches)
    eng.stats.images_timed, eng.stats.ms_total = 0, 0.0
    reset_counts()
    preds = eng.classify(images, pipeline=2)
    counts, shapes = read_counts()
    expect_counts(counts, path, NB, what)
    expect_by_shape(shapes, path, NB, what)
    return preds, counts, shapes


def main_paths(dev, card, depth, images):
    """fused2, PallasBlockCtx, deploy and pallas of ResNet-``depth``; returns
    {path: (counts, shapes)} of the two timed main paths."""
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.resnet import (
        ResNetConfig, flatten_folded, fold_resnet, folded_forward, init_resnet, qforward,
        qforward_fused2,
    )
    from dlq_tpu_torch.ops.block_fused import pack_fused_blocks
    from dlq_tpu_torch.quant.model_quant import FullFusedCtx, PallasBlockCtx
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import load_quantized, save_quantized

    model, tag = f"resnet{depth}", f"r{depth}"
    cfg = ResNetConfig(depth=depth, num_classes=1000)
    folded = fold_resnet(init_resnet(SEED, cfg), cfg)
    flat = flatten_folded(folded)
    calib = [np.random.default_rng(SEED + depth).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)]
    x0 = images[:BATCH]

    fp32 = Engine.fp32(folded_forward, folded, cfg, batch=BATCH, device=dev, name=f"{model}_fp32")
    ref_logits = fp32(x0).float().cpu().numpy()
    del fp32

    t0 = time.perf_counter()
    eng_q = Engine.quantized(qforward, flat, cfg, INT8_PER_CHANNEL, calib_batches=calib,
                             batch=BATCH, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, model, eng_q.qflat, eng_q.act_scales, INT8_PER_CHANNEL,
                       meta={"config": {"num_classes": 1000, "small_input": False}})
        del eng_q
        eng = Engine.from_store(tmp, ctx="fused2", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0

        # ---- phase 3: the fused2 main path ----
        path = f"{tag}_fused2"
        preds, counts, shapes = drive(eng, images, path, f"{model} fused2")
        logits_f2, taps_f2 = _taps(eng, x0, cfg, qforward_fused2)
        if not np.array_equal(preds[:BATCH], logits_f2.argmax(-1)):
            raise AssertionError(f"{model} fused2: classify and the taps forward disagree")
        # ResNet-50's random-weight logits collapse onto one or two classes
        # with a runner-up margin below the int8 path's logit error, so its
        # top-1 agreement (with fp32 here, with fused2 in phase 4) is reported,
        # not gated (top1_report); every forward is held bit-identical to its
        # plain-version twin instead
        top1 = depth == 18
        agree, cos = gate(logits_f2, ref_logits, f"{model} fused2 vs fp32", 0.999, top1=top1)
        int8_stages = ("stem", "layer1", "layer2", "layer3")
        plain_f2 = plain_equivalence(eng, x0, cfg, qforward_fused2, logits_f2, taps_f2,
                                     int8_stages, f"{model} fused2")
        xt = torch.from_numpy(x0).to(dev)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        # the 224 px stem alone (bf16 conv, int8 requant, int8 maxpool): no kernel of this port
        with torch.inference_mode():
            stem_ms = time_ms(lambda: eng.params.maxpool(
                eng.params.conv_stem_bf16("stem", xt, out_site="layer1.0.conv1")), iters=10)
        emit({"phase": "main_path_fused2", "model": model, "size": 224, "batch": BATCH,
              "batches": NB, "img_per_s_classify": eng.stats.images_per_sec,
              "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
              "stem_maxpool_ms": stem_ms,
              "launches": counts, "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "top1_agreement_vs_fp32": agree, "logits_cosine_vs_fp32": cos,
              "top1_gated": top1, "top1_vs_fp32": top1_report(logits_f2, ref_logits),
              "max_abs_vs_plain_versions": plain_f2, "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, f"{model}_fused2")
        out[path] = (counts, shapes)
        del eng

        # ---- phase 4: PallasBlockCtx on the same store ----
        qflat, scales, qcfg, _ = load_quantized(tmp)
        qflat = {k: {n: (t.to(dev) if t is not None else None) for n, t in v.items()}
                 for k, v in qflat.items()}
        scales = {k: v.to(dev) for k, v in scales.items()}
        packs = pack_fused_blocks(qflat, scales, cfg)
        want_sites = ({"layer2.1", "layer3.1"} if depth == 18 else
                      {f"layer{s + 1}.{b}" for s, n in enumerate(cfg.blocks_per_stage)
                       for b in range(1, n)} - {"layer4.2"})
        if set(packs) != want_sites:
            raise AssertionError(f"{model} block sites {sorted(packs)}")
        blk = Engine(lambda c, x: qforward_fused2(c, x, cfg),
                     PallasBlockCtx(qflat, scales, qcfg, packs), batch=BATCH, device=dev,
                     name=f"{model}_block")
        path = f"{tag}_block"
        preds_b, counts_b, shapes_b = drive(blk, images, path, f"{model} PallasBlockCtx")
        logits_b, taps_b = _taps(blk, x0, cfg, qforward_fused2)
        agree_b, cos_b = gate(logits_b, logits_f2, f"{model} PallasBlockCtx vs fused2", 0.9999,
                              top1=top1)
        stages = ("layer2", "layer3") if depth == 18 else ("layer1", "layer2", "layer3")
        eq = {k: float((taps_b[k] == taps_f2[k]).mean()) for k in stages}
        per_block = None
        if depth == 18 and min(eq.values()) < 0.999:
            raise AssertionError(f"{model} PallasBlockCtx block outputs agree on {eq} (< 0.999)")
        if depth != 18:
            # ResNet-50 chains up to 5 packed blocks per stage, and each
            # block's ~1e-4 one-step differences feed the next: the contract
            # is held per block, on the fused2 forward's own block inputs
            per_block = block_contract(FullFusedCtx(qflat, scales, qcfg), packs, x0, cfg)
            if set(per_block) != set(packs) or any(
                    f < 0.999 or d > 1 for f, d in per_block.values()):
                raise AssertionError(f"{model} K4 vs the fused2 composition per block {per_block}")
        plain_b = plain_equivalence(blk, x0, cfg, qforward_fused2, logits_b, taps_b,
                                    int8_stages, f"{model} PallasBlockCtx")
        del taps_b, taps_f2
        ms_b = time_ms(lambda: blk._fn(blk.params, xt), iters=10)
        emit({"phase": "main_path_block", "model": model, "batch": BATCH, "batches": NB,
              "img_per_s_classify": blk.stats.images_per_sec, "ms_per_batch": ms_b,
              "img_per_s_device": BATCH / (ms_b / 1e3), "launches": counts_b,
              "launches_per_forward": {k: v / NB for k, v in counts_b.items()},
              "top1_agreement_vs_fused2": agree_b, "logits_cosine_vs_fused2": cos_b,
              "top1_gated": top1, "top1_vs_fused2": top1_report(logits_b, logits_f2),
              "block_output_equal_fraction": eq, "per_block_equal_fraction_max_step": per_block,
              "max_abs_vs_plain_versions": plain_b,
              "preds_equal_fused2": float((preds_b == preds).mean()), "card": card})
        profile_forward(blk, xt, f"{model}_block")
        out[path] = (counts_b, shapes_b)
        del blk

        # ---- phase 5: fp32-interchange contexts at batch 64 ----
        for name in ("deploy", "pallas"):
            e = Engine.from_store(tmp, ctx=name, batch=64, device=dev)
            reset_counts()
            lg = e(x0[:64]).float().cpu().numpy()
            c = read_counts()[0]
            expect_counts(c, f"{tag}_deploy", 1, f"{model} {name}")
            agree_d, cos_d = gate(lg, ref_logits[:64], f"{model} {name} vs fp32", 0.999,
                                  top1=top1)
            reset_counts()
            with plain_kernels(), torch.inference_mode():
                lp = e._fn(e.params, torch.from_numpy(x0[:64]).to(dev)).float().cpu().numpy()
            if any(read_counts()[0].values()) or not np.array_equal(lp, lg):
                raise AssertionError(f"{model} {name}: kernels vs plain versions differ")
            emit({"phase": f"ctx_{name}", "model": model, "batch": 64, "launches": c,
                  "top1_agreement_vs_fp32": agree_d, "logits_cosine_vs_fp32": cos_d,
                  "top1_gated": top1, "top1_vs_fp32": top1_report(lg, ref_logits[:64]),
                  "logits_equal_plain_versions": True})
            del e
    torch.cuda.empty_cache()
    return out


def deit_model(dev, images):
    """DeiT-Tiny (224 px, patch 16, dim 192, depth 12, 3 heads, 1000
    classes) with numpy-seeded weights on the card, its fp32 logits on the
    first batch (tanh and exact GELU), and the calibration batch."""
    from dlq_tpu_torch.engine import to_device
    from dlq_tpu_torch.models.vit import ViTConfig, init_vit, make_qforward, vit_extras, vit_forward

    cfg = ViTConfig()
    params = to_device(init_vit(SEED, cfg), dev)
    x0 = images[:BATCH]
    xt = torch.from_numpy(x0).to(dev)
    with torch.inference_mode():
        ref = {g: vit_forward(params, xt, ViTConfig(gelu=g)).cpu().numpy()
               for g in ("tanh", "exact")}
    return {"cfg": cfg, "params": params, "x0": x0, "xt": xt, "ref": ref,
            "meta": {"config": {k: getattr(cfg, k) for k in (
                "num_classes", "image_size", "patch", "dim", "depth", "heads", "mlp_ratio")}},
            "qf": make_qforward(vit_extras(params), cfg.depth, cfg.heads, cfg.patch, cfg.dim),
            "calib": [np.random.default_rng(SEED + 12).normal(0, 1, (8, 224, 224, 3))
                      .astype(np.float32)]}


def deit_paths(dev, card, d, images):
    """DeiT-Tiny W8A8: the block main path (timed, batch 256), then
    vit_forward_blockfused_w8 and ctx="deploy" at batch 64; returns
    ({"deit_block": (counts, shapes)}, the calibrated act scales)."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine, to_device
    from dlq_tpu_torch.models.vit import flatten_vit, vit_extras
    from dlq_tpu_torch.ops.vit_block import pack_vit_blocks_w8, vit_forward_blockfused_w8
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import load_quantized, save_quantized, unflatten_extras

    cfg, params, x0, xt, ref, meta = (d[k] for k in ("cfg", "params", "x0", "xt", "ref", "meta"))
    t0 = time.perf_counter()
    eng_q = Engine.quantized(d["qf"], flatten_vit(params), cfg, INT8_PER_CHANNEL,
                             calib_batches=d["calib"], batch=BATCH, device=dev)
    act_scales = eng_q.act_scales
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, "deit_tiny", eng_q.qflat, eng_q.act_scales, INT8_PER_CHANNEL,
                       extras=vit_extras(params), meta=meta)
        del eng_q
        eng = Engine.from_store(tmp, ctx="block", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0

        # ---- the block main path ----
        preds, counts, shapes = drive(eng, images, "deit_block", "deit_tiny block")
        with torch.inference_mode():
            logits = eng(x0).float().cpu().numpy()
        if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
            raise AssertionError("deit_tiny block: classify and the forward disagree")
        # W8A8 over 12 random-weight layers sits at cosine ~0.9987-0.9989 of
        # fp32 in the reference itself (its jitted deploy forward on the CPU:
        # 0.99875, top-1 0.875 on 16 images), so the fp32 gate is 0.998 and
        # top-1 is reported beside the fp32 margins (PERF.md, Findings)
        agree, cos = gate(logits, ref["tanh"], "deit_tiny block vs fp32", DEIT_FP32_COS,
                          top1=False)
        # the random-weight net amplifies one-step differences over 12 layers
        # (on the CPU, summing LN's moments in another order alone moves the
        # logits to cosine 0.99977), so the kernels are held per layer on
        # this forward's own inputs (layer_contract) and the twin at 0.999
        lp = plain_twin(eng, x0, "deit_tiny block")
        cos_p = gate(logits, lp, "deit_tiny block vs its plain versions", DEIT_TWIN_COS,
                     top1=False)[1]
        per_layer = layer_contract(eng.params, xt, cfg)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        # the bound of the reference's one launch per chunk, as its I/O
        # defines it: the bf16 stream in and out once per chunk, the int8
        # weights once, every int8 GEMM and the bf16 attention products over
        # the valid keys (the three-kernel split's bound is the sum of K5-K7's
        # in the kernels line)
        w_bytes = VIT_DP * 3 * VIT_DP + VIT_DP * VIT_DP + 2 * VIT_DP * VIT_HP
        t_ops = cfg.depth * (2.0 * BATCH * VIT_NP * w_bytes / PEAK_INT8_OPS
                             + 4.0 * BATCH * VIT_HEADS * VIT_NP * VIT_N * VIT_HD / PEAK_BF16)
        t_bytes = (len(eng.params["_chunks"]) * 2 * BATCH * VIT_NP * VIT_DP * 2
                   + cfg.depth * w_bytes) / PEAK_BYTES
        emit({"phase": "main_path_deit_block", "model": "deit_tiny", "size": 224, "batch": BATCH,
              "batches": NB, "layers_per_chunk": [len(c) for c in eng.params["_chunks"]],
              "img_per_s_classify": eng.stats.images_per_sec, "ms_per_batch": ms,
              "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
              "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "logits_cosine_vs_fp32": cos, "top1_agreement_vs_fp32": agree, "top1_gated": False,
              "top1_vs_fp32": top1_report(logits, ref["tanh"]),
              "logits_cosine_vs_plain_versions": cos_p,
              "top1_agreement_vs_plain_versions": numerics.top1_agreement(logits, lp),
              "per_layer_equal_fraction_max_abs": per_layer,
              "bound_one_launch_per_chunk_ms": max(t_ops, t_bytes) * 1e3,
              "bound_one_launch_per_chunk_by": "operations" if t_ops >= t_bytes else "bytes",
              "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, "deit_tiny_block")
        out["deit_block"] = (counts, shapes)
        out.update(deit_attn_int8_paths(dev, card, d, tmp, images, eng, act_scales))
        del eng

        # ---- one layer per K5/K6/K7 chain, bf16 between layers, batch 64 ----
        qflat, scales, _, extras = load_quantized(tmp)
        packed = pack_vit_blocks_w8(to_device(qflat, dev), to_device(scales, dev),
                                    to_device(unflatten_extras(extras), dev), cfg, tight=True)
        bf = Engine(lambda p, x: vit_forward_blockfused_w8(p, x, cfg, tight=True), packed,
                    batch=64, device=dev, name="deit_tiny_blockfused")
        for name, e, rk in (("blockfused", bf, "tanh"),
                            ("deploy", Engine.from_store(tmp, ctx="deploy", batch=64, device=dev),
                             "exact")):
            reset_counts()
            with torch.inference_mode():
                lg = e(x0[:64]).float().cpu().numpy()
            c = read_counts()[0]
            expect_counts(c, f"deit_{name}", 1, f"deit_tiny {name}")
            agree_d, cos_d = gate(lg, ref[rk][:64], f"deit_tiny {name} vs fp32", DEIT_FP32_COS,
                                  top1=False)
            lpd = plain_twin(e, x0[:64], f"deit_tiny {name}")
            cos_pd = gate(lg, lpd, f"deit_tiny {name} vs its plain versions", DEIT_TWIN_COS,
                          top1=False)[1]
            emit({"phase": f"deit_{name}", "model": "deit_tiny", "batch": 64, "launches": c,
                  "logits_cosine_vs_fp32": cos_d, "top1_agreement_vs_fp32": agree_d,
                  "fp32_gelu": rk, "top1_gated": False,
                  "top1_vs_fp32": top1_report(lg, ref[rk][:64]),
                  "logits_cosine_vs_plain_versions": cos_pd,
                  "top1_agreement_vs_plain_versions": numerics.top1_agreement(lg, lpd)})
            del e
        del bf, packed
    torch.cuda.empty_cache()
    return out, act_scales


def deit_attn_int8_paths(dev, card, d, store, images, eng_block, act_scales):
    """DeiT-Tiny W8A8 with int8 attention, on the W8A8 store ``store``: the
    multiblock forward with attn_int8=True (tight pads, 6 layers per chunk,
    K5 -> K18 -> K7 per layer) through Engine and classify at batch 256,
    timed in turns with the bf16-attention block engine ``eng_block``
    (K5 -> K6 -> K7) and profiled; then at batch 64 the split-attention
    forward (loose pads) with attn="int8" (K18, zero-pad form) and "bf16"
    (K6: bit-identical to vit_forward_blockfused_w8 on the same packing),
    and make_qforward(attn_impl="xla_int8") under DeployCtx on the store's
    act scales (K2 50, K18 12). Returns {path: (counts, shapes)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine, to_device
    from dlq_tpu_torch.models.vit import flatten_vit, make_qforward, vit_extras
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8, mhsa_i8_plain
    from dlq_tpu_torch.ops.vit_block import (
        pack_vit_blocks_w8, stack_vit_blocks_w8, vit_forward_blockfused_w8,
        vit_forward_blockfused_w8_split, vit_forward_multiblock_w8,
    )
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import load_quantized, unflatten_extras

    cfg, params, x0, xt, ref = (d[k] for k in ("cfg", "params", "x0", "xt", "ref"))
    out = {}
    t0 = time.perf_counter()
    qflat, scales, _, extras = load_quantized(store)
    qd, sd, ed = (to_device(t, dev) for t in (qflat, scales, unflatten_extras(extras)))
    packed = pack_vit_blocks_w8(qd, sd, ed, cfg, tight=True)
    packed["_chunks"] = stack_vit_blocks_w8(packed, 6)
    packed.pop("blocks")
    eng = Engine(lambda p, x: vit_forward_multiblock_w8(p, x, cfg, tight=True, attn_int8=True),
                 packed, batch=BATCH, device=dev, name="deit_tiny_block_attn_int8")
    setup_s = time.perf_counter() - t0
    preds, counts, shapes = drive(eng, images, "deit_block_attn_int8", "deit_tiny attn_int8")
    with torch.inference_mode():
        logits = eng(x0).float().cpu().numpy()
    if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
        raise AssertionError("deit_tiny attn_int8: classify and the forward disagree")
    agree, cos = gate(logits, ref["tanh"], "deit_tiny attn_int8 vs fp32", DEIT_ATTN_INT8_FP32_COS,
                      top1=False)
    lp = plain_twin(eng, x0, "deit_tiny attn_int8")
    cos_p = gate(logits, lp, "deit_tiny attn_int8 vs its plain versions", DEIT_TWIN_COS,
                 top1=False)[1]
    per_layer = layer_contract(eng.params, xt, cfg, attn=(mhsa_i8, mhsa_i8_plain))
    # the two block engines in turns: bf16 attention, int8, int8, bf16
    ab = {}
    for tag, e in (("bf16_attention", eng_block), ("int8_attention", eng), ("int8_attention", eng),
                   ("bf16_attention", eng_block)):
        ab.setdefault(tag, []).append(time_ms(lambda: e._fn(e.params, xt), iters=10))
    ms = min(ab["int8_attention"])
    w_bytes = VIT_DP * 3 * VIT_DP + VIT_DP * VIT_DP + 2 * VIT_DP * VIT_HP
    t_ops = cfg.depth * (2.0 * BATCH * VIT_NP * w_bytes
                         + 4.0 * BATCH * VIT_HEADS * VIT_NP * VIT_N * VIT_HD) / PEAK_INT8_OPS
    t_bytes = (len(packed["_chunks"]) * 2 * BATCH * VIT_NP * VIT_DP * 2
               + cfg.depth * w_bytes) / PEAK_BYTES
    emit({"phase": "main_path_deit_block_attn_int8", "model": "deit_tiny", "size": 224,
          "batch": BATCH, "batches": NB, "layers_per_chunk": [len(c) for c in packed["_chunks"]],
          "engine": eng.name, "img_per_s_classify": eng.stats.images_per_sec,
          "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
          "ms_per_batch_in_turns": ab, "deit_block_ms_per_batch_same_call": min(ab["bf16_attention"]),
          "launches": counts, "launches_per_forward": {k: v / NB for k, v in counts.items()},
          "logits_cosine_vs_fp32": cos, "top1_agreement_vs_fp32": agree, "fp32_gelu": "tanh",
          "top1_gated": False, "top1_vs_fp32": top1_report(logits, ref["tanh"]),
          "logits_cosine_vs_plain_versions": cos_p,
          "top1_agreement_vs_plain_versions": numerics.top1_agreement(logits, lp),
          "per_layer_equal_fraction_max_abs": per_layer,
          "bound_one_launch_per_chunk_ms": max(t_ops, t_bytes) * 1e3,
          "bound_one_launch_per_chunk_by": "operations" if t_ops >= t_bytes else "bytes",
          "setup_s": setup_s, "card": card})
    profile_forward(eng, xt, "deit_tiny_block_attn_int8")
    out["deit_block_attn_int8"] = (counts, shapes)
    del eng, packed

    # ---- the split-attention forward, loose pads, batch 64 ----
    xb = x0[:TOTALS_BATCH]
    loose = pack_vit_blocks_w8(qd, sd, ed, cfg)
    split = {}
    for attn in ("int8", "bf16"):
        e = Engine(lambda p, x, a=attn: vit_forward_blockfused_w8_split(p, x, cfg, attn=a), loose,
                   batch=TOTALS_BATCH, device=dev, name=f"deit_tiny_split_{attn}")
        reset_counts()
        with torch.inference_mode():
            lg = split[attn] = e(xb).float().cpu().numpy()
        c, sh = read_counts()
        expect_counts(c, f"deit_split_{attn}", 1, f"deit_tiny split {attn}")
        out[f"deit_split_{attn}"] = (c, sh)
        min_cos = DEIT_ATTN_INT8_FP32_COS if attn == "int8" else DEIT_FP32_COS
        agree_s, cos_s = gate(lg, ref["tanh"][:TOTALS_BATCH], f"deit_tiny split {attn} vs fp32",
                              min_cos, top1=False)
        cos_ps = gate(lg, plain_twin(e, xb, f"deit_tiny split {attn}"),
                      f"deit_tiny split {attn} vs its plain versions", DEIT_TWIN_COS,
                      top1=False)[1]
        emit({"phase": f"deit_split_{attn}", "model": "deit_tiny", "batch": TOTALS_BATCH,
              "pads": f"{VIT_NP_LOOSE}/{VIT_DP_LOOSE}", "launches": c,
              "logits_cosine_vs_fp32": cos_s, "top1_agreement_vs_fp32": agree_s,
              "fp32_gelu": "tanh", "top1_gated": False, "logits_cosine_vs_plain_versions": cos_ps})
        del e
    with torch.inference_mode():
        fused = vit_forward_blockfused_w8(loose, torch.from_numpy(xb).to(dev), cfg).float()
    if not np.array_equal(split["bf16"], fused.cpu().numpy()):
        raise AssertionError("deit_tiny split bf16 arm: logits differ from vit_forward_blockfused_w8")
    emit({"phase": "deit_split_bf16_vs_blockfused_w8", "logits_bit_identical": True})
    del loose

    # ---- make_qforward(attn_impl="xla_int8") under DeployCtx, batch 64 ----
    qf = make_qforward(vit_extras(params), cfg.depth, cfg.heads, cfg.patch, cfg.dim,
                       attn_impl="xla_int8")
    e = Engine.quantized(qf, flatten_vit(params), cfg, INT8_PER_CHANNEL, act_scales=act_scales,
                         batch=TOTALS_BATCH, device=dev)
    reset_counts()
    with torch.inference_mode():
        lg = e(xb).float().cpu().numpy()
    c, sh = read_counts()
    expect_counts(c, "deit_deploy_xla_int8", 1, "deit_tiny deploy xla_int8")
    out["deit_deploy_xla_int8"] = (c, sh)
    agree_d, cos_d = gate(lg, ref["exact"][:TOTALS_BATCH], "deit_tiny deploy xla_int8 vs fp32",
                          DEIT_ATTN_INT8_FP32_COS, top1=False)
    cos_pd = gate(lg, plain_twin(e, xb, "deit_tiny deploy xla_int8"),
                  "deit_tiny deploy xla_int8 vs its plain versions", DEIT_TWIN_COS, top1=False)[1]
    emit({"phase": "deit_deploy_xla_int8", "model": "deit_tiny", "batch": TOTALS_BATCH,
          "launches": c, "logits_cosine_vs_fp32": cos_d, "top1_agreement_vs_fp32": agree_d,
          "fp32_gelu": "exact", "top1_gated": False, "logits_cosine_vs_plain_versions": cos_pd})
    del e, qd, sd, ed
    torch.cuda.empty_cache()
    return out


def deit_w4a8_paths(dev, card, d, act_scales, images):
    """DeiT-Tiny W4A8: the same weights quantized INT4A8_PER_CHANNEL, with
    the W8A8 store's act scales (calibration reads only the fp32 model and
    the activation scheme, which the two configs share). The block main
    path (timed, batch 256), then ctx="deploy" at batch 64 with
    int4_runtime "packed" (K10) and "int8" (K2), whose logits must be
    bit-identical, and ctx="block" with int4_runtime="int8" (the W8 block
    path) at batch 64; returns {"deit_block_w4a8": (counts, shapes),
    "deit_deploy_w4a8": (counts, shapes)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.vit import flatten_vit, vit_extras
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import save_quantized

    cfg, params, x0, xt, ref, meta = (d[k] for k in ("cfg", "params", "x0", "xt", "ref", "meta"))
    t0 = time.perf_counter()
    eng_q = Engine.quantized(d["qf"], flatten_vit(params), cfg, INT4A8_PER_CHANNEL,
                             act_scales=act_scales, batch=BATCH, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, "deit_tiny", eng_q.qflat, eng_q.act_scales, INT4A8_PER_CHANNEL,
                       extras=vit_extras(params), meta=meta)
        del eng_q
        eng = Engine.from_store(tmp, ctx="block", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0
        w_bytes = {k: sum(b[k].numel() * b[k].element_size() for b in eng.params["blocks"])
                   for k in ("wqkv", "wproj", "wfc1", "wfc2")}
        if eng.name != "deit_tiny_block_w4a8" or \
                any(b["wqkv"].dtype != torch.uint8 for b in eng.params["blocks"]):
            raise AssertionError(f"deit_tiny W4A8 block: engine {eng.name}, not 4-bit weights")

        # ---- the W4A8 block main path ----
        preds, counts, shapes = drive(eng, images, "deit_block_w4a8", "deit_tiny block_w4a8")
        with torch.inference_mode():
            logits = eng(x0).float().cpu().numpy()
        if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
            raise AssertionError("deit_tiny block_w4a8: classify and the forward disagree")
        # the reference's own W4A8 error on these random weights sets the
        # fp32 gate (tools/deit_reference_error.py; PERF.md, Findings)
        agree, cos = gate(logits, ref["tanh"], "deit_tiny block_w4a8 vs fp32", DEIT_W4A8_FP32_COS,
                          top1=False)
        lp = plain_twin(eng, x0, "deit_tiny block_w4a8")
        cos_p = gate(logits, lp, "deit_tiny block_w4a8 vs its plain versions", DEIT_TWIN_COS,
                     top1=False)[1]
        per_layer = layer_contract(eng.params, xt, cfg)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        emit({"phase": "main_path_deit_block_w4a8", "model": "deit_tiny", "size": 224,
              "batch": BATCH, "batches": NB, "scheme": "INT4A8_PER_CHANNEL", "engine": eng.name,
              "img_per_s_classify": eng.stats.images_per_sec, "ms_per_batch": ms,
              "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
              "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "block_weight_bytes_on_card": w_bytes,
              "logits_cosine_vs_fp32": cos, "top1_agreement_vs_fp32": agree, "top1_gated": False,
              "top1_vs_fp32": top1_report(logits, ref["tanh"]),
              "logits_cosine_vs_plain_versions": cos_p,
              "top1_agreement_vs_plain_versions": numerics.top1_agreement(logits, lp),
              "per_layer_equal_fraction_max_abs": per_layer, "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, "deit_tiny_block_w4a8")
        out["deit_block_w4a8"] = (counts, shapes)
        del eng

        # ---- ctx="deploy" at batch 64, both int4 runtimes ----
        lg = {}
        for rt, path in (("packed", "deit_deploy_w4a8"), ("int8", "deit_deploy_w4a8_int8")):
            e = Engine.from_store(tmp, ctx="deploy", int4_runtime=rt, batch=TOTALS_BATCH,
                                  device=dev)
            reset_counts()
            with torch.inference_mode():
                lg[rt] = e(x0[:TOTALS_BATCH]).float().cpu().numpy()
            c, sh = read_counts()
            expect_counts(c, path, 1, f"deit_tiny deploy, int4_runtime={rt}")
            if rt == "packed":
                out[path] = (c, sh)
            agree_d, cos_d = gate(lg[rt], ref["exact"][:TOTALS_BATCH],
                                  f"deit_tiny deploy {rt} vs fp32", DEIT_W4A8_FP32_COS, top1=False)
            lpd = plain_twin(e, x0[:TOTALS_BATCH], f"deit_tiny deploy {rt}")
            cos_pd = gate(lg[rt], lpd, f"deit_tiny deploy {rt} vs its plain versions",
                          DEIT_TWIN_COS, top1=False)[1]
            # the forward K10 (or K2) carries, timed at the main paths' batch
            ms = time_ms(lambda: e._fn(e.params, xt), iters=10)
            emit({"phase": f"deit_deploy_w4a8_{rt}", "model": "deit_tiny", "batch": TOTALS_BATCH,
                  "int4_runtime": rt, "launches": c, "logits_cosine_vs_fp32": cos_d,
                  "top1_agreement_vs_fp32": agree_d, "fp32_gelu": "exact", "top1_gated": False,
                  "top1_vs_fp32": top1_report(lg[rt], ref["exact"][:TOTALS_BATCH]),
                  "logits_cosine_vs_plain_versions": cos_pd,
                  "top1_agreement_vs_plain_versions": numerics.top1_agreement(lg[rt], lpd),
                  "timed_batch": BATCH, "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
                  "card": card})
            if rt == "packed":
                profile_forward(e, xt, "deit_tiny_deploy_w4a8_packed")
            del e
        # the same int32 sums and epilogue on K10 and K2, and K6 is
        # deterministic: the two runtimes give the same logits bit for bit
        diff = float(np.abs(lg["packed"] - lg["int8"]).max())
        if diff != 0.0:
            raise AssertionError(f"deit_tiny deploy: packed vs int8 runtime logits differ by {diff}")

        # ---- ctx="block" with int4_runtime="int8": the W8 block path ----
        e = Engine.from_store(tmp, ctx="block", int4_runtime="int8", batch=TOTALS_BATCH,
                              device=dev)
        if e.name != "deit_tiny_block":
            raise AssertionError(f"deit_tiny block, int4_runtime=int8: engine {e.name}")
        reset_counts()
        with torch.inference_mode():
            lg8 = e(x0[:TOTALS_BATCH]).float().cpu().numpy()
        c = read_counts()[0]
        expect_counts(c, "deit_block_w4a8_int8", 1, "deit_tiny block, int4_runtime=int8")
        agree_b, cos_b = gate(lg8, ref["tanh"][:TOTALS_BATCH], "deit_tiny block int8 runtime vs fp32",
                              DEIT_W4A8_FP32_COS, top1=False)
        emit({"phase": "deit_block_w4a8_int8_runtime", "model": "deit_tiny",
              "batch": TOTALS_BATCH, "engine": e.name, "launches": c,
              "deploy_runtimes_logits_max_abs_diff": diff,
              "logits_cosine_vs_fp32": cos_b, "top1_agreement_vs_fp32": agree_b,
              "top1_gated": False})
        del e
    torch.cuda.empty_cache()
    return out


def deit_w4a16_paths(dev, card, d, images):
    """DeiT-Tiny W4A16: the same weights quantized INT4_WEIGHT_ONLY_PER_OC (no
    calibration: weight-only), stored and served by Engine.from_store(
    ctx="block") (the reference's deit_tiny_block_w4: K11, K6, K12 per layer,
    bf16 between layers; timed, batch 256); then INT4_WEIGHT_ONLY_G128 served
    by ctx="deploy" at batch 64 (K13 for the 13 group-wise sites, K6 for
    attention). Returns {"deit_block_w4": (counts, shapes),
    "deit_deploy_g128": (counts, shapes)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.vit import flatten_vit, vit_extras
    from dlq_tpu_torch.ops.matmul_int4 import PackedInt4G
    from dlq_tpu_torch.quant.qconfig import INT4_WEIGHT_ONLY_G128, INT4_WEIGHT_ONLY_PER_OC
    from dlq_tpu_torch.quant.store import save_quantized

    cfg, params, x0, xt, ref, meta = (d[k] for k in ("cfg", "params", "x0", "xt", "ref", "meta"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, qcfg in (("per_oc", INT4_WEIGHT_ONLY_PER_OC), ("g128", INT4_WEIGHT_ONLY_G128)):
            eng_q = Engine.quantized(d["qf"], flatten_vit(params), cfg, qcfg, batch=BATCH,
                                     device=dev)
            save_quantized(f"{tmp}/{name}", "deit_tiny", eng_q.qflat, None, qcfg,
                           extras=vit_extras(params), meta=meta)
            del eng_q
        eng = Engine.from_store(f"{tmp}/per_oc", ctx="block", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0
        w_bytes = {k: sum(b[k].numel() * b[k].element_size() for b in eng.params["blocks"])
                   for k in ("wqkv", "wproj", "wfc1", "wfc2")}
        if eng.name != "deit_tiny_block_w4" or \
                any(b["wqkv"].dtype != torch.uint8 for b in eng.params["blocks"]):
            raise AssertionError(f"deit_tiny W4A16 block: engine {eng.name}, not 4-bit weights")

        # ---- the W4A16 block main path ----
        preds, counts, shapes = drive(eng, images, "deit_block_w4", "deit_tiny block_w4")
        with torch.inference_mode():
            logits = eng(x0).float().cpu().numpy()
        if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
            raise AssertionError("deit_tiny block_w4: classify and the forward disagree")
        # the reference's own weight-only error on these random weights sets
        # the fp32 gate (tools/deit_reference_error.py; PERF.md, Findings)
        agree, cos = gate(logits, ref["tanh"], "deit_tiny block_w4 vs fp32", DEIT_W4A16_FP32_COS,
                          top1=False)
        lp = plain_twin(eng, x0, "deit_tiny block_w4")
        cos_p = gate(logits, lp, "deit_tiny block_w4 vs its plain versions", DEIT_TWIN_COS,
                     top1=False)[1]
        per_layer = layer_contract(eng.params, xt, cfg)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        emit({"phase": "main_path_deit_block_w4", "model": "deit_tiny", "size": 224,
              "batch": BATCH, "batches": NB, "scheme": "INT4_WEIGHT_ONLY_PER_OC",
              "engine": eng.name, "img_per_s_classify": eng.stats.images_per_sec,
              "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
              "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "block_weight_bytes_on_card": w_bytes,
              "logits_cosine_vs_fp32": cos, "top1_agreement_vs_fp32": agree, "top1_gated": False,
              "top1_vs_fp32": top1_report(logits, ref["tanh"]),
              "logits_cosine_vs_plain_versions": cos_p,
              "top1_agreement_vs_plain_versions": numerics.top1_agreement(logits, lp),
              "per_layer_equal_fraction_max_abs": per_layer, "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, "deit_tiny_block_w4")
        out["deit_block_w4"] = (counts, shapes)
        del eng

        # ---- ctx="deploy" on the G128 store, batch 64 ----
        e = Engine.from_store(f"{tmp}/g128", ctx="deploy", batch=TOTALS_BATCH, device=dev)
        g_sites = sorted(k for k, p in e.params.packed.items() if isinstance(p, PackedInt4G))
        if len(g_sites) != 13:
            raise AssertionError(f"deit_tiny G128 deploy: group-wise int4 sites {g_sites}")
        reset_counts()
        with torch.inference_mode():
            lg = e(x0[:TOTALS_BATCH]).float().cpu().numpy()
        c, sh = read_counts()
        expect_counts(c, "deit_deploy_g128", 1, "deit_tiny deploy G128")
        out["deit_deploy_g128"] = (c, sh)
        agree_d, cos_d = gate(lg, ref["exact"][:TOTALS_BATCH], "deit_tiny deploy G128 vs fp32",
                              DEIT_G128_FP32_COS, top1=False)
        lpd = plain_twin(e, x0[:TOTALS_BATCH], "deit_tiny deploy G128")
        cos_pd = gate(lg, lpd, "deit_tiny deploy G128 vs its plain versions", DEIT_TWIN_COS,
                      top1=False)[1]
        # the forward K13 carries, timed at the main paths' batch
        ms = time_ms(lambda: e._fn(e.params, xt), iters=10)
        emit({"phase": "deit_deploy_g128", "model": "deit_tiny", "batch": TOTALS_BATCH,
              "scheme": "INT4_WEIGHT_ONLY_G128", "group_wise_int4_sites": len(g_sites),
              "launches": c, "logits_cosine_vs_fp32": cos_d, "top1_agreement_vs_fp32": agree_d,
              "fp32_gelu": "exact", "top1_gated": False,
              "top1_vs_fp32": top1_report(lg, ref["exact"][:TOTALS_BATCH]),
              "logits_cosine_vs_plain_versions": cos_pd,
              "top1_agreement_vs_plain_versions": numerics.top1_agreement(lg, lpd),
              "timed_batch": BATCH, "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
              "card": card})
        profile_forward(e, xt, "deit_tiny_deploy_g128")
        del e
    torch.cuda.empty_cache()
    return out


def deit_bf16_paths(dev, card, d, act_scales, images):
    """DeiT-Tiny bf16 and the fused LayerNorms on the same fp32 weights:
    vit_forward_blockfused on pack_vit_blocks (K14, K6, K15 per layer, bf16
    between layers) through Engine.fp32 and classify at batch 256, loose
    pads (the reference's default) then tight, each timed and profiled; the
    fp32 forward with fused_ln=True, attn_impl="fused" at batch 64; the W8A8
    deploy forward with fused_ln=True at batch 64, on the W8A8 store's act
    scales (the same quantized model as the unfused deploy forward). Returns
    {path: (counts, shapes)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.vit import flatten_vit, make_qforward, vit_extras, vit_forward
    from dlq_tpu_torch.ops.vit_block import pack_vit_blocks, vit_forward_blockfused, vit_pads
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL

    cfg, params, x0, xt, ref = (d[k] for k in ("cfg", "params", "x0", "xt", "ref"))
    out, logits = {}, {}
    for tight in (False, True):
        tag = "tight" if tight else "loose"
        path = f"deit_bf16_{tag}"
        t0 = time.perf_counter()
        packed = pack_vit_blocks(params, cfg, tight=tight)
        eng = Engine.fp32(functools.partial(vit_forward_blockfused, tight=tight), packed, cfg,
                          batch=BATCH, device=dev, name=f"deit_tiny_bf16_{tag}")
        setup_s = time.perf_counter() - t0
        if any(b["wqkv"].dtype != torch.bfloat16 for b in eng.params["blocks"]):
            raise AssertionError(f"deit_tiny bf16 {tag}: block weights not bf16")
        preds, counts, shapes = drive(eng, images, path, f"deit_tiny bf16 {tag}")
        with torch.inference_mode():
            lg = logits[tag] = eng(x0).float().cpu().numpy()
        if not np.array_equal(preds[:BATCH], lg.argmax(-1)):
            raise AssertionError(f"deit_tiny bf16 {tag}: classify and the forward disagree")
        # the reference's own bf16 forward on these weights sets the fp32 gate
        # (tools/deit_reference_error.py; PERF.md, Findings)
        agree, cos = gate(lg, ref["tanh"], f"deit_tiny bf16 {tag} vs fp32", DEIT_BF16_FP32_COS,
                          top1=False)
        lp = plain_twin(eng, x0, f"deit_tiny bf16 {tag}")
        cos_p = gate(lg, lp, f"deit_tiny bf16 {tag} vs its plain versions", DEIT_BF16_TWIN_COS,
                     top1=False)[1]
        per_layer = layer_contract(eng.params, xt, cfg, tight=tight)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        emit({"phase": f"main_path_deit_bf16_{tag}", "model": "deit_tiny", "size": 224,
              "batch": BATCH, "batches": NB, "pads": "/".join(map(str, vit_pads(cfg, tight))),
              "engine": eng.name, "img_per_s_classify": eng.stats.images_per_sec,
              "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
              "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "logits_cosine_vs_fp32": cos, "top1_agreement_vs_fp32": agree, "fp32_gelu": "tanh",
              "top1_gated": False, "top1_vs_fp32": top1_report(lg, ref["tanh"]),
              "logits_cosine_vs_plain_versions": cos_p,
              "top1_agreement_vs_plain_versions": numerics.top1_agreement(lg, lp),
              "per_layer_equal_fraction_max_abs": per_layer, "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, f"deit_tiny_bf16_{tag}")
        out[path] = (counts, shapes)
        del eng, packed
    agree_t, cos_t = gate(logits["tight"], logits["loose"], "deit_tiny bf16 tight vs loose pads",
                          DEIT_BF16_TWIN_COS)
    emit({"phase": "deit_bf16_tight_vs_loose", "logits_cosine": cos_t, "top1_agreement": agree_t,
          "logits_max_abs_diff": float(np.abs(logits["tight"] - logits["loose"]).max())})

    # ---- the fp32 forward with fused_ln, batch 64 ----
    xb = xt[:TOTALS_BATCH]
    cfg_ln = dataclasses.replace(cfg, fused_ln=True, attn_impl="fused")
    e = Engine.fp32(vit_forward, params, cfg_ln, batch=TOTALS_BATCH, device=dev,
                    name="deit_tiny_fused_ln")
    reset_counts()
    lg = e(x0[:TOTALS_BATCH])
    c, sh = read_counts()
    expect_counts(c, "deit_fused_ln", 1, "deit_tiny fp32 fused_ln")
    out["deit_fused_ln"] = (c, sh)
    del e
    # the reference's gate (tests/test_pallas_layernorm.py:39-50): logits and
    # every tap of the fused forward against the unfused one on the same batch
    with torch.inference_mode():
        unfused, ut = vit_forward(params, xb, cfg, taps=True)
        _, ft = vit_forward(params, xb, cfg_ln, taps=True)
    taps_err = {k: float((ft[k] - ut[k]).abs().max()) for k in ut}
    err = float((lg - unfused).abs().max())
    if err >= FUSED_LN_MAX_ABS or max(taps_err.values()) >= FUSED_LN_MAX_ABS:
        raise AssertionError(f"deit_tiny fp32 fused_ln vs unfused: logits max_abs {err}, "
                             f"taps {taps_err} (need < {FUSED_LN_MAX_ABS})")
    emit({"phase": "deit_fused_ln_fp32", "model": "deit_tiny", "batch": TOTALS_BATCH,
          "launches": c, "logits_max_abs_vs_unfused": err, "taps_max_abs_vs_unfused": taps_err,
          "logits_cosine_vs_unfused": numerics.diff(lg.cpu(), unfused.cpu()).cosine})

    # ---- the W8A8 deploy forward with fused_ln, batch 64 ----
    lgq = {}
    for fused in (False, True):
        qf = make_qforward(vit_extras(params), cfg.depth, cfg.heads, cfg.patch, cfg.dim,
                           attn_impl="fused", fused_ln=fused)
        e = Engine.quantized(qf, flatten_vit(params), cfg, INT8_PER_CHANNEL, act_scales=act_scales,
                             batch=TOTALS_BATCH, device=dev)
        reset_counts()
        with torch.inference_mode():
            lgq[fused] = e(x0[:TOTALS_BATCH]).float().cpu().numpy()
        c, sh = read_counts()
        if fused:
            expect_counts(c, "deit_deploy_fused_ln", 1, "deit_tiny deploy fused_ln")
            out["deit_deploy_fused_ln"] = (c, sh)
            lpd = plain_twin(e, x0[:TOTALS_BATCH], "deit_tiny deploy fused_ln")
        del e
    agree_u, cos_u = gate(lgq[True], lgq[False], "deit_tiny deploy fused_ln vs unfused",
                          DEIT_FUSED_LN_COS, top1=False)
    agree_f, cos_f = gate(lgq[True], ref["exact"][:TOTALS_BATCH],
                          "deit_tiny deploy fused_ln vs fp32", DEIT_FP32_COS, top1=False)
    cos_pd = gate(lgq[True], lpd, "deit_tiny deploy fused_ln vs its plain versions",
                  DEIT_TWIN_COS, top1=False)[1]
    emit({"phase": "deit_deploy_fused_ln", "model": "deit_tiny", "batch": TOTALS_BATCH,
          "launches": out["deit_deploy_fused_ln"][0],
          "logits_cosine_vs_unfused_deploy": cos_u, "top1_agreement_vs_unfused_deploy": agree_u,
          "logits_cosine_vs_fp32": cos_f, "top1_agreement_vs_fp32": agree_f, "fp32_gelu": "exact",
          "top1_gated": False, "logits_cosine_vs_plain_versions": cos_pd})
    torch.cuda.empty_cache()
    return out


def layer_contract(packed, xt, cfg, tight=True, attn=None):
    """Each layer of a block forward, its three kernels against the plain
    versions on the same input: the stream the kernel forward itself
    reaches that layer with. W8A8 chunks (``_chunks``: K5 -> K6 -> K7, fp32
    inside a chunk), W4A8 layers (``blocks``: K8 -> K6 -> K9, bf16 between
    layers), W4A16 layers (K11 -> K6 -> K12, bf16 between layers) or bf16
    layers (K14 -> K6 -> K15, bf16 between layers, at either pads). Returns
    [(fraction of valid outputs equal, largest difference)] per layer;
    raises outside LAYER_TOL. ``attn``: the attention wrapper and its plain
    version (default K6's; K18's in-kernel form for the attn_int8 path)."""
    from dlq_tpu_torch.ops import attention, vit_block as vb

    n, d = cfg.seq_len, cfg.dim
    chunks = packed["_chunks"] if "_chunks" in packed else [[b] for b in packed["blocks"]]
    stacked = functools.partial(vb.vit_block_post_plain, multi=True)   # z1 + fma(acc, s, b)
    kinds = {  # (pre, post, plain pre, plain post), post with its FC2 association bound
        "w8": (vb.vit_block_pre_w8, functools.partial(vb.vit_block_post_w8, multi=True),
               vb.vit_block_pre_plain, stacked),
        "w4a8": (vb.vit_block_pre_w4a8, vb.vit_block_post_w4a8, vb.vit_block_pre_plain, stacked),
        "w4": (vb.vit_block_pre_w4, vb.vit_block_post_w4, vb.vit_block_pre_w4_plain,
               vb.vit_block_post_w4_plain),
        "bf16": (vb.vit_block_pre_bf16, vb.vit_block_post_bf16, vb.vit_block_pre_bf16_plain,
                 vb.vit_block_post_bf16_plain)}
    out = []
    with torch.inference_mode():
        y = vb._token_stream(packed, xt, cfg, tight)
        for chunk in chunks:
            for l, w in enumerate(chunk):
                kind = ("bf16" if w["wqkv"].dtype == torch.bfloat16 else
                        "w4" if "inv_act" not in w else
                        "w4a8" if w["wqkv"].dtype == torch.uint8 else "w8")
                pre, post, pre_p, post_p = kinds[kind]
                # the stream is bf16 between chunks, fp32 inside one
                odt = torch.bfloat16 if l == len(chunk) - 1 else torch.float32
                x = y

                def layer(pre, mh, post):
                    qkv = pre(x, w, d)
                    dp = qkv.shape[-1] // 3
                    a = mh(qkv[..., :d], qkv[..., dp: dp + d], qkv[..., 2 * dp: 2 * dp + d],
                           cfg.heads, n, out_lanes=dp)
                    return post(x, a, w, d, True, odt)

                mh, mh_p = attn or (attention.mhsa, attention.mhsa_plain)
                y = layer(pre, mh, post)
                ref = layer(pre_p, mh_p, post_p)
                diff = (y[:, :n, :d].float() - ref[:, :n, :d].float()).abs()
                out.append((float((diff == 0).float().mean()), float(diff.max())))
    if min(f for f, _ in out) < LAYER_TOL[0] or max(e for _, e in out) > LAYER_TOL[1]:
        raise AssertionError(f"deit_tiny block forward: per-layer kernels vs plain versions {out}")
    return out


def plain_twin(eng, x, what):
    """The engine's forward on ``x`` with every kernel call routed to its
    plain version (no kernel may launch inside it); fp32 logits."""
    reset_counts()
    with plain_kernels(), torch.inference_mode():
        lp = eng._fn(eng.params, torch.from_numpy(x).to(eng.device)).float().cpu().numpy()
    if any(read_counts()[0].values()):
        raise AssertionError(f"{what}: a kernel launched inside the plain run {read_counts()[0]}")
    return lp


def profile_forward(eng, xt, what, forwards=3):
    """Where one forward's device time goes: torch.profiler (CUPTI) over a
    few back-to-back forwards; device kernel time by kernel name, and the
    share of the wall window in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(forwards):
                eng._fn(eng.params, xt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    kern.sort(key=lambda e: -e.self_device_time_total)
    emit({"phase": f"profile_{what}", "forwards": forwards,
          "wall_ms_per_forward": wall_us / forwards / 1e3,
          "device_ms_per_forward": dev_us / forwards / 1e3 if dev_us else "not measured",
          "device_idle_share": 1.0 - dev_us / wall_us if dev_us else "not measured",
          "top_kernels": [{"name": e.key[:160], "ms_per_forward": e.self_device_time_total / forwards / 1e3,
                           "share_of_device": e.self_device_time_total / dev_us if dev_us else None,
                           "launches_per_forward": e.count / forwards} for e in kern[:16]]})


def _taps(eng, x, cfg, qf):
    with torch.inference_mode():
        logits, taps = qf(eng.params, torch.from_numpy(x).to(eng.device), cfg, taps=True)
    torch.cuda.synchronize()
    return (logits.float().cpu().numpy(),
            {k: v.float().cpu().numpy() for k, v in taps.items()})


# ---------------------------------------------------------------------------
# phase 11: the probes (K19-K22)
# ---------------------------------------------------------------------------

def probe_path():
    """The probe entry point as a user runs it: each module's results() (its
    main() without the exit status) on the card, every count set to 0 just
    before and read just after. Each pattern runs once and is held against
    the reference's numpy expectation with the reference's check and against
    its plain version by its own limit (_probe.held: identical where the
    pattern is integer, a copy or an exact bf16 scaling; rel 1e-4 of
    max|plain| for an fp32 output; one bf16 step of max|plain| on at most 1%
    of a bf16 output). Raises on any FAIL, on a pattern launched other than
    once, or on any other kernel launched. Then, outside the counted run, the
    kernel, its plain version and the one PyTorch call that computes the same
    function (where there is one) timed as device time on a spinning card;
    the bound counts the input (or the window of it the pattern reads) once
    and the output once, and the tensor-core products the data needs at the
    bf16 or int8 peak. Returns (rows, {probe: (launches, launches per
    pattern)})."""
    from dlq_tpu_torch.tools import _probe

    mods = _probe_modules()
    reset_counts()
    results = {name: mod.results() for name, mod in mods.items()}
    counts = {name: (getattr(mod, name).launches, dict(getattr(mod, name).by_shape))
              for name, mod in mods.items()}
    others = read_counts()[0]
    fails = {name: _probe.fails(rs) for name, rs in results.items()}
    if any(fails.values()):
        bad = [f"{name} {r.key} ({r.spec.name}): against the plain version {r.vs_plain}, "
               f"against the expectation {r.vs_expect}"
               for name, rs in results.items() for r in rs if not r.ok]
        raise AssertionError(f"probes: FAILs per probe {fails}: {bad}")
    for name, mod in mods.items():
        want = {key: 1 for key in mod.SPEC}
        if counts[name][1] != want:
            raise AssertionError(f"{name}: launches per pattern {counts[name][1]}, expected {want}")
    if any(others.values()):
        raise AssertionError(f"probes launched model kernels: {others}")
    emit({"phase": "probes", "fails": fails,
          "launches": {name: c[0] for name, c in counts.items()}})
    rows = []
    for name, mod in mods.items():
        fn = getattr(mod, name)
        for r in results[name]:
            key, spec, xs = r.key, r.spec, r.xs
            lib = mod.LIBRARY.get(key)
            peak = PEAK_BF16 if spec.peak == "bf16" else PEAK_INT8_OPS
            b_ms, b_by = bound(spec.flops, _probe.nbytes(spec, xs), peak)
            row = {"kernel": name, "pattern": key, "name": spec.name, "exact": spec.exact,
                   "max_abs_err": r.err, "vs_plain": r.vs_plain, "vs_expect": r.vs_expect,
                   "ms": _probe.spun_ms(lambda: fn(key, *xs), 20, warmup=2, reps=3),
                   "plain_ms": _probe.spun_ms(lambda: mod.PLAIN[key](*xs), 3, warmup=2, reps=3),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": (_probe.spun_ms(lambda: lib(*xs), 20, warmup=2, reps=3)
                                  if lib is not None else None),
                   "library": spec.library}
            emit_row(row)
            rows.append(row)
    if len(rows) != PROBE_PATTERNS:
        raise AssertionError(f"probes: {len(rows)} patterns, expected {PROBE_PATTERNS}")
    del results
    return rows, counts


def probe_summary(rows, counts):
    """One entry per probe kernel (K19-K22): ``launches`` from the probe
    path's run; ``ms``, ``plain_ms`` and ``bound_ms`` summed over its
    patterns (one launch of each); no one PyTorch call computes a whole
    probe, so ``library_ms`` is null there and given per pattern."""
    out = []
    for name, (_, src, repl) in PROBES.items():
        rs = [r for r in rows if r["kernel"] == name]
        pats = [{k: r[k] for k in ("pattern", "name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library")}
                | {"launches": counts[name][1].get(r["pattern"], 0)} for r in rs]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": counts[name][0], "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                    "bound_ms": sum(r["bound_ms"] for r in rs),
                    "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
                    "library_ms": None,
                    "library": "none for a whole probe; per pattern in patterns",
                    "main": "probes",
                    "per": "launches: one run of the module's main() on the card (each pattern "
                           "once); times: one launch of each pattern, summed",
                    "patterns": pats})
    return out


def summary(rows, paths):
    """One entry per kernel. The top-level ``launches`` and per-forward
    ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are those of the
    kernel's main path (``main``); ``paths`` gives them for every path in
    ``paths`` that launches the kernel. Per-forward figures weight each
    shape's time (at batch ``BATCH``) by its launches per forward, as counted
    per shape on that path's run of ``NB`` forwards, or, on a path checked by
    totals (run once at batch ``TOTALS_BATCH``), as its case table gives
    them."""
    meta = {
        "conv_int8": ("dlq_tpu_torch/csrc/conv_int8.cu",
                      "dlq_tpu/ops/pallas_conv.py:143 int8_conv3x3_s1 (+ :317 int8_conv3x3_s1_dp, "
                      ":472 int8_conv3x3_s1_dp2)", "r50_fused2"),
        "matmul_int8": ("dlq_tpu_torch/csrc/matmul_int8.cu",
                        "dlq_tpu/ops/pallas_matmul.py:61 int8_matmul", "r50_fused2"),
        "basic_block": ("dlq_tpu_torch/csrc/basic_block.cu",
                        "dlq_tpu/ops/pallas_block.py:155 basic_block_fused", "r18_block"),
        "bottleneck_block": ("dlq_tpu_torch/csrc/bottleneck_block.cu",
                             "dlq_tpu/ops/pallas_block.py:243 bottleneck_block_fused", "r50_block"),
        "vit_pre_w8": ("dlq_tpu_torch/csrc/vit_pre_w8.cu",
                       "dlq_tpu/ops/pallas_vit_block.py:981 vit_block_pre_w8 (and the first third "
                       "of each layer of :537 vit_multiblock_fused_w8, :632 vit_block_fused_w8)",
                       "deit_block"),
        "mhsa": ("dlq_tpu_torch/csrc/mhsa.cu",
                 "dlq_tpu/ops/pallas_attention.py:61 fused_mhsa (and the attention of "
                 "pallas_vit_block.py:537 / :632)", "deit_block"),
        "vit_post_w8": ("dlq_tpu_torch/csrc/vit_post_w8.cu",
                        "dlq_tpu/ops/pallas_vit_block.py:1017 vit_block_post_w8 (and the last "
                        "two thirds of each layer of :537 / :632)", "deit_block"),
        "vit_pre_w4a8": ("dlq_tpu_torch/csrc/vit_pre_w4a8.cu",
                         "dlq_tpu/ops/pallas_vit_block.py:1903 vit_block_fused_w4a8c (the first "
                         "third of each layer; also of :1550 vit_block_fused_w4a8 and :1753 "
                         "vit_multiblock_fused_w4a8)", "deit_block_w4a8"),
        "vit_post_w4a8": ("dlq_tpu_torch/csrc/vit_post_w4a8.cu",
                          "dlq_tpu/ops/pallas_vit_block.py:1903 vit_block_fused_w4a8c (the last "
                          "two thirds of each layer; also of :1550 and :1753)", "deit_block_w4a8"),
        "matmul_int4a8": ("dlq_tpu_torch/csrc/matmul_int4a8.cu",
                          "dlq_tpu/ops/pallas_matmul.py:208 int4a8_matmul (+ :318 "
                          "int4a8_matmul_cached)", "deit_deploy_w4a8"),
        "vit_pre_w4": ("dlq_tpu_torch/csrc/vit_pre_w4.cu",
                       "dlq_tpu/ops/pallas_vit_block.py:2045 vit_block_fused_w4c (the first "
                       "third of each layer; also of :1213 vit_block_fused_w4 and :1408 "
                       "vit_multiblock_fused_w4)", "deit_block_w4"),
        "vit_post_w4": ("dlq_tpu_torch/csrc/vit_post_w4.cu",
                        "dlq_tpu/ops/pallas_vit_block.py:2045 vit_block_fused_w4c (the last two "
                        "thirds of each layer; also of :1213 and :1408)", "deit_block_w4"),
        "matmul_int4": ("dlq_tpu_torch/csrc/matmul_int4.cu",
                        "dlq_tpu/ops/pallas_matmul.py:636 int4_matmul (+ :564 "
                        "int4_matmul_cached)", "deit_deploy_g128"),
        "vit_pre_bf16": ("dlq_tpu_torch/csrc/vit_pre_bf16.cu",
                         "dlq_tpu/ops/pallas_vit_block.py:371 vit_block_fused (the first third "
                         "of each layer, _block_kernel :299-303)", "deit_bf16_loose"),
        "vit_post_bf16": ("dlq_tpu_torch/csrc/vit_post_bf16.cu",
                          "dlq_tpu/ops/pallas_vit_block.py:371 vit_block_fused (the last two "
                          "thirds of each layer, _block_kernel :309-320)", "deit_bf16_loose"),
        "layernorm_fused": ("dlq_tpu_torch/csrc/layernorm.cu",
                            "dlq_tpu/ops/pallas_layernorm.py:71 layernorm_fused", "deit_fused_ln"),
        "residual_layernorm": ("dlq_tpu_torch/csrc/layernorm.cu",
                               "dlq_tpu/ops/pallas_layernorm.py:105 residual_layernorm",
                               "deit_fused_ln"),
        "mhsa_f32": ("dlq_tpu_torch/csrc/mhsa.cu",
                     "dlq_tpu/ops/pallas_attention.py:61 fused_mhsa (on fp32 q/k/v)",
                     "deit_fused_ln"),
        "mhsa_i8": ("dlq_tpu_torch/csrc/mhsa_i8.cu",
                    "dlq_tpu/ops/pallas_vit_block.py:560 vit_multiblock_fused_w8, its attn_int8 "
                    "arm (_mhsa_batched_i8_into_scratch :237); and the XLA function "
                    "dlq_tpu/ops/int8_attention.py:34 attention_int8_dynamic",
                    "deit_block_attn_int8"),
    }
    out = []
    for name, (src, repl, main) in meta.items():
        rs = [r for r in rows if r["kernel"] == name]
        per_path = []
        for path, (counts, shapes) in paths.items():
            if not counts[name]:
                continue
            if path in TOTALS_ONLY:
                forwards, batch = 1, TOTALS_BATCH
                w = [r["launches_per_forward"].get(path, 0) for r in rs]
            else:
                forwards, batch = NB, BATCH
                w = [shapes[name].get(r["key"], 0) / NB for r in rs]

            if not any(w):
                raise AssertionError(f"{name} on {path}: no timed shape is this path's")

            def tot(f):
                vals = [r.get(f) for r in rs]
                return None if any(v is None for v in vals) else sum(n * v for n, v in zip(w, vals))

            bounds = [(n * r["bound_ms"], r["bound_by"]) for n, r in zip(w, rs) if n]
            per_path.append({"path": path, "launches": counts[name], "forwards": forwards,
                             "batch": batch, "launches_per_forward": counts[name] / forwards,
                             "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                             "bound_ms": tot("bound_ms"),
                             "bound_by": max(bounds)[1],
                             "library_ms": tot("library_ms"),
                             **({"sdpa_bf16_ms": tot("sdpa_bf16_ms")}
                                if "sdpa_bf16_ms" in rs[0] else {})})
        m = next(p for p in per_path if p["path"] == main)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": m["launches"], "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                    **({"sdpa_bf16_ms": m["sdpa_bf16_ms"]} if "sdpa_bf16_ms" in m else {}),
                    "library": rs[0]["library"], "main": main,
                    "per": f"launches: the {main} run of {m['forwards']} forward(s) at batch "
                           f"{m['batch']}; times: one forward at batch {BATCH}",
                    "paths": per_path})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dlq_tpu_torch import _build

    _check_tables()
    dev = torch.device("cuda")
    card = card_line()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                            check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_v, "card": card, "device_name": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "build_s_per_source": secs})

    rows = (check_conv_kernels(dev) + check_matmul_kernel(dev) + check_block_kernel(dev)
            + check_bottleneck_kernel(dev) + check_vit_kernels(dev) + check_w4a8_kernels(dev)
            + check_int4a8_matmul(dev) + check_w4a16_kernels(dev) + check_int4_matmul(dev)
            + check_bf16_kernels(dev) + check_ln_kernels(dev)
            + check_int8_attention_kernels(dev))
    check_groupwise_routes(dev)
    torch.cuda.empty_cache()
    images = np.random.default_rng(SEED).normal(0, 1, (NB * BATCH, 224, 224, 3)).astype(np.float32)
    paths = {**main_paths(dev, card, 18, images), **main_paths(dev, card, 50, images)}
    deit = deit_model(dev, images)
    deit_w8, act_scales = deit_paths(dev, card, deit, images)
    paths.update(deit_w8)
    paths.update(deit_w4a8_paths(dev, card, deit, act_scales, images))
    paths.update(deit_w4a16_paths(dev, card, deit, images))
    paths.update(deit_bf16_paths(dev, card, deit, act_scales, images))
    del deit
    probe_rows, probe_counts = probe_path()
    kernels = summary(rows, paths) + probe_summary(probe_rows, probe_counts)
    print(card_line())
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
