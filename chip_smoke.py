"""Smoke run of the PyTorch/CUDA port on one GPU (ResNet-18, ResNet-50 and
DeiT-Tiny W8A8, DeiT-Tiny W4A8, DeiT-Tiny W4A16, DeiT-Tiny bf16 and the
fused LayerNorms, DeiT-Tiny W8A8 with int8 attention, MobileNetV2 1.0x W8A8,
224 px; ResNet-18 and MobileNetV2 with run-time activation scales, ResNet-18
in bf16, LeNet-5 and the MNIST MLP; the PTQ toolbox on ResNet-18 and
DeiT-Tiny; and the four lowering probes).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, one JSON line each:
  1. environment: torch, nvcc, the card's name and power limit, kernel build time;
  2. every kernel (K1 conv_int8, K2 matmul_int8, K3 basic_block, K4
     bottleneck_block) at every distinct shape and epilogue the main paths of
     both models give it at batch 256, held against its plain PyTorch version
     on the card (int8 and fp32 outputs bit-identical), with CUDA-event times
     of the kernel, the plain version, the library call where one exists
     (torch._int_mm for K2), and the least time the card could take (the bound);
     K1, K2, K3 and K4 (and torch._int_mm) also as device time on a
     spinning card, each row with the form its launch took, each K1 shape
     beside a cuDNN bf16 channels-last conv at the same shape (a reference
     point, not a yardstick: another function), each K4 shape beside the
     K2 -> K1 -> K2 composition of the same block (its yardstick), each K3
     shape equal to its first form on every output, timed in turns with it
     (first, Hopper, Hopper, first) and beside K1 -> K1 on the same two
     convs (its yardstick);
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
     profile; on ResNet-18 the same forward with K3 on its first form, its
     logits equal, timed in turns (Hopper, first, first, Hopper) and
     profiled;
  5. ctx="deploy" and ctx="pallas" at batch 64, gated as fused2; on
     ResNet-18 then the engine paths: Engine.from_store(ctx="dynamic") on
     the same store at batch 256 (DynamicDeployCtx: each site's scale from
     its input on the card; K1 20, K2 1 a forward), driven through classify,
     gated against the fp32 engine (R18_DYNAMIC_FP32_COS) and bit-identical
     to its plain-version twin, one forward under
     torch.cuda.set_sync_debug_mode("error") (no synchronizing call), timed
     in turns with ctx="deploy" on the same store at batch 256 (deploy,
     dynamic, dynamic, deploy), both profiled; then Engine.bf16 on the
     folded qforward(ObserveCtx) forward (as bench.py times it) and on the
     unfolded resnet_forward (no kernel of the port), each gated against
     fp32 (R18_BF16_FP32_COS) and timed;
  6. DeiT-Tiny (224 px, dim 192, depth 12, 3 heads, 1000 classes, seeded
     random weights): K5 vit_pre_w8, K6 mhsa and K7 vit_post_w8 at every
     shape of its block path and K2 at its deploy shapes, at batch 256,
     held against their plain versions (>= 0.999 of the outputs equal, the
     rest one rounding step apart: the kernels sum in another order), K5
     also bit-identical to its first form and timed as device time beside
     it, with the form its launch took, with
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
     on the materialized int8 weights as the yardstick, K8 and K9 also as
     device time, both also bit-identical to their first forms and timed
     beside them, with the form their launch took; then the store
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
     yardstick, K11 and K12 also against their first forms (W4A16_TOL) and
     timed as device time beside them, with the form their launch took;
     then 4,000 launches each of K1-K5 and K7-K15 (the kernels whose
     producer gives registers to its consumers by setmaxnreg) at a
     main-path shape, K5, K7 and K14 also at their loose pads, every
     launch's output equal to the first's (counted on the device), each
     with its register split and ptxas report; then digests of K5's and
     K11's outputs over their forms on seeded inputs, equal to the digests
     of the sources before K8 and K14 shared their Hopper bodies
     (tools/pre_digest.py); then an INT4_WEIGHT_ONLY_PER_OC store through
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
     F.layer_norm and scaled_dot_product_attention as yardsticks, K14 and
     K15 also against their first forms (BF16_TOL), K16 and mhsa_f32 equal
     to their first forms on every output, each timed as device time beside
     its first form (K16 in turns), with the form its launch took; the
     ptxas reports of mhsa_f32's
     and K18's libraries; then
     vit_forward_blockfused (pack_vit_blocks; K14, K6, K15 12 launches each
     per forward) through Engine.fp32 and classify at batch 256 with loose
     and tight pads, gated against the fp32 forward (DEIT_BF16_FP32_COS: the
     reference's own bf16 error), its plain-version twin and per layer, the
     two pads against each other, and profiled; the fp32 forward with
     fused_ln=True, attn_impl="fused" at batch 64 (K16 1, K17 24, mhsa_f32 12
     per forward) against the unfused fp32 forward (max_abs < 1e-5), then
     timed at batch 256 in turns with the same forward on mhsa_f32's first
     form, each profiled; and the
     W8A8 deploy forward with fused_ln=True at batch 64 (K2 50, K6 12, K16 1,
     K17 24) against the unfused deploy forward (DEIT_FUSED_LN_COS) and fp32;
 10. DeiT-Tiny W8A8 with int8 attention: K18 mhsa_i8 in its in-kernel form
     on the tight block stream and its zero-pad form on the split path's
     loose stream and on the deploy path's qkv dense (bf16, and fp32), at
     batch 256, against its plain version (>= 0.99 of the outputs equal,
     the rest within 2 av / 127) and equal to its first form on every
     output, timed as device time beside its first form, with the form its
     launch took, and bf16 SDPA as the yardstick (no PyTorch call computes
     int8 attention); then, inside phase 6 on its
     W8A8 store, vit_forward_multiblock_w8(attn_int8=True) (tight pads, 6
     layers per chunk; K5, K18, K7 12 launches each per forward, K6 none)
     through Engine and classify at batch 256, gated against the fp32
     forward (DEIT_ATTN_INT8_FP32_COS: the reference's own int8-attention
     error), its plain-version twin and per layer, timed in turns with the
     bf16-attention block engine and with itself on K18's first form, and
     profiled (on the first form too); at batch 64 the
     split-attention forward (loose pads) with attn="int8" (K18) and
     "bf16" (K6; bit-identical to vit_forward_blockfused_w8, and both
     forwards again 200 times each, every run equal to the first), and
     make_qforward(attn_impl="xla_int8") under DeployCtx (K2 50, K18 12);
 10b. MobileNetV2 1.0x (224 px, 1000 classes, seed-0 weights): K23
     depthwise_int8 at its ten depthwise shapes at batch 256 with both
     epilogues (fp32 out, as under deploy; int8 out with relu6, as under
     fused2), bit-identical to its plain version, timed beside the plain
     version, the bound and the fp32 grouped conv (F.conv2d(groups=C), TF32
     off: the same exact sums), also as device time on a spinning card; odd
     shapes (C = 40, odd H and W, stride 2 from an odd H) bit-identical and a
     C = 12 refused; K1 and K2 with relu6 and int8 out at its stem, expand,
     project and head shapes, bit-identical (the mnv2_relu6_epilogues line;
     these two checks run with phase 2); then Engine.quantized (calibrated
     on 8 images), save_quantized and Engine.from_store(ctx="deploy") driven
     through classify (main_path_mnv2_deploy: K1 1, K2 35, K23 17 per
     forward, K23 per shape), gated against the fp32 forward
     (MNV2_DEPLOY_FP32_COS), bit-identical to its plain-version twin (every
     block's output, the pooled vector, the logits), timed, repeated 200
     times and profiled; then make_qforward_fused under FullFusedCtx on the
     same store (mnv2_fused2: the same launches, int8 out everywhere but the
     fc), gated against deploy (MNV2_FUSED2_DEPLOY_COS), every block's int8
     output and the logits bit-identical to its plain-version twin, timed,
     repeated 200 times and profiled; then Engine.from_store(ctx="dynamic")
     on the deploy store at batch 64 (mnv2_dynamic: K1 1, K2 35, K23 17 a
     forward, every K23 launch on its Hopper form), gated against fp32
     (MNV2_DYNAMIC_FP32_COS), bit-identical to its plain-version twin, one
     forward under set_sync_debug_mode("error");
 10c. LeNet-5 and the MLP (seed-0 weights from the registry's builders,
     INT8_PER_CHANNEL stores by save_quantized, 28 x 28 x 1 images, the
     MLP's as 784-wide rows): Engine.from_store(ctx="deploy") and
     ctx="dynamic" at batch 256, driven through classify (LeNet-5: K1 2 on
     its first form, K2 3 (fc1 Hopper, fc2 and fc3 first); the MLP: K2 2
     on the Hopper form; per shape, with their case rows in phase 2), gated
     against the fp32 forward (MNIST_FP32_COS), bit-identical to the
     plain-version twin, the dynamic forwards under
     set_sync_debug_mode("error"), timed and profiled;
 10d. the PTQ toolbox (ptq; seeded weights, stores written by the port):
     (a) ResNet-18: the Hessians of 8 calibration images and GPTQ timed on
     the card, its GPTQ codes against the port's on the CPU (at most
     PTQ_GPTQ_CODE_SHARE differ, each site's GPTQ objective within
     PTQ_GPTQ_OBJECTIVE_REL), round-to-nearest, GPTQ and GPTQ + bias
     correction stores by ptq_auto(smooth="off"), each served by
     from_store under deploy (K1 20, K2 1) and fused2 (K1 19, K2 1) at batch
     256, gated against fp32 (PTQ_R18_FP32_COS); (d) auto_mixed_qconfig over
     those Hessians at INT4A8 with a budget halfway between all-int4 and
     all-int8, served under deploy (K1 20, K2 or K10 for the fc), gated
     against fp32 (PTQ_MIXED_FP32_COS); (c) three make_qat_step steps at
     batch 32, INT4A8, each timed by CUDA events, loss finite, every site
     moved, QATCtx against DeployCtx on the trained weights (K1 20, K10 1)
     at cosine > 0.999; (f) quant_error_report of fp32 against GPTQ taps,
     logged by the port's RunLogger and read back; (b) DeiT-Tiny ptq_auto
     (alpha searched, LN-foldable sites) on two calibration batches, folded
     into the LN affines, saved and served by from_store(ctx="block") (K5,
     K6, K7 12 each) against the sitewise SmoothDeployCtx forward at batch
     64 (K2 50, K6's fp32 form 12) and fp32, and the same smoothed weights
     at INT4A8 through pack_vit_blocks_w4a8(smooth=) (K8, K6, K9) against
     their sitewise forward (K10 50); (e) uint8 images through ResNet-18
     fused2 (the folded stem) and DeiT's block engine against the
     normalized fp32 images, and the two ResNet stems' codes. Every served
     forward is repeated SPLIT_REPEATS times;
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
     PyTorch call where one computes the same function; all 23 patterns
     run on a redesigned Hopper form (K19 6 and K20 D on attention_kernel,
     K19 3 and K20 A on nt_dot_hopper_kernel, K20 B on nn_dot_hopper_kernel,
     K21 D on double_conv_cluster_kernel, a cluster of 8 blocks, K22 E on
     int_dot_hopper_kernel, K22 J on cols_kernel, K22 K on maxpool_kernel,
     K21 O on requant_kernel, K19 5 on tanh_kernel, the 12 copy patterns
     on stage_kernel), must launch that form, and equal their first forms
     on every output (each module's FIRST_FORMS: launches by form 6 for
     probe_mosaic, 4 for probe_batched_dot, 6 for probe_block, 7 for
     probe_stem); each is timed in turns with its first form (first,
     Hopper, Hopper, first), beside launch_floor_ms, one empty kernel's
     device time under the same timing; each pattern with a library call
     is timed in ten alternating pairs with it (five rounds of kernel,
     library, library, kernel), with the pairs' median ratio and the
     pairs the kernel lost; then probe_exhaustive: K21 O's and K19 5's
     Hopper forms against their first forms and plain versions on every
     input value (O's 256 int8 values at four scales, 5's 65,536 bf16 bit
     patterns, NaN and +-inf included), the outputs that differ counted
     and gated at 0 against the first form, with both forms' ptxas
     registers and stack frames.
Each timed forward of ResNet-18/-50 (fused2, PallasBlockCtx), of
DeiT-Tiny's block paths (W8A8 with and without int8 attention, W4A8,
W4A16, bf16 at both pads), of MobileNetV2 (deploy, fused2) and of the
engine paths (ResNet-18 dynamic and deploy, both bf16 forwards; LeNet-5 and
the MLP, deploy and dynamic) runs SPLIT_REPEATS more times at batch 256, and
each DeiT-Tiny deploy forward (W8A8, with fused_ln and with xla_int8; W4A8
"packed" and "int8"; G128) at batch 64, every run's logits equal to the
first's (counted on the device; a race differs in some run). Each main path
is driven with every launch count set to 0 just before it and read just
after; on ResNet-18/-50 fused2 and PallasBlockCtx and on
DeiT-Tiny's deploy paths every K1 and K2 launch must have taken its Hopper
form, and on every path every K3, K4, K5, K8, K9, K11, K12, K14, K15, K16,
mhsa_f32 and K18 launch (the per-form counts are printed per path). Then
the card's name and power limit, the kernel summary line and, last,
{"ok": true, "device": {...}}. Any failed gate raises before those lines.
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
CUDNN_BF16 = ("reference point, not a yardstick: cuDNN conv in bf16, channels-last, bf16 out "
              "(another function: no int8 operands, no int32 sums, no epilogue)")
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
# MobileNetV2 1.0x (224 px, 1000 classes, seed-0 weights calibrated on 8
# images of seed MNV2_CALIB_SEED): the deploy logits vs the port's fp32
# engine, and the fused2 forward (make_qforward_fused under FullFusedCtx) vs
# deploy, just under the reference's own figures on these weights
# (tools/mnv2_reference_error.py, 16 images, CPU; PERF.md §2): its deploy
# forward at cosine 0.99887 of fp32, its FullFusedCtx forward at 0.99904 of
# deploy (0.99880 of fp32), top-1 1.0 (the random-weight logits pick one
# class for the whole batch, so top-1 is reported, not gated)
MNV2_CALIB_SEED = SEED + 2
MNV2_DEPLOY_FP32_COS = 0.998
MNV2_FUSED2_DEPLOY_COS = 0.998
# The engine paths (ResNet-18 ctx="dynamic" and Engine.bf16, LeNet-5 and the
# MLP under deploy and dynamic, MobileNetV2 ctx="dynamic"), gated against the
# port's fp32 forwards just under the reference's own errors on the same
# weights and inputs (scripts/engine_reference_error.py, CPU; PERF.md §2):
# ResNet-18 dynamic 0.99988 (16 images; the gate is bench.py:138-145's
# 0.999), its bf16 engine 0.999993 on the folded ObserveCtx forward and on
# resnet_forward; LeNet-5 deploy / dynamic 0.99980 / 0.99985, the MLP
# 0.99983 / 0.99989 (256 images); MobileNetV2 dynamic 0.99882 (16 images;
# the deploy path's 0.998). Top-1 is reported, not gated: the MNIST models'
# random logits sit at 0.98-0.99 of fp32 in the reference itself.
R18_DYNAMIC_FP32_COS = 0.999
R18_BF16_FP32_COS = 0.9999
MNIST_FP32_COS = 0.999
MNV2_DYNAMIC_FP32_COS = 0.998
MNV2_DYNAMIC_BATCH = 64
MNIST_SEED = SEED + 28        # the MNIST models' images (28 x 28 x 1; the MLP's as 784-wide rows)
MNIST_CALIB_SEED = SEED + 5   # their 8 calibration images
NO_INT_MM = "none at this shape: torch._int_mm needs K and N multiples of 8"
DW_FP32 = ("F.conv2d(groups=C) in fp32 with TF32 off on the same integer values, channels-last "
           "(the reference's depthwise='fp32' sums, exact here; no epilogue)")

KERNELS = ("conv_int8", "matmul_int8", "basic_block", "bottleneck_block", "vit_pre_w8", "mhsa",
           "vit_post_w8", "vit_pre_w4a8", "vit_post_w4a8", "matmul_int4a8", "vit_pre_w4",
           "vit_post_w4", "matmul_int4", "vit_pre_bf16", "vit_post_bf16", "layernorm_fused",
           "residual_layernorm", "mhsa_f32", "mhsa_i8", "depthwise_int8")


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
    # MobileNetV2 1.0x: the stem on K1, 16 expand + 17 project 1x1 convs, the
    # head and the fc on K2, 17 depthwise convs on K23
    "mnv2_deploy": _per(conv_int8=1, matmul_int8=35, depthwise_int8=17),
    "mnv2_fused2": _per(conv_int8=1, matmul_int8=35, depthwise_int8=17),
    # the engine paths: ResNet-18 under ctx="dynamic" (and "deploy" at batch
    # 256, its yardstick) as r18_deploy; its bf16 engines launch no kernel of
    # the port; LeNet-5's two 5x5 convs on K1 and three dense on K2, the
    # MLP's two dense on K2; MobileNetV2 dynamic as its deploy path
    "r18_dynamic": _per(conv_int8=20, matmul_int8=1),
    "r18_deploy_256": _per(conv_int8=20, matmul_int8=1),
    "r18_bf16": _per(),
    "r18_bf16_unfolded": _per(),
    "lenet_deploy": _per(conv_int8=2, matmul_int8=3),
    "lenet_dynamic": _per(conv_int8=2, matmul_int8=3),
    "mlp_deploy": _per(matmul_int8=2),
    "mlp_dynamic": _per(matmul_int8=2),
    "mnv2_dynamic": _per(conv_int8=1, matmul_int8=35, depthwise_int8=17),
}
# engine paths checked by totals and forms only (no per-shape case rows;
# not in the kernels line's per-path figures)
ENGINE_TOTALS = ("r18_dynamic", "r18_deploy_256", "r18_bf16", "r18_bf16_unfolded",
                 "mnv2_dynamic")
# the launches by form of K1 and K2 on the MNIST paths (form rules: K1's
# Hopper form needs C % 64 == 0 and a 1x1 or 3x3 kernel, K2's K % 16 == 0):
# LeNet-5's convs (C = 1, 6; 5x5) and its fc2 / fc3 (K = 120, 84) on the
# first forms, its fc1 (K = 400) and both MLP dense (K = 784, 256) on the
# Hopper form
MNIST_FORMS = {"lenet": {"conv_int8": {"first": 2}, "matmul_int8": {"hopper": 1, "first": 2}},
               "mlp": {"conv_int8": {}, "matmul_int8": {"hopper": 2}}}
# MobileNetV2's paths: K1 and K2 checked by totals, K23 by shape (its case table)
MNV2_PATHS = ("mnv2_deploy", "mnv2_fused2")
# paths run at batch 64 and checked by totals only (the shape tables are at
# batch 256; where a kernel's times are summed per forward on such a path,
# its case table's launches per forward weight them)
TOTALS_ONLY = ("r18_deploy", "r50_deploy", "deit_blockfused", "deit_deploy", "deit_deploy_w4a8",
               "deit_deploy_w4a8_int8", "deit_block_w4a8_int8", "deit_deploy_g128",
               "deit_fused_ln", "deit_deploy_fused_ln", "deit_split_int8", "deit_split_bf16",
               "deit_deploy_xla_int8")
TOTALS_BATCH = 64
SPLIT_REPEATS = 200   # runs of each forward held bit-identical to the first (a race shows)
# the DeiT deploy forwards repeated at batch 64 (K2 on W8A8, fused_ln,
# xla_int8 with K18, W4A8 "int8"; K10 on W4A8 "packed"; K13 on G128)
# the engine paths repeated at batch 256
ENGINE_REPEATS = ("r18_dynamic", "r18_deploy_256", "r18_bf16", "r18_bf16_unfolded",
                  "lenet_deploy", "lenet_dynamic", "mlp_deploy", "mlp_dynamic")
DEPLOY_REPEATS = ("deit_deploy", "deit_deploy_fused_ln", "deit_deploy_xla_int8",
                  "deit_deploy_w4a8", "deit_deploy_w4a8_int8", "deit_deploy_g128")

# the ptq phase (the PTQ toolbox). Its gates sit just under the reference's
# own figures on the same weights, calibration sets and inputs
# (scripts/ptq_reference_error.py, CPU, 16 images; PERF.md §2):
# ResNet-18 INT8_PER_CHANNEL vs fp32 under deploy / fused2: round-to-nearest
# 0.99988 / 0.99988, GPTQ 0.99995 / 0.99994, GPTQ + bias correction
# 0.99995 / 0.99994
PTQ_R18_FP32_COS = {"rtn": 0.9998, "gptq": 0.9999, "gptq_bc": 0.9999}
# the card's GPTQ codes (Hessians summed by cuBLAS) against the port's on
# the CPU: GPTQ is chaotic in its Hessian at the last bit (act order swaps
# near-equal diagonal entries, a flipped code carries its error along its
# column): on the CPU, H scaled entrywise by 1 + 1e-7 N(0, 1) moves 2.74% of
# ResNet-18's int8 codes (4.09% at a layer4 site) and 1e-6 moves 5.44%,
# while each site's GPTQ objective tr(dW^T H dW) moves by at most 0.31%
# (scripts/gptq_hessian_noise.py). So the codes are gated just above the
# 1e-6 share and the objective (on the CPU's Hessian) at 2%
PTQ_GPTQ_CODE_SHARE = 0.06
PTQ_GPTQ_OBJECTIVE_REL = 0.02
# the mixed store (INT4A8 with the sites auto_mixed_qconfig promotes to int8
# at a budget halfway between all-int4 and all-int8) vs fp32: the
# reference's own 0.99239
PTQ_MIXED_FP32_COS = 0.992
PTQ_QAT_BATCH = 32
PTQ_QAT_LR = 0.001            # a fine-tuning rate (momentum 0.9, EMA 0.99: the defaults)
PTQ_QAT_LABEL_SEED = SEED + 32
# QATCtx vs DeployCtx on the trained weights: tests/test_qat.py:96's gate
# (the reference's training step cannot differentiate the 224 px ResNet's
# maxpool, so it has no figure of its own here)
PTQ_QAT_PARITY_COS = 0.999
PTQ_DEIT_CALIB_SEEDS = (SEED + 26, SEED + 27)
PTQ_SITEWISE_BATCH = 64
# DeiT-Tiny after ptq_auto (alpha 0.25 chosen, 24 LN-foldable sites): the
# block forward vs fp32 (tanh) 0.99891 in the reference; its block forward
# vs its sitewise SmoothDeployCtx forward (tanh) 0.99819 at W8A8 and 0.99824
# at W4A8 (over 12 random-weight layers two int8 paths drift apart: the
# reference's tiny-model gate of 0.999, tests/test_vit_blockfused.py:142,
# does not hold at this depth in the reference itself); uint8 vs the
# normalized image through the block forward 0.99864
PTQ_DEIT_FP32_COS = 0.998
PTQ_DEIT_TWIN_COS = 0.9975
PTQ_DEIT_W4A8_TWIN_COS = 0.9975
PTQ_U8_SEED = SEED + 8
# ResNet-18 fused2 on uint8 vs the normalized image: the reference's own
# 0.99995, its stems' codes equal on 0.95096, one step apart at most
PTQ_U8_COS = 0.999            # tests/test_uint8_ingest.py:39, with top-1 1.0
PTQ_U8_STEM_EQUAL = 0.93      # tests/test_uint8_ingest.py:64, at most one step apart
PTQ_DEIT_U8_COS = 0.998
# launches per forward of the ptq phase's paths (the smoothed sitewise DeiT
# forwards run fp32 from layer 0's qkv on: a bf16 input times the fp32
# reciprocal of s is fp32, so attention takes K6's fp32 form)
PTQ_PER_FORWARD = {
    "r18_deploy": _per(conv_int8=20, matmul_int8=1),
    "r18_fused2": _per(conv_int8=19, matmul_int8=1),
    "qat_deploy": _per(conv_int8=20, matmul_int4a8=1),
    "deit_block": _per(vit_pre_w8=12, mhsa=12, vit_post_w8=12),
    "deit_sitewise": _per(matmul_int8=50, mhsa_f32=12),
    "deit_w4a8_block": _per(vit_pre_w4a8=12, mhsa=12, vit_post_w4a8=12),
    "deit_w4a8_sitewise": _per(matmul_int4a8=50, mhsa_f32=12),
}
PTQ_REPEATS = (*(f"ptq_r18_{n}_{c}" for n in ("rtn", "gptq", "gptq_bc")
                 for c in ("deploy", "fused2")),
               "ptq_mixed_deploy", "ptq_qat_deploy", "ptq_deit_block", "ptq_deit_sitewise",
               "ptq_deit_w4a8_block", "ptq_deit_w4a8_sitewise", "ptq_r18_u8_fused2",
               "ptq_deit_block_u8")


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
        # LeNet-5's 5x5/s1/p0 convs (an eighth entry: the padding), fp32 out
        # with relu: conv1 on the zero-padded 32^2 x 1 input, conv2 at 14^2 x 6
        (32, 1, 6, 5, 1, True, False, 0): {"lenet_deploy": 1, "lenet_dynamic": 1},
        (14, 6, 16, 5, 1, True, False, 0): {"lenet_deploy": 1, "lenet_dynamic": 1},
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
        # LeNet-5's fc1-fc3 and the MLP's fc1-fc2 (fp32 out)
        (1, 400, 120, True, False): {"lenet_deploy": 1, "lenet_dynamic": 1},
        (1, 120, 84, True, False): {"lenet_deploy": 1, "lenet_dynamic": 1},
        (1, 84, 10, False, False): {"lenet_deploy": 1, "lenet_dynamic": 1},
        (1, 784, 256, True, False): {"mlp_deploy": 1, "mlp_dynamic": 1},
        (1, 256, 10, False, False): {"mlp_deploy": 1, "mlp_dynamic": 1},
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


def depthwise_cases():
    """K23: (H, C, stride, activation, int8_out) -> launches per forward per
    path: every depthwise site of MobileNetV2 1.0x at 224 px (ten distinct
    shapes), fp32 out with no activation under deploy (its relu6 runs on the
    fp32 interchange), int8 out with relu6 under fused2."""
    from dlq_tpu_torch.models.mobilenetv2 import MobileNetV2Config, block_meta

    sites, h = {}, 112
    for m in block_meta(MobileNetV2Config()):
        sites[(h, m["hidden"], m["stride"])] = sites.get((h, m["hidden"], m["stride"]), 0) + 1
        h = (h - 1) // m["stride"] + 1
    out = {}
    for (h, c, s), n in sites.items():
        out[(h, c, s, False, False)] = {"mnv2_deploy": n}
        out[(h, c, s, "relu6", True)] = {"mnv2_fused2": n}
    return out


def _conv_case(case):
    """(H, C, OC, k, stride, relu, int8_out, pad): the padding is k // 2
    unless the case gives it as an eighth entry."""
    h, c, oc, k, s, relu, int8_out, *pad = case
    return h, c, oc, k, s, relu, int8_out, pad[0] if pad else k // 2


def _conv_key(case):
    h, c, oc, k, s, relu, int8_out, pad = _conv_case(case)
    return (BATCH, h, h, c, oc, k, k, s, pad, relu, int8_out)


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
        "mhsa_i8": (mhsa_i8_cases, lambda c: (BATCH, c[0], VIT_HEADS, VIT_HD, *c[1:])),
        "depthwise_int8": (depthwise_cases,
                           lambda c: (BATCH, c[0], c[0], c[1], 3, 3, c[2], 1, *c[3:]))}


def expected_by_shape(path: str, forwards: int):
    """Launches per kernel and shape key that the case tables give a main
    path over ``forwards`` forwards."""
    return {name: {key(case): per[path] * forwards for case, per in cases().items() if per.get(path)}
            for name, (cases, key) in KEYS.items()}


def _check_tables():
    """The case tables add up to the per-forward totals."""
    for path, totals in PER_FORWARD.items():
        if path in TOTALS_ONLY or path in ENGINE_TOTALS:
            continue
        got = {k: sum(v.values()) for k, v in expected_by_shape(path, 1).items()}
        if path in MNV2_PATHS:   # K1 and K2 by totals only
            got.update(conv_int8=totals["conv_int8"], matmul_int8=totals["matmul_int8"])
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
    import torch.nn.functional as F

    from dlq_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, out_hw, pack_conv_weight
    from dlq_tpu_torch.tools._probe import spun_ms

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    conv_int8.by_form.clear()
    for case, per in conv_cases().items():
        h, c, oc, k, s, relu, int8_out, pad = _conv_case(case)
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
        # the reference point of rows 6-8 (not a yardstick: another function)
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wc = pk.hwio().permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

        def cudnn():
            return F.conv2d(xc, wc, stride=s, padding=pad)

        rows.append(_row(
            "conv_int8", _conv_key(case), f"{BATCH}x{h}x{h}x{c}->{oc} {k}x{k}/s{s}", got, ref,
            lambda: conv_int8(x, pk, s, pad, scale, bias, relu, osc),
            lambda: conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc),
            2.0 * BATCH * oh * ow * oc * k * k * c,
            x_bytes + k * k * c * oc + 8 * oc + got.numel() * got.element_size(), per,
            relu=relu, out="int8" if int8_out else "fp32", spun=True,
            form=conv_int8.by_form.most_common(1)[0][0] if conv_int8.by_form else None,
            cudnn_bf16_ms=time_ms(cudnn), cudnn_bf16_device_ms=spun_ms(cudnn, 20, warmup=2, reps=3),
            cudnn_bf16=CUDNN_BF16))
        conv_int8.by_form.clear()
        del x, got, ref, xc
    return rows


def check_matmul_kernel(dev):
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    matmul_int8.by_form.clear()
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
        int_mm = k % 8 == 0 and n % 8 == 0
        rows.append(_row(
            "matmul_int8", _mm_key(case), f"{m}x{k}@{k}x{n}", got, ref,
            lambda: matmul_int8(x, pk, scale, bias, relu, osc),
            lambda: matmul_int8_plain(x, pk, scale, bias, relu, osc),
            2.0 * m * n * k, m * k + k * n + 8 * n + got.numel() * got.element_size(), per,
            plain_iters=5, library=(lambda: torch._int_mm(x, wt)) if int_mm else None,
            no_library=NO_INT_MM, relu=relu, out="int8" if int8_out else "fp32", spun=True,
            form=matmul_int8.by_form.most_common(1)[0][0] if matmul_int8.by_form else None))
        matmul_int8.by_form.clear()
        del x, got, ref
    return rows


def check_block_kernel(dev):
    """K3 at ResNet-18's two packed shapes, bit-identical to its plain
    version and to its first form (the parent's kernel, unchanged), timed
    also as device time on a spinning card in turns with the first form
    (first, Hopper, Hopper, first), beside the yardstick: the same two convs
    on K1, conv1 (relu, int8 out) -> conv2 (int8 out), without the junction
    glue (the skip's requant, add and clip are K3's alone)."""
    from dlq_tpu_torch.ops.block_fused import basic_block_first, basic_block_fused, basic_block_plain
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, pack_conv_weight
    from dlq_tpu_torch.tools._probe import spun_ms

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

        def yardstick():
            hq = conv_int8(x, pack["w1"], 1, 1, s1, b1, True, 0.05)
            return conv_int8(hq, pack["w2"], 1, 1, s2, b2, False, 0.05)

        basic_block_fused.by_form.clear()
        got = basic_block_fused(x, pack)
        form = basic_block_fused.by_form.most_common(1)[0][0]
        first = basic_block_first(x, pack)
        if not torch.equal(got, first):
            raise AssertionError(f"basic_block {h}x{c}: the {form} form differs from the first "
                                 f"form at {int((got != first).sum())} outputs")
        turns = {"first_form": [], "hopper": []}
        for tag in ("first_form", "hopper", "hopper", "first_form"):
            fn = basic_block_first if tag == "first_form" else basic_block_fused
            turns[tag].append(spun_ms(lambda: fn(x, pack), 10, warmup=2, reps=3))
        rows.append(_row(
            "basic_block", (BATCH, h, h, c), f"{BATCH}x{h}x{h}x{c}", got, basic_block_plain(x, pack),
            lambda: basic_block_fused(x, pack), lambda: basic_block_plain(x, pack),
            2.0 * 2 * BATCH * h * h * c * 9 * c, 2 * x.numel() + 2 * 9 * c * c + 16 * c, per,
            relu=True, out="int8", spun=True, form=form, first_form_equal=True,
            first_form_device_ms=min(turns["first_form"]), device_ms_in_turns=turns,
            yardstick_device_ms=spun_ms(yardstick, 10, warmup=2, reps=3),
            yardstick="K1 conv1 (relu, int8) -> K1 conv2 (int8), the same two convs without "
                      "the junction"))
        basic_block_fused.by_form.clear()
        del x, got, first
    return rows


def check_bottleneck_kernel(dev):
    """K4 at ResNet-50's four identity-block shapes, bit-identical to its
    plain version, timed also as device time on a spinning card beside the
    yardstick: the fused2 route's composition of the same block, K2 (conv1,
    relu, int8 out) -> K1 (conv2) -> K2 (conv3, int8 out), without the
    junction glue (its skip add and clip are K4's alone)."""
    from dlq_tpu_torch.ops.block_fused import bottleneck_block_fused, bottleneck_block_plain
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, pack_conv_weight
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, pack_dense_weight
    from dlq_tpu_torch.tools._probe import spun_ms

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
        d1 = pack_dense_weight(pack["w1"].hwio()[0, 0].contiguous())
        d3 = pack_dense_weight(pack["w3"].hwio()[0, 0].contiguous())
        xm = x.view(-1, c4)

        def composition():
            h1 = matmul_int8(xm, d1, pack["s1"], pack["b1"], True, 0.05)
            h2 = conv_int8(h1.view(BATCH, h, h, cm), pack["w2"], 1, 1, pack["s2"], pack["b2"],
                           True, 0.05)
            return matmul_int8(h2.view(-1, cm), d3, pack["s3"], pack["b3"], False, 0.05)

        bottleneck_block_fused.by_form.clear()
        got = bottleneck_block_fused(x, pack)
        form = bottleneck_block_fused.by_form.most_common(1)[0][0]
        rows.append(_row(
            "bottleneck_block", (BATCH, h, h, c4, cm), f"{BATCH}x{h}x{h}x{c4} mid {cm}",
            got, bottleneck_block_plain(x, pack),
            lambda: bottleneck_block_fused(x, pack), lambda: bottleneck_block_plain(x, pack),
            2.0 * BATCH * h * h * w_bytes, 2 * x.numel() + w_bytes + 8 * (2 * cm + c4), per,
            relu=True, out="int8", spun=True, form=form,
            # 6 compositions a window (18 launches): their host enqueue fits the spin
            yardstick_device_ms=spun_ms(composition, 6, warmup=2, reps=3),
            yardstick="K2 conv1 (relu, int8) -> K1 conv2 -> K2 conv3 (int8), the fused2 "
                      "route's three launches without the junction"))
        bottleneck_block_fused.by_form.clear()
        del x, xm, got
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
        vit_block_pre_w8_first,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

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
        vit_block_pre_w8.by_form.clear()
        got = vit_block_pre_w8(y, bk, d)
        form = vit_block_pre_w8.by_form.most_common(1)[0][0]
        # the Hopper form against the first form, bit for bit (the same LN
        # order and codes, exact sums, the same epilogue)
        first = vit_block_pre_w8_first(y, bk, d)
        if not torch.equal(got, first):
            raise AssertionError(f"vit_pre_w8 {npad}/{dp} {case}: the {form} form differs from "
                                 f"the first form at {int((got != first).sum())} outputs")
        rows.append(_row(
            "vit_pre_w8", (BATCH, npad, dp, case), f"{BATCH}x{npad}x{dp} {case} -> qkv",
            got, vit_block_pre_plain(y, bk, d),
            lambda: vit_block_pre_w8(y, bk, d), lambda: vit_block_pre_plain(y, bk, d),
            2.0 * mr * d * 3 * d,
            mr * d * y.element_size() + 3 * d * d + 8 * 3 * d + 8 * d + mr * 3 * dp * 2, per,
            library=lambda: torch._int_mm(p["x1"], p["w"][0]), tol=VIT_TOL, residual=case,
            out="bf16", pads=f"{npad}/{dp}", spun=True, form=form, first_form_equal=True,
            first_form_device_ms=spun_ms(lambda: vit_block_pre_w8_first(y, bk, d), 20,
                                         warmup=2, reps=3)))
        vit_block_pre_w8.by_form.clear()
        del got, first
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
    int4 weights count K/2 bytes in the bound. Both also as device time on
    a spinning card (their own and the yardstick's); each row also carries
    its form, and its first form's device time and bit-identity to it."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_plain, vit_block_post_w4a8, vit_block_post_w4a8_first, vit_block_pre_plain,
        vit_block_pre_w4a8, vit_block_pre_w4a8_first,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

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
        vit_block_pre_w4a8.by_form.clear()
        got = vit_block_pre_w4a8(y, blk, dp)
        form = vit_block_pre_w4a8.by_form.most_common(1)[0][0]
        # the Hopper form against the first form, bit for bit (the same LN
        # order and codes, exact int32 sums, the same epilogue)
        first = vit_block_pre_w4a8_first(y, blk, dp)
        if not torch.equal(got, first):
            raise AssertionError(f"vit_pre_w4a8 {case}: the {form} form differs from the first "
                                 f"form at {int((got != first).sum())} outputs")
        rows.append(_row(
            "vit_pre_w4a8", (BATCH, VIT_NP, dp, case), f"{BATCH}x{VIT_NP}x{dp} {case} -> qkv, int4",
            got, vit_block_pre_plain(y, blk, dp),
            lambda: vit_block_pre_w4a8(y, blk, dp), lambda: vit_block_pre_plain(y, blk, dp),
            2.0 * m * dp * 3 * dp,
            y.numel() * y.element_size() + 3 * dp * dp // 2 + 8 * 3 * dp + 8 * dp + m * 3 * dp * 2,
            per, library=lambda: torch._int_mm(x1, wq), tol=VIT_TOL, residual=case, out="bf16",
            spun=True, form=form, first_form_equal=True,
            first_form_device_ms=spun_ms(lambda: vit_block_pre_w4a8_first(y, blk, dp), 20,
                                         warmup=2, reps=3)))
        vit_block_pre_w4a8.by_form.clear()
        del got, first
    qkv = vit_block_pre_plain(y32, blk, dp)
    a = mhsa(qkv[..., :dp], qkv[..., dp: 2 * dp], qkv[..., 2 * dp:], VIT_HEADS, VIT_N)
    for (din, dout), per in vit_post_w4a8_cases().items():
        y, odt = ys[din], getattr(torch, dout)

        def kern():
            return vit_block_post_w4a8(y, a, blk, dp, True, odt, True)

        def plain():
            return vit_block_post_plain(y, a, blk, dp, True, odt, True)

        def first():
            return vit_block_post_w4a8_first(y, a, blk, dp, True, odt, True)

        vit_block_post_w4a8.by_form.clear()
        got = kern()
        form = vit_block_post_w4a8.by_form.most_common(1)[0][0]
        # the Hopper form against the first form, bit for bit (exact int32
        # sums in the paired K order, the same LN2 order, codes and roundings)
        ref_first = first()
        if not torch.equal(got, ref_first):
            raise AssertionError(f"vit_post_w4a8 {din} -> {dout}: the {form} form differs from "
                                 f"the first form at {int((got != ref_first).sum())} outputs")
        rows.append(_row(
            "vit_post_w4a8", (BATCH, VIT_NP, dp, hp, din, dout),
            f"{BATCH}x{VIT_NP}x{dp} {din} -> {dout}, mlp {hp}, int4", got, plain(), kern, plain,
            2.0 * m * (dp * dp + 2 * dp * hp),
            y.numel() * y.element_size() + a.numel() * 2 + (dp * dp + 2 * dp * hp) // 2
            + 8 * (3 * dp + hp) + m * dp * odt.itemsize, per,
            library=lambda: (torch._int_mm(x1, wp), torch._int_mm(x1, w1), torch._int_mm(x2, w2)),
            tol=VIT_TOL, library_name=INT_MM + ", the three products on int8 weights",
            residual=din, out=dout, spun=True, form=form, first_form_equal=True,
            first_form_device_ms=spun_ms(first, 20, warmup=2, reps=3)))
        vit_block_post_w4a8.by_form.clear()
        del got, ref_first
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
    weights count K/2 bytes in the bound, the products bf16's peak. K11's
    and K12's rows also carry their form, device time on a spinning card
    (their own and the yardstick's), and their first form's device time and
    equal fraction against it."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.matmul_int4a8 import unpack_halves_kmajor
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_w4, vit_block_post_w4_first, vit_block_post_w4_plain, vit_block_pre_w4,
        vit_block_pre_w4_first, vit_block_pre_w4_plain,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

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
        vit_block_pre_w4.by_form.clear()
        got = vit_block_pre_w4(y, blk, dp)
        form = vit_block_pre_w4.by_form.most_common(1)[0][0]
        # the Hopper form against the first form (fp32 sums in another
        # order): within W4A16_TOL, as against the plain version
        first = vit_block_pre_w4_first(y, blk, dp)
        diff = (got.float() - first.float()).abs()
        first_equal, first_err = float((diff == 0).float().mean()), float(diff.max())
        if first_equal < W4A16_TOL["bf16"][0] or first_err > W4A16_TOL["bf16"][1]:
            raise AssertionError(f"vit_pre_w4 {case}: the {form} form against the first form: "
                                 f"{first_equal} equal, largest difference {first_err}")
        rows.append(_row(
            "vit_pre_w4", (BATCH, VIT_NP, dp, case), f"{BATCH}x{VIT_NP}x{dp} {case} -> qkv, w4a16",
            got, vit_block_pre_w4_plain(y, blk, dp),
            lambda: vit_block_pre_w4(y, blk, dp), lambda: vit_block_pre_w4_plain(y, blk, dp),
            2.0 * m * dp * 3 * dp,
            y.numel() * y.element_size() + 3 * dp * dp // 2 + 8 * 3 * dp + 8 * dp + m * 3 * dp * 2,
            per, library=lambda: torch.matmul(h1, wq), tol=W4A16_TOL["bf16"], peak=PEAK_BF16,
            library_name=HMM, residual=case, out="bf16", spun=True, form=form,
            first_form_equal_fraction=first_equal, first_form_max_abs_diff=first_err,
            first_form_device_ms=spun_ms(lambda: vit_block_pre_w4_first(y, blk, dp), 20,
                                         warmup=2, reps=3)))
        vit_block_pre_w4.by_form.clear()
        del got, first, diff
    qkv = vit_block_pre_w4_plain(y32, blk, dp)
    a = mhsa(qkv[..., :dp], qkv[..., dp: 2 * dp], qkv[..., 2 * dp:], VIT_HEADS, VIT_N)
    for (din, dout), per in vit_post_w4_cases().items():
        y, odt = ys[din], getattr(torch, dout)

        def kern():
            return vit_block_post_w4(y, a, blk, dp, True, odt)

        def plain():
            return vit_block_post_w4_plain(y, a, blk, dp, True, odt)

        def first():
            return vit_block_post_w4_first(y, a, blk, dp, True, odt)

        vit_block_post_w4.by_form.clear()
        got = kern()
        form = vit_block_post_w4.by_form.most_common(1)[0][0]
        rows.append(_row(
            "vit_post_w4", (BATCH, VIT_NP, dp, hp, din, dout),
            f"{BATCH}x{VIT_NP}x{dp} {din} -> {dout}, mlp {hp}, w4a16", got, plain(), kern, plain,
            2.0 * m * (dp * dp + 2 * dp * hp),
            y.numel() * y.element_size() + a.numel() * 2 + (dp * dp + 2 * dp * hp) // 2
            + 8 * (3 * dp + hp) + m * dp * odt.itemsize, per,
            library=lambda: (torch.matmul(h1, wp), torch.matmul(h1, w1), torch.matmul(h2, w2)),
            tol=W4A16_TOL["fp32" if dout == "float32" else "bf16"], peak=PEAK_BF16,
            library_name=HMM + ", the three products", residual=din, out=dout, spun=True,
            form=form, first_form_equal_fraction=_equal_fraction(got, first()),
            first_form_device_ms=spun_ms(first, 20, warmup=2, reps=3)))
        vit_block_post_w4.by_form.clear()
        del got
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
    plain version. Each row carries its form, device time on a spinning
    card (its own and the products'), and its first form's device time and
    equal fraction against it (K14's held to BF16_TOL)."""
    from dlq_tpu_torch.ops.attention import mhsa
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_bf16, vit_block_post_bf16_first, vit_block_post_bf16_plain,
        vit_block_post_w4, vit_block_post_w4_plain, vit_block_pre_bf16, vit_block_pre_bf16_first,
        vit_block_pre_bf16_plain,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

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
        vit_block_pre_bf16.by_form.clear()
        got = vit_block_pre_bf16(y, blk, d)
        form = vit_block_pre_bf16.by_form.most_common(1)[0][0]
        # the Hopper form against the first form (fp32 sums in the tensor
        # core's order, the first form's in mma.sync's): within BF16_TOL, as
        # against the plain version
        first = vit_block_pre_bf16_first(y, blk, d)
        diff = (got.float() - first.float()).abs()
        first_equal, first_err = float((diff == 0).float().mean()), float(diff.max())
        if first_equal < BF16_TOL[0] or first_err > BF16_TOL[1]:
            raise AssertionError(f"vit_pre_bf16 {npad}/{dp}: the {form} form against the first "
                                 f"form: {first_equal} equal, largest difference {first_err}")
        rows.append(_row(
            "vit_pre_bf16", (BATCH, npad, dp, din),
            f"{BATCH}x{npad}x{dp} {din} -> qkv, bf16 weights",
            got, vit_block_pre_bf16_plain(y, blk, d),
            lambda: vit_block_pre_bf16(y, blk, d), lambda: vit_block_pre_bf16_plain(y, blk, d),
            2.0 * m * d * 3 * d,
            m * d * y.element_size() + 3 * d * d * 2 + 4 * 3 * d + 8 * d + m * 3 * dp * 2,
            per, library=lambda: torch.matmul(h1, wq), tol=BF16_TOL, peak=PEAK_BF16,
            library_name=BMM, residual=din, out="bf16", pads=f"{npad}/{dp}", spun=True,
            form=form, first_form_equal_fraction=first_equal, first_form_max_abs_diff=first_err,
            first_form_device_ms=spun_ms(lambda: vit_block_pre_bf16_first(y, blk, d), 20,
                                         warmup=2, reps=3)))
        vit_block_pre_bf16.by_form.clear()
        del got, first, diff
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
        def first():
            return vit_block_post_bf16_first(y, a, blk, d, True, odt)

        vit_block_post_bf16.by_form.clear()
        got = kern()
        form = vit_block_post_bf16.by_form.most_common(1)[0][0]
        rows.append(_row(
            "vit_post_bf16", (BATCH, npad, dp, hp, din, dout),
            f"{BATCH}x{npad}x{dp} {din} -> {dout}, mlp {hp}, bf16 weights", got, ref, kern,
            plain, 2.0 * m * (d * d + 2 * d * hp),
            2 * m * d * y.element_size() + (d * d + 2 * d * hp) * 2
            + 4 * (2 * d + hp) + 8 * d + m * dp * odt.itemsize, post_per,
            library=lambda: (torch.matmul(h1, wp), torch.matmul(h1, w1), torch.matmul(h2, w2)),
            tol=BF16_TOL, peak=PEAK_BF16, library_name=BMM + ", the three products",
            residual=din, out=dout, pads=f"{npad}/{dp}", bf16_tol_witness_equal_fraction=witness,
            spun=True, form=form, first_form_equal_fraction=_equal_fraction(got, first()),
            first_form_device_ms=spun_ms(first, 20, warmup=2, reps=3)))
        vit_block_post_bf16.by_form.clear()
        del got
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
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8, mhsa_i8_first, mhsa_i8_plain
    from dlq_tpu_torch.ops.vit_block import vit_block_pre_plain
    from dlq_tpu_torch.tools._probe import spun_ms

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

        def first():
            return mhsa_i8_first(*views, VIT_HEADS, n_valid, out_lanes=lanes, zero_pad=zero_pad,
                                 out_dtype=odt)

        mhsa_i8.by_form.clear()
        got, ref = kern(), plain()
        kform = mhsa_i8.by_form.most_common(1)[0][0]
        mhsa_i8.by_form.clear()
        # the Hopper form against the first form: the same codes, exact int32
        # sums and each thread's row sum in the same order
        fst = first()
        if not torch.equal(got, fst):
            raise AssertionError(f"mhsa_i8 {n}/{n_valid} {form} {din}: the {kform} form differs "
                                 f"from the first form at {int((got != fst).sum())} outputs")
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
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)),
            spun=True, kernel_form=kform, first_form_equal=True,
            first_form_device_ms=spun_ms(first, 20, warmup=2, reps=3),
            sdpa_bf16_device_ms=spun_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4), 20,
                warmup=2, reps=3)))
        del t, views, q4, k4, v4, got, ref, fst
    del qkv
    return rows


def check_ln_kernels(dev):
    """K16 and K17 at [256 x 197, 192] in fp32 and bf16 (x, y, delta, g and
    b in the stream's dtype, as make_qforward casts them), with F.layer_norm
    (after y + delta for K17) as the yardstick, as device time too; K16
    equal to its first form on every output and timed in turns with it;
    then K6's fp32 form at [256, 197, 3 x 64] with fp32
    scaled_dot_product_attention as the yardstick."""
    import torch.nn.functional as F

    from dlq_tpu_torch.ops.attention import mhsa, mhsa_f32, mhsa_f32_first, mhsa_plain
    from dlq_tpu_torch.ops.layernorm import (
        layernorm_fused, layernorm_fused_first, layernorm_fused_plain, residual_layernorm,
        residual_layernorm_plain,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    m, d = BATCH * VIT_N, VIT_DP
    x32 = 0.3 + torch.randn((m, d), generator=gen, device=dev)
    d32 = 0.5 * torch.randn((m, d), generator=gen, device=dev)
    g32 = 0.5 + torch.rand(d, generator=gen, device=dev)
    b32 = 0.1 * torch.randn(d, generator=gen, device=dev)
    rows = []
    for dt, per in layernorm_fused_cases().items():
        x, g, b = (t.to(getattr(torch, dt)) for t in (x32, g32, b32))
        layernorm_fused.by_form.clear()
        got = layernorm_fused(x, g, b)
        form = layernorm_fused.by_form.most_common(1)[0][0]
        layernorm_fused.by_form.clear()
        first = layernorm_fused_first(x, g, b)
        if not torch.equal(got, first):
            raise AssertionError(f"layernorm_fused {dt}: the {form} form differs from the first "
                                 f"form at {int((got != first).sum())} outputs")
        # the first form is the parent's kernel, unchanged: first, Hopper,
        # Hopper, first as device time on a spinning card
        turns = {"first_form": [], "hopper": []}
        for tag in ("first_form", "hopper", "hopper", "first_form"):
            fn = layernorm_fused_first if tag == "first_form" else layernorm_fused
            turns[tag].append(spun_ms(lambda: fn(x, g, b), 20, warmup=2, reps=3))
        rows.append(_row(
            "layernorm_fused", (m, d, dt), f"{m}x{d} {dt}", got,
            layernorm_fused_plain(x, g, b), lambda: layernorm_fused(x, g, b),
            lambda: layernorm_fused_plain(x, g, b), 8.0 * m * d,
            2 * x.numel() * x.element_size() + 2 * d * g.element_size(), per,
            plain_iters=5, library=lambda: F.layer_norm(x, (d,), g, b, 1e-6),
            tol=LN_TOL[dt], peak=PEAK_FP32, library_name=LAYER_NORM, dtype=dt, spun=True,
            form=form, first_form_equal=True, first_form_device_ms=min(turns["first_form"]),
            device_ms_in_turns=turns))
        layernorm_fused.by_form.clear()
        del got, first
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
            dtype=f"{ydt}+{ddt}", z_equal_plain=True, spun=True))
    del x32, d32
    qkv = torch.randn((BATCH, VIT_N, 3 * d), generator=gen, device=dev)
    for (n, n_valid), per in mhsa_f32_cases().items():
        views = (qkv[:, :n, :d], qkv[:, :n, d: 2 * d], qkv[:, :n, 2 * d:])
        q4, k4, v4 = (v.reshape(BATCH, n, VIT_HEADS, VIT_HD).transpose(1, 2).contiguous()
                      for v in views)
        mhsa_f32.by_form.clear()
        got = mhsa(*views, VIT_HEADS, n_valid)
        form = mhsa_f32.by_form.most_common(1)[0][0]
        mhsa_f32.by_form.clear()
        # the Hopper form against the first form: each score and each output
        # one FMA chain in the same order, the same softmax
        first = mhsa_f32_first(*views, VIT_HEADS, n_valid)
        if not torch.equal(got, first):
            raise AssertionError(f"mhsa_f32 {n}/{n_valid}: the {form} form differs from the first "
                                 f"form at {int((got != first).sum())} outputs")
        rows.append(_row(
            "mhsa_f32", (BATCH, n, VIT_HEADS, VIT_HD, n_valid),
            f"{BATCH}x{VIT_HEADS} heads x {n} rows x {VIT_HD}, {n_valid} keys, fp32",
            got, mhsa_plain(*views, VIT_HEADS, n_valid),
            lambda: mhsa(*views, VIT_HEADS, n_valid),
            lambda: mhsa_plain(*views, VIT_HEADS, n_valid),
            4.0 * BATCH * VIT_HEADS * n * n_valid * VIT_HD, _mhsa_bytes(n, n_valid, d, 4), per,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4),
            tol=MHSA_F32_TOL, peak=PEAK_FP32, library_name=SDPA_F32, out="fp32", spun=True,
            form=form, first_form_equal=True,
            first_form_device_ms=spun_ms(lambda: mhsa_f32_first(*views, VIT_HEADS, n_valid), 20,
                                         warmup=2, reps=3)))
        del q4, k4, v4, got, first
    return rows


def _dw_off_fast_path(scale, bias, force):
    """K23's epilogue parameters off the Hopper form's int8 fast path, y / s
    spread over the int8 range: "s_small" / "s_large" an output scale of
    2^-31 / 2^31 (s_fast fails; scale and bias scaled with it), "quad" s =
    0.1 with a bias of +-1e18 in channel 8k and a scale of 1e13 in channel
    16k + 5 (those quads take requant_exact, the others the fast path, in
    one launch)."""
    scale = scale * 80.0
    if force == "quad":
        scale, bias = scale.clone(), bias.clone()
        sign = torch.where(torch.arange(bias[0::8].numel(), device=bias.device) % 2 == 1, -1.0, 1.0)
        bias[0::8] = 1e18 * sign
        scale[5::16] = 1e13
        return scale, bias, 0.1
    s = 2.0 ** -31 if force == "s_small" else 2.0 ** 31
    return scale * (s / 0.1), bias * (s / 0.1), s


def check_depthwise_kernel(dev):
    """K23 at every depthwise shape of MobileNetV2 1.0x at batch 256, with
    both of its paths' epilogues (fp32 out under deploy, int8 out with relu6
    under fused2), on the Hopper form (asserted by ``by_form``),
    bit-identical to its plain version and to its first form, timed beside
    the plain version, the bound and the fp32 grouped conv (DW_FP32), also as
    device time on a spinning card, and in turns with the first form
    (hopper, first, first, hopper); then odd shapes held bit-identical on
    both forms, each launch on the form the rule names (C = 40 and 24 on the
    first form, odd H and W, stride 2 from an odd H); the Hopper form off its
    int8 fast path (requant_exact: output scales 2^-31 and 2^31, quads past
    its check's bound) with relu6, relu and no activation, bit-identical to
    both; a C that is not a multiple of 8 refused; the Hopper kernels'
    ptxas report."""
    import torch.nn.functional as F

    from dlq_tpu_torch import _build
    from dlq_tpu_torch.models.common import fp32_conv
    from dlq_tpu_torch.ops.conv_int8 import out_hw
    from dlq_tpu_torch.ops.depthwise_int8 import (
        depthwise_form, depthwise_int8, depthwise_int8_first, depthwise_int8_plain,
        pack_depthwise_weight,
    )
    from dlq_tpu_torch.tools._probe import spun_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows = []
    for case, per in depthwise_cases().items():
        h, c, s, act, int8_out = case
        relu6 = act == "relu6"
        x = _rand_int8(gen, (BATCH, h, h, c), dev)
        pk = pack_depthwise_weight(_rand_int8(gen, (3, 3, 1, c), dev))
        scale, bias, osc = _epi_params(gen, c, 9, dev)
        if relu6:
            # y spread past 6 (std ~4), at an output scale whose 6 / s < 127,
            # so the clip before the division shows
            scale, osc = scale * 80.0, 0.1
        osc = osc if int8_out else None
        args = (x, pk, s, 1, scale, bias, False, osc, relu6)
        fn = functools.partial(depthwise_int8, *args)
        first = functools.partial(depthwise_int8_first, *args)
        plain = functools.partial(depthwise_int8_plain, *args)
        depthwise_int8.by_form.clear()
        got, ref = fn(), plain()
        form = depthwise_int8.by_form.most_common(1)[0][0]
        if form != "hopper" or not torch.equal(first(), got):
            raise AssertionError(f"depthwise_int8 {case}: form {form}, or the first form differs")
        oh, ow = out_hw(h, h, 3, 3, s, 1)
        xf = x.permute(0, 3, 1, 2).float()          # channels-last fp32 of the same values
        wf = pk.hwio().permute(3, 2, 0, 1).float()  # [C, 1, 3, 3]

        def lib():
            with fp32_conv():
                return F.conv2d(xf, wf, stride=s, padding=1, groups=c)

        turns = {"first_form": [], "hopper": []}
        for tag in ("hopper", "first_form", "first_form", "hopper"):
            turns[tag].append(spun_ms(first if tag == "first_form" else fn, 20, warmup=2, reps=3))
        rows.append(_row(
            "depthwise_int8", KEYS["depthwise_int8"][1](case),
            f"{BATCH}x{h}x{h}x{c} 3x3/s{s}", got, ref, fn, plain,
            2.0 * BATCH * oh * ow * c * 9,
            x.numel() + 9 * c + 8 * c + got.numel() * got.element_size(),
            per, library=lib, library_name=DW_FP32, spun=True,
            act=act, out="int8" if int8_out else "fp32", form=form, first_form_equal=True,
            first_form_ms=time_ms(first), first_form_device_ms=min(turns["first_form"]),
            device_ms_in_turns=turns))
        del x, got, ref, xf
    odd = []
    for n, h, w, c, s in ((2, 9, 9, 40, 1), (2, 13, 11, 40, 2), (3, 7, 5, 24, 2),
                          (2, 15, 15, 16, 2), (2, 13, 11, 32, 2), (1, 9, 20, 48, 1),
                          (2, 30, 30, 208, 1)):
        x = _rand_int8(gen, (n, h, w, c), dev)
        pk = pack_depthwise_weight(_rand_int8(gen, (3, 3, 1, c), dev))
        scale, bias, _ = _epi_params(gen, c, 9, dev)
        want = depthwise_form(n, h, w, c, 3, 3, s, 1)
        for relu6, osc in ((False, None), (True, 0.1)):
            sc = scale * 80.0 if relu6 else scale
            depthwise_int8.by_form.clear()
            got = depthwise_int8(x, pk, s, 1, sc, bias, False, osc, relu6)
            form = depthwise_int8.by_form.most_common(1)[0][0]
            first = depthwise_int8_first(x, pk, s, 1, sc, bias, False, osc, relu6)
            ref = depthwise_int8_plain(x, pk, s, 1, sc, bias, False, osc, relu6)
            err = max(float((got.float() - ref.float()).abs().max()),
                      float((first.float() - ref.float()).abs().max()))
            if err or form != want:
                raise AssertionError(f"depthwise_int8 {(n, h, w, c, s, relu6)}: form {form} "
                                     f"(rule: {want}), max_abs_err {err}")
            odd.append({"shape": [n, h, w, c], "stride": s, "relu6": relu6, "form": form,
                        "max_abs_err": err, "first_form_equal": True})
    fallback = []
    for n, h, w, c, s in ((2, 15, 15, 16, 2), (2, 30, 30, 208, 1), (2, 14, 14, 576, 2)):
        x = _rand_int8(gen, (n, h, w, c), dev)
        pk = pack_depthwise_weight(_rand_int8(gen, (3, 3, 1, c), dev))
        scale0, bias0, _ = _epi_params(gen, c, 9, dev)
        for force in ("s_small", "s_large", "quad"):
            scale, bias, osc = _dw_off_fast_path(scale0, bias0, force)
            for relu, relu6 in ((False, True), (True, False), (False, False)):
                args = (x, pk, s, 1, scale, bias, relu, osc, relu6)
                depthwise_int8.by_form.clear()
                got = depthwise_int8(*args)
                form = depthwise_int8.by_form.most_common(1)[0][0]
                if (form != "hopper" or not torch.equal(got, depthwise_int8_plain(*args))
                        or not torch.equal(got, depthwise_int8_first(*args))):
                    raise AssertionError(f"depthwise_int8 {(n, h, w, c, s)} off the fast path "
                                         f"({force}, relu {relu}, relu6 {relu6}): form {form}, "
                                         f"or it differs from the plain version or first form")
                fallback.append({"shape": [n, h, w, c], "stride": s, "force": force,
                                 "relu": relu, "relu6": relu6, "form": form, "equal": True,
                                 "codes": len(torch.unique(got))})
    try:
        bad = pack_depthwise_weight(_rand_int8(gen, (3, 3, 1, 12), dev))
        depthwise_int8(_rand_int8(gen, (1, 8, 8, 12), dev), bad, 1, 1, scale[:12].contiguous(),
                       bias[:12].contiguous())
        raise AssertionError("depthwise_int8: C = 12 was not refused")
    except ValueError as e:
        refused = str(e)
    emit({"phase": "depthwise_odd_shapes", "cases": odd, "exact_fallback": fallback,
          "refused_c12": refused,
          "ptxas_hopper": _build.ptxas_report("depthwise_int8", "depthwise_hopper_kernel"),
          "ptxas_first": _build.ptxas_report("depthwise_int8", "depthwise_int8_kernel")})
    return rows


def check_mnv2_epilogues(dev):
    """K1 and K2 with relu6 and int8 out at MobileNetV2 1.0x's stem, expand,
    project and head shapes at batch 256, bit-identical to their plain
    versions, y spread past 6 at output scales whose 6 / s is below (0.1) and
    above (0.025) 127: the stem C = 3 -> 32 3x3/s2/p1 (first form), the
    expand convs K = 16 -> 96 and K = 24 -> 144 (K % 16 != 0: first form),
    the project convs to N = 24 (int8 rows not 16-byte multiples: the
    unaligned store branch) and N = 16, the head 320 -> 1280; each with the
    form its launch took and its time."""
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, pack_conv_weight
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    out = []

    def held(kernel, what, fn, plain, by_form):
        by_form.clear()
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if err:
            raise AssertionError(f"{kernel} relu6 {what}: max_abs_err {err}")
        out.append({"kernel": kernel, "shape": what, "max_abs_err": err,
                    "form": by_form.most_common(1)[0][0], "ms": time_ms(fn, iters=10)})

    x = _rand_int8(gen, (BATCH, 224, 224, 3), dev)
    pk = pack_conv_weight(_rand_int8(gen, (3, 3, 3, 32), dev))
    scale, bias, _ = _epi_params(gen, 32, 27, dev)
    for osc in (0.1, 0.025):
        held("conv_int8", f"{BATCH}x224x224x3->32 3x3/s2 out_scale {osc}",
             functools.partial(conv_int8, x, pk, 2, 1, scale * 80.0, bias, False, osc, True),
             functools.partial(conv_int8_plain, x, pk, 2, 1, scale * 80.0, bias, False, osc,
                               True), conv_int8.by_form)
    del x
    for hw, k, n, relu6 in ((112 * 112, 16, 96, True), (56 * 56, 24, 144, True),
                            (56 * 56, 144, 24, False), (112 * 112, 32, 16, False),
                            (7 * 7, 320, 1280, True)):
        x = _rand_int8(gen, (BATCH * hw, k), dev)
        pk = pack_dense_weight(_rand_int8(gen, (k, n), dev))
        scale, bias, _ = _epi_params(gen, n, k, dev)
        sc = scale * 80.0 if relu6 else scale * 40.0
        for osc in (0.1, 0.025):
            held("matmul_int8", f"{BATCH * hw}x{k}@{k}x{n} relu6={relu6} out_scale {osc}",
                 functools.partial(matmul_int8, x, pk, sc, bias, False, osc, relu6),
                 functools.partial(matmul_int8_plain, x, pk, sc, bias, False, osc, relu6),
                 matmul_int8.by_form)
        del x
    emit({"phase": "mnv2_relu6_epilogues", "cases": out})


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
# the kernels whose producer warpgroup gives registers to its consumer
# warpgroups by setmaxnreg, as their sources set the split (producer,
# consumer registers a thread), and the mark of their Hopper kernels' names
# in the ptxas report: K1 and K2 (csrc/i8gemm.cuh), K3
# (csrc/basic_block.cu), K4 (csrc/bottleneck_block.cu), K5 and K8
# (csrc/vit_pre_iw.cuh), K7 and K9 (csrc/vit_post_iw.cuh), K10 and K13
# (csrc/w4gemm.cuh), K11 and K14 (csrc/vit_pre_hw.cuh), K12 and K15
# (csrc/vit_post_hw.cuh)
SPLIT_KERNELS = {"conv_int8": (40, 232, "i8_kernel"),
                 "matmul_int8": (40, 232, "i8_kernel"),
                 "basic_block": (40, 232, "basic_hopper_kernel"),
                 "bottleneck_block": (40, 232, "bottleneck_hopper_kernel"),
                 "vit_pre_w8": (40, 232, "pre_iw6kernel"),
                 "vit_pre_w4a8": (40, 232, "pre_iw6kernel"),
                 "vit_post_w8": (40, 232, "post_iw6kernel"),
                 "vit_post_w4a8": (88, 208, "post_iw6kernel"),
                 "matmul_int4a8": (56, 224, "gemm_kernel"),
                 "vit_pre_w4": (88, 208, "pre_hw6kernel"),
                 "vit_post_w4": (88, 208, "post_hw6kernel"),
                 "matmul_int4": (56, 224, "gemm_kernel"),
                 "vit_pre_bf16": (40, 232, "pre_hw6kernel"),
                 "vit_post_bf16": (40, 232, "post_hw6kernel")}
STRESS_LAUNCHES = 4000


def attention_ptxas():
    """The ptxas reports of mhsa_f32's and K18's libraries: registers, stack
    frame, spills and the library's C7520 count, for each Hopper form and
    first form."""
    from dlq_tpu_torch import _build

    emit({"phase": "attention_ptxas",
          "mhsa_f32_hopper": _build.ptxas_report("mhsa", "mhsa_f32_hopper"),
          "mhsa_f32_first": _build.ptxas_report("mhsa", "mhsa_f32_kernel"),
          "mhsa_i8_hopper": _build.ptxas_report("mhsa_i8", "mhsa_i8_hopper"),
          "mhsa_i8_first": _build.ptxas_report("mhsa_i8", "mhsa_i8_kernel")})


@contextlib.contextmanager
def first_form(module, name: str, first, on: bool = True):
    """With ``on``, ``module.name`` (a kernel wrapper a forward calls by that
    name) routed to the kernel's first form ``first`` for a measurement; its
    launches are not counted."""
    keep = getattr(module, name)
    if on:
        setattr(module, name, first)
    try:
        yield
    finally:
        setattr(module, name, keep)


def repeat_differing(fn, first, runs: int) -> int:
    """``runs`` more calls of ``fn()``, each output compared with ``first``
    on the device: the number of calls whose output differs anywhere, counted
    in a device int32 and read after one synchronize."""
    differ = torch.zeros((), dtype=torch.int32, device=first.device)
    for _ in range(runs):
        differ += torch.ne(fn(), first).any()
    return int(differ)   # synchronizes: a fault in any launch raises here


REPEATS = {}   # served path -> its repeat_forward reading


def repeat_forward(path: str, fn) -> None:
    """The served forward ``fn()`` (logits of a resident batch: 256 on the
    timed paths, 64 on the DeiT deploy paths) run SPLIT_REPEATS more times,
    each run's logits compared with the first's on the device
    (repeat_differing): a kernel that races differs in some run. Records
    and prints the runs that differ and the seconds; check_repeats gates
    them."""
    with torch.inference_mode():
        first = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        differ = repeat_differing(fn, first, SPLIT_REPEATS)
    REPEATS[path] = {"repeats": SPLIT_REPEATS, "runs_differing": differ,
                     "seconds": time.perf_counter() - t0}
    emit({"phase": "repeat_forward", "path": path, **REPEATS[path]})


def check_repeats() -> None:
    """Every served forward that repeat_forward ran: no run differs from
    its first."""
    want = {"r18_fused2", "r18_block", "r50_fused2", "r50_block", "deit_block",
            "deit_block_attn_int8", "deit_block_w4a8", "deit_block_w4", "deit_bf16_loose",
            "deit_bf16_tight", *DEPLOY_REPEATS, *MNV2_PATHS, *ENGINE_REPEATS, *PTQ_REPEATS}
    differ = {k: v["runs_differing"] for k, v in REPEATS.items() if v["runs_differing"]}
    emit({"phase": "repeat_forwards", "paths": len(REPEATS), "repeats": SPLIT_REPEATS,
          "runs_differing": {k: v["runs_differing"] for k, v in REPEATS.items()},
          "seconds": sum(v["seconds"] for v in REPEATS.values()),
          "deploy_seconds": sum(REPEATS[k]["seconds"] for k in DEPLOY_REPEATS if k in REPEATS)})
    if set(REPEATS) != want:
        raise AssertionError(f"repeat_forwards: paths {sorted(REPEATS)}, expected {sorted(want)}")
    if differ:
        raise AssertionError(f"repeat_forwards: runs differing from the first of "
                             f"{SPLIT_REPEATS} each: {differ}")


def stress_split_kernels(dev):
    """STRESS_LAUNCHES launches each of the SPLIT_KERNELS at a main-path
    shape: DeiT-Tiny's block path at [256, 200, 192] bf16 -> bf16 (K5, K7,
    K8, K9, K11, K12, K14, K15), K5 and K7 also at the split forward's loose
    [64, 256, 256] and K14 at the bf16 forward's loose [256, 256, 256]; K1
    at ResNet's 56x56x64 3x3/s1 conv, K2 at ResNet-50 layer1's 802816x64 @
    64x256, K3 at [256, 28, 28, 128], K4 at layer1's 56x56x256 mid 64
    (weights resident), K10 at the deploy path's fc1 (50432x192 @ 192x768)
    and K13 at its G128 fc2 (50432x768 @ 768x192, the group-wise site K13
    serves). Every launch's output is compared with the first's on the
    device (repeat_differing; the kernels are deterministic): a producer
    that keeps fewer registers than its code uses faults only now and then
    (K12's at 56, PERF.md), and a race (K5's y stages did) differs in
    some launch. Gate: no launch differs. Each case's line carries the
    differing count, its seconds, its register split, the form its launch
    took and its library's ptxas report."""
    from dlq_tpu_torch import _build
    from dlq_tpu_torch.ops.block_fused import basic_block_fused, bottleneck_block_fused
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, pack_conv_weight
    from dlq_tpu_torch.ops.matmul_int4 import matmul_int4, pack_int4_weight
    from dlq_tpu_torch.ops.matmul_int4a8 import matmul_int4a8, pack_int4a8_weight
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, pack_dense_weight
    from dlq_tpu_torch.ops.vit_block import (
        vit_block_post_bf16, vit_block_post_w4, vit_block_post_w4a8, vit_block_post_w8,
        vit_block_pre_bf16, vit_block_pre_w4, vit_block_pre_w4a8, vit_block_pre_w8,
    )
    from dlq_tpu_torch.quant.qconfig import INT4_WEIGHT_ONLY_G128, INT4A8_PER_CHANNEL
    from dlq_tpu_torch.quant.quantize import quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    d, bf = VIT_DP, torch.bfloat16
    y = torch.randn((BATCH, VIT_NP, d), generator=gen, device=dev).to(bf)
    a = torch.randn((BATCH, VIT_NP, d), generator=gen, device=dev).to(bf)
    w8, w4a8, w4 = _vit_layer(gen, dev), _w4a8_layer(gen, dev), _w4a16_layer(gen, dev)
    wbf = _bf16_layer(gen, dev, d)
    # the loose pads: the split forward's [64, 256, 256] and the bf16 forward's [256, 256, 256]
    lp, ld = VIT_NP_LOOSE, VIT_DP_LOOSE
    ys = torch.randn((TOTALS_BATCH, lp, ld), generator=gen, device=dev).to(bf)
    as_ = torch.randn((TOTALS_BATCH, lp, ld), generator=gen, device=dev).to(bf)
    yl = torch.randn((BATCH, lp, ld), generator=gen, device=dev).to(bf)
    w8l, wbfl = _vit_layer(gen, dev, ld), _bf16_layer(gen, dev, ld)
    xb = _rand_int8(gen, (BATCH, 28, 28, 128), dev, lo=0)
    bpack = {"w1": pack_conv_weight(_rand_int8(gen, (3, 3, 128, 128), dev)),
             "w2": pack_conv_weight(_rand_int8(gen, (3, 3, 128, 128), dev)),
             "inv": (float(np.float32(800.0)), float(np.float32(800.0)), float(np.float32(0.7)))}
    for i in (1, 2):
        bpack[f"s{i}"], bpack[f"b{i}"], _ = _epi_params(gen, 128, 9 * 128, dev)
    # K1: 56x56x64 -> 64 3x3/s1, relu, int8 out (ResNet layer1)
    xc = _rand_int8(gen, (BATCH, 56, 56, 64), dev)
    wc = pack_conv_weight(_rand_int8(gen, (3, 3, 64, 64), dev))
    sc1, bc1, oc1 = _epi_params(gen, 64, 9 * 64, dev)
    # K2: ResNet-50 layer1's 1x1 conv3, 802816x64 @ 64x256, int8 out
    xm = _rand_int8(gen, (BATCH * 56 * 56, 64), dev)
    wm = pack_dense_weight(_rand_int8(gen, (64, 256), dev))
    sm2, bm2, om2 = _epi_params(gen, 256, 64, dev)
    # K4: layer1, 56x56x256 mid 64
    x4 = _rand_int8(gen, (BATCH, 56, 56, 256), dev, lo=0)
    inv = float(np.float32(40.0 / 0.05))
    p4 = {"inv": (inv, inv, inv, float(np.float32(0.7)))}
    for i, (k, c, oc) in enumerate(((1, 256, 64), (3, 64, 64), (1, 64, 256)), 1):
        p4[f"w{i}"] = pack_conv_weight(_rand_int8(gen, (k, k, c, oc), dev))
        p4[f"s{i}"], p4[f"b{i}"], _ = _epi_params(gen, oc, k * k * c, dev)
    # K10: the W4A8 deploy path's fc1, 256 x 197 rows, 192 -> 768
    x10 = _rand_int8(gen, (BATCH * VIT_N, 192), dev)
    w10 = pack_int4a8_weight(quantize_tensor(torch.randn((192, 768), generator=gen, device=dev),
                                             INT4A8_PER_CHANNEL.weights))
    s10, b10, _ = _epi_params(gen, 768, 192, dev)
    s10 = s10 * 16.0
    # K13: the G128 deploy path's fc2, 256 x 197 rows, 768 -> 192
    x13 = torch.randn((BATCH * VIT_N, 768), generator=gen, device=dev).to(bf)
    w13 = pack_int4_weight(quantize_tensor(0.02 * torch.randn((768, 192), generator=gen, device=dev),
                                           INT4_WEIGHT_ONLY_G128.weights))
    b13 = (0.02 * torch.randn(192, generator=gen, device=dev)).contiguous()
    # (label, wrapper, library, call, shape)
    tight = f"{BATCH}x{VIT_NP}x{d} bf16"
    cases = [
        ("conv_int8", conv_int8, "conv_int8",
         lambda: conv_int8(xc, wc, 1, 1, sc1, bc1, True, oc1), f"{BATCH}x56x56x64->64 3x3/s1"),
        ("matmul_int8", matmul_int8, "matmul_int8",
         lambda: matmul_int8(xm, wm, sm2, bm2, False, om2), f"{BATCH * 56 * 56}x64@64x256"),
        ("basic_block", basic_block_fused, "basic_block",
         lambda: basic_block_fused(xb, bpack), f"{BATCH}x28x28x128"),
        ("bottleneck_block", bottleneck_block_fused, "bottleneck_block",
         lambda: bottleneck_block_fused(x4, p4), f"{BATCH}x56x56x256 mid 64"),
        ("vit_pre_w8", vit_block_pre_w8, "vit_pre_w8", lambda: vit_block_pre_w8(y, w8, d), tight),
        ("vit_pre_w8_loose", vit_block_pre_w8, "vit_pre_w8",
         lambda: vit_block_pre_w8(ys, w8l, d), f"{TOTALS_BATCH}x{lp}x{ld} bf16"),
        ("vit_pre_w4a8", vit_block_pre_w4a8, "vit_pre_w4a8",
         lambda: vit_block_pre_w4a8(y, w4a8, d), tight),
        ("vit_post_w8", vit_block_post_w8, "vit_post_w8",
         lambda: vit_block_post_w8(y, a, w8, d, True, bf, True), tight),
        ("vit_post_w8_loose", vit_block_post_w8, "vit_post_w8",
         lambda: vit_block_post_w8(ys, as_, w8l, d), f"{TOTALS_BATCH}x{lp}x{ld} bf16"),
        ("vit_post_w4a8", vit_block_post_w4a8, "vit_post_w4a8",
         lambda: vit_block_post_w4a8(y, a, w4a8, d), tight),
        ("matmul_int4a8", matmul_int4a8, "matmul_int4a8",
         lambda: matmul_int4a8(x10, w10, s10, b10, False), f"{BATCH * VIT_N}x192@192x768 int4"),
        ("vit_pre_w4", vit_block_pre_w4, "vit_pre_w4", lambda: vit_block_pre_w4(y, w4, d), tight),
        ("vit_post_w4", vit_block_post_w4, "vit_post_w4",
         lambda: vit_block_post_w4(y, a, w4, d), tight),
        ("matmul_int4", matmul_int4, "matmul_int4",
         lambda: matmul_int4(x13, w13, b13, False), f"{BATCH * VIT_N}x768@768x192 int4 g128"),
        ("vit_pre_bf16", vit_block_pre_bf16, "vit_pre_bf16",
         lambda: vit_block_pre_bf16(y, wbf, d), tight),
        ("vit_pre_bf16_loose", vit_block_pre_bf16, "vit_pre_bf16",
         lambda: vit_block_pre_bf16(yl, wbfl, d), f"{BATCH}x{lp}x{ld} bf16"),
        ("vit_post_bf16", vit_block_post_bf16, "vit_post_bf16",
         lambda: vit_block_post_bf16(y, a, wbf, d), tight),
    ]
    if {lib for _, _, lib, _, _ in cases} != set(SPLIT_KERNELS):
        raise AssertionError("setmaxnreg_stress: its cases do not cover SPLIT_KERNELS")
    out, bad, t_all = {}, {}, time.perf_counter()
    for label, wrapper, lib, fn, shape in cases:
        forms = getattr(wrapper, "by_form", None)
        if forms is not None:
            forms.clear()
        first = fn()
        form = None if forms is None else dict(forms)
        if form is not None and form != {"hopper": 1}:
            raise AssertionError(f"setmaxnreg_stress {label}: launch took {form}, not the "
                                 f"Hopper (split) form")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        differ = repeat_differing(fn, first, STRESS_LAUNCHES - 1)
        secs = time.perf_counter() - t0
        producer, consumer, mark = SPLIT_KERNELS[lib]
        out[label] = {"shape": shape, "launches": STRESS_LAUNCHES,
                      "launches_differing_from_first": differ, "seconds": secs, "form": form,
                      "producer_registers": producer, "consumer_registers": consumer,
                      "ptxas": _build.ptxas_report(lib, mark)}
        if differ:
            bad[label] = differ
        del first
    emit({"phase": "setmaxnreg_stress", "kernels": out, "cases": len(out),
          "libraries": len(SPLIT_KERNELS), "launches_differing": bad,
          "seconds": time.perf_counter() - t_all})
    if bad:
        raise AssertionError(f"setmaxnreg_stress: launches differing from the first of "
                             f"{STRESS_LAUNCHES}: {bad}")


def check_pre_digests(dev):
    """K5's and K11's outputs over their forms on seeded inputs
    (tools/pre_digest.py), equal bit for bit to those of the sources before
    K8 and K14 took their Hopper bodies."""
    from dlq_tpu_torch.tools import pre_digest

    got = pre_digest.digests(dev)
    if got != pre_digest.EXPECTED:
        raise AssertionError(f"pre_digest: {got}, expected {pre_digest.EXPECTED}")
    emit({"phase": "pre_digest", "digests": got, "equal_to_expected": True})


# ---------------------------------------------------------------------------

def _wrappers():
    from dlq_tpu_torch.ops.attention import mhsa, mhsa_f32
    from dlq_tpu_torch.ops.block_fused import basic_block_fused, bottleneck_block_fused
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8
    from dlq_tpu_torch.ops.conv_int8 import conv_int8
    from dlq_tpu_torch.ops.depthwise_int8 import depthwise_int8
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
          "residual_layernorm": residual_layernorm, "mhsa_f32": mhsa_f32, "mhsa_i8": mhsa_i8,
          "depthwise_int8": depthwise_int8}
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
        if hasattr(fn, "by_form"):
            fn.by_form.clear()


# paths on which every K1 and K2 launch must take the Hopper form (their
# first form serves only the C=3 stems of deploy/pallas and K % 16 != 0);
# every K3, K4, K5, K8, K9, K11, K12, K14, K15, K16, mhsa_f32, K18 and K23
# launch of every path must (their first forms serve no main-path shape: K3 C not
# a multiple of 128 or W > 83; K4 W > 126; Dp other than 128, 192, 256, for
# K8 also 256; K9, K12 and K15 also an Hp whose ring would hold fewer than
# 3 stages; K16 rows not a multiple of 16 bytes, D > 512 or a misaligned
# x; mhsa_f32 256 keys at hd 64; K18 fp32 in at 256 rows; K23 other than
# 3x3, pad 1, stride 1 or 2, C % 16 == 0)
HOPPER_PATHS = ("r18_fused2", "r18_block", "r50_fused2", "r50_block", "deit_deploy",
                "deit_deploy_w4a8_int8", "deit_deploy_fused_ln", "deit_deploy_xla_int8")
FORM_KERNELS = ("conv_int8", "matmul_int8", "basic_block", "bottleneck_block", "vit_pre_w8",
                "vit_pre_w4a8", "vit_post_w4a8", "vit_pre_w4", "vit_post_w4", "vit_pre_bf16",
                "vit_post_bf16", "layernorm_fused", "mhsa_f32", "mhsa_i8", "depthwise_int8")


def read_forms():
    """Launches per form of K1, K2, K3, K4, K5, K8, K9, K11, K12, K14, K15,
    K16, mhsa_f32, K18 and K23 since the counts were last set to 0."""
    ws = _wrappers()
    return {k: dict(ws[k].by_form) for k in FORM_KERNELS}


def read_counts():
    """(launches per kernel, launches per kernel and shape key)."""
    ws = _wrappers()
    return ({k: fn.launches for k, fn in ws.items()},
            {k: dict(fn.by_shape) for k, fn in ws.items()})


def expect_counts(got, path, forwards, what):
    want = {k: v * forwards for k, v in PER_FORWARD[path].items()}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} ({forwards} forwards)")
    forms = read_forms()
    for k, by in forms.items():
        if k in ("conv_int8", "matmul_int8") and path not in HOPPER_PATHS:
            continue
        if by.get("first") or by.get("hopper", 0) != got[k]:
            raise AssertionError(f"{what}: {k} launches by form {by}, expected all "
                                 f"{got[k]} on the Hopper form")
    emit({"phase": "forms", "path": path, "what": what, "forms": forms})


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
        attention, block_fused, conv_int8, depthwise_int8, int8_attention, layernorm,
        matmul_int4, matmul_int4a8, matmul_int8, qops, vit_block,
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
            (qops, "depthwise_int8", depthwise_int8.depthwise_int8_plain),
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


def drive(eng, images, path, what, by_shape=True):
    """Warm, then classify ``NB`` batches with the counts set to 0 just
    before and read just after; checks the launches per kernel and (with
    ``by_shape``) per shape. The launches by form of that run stay
    readable (``read_forms``) until the next launch."""
    eng.classify(images[:BATCH])                   # warm (first launches)
    eng.stats.images_timed, eng.stats.ms_total = 0, 0.0
    reset_counts()
    preds = eng.classify(images, pipeline=2)
    counts, shapes = read_counts()
    expect_counts(counts, path, NB, what)
    if by_shape:
        expect_by_shape(shapes, path, NB, what)
    return preds, counts, shapes


def no_sync_forward(eng, xt):
    """One forward with CUDA's sync debug mode at "error": any call that
    synchronizes the host with the card raises (the gate)."""
    torch.cuda.synchronize()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng._fn(eng.params, xt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def r18_dynamic_path(dev, card, store, images, ref_logits):
    """ResNet-18 Engine.from_store(ctx="dynamic") at batch 256 (r18_dynamic):
    driven through classify (K1 20, K2 1 a forward; by form: the 7x7 C = 3
    stem on K1's first form), gated against the port's fp32 engine
    (R18_DYNAMIC_FP32_COS) and bit-identical to its plain-version twin, one
    forward under set_sync_debug_mode("error"), then timed in turns with
    ctx="deploy" on the same store at the same batch (deploy, dynamic,
    dynamic, deploy), both repeated SPLIT_REPEATS times, and profiled."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine

    x0 = images[:BATCH]
    xt = torch.from_numpy(x0).to(dev)
    eng = Engine.from_store(store, ctx="dynamic", batch=BATCH, device=dev)
    dep = Engine.from_store(store, ctx="deploy", batch=BATCH, device=dev)
    preds, counts, _ = drive(eng, images, "r18_dynamic", "resnet18 dynamic", by_shape=False)
    forms = read_forms()
    logits = eng(x0).float().cpu().numpy()
    if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
        raise AssertionError("resnet18 dynamic: classify and the forward disagree")
    agree, cos = gate(logits, ref_logits, "resnet18 dynamic vs fp32", R18_DYNAMIC_FP32_COS,
                      top1=False)
    lp = plain_twin(eng, x0, "resnet18 dynamic")
    if not np.array_equal(lp, logits):
        raise AssertionError(f"resnet18 dynamic: kernels vs plain versions differ "
                             f"{float(np.abs(lp - logits).max())}")
    sync_out = no_sync_forward(eng, xt)
    if not np.array_equal(sync_out.float().cpu().numpy(), logits):
        raise AssertionError("resnet18 dynamic: the forward under sync debug mode differs")
    drive(dep, images, "r18_deploy_256", "resnet18 deploy 256", by_shape=False)
    dep_forms = read_forms()
    dep_logits = dep(x0).float().cpu().numpy()
    turns = {}
    for name, e in (("deploy", dep), ("dynamic", eng), ("dynamic", eng), ("deploy", dep)):
        turns.setdefault(name, []).append(time_ms(lambda: e._fn(e.params, xt), iters=10))
    repeat_forward("r18_dynamic", lambda: eng._fn(eng.params, xt))
    repeat_forward("r18_deploy_256", lambda: dep._fn(dep.params, xt))
    ms = float(np.mean(turns["dynamic"]))
    ms_dep = float(np.mean(turns["deploy"]))
    emit({"phase": "main_path_r18_dynamic", "model": "resnet18", "size": 224, "batch": BATCH,
          "batches": NB, "img_per_s_classify": eng.stats.images_per_sec, "ms_per_batch": ms,
          "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
          "launches_per_forward": {k: v / NB for k, v in counts.items()},
          "launches_by_form": {k: forms[k] for k in ("conv_int8", "matmul_int8")},
          "logits_cosine_vs_fp32": cos, "cosine_gate": R18_DYNAMIC_FP32_COS,
          "top1_agreement_vs_fp32": agree, "top1_gated": False,
          "logits_cosine_vs_deploy": numerics.diff(logits, dep_logits).cosine,
          "top1_agreement_vs_deploy": numerics.top1_agreement(logits, dep_logits),
          "logits_equal_plain_versions": True, "sync_debug_mode": "error, no synchronizing call",
          "ms_per_batch_in_turns": turns, "deploy_ms_per_batch": ms_dep,
          "deploy_img_per_s_classify": dep.stats.images_per_sec,
          "deploy_launches_by_form": {k: dep_forms[k] for k in ("conv_int8", "matmul_int8")},
          "dynamic_minus_deploy_ms": ms - ms_dep, "card": card})
    profile_forward(eng, xt, "resnet18_dynamic")
    profile_forward(dep, xt, "resnet18_deploy_256")
    del eng, dep


def r18_bf16_paths(dev, card, images, ref_logits):
    """ResNet-18 Engine.bf16 at batch 256: the folded qforward(ObserveCtx)
    forward, as bench.py:57-70 times it (r18_bf16), and resnet_forward on the
    unfolded params, bf16 through every BN (r18_bf16_unfolded); PyTorch's
    bf16 convs and matmuls (no kernel of the port launches), fp32 logits;
    each gated against the port's fp32 engine (R18_BF16_FP32_COS), timed,
    repeated SPLIT_REPEATS times; the folded one profiled."""
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.resnet import (
        ResNetConfig, flatten_folded, fold_resnet, init_resnet, qforward, resnet_forward,
    )
    from dlq_tpu_torch.quant.model_quant import ObserveCtx

    cfg = ResNetConfig(depth=18, num_classes=1000)
    params = init_resnet(SEED, cfg)
    x0 = images[:BATCH]

    def observe(p, x, c):
        return qforward(ObserveCtx(p), x, c)

    for path, fwd, p in (("r18_bf16", observe, flatten_folded(fold_resnet(params, cfg))),
                         ("r18_bf16_unfolded", resnet_forward, params)):
        eng = Engine.bf16(fwd, p, cfg, batch=BATCH, device=dev, name=path)
        preds, counts, _ = drive(eng, images, path, f"resnet18 {path}", by_shape=False)
        out = eng(x0)
        if out.dtype != torch.float32:
            raise AssertionError(f"resnet18 {path}: logits dtype {out.dtype}")
        logits = out.cpu().numpy()
        if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
            raise AssertionError(f"resnet18 {path}: classify and the forward disagree")
        agree, cos = gate(logits, ref_logits, f"resnet18 {path} vs fp32", R18_BF16_FP32_COS,
                          top1=False)
        xt = torch.from_numpy(x0).to(dev, torch.bfloat16)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        repeat_forward(path, lambda: eng._fn(eng.params, xt))
        emit({"phase": f"main_path_{path}", "model": "resnet18", "size": 224, "batch": BATCH,
              "batches": NB, "img_per_s_classify": eng.stats.images_per_sec,
              "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
              "launches": counts, "logits_dtype": "float32",
              "logits_cosine_vs_fp32": cos, "cosine_gate": R18_BF16_FP32_COS,
              "top1_agreement_vs_fp32": agree, "top1_gated": False, "card": card})
        if path == "r18_bf16":
            profile_forward(eng, xt, "resnet18_bf16")
        del eng


def main_paths(dev, card, depth, images):
    """fused2, PallasBlockCtx, deploy and pallas of ResNet-``depth``; returns
    {path: (counts, shapes)} of the two timed main paths."""
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.resnet import (
        ResNetConfig, flatten_folded, fold_resnet, folded_forward, init_resnet, qforward,
        qforward_fused2,
    )
    from dlq_tpu_torch.ops import block_fused
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
        repeat_forward(path, lambda: eng._fn(eng.params, xt))
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
        repeat_forward(path, lambda: blk._fn(blk.params, xt))
        turns = None
        if depth == 18:
            # the same forward with K3 on its first form (the parent's kernel,
            # unchanged): equal logits, then Hopper, first, first, Hopper
            with torch.inference_mode():
                hopper_logits = blk._fn(blk.params, xt)
                with first_form(block_fused, "basic_block_fused", block_fused.basic_block_first):
                    first_logits = blk._fn(blk.params, xt)
            if not torch.equal(hopper_logits, first_logits):
                raise AssertionError(f"{model} PallasBlockCtx: K3's first form changes the logits")
            del hopper_logits, first_logits
            turns = {}
            for form in ("hopper", "first_form", "first_form", "hopper"):
                with first_form(block_fused, "basic_block_fused", block_fused.basic_block_first,
                                form == "first_form"):
                    turns.setdefault(form, []).append(
                        time_ms(lambda: blk._fn(blk.params, xt), iters=10))
        emit({"phase": "main_path_block", "model": model, "batch": BATCH, "batches": NB,
              "img_per_s_classify": blk.stats.images_per_sec, "ms_per_batch": ms_b,
              "img_per_s_device": BATCH / (ms_b / 1e3), "launches": counts_b,
              "launches_per_forward": {k: v / NB for k, v in counts_b.items()},
              "top1_agreement_vs_fused2": agree_b, "logits_cosine_vs_fused2": cos_b,
              "top1_gated": top1, "top1_vs_fused2": top1_report(logits_b, logits_f2),
              "block_output_equal_fraction": eq, "per_block_equal_fraction_max_step": per_block,
              "max_abs_vs_plain_versions": plain_b,
              "preds_equal_fused2": float((preds_b == preds).mean()),
              "ms_per_batch_in_turns_k3_first_form": turns,
              "logits_equal_k3_first_form": None if turns is None else True, "card": card})
        profile_forward(blk, xt, f"{model}_block")
        if depth == 18:
            with first_form(block_fused, "basic_block_fused", block_fused.basic_block_first):
                profile_forward(blk, xt, f"{model}_block_k3_first_form")
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

        # ---- the engine paths: ctx="dynamic" on the same store, Engine.bf16 ----
        if depth == 18:
            torch.cuda.empty_cache()
            r18_dynamic_path(dev, card, tmp, images, ref_logits)
    if depth == 18:
        r18_bf16_paths(dev, card, images, ref_logits)
    torch.cuda.empty_cache()
    return out


def _mnv2_drive(eng, images, path, what, fused2=False):
    """drive() for a MobileNetV2 path: launches per kernel per forward, K23's
    per shape (K1 and K2 by totals); under fused2 every K1, K2 and K23 output
    is int8 but the fc's."""
    eng.classify(images[:BATCH])                   # warm (first launches)
    eng.stats.images_timed, eng.stats.ms_total = 0, 0.0
    reset_counts()
    preds = eng.classify(images, pipeline=2)
    counts, shapes = read_counts()
    forms = read_forms()["depthwise_int8"]
    expect_counts(counts, path, NB, what)
    want = expected_by_shape(path, NB)["depthwise_int8"]
    if shapes["depthwise_int8"] != want:
        raise AssertionError(f"{what}: K23 launches per shape {shapes['depthwise_int8']}, "
                             f"expected {want}")
    if fused2:
        fp32_out = {(k, name) for name in ("conv_int8", "matmul_int8", "depthwise_int8")
                    for k in shapes[name] if not k[-1]}
        if fp32_out != {((BATCH, 1280, 1000, False, False), "matmul_int8")}:
            raise AssertionError(f"{what}: fp32-out launches other than the fc's {fp32_out}")
    return preds, counts, shapes, forms


def mnv2_paths(dev, card, images):
    """MobileNetV2 1.0x W8A8 (224 px, 1000 classes, seed-0 weights): calibrated
    and quantized by Engine.quantized, saved as a store, served by
    Engine.from_store(ctx="deploy") (main_path_mnv2_deploy), then
    make_qforward_fused under FullFusedCtx on the same store (mnv2_fused2);
    returns {path: (counts, shapes, K23's launches by form)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine, to_device
    from dlq_tpu_torch.models.mobilenetv2 import (
        MobileNetV2Config, block_meta, fold_mobilenetv2, init_mobilenetv2, make_qforward,
        make_qforward_fused, mobilenetv2_forward,
    )
    from dlq_tpu_torch.quant.model_quant import FullFusedCtx
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import load_quantized, save_quantized

    cfg = MobileNetV2Config()
    meta = block_meta(cfg)
    params = init_mobilenetv2(SEED, cfg)
    x0 = images[:BATCH]
    xt = torch.from_numpy(x0).to(dev)
    fp32 = Engine.fp32(mobilenetv2_forward, params, cfg, batch=BATCH, device=dev,
                       name="mobilenetv2_fp32")
    ref_logits = fp32(x0).float().cpu().numpy()
    del fp32
    calib = [np.random.default_rng(MNV2_CALIB_SEED).normal(0, 1, (8, 224, 224, 3))
             .astype(np.float32)]
    t0 = time.perf_counter()
    qf = make_qforward(meta)
    eng_q = Engine.quantized(qf, fold_mobilenetv2(params), cfg, INT8_PER_CHANNEL,
                             calib_batches=calib, batch=BATCH, device=dev)
    out = {}
    blocks = [f"block{i}" for i in range(len(meta))]
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, "mobilenetv2", eng_q.qflat, eng_q.act_scales, INT8_PER_CHANNEL,
                       meta={"config": {"num_classes": cfg.num_classes, "small_input": False}})
        del eng_q
        eng = Engine.from_store(tmp, ctx="deploy", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0

        # ---- main_path_mnv2_deploy ----
        path = "mnv2_deploy"
        preds, counts, shapes, forms = _mnv2_drive(eng, images, path, "mobilenetv2 deploy")
        logits, taps = _taps(eng, x0, cfg, qf)
        if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
            raise AssertionError("mobilenetv2 deploy: classify and the taps forward disagree")
        # random-weight logits: top-1 is reported beside the margins, not gated
        agree, cos = gate(logits, ref_logits, "mobilenetv2 deploy vs fp32", MNV2_DEPLOY_FP32_COS,
                          top1=False)
        plain = plain_equivalence(eng, x0, cfg, qf, logits, taps, (*blocks, "gap"),
                                  "mobilenetv2 deploy")
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        repeat_forward(path, lambda: eng._fn(eng.params, xt))
        emit({"phase": "main_path_mnv2_deploy", "model": "mobilenetv2", "width_mult": 1.0,
              "size": 224, "batch": BATCH, "batches": NB,
              "img_per_s_classify": eng.stats.images_per_sec, "ms_per_batch": ms,
              "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
              "launches_per_forward": {k: v / NB for k, v in counts.items()},
              "top1_agreement_vs_fp32": agree, "logits_cosine_vs_fp32": cos,
              "cosine_gate": MNV2_DEPLOY_FP32_COS, "top1_gated": False,
              "top1_vs_fp32": top1_report(logits, ref_logits),
              "max_abs_vs_plain_versions": plain, "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, "mobilenetv2_deploy")
        out[path] = (counts, shapes, forms)
        del eng, taps
        mnv2_dynamic_gate(dev, card, tmp, x0[:MNV2_DYNAMIC_BATCH],
                          ref_logits[:MNV2_DYNAMIC_BATCH])

        # ---- mnv2_fused2: make_qforward_fused under FullFusedCtx, same store ----
        qflat, scales, qcfg, _ = load_quantized(tmp)
        ctx = FullFusedCtx(to_device(qflat, dev), to_device(scales, dev), qcfg)
    qff = make_qforward_fused(meta)
    eng2 = Engine(lambda c, x: qff(c, x, cfg), ctx, batch=BATCH, device=dev,
                  name="mobilenetv2_fused2")
    path = "mnv2_fused2"
    preds2, counts2, shapes2, forms2 = _mnv2_drive(eng2, images, path, "mobilenetv2 fused2",
                                                   fused2=True)
    logits2, taps2 = _taps(eng2, x0, cfg, qff)
    if not np.array_equal(preds2[:BATCH], logits2.argmax(-1)):
        raise AssertionError("mobilenetv2 fused2: classify and the taps forward disagree")
    agree2, cos2 = gate(logits2, logits, "mobilenetv2 fused2 vs deploy", MNV2_FUSED2_DEPLOY_COS,
                        top1=False)
    cos2_fp32 = numerics.diff(logits2, ref_logits).cosine
    plain2 = plain_equivalence(eng2, x0, cfg, qff, logits2, taps2, blocks, "mobilenetv2 fused2")
    ms2 = time_ms(lambda: eng2._fn(eng2.params, xt), iters=10)
    repeat_forward(path, lambda: eng2._fn(eng2.params, xt))
    emit({"phase": "mnv2_fused2", "model": "mobilenetv2", "width_mult": 1.0, "size": 224,
          "batch": BATCH, "batches": NB, "img_per_s_classify": eng2.stats.images_per_sec,
          "ms_per_batch": ms2, "img_per_s_device": BATCH / (ms2 / 1e3), "launches": counts2,
          "launches_per_forward": {k: v / NB for k, v in counts2.items()},
          "top1_agreement_vs_deploy": agree2, "logits_cosine_vs_deploy": cos2,
          "cosine_gate": MNV2_FUSED2_DEPLOY_COS, "logits_cosine_vs_fp32": cos2_fp32,
          "top1_vs_deploy": top1_report(logits2, logits),
          "int8_block_taps_equal_plain_versions": True,
          "max_abs_vs_plain_versions": plain2, "card": card})
    profile_forward(eng2, xt, "mobilenetv2_fused2")
    out[path] = (counts2, shapes2, forms2)
    del eng2, ctx
    torch.cuda.empty_cache()
    return out


def mnv2_dynamic_gate(dev, card, store, x, ref_logits):
    """MobileNetV2 Engine.from_store(ctx="dynamic") on the deploy path's
    store, a gate at batch MNV2_DYNAMIC_BATCH: K1 1, K2 35, K23 17 a
    forward, every K23 launch on its Hopper form; cosine against the fp32
    forward (MNV2_DYNAMIC_FP32_COS); bit-identical to its plain-version
    twin; one forward under set_sync_debug_mode("error")."""
    from dlq_tpu_torch.engine import Engine

    eng = Engine.from_store(store, ctx="dynamic", batch=len(x), device=dev)
    eng(x)                                         # warm (first launches)
    reset_counts()
    logits = eng(x).float().cpu().numpy()
    counts = read_counts()[0]
    forms = read_forms()
    expect_counts(counts, "mnv2_dynamic", 1, "mobilenetv2 dynamic")
    agree, cos = gate(logits, ref_logits, "mobilenetv2 dynamic vs fp32", MNV2_DYNAMIC_FP32_COS,
                      top1=False)
    lp = plain_twin(eng, x, "mobilenetv2 dynamic")
    if not np.array_equal(lp, logits):
        raise AssertionError(f"mobilenetv2 dynamic: kernels vs plain versions differ "
                             f"{float(np.abs(lp - logits).max())}")
    sync_out = no_sync_forward(eng, torch.from_numpy(x).to(dev))
    if not np.array_equal(sync_out.float().cpu().numpy(), logits):
        raise AssertionError("mobilenetv2 dynamic: the forward under sync debug mode differs")
    emit({"phase": "mnv2_dynamic", "model": "mobilenetv2", "width_mult": 1.0, "size": 224,
          "batch": len(x), "launches": counts,
          "launches_by_form": {k: forms[k] for k in ("conv_int8", "matmul_int8",
                                                     "depthwise_int8")},
          "logits_cosine_vs_fp32": cos, "cosine_gate": MNV2_DYNAMIC_FP32_COS,
          "top1_agreement_vs_fp32": agree, "top1_gated": False,
          "logits_equal_plain_versions": True, "sync_debug_mode": "error, no synchronizing call",
          "card": card})
    del eng


def mnist_paths(dev, card):
    """LeNet-5 and the MLP (seed-0 weights from the registry's builders):
    calibrated on 8 images and quantized by Engine.quantized,
    INT8_PER_CHANNEL, saved with save_quantized, then served by
    Engine.from_store under ctx="deploy" and "dynamic" at batch 256 (28 x 28
    x 1 images; the MLP's as 784-wide rows): driven through classify
    (LeNet-5: K1 2, K2 3 a forward; the MLP: K2 2; per shape, and per form
    as MNIST_FORMS), gated against the fp32 forward (MNIST_FP32_COS) and
    bit-identical to the plain-version twin, the dynamic forward under
    set_sync_debug_mode("error"), timed, repeated SPLIT_REPEATS times and
    profiled. Returns {path: (counts, shapes)}."""
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models import get_model, lenet, mlp
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import save_quantized

    imgs = np.random.default_rng(MNIST_SEED).normal(0, 1, (NB * BATCH, 28, 28, 1)).astype(
        np.float32)
    calib = np.random.default_rng(MNIST_CALIB_SEED).normal(0, 1, (8, 28, 28, 1)).astype(
        np.float32)
    out = {}
    for model, tag, mod in (("lenet5", "lenet", lenet), ("mlp", "mlp", mlp)):
        cfg, init, forward = get_model(model)
        params = init(SEED, cfg)
        xs, cs = (imgs, calib) if model == "lenet5" else (imgs.reshape(len(imgs), -1),
                                                          calib.reshape(len(calib), -1))
        x0 = xs[:BATCH]
        xt = torch.from_numpy(x0).to(dev)
        ref = Engine.fp32(forward, params, cfg, batch=BATCH, device=dev)(x0).float().cpu().numpy()
        q = Engine.quantized(mod.qforward, mod.flatten_params(params), cfg, INT8_PER_CHANNEL,
                             calib_batches=[cs], batch=BATCH, device=dev)
        meta = {"config": {"num_classes": cfg.num_classes, "in_channels": cfg.in_channels}} \
            if model == "lenet5" else {}
        with tempfile.TemporaryDirectory() as tmp:
            save_quantized(tmp, model, q.qflat, q.act_scales, INT8_PER_CHANNEL, meta=meta)
            del q
            for ctx in ("deploy", "dynamic"):
                path, what = f"{tag}_{ctx}", f"{model} {ctx}"
                eng = Engine.from_store(tmp, ctx=ctx, batch=BATCH, device=dev)
                preds, counts, shapes = drive(eng, xs, path, what)
                forms = {k: v for k, v in read_forms().items() if k in ("conv_int8", "matmul_int8")}
                if forms != {k: {f: v * NB for f, v in by.items()}
                             for k, by in MNIST_FORMS[tag].items()}:
                    raise AssertionError(f"{what}: launches by form {forms}, expected "
                                         f"{MNIST_FORMS[tag]} a forward")
                logits = eng(x0).float().cpu().numpy()
                if not np.array_equal(preds[:BATCH], logits.argmax(-1)):
                    raise AssertionError(f"{what}: classify and the forward disagree")
                agree, cos = gate(logits, ref, f"{what} vs fp32", MNIST_FP32_COS, top1=False)
                lp = plain_twin(eng, x0, what)
                if not np.array_equal(lp, logits):
                    raise AssertionError(f"{what}: kernels vs plain versions differ "
                                         f"{float(np.abs(lp - logits).max())}")
                if ctx == "dynamic":
                    sync_out = no_sync_forward(eng, xt)
                    if not np.array_equal(sync_out.float().cpu().numpy(), logits):
                        raise AssertionError(f"{what}: the forward under sync debug mode "
                                             "differs")
                ms = time_ms(lambda: eng._fn(eng.params, xt), iters=20)
                repeat_forward(path, lambda: eng._fn(eng.params, xt))
                emit({"phase": f"main_path_{path}", "model": model, "ctx": ctx,
                      "input": list(x0.shape[1:]), "batch": BATCH, "batches": NB,
                      "img_per_s_classify": eng.stats.images_per_sec, "ms_per_batch": ms,
                      "img_per_s_device": BATCH / (ms / 1e3), "launches": counts,
                      "launches_per_forward": {k: v / NB for k, v in counts.items()},
                      "launches_by_form": forms,
                      "logits_cosine_vs_fp32": cos, "cosine_gate": MNIST_FP32_COS,
                      "top1_agreement_vs_fp32": agree, "top1_gated": False,
                      "logits_equal_plain_versions": True,
                      "sync_debug_mode": "error, no synchronizing call" if ctx == "dynamic"
                      else None, "card": card})
                profile_forward(eng, xt, f"{model}_{ctx}")
                out[path] = (counts, shapes)
                del eng
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
        repeat_forward("deit_block", lambda: eng._fn(eng.params, xt))
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
            if name == "deploy":
                repeat_forward("deit_deploy", lambda: e._fn(e.params, xt[:64]))
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
    from dlq_tpu_torch.ops import vit_block
    from dlq_tpu_torch.ops.int8_attention import mhsa_i8, mhsa_i8_first, mhsa_i8_plain
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
    # the two block engines in turns, the int8 one also on K18's first form:
    # bf16 attention, int8, int8 first form, int8 first form, int8, bf16
    ab = {}
    for tag, e in (("bf16_attention", eng_block), ("int8_attention", eng),
                   ("int8_attention_first_form", eng), ("int8_attention_first_form", eng),
                   ("int8_attention", eng), ("bf16_attention", eng_block)):
        with first_form(vit_block, "mhsa_i8", mhsa_i8_first, tag.endswith("first_form")):
            ab.setdefault(tag, []).append(time_ms(lambda: e._fn(e.params, xt), iters=10))
    ms = min(ab["int8_attention"])
    repeat_forward("deit_block_attn_int8", lambda: eng._fn(eng.params, xt))
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
    with first_form(vit_block, "mhsa_i8", mhsa_i8_first):
        profile_forward(eng, xt, "deit_tiny_block_attn_int8_first_form")
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
    xt64 = torch.from_numpy(xb).to(dev)
    with torch.inference_mode():
        fused = vit_forward_blockfused_w8(loose, xt64, cfg).float()
    if not np.array_equal(split["bf16"], fused.cpu().numpy()):
        raise AssertionError("deit_tiny split bf16 arm: logits differ from vit_forward_blockfused_w8")
    # both forwards again, SPLIT_REPEATS times each: a kernel that races
    # (K5's y stages did: now and then one token row) differs in some run
    with torch.inference_mode():
        differ = {"split": repeat_differing(lambda: vit_forward_blockfused_w8_split(
                      loose, xt64, cfg, attn="bf16").float(), fused, SPLIT_REPEATS),
                  "fused": repeat_differing(lambda: vit_forward_blockfused_w8(
                      loose, xt64, cfg).float(), fused, SPLIT_REPEATS)}
    if any(differ.values()):
        raise AssertionError(f"deit_tiny split bf16 / blockfused_w8: runs differing from the first "
                             f"of {SPLIT_REPEATS} each: {differ}")
    emit({"phase": "deit_split_bf16_vs_blockfused_w8", "logits_bit_identical": True,
          "repeats": SPLIT_REPEATS, "runs_differing": differ})
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
    repeat_forward("deit_deploy_xla_int8", lambda: e._fn(e.params, xt[:TOTALS_BATCH]))
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
        repeat_forward("deit_block_w4a8", lambda: eng._fn(eng.params, xt))
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
            repeat_forward(path, lambda: e._fn(e.params, xt[:TOTALS_BATCH]))
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
        repeat_forward("deit_block_w4", lambda: eng._fn(eng.params, xt))
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
        repeat_forward("deit_deploy_g128", lambda: e._fn(e.params, xt[:TOTALS_BATCH]))
        del e
    torch.cuda.empty_cache()
    return out


def deit_bf16_paths(dev, card, d, act_scales, images):
    """DeiT-Tiny bf16 and the fused LayerNorms on the same fp32 weights:
    vit_forward_blockfused on pack_vit_blocks (K14, K6, K15 per layer, bf16
    between layers) through Engine.fp32 and classify at batch 256, loose
    pads (the reference's default) then tight, each timed and profiled; the
    fp32 forward with fused_ln=True, attn_impl="fused" at batch 64, then
    timed and profiled at batch 256 in turns with mhsa_f32's first form; the W8A8
    deploy forward with fused_ln=True at batch 64, on the W8A8 store's act
    scales (the same quantized model as the unfused deploy forward). Returns
    {path: (counts, shapes)}."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.vit import flatten_vit, make_qforward, vit_extras, vit_forward
    from dlq_tpu_torch.ops import attention
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
        repeat_forward(path, lambda: eng._fn(eng.params, xt))
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
    # the same forward at batch 256, in turns with itself on mhsa_f32's first
    # form (Hopper, first, first, Hopper), each profiled
    e = Engine.fp32(vit_forward, params, cfg_ln, batch=BATCH, device=dev,
                    name="deit_tiny_fused_ln")
    turns = {}
    for tag in ("hopper", "first_form", "first_form", "hopper"):
        with first_form(attention, "mhsa_f32", attention.mhsa_f32_first, tag == "first_form"):
            turns.setdefault(tag, []).append(time_ms(lambda: e._fn(e.params, xt), iters=5))
    emit({"phase": "deit_fused_ln_fp32_timed", "model": "deit_tiny", "batch": BATCH,
          "ms_per_batch_in_turns": turns, "ms_per_batch": min(turns["hopper"]),
          "first_form_ms_per_batch": min(turns["first_form"]), "card": card})
    profile_forward(e, xt, "deit_tiny_fused_ln_fp32")
    with first_form(attention, "mhsa_f32", attention.mhsa_f32_first):
        profile_forward(e, xt, "deit_tiny_fused_ln_fp32_first_form")
    del e

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
            repeat_forward("deit_deploy_fused_ln", lambda: e._fn(e.params, xt[:TOTALS_BATCH]))
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
# phase 10d: the PTQ toolbox (ptq)
# ---------------------------------------------------------------------------

def ptq_expect(counts, key, what, hopper_k12=False):
    """One forward's launches against PTQ_PER_FORWARD[key] (key may be a
    dict of launches itself); every K5, K8, K9 launch (and with
    ``hopper_k12`` every K1 and K2 launch) on its Hopper form. Returns the
    launches by form."""
    want = PTQ_PER_FORWARD[key] if isinstance(key, str) else key
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    forms = read_forms()
    for k, by in forms.items():
        if k in ("conv_int8", "matmul_int8") and not hopper_k12:
            continue
        if by.get("first") or by.get("hopper", 0) != counts[k]:
            raise AssertionError(f"{what}: {k} launches by form {by}, expected all {counts[k]} "
                                 "on the Hopper form")
    return {k: v for k, v in forms.items() if v}


def ptq_forward(fn, key, what, hopper_k12=False):
    """``fn()`` once with every count set to 0 just before and read just
    after: (fp32 logits on the host, launches, launches by form)."""
    reset_counts()
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    counts = read_counts()[0]
    return out.float().cpu().numpy(), counts, ptq_expect(counts, key, what, hopper_k12)


def _codes(qw) -> np.ndarray:
    """A QTensor's integer codes, int8 [K, O] on the host."""
    from dlq_tpu_torch.quant.quantize import unpack_int4

    q = unpack_int4(qw.values, tuple(qw.shape)) if qw.bits == 4 else qw.values
    return q.cpu().numpy().reshape(-1, q.shape[-1])


def _gptq_objective(w: torch.Tensor, qw, H: np.ndarray) -> float:
    """GPTQ's objective ``tr(dW^T H dW)`` (float64, host) of codes ``qw`` for
    the fp32 weight ``w``, rows in the Hessian's IHW order for a conv."""
    from dlq_tpu_torch.quant.quantize import dequantize

    w64 = w.cpu().numpy().astype(np.float64)
    dw = w64 - dequantize(qw).cpu().numpy().astype(np.float64).reshape(qw.layout_shape)
    if dw.ndim == 4:
        dw = dw.transpose(2, 0, 1, 3)
    dw = dw.reshape(-1, dw.shape[-1])
    return float(np.einsum("ko,ko->", dw, H @ dw))


def ptq_r18(dev, card, x0, tmp):
    """(a) ResNet-18 at 224 px: the card's Hessians and GPTQ timed, its GPTQ
    codes against the port's on the CPU, RTN / GPTQ / GPTQ + bias
    correction stores by ptq_auto(smooth="off") served under deploy and
    fused2 from save_quantized -> from_store, gated against fp32. Returns
    what (d), (e) and (f) reuse."""
    from dlq_tpu_torch.engine import Engine, to_device
    from dlq_tpu_torch.models.resnet import (
        ResNetConfig, flatten_folded, fold_resnet, folded_forward, init_resnet, qforward,
    )
    from dlq_tpu_torch.quant.gptq import collect_hessians, gptq_quantize_weights
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.recipe import ptq_auto
    from dlq_tpu_torch.quant.store import save_quantized

    cfg = ResNetConfig(depth=18, num_classes=1000)
    folded = fold_resnet(init_resnet(SEED, cfg), cfg)
    flat_cpu = flatten_folded(folded)
    flat = to_device(flat_cpu, dev)
    calib = [np.random.default_rng(SEED + 18).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)]
    ref = Engine.fp32(folded_forward, folded, cfg, batch=BATCH, device=dev)(x0).float().cpu().numpy()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = collect_hessians(qforward, flat, cfg, calib)
    torch.cuda.synchronize()
    hess_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_card = gptq_quantize_weights(flat, INT8_PER_CHANNEL, col)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    col_cpu = collect_hessians(qforward, flat_cpu, cfg, calib)
    hess_cpu_s = time.perf_counter() - t0
    q_cpu = gptq_quantize_weights(flat_cpu, INT8_PER_CHANNEL, col_cpu)
    differ = {s: int((_codes(q_card[s]["qw"]) != _codes(q_cpu[s]["qw"])).sum()) for s in q_cpu}
    total = sum(_codes(q_cpu[s]["qw"]).size for s in q_cpu)
    share = sum(differ.values()) / total
    # GPTQ's objective, tr(dW^T H dW) on the CPU's Hessian, of either codes
    obj = {s: (_gptq_objective(flat_cpu[s]["w"], q_card[s]["qw"], col_cpu.H[s]),
               _gptq_objective(flat_cpu[s]["w"], q_cpu[s]["qw"], col_cpu.H[s])) for s in q_cpu}
    obj_rel = max(abs(a - b) / b for a, b in obj.values())
    emit({"phase": "ptq_r18_gptq", "model": "resnet18", "size": 224, "calibration_images": 8,
          "sites": len(col.H), "hessians_s": hess_s, "gptq_s": gptq_s,
          "hessians_cpu_s": hess_cpu_s, "gptq_codes_differing_card_vs_cpu": sum(differ.values()),
          "gptq_codes": total, "gptq_code_share_differing": share,
          "gptq_code_share_by_site": {s: d / _codes(q_cpu[s]["qw"]).size
                                      for s, d in differ.items()},
          "gate_share": PTQ_GPTQ_CODE_SHARE, "gptq_objective_rel_diff_max": obj_rel,
          "gate_objective": PTQ_GPTQ_OBJECTIVE_REL, "card": card})
    if share > PTQ_GPTQ_CODE_SHARE or obj_rel > PTQ_GPTQ_OBJECTIVE_REL:
        raise AssertionError(f"resnet18 GPTQ: {share} of the codes differ between the card's "
                             f"Hessians and the CPU's (gate {PTQ_GPTQ_CODE_SHARE}), objective "
                             f"{obj_rel} apart (gate {PTQ_GPTQ_OBJECTIVE_REL})")
    del q_card, q_cpu, col_cpu, flat_cpu

    xt = torch.from_numpy(x0).to(dev)
    stores, fused2_eng = {}, None
    for name, kw in (("rtn", dict(gptq=False, bias_correct=False)),
                     ("gptq", dict(bias_correct=False)), ("gptq_bc", {})):
        t0 = time.perf_counter()
        qflat, scales, sm = ptq_auto(qforward, flat, cfg, calib, INT8_PER_CHANNEL, smooth="off",
                                     **kw)
        torch.cuda.synchronize()
        ptq_s = time.perf_counter() - t0
        if sm:
            raise AssertionError(f"ptq_auto(smooth='off') returned vectors for {sorted(sm)}")
        root = f"{tmp}/r18_{name}"
        save_quantized(root, "resnet18", qflat, scales, INT8_PER_CHANNEL,
                       meta={"config": {"num_classes": 1000, "small_input": False}})
        stores[name] = (root, qflat, scales)
        for ctx in ("deploy", "fused2"):
            path = f"ptq_r18_{name}_{ctx}"
            eng = Engine.from_store(root, ctx=ctx, batch=BATCH, device=dev)
            logits, counts, forms = ptq_forward(lambda: eng._fn(eng.params, xt), f"r18_{ctx}",
                                                path, hopper_k12=ctx == "fused2")
            agree, cos = gate(logits, ref, f"{path} vs fp32", PTQ_R18_FP32_COS[name], top1=False)
            ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
            repeat_forward(path, lambda: eng._fn(eng.params, xt))
            emit({"phase": path, "model": "resnet18", "rounding": name, "ctx": ctx,
                  "batch": BATCH, "ptq_auto_s": ptq_s, "launches": counts,
                  "launches_by_form": forms, "logits_cosine_vs_fp32": cos,
                  "cosine_gate": PTQ_R18_FP32_COS[name], "top1_agreement_vs_fp32": agree,
                  "ms_per_batch": ms, "card": card})
            if name == "rtn" and ctx == "fused2":
                fused2_eng = eng
            else:
                del eng
    return {"cfg": cfg, "flat": flat, "col": col, "ref": ref, "stores": stores,
            "fused2": fused2_eng}


def ptq_mixed(dev, card, r18, x0, tmp):
    """(d) auto_mixed_qconfig over (a)'s collector at INT4A8_PER_CHANNEL, a
    weight-byte budget halfway between all-int4 and all-int8, served under
    deploy from a store; launches by kernel from the wrapper counters."""
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.quant.model_quant import quantize_weights
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL
    from dlq_tpu_torch.quant.quantize import effective_weight_scheme
    from dlq_tpu_torch.quant.sensitivity import _stored_bytes, auto_mixed_qconfig
    from dlq_tpu_torch.quant.store import save_quantized

    flat, cfg = r18["flat"], r18["cfg"]
    lo = sum(_stored_bytes(p["w"].numel(), effective_weight_scheme(
        tuple(p["w"].shape), INT4A8_PER_CHANNEL.scheme_for(s))) for s, p in flat.items())
    hi = sum(p["w"].numel() for p in flat.values())
    budget = (lo + hi) // 2
    t0 = time.perf_counter()
    mixed = auto_mixed_qconfig(flat, r18["col"], INT4A8_PER_CHANNEL, budget_bytes=budget)
    mixed_s = time.perf_counter() - t0
    qflat = quantize_weights(flat, mixed)
    stored = sum(_stored_bytes(p["w"].numel(), effective_weight_scheme(
        tuple(p["w"].shape), mixed.scheme_for(s))) for s, p in flat.items())
    if not lo < stored <= budget:
        raise AssertionError(f"mixed precision: {stored} weight bytes, budget {budget}, "
                             f"all-int4 {lo}")
    root = f"{tmp}/r18_mixed"
    save_quantized(root, "resnet18", qflat, r18["stores"]["rtn"][2], mixed,
                   meta={"config": {"num_classes": 1000, "small_input": False}})
    eng = Engine.from_store(root, ctx="deploy", batch=BATCH, device=dev)
    fc4 = eng.params.qflat["fc"]["qw"].bits == 4
    want = _per(conv_int8=20, **({"matmul_int4a8": 1} if fc4 else {"matmul_int8": 1}))
    xt = torch.from_numpy(x0).to(dev)
    logits, counts, forms = ptq_forward(lambda: eng._fn(eng.params, xt), want, "ptq_mixed_deploy")
    agree, cos = gate(logits, r18["ref"], "ptq_mixed_deploy vs fp32", PTQ_MIXED_FP32_COS,
                      top1=False)
    repeat_forward("ptq_mixed_deploy", lambda: eng._fn(eng.params, xt))
    emit({"phase": "ptq_mixed_deploy", "model": "resnet18", "batch": BATCH,
          "base": "INT4A8_PER_CHANNEL", "budget_bytes": budget, "all_int4_bytes": lo,
          "all_int8_bytes": hi, "stored_bytes": stored, "auto_mixed_qconfig_s": mixed_s,
          "int8_sites": [s for s, _ in mixed.weight_overrides],
          "int4_sites": sorted(s for s, p in eng.params.qflat.items() if p["qw"].bits == 4),
          "launches": {k: v for k, v in counts.items() if v}, "launches_by_form": forms,
          "logits_cosine_vs_fp32": cos, "cosine_gate": PTQ_MIXED_FP32_COS,
          "top1_agreement_vs_fp32": agree, "card": card})


def ptq_qat(dev, card, r18, images):
    """(c) three make_qat_step steps on ResNet-18 at 224 px, batch 32,
    INT4A8_PER_CHANNEL, lr PTQ_QAT_LR, each timed with CUDA events; loss finite, params
    moved; QATCtx against DeployCtx(quantize_weights(trained)) on K1 / K10."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.models.resnet import qforward
    from dlq_tpu_torch.quant.calibrate import calibrate
    from dlq_tpu_torch.quant.model_quant import DeployCtx, make_sites_fn, quantize_weights
    from dlq_tpu_torch.quant.qat import QATCtx, make_qat_step
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL

    cfg, flat = r18["cfg"], r18["flat"]
    qcfg = INT4A8_PER_CHANNEL
    x = torch.from_numpy(images[:PTQ_QAT_BATCH]).to(dev)
    y = torch.from_numpy(np.random.default_rng(PTQ_QAT_LABEL_SEED).integers(
        0, 1000, PTQ_QAT_BATCH)).to(dev)
    scales = calibrate(make_sites_fn(qforward, cfg), flat, [x], qcfg)
    step = make_qat_step(qforward, cfg, qcfg, lr=PTQ_QAT_LR)
    vel = {s: {k: torch.zeros_like(v) for k, v in p.items() if v is not None}
           for s, p in flat.items()}
    f, ms, losses = flat, [], []
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        f, vel, scales, loss, acc = step(f, vel, scales, x, y)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        losses.append(float(loss))
    moved = sum(not torch.equal(f[s]["w"], flat[s]["w"]) for s in flat)
    if not all(np.isfinite(losses)) or moved != len(flat):
        raise AssertionError(f"qat: losses {losses}, {moved} of {len(flat)} sites moved")
    with torch.inference_mode():
        sim = qforward(QATCtx(f, scales, qcfg), x, cfg).float().cpu().numpy()
    dctx = DeployCtx(quantize_weights(f, qcfg), scales, qcfg)
    dep, counts, forms = ptq_forward(lambda: qforward(dctx, x, cfg), "qat_deploy",
                                     "ptq_qat_deploy")
    cos = numerics.diff(dep, sim).cosine
    if cos <= PTQ_QAT_PARITY_COS:
        raise AssertionError(f"qat deploy parity: cosine {cos} (need > {PTQ_QAT_PARITY_COS})")
    repeat_forward("ptq_qat_deploy", lambda: qforward(dctx, x, cfg))
    emit({"phase": "ptq_qat", "model": "resnet18", "size": 224, "batch": PTQ_QAT_BATCH,
          "scheme": "INT4A8_PER_CHANNEL", "steps": 3, "ms_per_step": ms, "losses": losses,
          "sites_moved": moved, "deploy_launches": {k: v for k, v in counts.items() if v},
          "deploy_launches_by_form": forms, "deploy_vs_qatctx_cosine": cos,
          "cosine_gate": PTQ_QAT_PARITY_COS,
          "deploy_vs_qatctx_top1": numerics.top1_agreement(dep, sim), "card": card})


def ptq_deit(dev, card, x0, tmp):
    """(b) DeiT-Tiny W8A8 by ptq_auto(smooth="auto",
    smooth_site_filter=VIT_LN_FOLDABLE) on two calibration batches, the
    vectors folded into the LN affines, saved, served by
    from_store(ctx="block") on K5 -> K6 -> K7 and gated against the sitewise
    SmoothDeployCtx forward on K2 and against fp32; the same smoothed
    weights at INT4A8 through pack_vit_blocks_w4a8(smooth=) on K8 -> K6 ->
    K9 against their sitewise forward on K10. Returns the block store."""
    from dlq_tpu_torch.engine import Engine, to_device
    from dlq_tpu_torch.models.vit import (
        ViTConfig, flatten_vit, init_vit, make_qforward, vit_extras, vit_forward,
    )
    from dlq_tpu_torch.ops.vit_block import pack_vit_blocks_w4a8, vit_forward_blockfused_w4a8c
    from dlq_tpu_torch.quant.model_quant import quantize_weights
    from dlq_tpu_torch.quant.qconfig import INT4A8_PER_CHANNEL, INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.recipe import VIT_LN_FOLDABLE, ptq_auto
    from dlq_tpu_torch.quant.smooth import (
        SmoothDeployCtx, apply_smooth, fold_smooth_into_ln_extras, search_smooth_alpha,
    )
    from dlq_tpu_torch.quant.store import save_quantized

    cfg = ViTConfig()
    params = to_device(init_vit(SEED, cfg), dev)
    flat, ex = flatten_vit(params), vit_extras(params)
    qf = make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim)
    qf_site = make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim, attn_impl="fused",
                            gelu="tanh")
    calib = [np.random.default_rng(s).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
             for s in PTQ_DEIT_CALIB_SEEDS]
    xt = torch.from_numpy(x0).to(dev)
    xs = xt[:PTQ_SITEWISE_BATCH]
    with torch.inference_mode():
        ref = vit_forward(params, xt, ViTConfig(gelu="tanh")).cpu().numpy()
    t0 = time.perf_counter()
    sm_search, alpha = search_smooth_alpha(qf, flat, cfg, calib, INT8_PER_CHANNEL,
                                           site_filter=VIT_LN_FOLDABLE)
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qflat, scales, sm = ptq_auto(qf, flat, cfg, calib, INT8_PER_CHANNEL,
                                 smooth_site_filter=VIT_LN_FOLDABLE)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    if set(sm) != set(sm_search) or not all(np.array_equal(sm[k], sm_search[k]) for k in sm):
        raise AssertionError("deit ptq_auto: its vectors are not search_smooth_alpha's")
    if not all(VIT_LN_FOLDABLE(k) for k in sm):
        raise AssertionError(f"deit ptq_auto: vectors for {sorted(sm)}")
    root = f"{tmp}/deit_auto"
    save_quantized(root, "deit_tiny", qflat, scales, INT8_PER_CHANNEL,
                   extras=fold_smooth_into_ln_extras(ex, sm),
                   meta={"config": {k: getattr(cfg, k) for k in (
                       "num_classes", "image_size", "patch", "dim", "depth", "heads",
                       "mlp_ratio")}, "smooth_sites": sorted(sm)})
    eng = Engine.from_store(root, ctx="block", batch=BATCH, device=dev)
    blk, counts, forms = ptq_forward(lambda: eng._fn(eng.params, xt), "deit_block",
                                     "ptq_deit_block")
    sctx = SmoothDeployCtx(qflat, scales, INT8_PER_CHANNEL, sm)
    site, c_site, f_site = ptq_forward(lambda: qf_site(sctx, xs, cfg), "deit_sitewise",
                                       "ptq_deit_sitewise", hopper_k12=True)
    _, cos_twin = gate(blk[:PTQ_SITEWISE_BATCH], site, "ptq_deit_block vs sitewise",
                       PTQ_DEIT_TWIN_COS, top1=False)
    agree, cos = gate(blk, ref, "ptq_deit_block vs fp32", PTQ_DEIT_FP32_COS, top1=False)
    ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
    repeat_forward("ptq_deit_block", lambda: eng._fn(eng.params, xt))
    repeat_forward("ptq_deit_sitewise", lambda: qf_site(sctx, xs, cfg))
    emit({"phase": "ptq_deit_block", "model": "deit_tiny", "scheme": "INT8_PER_CHANNEL",
          "batch": BATCH, "alpha": alpha, "smooth_sites": len(sm),
          "search_smooth_alpha_s": search_s, "ptq_auto_s": ptq_s, "launches": counts,
          "launches_by_form": forms, "sitewise_batch": PTQ_SITEWISE_BATCH,
          "sitewise_launches": {k: v for k, v in c_site.items() if v},
          "sitewise_launches_by_form": f_site, "logits_cosine_vs_sitewise": cos_twin,
          "twin_gate": PTQ_DEIT_TWIN_COS, "logits_cosine_vs_fp32": cos,
          "cosine_gate": PTQ_DEIT_FP32_COS, "top1_agreement_vs_fp32": agree,
          "ms_per_batch": ms, "card": card})

    q4 = quantize_weights(apply_smooth(flat, sm), INT4A8_PER_CHANNEL)
    pack4 = pack_vit_blocks_w4a8(q4, scales, ex, cfg, tight=True, smooth=sm)
    blk4, c4, f4 = ptq_forward(lambda: vit_forward_blockfused_w4a8c(pack4, xt, cfg, tight=True),
                               "deit_w4a8_block", "ptq_deit_w4a8_block")
    sctx4 = SmoothDeployCtx(q4, scales, INT4A8_PER_CHANNEL, sm)
    site4, cs4, fs4 = ptq_forward(lambda: qf_site(sctx4, xs, cfg), "deit_w4a8_sitewise",
                                  "ptq_deit_w4a8_sitewise")
    _, cos_twin4 = gate(blk4[:PTQ_SITEWISE_BATCH], site4, "ptq_deit_w4a8_block vs sitewise",
                        PTQ_DEIT_W4A8_TWIN_COS, top1=False)
    agree4, cos4 = gate(blk4, ref, "ptq_deit_w4a8_block vs fp32", DEIT_W4A8_FP32_COS,
                        top1=False)
    repeat_forward("ptq_deit_w4a8_block",
                   lambda: vit_forward_blockfused_w4a8c(pack4, xt, cfg, tight=True))
    repeat_forward("ptq_deit_w4a8_sitewise", lambda: qf_site(sctx4, xs, cfg))
    emit({"phase": "ptq_deit_w4a8_block", "model": "deit_tiny", "scheme": "INT4A8_PER_CHANNEL",
          "batch": BATCH, "launches": c4, "launches_by_form": f4,
          "sitewise_launches": {k: v for k, v in cs4.items() if v},
          "sitewise_launches_by_form": fs4, "logits_cosine_vs_sitewise": cos_twin4,
          "twin_gate": PTQ_DEIT_W4A8_TWIN_COS, "logits_cosine_vs_fp32": cos4,
          "cosine_gate": DEIT_W4A8_FP32_COS, "top1_agreement_vs_fp32": agree4, "card": card})
    return {"root": root, "block": eng}


def ptq_uint8(dev, card, r18, deit):
    """(e) uint8 ingest: ResNet-18 fused2 on uint8 images against the
    normalized fp32 images, and the two stems' int8 codes; DeiT's block
    engine on uint8 against normalized input."""
    from dlq_tpu_torch import numerics
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.preprocess import IMAGENET_MEAN, IMAGENET_STD

    u8 = np.random.default_rng(PTQ_U8_SEED).integers(0, 256, (BATCH, 224, 224, 3)).astype(np.uint8)
    xn = ((u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    ut, nt = torch.from_numpy(u8).to(dev), torch.from_numpy(xn).to(dev)
    f2 = r18["fused2"]
    eng = Engine.from_store(r18["stores"]["rtn"][0], ctx="fused2", batch=BATCH, device=dev,
                            input_dtype=torch.uint8)
    got, counts, forms = ptq_forward(lambda: eng._fn(eng.params, ut), "r18_fused2",
                                     "ptq_r18_u8_fused2", hopper_k12=True)
    with torch.inference_mode():
        norm = f2._fn(f2.params, nt).float().cpu().numpy()
        a = f2.params.conv_stem_bf16("stem", nt, out_site="layer1.0.conv1").q
        b = f2.params.conv_stem_bf16_u8("stem", ut, out_site="layer1.0.conv1").q
        equal = float((a == b).float().mean())
        worst = int((a.int() - b.int()).abs().max())
    agree, cos = gate(got, norm, "ptq_r18_u8_fused2 vs normalized fp32", PTQ_U8_COS, top1=True)
    if equal <= PTQ_U8_STEM_EQUAL or worst > 1:
        raise AssertionError(f"uint8 stem: {equal} of codes equal, largest difference {worst}")
    preds = eng.classify(u8)
    if not np.array_equal(preds, got.argmax(-1)):
        raise AssertionError("ptq_r18_u8_fused2: classify on uint8 and the forward disagree")
    ms = time_ms(lambda: eng._fn(eng.params, ut), iters=10)
    repeat_forward("ptq_r18_u8_fused2", lambda: eng._fn(eng.params, ut))
    emit({"phase": "ptq_r18_u8_fused2", "model": "resnet18", "batch": BATCH,
          "launches": counts, "launches_by_form": forms,
          "logits_cosine_vs_normalized": cos, "top1_agreement_vs_normalized": agree,
          "cosine_gate": PTQ_U8_COS, "stem_codes_equal": equal, "stem_codes_max_diff": worst,
          "stem_gate": PTQ_U8_STEM_EQUAL, "ms_per_batch": ms,
          "ms_per_batch_normalized": time_ms(lambda: f2._fn(f2.params, nt), iters=10),
          "card": card})

    blk = deit["block"]
    beng = Engine.from_store(deit["root"], ctx="block", batch=BATCH, device=dev,
                             input_dtype=torch.uint8)
    gu, cu, fu = ptq_forward(lambda: beng._fn(beng.params, ut), "deit_block",
                             "ptq_deit_block_u8")
    with torch.inference_mode():
        gn = blk._fn(blk.params, nt).float().cpu().numpy()
    agree_d, cos_d = gate(gu, gn, "ptq_deit_block_u8 vs normalized fp32", PTQ_DEIT_U8_COS,
                          top1=False)
    repeat_forward("ptq_deit_block_u8", lambda: beng._fn(beng.params, ut))
    emit({"phase": "ptq_deit_block_u8", "model": "deit_tiny", "batch": BATCH, "launches": cu,
          "launches_by_form": fu, "logits_cosine_vs_normalized": cos_d,
          "top1_agreement_vs_normalized": agree_d, "cosine_gate": PTQ_DEIT_U8_COS,
          "ms_per_batch": time_ms(lambda: beng._fn(beng.params, ut), iters=10), "card": card})


def ptq_report(card, r18, x0, tmp):
    """(f) quant_error_report on (a)'s fp32 and GPTQ taps over two batches
    of BATCH / 4, logged by the port's RunLogger and read back (JSONL and xlsx)."""
    from dlq_tpu_torch.models.resnet import qforward
    from dlq_tpu_torch.quant.error_report import quant_error_report
    from dlq_tpu_torch.quant.model_quant import DeployCtx, ObserveCtx
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.runlog import RunLogger, read_xlsx_rows

    cfg, flat = r18["cfg"], r18["flat"]
    _, qflat, scales = r18["stores"]["gptq"]
    dctx, octx = DeployCtx(qflat, scales, INT8_PER_CHANNEL), ObserveCtx(flat)
    dev = next(iter(scales.values())).device

    def taps(ctx):
        def fn(x):
            with torch.inference_mode():
                return qforward(ctx, torch.from_numpy(x).to(dev), cfg, taps=True)
        return fn

    log = RunLogger(f"{tmp}/runlogs", script="chip_smoke_ptq.py", tag="gptq")
    h = BATCH // 4
    rep = quant_error_report(taps(octx), taps(dctx), [x0[:h], x0[h:2 * h]], logger=log,
                             params_info={"model": "resnet18", "rounding": "gptq"})
    rows = log.rows()
    table = read_xlsx_rows(log.export_xlsx())
    head = table[0]
    if (len(rows) != 1 or rows[0]["m_top1_agreement"] != rep["top1_agreement"]
            or len(table) != 2 or float(table[1][head.index("m_stem_cosine")])
            != rep["stages"]["stem"]["cosine"]):
        raise AssertionError("quant_error_report: the logged row does not read back")
    emit({"phase": "ptq_error_report", "model": "resnet18", "rounding": "gptq",
          "images": rep["images"], "worst_stage": rep["worst_stage"],
          "top1_agreement": rep["top1_agreement"], "top5_agreement": rep["top5_agreement"],
          "logits_cosine": rep["logits_cosine"],
          "stage_cosine": {k: v["cosine"] for k, v in rep["stages"].items()},
          "runlog_rows": len(rows), "xlsx_columns": len(head), "card": card})


def ptq_paths(dev, card, images):
    """The ptq phase, (a)-(f) of the PTQ toolbox on the card; every forward
    it serves is repeated SPLIT_REPEATS times (repeat_forward)."""
    x0 = images[:BATCH]
    with tempfile.TemporaryDirectory() as tmp:
        r18 = ptq_r18(dev, card, x0, tmp)
        ptq_mixed(dev, card, r18, x0, tmp)
        ptq_qat(dev, card, r18, images)
        ptq_report(card, r18, x0, tmp)
        deit = ptq_deit(dev, card, x0, tmp)
        ptq_uint8(dev, card, r18, deit)
        del r18, deit
    torch.cuda.empty_cache()


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
    forms = {name: dict(getattr(mod, name).by_form) for name, mod in mods.items()}
    for name, mod in mods.items():
        want = {"hopper": len(mod.FIRST_FORMS)}
        if forms[name] != want:
            raise AssertionError(f"{name}: launches by form {forms[name]}, expected {want}")
    floor = _probe.launch_floor_ms()
    emit({"phase": "probes", "fails": fails, "forms": forms, "launch_floor_ms": floor,
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
                   "library": spec.library, "launch_floor_ms": floor}
            if lib is not None:
                row["library_in_turns_ms"] = _probe.library_turns(fn, key, lib, xs)
            if key in mod.FIRST_FORMS:
                row.update(_probe.first_form_turns(fn, key, xs))
            emit_row(row)
            rows.append(row)
    if len(rows) != PROBE_PATTERNS:
        raise AssertionError(f"probes: {len(rows)} patterns, expected {PROBE_PATTERNS}")
    del results
    return rows, counts


def probe_exhaustive():
    """O's and 5's Hopper forms on every input value (their inputs hold 256
    and 65,536 distinct values): O on an int8 [256, 1024] holding each value
    1,024 times at four scales (the probe's f32(0.11); 0.5, exact ties; 1.7,
    the clip binds; 1/127), 5 on a bf16 [256, 768] holding every bit pattern
    three times (in order, reversed, seeded order; NaN, +-inf, -0 and the
    subnormals included). Per case the outputs differing from the first
    form (bit for bit, NaN for NaN) and from the plain version (bit for bit
    for O; _probe.held on the non-NaN inputs for 5, every NaN giving NaN);
    raises unless every case has 0 against the first form and holds against
    the plain version. Also the C launch plans against their Python mirrors,
    and both forms' ptxas registers and stack frames. Outside the counted
    probe run."""
    from dlq_tpu_torch import _build
    from dlq_tpu_torch.tools import _probe
    from dlq_tpu_torch.tools import probe_block_patterns as PK
    from dlq_tpu_torch.tools import probe_mosaic_patterns as PM

    dev = torch.device("cuda")
    plans = {"o_plan": (_probe.c_plan("probe_block", "o_plan", 3), PK.o_launch()),
             "tanh_plan": (_probe.c_plan("probe_mosaic", "tanh_plan", 3), PM.tanh_launch())}
    if any(c != py for c, py in plans.values()):
        raise AssertionError(f"probe_exhaustive: C plans against their Python mirrors {plans}")
    rows = []
    for mod, fn in ((PK, PK.probe_block), (PM, PM.probe_mosaic)):
        cases = [(lab, key, x.to(dev), s) for lab, key, x, s in mod.exhaustive_cases()]
        rows += _probe.exhaustive(fn, mod.SPEC, mod.PLAIN, cases)
    ptxas = {mark: _build.ptxas_report(lib, mark)
             for lib, mark in (("probe_block", "requant_kernel"),
                               ("probe_block", "requant_first_kernel"),
                               ("probe_mosaic", "tanh_kernel"),
                               ("probe_mosaic", "tanh_first_kernel"))}
    emit({"phase": "probe_exhaustive", "cases": rows, "plans": {k: v[0] for k, v in plans.items()},
          "ptxas": ptxas})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"probe_exhaustive: {bad}")


def probe_summary(rows, counts):
    """One entry per probe kernel (K19-K22): ``launches`` from the probe
    path's run; ``ms``, ``plain_ms`` and ``bound_ms`` summed over its
    patterns (one launch of each); no one PyTorch call computes a whole
    probe, so ``library_ms`` is null there and given per pattern (also
    in turns with the kernel), each pattern beside ``launch_floor_ms`` and,
    where redesigned, its first form's and its Hopper form's times in
    turns."""
    out = []
    for name, (_, src, repl) in PROBES.items():
        rs = [r for r in rows if r["kernel"] == name]
        pats = [{k: r[k] for k in ("pattern", "name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library", "launch_floor_ms",
                                   "library_in_turns_ms", "first_form_ms", "hopper_in_turns_ms")
                 if k in r}
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


# per-shape times a kernel's rows may carry beside ms / plain_ms / library_ms
# (device time on a spinning card, yardsticks and reference points)
EXTRA_TIMES = ("sdpa_bf16_ms", "sdpa_bf16_device_ms", "device_ms", "library_device_ms",
               "cudnn_bf16_ms", "cudnn_bf16_device_ms", "yardstick_device_ms",
               "first_form_device_ms")


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
                vals = [(n, r.get(f)) for n, r in zip(w, rs) if n]
                return None if any(v is None for _, v in vals) else sum(n * v for n, v in vals)

            bounds = [(n * r["bound_ms"], r["bound_by"]) for n, r in zip(w, rs) if n]
            per_path.append({"path": path, "launches": counts[name], "forwards": forwards,
                             "batch": batch, "launches_per_forward": counts[name] / forwards,
                             "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                             "bound_ms": tot("bound_ms"),
                             "bound_by": max(bounds)[1],
                             "library_ms": tot("library_ms"),
                             **{f: tot(f) for f in EXTRA_TIMES if f in rs[0]}})
        m = next(p for p in per_path if p["path"] == main)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": m["launches"], "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                    **{f: m[f] for f in EXTRA_TIMES if f in m},
                    "library": rs[0]["library"], "main": main,
                    "per": f"launches: the {main} run of {m['forwards']} forward(s) at batch "
                           f"{m['batch']}; times: one forward at batch {BATCH}",
                    "paths": per_path})
    return out


DW_TIMES = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "library_device_ms",
            "first_form_ms", "first_form_device_ms")


def mnv2_summary(rows, paths):
    """K23's entry of the kernels line: per forward of each MobileNetV2 path,
    each shape's time (batch ``BATCH``) weighted by its launches per forward
    as counted on that path's run of ``NB`` forwards; ``main``: deploy.
    Both forms are listed: each with its launches in that path's run (read
    by form; expect_counts held every launch to the Hopper form) and its
    times, the first form's timed beside the Hopper form's at the same
    shapes."""
    per_path = []
    for path, (counts, shapes, forms) in paths.items():
        w = [shapes["depthwise_int8"].get(r["key"], 0) / NB for r in rows]

        def tot(f):
            vals = [r.get(f) for r in rows]
            return None if any(v is None for v in vals) else sum(n * v for n, v in zip(w, vals))

        per_path.append({"path": path, "launches": counts["depthwise_int8"], "forwards": NB,
                         "launches_by_form": {f: forms.get(f, 0) for f in ("hopper", "first")},
                         "batch": BATCH, "launches_per_forward": counts["depthwise_int8"] / NB,
                         "bound_by": max((n * r["bound_ms"], r["bound_by"])
                                         for n, r in zip(w, rows) if n)[1],
                         **{f: tot(f) for f in DW_TIMES}})
    m = per_path[0]
    return [{"name": "depthwise_int8", "route": "cuda",
             "source": "dlq_tpu_torch/csrc/depthwise_int8.cu",
             "replaces": "dlq_tpu/ops/qops.py:182 _conv_int8, its grouped branch (groups == C; an "
                         "XLA function, no pallas_call; oracle _depthwise_int8_stencil :162)",
             "launches": m["launches"], "max_abs_err": max(r["max_abs_err"] for r in rows),
             "bound_by": m["bound_by"], **{f: m[f] for f in DW_TIMES},
             "library": DW_FP32, "main": m["path"],
             "forms": {"hopper": {"kernel": "depthwise_hopper_kernel", "ms": m["ms"],
                                  "device_ms": m["device_ms"],
                                  "launches": m["launches_by_form"]["hopper"]},
                       "first": {"kernel": "depthwise_int8_kernel", "ms": m["first_form_ms"],
                                 "device_ms": m["first_form_device_ms"],
                                 "launches": m["launches_by_form"]["first"]}},
             "per": f"launches: the {m['path']} run of {NB} forward(s) at batch {BATCH}; "
                    f"times: one forward at batch {BATCH}",
             "paths": per_path}]


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
    dw_rows = check_depthwise_kernel(dev)
    check_mnv2_epilogues(dev)
    check_groupwise_routes(dev)
    attention_ptxas()
    stress_split_kernels(dev)
    check_pre_digests(dev)
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
    mnv2 = mnv2_paths(dev, card, images)
    ptq_paths(dev, card, images)
    del images
    paths.update(mnist_paths(dev, card))
    check_repeats()
    probe_rows, probe_counts = probe_path()
    probe_exhaustive()
    kernels = (summary(rows, paths) + mnv2_summary(dw_rows, mnv2)
               + probe_summary(probe_rows, probe_counts))
    print(card_line())
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
