// K15: the last two thirds of a bf16 ViT layer: proj + bias + residual, LN2,
// FC1 + bias, GELU, FC2 + residual + bias, each GEMM bf16 activations
// against bf16 weights with fp32 sums (the body is vit_post_h.cuh's, shared
// with K12).
//
// Replaces the tail of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused (:371, kernel
// _block_kernel :309-320), the layer of the bf16 deploy forward
// vit_forward_blockfused (:1116):
//   z1  = x + (attn @ wproj + b)                 attn: bf16, as it is
//   h2  = bf16(LN(z1))
//   f   = bf16(gelu(h2 @ wfc1 + b))
//   out = (z1 + f @ wfc2) + b                    -> y.dtype
// FC2's residual is added before its bias (:318-319): a third order beside
// K7's fma(acc, s, z1) + b and K9/K12's z1 + fma(acc, s, b), and the one
// this weight format takes (vit_post_h.cuh). Weights bf16, K-major,
// zero-padded: wproj [Dp, Dp], wfc1 [Hp, Dp], wfc2 [Dp, Hp].
//
// Bound: operations (34 GFLOP of bf16 products at DeiT-Tiny batch 256 with
// tight pads, 0.034 ms; 60 GFLOP with the loose pads' 256 rows and lanes,
// 0.061 ms) against ~59 / ~101 MB of residual, attn and output. Design:
// K12's (vit_post_h.cuh) with the bf16 weight streamed through two cp.async
// stages of 64 K values per column, read straight into the m16n8k16 B
// fragments (hgemm.cuh: step_bf16): no unpack, twice the weight bytes per
// stage. Shared memory at the loose pads (Dp 256, Hp 768): z1 64 KB, attn
// then h2 34 KB, gelu(FC1) 98 KB, two weight stages 20 KB: 216 KB.
#include "vit_post_h.cuh"

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; attn: bf16 [M, Dp] (16-byte aligned);
// ln: fp32 [2, Dp]; weights bf16; s*: unused (null); b*: fp32 rows; out:
// [M, Dp] bf16 (out_f32 = 0) or fp32. Dp, Hp multiples of 64, Dp <= 512.
extern "C" int dlq_vit_post_bf16(const void* y, int y_f32, const __nv_bfloat16* attn,
                                 const __nv_bfloat16* wproj, const float* sproj,
                                 const float* bproj, const float* ln, const __nv_bfloat16* wfc1,
                                 const float* sfc1, const float* bfc1, const __nv_bfloat16* wfc2,
                                 const float* sfc2, const float* bfc2, void* out, int out_f32,
                                 int M, int Dp, int Hp, int d_valid, int gelu_tanh, void* stream) {
  return dlq::post_h::launch<false>(y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1,
                                    wfc2, sfc2, bfc2, out, out_f32, M, Dp, Hp, d_valid,
                                    gelu_tanh, stream);
}
