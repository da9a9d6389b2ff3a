// K12: the last two thirds of a W4A16 (weight-only int4) ViT layer: proj +
// bias + residual, LN2, FC1 + bias, GELU, FC2 + bias + residual, each GEMM
// bf16 activations against int4 per-OC weights with fp32 sums (the body is
// vit_post_h.cuh's, shared with K15).
//
// Replaces the tail of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4 (:1213, kernel
// :1199-1207), vit_multiblock_fused_w4 (:1408, :1390-1395) and
// vit_block_fused_w4c (:2045, :2031-2039):
//   z1  = x + fma(acc_proj, s, b),         acc_proj = attn @ wproj   (attn: bf16, as it is)
//   h2  = bf16(LN(z1))
//   f   = bf16(gelu(fma(acc_fc1, s, b))),  acc_fc1  = h2 @ wfc1
//   out = z1 + fma(acc_fc2, s, b),         acc_fc2  = f @ wfc2
// All three reference functions write FC2's residual as z1 + (acc s + b)
// through a helper returning acc s + b (_dot_w4a :1168, dotw :2021), which
// XLA contracts to z1 + fma(acc, s, b): the stacked association, in the
// single-block kernels too, so the kernel has only that one. Weights
// K-major, halves-packed: wproj [Dp, Dp/2], wfc1 [Hp, Dp/2], wfc2 [Dp, Hp/2]
// bytes.
//
// Bound: operations (34 GFLOP of bf16 products at DeiT-Tiny batch 256
// against ~59 MB of residual, attn and output). Design: K9's layer
// structure with bf16 A tiles (vit_post_h.cuh); each GEMM streams its packed
// weight through two cp.async stages and unpacks it in registers
// (hgemm.cuh: step_h4). 32-row blocks (two per SM) would unpack twice as
// often per product.
#include "vit_post_h.cuh"

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; attn: bf16 [M, Dp] (16-byte aligned);
// ln: fp32 [2, Dp]; s*, b*: fp32 rows; out: [M, Dp] bf16 (out_f32 = 0) or fp32.
// Dp, Hp multiples of 64, Dp <= 512.
extern "C" int dlq_vit_post_w4(const void* y, int y_f32, const __nv_bfloat16* attn,
                               const uint8_t* wproj, const float* sproj, const float* bproj,
                               const float* ln, const uint8_t* wfc1, const float* sfc1,
                               const float* bfc1, const uint8_t* wfc2, const float* sfc2,
                               const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                               int d_valid, int gelu_tanh, void* stream) {
  return dlq::post_h::launch<true>(y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1,
                                   wfc2, sfc2, bfc2, out, out_f32, M, Dp, Hp, d_valid, gelu_tanh,
                                   stream);
}
