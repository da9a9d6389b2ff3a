// K11: the first third of a W4A16 (weight-only int4) ViT layer: LN1 -> bf16
// -> QKV GEMM of bf16 activations against int4 per-OC weights -> fp32
// epilogue -> bf16 qkv (the body is vit_pre_h.cuh's, shared with K14).
//
// Replaces the first third of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4 (:1213, kernel
// _block_kernel_w4 :1191-1193), vit_multiblock_fused_w4 (:1408, :1384-1387)
// and vit_block_fused_w4c (:2045, :2023-2025):
//   h1  = bf16(LN(x))                                         x: bf16 or fp32 [M, Dp]
//   acc = h1 @ W       (bf16 x int4 products, exact; fp32 sums)
//   qkv = bf16(fma(acc, s[n], b[n]))                          -> bf16 [M, 3 Dp]
// The reference's _dot_w4a (:1150-1168) sums h1[:, :Dp/2] @ lo + h1[:, Dp/2:]
// @ hi and its cached twin one dot over the unpacked weight; the kernel sums
// in the tensor core's order, so its fp32 sums (not its products) may differ
// from either in the last bits. wqkv: [3 Dp, Dp / 2] bytes, byte k of row n
// holding W[k][n] (low nibble) and W[k + Dp/2][n] (high nibble): the
// reference's halves packing on the padded grid, transposed.
//
// Bound: bytes (the residual in, qkv out: ~79 MB at DeiT-Tiny batch 256
// against 11 GFLOP of bf16 products). Design: K8's layer structure with
// bf16 A (vit_pre_h.cuh); the packed weight streams through two cp.async
// stages of 32 bytes per column (64 K values) and is unpacked in registers
// into two m16n8k16 B fragments per 32-bit word (hgemm.cuh: step_h4).
#include "vit_pre_h.cuh"

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: uint8 [3 Dp, Dp / 2];
// s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
extern "C" int dlq_vit_pre_w4(const void* y, int y_f32, const float* ln, const uint8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, void* stream) {
  return dlq::pre_h::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}
