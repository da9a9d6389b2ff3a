// K14: the first third of a bf16 ViT layer: LN1 -> bf16 -> QKV GEMM of bf16
// activations against bf16 weights -> fp32 bias -> bf16 qkv (the body is
// vit_pre_h.cuh's, shared with K11).
//
// Replaces the first third of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused (:371, kernel
// _block_kernel :299-303), the layer of the bf16 deploy forward
// vit_forward_blockfused (:1116):
//   h1  = bf16(LN(x))                            x: bf16 or fp32 [M, Dp]
//   qkv = bf16(h1 @ Wqkv + b)                    fp32 sums  -> bf16 [M, 3 Dp]
// Every product of two bf16 values is exact; the fp32 sums run in the tensor
// core's order, so a sum (and a bf16 value rounded from it) may differ from
// the reference's (XLA's order) in the last bits. wqkv: bf16 [3 Dp, Dp],
// K-major, [q|k|v] blocks of Dp lanes, heads at hd offsets, zero-padded.
//
// Bound: bytes (at DeiT-Tiny batch 256, tight pads: the residual in and qkv
// out, ~79 MB, against 11 GFLOP of bf16 products; loose pads 200 -> 256
// rows, 192 -> 256 lanes: ~134 MB). Design: vit_pre_h.cuh with the bf16
// weight streamed through two cp.async stages of 64 K values per column,
// read straight into the m16n8k16 B fragments (hgemm.cuh: step_bf16).
#include "vit_pre_h.cuh"

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: bf16 [3 Dp, Dp];
// s: unused (null); b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of
// 64, <= 512.
extern "C" int dlq_vit_pre_bf16(const void* y, int y_f32, const float* ln,
                                const __nv_bfloat16* w, const float* s, const float* b,
                                __nv_bfloat16* out, int M, int Dp, int d_valid, void* stream) {
  return dlq::pre_h::launch<false>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}
