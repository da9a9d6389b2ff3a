// K5: the first third of a W8A8 ViT layer: LN1 -> int8 quant -> int8 QKV
// GEMM -> fp32 epilogue -> bf16 qkv (the shared body: vit_pre.cuh).
//
// Replaces dlq_tpu/ops/pallas_vit_block.py:vit_block_pre_w8 (kernel
// _block_pre_kernel_w8, :937-950) and the first third of each layer of
// vit_multiblock_fused_w8 / vit_block_fused_w8:
//   h1  = LN(x) (two-moment, over Dp lanes, 1/d_valid)       x: bf16 or fp32 [M, Dp]
//   acc = quant(h1, inv_qkv) @ wqkv    (int8 x int8 -> int32; wqkv K-major [3 Dp, Dp])
//   qkv = bf16(fma(float(acc), s[n], b[n]))                  -> [M, 3 Dp]
//
// Bound: at DeiT-Tiny batch 256 (M = 51,200 rows, Dp = 192) the GEMM does
// 2 x 192 x 576 = 221 K int8 operations per row against 768 bytes in (fp32
// residual) and 1,152 out: ~115 operations per byte, far below the card's
// ridge of ~590, so bytes bound it (about 0.03 ms at 3.35 TB/s).
// Design (vit_pre.cuh): LN as a prologue into a resident int8 A tile, the
// weight streamed in 64-byte K slices; the int8 activations never reach
// device memory.
#include "vit_pre.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(dlq::THREADS) vit_pre_kernel(const dlq::vit_pre::Args a) {
  dlq::vit_pre::body<false, T>(a);
}

}  // namespace

// y: [M, Dp] bf16 (y_f32 == 0) or fp32; ln: fp32 [2, Dp]; w: int8 [3 Dp, Dp]
// K-major; s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
extern "C" int dlq_vit_pre_w8(const void* y, int y_f32, const float* ln, const int8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, float inv_q, void* stream) {
  return dlq::vit_pre::run<false>(vit_pre_kernel<float>, vit_pre_kernel<__nv_bfloat16>, y, y_f32,
                                  ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}
