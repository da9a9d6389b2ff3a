// K8: the first third of a W4A8 ViT layer: LN1 -> int8 quant -> QKV GEMM
// against int4 weights -> fp32 epilogue -> bf16 qkv (the shared body of K5:
// vit_pre.cuh).
//
// Replaces the first third of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4a8 (:1550, kernel
// _block_kernel_w4a8 :1524-1527), vit_multiblock_fused_w4a8 (:1753,
// :1726-1729) and vit_block_fused_w4a8c (:1903, :1879-1882):
//   h1  = LN(x)                                              x: bf16 or fp32 [M, Dp]
//   acc = quant(h1, inv_qkv)[:, :Dp/2] @ lo(wqkv) + quant(h1, inv_qkv)[:, Dp/2:] @ hi(wqkv)
//   qkv = bf16(fma(float(acc), s[n], b[n]))                  -> [M, 3 Dp]
// wqkv: [3 Dp, Dp / 2] bytes, byte k of row n holding W[k][n] (low nibble)
// and W[k + Dp/2][n] (high nibble), the reference's halves packing on the
// padded grid, transposed (the reference's _dot_w4a8, :1491-1505, unpacks
// the same bytes into two int8 dots; the int32 sums are the same in any
// order).
//
// Bound: as K5's (bytes: the residual in, qkv out; the int4 weight is 55 KB
// of the ~170 MB a launch moves at DeiT-Tiny batch 256). Design: K5's, with
// the weight streamed packed (32 bytes of each row per stage, half of K5's
// weight traffic through shared memory) and unpacked in registers at
// fragment load: each 32-bit word of 4 packed bytes sign-extends (__vsub4)
// into the B fragment of the low half and of the high half, each feeding
// one mma.sync.m16n8k32 (igemm.cuh: step_w4).
#include "vit_pre.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(dlq::THREADS) vit_pre_w4a8_kernel(const dlq::vit_pre::Args a) {
  dlq::vit_pre::body<true, T>(a);
}

}  // namespace

// As dlq_vit_pre_w8, with w: int4 halves-packed [3 Dp, Dp / 2] bytes.
extern "C" int dlq_vit_pre_w4a8(const void* y, int y_f32, const float* ln, const uint8_t* w,
                                const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                                int d_valid, float inv_q, void* stream) {
  return dlq::vit_pre::run<true>(vit_pre_w4a8_kernel<float>, vit_pre_w4a8_kernel<__nv_bfloat16>,
                                 y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}
