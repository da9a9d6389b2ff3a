// K9: the last two thirds of a W4A8 ViT layer: proj + bias + residual, LN2,
// FC1 + bias, GELU, FC2 + bias + residual, each GEMM int8 activations
// against int4 weights (the shared body of K7: vit_post.cuh).
//
// Replaces the tail of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4a8 (:1550, kernel
// :1533-1544), vit_multiblock_fused_w4a8 (:1753, :1732-1740) and
// vit_block_fused_w4a8c (:1903, :1888-1897). All three write the FC2
// residual as z1 + (acc s + b) through a helper that returns acc s + b
// (_dot_w4a8 :1505, dot8 :1877), which XLA contracts to z1 + fma(acc, s, b):
// the stacked association (multi = 1), in the single-block kernels too.
// Weights: wproj [Dp, Dp/2], wfc1 [Hp, Dp/2], wfc2 [Dp, Hp/2] bytes, each
// the reference's halves packing on the padded grid, transposed.
//
// Bound: as K7's (bytes: the residual and attn in, the residual out; the
// int4 weights are 221 KB of the ~200 MB a launch moves at DeiT-Tiny batch
// 256). Design: K7's, with each weight streamed packed (32 bytes of each row
// per stage) and unpacked in registers at fragment load (igemm.cuh:
// step_w4): half of K7's weight traffic through shared memory, and 4 KB
// less shared memory per block (116 KB: the B stages are 48-byte rows).
#include "vit_post.cuh"

namespace {

template <class T, class TO>
__global__ void __launch_bounds__(dlq::THREADS) vit_post_w4a8_kernel(const dlq::vit_post::Args a) {
  dlq::vit_post::body<true, T, TO>(a);
}

}  // namespace

// As dlq_vit_post_w8, with int4 halves-packed weights.
extern "C" int dlq_vit_post_w4a8(const void* y, int y_f32, const __nv_bfloat16* attn,
                                 float inv_qkv, float inv_proj, float inv_fc1, float inv_fc2,
                                 const uint8_t* wproj, const float* sproj, const float* bproj,
                                 const float* ln, const uint8_t* wfc1, const float* sfc1,
                                 const float* bfc1, const uint8_t* wfc2, const float* sfc2,
                                 const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                                 int d_valid, int gelu_tanh, int multi, void* stream) {
  (void)inv_qkv;  // K8's; the layer's four inverse scales travel together
  using BF = __nv_bfloat16;
  const dlq::vit_post::Kernels ks{
      {{vit_post_w4a8_kernel<BF, BF>, vit_post_w4a8_kernel<BF, float>},
       {vit_post_w4a8_kernel<float, BF>, vit_post_w4a8_kernel<float, float>}}};
  return dlq::vit_post::run<true>(ks, y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj,
                                  bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, out_f32, M,
                                  Dp, Hp, d_valid, gelu_tanh, multi, stream);
}
