// K9: the last two thirds of a W4A8 ViT layer: proj + bias + residual, LN2,
// FC1 + bias, GELU, FC2 + bias + residual, each GEMM int8 activations
// against int4 weights (the bodies are shared with K7: vit_post_iw.cuh's
// Hopper form, vit_post.cuh's first form).
//
// Replaces the tail of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4a8 (:1550, kernel
// :1533-1544), vit_multiblock_fused_w4a8 (:1753, :1732-1740) and
// vit_block_fused_w4a8c (:1903, :1888-1897). All three write the FC2
// residual as z1 + (acc s + b) through a helper that returns acc s + b
// (_dot_w4a8 :1505, dot8 :1877), which XLA contracts to z1 + fma(acc, s, b):
// the stacked association (multi = 1), in the single-block kernels too.
// Weights: wproj [Dp, Dp/2], wfc1 [Hp, Dp/2], wfc2 [Dp, Hp/2] bytes, each
// the reference's halves packing on the padded grid, transposed: byte j of
// row n holds W[j][n] (low nibble) and W[j + Kp/2][n] (high nibble), the
// weights the reference's _unpack_halves_i8 (:1834) restores.
//
// Bound: as K7's (bytes: the residual and attn in, the residual out; the
// int4 weights are 221 KB of the ~200 MB a launch moves at DeiT-Tiny batch
// 256). Design (Dp 128, 192 or 256 where the ring holds at least 3 stages):
// K7's Hopper form (vit_post_iw.cuh), its producer warpgroup writing the
// sign-extended nibbles of 32 packed bytes a row into each int8 stage (K
// slots paired across the packed halves, so every packed byte is read
// once), with the hidden chunks paired the same way for FC2. The int8
// stages are K7's, so is the shared memory, and every sum is the exact
// int32 one: the output is bit-identical to the first form's. Any other
// shape runs the first form (vit_post.cuh: two cp.async stages of the
// packed bytes a 64-row block, unpacked in registers at fragment load,
// igemm.cuh: step_w4).
#include "vit_post.cuh"
#include "vit_post_iw.cuh"

namespace {

template <class T, class TO>
__global__ void __launch_bounds__(dlq::THREADS) vit_post_w4a8_kernel(const dlq::vit_post::Args a) {
  dlq::vit_post::body<true, T, TO>(a);
}

// The form the rule picks, or the first form (first = 1).
int run(int first, const void* y, int y_f32, const __nv_bfloat16* attn, float inv_proj,
        float inv_fc1, float inv_fc2, const uint8_t* wproj, const float* sproj,
        const float* bproj, const float* ln, const uint8_t* wfc1, const float* sfc1,
        const float* bfc1, const uint8_t* wfc2, const float* sfc2, const float* bfc2, void* out,
        int out_f32, int M, int Dp, int Hp, int d_valid, int gelu_tanh, int multi,
        void* stream) {
  if (!first && dlq::post_iw::hopper(Dp, Hp))
    return dlq::post_iw::launch<true>(y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj,
                                      bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, out_f32,
                                      M, Dp, Hp, d_valid, gelu_tanh, multi, stream);
  using BF = __nv_bfloat16;
  const dlq::vit_post::Kernels ks{
      {{vit_post_w4a8_kernel<BF, BF>, vit_post_w4a8_kernel<BF, float>},
       {vit_post_w4a8_kernel<float, BF>, vit_post_w4a8_kernel<float, float>}}};
  return dlq::vit_post::run<true>(ks, y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj,
                                  bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, out_f32, M,
                                  Dp, Hp, d_valid, gelu_tanh, multi, stream);
}

}  // namespace

// The form a launch at (Dp, Hp) takes: 1 the Hopper form (Dp 128, 192 or
// 256, Hp a multiple of 64 and a ring of at least 3 stages), 0 the first
// form. A static shape rule (ops/vit_block.py: vit_post_w4a8_form).
extern "C" int dlq_vit_post_w4a8_form(int Dp, int Hp) { return dlq::post_iw::hopper(Dp, Hp); }

// The Hopper form's launch plan: out = {ring stages, shared-memory bytes,
// blocks, rows a block} for Dp, Hp, M on `sms` SMs (0: this card's); all 0
// where the first form serves.
extern "C" int dlq_vit_post_w4a8_plan(int Dp, int Hp, int M, int sms, int* out) {
  return dlq::post_iw::plan_entry(Dp, Hp, M, sms, out);
}

// As dlq_vit_post_w8, with int4 halves-packed weights; the form by the rule above.
extern "C" int dlq_vit_post_w4a8(const void* y, int y_f32, const __nv_bfloat16* attn,
                                 float inv_qkv, float inv_proj, float inv_fc1, float inv_fc2,
                                 const uint8_t* wproj, const float* sproj, const float* bproj,
                                 const float* ln, const uint8_t* wfc1, const float* sfc1,
                                 const float* bfc1, const uint8_t* wfc2, const float* sfc2,
                                 const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                                 int d_valid, int gelu_tanh, int multi, void* stream) {
  (void)inv_qkv;  // K8's; the layer's four inverse scales travel together
  return run(0, y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj, bproj, ln, wfc1, sfc1,
             bfc1, wfc2, sfc2, bfc2, out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, multi, stream);
}

// The first form at any Dp, Hp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to, bit for bit.
extern "C" int dlq_vit_post_w4a8_first(const void* y, int y_f32, const __nv_bfloat16* attn,
                                       float inv_qkv, float inv_proj, float inv_fc1,
                                       float inv_fc2, const uint8_t* wproj, const float* sproj,
                                       const float* bproj, const float* ln, const uint8_t* wfc1,
                                       const float* sfc1, const float* bfc1, const uint8_t* wfc2,
                                       const float* sfc2, const float* bfc2, void* out,
                                       int out_f32, int M, int Dp, int Hp, int d_valid,
                                       int gelu_tanh, int multi, void* stream) {
  (void)inv_qkv;
  return run(1, y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj, bproj, ln, wfc1, sfc1,
             bfc1, wfc2, sfc2, bfc2, out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, multi, stream);
}
