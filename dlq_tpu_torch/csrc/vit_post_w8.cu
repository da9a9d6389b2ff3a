// K7: the last two thirds of a W8A8 ViT layer: int8 proj + bias + residual,
// LN2, int8 FC1 + bias, GELU, int8 FC2 + bias + residual.
//
// Replaces dlq_tpu/ops/pallas_vit_block.py:vit_block_post_w8 (kernel
// _block_post_kernel_w8, :953-977) and the tail of each layer of
// vit_multiblock_fused_w8 (:490-501) / vit_block_fused_w8 (:351-365):
//   z1  = x + fma(acc_proj, s, b),      acc_proj = quant(attn, inv_proj) @ wproj
//   f   = gelu(fma(acc_fc1, s, b)),     acc_fc1  = quant(LN(z1), inv_fc1) @ wfc1
//   out = z1 + fma(acc_fc2, s, b)       (multi: the stacked kernel, :501)
//       | fma(acc_fc2, s, z1) + b       (the single-block kernels, :364, :976)
//                                       acc_fc2  = quant(f, inv_fc2) @ wfc2
// x: the residual, bf16 or fp32 [M, Dp]; attn: bf16 [M, Dp]; out: bf16 or
// fp32. Weights int8, K-major: wproj [Dp, Dp], wfc1 [Hp, Dp], wfc2 [Dp, Hp].
//
// Bound: at DeiT-Tiny batch 256 (M = 51,200, Dp = 192, Hp = 768) the three
// GEMMs do 2 x (192^2 + 2 x 192 x 768) = 664 K int8 operations per row
// against up to 1,920 bytes in and out per row: ~350 operations per byte,
// under the card's ridge of ~590, so bytes bound it (~0.03 ms per launch).
//
// Design (Hopper, Dp 128, 192 or 256): vit_post_iw.cuh, the body K9 shares
// (a persistent grid of 128-row tiles, a producer warp streaming the int8
// weights through an mbarrier ring of Dp x 64-byte stages by cp.async, two
// consumer warpgroups on int8 wgmma, FC2's sums in registers over Hp).
// Limiters of the first form (vit_post.cuh's body, one 64-row block per
// SM) that this removes: the short last wave, five phases in series behind
// block barriers with two barriers per weight slice, 265 MB of L2 weight
// reads per launch (halved: 128 rows a pass), mma.sync on 64 x 64 tiles,
// scalar 2-byte loads of attn and x. What it keeps: the epilogues' CUDA-core
// work (the accurate GELU on 51,200 x 768 values a launch) runs while the
// tensor cores wait, on 8 consumer warps an SM (PERF.md, Findings).
// Any other shape (Dp other than 128, 192, 256, or a ring of fewer than 3
// stages) runs the first form.
#include "vit_post.cuh"
#include "vit_post_iw.cuh"

namespace {

// The first form (vit_post.cuh's body) for the Dp the Hopper form does not take.
template <class T, class TO>
__global__ void __launch_bounds__(dlq::THREADS) vit_post_first_kernel(const dlq::vit_post::Args a) {
  dlq::vit_post::body<false, T, TO>(a);
}

}  // namespace

// The launch plan of the Hopper form: out = {ring stages, shared-memory
// bytes, blocks, rows a block} for Dp, Hp, M on `sms` SMs (0: this card's);
// all 0 where the first form serves.
extern "C" int dlq_vit_post_w8_plan(int Dp, int Hp, int M, int sms, int* out) {
  return dlq::post_iw::plan_entry(Dp, Hp, M, sms, out);
}

extern "C" int dlq_vit_post_w8(const void* y, int y_f32, const __nv_bfloat16* attn,
                               float inv_qkv, float inv_proj, float inv_fc1, float inv_fc2,
                               const int8_t* wproj, const float* sproj, const float* bproj,
                               const float* ln, const int8_t* wfc1, const float* sfc1,
                               const float* bfc1, const int8_t* wfc2, const float* sfc2,
                               const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                               int d_valid, int gelu_tanh, int multi, void* stream) {
  (void)inv_qkv;  // K5's; the layer's four inverse scales travel together
  using BF = __nv_bfloat16;
  if (!dlq::post_iw::hopper(Dp, Hp)) {
    const dlq::vit_post::Kernels ks{
        {{vit_post_first_kernel<BF, BF>, vit_post_first_kernel<BF, float>},
         {vit_post_first_kernel<float, BF>, vit_post_first_kernel<float, float>}}};
    return dlq::vit_post::run<false>(ks, y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj,
                                     bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, out_f32,
                                     M, Dp, Hp, d_valid, gelu_tanh, multi, stream);
  }
  return dlq::post_iw::launch<false>(y, y_f32, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj,
                                     bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, out_f32,
                                     M, Dp, Hp, d_valid, gelu_tanh, multi, stream);
}
