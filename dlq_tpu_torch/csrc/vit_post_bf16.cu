// K15: the last two thirds of a bf16 ViT layer: proj + bias + residual, LN2,
// FC1 + bias, GELU, FC2 + residual + bias, each GEMM bf16 activations
// against bf16 weights with fp32 sums (the bodies are shared with K12:
// vit_post_hw.cuh's Hopper form, vit_post_h.cuh's first form).
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
// this weight format takes. Weights bf16, K-major, zero-padded: wproj
// [Dp, Dp], wfc1 [Hp, Dp], wfc2 [Dp, Hp].
//
// Bound: operations (34 GFLOP of bf16 products at DeiT-Tiny batch 256 with
// tight pads, 0.034 ms; 60 GFLOP with the loose pads' 256 rows and lanes,
// 0.061 ms) against ~59 / ~101 MB of residual, attn and output. Design: the
// Hopper form (vit_post_hw.cuh: persistent, 128-row tiles, bf16 wgmma, the
// weights streamed through an mbarrier ring of bf16 stages by cp.async, the
// GELU chunk as FC2's register operand) at Dp 128, 192 and 256 (the loose
// pads: three stages of one k16 step fit beside z1 and the A operand); the
// first form (vit_post_h.cuh: one 64-row block per SM, mma.sync, two
// cp.async stages) at any other Dp.
#include "vit_post_h.cuh"
#include "vit_post_hw.cuh"

namespace {

// The form the rule picks, or the first form (first = 1).
template <bool W4, class W>
int run(int first, const void* y, int y_f32, const __nv_bfloat16* attn, const W* wproj,
        const float* sproj, const float* bproj, const float* ln, const W* wfc1,
        const float* sfc1, const float* bfc1, const W* wfc2, const float* sfc2,
        const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp, int d_valid,
        int gelu_tanh, void* stream) {
  auto go = [&](auto launch) {
    return launch(y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2,
                    out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, stream);
  };
  if (first || !dlq::post_hw::form(Dp, Hp)) return go(dlq::post_h::launch<W4>);
  return go(dlq::post_hw::launch<W4>);
}

}  // namespace

// The form a launch at (Dp, Hp) takes: 1 the Hopper form (vit_post_hw.cuh:
// Dp 128, 192 or 256 and a plan of at least 3 ring stages), 0 the first
// form. A static shape rule (ops/vit_block.py: vit_post_h_form).
extern "C" int dlq_vit_post_bf16_form(int Dp, int Hp) { return dlq::post_hw::form(Dp, Hp); }

// The Hopper form's launch plan: out = {K bytes a stage row, ring stages,
// shared-memory bytes, blocks, rows a block} for Dp, Hp, M on `sms` SMs (0:
// this card's); all 0 where the first form serves.
extern "C" int dlq_vit_post_bf16_plan(int Dp, int Hp, int M, int sms, int* out) {
  return dlq::post_hw::plan_entry(Dp, Hp, M, sms, out);
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; attn: bf16 [M, Dp] (16-byte aligned);
// ln: fp32 [2, Dp]; weights bf16; s*: unused (null); b*: fp32 rows; out:
// [M, Dp] bf16 (out_f32 = 0) or fp32. Dp, Hp multiples of 64, Dp <= 512. The
// form by the rule above.
extern "C" int dlq_vit_post_bf16(const void* y, int y_f32, const __nv_bfloat16* attn,
                                 const __nv_bfloat16* wproj, const float* sproj, const float* bproj,
                                 const float* ln, const __nv_bfloat16* wfc1, const float* sfc1,
                                 const float* bfc1, const __nv_bfloat16* wfc2, const float* sfc2,
                                 const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                                 int d_valid, int gelu_tanh, void* stream) {
  return run<false>(0, y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2,
                    out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, stream);
}

// The first form at any Dp, Hp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to.
extern "C" int dlq_vit_post_bf16_first(const void* y, int y_f32, const __nv_bfloat16* attn,
                                       const __nv_bfloat16* wproj, const float* sproj,
                                       const float* bproj, const float* ln,
                                       const __nv_bfloat16* wfc1, const float* sfc1,
                                       const float* bfc1, const __nv_bfloat16* wfc2,
                                       const float* sfc2, const float* bfc2, void* out,
                                       int out_f32, int M, int Dp, int Hp, int d_valid,
                                       int gelu_tanh, void* stream) {
  return run<false>(1, y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2,
                    out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, stream);
}
