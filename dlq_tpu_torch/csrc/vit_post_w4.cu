// K12: the last two thirds of a W4A16 (weight-only int4) ViT layer: proj +
// bias + residual, LN2, FC1 + bias, GELU, FC2 + bias + residual, each GEMM
// bf16 activations against int4 per-OC weights with fp32 sums (the bodies
// are shared with K15: vit_post_hw.cuh's Hopper form, vit_post_h.cuh's
// first form).
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
// against ~59 MB of residual, attn and output). Design: K15's Hopper form
// (vit_post_hw.cuh) with a producer that unpacks the int4 bytes into the
// ring's bf16 stages as it streams them (the reference's cache-unpack,
// _block_kernel_w4c :2003-2010, done per stage: the ring holds what its
// bf16 scratches hold), at Dp 128, 192 and 256; the first form
// (vit_post_h.cuh: the packed weight through two cp.async stages, unpacked
// in registers at every mma.sync, hgemm.cuh: step_h4) at any other Dp.
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
extern "C" int dlq_vit_post_w4_form(int Dp, int Hp) { return dlq::post_hw::form(Dp, Hp); }

// The Hopper form's launch plan: out = {K bytes a stage row, ring stages,
// shared-memory bytes, blocks, rows a block} for Dp, Hp, M on `sms` SMs (0:
// this card's); all 0 where the first form serves.
extern "C" int dlq_vit_post_w4_plan(int Dp, int Hp, int M, int sms, int* out) {
  return dlq::post_hw::plan_entry(Dp, Hp, M, sms, out);
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; attn: bf16 [M, Dp] (16-byte aligned);
// ln: fp32 [2, Dp]; s*, b*: fp32 rows; out: [M, Dp] bf16 (out_f32 = 0) or
// fp32. Dp, Hp multiples of 64, Dp <= 512. The form by the rule above.
extern "C" int dlq_vit_post_w4(const void* y, int y_f32, const __nv_bfloat16* attn,
                               const uint8_t* wproj, const float* sproj, const float* bproj,
                               const float* ln, const uint8_t* wfc1, const float* sfc1,
                               const float* bfc1, const uint8_t* wfc2, const float* sfc2,
                               const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                               int d_valid, int gelu_tanh, void* stream) {
  return run<true>(0, y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2,
                   out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, stream);
}

// The first form at any Dp, Hp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to.
extern "C" int dlq_vit_post_w4_first(const void* y, int y_f32, const __nv_bfloat16* attn,
                                     const uint8_t* wproj, const float* sproj, const float* bproj,
                                     const float* ln, const uint8_t* wfc1, const float* sfc1,
                                     const float* bfc1, const uint8_t* wfc2, const float* sfc2,
                                     const float* bfc2, void* out, int out_f32, int M, int Dp,
                                     int Hp, int d_valid, int gelu_tanh, void* stream) {
  return run<true>(1, y, y_f32, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2,
                   out, out_f32, M, Dp, Hp, d_valid, gelu_tanh, stream);
}
