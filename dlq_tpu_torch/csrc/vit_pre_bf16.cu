// K14: the first third of a bf16 ViT layer: LN1 -> bf16 -> QKV GEMM of bf16
// activations against bf16 weights -> fp32 bias -> bf16 qkv (the bodies are
// shared with K11: vit_pre_hw.cuh's Hopper form, vit_pre_h.cuh's first form).
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
// rows, 192 -> 256 lanes: ~134 MB).
//
// Design (Hopper, Dp 128, 192 or 256): vit_pre_hw.cuh, K11's body, with a
// producer warp that copies the bf16 weight from L2 into its ring stages by
// 16-byte cp.async (192 columns x 64 contiguous K values a stage) and
// consumers on bf16 wgmma m64n192k16; the epilogue adds the bias as
// fma(acc, 1, b). Limiters of the first form that this removes: 800 blocks
// (tight pads; 1,024 loose) of 64 rows each streaming the whole weight
// through two cp.async stages behind block barriers, mma.sync m16n8k16 on
// 64 x 64 tiles, 4-byte output stores. The fp32 sums run in another order
// than the first form's, so the two agree within the bf16 tolerance, not bit
// for bit. Other Dp (multiples of 64 up to 512) run the first form
// (vit_pre_h.cuh: the weight read straight into the m16n8k16 B fragments,
// hgemm.cuh: step_bf16).
#include "vit_pre_h.cuh"
#include "vit_pre_hw.cuh"

// The form a launch takes: 1 the Hopper form (Dp 128, 192, 256), 0 the
// first form. A static shape rule (ops/vit_block.py: vit_pre_bf16_form).
extern "C" int dlq_vit_pre_bf16_form(int Dp) { return dlq::pre_hw::hopper(Dp) ? 1 : 0; }

// The launch plan of the Hopper form (K11's): out = {weight ring stages, y
// stages a consumer, shared-memory bytes, blocks, rows a block} for Dp and M
// on `sms` SMs (0: this card's); all 0 where the first form serves.
extern "C" int dlq_vit_pre_bf16_plan(int Dp, int M, int sms, int* out) {
  return dlq::pre_hw::plan_entry(Dp, M, sms, out);
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: bf16 [3 Dp, Dp];
// s: unused (null); b: fp32 [3 Dp]; out: bf16 [M, 3 Dp] (16-byte aligned).
// Dp a multiple of 64, <= 512. The form by the rule above.
extern "C" int dlq_vit_pre_bf16(const void* y, int y_f32, const float* ln,
                                const __nv_bfloat16* w, const float* s, const float* b,
                                __nv_bfloat16* out, int M, int Dp, int d_valid, void* stream) {
  if (!dlq::pre_hw::hopper(Dp))
    return dlq::pre_h::launch<false>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
  return dlq::pre_hw::launch<false>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}

// The first form at any Dp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to.
extern "C" int dlq_vit_pre_bf16_first(const void* y, int y_f32, const float* ln,
                                      const __nv_bfloat16* w, const float* s, const float* b,
                                      __nv_bfloat16* out, int M, int Dp, int d_valid,
                                      void* stream) {
  return dlq::pre_h::launch<false>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}
