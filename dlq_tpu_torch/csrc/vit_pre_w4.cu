// K11: the first third of a W4A16 (weight-only int4) ViT layer: LN1 -> bf16
// -> QKV GEMM of bf16 activations against int4 per-OC weights -> fp32
// epilogue -> bf16 qkv.
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
// against 11 GFLOP of bf16 products).
//
// Design (Hopper, Dp 128, 192 or 256): vit_pre_hw.cuh, the body K14 shares
// (K5's form in bf16 wgmma: a persistent grid of 128-row tiles, y rows by
// bulk copy, LN1 one warp a row into bf16 core-matrix tiles, m64n192k16,
// rows out by the bulk-copy engine), with K11's producer streaming the
// packed weight from L2 and unpacking it into bf16 ring stages, the K
// slots paired across the packed halves.
// Limiters of the first form (vit_pre_h.cuh's body) that this removes: 800
// blocks of 64 rows each streaming all of the weight through two cp.async
// stages behind block barriers, mma.sync m16n8k16 with the int4 unpacked in
// registers at every fragment (hgemm.cuh: step_h4), 4-byte output stores
// scattered over 1,152-byte rows. The fp32 sums run in the tensor core's
// order, another than the first form's, so the two agree within W4A16's
// tolerance, not bit for bit. Other Dp (multiples of 64 up to 512) run the
// first form (vit_pre_h.cuh, shared with K14).
#include "vit_pre_h.cuh"
#include "vit_pre_hw.cuh"

// The form a launch takes: 1 the Hopper form (Dp 128, 192, 256), 0 the
// first form. A static shape rule (ops/vit_block.py: vit_pre_w4_form).
extern "C" int dlq_vit_pre_w4_form(int Dp) { return dlq::pre_hw::hopper(Dp) ? 1 : 0; }

// The launch plan of the Hopper form: out = {weight ring stages, y stages a
// consumer, shared-memory bytes, blocks, rows a block} for Dp and M on `sms`
// SMs (0: this card's); all 0 where the first form serves.
extern "C" int dlq_vit_pre_w4_plan(int Dp, int M, int sms, int* out) {
  return dlq::pre_hw::plan_entry(Dp, M, sms, out);
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: uint8 [3 Dp, Dp / 2];
// s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp] (16-byte aligned). Dp a multiple
// of 64, <= 512. The form by the rule above.
extern "C" int dlq_vit_pre_w4(const void* y, int y_f32, const float* ln, const uint8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, void* stream) {
  if (!dlq::pre_hw::hopper(Dp))
    return dlq::pre_h::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
  return dlq::pre_hw::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}

// The first form at any Dp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to.
extern "C" int dlq_vit_pre_w4_first(const void* y, int y_f32, const float* ln, const uint8_t* w,
                                    const float* s, const float* b, __nv_bfloat16* out, int M,
                                    int Dp, int d_valid, void* stream) {
  return dlq::pre_h::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}
