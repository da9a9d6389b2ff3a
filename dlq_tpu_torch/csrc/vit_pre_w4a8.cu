// K8: the first third of a W4A8 ViT layer: LN1 -> int8 quant -> QKV GEMM
// against int4 weights -> fp32 epilogue -> bf16 qkv (the bodies are shared
// with K5: vit_pre_iw.cuh's Hopper form, vit_pre.cuh's first form).
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
// of the ~170 MB a launch moves at DeiT-Tiny batch 256).
//
// Design (Hopper, Dp 128 and 192): K5's Hopper form (vit_pre_iw.cuh), its
// weight resident in shared memory as int8: warps 0-2 of the producer
// warpgroup read the packed bytes once a block and write their
// sign-extended nibbles into K5's resident core-matrix copy (byte k of row
// n: the low nibble to column k, the high one to Dp/2 + k). The int8 copy
// is K5's, so is the plan, and every sum is the exact int32 one: the output
// is bit-identical to the first form's. Any other Dp (256 among them: the
// weight is not resident there, and no main path runs K8 at 256) runs the
// first form: vit_pre.cuh's body, the packed weight streamed 32 bytes of
// each row a stage and unpacked in registers at fragment load (each 32-bit
// word of 4 packed bytes sign-extends (__vsub4) into the B fragment of the
// low half and of the high half, each feeding one mma.sync.m16n8k32;
// igemm.cuh: step_w4).
#include "vit_pre.cuh"
#include "vit_pre_iw.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(dlq::THREADS) vit_pre_w4a8_kernel(const dlq::vit_pre::Args a) {
  dlq::vit_pre::body<true, T>(a);
}

int first_form(const void* y, int y_f32, const float* ln, const uint8_t* w, const float* s,
               const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid, float inv_q,
               void* stream) {
  return dlq::vit_pre::run<true>(vit_pre_w4a8_kernel<float>, vit_pre_w4a8_kernel<__nv_bfloat16>,
                                 y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}

}  // namespace

// The form a launch takes: 1 the Hopper form (Dp 128, 192), 0 the first
// form. A static shape rule (ops/vit_block.py: vit_pre_w4a8_form).
extern "C" int dlq_vit_pre_w4a8_form(int Dp) { return dlq::pre_iw::hopper(true, Dp) ? 1 : 0; }

// The launch plan of the Hopper form (K5's at the same Dp): out = {resident
// weight, ring stages, y stages, shared-memory bytes, blocks, rows a block}
// for Dp and M on `sms` SMs (0: this card's); all 0 where the first form
// serves.
extern "C" int dlq_vit_pre_w4a8_plan(int Dp, int M, int sms, int* out) {
  return dlq::pre_iw::plan_entry<true>(Dp, M, sms, out);
}

// As dlq_vit_pre_w8, with w: int4 halves-packed [3 Dp, Dp / 2] bytes; the
// form by the rule above.
extern "C" int dlq_vit_pre_w4a8(const void* y, int y_f32, const float* ln, const uint8_t* w,
                                const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                                int d_valid, float inv_q, void* stream) {
  if (!dlq::pre_iw::hopper(true, Dp))
    return first_form(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
  return dlq::pre_iw::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}

// The first form at any Dp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to, bit for bit.
extern "C" int dlq_vit_pre_w4a8_first(const void* y, int y_f32, const float* ln,
                                      const uint8_t* w, const float* s, const float* b,
                                      __nv_bfloat16* out, int M, int Dp, int d_valid, float inv_q,
                                      void* stream) {
  return first_form(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}
