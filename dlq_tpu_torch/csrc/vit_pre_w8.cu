// K5: the first third of a W8A8 ViT layer: LN1 -> int8 quant -> int8 QKV
// GEMM -> fp32 epilogue -> bf16 qkv.
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
//
// Design (Hopper, Dp 128, 192 or 256): vit_pre_iw.cuh, the body K8 shares
// (a persistent grid of 128-row tiles; the weight resident in shared memory
// at Dp 128 and 192, streamed through an mbarrier ring at 256; y rows by
// bulk copy; LN1 one warp a row into int8 core-matrix codes; int8 wgmma
// m64n192k32; rows out by the bulk-copy engine).
// Limiters of the first form (vit_pre.cuh's body) that this removes: 800
// blocks of 64 rows each streaming all of wqkv through two cp.async stages
// behind block barriers (~88 MB of L2 weight reads per launch), mma.sync on
// 64 x 64 tiles, y read by the consumers' own loads, 4-byte output stores
// scattered over 1,152-byte rows. What still holds it: instruction issue,
// with 8 consumer warps an SM doing LN (about 110 instructions a row and
// warp) and the epilogue (about 80), PERF.md, Findings.
// The output is bit-identical to the first form's: the same LN, codes,
// exact int32 sums, and the same fma and rounding.
// Other Dp (multiples of 64 up to 512) run the first form.
#include "vit_pre.cuh"
#include "vit_pre_iw.cuh"

namespace {

using dlq::vit_pre::Args;

// The first form (vit_pre.cuh's body) for the Dp the Hopper form does not take.
template <class T>
__global__ void __launch_bounds__(dlq::THREADS) vit_pre_first_kernel(const Args a) {
  dlq::vit_pre::body<false, T>(a);
}

int first_form(const void* y, int y_f32, const float* ln, const int8_t* w, const float* s,
               const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid, float inv_q,
               void* stream) {
  return dlq::vit_pre::run<false>(vit_pre_first_kernel<float>, vit_pre_first_kernel<__nv_bfloat16>,
                                  y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}

}  // namespace

// The form a launch takes: 1 the Hopper form (Dp 128, 192, 256), 0 the
// first form. A static shape rule (ops/vit_block.py: vit_pre_w8_form).
extern "C" int dlq_vit_pre_w8_form(int Dp) { return dlq::pre_iw::hopper(false, Dp) ? 1 : 0; }

// The launch plan of the Hopper form: out = {resident weight, ring stages,
// shared-memory bytes, blocks, rows a block} for Dp and M on `sms` SMs (0:
// this card's).
extern "C" int dlq_vit_pre_w8_plan(int Dp, int M, int sms, int* out) {
  return dlq::pre_iw::plan_entry<false>(Dp, M, sms, out);
}

// y: [M, Dp] bf16 (y_f32 == 0) or fp32; ln: fp32 [2, Dp]; w: int8 [3 Dp, Dp]
// K-major; s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
extern "C" int dlq_vit_pre_w8(const void* y, int y_f32, const float* ln, const int8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, float inv_q, void* stream) {
  if (!dlq::pre_iw::hopper(false, Dp))
    return first_form(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
  return dlq::pre_iw::launch<false>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}

// The first form at any Dp it takes (the same arguments): the reference
// that the card tests hold the Hopper form to, bit for bit.
extern "C" int dlq_vit_pre_w8_first(const void* y, int y_f32, const float* ln, const int8_t* w,
                                    const float* s, const float* b, __nv_bfloat16* out, int M,
                                    int Dp, int d_valid, float inv_q, void* stream) {
  return first_form(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, inv_q, stream);
}
