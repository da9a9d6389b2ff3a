// Shared pieces of the ViT block kernels (K5/K8 vit_pre.cuh, K7/K9
// vit_post.cuh, K11 vit_pre_w4.cu, K12 vit_post_w4.cu): the reference's
// two-moment LayerNorm of one row, its inverse-scale int8 quantization or
// bf16 rounding, and its GELU (dlq_tpu/ops/pallas_vit_block.py:62-69,
// :279-287).
//
// Every operation is written with the _rn intrinsics so that nvcc contracts
// nothing into a fused multiply-add the reference does not have:
//   mu = sum(x) * inv_n,  m2 = sum(x*x) * inv_n,  var = max(m2 - mu*mu, 0)
//   h  = ((x - mu) * rsqrt(var + 1e-6)) * g + b
//   q  = clip(rint(h * inv_q), -127, 127)
// Sums are taken lane-strided then by a warp butterfly: another order than
// XLA's or PyTorch's, so a value on a rounding boundary may land one step
// apart (the card test holds the kernels to their plain versions with that
// slack).
#pragma once

#include <cuda_bf16.h>

#include "hgemm.cuh"

namespace dlq {

constexpr int ROW_REGS = 16;   // values per lane of one LN row: Dp <= 512

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quant_i8(float h, float inv_q) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(h, inv_q)), -127.0f), 127.0f));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One warp: LayerNorm of the Dp values v[j] (lane + 32 j) of one row;
// put(c, h) takes the normalized value of column c. g, b: fp32 [Dp] (zero
// past d_valid).
template <class Put>
__device__ __forceinline__ void ln_row(const float (&v)[ROW_REGS], int Dp,
                                       const float* __restrict__ g, const float* __restrict__ b,
                                       float inv_n, Put&& put) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < ROW_REGS; ++j) {
    if (lane + 32 * j < Dp) {
      s = __fadd_rn(s, v[j]);
      sq = __fadd_rn(sq, __fmul_rn(v[j], v[j]));
    }
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = __fmul_rn(s, inv_n);
  const float m2 = __fmul_rn(sq, inv_n);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.0f);
  const float r = rsqrtf(__fadd_rn(var, 1e-6f));
#pragma unroll
  for (int j = 0; j < ROW_REGS; ++j) {
    const int c = lane + 32 * j;
    if (c < Dp) put(c, __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mu), r), g[c]), b[c]));
  }
}

// ln_row, then int8 quantization into dst[0..Dp) (the W8A8 and W4A8 layers).
__device__ __forceinline__ void ln_quant_row(const float (&v)[ROW_REGS], int Dp,
                                             const float* __restrict__ g,
                                             const float* __restrict__ b, float inv_n,
                                             float inv_q, int8_t* dst) {
  ln_row(v, Dp, g, b, inv_n, [&](int c, float h) { dst[c] = quant_i8(h, inv_q); });
}

// ln_row, then bf16 (round to nearest even) into dst[0..Dp) (the W4A16 layer).
__device__ __forceinline__ void ln_bf16_row(const float (&v)[ROW_REGS], int Dp,
                                            const float* __restrict__ g,
                                            const float* __restrict__ b, float inv_n,
                                            __nv_bfloat16* dst) {
  ln_row(v, Dp, g, b, inv_n, [&](int c, float h) { dst[c] = __float2bfloat16_rn(h); });
}

constexpr float GELU_C = 0.7978845608028654f;    // sqrt(2/pi)
constexpr float SQRT_HALF = 0.7071067811865476f;

// gelu as the reference writes it (pallas_vit_block.py:279-283, jax.nn.gelu):
// tanh: (0.5 f) (1 + tanh(c (f + ((0.044715 f) f) f))); exact: (0.5 f) erfc(-f sqrt(1/2))
__device__ __forceinline__ float gelu(float f, bool tanh_approx) {
  if (tanh_approx) {
    const float f3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, f), f), f);
    const float th = tanhf(__fmul_rn(GELU_C, __fadd_rn(f, f3)));
    return __fmul_rn(__fmul_rn(0.5f, f), __fadd_rn(1.0f, th));
  }
  return __fmul_rn(__fmul_rn(0.5f, f), erfcf(__fmul_rn(-f, SQRT_HALF)));
}

}  // namespace dlq
