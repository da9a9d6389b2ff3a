// Shared pieces of the ViT block kernels (K5/K8 vit_pre.cuh, K7/K9
// vit_post.cuh, K11/K14 vit_pre_h.cuh, K12/K15 vit_post_h.cuh) and the fused
// LayerNorms (K16/K17 layernorm.cu): the reference's two-moment LayerNorm of
// one row, its inverse-scale int8 quantization or bf16 rounding, and its
// GELU (dlq_tpu/ops/pallas_vit_block.py:62-69, :279-287;
// pallas_layernorm.py:29-41, where eps is an argument).
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

// One lane's running moments: s += v, sq += v*v.
__device__ __forceinline__ void ln_acc(float& s, float& sq, float v) {
  s = __fadd_rn(s, v);
  sq = __fadd_rn(sq, __fmul_rn(v, v));
}

// The row's mean and rsqrt(var + eps) from the lane sums (warp-reduced here).
__device__ __forceinline__ void ln_stats(float s, float sq, float inv_n, float eps, float& mu,
                                         float& r) {
  s = warp_sum(s);
  sq = warp_sum(sq);
  mu = __fmul_rn(s, inv_n);
  const float m2 = __fmul_rn(sq, inv_n);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.0f);
  r = rsqrtf(__fadd_rn(var, eps));
}

// ((x - mu) * r) * g + b
__device__ __forceinline__ float ln_apply(float x, float mu, float r, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), r), g), b);
}

// One warp: LayerNorm of the Dp values v[j] (lane + 32 j) of one row;
// put(c, h) takes the normalized value of column c. g, b: fp32 or bf16 [Dp]
// (zero past d_valid), read widened to fp32.
template <class TG, class Put>
__device__ __forceinline__ void ln_row(const float (&v)[ROW_REGS], int Dp,
                                       const TG* __restrict__ g, const TG* __restrict__ b,
                                       float inv_n, Put&& put, float eps = 1e-6f) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < ROW_REGS; ++j)
    if (lane + 32 * j < Dp) ln_acc(s, sq, v[j]);
  float mu, r;
  ln_stats(s, sq, inv_n, eps, mu, r);
#pragma unroll
  for (int j = 0; j < ROW_REGS; ++j) {
    const int c = lane + 32 * j;
    if (c < Dp) put(c, ln_apply(v[j], mu, r, load_f(g + c), load_f(b + c)));
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

// One 16-byte row piece: 8 bf16 or fp32 values widened to fp32 (load8), or
// stored from fp32 (store8, bf16 rounded to nearest even).
template <class T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const int4 q = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __bfloat162float(h[e].x);
      v[2 * e + 1] = __bfloat162float(h[e].y);
    }
  }
}

template <class T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    int4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<int4*>(p) = q;
  }
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
