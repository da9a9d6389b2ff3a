// The first third of a ViT layer with bf16 activations, shared by K11
// vit_pre_w4 (int4 per-OC weights, vit_pre_w4.cu) and K14 vit_pre_bf16 (bf16
// weights, vit_pre_bf16.cu) as their first form (their Hopper form:
// vit_pre_hw.cuh), as vit_pre.cuh is by K5 and K8:
//   h1  = bf16(LN(x))                                         x: bf16 or fp32 [M, Dp]
//   acc = h1 @ W       (bf16 x bf16 products, exact; fp32 sums)
//   qkv = bf16(fma(acc, s[n], b[n]))                          -> bf16 [M, 3 Dp]
// With bf16 weights there is no scale: qkv = bf16(acc + b[n]), which
// fma(acc, 1.0f, b) rounds identically.
//
// Design: one block of 256 threads per 64 rows; LN is a prologue (one warp
// per row, from registers) that writes the bf16 h1 tile into shared memory,
// resident for the whole GEMM (64 x (Dp + 16) bf16); the weight streams
// through two cp.async stages (hgemm.cuh: mainloop_resident_hw) into the
// m16n8k16 tile, 64 qkv columns at a time. The residual is read once and qkv
// written once; h1 never reaches device memory.
#pragma once

#include "vit_common.cuh"

namespace dlq {
namespace pre_h {

constexpr int BM = 64;
constexpr int BN = 64;

struct Args {
  const void* y;
  const float* ln;       // [2, Dp]: LN1 g, b
  const void* w;         // [3 Dp, Dp / 2] halves-packed bytes (W4) or bf16 [3 Dp, Dp]
  const float* s;        // [3 Dp] (W4; unused for bf16 weights)
  const float* b;        // [3 Dp]
  __nv_bfloat16* out;    // [M, 3 Dp]
  int M, Dp;
  float inv_n;
};

template <bool W4>
int smem_bytes(int Dp) { return BM * (Dp + 16) * 2 + hw_stage_bytes<W4>(BN); }

template <bool W4, class T>
__global__ void __launch_bounds__(THREADS) kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = a.Dp + 16;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);        // [BM][lda] bf16 LN1(x)
  void* Bs = As + BM * lda;                                         // 2 weight stages
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* y = static_cast<const T*>(a.y);

  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    __nv_bfloat16* dst = As + r * lda;
    if (m >= a.M) {
      for (int c = lane; c < a.Dp; c += 32) dst[c] = __float2bfloat16_rn(0.0f);
      continue;
    }
    float v[ROW_REGS];
#pragma unroll
    for (int j = 0; j < ROW_REGS; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < a.Dp ? load_f(y + (size_t)m * a.Dp + c) : 0.0f;
    }
    ln_bf16_row(v, a.Dp, a.ln, a.ln + a.Dp, a.inv_n, dst);
  }

  const int N = 3 * a.Dp;
  for (int n0 = 0; n0 < N; n0 += BN) {
    HTile<BM, BN, 2, 4> tile;
    mainloop_resident_hw<W4, decltype(tile), BN>(tile, As, lda, Bs, a.w, N, a.Dp, n0);
    for_pairs(tile, [&](int r, int c, float v0, float v1) {
      const int m = m0 + r, n = n0 + c;
      if (m >= a.M) return;
      const float s0 = W4 ? a.s[n] : 1.0f, s1 = W4 ? a.s[n + 1] : 1.0f;
      *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)m * N + n) = __floats2bfloat162_rn(
          __fmaf_rn(v0, s0, a.b[n]), __fmaf_rn(v1, s1, a.b[n + 1]));
    });
  }
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w, s, b as Args;
// out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
template <bool W4>
int launch(const void* y, int y_f32, const float* ln, const void* w, const float* s,
           const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid, void* stream) {
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || d_valid <= 0 || d_valid > Dp)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid)};
  void (*const ks[2])(const Args) = {kernel<W4, __nv_bfloat16>, kernel<W4, float>};
  void (*k)(const Args) = ks[y_f32 != 0];
  const int smem = smem_bytes<W4>(Dp);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace pre_h
}  // namespace dlq
