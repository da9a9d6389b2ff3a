// The body of the first third of a quantized ViT layer, shared by K5
// (vit_pre_w8.cu: int8 weights) and K8 (vit_pre_w4a8.cu: int4 weights,
// halves-packed) as their first form (their Hopper form: vit_pre_iw.cuh).
// Each source instantiates it in a kernel of its own name.
//   h1  = LN(x) (two-moment, over Dp lanes, 1/d_valid)       x: bf16 or fp32 [M, Dp]
//   acc = quant(h1, inv_qkv) @ wqkv                          (int32 sums)
//   qkv = bf16(fma(float(acc), s[n], b[n]))                  -> [M, 3 Dp]
// One block of 256 threads per 64 rows. Each row is whole in the block
// (Dp <= 512), so LN is a prologue: each warp normalizes 8 rows from
// registers and writes their int8 codes into a shared A tile that stays
// resident for the whole GEMM (64 x (Dp + 16) bytes); the weight streams
// through shared memory in stages of 64 K values (two cp.async stages), 64
// qkv columns at a time on mma.sync.m16n8k32. The residual is read once and
// qkv written once; the int8 activations never reach device memory.
#pragma once

#include "vit_common.cuh"

namespace dlq {
namespace vit_pre {

constexpr int BM = 64;
constexpr int BN = 64;

struct Args {
  const void* y;
  const float* ln;  // [2, Dp]: g, b
  const void* w;    // int8 [3 Dp, Dp], or int4 halves-packed [3 Dp, Dp / 2] bytes
  const float* s;
  const float* b;
  __nv_bfloat16* out;
  int M, Dp;
  float inv_n, inv_q;
};

using Kernel = void (*)(const Args);

template <bool W4>
int smem_bytes(int Dp) { return BM * (Dp + 16) + b_stage_bytes<W4>(BN); }

template <bool W4, class T>
__device__ __forceinline__ void body(const Args& a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = a.Dp + 16;
  int8_t* As = smem;               // [BM][lda] int8 codes of LN1(x)
  int8_t* Bs = As + BM * lda;      // 2 weight stages
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* y = static_cast<const T*>(a.y);

  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    int8_t* dst = As + r * lda;
    if (m >= a.M) {
      for (int c = lane; c < a.Dp; c += 32) dst[c] = 0;
      continue;
    }
    float v[ROW_REGS];
#pragma unroll
    for (int j = 0; j < ROW_REGS; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < a.Dp ? load_f(y + (size_t)m * a.Dp + c) : 0.0f;
    }
    ln_quant_row(v, a.Dp, a.ln, a.ln + a.Dp, a.inv_n, a.inv_q, dst);
  }

  const int N = 3 * a.Dp;
  for (int n0 = 0; n0 < N; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident<W4, decltype(tile), BN>(tile, As, lda, Bs, a.w, N, a.Dp, n0);
#pragma unroll
    for (int i = 0; i < tile.MI; ++i)
#pragma unroll
      for (int j = 0; j < tile.NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + tile.warp_m * tile.WM + i * 16 + tile.g + h * 8;
          const int n = n0 + tile.warp_n * tile.WN + j * 8 + tile.t * 2;
          if (m >= a.M) continue;
          const float y0 = __fmaf_rn(__int2float_rn(tile.acc[i][j][2 * h]), a.s[n], a.b[n]);
          const float y1 = __fmaf_rn(__int2float_rn(tile.acc[i][j][2 * h + 1]), a.s[n + 1], a.b[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)m * N + n) =
              __floats2bfloat162_rn(y0, y1);
        }
  }
}

// Checks the arguments, then launches k_f32 (fp32 residual) or k_bf16.
// y: [M, Dp] bf16 or fp32; ln: fp32 [2, Dp]; s, b: fp32 [3 Dp]; out: bf16
// [M, 3 Dp]. Dp a multiple of 64, <= 512.
template <bool W4>
int run(Kernel k_f32, Kernel k_bf16, const void* y, int y_f32, const float* ln, const void* w,
        const float* s, const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid,
        float inv_q, void* stream) {
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || d_valid <= 0 || d_valid > Dp)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid), inv_q};
  const Kernel k = y_f32 ? k_f32 : k_bf16;
  const int smem = smem_bytes<W4>(Dp);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vit_pre
}  // namespace dlq
