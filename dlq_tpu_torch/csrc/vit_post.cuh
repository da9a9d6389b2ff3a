// The body of the last two thirds of a quantized ViT layer: K9's
// (vit_post_w4a8.cu: int4 weights, halves-packed), and K7's first form
// (vit_post_w8.cu: int8 weights), which K7 now runs only for a Dp other than
// 128, 192 and 256 (its Hopper form takes those). Each source instantiates
// it in a kernel of its own name.
//   z1  = x + fma(acc_proj, s, b),      acc_proj = quant(attn, inv_proj) @ wproj
//   f   = gelu(fma(acc_fc1, s, b)),     acc_fc1  = quant(LN(z1), inv_fc1) @ wfc1
//   out = z1 + fma(acc_fc2, s, b)       (multi: the stacked association)
//       | fma(acc_fc2, s, z1) + b       (the W8 single-block kernels')
//                                       acc_fc2  = quant(f, inv_fc2) @ wfc2
// x: the residual, bf16 or fp32 [M, Dp]; attn: bf16 [M, Dp]; out: bf16 or
// fp32. Weights K-major: wproj [Dp, Dp], wfc1 [Hp, Dp], wfc2 [Dp, Hp] (int8,
// or int4 halves-packed with half the columns in bytes).
//
// One block of 256 threads per 64 rows; nothing between the input and the
// output reaches device memory. The int8 codes of the quantized attn and of
// LN2(z1) (64 x (Dp + 16) bytes), z1 in fp32 (64 x Dp x 4) and the int8
// codes of gelu(FC1) (64 x (Hp + 16)) stay in shared memory; each GEMM
// streams its weight through shared memory in stages of 64 K values (two
// cp.async stages of igemm.cuh) on mma.sync.m16n8k32, 64 output columns at
// a time. At Dp 192 / Hp 768 that is ~120 KB of shared memory, above the
// 48 KB default: the launch opts in and a refused opt-in returns its error.
#pragma once

#include "vit_common.cuh"

namespace dlq {
namespace vit_post {

constexpr int BM = 64;
constexpr int BN = 64;

struct Args {
  const void* y;
  const __nv_bfloat16* attn;
  float inv_proj, inv_fc1, inv_fc2;
  const void* wproj;
  const float* sproj;
  const float* bproj;
  const float* ln;  // [2, Dp]: LN2 g, b
  const void* wfc1;
  const float* sfc1;
  const float* bfc1;
  const void* wfc2;
  const float* sfc2;
  const float* bfc2;
  void* out;
  int M, Dp, Hp;
  float inv_n;
  int gelu_tanh, multi;
};

using Kernel = void (*)(const Args);

template <bool W4>
int smem_bytes(int Dp, int Hp) {
  return BM * Dp * 4 + BM * (Dp + 16) + BM * (Hp + 16) + b_stage_bytes<W4>(BN);
}

template <bool W4, class T, class TO>
__device__ __forceinline__ void body(const Args& a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int Dp = a.Dp, Hp = a.Hp;
  const int lda = Dp + 16, ldh = Hp + 16;
  float* Z = reinterpret_cast<float*>(smem);     // [BM][Dp] z1, fp32
  int8_t* As = smem + BM * Dp * 4;               // [BM][lda] codes: attn, then LN2(z1)
  int8_t* Hs = As + BM * lda;                    // [BM][ldh] codes of gelu(FC1)
  int8_t* Bs = Hs + BM * ldh;                    // 2 weight stages
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, a.M - m0);
  const T* y = static_cast<const T*>(a.y);
  TO* out = static_cast<TO*>(a.out);

  // 1. quantize the attn tile
  for (int e = threadIdx.x; e < BM * Dp; e += THREADS) {
    const int r = e / Dp, c = e - r * Dp;
    As[r * lda + c] = r < rows ? quant_i8(__bfloat162float(a.attn[(size_t)(m0 + r) * Dp + c]),
                                          a.inv_proj)
                               : (int8_t)0;
  }

  // 2. proj: z1 = x + fma(acc, s, b) into Z
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident<W4, decltype(tile), BN>(tile, As, lda, Bs, a.wproj, Dp, Dp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      const int n = n0 + c;
      float x0 = 0.0f, x1 = 0.0f;
      if (r < rows) {
        x0 = load_f(y + (size_t)(m0 + r) * Dp + n);
        x1 = load_f(y + (size_t)(m0 + r) * Dp + n + 1);
      }
      Z[r * Dp + n] = __fadd_rn(x0, __fmaf_rn(__int2float_rn(v0), a.sproj[n], a.bproj[n]));
      Z[r * Dp + n + 1] = __fadd_rn(x1, __fmaf_rn(__int2float_rn(v1), a.sproj[n + 1], a.bproj[n + 1]));
    });
  }
  __syncthreads();

  // 3. LN2(z1) -> int8 codes in As (one warp per row)
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += THREADS / 32) {
      float v[ROW_REGS];
#pragma unroll
      for (int j = 0; j < ROW_REGS; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < Dp ? Z[r * Dp + c] : 0.0f;
      }
      ln_quant_row(v, Dp, a.ln, a.ln + Dp, a.inv_n, a.inv_fc1, As + r * lda);
    }
  }

  // 4. FC1 + bias + gelu -> int8 codes in Hs
  const bool tanh_approx = a.gelu_tanh != 0;
  for (int n0 = 0; n0 < Hp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident<W4, decltype(tile), BN>(tile, As, lda, Bs, a.wfc1, Hp, Dp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      const int n = n0 + c;
      const float f0 = __fmaf_rn(__int2float_rn(v0), a.sfc1[n], a.bfc1[n]);
      const float f1 = __fmaf_rn(__int2float_rn(v1), a.sfc1[n + 1], a.bfc1[n + 1]);
      Hs[r * ldh + n] = quant_i8(gelu(f0, tanh_approx), a.inv_fc2);
      Hs[r * ldh + n + 1] = quant_i8(gelu(f1, tanh_approx), a.inv_fc2);
    });
  }

  // 5. FC2 + bias + residual -> out
  const bool multi = a.multi != 0;
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident<W4, decltype(tile), BN>(tile, Hs, ldh, Bs, a.wfc2, Dp, Hp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      if (r >= rows) return;
      const int n = n0 + c;
      float o[2];
      const int acc[2] = {v0, v1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float z1 = Z[r * Dp + n + u];
        const float av = __int2float_rn(acc[u]);
        o[u] = multi ? __fadd_rn(z1, __fmaf_rn(av, a.sfc2[n + u], a.bfc2[n + u]))
                     : __fadd_rn(__fmaf_rn(av, a.sfc2[n + u], z1), a.bfc2[n + u]);
      }
      TO* dst = out + (size_t)(m0 + r) * Dp + n;
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[0], o[1]);
      }
    });
  }
}

// The four instantiations of one kernel: [y fp32][out fp32].
struct Kernels {
  Kernel k[2][2];
};

// Checks the arguments, then launches the instantiation for the residual
// and output dtypes.
template <bool W4>
int run(const Kernels& ks, const void* y, int y_f32, const __nv_bfloat16* attn, float inv_proj,
        float inv_fc1, float inv_fc2, const void* wproj, const float* sproj, const float* bproj,
        const float* ln, const void* wfc1, const float* sfc1, const float* bfc1, const void* wfc2,
        const float* sfc2, const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
        int d_valid, int gelu_tanh, int multi, void* stream) {
  const int smem = smem_bytes<W4>(Dp, Hp);
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || Hp <= 0 || Hp % 64 != 0 ||
      d_valid <= 0 || d_valid > Dp || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a{y, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1,
               wfc2, sfc2, bfc2, out, M, Dp, Hp, (float)(1.0 / (double)d_valid), gelu_tanh,
               multi};
  const Kernel k = ks.k[y_f32 != 0][out_f32 != 0];
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vit_post
}  // namespace dlq
