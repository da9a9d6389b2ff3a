// The last two thirds of a ViT layer with bf16 activations, shared by K12
// vit_post_w4 (int4 per-OC weights, vit_post_w4.cu) and K15 vit_post_bf16
// (bf16 weights, vit_post_bf16.cu), as vit_post.cuh is by K7 and K9:
//   z1  = x + fma(acc_proj, s, b),         acc_proj = attn @ wproj   (attn: bf16, as it is)
//   h2  = bf16(LN(z1))
//   f   = bf16(gelu(fma(acc_fc1, s, b))),  acc_fc1  = h2 @ wfc1
//   out = FC2's residual of acc_fc2 = f @ wfc2, by weight format:
//         W4 (K12):   z1 + fma(acc_fc2, s, b)
//         bf16 (K15): (z1 + acc_fc2) + b
// With bf16 weights there is no scale, and fma(acc, 1.0f, b) rounds as
// acc + b. x: the residual, bf16 or fp32 [M, Dp]; out: bf16 or fp32.
//
// Design: one block of 256 threads per 64 rows, and nothing between the
// inputs and the output reaches device memory. The attn tile (copied with
// cp.async, then LN2(z1) in its place, bf16 64 x (Dp + 16)), z1 in fp32
// (64 x Dp) and gelu(FC1) in bf16 (64 x (Hp + 16)) stay in shared memory;
// each GEMM streams its weight through two cp.async stages (hgemm.cuh:
// mainloop_resident_hw), 64 output columns at a time. At Dp 192 / Hp 768
// that is 178 KB of shared memory with int4 weights and 192 KB with bf16
// ones; at Dp 256 / Hp 768 (the loose pads) 216 KB with bf16: one block
// per SM, opted in at launch (a refused opt-in returns its error). 64-row
// blocks keep K9's tile, so each B fragment feeds two 16-row A tiles.
#pragma once

#include "vit_common.cuh"

namespace dlq {
namespace post_h {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int MAX_SMEM = 232448;   // the opt-in limit of one block (H100)

struct Args {
  const void* y;
  const __nv_bfloat16* attn;
  const void* wproj;
  const float* sproj;   // the scale rows: W4 only
  const float* bproj;
  const float* ln;      // [2, Dp]: LN2 g, b
  const void* wfc1;
  const float* sfc1;
  const float* bfc1;
  const void* wfc2;
  const float* sfc2;
  const float* bfc2;
  void* out;
  int M, Dp, Hp;
  float inv_n;
  int gelu_tanh;
};

template <bool W4>
int smem_bytes(int Dp, int Hp) {
  return BM * Dp * 4 + BM * (Dp + 16) * 2 + BM * (Hp + 16) * 2 + hw_stage_bytes<W4>(BN);
}

template <bool W4>
__device__ __forceinline__ float scale(const float* s, int n) { return W4 ? s[n] : 1.0f; }

template <bool W4, class T, class TO>
__global__ void __launch_bounds__(THREADS) kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Dp = a.Dp, Hp = a.Hp;
  const int lda = Dp + 16, ldh = Hp + 16;
  float* Z = reinterpret_cast<float*>(smem);                          // [BM][Dp] z1, fp32
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(Z + BM * Dp);  // [BM][lda] attn, then h2
  __nv_bfloat16* Hs = As + BM * lda;                                  // [BM][ldh] gelu(FC1)
  void* Bs = Hs + BM * ldh;                                           // 2 weight stages
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, a.M - m0);
  const T* y = static_cast<const T*>(a.y);
  TO* out = static_cast<TO*>(a.out);

  // 1. the attn tile, 16 bytes per copy (rows past M zero-filled); the
  //    proj loop's first wait and barrier order it before any read
  const int cpr = Dp / 8;
  for (int e = threadIdx.x; e < BM * cpr; e += THREADS) {
    const int r = e / cpr, c = (e - r * cpr) * 8;
    const bool v = r < rows;
    cp_async16(As + r * lda + c, v ? a.attn + (size_t)(m0 + r) * Dp + c : a.attn, v);
  }
  cp_async_commit();

  // 2. proj: z1 = x + fma(acc, s, b) into Z
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    HTile<BM, BN, 2, 4> tile;
    mainloop_resident_hw<W4, decltype(tile), BN>(tile, As, lda, Bs, a.wproj, Dp, Dp, n0);
    for_pairs(tile, [&](int r, int c, float v0, float v1) {
      const int n = n0 + c;
      float x0 = 0.0f, x1 = 0.0f;
      if (r < rows) {
        x0 = load_f(y + (size_t)(m0 + r) * Dp + n);
        x1 = load_f(y + (size_t)(m0 + r) * Dp + n + 1);
      }
      *reinterpret_cast<float2*>(Z + r * Dp + n) = make_float2(
          __fadd_rn(x0, __fmaf_rn(v0, scale<W4>(a.sproj, n), a.bproj[n])),
          __fadd_rn(x1, __fmaf_rn(v1, scale<W4>(a.sproj, n + 1), a.bproj[n + 1])));
    });
  }
  __syncthreads();

  // 3. h2 = bf16(LN2(z1)) into As (one warp per row)
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += THREADS / 32) {
      float v[ROW_REGS];
#pragma unroll
      for (int j = 0; j < ROW_REGS; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < Dp ? Z[r * Dp + c] : 0.0f;
      }
      ln_bf16_row(v, Dp, a.ln, a.ln + Dp, a.inv_n, As + r * lda);
    }
  }

  // 4. FC1 + bias + gelu -> bf16 into Hs
  const bool tanh_approx = a.gelu_tanh != 0;
  for (int n0 = 0; n0 < Hp; n0 += BN) {
    HTile<BM, BN, 2, 4> tile;
    mainloop_resident_hw<W4, decltype(tile), BN>(tile, As, lda, Bs, a.wfc1, Hp, Dp, n0);
    for_pairs(tile, [&](int r, int c, float v0, float v1) {
      const int n = n0 + c;
      *reinterpret_cast<__nv_bfloat162*>(Hs + r * ldh + n) = __floats2bfloat162_rn(
          gelu(__fmaf_rn(v0, scale<W4>(a.sfc1, n), a.bfc1[n]), tanh_approx),
          gelu(__fmaf_rn(v1, scale<W4>(a.sfc1, n + 1), a.bfc1[n + 1]), tanh_approx));
    });
  }

  // 5. FC2 + bias + residual -> out, in the weight format's association
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    HTile<BM, BN, 2, 4> tile;
    mainloop_resident_hw<W4, decltype(tile), BN>(tile, Hs, ldh, Bs, a.wfc2, Dp, Hp, n0);
    for_pairs(tile, [&](int r, int c, float v0, float v1) {
      if (r >= rows) return;
      const int n = n0 + c;
      float o0, o1;
      if constexpr (W4) {
        o0 = __fadd_rn(Z[r * Dp + n], __fmaf_rn(v0, a.sfc2[n], a.bfc2[n]));
        o1 = __fadd_rn(Z[r * Dp + n + 1], __fmaf_rn(v1, a.sfc2[n + 1], a.bfc2[n + 1]));
      } else {
        o0 = __fadd_rn(__fadd_rn(Z[r * Dp + n], v0), a.bfc2[n]);
        o1 = __fadd_rn(__fadd_rn(Z[r * Dp + n + 1], v1), a.bfc2[n + 1]);
      }
      TO* dst = out + (size_t)(m0 + r) * Dp + n;
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o0, o1);
      }
    });
  }
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; attn: bf16 [M, Dp] (16-byte aligned);
// ln: fp32 [2, Dp]; weights, scales as Args; biases fp32 rows; out: [M, Dp]
// bf16 (out_f32 = 0) or fp32. Dp, Hp multiples of 64, Dp <= 512.
template <bool W4>
int launch(const void* y, int y_f32, const __nv_bfloat16* attn, const void* wproj,
           const float* sproj, const float* bproj, const float* ln, const void* wfc1,
           const float* sfc1, const float* bfc1, const void* wfc2, const float* sfc2,
           const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp, int d_valid,
           int gelu_tanh, void* stream) {
  const int smem = smem_bytes<W4>(Dp, Hp);
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || Hp <= 0 || Hp % 64 != 0 ||
      d_valid <= 0 || d_valid > Dp || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a{y, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, M, Dp,
               Hp, (float)(1.0 / (double)d_valid), gelu_tanh};
  using BF = __nv_bfloat16;
  void (*const ks[2][2])(const Args) = {
      {kernel<W4, BF, BF>, kernel<W4, BF, float>},
      {kernel<W4, float, BF>, kernel<W4, float, float>}};
  void (*k)(const Args) = ks[y_f32 != 0][out_f32 != 0];
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace post_h
}  // namespace dlq
