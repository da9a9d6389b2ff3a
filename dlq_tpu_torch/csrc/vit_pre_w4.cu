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
// against 11 GFLOP of bf16 products). Design: K8's layer structure with
// bf16 A: one block of 256 threads per 64 rows; LN is a prologue (one warp
// per row, from registers) that writes the bf16 h1 tile into shared memory,
// resident for the whole GEMM (64 x (Dp + 16) bf16); the packed weight
// streams through two cp.async stages of 32 bytes per column (64 K values)
// and is unpacked in registers into two m16n8k16 B fragments per 32-bit word
// (hgemm.cuh: step_h4), 64 qkv columns at a time. The residual is read once
// and qkv written once; h1 never reaches device memory.
#include "vit_common.cuh"

namespace {

using namespace dlq;

constexpr int BM = 64;
constexpr int BN = 64;

struct Args {
  const void* y;
  const float* ln;       // [2, Dp]: LN1 g, b
  const uint8_t* w;      // [3 Dp, Dp / 2] halves-packed bytes
  const float* s;        // [3 Dp]
  const float* b;        // [3 Dp]
  __nv_bfloat16* out;    // [M, 3 Dp]
  int M, Dp;
  float inv_n;
};

int smem_bytes(int Dp) { return BM * (Dp + 16) * 2 + 2 * BN * LDS4; }

template <class T>
__global__ void __launch_bounds__(THREADS) vit_pre_w4_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = a.Dp + 16;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);        // [BM][lda] bf16 LN1(x)
  int8_t* Bs = reinterpret_cast<int8_t*>(As + BM * lda);            // 2 weight stages
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
    mainloop_resident_h4<decltype(tile), BN>(tile, As, lda, Bs, a.w, N, a.Dp, n0);
    for_pairs(tile, [&](int r, int c, float v0, float v1) {
      const int m = m0 + r, n = n0 + c;
      if (m >= a.M) return;
      *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)m * N + n) = __floats2bfloat162_rn(
          __fmaf_rn(v0, a.s[n], a.b[n]), __fmaf_rn(v1, a.s[n + 1], a.b[n + 1]));
    });
  }
}

}  // namespace

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: uint8 [3 Dp, Dp / 2];
// s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
extern "C" int dlq_vit_pre_w4(const void* y, int y_f32, const float* ln, const uint8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, void* stream) {
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || d_valid <= 0 || d_valid > Dp)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid)};
  void (*const ks[2])(const Args) = {vit_pre_w4_kernel<__nv_bfloat16>, vit_pre_w4_kernel<float>};
  void (*k)(const Args) = ks[y_f32 != 0];
  const int smem = smem_bytes(Dp);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
