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
// Design: one block of 256 threads per 64 rows. Each row is whole in the
// block (Dp <= 512), so LN is a prologue: each warp normalizes 8 rows from
// registers and writes their int8 codes into a shared A tile that stays
// resident for the whole GEMM (64 x (Dp + 16) bytes); the weight streams
// through shared memory in 64-byte K slices (two cp.async stages), 64 qkv
// columns at a time on mma.sync.m16n8k32. The residual is read once and
// qkv written once; the int8 activations never reach device memory.
#include "vit_common.cuh"

namespace {

using namespace dlq;

constexpr int BM = 64;
constexpr int BN = 64;

struct Args {
  const void* y;
  const float* ln;  // [2, Dp]: g, b
  const int8_t* w;
  const float* s;
  const float* b;
  __nv_bfloat16* out;
  int M, Dp;
  float inv_n, inv_q;
};

template <class T>
__global__ void __launch_bounds__(THREADS) vit_pre_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = a.Dp + 16;
  int8_t* As = smem;               // [BM][lda] int8 codes of LN1(x)
  int8_t* Bs = As + BM * lda;      // 2 stages x BN rows x LDS
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
    mainloop_resident_a<decltype(tile), BN>(tile, As, lda, Bs, a.w, N, a.Dp, n0);
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

template <class T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = BM * (a.Dp + 16) + 2 * BN * LDS;
  cudaError_t e = cudaFuncSetAttribute(vit_pre_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  vit_pre_kernel<T><<<(a.M + BM - 1) / BM, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y: [M, Dp] bf16 (y_f32 == 0) or fp32; ln: fp32 [2, Dp]; w: int8 [3 Dp, Dp]
// K-major; s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp]. Dp a multiple of 64, <= 512.
extern "C" int dlq_vit_pre_w8(const void* y, int y_f32, const float* ln, const int8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, float inv_q, void* stream) {
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || d_valid <= 0 || d_valid > Dp)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid), inv_q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_f32 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st));
}
