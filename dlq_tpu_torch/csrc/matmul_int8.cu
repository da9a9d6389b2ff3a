// K2: int8 GEMM with the fused fp32 epilogue of K1.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int8_matmul:
//   acc = x[M, K] @ w^T (w K-major [N, Kp], int32 accumulation)
//   out = fma(float(acc), scale[n], bias[n])  (fp32)
//
// Bound: bytes at the ResNet fc (M = batch, K = 512, N = 1000: every weight
// byte is used by only M rows); operations only for large square products. Design: the same block-tile tensor-core GEMM as K1
// with a plain row loader (A rows are contiguous K-byte rows), so each
// operand byte is read once per block tile and the epilogue writes the
// output once. The TPU kernel's sequential K grid axis with a VMEM
// accumulator becomes the in-block K loop with register accumulators.
#include "igemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, N, K, Kp;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(THREADS) matmul_int8_kernel(const Args a) {
  __shared__ __align__(16) int8_t As[2 * BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * BN * LDS];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  constexpr int CH = BM * (BK / 16) / THREADS;

  auto load = [&](int8_t* as, int8_t* bs, int kt) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int chunk = threadIdx.x + j * THREADS;
      const int r = chunk >> 2, q = chunk & 3;
      const int m = m0 + r;
      const int k = kt * BK + q * 16;
      int8_t* dst = as + r * LDS + q * 16;
      if (VEC) {
        const bool v = m < a.M && k < a.K;
        cp_async16(dst, v ? a.x + (size_t)m * a.K + k : a.x, v);
      } else {
        for (int b = 0; b < 16; ++b)
          dst[b] = (m < a.M && k + b < a.K) ? a.x[(size_t)m * a.K + k + b] : (int8_t)0;
      }
    }
    load_b<BN>(bs, a.w, a.N, a.Kp, n0, kt);
  };

  MmaTile<BM, BN, WARPS_M, WARPS_N> tile;
  mainloop<decltype(tile), BM, BN>(tile, As, Bs, a.Kp / BK, load);

  tile.for_each([&](int row, int col, int v) {
    const int m = m0 + row, n = n0 + col;
    if (m >= a.M || n >= a.N) return;
    a.out[(size_t)m * a.N + n] = epi_fma(v, a.scale[n], a.bias[n], false);
  });
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.N + BN - 1) / BN));
  if (a.K % 16 == 0)
    matmul_int8_kernel<BM, BN, WM, WN, true><<<grid, THREADS, 0, stream>>>(a);
  else
    matmul_int8_kernel<BM, BN, WM, WN, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dlq_matmul_int8(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, float* out, int M, int N, int K, int Kp,
                               void* stream) {
  Args a{x, w, scale, bias, out, M, N, K, Kp};
  if (Kp % BK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = N <= 64 ? launch<128, 64, 4, 2>(a, s) : launch<128, 128, 2, 4>(a, s);
  return (int)e;
}
