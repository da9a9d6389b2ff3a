// K2: int8 GEMM with K1's fused fp32 / int8 epilogue.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int8_matmul (fp32 out, optional
// relu) and carries the int8-out epilogue of the reference's mm1x1 rewrite
// (FullFusedCtx.conv on a 1x1/s1 conv, model_quant.py:403-430):
//   acc = x[M, K] @ w^T (w K-major [N, Kp], int32 accumulation)
//   y = fma(float(acc), scale[n], bias[n]), relu
//   out = y (fp32) | clip(rint(y / out_scale), relu ? 0 : -127, 127) (int8)
//
// Bound: bytes at the ResNet fc (M = batch: every weight byte is used by
// only M rows) and at the 1x1 body convs of ResNet-50 (M = N*H*W up to
// 802,816 rows, K and N 64..2048: 64 to ~1000 int8 operations per byte, the
// narrow ones far below the card's ridge of ~590). Design: the same
// block-tile tensor-core GEMM as K1 with a plain row loader (A rows are
// contiguous K-byte rows), so each operand byte is read once per block tile,
// and the epilogue writes the output once, int8 when the consumer takes
// int8. 128x64 tiles for N <= 64 (ResNet-50 layer1's reduce convs), 128x128
// otherwise. The TPU kernel's sequential K grid axis with a VMEM accumulator
// becomes the in-block K loop with register accumulators.
#include "igemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int M, N, K, Kp;
  int relu, out_int8;
  float out_scale;
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

  const bool relu = a.relu != 0;
  const float lo = relu ? 0.0f : -127.0f;
  tile.for_each([&](int row, int col, int v) {
    const int m = m0 + row, n = n0 + col;
    if (m >= a.M || n >= a.N) return;
    const float y = epi_fma(v, a.scale[n], a.bias[n], relu);
    const size_t o = (size_t)m * a.N + n;
    if (a.out_int8)
      static_cast<int8_t*>(a.out)[o] = requant_div(y, a.out_scale, lo);
    else
      static_cast<float*>(a.out)[o] = y;
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
                               const float* bias, void* out, int M, int N, int K, int Kp,
                               int relu, int out_int8, float out_scale, void* stream) {
  Args a{x, w, scale, bias, out, M, N, K, Kp, relu, out_int8, out_scale};
  if (Kp % BK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = N <= 64 ? launch<128, 64, 4, 2>(a, s) : launch<128, 128, 2, 4>(a, s);
  return (int)e;
}
