// K10: W4A8 GEMM: int8 activations against int4 per-OC weights with int32
// sums and K2's fused fp32 epilogue.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int4a8_matmul (:208) and
// int4a8_matmul_cached (:318): one function (the cached kernel only keeps
// the nibble unpack across the M tiles of the TPU grid):
//   acc = x[M, K] @ W[K, N]    (int8 x int4 -> int32)
//   y = fma(float(acc), scale[n], bias[n]);  y = max(y, 0) if relu    -> fp32 [M, N]
// W: halves-packed K-major [N, Kp/2] bytes (Kp: K rounded up to 64, rows
// past K zero): byte k of row n holds W[k][n] in its low nibble and
// W[k + Kp/2][n] in its high nibble, repacked once at load from the store's
// adjacent-row packing (ops/matmul_int4a8.py: pack_int4a8_weight).
//
// Bound: bytes at every DeiT-Tiny deploy site (M = batch x 197 rows, K and
// N 192..768: ~100-300 int8 operations per byte, below the card's ridge of
// ~590). Design: K2's block tile (128 x 128, or 128 x 64 for N <= 64; A and
// B both streamed through two cp.async stages; mma.sync.m16n8k32), with the
// weight streamed packed, 32 bytes of each row per stage (half of K2's weight
// bytes), and unpacked in registers at fragment load (igemm.cuh: step_w4).
// A stage holds the 32 A columns of each half, [32 kt, 32 kt + 32) and
// [Kp/2 + 32 kt, ...), 64 bytes a row as in K2. Any M, N and even K: A
// columns past K and rows past M are zero-filled, outputs past M or N are
// not written. The int32 sums are exact in any order, so the kernel is
// bit-identical to its plain version.
#include "igemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const uint8_t* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, N, K, Kp;
  int relu;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(THREADS) matmul_int4a8_kernel(const Args a) {
  __shared__ __align__(16) int8_t As[2 * BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * BN * LDS4];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Kh = a.Kp / 2, KT = Kh / BK4;
  constexpr int CH = BM * (BK / 16) / THREADS;

  auto load = [&](int8_t* as, int8_t* bs, int kt) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int chunk = threadIdx.x + j * THREADS;
      const int r = chunk >> 2, q = chunk & 3;
      const int m = m0 + r;
      const int k = (q < 2 ? 0 : Kh) + kt * BK4 + (q & 1) * 16;   // low half, then high
      int8_t* dst = as + r * LDS + q * 16;
      if (VEC) {
        const bool v = m < a.M && k < a.K;
        cp_async16(dst, v ? a.x + (size_t)m * a.K + k : a.x, v);
      } else {
        for (int b = 0; b < 16; ++b)
          dst[b] = (m < a.M && k + b < a.K) ? a.x[(size_t)m * a.K + k + b] : (int8_t)0;
      }
    }
    load_b4<BN>(bs, a.w, a.N, Kh, n0, kt);
  };

  MmaTile<BM, BN, WARPS_M, WARPS_N> tile;
  tile.zero();
  load(As, Bs, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load(As + (s ^ 1) * BM * LDS, Bs + (s ^ 1) * BN * LDS4, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* as = As + s * BM * LDS;
    tile.step_w4(as, as + BK4, LDS, Bs + s * BN * LDS4);
    __syncthreads();
  }
  cp_async_wait<0>();

  const bool relu = a.relu != 0;
  tile.for_each([&](int row, int col, int v) {
    const int m = m0 + row, n = n0 + col;
    if (m >= a.M || n >= a.N) return;
    a.out[(size_t)m * a.N + n] = epi_fma(v, a.scale[n], a.bias[n], relu);
  });
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.N + BN - 1) / BN));
  if (a.K % 16 == 0)
    matmul_int4a8_kernel<BM, BN, WM, WN, true><<<grid, THREADS, 0, stream>>>(a);
  else
    matmul_int4a8_kernel<BM, BN, WM, WN, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: int8 [M, K] (16-byte aligned rows when K % 16 == 0); w: uint8 [N, Kp/2];
// scale, bias: fp32 [N]; out: fp32 [M, N]. K even, Kp a multiple of 64, >= K.
extern "C" int dlq_matmul_int4a8(const int8_t* x, const uint8_t* w, const float* scale,
                                 const float* bias, float* out, int M, int N, int K, int Kp,
                                 int relu, void* stream) {
  if (K % 2 != 0 || Kp % BK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Args a{x, w, scale, bias, out, M, N, K, Kp, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? launch<128, 64, 4, 2>(a, s) : launch<128, 128, 2, 4>(a, s));
}
