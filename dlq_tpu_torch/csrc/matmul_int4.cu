// K13: W4A16 GEMM: bf16 activations against int4 weights with group-wise
// scales, fp32 sums, + bias, relu, fp32 out.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int4_matmul (:636, kernel
// _int4_mm_kernel :470-515) and int4_matmul_cached (:564, :518-558): one
// function (the cached kernel only keeps the dequantized tile across the M
// tiles of the TPU grid):
//   y[m, n] = sum_k bf16(x)[m, k] * bf16(bf16(W[k, n]) * bf16(s[k / g, n]))   fp32 sums
//   y += bias[n] (an fp32 add);  y = max(y, 0) if relu                        -> fp32 [M, N]
// The dequantized weight is rounded to bf16 once, after the exact product of
// the nibble and the bf16-rounded group scale, as the reference's
// lo.astype(bf16) * scales_h.astype(bf16) does. The sums run in the tensor
// core's order: another order than the reference's two de-interleaved dots
// (xe @ lo + xo @ hi, TPU tiling that is not ported), so the last bits of an
// output may differ.
// W: the store's adjacent packing (byte j of a column holds W[2j] in its low
// nibble and W[2j + 1] in its high nibble), repacked once at load K-major:
// [N, Kp/2] bytes, Kp = K rounded up to 64, zero past K; scales bf16 [N, G],
// G = ceil(Kp / g), zero past K / g (ops/matmul_int4.py: pack_int4_weight).
//
// Bound: bytes at DeiT-Tiny's group-wise sites (patch and fc2: M = 197 x
// batch, K = 768, N = 192: ~130 bf16 operations per byte, below the card's
// ridge of ~295). Design: a 128 x 64 block tile, A (bf16) and the packed B
// both streamed through two cp.async stages of 64 K values (A rows 160 bytes
// apart); the weight stays 4-bit up to the registers, where each 16-bit load
// of 4 nibbles becomes the two B registers of one m16n8k16 product
// (hgemm.cuh: step_g4). The grid walks the N tiles of one M tile together,
// so the activations are read from device memory about once. Any M and N; K
// a multiple of 16 and g a multiple of 16 (A columns past K and rows past M
// are zero-filled, outputs past M or N are not written).
#include "hgemm.cuh"

namespace {

using namespace dlq;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BKH = 64;          // K values per stage
constexpr int LDA = BKH + 16;    // bf16 A row stride: 160 bytes, 32 (mod 128)

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __nv_bfloat16* sc;
  const float* bias;
  float* out;
  int M, N, K, Kp, G, group;
  int relu;
};

__global__ void __launch_bounds__(THREADS) matmul_int4_kernel(const Args a) {
  __shared__ __align__(16) __nv_bfloat16 As[2 * BM * LDA];
  __shared__ __align__(16) int8_t Bs[2 * BN * LDS4];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int KT = a.Kp / BKH;
  constexpr int CH = BM * (BKH / 8) / THREADS;   // 16-byte A copies per thread

  auto load = [&](__nv_bfloat16* as, int8_t* bs, int kt) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int chunk = threadIdx.x + j * THREADS;
      const int r = chunk >> 3, c = (chunk & 7) * 8;
      const int m = m0 + r, k = kt * BKH + c;
      const bool v = m < a.M && k < a.K;
      cp_async16(as + r * LDA + c, v ? a.x + (size_t)m * a.K + k : a.x, v);
    }
    load_b4<BN>(bs, a.w, a.N, a.Kp / 2, n0, kt);
  };

  HTile<BM, BN, 2, 4> tile;
  tile.zero();
  load(As, Bs, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load(As + (s ^ 1) * BM * LDA, Bs + (s ^ 1) * BN * LDS4, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile.step_g4(As + s * BM * LDA, LDA, Bs + s * BN * LDS4, a.sc, a.G, n0, a.N, kt * BKH,
                 a.group);
    __syncthreads();
  }
  cp_async_wait<0>();

  const bool relu = a.relu != 0;
  const bool pairs = a.N % 2 == 0;
  for_pairs(tile, [&](int r, int c, float v0, float v1) {
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) return;
    float y0 = __fadd_rn(v0, a.bias[n]);
    y0 = relu ? fmaxf(y0, 0.0f) : y0;
    float* dst = a.out + (size_t)m * a.N + n;
    if (n + 1 >= a.N) {
      dst[0] = y0;
      return;
    }
    float y1 = __fadd_rn(v1, a.bias[n + 1]);
    y1 = relu ? fmaxf(y1, 0.0f) : y1;
    if (pairs) {
      *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    } else {
      dst[0] = y0;
      dst[1] = y1;
    }
  });
}

}  // namespace

// x: bf16 [M, K] (16-byte aligned); w: uint8 [N, Kp/2]; sc: bf16 [N, G];
// bias: fp32 [N]; out: fp32 [M, N]. K and group multiples of 16, Kp a
// multiple of 64 (>= K), G >= ceil(Kp / group).
extern "C" int dlq_matmul_int4(const __nv_bfloat16* x, const uint8_t* w, const __nv_bfloat16* sc,
                               const float* bias, float* out, int M, int N, int K, int Kp, int G,
                               int group, int relu, void* stream) {
  if (K <= 0 || K % 16 != 0 || group <= 0 || group % 16 != 0 || Kp % BKH != 0 || Kp < K ||
      G * group < Kp)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Args a{x, w, sc, bias, out, M, N, K, Kp, G, group, relu};
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  matmul_int4_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
