// K16 layernorm_fused and K17 residual_layernorm: the fused LayerNorms of
// the fp32 and quantized DeiT forwards with fused_ln=True.
//
// Replace dlq_tpu/ops/pallas_layernorm.py:layernorm_fused (:71, kernel
// _ln_kernel :44-47) and residual_layernorm (:105, kernel _res_ln_kernel
// :50-55). Per row of x [M, D] (d_valid = D), in fp32:
//   mu = sum(x) * (1/D),  m2 = sum(x*x) * (1/D),  var = max(m2 - mu^2, 0)
//   h  = ((x - mu) * rsqrt(var + eps)) * g + b                 -> x.dtype
// and for K17, with x = z = f32(y) + f32(delta):
//   z  -> y.dtype;  h = LN(z) taken from the unrounded fp32 z  -> y.dtype
// g, b arrive in the stream's dtype (x's or y's) and are read widened to
// fp32. Every operation is written with the _rn intrinsics (vit_common.cuh:
// ln_acc, ln_stats, ln_apply), so nvcc contracts nothing the reference does
// not have; rsqrtf is not correctly rounded, and the sums run lane-strided then
// by a warp butterfly, so an output may sit a few ulp from the reference's.
// The reference's row padding to 8 and its row blocks are TPU tiling and
// have no counterpart.
//
// Bound: bytes (at DeiT-Tiny's [50432, 192] 39 MB fp32 in and out for K16,
// 78 MB for K17: 0.023 and 0.046 ms; half that in bf16; a few FLOP per
// byte). Design: one warp per row, 8 rows per 256-thread block; a row of D
// <= 512 (DeiT's 192) is read once into registers (ROW_REGS per lane), its
// moments reduced by butterflies, and normalized from the registers; a
// longer row is read twice (moments, then normalize), never refused. Lanes
// read consecutive elements: every load and store of a warp is coalesced.
#include "vit_common.cuh"

namespace {

using namespace dlq;

constexpr int ROWS = THREADS / 32;   // rows per block, one warp each

struct Args {
  const void* y;       // x (K16) or y (K17), [M, D]
  const void* delta;   // K17: [M, D]
  const void* g;       // [D]
  const void* b;       // [D]
  void* z;             // K17: y + delta, [M, D] in y's dtype
  void* h;             // the normalized rows, [M, D] in y's dtype
  int M, D;
  float inv_n, eps;
};

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// TY: x / y (and z, h, g, b); TD: delta (K17 only: RES).
template <class TY, class TD, bool RES>
__global__ void __launch_bounds__(THREADS) ln_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS + warp;
  if (m >= a.M) return;
  const int D = a.D;
  const size_t base = (size_t)m * D;
  const TY* y = static_cast<const TY*>(a.y) + base;
  const TD* dl = RES ? static_cast<const TD*>(a.delta) + base : nullptr;
  TY* z = RES ? static_cast<TY*>(a.z) + base : nullptr;
  TY* h = static_cast<TY*>(a.h) + base;
  const TY* g = static_cast<const TY*>(a.g);
  const TY* b = static_cast<const TY*>(a.b);
  auto val = [&](int c) {
    float v = load_f(y + c);
    if constexpr (RES) v = __fadd_rn(v, load_f(dl + c));
    return v;
  };

  if (D <= 32 * ROW_REGS) {
    float v[ROW_REGS];
#pragma unroll
    for (int j = 0; j < ROW_REGS; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < D ? val(c) : 0.0f;
      if constexpr (RES) {
        if (c < D) store_f(z + c, v[j]);
      }
    }
    ln_row(v, D, g, b, a.inv_n, [&](int c, float o) { store_f(h + c, o); }, a.eps);
    return;
  }
  // a row longer than the registers hold: moments, then a second read
  float s = 0.0f, sq = 0.0f;
  for (int c = lane; c < D; c += 32) ln_acc(s, sq, val(c));
  float mu, r;
  ln_stats(s, sq, a.inv_n, a.eps, mu, r);
  for (int c = lane; c < D; c += 32) {
    const float v = val(c);
    if constexpr (RES) store_f(z + c, v);
    store_f(h + c, ln_apply(v, mu, r, load_f(g + c), load_f(b + c)));
  }
}

using BF = __nv_bfloat16;
using Kernel = void (*)(const Args);

int launch(Kernel k, const Args& a, void* stream) {
  if (a.M == 0) return 0;
  k<<<(a.M + ROWS - 1) / ROWS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

bool bad(int M, int D) { return M < 0 || D <= 0; }

}  // namespace

// K16. x, out, g, b: bf16 (x_f32 = 0) or fp32.
extern "C" int dlq_layernorm(const void* x, int x_f32, const void* g, const void* b, void* out,
                             int M, int D, float eps, void* stream) {
  if (bad(M, D)) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, g, b, nullptr, out, M, D, (float)(1.0 / (double)D), eps};
  return launch(x_f32 ? ln_kernel<float, float, false> : ln_kernel<BF, BF, false>, a, stream);
}

// K17. y, z, h, g, b: bf16 (y_f32 = 0) or fp32; delta: bf16 (d_f32 = 0) or
// fp32.
extern "C" int dlq_residual_layernorm(const void* y, int y_f32, const void* delta, int d_f32,
                                      const void* g, const void* b, void* z, void* h, int M,
                                      int D, float eps, void* stream) {
  if (bad(M, D)) return (int)cudaErrorInvalidValue;
  const Kernel ks[2][2] = {{ln_kernel<BF, BF, true>, ln_kernel<BF, float, true>},
                           {ln_kernel<float, BF, true>, ln_kernel<float, float, true>}};
  const Args a{y, delta, g, b, z, h, M, D, (float)(1.0 / (double)D), eps};
  return launch(ks[y_f32 != 0][d_f32 != 0], a, stream);
}
