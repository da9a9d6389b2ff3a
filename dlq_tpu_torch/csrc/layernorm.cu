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
// byte).
//
// Two forms of K16, picked by a static rule (dlq_layernorm_form;
// ops/layernorm.py: layernorm_form mirrors it).
//
// The first form (ln_kernel; K17's only form): one warp per row, 8 rows per
// 256-thread block; a row of D <= 512 (DeiT's 192) is read once into
// registers (ROW_REGS per lane), its moments reduced by butterflies, and
// normalized from the registers; a longer row is read twice (moments, then
// normalize), never refused. Lanes read consecutive elements: every load and
// store of a warp is coalesced, but a 192-lane bf16 row goes out as six
// 64-byte warp loads, 384 bytes in flight a warp: the form reaches half the
// byte rate of its fp32 twin.
//
// The Hopper form (ln_hopper_kernel; K16 where D <= 512, rows a multiple of
// 16 bytes, x and out 16-byte aligned: DeiT's [50432, 192] in bf16 and in
// fp32). What held the first form was not bytes in flight but instructions
// a row: ROW_REGS = 16 column slots a lane, predicated, for DeiT's 6, and g
// and b loaded again for every row. The Hopper form compiles the slots a
// lane (NJ = D / 32 rounded up) and keeps g and b in registers for the
// whole kernel. A persistent grid of HOPPER_BLOCKS blocks an SM walks tiles
// of the rows of STAGE_BYTES (32 bf16 or 16 fp32 rows of 192): thread 0
// keeps STAGES tiles in flight by bulk copies (cp.async.bulk, counted by
// an mbarrier a stage); each warp reads its rows from the stage in the
// first form's lane order (lane l: columns l + 32 j), runs ln_row's steps
// (the same moments, butterfly and _rn operations, so every output equals
// the first form's), writes its outputs over its row, and thread 0 hands
// the stage to a bulk store, refilling it once the store has read it.
#include "launch.cuh"
#include "sm90.cuh"
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

constexpr int STAGE_BYTES = 12288;   // the rows of a tile
constexpr int STAGES = 4;            // tiles in flight a block
constexpr int HOPPER_BLOCKS = 4;     // blocks an SM

// The Hopper form of K16 (see the top of the file) for rows of D <= 32 NJ.
template <class T, int NJ>
__global__ void __launch_bounds__(THREADS) ln_hopper_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t stage[];
  const int D = a.D, rb = D * (int)sizeof(T), rows = STAGE_BYTES / rb, sbytes = rows * rb;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + STAGES * sbytes);
  const int tiles = (a.M + rows - 1) / rows;
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;   // grid <= tiles
  const uint8_t* src = static_cast<const uint8_t*>(a.y);
  uint8_t* dst = static_cast<uint8_t*>(a.h);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(full + s, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int i) {   // this block's tile i into stage i % STAGES
    const int r0 = (blockIdx.x + i * gridDim.x) * rows, nr = min(rows, a.M - r0);
    sm90::expect_tx(full + i % STAGES, nr * rb);
    sm90::bulk_load(stage + (i % STAGES) * sbytes, src + (size_t)r0 * rb, nr * rb,
                    full + i % STAGES);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES && i < mine; ++i) load(i);
  const int lane = threadIdx.x & 31;
  float gv[NJ], bv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    gv[j] = c < D ? load_f(static_cast<const T*>(a.g) + c) : 0.0f;
    bv[j] = c < D ? load_f(static_cast<const T*>(a.b) + c) : 0.0f;
  }
  for (int i = 0; i < mine; ++i) {
    const int s = i % STAGES, r0 = (blockIdx.x + i * gridDim.x) * rows, nr = min(rows, a.M - r0);
    sm90::mbar_wait(full + s, (i / STAGES) & 1);
    for (int r = threadIdx.x >> 5; r < nr; r += ROWS) {
      T* row = reinterpret_cast<T*>(stage + s * sbytes) + (size_t)r * D;
      float v[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < D ? load_f(row + c) : 0.0f;
      }
      // ln_row's steps on NJ slots (each lane writes only the columns it read)
      float sum = 0.0f, sq = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (lane + 32 * j < D) ln_acc(sum, sq, v[j]);
      float mu, rs;
      ln_stats(sum, sq, a.inv_n, a.eps, mu, rs);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) store_f(row + c, ln_apply(v[j], mu, rs, gv[j], bv[j]));
      }
    }
    sm90::fence_proxy_async();   // the rows' st.shared, to the bulk store's reads
    __syncthreads();
    if (threadIdx.x == 0) {
      sm90::bulk_store(dst + (size_t)r0 * rb, stage + s * sbytes, nr * rb);
      if (i + STAGES < mine) {
        sm90::bulk_wait_read<0>();   // the store has read the stage: refill it
        load(i + STAGES);
      }
    }
  }
  if (threadIdx.x == 0) sm90::bulk_wait_all();
}

using BF = __nv_bfloat16;
using Kernel = void (*)(const Args);

bool hopper_takes(int D, int esize) { return D <= 32 * ROW_REGS && (D * esize) % 16 == 0; }

template <class T, int NJ>
int launch_hopper_t(const Args& a, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = dlq::device(&dev, &sms);   // once per device (launch.cuh)
  if (e == cudaSuccess) e = dlq::opt_in<ln_hopper_kernel<T, NJ>>(dev);
  if (e != cudaSuccess) return (int)e;
  const int rows = STAGE_BYTES / (a.D * (int)sizeof(T)), tiles = (a.M + rows - 1) / rows;
  const int grid = tiles < HOPPER_BLOCKS * sms ? tiles : HOPPER_BLOCKS * sms;
  const int smem = STAGES * rows * a.D * (int)sizeof(T) + 8 * STAGES;
  ln_hopper_kernel<T, NJ><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int launch(Kernel k, const Args& a, void* stream) {
  if (a.M == 0) return 0;
  k<<<(a.M + ROWS - 1) / ROWS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

bool bad(int M, int D) { return M < 0 || D <= 0; }

int launch_first(const Args& a, int x_f32, void* stream) {
  return launch(x_f32 ? ln_kernel<float, float, false> : ln_kernel<BF, BF, false>, a, stream);
}

int launch_hopper(const Args& a, int x_f32, void* stream) {
  if (a.M == 0) return 0;
  switch ((a.D + 31) / 32 * 2 + (x_f32 ? 1 : 0)) {
#define DLQ_LN_HOPPER(NJ)                                      \
  case 2 * NJ: return launch_hopper_t<BF, NJ>(a, stream);      \
  case 2 * NJ + 1: return launch_hopper_t<float, NJ>(a, stream);
    DLQ_LN_HOPPER(1) DLQ_LN_HOPPER(2) DLQ_LN_HOPPER(3) DLQ_LN_HOPPER(4) DLQ_LN_HOPPER(5)
    DLQ_LN_HOPPER(6) DLQ_LN_HOPPER(7) DLQ_LN_HOPPER(8) DLQ_LN_HOPPER(9) DLQ_LN_HOPPER(10)
    DLQ_LN_HOPPER(11) DLQ_LN_HOPPER(12) DLQ_LN_HOPPER(13) DLQ_LN_HOPPER(14) DLQ_LN_HOPPER(15)
    DLQ_LN_HOPPER(16)
#undef DLQ_LN_HOPPER
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K16's form: 1 the Hopper form, 0 the first form. A static rule: D <= 512
// and rows a multiple of 16 bytes, x and out 16-byte aligned (`aligned`);
// not the batch or the card.
extern "C" int dlq_layernorm_form(int M, int D, int x_f32, int aligned) {
  return M > 0 && aligned && hopper_takes(D, x_f32 ? 4 : 2) ? 1 : 0;
}

// K16. x, out, g, b: bf16 (x_f32 = 0) or fp32.
extern "C" int dlq_layernorm(const void* x, int x_f32, const void* g, const void* b, void* out,
                             int M, int D, float eps, void* stream) {
  if (bad(M, D)) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, g, b, nullptr, out, M, D, (float)(1.0 / (double)D), eps};
  const int aligned = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  return dlq_layernorm_form(M, D, x_f32, aligned) ? launch_hopper(a, x_f32, stream)
                                                  : launch_first(a, x_f32, stream);
}

// K16's first form at any shape (what the card tests and chip_smoke.py
// hold the Hopper form to, output for output).
extern "C" int dlq_layernorm_first(const void* x, int x_f32, const void* g, const void* b,
                                   void* out, int M, int D, float eps, void* stream) {
  if (bad(M, D)) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, g, b, nullptr, out, M, D, (float)(1.0 / (double)D), eps};
  return launch_first(a, x_f32, stream);
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
