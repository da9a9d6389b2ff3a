// K10: W4A8 GEMM: int8 activations against int4 per-OC weights with int32
// sums and K2's fused fp32 epilogue.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int4a8_matmul (def :208, its
// pallas_call :255) and int4a8_matmul_cached (:318 / :353): one function (the
// cached kernel only keeps the nibble unpack across the M tiles of the TPU
// grid):
//   acc = x[M, K] @ W[K, N]    (int8 x int4 -> int32)
//   y = fma(float(acc), scale[n], bias[n]);  y = max(y, 0) if relu    -> fp32 [M, N]
// W: halves-packed K-major [N, Kp/2] bytes (Kp: K rounded up to 64, rows
// past K zero): byte k of row n holds W[k][n] in its low nibble and
// W[k + Kp/2][n] in its high nibble, repacked once at load from the store's
// adjacent-row packing (ops/matmul_int4a8.py: pack_int4a8_weight). The int32
// sums are exact in any order, so the kernel is bit-identical to its plain
// version, and to K2 on the materialized int8 weights.
//
// Bound: bytes at every DeiT-Tiny deploy site (M = batch x 197 rows, K and
// N 192..768: 100-300 int8 operations per byte, under the card's ridge of
// ~590), and the fp32 output is most of them: 94% at fc1 (50,432 x 768),
// 92% at qkv, 80% at proj, 50% at patch and fc2 (K = 768).
//
// Design (Hopper, w4gemm.cuh's body; the first form below serves a Kp
// whose 64-column packed slice does not fit beside the ring, and K % 16 !=
// 0, whose A rows are not 16-byte aligned, which TMA refuses). Limiters of
// the first form (one 128 x 128 block tile per block, 2364 blocks at fc1)
// and what removes them:
//  1. the fp32 output written 4 bytes a store after the K loop, overlapped
//     with nothing: each consumer warp stages 8 rows at a time in shared
//     memory and hands each row to the bulk-copy engine (cp.async.bulk, 16
//     bytes a beat), which writes them while the consumers run the next
//     item's products on stages that landed during the epilogue;
//  2. three-step K loops behind two block barriers each, A copied 16 bytes
//     a thread: no block barrier; A arrives by TMA (two 2D boxes a stage,
//     issued by one thread), stages are handed over by mbarriers, and the
//     producer warpgroup runs up to the ring's depth ahead, across items;
//  3. the weight streamed again by every block: each block keeps its N
//     slice resident in shared memory, packed (4 bits a value, read from L2
//     in half K2's bytes, once per block), and the producers unpack one
//     64-K stage of it at a time into the int8 wgmma operand (branch-free:
//     4 operations a word), once per 128-row item for both consumers;
//  4. waves of short blocks: a persistent grid of at most one block per SM
//     (132 at every large site); at the head (M = 256) the slices narrow
//     to 64 columns so that 32 blocks share the work, not 16.
// Products: int8 wgmma m64nNk32 (s8 x s8 -> s32, sm90.cuh), N = the slice
// width, both operands K-major in shared memory. An A stage is two boxes
// (32-byte swizzle) of A columns [32 s, 32 s + 32) and [Kp/2 + 32 s, ...)
// of 128 rows, and the matching B stage the low and the high nibbles of
// packed bytes [32 s, 32 s + 32) of each slice column, so one packed read
// feeds both halves' k32 steps. A columns past K and rows past M read as
// zeros; outputs past M or N are not written (4-byte stores when N % 4 !=
// 0).
//
// Shared memory per DeiT-Tiny site (make_plan: the ring, 8 KB of A and
// slice x 64 bytes of B a stage; the packed slice, slice x (Kp/2 + 16); the
// epilogue table, 8 bytes a column; the output staging, 64 rows of slice x
// 4 + 32 bytes; 16 bytes of mbarriers a stage), of the 232,448 allowed
// after the opt-in:
//   patch, fc2 (K 768, N 192): slice 192, 5 stages: 102,400 + 76,800
//     + 1,536 + 51,200 + 80 = 232,016;
//   qkv (K 192, N 576): slice 192, 3 slices, 7 stages: 143,360 + 21,504
//     + 1,536 + 51,200 + 112 = 217,712;
//   proj (K 192, N 192): the same, 1 slice: 217,712;
//   fc1 (K 192, N 768): slice 256, 3 slices, 5 stages: 122,880 + 28,672
//     + 2,048 + 67,584 + 80 = 221,264;
//   head (M 256, K 192, N 1000): slice 64, 16 slices, 8 stages: 98,304
//     + 7,168 + 512 + 18,432 + 128 = 124,544.
#include "w4gemm.cuh"

namespace {

using namespace dlq;
using w4::Args;
using w4::Plan;

// The Hopper form's operation.
struct W4A8 {
  using Acc = int;
  static constexpr int ESIZE = 1;   // A bytes a K value: a stage is Kp / 64 of K
  // an A stage is two TMA boxes of 128 rows x 32 bytes (32-byte swizzle):
  // columns [32 s, 32 s + 32) of the low half, then of the high half
  static constexpr int A_BOXES = 2;
  __device__ static int box_x(const Args& a, int s, int b) { return (b ? a.Kp / 2 : 0) + 32 * s; }
  // k-step j of consumer cw: box j, rows 64 cw ..
  __device__ static uint64_t a_desc(const int8_t* stage, int cw, int j) {
    return w4::desc_sw(stage + j * (w4::A_STAGE / 2) + cw * 64 * 32, 8 * 32, 3);
  }
  __host__ __device__ static int extras_bytes(const Args&, int) { return 0; }
  __host__ __device__ static int table_bytes(int ns) { return ns * 8; }
  __device__ static void load_extras(const Args&, uint8_t*, int, int, int, int) {}
  // {scale[n], scale[n + 1], bias[n], bias[n + 1]} for each column pair (0 past N)
  __device__ static void load_table(const Args& a, uint8_t* table, int n0, int ns, int tid,
                                    int nthreads) {
    float4* t = reinterpret_cast<float4*>(table);
    for (int i = tid; i < ns / 2; i += nthreads) {
      const int n = n0 + 2 * i;
      t[i] = make_float4(n < a.N ? a.scale[n] : 0.0f, n + 1 < a.N ? a.scale[n + 1] : 0.0f,
                         n < a.N ? a.bias[n] : 0.0f, n + 1 < a.N ? a.bias[n + 1] : 0.0f);
    }
  }
  // B stage s: the low nibbles of packed bytes [32 s, 32 s + 32) of each
  // column at stage bytes 0..31, their high nibbles at 32..63, sign-extended
  // (unit u = q NS + n: 16 packed bytes; a thread's NS / 64 units are loaded
  // first, then unpacked and stored, with no branch between them)
  template <int NS>
  __device__ static void build(const Args&, int8_t* stage, const uint8_t* packed, int ldp,
                               const uint8_t*, int s, int pt) {
    constexpr int PER = 2 * NS / w4::PRODUCERS;
    uint4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = pt + i * w4::PRODUCERS, q = u >= NS, n = u - q * NS;
      v[i] = *reinterpret_cast<const uint4*>(packed + n * ldp + 32 * s + 16 * q);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = pt + i * w4::PRODUCERS, q = u >= NS, n = u - q * NS;
      *reinterpret_cast<uint4*>(stage + sm90::core_off(n, 16 * q, w4::KS)) =
          make_uint4(nib_sx(v[i].x), nib_sx(v[i].y), nib_sx(v[i].z), nib_sx(v[i].w));
      *reinterpret_cast<uint4*>(stage + sm90::core_off(n, 32 + 16 * q, w4::KS)) =
          make_uint4(nib_sx(v[i].x >> 4), nib_sx(v[i].y >> 4), nib_sx(v[i].z >> 4),
                     nib_sx(v[i].w >> 4));
    }
  }
  template <int NS>
  __device__ static void mma(int (&acc)[NS / 2], uint64_t da, uint64_t db) {
    sm90::wgmma_s8<NS>(acc, da, db);
  }
  __device__ static float2 epi(const Args& a, int v0, int v1, const uint8_t* table, int pair) {
    const float4 sb = reinterpret_cast<const float4*>(table)[pair];
    const bool relu = a.relu != 0;
    return make_float2(epi_fma(v0, sb.x, sb.z, relu), epi_fma(v1, sb.y, sb.w, relu));
  }
};

Plan plan(int M, int N, int Kp, int sms) {
  return w4::make_plan(M, N, Kp, sms, [](int ns) { return W4A8::table_bytes(ns); });
}

// ---- the first form: K2's block tile, both operands streamed through two
// cp.async stages, the weight unpacked in registers (igemm.cuh: step_w4);
// for a Kp whose 64-column packed slice does not fit beside the rings, and
// for K % 16 != 0 (A bytes loaded one at a time) ----
struct FirstArgs {
  const int8_t* x;
  const uint8_t* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, N, K, Kp;
  int relu;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(THREADS) matmul_int4a8_first_kernel(const FirstArgs a) {
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
cudaError_t launch_first(const FirstArgs& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.N + BN - 1) / BN));
  if (a.K % 16 == 0)
    matmul_int4a8_first_kernel<BM, BN, WM, WN, true><<<grid, THREADS, 0, stream>>>(a);
  else
    matmul_int4a8_first_kernel<BM, BN, WM, WN, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The Hopper form's launch plan: out = {slice width (0: the first form),
// slices, ring stages, shared-memory bytes, blocks} for M x N, Kp on `sms`
// SMs (0: this card's). A K % 16 != 0 runs the first form whatever the plan.
extern "C" int dlq_matmul_int4a8_plan(int M, int N, int Kp, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = w4::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p = plan(M, N, Kp, sms);
  out[0] = p.ns, out[1] = p.slices, out[2] = p.stages, out[3] = p.smem, out[4] = p.grid;
  return 0;
}

// x: int8 [M, K] (16-byte aligned rows when K % 16 == 0); w: uint8 [N, Kp/2];
// scale, bias: fp32 [N]; out: fp32 [M, N]. K even, Kp a multiple of 64, >= K.
extern "C" int dlq_matmul_int4a8(const int8_t* x, const uint8_t* w, const float* scale,
                                 const float* bias, float* out, int M, int N, int K, int Kp,
                                 int relu, void* stream) {
  if (K % 2 != 0 || Kp % BK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  const cudaError_t e = w4::device(&dev, &sms);
  if (e != cudaSuccess) return (int)e;
  const Plan pl = plan(M, N, Kp, sms);
  if (pl.ns == 0 || K % 16 != 0) {
    const FirstArgs f{x, w, scale, bias, out, M, N, K, Kp, relu};
    return (int)(N <= 64 ? launch_first<128, 64, 4, 2>(f, st) : launch_first<128, 128, 2, 4>(f, st));
  }
  const Args a{x, w, nullptr, scale, bias, out, M, N, Kp, 0, 0, K, relu};
  return (int)w4::launch<W4A8>(a, pl, dev, st);
}
