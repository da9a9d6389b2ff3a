// K13: W4A16 GEMM: bf16 activations against int4 weights with group-wise
// scales, fp32 sums, + bias, relu, fp32 out.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int4_matmul (def :636, its
// pallas_call :691, kernel _int4_mm_kernel :470-515) and int4_matmul_cached
// (:564 / :603, kernel :518-558): one function (the cached kernel only keeps
// the dequantized tile across the M tiles of the TPU grid):
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
// batch, K = 768, N = 192: ~130 bf16 operations per byte, under the card's
// ridge of ~295); the bf16 activations are two thirds of the bytes, the fp32
// output one third.
//
// Design (Hopper, w4gemm.cuh's body; the first form below serves a Kp
// whose 64-column packed slice and scales do not fit beside the ring).
// Limiters of the first form (a 128 x 64 block tile, the grid walking the N
// tiles of an M tile) and what removes them:
//  1. A read three times (once per 64-column N tile): an N slice holds up to
//     256 columns, so at N = 192 each block reads its A rows once;
//  2. the weight dequantized again for every 16-row fragment by each warp:
//     the producer warpgroup dequantizes each 32-K stage of the resident
//     slice once per 128-row item (branch-free, 16 values a thread per
//     unit), into the bf16 wgmma operand both consumers read;
//  3. a K loop that waits on every stage behind two block barriers, and an
//     fp32 epilogue of 8-byte stores after it: an mbarrier ring that runs
//     ahead across items, A arriving by TMA (one 2D box a stage), and an
//     epilogue staged 8 rows a warp at a time in shared memory and written
//     by the bulk-copy engine (cp.async.bulk) while the next item's products
//     run;
//  4. the packed weight streamed again by every block: each block keeps its
//     N slice resident in shared memory, 4 bits a value, with its bf16
//     group scales beside it, loaded once.
// Products: bf16 wgmma m64nNk16 (fp32 sums), N = the slice width, both
// operands K-major in shared memory. An A stage is one box (64-byte
// swizzle) of A columns [32 s, 32 s + 32) of 128 rows, the matching B stage
// the same 32 K values of each slice column, each bf16(bf16(nibble) *
// scale) by one fma.rn.bf16x2 (hgemm.cuh: nib2_bf16, mul_bf16x2). Any M and
// N; K and g multiples of 16 (A columns past K and rows past M read as
// zeros, outputs past M or N are not written; 4-byte stores when N % 4 !=
// 0).
// The yardstick, bf16 torch.matmul on the dequantized weights, writes a bf16
// output: half K13's output bytes, so to match it K13 must run at 86% of
// its own bound.
//
// Shared memory per DeiT-Tiny site (make_plan: the ring, 8 KB of A and
// slice x 64 bytes of B a stage; the packed slice, slice x (Kp/2 + 16); the
// scales, slice x G x 2; the bias table, 4 bytes a column; the output
// staging, 64 rows of slice x 4 + 32 bytes; 16 bytes of mbarriers a stage),
// of the 232,448 allowed after the opt-in:
//   patch, fc2 (K 768, N 192, g 128, G 6): slice 192, 4 stages: 81,920
//     + 76,800 + 2,304 + 768 + 51,200 + 64 = 213,056.
#include "w4gemm.cuh"

namespace {

using namespace dlq;
using w4::Args;
using w4::Plan;

// 4 packed bytes (8 adjacent K values) -> 4 bf16 pairs, each bf16(n * s)
__device__ __forceinline__ void dequant4(uint32_t x, uint32_t s2, uint32_t* o) {
  const uint32_t lo = x & 0xFFFFu, hi = x >> 16;
  const uint32_t v0 = lo | (lo << 12), v1 = hi | (hi << 12);   // a byte's nibbles at bits 0, 16
  o[0] = mul_bf16x2(nib2_bf16(v0), s2);
  o[1] = mul_bf16x2(nib2_bf16(v0 >> 8), s2);
  o[2] = mul_bf16x2(nib2_bf16(v1), s2);
  o[3] = mul_bf16x2(nib2_bf16(v1 >> 8), s2);
}

// The Hopper form's operation.
struct W4A16 {
  using Acc = float;
  static constexpr int ESIZE = 2;   // A bytes a K value: a stage is 32 K values
  // an A stage is one TMA box of 128 rows x 64 bytes (64-byte swizzle)
  static constexpr int A_BOXES = 1;
  __device__ static int box_x(const Args&, int s, int) { return 32 * s; }
  // k-step j of consumer cw: rows 64 cw .., K bytes 32 j ..
  __device__ static uint64_t a_desc(const int8_t* stage, int cw, int j) {
    return w4::desc_sw(stage + cw * 64 * 64 + 32 * j, 8 * 64, 2);
  }
  __host__ __device__ static int scale_bytes(int G, int ns) { return w4::round16(ns * G * 2); }
  __host__ __device__ static int extras_bytes(const Args& a, int ns) { return scale_bytes(a.G, ns); }
  __host__ __device__ static int table_bytes(int ns) { return ns * 4; }
  // the slice's bf16 scale rows [NS][G] (0 past N)
  __device__ static void load_extras(const Args& a, uint8_t* extras, int n0, int ns, int tid,
                                     int nthreads) {
    const unsigned short* sc = static_cast<const unsigned short*>(a.sc);
    unsigned short* d = reinterpret_cast<unsigned short*>(extras);
    const int base = n0 * a.G, end = a.N * a.G;
    for (int i = tid; i < ns * a.G; i += nthreads) d[i] = base + i < end ? sc[base + i] : 0;
  }
  // {bias[n], bias[n + 1]} for each column pair (0 past N)
  __device__ static void load_table(const Args& a, uint8_t* table, int n0, int ns, int tid,
                                    int nthreads) {
    float2* t = reinterpret_cast<float2*>(table);
    for (int i = tid; i < ns / 2; i += nthreads) {
      const int n = n0 + 2 * i;
      t[i] = make_float2(n < a.N ? a.bias[n] : 0.0f, n + 1 < a.N ? a.bias[n + 1] : 0.0f);
    }
  }
  // B stage s: K values [32 s, 32 s + 32) of each column, dequantized: unit
  // u = h NS + n takes the 16 values [32 s + 16 h, ...), packed bytes 16 s +
  // 8 h .. (a thread's NS / 64 units are loaded first, then dequantized and
  // stored, with no branch between them; the two halves' groups found once)
  template <int NS>
  __device__ static void build(const Args& a, int8_t* stage, const uint8_t* packed, int ldp,
                               const uint8_t* extras, int s, int pt) {
    constexpr int PER = 2 * NS / w4::PRODUCERS;
    const unsigned short* sc = reinterpret_cast<const unsigned short*>(extras);
    const int g0 = 32 * s / a.group, g1 = (32 * s + 16) / a.group;
    uint2 v[PER];
    uint32_t s2[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = pt + i * w4::PRODUCERS, h = u >= NS, n = u - h * NS;
      v[i] = *reinterpret_cast<const uint2*>(packed + n * ldp + 16 * s + 8 * h);
      s2[i] = (uint32_t)sc[n * a.G + (h ? g1 : g0)] * 0x00010001u;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = pt + i * w4::PRODUCERS, h = u >= NS, n = u - h * NS;
      uint32_t o[8];
      dequant4(v[i].x, s2[i], o);
      dequant4(v[i].y, s2[i], o + 4);
      *reinterpret_cast<uint4*>(stage + sm90::core_off(n, 32 * h, w4::KS)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(stage + sm90::core_off(n, 32 * h + 16, w4::KS)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
  template <int NS>
  __device__ static void mma(float (&acc)[NS / 2], uint64_t da, uint64_t db) {
    w4::wgmma_bf16<NS>(acc, da, db);
  }
  __device__ static float2 epi(const Args& a, float v0, float v1, const uint8_t* table, int pair) {
    const float2 b = reinterpret_cast<const float2*>(table)[pair];
    float y0 = __fadd_rn(v0, b.x), y1 = __fadd_rn(v1, b.y);
    if (a.relu) y0 = fmaxf(y0, 0.0f), y1 = fmaxf(y1, 0.0f);
    return make_float2(y0, y1);
  }
};

Plan plan(int M, int N, int Kp, int G, int sms) {
  return w4::make_plan(M, N, Kp, sms, [G](int ns) {
    return W4A16::scale_bytes(G, ns) + W4A16::table_bytes(ns);
  });
}

// ---- the first form: a 128 x 64 block tile, A (bf16) and the packed B both
// streamed through two cp.async stages of 64 K values, the weight dequantized
// in registers (hgemm.cuh: step_g4); for a Kp whose 64-column packed slice
// and scales do not fit beside the rings ----
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BKH = 64;          // K values per stage
constexpr int LDA = BKH + 16;    // bf16 A row stride: 160 bytes, 32 (mod 128)

struct FirstArgs {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __nv_bfloat16* sc;
  const float* bias;
  float* out;
  int M, N, K, Kp, G, group;
  int relu;
};

__global__ void __launch_bounds__(THREADS) matmul_int4_first_kernel(const FirstArgs a) {
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

// The Hopper form's launch plan: out = {slice width (0: the first form),
// slices, ring stages, shared-memory bytes, blocks} for M x N, Kp and G
// scale groups on `sms` SMs (0: this card's).
extern "C" int dlq_matmul_int4_plan(int M, int N, int Kp, int G, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = w4::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p = plan(M, N, Kp, G, sms);
  out[0] = p.ns, out[1] = p.slices, out[2] = p.stages, out[3] = p.smem, out[4] = p.grid;
  return 0;
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  const cudaError_t e = w4::device(&dev, &sms);
  if (e != cudaSuccess) return (int)e;
  const Plan pl = plan(M, N, Kp, G, sms);
  if (pl.ns == 0) {
    const FirstArgs f{x, w, sc, bias, out, M, N, K, Kp, G, group, relu};
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
    matmul_int4_first_kernel<<<grid, THREADS, 0, st>>>(f);
    return (int)cudaGetLastError();
  }
  const Args a{reinterpret_cast<const int8_t*>(x), w, sc, nullptr, bias, out, M, N, Kp, G,
               group, 2 * K, relu};
  return (int)w4::launch<W4A16>(a, pl, dev, st);
}
