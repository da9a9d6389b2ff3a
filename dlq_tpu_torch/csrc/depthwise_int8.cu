// K23: int8 depthwise convolution (groups == C) with K1's fused fp32 / int8
// epilogue.
//
// Replaces no Pallas kernel: the reference leaves this conv to XLA, the
// grouped branch of dlq_tpu/ops/qops.py:182 _conv_int8 (groups == C, HWIO
// weights [kh, kw, 1, C]; its oracle _depthwise_int8_stencil, :162-179),
// with the fused contexts' epilogue (dlq_tpu/quant/model_quant.py:416-430).
// PyTorch has no int8 conv that sums in int32 on CUDA, so every depthwise
// conv of MobileNetV2's served paths runs here.
//
//   acc[n, oh, ow, c] = sum_{u, v} x[n, oh*s - p + u, ow*s - p + v, c] * w[u*KW + v, c]  (int32)
//   y = fma(float(acc), scale[c], bias[c]), then relu or relu6 (clip to [0, 6])
//   out = y (fp32) | clip(rint(y / out_scale), act ? 0 : -127, 127) (int8)
//
// on int8 NHWC input, stride 1 or 2 (any), symmetric zero padding; the
// epilogue is K1's (igemm.cuh: epi_act, requant_div: one fused multiply-add,
// the requant divides).
//
// Bound: bytes. A 3x3 depthwise conv does 9 multiply-adds per output value
// and reads each input byte once: 18 int8 operations per input byte at
// stride 1 (4.5 at stride 2), far below the card's ridge of ~590; with fp32
// out the output's 4 bytes a value dominate. No tensor core helps (no sum
// runs across channels), so the products run on the integer pipe, and with
// int8 out they and the epilogue's instructions are what a simple kernel
// spends its time on.
//
// Two forms, one rule (dlq_depthwise_int8_form; mirror ops/depthwise_int8.py:
// depthwise_form): 3x3, pad 1, stride 1 or 2, C % 16 == 0 and a plan that
// fits take the Hopper form; every other shape the first form.
//
// The Hopper form (depthwise_hopper_kernel), for MobileNetV2's depthwise
// convs. Work: an item is (image n, band of TH output rows, channel slice of
// CS channels); item i is (slice i % slices, band, image) and block b walks
// items b, b + grid, ... (a persistent grid, a multiple of the slice count,
// so a block keeps one slice). The plan (make_plan; mirror
// depthwise_hopper_plan) picks R, CS, TH per shape.
//   * Loads: the item's input band, (TH - 1) s + 3 rows x WB columns x CS
//     channels, is one 4-D TMA box [1, rows, WB, CS] at (n, oh0 s - 1, -1,
//     c0) of x [N, H, W, C]: out-of-image rows and columns (the padding,
//     and columns past the last pixel group) land as zeros, so no tap
//     branches. Stages sit in an mbarrier ring (3-4 deep); thread 0 issues a
//     stage's box as soon as the block has left it, so the next items'
//     loads run under this item's products.
//   * Threads: a block is Q x PG threads (Q = CS / 4 channel quads, PG pixel
//     groups at once). Thread t keeps quad t % Q for its whole walk: its
//     weights as twelve tap-row words (w[u, 0, k], w[u, 1, k], w[u, 2, k],
//     0) for tap row u and channel k, and its scales and biases, loaded
//     once. It takes R consecutive output pixels of a row at a time (a
//     pixel group), so each input word it reads from shared memory serves
//     every output whose taps reach it: (R - 1) s + 3 reads a tap row for R
//     outputs, not 3R.
//   * Products: a tap row's words (four channels of a pixel each) are
//     transposed by byte permutes, four pixels at a time, into channel
//     streams (four consecutive pixels of one channel a word); output j's
//     three taps of the row are then one __dp4a of the stream's window of
//     pixels j s .. j s + 3 (one permute where j s % 4 != 0) and the tap-row
//     word: a third of an instruction a product on the dp4a pipe.
//   * Epilogue (exact): fma(float(acc), scale, bias) and the activation as
//     epi_act; the int8 code by the division's fast path (i8gemm.cuh:
//     div_rn_fast, then requant_code's round) where it is exact for every y
//     of the thread's quad (s_fast(s), 147456 |scale| + |bias| <= 2^59),
//     with relu and relu6 as clips of y / s (requant4), else requant_exact.
//     Every pixel's epilogue is computed before its stores: one 4-byte int8
//     word or one 16-byte fp32 vector a pixel a thread; a warp's lanes hold
//     consecutive quads of a pixel, so each store is contiguous.
//
// The first form (depthwise_int8_kernel; dlq_depthwise_int8_first): a thread
// per output pixel and G-byte channel granule (G = 16, or 8 when C % 16 ==
// 8; C % 8 != 0 is refused), consecutive threads on consecutive granules of
// a pixel, so a warp's loads of one tap are contiguous; per tap one G-byte
// read-only load of x (padding taps skipped) and of the tap-major [KH*KW, C]
// weight (L1-resident), G int32 sums in registers, then the epilogue per
// channel and one G-byte int8 store or G / 4 16-byte fp32 stores.
#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

#include "i8gemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;      // [KH * KW, C], tap-major
  const float* scale;
  const float* bias;
  void* out;
  int H, W, C, KH, KW, stride, pad, OH, OW;
  int act, out_int8;    // act: ACT_NONE, ACT_RELU or ACT_RELU6 (igemm.cuh)
  float out_scale;
  long long total;      // output granules: N * OH * OW * C / G
};

constexpr int THREADS_DW = 256;

// A G-byte vector of int8 values: its 32-bit words, and built from them.
template <int G>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
  __device__ static uint32_t word(const T& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ static T make(const uint32_t (&q)[4]) { return make_uint4(q[0], q[1], q[2], q[3]); }
};
template <>
struct Vec<8> {
  using T = uint2;
  __device__ static uint32_t word(const T& v, int j) { return j == 0 ? v.x : v.y; }
  __device__ static T make(const uint32_t (&q)[2]) { return make_uint2(q[0], q[1]); }
};

// byte k of a G-byte vector, sign-extended (k a constant after unrolling)
template <int G>
__device__ __forceinline__ int sbyte(const typename Vec<G>::T& v, int k) {
  return static_cast<int>(static_cast<int8_t>(Vec<G>::word(v, k >> 2) >> (8 * (k & 3))));
}

template <int G, bool I8, bool R6>
__global__ void __launch_bounds__(THREADS_DW) depthwise_int8_kernel(const Args a) {
  using V = typename Vec<G>::T;
  const long long i = (long long)blockIdx.x * THREADS_DW + threadIdx.x;
  if (i >= a.total) return;
  const int gpp = a.C / G;   // granules a pixel
  const long long pix = i / gpp;
  const int c0 = (int)(i - pix * gpp) * G;
  const int ow = (int)(pix % a.OW);
  const long long r = pix / a.OW;
  const int oh = (int)(r % a.OH);
  const long long n = r / a.OH;
  const int8_t* xn = a.x + (size_t)n * a.H * a.W * a.C + c0;
  const int ih0 = oh * a.stride - a.pad, iw0 = ow * a.stride - a.pad;

  int acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0;
  for (int u = 0; u < a.KH; ++u) {
    const int ih = ih0 + u;
    if (ih < 0 || ih >= a.H) continue;
    for (int v = 0; v < a.KW; ++v) {
      const int iw = iw0 + v;
      if (iw < 0 || iw >= a.W) continue;
      const V xv = __ldg(reinterpret_cast<const V*>(xn + ((size_t)ih * a.W + iw) * a.C));
      const V wv = __ldg(reinterpret_cast<const V*>(a.w + (size_t)(u * a.KW + v) * a.C + c0));
#pragma unroll
      for (int k = 0; k < G; ++k) acc[k] += sbyte<G>(xv, k) * sbyte<G>(wv, k);
    }
  }

  const size_t o = (size_t)pix * a.C + c0;
  const bool relu = a.act != ACT_NONE;
  auto epi = [&](int k) {
    return epi_act<R6>(acc[k], __ldg(a.scale + c0 + k), __ldg(a.bias + c0 + k), relu);
  };
  if constexpr (I8) {
    const float lo = relu ? 0.0f : -127.0f;
    uint32_t q[G / 4];
#pragma unroll
    for (int k = 0; k < G / 4; ++k) q[k] = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      q[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(requant_div(epi(k), a.out_scale, lo)))
                   << (8 * (k & 3));
    }
    *reinterpret_cast<V*>(static_cast<int8_t*>(a.out) + o) = Vec<G>::make(q);
  } else {
    float* out = static_cast<float*>(a.out) + o;
#pragma unroll
    for (int k = 0; k < G; k += 4)
      *reinterpret_cast<float4*>(out + k) = make_float4(epi(k), epi(k + 1), epi(k + 2), epi(k + 3));
  }
}

template <int G, bool R6>
cudaError_t launch_act(Args a, long long pixels, cudaStream_t s) {
  a.total = pixels * (a.C / G);
  const long long blocks = (a.total + THREADS_DW - 1) / THREADS_DW;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  if (a.out_int8)
    depthwise_int8_kernel<G, true, R6><<<(unsigned)blocks, THREADS_DW, 0, s>>>(a);
  else
    depthwise_int8_kernel<G, false, R6><<<(unsigned)blocks, THREADS_DW, 0, s>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch(const Args& a, long long pixels, cudaStream_t s) {
  return a.act == ACT_RELU6 ? launch_act<G, true>(a, pixels, s)
                            : launch_act<G, false>(a, pixels, s);
}


// ---- the Hopper form ----

constexpr int HOP_THREADS = 256;      // the most threads a block
constexpr int HOP_MIN_THREADS = 128;  // fewer are scored down (latency hidden by few warps)
constexpr int STAGE_MAX = 36 * 1024;  // bytes of one stage, an item's input band
constexpr int RING_MAX = 113 * 1024;  // bytes of a block's ring: two blocks share an SM
constexpr int MAX_STAGES = 4;
constexpr int CS_MAX = 192;           // channels a slice (a box's innermost extent <= 256)
constexpr int BOX_MAX = 256;          // a TMA box's extent in any dimension
constexpr int SMEM_SM = 233472;       // shared memory of one SM
constexpr int SMEM_RESERVED = 1024;   // of it, reserved for each resident block
constexpr int REG_BLOCKS = 16;        // 65536 registers / (128 a thread x 32 a warp): warps per SM
constexpr int R_CAND[2] = {4, 7};     // output pixels a pixel group

// The Hopper form's plan for N x H x W x C at stride s (3x3, pad 1) on `sms`
// SMs (mirror: ops/depthwise_int8.py: depthwise_hopper_plan). Every (R, CS,
// TH) is scored: the lanes' useful share (pixel groups past OW, bands past
// OH and a round's idle lane groups waste), the blocks' (the last wave's
// idle blocks), the square root of the band's useful input rows (TH s of
// (TH - 1) s + 3: the halo is loaded again) and threads / 128 up to 1. CS
// divides C, a multiple of 16 up to 192, and is C or at least 64 (narrower
// rows make the box's requests small) where such a CS fits, else any such
// divisor (C = 208, say); a stage is at most 36 KB, the ring
// 3-4 stages within 113 KB. The highest score wins, a later candidate on a
// tie (R 7 over 4, wider slices, taller bands). ok == 0: no plan (WB or a
// one-row band does not fit), the first form's shape.
struct Plan {
  int ok, r, cs, th, rb, wb, cg, q, pg, threads, stage, pitch, stages, smem, bands, slices, items,
      grid;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline Plan make_plan(int N, int H, int W, int C, int s, int sms) {
  Plan best{};
  double best_score = -1.0;
  if ((s != 1 && s != 2) || C % 16 != 0 || N < 1 || H < 1 || W < 1 || sms < 1) return best;
  const int oh = (H - 1) / s + 1, ow = (W - 1) / s + 1;
  for (int narrow = 0; narrow < 2 && !best.ok; ++narrow)
  for (int r : R_CAND) {
    const int cg = cdiv(ow, r), wb = (cg * r - 1) * s + 3;
    if (wb > BOX_MAX) continue;
    for (int cs = 16; cs <= C && cs <= CS_MAX; cs += 16) {
      if (C % cs != 0 || (!narrow && cs < 64 && cs != C)) continue;
      const int q = cs / 4, pg0 = HOP_THREADS / q, slices = C / cs;
      for (int th = 1; th <= oh; ++th) {
        const int rb = (th - 1) * s + 3, stage = cs * wb * rb;
        if (stage > STAGE_MAX || rb > BOX_MAX) break;
        const int tasks = th * cg, pg = tasks < pg0 ? tasks : pg0, threads = q * pg;
        const int pitch = cdiv(stage, 128) * 128;
        const int stages = RING_MAX / pitch < MAX_STAGES ? RING_MAX / pitch : MAX_STAGES;
        const int smem = stages * pitch + 8 * stages;
        const int warps = cdiv(threads, 32);
        int bps = SMEM_SM / (smem + SMEM_RESERVED);
        if (REG_BLOCKS / warps < bps) bps = REG_BLOCKS / warps;
        if (bps < 1) bps = 1;
        const int bands = cdiv(oh, th);
        const long long items = (long long)N * bands * slices;
        if (items > 0x7FFFFFFFLL) return Plan{};
        long long grid = items < (long long)bps * sms ? items : (long long)bps * sms;
        grid = grid / slices * slices;
        if (grid < slices) grid = slices;
        const double lane = ((double)oh * ow / r) / ((double)bands * cdiv(tasks, pg) * pg);
        const double blk = (double)items / ((double)((items + grid - 1) / grid) * grid);
        const double halo = std::sqrt((double)(th * s) / rb);
        const double occ = threads < HOP_MIN_THREADS ? (double)threads / HOP_MIN_THREADS : 1.0;
        const double score = lane * blk * halo * occ;
        if (score >= best_score) {
          best_score = score;
          best = Plan{1, r, cs, th, rb, wb, cg, q, pg, threads, stage, pitch, stages, smem, bands,
                      slices, (int)items, (int)grid};
        }
      }
    }
  }
  return best;
}

// The plan of a shape on `sms` SMs, made once per (shape, SMs).
inline Plan cached_plan(int N, int H, int W, int C, int s, int sms) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int>, Plan> known;
  const auto key = std::make_tuple(N, H, W, C, s, sms);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  return known[key] = make_plan(N, H, W, C, s, sms);
}

struct HArgs {
  const int8_t* w;      // [9, C], tap-major
  const float* scale;
  const float* bias;
  void* out;            // [N, OH, OW, C], fp32 or int8
  int C, OH, OW, stride, act;
  float out_scale;
  int cs, q, th, wb, cg, pg, stage, pitch, stages, bands, slices, items;
};

// Stage k of this block's walk: its item's band, by one TMA box.
__device__ __forceinline__ void issue(const HArgs& a, const CUtensorMap* tm, uint8_t* smem,
                                      uint64_t* full, int k) {
  const int st = k % a.stages;
  const int item = blockIdx.x + k * gridDim.x;
  const int slice = item % a.slices, rest = item / a.slices;
  const int band = rest % a.bands, n = rest / a.bands;
  w4::mbar_expect_tx(full + st, a.stage);
  i8::tma_load4(smem + st * a.pitch, tm, slice * a.cs, -1, band * a.th * a.stride - 1, n,
                full + st);
}

// epi_act: fma(float(acc), scale, bias) and the activation (float(acc) is
// exact: |acc| <= 9 x 128 x 128 < 2^24)
template <bool R6>
__device__ __forceinline__ float epi_f(int acc, float scale, float bias, bool relu) {
  const float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  if constexpr (R6)
    return fminf(fmaxf(y, 0.0f), 6.0f);
  else
    return relu ? fmaxf(y, 0.0f) : y;
}

// Four int8 codes (the low bytes of requant_code's sums) packed into a word.
__device__ __forceinline__ uint32_t pack4(const uint32_t (&cd)[4]) {
  return __byte_perm(__byte_perm(cd[0], cd[1], 0x0040), __byte_perm(cd[2], cd[3], 0x0040),
                     0x5410);
}

// The int8 epilogue of one pixel's four channels. Fast (`fast`: s_fast(s),
// so s > 0, and |y| <= 147456 |scale| + |bias| <= 2^59 for all four, so the
// division's fast path is exact): q = y / s by div_rn_fast, clipped to [lo,
// qhi] and rounded by requant_code's add. Division by s > 0 is monotone, so
// clip(y, 0, 6) / s = clip(y / s, 0, 6 / s) and max(y, 0) / s = max(y / s,
// 0): relu6 (qhi = min(6 / s, 127)) and relu (lo = 0) need no clip of y.
// Else the first form's steps: epi_act, then requant_exact.
template <bool R6>
__device__ __forceinline__ uint32_t requant4(const int (&acc)[4], const float (&sc)[4],
                                             const float (&bi)[4], float s, bool fast, float qhi,
                                             bool relu, float lo) {
  uint32_t cd[4];
  if (fast) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float q = i8::div_rn_fast(__fmaf_rn(__int2float_rn(acc[c]), sc[c], bi[c]), s);
      cd[c] = __float_as_uint(__fadd_rn(fminf(fmaxf(q, lo), qhi), 12582912.0f));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cd[c] = i8::requant_exact(epi_f<R6>(acc[c], sc[c], bi[c], relu), s, lo);
  }
  return pack4(cd);
}

// 4 x 4 byte transpose: t[k] = byte k of x0, x1, x2, x3 (channel k of four
// consecutive pixels, from four pixels' channel quads), eight byte permutes.
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                                           uint32_t* t) {
  const uint32_t a = __byte_perm(x0, x1, 0x5140), b = __byte_perm(x0, x1, 0x7362);
  const uint32_t c = __byte_perm(x2, x3, 0x5140), d = __byte_perm(x2, x3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

// Bytes o .. o + 3 of the 8-byte pair (lo, hi), o a constant 0..3.
template <int O>
__device__ __forceinline__ uint32_t window(uint32_t lo, uint32_t hi) {
  if constexpr (O == 0)
    return lo;
  else
    return __byte_perm(lo, hi, O == 1 ? 0x4321 : O == 2 ? 0x5432 : 0x6543);
}

// acc[j][k] += the three taps of tap row u for output j, channel k: from the
// transposed row t[m][k] (channel k, pixels 4m .. 4m + 3), one __dp4a of
// the window of pixels jS .. jS + 3 and the word (w[u, 0, k], w[u, 1, k],
// w[u, 2, k], 0).
template <int R, int S, int J = 0>
__device__ __forceinline__ void row_taps(int (&acc)[R][4], const uint32_t (*t)[4],
                                         const uint32_t (&wt)[4]) {
  if constexpr (J < R) {
    constexpr int P = J * S;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[J][k] = __dp4a((int)window<P % 4>(t[P / 4][k], t[P / 4 + (P % 4 ? 1 : 0)][k]),
                         (int)wt[k], acc[J][k]);
    row_taps<R, S, J + 1>(acc, t, wt);
  }
}

template <int R, int S, bool I8, bool R6>
__global__ void __launch_bounds__(HOP_THREADS, 2)
    depthwise_hopper_kernel(const __grid_constant__ HArgs a,
                            const __grid_constant__ CUtensorMap tm) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * a.pitch);
  const int tid = threadIdx.x;
  const int q = tid % a.q, g0 = tid / a.q;
  const int mine = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) sm90::mbar_init(full + st, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < a.stages && k < mine; ++k) issue(a, &tm, smem, full, k);

  // this thread's quad of the block's slice: its weights (tap-row words
  // wt[u][k] = (w[u, 0, k], w[u, 1, k], w[u, 2, k], 0) for channel k), scales
  // and biases
  const int c0 = (blockIdx.x % a.slices) * a.cs + 4 * q;
  uint32_t w9[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w9[t] = __ldg(reinterpret_cast<const uint32_t*>(a.w + t * a.C + c0));
  uint32_t wt[3][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wt[u][k] = __byte_perm(__byte_perm(w9[3 * u], w9[3 * u + 1], k | (4 + k) << 4),
                             __byte_perm(w9[3 * u + 2], 0, 0x4440 | k), 0x5410);
  float sc[4], bi[4];
  const float s = a.out_scale;
  bool fast = i8::s_fast(s);   // the division's fast path is exact for every y of the quad
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    sc[c] = __ldg(a.scale + c0 + c), bi[c] = __ldg(a.bias + c0 + c);
    fast = fast && 147456.0f * fabsf(sc[c]) + fabsf(bi[c]) <= 0x1p59f;
  }
  const bool relu = a.act != ACT_NONE;
  const float lo = relu ? 0.0f : -127.0f;   // the int8 clip's lower bound
  const float qhi = R6 && fast ? fminf(__fdiv_rn(6.0f, s), 127.0f) : 127.0f;
  constexpr int XW = (R - 1) * S + 3;       // input words a tap row of a pixel group
  constexpr int XT = (XW + 4) / 4;          // 4-pixel blocks of them, the last window's pad included
  const int tasks = a.th * a.cg;

  for (int k = 0; k < mine; ++k) {
    const int st = k % a.stages;
    sm90::mbar_wait(full + st, (k / a.stages) & 1);
    const int item = blockIdx.x + k * gridDim.x;
    const int rest = item / a.slices;
    const int band = rest % a.bands, n = rest / a.bands;
    const int oh0 = band * a.th;
    const uint8_t* xs = smem + st * a.pitch + 4 * q;
    for (int g = g0; g < tasks; g += a.pg) {
      const int ohl = g / a.cg, cgi = g - ohl * a.cg;
      const int oh = oh0 + ohl;
      if (oh >= a.OH) break;
      int acc[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;
      const uint8_t* p = xs + (ohl * S * a.wb + cgi * R * S) * a.cs;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        uint32_t xw[4 * XT];
#pragma unroll
        for (int j = 0; j < 4 * XT; ++j)
          xw[j] = j < XW ? *reinterpret_cast<const uint32_t*>(p + (u * a.wb + j) * a.cs) : 0u;
        uint32_t t[XT][4];   // channel k of pixels 4m .. 4m + 3 of the row
#pragma unroll
        for (int m = 0; m < XT; ++m)
          transpose4(xw[4 * m], xw[4 * m + 1], xw[4 * m + 2], xw[4 * m + 3], t[m]);
        row_taps<R, S>(acc, t, wt[u]);
      }
      const int ow0 = cgi * R;
      const size_t o = (((size_t)n * a.OH + oh) * a.OW + ow0) * a.C + c0;
      // every pixel's epilogue first (independent chains the scheduler
      // interleaves), then the stores, each under its own predicate
      if constexpr (I8) {
        uint32_t word[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
          word[j] = requant4<R6>(acc[j], sc, bi, s, fast, qhi, relu, lo);
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (ow0 + j < a.OW)
            *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + o + (size_t)j * a.C) =
                word[j];
      } else {
        float4 y[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
          y[j] = make_float4(epi_f<R6>(acc[j][0], sc[0], bi[0], relu),
                             epi_f<R6>(acc[j][1], sc[1], bi[1], relu),
                             epi_f<R6>(acc[j][2], sc[2], bi[2], relu),
                             epi_f<R6>(acc[j][3], sc[3], bi[3], relu));
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (ow0 + j < a.OW)
            *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o + (size_t)j * a.C) = y[j];
      }
    }
    __syncthreads();   // every thread is done with stage st
    if (tid == 0 && k + a.stages < mine) issue(a, &tm, smem, full, k + a.stages);
  }
}

template <int R, int S, bool I8, bool R6>
cudaError_t launch_hop(const HArgs& a, const Plan& pl, const CUtensorMap& tm, int dev,
                       cudaStream_t st) {
  const cudaError_t e = opt_in<depthwise_hopper_kernel<R, S, I8, R6>>(dev);
  if (e != cudaSuccess) return e;
  depthwise_hopper_kernel<R, S, I8, R6><<<pl.grid, pl.threads, pl.smem, st>>>(a, tm);
  return cudaGetLastError();
}

template <int R, int S>
cudaError_t launch_rs(const HArgs& a, const Plan& pl, const CUtensorMap& tm, int dev,
                      cudaStream_t st, bool i8out) {
  if (a.act == ACT_RELU6)
    return i8out ? launch_hop<R, S, true, true>(a, pl, tm, dev, st)
                 : launch_hop<R, S, false, true>(a, pl, tm, dev, st);
  return i8out ? launch_hop<R, S, true, false>(a, pl, tm, dev, st)
               : launch_hop<R, S, false, false>(a, pl, tm, dev, st);
}

// The Hopper form on plan pl: x's map cut in the plan's boxes, then the
// kernel for (R, stride, int8 out, relu6).
cudaError_t launch_hopper(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
                          void* out, int N, int H, int W, int C, int stride, int act, int out_int8,
                          float out_scale, const Plan& pl, int dev, cudaStream_t st) {
  CUtensorMap tm{};
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const cuuint32_t box[4] = {(cuuint32_t)pl.cs, (cuuint32_t)pl.wb, (cuuint32_t)pl.rb, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  cudaError_t e = i8::encode(&tm, x, 4, dims, strides, box, estr, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const int OH = (H - 1) / stride + 1, OW = (W - 1) / stride + 1;
  const HArgs a{w, scale, bias, out, C, OH, OW, stride, act, out_scale, pl.cs, pl.q, pl.th,
                pl.wb, pl.cg, pl.pg, pl.stage, pl.pitch, pl.stages, pl.bands, pl.slices,
                pl.items};
  const bool i8out = out_int8 != 0;
  if (pl.r == 7)
    return stride == 1 ? launch_rs<7, 1>(a, pl, tm, dev, st, i8out)
                       : launch_rs<7, 2>(a, pl, tm, dev, st, i8out);
  return stride == 1 ? launch_rs<4, 1>(a, pl, tm, dev, st, i8out)
                     : launch_rs<4, 2>(a, pl, tm, dev, st, i8out);
}

}  // namespace

// The channel granule the first form takes: 16 bytes for C % 16 == 0, 8
// for C % 16 == 8, 0 (refused) otherwise.
extern "C" int dlq_depthwise_int8_granule(int C) {
  return C % 16 == 0 ? 16 : (C % 8 == 0 ? 8 : 0);
}

// The form a launch takes: 1 the Hopper form (3x3, pad 1, stride 1 or 2,
// C % 16 == 0, a plan that fits), 0 the first form.
extern "C" int dlq_depthwise_int8_form(int N, int H, int W, int C, int KH, int KW, int stride,
                                       int pad) {
  return KH == 3 && KW == 3 && pad == 1 && cached_plan(N, H, W, C, stride, 1).ok;
}

// The Hopper form's plan on `sms` SMs into out[0..17] (the fields of Plan in
// order, ok first), for the card tests' check of the mirror.
extern "C" void dlq_depthwise_int8_plan(int N, int H, int W, int C, int stride, int sms,
                                        int* out) {
  const Plan p = make_plan(N, H, W, C, stride, sms);
  const int v[18] = {p.ok, p.r, p.cs, p.th, p.rb, p.wb, p.cg, p.q, p.pg, p.threads, p.stage,
                     p.pitch, p.stages, p.smem, p.bands, p.slices, p.items, p.grid};
  for (int i = 0; i < 18; ++i) out[i] = v[i];
}

static int check_args(int g, int N, int H, int W, int KH, int KW, int stride, int pad, int act) {
  return g == 0 || N < 0 || KH <= 0 || KW <= 0 || stride <= 0 || pad < 0 || H + 2 * pad < KH ||
         W + 2 * pad < KW || act < ACT_NONE || act > ACT_RELU6;
}

static int launch_first(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
                        void* out, int N, int H, int W, int C, int KH, int KW, int stride,
                        int pad, int act, int out_int8, float out_scale, cudaStream_t s) {
  const int g = dlq_depthwise_int8_granule(C);
  const int OH = (H + 2 * pad - KH) / stride + 1, OW = (W + 2 * pad - KW) / stride + 1;
  Args a{x, w, scale, bias, out, H, W, C, KH, KW, stride, pad, OH, OW, act, out_int8, out_scale, 0};
  const long long pixels = (long long)N * OH * OW;
  return (int)(g == 16 ? launch<16>(a, pixels, s) : launch<8>(a, pixels, s));
}

// x: int8 NHWC [N, H, W, C], 16-byte aligned (8 for an 8-byte granule);
// w: int8 [KH * KW, C] (the HWIO [KH, KW, 1, C] weight, tap-major); scale,
// bias: fp32 [C]; out: fp32 or int8 NHWC [N, OH, OW, C], 16-byte aligned;
// act: 0 none, 1 relu, 2 relu6. The form by dlq_depthwise_int8_form. A
// refused shape returns cudaErrorInvalidValue.
extern "C" int dlq_depthwise_int8(const int8_t* x, const int8_t* w, const float* scale,
                                  const float* bias, void* out, int N, int H, int W, int C,
                                  int KH, int KW, int stride, int pad, int act, int out_int8,
                                  float out_scale, void* stream) {
  if (check_args(dlq_depthwise_int8_granule(C), N, H, W, KH, KW, stride, pad, act))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH == 3 && KW == 3 && pad == 1) {
    int dev, sms;
    const cudaError_t e = dlq::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
    const Plan pl = cached_plan(N, H, W, C, stride, sms);
    if (pl.ok)
      return (int)launch_hopper(x, w, scale, bias, out, N, H, W, C, stride, act, out_int8,
                                out_scale, pl, dev, s);
  }
  return launch_first(x, w, scale, bias, out, N, H, W, C, KH, KW, stride, pad, act, out_int8,
                      out_scale, s);
}

// The first form at any shape it takes (what the card tests and
// chip_smoke.py hold the Hopper form to).
extern "C" int dlq_depthwise_int8_first(const int8_t* x, const int8_t* w, const float* scale,
                                        const float* bias, void* out, int N, int H, int W, int C,
                                        int KH, int KW, int stride, int pad, int act,
                                        int out_int8, float out_scale, void* stream) {
  if (check_args(dlq_depthwise_int8_granule(C), N, H, W, KH, KW, stride, pad, act))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_first(x, w, scale, bias, out, N, H, W, C, KH, KW, stride, pad, act, out_int8,
                      out_scale, static_cast<cudaStream_t>(stream));
}
