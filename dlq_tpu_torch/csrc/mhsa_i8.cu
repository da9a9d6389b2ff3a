// K18: dynamically quantized int8 multi-head self-attention, bf16 or fp32 in
// and out, in two forms.
//
// Replaces the attn_int8 arm of dlq_tpu/ops/pallas_vit_block.py
// (_mhsa_batched_i8_into_scratch, :237-276, inside vit_multiblock_fused_w8
// :537) and the XLA function dlq_tpu/ops/int8_attention.py:
// attention_int8_dynamic (:34-82), which attn_impl="xla_int8" and the
// split-attention block (vit_block_w8_splitattn, pallas_vit_block.py:1058)
// reach. Per (sample b, head h), Q, K, V [rows, hd] read widened to fp32:
//   aX  = max|X| + 1e-9; X8 = clip(rint(X * (127 / aX)), +-127)   X = Q, K, V
//   s   = f32(Q8 K8^T) * ((aq * ak) * c),  c = f32(1/sqrt(hd) / 127^2)
//   s[:, j] = -1e30 for j >= n_valid
//   p   = expf(s - rowmax);  a = p / rowsum(p)   (IEEE division)
//   a8  = clip(rint(a * 127), 0, 127)
//   out = f32(a8 V8) * (av * f32(1/127^2))       (XLA's form of av / 127^2)
// zero_pad (attention_int8_dynamic): rows >= n_valid of Q, K and V are 0
// before the amax. Otherwise (the fused block's arm) the amax runs over all
// rows, the padded stream's pad rows included. Every step is written with
// the _rn intrinsics so that nvcc contracts nothing into an FMA; the codes
// and both int32 sums are exact, the scores bit for bit the plain version's;
// expf and the row sum's order may flip a probability code at a half.
//
// Bound: at DeiT-Tiny batch 256 (200 rows, 3 heads of 64) one launch does
// 4 x 200 x 197 x 64 x 768 = 7.7 G int8 ops (~0.004 ms at 1979 TOP/s)
// against ~79 MB of bf16 q, k, v read and attention written (~0.0235 ms
// at 3.35 TB/s): bytes.
// Two forms of the kernel, one arithmetic.
// The first form (mhsa_i8_kernel, dlq_mhsa_i8_first), simple first: the
// amax needs every row of the (sample, head) before the first product, so
// one block of 128 threads owns a whole (sample, head). Pass 1 reads Q, K,
// V from device memory for the three amaxes (fmaxf: exact in any order)
// and reduces them over the block; pass 2 reads them again and writes the
// int8 codes into shared memory (Q and K row-major, V transposed with each
// 32-key group permuted, below). Then each
// warp takes 16 query rows at a time: QK^T on mma.sync.m16n8k32 (s8 x s8 ->
// s32), the score rows in registers, max, exp, sum, division and the
// probability codes in registers, and the AV product from those registers.
// The m16n8 C fragment of key tile j gives a lane keys 8j+2t, 8j+2t+1, and
// the k32 A fragment wants keys 4t..4t+3 and 16+4t..19+4t; the int32 sum is
// exact in any key order, so V's keys are stored in the order the lanes
// hold them instead of moving probabilities between lanes. Keys past the
// row count carry a8 = 0 (masked) and v8 = 0 (zero-filled). Its limiters:
// Q, K and V read twice from device memory, no load overlapping compute,
// V transposed a byte at a time, 768 blocks of 4 warps, a whole score row
// in registers.
//
// The Hopper form (mhsa_i8_hopper, the rule mhsa_i8_form), on K6's Hopper
// body: a persistent grid of one block per SM walks the (sample, head)
// items, one warp per 16 query rows (13 at 200 rows, 16 at 256). Each
// item's raw Q, K and V come from device memory once, by 16-byte cp.async,
// into one stage in shared memory (rows padded by 16 bytes); the three
// amaxes are taken from the stage (the in-kernel form over every row, the
// zero-pad form over the n_valid rows it loads), then the int8 codes from
// the same values, quant_i8's codes with the clip before the rounding, on
// the full-rate pipes: Q and K row-major in 8- (bf16) or 4-byte (fp32)
// stores, V transposed into V's permuted key order one 32-bit word (4 keys
// at one lane) a store. The stage is then free, and the next
// item's load runs while this item's attention does. A warp recomputes its
// int32 Q K^T (mma.sync m16n8k32 s8, fragments by ldmatrix) over the keys
// in chunks of 64, in three passes: the integer row max (the float score
// is monotonic in it); p = expf(s - max) and the row sum, each thread in
// the first form's key order, then quad_sum; the codes a8 and a8 V. So no
// thread holds a whole score row, and the codes, the sums and every output
// are the first form's. The division by the row sum is div.rn's own fast
// path with the divisor's part hoisted (attn.cuh; a numerator below 2^-64
// codes 0 either way); 8-key tiles wholly past n_valid are skipped. What
// bounds it (PERF.md, Findings): the CUDA-core work of the exact softmax,
// two expf and ~35 instructions a score over 13-16 warps an SM, and the
// block-wide quantization between items.
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "attn.cuh"
#include "igemm.cuh"
#include "launch.cuh"
#include "vit_common.cuh"

namespace {

using dlq::cp_async16;
using dlq::cp_async_commit;
using dlq::cp_async_wait;
using dlq::div_fast;
using dlq::Int;
using dlq::ldsm_x4;
using dlq::Masked;
using dlq::mma_s8;
using dlq::quad_max;
using dlq::quad_sum;
using dlq::quant_i8;
using dlq::Recip;
using dlq::recip;
using dlq::Unmasked;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float INV_Q127 = 1.0f / 16129.0f;   // f32(1/127^2)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qb, qn, kb, kn, vb, vn, ob, on;
  int N, heads, n_valid, lanes, zero_pad, out_f32;
  float qk_c;
};

// 16 bytes of T widened to fp32
__device__ __forceinline__ void widen(const int4& raw, const float*, float (&x)[4]) {
  x[0] = __int_as_float(raw.x);
  x[1] = __int_as_float(raw.y);
  x[2] = __int_as_float(raw.z);
  x[3] = __int_as_float(raw.w);
}
__device__ __forceinline__ void widen(const int4& raw, const __nv_bfloat16*, float (&x)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}


__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float block_max(float v, float* red, int slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[slot * WARPS + (threadIdx.x >> 5)] = v;
  __syncthreads();
  float m = red[slot * WARPS];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[slot * WARPS + w]);
  return m;
}

// Position of key k within its 32-key group of V^T: the lane with t = (k & 7)
// >> 1 holds key k in C byte (k & 1) + 2 ((k >> 3) & 1) of its A register for
// the group's half k >> 4 (see the design note).
__device__ __forceinline__ int vpos(int k) {
  const int r = k & 31;
  return (k & ~31) + 16 * (r >> 4) + 4 * ((r & 7) >> 1) + (r & 1) + 2 * ((r >> 3) & 1);
}

__device__ __forceinline__ int code_a(float p, float sum) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(p, sum), 127.0f)), 0.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(b0) | (static_cast<uint32_t>(b1) << 8) |
         (static_cast<uint32_t>(b2) << 16) | (static_cast<uint32_t>(b3) << 24);
}

// TI: input element type (the output's, bf16 or fp32, is a flag); HD: head
// width; NKT: key tiles of 8 (a multiple of 4; NKT * 8 >= N rounded up to 32).
template <class TI, int HD, int NKT>
__global__ void __launch_bounds__(THREADS) mhsa_i8_kernel(const Args a) {
  constexpr int NKP = NKT * 8;          // keys (and Q rows) staged; rows past N are zero
  constexpr int LDQ = HD + 16;          // int8 row strides: conflict-free fragment reads
  constexpr int LDV = NKP + 16;
  constexpr int VE = 16 / sizeof(TI);   // elements per 16-byte load
  constexpr int CPR = HD / VE;          // 16-byte chunks per row
  extern __shared__ __align__(16) int8_t sm[];
  int8_t* Qs = sm;                      // [NKP][LDQ]
  int8_t* Ks = Qs + NKP * LDQ;          // [NKP][LDQ]
  int8_t* Vt = Ks + NKP * LDQ;          // [HD][LDV]  (V transposed, keys permuted)
  float* red = reinterpret_cast<float*>(Vt + HD * LDV);   // [3][WARPS]

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int tid = threadIdx.x;
  const TI* qg = static_cast<const TI*>(a.q) + b * a.qb + h * HD;
  const TI* kg = static_cast<const TI*>(a.k) + b * a.kb + h * HD;
  const TI* vg = static_cast<const TI*>(a.v) + b * a.vb + h * HD;
  const int rows = a.zero_pad ? a.n_valid : a.N;   // rows that hold values

  // pass 1: the three amaxes
  float mq = 0.0f, mk = 0.0f, mv = 0.0f;
  for (int c = tid; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, d0 = (c % CPR) * VE;
    float x[VE];
    widen(*reinterpret_cast<const int4*>(qg + r * a.qn + d0), qg, x);
#pragma unroll
    for (int e = 0; e < VE; ++e) mq = fmaxf(mq, fabsf(x[e]));
    widen(*reinterpret_cast<const int4*>(kg + r * a.kn + d0), kg, x);
#pragma unroll
    for (int e = 0; e < VE; ++e) mk = fmaxf(mk, fabsf(x[e]));
    widen(*reinterpret_cast<const int4*>(vg + r * a.vn + d0), vg, x);
#pragma unroll
    for (int e = 0; e < VE; ++e) mv = fmaxf(mv, fabsf(x[e]));
  }
  const float aq = __fadd_rn(block_max(mq, red, 0), 1e-9f);
  const float ak = __fadd_rn(block_max(mk, red, 1), 1e-9f);
  const float av = __fadd_rn(block_max(mv, red, 2), 1e-9f);
  const float iq = __fdiv_rn(127.0f, aq), ik = __fdiv_rn(127.0f, ak), iv = __fdiv_rn(127.0f, av);

  // pass 2: the int8 codes into shared memory
  for (int c = tid; c < NKP * CPR; c += THREADS) {
    const int r = c / CPR, d0 = (c % CPR) * VE;
    const bool ok = r < rows;
    int8_t cq[VE], ck[VE], cv[VE];
    float x[VE];
    if (ok) {
      widen(*reinterpret_cast<const int4*>(qg + r * a.qn + d0), qg, x);
#pragma unroll
      for (int e = 0; e < VE; ++e) cq[e] = quant_i8(x[e], iq);
      widen(*reinterpret_cast<const int4*>(kg + r * a.kn + d0), kg, x);
#pragma unroll
      for (int e = 0; e < VE; ++e) ck[e] = quant_i8(x[e], ik);
      widen(*reinterpret_cast<const int4*>(vg + r * a.vn + d0), vg, x);
#pragma unroll
      for (int e = 0; e < VE; ++e) cv[e] = quant_i8(x[e], iv);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) cq[e] = ck[e] = cv[e] = 0;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      Qs[r * LDQ + d0 + e] = cq[e];
      Ks[r * LDQ + d0 + e] = ck[e];
      Vt[(d0 + e) * LDV + vpos(r)] = cv[e];
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sc = __fmul_rn(__fmul_rn(aq, ak), a.qk_c);
  const float osc = __fmul_rn(av, INV_Q127);
  float* of = static_cast<float*>(a.o) + b * a.ob;
  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.o) + b * a.ob;
  const int nqt = (a.N + 15) / 16;
  for (int qt = warp; qt < nqt; qt += WARPS) {
    const int8_t* qw = Qs + qt * 16 * LDQ;
    // int32 scores of rows g and g+8 of this tile: s[j] covers keys 8j..8j+7
    int acc[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      const uint32_t af[4] = {ld32(qw + g * LDQ + kk + 4 * t), ld32(qw + (g + 8) * LDQ + kk + 4 * t),
                              ld32(qw + g * LDQ + kk + 16 + 4 * t),
                              ld32(qw + (g + 8) * LDQ + kk + 16 + 4 * t)};
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const int8_t* kr = Ks + (j * 8 + g) * LDQ + kk + 4 * t;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 16)};
        mma_s8(acc[j], af, bf);
      }
    }
    float s[NKT][4];
    float mx0 = -3.4028235e38f, mx1 = -3.4028235e38f;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = j * 8 + 2 * t + (r & 1);
        const float v = col < a.n_valid ? __fmul_rn(__int2float_rn(acc[j][r]), sc) : -1e30f;
        s[j][r] = v;
        if (r < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = expf(__fsub_rn(s[j][r], r < 2 ? mx0 : mx1));
        s[j][r] = p;
        if (r < 2) sum0 = __fadd_rn(sum0, p); else sum1 = __fadd_rn(sum1, p);
      }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    // the probability codes as k32 A fragments (keys in V^T's permuted order)
    uint32_t pa[NKT / 4][4];
#pragma unroll
    for (int ks = 0; ks < NKT / 4; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j0 = 4 * ks + 2 * half, j1 = j0 + 1;
        pa[ks][2 * half] = pack4(code_a(s[j0][0], sum0), code_a(s[j0][1], sum0),
                                 code_a(s[j1][0], sum0), code_a(s[j1][1], sum0));
        pa[ks][2 * half + 1] = pack4(code_a(s[j0][2], sum1), code_a(s[j0][3], sum1),
                                     code_a(s[j1][2], sum1), code_a(s[j1][3], sum1));
      }
    int o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0;
#pragma unroll
    for (int ks = 0; ks < NKT / 4; ++ks) {
      // A registers: {row g, keys 4t..}, {row g+8, keys 4t..}, {row g, 16+4t..}, {row g+8, ..}
      const uint32_t af[4] = {pa[ks][0], pa[ks][1], pa[ks][2], pa[ks][3]};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int8_t* vr = Vt + (j * 8 + g) * LDV + ks * 32 + 4 * t;
        const uint32_t bf[2] = {ld32(vr), ld32(vr + 16)};
        mma_s8(o[j], af, bf);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = qt * 16 + g + hh * 8;
      if (row >= a.N) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const long long at = row * a.on + h * HD + j * 8 + 2 * t;
        const float v0 = __fmul_rn(__int2float_rn(o[j][2 * hh]), osc);
        const float v1 = __fmul_rn(__int2float_rn(o[j][2 * hh + 1]), osc);
        if (a.out_f32) store2(of + at, v0, v1); else store2(oh + at, v0, v1);
      }
    }
  }
  // the lanes past the last head (the block path's pad-head slots) are zero
  const int pad0 = a.heads * HD;
  if (h == 0 && pad0 < a.lanes) {
    const int w = a.lanes - pad0;
    for (int c = tid; c < a.N * w; c += THREADS) {
      const long long at = (c / w) * a.on + pad0 + c % w;
      if (a.out_f32) of[at] = 0.0f; else oh[at] = __float2bfloat16_rn(0.0f);
    }
  }
}

template <class TI, int HD, int NKT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int NKP = NKT * 8;
  const int smem = 2 * NKP * (HD + 16) + HD * (NKP + 16) + 3 * WARPS * 4;
  cudaError_t e = cudaFuncSetAttribute(mhsa_i8_kernel<TI, HD, NKT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mhsa_i8_kernel<TI, HD, NKT><<<B * a.heads, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class TI, int HD>
cudaError_t launch_keys(const Args& a, int B, cudaStream_t stream) {
  const int nkt = (a.N + 31) / 32 * 4;
  if (nkt <= 4) return launch<TI, HD, 4>(a, B, stream);
  if (nkt <= 8) return launch<TI, HD, 8>(a, B, stream);
  if (nkt <= 16) return launch<TI, HD, 16>(a, B, stream);
  if (nkt <= 28) return launch<TI, HD, 28>(a, B, stream);
  return launch<TI, HD, 32>(a, B, stream);
}

template <class TI>
cudaError_t launch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_keys<TI, 64>(a, B, stream);
  if (hd == 32) return launch_keys<TI, 32>(a, B, stream);
  return cudaErrorInvalidValue;
}


// ---- the Hopper form ----
constexpr int H_MAX_WARPS = 16;   // 256 query rows
constexpr int H_KC = 64;          // keys a score chunk

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int round32(int n) { return (n + 31) / 32 * 32; }

// The Hopper form's shared memory for N rows, n_valid keys, head width hd
// and esize-byte inputs: the raw stage (Q, K and V over N rows of hd x
// esize + 16 bytes; the zero-pad form fills n_valid of them), the int8
// codes of Q over round16(N) rows and of K over round32(n_valid) rows at
// hd + 16 bytes a row, V^T (hd rows of round32(n_valid) + 16 bytes) and the
// amax slots (3 x 16 floats). Every stride is an odd number of 16-byte
// units: the 16-byte reads and the ldmatrix rows are conflict-free.
struct PlanI {
  int nq, nk, ldr, stage, codes, smem;
};

__host__ __device__ __forceinline__ PlanI plan_i8(int N, int n_valid, int hd, int esize) {
  PlanI p;
  p.nq = round16(N);
  p.nk = round32(n_valid);
  p.ldr = hd * esize + 16;
  p.stage = 3 * N * p.ldr;
  p.codes = (p.nq + p.nk) * (hd + 16) + hd * (p.nk + 16);
  p.smem = p.stage + p.codes + 3 * H_MAX_WARPS * 4;
  return p;
}

// The form rule: the Hopper form wherever its stage and codes fit a
// block's shared memory (at hd 64, fp32 in at 256 rows takes the first form).
__host__ __device__ __forceinline__ bool i8_hopper(int N, int n_valid, int hd, int esize) {
  return (hd == 32 || hd == 64) && N > 0 && N <= 256 && n_valid > 0 && n_valid <= N &&
         plan_i8(N, n_valid, hd, esize).smem <= dlq::SMEM_OPT_IN;
}

// Exact conversions on the full-rate pipes (I2F, F2I and FRND issue at a
// quarter of the FFMA rate): float(n) for |n| < 2^22, and rint(x) for x in
// [-2^22, 2^22] (x + 1.5 * 2^23 rounds to nearest even at 1).
constexpr float MAGIC = 12582912.0f;   // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ float i2f_exact(int n) {
  return __fsub_rn(__int_as_float(n + MAGIC_BITS), MAGIC);
}

// The bits of x + 1.5 * 2^23 for x clipped to [lo, 127]: their low byte is
// rint(x) as an int8 (two's complement). As quant_i8's code (clip(rint(h *
// inv_q), +-127)) with the clip first: the same for every input, NaN
// included (fmaxf(NaN, lo) is lo either way).
__device__ __forceinline__ uint32_t code_bits(float x, float lo) {
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(fminf(fmaxf(x, lo), 127.0f), MAGIC)));
}

// The low bytes of four words, a's lowest.
__device__ __forceinline__ uint32_t pack_lo(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// max(m, |x|) over the 16 bytes of raw: bf16 pairs (max of |x| is exact in
// bf16, and __hmax2, as fmaxf, returns the other operand for a NaN) or fp32.
__device__ __forceinline__ void amax16(float&, __nv_bfloat162& m2, const int4& raw,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = w[i] & 0x7FFF7FFFu;
    m2 = __hmax2(m2, *reinterpret_cast<const __nv_bfloat162*>(&a));
  }
}
__device__ __forceinline__ void amax16(float& m, __nv_bfloat162&, const int4& raw, const float*) {
  m = fmaxf(m, fabsf(__int_as_float(raw.x)));
  m = fmaxf(m, fabsf(__int_as_float(raw.y)));
  m = fmaxf(m, fabsf(__int_as_float(raw.z)));
  m = fmaxf(m, fabsf(__int_as_float(raw.w)));
}
// 16 bytes of the stage as fp32 values by bit operations on the loaded
// words (a bf16 is the high half of its fp32), so the load stays one LDS.128
// (widen's element pointers make nvcc split it into 16-bit loads).
__device__ __forceinline__ void unpack16(const int4 raw, const __nv_bfloat16*, float (&x)[8]) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack16(const int4 raw, const float*, float (&x)[4]) {
  x[0] = __int_as_float(raw.x);
  x[1] = __int_as_float(raw.y);
  x[2] = __int_as_float(raw.z);
  x[3] = __int_as_float(raw.w);
}

__device__ __forceinline__ float amax_of(float m, __nv_bfloat162 m2) {
  return fmaxf(m, fmaxf(__low2float(m2), __high2float(m2)));
}

__device__ __forceinline__ int quad_max_i(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// body(Int<NS>, mask, kb) for each 64-key chunk of the nk32 32-key steps,
// in key order: the full chunks unmasked (every key before the last chunk
// is below n_valid), the last one (NS = 1 or 2 steps) masked.
template <class Body>
__device__ __forceinline__ void over_chunks(int nk32, Body&& body) {
  const int last = (nk32 - 1) / 2 * H_KC;
  for (int kb = 0; kb < last; kb += H_KC) body(Int<2>{}, Unmasked{}, kb);
  if (nk32 - last / 32 == 1)
    body(Int<1>{}, Masked{}, last);
  else
    body(Int<2>{}, Masked{}, last);
}

// int32 scores (Q8 K8^T) of this warp's 16 rows against the NS 32-key steps
// at kb. s[j][r]: rows g (r < 2) / g + 8, key kb + 8 j + 2 t + (r & 1).
template <int HD, int NS>
__device__ __forceinline__ void score_chunk(int (&s)[8][4], const uint32_t (&qf)[HD / 32][4],
                                            const int8_t* Kc, int kb, int lane) {
  constexpr int LDQ = HD + 16;
#pragma unroll
  for (int j = 0; j < 4 * NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
  // ldmatrix rows: matrix i = lane / 8 covers keys +8 (i >> 1), bytes +16 (i & 1)
  const int mi = lane >> 3, mr = lane & 7;
  const int8_t* kp = Kc + (kb + mr + 8 * (mi >> 1)) * LDQ + 16 * (mi & 1);
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk)
#pragma unroll
    for (int p = 0; p < 2 * NS; ++p) {
      uint32_t bk[4];
      ldsm_x4(bk, kp + 16 * p * LDQ + 32 * kk);
      const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
      mma_s8(s[2 * p], qf[kk], b0);
      mma_s8(s[2 * p + 1], qf[kk], b1);
    }
}

template <class TI, int HD>
__global__ void __launch_bounds__(H_MAX_WARPS * 32, 1) mhsa_i8_hopper(const Args a,
                                                                      const int items) {
  constexpr int VE = 16 / sizeof(TI);   // elements per 16-byte load
  constexpr int CPR = HD / VE;          // 16-byte chunks per row
  constexpr int LDQ = HD + 16;
  extern __shared__ __align__(16) unsigned char smb[];
  const PlanI p = plan_i8(a.N, a.n_valid, HD, sizeof(TI));
  const int LDV = p.nk + 16;
  const unsigned char* raw = smb;                            // [3][N][ldr]: Q, K, V
  int8_t* Qc = reinterpret_cast<int8_t*>(smb + p.stage);     // [nq][LDQ]
  int8_t* Kc = Qc + p.nq * LDQ;                              // [nk][LDQ]
  int8_t* Vt = Kc + p.nk * LDQ;                              // [HD][LDV], keys in vpos order
  float* red = reinterpret_cast<float*>(Vt + HD * LDV);      // [3][H_MAX_WARPS]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rows = a.zero_pad ? a.n_valid : a.N;   // rows that hold values
  const int plane = a.N * p.ldr;                   // bytes of one of Q, K, V in the stage
  const TI* tag = nullptr;

  // the cp.async copies of item it's Q, K and V rows below `rows`
  auto load_item = [&](int it) {
    const int b = it / a.heads, h = it - b * a.heads;
    const TI* qg = static_cast<const TI*>(a.q) + b * a.qb + h * HD;
    const TI* kg = static_cast<const TI*>(a.k) + b * a.kb + h * HD;
    const TI* vg = static_cast<const TI*>(a.v) + b * a.vb + h * HD;
    for (int c = tid; c < rows * CPR; c += nthr) {
      const int r = c / CPR, cc = c - r * CPR;
      unsigned char* d = smb + r * p.ldr + cc * 16;
      cp_async16(d, qg + r * a.qn + cc * VE, true);
      cp_async16(d + plane, kg + r * a.kn + cc * VE, true);
      cp_async16(d + 2 * plane, vg + r * a.vn + cc * VE, true);
    }
  };

  int it = blockIdx.x;
  if (it < items) load_item(it);
  cp_async_commit();
  for (; it < items; it += gridDim.x) {
    const int b = it / a.heads, h = it - b * a.heads;
    cp_async_wait<0>();
    __syncthreads();

    // the three amaxes from the stage (max: exact in any order)
    float mq = 0.0f, mk = 0.0f, mv = 0.0f;
    {
      const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.0f, 0.0f);
      __nv_bfloat162 q2 = z2, k2 = z2, v2 = z2;
      for (int c = tid; c < rows * CPR; c += nthr) {
        const int r = c / CPR, cc = c - r * CPR;
        const unsigned char* s0 = raw + r * p.ldr + cc * 16;
        amax16(mq, q2, *reinterpret_cast<const int4*>(s0), tag);
        amax16(mk, k2, *reinterpret_cast<const int4*>(s0 + plane), tag);
        amax16(mv, v2, *reinterpret_cast<const int4*>(s0 + 2 * plane), tag);
      }
      mq = amax_of(mq, q2);
      mk = amax_of(mk, k2);
      mv = amax_of(mv, v2);
    }
    mq = dlq::warp_max(mq);
    mk = dlq::warp_max(mk);
    mv = dlq::warp_max(mv);
    if (lane == 0) {
      red[warp] = mq;
      red[H_MAX_WARPS + warp] = mk;
      red[2 * H_MAX_WARPS + warp] = mv;
    }
    __syncthreads();
    mq = red[0], mk = red[H_MAX_WARPS], mv = red[2 * H_MAX_WARPS];
    for (int w = 1; w < (nthr >> 5); ++w) {
      mq = fmaxf(mq, red[w]);
      mk = fmaxf(mk, red[H_MAX_WARPS + w]);
      mv = fmaxf(mv, red[2 * H_MAX_WARPS + w]);
    }
    const float aq = __fadd_rn(mq, 1e-9f), ak = __fadd_rn(mk, 1e-9f), av = __fadd_rn(mv, 1e-9f);
    const float iq = __fdiv_rn(127.0f, aq), ik = __fdiv_rn(127.0f, ak), iv = __fdiv_rn(127.0f, av);

    // V's codes into V^T, keys in vpos order: a unit (lane chunk dc, 32-key
    // group ks, half, tt) reads keys k0, k0 + 1, k0 + 8, k0 + 9 (k0 = 32 ks
    // + 16 half + 2 tt) and writes, at each of its VE lanes, their four
    // codes as one word at position 32 ks + 16 half + 4 tt
    const int nks = p.nk / 32, wv = CPR * nks * 8;
    int u = tid;
    for (; u < wv; u += nthr) {
      const int tt = u & 3, half = (u >> 2) & 1, rest = u >> 3;
      const int ks = rest % nks, dc = rest / nks;
      const int k0 = 32 * ks + 16 * half + 2 * tt;
      uint32_t cv[4][VE];
#pragma unroll
      for (int m = 0; m < 4; ++m) {   // branch-free: a key past the stage reads row 0, codes 0
        const int key = k0 + (m & 1) + 8 * (m >> 1);
        const bool in = key < rows;
        float x[VE];
        unpack16(*reinterpret_cast<const int4*>(raw + 2 * plane + (in ? key : 0) * p.ldr + dc * 16),
              tag, x);
#pragma unroll
        for (int e = 0; e < VE; ++e) cv[m][e] = in ? code_bits(__fmul_rn(x[e], iv), -127.0f) : 0u;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e)
        *reinterpret_cast<uint32_t*>(Vt + (dc * VE + e) * LDV + 32 * ks + 16 * half + 4 * tt) =
            pack_lo(cv[0][e], cv[1][e], cv[2][e], cv[3][e]);
    }
    // then, the index running on (the units balance over the threads), the
    // codes of Q (nq rows) and K (nk rows) from the stage, rows past `rows`
    // zero, VE codes a store
#pragma unroll 2
    for (; u < wv + (p.nq + p.nk) * CPR; u += nthr) {
      const int c = u - wv, rc = c / CPR, cc = c - rc * CPR;
      const bool isk = rc >= p.nq;
      const int r = isk ? rc - p.nq : rc;
      const bool in = r < rows;   // branch-free: a row past the stage reads row 0, codes 0
      float x[VE];
      unpack16(*reinterpret_cast<const int4*>(raw + (isk ? plane : 0) + (in ? r : 0) * p.ldr +
                                           cc * 16),
            tag, x);
      const float inv = isk ? ik : iq;
      uint32_t w[VE / 4];
#pragma unroll
      for (int e = 0; e < VE / 4; ++e)
        w[e] = in ? pack_lo(code_bits(__fmul_rn(x[4 * e], inv), -127.0f),
                            code_bits(__fmul_rn(x[4 * e + 1], inv), -127.0f),
                            code_bits(__fmul_rn(x[4 * e + 2], inv), -127.0f),
                            code_bits(__fmul_rn(x[4 * e + 3], inv), -127.0f))
                  : 0u;
      int8_t* dst = (isk ? Kc : Qc) + r * LDQ + cc * VE;
      if constexpr (VE == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
    __syncthreads();   // the codes are in; the stage is free for the next item
    if (it + gridDim.x < items) load_item(it + gridDim.x);
    cp_async_commit();

    // attention: this warp's 16 query rows
    const int r0 = warp * 16;
    const float sc = __fmul_rn(__fmul_rn(aq, ak), a.qk_c);
    const float osc = __fmul_rn(av, INV_Q127);
    uint32_t qf[HD / 32][4];
    {
      const int mi = lane >> 3, mr = lane & 7;
      const int8_t* qp = Qc + (r0 + mr + 8 * (mi & 1)) * LDQ + 16 * (mi >> 1);
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) ldsm_x4(qf[kk], qp + 32 * kk);
    }
    const int nk32 = p.nk / 32;
    // f(j, r, valid) over the NS steps' scores, in key order (valid: key <
    // n_valid, tested only in the masked chunk); an 8-key tile wholly past
    // n_valid is skipped (a warp-uniform branch): its p are 0, which add
    // nothing to a sum, and its codes are 0 (pass 3 sets them)
    auto each = [&](auto ns, auto mask, int kb, auto&& f) {
#pragma unroll
      for (int j = 0; j < 4 * decltype(ns)::value; ++j)
        if (!decltype(mask)::value || kb + j * 8 < a.n_valid) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            f(j, r, !decltype(mask)::value || kb + j * 8 + 2 * t + (r & 1) < a.n_valid);
        }
    };

    // pass 1: the integer row max of the valid keys (fl(fl(acc) * sc) is
    // monotonic in acc for sc > 0, so its max is the max score)
    int m0 = INT_MIN, m1 = INT_MIN;
    over_chunks(nk32, [&](auto ns, auto mask, int kb) {
      int acc[8][4];
      score_chunk<HD, decltype(ns)::value>(acc, qf, Kc, kb, lane);
      each(ns, mask, kb, [&](int j, int r, bool valid) {
        if (valid) {
          if (r < 2) m0 = max(m0, acc[j][r]); else m1 = max(m1, acc[j][r]);
        }
      });
    });
    const float mx0 = __fmul_rn(i2f_exact(quad_max_i(m0)), sc);
    const float mx1 = __fmul_rn(i2f_exact(quad_max_i(m1)), sc);

    // pass 2: p = expf(s - max) and the row sum, each thread in key order
    float sum0 = 0.0f, sum1 = 0.0f;
    over_chunks(nk32, [&](auto ns, auto mask, int kb) {
      int acc[8][4];
      score_chunk<HD, decltype(ns)::value>(acc, qf, Kc, kb, lane);
      each(ns, mask, kb, [&](int j, int r, bool valid) {
        const float v = valid ? __fmul_rn(i2f_exact(acc[j][r]), sc) : -1e30f;
        const float e = expf(__fsub_rn(v, r < 2 ? mx0 : mx1));
        if (r < 2) sum0 = __fadd_rn(sum0, e); else sum1 = __fadd_rn(sum1, e);
      });
    });
    const Recip rs0 = recip(quad_sum(sum0)), rs1 = recip(quad_sum(sum1));

    // pass 3: a8 = clip(rint(p / sum * 127), 0, 127) as k32 A fragments
    // (keys in V^T's permuted order), then a8 V8; V^T's B fragments by
    // ldmatrix: matrix i covers lanes +8 (i >> 1), positions +16 (i & 1)
    int o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0;
    const int8_t* vp = Vt + ((lane & 7) + 8 * (lane >> 4)) * LDV + 16 * ((lane >> 3) & 1);
    over_chunks(nk32, [&](auto ns, auto mask, int kb) {
      int acc[8][4];
      score_chunk<HD, decltype(ns)::value>(acc, qf, Kc, kb, lane);
      each(ns, mask, kb, [&](int j, int r, bool valid) {
        const float v = valid ? __fmul_rn(i2f_exact(acc[j][r]), sc) : -1e30f;
        const float e = expf(__fsub_rn(v, r < 2 ? mx0 : mx1));
        const float q = div_fast(e, r < 2 ? rs0 : rs1);
        acc[j][r] = static_cast<int>(code_bits(__fmul_rn(q, 127.0f), 0.0f));
      });
      if constexpr (decltype(mask)::value) {
#pragma unroll
        for (int j = 0; j < 4 * decltype(ns)::value; ++j)
          if (kb + j * 8 >= a.n_valid) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      }
#pragma unroll
      for (int ks = 0; ks < decltype(ns)::value; ++ks) {
        uint32_t af[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j0 = 4 * ks + 2 * half, j1 = j0 + 1;
          af[2 * half] = pack_lo(acc[j0][0], acc[j0][1], acc[j1][0], acc[j1][1]);
          af[2 * half + 1] = pack_lo(acc[j0][2], acc[j0][3], acc[j1][2], acc[j1][3]);
        }
#pragma unroll
        for (int jd = 0; jd < HD / 16; ++jd) {
          uint32_t bv[4];
          ldsm_x4(bv, vp + 16 * jd * LDV + kb + 32 * ks);
          const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
          mma_s8(o[2 * jd], af, b0);
          mma_s8(o[2 * jd + 1], af, b1);
        }
      }
    });

    // out = f32(a8 V8) * (av / 127^2)
    float* of = static_cast<float*>(a.o) + b * a.ob;
    __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.o) + b * a.ob;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + g + hh * 8;
      if (row >= a.N) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const long long at = row * a.on + h * HD + j * 8 + 2 * t;
        const float v0 = __fmul_rn(i2f_exact(o[j][2 * hh]), osc);
        const float v1 = __fmul_rn(i2f_exact(o[j][2 * hh + 1]), osc);
        if (a.out_f32) store2(of + at, v0, v1); else store2(oh + at, v0, v1);
      }
    }
    // the lanes past the last head (the block path's pad-head slots) are zero
    const int pad0 = a.heads * HD;
    if (h == 0 && pad0 < a.lanes) {
      const int w = a.lanes - pad0;
      for (int c = lane; c < 16 * w; c += 32) {
        const int r = c / w;
        if (r0 + r >= a.N) break;
        const long long at = (r0 + r) * a.on + pad0 + c - r * w;
        if (a.out_f32) of[at] = 0.0f; else oh[at] = __float2bfloat16_rn(0.0f);
      }
    }
    __syncthreads();   // the codes are free for the next item
  }
  cp_async_wait<0>();
}

template <class TI, int HD>
cudaError_t launch_hopper(const Args& a, int B, cudaStream_t stream) {
  const PlanI p = plan_i8(a.N, a.n_valid, HD, sizeof(TI));
  const int threads = p.nq / 16 * 32;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = dlq::device(&dev, &sms);
  if (e != cudaSuccess) return e;
  if ((e = dlq::blocks_per_sm<mhsa_i8_hopper<TI, HD>>(dev, threads, p.smem, &per_sm)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int items = B * a.heads;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  mhsa_i8_hopper<TI, HD><<<grid, threads, p.smem, stream>>>(a, items);
  return cudaGetLastError();
}

template <class TI>
cudaError_t launch_hd_hopper(const Args& a, int B, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_hopper<TI, 64>(a, B, stream);
  if (hd == 32) return launch_hopper<TI, 32>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// K18's form rule (1: the Hopper form, 0: the first form) and the Hopper
// form's launch plan: out = {threads, raw stage bytes, code bytes, dynamic
// shared-memory bytes}, all 0 where the first form serves.
extern "C" int dlq_mhsa_i8_form(int N, int n_valid, int hd, int in_f32) {
  return i8_hopper(N, n_valid, hd, in_f32 ? 4 : 2) ? 1 : 0;
}

extern "C" int dlq_mhsa_i8_plan(int N, int n_valid, int hd, int in_f32, int* out) {
  const int es = in_f32 ? 4 : 2;
  const bool hop = i8_hopper(N, n_valid, hd, es);
  const PlanI p = plan_i8(N, n_valid, hd, es);
  out[0] = hop ? p.nq / 16 * 32 : 0;
  out[1] = hop ? p.stage : 0;
  out[2] = hop ? p.codes : 0;
  out[3] = hop ? p.smem : 0;
  return 0;
}

static int i8_args(int B, int N, int heads, int hd, int n_valid, int lanes) {
  if (N <= 0 || N > 256 || n_valid <= 0 || n_valid > N || heads <= 0 || lanes < heads * hd ||
      B < 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// q, k, v: bf16 (in_f32 0) or fp32 (1), element (b, n, h*hd + d) at
// b*xb + n*xn + h*hd + d, 16-byte aligned rows; out: bf16 (out_f32 0) or fp32
// [B, N, lanes] through ob/on. hd 32 or 64; N <= 256; qk_c = f32(1/sqrt(hd)
// / 127^2). The Hopper form where the rule takes it, else the first form.
extern "C" int dlq_mhsa_i8(const void* q, const void* k, const void* v, void* out, long long qb,
                           long long qn, long long kb, long long kn, long long vb, long long vn,
                           long long ob, long long on, int B, int N, int heads, int hd,
                           int n_valid, int lanes, int zero_pad, int in_f32, int out_f32,
                           float qk_c, void* stream) {
  if (const int rc = i8_args(B, N, heads, hd, n_valid, lanes)) return rc;
  if (B == 0) return 0;
  Args a{q, k, v, out, qb, qn, kb, kn, vb, vn, ob, on, N, heads, n_valid, lanes, zero_pad,
         out_f32, qk_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!i8_hopper(N, n_valid, hd, in_f32 ? 4 : 2))
    return (int)(in_f32 ? launch_hd<float>(a, B, hd, st)
                        : launch_hd<__nv_bfloat16>(a, B, hd, st));
  return (int)(in_f32 ? launch_hd_hopper<float>(a, B, hd, st)
                      : launch_hd_hopper<__nv_bfloat16>(a, B, hd, st));
}

// The first form at any shape it takes (what the Hopper form is held to).
extern "C" int dlq_mhsa_i8_first(const void* q, const void* k, const void* v, void* out,
                                 long long qb, long long qn, long long kb, long long kn,
                                 long long vb, long long vn, long long ob, long long on, int B,
                                 int N, int heads, int hd, int n_valid, int lanes, int zero_pad,
                                 int in_f32, int out_f32, float qk_c, void* stream) {
  if (const int rc = i8_args(B, N, heads, hd, n_valid, lanes)) return rc;
  if (B == 0) return 0;
  Args a{q, k, v, out, qb, qn, kb, kn, vb, vn, ob, on, N, heads, n_valid, lanes, zero_pad,
         out_f32, qk_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(in_f32 ? launch_hd<float>(a, B, hd, st)
                      : launch_hd<__nv_bfloat16>(a, B, hd, st));
}
