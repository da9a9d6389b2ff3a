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
// Design, simple first: the amax needs every row of the (sample, head)
// before the first product, so one block of 128 threads owns a whole
// (sample, head). Pass 1 reads Q, K, V from device memory for the three
// amaxes (fmaxf: exact in any order) and reduces them over the block; pass
// 2 reads them again and writes the int8 codes into shared memory (Q and K
// row-major, V transposed with each 32-key group permuted, below). Then each
// warp takes 16 query rows at a time: QK^T on mma.sync.m16n8k32 (s8 x s8 ->
// s32), the score rows in registers, max, exp, sum, division and the
// probability codes in registers, and the AV product from those registers.
// The m16n8 C fragment of key tile j gives a lane keys 8j+2t, 8j+2t+1, and
// the k32 A fragment wants keys 4t..4t+3 and 16+4t..19+4t; the int32 sum is
// exact in any key order, so V's keys are stored in the order the lanes
// hold them instead of moving probabilities between lanes. Keys past the
// row count carry a8 = 0 (masked) and v8 = 0 (zero-filled).
#include <cuda_bf16.h>
#include <cstdint>

#include "igemm.cuh"
#include "vit_common.cuh"

namespace {

using dlq::mma_s8;
using dlq::quant_i8;

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
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

}  // namespace

// q, k, v: bf16 (in_f32 0) or fp32 (1), element (b, n, h*hd + d) at
// b*xb + n*xn + h*hd + d, 16-byte aligned rows; out: bf16 (out_f32 0) or fp32
// [B, N, lanes] through ob/on. hd 32 or 64; N <= 256 (a score row in
// registers); qk_c = f32(1/sqrt(hd) / 127^2).
extern "C" int dlq_mhsa_i8(const void* q, const void* k, const void* v, void* out, long long qb,
                           long long qn, long long kb, long long kn, long long vb, long long vn,
                           long long ob, long long on, int B, int N, int heads, int hd,
                           int n_valid, int lanes, int zero_pad, int in_f32, int out_f32,
                           float qk_c, void* stream) {
  if (N <= 0 || N > 256 || n_valid <= 0 || n_valid > N || heads <= 0 || lanes < heads * hd)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q, k, v, out, qb, qn, kb, kn, vb, vn, ob, on, N, heads, n_valid, lanes, zero_pad,
         out_f32, qk_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(in_f32 ? launch_hd<float>(a, B, hd, st)
                      : launch_hd<__nv_bfloat16>(a, B, hd, st));
}
