// Shared building blocks of the port's bf16 tensor-core kernels: K6 mhsa
// (bf16 x bf16), K14 vit_pre_bf16 and K15 vit_post_bf16 (the bf16 ViT layer:
// bf16 K-major weights), and, with int4 weights unpacked to bf16 in
// registers, K11 vit_pre_w4 and K12 vit_post_w4 (the W4A16 ViT layer:
// per-OC weights, halves-packed) and K13 matmul_int4 (the W4A16 GEMM:
// adjacent-packed weights with group-wise scales). The product is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands, exact
// products, fp32 sums in the tensor core's order.
//
// Fragment layout of m16n8k16 (PTX ISA): lane = 4 g + t; A regs a0..a3 hold
// rows g / g+8 at K slots (2t, 2t+1) and (2t+8, 2t+9); B regs b0, b1 hold
// column g at the same K slots; C regs hold rows g / g+8, columns 2t, 2t+1.
// The int4 kernels assign K slots to K values in another order, the same
// for A and B (a sum does not depend on which slot carries which K value):
// within each 16-wide K step, thread t's slots (2t, 2t+1, 2t+8, 2t+9) carry K
// values 4t .. 4t+3. Then a thread's A fragment of one row is one 64-bit
// shared load, and its B fragment is 4 consecutive weights: 2 bytes of
// adjacent packing, or 4 bytes of halves packing that also carry the 4
// weights of the high half.
//
// Nibble to bf16 is exact and branch-free: with the nibble n at bits 0-3 of
// a 16-bit lane, (n ^ 0x4308) is the bf16 value 128 + (n ^ 8) = 136 + n for
// the signed n in [-8, 7], and a bf16 subtraction of 136 gives n exactly.
//
// A weight stage is BK4 = 32 packed bytes per output column (igemm.cuh's
// load_b4, rows LDS4 = 48 bytes apart: a warp's fragment reads hit distinct
// banks); bf16 A rows are `lda` elements apart with lda*2 = 32 (mod 128) so
// that a half-warp's 64-bit fragment loads of four rows hit 32 distinct banks.
// A bf16 weight stage (K14, K15) is BKW = 64 K values of each K-major [N, K]
// row, rows LDW = 80 elements (160 bytes, 32 mod 128) apart: a thread's B
// fragment of one 16-wide step is the 4 weights of its K values 4t..4t+3,
// one 64-bit shared load, and a half-warp's loads hit 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "igemm.cuh"

namespace dlq {

constexpr int BKW = 64;          // bf16 weight stage: K values per column
constexpr int LDW = BKW + 16;    // its padded row stride (elements)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The signed nibbles at bits 0-3 and 16-19 of w (the other bits are
// ignored) as the exact bf16 pair {lo, hi}.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t w) {
  uint32_t v = (w & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;   // {136, 136}
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16 halves-packed bytes -> the 16 bf16 nibble values of one half (shift
// 0: the low nibbles, 4: the high ones), in byte order: lo holds bytes
// 0-7, hi bytes 8-15.
__device__ __forceinline__ void unpack16(const uint4 p, int sh, uint4& lo, uint4& hi) {
  auto two = [&](uint32_t w, uint32_t& a, uint32_t& b) {
    a = nib2_bf16(__byte_perm(w, 0, 0x4140) >> sh);   // bytes 0, 1
    b = nib2_bf16(__byte_perm(w, 0, 0x4342) >> sh);   // bytes 2, 3
  };
  two(p.x, lo.x, lo.y);
  two(p.y, lo.z, lo.w);
  two(p.z, hi.x, hi.y);
  two(p.w, hi.z, hi.w);
}

// bf16x2 a * b, rounded once to nearest even (the fused multiply-add of the
// exact product with -0).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// A BM x BN fp32 accumulator tile of bf16 products over 8 warps (WARPS_M x
// WARPS_N), in the K-slot order above.
template <int BM, int BN, int WARPS_M, int WARPS_N>
struct HTile {
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static_assert(MI * 16 == WM && NI * 8 == WN, "warp tile");

  float acc[MI][NI][4];
  int warp_m, warp_n, g, t;

  __device__ __forceinline__ HTile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    warp_m = warp / WARPS_N;
    warp_n = warp % WARPS_N;
    g = lane >> 2;
    t = lane & 3;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  }

  // The weight column of fragment j in this block tile.
  __device__ __forceinline__ int col(int j) const { return warp_n * WN + j * 8 + g; }

  // acc += A (16 K values at As, rows lda elements apart) x the B fragments b.
  __device__ __forceinline__ void mma_rows(const __nv_bfloat16* As, int lda,
                                           const uint32_t (&b)[NI][2]) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const __nv_bfloat16* p = As + (warp_m * WM + i * 16 + g) * lda + 4 * t;
      const uint2 r0 = *reinterpret_cast<const uint2*>(p);
      const uint2 r8 = *reinterpret_cast<const uint2*>(p + 8 * lda);
      const uint32_t a[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
    }
  }

  // One stage of a halves-packed int4 weight (K11, K12): Bs [BN][LDS4]
  // holds 32 bytes per column, byte k carrying the weight of K value k of the
  // low half (A columns at Alo) and of the high half (A columns at Ahi).
  // Each 32-bit word feeds one m16n8k16 product per half.
  __device__ __forceinline__ void step_h4(const __nv_bfloat16* Alo, const __nv_bfloat16* Ahi,
                                          int lda, const int8_t* Bs) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t lo[NI][2], hi[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(Bs + col(j) * LDS4 + 16 * s + 4 * t);
        const uint32_t w01 = __byte_perm(w, 0, 0x4140);   // bytes 0, 1 at bits 0 and 16
        const uint32_t w23 = __byte_perm(w, 0, 0x4342);   // bytes 2, 3
        lo[j][0] = nib2_bf16(w01);
        lo[j][1] = nib2_bf16(w23);
        hi[j][0] = nib2_bf16(w01 >> 4);
        hi[j][1] = nib2_bf16(w23 >> 4);
      }
      mma_rows(Alo + 16 * s, lda, lo);
      mma_rows(Ahi + 16 * s, lda, hi);
    }
  }

  // One stage of a bf16 K-major weight (K14, K15): Bs [BN][LDW] holds BKW
  // K values per column, in the K-slot order above (b0: K values 4t, 4t+1;
  // b1: 4t+2, 4t+3); A columns at As.
  __device__ __forceinline__ void step_bf16(const __nv_bfloat16* As, int lda,
                                            const __nv_bfloat16* Bs) {
#pragma unroll
    for (int s = 0; s < BKW / 16; ++s) {
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const uint2 w = *reinterpret_cast<const uint2*>(Bs + col(j) * LDW + 16 * s + 4 * t);
        b[j][0] = w.x;
        b[j][1] = w.y;
      }
      mma_rows(As + 16 * s, lda, b);
    }
  }

  // One stage of an adjacent-packed int4 weight with group-wise scales
  // (K13): Bs [BN][LDS4] holds 32 bytes per column, byte k carrying the
  // weights of K values 2k and 2k + 1; A columns at As. Each weight is
  // dequantized as bf16(n * scale) (one rounding of the exact product), the
  // scale of its group read from sc (bf16 [N, G], row n, group of K value
  // k0 + 16 s; `group` a multiple of 16). Columns past N use row N - 1.
  __device__ __forceinline__ void step_g4(const __nv_bfloat16* As, int lda, const int8_t* Bs,
                                          const __nv_bfloat16* __restrict__ sc, int G, int n0,
                                          int N, int k0, int group) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = (k0 + 16 * s) / group;
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = min(n0 + col(j), N - 1);
        const __nv_bfloat16 sv = sc[(size_t)n * G + gi];
        const uint32_t s2 = (uint32_t)__bfloat16_as_ushort(sv) * 0x00010001u;
        const uint32_t h = *reinterpret_cast<const uint16_t*>(Bs + col(j) * LDS4 + 8 * s + 2 * t);
        const uint32_t w = h | (h << 12);   // nibbles 0, 1 at bits 0, 16; 2, 3 at bits 8, 24
        b[j][0] = mul_bf16x2(nib2_bf16(w), s2);
        b[j][1] = mul_bf16x2(nib2_bf16(w >> 8), s2);
      }
      mma_rows(As + 16 * s, lda, b);
    }
  }
};

// The K loop with a bf16 A tile resident in shared memory (As [BM][lda], all
// of K) and a halves-packed int4 weight streamed: rows n0..n0+BN-1 of the
// K-major [N, K/2] bytes (K/2 a multiple of BK4), two cp.async stages. The
// caller has written (or issued the copies of) As before the call: the
// first wait and barrier inside order them before any read.
template <class Tile, int BN>
__device__ __forceinline__ void mainloop_resident_h4(Tile& tile, const __nv_bfloat16* As, int lda,
                                                     int8_t* Bs, const uint8_t* __restrict__ w,
                                                     int N, int K, int n0) {
  const int Kh = K / 2, KT = Kh / BK4;
  tile.zero();
  load_b4<BN>(Bs, w, N, Kh, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_b4<BN>(Bs + (s ^ 1) * BN * LDS4, w, N, Kh, n0, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile.step_h4(As + kt * BK4, As + Kh + kt * BK4, lda, Bs + s * BN * LDS4);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// B loader of a bf16 weight: stage kt of rows n0..n0+BN-1 of the K-major
// [N, K] bf16 matrix (K a multiple of BKW; rows >= N zero-filled).
template <int BN>
__device__ __forceinline__ void load_bh(__nv_bfloat16* Bs, const __nv_bfloat16* __restrict__ w,
                                        int N, int K, int n0, int kt) {
  constexpr int CPR = BKW / 8;   // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < BN * CPR / THREADS; ++j) {
    const int chunk = threadIdx.x + j * THREADS;
    const int r = chunk / CPR, q = chunk % CPR;
    const int n = n0 + r;
    const bool v = n < N;
    const __nv_bfloat16* src = v ? w + (size_t)n * K + (size_t)kt * BKW + q * 8 : w;
    cp_async16(Bs + r * LDW + q * 8, src, v);
  }
}

// mainloop_resident_h4 with a bf16 weight (K14, K15): rows n0..n0+BN-1 of
// the K-major [N, K] bf16 matrix, two cp.async stages of BKW K values.
template <class Tile, int BN>
__device__ __forceinline__ void mainloop_resident_bh(Tile& tile, const __nv_bfloat16* As, int lda,
                                                     __nv_bfloat16* Bs,
                                                     const __nv_bfloat16* __restrict__ w, int N,
                                                     int K, int n0) {
  const int KT = K / BKW;
  tile.zero();
  load_bh<BN>(Bs, w, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_bh<BN>(Bs + (s ^ 1) * BN * LDW, w, N, K, n0, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile.step_bf16(As + kt * BKW, lda, Bs + s * BN * LDW);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The resident-A K loop of either bf16-activation weight format: int4
// halves-packed [N, K/2] bytes (W4) or bf16 [N, K]; Bs: the two stages.
template <bool W4, class Tile, int BN>
__device__ __forceinline__ void mainloop_resident_hw(Tile& tile, const __nv_bfloat16* As, int lda,
                                                     void* Bs, const void* w, int N, int K,
                                                     int n0) {
  if constexpr (W4)
    mainloop_resident_h4<Tile, BN>(tile, As, lda, static_cast<int8_t*>(Bs),
                                   static_cast<const uint8_t*>(w), N, K, n0);
  else
    mainloop_resident_bh<Tile, BN>(tile, As, lda, static_cast<__nv_bfloat16*>(Bs),
                                   static_cast<const __nv_bfloat16*>(w), N, K, n0);
}

// Bytes of the two B stages of mainloop_resident_hw.
template <bool W4>
constexpr int hw_stage_bytes(int BN) { return 2 * BN * (W4 ? LDS4 : LDW * 2); }

// Visit this thread's accumulator pairs: f(row, col, v_even, v_odd) for
// columns col, col + 1 of the block tile (int or fp32 accumulators).
template <class Tile, class F>
__device__ __forceinline__ void for_pairs(const Tile& tile, F&& f) {
#pragma unroll
  for (int i = 0; i < Tile::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tile::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(tile.warp_m * Tile::WM + i * 16 + tile.g + h * 8,
          tile.warp_n * Tile::WN + j * 8 + tile.t * 2, tile.acc[i][j][2 * h],
          tile.acc[i][j][2 * h + 1]);
}

}  // namespace dlq
