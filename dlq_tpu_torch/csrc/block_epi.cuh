// The int8 block epilogues of the Hopper forms of K3 (basic_block.cu) and
// K4 (bottleneck_block.cu): a consumer warpgroup's wgmma sums requantized
// to int8 codes in the reference's formula, and the skip add of the last
// conv. Both kernels take the same values as their first forms:
//   code = clip(rint(fma(acc, s, b) * inv), lo, 127)
//   out  = clip(z + clip(rint(x * rs), -127, 127), 0, 127)
// Codes are rounded by adding 1.5 x 2^23 after the clip (the sum's low byte
// is the code): the same value as rint on [-127, 127].
#pragma once

#include <cstdint>

namespace dlq {
namespace blk {

// 8 consumer warps x 8 staged output rows of ns + 16 bytes.
__host__ __device__ inline int staging_bytes(int ns) { return 64 * (ns + 16); }
constexpr int LUT_BYTES = 256;   // the skip's requant of each int8 value

// float(acc), the same value as __int2float_rn: with SMALL (|acc| < 2^22:
// every sum of K <= 260 int8 products, 260 x 127^2 < 2^22) the bits of 1.5 x
// 2^23 plus acc are that float plus acc exactly, and subtracting 1.5 x 2^23
// leaves acc, on the full-rate pipes; else the conversion pipe (a quarter
// of the rate). A product takes the first where K <= SMALL_K (exact up to
// 260; 128 measured faster than 260 at K4's layer3 conv3, K 256).
constexpr int SMALL_K = 128;
template <bool SMALL>
__device__ __forceinline__ float i2f(int acc) {
  if constexpr (SMALL) return __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.0f);
  else return __int2float_rn(acc);
}

// clip(rint(fma(acc, s, b) * inv), lo, 127) as an int8 code in the low byte
// (clip first, then round by adding 1.5 x 2^23: the sum's ulp is 1).
template <bool SMALL>
__device__ __forceinline__ uint32_t code(int acc, float s, float b, float inv, float lo) {
  const float q = __fmul_rn(__fmaf_rn(i2f<SMALL>(acc), s, b), inv);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, lo), 127.0f), 12582912.0f));
}

// The codes of one half of a consumer's 64 x NS sums (rows 16 w + gq + 8 h),
// column pairs n0 + 8 j + 2 t, each pair's two codes (bits 0-15) handed to
// put(j, v), eight pairs at a time: their scale and bias loads first, then
// their stores (put stores by st.shared), then a compiler barrier so that
// the next eight pairs' loads are not hoisted (their registers would spill).
template <int NS, bool SMALL, class Put>
__device__ __forceinline__ void codes_t(const int (&acc)[NS / 2], int h, int n0, int t,
                                        const float* s, const float* b, float inv, float lo,
                                        Put&& put) {
  constexpr int CH = NS / 8 < 8 ? NS / 8 : 8;
#pragma unroll
  for (int j0 = 0; j0 < NS / 8; j0 += CH) {
    uint32_t v[CH];
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int j = j0 + jj, n = n0 + 8 * j + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(s + n));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(b + n));
      v[jj] = __byte_perm(code<SMALL>(acc[4 * j + 2 * h], sc.x, bi.x, inv, lo),
                          code<SMALL>(acc[4 * j + 2 * h + 1], sc.y, bi.y, inv, lo), 0x0040);
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) put(j0 + jj, v[jj]);
    asm volatile("" ::: "memory");
  }
}

template <int NS, class Put>
__device__ __forceinline__ void codes(const int (&acc)[NS / 2], int h, int n0, int t,
                                      const float* s, const float* b, float inv, float lo,
                                      bool small, Put&& put) {
  if (small) codes_t<NS, true>(acc, h, n0, t, s, b, inv, lo, put);
  else codes_t<NS, false>(acc, h, n0, t, s, b, inv, lo, put);
}

// A 2-byte store to shared memory (an st.shared the compiler need not order
// against the global loads around it).
__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"((unsigned short)v));
}

// lut[(uint8_t)x] = clip(rint(x rs), -127, 127) for the int8 value x = i - 128
// (i: 0..255, one thread each).
__device__ __forceinline__ void skip_lut(int8_t* lut, int i, float rs) {
  const float r = fminf(fmaxf(__fmul_rn((float)(int8_t)i, rs), -127.0f), 127.0f);
  lut[i] = (int8_t)((int)__float_as_uint(__fadd_rn(r, 12582912.0f)) - 0x4B400000);
}

// Sixteen output bytes: clip(z + r, 0, 127) with r = lut[x] = clip(rint(x *
// rs), -127, 127): a saturating byte add (z + r within [-254, 254] saturates
// to [-128, 127]) and a byte max with 0.
__device__ __forceinline__ uint4 skip_add16(uint4 z, uint4 x, const int8_t* lut) {
  auto r4 = [&](uint32_t xw) {
    return __byte_perm(__byte_perm((uint8_t)lut[xw & 255], (uint8_t)lut[(xw >> 8) & 255], 0x0040),
                       __byte_perm((uint8_t)lut[(xw >> 16) & 255], (uint8_t)lut[xw >> 24], 0x0040),
                       0x5410);
  };
  auto add4 = [&](uint32_t zw, uint32_t xw) { return __vmaxs4(__vaddss4(zw, r4(xw)), 0u); };
  return make_uint4(add4(z.x, x.x), add4(z.y, x.y), add4(z.z, x.z), add4(z.w, x.w));
}

}  // namespace blk
}  // namespace dlq
