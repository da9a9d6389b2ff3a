// Shared building blocks of the port's int8 kernels (K1 conv_int8, K2
// matmul_int8, K3 basic_block, K4 bottleneck_block, K5 vit_pre_w8, K7
// vit_post_w8, and with int4 weights K8 vit_pre_w4a8, K9 vit_post_w4a8, K10
// matmul_int4a8): a block-tile int8 GEMM on the tensor cores
// with mma.sync.m16n8k32 (s8 x s8 -> s32), fed through shared memory by a
// two-stage cp.async pipeline, and the fp32 epilogue the reference uses.
//
// What bounds these kernels on an H100: the card's ridge is ~590 int8
// operations per byte (1979 TOP/s over 3.35 TB/s). ResNet's 3x3 convs sit
// near it (56^2 x 64) or far above it (7^2 x 512: bound by operations); the
// 1x1/s2 downsamples and the fc are far below it (bound by bytes). So the
// design keeps every operand byte read once from device memory per block
// tile and does all int8 math on the tensor cores.
// This first version is simple on purpose: mma.sync (not wgmma), cp.async
// (not TMA), two stages, 256 threads; shared-memory rows are padded to 80
// bytes so the 32-bit fragment reads of a warp hit 32 distinct banks.
//
// Tiles: BM x BN outputs per block, K in steps of BK = 64 bytes (two
// m16n8k32 steps). A rows are output pixels (implicit GEMM: the loader
// gathers them from the NHWC input, zero-filling padding); B rows are
// output channels of a K-major [N, Kp] weight, Kp a multiple of 64.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dlq {

constexpr int BK = 64;           // K bytes per pipeline stage
constexpr int LDS = BK + 16;     // padded shared-memory row stride (bytes)
constexpr int THREADS = 256;     // 8 warps per block

// int4 weights (W4A8: K8, K9, K10) are halves-packed and K-major: row n of
// a [N, Kp/2] byte matrix, byte k holding W[k][n] in its low nibble and
// W[k + Kp/2][n] in its high nibble. A stage streams BK4 = 32 bytes of each
// row (64 K values: 32 of each half, the work of one BK stage of int8), rows
// LDS4 = 48 bytes apart (again 32 distinct banks for a warp's fragment reads).
constexpr int BK4 = 32;
constexpr int LDS4 = BK4 + 16;

// Sign-extend the low nibble of each byte of w to an int8 byte, branch-free:
// (v ^ 8) - 8 per byte (__vsub4 does not borrow across bytes), so 0x8 -> -8.
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// The low nibble of each byte of w sign-extended to the byte: x | (bit 3 of
// x) x 30 per byte (8 x 30 = 0xF0 stays within its byte); four operations
// where nib_lo takes __vsub4's emulation.
__device__ __forceinline__ uint32_t nib_sx(uint32_t w) {
  const uint32_t x = w & 0x0F0F0F0Fu;
  return x | (x & 0x08080808u) * 30u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; zero-fills the destination when !valid
// (src-size 0 reads nothing, so `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The reference's epilogue: y = fma(float(acc), scale, bias) — XLA contracts
// `acc * s + b` into one fused multiply-add — then relu.
__device__ __forceinline__ float epi_fma(int acc, float scale, float bias, bool relu) {
  float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

// The fused epilogues' activation argument (K1, K2, K23): none, relu, or
// relu6, which clips y to [0, 6] before any requant divides (the reference's
// fuse_relu6); an int8 output's clip is then bounded by 0 below, as relu's.
enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

// The epilogue with relu6: clip(fma(float(acc), scale, bias), 0, 6).
__device__ __forceinline__ float epi_fma_relu6(int acc, float scale, float bias) {
  return fminf(fmaxf(__fmaf_rn(__int2float_rn(acc), scale, bias), 0.0f), 6.0f);
}

// The epilogue by activation: relu6, or epi_fma with relu (a compile-time
// R6, so a kernel without relu6 compiles to epi_fma alone).
template <bool R6>
__device__ __forceinline__ float epi_act(int acc, float scale, float bias, bool relu) {
  if constexpr (R6)
    return epi_fma_relu6(acc, scale, bias);
  else
    return epi_fma(acc, scale, bias, relu);
}

// int8 requant: clip(rint(y / s), lo, 127); division (not a reciprocal
// multiply) and round-half-to-even, as the reference computes it.
__device__ __forceinline__ int8_t requant_div(float y, float s, float lo) {
  float q = rintf(__fdiv_rn(y, s));
  return static_cast<int8_t>(fminf(fmaxf(q, lo), 127.0f));
}

// A BM x BN int32 accumulator tile spread over 8 warps (WARPS_M x WARPS_N).
// Fragment layout of m16n8k32 (PTX ISA): lane = 4*g + t; A regs hold rows
// g / g+8, bytes 4t.. and 4t+16..; B regs hold column g, bytes 4t.., 4t+16..;
// C regs hold rows g / g+8, columns 2t, 2t+1.
template <int BM, int BN, int WARPS_M, int WARPS_N>
struct MmaTile {
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static_assert(MI * 16 == WM && NI * 8 == WN, "warp tile");

  int acc[MI][NI][4];
  int warp_m, warp_n, g, t;

  __device__ __forceinline__ MmaTile() {
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
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  }

  // One BK-deep step from shared memory: As [BM][LDS], Bs [BN][LDS].
  __device__ __forceinline__ void step(const int8_t* As, const int8_t* Bs) { step(As, LDS, Bs); }

  // The same with A rows `lda` bytes apart (an A tile resident across the
  // whole K loop; `As` points at this step's K offset).
  __device__ __forceinline__ void step(const int8_t* As, int lda, const int8_t* Bs) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = As + (warp_m * WM + i * 16 + g) * lda + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* q = Bs + (warp_n * WN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(q);
        b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // One stage of an int4 weight (W4A8, see load_b4): Bs [BN][LDS4] holds 32
  // halves-packed bytes per column, i.e. 32 K values of each half. Each
  // 32-bit B word unpacks in registers into the fragment of the low half
  // (A columns at Alo) and of the high half (A columns at Ahi): two
  // m16n8k32 products per word pair, as the reference's two int8 dots.
  __device__ __forceinline__ void step_w4(const int8_t* Alo, const int8_t* Ahi, int lda,
                                          const int8_t* Bs) {
    uint32_t b[NI][2], bh[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int8_t* q = Bs + (warp_n * WN + j * 8 + g) * LDS4 + t * 4;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(q);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(q + 16);
      b[j][0] = nib_lo(w0);
      b[j][1] = nib_lo(w1);
      bh[j][0] = nib_lo(w0 >> 4);
      bh[j][1] = nib_lo(w1 >> 4);
    }
    mma_rows(Alo, lda, b);
    mma_rows(Ahi, lda, bh);
  }

  // acc += A (32 K columns at As, rows lda bytes apart) x the B fragments b.
  __device__ __forceinline__ void mma_rows(const int8_t* As, int lda, const uint32_t (&b)[NI][2]) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int8_t* p = As + (warp_m * WM + i * 16 + g) * lda + t * 4;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(p),
                             *reinterpret_cast<const uint32_t*>(p + 8 * lda),
                             *reinterpret_cast<const uint32_t*>(p + 16),
                             *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16)};
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a, b[j]);
    }
  }

  // Visit every accumulator: f(row_in_tile, col_in_tile, value).
  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = warp_m * WM + i * 16 + g + (r >> 1) * 8;
          const int col = warp_n * WN + j * 8 + t * 2 + (r & 1);
          f(row, col, acc[i][j][r]);
        }
  }
};

// B loader: rows n0..n0+BN-1 of a K-major [N, Kp] int8 weight (rows >= N
// zero-filled), 16-byte chunks, BN*4 chunks per stage.
template <int BN>
__device__ __forceinline__ void load_b(int8_t* Bs, const int8_t* __restrict__ w, int N, int Kp,
                                       int n0, int kt) {
#pragma unroll
  for (int j = 0; j < BN * (BK / 16) / THREADS; ++j) {
    const int chunk = threadIdx.x + j * THREADS;
    const int r = chunk >> 2, q = chunk & 3;
    const int n = n0 + r;
    const bool v = n < N;
    const int8_t* src = v ? w + (size_t)n * Kp + (size_t)kt * BK + q * 16 : w;
    cp_async16(Bs + r * LDS + q * 16, src, v);
  }
}

// A loader of an implicit-GEMM conv over an NHWC int8 input: each of this
// thread's chunks (fixed rows for the whole K loop) knows its row's image
// base pointer and the input coordinate of its top-left tap.
struct ConvGeom {
  int H, W, C, KW, K;  // input H, W, C; kernel width; K = KH*KW*C
};

template <int BM>
struct GatherA {
  static constexpr int CH = BM * (BK / 16) / THREADS;  // chunks per thread
  const int8_t* base[CH];  // image base (nullptr: row outside the GEMM)
  int ih0[CH], iw0[CH];

  __device__ __forceinline__ void set(int j, const int8_t* b, int h0, int w0) {
    base[j] = b;
    ih0[j] = h0;
    iw0[j] = w0;
  }
  __device__ __forceinline__ static int row(int j) { return (threadIdx.x + j * THREADS) >> 2; }
  __device__ __forceinline__ static int quad(int j) { return (threadIdx.x + j * THREADS) & 3; }

  // Vector path, C % 16 == 0: a chunk never straddles two taps.
  __device__ __forceinline__ void load_vec(int8_t* As, const ConvGeom& gm, int kt,
                                           const int8_t* any) const {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int k = kt * BK + quad(j) * 16;
      const int tap = k / gm.C, c = k - tap * gm.C;
      const int kh = tap / gm.KW, kw = tap - kh * gm.KW;
      const int ih = ih0[j] + kh, iw = iw0[j] + kw;
      const bool v = base[j] != nullptr && k < gm.K && ih >= 0 && ih < gm.H && iw >= 0 &&
                     iw < gm.W;
      const int8_t* src = v ? base[j] + ((size_t)ih * gm.W + iw) * gm.C + c : any;
      cp_async16(As + row(j) * LDS + quad(j) * 16, src, v);
    }
  }

  // Byte path for any C (the C=3 stems): synchronous gather.
  __device__ __forceinline__ void load_bytes(int8_t* As, const ConvGeom& gm, int kt) const {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      int8_t* dst = As + row(j) * LDS + quad(j) * 16;
#pragma unroll 4
      for (int b = 0; b < 16; ++b) {
        const int k = kt * BK + quad(j) * 16 + b;
        int8_t v = 0;
        if (base[j] != nullptr && k < gm.K) {
          const int tap = k / gm.C, c = k - tap * gm.C;
          const int kh = tap / gm.KW, kw = tap - kh * gm.KW;
          const int ih = ih0[j] + kh, iw = iw0[j] + kw;
          if (ih >= 0 && ih < gm.H && iw >= 0 && iw < gm.W)
            v = base[j][((size_t)ih * gm.W + iw) * gm.C + c];
        }
        dst[b] = v;
      }
    }
  }
};

// The K loop with A resident in shared memory (As [BM][lda], all of K) and
// only B streamed: rows n0..n0+BN-1 of a K-major [N, K] weight, two stages.
// The caller has written As before the call (the first barrier inside
// orders those writes before any read).
template <class Tile, int BN>
__device__ __forceinline__ void mainloop_resident_a(Tile& tile, const int8_t* As, int lda,
                                                    int8_t* Bs, const int8_t* __restrict__ w,
                                                    int N, int K, int n0) {
  const int KT = K / BK;
  tile.zero();
  load_b<BN>(Bs, w, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_b<BN>(Bs + (s ^ 1) * BN * LDS, w, N, K, n0, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile.step(As + kt * BK, lda, Bs + s * BN * LDS);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// B loader of an int4 weight: stage kt of rows n0..n0+BN-1 of the packed
// [N, Kh] bytes (Kh = Kp/2, a multiple of BK4; rows >= N zero-filled).
template <int BN>
__device__ __forceinline__ void load_b4(int8_t* Bs, const uint8_t* __restrict__ w, int N, int Kh,
                                        int n0, int kt) {
#pragma unroll
  for (int j = 0; j < (BN * 2 + THREADS - 1) / THREADS; ++j) {
    const int chunk = threadIdx.x + j * THREADS;
    if (chunk >= BN * 2) break;
    const int r = chunk >> 1, q = chunk & 1;
    const int n = n0 + r;
    const bool v = n < N;
    const uint8_t* src = v ? w + (size_t)n * Kh + (size_t)kt * BK4 + q * 16 : w;
    cp_async16(Bs + r * LDS4 + q * 16, src, v);
  }
}

// mainloop_resident_a with an int4 weight (K8, K9): stage kt contracts A
// columns [32 kt, 32 kt + 32) against the low nibbles and [K/2 + 32 kt, ...)
// against the high nibbles of the same packed bytes.
template <class Tile, int BN>
__device__ __forceinline__ void mainloop_resident_a_w4(Tile& tile, const int8_t* As, int lda,
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
    tile.step_w4(As + kt * BK4, As + Kh + kt * BK4, lda, Bs + s * BN * LDS4);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The resident-A K loop of either weight format: int8 [N, K] or int4
// halves-packed [N, K/2] bytes.
template <bool W4, class Tile, int BN>
__device__ __forceinline__ void mainloop_resident(Tile& tile, const int8_t* As, int lda,
                                                  int8_t* Bs, const void* w, int N, int K, int n0) {
  if constexpr (W4)
    mainloop_resident_a_w4<Tile, BN>(tile, As, lda, Bs, static_cast<const uint8_t*>(w), N, K, n0);
  else
    mainloop_resident_a<Tile, BN>(tile, As, lda, Bs, static_cast<const int8_t*>(w), N, K, n0);
}

// Bytes of the two B stages of mainloop_resident.
template <bool W4>
constexpr int b_stage_bytes(int BN) { return 2 * BN * (W4 ? LDS4 : LDS); }

// The K loop: two shared-memory stages, tile kt+1 in flight while kt
// computes. `load(stage_A, stage_B, kt)` issues one stage's copies.
template <class Tile, int BM, int BN, class Load>
__device__ __forceinline__ void mainloop(Tile& tile, int8_t* As, int8_t* Bs, int KT, Load&& load) {
  tile.zero();
  load(As, Bs, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load(As + (s ^ 1) * BM * LDS, Bs + (s ^ 1) * BN * LDS, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile.step(As + s * BM * LDS, Bs + s * BN * LDS);
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace dlq
