// K21: the port of tools/probe_block_patterns.py (its run helper's
// pallas_call, :38/:40): the patterns of fused residual-block kernels (the
// four copies on probe_common.cuh's stage_kernel; the plain versions and
// the numpy expectations sit in dlq_tpu_torch/tools/probe_block_patterns.py):
//   0 "A1" pair-row merge int8 [232, 920] -> [116, 1840] (stage_kernel)
//   1 "A2" the same on fp32 (stage_kernel)
//   2 "S"  stride-2 slices x[:, 1:17:2, 1:17:2, :] of [1, 18, 18, 128] int8
//          (stage_kernel: 128-byte pixels at strides of 2 rows, 2 pixels)
//   3 "L"  lane split and half: [232, 928] viewed [232, 116, 8], lanes 4..7
//          of each group (stage_kernel)
//   4 "O"  int8 requant: clip(rint(f32(x) * s), -127, 127), s = f32(0.11)
//          (requant_kernel; the reference's kernel multiplies in fp32, its
//          numpy expectation in float64, one step apart)
//   5 "D"  K3's core on a [1, 12, 20, 128] slab, two [9, 128, 128] weight
//          stacks and fp32 scales s1, s2 (double_conv_kernel):
//            acc1 = 9 taps of x[kh:kh+10, kw:kw+18] @ w1[tap]    (int32)
//            h    = clip(rint(f32(acc1) * s1), 0, 127)           (int8, shared memory)
//            acc2 = 9 taps of h[kh:kh+8, kw:kw+16] @ w2[tap]
//            out  = clip(rint(f32(acc2) * s2) + x[2:10, 2:18], 0, 127)
// Bound: bytes for every pattern (D: 91 MOP of int8, 0.05 us at the int8
// peak, against 342 KB, 0.10 us); at these sizes launch latency.
// stage_kernel is a Hopper form (probe_common.cuh: L reads each 928-byte
// row as aligned 16-byte granules and keeps words 1 and 3 of each);
// dlq_probe_block_first runs its first form for A1, A2, S and L.
//
// D design: one block of 8 warps holds the slab (240 pixels, 144-byte rows)
// and h (180 pixels) in shared memory and runs both convs on
// mma.sync.m16n8k32 (s8). The two weight stacks (2 x 147 KB) do not fit
// beside them, so the weights stream one tap at a time, as K3's do; the
// probe's weights are [tap][cin][cout], and the B fragments want each
// output channel's cin bytes contiguous, so a tap is transposed on its way
// into shared memory with byte-wise stores.
#include "probe_common.cuh"

namespace {

using namespace dlq;
using namespace dlq::probe;

__global__ void __launch_bounds__(256) requant_kernel(const int8_t* __restrict__ x,
                                                      int8_t* __restrict__ out, int n16, float s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n16) return;
  int4 v = reinterpret_cast<const int4*>(x)[i];
  int8_t* e = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    e[k] = static_cast<int8_t>(
        fminf(fmaxf(rintf(__fmul_rn(static_cast<float>(e[k]), s)), -127.0f), 127.0f));
  reinterpret_cast<int4*>(out)[i] = v;
}

constexpr int TOH = 8, OW = 16, C = 128;
constexpr int SH = TOH + 4, SW = OW + 4;      // the slab: 12 x 20 pixels
constexpr int H1 = TOH + 2, W1 = OW + 2;      // h: 10 x 18 pixels
constexpr int M1 = H1 * W1;                   // conv1 rows: 180
constexpr int LDP = C + 16;                   // bytes per pixel row in shared memory
constexpr int kDoubleConvSmem = (SH * SW + M1 + C) * LDP;

// Tap `tap` of a [9][cin][cout] int8 stack into Bs[cout][cin] (rows LDP apart).
__device__ __forceinline__ void load_tap_t(int8_t* Bs, const int8_t* __restrict__ w, int tap) {
  const int8_t* wt = w + tap * C * C;
  for (int c = threadIdx.x; c < C * C / 16; c += 256) {
    const int k = c >> 3, n0 = (c & 7) * 16;
    const int4 v = *reinterpret_cast<const int4*>(wt + k * C + n0);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[(n0 + j) * LDP + k] = e[j];
  }
}

// acc[MI][NI] += sum over the 9 taps of A(tap) x w[tap]: A rows (this warp's
// MI x 16 of them) are pixels of `src` (rows LDP apart) at pix(row, tap);
// the warp's NI x 8 output channels start at n0.
template <int MI, int NI, class Pix>
__device__ __forceinline__ void conv9(int (&acc)[MI][NI][4], const int8_t* src, int8_t* Bs,
                                      const int8_t* __restrict__ w, int m0, int n0, Pix&& pix) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();   // the previous tap's B reads are done
    load_tap_t(Bs, w, tap);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C; kk += 32) {
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* q = Bs + (n0 + j * 8 + g) * LDP + kk + 4 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(q);
        b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p0 = src + pix(m0 + i * 16 + g, tap) * LDP + kk + 4 * t;
        const int8_t* p1 = src + pix(m0 + i * 16 + g + 8, tap) * LDP + kk + 4 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(p0),
                               *reinterpret_cast<const uint32_t*>(p1),
                               *reinterpret_cast<const uint32_t*>(p0 + 16),
                               *reinterpret_cast<const uint32_t*>(p1 + 16)};
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a, b[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(256) double_conv_kernel(const int8_t* __restrict__ slab,
                                                          const int8_t* __restrict__ w1,
                                                          const int8_t* __restrict__ w2,
                                                          int8_t* __restrict__ out, float s1,
                                                          float s2) {
  int8_t* Xs = reinterpret_cast<int8_t*>(probe_smem);   // [SH*SW][LDP]
  int8_t* Hs = Xs + SH * SW * LDP;                       // [M1][LDP]
  int8_t* Bs = Hs + M1 * LDP;                            // [C][LDP]
  for (int c = threadIdx.x; c < SH * SW * (C / 16); c += 256) {
    const int p = c >> 3, q = (c & 7) * 16;
    cp_async16(Xs + p * LDP + q, slab + p * C + q, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  {  // conv1 over the 10 x 18 h pixels (rows padded to 192): 4 x 2 warps of 48 x 64
    const int wm = warp >> 1, wn = warp & 1;
    int acc[3][8][4] = {};
    conv9(acc, Xs, Bs, w1, wm * 48, wn * 64, [](int r, int tap) {
      r = min(r, M1 - 1);   // pad rows repeat the last one; their sums are dropped
      return (r / W1 + tap / 3) * SW + r % W1 + tap % 3;
    });
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm * 48 + i * 16 + g + (r >> 1) * 8;
          const int col = wn * 64 + j * 8 + 2 * t + (r & 1);
          if (row < M1)
            Hs[row * LDP + col] = static_cast<int8_t>(fminf(
                fmaxf(rintf(__fmul_rn(__int2float_rn(acc[i][j][r]), s1)), 0.0f), 127.0f));
        }
  }
  {  // conv2 over the 8 x 16 outputs from h: 2 x 4 warps of 64 x 32
    const int wm = warp >> 2, wn = warp & 3;
    int acc[4][4][4] = {};
    conv9(acc, Hs, Bs, w2, wm * 64, wn * 32, [](int r, int tap) {
      return (r / OW + tap / 3) * W1 + r % OW + tap % 3;
    });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm * 64 + i * 16 + g + (r >> 1) * 8;
          const int col = wn * 32 + j * 8 + 2 * t + (r & 1);
          const int oi = row / OW, oj = row % OW;
          const float res = static_cast<float>(Xs[((oi + 2) * SW + oj + 2) * LDP + col]);
          const float y = rintf(__fmul_rn(__int2float_rn(acc[i][j][r]), s2)) + res;
          out[row * C + col] = static_cast<int8_t>(fminf(fmaxf(y, 0.0f), 127.0f));
        }
  }
}

constexpr Staged kStaged[] = {
    {0, Op::kCopy, {0, 1840, 0, 116, 1, 1840}},
    {1, Op::kCopy, {0, 7360, 0, 116, 1, 7360}},
    // pixel (1 + 2i, 1 + 2j) of the 18 x 18 slab, 128 bytes each
    {2, Op::kCopy, {19 * 128, 2 * 18 * 128, 2 * 128, 8, 8, 128}},
    // bytes 4..7 of each 8-byte group of a 928-byte row
    {3, Op::kCopy, {4, 928, 8, 232, 116, 4}},
};

}  // namespace

extern "C" int dlq_probe_block_prepare() {
  cudaError_t e;
  if ((e = prepare_stage()) != cudaSuccess) return (int)e;
  if ((e = prepare(requant_kernel)) != cudaSuccess) return (int)e;
  return (int)prepare(double_conv_kernel, kDoubleConvSmem);
}

// a, b, c: the pattern's inputs (contiguous, the shapes above); out: its
// output; s1: O's scale or D's first, s2: D's second.
extern "C" int dlq_probe_block(int pattern, const void* a, const void* b, const void* c,
                               void* out, float s1, float s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 4: {
      const int n16 = 256 * 1024 / 16;
      requant_kernel<<<(n16 + 255) / 256, 256, 0, st>>>(static_cast<const int8_t*>(a),
                                                         static_cast<int8_t*>(out), n16, s1);
      return (int)cudaGetLastError();
    }
    case 5:
      double_conv_kernel<<<1, 256, kDoubleConvSmem, st>>>(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
          static_cast<const int8_t*>(c), static_cast<int8_t*>(out), s1, s2);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first form of A1, A2, S and L (stage_first_kernel), arguments as
// dlq_probe_block's; other patterns have one form and return
// cudaErrorInvalidValue.
extern "C" int dlq_probe_block_first(int pattern, const void* a, const void*, const void*,
                                     void* out, float, float, void* stream) {
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

DLQ_PROBE_STAGE_ENTRIES(probe_block, kStaged)
