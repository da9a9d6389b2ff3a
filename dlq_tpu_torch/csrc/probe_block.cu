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
//          or the caller's (requant_kernel, below: a thread per 8 bytes on
//          every SM, the bytes in registers; first form requant_first_kernel;
//          the reference's kernel multiplies in fp32, its numpy expectation
//          in float64, one step apart)
//   5 "D"  K3's core on a [1, 12, 20, 128] slab, two [9, 128, 128] weight
//          stacks ([tap][cin][cout]) and fp32 scales s1, s2
//          (double_conv_cluster_kernel, below; first form double_conv_kernel):
//            acc1 = 9 taps of x[kh:kh+10, kw:kw+18] @ w1[tap]    (int32)
//            h    = clip(rint(f32(acc1) * s1), 0, 127)           (int8, shared memory)
//            acc2 = 9 taps of h[kh:kh+8, kw:kw+16] @ w2[tap]
//            out  = clip(rint(f32(acc2) * s2) + x[2:10, 2:18], 0, 127)
// Bound: bytes for every pattern (D: 91 MOP of int8, 0.05 us at the int8
// peak, against 342 KB, 0.10 us); at these sizes launch latency.
// stage_kernel is a Hopper form (probe_common.cuh: L reads each 928-byte
// row as aligned 16-byte granules and keeps words 1 and 3 of each), and so
// are O's and D's kernels; dlq_probe_block_first runs the first forms of
// all six patterns.
#include "probe_common.cuh"

namespace {

using namespace dlq;
using namespace dlq::probe;

// requant_first_kernel, O's first form: 64 blocks of 256 threads, a thread
// per 16 bytes through a byte view of a local int4 (kept in registers:
// ptxas reports no stack frame).
__global__ void __launch_bounds__(256) requant_first_kernel(const int8_t* __restrict__ x,
                                                            int8_t* __restrict__ out, int n16,
                                                            float s) {
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

// requant_kernel, O's Hopper form. Bound: bytes, 256 KB in + 256 KB out,
// 0.157 us at 3.35 TB/s; at this size the launch and one round trip. The
// first form (requant_first_kernel, 2.75 us, PERF.md) left 68 of the 132
// SMs idle (64 blocks of 256) with 16 bytes a thread, each byte three
// conversion instructions (I2F, FRND, F2I in its SASS) that run at a
// fraction of the fp32 rate. Here:
//  - every SM works: kOGrid blocks (128: one an SM) of kOThreads threads
//    (256), a thread per kOBytes bytes (8: one read-only uint2 load and one
//    store), so each SM's conversions are spread over 8 warps; of the
//    shapes timed (PERF.md) 32-thread blocks ran no faster than the first
//    form, and a 256-entry table of the results a block, built in shared
//    memory while its loads fly, helped at 16 bytes a thread but not at
//    this shape;
//  - the bytes stay in registers, taken apart and packed back by
//    __byte_perm;
//  - each byte's arithmetic is the first form's (the fp32 product
//    __fmul_rn, rintf half to even, the clip in fp32), so the two are equal
//    for any s.
constexpr int kOThreads = 256;
constexpr int kOBytes = 8;   // one uint2 a thread
constexpr int kOGrid = 256 * 1024 / (kOThreads * kOBytes);
static_assert(kOGrid * kOThreads * kOBytes == 256 * 1024, "O: the grid covers the output");

// the four bytes of w requantized, in place
__device__ __forceinline__ uint32_t requant4(uint32_t w, float s) {
  uint32_t r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float q = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
    r[k] = static_cast<uint32_t>(
        static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(q, s)), -127.0f), 127.0f)));
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

__global__ void __launch_bounds__(kOThreads) requant_kernel(const int8_t* __restrict__ x,
                                                            int8_t* __restrict__ out, float s) {
  const int i = blockIdx.x * kOThreads + threadIdx.x;
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(x) + i);
  reinterpret_cast<uint2*>(out)[i] = make_uint2(requant4(v.x, s), requant4(v.y, s));
}

// D's first form: one block of 8 warps holds the slab (240 pixels, 144-byte
// rows) and h (180 pixels) in shared memory and runs both convs on
// mma.sync.m16n8k32 (s8). The two weight stacks (2 x 147 KB) do not fit
// beside them, so the weights stream one tap at a time, as K3's do; the
// probe's weights are [tap][cin][cout], and the B fragments want each
// output channel's cin bytes contiguous, so a tap is transposed on its way
// into shared memory with byte-wise stores.
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

// double_conv_cluster_kernel, the Hopper form of D. Bound: bytes, 342 KB
// (the slab 30 KB, the weights 2 x 147 KB, out 16 KB), 0.102 us at 3.35 TB/s;
// its 91 MOP of int8 products take 0.046 us at 1,979 TOP/s. The first form
// (71.06 us, PERF.md) ran on one SM of 132: 18 taps in series, each behind
// two block barriers, each tap's 16 KB of weight fetched only when needed
// and transposed into shared memory by byte stores that 8 threads aimed at
// one bank. This form is a cluster of 8 blocks (the portable cluster size)
// of 8 warps; rank r owns output channels 16r..16r+15 of both convs:
//  - at the start thread 0 issues all of the rank's loads by TMA: the slab
//    (8 boxes of 32 pixels x 128 channels, 128-byte swizzle; pixels 240..255
//    land zeros) and the rank's 16-channel slices of w1 and w2 (a box of 128
//    cin rows x 16 bytes a tap, 18 KB a conv), each on its own mbarrier;
//    no tap waits on a load;
//  - each slice is transposed to [tap][cout][cin] (the s8 B fragments want
//    a channel's cin bytes contiguous; int8 wgmma has no transposed B
//    either) in 4 x 4-byte blocks with __byte_perm and 32-bit shared
//    stores, a warp's 32 stores on 32 banks: w1's by all warps before
//    conv1, w2's by warps 4-7 while warps 0-3 run conv1;
//  - conv1 on warps 0-3: h's 16 channels of the rank for all 180 pixels
//    (rows padded to 192), a warp 3 m16 tiles x both n8 tiles (216
//    mma.sync m16n8k32, 864 a rank), so each A fragment is read from
//    shared memory once for both tiles; each k32 step's fragments are
//    loaded two steps ahead (conv_steps); the epilogue writes the rank's
//    slice of h into its own shared memory;
//  - exchange: h lies in shared memory as 8 slices [rank][pixel][16
//    channels], each rank's 2,880 contiguous bytes; thread 0 copies the
//    rank's slice into the other 7 ranks' h by 7 bulk copies, each counted
//    on the receiving rank's h mbarrier (7 x 2,880 bytes expected);
//  - conv2 on warps 0-3: out's 16 channels of the rank for all 128 pixels
//    from the whole h (a warp 2 output rows x both n8 tiles, 576 mma.sync a
//    rank), pipelined as conv1, the skip from the rank's own slab; the int8
//    tile leaves through shared memory in 16-byte pieces;
//  - cluster barriers: one after the mbarriers' initialization (a rank's
//    bulk copies wait for it), one before exit (a rank leaves once every
//    rank has received every slice, so no copy still reads its memory).
// int32 sums are exact in any order, and the epilogues are the first
// form's (rintf(__fmul_rn(__int2float_rn(acc), s)), the same clips), so
// every output equals the first form's and double_conv_plain's. What
// bounds it: each rank's loads (66 KB into one SM), its two convs (each
// slower than its 1,440 mma.sync and 1,008 ldmatrix.x4 a rank take alone
// at the card's rates; more warps, deeper load pipelining and a rolled
// loop left them as they are), the exchange, and the launch.
constexpr int kRanks = 8;                   // blocks of the cluster
constexpr int CS = C / kRanks;              // channels a rank: 16
constexpr int LDB = C + 16;                 // bytes a transposed weight row (cout): 144
constexpr int kTapB = CS * LDB;             // a rank's transposed tap: 2,304 bytes
constexpr int kTapW = C * CS;               // a rank's tap as landed, [cin][16]: 2,048 bytes
constexpr int kHSlice = M1 * CS;            // a rank's slice of h: 2,880 bytes
constexpr int kXBox = 32;                   // slab pixels a box
constexpr int kXBoxes = (SH * SW + kXBox - 1) / kXBox;   // 8 (pixels 240..255 zero)
constexpr int kSteps = 9 * (C / 32);        // k32 steps of a conv: 9 taps x 4
constexpr int kDepth = 3;                   // fragment buffers: loads 2 steps ahead
namespace dc {   // the shared-memory layout, from a 1,024-byte aligned base
constexpr int X = 0;                                  // slab [256 pixels][128], swizzled
constexpr int W = X + kXBoxes * kXBox * C;            // slices [conv][tap][cin][16]
constexpr int BT = W + 2 * 9 * kTapW;                 // transposed [conv][tap][cout][LDB]
constexpr int H = BT + 2 * 9 * kTapB;                 // h [rank][M1][CS]
constexpr int O = H + kRanks * kHSlice;               // out tile [TOH * OW][CS]
constexpr int BAR = O + TOH * OW * CS;                // mbarriers: slab, w1, w2, h
constexpr int SINK = BAR + 4 * 8;                     // a word a warp (conv_steps)
constexpr int SMEM = 1024 + SINK + 8 * 4;
}  // namespace dc

// A conv's slice from Ws ([tap][cin][16 couts]) into Bt ([tap][cout][cin],
// rows LDB apart) by `threads` threads, this one the i-th: item c = (tap, 4
// cin rows 4kb..4kb+3), a warp's 32 items one tap's 32 row blocks.
__device__ __forceinline__ void transpose_slice(const unsigned char* Ws, unsigned char* Bt, int i,
                                                int threads) {
  for (int c = i; c < 9 * (C / 4); c += threads) {
    const int tap = c >> 5, kb = c & 31;
    const uint4* src = reinterpret_cast<const uint4*>(Ws + tap * kTapW + 4 * kb * CS);
    const uint4 rows[4] = {src[0], src[1], src[2], src[3]};
    unsigned char* dst = Bt + tap * kTapB + 4 * kb;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {   // couts 4nb..4nb+3
      uint32_t w[4] = {word(rows[0], nb), word(rows[1], nb), word(rows[2], nb), word(rows[3], nb)};
      transpose4x4(w);
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(dst + (4 * nb + j) * LDB) = w[j];
    }
  }
}

// A conv's kSteps k32 steps for one warp: MI m16 tiles x both n8 tiles of
// products a step, `load(s, b, a)` step s's fragments (B of both n8 tiles,
// A of the MI tiles) by ldmatrix, loaded two steps ahead into kDepth
// buffers. ptxas moves each ldmatrix down to its first product (across
// bar.sync too), so every product would wait a load's latency: a step's
// loads are made to land together before the next step's products by a
// store of their XOR to the warp's word at `sink`, which no later load may
// pass.
template <int MI, class Load>
__device__ __forceinline__ void conv_steps(int (&acc)[MI][2][4], Load&& load, uint32_t sink) {
  const auto landed = [sink](const uint32_t (&b)[4], const uint32_t (&a)[MI][4]) {
    uint32_t x = b[0];
#pragma unroll
    for (int i = 0; i < MI; ++i) x ^= a[i][0];
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sink), "r"(x) : "memory");
  };
  uint32_t b[kDepth][4], a[kDepth][MI][4];
#pragma unroll
  for (int s = 0; s < kDepth - 1; ++s) load(s, b[s], a[s]);
  landed(b[0], a[0]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int q = s % kDepth, ahead = s + kDepth - 1;
    if (ahead < kSteps) load(ahead, b[ahead % kDepth], a[ahead % kDepth]);
    const uint32_t b0[2] = {b[q][0], b[q][1]};
    const uint32_t b1[2] = {b[q][2], b[q][3]};
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      mma_s8(acc[i][0], a[q][i], b0);
      mma_s8(acc[i][1], a[q][i], b1);
    }
    if (s + 1 < kSteps) landed(b[(s + 1) % kDepth], a[(s + 1) % kDepth]);
  }
}

__device__ __forceinline__ int8_t h_code(int acc, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(__int2float_rn(acc), s)), 0.0f), 127.0f));
}

__global__ void __launch_bounds__(256) double_conv_cluster_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
    const __grid_constant__ CUtensorMap tw2, int8_t* __restrict__ out, float s1, float s2) {
  unsigned char* base = probe_smem + ((1024 - (smem_u32(probe_smem) & 1023)) & 1023);
  unsigned char* Xs = base + dc::X;
  unsigned char* Ws = base + dc::W;
  unsigned char* Bt = base + dc::BT;
  unsigned char* Hs = base + dc::H;
  unsigned char* Os = base + dc::O;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + dc::BAR);   // slab, w1, w2, h
  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  if (tid == 0) {
    const CUtensorMap* maps[3] = {&tx, &tw1, &tw2};
    for (const CUtensorMap* m : maps) prefetch_map(m);
    for (int b = 0; b < 4; ++b) sm90::mbar_init(bar + b, 1);
    sm90::mbar_init_fence();
    sm90::expect_tx(bar, kXBoxes * kXBox * C);
    for (int b = 0; b < kXBoxes; ++b) tma_load2(Xs + b * kXBox * C, &tx, 0, b * kXBox, bar);
    for (int conv = 0; conv < 2; ++conv) {
      sm90::expect_tx(bar + 1 + conv, 9 * kTapW);
      for (int tap = 0; tap < 9; ++tap)
        tma_load2(Ws + (conv * 9 + tap) * kTapW, conv ? &tw2 : &tw1, CS * rank, tap * C,
                  bar + 1 + conv);
    }
    sm90::expect_tx(bar + 3, (kRanks - 1) * kHSlice);   // the other ranks' h slices
  }
  cluster_arrive_relaxed();   // the mbarriers are initialized (after the fence above)
  __syncthreads();

  sm90::mbar_wait(bar + 1, 0);
  transpose_slice(Ws, Bt, tid, 256);
  sm90::mbar_wait(bar, 0);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3, hi = lane >> 4;
  // fragments by ldmatrix: A rows this lane addresses (lane & 15), at k half
  // hi; B (x4) rows n = (lane & 7) + 8 hi of both n8 tiles at k half
  // (lane >> 3) & 1
  const int bn = ((lane & 7) + 8 * hi) * LDB + 16 * ((lane >> 3) & 1);
  const uint32_t sink = smem_u32(base + dc::SINK + 4 * warp);
  if (warp < 4) {  // conv1: warp w, m16 tiles 3w..3w+2 (rows 48w..), both n8 tiles
    int pix[3];   // the slab pixel of this lane's A row at tap 0 (pad rows repeat the last)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int r = min((3 * warp + i) * 16 + (lane & 15), M1 - 1);
      pix[i] = (r / W1) * SW + r % W1;
    }
    // k32 step s = 4 tap + ks: B of both n8 tiles, A of the 3 tiles
    const auto load = [&](int s, uint32_t (&b)[4], uint32_t (&a)[3][4]) {
      const int tap = s >> 2, ks = s & 3;
      ldsm_x4(b, Bt + tap * kTapB + bn + 32 * ks);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int p = pix[i] + (tap / 3) * SW + tap % 3;
        ldsm_x4(a[i], Xs + p * C + (((2 * ks) ^ hi ^ (p & 7)) << 4));
      }
    };
    int acc[3][2][4] = {};   // [m16 tile][n8 tile]
    conv_steps(acc, load, sink);
    unsigned char* hs = Hs + rank * kHSlice;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = (3 * warp + i) * 16 + g + hh * 8;
          if (row < M1)
            *reinterpret_cast<uint16_t*>(hs + row * CS + j * 8 + 2 * t) = (uint16_t)(
                (uint8_t)h_code(acc[i][j][2 * hh], s1) |
                (uint8_t)h_code(acc[i][j][2 * hh + 1], s1) << 8);
        }
  } else {  // warps 4..7: w2's slice, while conv1 runs
    sm90::mbar_wait(bar + 2, 0);
    transpose_slice(Ws + 9 * kTapW, Bt + 9 * kTapB, tid - 128, 128);
  }
  sm90::fence_proxy_async();   // the slice's writes, before the bulk copies read it
  __syncthreads();
  cluster_wait();              // every rank's mbarriers are initialized
  if (tid == 0)
    for (unsigned d = 1; d < kRanks; ++d)
      bulk_to_rank(Hs + rank * kHSlice, kHSlice, bar + 3, (rank + d) % kRanks);
  sm90::mbar_wait(bar + 3, 0);   // every other rank's slice of h has landed
  cluster_arrive_relaxed();      // so every copy into this rank is done

  if (warp < 4) {  // conv2: warp w, output rows 2w, 2w + 1 (m16 tiles of 16 pixels), both n8 tiles
    const unsigned char* hb = Hs + hi * kHSlice + (2 * warp * W1 + (lane & 15)) * CS;
    const auto load = [&](int s, uint32_t (&b)[4], uint32_t (&a)[2][4]) {
      const int tap = s >> 2, ks = s & 3;   // channels 32ks..: slices 2ks, 2ks + 1
      const int toff = ((tap / 3) * W1 + tap % 3) * CS;
      ldsm_x4(b, Bt + (9 + tap) * kTapB + bn + 32 * ks);
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(a[i], hb + 2 * ks * kHSlice + toff + i * W1 * CS);
    };
    int acc[2][2][4] = {};   // [m16 tile][n8 tile]
    conv_steps(acc, load, sink);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int oi = 2 * warp + i, oj = g + hh * 8, col = j * 8 + 2 * t;
          const int ch = CS * rank + col, p = (oi + 2) * SW + oj + 2;   // the skip's pixel
          const int8_t* res = reinterpret_cast<const int8_t*>(
              Xs + p * C + ((((ch >> 4) ^ (p & 7)) << 4) | (ch & 15)));
          const auto q = [&](int v, int8_t x) {
            const float y = rintf(__fmul_rn(__int2float_rn(v), s2)) + static_cast<float>(x);
            return (uint32_t)(uint8_t)static_cast<int8_t>(fminf(fmaxf(y, 0.0f), 127.0f));
          };
          *reinterpret_cast<uint16_t*>(Os + (oi * OW + oj) * CS + col) =
              (uint16_t)(q(acc[i][j][2 * hh], res[0]) | q(acc[i][j][2 * hh + 1], res[1]) << 8);
        }
  }
  __syncthreads();
  if (tid < TOH * OW)
    *reinterpret_cast<uint4*>(out + tid * C + CS * rank) =
        *reinterpret_cast<const uint4*>(Os + tid * CS);
  cluster_wait();   // every rank has its h: no bulk copy still reads this rank's slice
}

// D on the Hopper form: the slab [240 pixels][128], the stacks [9 * 128][128]
// (16-byte aligned).
inline cudaError_t double_conv_cluster(const int8_t* slab, const int8_t* w1, const int8_t* w2,
                                       int8_t* out, float s1, float s2, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(slab) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2)) % 16)
    return cudaErrorInvalidValue;
  const w4::EncodeTiled encode = w4::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row[1] = {C};   // bytes between rows
  const cuuint32_t step[2] = {1, 1};
  const cuuint64_t xdims[2] = {C, SH * SW}, wdims[2] = {C, 9 * C};
  const cuuint32_t xbox[2] = {C, kXBox}, wbox[2] = {CS, C};
  CUtensorMap tx, tw1, tw2;
  const auto map = [&](CUtensorMap* m, const int8_t* p, const cuuint64_t* dims,
                       const cuuint32_t* box, CUtensorMapSwizzle sw) {
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims, row, box,
                  step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!map(&tx, slab, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map(&tw1, w1, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !map(&tw2, w2, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return launch_cluster(double_conv_cluster_kernel, kRanks, 256, dc::SMEM, kRanks, st, tx, tw1,
                        tw2, out, s1, s2);
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
  if ((e = prepare(requant_first_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(requant_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare_cluster(double_conv_cluster_kernel, 256, dc::SMEM, kRanks)) != cudaSuccess)
    return (int)e;
  return (int)prepare(double_conv_kernel, kDoubleConvSmem);
}

// a, b, c: the pattern's inputs (contiguous, the shapes above); out: its
// output; s1: O's scale or D's first, s2: D's second.
extern "C" int dlq_probe_block(int pattern, const void* a, const void* b, const void* c,
                               void* out, float s1, float s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 4:
      requant_kernel<<<kOGrid, kOThreads, 0, st>>>(static_cast<const int8_t*>(a),
                                                    static_cast<int8_t*>(out), s1);
      return (int)cudaGetLastError();
    case 5:
      return (int)double_conv_cluster(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                      static_cast<const int8_t*>(c), static_cast<int8_t*>(out), s1,
                                      s2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of A1, A2, S, L (stage_first_kernel), O
// (requant_first_kernel) and D (double_conv_kernel), arguments as
// dlq_probe_block's.
extern "C" int dlq_probe_block_first(int pattern, const void* a, const void* b, const void* c,
                                     void* out, float s1, float s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, st);
  if (pattern == 4) {
    const int n16 = 256 * 1024 / 16;
    requant_first_kernel<<<(n16 + 255) / 256, 256, 0, st>>>(static_cast<const int8_t*>(a),
                                                             static_cast<int8_t*>(out), n16, s1);
    return (int)cudaGetLastError();
  }
  if (pattern != 5) return (int)cudaErrorInvalidValue;
  double_conv_kernel<<<1, 256, kDoubleConvSmem, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const int8_t*>(c),
      static_cast<int8_t*>(out), s1, s2);
  return (int)cudaGetLastError();
}

// D's Hopper form's launch into v[0..3]: cluster ranks (= blocks), threads,
// dynamic shared memory and channels a rank (the card tests hold it to
// dlq_tpu_torch/tools/probe_block_patterns.py: D_RANKS, D_THREADS, D_SMEM,
// D_CS).
extern "C" int dlq_probe_block_d_plan(int* v) {
  const int t[4] = {kRanks, 256, dc::SMEM, CS};
  for (int k = 0; k < 4; ++k) v[k] = t[k];
  return 0;
}

// O's Hopper form's launch into v[0..2]: grid, threads, bytes a thread (the
// card tests hold it to probe_block_patterns.py: o_launch).
extern "C" int dlq_probe_block_o_plan(int* v) {
  const int t[3] = {kOGrid, kOThreads, kOBytes};
  for (int k = 0; k < 3; ++k) v[k] = t[k];
  return 0;
}

DLQ_PROBE_STAGE_ENTRIES(probe_block, kStaged)
