// K22: the port of tools/probe_stem_patterns.py (its run helper's
// pallas_call, :36/:38): the patterns of a fused int8 ResNet stem (the four
// copies on probe_common.cuh's stage_kernel; the plain versions and the
// numpy expectations sit in dlq_tpu_torch/tools/probe_stem_patterns.py).
// x is int8 [232, 920];
// merge(x) its [116, 1840] view (row pairs side by side).
//   0 "A"  pair-row merge [232, 920] -> [116, 1840] (stage_kernel)
//   1 "B"  x[:112, :896] -> [12544, 8] (stage_kernel, 8-byte granules:
//          920-byte rows are 8-aligned only)
//   2 "C"  merge(x)[3:115, 928:1824] -> [112, 896] (stage_kernel)
//   3 "D"  x[:128, :128] through shared memory in 16 pieces of 8 lanes per
//          row (stage_kernel, 8-byte granules)
//   4 "E"  int8 dot [12544, 256] x [256, 64] -> int32
//          (int_dot_hopper_kernel, below: a block per 64 rows, 196 blocks,
//          the rows by TMA, b transposed once a block, int8 wgmma; first
//          form int_dot_kernel)
//   5 "J"  the im2col cols build: piece t = (r, a, b), 32 of them, is
//          merge(x)[a:a+112, 920r + 8b : +896] viewed [12544, 8], written to
//          lanes 8t..8t+7 of cols [12544, 256] (cols_kernel, below: no
//          staging, a thread per 16-byte output granule from two 8-byte
//          loads; first form cols_first_kernel)
//   6 "K"  3x3/s2 max pool of [112, 112, 64] int8 with -128 padding ->
//          [56, 3584] (maxpool_kernel, below: no staging, a thread per 16
//          channels of one output pixel, its 9 taps as 16-byte loads; first
//          form maxpool_first_kernel)
// Bound: bytes everywhere (E: 0.41 GOP of int8 against 6.4 MB, 1.9 us at
// 3.35 TB/s); at these sizes launch latency. Every pattern runs on a Hopper
// form: stage_kernel (probe_common.cuh) for A-D, int_dot_hopper_kernel,
// cols_kernel and maxpool_kernel; dlq_probe_stem_first runs their first
// forms (stage_first_kernel for A-D, int_dot_kernel, cols_first_kernel,
// maxpool_first_kernel).
#include "probe_common.cuh"

namespace {

using namespace dlq;
using namespace dlq::probe;

constexpr int EM = 12544, EK = 256, EN = 64, EBM = 128;

// int_dot_kernel, the first form: a block per 128 rows (98 blocks) on
// igemm.cuh's MmaTile (mma.sync m16n8k32) and two-stage cp.async mainloop;
// the [K, N] b is transposed stage by stage into K-major shared rows by
// byte stores, and the int32 sums are stored from the fragments.
__global__ void __launch_bounds__(THREADS) int_dot_kernel(const int8_t* __restrict__ a,
                                                          const int8_t* __restrict__ b,
                                                          int* __restrict__ out) {
  __shared__ __align__(16) int8_t As[2 * EBM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * EN * LDS];
  const int m0 = blockIdx.x * EBM;
  MmaTile<EBM, EN, 4, 2> tile;
  mainloop<decltype(tile), EBM, EN>(tile, As, Bs, EK / BK, [&](int8_t* as, int8_t* bs,
                                                                    int kt) {
#pragma unroll
    for (int j = 0; j < EBM * (BK / 16) / THREADS; ++j) {
      const int chunk = threadIdx.x + j * THREADS;
      const int r = chunk >> 2, q = (chunk & 3) * 16;
      cp_async16(as + r * LDS + q, a + (long long)(m0 + r) * EK + kt * BK + q, true);
    }
    // rows kt*BK .. +63 of b [K][N]: each thread moves 16 output channels of one K row
    const int k = threadIdx.x >> 2, n0 = (threadIdx.x & 3) * 16;
    const int4 v = *reinterpret_cast<const int4*>(b + (kt * BK + k) * EN + n0);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) bs[(n0 + j) * LDS + k] = e[j];
  });
  tile.for_each([&](int row, int col, int v) { out[(long long)(m0 + row) * EN + col] = v; });
}

// int_dot_hopper_kernel, the Hopper form. Bound: bytes, a 3.21 MB + b 16 KB
// + out 3.21 MB = 6.44 MB, 1.922 us at 3.35 TB/s (its 0.41 GOP take 0.21 us
// at 1,979 TOP/s). The first form (int_dot_kernel, 8.65 us against
// torch._int_mm's 13.05, PERF.md) ran 98 blocks on 132 SMs with at most two
// of a block's four 64-byte K stages of a in flight, transposed b's 16 KB
// again at every stage by byte stores in every block, and wrote the int32
// output, half of its bytes, by 4-byte stores in fragment order. This form:
//  - gives each block 64 rows (196 blocks of one warpgroup and 33 KB of
//    shared memory: every SM pulls from memory, 64 of them for two blocks);
//  - issues the block's whole a tile at its start: two TMA boxes (64 rows x
//    128 bytes of K, 128-byte swizzle) on one mbarrier;
//  - transposes b once a block while a lands: each thread reads two pieces
//    of 4 K rows x 16 bytes straight from global memory (16-byte loads; L2
//    serves every block after the first), transposes each 4 x 4 byte block
//    by __byte_perm (transpose4x4) and stores the K-major words ([K half]
//    [64 n][128 k bytes], the 128-byte swizzle wgmma's descriptors read) by
//    32-bit stores, a warp's 32 on 32 banks (its lanes 32 consecutive K
//    quads of one n); staged from a dense shared copy instead, the 4 rows a
//    word needs would sit on one bank;
//  - runs int8 wgmma m64n64k32, both operands in shared memory by swizzled
//    descriptors, 8 k32 steps (int32 sums of int8 products are exact in any
//    order: |sum| <= 256 x 128 x 128 < 2^31, so every output equals the
//    first form's);
//  - stores the int32 sums straight from the accumulator, 8 bytes a lane,
//    a quad's 32 bytes one sector (the tile staged in shared memory and
//    written by TMA stores, its 16 KB one contiguous span of out, tried
//    first, was slower).
// What bounds it: the 6.4 MB at the memory's rate, the launch, and a
// block's a round trip before its products.
constexpr int kIdRows = 64;             // rows of a and out a block
constexpr int kIdBox = kIdRows * 128;   // 64 rows of 128 bytes, 128-byte swizzle: 8 KB
namespace id {   // the shared-memory layout, from a 1,024-byte aligned base: 2 boxes each
constexpr int A = 0;                  // a [K half][64 rows][128 k bytes]
constexpr int B = A + 2 * kIdBox;     // b^T [K half][64 n][128 k bytes]
constexpr int BAR = B + 2 * kIdBox;
constexpr int SMEM = 1024 + BAR + 8;
}  // namespace id

__global__ void __launch_bounds__(128) int_dot_hopper_kernel(const __grid_constant__ CUtensorMap ta,
                                                             const int8_t* __restrict__ b,
                                                             int* __restrict__ out) {
  unsigned char* base = probe_smem + ((1024 - (smem_u32(probe_smem) & 1023)) & 1023);
  unsigned char* As = base + id::A;
  unsigned char* Bs = base + id::B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + id::BAR);
  const int m0 = blockIdx.x * kIdRows, tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&ta);
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
    sm90::expect_tx(bar, 2 * kIdBox);
    tma_load3(As, &ta, 0, m0, 0, bar);
    tma_load3(As + kIdBox, &ta, 128, m0, 0, bar);
  }
  // b^T: warp w takes K half h = w & 1 of the 16-column pieces w >> 1 and
  // 2 + (w >> 1); lane l the K quad kb = 32 h + l (k bytes 4 l .. of the half)
  const int lane = tid & 31, warp = tid >> 5, h = warp & 1;
  const int8_t* bq = b + 4 * (32 * h + lane) * EN + 16 * (warp >> 1);
  uint4 rows[2][4];   // [piece][K row of the quad]
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rows[it][i] = *reinterpret_cast<const uint4*>(bq + i * EN + 32 * it);
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // columns n .. n + 3
      uint32_t w[4] = {word(rows[it][0], q), word(rows[it][1], q), word(rows[it][2], q),
                       word(rows[it][3], q)};
      transpose4x4(w);
      const int n = 16 * (2 * it + (warp >> 1)) + 4 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j)   // chunk l / 4 of row n + j
        *reinterpret_cast<uint32_t*>(swz(Bs + h * kIdBox, n + j, lane >> 2) + 4 * (lane & 3)) =
            w[j];
    }
  sm90::fence_proxy_async();   // b^T's st.shared, before wgmma reads it
  __syncthreads();             // and the mbarrier is initialized
  sm90::mbar_wait(bar, 0);

  int acc[32];
  sm90::zero(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < EK / 32; ++s) {
    const int kh = s >> 2, k0 = 32 * (s & 3);
    sm90::wgmma_s8_n64(acc, w4::desc_sw(As + kh * kIdBox + k0, 1024, 1),
                       w4::desc_sw(Bs + kh * kIdBox + k0, 1024, 1));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  // acc[4 j + q]: row 16 warp + g + 8 (q >> 1), column 8 j + 2 t + (q & 1)
  const int g = lane >> 2, t = lane & 3;
  int* og = out + (long long)(m0 + 16 * warp + g) * EN + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<int2*>(og + 8 * hh * EN + 8 * j) =
          make_int2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// E on the Hopper form: a [EM][EK], b [EK][EN] int8 (16-byte aligned) and
// out [EM][EN] int32, contiguous.
inline cudaError_t int_dot_hopper(const int8_t* a, const int8_t* b, int* out, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  const cuuint32_t abox[3] = {128, kIdRows, 1};
  CUtensorMap ta;
  const cudaError_t e = tensor_map3(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, {EK, EM, 1},
                                    {EK, (cuuint64_t)EM * EK}, abox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  int_dot_hopper_kernel<<<EM / kIdRows, 128, id::SMEM, st>>>(ta, b, out);
  return cudaGetLastError();
}

// cols_first_kernel, J's first form: 64-row tiles staged in shared memory by
// 8-byte cp.async granules, waited for whole, then copied out.
constexpr int kColRows = 64;   // cols rows per block

__global__ void __launch_bounds__(256) cols_first_kernel(const int8_t* __restrict__ x,
                                                         int8_t* __restrict__ cols) {
  int8_t* tile = reinterpret_cast<int8_t*>(probe_smem);   // [kColRows][256]
  const int p0 = blockIdx.x * kColRows;
  for (int c = threadIdx.x; c < kColRows * 32; c += 256) {
    const int r = c >> 5, t = c & 31;
    const int rr = t >> 4, pa = (t >> 2) & 3, pb = t & 3;   // piece (r, a, b)
    const int p = p0 + r, i = p / 112, jj = p % 112;
    cp_async_ca<8>(tile + r * 256 + 8 * t,
                   x + (pa + i) * 1840 + rr * 920 + 8 * pb + 8 * jj);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const uint4* s = reinterpret_cast<const uint4*>(tile);
  uint4* o = reinterpret_cast<uint4*>(cols + (long long)p0 * 256);
  for (int c = threadIdx.x; c < kColRows * 256 / 16; c += 256) o[c] = s[c];
}

// cols_kernel, J's Hopper form. Bound: bytes, cols 3.21 MB out + x 0.21 MB
// in, 1.022 us at 3.35 TB/s. The first form (cols_first_kernel, 3.62 us,
// PERF.md) ran load, wait and store in series within each of its 196
// blocks, through a shared-memory pass the data does not need. Here
// cols[112 i + j, 128 r + 32 a + 16 h ..+16] = merge(x)[a + i, 920 r + 8 j +
// 16 h ..+16]: each 16-byte output granule is 16 contiguous source bytes,
// 8-aligned (920 is an odd multiple of 8), so:
//  - a thread owns one granule: two 8-byte read-only loads, one 16-byte
//    store; a warp's 32 store 512 contiguous bytes (two cols rows);
//  - 200,704 threads in 784 blocks, all resident at once (about 6 blocks of
//    8 warps an SM): the SMs keep as many loads in flight as threads (4 or
//    8 granules a thread, fewer threads, ran slower: PERF.md);
//  - the 213 KB x stays in L1/L2 (a row's (r, a) runs overlap its
//    neighbour's by 24 bytes), so the loads cost round trips, not bytes;
//  - no shared memory, no barrier. (TMA cannot take the source view: its
//    8-byte strides are not multiples of 16.)
// What bounds it: the 3.2 MB of stores at the memory's rate and the launch.
constexpr int kColThreads = 256;
constexpr int kColGranules = EM * 256 / 16;            // cols [12544][256]: 200,704 granules
constexpr int kColGrid = kColGranules / kColThreads;   // 784

__global__ void __launch_bounds__(kColThreads) cols_kernel(const int8_t* __restrict__ x,
                                                           int8_t* __restrict__ cols) {
  const int g = blockIdx.x * kColThreads + threadIdx.x;
  const int p = g >> 4, q = g & 15, i = p / 112, j = p - 112 * i;
  const int8_t* src = x + (((q >> 1) & 3) + i) * 1840 + 920 * (q >> 3) + 8 * j + 16 * (q & 1);
  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(src));
  const uint2 hi = __ldg(reinterpret_cast<const uint2*>(src + 8));
  *reinterpret_cast<uint4*>(cols + 16LL * g) = make_uint4(lo.x, lo.y, hi.x, hi.y);
}

constexpr int PW = 112, PC = 64, PROW = PW * PC;   // input row: 112 pixels x 64 bytes

constexpr Staged kStaged[] = {
    {0, Op::kCopy, {0, 1840, 0, 116, 1, 1840}},
    {1, Op::kCopy, {0, 920, 0, 112, 1, 896}},
    {2, Op::kCopy, {3 * 1840 + 928, 1840, 0, 112, 1, 896}},
    {3, Op::kCopy, {0, 920, 8, 128, 16, 8}},
};

// maxpool_first_kernel, K's first form: a block per output row stages its
// three input rows (the top halo row -128 for the first) by cp.async, then
// takes __vmaxs4 over the 9 taps, 4 bytes a thread.
__global__ void __launch_bounds__(256) maxpool_first_kernel(const int8_t* __restrict__ x,
                                                            int8_t* __restrict__ out) {
  int8_t* rows = reinterpret_cast<int8_t*>(probe_smem);   // [3][PROW]
  const int oi = blockIdx.x;
  for (int c = threadIdx.x; c < 3 * PROW / 16; c += 256) {
    const int kh = c / (PROW / 16), q = (c - kh * (PROW / 16)) * 16;
    const int ir = 2 * oi - 1 + kh;
    if (ir >= 0)
      cp_async16(rows + kh * PROW + q, x + ir * PROW + q, true);
    else
      *reinterpret_cast<uint4*>(rows + kh * PROW + q) =
          make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < 56 * PC / 4; c += 256) {
    const int oj = c / (PC / 4), c4 = (c - oj * (PC / 4)) * 4;
    uint32_t m = 0x80808080u;   // -128 in every byte: the padding
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int col = 2 * oj - 1 + kw;
        if (col >= 0)
          m = __vmaxs4(m, *reinterpret_cast<const uint32_t*>(rows + kh * PROW + col * PC + c4));
      }
    *reinterpret_cast<uint32_t*>(out + oi * 56 * PC + oj * PC + c4) = m;
  }
}

// maxpool_kernel, K's Hopper form. Bound: bytes, 0.80 MB in + 0.20 MB out,
// 0.300 us at 3.35 TB/s. The first form (maxpool_first_kernel, 4.95 us,
// PERF.md) ran 56 blocks on 132 SMs, each staging three whole input rows
// (21.5 KB) and waiting for all of them before its first max, every input
// row loaded by up to two blocks, and read shared memory 4 bytes at a time
// (9 loads per 4 output bytes). Here:
//  - a thread owns one 16-byte output granule, 16 channels of one output
//    pixel (12,544 threads); neighbouring threads own neighbouring
//    granules, so a warp stores 512 contiguous bytes;
//  - its 9 taps are independent 16-byte read-only loads straight from
//    global memory, all in flight at once: L1/L2 serve the 2.25x overlap of
//    the taps, so the input crosses the memory bus about once;
//  - blocks of one warp (392 of them, about 3 an SM): ptxas gives this
//    launch bound 50 registers, room for the 9 loads' 36 at once; at 64 to
//    256 threads a block it used 32, and at 128 and 256 ran 0.34-0.43 us
//    slower in turns (PERF.md);
//  - a tap above row 0 or left of column 0 is the padding, -128, the least
//    int8: the max starts at 0x80808080 and skips it. The centre tap (2 oi,
//    2 oj) always lies inside;
//  - 4 __vmaxs4 a tap, one 16-byte store.
// What bounds it: the launch and one L2 round trip before the store.
constexpr int kPoolThreads = 32;
constexpr int kPoolGranules = 56 * 56 * PC / 16;            // 12,544
constexpr int kPoolGrid = kPoolGranules / kPoolThreads;     // 392

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

__global__ void __launch_bounds__(kPoolThreads) maxpool_kernel(const int8_t* __restrict__ x,
                                                               int8_t* __restrict__ out) {
  const int t = blockIdx.x * kPoolThreads + threadIdx.x;
  const int oi = t / (56 * PC / 16), oj = (t >> 2) % 56, c16 = 16 * (t & 3);
  uint4 v[9];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ir = 2 * oi - 1 + kh, ic = 2 * oj - 1 + kw;
      v[3 * kh + kw] = ir >= 0 && ic >= 0
                           ? __ldg(reinterpret_cast<const uint4*>(x + ir * PROW + ic * PC + c16))
                           : make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
    }
  uint4 m = v[4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (k != 4) m = vmax16(m, v[k]);
  *reinterpret_cast<uint4*>(out + 16 * t) = m;
}

}  // namespace

extern "C" int dlq_probe_stem_prepare() {
  cudaError_t e;
  if ((e = prepare_stage()) != cudaSuccess) return (int)e;
  if ((e = prepare(int_dot_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(int_dot_hopper_kernel, id::SMEM)) != cudaSuccess) return (int)e;
  if ((e = prepare(cols_first_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(cols_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(maxpool_first_kernel)) != cudaSuccess) return (int)e;
  return (int)prepare(maxpool_kernel);
}

// a, b: the pattern's inputs (contiguous, the shapes above); out: its output.
extern "C" int dlq_probe_stem(int pattern, const void* a, const void* b, const void*, void* out,
                              float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 4:
      return (int)int_dot_hopper(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                 static_cast<int*>(out), st);
    case 5:
      cols_kernel<<<kColGrid, kColThreads, 0, st>>>(static_cast<const int8_t*>(a),
                                                    static_cast<int8_t*>(out));
      return (int)cudaGetLastError();
    case 6:
      maxpool_kernel<<<kPoolGrid, kPoolThreads, 0, st>>>(static_cast<const int8_t*>(a),
                                                         static_cast<int8_t*>(out));
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of A, B, C, D (stage_first_kernel), E (int_dot_kernel),
// J (cols_first_kernel) and K (maxpool_first_kernel), arguments as
// dlq_probe_stem's.
extern "C" int dlq_probe_stem_first(int pattern, const void* a, const void* b, const void*,
                                    void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, st);
  const int8_t* x = static_cast<const int8_t*>(a);
  switch (pattern) {
    case 4:
      int_dot_kernel<<<EM / EBM, THREADS, 0, st>>>(x, static_cast<const int8_t*>(b),
                                                   static_cast<int*>(out));
      break;
    case 5:
      cols_first_kernel<<<EM / kColRows, 256, kColRows * 256, st>>>(x, static_cast<int8_t*>(out));
      break;
    case 6:
      maxpool_first_kernel<<<56, 256, 3 * PROW, st>>>(x, static_cast<int8_t*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// E's Hopper form's launch into v[0..5]: grid, threads, rows a block, bytes
// of an a box, bytes of shared memory, the bytes its mbarrier counts (the
// card tests hold it to dlq_tpu_torch/tools/probe_stem_patterns.py:
// int_dot_launch).
extern "C" int dlq_probe_stem_int_plan(int* v) {
  const int t[6] = {EM / kIdRows, 128, kIdRows, kIdBox, id::SMEM, 2 * kIdBox};
  for (int k = 0; k < 6; ++k) v[k] = t[k];
  return 0;
}

// J's and K's Hopper forms' launches into v[0..2]: grid, threads, output
// bytes a thread (the card tests hold them to probe_stem_patterns.py:
// cols_launch, pool_launch).
extern "C" int dlq_probe_stem_cols_plan(int* v) {
  const int t[3] = {kColGrid, kColThreads, 16};
  for (int k = 0; k < 3; ++k) v[k] = t[k];
  return 0;
}

extern "C" int dlq_probe_stem_pool_plan(int* v) {
  const int t[3] = {kPoolGrid, kPoolThreads, 16};
  for (int k = 0; k < 3; ++k) v[k] = t[k];
  return 0;
}

DLQ_PROBE_STAGE_ENTRIES(probe_stem, kStaged)
