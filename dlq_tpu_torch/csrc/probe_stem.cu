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
//   (stage_kernel is a Hopper form, probe_common.cuh; dlq_probe_stem_first
//   runs its first form for A, B, C and D)
//   4 "E"  int8 dot [12544, 256] x [256, 64] -> int32 (int_dot_kernel:
//          igemm.cuh's MmaTile and two-stage cp.async mainloop; the [K, N]
//          weight is transposed stage by stage into K-major shared rows)
//   5 "J"  the im2col cols build: piece t = (r, a, b), 32 of them, is
//          merge(x)[a:a+112, 920r + 8b : +896] viewed [12544, 8], written to
//          lanes 8t..8t+7 of cols [12544, 256] (cols_kernel: 3.2 MB of cols
//          is no shared-memory scratch, so 64-row tiles are built in shared
//          memory with 8-byte cp.async granules and written out)
//   6 "K"  3x3/s2 max pool of [112, 112, 64] int8 with -128 padding ->
//          [56, 3584] (maxpool_kernel: one block per output row stages its
//          three input rows, the top halo row -128 for the first, and
//          takes __vmaxs4 over the 9 taps)
// Bound: bytes everywhere (E: 0.41 GOP of int8 against 6.4 MB, 1.9 us at
// 3.35 TB/s); at these sizes launch latency. Nothing is tuned.
#include "probe_common.cuh"

namespace {

using namespace dlq;
using namespace dlq::probe;

constexpr int EM = 12544, EK = 256, EN = 64, EBM = 128;

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

constexpr int kColRows = 64;   // cols rows per block

__global__ void __launch_bounds__(256) cols_kernel(const int8_t* __restrict__ x,
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

constexpr int PW = 112, PC = 64, PROW = PW * PC;   // input row: 112 pixels x 64 bytes

constexpr Staged kStaged[] = {
    {0, Op::kCopy, {0, 1840, 0, 116, 1, 1840}},
    {1, Op::kCopy, {0, 920, 0, 112, 1, 896}},
    {2, Op::kCopy, {3 * 1840 + 928, 1840, 0, 112, 1, 896}},
    {3, Op::kCopy, {0, 920, 8, 128, 16, 8}},
};

__global__ void __launch_bounds__(256) maxpool_kernel(const int8_t* __restrict__ x,
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

}  // namespace

extern "C" int dlq_probe_stem_prepare() {
  cudaError_t e;
  if ((e = prepare_stage()) != cudaSuccess) return (int)e;
  if ((e = prepare(int_dot_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(cols_kernel)) != cudaSuccess) return (int)e;
  return (int)prepare(maxpool_kernel);
}

// a, b: the pattern's inputs (contiguous, the shapes above); out: its output.
extern "C" int dlq_probe_stem(int pattern, const void* a, const void* b, const void*, void* out,
                              float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 4:
      int_dot_kernel<<<EM / EBM, THREADS, 0, st>>>(static_cast<const int8_t*>(a),
                                                   static_cast<const int8_t*>(b),
                                                   static_cast<int*>(out));
      return (int)cudaGetLastError();
    case 5:
      cols_kernel<<<EM / kColRows, 256, kColRows * 256, st>>>(static_cast<const int8_t*>(a),
                                                               static_cast<int8_t*>(out));
      return (int)cudaGetLastError();
    case 6:
      maxpool_kernel<<<56, 256, 3 * PROW, st>>>(static_cast<const int8_t*>(a),
                                                static_cast<int8_t*>(out));
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first form of A, B, C and D (stage_first_kernel), arguments as
// dlq_probe_stem's; other patterns have one form and return
// cudaErrorInvalidValue.
extern "C" int dlq_probe_stem_first(int pattern, const void* a, const void*, const void*,
                                    void* out, float, float, void* stream) {
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

DLQ_PROBE_STAGE_ENTRIES(probe_stem, kStaged)
