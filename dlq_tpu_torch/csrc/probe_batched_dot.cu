// K20: the port of tools/probe_batched_dot.py (its run helper's
// pallas_call, :28/:30): the batched dots of a per-(sample, head)
// attention, one kernel each (the split reshape on probe_common.cuh's
// stage_kernel; the plain versions and the numpy expectations sit in
// dlq_tpu_torch/tools/probe_batched_dot.py):
//   0 "A"  batched NT dot: q, k [8, 200, 64] bf16 -> fp32 [8, 200, 200]
//          (nt_dot_hopper_kernel, probe_common.cuh: a block per (16 x 32
//          output tile, sample), 728 blocks; the boxes land zeros past a
//          sample's 200 rows, and no row or column past 200 is stored;
//          first form nt_dot_kernel)
//   1 "B"  batched NN dot: a [8, 200, 200] x v [8, 200, 64] -> fp32
//          [8, 200, 64] (nn_dot_hopper_kernel, below; first form
//          nn_dot_kernel: K padded to 208 with zeros, the B operand read
//          from row-major v through ldmatrix.trans)
//   2 "C"  split reshape [1600, 576] -> [8, 200, 576] (stage_kernel)
//   3 "D"  per sample of x [1600, 576]: q, k, v = lanes 0, 64, 128 of its
//          200 rows, no scale and no mask; out [8, 200, 192] bf16 with lanes
//          64..191 zero (attention_kernel: a block per (sample, 64-row query
//          tile); only lanes 0..191, 77 KB of the 230 KB sample, are read,
//          the 208 keys' K and V in shared memory, the 8 pad keys zero and
//          at -1e30)
// Bound: A and B are 41 MFLOP of bf16 products (2 x 8 x 200 x 200 x 64),
// D 82 MFLOP, against 0.6-1.3 MB: bytes (B: 1.25 MB, 0.374 us at 3.35
// TB/s), and at these sizes launch latency. Every pattern runs on a Hopper
// form; dlq_probe_batched_dot_first runs their first forms (nn_dot_kernel
// here, nt_dot_kernel, stage_first_kernel and attention_first_kernel in
// probe_common.cuh).
#include "probe_common.cuh"

namespace {

using namespace dlq;
using namespace dlq::probe;

constexpr int kKp = 208;        // K (keys) padded to k16 steps
constexpr int kLdA = kKp + 8;   // bf16 row stride of the a tile (conflict-free reads)
constexpr int kNnSmem = (64 * kLdA + kKp * kLd) * 2;

// out[b][m][n] = sum_k a[b][m][k] v[b][k][n], fp32; a [M][K], v [K][64], K <= 208,
// K % 8 == 0. One block of 4 warps per (64 rows, b); each warp owns 16 rows.
__global__ void __launch_bounds__(128) nn_dot_kernel(const bf16* __restrict__ a,
                                                     const bf16* __restrict__ v,
                                                     float* __restrict__ out, int M, int K) {
  bf16* As = reinterpret_cast<bf16*>(probe_smem);   // [64][kLdA]
  bf16* Vs = As + 64 * kLdA;                         // [kKp][kLd]
  const int b = blockIdx.y, m0 = blockIdx.x * 64;
  const bf16* ag = a + (long long)b * M * K;
  const bf16* vg = v + (long long)b * K * 64;
  constexpr int CA = kKp / 8;   // 16-byte chunks of an a row
  for (int c = threadIdx.x; c < 64 * CA; c += 128) {
    const int r = c / CA, k = (c - r * CA) * 8;
    const bool ok = m0 + r < M && k < K;
    cp_async16(As + r * kLdA + k, ok ? ag + (long long)(m0 + r) * K + k : a, ok);
  }
  for (int c = threadIdx.x; c < kKp * 8; c += 128) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool ok = r < K;
    cp_async16(Vs + r * kLd + d, ok ? vg + r * 64 + d : v, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* aw = As + warp * 16 * kLdA;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kKp / 16; ++ks) {
    const int kk = ks * 16;
    const uint32_t af[4] = {ld32(aw + g * kLdA + kk + 2 * t), ld32(aw + (g + 8) * kLdA + kk + 2 * t),
                            ld32(aw + g * kLdA + kk + 2 * t + 8),
                            ld32(aw + (g + 8) * kLdA + kk + 2 * t + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, Vs + (kk + (lane & 15)) * kLd + j * 8);
      mma_bf16(acc[j], af, b0, b1);
    }
  }
  float* og = out + (long long)b * M * 64;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + warp * 16 + g + hh * 8;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(og + (long long)row * 64 + j * 8 + 2 * t) =
          make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

// nn_dot_hopper_kernel, the Hopper form of B. Bound: bytes, a 640,000 + v
// 204,800 + out 409,600 = 1.25 MB, 0.374 us at 3.35 TB/s (its 41 MFLOP take
// 0.041 us at 989 TFLOP/s). The first form (nn_dot_kernel, 5.27 us against
// torch.matmul's 3.71, PERF.md) ran 32 blocks of 4 warps on 132 SMs, each
// waiting for its whole 64 x 208 a tile and all of v (53 KB, one cp.async
// group) before its first product. This form:
//  - gives each block an output tile of 32 rows x 32 columns: a grid of
//    (7, 2, 8) = 112 blocks, each reading 13 KB of a and 13 KB of v; each
//    warp owns 16 rows x 16 columns (the last row tile's second pair of
//    warps has no rows and does no products);
//  - brings the keys in four chunks of 64, each an a box (32 rows x 64 keys,
//    128-byte swizzle) and a v box (64 keys x 32 columns, 64-byte swizzle)
//    by TMA on its own mbarrier, all issued by thread 0 at the start from
//    3-D maps [sample][row][key] and [sample][key][column]: a box past a
//    sample's 200 rows or keys lands zeros (the first form's zero-filled
//    pads), and a warp runs a chunk's k16 steps while the later chunks land
//    (four cp.async groups, 13 granules a thread, landed later than the
//    boxes do);
//  - reads every fragment by ldmatrix from the swizzled boxes, 8 distinct
//    16-byte bank groups a phase;
//  - writes the fp32 tile through shared memory as 16-byte row pieces,
//    rows >= M not stored;
//  - keeps the first form's arithmetic, so every output equals it: the same
//    mma.sync m16n8k16 on the same A fragments (ldmatrix gives the bits the
//    first form's 32-bit loads give) and B fragments (ldmatrix.trans of
//    row-major v; the x4 form's lanes 0-15 give the x2 form's rows, lanes
//    16-31 the next 8 columns'), the k16 steps 0..12 in order with keys
//    200..207 zero (the fourth chunk's keys 208..255 are zeros it never
//    reads).
// What bounds it: the first chunk's latency and the launch.
constexpr int kNnTile = 32;                        // output rows and columns a block
constexpr int kNnChunk = 64;                       // keys a box
constexpr int kNnChunks = (kKp + kNnChunk - 1) / kNnChunk;
constexpr int kNnBox = kNnTile * kNnChunk * 2;     // bytes of an a box and of a v box: 4 KB
constexpr int kLdO = kNnTile + 8;                  // fp32 row stride of the output tile

// The shared address of 16-byte chunk c of row r in boxes of 64-byte rows
// landed with TMA's 64-byte swizzle (base 512-byte aligned): chunk c ^ bits
// 7-8 of the row's offset.
__device__ __forceinline__ const unsigned char* swz64(const unsigned char* base, int r, int c) {
  return base + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(128) nn_dot_hopper_kernel(const __grid_constant__ CUtensorMap ta,
                                                            const __grid_constant__ CUtensorMap tv,
                                                            float* __restrict__ out, int M) {
  __shared__ __align__(128) unsigned char raw[1024 + 2 * kNnChunks * kNnBox];
  __shared__ __align__(16) float Os[kNnTile * kLdO];
  __shared__ __align__(8) uint64_t bar[kNnChunks];
  unsigned char* As = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);   // a chunk c at c * kNnBox
  unsigned char* Vs = As + kNnChunks * kNnBox;
  const int b = blockIdx.z, m0 = blockIdx.x * kNnTile, n0 = blockIdx.y * kNnTile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&ta);
    prefetch_map(&tv);
    for (int c = 0; c < kNnChunks; ++c) sm90::mbar_init(bar + c, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kNnChunks; ++c) {
      sm90::expect_tx(bar + c, 2 * kNnBox);
      tma_load3(As + c * kNnBox, &ta, c * kNnChunk, m0, b, bar + c);
      tma_load3(Vs + c * kNnBox, &tv, n0, c * kNnChunk, b, bar + c);
    }
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  if (m0 + wm * 16 < M) {   // a warp with rows (warp 0 always: it waits for every chunk)
    const int ar = wm * 16 + (lane & 15), vc = wn * 2 + (lane >> 4);
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNnChunks; ++c) {
      sm90::mbar_wait(bar + c, 0);
#pragma unroll
      for (int kl = 0; kl < kNnChunk / 16 && c * (kNnChunk / 16) + kl < kKp / 16; ++kl) {
        uint32_t af[4], bq[4];   // bq: columns wn*16 .. +7 (bq[0..1]) and +8 .. +15 (bq[2..3])
        ldsm_x4(af, swz(As + c * kNnBox, ar, 2 * kl + (lane >> 4)));
        ldsm_x4_trans(bq, swz64(Vs + c * kNnBox, 16 * kl + (lane & 15), vc));
        mma_bf16(acc[0], af, bq[0], bq[1]);
        mma_bf16(acc[1], af, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(Os + (wm * 16 + g + hh * 8) * kLdO + wn * 16 + j * 8 + 2 * t) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
  __syncthreads();
  float* og = out + ((long long)b * M + m0) * 64 + n0;
  for (int i = tid; i < kNnTile * (kNnTile / 4); i += 128) {
    const int r = i >> 3, q = (i & 7) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(og + (long long)r * 64 + q) =
          *reinterpret_cast<const float4*>(Os + r * kLdO + q);
  }
}

// B on the Hopper form: a [batch][M][K], v [batch][K][64] (16-byte aligned);
// K <= 208, K % 8 == 0.
inline cudaError_t nn_dot_hopper(const bf16* a, const bf16* v, float* out, int batch, int M,
                                 int K, cudaStream_t st) {
  if (K > kKp || K % 8 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  const cuuint32_t abox[3] = {kNnChunk, kNnTile, 1}, vbox[3] = {kNnTile, kNnChunk, 1};
  CUtensorMap ta, tv;
  cudaError_t e = tensor_map3(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a,
                              {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)batch},
                              {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2}, abox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tensor_map3(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, {64, (cuuint64_t)K, (cuuint64_t)batch},
                    {128, (cuuint64_t)K * 128}, vbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  nn_dot_hopper_kernel<<<dim3((M + kNnTile - 1) / kNnTile, 64 / kNnTile, batch), 128, 0, st>>>(
      ta, tv, out, M);
  return cudaGetLastError();
}

constexpr int kKeyTiles = 26;   // 208 keys: 200 and 8 pads
constexpr int kValid = 200;     // unmasked keys

constexpr Staged kStaged[] = {{2, Op::kCopy, {0, 1152, 0, 1600, 1, 1152}}};

// unit = sample: rows of 576 lanes, q/k/v at lanes 0/64/128; out [200, 192]
// per sample, lanes 64..191 zero
AttnArgs samples(const void* a, void* out) {
  constexpr int N = 200;
  return AttnArgs{static_cast<const bf16*>(a), static_cast<bf16*>(out), N * 576, 576, 0, N * 192,
                  192, 0, 0, 64, 128, N, kValid, 64, 192, 1.0f};
}

}  // namespace

extern "C" int dlq_probe_batched_dot_prepare() {
  cudaError_t e;
  if ((e = prepare(nt_dot_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(nt_dot_hopper_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(nn_dot_hopper_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(nn_dot_kernel, kNnSmem)) != cudaSuccess) return (int)e;
  if ((e = prepare_stage()) != cudaSuccess) return (int)e;
  constexpr int smem = AttnPlan<kKeyTiles>::SMEM;
  if ((e = prepare(attention_kernel<kKeyTiles, kValid>, smem)) != cudaSuccess) return (int)e;
  return (int)prepare(attention_first_kernel<kKeyTiles>, attention_first_smem<kKeyTiles>());
}

// a, b: the pattern's inputs (contiguous, the shapes above); out: its output.
extern "C" int dlq_probe_batched_dot(int pattern, const void* a, const void* b, const void*,
                                     void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int B = 8, N = 200;
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 0:
      return (int)nt_dot_hopper(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                static_cast<float*>(out), B, N, N, st);
    case 1:
      return (int)nn_dot_hopper(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                static_cast<float*>(out), B, N, N, st);
    case 3:
      return (int)attention<kKeyTiles, kValid>(samples(a, out), B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of A (nt_dot_kernel), B (nn_dot_kernel), C
// (stage_first_kernel) and D (attention_first_kernel), arguments as
// dlq_probe_batched_dot's.
extern "C" int dlq_probe_batched_dot_first(int pattern, const void* a, const void* b, const void*,
                                           void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int B = 8, N = 200;
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, st);
  if (pattern == 0) {
    const NtArgs n{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                   static_cast<float*>(out), N, N, N * 64, N * 64, N * N};
    return (int)nt_dot(n, B, st);
  }
  if (pattern == 1) {
    nn_dot_kernel<<<dim3((N + 63) / 64, B), 128, kNnSmem, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(out), N, N);
    return (int)cudaGetLastError();
  }
  if (pattern == 3) return (int)attention_first<kKeyTiles>(samples(a, out), B, st);
  return (int)cudaErrorInvalidValue;
}

// B's Hopper form's launch into v[0..5]: grid x, y, z, threads, key chunks
// (one box pair and mbarrier each) and the bytes of a box (the card tests
// hold it to dlq_tpu_torch/tools/probe_batched_dot.py: nn_dot_plan).
extern "C" int dlq_probe_batched_dot_nn_plan(int* v) {
  const int t[6] = {(200 + kNnTile - 1) / kNnTile, 64 / kNnTile, 8, 128, kNnChunks, kNnBox};
  for (int k = 0; k < 6; ++k) v[k] = t[k];
  return 0;
}

DLQ_PROBE_STAGE_ENTRIES(probe_batched_dot, kStaged)
DLQ_PROBE_NT_PLAN(probe_batched_dot, 8, 200, 200)
