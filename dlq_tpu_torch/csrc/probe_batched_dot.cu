// K20: the port of tools/probe_batched_dot.py (its run helper's
// pallas_call, :28/:30): the batched dots of a per-(sample, head)
// attention, one kernel each (the split reshape on probe_common.cuh's
// stage_kernel; the plain versions and the numpy expectations sit in
// dlq_tpu_torch/tools/probe_batched_dot.py):
//   0 "A"  batched NT dot: q, k [8, 200, 64] bf16 -> fp32 [8, 200, 200]
//          (nt_dot_kernel; 200 is no multiple of 16: rows and columns past
//          200 are zero-filled at load and not stored)
//   1 "B"  batched NN dot: a [8, 200, 200] x v [8, 200, 64] -> fp32
//          [8, 200, 64] (nn_dot_kernel: K padded to 208 with zeros, the B
//          operand read from row-major v through ldmatrix.trans)
//   2 "C"  split reshape [1600, 576] -> [8, 200, 576] (stage_kernel)
//   3 "D"  per sample of x [1600, 576]: q, k, v = lanes 0, 64, 128 of its
//          200 rows, no scale and no mask; out [8, 200, 192] bf16 with lanes
//          64..191 zero (attention_kernel: a block per (sample, 64-row query
//          tile); only lanes 0..191, 77 KB of the 230 KB sample, are read,
//          the 208 keys' K and V in shared memory, the 8 pad keys zero and
//          at -1e30)
// Bound: A, B and D are 1.6-3.3 MFLOP of bf16 products against 0.2-1.3 MB:
// bytes, and at these sizes launch latency. stage_kernel and
// attention_kernel are Hopper forms (probe_common.cuh);
// dlq_probe_batched_dot_first runs their first forms for C and D.
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
    case 0: {
      const NtArgs n{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                     static_cast<float*>(out), N, N, N * 64, N * 64, N * N};
      return (int)nt_dot(n, B, st);
    }
    case 1:
      nn_dot_kernel<<<dim3((N + 63) / 64, B), 128, kNnSmem, st>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(out), N,
          N);
      return (int)cudaGetLastError();
    case 3:
      return (int)attention<kKeyTiles, kValid>(samples(a, out), B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of C (stage_first_kernel) and D (attention_first_kernel),
// arguments as dlq_probe_batched_dot's; other patterns have one form and
// return cudaErrorInvalidValue.
extern "C" int dlq_probe_batched_dot_first(int pattern, const void* a, const void*, const void*,
                                           void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, st);
  if (pattern == 3) return (int)attention_first<kKeyTiles>(samples(a, out), 8, st);
  return (int)cudaErrorInvalidValue;
}

DLQ_PROBE_STAGE_ENTRIES(probe_batched_dot, kStaged)
