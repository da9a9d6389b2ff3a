// K19: the port of tools/probe_mosaic_patterns.py (its run helper's
// pallas_call, :37/:39): the patterns of a fused ViT block kernel (1, 2 and
// 4 on probe_common.cuh's stage_kernel; the plain versions and the numpy
// expectations sit in dlq_tpu_torch/tools/probe_mosaic_patterns.py):
//   0 "1"  lane-slice read at lane 64: x [256, 768] bf16 -> [256, 64]
//          (stage_kernel: one 128-byte piece per row at byte 128)
//   1 "2"  scratch writes at 64-lane offsets, x 2: [256, 256] -> [256, 256]
//          (stage_kernel: four 64-lane pieces per row staged at their
//          offsets, doubled in bf16 on the way out; exact)
//   2 "3"  NT dot: q [256, 64] x k [256, 64]^T -> fp32 [256, 256]
//          (nt_dot_hopper_kernel: a block per 16 x 32 output tile, 128
//          blocks, q and k rows by TMA boxes)
//   3 "4"  leading-dim merge [4, 256, 256] -> [1024, 256], x 2 (stage_kernel)
//   4 "5"  tanh epilogue: bf16(tanhf(fp32(x))), [256, 768] (tanh_kernel,
//          below: a thread per 4 values on every SM; first form
//          tanh_first_kernel)
//   5 "6"  the probe's 4-head attention on qkv [256, 768] (attention_kernel:
//          a block per (head, 64-row query tile), scale 0.125, keys >= 197
//          at -1e30, 256 keys)
// Bound: bytes for every pattern, and at these sizes (at most 0.5 MB)
// launch latency more than either. stage_kernel, nt_dot_hopper_kernel and
// attention_kernel are Hopper forms (probe_common.cuh), and so is
// tanh_kernel; dlq_probe_mosaic_first runs the first forms of all six
// patterns (stage_first_kernel, nt_dot_kernel, tanh_first_kernel,
// attention_first_kernel).
#include "probe_common.cuh"

namespace {

using namespace dlq::probe;

// tanh_first_kernel, pattern 4's first form: 96 blocks of 256 threads, a
// thread per 8 values, tanhf on each through a view of a local uint4 (kept
// in registers: ptxas reports no stack frame).
__global__ void __launch_bounds__(256) tanh_first_kernel(const bf16* __restrict__ x,
                                                         bf16* __restrict__ out, int n8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 v = reinterpret_cast<const uint4*>(x)[i];
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(tanhf(__bfloat162float(e[k])));
  reinterpret_cast<uint4*>(out)[i] = v;
}

// tanh_kernel, pattern 4's Hopper form. Bound: bytes, 384 KB in + 384 KB
// out, 0.235 us at 3.35 TB/s; at this size the launch and one round trip.
// The first form (tanh_first_kernel, 2.55 us, PERF.md) left 36 of the 132
// SMs idle (96 blocks of 256 threads, 8 values a thread). Its tanhf is
// branch-free (two MUFU and ~12 other instructions a value, in the SASS),
// so the time is in the launch shape, not in the arithmetic: a cheaper
// tanh, exact on every bf16 input, ran no faster (PERF.md). Here:
//  - every SM works: kTanhGrid blocks (192) of kTanhThreads threads (256),
//    a thread per kTanhValues values (4: one read-only uint2 load and one
//    store). No other shape timed (PERF.md) was faster than this one in
//    every call: at this size the launch and one round trip bound both
//    forms;
//  - the values stay in registers: a bf16 is the high half of its fp32,
//    and each pair goes back by one cvt.rn.bf16x2.f32 (tanh2), which rounds
//    as __float2bfloat16_rn does (NaN to NaN), so the two forms are equal
//    on every input.
constexpr int kTanhThreads = 256;
constexpr int kTanhValues = 4;   // one uint2 a thread
constexpr int kTanhGrid = 256 * 768 / (kTanhThreads * kTanhValues);
static_assert(kTanhGrid * kTanhThreads * kTanhValues == 256 * 768, "5: the grid covers the output");

// tanhf of the two bf16 of w; cvt.rn.bf16x2.f32 d, a, b puts bf16(a) in
// d's high half
__device__ __forceinline__ uint32_t tanh2(uint32_t w) {
  const float lo = tanhf(__uint_as_float(w << 16));
  const float hi = tanhf(__uint_as_float(w & 0xffff0000u));
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__global__ void __launch_bounds__(kTanhThreads) tanh_kernel(const bf16* __restrict__ x,
                                                            bf16* __restrict__ out) {
  const int i = blockIdx.x * kTanhThreads + threadIdx.x;
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(x) + i);
  reinterpret_cast<uint2*>(out)[i] = make_uint2(tanh2(v.x), tanh2(v.y));
}

constexpr int kKeyTiles = 32;   // 256 keys
constexpr int kValid = 197;     // unmasked keys

constexpr Staged kStaged[] = {
    {0, Op::kCopy, {128, 1536, 0, 256, 1, 128}},
    {1, Op::kTimes2Bf16, {0, 512, 128, 256, 4, 128}},
    {3, Op::kTimes2Bf16, {0, 512, 0, 1024, 1, 512}},
};

// unit = head h: q/k/v at lanes 64h, 256 + 64h, 512 + 64h of each [768]
// row; out lanes 64h of each [256] row
AttnArgs heads(const void* a, void* out) {
  return AttnArgs{static_cast<const bf16*>(a), static_cast<bf16*>(out), 0, 768, 64, 0, 256, 64,
                  0, 256, 512, 256, kValid, 0, 0, 0.125f};
}

}  // namespace

extern "C" int dlq_probe_mosaic_prepare() {
  cudaError_t e;
  if ((e = prepare_stage()) != cudaSuccess) return (int)e;
  if ((e = prepare(nt_dot_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(nt_dot_hopper_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(tanh_first_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(tanh_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(empty_kernel)) != cudaSuccess) return (int)e;
  constexpr int smem = AttnPlan<kKeyTiles>::SMEM;
  if ((e = prepare(attention_kernel<kKeyTiles, kValid>, smem)) != cudaSuccess) return (int)e;
  return (int)prepare(attention_first_kernel<kKeyTiles>, attention_first_smem<kKeyTiles>());
}

// a, b, c: the pattern's inputs (contiguous, the shapes above); out: its
// output; s1, s2 unused.
extern "C" int dlq_probe_mosaic(int pattern, const void* a, const void* b, const void*,
                                void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern)) return (int)stage(s->op, a, out, s->w, st);
  switch (pattern) {
    case 2:
      return (int)nt_dot_hopper(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                static_cast<float*>(out), 1, 256, 256, st);
    case 4:
      tanh_kernel<<<kTanhGrid, kTanhThreads, 0, st>>>(static_cast<const bf16*>(a),
                                                       static_cast<bf16*>(out));
      return (int)cudaGetLastError();
    case 5:
      return (int)attention<kKeyTiles, kValid>(heads(a, out), 4, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of patterns 0, 1, 3 (stage_first_kernel), 2
// (nt_dot_kernel), 4 (tanh_first_kernel) and 5 (attention_first_kernel),
// arguments as dlq_probe_mosaic's.
extern "C" int dlq_probe_mosaic_first(int pattern, const void* a, const void* b, const void*,
                                      void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const Staged* s = find_staged(kStaged, pattern))
    return (int)stage_first(s->op, a, out, s->w, st);
  if (pattern == 2) {
    const NtArgs n{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                   static_cast<float*>(out), 256, 256, 0, 0, 0};
    return (int)nt_dot(n, 1, st);
  }
  if (pattern == 4) {
    const int n8 = 256 * 768 / 8;
    tanh_first_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(a),
                                                         static_cast<bf16*>(out), n8);
    return (int)cudaGetLastError();
  }
  if (pattern == 5) return (int)attention_first<kKeyTiles>(heads(a, out), 4, st);
  return (int)cudaErrorInvalidValue;
}

// Pattern 4's Hopper form's launch into v[0..2]: grid, threads, values a
// thread (the card tests hold it to probe_mosaic_patterns.py:
// tanh_launch).
extern "C" int dlq_probe_mosaic_tanh_plan(int* v) {
  const int t[3] = {kTanhGrid, kTanhThreads, kTanhValues};
  for (int k = 0; k < 3; ++k) v[k] = t[k];
  return 0;
}

DLQ_PROBE_STAGE_ENTRIES(probe_mosaic, kStaged)
DLQ_PROBE_NT_PLAN(probe_mosaic, 1, 256, 256)
