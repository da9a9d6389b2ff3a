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
//   4 "5"  tanh epilogue: bf16(tanhf(fp32(x))), [256, 768]
//   5 "6"  the probe's 4-head attention on qkv [256, 768] (attention_kernel:
//          a block per (head, 64-row query tile), scale 0.125, keys >= 197
//          at -1e30, 256 keys)
// Bound: bytes for every pattern, and at these sizes (at most 0.5 MB)
// launch latency more than either. stage_kernel, nt_dot_hopper_kernel and
// attention_kernel are Hopper forms (probe_common.cuh); dlq_probe_mosaic_first
// runs their first forms (stage_first_kernel, nt_dot_kernel,
// attention_first_kernel) for patterns 0-3 and 5.
#include "probe_common.cuh"

namespace {

using namespace dlq::probe;

__global__ void __launch_bounds__(256) tanh_kernel(const bf16* __restrict__ x,
                                                   bf16* __restrict__ out, int n8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 v = reinterpret_cast<const uint4*>(x)[i];
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(tanhf(__bfloat162float(e[k])));
  reinterpret_cast<uint4*>(out)[i] = v;
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
    case 4: {
      const int n8 = 256 * 768 / 8;
      tanh_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(a),
                                                     static_cast<bf16*>(out), n8);
      return (int)cudaGetLastError();
    }
    case 5:
      return (int)attention<kKeyTiles, kValid>(heads(a, out), 4, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first forms of patterns 0, 1, 3 (stage_first_kernel), 2
// (nt_dot_kernel) and 5 (attention_first_kernel), arguments as
// dlq_probe_mosaic's; pattern 4 has one form and returns
// cudaErrorInvalidValue.
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
  if (pattern == 5) return (int)attention_first<kKeyTiles>(heads(a, out), 4, st);
  return (int)cudaErrorInvalidValue;
}

DLQ_PROBE_STAGE_ENTRIES(probe_mosaic, kStaged)
DLQ_PROBE_NT_PLAN(probe_mosaic, 1, 256, 256)
