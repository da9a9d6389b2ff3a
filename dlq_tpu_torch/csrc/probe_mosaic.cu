// K19: the port of tools/probe_mosaic_patterns.py (its run helper's
// pallas_call, :37/:39): the patterns of a fused ViT block kernel (1, 2 and
// 4 on probe_common.cuh's stage_kernel; the plain versions and the numpy
// expectations sit in dlq_tpu_torch/tools/probe_mosaic_patterns.py):
//   0 "1"  lane-slice read at lane 64: x [256, 768] bf16 -> [256, 64]
//          (stage_kernel: one 128-byte piece per row at byte 128)
//   1 "2"  scratch writes at 64-lane offsets, x 2: [256, 256] -> [256, 256]
//          (stage_kernel: four 64-lane pieces per row staged at their
//          offsets, doubled in bf16 on the way out; exact)
//   2 "3"  NT dot: q [256, 64] x k [256, 64]^T -> fp32 [256, 256] (nt_dot_kernel)
//   3 "4"  leading-dim merge [4, 256, 256] -> [1024, 256], x 2 (stage_kernel)
//   4 "5"  tanh epilogue: bf16(tanhf(fp32(x))), [256, 768]
//   5 "6"  the probe's 4-head attention on qkv [256, 768] (attention_kernel:
//          one block per head, scale 0.125, keys >= 197 at -1e30, 256 keys)
// Bound: bytes for every pattern but 3 and 6, and at these sizes (at most
// 0.4 MB) launch latency more than either; nothing is tuned.
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

}  // namespace

extern "C" int dlq_probe_mosaic_prepare() {
  cudaError_t e;
  if ((e = prepare(stage_kernel<16, Op::kCopy>)) != cudaSuccess) return (int)e;
  if ((e = prepare(stage_kernel<16, Op::kTimes2Bf16>)) != cudaSuccess) return (int)e;
  if ((e = prepare(nt_dot_kernel)) != cudaSuccess) return (int)e;
  if ((e = prepare(tanh_kernel)) != cudaSuccess) return (int)e;
  return (int)prepare(attention_kernel<kKeyTiles>, attention_smem<kKeyTiles>());
}

// a, b, c: the pattern's inputs (contiguous, the shapes above); out: its
// output; s1, s2 unused.
extern "C" int dlq_probe_mosaic(int pattern, const void* a, const void* b, const void*,
                                void* out, float, float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pattern) {
    case 0:
      return (int)stage<16, Op::kCopy>(a, out, Window{128, 1536, 0, 256, 1, 128}, st);
    case 1:
      return (int)stage<16, Op::kTimes2Bf16>(a, out, Window{0, 512, 128, 256, 4, 128}, st);
    case 2: {
      const NtArgs n{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                     static_cast<float*>(out), 256, 256, 0, 0, 0};
      return (int)nt_dot(n, 1, st);
    }
    case 3:
      return (int)stage<16, Op::kTimes2Bf16>(a, out, Window{0, 512, 0, 1024, 1, 512}, st);
    case 4: {
      const int n8 = 256 * 768 / 8;
      tanh_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(a),
                                                     static_cast<bf16*>(out), n8);
      return (int)cudaGetLastError();
    }
    case 5: {
      // unit = head h: q/k/v at lanes 64h, 256 + 64h, 512 + 64h of each
      // [768] row; out lanes 64h of each [256] row
      AttnArgs t{static_cast<const bf16*>(a), static_cast<bf16*>(out), 0, 768, 64, 0, 256, 64,
                 0, 256, 512, 256, 197, 0, 0, 0.125f};
      return (int)attention<kKeyTiles>(t, 4, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
