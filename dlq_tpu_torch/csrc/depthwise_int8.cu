// K23: int8 depthwise convolution (groups == C) with K1's fused fp32 / int8
// epilogue.
//
// Replaces no Pallas kernel: the reference leaves this conv to XLA, the
// grouped branch of dlq_tpu/ops/qops.py:182 _conv_int8 (groups == C, HWIO
// weights [kh, kw, 1, C]; its oracle _depthwise_int8_stencil, :162-179),
// with the fused contexts' epilogue (dlq_tpu/quant/model_quant.py:416-430).
// PyTorch has no int8 conv that sums in int32 on CUDA, so every depthwise
// conv of MobileNetV2's served paths runs here.
//
//   acc[n, oh, ow, c] = sum_{u, v} x[n, oh*s - p + u, ow*s - p + v, c] * w[u*KW + v, c]  (int32)
//   y = fma(float(acc), scale[c], bias[c]), then relu or relu6 (clip to [0, 6])
//   out = y (fp32) | clip(rint(y / out_scale), act ? 0 : -127, 127) (int8)
//
// on int8 NHWC input, stride 1 or 2 (any), symmetric zero padding; the
// epilogue is K1's (igemm.cuh: epi_act, requant_div: one fused multiply-add,
// the requant divides).
//
// Bound: bytes. A 3x3 depthwise conv does 9 multiply-adds per output value
// and reads each input byte once: 18 int8 operations per input byte at
// stride 1 (4.5 at stride 2), far below the card's ridge of ~590; with fp32
// out the output's 4 bytes a value dominate. No tensor core helps (no sum
// runs across channels).
//
// Design (a simple first form): a thread per output pixel and G-byte
// channel granule (G = 16, or 8 when C % 16 == 8; C % 8 != 0 is refused),
// consecutive threads on consecutive granules of a pixel, so a warp's loads
// of one tap are contiguous; per tap one G-byte read-only load of x (padding
// taps skipped) and of the tap-major [KH*KW, C] weight (L1-resident), G int32
// sums in registers, then the epilogue per channel and one G-byte int8 store
// or G / 4 16-byte fp32 stores. Neighbouring pixels' taps overlap, so most
// of x's reads after the first hit L1 or L2.
#include "igemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;      // [KH * KW, C], tap-major
  const float* scale;
  const float* bias;
  void* out;
  int H, W, C, KH, KW, stride, pad, OH, OW;
  int act, out_int8;    // act: ACT_NONE, ACT_RELU or ACT_RELU6 (igemm.cuh)
  float out_scale;
  long long total;      // output granules: N * OH * OW * C / G
};

constexpr int THREADS_DW = 256;

// A G-byte vector of int8 values: its 32-bit words, and built from them.
template <int G>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
  __device__ static uint32_t word(const T& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ static T make(const uint32_t (&q)[4]) { return make_uint4(q[0], q[1], q[2], q[3]); }
};
template <>
struct Vec<8> {
  using T = uint2;
  __device__ static uint32_t word(const T& v, int j) { return j == 0 ? v.x : v.y; }
  __device__ static T make(const uint32_t (&q)[2]) { return make_uint2(q[0], q[1]); }
};

// byte k of a G-byte vector, sign-extended (k a constant after unrolling)
template <int G>
__device__ __forceinline__ int sbyte(const typename Vec<G>::T& v, int k) {
  return static_cast<int>(static_cast<int8_t>(Vec<G>::word(v, k >> 2) >> (8 * (k & 3))));
}

template <int G, bool I8, bool R6>
__global__ void __launch_bounds__(THREADS_DW) depthwise_int8_kernel(const Args a) {
  using V = typename Vec<G>::T;
  const long long i = (long long)blockIdx.x * THREADS_DW + threadIdx.x;
  if (i >= a.total) return;
  const int gpp = a.C / G;   // granules a pixel
  const long long pix = i / gpp;
  const int c0 = (int)(i - pix * gpp) * G;
  const int ow = (int)(pix % a.OW);
  const long long r = pix / a.OW;
  const int oh = (int)(r % a.OH);
  const long long n = r / a.OH;
  const int8_t* xn = a.x + (size_t)n * a.H * a.W * a.C + c0;
  const int ih0 = oh * a.stride - a.pad, iw0 = ow * a.stride - a.pad;

  int acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0;
  for (int u = 0; u < a.KH; ++u) {
    const int ih = ih0 + u;
    if (ih < 0 || ih >= a.H) continue;
    for (int v = 0; v < a.KW; ++v) {
      const int iw = iw0 + v;
      if (iw < 0 || iw >= a.W) continue;
      const V xv = __ldg(reinterpret_cast<const V*>(xn + ((size_t)ih * a.W + iw) * a.C));
      const V wv = __ldg(reinterpret_cast<const V*>(a.w + (size_t)(u * a.KW + v) * a.C + c0));
#pragma unroll
      for (int k = 0; k < G; ++k) acc[k] += sbyte<G>(xv, k) * sbyte<G>(wv, k);
    }
  }

  const size_t o = (size_t)pix * a.C + c0;
  const bool relu = a.act != ACT_NONE;
  auto epi = [&](int k) {
    return epi_act<R6>(acc[k], __ldg(a.scale + c0 + k), __ldg(a.bias + c0 + k), relu);
  };
  if constexpr (I8) {
    const float lo = relu ? 0.0f : -127.0f;
    uint32_t q[G / 4];
#pragma unroll
    for (int k = 0; k < G / 4; ++k) q[k] = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      q[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(requant_div(epi(k), a.out_scale, lo)))
                   << (8 * (k & 3));
    }
    *reinterpret_cast<V*>(static_cast<int8_t*>(a.out) + o) = Vec<G>::make(q);
  } else {
    float* out = static_cast<float*>(a.out) + o;
#pragma unroll
    for (int k = 0; k < G; k += 4)
      *reinterpret_cast<float4*>(out + k) = make_float4(epi(k), epi(k + 1), epi(k + 2), epi(k + 3));
  }
}

template <int G, bool R6>
cudaError_t launch_act(Args a, long long pixels, cudaStream_t s) {
  a.total = pixels * (a.C / G);
  const long long blocks = (a.total + THREADS_DW - 1) / THREADS_DW;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  if (a.out_int8)
    depthwise_int8_kernel<G, true, R6><<<(unsigned)blocks, THREADS_DW, 0, s>>>(a);
  else
    depthwise_int8_kernel<G, false, R6><<<(unsigned)blocks, THREADS_DW, 0, s>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch(const Args& a, long long pixels, cudaStream_t s) {
  return a.act == ACT_RELU6 ? launch_act<G, true>(a, pixels, s)
                            : launch_act<G, false>(a, pixels, s);
}

}  // namespace

// The channel granule a launch takes: 16 bytes for C % 16 == 0, 8 for
// C % 16 == 8, 0 (refused) otherwise.
extern "C" int dlq_depthwise_int8_granule(int C) {
  return C % 16 == 0 ? 16 : (C % 8 == 0 ? 8 : 0);
}

// x: int8 NHWC [N, H, W, C], 16-byte aligned (8 for an 8-byte granule);
// w: int8 [KH * KW, C] (the HWIO [KH, KW, 1, C] weight, tap-major); scale,
// bias: fp32 [C]; out: fp32 or int8 NHWC [N, OH, OW, C]; act: 0 none, 1
// relu, 2 relu6. A refused shape returns cudaErrorInvalidValue.
extern "C" int dlq_depthwise_int8(const int8_t* x, const int8_t* w, const float* scale,
                                  const float* bias, void* out, int N, int H, int W, int C,
                                  int KH, int KW, int stride, int pad, int act, int out_int8,
                                  float out_scale, void* stream) {
  const int g = dlq_depthwise_int8_granule(C);
  if (g == 0 || KH <= 0 || KW <= 0 || stride <= 0 || pad < 0 || H + 2 * pad < KH ||
      W + 2 * pad < KW || act < ACT_NONE || act > ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  const int OH = (H + 2 * pad - KH) / stride + 1, OW = (W + 2 * pad - KW) / stride + 1;
  if (N == 0) return 0;
  Args a{x, w, scale, bias, out, H, W, C, KH, KW, stride, pad, OH, OW, act, out_int8, out_scale, 0};
  const long long pixels = (long long)N * OH * OW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(g == 16 ? launch<16>(a, pixels, s) : launch<8>(a, pixels, s));
}
