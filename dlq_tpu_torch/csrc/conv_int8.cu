// K1: int8 implicit-GEMM convolution with a fused fp32 / int8 epilogue.
//
// Replaces dlq_tpu/ops/pallas_conv.py:int8_conv3x3_s1 (fp32 epilogue) and
// dlq_tpu/ops/pallas_conv.py:int8_conv3x3_s1_dp (int8 requant epilogue),
// generalised to every kernel size, stride and symmetric padding.
//
//   acc[m, oc] = sum_k A[m, k] * w[oc, k]     m = (n, oh, ow), k = (kh, kw, c)
//   y = fma(float(acc), scale[oc], bias[oc]), relu
//   out = y (fp32) | clip(rint(y / out_scale), relu ? 0 : -127, 127) (int8)
//
// Bound: bytes for the 1x1/s2 downsamples, operations for the 3x3 convs
// (see igemm.cuh). Design: the im2col matrix is never written — each block
// gathers its A tile straight from the NHWC input into shared memory with
// zero-filling cp.async (padding costs no branch in the math), keeps the
// int32 sums in registers, and writes the epilogue's result once, int8 when
// the consumer takes int8. The TPU kernel's width-pair packing (pack_w_dual)
// existed to fill 128 MXU lanes at C=64 and has no counterpart here.
#include "igemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int N, H, W, C, OC, KH, KW, stride, pad, OH, OW, Kp;
  long long M;
  int relu, out_int8;
  float out_scale;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(THREADS) conv_int8_kernel(const Args a) {
  __shared__ __align__(16) int8_t As[2 * BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * BN * LDS];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const ConvGeom gm{a.H, a.W, a.C, a.KW, a.KH * a.KW * a.C};

  GatherA<BM> ga;
#pragma unroll
  for (int j = 0; j < GatherA<BM>::CH; ++j) {
    const long long m = m0 + GatherA<BM>::row(j);
    if (m < a.M) {
      const int ow = (int)(m % a.OW);
      const long long r = m / a.OW;
      const int oh = (int)(r % a.OH);
      const int n = (int)(r / a.OH);
      ga.set(j, a.x + (size_t)n * a.H * a.W * a.C, oh * a.stride - a.pad, ow * a.stride - a.pad);
    } else {
      ga.set(j, nullptr, 0, 0);
    }
  }

  MmaTile<BM, BN, WARPS_M, WARPS_N> tile;
  mainloop<decltype(tile), BM, BN>(tile, As, Bs, a.Kp / BK,
                                   [&](int8_t* as, int8_t* bs, int kt) {
                                     if (VEC)
                                       ga.load_vec(as, gm, kt, a.x);
                                     else
                                       ga.load_bytes(as, gm, kt);
                                     load_b<BN>(bs, a.w, a.OC, a.Kp, n0, kt);
                                   });

  const bool relu = a.relu != 0;
  const float lo = relu ? 0.0f : -127.0f;
  tile.for_each([&](int row, int col, int v) {
    const long long m = m0 + row;
    const int oc = n0 + col;
    if (m >= a.M || oc >= a.OC) return;
    const float y = epi_fma(v, a.scale[oc], a.bias[oc], relu);
    const size_t o = (size_t)m * a.OC + oc;
    if (a.out_int8)
      static_cast<int8_t*>(a.out)[o] = requant_div(y, a.out_scale, lo);
    else
      static_cast<float*>(a.out)[o] = y;
  });
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.OC + BN - 1) / BN));
  if (a.C % 16 == 0)
    conv_int8_kernel<BM, BN, WM, WN, true><<<grid, THREADS, 0, stream>>>(a);
  else
    conv_int8_kernel<BM, BN, WM, WN, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dlq_conv_int8(const int8_t* x, const int8_t* w, const float* scale,
                             const float* bias, void* out, int N, int H, int W, int C, int OC,
                             int KH, int KW, int stride, int pad, int Kp, int relu, int out_int8,
                             float out_scale, void* stream) {
  Args a;
  a.x = x;
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.OC = OC;
  a.KH = KH;
  a.KW = KW;
  a.stride = stride;
  a.pad = pad;
  a.OH = (H + 2 * pad - KH) / stride + 1;
  a.OW = (W + 2 * pad - KW) / stride + 1;
  a.Kp = Kp;
  a.M = (long long)N * a.OH * a.OW;
  a.relu = relu;
  a.out_int8 = out_int8;
  a.out_scale = out_scale;
  if (Kp % BK != 0 || Kp < KH * KW * C || a.OH <= 0 || a.OW <= 0) return (int)cudaErrorInvalidValue;
  if (a.M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-wide output-channel tiles for OC = 64 (layer1), 128 otherwise
  cudaError_t e = OC <= 64 ? launch<128, 64, 4, 2>(a, s) : launch<128, 128, 2, 4>(a, s);
  return (int)e;
}
