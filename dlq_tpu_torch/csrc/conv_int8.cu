// K1: int8 implicit-GEMM convolution with a fused fp32 / int8 epilogue.
//
// Replaces dlq_tpu/ops/pallas_conv.py:int8_conv3x3_s1 (def :143, its
// pallas_call :180; fp32 epilogue), int8_conv3x3_s1_dp (:317 / :366; int8
// requant epilogue) and int8_conv3x3_s1_dp2 (:472 / :510; the same function
// with width-pair packing), generalised to every kernel size, stride and
// symmetric padding.
//
//   acc[m, oc] = sum_k A[m, k] * w[oc, k]     m = (n, oh, ow), k = (kh, kw, c)
//   y = fma(float(acc), scale[oc], bias[oc]), then relu or relu6 (clip to [0, 6])
//   out = y (fp32) | clip(rint(y / out_scale), act ? 0 : -127, 127) (int8)
//
// Bound: operations at ResNet's 3x3 convs from 28^2 x 128 on (7^2 x 512:
// ~2,300 int8 operations per byte), near the card's ridge of ~590 at 56^2 x
// 64 (bytes by a little), bytes at the 1x1/s2 downsamples.
//
// Design (Hopper, i8gemm.cuh's body with CONV; the reference's own answer,
// one halo slab per item and nine shifted products, mapped onto TMA and
// wgmma): per item thread 0 loads the slab of TOH output rows (or of two
// small images, one per consumer) for 64 input channels at a time by 4-D
// TMA boxes, 16 channels a box, whose out-of-bounds pixels are the padding;
// the nine taps are the same no-swizzle wgmma descriptor moved along the
// slab, so each input byte is read from L2 once per item and slice, not
// nine times; stride 2 takes four phase planes (TMA element strides 2). The
// weight [OC, Kp] streams by 64-byte TMA boxes per tap, or stays resident
// when its one slice fits beside 4 A stages (OC 64 and 128); two consumer
// warpgroups of 64 sum rows; the epilogue writes only valid rows and
// columns, int8 rows staged and written 16 bytes a lane. Limiters of the first form
// that this removes: A gathered 16 bytes a thread per K stage (each input
// byte read nine times at a 3x3/s1 conv), mma.sync behind two block
// barriers a stage, one-byte stores, short blocks.
//
// The first form (C % 64 != 0, as the C=3 stems, or a kernel other than
// 1x1 / 3x3 with pad k / 2 at stride 1 or 2): each block gathers its A tile
// straight from the NHWC input into shared memory with zero-filling cp.async
// (igemm.cuh: GatherA), keeps the int32 sums in registers on mma.sync and
// writes the epilogue's result once. The TPU kernel's width-pair packing
// (pack_w_dual) existed to fill 128 MXU lanes at C=64 and has no
// counterpart here.
#include "i8gemm.cuh"

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
  int act, out_int8;   // act: ACT_NONE, ACT_RELU or ACT_RELU6 (igemm.cuh)
  float out_scale;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC, bool R6>
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

  const bool relu = a.act != ACT_NONE;
  const float lo = relu ? 0.0f : -127.0f;
  tile.for_each([&](int row, int col, int v) {
    const long long m = m0 + row;
    const int oc = n0 + col;
    if (m >= a.M || oc >= a.OC) return;
    const float y = epi_act<R6>(v, a.scale[oc], a.bias[oc], relu);
    const size_t o = (size_t)m * a.OC + oc;
    if (a.out_int8)
      static_cast<int8_t*>(a.out)[o] = requant_div(y, a.out_scale, lo);
    else
      static_cast<float*>(a.out)[o] = y;
  });
}

template <int BM, int BN, int WM, int WN, bool R6>
cudaError_t launch_act(const Args& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.OC + BN - 1) / BN));
  if (a.C % 16 == 0)
    conv_int8_kernel<BM, BN, WM, WN, true, R6><<<grid, THREADS, 0, stream>>>(a);
  else
    conv_int8_kernel<BM, BN, WM, WN, false, R6><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// relu6 takes kernels of its own, so the others compile to the epilogue without it
template <int BM, int BN, int WM, int WN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.act == ACT_RELU6 ? launch_act<BM, BN, WM, WN, true>(a, stream)
                            : launch_act<BM, BN, WM, WN, false>(a, stream);
}

}  // namespace

namespace {

// The Hopper form's geometry and plan of a conv (gw == 0 or ns == 0: the first form).
struct Hopper {
  i8::ConvGeo g;
  i8::Plan p;
};

Hopper hopper(int N, int H, int W, int C, int OC, int KH, int KW, int stride, int pad,
              int out_int8, int sms) {
  Hopper h{i8::conv_geo(H, W, C, KH, KW, stride, pad), {0, 0, 0, 0, 0, 0}};
  if (h.g.gw == 0) return h;
  const int units = (N + h.g.imgs - 1) / h.g.imgs * h.g.rb;
  h.p = i8::make_plan(units, OC, KH * KW * C, KH * KW, i8::conv_a_bytes(h.g), out_int8 != 0, sms);
  return h;
}

}  // namespace

// The form a launch takes: 1 the Hopper form, 0 the first form. A static
// shape rule: the slab geometry exists and a plan fits (neither depends on
// the batch or the card).
extern "C" int dlq_conv_int8_form(int H, int W, int C, int OC, int KH, int KW, int stride,
                                  int pad, int out_int8) {
  return hopper(1, H, W, C, OC, KH, KW, stride, pad, out_int8, 1).p.ns > 0 ? 1 : 0;
}

// The Hopper form's plan and slab geometry: out = {slice width, slices, A
// stages, B stages (0: resident slice), shared-memory bytes, blocks, grid
// width, output rows an item, row blocks an image, images an item, slab
// pixels a chunk, planes} on `sms` SMs (0: this card's); zeros for the first form.
extern "C" int dlq_conv_int8_plan(int N, int H, int W, int C, int OC, int KH, int KW, int stride,
                                  int pad, int out_int8, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  Hopper h = hopper(N, H, W, C, OC, KH, KW, stride, pad, out_int8, sms);
  if (h.p.ns == 0) h.g = i8::ConvGeo{0, 0, 0, 0, 0, 0};
  const int v[12] = {h.p.ns, h.p.slices, h.p.a_stages, h.p.b_stages, h.p.smem, h.p.grid,
                     h.g.gw, h.g.toh, h.g.rb, h.g.imgs, h.g.spx, h.g.planes};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// x: int8 NHWC [N, H, W, C] (16-byte aligned); w: int8 [OC, Kp], K = (kh,
// kw, c); scale, bias: fp32 [OC]; out: fp32 or int8 NHWC [N, OH, OW, OC];
// act: 0 none, 1 relu, 2 relu6.
extern "C" int dlq_conv_int8(const int8_t* x, const int8_t* w, const float* scale,
                             const float* bias, void* out, int N, int H, int W, int C, int OC,
                             int KH, int KW, int stride, int pad, int Kp, int act, int out_int8,
                             float out_scale, void* stream) {
  if (act < ACT_NONE || act > ACT_RELU6) return (int)cudaErrorInvalidValue;
  const int OH = (H + 2 * pad - KH) / stride + 1, OW = (W + 2 * pad - KW) / stride + 1;
  if (Kp % BK != 0 || Kp < KH * KW * C || OH <= 0 || OW <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || OC == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dlq_conv_int8_form(H, W, C, OC, KH, KW, stride, pad, out_int8)) {
    Args a;
    a.x = x, a.w = w, a.scale = scale, a.bias = bias, a.out = out;
    a.N = N, a.H = H, a.W = W, a.C = C, a.OC = OC, a.KH = KH, a.KW = KW;
    a.stride = stride, a.pad = pad, a.OH = OH, a.OW = OW, a.Kp = Kp;
    a.M = (long long)N * OH * OW;
    a.act = act, a.out_int8 = out_int8, a.out_scale = out_scale;
    // 64-wide output-channel tiles for OC = 64 (layer1), 128 otherwise
    return (int)(OC <= 64 ? launch<128, 64, 4, 2>(a, s) : launch<128, 128, 2, 4>(a, s));
  }
  int dev = 0, sms = 0;
  cudaError_t e = device(&dev, &sms);
  if (e != cudaSuccess) return (int)e;
  const Hopper h = hopper(N, H, W, C, OC, KH, KW, stride, pad, out_int8, sms);
  if (h.p.ns == 0 || Kp != KH * KW * C) return (int)cudaErrorInvalidConfiguration;
  const int e_rows = (KH - 1) / stride;   // halo rows and columns of a plane
  CUtensorMap ta{};
  if ((e = i8::slab_map(&ta, x, N, H, W, C, stride, h.g.gw, h.g.toh + e_rows)) != cudaSuccess)
    return (int)e;
  i8::Args a{};
  a.scale = scale, a.bias = bias, a.out = out, a.M = 0, a.N = OC, a.Kp = Kp;
  a.act = act, a.out_int8 = out_int8, a.out_scale = out_scale;
  a.units = (N + h.g.imgs - 1) / h.g.imgs * h.g.rb, a.cbs = C / 64, a.taps = KH * KW;
  a.a_bytes = i8::conv_a_bytes(h.g);
  a.nimg = N, a.oh = OH, a.ow = OW, a.gw = h.g.gw, a.toh = h.g.toh, a.rb = h.g.rb;
  a.imgs = h.g.imgs, a.spx = h.g.spx, a.planes = h.g.planes, a.stride = stride, a.pad = pad;
  a.box_bytes = h.g.gw * (h.g.toh + e_rows) * 16;
  for (int t = 0; t < KH * KW; ++t) {   // ops/i8plan.py: conv_taps
    const int kh = t / KW, kw = t - kh * KW;
    const int plane = h.g.planes == 4 ? (kh % 2) * 2 + kw % 2 : 0;
    const int shift = (kh / stride) * h.g.gw + kw / stride;
    a.tap_off[t] = (plane * 4 * h.g.spx + shift) * 16;
    a.tap_k[t] = t * C;
  }
  return (int)i8::launch<true>(a, h.p, ta, w, dev, s);
}
