// K2: int8 GEMM with K1's fused fp32 / int8 epilogue.
//
// Replaces dlq_tpu/ops/pallas_matmul.py:int8_matmul (def :61, its
// pallas_call :98; fp32 out, optional relu) and carries the int8-out
// epilogue of the reference's mm1x1 rewrite (FullFusedCtx.conv on a 1x1/s1
// conv, model_quant.py:403-430):
//   acc = x[M, K] @ w^T (w K-major [N, Kp], int32 accumulation)
//   y = fma(float(acc), scale[n], bias[n]), then relu or relu6 (clip to [0, 6])
//   out = y (fp32) | clip(rint(y / out_scale), act ? 0 : -127, 127) (int8)
//
// Bound: bytes at the ResNet fc (M = batch: every weight byte is used by
// only M rows), at DeiT-Tiny's deploy sites and at most of ResNet-50's 1x1
// body convs (M = N*H*W up to 802,816 rows, K and N 64..2048: 64 to ~1000
// int8 operations per byte, the narrow ones far below the card's ridge of
// ~590); operations at the widest ones (layer4, K and N 512..2048).
//
// Design (Hopper, i8gemm.cuh's body; the first form below serves K % 16 !=
// 0, whose rows of x are not 16-byte aligned, which TMA refuses): a
// persistent grid of at most one block per SM walks (128-row tile, N slice)
// items; thread 0 streams 128 x 64-byte boxes of x and NS x 64-byte boxes of
// the weight by TMA through paired ring stages (or loads the weight's one
// slice once when it fits beside 4 A stages), running ahead across items;
// two consumer warpgroups run int8 wgmma m64nNSk32 on 64 rows each; the
// epilogue stages 8 rows a warp in shared memory, int8 codes (requant by
// the IEEE division's fast path, exact; i8gemm.cuh) written 16 bytes a
// lane, fp32 rows by the bulk-copy engine, while the producer fills the
// next items' stages. Limiters of the first form that this removes: mma.sync on 128 x 128
// block tiles behind two block barriers a 64-byte K step, operands copied
// 16 bytes a thread, one byte a thread a store in the epilogue, and a wave
// of short blocks per launch (6,272 blocks at ResNet-50's layer1).
//
// The first form (K % 16 != 0): the same block-tile tensor-core GEMM as
// K1's first form with a row loader that copies x byte by byte, 128x64
// tiles for N <= 64, 128x128 otherwise; the TPU kernel's sequential K grid
// axis with a VMEM accumulator becomes the in-block K loop with register
// accumulators.
#include "i8gemm.cuh"

namespace {

using namespace dlq;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int M, N, K, Kp;
  int act, out_int8;   // act: ACT_NONE, ACT_RELU or ACT_RELU6 (igemm.cuh)
  float out_scale;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool R6>
__global__ void __launch_bounds__(THREADS) matmul_int8_kernel(const Args a) {
  __shared__ __align__(16) int8_t As[2 * BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * BN * LDS];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  constexpr int CH = BM * (BK / 16) / THREADS;

  auto load = [&](int8_t* as, int8_t* bs, int kt) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int chunk = threadIdx.x + j * THREADS;
      const int r = chunk >> 2, q = chunk & 3;
      const int m = m0 + r;
      const int k = kt * BK + q * 16;
      int8_t* dst = as + r * LDS + q * 16;   // rows of x are not 16-byte aligned: byte loads
      for (int b = 0; b < 16; ++b)
        dst[b] = (m < a.M && k + b < a.K) ? a.x[(size_t)m * a.K + k + b] : (int8_t)0;
    }
    load_b<BN>(bs, a.w, a.N, a.Kp, n0, kt);
  };

  MmaTile<BM, BN, WARPS_M, WARPS_N> tile;
  mainloop<decltype(tile), BM, BN>(tile, As, Bs, a.Kp / BK, load);

  const bool relu = a.act != ACT_NONE;
  const float lo = relu ? 0.0f : -127.0f;
  tile.for_each([&](int row, int col, int v) {
    const int m = m0 + row, n = n0 + col;
    if (m >= a.M || n >= a.N) return;
    const float y = epi_act<R6>(v, a.scale[n], a.bias[n], relu);
    const size_t o = (size_t)m * a.N + n;
    if (a.out_int8)
      static_cast<int8_t*>(a.out)[o] = requant_div(y, a.out_scale, lo);
    else
      static_cast<float*>(a.out)[o] = y;
  });
}

// relu6 takes kernels of its own, so the others compile to the epilogue without it
template <int BM, int BN, int WM, int WN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.N + BN - 1) / BN));
  if (a.act == ACT_RELU6)
    matmul_int8_kernel<BM, BN, WM, WN, true><<<grid, THREADS, 0, stream>>>(a);
  else
    matmul_int8_kernel<BM, BN, WM, WN, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The form a launch takes: 1 the Hopper form, 0 the first form (K % 16 != 0).
extern "C" int dlq_matmul_int8_form(int K) { return K % 16 == 0 ? 1 : 0; }

namespace {
i8::Plan plan(int M, int N, int Kp, int out_int8, int sms) {
  return i8::make_plan((M + i8::BM - 1) / i8::BM, N, Kp, 1, i8::K2_A_STAGE, out_int8 != 0, sms);
}
}  // namespace

// The Hopper form's launch plan: out = {slice width, slices, A stages, B
// stages (0: the weight's slice is resident), shared-memory bytes, blocks}
// for M x N, Kp on `sms` SMs (0: this card's).
extern "C" int dlq_matmul_int8_plan(int M, int N, int Kp, int out_int8, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const i8::Plan p = plan(M, N, Kp, out_int8, sms);
  out[0] = p.ns, out[1] = p.slices, out[2] = p.a_stages, out[3] = p.b_stages, out[4] = p.smem;
  out[5] = p.grid;
  return 0;
}

// x: int8 [M, K] (16-byte aligned rows when K % 16 == 0); w: int8 [N, Kp];
// scale, bias: fp32 [N]; out: fp32 or int8 [M, N]. Kp a multiple of 64, >= K.
// act: 0 none, 1 relu, 2 relu6.
extern "C" int dlq_matmul_int8(const int8_t* x, const int8_t* w, const float* scale,
                               const float* bias, void* out, int M, int N, int K, int Kp,
                               int act, int out_int8, float out_scale, void* stream) {
  if (Kp % BK != 0 || Kp < K || act < ACT_NONE || act > ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dlq_matmul_int8_form(K)) {
    Args f{x, w, scale, bias, out, M, N, K, Kp, act, out_int8, out_scale};
    return (int)(N <= 64 ? launch<128, 64, 4, 2>(f, s) : launch<128, 128, 2, 4>(f, s));
  }
  int dev = 0, sms = 0;
  cudaError_t e = device(&dev, &sms);
  if (e != cudaSuccess) return (int)e;
  const i8::Plan pl = plan(M, N, Kp, out_int8, sms);
  if (pl.ns == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap ta{};
  if ((e = i8::kmajor_map(&ta, x, K, M, i8::BM)) != cudaSuccess) return (int)e;
  i8::Args a{};
  a.scale = scale, a.bias = bias, a.out = out, a.M = M, a.N = N, a.Kp = Kp;
  a.act = act, a.out_int8 = out_int8, a.out_scale = out_scale;
  a.units = (M + i8::BM - 1) / i8::BM, a.cbs = Kp / i8::KS, a.taps = 1;
  a.a_bytes = i8::K2_A_STAGE;
  return (int)i8::launch<false>(a, pl, ta, w, dev, s);
}
