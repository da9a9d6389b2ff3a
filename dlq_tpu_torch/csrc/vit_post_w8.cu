// K7: the last two thirds of a W8A8 ViT layer: int8 proj + bias + residual,
// LN2, int8 FC1 + bias, GELU, int8 FC2 + bias + residual.
//
// Replaces dlq_tpu/ops/pallas_vit_block.py:vit_block_post_w8 (kernel
// _block_post_kernel_w8, :953-977) and the tail of each layer of
// vit_multiblock_fused_w8 (:490-501) / vit_block_fused_w8 (:351-365):
//   z1  = x + fma(acc_proj, s, b),      acc_proj = quant(attn, inv_proj) @ wproj
//   f   = gelu(fma(acc_fc1, s, b)),     acc_fc1  = quant(LN(z1), inv_fc1) @ wfc1
//   out = z1 + fma(acc_fc2, s, b)       (multi: the stacked kernel, :501)
//       | fma(acc_fc2, s, z1) + b       (the single-block kernels, :364, :976)
//                                       acc_fc2  = quant(f, inv_fc2) @ wfc2
// x: the residual, bf16 or fp32 [M, Dp]; attn: bf16 [M, Dp]; out: bf16 or
// fp32. Weights K-major: wproj [Dp, Dp], wfc1 [Hp, Dp], wfc2 [Dp, Hp].
//
// Bound: at DeiT-Tiny batch 256 (M = 51,200, Dp = 192, Hp = 768) the three
// GEMMs do 2 x (192^2 + 2 x 192 x 768) = 664 K int8 operations per row
// against up to 1,920 bytes in and out per row: ~350 operations per byte,
// under the card's ridge of ~590, so bytes bound it (~0.03 ms per launch).
// Design: one block of 256 threads per 64 rows; nothing between the input
// and the output reaches device memory. The int8 codes of the quantized
// attn and of LN2(z1) (64 x (Dp + 16) bytes), z1 in fp32 (64 x Dp x 4) and
// the int8 codes of gelu(FC1) (64 x (Hp + 16)) stay in shared memory; each
// GEMM streams its weight through shared memory in 64-byte K slices (two
// cp.async stages of igemm.cuh) on mma.sync.m16n8k32, 64 output columns at
// a time. At Dp 192 / Hp 768 that is 120 KB of shared memory, above the
// 48 KB default: the launch opts in and a refused opt-in returns its error.
#include "vit_common.cuh"

namespace {

using namespace dlq;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr float GELU_C = 0.7978845608028654f;    // sqrt(2/pi)
constexpr float SQRT_HALF = 0.7071067811865476f;

struct Args {
  const void* y;
  const __nv_bfloat16* attn;
  float inv_proj, inv_fc1, inv_fc2;
  const int8_t* wproj;
  const float* sproj;
  const float* bproj;
  const float* ln;  // [2, Dp]: LN2 g, b
  const int8_t* wfc1;
  const float* sfc1;
  const float* bfc1;
  const int8_t* wfc2;
  const float* sfc2;
  const float* bfc2;
  void* out;
  int M, Dp, Hp;
  float inv_n;
  int gelu_tanh, multi;
};

// gelu as the reference writes it (pallas_vit_block.py:279-283, jax.nn.gelu):
// tanh: (0.5 f) (1 + tanh(c (f + ((0.044715 f) f) f))); exact: (0.5 f) erfc(-f sqrt(1/2))
__device__ __forceinline__ float gelu(float f, bool tanh_approx) {
  if (tanh_approx) {
    const float f3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, f), f), f);
    const float th = tanhf(__fmul_rn(GELU_C, __fadd_rn(f, f3)));
    return __fmul_rn(__fmul_rn(0.5f, f), __fadd_rn(1.0f, th));
  }
  return __fmul_rn(__fmul_rn(0.5f, f), erfcf(__fmul_rn(-f, SQRT_HALF)));
}

// Visit this thread's accumulator pairs: f(row, col, acc_even, acc_odd) for
// columns col, col + 1.
template <class Tile, class F>
__device__ __forceinline__ void for_pairs(const Tile& tile, F&& f) {
#pragma unroll
  for (int i = 0; i < Tile::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tile::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(tile.warp_m * Tile::WM + i * 16 + tile.g + h * 8,
          tile.warp_n * Tile::WN + j * 8 + tile.t * 2, tile.acc[i][j][2 * h],
          tile.acc[i][j][2 * h + 1]);
}

template <class T, class TO>
__global__ void __launch_bounds__(THREADS) vit_post_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int Dp = a.Dp, Hp = a.Hp;
  const int lda = Dp + 16, ldh = Hp + 16;
  float* Z = reinterpret_cast<float*>(smem);     // [BM][Dp] z1, fp32
  int8_t* As = smem + BM * Dp * 4;               // [BM][lda] codes: attn, then LN2(z1)
  int8_t* Hs = As + BM * lda;                    // [BM][ldh] codes of gelu(FC1)
  int8_t* Bs = Hs + BM * ldh;                    // 2 stages x BN rows x LDS
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, a.M - m0);
  const T* y = static_cast<const T*>(a.y);
  TO* out = static_cast<TO*>(a.out);

  // 1. quantize the attn tile
  for (int e = threadIdx.x; e < BM * Dp; e += THREADS) {
    const int r = e / Dp, c = e - r * Dp;
    As[r * lda + c] = r < rows ? quant_i8(__bfloat162float(a.attn[(size_t)(m0 + r) * Dp + c]),
                                          a.inv_proj)
                               : (int8_t)0;
  }

  // 2. proj: z1 = x + fma(acc, s, b) into Z
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident_a<decltype(tile), BN>(tile, As, lda, Bs, a.wproj, Dp, Dp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      const int n = n0 + c;
      float x0 = 0.0f, x1 = 0.0f;
      if (r < rows) {
        x0 = load_f(y + (size_t)(m0 + r) * Dp + n);
        x1 = load_f(y + (size_t)(m0 + r) * Dp + n + 1);
      }
      Z[r * Dp + n] = __fadd_rn(x0, __fmaf_rn(__int2float_rn(v0), a.sproj[n], a.bproj[n]));
      Z[r * Dp + n + 1] = __fadd_rn(x1, __fmaf_rn(__int2float_rn(v1), a.sproj[n + 1], a.bproj[n + 1]));
    });
  }
  __syncthreads();

  // 3. LN2(z1) -> int8 codes in As (one warp per row)
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += THREADS / 32) {
      float v[ROW_REGS];
#pragma unroll
      for (int j = 0; j < ROW_REGS; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < Dp ? Z[r * Dp + c] : 0.0f;
      }
      ln_quant_row(v, Dp, a.ln, a.ln + Dp, a.inv_n, a.inv_fc1, As + r * lda);
    }
  }

  // 4. FC1 + bias + gelu -> int8 codes in Hs
  const bool tanh_approx = a.gelu_tanh != 0;
  for (int n0 = 0; n0 < Hp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident_a<decltype(tile), BN>(tile, As, lda, Bs, a.wfc1, Hp, Dp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      const int n = n0 + c;
      const float f0 = __fmaf_rn(__int2float_rn(v0), a.sfc1[n], a.bfc1[n]);
      const float f1 = __fmaf_rn(__int2float_rn(v1), a.sfc1[n + 1], a.bfc1[n + 1]);
      Hs[r * ldh + n] = quant_i8(gelu(f0, tanh_approx), a.inv_fc2);
      Hs[r * ldh + n + 1] = quant_i8(gelu(f1, tanh_approx), a.inv_fc2);
    });
  }

  // 5. FC2 + bias + residual -> out
  const bool multi = a.multi != 0;
  for (int n0 = 0; n0 < Dp; n0 += BN) {
    MmaTile<BM, BN, 2, 4> tile;
    mainloop_resident_a<decltype(tile), BN>(tile, Hs, ldh, Bs, a.wfc2, Dp, Hp, n0);
    for_pairs(tile, [&](int r, int c, int v0, int v1) {
      if (r >= rows) return;
      const int n = n0 + c;
      float o[2];
      const int acc[2] = {v0, v1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float z1 = Z[r * Dp + n + u];
        const float av = __int2float_rn(acc[u]);
        o[u] = multi ? __fadd_rn(z1, __fmaf_rn(av, a.sfc2[n + u], a.bfc2[n + u]))
                     : __fadd_rn(__fmaf_rn(av, a.sfc2[n + u], z1), a.bfc2[n + u]);
      }
      TO* dst = out + (size_t)(m0 + r) * Dp + n;
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[0], o[1]);
      }
    });
  }
}

int smem_bytes(int Dp, int Hp) { return BM * Dp * 4 + BM * (Dp + 16) + BM * (Hp + 16) + 2 * BN * LDS; }

template <class T, class TO>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.Dp, a.Hp);
  cudaError_t e = cudaFuncSetAttribute(vit_post_kernel<T, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  vit_post_kernel<T, TO><<<(a.M + BM - 1) / BM, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_out(const Args& a, int out_f32, cudaStream_t stream) {
  return out_f32 ? launch<T, float>(a, stream) : launch<T, __nv_bfloat16>(a, stream);
}

}  // namespace

extern "C" int dlq_vit_post_w8(const void* y, int y_f32, const __nv_bfloat16* attn,
                               float inv_qkv, float inv_proj, float inv_fc1, float inv_fc2,
                               const int8_t* wproj, const float* sproj, const float* bproj,
                               const float* ln, const int8_t* wfc1, const float* sfc1,
                               const float* bfc1, const int8_t* wfc2, const float* sfc2,
                               const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp,
                               int d_valid, int gelu_tanh, int multi, void* stream) {
  (void)inv_qkv;  // K5's; the layer's four inverse scales travel together
  if (Dp <= 0 || Dp % 64 != 0 || Dp > 32 * ROW_REGS || Hp <= 0 || Hp % 64 != 0 ||
      d_valid <= 0 || d_valid > Dp || smem_bytes(Dp, Hp) > 232448)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a{y, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1,
         wfc2, sfc2, bfc2, out, M, Dp, Hp, (float)(1.0 / (double)d_valid), gelu_tanh, multi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_f32 ? launch_out<float>(a, out_f32, st)
                     : launch_out<__nv_bfloat16>(a, out_f32, st));
}
