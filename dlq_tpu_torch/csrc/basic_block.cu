// K3: one identity ResNet BasicBlock, int8 NHWC in -> int8 NHWC out.
//
// Replaces dlq_tpu/ops/pallas_block.py:basic_block_fused, with its
// formulas (pallas_block.py:125-150):
//   h   = clip(rint(fma(acc1, s1, b1) * inv_mid), 0, 127), zero outside the image
//   z   = clip(rint(fma(acc2, s2, b2) * inv_nxt), -127, 127)
//   r   = clip(rint(x * rs), -127, 127)
//   out = clip(z + r, 0, 127)
//
// Bound: at ResNet-18's packed blocks (28^2 x 128, 14^2 x 256) the two 3x3
// convs do ~1000-2000 int8 operations per byte of block input and output,
// so operations bound it. Design: one block of 256 threads per (image, 8x8
// output tile). Conv1 runs on the tensor cores over the 10x10 haloed tile
// (gathered from the input like K1) and its int8 result h stays in shared
// memory, zeroed where the halo leaves the image; conv2 reads its A tiles
// from that shared h, and the requantized skip and the add+relu happen in
// conv2's epilogue. h never touches device memory: the block reads x once
// (plus its halo) and writes out once. The price is recomputing conv1 on
// the halo ring (100 vs 64 pixels). Output channels go in chunks of 128.
#include "igemm.cuh"

namespace {

using namespace dlq;

constexpr int TILE = 8;            // output tile edge
constexpr int HALO = TILE + 2;     // conv1 tile edge
constexpr int BN = 128;            // output-channel chunk

struct Args {
  const int8_t* x;
  const int8_t* w1;
  const float* s1;
  const float* b1;
  const int8_t* w2;
  const float* s2;
  const float* b2;
  int8_t* out;
  int N, H, W, C, Kp;
  float inv_mid, inv_nxt, rs;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS) basic_block_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                       // 2 stages x 128 rows
  int8_t* Bs = As + 2 * 128 * LDS;         // 2 stages x BN rows
  int8_t* Hs = Bs + 2 * BN * LDS;          // [HALO*HALO][C + 16]
  const int HS = a.C + 16;

  const int tiles_x = (a.W + TILE - 1) / TILE;
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const int n = blockIdx.y;
  const int8_t* ximg = a.x + (size_t)n * a.H * a.W * a.C;
  const int KT = a.Kp / BK;

  // ---- conv1 over the haloed tile -> h (shared memory) ----
  {
    const ConvGeom gm{a.H, a.W, a.C, 3, 9 * a.C};
    GatherA<128> ga;
#pragma unroll
    for (int j = 0; j < GatherA<128>::CH; ++j) {
      const int r = GatherA<128>::row(j);
      if (r < HALO * HALO) {
        const int hy = oy0 - 1 + r / HALO, hx = ox0 - 1 + r % HALO;
        ga.set(j, ximg, hy - 1, hx - 1);
      } else {
        ga.set(j, nullptr, 0, 0);
      }
    }
    for (int n0 = 0; n0 < a.C; n0 += BN) {
      MmaTile<128, BN, 2, 4> tile;
      mainloop<decltype(tile), 128, BN>(tile, As, Bs, KT, [&](int8_t* as, int8_t* bs, int kt) {
        ga.load_vec(as, gm, kt, a.x);
        load_b<BN>(bs, a.w1, a.C, a.Kp, n0, kt);
      });
      tile.for_each([&](int row, int col, int v) {
        const int oc = n0 + col;
        if (row >= HALO * HALO || oc >= a.C) return;
        const int hy = oy0 - 1 + row / HALO, hx = ox0 - 1 + row % HALO;
        int8_t h = 0;
        if (hy >= 0 && hy < a.H && hx >= 0 && hx < a.W) {
          const float y = __fmul_rn(__fmaf_rn(__int2float_rn(v), a.s1[oc], a.b1[oc]), a.inv_mid);
          h = static_cast<int8_t>(clampf(rintf(y), 0.0f, 127.0f));
        }
        Hs[row * HS + oc] = h;
      });
    }
  }
  __syncthreads();

  // ---- conv2 over the 8x8 tile from h, skip, add, relu ----
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;  // this thread's A chunk
  const int ti = r / TILE, tj = r % TILE;
  for (int n0 = 0; n0 < a.C; n0 += BN) {
    MmaTile<TILE * TILE, BN, 2, 4> tile;
    mainloop<decltype(tile), TILE * TILE, BN>(tile, As, Bs, KT, [&](int8_t* as, int8_t* bs, int kt) {
      const int k = kt * BK + q * 16;
      const int tap = k / a.C, c = k - tap * a.C;
      const int kh = tap / 3, kw = tap - kh * 3;
      *reinterpret_cast<int4*>(as + r * LDS + q * 16) =
          *reinterpret_cast<const int4*>(Hs + ((ti + kh) * HALO + (tj + kw)) * HS + c);
      load_b<BN>(bs, a.w2, a.C, a.Kp, n0, kt);
    });
    tile.for_each([&](int row, int col, int v) {
      const int oc = n0 + col;
      const int oy = oy0 + row / TILE, ox = ox0 + row % TILE;
      if (oc >= a.C || oy >= a.H || ox >= a.W) return;
      const float y = __fmul_rn(__fmaf_rn(__int2float_rn(v), a.s2[oc], a.b2[oc]), a.inv_nxt);
      const float z = clampf(rintf(y), -127.0f, 127.0f);
      const size_t o = ((size_t)oy * a.W + ox) * a.C + oc;
      const float xr = clampf(rintf(__fmul_rn((float)ximg[o], a.rs)), -127.0f, 127.0f);
      a.out[(size_t)n * a.H * a.W * a.C + o] = static_cast<int8_t>(clampf(z + xr, 0.0f, 127.0f));
    });
  }
}

}  // namespace

extern "C" int dlq_basic_block(const int8_t* x, const int8_t* w1, const float* s1,
                               const float* b1, const int8_t* w2, const float* s2,
                               const float* b2, int8_t* out, int N, int H, int W, int C, int Kp,
                               float inv_mid, float inv_nxt, float rs, void* stream) {
  if (C % 64 != 0 || C > 512 || Kp != 9 * C) return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return 0;
  Args a{x, w1, s1, b1, w2, s2, b2, out, N, H, W, C, Kp, inv_mid, inv_nxt, rs};
  const int smem = 2 * 128 * LDS + 2 * BN * LDS + HALO * HALO * (C + 16);
  cudaError_t e = cudaFuncSetAttribute(basic_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  basic_block_kernel<<<dim3(tiles, N), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
