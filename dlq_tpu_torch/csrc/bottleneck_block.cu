// K4: one identity ResNet Bottleneck, int8 NHWC in -> int8 NHWC out.
//
// Replaces dlq_tpu/ops/pallas_block.py:bottleneck_block_fused, with its
// formulas (pallas_block.py:207-238): conv1 1x1 (C4 -> CM), conv2 3x3
// (CM -> CM), conv3 1x1 (CM -> C4), int32 sums acc1..3,
//   h1  = clip(rint(fma(acc1, s1, b1) * inv_h1), 0, 127), zero outside the image
//   h2  = clip(rint(fma(acc2, s2, b2) * inv_h2), 0, 127)
//   z   = clip(rint(fma(acc3, s3, b3) * inv_nxt), -127, 127)
//   r   = clip(rint(x * rs), -127, 127)
//   out = clip(z + r, 0, 127)
//
// Bound: at ResNet-50's identity blocks (batch 256) the three convs do ~270
// (layer1, 56^2 x 256/64), ~540 (layer2), ~1090 (layer3) and ~2000 (layer4,
// 7^2 x 2048/512) int8 operations per byte of block input, output and
// weights, against the card's ridge of ~590: bytes bound layer1, operations
// the deeper stages.
// Design: one block of 256 threads per (image, 8x8 output tile), three
// tensor-core GEMM stages (mma.sync.m16n8k32, the two-stage cp.async loop
// of igemm.cuh), one accumulator set live at a time:
//   1. conv1 over the 10x10 haloed tile (100 of 128 GEMM rows), A gathered
//      straight from x with zero-filling cp.async; h1 goes to shared memory,
//      zeroed where the halo leaves the image (the reference's _zero_halo:
//      there conv1 of a zero input is relu-requant of the bias, not 0, so
//      the 3x3 would otherwise see nonzero padding);
//   2. conv2 from h1 into h2 [64][CM], also in shared memory;
//   3. conv3 from h2 in 128-channel chunks of C4, with the skip requant and
//      the add+relu in its epilogue.
// Neither intermediate reaches device memory: the block reads x (plus its
// halo) and the weights, and writes out once. h1 + h2 take 164 x (CM + 16)
// bytes, 86.6 KB at CM = 512, so the kernel opts into more than the 48 KB
// default of dynamic shared memory; a refused opt-in or launch returns its
// error. An 8x8 tile over the 7x7 stage masks its output and skip reads.
#include "igemm.cuh"

namespace {

using namespace dlq;

constexpr int TILE = 8;            // output tile edge
constexpr int HALO = TILE + 2;     // conv1 tile edge
constexpr int BN3 = 128;           // conv3 output-channel chunk

struct Args {
  const int8_t* x;
  const int8_t* w1;
  const float* s1;
  const float* b1;
  const int8_t* w2;
  const float* s2;
  const float* b2;
  const int8_t* w3;
  const float* s3;
  const float* b3;
  int8_t* out;
  int N, H, W, C4, CM;
  float inv_h1, inv_h2, inv_nxt, rs;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The block epilogue: clip(rint(fma(acc, s, b) * inv), lo, 127) — the
// multiply-add contracted as XLA does, then the inverse-scale multiply.
__device__ __forceinline__ float requant_inv(int acc, float s, float b, float inv, float lo) {
  return clampf(rintf(__fmul_rn(__fmaf_rn(__int2float_rn(acc), s, b), inv)), lo, 127.0f);
}

// BNM: the mid-channel chunk of conv1 and conv2 (64 when CM is not a
// multiple of 128, as at ResNet-50's layer1 with CM = 64).
template <int BNM>
__global__ void __launch_bounds__(THREADS) bottleneck_kernel(const Args a) {
  constexpr int W1M = BNM == 64 ? 4 : 2;  // warps along M of the 128-row conv1 tile
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                       // 2 stages x 128 rows
  int8_t* Bs = As + 2 * 128 * LDS;         // 2 stages x 128 rows
  const int HS = a.CM + 16;                // padded row of h1 and h2
  int8_t* H1 = Bs + 2 * 128 * LDS;         // [HALO*HALO][HS]
  int8_t* H2 = H1 + HALO * HALO * HS;      // [TILE*TILE][HS]

  const int tiles_x = (a.W + TILE - 1) / TILE;
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const size_t img = (size_t)blockIdx.y * a.H * a.W * a.C4;
  const int8_t* ximg = a.x + img;

  // ---- conv1 (1x1) over the haloed tile -> h1 ----
  {
    const ConvGeom gm{a.H, a.W, a.C4, 1, a.C4};
    GatherA<128> ga;
#pragma unroll
    for (int j = 0; j < GatherA<128>::CH; ++j) {
      const int r = GatherA<128>::row(j);
      if (r < HALO * HALO)
        ga.set(j, ximg, oy0 - 1 + r / HALO, ox0 - 1 + r % HALO);
      else
        ga.set(j, nullptr, 0, 0);
    }
    for (int n0 = 0; n0 < a.CM; n0 += BNM) {
      MmaTile<128, BNM, W1M, 8 / W1M> tile;
      mainloop<decltype(tile), 128, BNM>(tile, As, Bs, a.C4 / BK, [&](int8_t* as, int8_t* bs, int kt) {
        ga.load_vec(as, gm, kt, a.x);
        load_b<BNM>(bs, a.w1, a.CM, a.C4, n0, kt);
      });
      tile.for_each([&](int row, int col, int v) {
        const int oc = n0 + col;
        if (row >= HALO * HALO || oc >= a.CM) return;
        const int hy = oy0 - 1 + row / HALO, hx = ox0 - 1 + row % HALO;
        int8_t h = 0;
        if (hy >= 0 && hy < a.H && hx >= 0 && hx < a.W)
          h = static_cast<int8_t>(requant_inv(v, a.s1[oc], a.b1[oc], a.inv_h1, 0.0f));
        H1[row * HS + oc] = h;
      });
    }
  }
  __syncthreads();

  // this thread's 16-byte A chunk of the 64-row conv2 / conv3 tiles
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int ti = r / TILE, tj = r % TILE;

  // ---- conv2 (3x3) from h1 -> h2 ----
  for (int n0 = 0; n0 < a.CM; n0 += BNM) {
    MmaTile<TILE * TILE, BNM, 2, 4> tile;
    mainloop<decltype(tile), TILE * TILE, BNM>(tile, As, Bs, 9 * a.CM / BK, [&](int8_t* as, int8_t* bs, int kt) {
      const int k = kt * BK + q * 16;
      const int tap = k / a.CM, c = k - tap * a.CM;
      const int kh = tap / 3, kw = tap - kh * 3;
      *reinterpret_cast<int4*>(as + r * LDS + q * 16) =
          *reinterpret_cast<const int4*>(H1 + ((ti + kh) * HALO + (tj + kw)) * HS + c);
      load_b<BNM>(bs, a.w2, a.CM, 9 * a.CM, n0, kt);
    });
    tile.for_each([&](int row, int col, int v) {
      const int oc = n0 + col;
      if (oc < a.CM)
        H2[row * HS + oc] = static_cast<int8_t>(requant_inv(v, a.s2[oc], a.b2[oc], a.inv_h2, 0.0f));
    });
  }
  __syncthreads();

  // ---- conv3 (1x1) from h2, skip, add, relu ----
  for (int n0 = 0; n0 < a.C4; n0 += BN3) {
    MmaTile<TILE * TILE, BN3, 2, 4> tile;
    mainloop<decltype(tile), TILE * TILE, BN3>(tile, As, Bs, a.CM / BK, [&](int8_t* as, int8_t* bs, int kt) {
      *reinterpret_cast<int4*>(as + r * LDS + q * 16) =
          *reinterpret_cast<const int4*>(H2 + r * HS + kt * BK + q * 16);
      load_b<BN3>(bs, a.w3, a.C4, a.CM, n0, kt);
    });
    tile.for_each([&](int row, int col, int v) {
      const int oc = n0 + col;
      const int oy = oy0 + row / TILE, ox = ox0 + row % TILE;
      if (oc >= a.C4 || oy >= a.H || ox >= a.W) return;
      const float z = requant_inv(v, a.s3[oc], a.b3[oc], a.inv_nxt, -127.0f);
      const size_t o = ((size_t)oy * a.W + ox) * a.C4 + oc;
      const float xr = clampf(rintf(__fmul_rn((float)ximg[o], a.rs)), -127.0f, 127.0f);
      a.out[img + o] = static_cast<int8_t>(clampf(z + xr, 0.0f, 127.0f));
    });
  }
}

template <int BNM>
cudaError_t launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(bottleneck_kernel<BNM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bottleneck_kernel<BNM><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Weights are K-major [OC, K] with no K padding: w1 [CM, C4], w2 [CM, 9*CM],
// w3 [C4, CM] (C4 and CM multiples of 64).
extern "C" int dlq_bottleneck_block(const int8_t* x, const int8_t* w1, const float* s1,
                                    const float* b1, const int8_t* w2, const float* s2,
                                    const float* b2, const int8_t* w3, const float* s3,
                                    const float* b3, int8_t* out, int N, int H, int W, int C4,
                                    int CM, float inv_h1, float inv_h2, float inv_nxt, float rs,
                                    void* stream) {
  if (CM <= 0 || CM % 64 != 0 || CM > 512 || C4 <= 0 || C4 % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return 0;
  Args a{x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, N, H, W, C4, CM, inv_h1, inv_h2, inv_nxt, rs};
  const int smem = 4 * 128 * LDS + (HALO * HALO + TILE * TILE) * (CM + 16);
  const dim3 grid(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(CM % 128 == 0 ? launch<128>(a, grid, smem, s) : launch<64>(a, grid, smem, s));
}
