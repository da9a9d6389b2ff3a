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
//
// Design (Hopper; the pieces of i8gemm.cuh: TMA boxes, K1's halo slab and
// its shifted no-swizzle descriptors, K2's rings). A persistent grid of at
// most one block per SM walks items: a strip of TOH full-width output rows
// of one image (TOH x (W + 2) <= 128 sum rows: 2 rows at 56^2, 4 at 28^2, 7
// at 14^2), or, where a whole image's (H + 2) x W and H x (W + 2) rows fit
// 64, two images, one per consumer (7^2). A block is three warpgroups:
//   thread 0      the producer: by TMA, the item's conv1 A stages (two
//                 boxes of 64 rows x 64 channels of x viewed as [N H W, C4],
//                 64-byte swizzle; rows above or below the tensor land as
//                 zeros) into an A ring, and the weights: resident when all
//                 three fit (layer1: 69,632 bytes, loaded once), else
//                 streamed in boxes of NS rows x 64 bytes through a B ring in
//                 the consumers' order, across phases and items.
//   warpgroups 1-2  the consumers, in three phases an item, each an int8
//                 wgmma m64nNSk32 product (sums in registers, one group in
//                 flight, a stage handed back as soon as its product is done):
//     conv1  over the strip's rows and the row above and below, (TOH + 2) x
//            W rows (in passes of 128), A from the ring; its epilogue writes
//            h1's codes into K1's slab layout (16 bytes a pixel, chunk-major,
//            a grid GW = W + 2 wide, columns -1 and W zero since the start),
//            0 for the rows outside the image (the reference's _zero_halo:
//            conv1 of a zero pixel is not 0);
//     conv2  the 3x3 as nine shifted no-swizzle descriptors on that slab
//            (sum row q = row x GW + column; columns W, W + 1 computed and
//            dropped); its epilogue writes h2's codes K-major (the core-
//            matrix layout of sm90.cuh) for this consumer's 64 rows;
//     conv3  over h2 in NS-wide slices of C4; its epilogue stages z's codes
//            per warp, then, 16 bytes a lane, reads the skip x (an L2 hit:
//            conv1 just read it; the loads issued before the codes are
//            computed), adds lut[x] = clip(rint(x rs), -127, 127) from a
//            256-byte table with a saturating byte add and a byte max, and
//            stores out.
//   Requants multiply by the inverse scale as the reference does, and round
//   by adding 1.5 x 2^23 after the clip (the sum's low byte is the code):
//   the same value as rint on [-127, 127]. Where a product's K is at most
//   SMALL_K, float(acc) is taken the same way, off the conversion pipe. A
//   half-tile's codes go to shared memory by st.shared, eight column pairs
//   at a time after their scale and bias loads.
// No intermediate reaches device memory; x is read about (TOH + 2) / TOH
// times from L2 (once from device memory), out written once. What it
// removes of the first form (one 256-thread block per image and 8x8 tile):
// every tile re-reading all three weights (0.87-1.14 GB of L2 reads a
// launch), conv1's 10x10 halo for 64 outputs, 23% of tile waste at 14^2 and
// 7^2, mma.sync behind block barriers, 1-byte output stores. What still
// holds it (PERF.md, Findings): the two consumers run each item's phases in
// lockstep, so every epilogue (conv3's skip and stores most: ~30% of a
// launch) runs while the tensor cores wait; conv1 recomputes the strip's
// halo rows (2.3x at 56^2, TOH 2); at 7^2 each item streams all 4.46 MB of
// weights for two images.
// Shared memory (bytes at batch 256; of the 232,448 allowed): the weights
// or the B ring, the A ring (A stages x 8,192), h1's slab (CM x SPX a slab),
// h2 (128 x CM), the output staging (64 x (NS3 + 16)), the skip's 256-byte
// table, 16 bytes a stage of mbarriers and 16 more:
//   layer1 56^2 256/64:  resident 69,632 + A 4 x 8,192 + h1 15,872 + h2
//                        8,192 + staging 17,408 + 256 + 80 = 144,208
//   layer2 28^2 512/128: B 8 x 16,384 + A 32,768 + h1 24,576 + h2 16,384 +
//                        17,408 + 256 + 208 = 222,672
//   layer3 14^2 1024/256: B 6 x 16,384 + A 32,768 + h1 43,008 + h2 32,768 +
//                        17,408 + 256 + 176 = 224,688
//   layer4 7^2 2048/512: B 6 x 8,192 + A 2 x 8,192 + h1 2 x 45,056 + h2
//                        65,536 + 9,216 + 256 + 144 = 230,800
// (ops/block_fused.py: bottleneck_plan mirrors the plan: the widest slice
// that fits, the most B stages, then the most A stages beside them.) The
// first form (below) serves what the Hopper form's rule leaves out: W > 126
// (a grid wider than 128 sum rows), and CM 512 at W >= 100 (no plan fits).
#include "block_epi.cuh"
#include "i8gemm.cuh"
#include "igemm.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// The first form: one block of 256 threads per (image, 8x8 output tile),
// three mma.sync GEMM stages (the two-stage cp.async loop of igemm.cuh):
// conv1 over the 10x10 haloed tile into shared h1 (zeroed outside the
// image), conv2 into shared h2 [64][CM], conv3 in 128-channel chunks with
// the skip and the add in its epilogue.
// ---------------------------------------------------------------------------
namespace first {

using namespace dlq;

constexpr int TILE = 8;            // output tile edge
constexpr int HALO = TILE + 2;     // conv1 tile edge
constexpr int BN3 = 128;           // conv3 output-channel chunk

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
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = 4 * 128 * LDS + (HALO * HALO + TILE * TILE) * (a.CM + 16);
  const dim3 grid(((a.H + TILE - 1) / TILE) * ((a.W + TILE - 1) / TILE), a.N);
  cudaError_t e = cudaFuncSetAttribute(bottleneck_kernel<BNM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bottleneck_kernel<BNM><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace first

// ---------------------------------------------------------------------------
// The Hopper form
// ---------------------------------------------------------------------------
namespace hop {

namespace sm90 = dlq::sm90;
namespace w4 = dlq::w4;
namespace i8 = dlq::i8;
using namespace dlq::blk;

constexpr int BM = 128;              // sum rows a pass: two consumer warpgroups of 64
constexpr int KS = 64;               // K bytes of a stage
constexpr int A_STAGE = BM * KS;     // two 64-row boxes of x
constexpr int THREADS = 384;         // producer warpgroup + two consumers
constexpr int SMEM_MAX = 232448;
constexpr int MAX_A_STAGES = 4, MIN_A_STAGES = 2, MAX_B_STAGES = 8, MIN_B_STAGES = 3;
constexpr int N_NS = 3;
constexpr int NS_CAND[N_NS] = {256, 128, 64};   // the widest slice first

// The item geometry: grid width, output rows an item, strips an image,
// images an item (2: one per consumer), conv1 rows a region, conv1 passes of
// 128 rows, slab pixels a 16-channel chunk (gw == 0: no geometry).
struct Geo {
  int gw, toh, rb, imgs, m1, passes, spx;
};

// The launch plan: widest slice, conv1/conv2 slice, conv3 slice, A stages,
// B stages (0: the weights are resident), shared-memory bytes, items,
// blocks (nsmax == 0: no plan).
struct Plan {
  int nsmax, ns12, ns3, a_stages, b_stages, smem, items, grid;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline Geo geometry(int H, int W) {
  Geo g{0, 0, 0, 0, 0, 0, 0};
  const int gw = W + 2;
  if (H <= 0 || W <= 0) return g;
  if ((H + 2) * W <= 64 && H * gw <= 64) {
    g.imgs = 2, g.toh = H, g.rb = 1;
  } else {
    const int t0 = BM / gw;
    if (t0 == 0) return g;
    g.imgs = 1, g.rb = cdiv(H, t0), g.toh = cdiv(H, g.rb);
  }
  g.gw = gw;
  g.m1 = (g.toh + 2) * W;
  g.passes = g.imgs == 2 ? 1 : cdiv(g.m1, BM);
  const int rows = g.imgs == 2 ? 64 : BM;            // sum rows a slab serves
  const int need = rows + 2 * gw + 2 > (g.toh + 2) * gw ? rows + 2 * gw + 2 : (g.toh + 2) * gw;
  g.spx = cdiv(need, 8) * 8;
  return g;
}

// Of the slice widths 256, 128, 64 (conv1/conv2 take min(CM, width), conv3
// the width; each must divide its N), the widest whose plan fits: resident
// weights with the most A stages (4 down to 2) that fit, else a B ring of
// max(ns12, ns3) x 64-byte stages with the most A stages (4 down to 2)
// beside at least 3 B stages (at most 8).
inline Plan make_plan(int N, int H, int W, int C4, int CM, int sms) {
  Plan p{0, 0, 0, 0, 0, 0, 0, 0};
  const Geo g = geometry(H, W);
  if (g.gw == 0 || CM <= 0 || CM % 64 || CM > 512 || C4 <= 0 || C4 % 64) return p;
  const int wb = 2 * CM * C4 + 9 * CM * CM;
  for (int i = 0; i < N_NS && p.nsmax == 0; ++i) {
    const int nsmax = NS_CAND[i], ns12 = CM < nsmax ? CM : nsmax, ns3 = nsmax;
    if (CM % ns12 || C4 % ns3 || (ns12 != 64 && ns12 != 128 && ns12 != 256)) continue;
    const int rest = BM * CM + staging_bytes(ns3) + LUT_BYTES;
    const int fixed = g.imgs * CM * g.spx + rest;
    for (int sa = MAX_A_STAGES; sa >= MIN_A_STAGES && p.nsmax == 0; --sa) {
      const int bytes = wb + sa * A_STAGE + fixed + 16 * (sa + 1);
      if (bytes <= SMEM_MAX) p = Plan{nsmax, ns12, ns3, sa, 0, bytes, 0, 0};
    }
    const int bst = (ns12 > ns3 ? ns12 : ns3) * KS;
    for (int sa = MAX_A_STAGES; sa >= MIN_A_STAGES && p.nsmax == 0; --sa) {
      int sb = (SMEM_MAX - fixed - sa * A_STAGE - 16 * (sa + 1)) / (bst + 16);
      sb = sb > MAX_B_STAGES ? MAX_B_STAGES : sb;
      // the most B stages first (the weights stream through them at every
      // phase), then the most A stages beside them
      const int sb2 = (SMEM_MAX - fixed - (sa - 1) * A_STAGE - 16 * sa) / (bst + 16);
      if (sb >= MIN_B_STAGES && (sa == MIN_A_STAGES || sb >= MAX_B_STAGES || sb2 == sb))
        p = Plan{nsmax, ns12, ns3, sa, sb, fixed + sa * A_STAGE + sb * bst + 16 * (sa + sb + 1), 0, 0};
    }
  }
  if (p.nsmax == 0) return p;
  p.items = cdiv(N, g.imgs) * g.rb;
  p.grid = p.items < sms ? p.items : sms;
  return p;
}

struct Hop {
  Geo g;
  Plan p;
};

// The item's first image (imgs 1: its image) and first output row.
__device__ __forceinline__ void origin(const Geo& g, int it, int& img, int& oh0) {
  if (g.imgs == 1) {
    img = it / g.rb;
    oh0 = (it - img * g.rb) * g.toh;
  } else {
    img = 2 * it;
    oh0 = 0;
  }
}

// ---- thread 0: the rings ----
template <int NS12, int NS3>
__device__ __forceinline__ void produce(const Args& a, const Hop& hp, const CUtensorMap& tx,
                                        const CUtensorMap& tw1, const CUtensorMap& tw2,
                                        const CUtensorMap& tw3, uint8_t* wsm, uint8_t* asm_,
                                        uint64_t* afull, uint64_t* aempty, uint64_t* bfull,
                                        uint64_t* bempty, uint64_t* bres) {
  constexpr int B12 = NS12 * KS, B3 = NS3 * KS, BST = (B12 > B3 ? B12 : B3);
  const Geo& g = hp.g;
  const Plan& p = hp.p;
  const int KC1 = a.C4 / KS, CC = a.CM / KS, S12 = a.CM / NS12, S3 = a.C4 / NS3;
  const bool res = p.b_stages == 0;
  if (res) {   // every box of the three weights, in the consumers' order
    w4::mbar_expect_tx(bres, 2 * a.CM * a.C4 + 9 * a.CM * a.CM);
    uint8_t* d = wsm;
    for (int s = 0; s < S12; ++s)
      for (int kc = 0; kc < KC1; ++kc, d += B12) w4::tma_load(d, &tw1, kc * KS, s * NS12, bres);
    for (int s = 0; s < S12; ++s)
      for (int kk = 0; kk < 9 * CC; ++kk, d += B12) w4::tma_load(d, &tw2, kk * KS, s * NS12, bres);
    for (int s = 0; s < S3; ++s)
      for (int cc = 0; cc < CC; ++cc, d += B3) w4::tma_load(d, &tw3, cc * KS, s * NS3, bres);
  }
  int as = 0, aph = 0, bs = 0, bph = 0;
  auto b_stage = [&](const CUtensorMap* tm, int k, int n, int bytes) {
    if (res) return;
    sm90::mbar_wait(bempty + bs, bph ^ 1);
    w4::mbar_expect_tx(bfull + bs, bytes);
    w4::tma_load(wsm + bs * BST, tm, k, n, bfull + bs);
    if (++bs == p.b_stages) bs = 0, bph ^= 1;
  };
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    int img, oh0;
    origin(g, it, img, oh0);
    for (int pass = 0; pass < g.passes; ++pass)
      for (int s = 0; s < S12; ++s)
        for (int kc = 0; kc < KC1; ++kc) {
          sm90::mbar_wait(aempty + as, aph ^ 1);
          w4::mbar_expect_tx(afull + as, A_STAGE);
          for (int b = 0; b < 2; ++b) {
            const int row = g.imgs == 1 ? (img * a.H + oh0 - 1) * a.W + BM * pass + 64 * b
                                        : ((img + b) * a.H - 1) * a.W;
            w4::tma_load(asm_ + as * A_STAGE + b * 64 * KS, &tx, kc * KS, row, afull + as);
          }
          if (++as == p.a_stages) as = 0, aph ^= 1;
          b_stage(&tw1, kc * KS, s * NS12, B12);
        }
    for (int s = 0; s < S12; ++s)
      for (int kk = 0; kk < 9 * CC; ++kk) b_stage(&tw2, kk * KS, s * NS12, B12);
    for (int s = 0; s < S3; ++s)
      for (int cc = 0; cc < CC; ++cc) b_stage(&tw3, cc * KS, s * NS3, B3);
  }
}

// ---- warpgroups 1-2: the three products and their epilogues ----
// The consumers take rows 64 cw .. of each conv1 pass of 128 rows (imgs 2:
// each its image) and of the 128 sum rows of conv2 and conv3, and meet at
// two barriers an item (the slab is whole; it is free again).
template <int NS12, int NS3>
__device__ __forceinline__ void consume(const Args& a, const Hop& hp, const uint8_t* wsm,
                                        const uint8_t* asm_, uint8_t* h1, uint8_t* h2,
                                        uint8_t* staging, int8_t* lut, uint64_t* afull,
                                        uint64_t* aempty,
                                        uint64_t* bfull, uint64_t* bempty, uint64_t* bres) {
  constexpr int B12 = NS12 * KS, B3 = NS3 * KS, BST = (B12 > B3 ? B12 : B3);
  constexpr int SROW = NS3 + 16;   // bytes of a staged output row
  const Geo& g = hp.g;
  const Plan& p = hp.p;
  const int cw = (threadIdx.x >> 7) - 1, ctid = threadIdx.x & 127;
  const int w = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  const int KC1 = a.C4 / KS, CC = a.CM / KS, S12 = a.CM / NS12, S3 = a.C4 / NS3;
  const bool res = p.b_stages == 0;
  const uint8_t* wres1 = wsm;
  const uint8_t* wres2 = wres1 + a.CM * a.C4;
  const uint8_t* wres3 = wres2 + 9 * a.CM * a.CM;
  uint8_t* slab = h1 + (g.imgs == 2 ? cw : 0) * a.CM * g.spx;
  const uint32_t slab_u32 = dlq::smem_u32(slab);
  uint8_t* h2c = h2 + cw * 64 * a.CM;
  uint8_t* wst = staging + (4 * cw + w) * 8 * SROW;
  const uint32_t wst_u32 = dlq::smem_u32(wst), h2_u32 = dlq::smem_u32(h2c);
  const int slab_pitch = g.spx * 16;
  // q / W and q / GW as (q x m) >> 16, m = ceil(2^16 / d): exact while q d <
  // 2^16 (conv1 rows q < 384 with W <= 126, sum rows q < 128 with GW <= 128)
  const uint32_t mw = (65535u + a.W) / a.W, mgw = (65535u + g.gw) / g.gw;
  // the sums of conv1 (K = C4), conv2 (9 CM), conv3 (CM) within +-2^22
  const bool small1 = a.C4 <= SMALL_K, small2 = 9 * a.CM <= SMALL_K, small3 = a.CM <= SMALL_K;
  const int rb0 = g.imgs == 1 ? 64 * cw : 0;   // this consumer's first conv1 / sum row
  auto both = []() { sm90::named_bar(1, 256); };

  // the skip's requant of every int8 value: lut[(uint8_t)x] = clip(rint(x rs), -127, 127)
  skip_lut(lut, threadIdx.x - 128, a.rs);
  // columns -1 and W of every slab row stay zero (the padding of the 3x3)
  for (int i = threadIdx.x - 128; i < g.imgs * (a.CM / 16) * (g.toh + 2) * 2; i += 256) {
    const int e = i & 1, rest = i >> 1, hr = rest % (g.toh + 2), ch = rest / (g.toh + 2);
    *reinterpret_cast<uint4*>(h1 + (size_t)ch * slab_pitch + (hr * g.gw + e * (g.gw - 1)) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  both();
  if (res) sm90::mbar_wait(bres, 0);

  int as = 0, aph = 0, bs = 0, bph = 0, held_a = -1, held_b = -1;
  // One product step: the stages in hand (A for conv1), issue(A, B), keep one
  // group in flight and hand back the stages of the group before. The
  // products are issued on every path, also by a consumer with no rows: a
  // wgmma under a branch makes ptxas serialize every wgmma of the kernel.
  auto step = [&](auto&& issue, bool uses_a, const uint8_t* resident_box) {
    const uint8_t* A = asm_;
    if (uses_a) {
      sm90::mbar_wait(afull + as, aph);
      A = asm_ + as * A_STAGE + cw * 64 * KS;   // this consumer's 64 rows
    }
    const uint8_t* B = resident_box;
    if (!res) {
      sm90::mbar_wait(bfull + bs, bph);
      B = wsm + bs * BST;
    }
    sm90::wgmma_fence();
    issue(A, B);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (ctid == 0) {
      if (held_b >= 0) sm90::mbar_arrive(bempty + held_b);
      if (held_a >= 0) sm90::mbar_arrive(aempty + held_a);
    }
    held_b = res ? -1 : bs;
    held_a = uses_a ? as : -1;
    if (!res && ++bs == p.b_stages) bs = 0, bph ^= 1;
    if (uses_a && ++as == p.a_stages) as = 0, aph ^= 1;
  };
  auto drain = [&]() {
    sm90::wgmma_wait<0>();
    if (ctid == 0) {
      if (held_b >= 0) sm90::mbar_arrive(bempty + held_b);
      if (held_a >= 0) sm90::mbar_arrive(aempty + held_a);
    }
    held_a = held_b = -1;
  };

  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    int img, oh0;
    origin(g, it, img, oh0);
    if (g.imgs == 2) img += cw;
    const bool valid = img < a.N;

    // 1. conv1 over the strip and its halo rows -> h1's codes in the slab
    for (int pass = 0; pass < g.passes; ++pass)
      for (int s = 0; s < S12; ++s) {
        int acc[NS12 / 2];
#pragma unroll
        for (int i = 0; i < NS12 / 2; ++i) acc[i] = 0;
        for (int kc = 0; kc < KC1; ++kc)
          step([&](const uint8_t* A, const uint8_t* B) {
#pragma unroll
                 for (int j = 0; j < 2; ++j)
                   sm90::wgmma_s8<NS12>(acc, w4::desc_sw(A + 32 * j, 8 * KS, 2),
                                        w4::desc_sw(B + 32 * j, 8 * KS, 2));
               },
               true, wres1 + (s * KC1 + kc) * B12);
        drain();
        sm90::fence_acc(acc);
        const int n0 = s * NS12;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q1 = (g.imgs == 1 ? BM * pass : 0) + rb0 + 16 * w + gq + 8 * h;
          if (q1 >= g.m1 || !valid) continue;
          const int hr = (int)(((uint32_t)q1 * mw) >> 16), c = q1 - hr * a.W, ih = oh0 - 1 + hr;
          const bool inside = ih >= 0 && ih < a.H;
          const uint32_t px = slab_u32 + (hr * g.gw + c + 1) * 16 + 2 * t;
          codes<NS12>(acc, h, n0, t, a.s1, a.b1, a.inv_h1, 0.0f, small1, [&](int j, uint32_t v) {
            const int n = n0 + 8 * j;
            sts16(px + (n >> 4) * slab_pitch + (n & 15), inside ? v : 0u);
          });
        }
      }
    sm90::fence_proxy_async();   // the slab's st.shared, to wgmma's reads
    both();

    {
      // 2. conv2: nine shifted descriptors on the slab -> h2's codes (K-major)
      for (int s = 0; s < S12; ++s) {
        int acc[NS12 / 2];
#pragma unroll
        for (int i = 0; i < NS12 / 2; ++i) acc[i] = 0;
        for (int tp = 0; tp < 9; ++tp) {
          const int shift = (tp / 3) * g.gw + tp % 3;
          for (int cc = 0; cc < CC; ++cc)
            step([&](const uint8_t*, const uint8_t* B) {
#pragma unroll
                   for (int j = 0; j < 2; ++j)
                     sm90::wgmma_s8<NS12>(
                         acc,
                         i8::desc_slab(slab_u32 + (4 * cc + 2 * j) * slab_pitch + (rb0 + shift) * 16,
                                       slab_pitch),
                         w4::desc_sw(B + 32 * j, 8 * KS, 2));
                 },
                 false, wres2 + ((s * 9 + tp) * CC + cc) * B12);
        }
        drain();
        sm90::fence_acc(acc);
        const int n0 = s * NS12;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + gq + 8 * h;
          codes<NS12>(acc, h, n0, t, a.s2, a.b2, a.inv_h2, 0.0f, small2, [&](int j, uint32_t v) {
            sts16(h2_u32 + sm90::core_off(r, n0 + 8 * j + 2 * t, a.CM), v);
          });
        }
      }
      sm90::fence_proxy_async();   // h2's st.shared, to wgmma's reads
      both();                      // and both consumers are done reading the slab

      // 3. conv3 over h2 in NS3-wide slices; skip, add, clip, 16-byte stores
      for (int s = 0; s < S3; ++s) {
        int acc[NS3 / 2];
#pragma unroll
        for (int i = 0; i < NS3 / 2; ++i) acc[i] = 0;
        for (int cc = 0; cc < CC; ++cc)
          step([&](const uint8_t*, const uint8_t* B) {
#pragma unroll
                 for (int j = 0; j < 2; ++j)
                   sm90::wgmma_s8<NS3>(acc, sm90::desc(h2c, a.CM, cc * KS + 32 * j),
                                       w4::desc_sw(B + 32 * j, 8 * KS, 2));
               },
               false, wres3 + (s * CC + cc) * B3);
        drain();
        sm90::fence_acc(acc);
        const int n0 = s * NS3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          constexpr int CPR = NS3 / 16;             // 16-byte chunks a staged row
          constexpr int PER = (8 * CPR + 31) / 32;  // chunks a lane
          long long off[PER];
          uint4 xv[PER];
#pragma unroll
          for (int u = 0; u < PER; ++u) {   // the skip's chunks first: in flight during the codes
            const int i = lane + 32 * u, r = i / CPR, c = i - r * CPR;
            const int q = rb0 + 16 * w + 8 * h + r, ohl = (int)(((uint32_t)q * mgw) >> 16);
            const int jc = q - ohl * g.gw;
            off[u] = -1;
            if (i < 8 * CPR && valid && jc < a.W && ohl < g.toh && oh0 + ohl < a.H)
              off[u] = (((long long)img * a.H + oh0 + ohl) * a.W + jc) * a.C4 + n0 + 16 * c;
            if (off[u] >= 0) xv[u] = *reinterpret_cast<const uint4*>(a.x + off[u]);
          }
          const uint32_t row = wst_u32 + gq * SROW + 2 * t;
          codes<NS3>(acc, h, n0, t, a.s3, a.b3, a.inv_nxt, -127.0f, small3,
                     [&](int j, uint32_t v) { sts16(row + 8 * j, v); });
          __syncwarp();
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            if (off[u] < 0) continue;
            const int i = lane + 32 * u, r = i / CPR, c = i - r * CPR;
            const uint4 z = *reinterpret_cast<const uint4*>(wst + r * SROW + 16 * c);
            *reinterpret_cast<uint4*>(a.out + off[u]) = skip_add16(z, xv[u], lut);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int NS12, int NS3>
__global__ void __launch_bounds__(THREADS, 1)
    bottleneck_hopper_kernel(const __grid_constant__ Args a, const Hop hp,
                             const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw1,
                             const __grid_constant__ CUtensorMap tw2,
                             const __grid_constant__ CUtensorMap tw3) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int BST = (NS12 > NS3 ? NS12 : NS3) * KS;
  const Geo& g = hp.g;
  const Plan& p = hp.p;
  const int wbytes = p.b_stages == 0 ? 2 * a.CM * a.C4 + 9 * a.CM * a.CM : p.b_stages * BST;
  uint8_t* wsm = smem;                                  // resident weights, or the B ring
  uint8_t* asm_ = smem + wbytes;                        // the A ring
  uint8_t* h1 = asm_ + p.a_stages * A_STAGE;            // slabs: imgs x [CM / 16][spx][16]
  uint8_t* h2 = h1 + g.imgs * a.CM * g.spx;             // 2 x [64 x CM] (K-major cores)
  uint8_t* staging = h2 + BM * a.CM;                    // 8 warps x 8 rows x (NS3 + 16)
  int8_t* lut = reinterpret_cast<int8_t*>(staging + staging_bytes(NS3));   // 256 bytes
  uint64_t* afull = reinterpret_cast<uint64_t*>(lut + 256);
  uint64_t* aempty = afull + p.a_stages;
  uint64_t* bfull = aempty + p.a_stages;
  uint64_t* bempty = bfull + p.b_stages;
  uint64_t* bres = bempty + p.b_stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.a_stages; ++s) {
      sm90::mbar_init(afull + s, 1);    // the producer's expect_tx
      sm90::mbar_init(aempty + s, 2);   // one thread of each consumer
    }
    for (int s = 0; s < p.b_stages; ++s) {
      sm90::mbar_init(bfull + s, 1);
      sm90::mbar_init(bempty + s, 2);
    }
    sm90::mbar_init(bres, 1);
    sm90::mbar_init_fence();
    if (dlq::smem_u32(smem) & 1023) __trap();   // the swizzled boxes need 1024-byte stage bases
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      produce<NS12, NS3>(a, hp, tx, tw1, tw2, tw3, wsm, asm_, afull, aempty, bfull, bempty, bres);
    return;
  }
  sm90::setmaxnreg_inc<232>();
  consume<NS12, NS3>(a, hp, wsm, asm_, h1, h2, staging, lut, afull, aempty, bfull, bempty, bres);
}

template <int NS12, int NS3>
cudaError_t launch_k(const Args& a, const Hop& hp, const CUtensorMap* maps, int dev,
                     cudaStream_t st) {
  const cudaError_t e = dlq::opt_in<bottleneck_hopper_kernel<NS12, NS3>>(dev);
  if (e != cudaSuccess) return e;
  bottleneck_hopper_kernel<NS12, NS3><<<hp.p.grid, THREADS, hp.p.smem, st>>>(
      a, hp, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, const Hop& hp, int dev, cudaStream_t st) {
  CUtensorMap maps[4]{};
  cudaError_t e;
  if ((e = i8::kmajor_map(&maps[0], a.x, a.C4, a.N * a.H * a.W, 64)) != cudaSuccess) return e;
  if ((e = i8::kmajor_map(&maps[1], a.w1, a.C4, a.CM, hp.p.ns12)) != cudaSuccess) return e;
  if ((e = i8::kmajor_map(&maps[2], a.w2, 9 * a.CM, a.CM, hp.p.ns12)) != cudaSuccess) return e;
  if ((e = i8::kmajor_map(&maps[3], a.w3, a.CM, a.C4, hp.p.ns3)) != cudaSuccess) return e;
  switch (hp.p.ns12 * 1000 + hp.p.ns3) {
    case 64256: return launch_k<64, 256>(a, hp, maps, dev, st);
    case 128256: return launch_k<128, 256>(a, hp, maps, dev, st);
    case 256256: return launch_k<256, 256>(a, hp, maps, dev, st);
    case 64128: return launch_k<64, 128>(a, hp, maps, dev, st);
    case 128128: return launch_k<128, 128>(a, hp, maps, dev, st);
    case 64064: return launch_k<64, 64>(a, hp, maps, dev, st);
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace hop

}  // namespace

// The form a launch takes: 1 the Hopper form, 0 the first form. A static
// shape rule: the item geometry exists (W + 2 <= 128) and a plan fits
// (neither depends on the batch or the card; ops/block_fused.py:
// bottleneck_form).
extern "C" int dlq_bottleneck_block_form(int H, int W, int C4, int CM) {
  return hop::make_plan(1, H, W, C4, CM, 1).nsmax > 0 ? 1 : 0;
}

// The Hopper form's plan and geometry: out = {widest slice, conv1/conv2
// slice, conv3 slice, A stages, B stages (0: resident weights),
// shared-memory bytes, items, blocks, grid width, output rows an item,
// strips an image, images an item, conv1 rows a region, conv1 passes, slab
// pixels a chunk} on `sms` SMs (0: this card's); zeros for the first form.
extern "C" int dlq_bottleneck_block_plan(int N, int H, int W, int C4, int CM, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = dlq::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const hop::Plan p = hop::make_plan(N, H, W, C4, CM, sms);
  hop::Geo g = hop::geometry(H, W);
  if (p.nsmax == 0) g = hop::Geo{0, 0, 0, 0, 0, 0, 0};
  const int v[15] = {p.nsmax, p.ns12, p.ns3, p.a_stages, p.b_stages, p.smem, p.items, p.grid,
                     g.gw, g.toh, g.rb, g.imgs, g.m1, g.passes, g.spx};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

// Weights are K-major [OC, K] with no K padding: w1 [CM, C4], w2 [CM, 9*CM],
// w3 [C4, CM] (C4 and CM multiples of 64, CM <= 512); x, out, w1-w3 16-byte
// aligned, s1-s3 and b1-b3 8-byte aligned.
extern "C" int dlq_bottleneck_block(const int8_t* x, const int8_t* w1, const float* s1,
                                    const float* b1, const int8_t* w2, const float* s2,
                                    const float* b2, const int8_t* w3, const float* s3,
                                    const float* b3, int8_t* out, int N, int H, int W, int C4,
                                    int CM, float inv_h1, float inv_h2, float inv_nxt, float rs,
                                    void* stream) {
  if (CM <= 0 || CM % 64 != 0 || CM > 512 || C4 <= 0 || C4 % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return 0;
  const Args a{x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, N, H, W, C4, CM, inv_h1, inv_h2, inv_nxt, rs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dlq_bottleneck_block_form(H, W, C4, CM))
    return (int)(CM % 128 == 0 ? first::launch<128>(a, st) : first::launch<64>(a, st));
  int dev = 0, sms = 0;
  const cudaError_t e = dlq::device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const hop::Hop hp{hop::geometry(H, W), hop::make_plan(N, H, W, C4, CM, sms)};
  return (int)hop::launch(a, hp, dev, st);
}
