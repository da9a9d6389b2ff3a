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
// so operations bound it (0.060 ms a launch at batch 256 at either shape).
//
// Two forms, picked by a static shape rule (dlq_basic_block_form;
// ops/block_fused.py: basic_block_form mirrors it).
//
// The Hopper form (namespace hop; K4's Hopper body with a 3x3 conv1 and no
// conv3, on the pieces of i8gemm.cuh and block_epi.cuh). A persistent grid
// of at most one block per SM walks items: a strip of TOH full-width output
// rows of one image, the most rows whose conv1 sums fit four 64-row tiles
// ((TOH + 2) x (W + 2) <= 256: TOH 6 at 28^2, a whole image at 14^2 and
// 7^2). Both convs sum on the slab grid GW = W + 2 (sum row q = row x GW +
// column; columns W and W + 1 computed and dropped), each consumer
// warpgroup over MT contiguous 64-row tiles, MT = 2 or 1 (conv1 (TOH + 2) x
// GW rows, conv2 TOH x GW). A block is three warpgroups:
//   thread 0      the B ring: w1's, then w2's boxes of NS rows x 64 bytes
//                 (64-byte swizzle) in the consumers' order (slice, tap,
//                 64-channel chunk), across convs and items;
//   thread 32     the x slab: the item's input rows oh0 - 2 .. oh0 + TOH + 1,
//                 columns -1 .. W, as C / 16 4-D TMA boxes of 16 channels
//                 (K1's slab layout; pixels outside the image land as
//                 zeros: the padding), loaded as soon as both consumers are
//                 done with the previous item's conv1;
//   warpgroups 1-2  the consumers, per item:
//     conv1  nine shifted no-swizzle descriptors on the x slab (int8 wgmma
//            m64nNSk32, sums in registers, one group in flight); its
//            epilogue writes h's codes into the h slab (same layout, GW
//            wide, columns -1 and W zero since the start) for the strip's
//            rows and the row above and below, 0 for rows outside the image
//            (the reference's zeroed halo);
//     conv2  the same nine descriptors on the h slab; its epilogue stages
//            z's codes per warp, then, 16 bytes a lane, reads the skip x
//            (an L2 hit: the slab's TMA just read it), adds lut[x] from a
//            256-byte table with a saturating byte add and a byte max, and
//            stores out.
//   The consumers meet twice an item: h is whole (conv2 may read it), and
//   conv2's sums are done (the next item's conv1 epilogue may write it).
// Neither h nor the sums reach device memory; each item reads both weights
// once from L2 (1.47 MB an image at 28^2 x 128, 2.36 MB at 14^2 x 256).
// Each epilogue keeps the first form's formula: fma, the inverse-scale
// multiply, the clip, rint (by 1.5 x 2^23 after the clip: the same value),
// so the two forms agree on every output.
// Shared memory (bytes; of the 232,448 allowed): the B ring (NS x 64 a
// stage, 3 to 8), the x and h slabs (C x SPX1 and C x SPX2), the output
// staging (64 x (NS + 16)), the skip's table, 16 bytes of mbarriers a B
// stage and 16 more:
//   28^2 x 128 (TOH 6, NS 128):  8 x 8,192 + 40,960 + 40,960 + 9,216 + 256 + 144 = 157,072
//   14^2 x 256 (TOH 14, NS 128): 8 x 8,192 + 75,776 + 75,776 + 9,216 + 256 + 144 = 226,704
//   7^2 x 512 (TOH 7, NS 128):   8 x 8,192 + 77,824 + 77,824 + 9,216 + 256 + 144 = 230,800
// The first form serves the rest: C not a multiple of 128, W + 2 > 85 (no
// item of four tiles), or no plan that fits.
//
// The first form (namespace first): one block of 256 threads per (image,
// 8x8 output tile). Conv1 runs on the tensor cores (mma.sync) over the 10x10
// haloed tile (gathered from the input like K1) and its int8 result h stays
// in shared memory, zeroed where the halo leaves the image; conv2 reads its
// A tiles from that shared h, and the requantized skip and the add+relu
// happen in conv2's epilogue. Output channels go in chunks of 128. It stays
// callable as dlq_basic_block_first.
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
  int8_t* out;
  int N, H, W, C, Kp;
  float inv_mid, inv_nxt, rs;
};

// ---------------------------------------------------------------------------
// The first form
// ---------------------------------------------------------------------------
namespace first {

using namespace dlq;

constexpr int TILE = 8;            // output tile edge
constexpr int HALO = TILE + 2;     // conv1 tile edge
constexpr int BN = 128;            // output-channel chunk

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

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = 2 * 128 * LDS + 2 * BN * LDS + HALO * HALO * (a.C + 16);
  cudaError_t e = cudaFuncSetAttribute(basic_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.H + TILE - 1) / TILE) * ((a.W + TILE - 1) / TILE);
  basic_block_kernel<<<dim3(tiles, a.N), THREADS, smem, stream>>>(a);
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

constexpr int KS = 64;               // K bytes of a B stage
constexpr int NS = 128;              // output channels a slice (a B stage's rows)
constexpr int THREADS = 384;         // producer warpgroup + two consumers
constexpr int SMEM_MAX = 232448;
constexpr int MAX_B_STAGES = 8, MIN_B_STAGES = 3;
constexpr int ROWS1 = 256;           // conv1 sum rows an item at most: four 64-row tiles

// The item geometry: grid width, output rows an item, strips an image,
// conv1 and conv2 sum rows, 64-row tiles a consumer takes in each, slab
// pixels a 16-channel chunk of x and of h (gw == 0: no geometry).
struct Geo {
  int gw, toh, rb, r1, r2, mt1, mt2, spx1, spx2;
};

// The launch plan: slice width, B stages, shared-memory bytes, items,
// blocks (ns == 0: no plan).
struct Plan {
  int ns, b_stages, smem, items, grid;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int round8(int a) { return cdiv(a, 8) * 8; }
inline int imax(int a, int b) { return a > b ? a : b; }

// Strips of TOH rows, the most with (TOH + 2) x GW <= ROWS1, balanced over
// the image. A slab chunk holds the box's rows x GW pixels and the pixels
// the consumers' tiles read (2 MT x 64 sum rows plus the largest tap
// shift, 2 GW + 2), rounded up to 8 (128-byte chunk pitch).
inline Geo geometry(int H, int W) {
  Geo g{0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int gw = W + 2;
  if (H <= 0 || W <= 0) return g;
  const int t0 = ROWS1 / gw - 2;
  if (t0 < 1) return g;
  g.gw = gw;
  g.rb = cdiv(H, t0);
  g.toh = cdiv(H, g.rb);
  g.r1 = (g.toh + 2) * gw;
  g.r2 = g.toh * gw;
  g.mt1 = cdiv(cdiv(g.r1, 64), 2);
  g.mt2 = cdiv(cdiv(g.r2, 64), 2);
  g.spx1 = round8(imax((g.toh + 4) * gw, 128 * g.mt1 + 2 * gw + 2));
  g.spx2 = round8(imax((g.toh + 2) * gw, 128 * g.mt2 + 2 * gw + 2));
  return g;
}

// C a multiple of 128 up to 512, slices of NS = 128 channels; the most B
// stages that fit (3 to 8) beside the slabs.
inline Plan make_plan(int N, int H, int W, int C, int sms) {
  Plan p{0, 0, 0, 0, 0};
  const Geo g = geometry(H, W);
  if (g.gw == 0 || C <= 0 || C % NS || C > 512) return p;
  const int fixed = C * (g.spx1 + g.spx2) + staging_bytes(NS) + LUT_BYTES + 16;
  int sb = (SMEM_MAX - fixed) / (NS * KS + 16);
  sb = sb > MAX_B_STAGES ? MAX_B_STAGES : sb;
  if (sb < MIN_B_STAGES) return p;
  p = Plan{NS, sb, fixed + sb * (NS * KS + 16), N * g.rb, 0};
  p.grid = p.items < sms ? p.items : sms;
  return p;
}

struct Hop {
  Geo g;
  Plan p;
};

// ---- thread 0: the B ring, w1's then w2's stages of every item ----
__device__ __forceinline__ void produce_b(const Args& a, const Hop& hp, const CUtensorMap& tw1,
                                          const CUtensorMap& tw2, uint8_t* ring, uint64_t* bfull,
                                          uint64_t* bempty) {
  const int CC = a.C / KS, S = a.C / NS;
  int bs = 0, bph = 0;
  for (int it = blockIdx.x; it < hp.p.items; it += gridDim.x)
    for (int conv = 0; conv < 2; ++conv)
      for (int s = 0; s < S; ++s)
        for (int tap = 0; tap < 9; ++tap)
          for (int cc = 0; cc < CC; ++cc) {
            sm90::mbar_wait(bempty + bs, bph ^ 1);
            w4::mbar_expect_tx(bfull + bs, NS * KS);
            w4::tma_load(ring + bs * NS * KS, conv == 0 ? &tw1 : &tw2, tap * a.C + cc * KS, s * NS,
                         bfull + bs);
            if (++bs == hp.p.b_stages) bs = 0, bph ^= 1;
          }
}

// ---- thread 32: the x slab of every item ----
__device__ __forceinline__ void produce_x(const Args& a, const Hop& hp, const CUtensorMap& tx,
                                          uint8_t* xs, uint64_t* xfull, uint64_t* xempty) {
  const Geo& g = hp.g;
  int ph = 0;
  for (int it = blockIdx.x; it < hp.p.items; it += gridDim.x) {
    const int img = it / g.rb, oh0 = (it - img * g.rb) * g.toh;
    sm90::mbar_wait(xempty, ph ^ 1);
    w4::mbar_expect_tx(xfull, a.C * g.gw * (g.toh + 4));
    for (int ch = 0; ch < a.C / 16; ++ch)
      i8::tma_load4(xs + ch * g.spx1 * 16, &tx, 16 * ch, -1, oh0 - 2, img, xfull);
    ph ^= 1;
  }
}

// A conv's sums over one NS slice: the nine taps as shifted no-swizzle
// descriptors on a slab (chunk pitch `pitch` bytes), the consumer's MT
// tiles from sum row row0, each 64-channel chunk's B stage in turn. step()
// hands over the ring's next stage and keeps one group in flight; the
// products are issued on every path, also for a tile past the conv's rows
// (a wgmma under a branch makes ptxas serialize every wgmma of the kernel).
template <int MT, class Step>
__device__ __forceinline__ void slab_sums(int (&acc)[MT][NS / 2], uint32_t slab, int pitch,
                                          int row0, int gw, int CC, Step&& step) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) acc[i][k] = 0;
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * gw + tap % 3;
    for (int cc = 0; cc < CC; ++cc)
      step([&](const uint8_t* B) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sm90::wgmma_s8<NS>(
                acc[i], i8::desc_slab(slab + (4 * cc + 2 * j) * pitch + (row0 + 64 * i + shift) * 16,
                                      pitch),
                w4::desc_sw(B + 32 * j, 8 * KS, 2));
      });
  }
}

// ---- warpgroups 1-2: the two convs and their epilogues ----
template <int MT1, int MT2>
__device__ __forceinline__ void consume(const Args& a, const Hop& hp, const uint8_t* ring,
                                        uint8_t* xs, uint8_t* hs, uint8_t* staging, int8_t* lut,
                                        uint64_t* bfull, uint64_t* bempty, uint64_t* xfull,
                                        uint64_t* xempty) {
  constexpr int SROW = NS + 16;   // bytes of a staged output row
  const Geo& g = hp.g;
  const int cw = (threadIdx.x >> 7) - 1, ctid = threadIdx.x & 127;
  const int w = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  const int CC = a.C / KS, S = a.C / NS;
  const int p1 = g.spx1 * 16, p2 = g.spx2 * 16;   // the slabs' chunk pitches
  const uint32_t xs_u32 = dlq::smem_u32(xs), hs_u32 = dlq::smem_u32(hs);
  uint8_t* wst = staging + (4 * cw + w) * 8 * SROW;
  const uint32_t wst_u32 = dlq::smem_u32(wst);
  // q / GW as (q x m) >> 16, m = ceil(2^16 / GW): exact while q GW < 2^16
  // (sum rows q < 256, GW <= 85)
  const uint32_t mgw = (65535u + g.gw) / g.gw;
  const int row1 = 64 * MT1 * cw, row2 = 64 * MT2 * cw;   // this consumer's first sum rows
  auto both = []() { sm90::named_bar(1, 256); };

  skip_lut(lut, threadIdx.x - 128, a.rs);
  // columns -1 and W of every h slab row stay zero (the padding of the 3x3)
  for (int i = threadIdx.x - 128; i < (a.C / 16) * (g.toh + 2) * 2; i += 256) {
    const int e = i & 1, rest = i >> 1, hr = rest % (g.toh + 2), ch = rest / (g.toh + 2);
    *reinterpret_cast<uint4*>(hs + (size_t)ch * p2 + (hr * g.gw + e * (g.gw - 1)) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  both();

  int bs = 0, bph = 0, held = -1, xph = 0;
  auto step = [&](auto&& issue) {
    sm90::mbar_wait(bfull + bs, bph);
    sm90::wgmma_fence();
    issue(ring + bs * NS * KS);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // the group before this one is done: free its stage
    if (ctid == 0 && held >= 0) sm90::mbar_arrive(bempty + held);
    held = bs;
    if (++bs == hp.p.b_stages) bs = 0, bph ^= 1;
  };
  auto drain = [&]() {
    sm90::wgmma_wait<0>();
    if (ctid == 0 && held >= 0) sm90::mbar_arrive(bempty + held);
    held = -1;
  };

  for (int it = blockIdx.x; it < hp.p.items; it += gridDim.x) {
    const int img = it / g.rb, oh0 = (it - img * g.rb) * g.toh;
    sm90::mbar_wait(xfull, xph);
    xph ^= 1;

    // 1. conv1 over the strip's rows and the row above and below -> h's codes
    for (int s = 0; s < S; ++s) {
      int acc[MT1][NS / 2];
      slab_sums<MT1>(acc, xs_u32, p1, row1, g.gw, CC, step);
      drain();
      if (s == S - 1 && ctid == 0) sm90::mbar_arrive(xempty);   // the x slab is free
      const int n0 = s * NS;
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
        sm90::fence_acc(acc[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q1 = row1 + 64 * i + 16 * w + gq + 8 * h;
          const int hr = (int)(((uint32_t)q1 * mgw) >> 16), c = q1 - hr * g.gw;
          if (q1 >= g.r1 || c >= a.W) continue;
          const int ih = oh0 - 1 + hr;
          const bool inside = ih >= 0 && ih < a.H;
          const uint32_t px = hs_u32 + (hr * g.gw + c + 1) * 16 + 2 * t;
          codes_t<NS, false>(acc[i], h, n0, t, a.s1, a.b1, a.inv_mid, 0.0f, [&](int j, uint32_t v) {
            const int n = n0 + 8 * j;
            sts16(px + (n >> 4) * p2 + (n & 15), inside ? v : 0u);
          });
        }
      }
    }
    sm90::fence_proxy_async();   // the h slab's st.shared, to wgmma's reads
    both();

    // 2. conv2 on the h slab; skip, add, clip, 16-byte stores
    for (int s = 0; s < S; ++s) {
      int acc[MT2][NS / 2];
      slab_sums<MT2>(acc, hs_u32, p2, row2, g.gw, CC, step);
      drain();
      if (s == S - 1) both();   // both consumers are done reading the h slab
      const int n0 = s * NS;
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        sm90::fence_acc(acc[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          constexpr int CPR = NS / 16;             // 16-byte chunks a staged row
          constexpr int PER = (8 * CPR + 31) / 32;  // chunks a lane
          long long off[PER];
          uint4 xv[PER];
#pragma unroll
          for (int u = 0; u < PER; ++u) {   // the skip's chunks first: in flight during the codes
            const int k = lane + 32 * u, r = k / CPR, c = k - r * CPR;
            const int q = row2 + 64 * i + 16 * w + 8 * h + r;
            const int ohl = (int)(((uint32_t)q * mgw) >> 16), jc = q - ohl * g.gw;
            off[u] = -1;
            if (k < 8 * CPR && jc < a.W && ohl < g.toh && oh0 + ohl < a.H)
              off[u] = (((long long)img * a.H + oh0 + ohl) * a.W + jc) * a.C + n0 + 16 * c;
            if (off[u] >= 0) xv[u] = *reinterpret_cast<const uint4*>(a.x + off[u]);
          }
          const uint32_t row = wst_u32 + gq * SROW + 2 * t;
          codes_t<NS, false>(acc[i], h, n0, t, a.s2, a.b2, a.inv_nxt, -127.0f,
                             [&](int j, uint32_t v) { sts16(row + 8 * j, v); });
          __syncwarp();
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            if (off[u] < 0) continue;
            const int k = lane + 32 * u, r = k / CPR, c = k - r * CPR;
            const uint4 z = *reinterpret_cast<const uint4*>(wst + r * SROW + 16 * c);
            *reinterpret_cast<uint4*>(a.out + off[u]) = skip_add16(z, xv[u], lut);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int MT1, int MT2>
__global__ void __launch_bounds__(THREADS, 1)
    basic_hopper_kernel(const __grid_constant__ Args a, const Hop hp,
                        const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw1,
                        const __grid_constant__ CUtensorMap tw2) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Geo& g = hp.g;
  const int sb = hp.p.b_stages;
  uint8_t* ring = smem;                                // sb x NS x 64 (64-byte swizzle)
  uint8_t* xs = ring + sb * NS * KS;                   // x slab: [C / 16][spx1][16]
  uint8_t* hs = xs + a.C * g.spx1;                     // h slab: [C / 16][spx2][16]
  uint8_t* staging = hs + a.C * g.spx2;                // 8 warps x 8 rows x (NS + 16)
  int8_t* lut = reinterpret_cast<int8_t*>(staging + staging_bytes(NS));   // 256 bytes
  uint64_t* bfull = reinterpret_cast<uint64_t*>(lut + LUT_BYTES);
  uint64_t* bempty = bfull + sb;
  uint64_t* xfull = bempty + sb;
  uint64_t* xempty = xfull + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sb; ++s) {
      sm90::mbar_init(bfull + s, 1);    // the producer's expect_tx
      sm90::mbar_init(bempty + s, 2);   // one thread of each consumer
    }
    sm90::mbar_init(xfull, 1);
    sm90::mbar_init(xempty, 2);
    sm90::mbar_init_fence();
    if (dlq::smem_u32(smem) & 1023) __trap();   // the swizzled stages need 1024-byte bases
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce_b(a, hp, tw1, tw2, ring, bfull, bempty);
    else if (threadIdx.x == 32) produce_x(a, hp, tx, xs, xfull, xempty);
    return;
  }
  sm90::setmaxnreg_inc<232>();
  consume<MT1, MT2>(a, hp, ring, xs, hs, staging, lut, bfull, bempty, xfull, xempty);
}

template <int MT1, int MT2>
cudaError_t launch_k(const Args& a, const Hop& hp, const CUtensorMap* maps, int dev,
                     cudaStream_t st) {
  const cudaError_t e = dlq::opt_in<basic_hopper_kernel<MT1, MT2>>(dev);
  if (e != cudaSuccess) return e;
  basic_hopper_kernel<MT1, MT2><<<hp.p.grid, THREADS, hp.p.smem, st>>>(a, hp, maps[0], maps[1],
                                                                   maps[2]);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, const Hop& hp, int dev, cudaStream_t st) {
  CUtensorMap maps[3]{};
  cudaError_t e;
  if ((e = i8::slab_map(&maps[0], a.x, a.N, a.H, a.W, a.C, 1, hp.g.gw, hp.g.toh + 4)) !=
      cudaSuccess)
    return e;
  if ((e = i8::kmajor_map(&maps[1], a.w1, 9 * a.C, a.C, hp.p.ns)) != cudaSuccess) return e;
  if ((e = i8::kmajor_map(&maps[2], a.w2, 9 * a.C, a.C, hp.p.ns)) != cudaSuccess) return e;
  switch (hp.g.mt1 * 10 + hp.g.mt2) {
    case 22: return launch_k<2, 2>(a, hp, maps, dev, st);
    case 21: return launch_k<2, 1>(a, hp, maps, dev, st);
    case 11: return launch_k<1, 1>(a, hp, maps, dev, st);
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace hop

bool bad(int N, int H, int W, int C, int Kp) {
  return N < 0 || H < 0 || W < 0 || C % 64 != 0 || C <= 0 || C > 512 || Kp != 9 * C;
}

}  // namespace

// The form a launch takes: 1 the Hopper form, 0 the first form. A static
// shape rule: the item geometry exists (W + 2 <= 85) and a plan fits
// (neither depends on the batch or the card; ops/block_fused.py:
// basic_block_form).
extern "C" int dlq_basic_block_form(int H, int W, int C) {
  return hop::make_plan(1, H, W, C, 1).ns > 0 ? 1 : 0;
}

// The Hopper form's plan and geometry: out = {slice width, B stages,
// shared-memory bytes, items, blocks, grid width, output rows an item,
// strips an image, conv1 rows, conv2 rows, conv1 tiles a consumer, conv2
// tiles a consumer, x slab pixels a chunk, h slab pixels a chunk} on `sms`
// SMs (0: this card's); zeros for the first form.
extern "C" int dlq_basic_block_plan(int N, int H, int W, int C, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = dlq::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const hop::Plan p = hop::make_plan(N, H, W, C, sms);
  hop::Geo g = hop::geometry(H, W);
  if (p.ns == 0) g = hop::Geo{0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int v[14] = {p.ns,  p.b_stages, p.smem, p.items, p.grid, g.gw,   g.toh,
                     g.rb,  g.r1,       g.r2,   g.mt1,   g.mt2,  g.spx1, g.spx2};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// Weights are K-major [C, Kp] with Kp = 9 C, K = (kh, kw, c); x, out, w1, w2
// 16-byte aligned; on the Hopper form s1, b1, s2, b2 8-byte aligned.
extern "C" int dlq_basic_block(const int8_t* x, const int8_t* w1, const float* s1,
                               const float* b1, const int8_t* w2, const float* s2,
                               const float* b2, int8_t* out, int N, int H, int W, int C, int Kp,
                               float inv_mid, float inv_nxt, float rs, void* stream) {
  if (bad(N, H, W, C, Kp)) return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return 0;
  const Args a{x, w1, s1, b1, w2, s2, b2, out, N, H, W, C, Kp, inv_mid, inv_nxt, rs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dlq_basic_block_form(H, W, C)) return (int)first::launch(a, st);
  int dev = 0, sms = 0;
  const cudaError_t e = dlq::device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const hop::Hop hp{hop::geometry(H, W), hop::make_plan(N, H, W, C, sms)};
  return (int)hop::launch(a, hp, dev, st);
}

// The first form at any shape it takes (what the card tests and
// chip_smoke.py hold the Hopper form to, output for output).
extern "C" int dlq_basic_block_first(const int8_t* x, const int8_t* w1, const float* s1,
                                     const float* b1, const int8_t* w2, const float* s2,
                                     const float* b2, int8_t* out, int N, int H, int W, int C,
                                     int Kp, float inv_mid, float inv_nxt, float rs,
                                     void* stream) {
  if (bad(N, H, W, C, Kp)) return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return 0;
  const Args a{x, w1, s1, b1, w2, s2, b2, out, N, H, W, C, Kp, inv_mid, inv_nxt, rs};
  return (int)first::launch(a, static_cast<cudaStream_t>(stream));
}
