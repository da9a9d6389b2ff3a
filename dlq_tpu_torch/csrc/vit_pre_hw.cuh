// The Hopper form of the first third of a ViT layer with bf16 activations,
// shared by K11 vit_pre_w4 (int4 per-OC weights, halves-packed; vit_pre_w4.cu)
// and K14 vit_pre_bf16 (bf16 weights, vit_pre_bf16.cu), as vit_pre_h.cuh's
// body is their first form:
//   h1  = bf16(LN(x))                                         x: bf16 or fp32 [M, Dp]
//   acc = h1 @ W       (bf16 x bf16 products, exact; fp32 sums)
//   qkv = bf16(fma(acc, s[n], b[n]))                          -> bf16 [M, 3 Dp]
// With bf16 weights there is no scale: qkv = bf16(acc + b[n]), which
// fma(acc, 1.0f, b) rounds identically (the table below holds s = 1).
// The fp32 sums run in the tensor core's order, another than the first
// form's, so the two agree within the stated tolerances, not bit for bit.
//
// Design (Dp 128, 192 or 256): K5's form (vit_pre_iw.cuh) in bf16. A
// persistent grid of one block per SM, each block a contiguous run of
// ceil(M / SMs) rows (at least 64) walked in tiles of 128. A block is three
// warpgroups. Lane 0 of the producer's warp 3 feeds each consumer's ring
// of y stages (32 x Dp bytes: 8 fp32 or 16 bf16 rows, contiguous in y) by
// bulk copy. The rest of the producer streams the weight from L2 through a
// ring of bf16 stages handed over by `full` / `empty` mbarriers; a stage is
// one 192-column slice of the 3 Dp outputs by 64 K values, 128 bytes a row,
// K-major, so both weights take one plan. They differ in the producer, the
// stage's layout and the K values of its slots:
//  - K11 (warps 0-2): the packed bytes stay in L2 (55 KB at Dp 192) and
//    are unpacked per stage, as K12's producer does (vit_post_hw.cuh), into
//    no-swizzle core matrices (sm90.cuh): each
//    thread loads its 16-byte packed units of a stage before it waits for
//    the stage, then writes their exact bf16 nibble values (the reference's
//    _unpack_halves_bf16, :1983) into it (eight consecutive threads fill one
//    core matrix). A stage holds 32 packed bytes of each row: the low
//    nibbles are K slots 0-31 (K values b0 .. b0 + 31), the high ones K
//    slots 32-63 (K values Dp/2 + b0 ..), so each packed byte is read once
//    and no stage straddles the halves (Dp/2 = 96 at Dp 192). Holding its
//    loads across the wait, it keeps 88 registers (consumers 208).
//  - K14 (thread 0): the bf16 weight (221 KB at Dp 192, 393 KB at 256:
//    never resident) lands by one TMA box a stage, 64 contiguous K values
//    (128 bytes) of 192 rows with 128-byte swizzle, counted on `full` by
//    its bytes; the consumers read it through swizzled B descriptors. A
//    stage is 24 x 1,024 bytes and the ring starts the shared memory, so
//    every stage base has the 1,024-byte alignment the swizzle needs and
//    the plan stays K11's. Chosen over 16-byte cp.async from one producer
//    warp (K5's streamed route), which was tried first and ran little
//    faster than the first form: one warp's copies could not feed the
//    stages (PERF.md, Findings). The producer holds nothing across a wait,
//    so it runs in 40 registers and gives the consumers 232.
// Both consumers read each weight stage, so one pass over the weight
// serves 128 rows (~88 MB of L2 reads a K14 launch at DeiT-Tiny batch 256,
// tight pads). The two consumer warpgroups take 64 rows each of a tile.
// Each runs LN1 on its rows from the y stages, one warp a row with lane l
// holding columns l + 32 j (the first form's arithmetic and reduction
// order: ln_bf16_row), and writes bf16 h1 into its 64 x Dp K-major
// core-matrix tile. Then, per slice, bf16 wgmma m64n192k16 (both operands
// in shared memory, 96 fp32 sums a thread; four k16 steps a stage, each
// with its A descriptor on the matching columns of h1), and the epilogue
// bf16(fma(acc, s, b)) from a table of {s, s, b, b} per column pair, bf16
// pairs staged per warp in two buffers of 8 rows, each row (384 bytes)
// handed to the bulk-copy engine by one lane; a consumer with no rows in a
// tile only passes the stages on.
// Shared memory: the ring (stages x 192 x 128 bytes), h1 128 x Dp x 2, the
// table 3 Dp x 8, the staging 8 x 2 x 8 x 400, the y stages 2 x NY x 32 Dp,
// the mbarriers: 227,968 bytes at Dp 192 (4 stages, 2 y stages a consumer),
// 226,448 at Dp 128 (5, 2), 229,488 at Dp 256 (3, 2), of the 232,448
// allowed. Other Dp (multiples of 64 up to 512) run the first form.
#pragma once

#include "launch.cuh"
#include "sm90.cuh"
#include "vit_pre_h.cuh"
#include "w4gemm.cuh"

namespace dlq {
namespace pre_hw {

using pre_h::Args;

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int NS = 192;          // output columns a slice (3 Dp is a multiple of 192)
constexpr int PB = 32;           // K11: packed bytes of a weight row a stage
constexpr int KB = 4 * PB;       // bf16 K bytes of a stage row (64 K values, 4 k16 steps)
constexpr int STAGE = NS * KB;   // bytes of a weight stage
constexpr int YB_PER_LANE = 32;  // a y stage: 32 x Dp bytes (8 fp32 rows, 16 bf16 rows)
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int MAX_STAGES = 8, MIN_STAGES = 3, MAX_Y = 4, MIN_Y = 2;
constexpr int STAGE_ROW = 2 * NS + 16;   // bytes of a staged bf16 output row

// The launch plan: weight ring stages, y stages a consumer, dynamic shared
// memory, blocks, rows a block (all 0: no Hopper plan, the first form).
struct Plan {
  int stages, ystages, smem, grid, rows;
};

inline bool hopper(int Dp) { return Dp == 128 || Dp == 192 || Dp == 256; }

inline Plan make_plan(int Dp, int M, int sms) {
  Plan p{0, 0, 0, 0, 0};
  if (!hopper(Dp)) return p;
  const int fixed = BM * Dp * 2 + 3 * Dp * 8 + 2 * 8 * 8 * STAGE_ROW;
  const int ystage = YB_PER_LANE * Dp + 16, stage = STAGE + 16;   // each with its two mbarriers
  int stages = (SMEM_OPT_IN - fixed - 2 * MIN_Y * ystage) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  if (stages < MIN_STAGES) return p;
  int ny = (SMEM_OPT_IN - fixed - stages * stage) / (2 * ystage);
  ny = ny > MAX_Y ? MAX_Y : ny;
  const int per = (M + sms - 1) / sms;
  const int rows = per > 64 ? per : 64;
  return {stages, ny, fixed + stages * stage + 2 * ny * ystage, (M + rows - 1) / rows, rows};
}

// tw: K14's weight map (weight_map); unused by K11.
template <bool W4, class T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    kernel(const Args a, const Plan pl, const __grid_constant__ CUtensorMap tw) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int N = 3 * DP, NJ = DP / 32, YB = YB_PER_LANE * DP, KH = DP / 2, LDA = 2 * DP;
  constexpr int YR = YB / (DP * (int)sizeof(T)), RPW = YR / 4;   // rows a y stage, a warp
  // weight producer threads: K11's unpack on warps 0-2, K14's TMA on thread 0
  constexpr int PT = W4 ? 96 : 1;
  // registers a thread after setmaxnreg (168 at launch): K11's producer
  // holds a stage's packed loads across its wait for the stage (K12's 88);
  // K14's holds nothing (K5's 40)
  constexpr int PRODUCER_REGS = W4 ? 88 : 40;
  constexpr int CONSUMER_REGS = 168 + (168 - PRODUCER_REGS) / 2;
  constexpr int UNITS = NS * PB / 16 / 96;   // K11: packed units a thread, a stage
  static_assert(UNITS * 96 == NS * PB / 16, "whole units");
  // a slice's stages: K11's walk packed bytes b0 = 0, 32, .. of each row,
  // K14's K values k0 = 0, 64, ..
  constexpr int KEND = W4 ? KH : DP, KSTEP = W4 ? PB : 64;
  const int S = pl.stages, NY = pl.ystages;
  uint8_t* ring = smem;                                           // S x [NS x KB] bf16 stages
  uint8_t* Atile = ring + S * STAGE;                              // 2 x [64 x LDA] bf16 h1 (K-major cores)
  float4* SB = reinterpret_cast<float4*>(Atile + BM * LDA);      // {s, s, b, b} per column pair
  uint8_t* staging = reinterpret_cast<uint8_t*>(SB + N / 2);      // 8 warps x 2 x 8 rows x STAGE_ROW
  uint8_t* ys = staging + 2 * 8 * 8 * STAGE_ROW;                  // 2 consumers x NY x [YR x DP] y
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + 2 * NY * YB);
  uint64_t* empty = full + S;
  uint64_t* yfull = empty + S;                                    // 2 x NY
  uint64_t* yempty = yfull + 2 * NY;
  const int m_begin = blockIdx.x * pl.rows;
  const int m_end = min(a.M, m_begin + pl.rows);
  const T* y = static_cast<const T*>(a.y);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, PT);   // each producer thread (K14: its expect_tx)
      sm90::mbar_init(empty + s, 2);
    }
    for (int s = 0; s < 2 * NY; ++s) {
      sm90::mbar_init(yfull + s, 1);    // the y producer's expect_tx
      sm90::mbar_init(yempty + s, 4);   // each warp of the consumer
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (!W4 && (smem_u32(smem) & 1023)) __trap();   // the swizzled stages' bases

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 96) {
      // ---- warp 3, lane 0: each consumer's y rows, YR at a time, by bulk copy ----
      int slot[2] = {0, 0}, ph[2] = {0, 0};
      for (int m0 = m_begin; m0 < m_end; m0 += BM)
        for (int k = 0; k < 64; k += YR)
          for (int cw = 0; cw < 2; ++cw) {
            const int r0 = m0 + 64 * cw + k, nr = min(YR, m_end - r0);
            if (nr <= 0) continue;
            const int i = cw * NY + slot[cw];
            sm90::mbar_wait(yempty + i, ph[cw] ^ 1);
            sm90::expect_tx(yfull + i, nr * DP * (int)sizeof(T));
            sm90::bulk_load(ys + i * YB, y + (size_t)r0 * DP, nr * DP * (int)sizeof(T),
                            yfull + i);
            if (++slot[cw] == NY) slot[cw] = 0, ph[cw] ^= 1;
          }
      return;
    }
    if (threadIdx.x >= PT) return;
    int stage = 0, phase = 0;
    if constexpr (W4) {
      // ---- warps 0-2: the weight, slice by slice, unpacked into bf16 stages ----
      const int pt = threadIdx.x;
      const uint8_t* w = static_cast<const uint8_t*>(a.w);
      for (int m0 = m_begin; m0 < m_end; m0 += BM)
        for (int n0 = 0; n0 < N; n0 += NS)
          for (int b0 = 0; b0 < KH; b0 += PB) {
            // unit u: row n, packed bytes b0 + 16 j .. (j = 0, 1); its low
            // nibbles are K slots 16 j .., its high ones 32 + 16 j ..
            uint4 p[UNITS];
            int off[UNITS];
#pragma unroll
            for (int i = 0; i < UNITS; ++i) {
              const int u = pt + PT * i, grp = u >> 3, n = (u & 7) + 8 * (grp >> 1), j = grp & 1;
              off[i] = sm90::core_off(n, 32 * j, KB);
              p[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * KH + b0 + 16 * j));
            }
            sm90::mbar_wait(empty + stage, phase ^ 1);
            uint8_t* dst = ring + stage * STAGE;
#pragma unroll
            for (int i = 0; i < UNITS; ++i) {
              uint4 lo, hi;
              unpack16(p[i], 0, lo, hi);
              *reinterpret_cast<uint4*>(dst + off[i]) = lo;          // K slots 16 j .. + 7
              *reinterpret_cast<uint4*>(dst + off[i] + 128) = hi;    // + 8 .. + 15 (next core matrix)
              unpack16(p[i], 4, lo, hi);
              *reinterpret_cast<uint4*>(dst + off[i] + 512) = lo;    // K slots 32 + 16 j ..
              *reinterpret_cast<uint4*>(dst + off[i] + 640) = hi;
            }
            sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
            sm90::mbar_arrive(full + stage);
            if (++stage == S) stage = 0, phase ^= 1;
          }
    } else {
      // ---- thread 0: the bf16 weight, slice by slice, one TMA box a stage ----
      for (int m0 = m_begin; m0 < m_end; m0 += BM)
        for (int n0 = 0; n0 < N; n0 += NS)
          for (int k0 = 0; k0 < DP; k0 += 64) {
            sm90::mbar_wait(empty + stage, phase ^ 1);
            sm90::expect_tx(full + stage, STAGE);
            w4::tma_load(ring + stage * STAGE, &tw, 2 * k0, n0, full + stage);
            if (++stage == S) stage = 0, phase ^= 1;
          }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile ----
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ctid = threadIdx.x - 128 * wg;
  const int warp = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  uint8_t* As = Atile + cw * 64 * LDA;
  uint8_t* wst = staging + (4 * cw + warp) * 2 * 8 * STAGE_ROW;
  auto wg_sync = [&]() { sm90::named_bar(1 + cw, 128); };

  for (int i = threadIdx.x - 128; i < N / 2; i += 256)
    SB[i] = W4 ? make_float4(a.s[2 * i], a.s[2 * i + 1], a.b[2 * i], a.b[2 * i + 1])
               : make_float4(1.0f, 1.0f, a.b[2 * i], a.b[2 * i + 1]);
  float lg[NJ], lb[NJ];   // LN1's g and b at this lane's columns (lane + 32 j)
#pragma unroll
  for (int j = 0; j < NJ; ++j) lg[j] = a.ln[lane + 32 * j], lb[j] = a.ln[DP + lane + 32 * j];
  sm90::named_bar(3, 256);

  int stage = 0, phase = 0, held = -1, yslot = 0, yph = 0;
  // wait for the next stage, issue(B) its products, keep one group in flight
  auto consume = [&](auto&& issue) {
    sm90::mbar_wait(full + stage, phase);
    sm90::fence_proxy_async();
    sm90::wgmma_fence();
    issue(ring + stage * STAGE);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (held >= 0 && ctid == 0) sm90::mbar_arrive(empty + held);
    held = stage;
    if (++stage == S) stage = 0, phase ^= 1;
  };
  auto drain = [&]() {
    sm90::wgmma_wait<0>();
    if (held >= 0 && ctid == 0) sm90::mbar_arrive(empty + held);
    held = -1;
  };
  // a tile with no rows for this warpgroup: hand each stage back unread
  auto pass = [&]() {
    sm90::mbar_wait(full + stage, phase);
    if (ctid == 0) sm90::mbar_arrive(empty + stage);
    if (++stage == S) stage = 0, phase ^= 1;
  };
  // h1's column (bf16) of k16 step kk (0-3) of the stage at k0: K11's packed
  // byte k0 pairs the halves, K14's K values run on from k0
  auto acol = [](int k0, int kk) {
    return W4 ? (kk < 2 ? 0 : KH - 32) + k0 + 16 * kk : k0 + 16 * kk;
  };

  float acc[NS / 2];
  sm90::zero(acc);
  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const int r0 = m0 + 64 * cw;
    const int rows = max(0, min(64, m_end - r0));
    if (rows == 0) {
      for (int i = 0; i < (N / NS) * (KEND / KSTEP); ++i) pass();
      continue;
    }
    // 1. LN1 -> bf16 h1, YR rows a y stage, YR / 4 a warp (a stage's rows
    //    past the tile's get zeros; rows past the last stage keep what they
    //    hold, and their sums are never stored)
#pragma unroll 1
    for (int k = 0; k < rows; k += YR) {
      const int nr = min(YR, rows - k);
      const int i = cw * NY + yslot;
      sm90::mbar_wait(yfull + i, yph);
      const T* yrows = reinterpret_cast<const T*>(ys + i * YB);
      float v[RPW][NJ];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = RPW * warp + u;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          v[u][j] = rr < nr ? load_f(yrows + rr * DP + lane + 32 * j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = RPW * warp + u;
        float s = 0.0f, sq = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) ln_acc(s, sq, v[u][j]);
        float mu, rs;
        ln_stats(s, sq, a.inv_n, 1e-6f, mu, rs);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<__nv_bfloat16*>(As + sm90::core_off(k + rr, 2 * (lane + 32 * j), LDA)) =
              __float2bfloat16_rn(rr < nr ? ln_apply(v[u][j], mu, rs, lg[j], lb[j]) : 0.0f);
      }
      // the stage goes back to the y producer only once this warp has used
      // every value it loaded from it (vit_pre_iw.cuh: an arrival right
      // after the loads let the next bulk copy overwrite unread rows)
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(yempty + i);   // this warp is done with the stage
      if (++yslot == NY) yslot = 0, yph ^= 1;
    }
    sm90::fence_proxy_async();   // h1's st.shared, to wgmma
    wg_sync();

    // 2. per slice of 192 columns: products over all of Dp, then the epilogue
    for (int n0 = 0; n0 < N; n0 += NS) {
#pragma unroll 1
      for (int k0 = 0; k0 < KEND; k0 += KSTEP)
        consume([&](const uint8_t* B) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // the slice's first step overwrites the sums
            sm90::wgmma_bf16<NS>(acc, sm90::desc(As, LDA, 2 * acol(k0, kk)),
                                 W4 ? sm90::desc(B, KB, 32 * kk)
                                    : w4::desc_sw(B + 32 * kk, 8 * KB, 1),   // 128-byte swizzle
                                 k0 + kk > 0);
        });
      drain();
      sm90::fence_acc(acc);
      // epilogue: per half h, this warp's 8 rows 16 warp + 8 h + gq staged as
      // bf16 pairs in the half's buffer, then each row (384 bytes) handed to
      // the bulk-copy engine by one lane; a buffer is written again only
      // after the engine has read its previous rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (16 * warp + 8 * h >= rows) continue;   // none of the half's rows is written
        uint8_t* buf = wst + h * 8 * STAGE_ROW;
        if (lane < 8) sm90::bulk_wait_read<1>();   // the copies of this buffer's last rows
        __syncwarp();
        uint8_t* row = buf + gq * STAGE_ROW;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const float4 sb = SB[(n0 >> 1) + 4 * j + t];
          const float y0 = __fmaf_rn(acc[4 * j + 2 * h], sb.x, sb.z);
          const float y1 = __fmaf_rn(acc[4 * j + 2 * h + 1], sb.y, sb.w);
          *reinterpret_cast<__nv_bfloat162*>(row + 2 * (8 * j + 2 * t)) =
              __floats2bfloat162_rn(y0, y1);
        }
        sm90::fence_proxy_async();   // these st.shared, to the bulk copy's reads
        __syncwarp();
        const int rl = 16 * warp + 8 * h + lane;   // lane i < 8: row i of the half
        if (lane < 8 && rl < rows)
          sm90::bulk_store(a.out + (size_t)(r0 + rl) * N + n0, buf + lane * STAGE_ROW, 2 * NS);
      }
      sm90::fence_acc(acc);
    }
    wg_sync();   // every warp's products are done before h1 is rewritten
  }
  if (lane < 8) sm90::bulk_wait_all();   // the staging outlives every copy
}

// The shared-memory opt-in: once per device and instantiation (launch.cuh).
template <bool W4, class T, int DP>
cudaError_t launch_k(const Args& a, const Plan& pl, const CUtensorMap& tw, int dev,
                     cudaStream_t st) {
  const cudaError_t e = opt_in<kernel<W4, T, DP>>(dev);
  if (e != cudaSuccess) return e;
  kernel<W4, T, DP><<<pl.grid, THREADS, pl.smem, st>>>(a, pl, tw);
  return cudaGetLastError();
}

template <bool W4, class T>
cudaError_t launch_t(const Args& a, const Plan& pl, const CUtensorMap& tw, int dev,
                     cudaStream_t st) {
  if (a.Dp == 128) return launch_k<W4, T, 128>(a, pl, tw, dev, st);
  if (a.Dp == 192) return launch_k<W4, T, 192>(a, pl, tw, dev, st);
  return launch_k<W4, T, 256>(a, pl, tw, dev, st);
}

// K14's weight map: bf16 [3 Dp, Dp] as bytes [3 Dp, 2 Dp], boxes of 128
// bytes (64 K values) x 192 rows, 128-byte swizzle.
inline cudaError_t weight_map(CUtensorMap* tm, const void* w, int Dp) {
  const w4::EncodeTiled encode = w4::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)(2 * Dp), (cuuint64_t)(3 * Dp)};
  const cuuint64_t strides[1] = {(cuuint64_t)(2 * Dp)};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)NS};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The Hopper form at a Dp it takes (hopper(Dp)); the arguments as
// pre_h::launch's.
template <bool W4>
int launch(const void* y, int y_f32, const float* ln, const void* w, const float* s,
           const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid, void* stream) {
  if (!hopper(Dp) || d_valid <= 0 || d_valid > Dp) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t e = device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const Plan pl = make_plan(Dp, M, sms);
  if (pl.stages < MIN_STAGES || pl.ystages < MIN_Y) return (int)cudaErrorInvalidValue;
  CUtensorMap tw{};
  if (!W4) {
    const cudaError_t em = weight_map(&tw, w, Dp);
    if (em != cudaSuccess) return (int)em;
  }
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_f32 ? launch_t<W4, float>(a, pl, tw, dev, st)
                     : launch_t<W4, __nv_bfloat16>(a, pl, tw, dev, st));
}

// The plan entry: out = {weight ring stages, y stages a consumer,
// shared-memory bytes, blocks, rows a block} for Dp and M on `sms` SMs (0:
// this card's); all 0 where the first form serves.
inline int plan_entry(int Dp, int M, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p = make_plan(Dp, M, sms);
  out[0] = p.stages, out[1] = p.ystages, out[2] = p.smem, out[3] = p.grid, out[4] = p.rows;
  return 0;
}

}  // namespace pre_hw
}  // namespace dlq
