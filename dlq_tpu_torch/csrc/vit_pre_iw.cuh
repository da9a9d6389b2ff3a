// The Hopper form of the first third of a ViT layer with int8 activations,
// shared by K5 vit_pre_w8 (int8 weights, vit_pre_w8.cu) and K8 vit_pre_w4a8
// (int4 halves-packed weights, vit_pre_w4a8.cu), as vit_pre.cuh's body is
// their first form. It computes what that body computes, bit for bit (the
// same LN order and codes, exact int32 sums, the same fma and rounding):
//   h1  = LN(x) (two-moment, over Dp lanes, 1/d_valid)       x: bf16 or fp32 [M, Dp]
//   acc = quant(h1, inv_qkv) @ wqkv    (int8 x int8 -> int32; wqkv K-major [3 Dp, Dp])
//   qkv = bf16(fma(float(acc), s[n], b[n]))                  -> [M, 3 Dp]
//
// Design (Dp 128, 192, and for K5 256; K7's form, vit_post_iw.cuh): a
// persistent grid of one block per SM, each block a contiguous run of
// ceil(M / 132) rows (at least 64) walked in tiles of 128. A block is three
// warpgroups. The first holds the weight: where it fits beside the rest (Dp
// 128 and 192) one copy of the int8 weight sits in shared memory in the
// no-swizzle core-matrix layout of sm90.cuh, resident for the block's walk;
// else (K5 at Dp 256: 196,608 bytes) 192 x 64-byte weight stages stream
// through a ring of up to 8 handed over by `full` / `empty` mbarriers.
// K5's weight is warp 0's: 16-byte cp.async, each lane's copies arriving on
// one mbarrier as they land. K8's is warps 0-2's: each thread loads four
// 16-byte packed units at a time (eight consecutive threads on eight rows,
// so their stores fill one 128-byte core matrix) and writes their
// sign-extended nibbles as int8: byte k of row n holds W[k][n] (low nibble)
// and W[Dp/2 + k][n] (high nibble), so a unit's low nibbles go to columns
// k .. k + 15 and its high ones to Dp/2 + k .. (Dp/2 is a multiple of 16 at
// Dp 128 and 192), then a proxy fence and an arrival on `full`. The fill is
// once a block and holds no load across a wait, so both producers run in 40
// registers and give the consumers 232. K8 takes no Dp 256: its packed
// stages would have to be loaded ahead of their waits, as K9's producer
// does at 88 registers, which would cost the consumers 24; no main path
// runs K8 at 256, so the first form serves it there. One lane (warp 1's for
// K5, warp 3's for K8) feeds each consumer's ring of y stages (32 x Dp
// bytes: 8 fp32 or 16 bf16 rows, contiguous in y) by bulk copy
// (cp.async.bulk), counted on the stage's mbarrier. The two consumer
// warpgroups (232 registers a thread by setmaxnreg) take 64 rows each of a
// tile. Each runs LN1 on its rows from the y stages, one warp a row with
// lane l holding columns l + 32 j (the first form's arithmetic and
// reduction order: ln_quant_row), and writes the int8 codes K-major into
// its 64 x Dp core-matrix tile. Then, per 192-column slice of the 3 Dp
// outputs, int8 wgmma m64n192k32 (both operands in shared memory, 96 sums a
// thread) over all of Dp, and the epilogue: fma(acc, s, b) from a table of
// {s, s, b, b} per column pair, bf16 pairs staged per warp in two buffers
// of 8 rows (400 bytes a row: a warp's stores of 8 rows hit distinct
// banks), each row (384 bytes) handed to the bulk-copy engine by one lane.
// float(acc) and the quantization round on the full-rate pipes (adding 1.5
// x 2^23), not the conversion pipe. With a resident weight the two
// consumers share nothing after the start (one with no rows left stops), so
// one's LN runs beside the other's products and epilogue.
// Shared memory: the weight (resident: 3 Dp x Dp; streamed: stages x 192 x
// 64), codes 128 x Dp, the table 3 Dp x 8, the staging 8 x 2 x 8 x 400, the
// y stages 2 x NY x 32 Dp, the mbarriers: 227,952 bytes at Dp 192
// (resident, 3 y stages a consumer), 152,720 at Dp 128 (resident, 4),
// 221,376 at Dp 256 (8 weight stages, 2 y stages), of the 232,448 allowed.
// K8's plan is K5's at Dp 128 and 192: its weight unpacks into the same
// resident int8 copy.
#pragma once

#include "launch.cuh"
#include "sm90.cuh"
#include "vit_pre.cuh"

namespace dlq {
namespace pre_iw {

using vit_pre::Args;

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int KS = 64;           // K bytes of a streamed weight stage
constexpr int NS = 192;          // output columns a slice (3 Dp is a multiple of 192)
constexpr int YB_PER_LANE = 32;  // a y stage: 32 x Dp bytes (8 fp32 rows, 16 bf16 rows)
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int MAX_STAGES = 8, MIN_STAGES = 3, MAX_Y = 4, MIN_Y = 2;
constexpr int STAGE_ROW = 2 * NS + 16;   // bytes of a staged bf16 output row
constexpr int W4_BATCH = 4;              // K8's packed units a producer thread holds at once

// The launch plan: resident weight (1) or weight ring stages, y stages a
// consumer, dynamic shared memory, blocks, rows a block.
struct Plan {
  int resident, stages, ystages, smem, grid, rows;
};

inline Plan make_plan(int Dp, int M, int sms) {
  const int fixed = BM * Dp + 3 * Dp * 8 + 2 * 8 * 8 * STAGE_ROW;
  const int ystage = YB_PER_LANE * Dp + 16;   // a stage and its two mbarriers
  const int per = (M + sms - 1) / sms;
  const int rows = per > 64 ? per : 64;
  Plan p{0, 0, 0, 0, (M + rows - 1) / rows, rows};
  if (3 * Dp * Dp + fixed + 16 + 2 * MIN_Y * ystage <= SMEM_OPT_IN) {
    int ny = (SMEM_OPT_IN - 3 * Dp * Dp - fixed - 16) / (2 * ystage);
    p.resident = 1;
    p.ystages = ny > MAX_Y ? MAX_Y : ny;
    p.smem = 3 * Dp * Dp + fixed + 16 + 2 * p.ystages * ystage;
    return p;
  }
  // a streamed weight beside the fewest y stages
  p.ystages = MIN_Y;
  const int rest = SMEM_OPT_IN - fixed - 2 * p.ystages * ystage;
  const int stages = rest / (NS * KS + 16);
  p.stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  p.smem = fixed + 2 * p.ystages * ystage + p.stages * (NS * KS + 16);
  return p;
}

// The Dp the Hopper form takes: 128, 192, 256 (K5); 128, 192 (K8: a
// resident weight only).
inline bool hopper(bool w4, int Dp) { return Dp == 128 || Dp == 192 || (!w4 && Dp == 256); }

template <class T>
__device__ __forceinline__ float ld(const T* p) { return load_f(p); }

// float(acc) for |acc| < 2^22 (every sum of Dp <= 256 int8 products: at most
// 256 x 127^2 < 2^22) without the conversion pipe: acc added to the bits of
// 1.5 x 2^23 is that float plus acc, exactly; subtracting 1.5 x 2^23 leaves
// acc. The same value as __int2float_rn(acc).
__device__ __forceinline__ float i2f(int acc) {
  return __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.0f);
}

// quant_i8(h, inv) (vit_common.cuh) as the low byte of the result: the clip
// first (its bounds are integers, so clipping before or after the rounding
// is the same), then rounding to nearest even by adding 1.5 x 2^23 (the
// sum's ulp is 1), without the conversion pipe.
__device__ __forceinline__ uint32_t quant_code(float h, float inv) {
  const float q = fminf(fmaxf(__fmul_rn(h, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

template <bool W4, class T, int DP, bool RES>
__global__ void __launch_bounds__(THREADS, 1) kernel(const Args a, const Plan pl) {
  static_assert(RES || !W4, "K8 takes a resident weight only");
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int N = 3 * DP, STAGE = NS * KS, NJ = DP / 32, YB = YB_PER_LANE * DP;
  constexpr int YR = YB / (DP * (int)sizeof(T)), RPW = YR / 4;   // rows a y stage, a warp
  // weight producer threads (warps 0-2, or warp 0); the next thread (lane 0
  // of warp 3, or of warp 1) feeds y
  constexpr int PT = W4 ? 96 : 32;
  const int S = pl.stages, NY = pl.ystages;
  int8_t* Wb = smem;                                   // resident [N][DP] cores, or S x [NS x KS]
  int8_t* Acodes = smem + (RES ? N * DP : S * STAGE);  // 2 x [64 x DP] codes (K-major cores)
  float4* SB = reinterpret_cast<float4*>(Acodes + BM * DP);   // {s, s, b, b} per column pair
  uint8_t* staging = reinterpret_cast<uint8_t*>(SB + N / 2);  // 8 warps x 2 x 8 rows x STAGE_ROW
  uint8_t* ys = staging + 2 * 8 * 8 * STAGE_ROW;               // 2 consumers x NY x [YR x DP] y
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + 2 * NY * YB);
  uint64_t* empty = full + S;                          // RES: full[0] is the weight's
  uint64_t* yfull = full + (RES ? 2 : 2 * S);          // 2 x NY
  uint64_t* yempty = yfull + 2 * NY;
  const int m_begin = blockIdx.x * pl.rows;
  const int m_end = min(a.M, m_begin + pl.rows);
  const int8_t* w = static_cast<const int8_t*>(a.w);
  const T* y = static_cast<const T*>(a.y);

  if (threadIdx.x == 0) {
    if (RES) {
      sm90::mbar_init(full, PT);
    } else {
      for (int s = 0; s < S; ++s) {
        sm90::mbar_init(full + s, 32);   // the producer's lanes, as their copies land
        sm90::mbar_init(empty + s, 2);
      }
    }
    for (int s = 0; s < 2 * NY; ++s) {
      sm90::mbar_init(yfull + s, 1);    // the y producer's expect_tx
      sm90::mbar_init(yempty + s, 4);   // each warp of the consumer
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == PT) {
      // ---- the y producer: each consumer's y rows, YR at a time, by bulk copy ----
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
    // ---- the weight, copied (K5) or unpacked (K8) once, or streamed (K5) ----
    if (threadIdx.x >= PT) return;
    const int lane = threadIdx.x;
    if constexpr (W4) {
      // unit c: row n = 8 (c / 8 / UPR) + c % 8, packed bytes q .. q + 15 with
      // q = 16 ((c / 8) % UPR); the packed weight [N][DP / 2] is contiguous
      constexpr int UPR = DP / 32, UNITS = N * UPR;
      const uint8_t* wp = static_cast<const uint8_t*>(a.w);
#pragma unroll 1
      for (int c0 = lane; c0 < UNITS; c0 += PT * W4_BATCH) {
        uint4 p[W4_BATCH];
#pragma unroll
        for (int i = 0; i < W4_BATCH; ++i) {
          const int c = c0 + PT * i, g = c >> 3, n = 8 * (g / UPR) + (c & 7), q = 16 * (g % UPR);
          if (c < UNITS) p[i] = __ldg(reinterpret_cast<const uint4*>(wp + n * (DP / 2) + q));
        }
#pragma unroll
        for (int i = 0; i < W4_BATCH; ++i) {
          const int c = c0 + PT * i, g = c >> 3, n = 8 * (g / UPR) + (c & 7), q = 16 * (g % UPR);
          if (c >= UNITS) continue;
          const uint4 u = p[i];
          *reinterpret_cast<uint4*>(Wb + sm90::core_off(n, q, DP)) =   // low nibbles: K q ..
              make_uint4(nib_sx(u.x), nib_sx(u.y), nib_sx(u.z), nib_sx(u.w));
          *reinterpret_cast<uint4*>(Wb + sm90::core_off(n, DP / 2 + q, DP)) =   // DP/2 + q ..
              make_uint4(nib_sx(u.x >> 4), nib_sx(u.y >> 4), nib_sx(u.z >> 4), nib_sx(u.w >> 4));
        }
      }
      sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
      sm90::mbar_arrive(full);
      return;
    } else if constexpr (RES) {
      for (int c = lane; c < N * (DP / 16); c += 32) {
        const int n = c / (DP / 16), q = (c - n * (DP / 16)) * 16;
        cp_async16(Wb + sm90::core_off(n, q, DP), w + (size_t)n * DP + q, true);
      }
      sm90::mbar_arrive_cp_async(full);
    } else {
      int stage = 0, phase = 0;
      for (int m0 = m_begin; m0 < m_end; m0 += BM)
        for (int n0 = 0; n0 < N; n0 += NS)
          for (int k = 0; k < DP; k += KS) {
            sm90::mbar_wait(empty + stage, phase ^ 1);
            int8_t* dst = Wb + stage * STAGE;
            for (int c = lane; c < NS * (KS / 16); c += 32) {
              const int n = c >> 2, q = (c & 3) * 16;
              cp_async16(dst + sm90::core_off(n, q, KS), w + (size_t)(n0 + n) * DP + k + q, true);
            }
            sm90::mbar_arrive_cp_async(full + stage);
            if (++stage == S) stage = 0, phase ^= 1;
          }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile ----
  sm90::setmaxnreg_inc<232>();
  const int cw = wg - 1, ctid = threadIdx.x - 128 * wg;
  const int warp = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  int8_t* As = Acodes + cw * 64 * DP;
  uint8_t* wst = staging + (4 * cw + warp) * 2 * 8 * STAGE_ROW;
  auto wg_sync = [&]() { sm90::named_bar(1 + cw, 128); };

  for (int i = threadIdx.x - 128; i < N / 2; i += 256)
    SB[i] = make_float4(a.s[2 * i], a.s[2 * i + 1], a.b[2 * i], a.b[2 * i + 1]);
  float lg[NJ], lb[NJ];   // LN1's g and b at this lane's columns (lane + 32 j)
#pragma unroll
  for (int j = 0; j < NJ; ++j) lg[j] = a.ln[lane + 32 * j], lb[j] = a.ln[DP + lane + 32 * j];
  sm90::named_bar(3, 256);

  bool w_ready = !RES;
  int stage = 0, phase = 0, held = -1, yslot = 0, yph = 0;
  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const int r0 = m0 + 64 * cw;
    const int rows = max(0, min(64, m_end - r0));
    // with the weight resident the consumers share nothing: one with no
    // rows left is done (a streamed weight's stages need both consumers)
    if (RES && rows == 0) break;
    // 1. LN1 -> int8 codes, YR rows a y stage, YR / 4 a warp (a stage's rows
    //    past the tile's get zero codes; stages past them are skipped, their
    //    rows' sums never written)
#pragma unroll 1
    for (int k = 0; k < (RES ? rows : 64); k += YR) {
      const int nr = min(YR, rows - k);
      const int i = cw * NY + yslot;
      if (nr > 0) sm90::mbar_wait(yfull + i, yph);
      const T* yrows = reinterpret_cast<const T*>(ys + i * YB);
      float v[RPW][NJ];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = RPW * warp + u;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          v[u][j] = rr < nr ? ld(yrows + rr * DP + lane + 32 * j) : 0.0f;
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
          As[sm90::core_off(k + rr, lane + 32 * j, DP)] =
              rr < nr ? (int8_t)quant_code(ln_apply(v[u][j], mu, rs, lg[j], lb[j]), a.inv_q)
                      : (int8_t)0;
      }
      // the stage goes back to the y producer only once this warp has used
      // every value it loaded from it: with the arrival right after the
      // loads, a row's loads were now and then still unread when the next
      // bulk copy overwrote the stage (one token row of the output wrong)
      __syncwarp();
      if (nr > 0) {   // this warp is done with the stage
        if (lane == 0) sm90::mbar_arrive(yempty + i);
        if (++yslot == NY) yslot = 0, yph ^= 1;
      }
    }
    if (!w_ready) {   // the resident weight has landed (first tile only)
      sm90::mbar_wait(full, 0);
      w_ready = true;
    }
    sm90::fence_proxy_async();   // the codes' st.shared (and the weight's cp.async), to wgmma
    wg_sync();

    // 2. per slice of 192 columns: products over all of Dp, then the epilogue
    for (int n0 = 0; n0 < N; n0 += NS) {
      int acc[NS / 2];
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) acc[i] = 0;
      if constexpr (RES) {
        for (int k = 0; k < DP; k += KS) {
          sm90::wgmma_fence();
          sm90::wgmma_s8<NS>(acc, sm90::desc(As, DP, k), sm90::desc(Wb + n0 * DP, DP, k));
          sm90::wgmma_s8<NS>(acc, sm90::desc(As, DP, k + 32), sm90::desc(Wb + n0 * DP, DP, k + 32));
          sm90::wgmma_commit();
        }
        sm90::wgmma_wait<0>();
      } else {
        for (int k = 0; k < DP; k += KS) {
          sm90::mbar_wait(full + stage, phase);
          sm90::fence_proxy_async();   // the stage's cp.async writes, to wgmma's reads
          const int8_t* B = Wb + stage * STAGE;
          sm90::wgmma_fence();
          sm90::wgmma_s8<NS>(acc, sm90::desc(As, DP, k), sm90::desc(B, KS, 0));
          sm90::wgmma_s8<NS>(acc, sm90::desc(As, DP, k + 32), sm90::desc(B, KS, 32));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
          if (held >= 0 && ctid == 0) sm90::mbar_arrive(empty + held);
          held = stage;
          if (++stage == S) stage = 0, phase ^= 1;
        }
        sm90::wgmma_wait<0>();
        if (held >= 0 && ctid == 0) sm90::mbar_arrive(empty + held);
        held = -1;
      }
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
          const float y0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), sb.x, sb.z);
          const float y1 = __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), sb.y, sb.w);
          *reinterpret_cast<__nv_bfloat162*>(row + 2 * (8 * j + 2 * t)) =
              __floats2bfloat162_rn(y0, y1);
        }
        sm90::fence_proxy_async();   // these st.shared, to the bulk copy's reads
        __syncwarp();
        const int rl = 16 * warp + 8 * h + lane;   // lane i < 8: row i of the half
        if (lane < 8 && rl < rows)
          sm90::bulk_store(a.out + (size_t)(r0 + rl) * N + n0, buf + lane * STAGE_ROW, 2 * NS);
      }
    }
    wg_sync();   // every warp's products are done before the codes are rewritten
  }
  if (lane < 8) sm90::bulk_wait_all();   // the staging outlives every copy
}

// The shared-memory opt-in: once per device and instantiation (launch.cuh).
template <bool W4, class T, int DP, bool RES>
cudaError_t launch_k(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  const cudaError_t e = opt_in<kernel<W4, T, DP, RES>>(dev);
  if (e != cudaSuccess) return e;
  kernel<W4, T, DP, RES><<<pl.grid, THREADS, pl.smem, st>>>(a, pl);
  return cudaGetLastError();
}

template <bool W4, class T>
cudaError_t launch_t(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  if (a.Dp == 128) return launch_k<W4, T, 128, true>(a, pl, dev, st);
  if (a.Dp == 192) return launch_k<W4, T, 192, true>(a, pl, dev, st);
  if constexpr (W4) return cudaErrorInvalidValue;   // hopper(true, Dp) takes no other Dp
  else return launch_k<W4, T, 256, false>(a, pl, dev, st);
}

// The Hopper form at a Dp it takes (hopper(W4, Dp)); the arguments as
// vit_pre::run's.
template <bool W4>
int launch(const void* y, int y_f32, const float* ln, const void* w, const float* s,
           const float* b, __nv_bfloat16* out, int M, int Dp, int d_valid, float inv_q,
           void* stream) {
  if (!hopper(W4, Dp) || d_valid <= 0 || d_valid > Dp) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t e = device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const Plan pl = make_plan(Dp, M, sms);
  if ((!pl.resident && pl.stages < MIN_STAGES) || pl.ystages < MIN_Y) return (int)cudaErrorInvalidValue;
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid), inv_q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_f32 ? launch_t<W4, float>(a, pl, dev, st)
                     : launch_t<W4, __nv_bfloat16>(a, pl, dev, st));
}

// The plan entry: out = {resident weight, ring stages, y stages, shared-
// memory bytes, blocks, rows a block} for Dp and M on `sms` SMs (0: this
// card's); K8's all 0 where its first form serves.
template <bool W4>
int plan_entry(int Dp, int M, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  // K5's entry reports its plan at any Dp, as its mirror does (vit_pre_w8_plan)
  const Plan p = !W4 || hopper(W4, Dp) ? make_plan(Dp, M, sms) : Plan{0, 0, 0, 0, 0, 0};
  out[0] = p.resident, out[1] = p.stages, out[2] = p.ystages, out[3] = p.smem, out[4] = p.grid;
  out[5] = p.rows;
  return 0;
}

}  // namespace pre_iw
}  // namespace dlq
