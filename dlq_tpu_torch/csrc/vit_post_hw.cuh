// The Hopper form of the last two thirds of a ViT layer with bf16
// activations, shared by K12 vit_post_w4 (int4 per-OC weights,
// vit_post_w4.cu) and K15 vit_post_bf16 (bf16 weights, vit_post_bf16.cu).
// It computes what vit_post_h.cuh's body (their first form) computes:
//   z1  = x + fma(acc_proj, s, b),         acc_proj = attn @ wproj
//   h2  = bf16(LN(z1))                     (ln_bf16_row's arithmetic and lane order)
//   f   = bf16(gelu(fma(acc_fc1, s, b))),  acc_fc1  = h2 @ wfc1
//   out = W4 (K12):   z1 + fma(acc_fc2, s, b)
//         bf16 (K15): (z1 + acc_fc2) + b,  acc_fc2  = f @ wfc2
// with s = 1 for bf16 weights (fma(acc, 1, b) rounds as acc + b). The fp32
// sums run in the tensor core's order, another order than the first form's.
//
// One body for both weight formats: the ring holds bf16 weight stages in
// either case. K15's producer copies its bf16 K-major rows in (cp.async);
// K12's producer unpacks the halves-packed int4 bytes into the same stages
// as the exact bf16 nibble values (-8..7), what the reference's cache-unpack
// kernel keeps in its bf16 scratches (_unpack_halves_bf16). A stage covers
// KS / 2 consecutive K values, which never straddle the packed halves
// (Kp / 2 is a multiple of KS / 2), so it reads KS / 2 packed bytes a row
// and one nibble of each. The per-OC scales stay in the epilogues.
//
// Design (Dp 128, 192 or 256 with a plan of at least 3 stages): K7's
// structure (vit_post_w8.cu) in bf16. A persistent grid of one block per
// SM, each block a contiguous run of ceil(M / SMs) rows (at least 64)
// walked in tiles of 128. Warpgroup 0 is the producer: its 128 threads
// stream the layer's weights through a ring of 3-8 stages of Dp x KS bytes
// in the consumers' order, handing them over by mbarriers (`full` when a
// stage has landed, `empty` when both consumers are done with it). K15's
// threads copy by cp.async, each arriving on `full` as its copies land;
// K12's load their packed units of a stage before they wait for it, then
// unpack them into it (one round of L2 latency a stage, not one a unit).
// Eight consecutive threads fill one 128-byte core matrix (8 rows). The two
// consumer warpgroups (setmaxnreg: 232 registers a thread for bf16, 208 for
// W4, whose producer keeps 88 to unpack) take 64 rows each of a tile, and
// both read each weight stage, so one pass over the weights serves 128
// rows. Per tile a consumer loads its attn rows (16-byte loads, stored as
// wgmma's K-major core matrices) and x into z1's fp32 rows, runs proj on
// bf16 wgmma (m64nDpk16, A and B from shared memory) and adds fma(acc, s,
// b) into z1, writes LN2's bf16 over the attn operand (one warp a row),
// then walks the hidden lanes in chunks of 64: FC1 (N = 64; its first step
// overwrites the sums: scale-d 0) -> bias, GELU, bf16 in registers ->
// FC2's partial product with A from those registers (the FC1 sums' pairs
// are already the register-A layout) into sums that stay in registers over
// all of Hp. While one consumer runs its GELU, the other's products keep
// the tensor cores busy. The output goes out through z1's rows (columns
// XOR-swizzled by row) in 16-byte stores. A consumer with no rows in a
// tile only passes the stages on; a warp with no rows skips its LN2 and
// GELU. No wgmma sits under a branch, and nothing but a wgmma writes a
// product's sums while products are in flight (ptxas serializes every
// wgmma of a kernel otherwise: C7520, C7515).
// Shared memory: z1 128 x Dp x 4, the A operand 128 x Dp x 2, the scales
// and biases (2 Dp + Hp) x 8 ({s, s, b, b} a column pair), the ring, 2
// mbarriers a stage. The GELU chunk never reaches shared memory, which is
// what makes Dp 256 fit: 206,848 fixed bytes at Dp 256 / Hp 768 leave
// three stages of 256 x 32 bytes (one k16 step each); at Dp 192 six stages
// of 192 x 64 bytes (two k16 steps) fit beside 156,672.
#pragma once

#include <type_traits>

#include "launch.cuh"
#include "sm90.cuh"
#include "vit_common.cuh"

namespace dlq {
namespace post_hw {

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int HC = 64;           // hidden lanes of an FC1 -> FC2 chunk
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int MAX_STAGES = 8, MIN_STAGES = 3;

struct Args {
  const void* y;
  const __nv_bfloat16* attn;
  const void* wproj;
  const float* sproj;   // the scale rows: W4 only
  const float* bproj;
  const float* ln;      // [2, Dp]: LN2 g, b
  const void* wfc1;
  const float* sfc1;
  const float* bfc1;
  const void* wfc2;
  const float* sfc2;
  const float* bfc2;
  void* out;
  int M, Hp;
  float inv_n;
  int gelu_tanh;
};

// The launch plan: K bytes a ring stage row, ring stages, dynamic shared
// memory, blocks, rows a block (ks == 0: no Hopper plan, the first form).
struct Plan {
  int ks, stages, smem, grid, rows;
};

// K bytes a stage row at each Dp the Hopper form takes (0: none).
__host__ __device__ constexpr int stage_k(int Dp) {
  return Dp == 128 || Dp == 192 ? 64 : Dp == 256 ? 32 : 0;
}

inline Plan make_plan(int Dp, int Hp, int M, int sms) {
  Plan p{0, 0, 0, 0, 0};
  const int ks = stage_k(Dp);
  if (ks == 0 || Hp <= 0 || Hp % HC != 0) return p;
  const int fixed = BM * Dp * 6 + (2 * Dp + Hp) * 8, stage = Dp * ks + 16;
  int stages = (SMEM_OPT_IN - fixed) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  if (stages < MIN_STAGES) return p;
  const int per = (M + sms - 1) / sms;
  const int rows = per > 64 ? per : 64;
  return {ks, stages, fixed + stages * stage, (M + rows - 1) / rows, rows};
}

// f(std::integral_constant<int, I>) for I = B .. E - 1, in order.
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

template <bool W4, class T, class TO, int DP>
__global__ void __launch_bounds__(THREADS, 1) kernel(const Args a, const Plan pl) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int KS = stage_k(DP);         // K bytes a row of a proj or FC2 stage
  constexpr int STAGE = DP * KS;          // bytes of a ring stage
  constexpr int KB1 = KS * DP / 64;       // K bytes a row of an FC1 stage (64 rows)
  constexpr int PROJ_STAGES = 2 * DP / KS;
  constexpr int CHUNK_STAGES = 128 / KS;  // FC1's stages of a chunk, and FC2's
  constexpr int LDA = 2 * DP;             // bytes of an A operand row
  constexpr int PT = 128;                 // producer threads
  // registers a thread after setmaxnreg (168 at launch; what the producer
  // warpgroup gives up, the two consumers take): K12's producer holds a
  // stage's packed loads across its wait for the stage and needs more than
  // 56 (at 56 the kernel faulted now and then; 72 and 88 ran clean)
  constexpr int PRODUCER_REGS = W4 ? 88 : 40;
  constexpr int CONSUMER_REGS = 168 + (168 - PRODUCER_REGS) / 2;
  // K12's 16-byte packed units a producer thread unpacks a stage (at most)
  constexpr int W4_UNITS = ((DP * KS / 32 > 2 * KB1 ? DP * KS / 32 : 2 * KB1) + PT - 1) / PT;
  const int S = pl.stages;
  float* Z = reinterpret_cast<float*>(smem);                        // [BM][DP] z1, swizzled (zcol)
  uint8_t* Atile = smem + BM * DP * 4;                              // 2 x [64 x LDA] attn, then h2
  // {s[n], s[n+1], b[n], b[n+1]} for each column pair of proj, FC2 and FC1
  float4* SBP = reinterpret_cast<float4*>(Atile + BM * LDA);
  float4* SB2 = SBP + DP / 2;
  float4* SB1 = SB2 + DP / 2;
  uint8_t* ring = reinterpret_cast<uint8_t*>(SB1 + a.Hp / 2);     // S x STAGE weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  const int m_begin = blockIdx.x * pl.rows;
  const int m_end = min(a.M, m_begin + pl.rows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, PT);   // each producer thread (bf16: as its copies land)
      sm90::mbar_init(empty + s, 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ---- producer: the weights in the consumers' order, as bf16 stages ----
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= PT) return;
    const int pt = threadIdx.x;
    int stage = 0, phase = 0;
    // a stage of `rows` weight rows of K values each: K values [k0, k0 + kb / 2)
    // of every row, kb bytes a row in K-major core matrices. Eight
    // consecutive threads fill one 128-byte core matrix (8 rows).
    auto put = [&](const uint8_t* w, int rows, int K, int k0, int kb) {
      if constexpr (W4) {
        // every packed load of the stage first (they need no free stage),
        // then the wait for the stage, then the unpacked stores
        const int kh = K / 2, b0 = k0 < kh ? k0 : k0 - kh, sh = k0 < kh ? 0 : 4;
        const int upr = kb / 32, units = rows * upr;   // 16-byte packed units (16 K values)
        uint4 p[W4_UNITS];
        int off[W4_UNITS];
#pragma unroll
        for (int i = 0; i < W4_UNITS; ++i) {
          const int u = pt + PT * i, grp = u >> 3, n = (u & 7) + 8 * (grp / upr), j = grp % upr;
          off[i] = sm90::core_off(n, 32 * j, kb);
          if (u < units) p[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)n * kh + b0 + 16 * j));
        }
        sm90::mbar_wait(empty + stage, phase ^ 1);
        uint8_t* dst = ring + stage * STAGE;
#pragma unroll
        for (int i = 0; i < W4_UNITS; ++i) {
          if (pt + PT * i >= units) continue;
          uint4 lo, hi;
          unpack16(p[i], sh, lo, hi);
          *reinterpret_cast<uint4*>(dst + off[i]) = lo;         // K values 16 j ..
          *reinterpret_cast<uint4*>(dst + off[i] + 128) = hi;   // .. and 16 j + 8 (next core matrix)
        }
        sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
        sm90::mbar_arrive(full + stage);
      } else {
        sm90::mbar_wait(empty + stage, phase ^ 1);
        uint8_t* dst = ring + stage * STAGE;
        const int cpr = kb / 16;   // 16-byte pieces a row
        for (int c = pt; c < rows * cpr; c += PT) {
          const int grp = c >> 3, n = (c & 7) + 8 * (grp / cpr), q = 16 * (grp % cpr);
          cp_async16(dst + sm90::core_off(n, q, kb), w + ((size_t)n * K + k0) * 2 + q, true);
        }
        sm90::mbar_arrive_cp_async(full + stage);   // when this thread's copies land
      }
      if (++stage == S) stage = 0, phase ^= 1;
    };
    const uint8_t* wproj = static_cast<const uint8_t*>(a.wproj);
    const uint8_t* wfc1 = static_cast<const uint8_t*>(a.wfc1);
    const uint8_t* wfc2 = static_cast<const uint8_t*>(a.wfc2);
    constexpr int ROW1 = W4 ? DP / 2 : DP * 2;   // bytes of a wfc1 row
    auto fc1 = [&](int c) {
      for (int k = 0; k < DP; k += KB1 / 2) put(wfc1 + (size_t)c * ROW1, HC, DP, k, KB1);
    };
    auto fc2 = [&](int c) {
      for (int k = c; k < c + HC; k += KS / 2) put(wfc2, DP, a.Hp, k, KS);
    };
    for (int m0 = m_begin; m0 < m_end; m0 += BM) {
      for (int k = 0; k < DP; k += KS / 2) put(wproj, DP, DP, k, KS);
      for (int c = 0; c < a.Hp; c += HC) fc1(c), fc2(c);
    }
    if constexpr (!W4) cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile ----
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ctid = threadIdx.x - 128 * wg;
  const int warp = ctid >> 5, lane = ctid & 31;
  uint8_t* As = Atile + cw * 64 * LDA;
  float* Zw = Z + cw * 64 * DP;
  // z1's row r, column c: columns XORed by 8 (r mod 8), so that the 8 rows
  // of an accumulator fragment hit distinct banks (8-column groups stay whole)
  auto zcol = [](int r, int c) { return r * DP + (c ^ ((r & 7) << 3)); };
  const T* y = static_cast<const T*>(a.y);
  TO* out = static_cast<TO*>(a.out);
  const bool tanh_approx = a.gelu_tanh != 0;
  auto wg_sync = [&]() { sm90::named_bar(1 + cw, 128); };

  int stage = 0, phase = 0, held = -1;
  // wait for the next stage, issue(B) its products, keep one group in flight
  auto consume = [&](auto&& issue) {
    sm90::mbar_wait(full + stage, phase);
    sm90::fence_proxy_async();   // the stage's cp.async writes, to wgmma's reads
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

  for (int i = threadIdx.x - 128; i < max(a.Hp, DP) / 2; i += 256) {
    if (i < a.Hp / 2)
      SB1[i] = make_float4(W4 ? a.sfc1[2 * i] : 1.0f, W4 ? a.sfc1[2 * i + 1] : 1.0f,
                           a.bfc1[2 * i], a.bfc1[2 * i + 1]);
    if (i < DP / 2) {
      SBP[i] = make_float4(W4 ? a.sproj[2 * i] : 1.0f, W4 ? a.sproj[2 * i + 1] : 1.0f,
                           a.bproj[2 * i], a.bproj[2 * i + 1]);
      SB2[i] = make_float4(W4 ? a.sfc2[2 * i] : 1.0f, W4 ? a.sfc2[2 * i + 1] : 1.0f,
                           a.bfc2[2 * i], a.bfc2[2 * i + 1]);
    }
  }
  sm90::named_bar(3, 256);

  constexpr int ITER = 64 * (DP / 8) / 128;   // 8-lane pieces of a 64-row slab, per thread
  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const int r0 = m0 + 64 * cw;
    const int rows = max(0, min(64, m_end - r0));
    if (rows == 0) {
      const int n = PROJ_STAGES + a.Hp / HC * 2 * CHUNK_STAGES;   // a tile's stages
      for (int i = 0; i < n; ++i) pass();
      continue;
    }
    // 1. attn -> the A operand (K-major core matrices; eight consecutive
    //    threads store 8 rows of one), the residual x -> z1's rows in fp32
    //    (rows past the tile's are zero): 16-byte loads, all issued first
    {
      int4 raw[ITER];
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int c = ctid + 128 * i, grp = c >> 3;
        const int r = (c & 7) + 8 * (grp / (DP / 8)), k = 8 * (grp % (DP / 8));
        raw[i] = r < rows ? *reinterpret_cast<const int4*>(a.attn + (size_t)(r0 + r) * DP + k)
                          : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x[ITER / 2][8];
#pragma unroll
        for (int i = 0; i < ITER / 2; ++i) {
          const int c = ctid + 128 * (i + half * ITER / 2), r = c / (DP / 8), k = (c - r * (DP / 8)) * 8;
          if (r < rows) load8(y + (size_t)(r0 + r) * DP + k, x[i]);
          else for (int e = 0; e < 8; ++e) x[i][e] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ITER / 2; ++i) {
          const int c = ctid + 128 * (i + half * ITER / 2), r = c / (DP / 8), k = (c - r * (DP / 8)) * 8;
          float4* z = reinterpret_cast<float4*>(Zw + zcol(r, k));
          z[0] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
          z[1] = make_float4(x[i][4], x[i][5], x[i][6], x[i][7]);
        }
      }
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int c = ctid + 128 * i, grp = c >> 3;
        const int r = (c & 7) + 8 * (grp / (DP / 8)), k = 8 * (grp % (DP / 8));
        *reinterpret_cast<int4*>(As + sm90::core_off(r, 2 * k, LDA)) = raw[i];
      }
    }
    // the next tile's attn and x rows into L2 (two bulk prefetches)
    if (m0 + BM < m_end && ctid == 0) {
      const int nr = min(64, m_end - (r0 + BM));
      if (nr > 0) {
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                     ::"l"(a.attn + (size_t)(r0 + BM) * DP), "r"(nr * DP * 2) : "memory");
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                     ::"l"(y + (size_t)(r0 + BM) * DP), "r"(nr * DP * (int)sizeof(T)) : "memory");
      }
    }
    float lg[DP / 32], lb[DP / 32];   // LN2's g and b at this lane's columns (lane + 32 j)
#pragma unroll
    for (int j = 0; j < DP / 32; ++j) lg[j] = a.ln[lane + 32 * j], lb[j] = a.ln[DP + lane + 32 * j];
    sm90::fence_proxy_async();
    wg_sync();

    // 2. proj: z1 = x + fma(acc, s, b)
    {
      float acc[DP / 2];
      sm90::zero(acc);
#pragma unroll 1
      for (int s = 0; s < PROJ_STAGES; ++s)
        consume([&](const uint8_t* B) {
#pragma unroll
          for (int j = 0; j < KS / 32; ++j)
            sm90::wgmma_bf16<DP>(acc, sm90::desc(As, LDA, s * KS + 32 * j), sm90::desc(B, KS, 32 * j));
        });
      drain();
      sm90::fence_acc(acc);
      sm90::for_pairs<DP>(acc, ctid, [&](int r, int n, float v0, float v1) {
        const float4 sb = SBP[n >> 1];
        float2* zp = reinterpret_cast<float2*>(Zw + zcol(r, n));
        const float2 x = *zp;
        *zp = make_float2(__fadd_rn(x.x, __fmaf_rn(v0, sb.x, sb.z)),
                          __fadd_rn(x.y, __fmaf_rn(v1, sb.y, sb.w)));
      });
    }
    wg_sync();

    // 3. h2 = bf16(LN2(z1)) over the attn operand (one warp a row; rows past
    //    the tile's keep what they hold, and their outputs are never stored)
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int r = warp + 4 * i;
      if (r >= rows) continue;
      float v[DP / 32], sum = 0.0f, sq = 0.0f;
#pragma unroll
      for (int j = 0; j < DP / 32; ++j) {
        v[j] = Zw[zcol(r, lane + 32 * j)];
        ln_acc(sum, sq, v[j]);
      }
      float mu, rs;
      ln_stats(sum, sq, a.inv_n, 1e-6f, mu, rs);
#pragma unroll
      for (int j = 0; j < DP / 32; ++j)
        *reinterpret_cast<__nv_bfloat16*>(As + sm90::core_off(r, 2 * (lane + 32 * j), LDA)) =
            __float2bfloat16_rn(ln_apply(v[j], mu, rs, lg[j], lb[j]));
    }
    sm90::fence_proxy_async();
    wg_sync();

    // 4. per 64 hidden lanes: FC1 -> bias, GELU, bf16 in registers -> FC2's
    //    partial product with A from those registers (FC2's sums stay in
    //    registers over all of Hp)
    const bool live = 16 * warp < rows;   // this warp has rows in the tile
    float acc2[DP / 2];
    sm90::zero(acc2);
    // af[kk]: the k16 step kk (hidden lanes c0 + 16 kk ..) of FC2's A:
    // acc1[8 kk + 2 q], acc1[8 kk + 2 q + 1] are row g + 8 (q & 1), columns
    // 16 kk + 8 (q >> 1) + 2 t and + 1: register q of the step. Declared
    // across the chunks, so that they stay put while a chunk's FC2 reads them.
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) af[kk][q] = 0u;
    float acc1[HC / 2];
    sm90::zero(acc1);
    // FC1 stage s of a chunk (K bytes s KB1 ..) into acc1 (its first step
    // overwrites acc1: scale-d 0)
    auto fc1_stage = [&](int s) {
      consume([&](const uint8_t* B) {
#pragma unroll
        for (int j = 0; j < KB1 / 32; ++j)
          sm90::wgmma_bf16<HC>(acc1, sm90::desc(As, LDA, s * KB1 + 32 * j),
                               sm90::desc(B, KB1, 32 * j), s + j > 0);
      });
    };
    // bias, GELU, bf16 of chunk c0's FC1 sums into af
    auto gelu_af = [&](int c0, auto tanh_c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kk + 2 * q, col = 16 * kk + 8 * (q >> 1) + 2 * (lane & 3);
          const float4 sb = SB1[(c0 + col) >> 1];
          af[kk][q] = pack_bf16(gelu(__fmaf_rn(acc1[i], sb.x, sb.z), decltype(tanh_c)::value),
                                gelu(__fmaf_rn(acc1[i + 1], sb.y, sb.w), decltype(tanh_c)::value));
        }
    };
    auto fc2 = [&]() {
      static_for<0, CHUNK_STAGES>([&](auto s) {
        consume([&](const uint8_t* B) {
          static_for<0, KS / 32>([&](auto j) {
            sm90::wgmma_bf16_ra<DP>(acc2, af[decltype(s)::value * (KS / 32) + decltype(j)::value],
                                    sm90::desc(B, KS, 32 * decltype(j)::value));
          });
        });
      });
    };
    // chunk by chunk: FC1, then its GELU, then FC2 (the other consumer's
    // products run meanwhile); a warp with no rows in the tile leaves af as
    // it is (rows past the tile's are never stored)
#pragma unroll 1
    for (int c0 = 0; c0 < a.Hp; c0 += HC) {
#pragma unroll
      for (int s = 0; s < CHUNK_STAGES; ++s) fc1_stage(s);
      drain();   // also ends the previous chunk's FC2, which read af
      sm90::fence_acc(acc1);
      if (live && tanh_approx) gelu_af(c0, std::true_type{});
      else if (live) gelu_af(c0, std::false_type{});
      fc2();
    }
    drain();
    sm90::fence_acc(acc2);

    // 5. out = z1 + fma(acc, s, b) (W4) | (z1 + acc) + b (bf16) into z1's rows
    //    (every row), then the tile's rows out in 16-byte stores
    sm90::for_pairs<DP>(acc2, ctid, [&](int r, int n, float v0, float v1) {
      float2* zp = reinterpret_cast<float2*>(Zw + zcol(r, n));
      const float2 z = *zp;
      const float4 sb = SB2[n >> 1];
      if constexpr (W4)
        *zp = make_float2(__fadd_rn(z.x, __fmaf_rn(v0, sb.x, sb.z)),
                          __fadd_rn(z.y, __fmaf_rn(v1, sb.y, sb.w)));
      else
        *zp = make_float2(__fadd_rn(__fadd_rn(z.x, v0), sb.z), __fadd_rn(__fadd_rn(z.y, v1), sb.w));
    });
    wg_sync();
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int c = ctid + 128 * i, r = c / (DP / 8), k = (c - r * (DP / 8)) * 8;
      if (r >= rows) continue;
      float v[8];
      const float4* z = reinterpret_cast<const float4*>(Zw + zcol(r, k));
      const float4 lo = z[0], hi = z[1];
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      store8(out + (size_t)(r0 + r) * DP + k, v);
    }
    wg_sync();
  }
}

// The shared-memory opt-in: once per device and instantiation (launch.cuh).
template <bool W4, class T, class TO, int DP>
cudaError_t launch_k(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  const cudaError_t e = opt_in<kernel<W4, T, TO, DP>>(dev);
  if (e != cudaSuccess) return e;
  kernel<W4, T, TO, DP><<<pl.grid, THREADS, pl.smem, st>>>(a, pl);
  return cudaGetLastError();
}

template <bool W4, int DP>
cudaError_t launch_dp(const Args& a, int y_f32, int out_f32, const Plan& pl, int dev,
                      cudaStream_t st) {
  using BF = __nv_bfloat16;
  if (y_f32)
    return out_f32 ? launch_k<W4, float, float, DP>(a, pl, dev, st)
                   : launch_k<W4, float, BF, DP>(a, pl, dev, st);
  return out_f32 ? launch_k<W4, BF, float, DP>(a, pl, dev, st)
                 : launch_k<W4, BF, BF, DP>(a, pl, dev, st);
}

// The form a launch at (Dp, Hp) takes: 1 the Hopper form (a plan of at
// least MIN_STAGES stages exists), 0 the first form.
inline int form(int Dp, int Hp) { return make_plan(Dp, Hp, 1, 1).ks != 0 ? 1 : 0; }

// The plan for the C entries: out = {ks, stages, smem, grid, rows} on `sms`
// SMs (0: this card's).
inline int plan_entry(int Dp, int Hp, int M, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p = make_plan(Dp, Hp, M, sms);
  out[0] = p.ks, out[1] = p.stages, out[2] = p.smem, out[3] = p.grid, out[4] = p.rows;
  return 0;
}

// The Hopper form (the caller has checked form(Dp, Hp)): the arguments of
// post_h::launch.
template <bool W4>
int launch(const void* y, int y_f32, const __nv_bfloat16* attn, const void* wproj,
           const float* sproj, const float* bproj, const float* ln, const void* wfc1,
           const float* sfc1, const float* bfc1, const void* wfc2, const float* sfc2,
           const float* bfc2, void* out, int out_f32, int M, int Dp, int Hp, int d_valid,
           int gelu_tanh, void* stream) {
  if (d_valid <= 0 || d_valid > Dp) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t e = device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const Plan pl = make_plan(Dp, Hp, M, sms);
  if (pl.ks == 0) return (int)cudaErrorInvalidValue;
  const Args a{y, attn, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1, wfc2, sfc2, bfc2, out, M, Hp,
               (float)(1.0 / (double)d_valid), gelu_tanh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dp == 128) return (int)launch_dp<W4, 128>(a, y_f32, out_f32, pl, dev, st);
  if (Dp == 192) return (int)launch_dp<W4, 192>(a, y_f32, out_f32, pl, dev, st);
  return (int)launch_dp<W4, 256>(a, y_f32, out_f32, pl, dev, st);
}

}  // namespace post_hw
}  // namespace dlq
