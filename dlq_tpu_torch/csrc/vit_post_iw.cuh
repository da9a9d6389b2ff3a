// The Hopper form of the last two thirds of a ViT layer with int8
// activations, shared by K7 vit_post_w8 (int8 weights, vit_post_w8.cu) and
// K9 vit_post_w4a8 (int4 halves-packed weights, vit_post_w4a8.cu). It
// computes what vit_post.cuh's body (their first form) computes, bit for
// bit (exact int32 sums, the same device functions for every rounding):
//   z1  = x + fma(acc_proj, s, b),      acc_proj = quant(attn, inv_proj) @ wproj
//   f   = gelu(fma(acc_fc1, s, b)),     acc_fc1  = quant(LN(z1), inv_fc1) @ wfc1
//   out = z1 + fma(acc_fc2, s, b)       (multi: the stacked association)
//       | fma(acc_fc2, s, z1) + b       (the W8 single-block kernels')
//                                       acc_fc2  = quant(f, inv_fc2) @ wfc2
//
// Design (Dp 128, 192 or 256): a persistent grid of one block per SM, each
// block a contiguous run of ceil(M / SMs) rows (at least 64) walked in
// tiles of 128 (the last one short: at batch 256, 388 rows = 3 tiles and 4
// rows), so no wave is left with a few blocks. A block is three
// warpgroups. The first is the producer: it streams the layer's weights
// through a ring of 3-8 stages of Dp x 64 int8 bytes (as many as the
// shared memory leaves: 7 at Dp 192, 3 at Dp 256), handing each over by
// mbarriers (`full` when it has landed, `empty` when both consumers are
// done with it): no block-wide barrier per slice. K7's producer is one warp
// copying by 16-byte cp.async, each lane arriving on `full` as its copies
// land. K9's is the whole warpgroup: each thread loads its 16-byte units of
// a stage's packed bytes before it waits for the stage (one round of L2
// latency a stage, not one a unit), then writes the sign-extended nibbles
// into it as int8 in the same core-matrix layout (eight consecutive threads
// fill one 128-byte core matrix). The two consumer warpgroups (setmaxnreg:
// 232 registers a thread for K7, whose producer drops to 40; 208 for K9,
// whose producer keeps 88 to hold its loads across the wait) take 64 rows
// each of the tile and run every product on int8 wgmma (m64nNk32, s8 x s8
// -> s32, both operands in shared memory as 8 x 16-byte core matrices, no
// swizzle): both read each weight stage, so one pass over the weights
// serves 128 rows. Per tile a consumer loads its attn and x rows with
// 16-byte loads (all issued before use; the next tile's rows go to L2 by
// two bulk prefetches), writes attn's int8 codes (K-major) and x in fp32
// into z1's rows, runs proj (N = Dp) and adds fma(acc, s, b) into z1,
// writes LN2's codes over the attn codes (one warp a row, 8 rows in
// flight), then walks the hidden lanes in chunks of 64: FC1 (N = 64) ->
// bias, GELU and int8 codes -> FC2's partial product (N = Dp) into sums
// that stay in registers over all of Hp. The ring runs ahead across phases
// and tiles, so the next product's first stages land during the LN2, GELU
// and output epilogues. The output goes out through z1's rows (columns
// XOR-swizzled by row, so fragment stores hit distinct banks) in 16-byte
// stores. The scales and biases of the three products sit in shared memory
// as {s, s, b, b} per column pair.
//
// K9's K order. A stage of K9 holds 32 packed bytes of each weight row:
// their low nibbles are K slots 0-31 (K values b0 .. b0 + 31), their high
// nibbles K slots 32-63 (K values b0 + Kp/2 ..), where byte b of a row holds
// K values b and b + Kp/2 (the reference's halves packing). The consumer
// runs a stage as its two k32 steps with the A descriptor on the matching
// columns of the codes (b0 and Kp/2 + b0), so each packed byte is read
// once and no stage straddles the halves (Kp/2 = 96 at Dp 192 is no
// multiple of 64). FC2 (K = Hp) is walked the same way: a hidden chunk is
// lanes c .. c + 31 and c + Hp/2 .. c + Hp/2 + 31, FC1 computes exactly
// those 64 rows of wfc1 (with their scales and biases), the GELU codes lay
// them out in that order, and FC2's stage is packed bytes c .. c + 31 of
// each row. Every sum is an exact int32, so the order changes nothing.
//
// Shared memory: z1 128 x Dp x 4, codes 128 x Dp, GELU codes 128 x 64, the
// scales and biases (2 Dp + Hp) x 8, the ring, 2 mbarriers a stage:
// 231,472 bytes at Dp 256 / Hp 768 (3 stages), 226,416 at Dp 192 (7), of
// the 232,448 allowed after the opt-in.
#pragma once

#include <type_traits>

#include "launch.cuh"
#include "sm90.cuh"
#include "vit_post.cuh"

namespace dlq {
namespace post_iw {

using vit_post::Args;

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int KS = 64;           // K bytes of a weight stage
constexpr int HC = 64;           // hidden lanes of an FC1 -> FC2 chunk
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int MAX_STAGES = 8, MIN_STAGES = 3;

// The launch plan: ring stages, dynamic shared memory, blocks, rows a block.
struct Plan {
  int stages, smem, grid, rows;
};

inline Plan make_plan(int Dp, int Hp, int M, int sms) {
  const int fixed = BM * Dp * 4 + BM * Dp + BM * HC + (2 * Dp + Hp) * 8, stage = Dp * KS;
  int stages = (SMEM_OPT_IN - fixed - 2 * 8 * MAX_STAGES) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  const int per = (M + sms - 1) / sms;
  const int rows = per > 64 ? per : 64;
  return {stages, fixed + stages * stage + 2 * 8 * stages, (M + rows - 1) / rows, rows};
}

// The Dp and Hp the Hopper form takes: Dp 128, 192 or 256, Hp a multiple of
// the chunk, and a ring of at least MIN_STAGES stages.
inline bool hopper(int Dp, int Hp) {
  return (Dp == 128 || Dp == 192 || Dp == 256) && Hp > 0 && Hp % HC == 0 &&
         make_plan(Dp, Hp, 1, 1).stages >= MIN_STAGES;
}

template <bool W4, class T, class TO, int DP>
__global__ void __launch_bounds__(THREADS, 1) kernel(const Args a, const Plan pl) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int STAGE = DP * KS;
  constexpr int PT = W4 ? 128 : 32;   // producer threads
  // registers a thread after setmaxnreg (168 at launch; what the producer
  // warpgroup gives up, the two consumers take): K9's producer holds a
  // stage's packed loads across its wait for the stage, as K12's does
  // (vit_post_hw.cuh, which faulted now and then at 56 and ran clean at 88)
  constexpr int PRODUCER_REGS = W4 ? 88 : 40;
  constexpr int CONSUMER_REGS = 168 + (168 - PRODUCER_REGS) / 2;
  constexpr int W4_UNITS = DP / 64;   // K9's 16-byte packed units a thread, a stage (at most)
  const int S = pl.stages;
  float* Z = reinterpret_cast<float*>(smem);              // [BM][DP] z1, swizzled (zcol)
  int8_t* Acodes = smem + BM * DP * 4;                    // 2 x [64 x DP] codes (K-major cores)
  int8_t* Hcodes = Acodes + BM * DP;                      // 2 x [64 x HC] GELU codes
  // {s[n], s[n+1], b[n], b[n+1]} for each column pair of proj, FC2 and FC1
  float4* SBP = reinterpret_cast<float4*>(Hcodes + BM * HC);
  float4* SB2 = SBP + DP / 2;
  float4* SB1 = SB2 + DP / 2;
  int8_t* ring = reinterpret_cast<int8_t*>(SB1 + a.Hp / 2);   // S x [DP x KS] weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  const int m_begin = blockIdx.x * pl.rows;
  const int m_end = min(a.M, m_begin + pl.rows);
  // a chunk's first hidden lane steps by HC (K7), or by HC / 2 over the low
  // half with its pair HC / 2 lanes into the high half (K9)
  const int chunk_end = W4 ? a.Hp / 2 : a.Hp;
  constexpr int CHUNK_STEP = W4 ? HC / 2 : HC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, PT);     // each producer thread (K7: as its copies land)
      sm90::mbar_init(empty + s, 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ---- producer: the weights in the consumers' order ----
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= PT) return;
    const int pt = threadIdx.x;
    int stage = 0, phase = 0;
    auto next = [&]() {
      if (++stage == S) stage = 0, phase ^= 1;
    };
    if constexpr (W4) {
      // a stage of `rows` weight rows: packed bytes b0 .. b0 + 31 of row
      // r(n) = n (n < 32) or n + split, kh bytes a row; low nibbles to K
      // bytes 0-31, high nibbles to 32-63. Every packed load of the stage
      // first (they need no free stage), then the wait, then the stores.
      auto put = [&](const uint8_t* w, int rows, int kh, int b0, int split) {
        const int units = 2 * rows;   // 16-byte packed units
        uint4 p[W4_UNITS];
        int off[W4_UNITS];
#pragma unroll
        for (int i = 0; i < W4_UNITS; ++i) {
          const int u = pt + PT * i, grp = u >> 3, n = (u & 7) + 8 * (grp >> 1), j = grp & 1;
          off[i] = sm90::core_off(n, 16 * j, KS);
          if (u < units)
            p[i] = __ldg(reinterpret_cast<const uint4*>(
                w + (size_t)(n < 32 ? n : n + split) * kh + b0 + 16 * j));
        }
        sm90::mbar_wait(empty + stage, phase ^ 1);
        int8_t* dst = ring + stage * STAGE;
#pragma unroll
        for (int i = 0; i < W4_UNITS; ++i) {
          if (pt + PT * i >= 2 * rows) continue;
          const uint4 q = p[i];
          *reinterpret_cast<uint4*>(dst + off[i]) =   // K slots 16 j .. (low nibbles)
              make_uint4(nib_sx(q.x), nib_sx(q.y), nib_sx(q.z), nib_sx(q.w));
          *reinterpret_cast<uint4*>(dst + off[i] + 256) =   // 32 + 16 j .. (high nibbles)
              make_uint4(nib_sx(q.x >> 4), nib_sx(q.y >> 4), nib_sx(q.z >> 4), nib_sx(q.w >> 4));
        }
        sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
        sm90::mbar_arrive(full + stage);
        next();
      };
      const uint8_t* wproj = static_cast<const uint8_t*>(a.wproj);
      const uint8_t* wfc1 = static_cast<const uint8_t*>(a.wfc1);
      const uint8_t* wfc2 = static_cast<const uint8_t*>(a.wfc2);
      for (int m0 = m_begin; m0 < m_end; m0 += BM) {
        for (int b = 0; b < DP / 2; b += 32) put(wproj, DP, DP / 2, b, 0);
        for (int c = 0; c < chunk_end; c += CHUNK_STEP) {
          // FC1's rows c .. c + 31 and c + Hp/2 .. c + Hp/2 + 31
          for (int b = 0; b < DP / 2; b += 32) put(wfc1 + (size_t)c * (DP / 2), HC, DP / 2, b,
                                                   a.Hp / 2 - 32);
          put(wfc2, DP, a.Hp / 2, c, 0);
        }
      }
    } else {
      auto put = [&](const int8_t* w, int rows, int ld, int k0) {
        sm90::mbar_wait(empty + stage, phase ^ 1);
        int8_t* dst = ring + stage * STAGE;
        for (int c = pt; c < rows * (KS / 16); c += 32) {
          const int n = c >> 2, q = (c & 3) * 16;
          cp_async16(dst + sm90::core_off(n, q, KS), w + (size_t)n * ld + k0 + q, true);
        }
        sm90::mbar_arrive_cp_async(full + stage);   // when this lane's copies land
        next();
      };
      const int8_t* wproj = static_cast<const int8_t*>(a.wproj);
      const int8_t* wfc1 = static_cast<const int8_t*>(a.wfc1);
      const int8_t* wfc2 = static_cast<const int8_t*>(a.wfc2);
      for (int m0 = m_begin; m0 < m_end; m0 += BM) {
        for (int k = 0; k < DP; k += KS) put(wproj, DP, DP, k);
        for (int c = 0; c < a.Hp; c += HC) {
          for (int k = 0; k < DP; k += KS) put(wfc1 + (size_t)c * DP, HC, DP, k);
          put(wfc2, DP, a.Hp, c);
        }
      }
      cp_async_wait<0>();
    }
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile ----
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ctid = threadIdx.x - 128 * wg;
  const int warp = ctid >> 5, lane = ctid & 31;
  int8_t* As = Acodes + cw * 64 * DP;
  int8_t* Hs = Hcodes + cw * 64 * HC;
  float* Zw = Z + cw * 64 * DP;
  // z1's row r, column c: columns XORed by 8 (r mod 8), so that the 8 rows
  // of an accumulator fragment hit distinct banks (8-column groups stay whole)
  auto zcol = [](int r, int c) { return r * DP + (c ^ ((r & 7) << 3)); };
  // the codes' column of k32 step h (0, 1) of the stage at K byte k (a
  // multiple of KS): K7's stage is K bytes k .. k + 63, K9's the packed
  // bytes k / 2 .. k / 2 + 31 of each row (K values there and Kp/2 on)
  auto acol = [](int k, int h) { return W4 ? h * (DP / 2) + k / 2 : k + 32 * h; };
  // the hidden lane of column n (0 .. 63) of the chunk at c0
  auto hid = [&](int c0, int n) { return W4 && n >= 32 ? c0 + a.Hp / 2 - 32 + n : c0 + n; };
  const T* y = static_cast<const T*>(a.y);
  TO* out = static_cast<TO*>(a.out);
  const bool tanh_approx = a.gelu_tanh != 0, multi = a.multi != 0;
  auto wg_sync = [&]() { sm90::named_bar(1 + cw, 128); };

  int stage = 0, phase = 0, held = -1;
  bool any = true;   // this warpgroup has rows in the tile (else it only passes stages on)
  // wait for the next stage, issue(B) its products, keep one group in flight
  auto consume = [&](auto&& issue) {
    sm90::mbar_wait(full + stage, phase);
    sm90::fence_proxy_async();   // the stage's cp.async writes, to wgmma's reads
    if (any) {
      sm90::wgmma_fence();
      issue(ring + stage * STAGE);
    }
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

  for (int i = threadIdx.x - 128; i < max(a.Hp, DP) / 2; i += 256) {
    if (i < a.Hp / 2)
      SB1[i] = make_float4(a.sfc1[2 * i], a.sfc1[2 * i + 1], a.bfc1[2 * i], a.bfc1[2 * i + 1]);
    if (i < DP / 2) {
      SBP[i] = make_float4(a.sproj[2 * i], a.sproj[2 * i + 1], a.bproj[2 * i], a.bproj[2 * i + 1]);
      SB2[i] = make_float4(a.sfc2[2 * i], a.sfc2[2 * i + 1], a.bfc2[2 * i], a.bfc2[2 * i + 1]);
    }
  }
  sm90::named_bar(3, 256);

  constexpr int ITER = 64 * (DP / 8) / 128;   // 8-lane pieces of a 64-row slab, per thread
  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const int r0 = m0 + 64 * cw;
    const int rows = max(0, min(64, m_end - r0));
    any = rows > 0;
    // 1. attn -> int8 codes (K-major), and the residual x -> z1's rows in fp32
    //    (rows past the tile's are zero): 16-byte loads, all issued first
    {
      int4 raw[ITER];
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int c = ctid + 128 * i, r = c / (DP / 8), k = (c - r * (DP / 8)) * 8;
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
        const int c = ctid + 128 * i, r = c / (DP / 8), k = (c - r * (DP / 8)) * 8;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = __bfloat162float((e & 1) ? h[e >> 1].y : h[e >> 1].x);
          q[e >> 2] |= (uint32_t)(uint8_t)quant_i8(v, a.inv_proj) << (8 * (e & 3));
        }
        *reinterpret_cast<uint2*>(As + sm90::core_off(r, k, DP)) = make_uint2(q[0], q[1]);
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
      int acc[DP / 2];
      sm90::zero(acc);
      for (int k = 0; k < DP; k += KS)
        consume([&](const int8_t* B) {
          sm90::wgmma_s8<DP>(acc, sm90::desc(As, DP, acol(k, 0)), sm90::desc(B, KS, 0));
          sm90::wgmma_s8<DP>(acc, sm90::desc(As, DP, acol(k, 1)), sm90::desc(B, KS, 32));
        });
      drain();
      sm90::fence_acc(acc);
      sm90::for_pairs<DP>(acc, ctid, [&](int r, int n, int v0, int v1) {
        const float4 sb = SBP[n >> 1];
        float2* zp = reinterpret_cast<float2*>(Zw + zcol(r, n));
        const float2 x = *zp;
        *zp = make_float2(__fadd_rn(x.x, __fmaf_rn(__int2float_rn(v0), sb.x, sb.z)),
                          __fadd_rn(x.y, __fmaf_rn(__int2float_rn(v1), sb.y, sb.w)));
      });
    }
    wg_sync();

    // 3. LN2(z1) -> codes over the attn codes (one warp per row, eight rows
    //    in flight; rows past the tile's are normalized too and never read out)
#pragma unroll 8
    for (int i = 0; i < 16; ++i) {
      const int r = warp + 4 * i;
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
        As[sm90::core_off(r, lane + 32 * j, DP)] =
            quant_i8(ln_apply(v[j], mu, rs, lg[j], lb[j]), a.inv_fc1);
    }
    sm90::fence_proxy_async();
    wg_sync();

    // 4. per 64 hidden lanes: FC1 -> bias, GELU, codes -> FC2's partial product
    //    (FC2's sums stay in registers over all of Hp)
    int acc2[DP / 2];
    sm90::zero(acc2);
    for (int c0 = 0; c0 < chunk_end; c0 += CHUNK_STEP) {
      int acc1[HC / 2];
      sm90::zero(acc1);
      for (int k = 0; k < DP; k += KS)
        consume([&](const int8_t* B) {
          sm90::wgmma_s8<HC>(acc1, sm90::desc(As, DP, acol(k, 0)), sm90::desc(B, KS, 0));
          sm90::wgmma_s8<HC>(acc1, sm90::desc(As, DP, acol(k, 1)), sm90::desc(B, KS, 32));
        });
      drain();   // also ends the previous chunk's FC2, which read Hs
      sm90::fence_acc(acc1);
      // every row (a row past the tile's gives codes that are never read out)
      auto gelu_codes = [&](auto tanh_c) {
        sm90::for_pairs<HC>(acc1, ctid, [&](int r, int n, int v0, int v1) {
          const float4 sb = SB1[hid(c0, n) >> 1];
          const float f0 = __fmaf_rn(__int2float_rn(v0), sb.x, sb.z);
          const float f1 = __fmaf_rn(__int2float_rn(v1), sb.y, sb.w);
          const uint32_t q0 = (uint8_t)quant_i8(gelu(f0, decltype(tanh_c)::value), a.inv_fc2);
          const uint32_t q1 = (uint8_t)quant_i8(gelu(f1, decltype(tanh_c)::value), a.inv_fc2);
          *reinterpret_cast<uint16_t*>(Hs + sm90::core_off(r, n, HC)) = (uint16_t)(q0 | (q1 << 8));
        });
      };
      if (tanh_approx) gelu_codes(std::true_type{});
      else gelu_codes(std::false_type{});
      sm90::fence_proxy_async();
      wg_sync();
      sm90::fence_acc(acc2);
      consume([&](const int8_t* B) {
        sm90::wgmma_s8<DP>(acc2, sm90::desc(Hs, HC, 0), sm90::desc(B, KS, 0));
        sm90::wgmma_s8<DP>(acc2, sm90::desc(Hs, HC, 32), sm90::desc(B, KS, 32));
      });
      sm90::fence_acc(acc2);
    }
    drain();
    sm90::fence_acc(acc2);

    // 5. out = z1 + fma(acc, s, b) | fma(acc, s, z1) + b into z1's rows (every
    //    row), then out in 16-byte stores
    sm90::for_pairs<DP>(acc2, ctid, [&](int r, int n, int v0, int v1) {
      float2* zp = reinterpret_cast<float2*>(Zw + zcol(r, n));
      const float2 z = *zp;
      const float4 sb = SB2[n >> 1];
      const float a0 = __int2float_rn(v0), a1 = __int2float_rn(v1);
      *zp = multi ? make_float2(__fadd_rn(z.x, __fmaf_rn(a0, sb.x, sb.z)),
                                __fadd_rn(z.y, __fmaf_rn(a1, sb.y, sb.w)))
                  : make_float2(__fadd_rn(__fmaf_rn(a0, sb.x, z.x), sb.z),
                                __fadd_rn(__fmaf_rn(a1, sb.y, z.y), sb.w));
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
template <bool W4, int DP, class T, class TO>
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
    return out_f32 ? launch_k<W4, DP, float, float>(a, pl, dev, st)
                   : launch_k<W4, DP, float, BF>(a, pl, dev, st);
  return out_f32 ? launch_k<W4, DP, BF, float>(a, pl, dev, st)
                 : launch_k<W4, DP, BF, BF>(a, pl, dev, st);
}

// The plan for the C entries: out = {stages, smem, grid, rows} on `sms` SMs
// (0: this card's); all 0 where the Hopper form does not serve.
inline int plan_entry(int Dp, int Hp, int M, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  Plan p{0, 0, 0, 0};
  if (hopper(Dp, Hp)) p = make_plan(Dp, Hp, M, sms);
  out[0] = p.stages, out[1] = p.smem, out[2] = p.grid, out[3] = p.rows;
  return 0;
}

// The Hopper form (the caller has checked hopper(Dp, Hp)): the arguments of
// vit_post::run after the kernels.
template <bool W4>
int launch(const void* y, int y_f32, const __nv_bfloat16* attn, float inv_proj, float inv_fc1,
           float inv_fc2, const void* wproj, const float* sproj, const float* bproj,
           const float* ln, const void* wfc1, const float* sfc1, const float* bfc1,
           const void* wfc2, const float* sfc2, const float* bfc2, void* out, int out_f32, int M,
           int Dp, int Hp, int d_valid, int gelu_tanh, int multi, void* stream) {
  if (Hp <= 0 || Hp % HC != 0 || d_valid <= 0 || d_valid > Dp) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t e = device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const Plan pl = make_plan(Dp, Hp, M, sms);
  if (pl.stages < MIN_STAGES) return (int)cudaErrorInvalidValue;
  const Args a{y, attn, inv_proj, inv_fc1, inv_fc2, wproj, sproj, bproj, ln, wfc1, sfc1, bfc1,
               wfc2, sfc2, bfc2, out, M, Dp, Hp, (float)(1.0 / (double)d_valid), gelu_tanh,
               multi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dp == 128) return (int)launch_dp<W4, 128>(a, y_f32, out_f32, pl, dev, st);
  if (Dp == 192) return (int)launch_dp<W4, 192>(a, y_f32, out_f32, pl, dev, st);
  return (int)launch_dp<W4, 256>(a, y_f32, out_f32, pl, dev, st);
}

}  // namespace post_iw
}  // namespace dlq
