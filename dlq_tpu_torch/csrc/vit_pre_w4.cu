// K11: the first third of a W4A16 (weight-only int4) ViT layer: LN1 -> bf16
// -> QKV GEMM of bf16 activations against int4 per-OC weights -> fp32
// epilogue -> bf16 qkv.
//
// Replaces the first third of each layer of
// dlq_tpu/ops/pallas_vit_block.py:vit_block_fused_w4 (:1213, kernel
// _block_kernel_w4 :1191-1193), vit_multiblock_fused_w4 (:1408, :1384-1387)
// and vit_block_fused_w4c (:2045, :2023-2025):
//   h1  = bf16(LN(x))                                         x: bf16 or fp32 [M, Dp]
//   acc = h1 @ W       (bf16 x int4 products, exact; fp32 sums)
//   qkv = bf16(fma(acc, s[n], b[n]))                          -> bf16 [M, 3 Dp]
// The reference's _dot_w4a (:1150-1168) sums h1[:, :Dp/2] @ lo + h1[:, Dp/2:]
// @ hi and its cached twin one dot over the unpacked weight; the kernel sums
// in the tensor core's order, so its fp32 sums (not its products) may differ
// from either in the last bits. wqkv: [3 Dp, Dp / 2] bytes, byte k of row n
// holding W[k][n] (low nibble) and W[k + Dp/2][n] (high nibble): the
// reference's halves packing on the padded grid, transposed.
//
// Bound: bytes (the residual in, qkv out: ~79 MB at DeiT-Tiny batch 256
// against 11 GFLOP of bf16 products).
//
// Design (Hopper, Dp 128, 192 or 256): K5's form (vit_pre_w8.cu) in bf16.
// A persistent grid of one block per SM, each block a contiguous run of
// ceil(M / SMs) rows (at least 64) walked in tiles of 128. A block is three
// warpgroups. Lane 0 of the producer's warp 3 feeds each consumer's ring
// of y stages (32 x Dp bytes: 8 fp32 or 16 bf16 rows, contiguous in y) by
// bulk copy. Its warps 0-2 stream the weight: the packed bytes stay in L2
// (55 KB at Dp 192) and are unpacked per stage, as K12's producer does
// (vit_post_hw.cuh): each thread loads its 16-byte packed units of a stage
// before it waits for the stage, then writes their exact bf16 nibble
// values (the reference's _unpack_halves_bf16, :1983) into it as K-major
// core matrices (eight consecutive threads fill one). A stage is one
// 192-column slice of the 3 Dp outputs by 32 packed bytes of each row: the
// low nibbles are K slots 0-31 (K values b0 .. b0 + 31), the high ones K
// slots 32-63 (K values Dp/2 + b0 ..), so each packed byte is read once and
// no stage straddles the halves (Dp/2 = 96 at Dp 192). The two consumer
// warpgroups (setmaxnreg: 208 registers a thread; the producer keeps 88 to
// hold its loads across the wait) take 64 rows each of a tile. Each runs
// LN1 on its rows from the y stages, one warp a row with lane l holding
// columns l + 32 j (the first form's arithmetic and reduction order:
// ln_bf16_row), and writes bf16 h1 into its 64 x Dp K-major core-matrix
// tile. Then, per slice, bf16 wgmma m64n192k16 (both operands in shared
// memory, 96 fp32 sums a thread; four k16 steps a stage, each with its A
// descriptor on the matching columns of h1), and the epilogue bf16(fma(acc,
// s, b)) from a table of {s, s, b, b} per column pair, bf16 pairs staged
// per warp in two buffers of 8 rows, each row (384 bytes) handed to the
// bulk-copy engine by one lane. Both consumers read each weight stage, so
// one pass over the weight serves 128 rows; a consumer with no rows in a
// tile only passes the stages on.
// Limiters of the first form (vit_pre_h.cuh's body) that this removes: 800
// blocks of 64 rows each streaming all of the weight through two cp.async
// stages behind block barriers, mma.sync m16n8k16 with the int4 unpacked in
// registers at every fragment (hgemm.cuh: step_h4), 4-byte output stores
// scattered over 1,152-byte rows.
// Shared memory: the ring (stages x 192 x 128 bytes), h1 128 x Dp x 2, the
// table 3 Dp x 8, the staging 8 x 2 x 8 x 400, the y stages 2 x NY x 32 Dp,
// the mbarriers: 227,968 bytes at Dp 192 (4 stages, 2 y stages a consumer),
// 226,448 at Dp 128 (5, 2), 229,488 at Dp 256 (3, 2), of the 232,448
// allowed. The fp32 sums run in the tensor core's order, another than the
// first form's, so the two agree within W4A16's tolerance, not bit for bit.
// Other Dp (multiples of 64 up to 512) run the first form (vit_pre_h.cuh,
// shared with K14).
#include "launch.cuh"
#include "sm90.cuh"
#include "vit_pre_h.cuh"

namespace {

namespace sm90 = dlq::sm90;
using dlq::pre_h::Args;

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int NS = 192;          // output columns a slice (3 Dp is a multiple of 192)
constexpr int PB = 32;           // packed bytes of a weight row a stage
constexpr int KB = 4 * PB;       // bf16 K bytes of a stage row (64 K values, 4 k16 steps)
constexpr int STAGE = NS * KB;   // bytes of a weight stage
constexpr int YB_PER_LANE = 32;  // a y stage: 32 x Dp bytes (8 fp32 rows, 16 bf16 rows)
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int PT = 96;           // unpacking producer threads (warps 0-2)
constexpr int MAX_STAGES = 8, MIN_STAGES = 3, MAX_Y = 4, MIN_Y = 2;
constexpr int STAGE_ROW = 2 * NS + 16;   // bytes of a staged bf16 output row
// registers a thread after setmaxnreg (168 at launch): the producer holds a
// stage's packed loads across its wait for the stage (K12's 88)
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 168 + (168 - PRODUCER_REGS) / 2;

// The launch plan: weight ring stages, y stages a consumer, dynamic shared
// memory, blocks, rows a block (all 0: no Hopper plan, the first form).
struct Plan {
  int stages, ystages, smem, grid, rows;
};

bool hopper_dp(int Dp) { return Dp == 128 || Dp == 192 || Dp == 256; }

Plan make_plan(int Dp, int M, int sms) {
  Plan p{0, 0, 0, 0, 0};
  if (!hopper_dp(Dp)) return p;
  const int fixed = BM * Dp * 2 + 3 * Dp * 8 + 2 * 8 * 8 * STAGE_ROW;
  const int ystage = YB_PER_LANE * Dp + 16, stage = STAGE + 16;   // each with its two mbarriers
  int stages = (dlq::SMEM_OPT_IN - fixed - 2 * MIN_Y * ystage) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  if (stages < MIN_STAGES) return p;
  int ny = (dlq::SMEM_OPT_IN - fixed - stages * stage) / (2 * ystage);
  ny = ny > MAX_Y ? MAX_Y : ny;
  const int per = (M + sms - 1) / sms;
  const int rows = per > 64 ? per : 64;
  return {stages, ny, fixed + stages * stage + 2 * ny * ystage, (M + rows - 1) / rows, rows};
}

template <class T, int DP>
__global__ void __launch_bounds__(THREADS, 1) vit_pre_w4_kernel(const Args a, const Plan pl) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int N = 3 * DP, NJ = DP / 32, YB = YB_PER_LANE * DP, KH = DP / 2, LDA = 2 * DP;
  constexpr int YR = YB / (DP * (int)sizeof(T)), RPW = YR / 4;   // rows a y stage, a warp
  constexpr int UNITS = NS * PB / 16 / PT;                        // packed units a thread, a stage
  static_assert(UNITS * PT == NS * PB / 16, "whole units");
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
      sm90::mbar_init(full + s, PT);   // each unpacking thread
      sm90::mbar_init(empty + s, 2);
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
    // ---- warps 0-2: the weight, slice by slice, unpacked into bf16 stages ----
    const int pt = threadIdx.x;
    const uint8_t* w = static_cast<const uint8_t*>(a.w);
    int stage = 0, phase = 0;
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
            dlq::unpack16(p[i], 0, lo, hi);
            *reinterpret_cast<uint4*>(dst + off[i]) = lo;          // K slots 16 j .. + 7
            *reinterpret_cast<uint4*>(dst + off[i] + 128) = hi;    // + 8 .. + 15 (next core matrix)
            dlq::unpack16(p[i], 4, lo, hi);
            *reinterpret_cast<uint4*>(dst + off[i] + 512) = lo;    // K slots 32 + 16 j ..
            *reinterpret_cast<uint4*>(dst + off[i] + 640) = hi;
          }
          sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
          sm90::mbar_arrive(full + stage);
          if (++stage == S) stage = 0, phase ^= 1;
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
    SB[i] = make_float4(a.s[2 * i], a.s[2 * i + 1], a.b[2 * i], a.b[2 * i + 1]);
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
  // h1's column (bf16) of k16 step kk (0-3) of the stage at packed byte b0
  auto acol = [](int b0, int kk) { return (kk < 2 ? 0 : KH - 32) + b0 + 16 * kk; };

  float acc[NS / 2];
  sm90::zero(acc);
  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const int r0 = m0 + 64 * cw;
    const int rows = max(0, min(64, m_end - r0));
    if (rows == 0) {
      for (int i = 0; i < (N / NS) * (KH / PB); ++i) pass();
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
          v[u][j] = rr < nr ? dlq::load_f(yrows + rr * DP + lane + 32 * j) : 0.0f;
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(yempty + i);   // this warp is done with the stage
      if (++yslot == NY) yslot = 0, yph ^= 1;
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = RPW * warp + u;
        float s = 0.0f, sq = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dlq::ln_acc(s, sq, v[u][j]);
        float mu, rs;
        dlq::ln_stats(s, sq, a.inv_n, 1e-6f, mu, rs);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<__nv_bfloat16*>(As + sm90::core_off(k + rr, 2 * (lane + 32 * j), LDA)) =
              __float2bfloat16_rn(rr < nr ? dlq::ln_apply(v[u][j], mu, rs, lg[j], lb[j]) : 0.0f);
      }
    }
    sm90::fence_proxy_async();   // h1's st.shared, to wgmma
    wg_sync();

    // 2. per slice of 192 columns: products over all of Dp, then the epilogue
    for (int n0 = 0; n0 < N; n0 += NS) {
#pragma unroll 1
      for (int b0 = 0; b0 < KH; b0 += PB)
        consume([&](const uint8_t* B) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // the slice's first step overwrites the sums
            sm90::wgmma_bf16<NS>(acc, sm90::desc(As, LDA, 2 * acol(b0, kk)),
                                 sm90::desc(B, KB, 32 * kk), b0 + kk > 0);
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
template <class T, int DP>
cudaError_t launch(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  const cudaError_t e = dlq::opt_in<vit_pre_w4_kernel<T, DP>>(dev);
  if (e != cudaSuccess) return e;
  vit_pre_w4_kernel<T, DP><<<pl.grid, THREADS, pl.smem, st>>>(a, pl);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_t(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  if (a.Dp == 128) return launch<T, 128>(a, pl, dev, st);
  if (a.Dp == 192) return launch<T, 192>(a, pl, dev, st);
  return launch<T, 256>(a, pl, dev, st);
}

}  // namespace

// The form a launch takes: 1 the Hopper form (Dp 128, 192, 256), 0 the
// first form. A static shape rule (ops/vit_block.py: vit_pre_w4_form).
extern "C" int dlq_vit_pre_w4_form(int Dp) { return hopper_dp(Dp) ? 1 : 0; }

// The launch plan of the Hopper form: out = {weight ring stages, y stages a
// consumer, shared-memory bytes, blocks, rows a block} for Dp and M on `sms`
// SMs (0: this card's); all 0 where the first form serves.
extern "C" int dlq_vit_pre_w4_plan(int Dp, int M, int sms, int* out) {
  if (sms == 0) {
    int dev = 0;
    const cudaError_t e = dlq::device(&dev, &sms);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p = make_plan(Dp, M, sms);
  out[0] = p.stages, out[1] = p.ystages, out[2] = p.smem, out[3] = p.grid, out[4] = p.rows;
  return 0;
}

// y: [M, Dp] bf16 (y_f32 = 0) or fp32; ln: fp32 [2, Dp]; w: uint8 [3 Dp, Dp / 2];
// s, b: fp32 [3 Dp]; out: bf16 [M, 3 Dp] (16-byte aligned). Dp a multiple
// of 64, <= 512. The form by the rule above.
extern "C" int dlq_vit_pre_w4(const void* y, int y_f32, const float* ln, const uint8_t* w,
                              const float* s, const float* b, __nv_bfloat16* out, int M, int Dp,
                              int d_valid, void* stream) {
  if (!hopper_dp(Dp))
    return dlq::pre_h::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
  if (d_valid <= 0 || d_valid > Dp) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t e = dlq::device(&dev, &sms);   // once per device (launch.cuh)
  if (e != cudaSuccess) return (int)e;
  const Plan pl = make_plan(Dp, M, sms);
  if (pl.stages < MIN_STAGES || pl.ystages < MIN_Y) return (int)cudaErrorInvalidValue;
  const Args a{y, ln, w, s, b, out, M, Dp, (float)(1.0 / (double)d_valid)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_f32 ? launch_t<float>(a, pl, dev, st) : launch_t<__nv_bfloat16>(a, pl, dev, st));
}

// The first form at any Dp it takes (the same arguments): what the card
// tests and chip_smoke.py hold the Hopper form to.
extern "C" int dlq_vit_pre_w4_first(const void* y, int y_f32, const float* ln, const uint8_t* w,
                                    const float* s, const float* b, __nv_bfloat16* out, int M,
                                    int Dp, int d_valid, void* stream) {
  return dlq::pre_h::launch<true>(y, y_f32, ln, w, s, b, out, M, Dp, d_valid, stream);
}
