// The launch plan of i8gemm.cuh's Hopper form (K1 conv_int8, K2
// matmul_int8) and K1's slab geometry: plain host arithmetic, mirrored by
// dlq_tpu_torch/ops/i8plan.py (a change to one is made in both places; the
// card tests hold the kernels' own plans to the mirror).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace dlq {
namespace i8 {

constexpr int BM = 128;          // rows an item: two consumer warpgroups of 64
constexpr int KS = 64;           // bytes of K a B stage (two k32 steps)
constexpr int THREADS = 384;
constexpr int PRODUCERS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_MAX = 232448;  // launch.cuh: SMEM_OPT_IN
constexpr int N_NS = 4;
constexpr int NS_CAND[N_NS] = {256, 192, 128, 64};
constexpr int MAX_STAGES = 8, MIN_STAGES = 3;
constexpr int RES_A_STAGES = 4;   // the fewest A stages beside a resident slice
constexpr int CONV_A_STAGES = 2;  // K1's A stages beside a streamed B ring
constexpr int MAX_TAPS = 9;
constexpr int K2_A_STAGE = BM * KS;

// The launch plan: slice width, slices, A stages, B stages (0: the slice is
// resident), dynamic shared-memory bytes, blocks (ns == 0: no plan fits).
struct Plan {
  int ns, slices, a_stages, b_stages, smem, grid;
};

__host__ __device__ constexpr int staging_row(int ns, bool i8) { return i8 ? ns + 16 : ns * 4 + 32; }

inline int plan_bytes(int ns, int sa, int sb, int Kp, int a_bytes, bool i8) {
  const int b = sb > 0 ? sb * ns * KS : ns * Kp;
  return b + sa * a_bytes + 8 * ns + CONSUMER_WARPS * 8 * staging_row(ns, i8) + 16 * (sa + sb + 1);
}

// The plan for `units` A units, N columns, Kp, `taps` B stages an A stage
// and A stages of a_bytes, on `sms` SMs. Each width up to N rounded up to
// 64 takes, with one slice, a resident slice and the most A stages (4 to
// 8) that fit; else a streamed B ring: K2 (taps 1) the most paired stages
// (3 to 8), K1 two A stages and the most B stages (3 to 8). Of those the
// fewest padded columns wins, the wider on a tie; but when that leaves
// fewer items than SMs, width 64.
inline Plan make_plan(int units, int N, int Kp, int taps, int a_bytes, bool i8, int sms) {
  Plan best{0, 0, 0, 0, 0, 0}, narrow{0, 0, 0, 0, 0, 0};
  const int n64 = (N + 63) / 64 * 64;
  for (int i = 0; i < N_NS; ++i) {
    const int ns = NS_CAND[i];
    if (ns > n64) continue;
    const int slices = (N + ns - 1) / ns;
    Plan p{0, 0, 0, 0, 0, 0};
    if (slices == 1) {
      for (int sa = MAX_STAGES; sa >= RES_A_STAGES && p.ns == 0; --sa) {
        const int bytes = plan_bytes(ns, sa, 0, Kp, a_bytes, i8);
        if (bytes <= SMEM_MAX) p = Plan{ns, 1, sa, 0, bytes, 0};
      }
    }
    for (int sb = MAX_STAGES; sb >= MIN_STAGES && p.ns == 0; --sb) {
      const int sa = taps == 1 ? sb : CONV_A_STAGES;
      const int bytes = plan_bytes(ns, sa, sb, Kp, a_bytes, i8);
      if (bytes <= SMEM_MAX) p = Plan{ns, slices, sa, sb, bytes, 0};
    }
    if (p.ns == 0) continue;
    if (best.ns == 0 || p.slices * p.ns < best.slices * best.ns) best = p;
    if (ns == 64) narrow = p;
  }
  if (best.ns == 0) return best;
  if (units * best.slices < sms && narrow.ns != 0) best = narrow;
  const int per = sms / best.slices;   // blocks a slice
  best.grid = best.slices <= sms ? best.slices * (units < per ? units : per) : sms;
  return best;
}

// K1's slab geometry (host): grid width, rows an item, row blocks an image,
// images an item, slab pixels a chunk, planes; gw == 0 when the Hopper form
// does not take the conv (C % 64 != 0, a kernel other than 1x1 / 3x3 with
// pad k / 2, a stride other than 1 / 2, or a grid wider than 128).
struct ConvGeo {
  int gw, toh, rb, imgs, spx, planes;
};

inline ConvGeo conv_geo(int H, int W, int C, int KH, int KW, int stride, int pad) {
  ConvGeo g{0, 0, 0, 0, 0, 0};
  if (C % 64 != 0 || KH != KW || (KH != 1 && KH != 3) || pad != KH / 2 ||
      (stride != 1 && stride != 2))
    return g;
  const int oh = (H + 2 * pad - KH) / stride + 1, ow = (W + 2 * pad - KW) / stride + 1;
  const int e = (KH - 1) / stride;
  const int gw = ow + e;
  if (oh <= 0 || ow <= 0 || gw > BM) return g;
  if (oh * gw <= 64) {
    g.imgs = 2, g.toh = oh, g.rb = 1;
  } else {
    const int t0 = BM / gw;
    g.imgs = 1, g.rb = (oh + t0 - 1) / t0, g.toh = (oh + g.rb - 1) / g.rb;
  }
  g.gw = gw;
  g.spx = ((g.imgs == 1 ? BM : 64) + e * gw + e + 7) / 8 * 8;
  g.planes = (stride == 2 && KH == 3) ? 4 : 1;
  return g;
}

inline int conv_a_bytes(const ConvGeo& g) { return g.imgs * g.planes * 4 * g.spx * 16; }

}  // namespace i8
}  // namespace dlq
