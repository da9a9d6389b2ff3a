// The Hopper form of the int4-weight GEMMs (K10 matmul_int4a8: int8
// activations; K13 matmul_int4: bf16 activations with group-wise scales):
// one warp-specialized, persistent body, parameterized by an operation
// `Op` that says how A's columns map to K, how a packed weight stage becomes
// a wgmma operand, which wgmma to issue and what the epilogue computes.
// K2, the same GEMM with an int8 weight, can take this body with an Op
// whose stage builder copies instead of unpacking.
//
// Work: an item is a 128-row M tile and an N slice of NS columns (64, 128,
// 192 or 256: a wgmma width). Item i is (M tile i / slices, slice i %
// slices); block b walks items b, b + grid, ... (a persistent grid of at
// most one block per SM). When the slice count divides the grid (every
// shape whose slices fit the SMs), a block keeps one slice for its whole
// walk and loads that slice's packed weight once.
//
// A block is three warpgroups (384 threads):
//   warpgroup 0   the producers: keep the slice's packed weight resident in
//                 shared memory (4 bits a value, with K13's bf16 group
//                 scales), and fill a ring of S stages, each an A stage
//                 (128 rows x 64 bytes: one or two 2D TMA boxes, which land
//                 swizzled in the layout wgmma reads, rows past M and
//                 columns past K as zeros) and the matching B stage (NS rows
//                 x 64 bytes in the K-major core-matrix layout of sm90.cuh:
//                 int8 for K10, dequantized bf16 for K13) built from the
//                 resident slice. Each weight element is built once per
//                 128-row item and read by both consumers. One thread
//                 issues the boxes (their bytes counted by the stage's
//                 `full` mbarrier), every thread builds NS / 64 B units and
//                 arrives; the producers wait only on a stage's `empty`
//                 mbarrier, so they run ahead across item boundaries. A's
//                 rows must be 16-byte aligned (TMA's stride rule): K10
//                 with K % 16 != 0 takes its first form.
//   warpgroups 1-2  the consumers: 64 rows of each item each; per stage, two
//                 wgmma k-steps (A and B from shared memory, sums in
//                 registers, one group kept in flight), then the stage goes
//                 back to the producers. After the item's last stage: the
//                 epilogue in registers, each warp's rows staged in shared
//                 memory 8 at a time and handed to the bulk-copy engine
//                 (cp.async.bulk, one copy of 16-byte multiples a row),
//                 which writes them out while the consumers run the next
//                 item's products on stages that landed during this
//                 epilogue.
// No block-wide barrier after the start: the ring hands stages over by
// mbarriers; a block that changes slice syncs its producers (and, for the
// epilogue table, its consumers) by named barriers.
//
// Shared memory (dynamic, opt-in above 48 KB): the ring S x (8192 + NS x
// 64), the packed slice NS x (Kp/2 + 16) (rows padded by 16 bytes so that a
// warp's 16-byte reads of 8 rows hit distinct banks), Op's extras (K13's
// scales), Op's epilogue table, the output staging (8 consumer warps x 8
// rows x (NS x 4 + 32)), 2 mbarriers a stage. make_plan picks NS and S so
// that the total stays within 232,448 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <atomic>
#include <cstdint>

#include "hgemm.cuh"
#include "sm90.cuh"

namespace dlq {
namespace w4 {

constexpr int BM = 128;          // rows an item: two consumer warpgroups of 64
constexpr int KS = 64;           // bytes of a row of an A or B stage
constexpr int A_STAGE = BM * KS;
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCERS = 128;   // warpgroup 0
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_MAX = 232448;
constexpr int N_NS = 4;
constexpr int NS_CAND[N_NS] = {256, 192, 128, 64};
constexpr int MAX_STAGES = 8, MIN_STAGES = 3;

struct Args {
  const int8_t* x;       // A: M rows, ldx bytes apart (int8 for K10, bf16 for K13)
  const uint8_t* w;      // packed weight [N, Kp/2]
  const void* sc;        // K13: bf16 group scales [N, G]
  const float* scale;    // K10: fp32 [N]
  const float* bias;     // fp32 [N]
  float* out;            // fp32 [M, N]
  int M, N, Kp, G, group;
  int ldx;               // A's row bytes (K values x their size)
  int relu;
};

// The launch plan: slice width, slices, ring stages, dynamic shared-memory
// bytes, blocks (ns == 0: no slice fits).
struct Plan {
  int ns, slices, stages, smem, grid;
};

__host__ __device__ __forceinline__ int round16(int b) { return (b + 15) / 16 * 16; }

// A consumer warp's output staging: 8 rows of ns fp32, rows 32 bytes
// longer than ns x 4 so that a warp's 8-byte stores of 8 rows hit distinct
// banks (two wavefronts, the least for 256 bytes).
__host__ __device__ __forceinline__ int stage_row_bytes(int ns) { return ns * 4 + 32; }
__host__ __device__ __forceinline__ int staging_bytes(int ns) {
  return CONSUMER_WARPS * 8 * stage_row_bytes(ns);
}

// Bytes of one (ns, stages) choice: the ring, the packed slice, Op's extras
// and table (`fixed` = extras + table for this ns), the output staging, 2
// mbarriers a stage.
inline int plan_bytes(int ns, int stages, int Kp, int fixed) {
  return stages * (A_STAGE + ns * KS) + ns * (Kp / 2 + 16) + fixed + staging_bytes(ns) +
         16 * stages;
}

// The slice width, slices and stages for M x N on `sms` SMs. Each width up
// to N rounded up to 64 takes the most stages that fit (at most 8, at least
// 3); of those the fewest padded columns wins, the wider on a tie; but when
// that leaves fewer items than SMs (a small M), width 64, so that the items
// still spread over the SMs.
template <class Fixed>
inline Plan make_plan(int M, int N, int Kp, int sms, Fixed&& fixed) {
  Plan best{0, 0, 0, 0, 0}, narrow{0, 0, 0, 0, 0};
  const int n64 = (N + 63) / 64 * 64;
  for (int i = 0; i < N_NS; ++i) {
    const int ns = NS_CAND[i];
    if (ns > n64) continue;
    for (int stages = MAX_STAGES; stages >= MIN_STAGES; --stages) {
      const int bytes = plan_bytes(ns, stages, Kp, fixed(ns));
      if (bytes > SMEM_MAX) continue;
      const Plan p{ns, (N + ns - 1) / ns, stages, bytes, 0};
      if (best.ns == 0 || p.slices * p.ns < best.slices * best.ns) best = p;
      if (ns == 64) narrow = p;
      break;
    }
  }
  if (best.ns == 0) return best;
  const int mt = (M + BM - 1) / BM;
  if (mt * best.slices < sms) best = narrow;
  const int per = sms / best.slices;   // blocks a slice
  best.grid = best.slices <= sms ? best.slices * (mt < per ? mt : per) : sms;
  return best;
}

// The low nibble of each byte of w sign-extended to the byte: x | (bit 3 of
// x) x 30 per byte (8 x 30 = 0xF0 stays within its byte); four operations
// where igemm.cuh's nib_lo takes __vsub4's emulation.
__device__ __forceinline__ uint32_t nib_sx(uint32_t w) {
  const uint32_t x = w & 0x0F0F0F0Fu;
  return x | (x & 0x08080808u) * 30u;
}

// The descriptor of a K-major operand tile stored by TMA with a swizzle
// (`mode` 2: 64-byte rows, 3: 32-byte rows), 8-row groups `sbo` bytes
// apart, at p (the tile's base plus a K offset inside its rows; the tile
// base aligned to its swizzle atom).
__device__ __forceinline__ uint64_t desc_sw(const void* p, int sbo, int mode) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

// A 2D TMA load of the box at (x, y) of map `tm` into dst, completing on
// mbarrier `bar` (bytes counted by its expect_tx).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The tensor map of A, an M x K matrix of `esize`-byte elements with rows
// K x esize bytes apart, cut in boxes of box_x elements x BM rows with the
// swizzle that box_x x esize bytes a row takes (32 or 64); rows past M and
// columns past K read as zeros. cuTensorMapEncodeTiled is looked up through
// the runtime's entry-point query, so nothing links against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t a_tensor_map(CUtensorMap* tm, const void* x, int esize, int K, int M,
                                int box_x) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_x, (cuuint32_t)BM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      tm, esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(x), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_x * esize == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16 wgmma m64nNk16 (fp32 sums), both operands K-major in shared memory
// (the same core-matrix layout as the int8 form: 16 bytes a core-matrix row,
// one k16 step = two K-adjacent core matrices).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_bf16_n64(d, da, db);
  else if constexpr (N == 128) wgmma_bf16_n128(d, da, db);
  else if constexpr (N == 192) wgmma_bf16_n192(d, da, db);
  else wgmma_bf16_n256(d, da, db);
}

// Keep the compiler from moving accesses of fp32 sums across the
// asynchronous product's issue and wait (sm90::fence_acc's fp32 twin).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) { sm90::fence_acc(d); }

// ---- warpgroup 0: the resident packed slice, and the ring's stages ----
template <class Op, int NS>
__device__ __forceinline__ void produce(const Args& a, const Plan& pl, const CUtensorMap& tm,
                                        int8_t* ring, uint8_t* packed, uint8_t* extras,
                                        uint64_t* full, uint64_t* empty, int KT, int items) {
  constexpr int STAGE = A_STAGE + NS * KS;
  const int pt = threadIdx.x;
  const int kh = a.Kp / 2, ldp = kh + 16, cpr = kh / 16;
  int st = 0, ph = 0, loaded = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int slice = it % pl.slices, m0 = it / pl.slices * BM;
    if (slice != loaded) {
      sm90::named_bar(2, PRODUCERS);   // every producer is done with the old slice
      const int n0 = slice * NS;
      for (int c = pt; c < NS * cpr; c += PRODUCERS) {
        const int r = c / cpr, j = c - r * cpr;
        const bool v = n0 + r < a.N;
        cp_async16(packed + r * ldp + 16 * j, v ? a.w + (size_t)(n0 + r) * kh + 16 * j : a.w, v);
      }
      cp_async_commit();
      Op::load_extras(a, extras, n0, NS, pt, PRODUCERS);
      cp_async_wait<0>();
      sm90::named_bar(2, PRODUCERS);
      loaded = slice;
    }
    for (int s = 0; s < KT; ++s) {
      sm90::mbar_wait(empty + st, ph ^ 1);
      int8_t* stage = ring + st * STAGE;
      // one thread hands the stage's A boxes to the TMA engine
      if (pt == 0) {
        mbar_expect_tx(full + st, A_STAGE);
#pragma unroll
        for (int b = 0; b < Op::A_BOXES; ++b)
          tma_load(stage + b * (A_STAGE / Op::A_BOXES), &tm, Op::box_x(a, s, b), m0, full + st);
      }
      Op::template build<NS>(a, stage + A_STAGE, packed, ldp, extras, s, pt);
      sm90::fence_proxy_async();   // these st.shared, to wgmma's reads
      sm90::mbar_arrive(full + st);
      if (++st == pl.stages) st = 0, ph ^= 1;
    }
  }
}

// ---- the epilogue of one consumer's 64 x NS sums ----
// Thread 32 w + 4 g + t holds, for each 8-column block j, columns 8 j + 2 t
// and + 1 of rows 16 w + g (h = 0) and 16 w + g + 8 (h = 1). With N % 4 ==
// 0 (16-byte aligned rows), each warp writes its 8 rows of a half h into its
// staging rows and lane g hands row g to the bulk-copy engine
// (cp.async.bulk, shared -> global: one copy of the row's slice columns),
// which writes it out while the consumers go on to the next item; the
// staging is written again only after the engine has read it. Otherwise
// (N % 4 != 0) the values go out by 4-byte stores.
__device__ __forceinline__ void bulk_store(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <class Op, int NS, class Acc>
__device__ __forceinline__ void epilogue(const Args& a, const Acc (&acc)[NS / 2],
                                         const uint8_t* table, uint8_t* staging, int n0,
                                         int r0, int ctid) {
  const int w = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  if ((a.N & 3) == 0) {
    constexpr int RB = NS * 4 + 32;
    const int bytes = min(NS, a.N - n0) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lane < 8) bulk_wait_read();   // the engine is done reading these rows
      __syncwarp();
      float* row = reinterpret_cast<float*>(staging + g * RB);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
            Op::epi(a, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], table, 4 * j + t);
      sm90::fence_proxy_async();   // these st.shared, to the bulk copy's reads
      __syncwarp();
      const int m = r0 + 16 * w + 8 * h + lane;
      if (lane < 8 && m < a.M) bulk_store(a.out + (size_t)m * a.N + n0, staging + lane * RB, bytes);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 16 * w + g + 8 * h;
    if (m >= a.M) continue;
    float* orow = a.out + (size_t)m * a.N;
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const float2 y = Op::epi(a, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], table, 4 * j + t);
      const int c = n0 + 8 * j + 2 * t;
      if (c < a.N) orow[c] = y.x;
      if (c + 1 < a.N) orow[c + 1] = y.y;
    }
  }
}

// ---- warpgroups 1-2: products and epilogue ----
template <class Op, int NS>
__device__ __forceinline__ void consume(const Args& a, const Plan& pl, const int8_t* ring,
                                        uint8_t* table, uint8_t* staging, uint64_t* full,
                                        uint64_t* empty, int KT, int items) {
  using Acc = typename Op::Acc;
  constexpr int STAGE = A_STAGE + NS * KS;
  const int cw = (threadIdx.x >> 7) - 1, ctid = threadIdx.x & 127;
  uint8_t* wstage = staging + ((threadIdx.x >> 5) - 4) * 8 * stage_row_bytes(NS);
  int st = 0, ph = 0, loaded = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int slice = it % pl.slices, n0 = slice * NS;
    const int r0 = it / pl.slices * BM + 64 * cw;
    const bool any = r0 < a.M;   // else this warpgroup only passes the stages on
    if (slice != loaded) {
      sm90::named_bar(1, 256);   // both consumers are done with the old table
      Op::load_table(a, table, n0, NS, threadIdx.x - 128, 256);
      sm90::named_bar(1, 256);
      loaded = slice;
    }
    Acc acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0;
    int held = -1;
    for (int s = 0; s < KT; ++s) {
      sm90::mbar_wait(full + st, ph);
      sm90::fence_proxy_async();   // the stage's cp.async writes, to wgmma's reads
      if (any) {
        const int8_t* A = ring + st * STAGE;
        const int8_t* B = ring + st * STAGE + A_STAGE;
        sm90::wgmma_fence();
        Op::template mma<NS>(acc, Op::a_desc(A, cw, 0), sm90::desc(B, KS, 0));
        Op::template mma<NS>(acc, Op::a_desc(A, cw, 1), sm90::desc(B, KS, 32));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (held >= 0 && ctid == 0) sm90::mbar_arrive(empty + held);
      held = st;
      if (++st == pl.stages) st = 0, ph ^= 1;
    }
    sm90::wgmma_wait<0>();
    if (ctid == 0) sm90::mbar_arrive(empty + held);
    fence_acc(acc);
    if (any) epilogue<Op, NS>(a, acc, table, wstage, n0, r0, ctid);
  }
  if ((threadIdx.x & 31) < 8) bulk_wait();   // the staging outlives every copy
}

template <class Op, int NS>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const Args a, const Plan pl, const __grid_constant__ CUtensorMap tm) {
  extern __shared__ __align__(1024) int8_t smem[];
  int8_t* ring = smem;
  uint8_t* packed = reinterpret_cast<uint8_t*>(ring + pl.stages * (A_STAGE + NS * KS));
  uint8_t* extras = packed + NS * (a.Kp / 2 + 16);
  uint8_t* table = extras + Op::extras_bytes(a, NS);
  uint8_t* staging = table + Op::table_bytes(NS);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + staging_bytes(NS));
  uint64_t* empty = full + pl.stages;
  const int KT = a.Kp * Op::ESIZE / KS;
  const int items = (a.M + BM - 1) / BM * pl.slices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      sm90::mbar_init(full + s, PRODUCERS + 1);   // each producer's writes, and the A boxes' expect_tx
      sm90::mbar_init(empty + s, 2);              // one thread of each consumer
    }
    sm90::mbar_init_fence();
    if (smem_u32(smem) & 1023) __trap();   // the swizzled A boxes need 1024-byte stage bases
  }
  __syncthreads();

  if (threadIdx.x < PRODUCERS) {
    sm90::setmaxnreg_dec<56>();
    produce<Op, NS>(a, pl, tm, ring, packed, extras, full, empty, KT, items);
    return;
  }
  sm90::setmaxnreg_inc<224>();
  consume<Op, NS>(a, pl, ring, table, staging, full, empty, KT, items);
}

// The current device and its SM count, looked up once per device (a
// launch then makes no device query).
inline cudaError_t device(int* dev, int* sms) {
  static std::atomic<int> known[64];   // 0: not looked up yet
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 64 && (*sms = known[*dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (e == cudaSuccess && *dev < 64) known[*dev].store(*sms, std::memory_order_relaxed);
  return e;
}

// Launch the Hopper form with the plan's slice width. The shared-memory
// opt-in is made once per device for each instantiation, to the most any
// plan takes (SMEM_MAX); a refused opt-in returns its error.
template <class Op, int NS>
cudaError_t launch_ns(const Args& a, const Plan& pl, const CUtensorMap& tm, int dev,
                      cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};   // a bit per device
  auto k = gemm_kernel<Op, NS>;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit == 0 || !(opted.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_MAX);
    if (e != cudaSuccess) return e;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  k<<<pl.grid, THREADS, pl.smem, st>>>(a, pl, tm);
  return cudaGetLastError();
}

// Launch the Hopper form on device `dev` (A's rows 16-byte aligned: TMA).
template <class Op>
cudaError_t launch(const Args& a, const Plan& pl, int dev, cudaStream_t st) {
  CUtensorMap tm{};
  const cudaError_t e = a_tensor_map(&tm, a.x, Op::ESIZE, a.ldx / Op::ESIZE, a.M,
                                     KS / Op::A_BOXES / Op::ESIZE);
  if (e != cudaSuccess) return e;
  switch (pl.ns) {
    case 256: return launch_ns<Op, 256>(a, pl, tm, dev, st);
    case 192: return launch_ns<Op, 192>(a, pl, tm, dev, st);
    case 128: return launch_ns<Op, 128>(a, pl, tm, dev, st);
    default: return launch_ns<Op, 64>(a, pl, tm, dev, st);
  }
}

}  // namespace w4
}  // namespace dlq
