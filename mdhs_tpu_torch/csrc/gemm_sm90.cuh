// The Hopper wgmma GEMM mainloop of the sublayers' products, for two operand
// types: s8 x s8 -> s32 (the int8 sublayers: int8_ffn_block.cu's three products,
// int8_attention_block.cu's QKV and output projections) and bf16 x bf16 -> f32
// (the bf16 sublayers: bf16_gemm.cu, run by ffn_block.cu and attention_block.cu).
// A kernel instantiates gemm_sm90<Op>(..., epi) inside its own __global__
// function with an epilogue that takes the finished tile from the registers;
// the epilogues the sublayers share are in epi_sm90.cuh.
//
//     C[M, N] = A[M, K] @ W[N, K]^T     (S8: int32, exact; BF16: float32)
//
// Both operands are K-major in device memory (a row of A and a row of the
// nn.Linear-layout W are K-contiguous), which is what wgmma takes with both
// operands in shared memory and no transpose (for 8-bit types the only layout it
// takes), so nothing is transposed. Everything but the instruction and the
// accumulator type is the same for both: a stage holds 128 bytes of K (128 s8 or
// 64 bf16 values, one 128-byte swizzle row), and one instruction takes 32 bytes
// of it (k32 for s8, k16 for bf16).
//
// Work items are 128 x BN output tiles (BN 128 or 256, Cfg). The grid is
// persistent, and a block walks its tiles in turn with two warpgroups, 64 rows
// each and all BN columns:
//   - K streams in steps of 128 bytes, a 128 x 128-byte A tile and a BN x
//     128-byte W tile a step, each one TMA box with the 128-byte swizzle, through
//     a ring of shared-memory stages with a full and an empty mbarrier each.
//     Thread 0 issues the loads: a ring's worth at the start, then one each time
//     both warpgroups have given a slot back. The ring runs on from one tile
//     into the next, so the next tile's first stages load while the epilogue runs;
//   - the products are wgmma.mma_async m64nBN (k32 .s32.s8.s8 or k16
//     .f32.bf16.bf16) with both operands from shared memory, four instructions a
//     stage, one group in flight while the next stage is awaited. The BN / 2
//     sums of a thread stay in registers until the epilogue.
// Rows past M are zero-filled by the tensor maps; the epilogue masks them.
//
// Split K. An epilogue that names kSplit walks (row tile, column tile, split)
// items: split s of S takes k-steps [s KT / S, (s + 1) KT / S) of the KT, and
// the epilogue writes a float32 partial tile that a row pass sums (bf16_gemm.cu).
// That is how few rows fill the card: at M = 128 a product has 6 to 24 tiles
// for 132 SMs (PERF.md).
//
// What was found on the H100 (PERF.md): the s8 mainloop alone, at 128 x 256
// tiles and one block an SM, runs near the int8 rate, and its TMA loads alone
// take as long: it runs at the L2's rate. The FFN's epilogues (GELU, quantize,
// LayerNorm) are long chains of float work that a block cannot overlap with its
// own products. Hence the two widths: 128 columns at two blocks an SM (128
// registers a thread, three 32 KB stages, 107 KB of shared memory), where one
// block's epilogue can run beside the other's products, at 32 KB of L2 traffic
// per 4.2 M s8 operations (2.1 M bf16); and 256 columns at one block an SM (four
// 48 KB stages), 48 KB per 8.4 M (4.2 M). There is no producer warp: a ninth or
// a twelfth warp would take registers that ptxas budgets for every warp alike
// (setmaxnreg moves registers between warps at run time, but ptxas compiles
// every warp's code to the launch's budget, and refused the epilogues at 80).
//
// Tiles walk columns fastest, so the blocks in flight at once share their A
// rows in L2; W (at most 3072 x 1024 elements here) stays in L2 throughout. A
// clustered kernel (Sched::by_rank) instead gives each block of a cluster one
// column tile of the same rows, so that an epilogue can see whole rows through
// distributed shared memory (the cluster helpers below). Sharing the A or W
// tile across a cluster by TMA multicast was slower: the blocks of a cluster
// then wait for the slowest of them at every stage, with three stages of slack,
// while each shares its SM with an unrelated block.
//
// The PTX pieces, the tensor-map encoder and bind_device come from
// attention_sm90.cuh; nothing of that header changes.
#pragma once

#include <type_traits>

#include "attention_sm90.cuh"

namespace mdhs {
namespace wg {

using sm90::desc_sw128;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait0;

constexpr int BM = 128;               // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;               // bytes of K a stage: one 128-byte swizzle row
constexpr int THREADS = 256;          // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr uint32_t A_BYTES = BM * BK;

// The two tile widths (the header comment): 128 columns at two blocks an SM, 256 at one;
// the ring's stages, unless an epilogue that keeps a tile of its own in shared memory
// asks for fewer (StagesOf).
template <int BN_, int ST_ = BN_ == 128 ? 3 : 4>
struct Cfg {
  static_assert(BN_ == 128 || BN_ == 256, "tile width");
  static constexpr int BN = BN_;
  static constexpr int BLOCKS_PER_SM = BN_ == 128 ? 2 : 1;
  static constexpr int ST = ST_;  // ring stages
  static constexpr int NACC = BN_ / 2;           // sums a thread holds
  static constexpr uint32_t B_BYTES = BN_ * BK;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr uint32_t BAR_OFFSET = ST * STAGE_BYTES;          // full[ST], empty[ST]
  static constexpr uint32_t EXTRA_OFFSET = BAR_OFFSET + 2 * ST * 8;  // the epilogue's own shared memory
  // dynamic shared memory of a kernel whose epilogue asks for ``extra`` bytes (1024
  // bytes of alignment slack first)
  static constexpr uint32_t smem_bytes(uint32_t extra) { return 1024 + EXTRA_OFFSET + extra; }
};

// The ring's stages for an epilogue: its kStages where it names one, else Cfg's.
template <class Epi, class = void>
struct StagesOf : std::integral_constant<int, Cfg<Epi::BN>::ST> {};
template <class Epi>
struct StagesOf<Epi, std::void_t<decltype(Epi::kStages)>> : std::integral_constant<int, Epi::kStages> {};

// Whether an epilogue takes split-K items: its kSplit where it names one, else no.
template <class Epi, class = void>
struct SplitOf : std::false_type {};
template <class Epi>
struct SplitOf<Epi, std::void_t<decltype(Epi::kSplit)>> : std::integral_constant<bool, Epi::kSplit> {};

// --------------------------------------------------------------------------- PTX helpers
// One box of a 2-D tensor map (coordinates innermost first) into shared memory;
// completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}


__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// keep the compiler from moving a read of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
  sm90::fence_regs(d);
}

// d[0 .. 64) (+)= A (64 x 32 bytes, shared memory, K-major) * B (32 bytes x 128, shared memory, K-major).
// (m64nN k32 with N = 2 x the accumulator count: overloaded on it.)
// d[4 j + 2 i + e] is row 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + e of the 64 x 128 tile.
__device__ __forceinline__ void wgmma_m64nk32(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. 128) (+)= A (64 x 32 bytes, shared memory, K-major) * B (32 bytes x 256, shared memory, K-major);
// the same layout, j up to 32.
__device__ __forceinline__ void wgmma_m64nk32(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The bf16 products, float32 sums in the same layout: m64n128k16 (attention_sm90.cuh's, Q K^T's
// instruction) and m64n256k16, both operands K-major from shared memory.
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  sm90::wgmma_ss_m64n128k16(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_m64nk16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// --------------------------------------------------------------------------- operand types
// What the mainloop needs of an operand type: the accumulator, the bytes of a value, the
// tensor map's element type and the product of one 32-byte slice of K.
struct S8 {
  using Acc = int;
  static constexpr int kBytes = 1;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  template <int N>
  static __device__ __forceinline__ void mma(int (&d)[N], uint64_t da, uint64_t db, int scale_d) {
    wgmma_m64nk32(d, da, db, scale_d);
  }
};

struct BF16 {
  using Acc = float;
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N], uint64_t da, uint64_t db, int scale_d) {
    wgmma_m64nk16(d, da, db, scale_d);
  }
};

// ---- thread-block clusters: ranks, distributed shared memory, the cluster barrier
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// the address of the same shared-memory word in block ``rank`` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t saddr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(saddr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t caddr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(caddr) : "memory");
  return v;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// --------------------------------------------------------------------------- the block
struct Tile {
  int m0, n0;      // first row and column
  int it;          // the block's own count of tiles so far
  int s = 0;       // split-K items: the split,
  int kb = 0, ke = 0;  // and its k-steps kb .. ke
};

// The tiles of one block: items dealt out round robin over the grid (over the
// clusters, in a clustered launch). Unclustered: (row tile, column tile), columns
// fastest, and with SPLIT the split slowest: the items in flight at once are
// whole splits. Clustered (by_rank): items are row tiles, and block ``rank`` of a
// cluster takes column tile ``rank`` of each.
template <int BN, bool SPLIT>
struct Sched {
  int mb, nb, kt, splits;
  int worker, workers;
  bool by_rank;
  int rank;
  __device__ int total() const { return by_rank ? mb : (SPLIT ? mb * nb * splits : mb * nb); }
  __device__ bool valid(int k) const { return worker + k * workers < total(); }
  __device__ Tile tile(int k) const {
    const int g = worker + k * workers;
    if (by_rank) return Tile{g * BM, rank * BN, k};
    if (!SPLIT) return Tile{(g / nb) * BM, (g % nb) * BN, k};
    const int s = g / (mb * nb), r = g % (mb * nb);
    return Tile{(r / nb) * BM, (r % nb) * BN, k, s, s * kt / splits, (s + 1) * kt / splits};
  }
};

template <int BN, bool SPLIT>
__device__ __forceinline__ Sched<BN, SPLIT> make_sched(int M, int N, int KT, int splits, bool by_rank) {
  Sched<BN, SPLIT> s;
  s.mb = (M + BM - 1) / BM;
  s.nb = (N + BN - 1) / BN;
  s.kt = KT;
  s.splits = splits;
  s.by_rank = by_rank;
  const int cs = by_rank ? static_cast<int>(cluster_size()) : 1;
  s.rank = by_rank ? static_cast<int>(cluster_rank()) : 0;
  s.worker = blockIdx.x / cs;
  s.workers = gridDim.x / cs;
  return s;
}

// The block's work. ``ta`` maps A, ``tb`` W (boxes of 128 bytes x 128 rows, or x BN rows),
// both with the 128-byte swizzle; K (in values) fills whole 128-byte steps. ``splits``:
// the split count of a kSplit epilogue (1 otherwise). The epilogue type gives:
//   static constexpr bool kCluster;                       launched as clusters (Sched::by_rank)
//   void attach(unsigned char* extra, uint32_t extra_addr)  every thread: its shared memory
//   void init()                                           one thread, before the first sync
//   void prefetch(const Tile&, int consumer_thread)        each consumer thread, as a tile starts
//   static constexpr int BN;                              the tile width (Cfg)
//   static constexpr int kStages;                         optional: the ring's stages (StagesOf)
//   static constexpr bool kSplit;                         optional: split-K items (SplitOf)
//   void operator()(Op::Acc (&acc)[BN / 2], const Tile&, int cw, int t128)   each thread
template <class Op, class Epi>
__device__ __forceinline__ void gemm_sm90(const CUtensorMap* ta, const CUtensorMap* tb, int M, int N, int K,
                                          Epi& epi, int splits = 1) {
  using C = Cfg<Epi::BN, StagesOf<Epi>::value>;
  constexpr int ST = C::ST;
  extern __shared__ __align__(1024) unsigned char s8_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(s8_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(base);
  auto bar_full = [&](int s) { return sbase + C::BAR_OFFSET + 8 * s; };
  auto bar_empty = [&](int s) { return sbase + C::BAR_OFFSET + 8 * (ST + s); };
  auto a_base = [&](int s) { return sbase + s * C::STAGE_BYTES; };
  auto b_base = [&](int s) { return sbase + s * C::STAGE_BYTES + A_BYTES; };

  constexpr bool SPLIT = SplitOf<Epi>::value;
  const int KT = K * Op::kBytes / BK;
  const Sched<Epi::BN, SPLIT> sc = make_sched<Epi::BN, SPLIT>(M, N, KT, splits, Epi::kCluster);
  const int tid = threadIdx.x, wg = tid / 128;

  epi.attach(base + C::EXTRA_OFFSET, sbase + C::EXTRA_OFFSET);
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1);                // thread 0's arrival (+ the bytes of both boxes)
      mbar_init(bar_empty(s), WARPS);           // one arrival a warp
    }
    epi.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Epi::kCluster)
    cluster_sync();  // no block's barrier is touched from another block before it is initialised
  else
    __syncthreads();

  // The producer's cursor, kept by thread 0: it issues k-step p + ST as soon as both
  // warpgroups have given back the slot of k-step p, the ring running on across tiles.
  int p_k = 0, p_kt = 0, p_stage = 0;
  if constexpr (SPLIT) p_kt = sc.valid(0) ? sc.tile(0).kb : 0;
  uint32_t p_phase = 0;
  auto issue = [&](int n) {
    for (; n > 0 && sc.valid(p_k); --n) {
      mbar_wait(bar_empty(p_stage), p_phase ^ 1);
      const Tile pt = sc.tile(p_k);
      mbar_arrive_expect_tx(bar_full(p_stage), C::STAGE_BYTES);
      tma_load_2d(a_base(p_stage), ta, bar_full(p_stage), p_kt * (BK / Op::kBytes), pt.m0);
      tma_load_2d(b_base(p_stage), tb, bar_full(p_stage), p_kt * (BK / Op::kBytes), pt.n0);
      if (++p_stage == ST) {
        p_stage = 0;
        p_phase ^= 1;
      }
      if constexpr (SPLIT) {
        if (++p_kt == pt.ke) {
          ++p_k;
          p_kt = sc.valid(p_k) ? sc.tile(p_k).kb : 0;
        }
      } else if (++p_kt == KT) {
        p_kt = 0;
        ++p_k;
      }
    }
  };
  if (tid == 0) issue(ST);

  const int cw = wg;  // rows 64 cw .. 64 cw + 64 of a tile
  const int t128 = tid - 128 * wg;
  const int lane = t128 & 31;
  typename Op::Acc acc[C::NACC];
  auto release = [&](int st) {  // give a stage back
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(st));
  };
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; sc.valid(k); ++k) {
    const Tile t = sc.tile(k);
    epi.prefetch(t, tid);
    int prev = 0;
    const int kb = SPLIT ? t.kb : 0, ke = SPLIT ? t.ke : KT;  // the tile's k-steps
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(bar_full(stage), phase);
      wgmma_fence();
      const uint32_t a = a_base(stage) + cw * 64 * BK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Op::mma(acc, desc_sw128(a + kk * 32, 16), desc_sw128(b_base(stage) + kk * 32, 16), kt - kb + kk > 0);
      wgmma_commit();
      if (kt > kb) {
        wgmma_wait1();  // the previous stage's products are done: give its slot back
        release(prev);
        if (tid == 0) issue(1);
      }
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait0();
    fence_acc(acc);
    release(prev);
    if (tid == 0) issue(1);  // the next tile's stages load while the epilogue runs
    epi(acc, t, cw, t128);
  }
  // no block leaves while another may still arrive on its barriers or write its shared memory
  if constexpr (Epi::kCluster) cluster_sync();
}

// --------------------------------------------------------------------------- host side
// 2-D map over a (rows, K) tensor of Op's values, innermost first, box (128 bytes,
// box_rows rows), 128-byte swizzle; rows past ``rows`` read as zero.
template <class Op>
inline cudaError_t operand_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * Op::kBytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK / Op::kBytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, Op::kMapType, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace mdhs
