// The Hopper attention forward, written once for fused_attention.cu and for
// the forward of flash_attention.cu, and run by int8_attention_block.cu's core
// (the fused kind over the thirds of a packed qkv: head_map's pitch) and by
// attention_ablate.cu. Each of them instantiates attention_sm90<NC, Kind>
// inside its own __global__ kernel.
//
// Work items are 128 query rows of one (head, batch row). The grid is
// persistent, one block an SM, and a block walks its items in turn with
// three warpgroups:
//   - warpgroup 0, the producer: one warp loads each item's Q into one of two
//     Q buffers and streams K and V tiles of KT = 128 keys through a ring of
//     shared-memory stages with TMA, copying each tile's 128 per-key words
//     (the float32 key bias, or the int32 segment ids) beside them; the ring
//     runs on from one item into the next, so an item's start and end
//     overlap its neighbours' work. It gives back its registers (setmaxnreg 24);
//   - warpgroups 1 and 2, the consumers: 64 query rows each (setmaxnreg 240).
//     S = Q K^T is wgmma m64n128k16 with Q and K from 128-byte-swizzled
//     shared memory; the row statistics live in registers (a row of the
//     accumulator sits in one quad of threads: 2 shuffle steps); P is the S
//     accumulator rounded to bf16 and reused in place as the register A
//     operand of O += P V (wgmma m64n64k16, V from shared memory with the
//     transpose bit). No score, probability or partial output goes through
//     shared memory.
// The ring has 3 stages at head_dim <= 64 and 2 at head_dim <= 128; a stage
// is a K tile, a V tile (NC = ceil(head_dim / 64) column chunks of 128 rows x
// 128 bytes each) and the key words, with a full and an empty mbarrier. The
// tensor maps are 3-D over the (B, L, heads * D) tensors, box (64, 128, 1):
// the hardware zero-fills rows past L, and the head's columns start at h * D.
// A box is 64 columns wide, so at a head_dim that is not a multiple of 64 it
// also reads the next head's columns: the consumers zero Q's columns past D,
// so those columns add nothing to S, and the stores are masked to D.
//
// Exponentials are ex2.approx on the MUFU, with log2(e) folded into the score
// scale (and into the fused kernel's bias): 2^(s' - m') with s' = s log2(e)
// is exp(s - m) to a few float32 ulps; the flash statistic m is written back
// in natural units. The flash mask stays the finite MASK in these units, so a
// tile whose keys are all masked still takes them at p = 1 until a matching
// key's rescale wipes them.
//
// 384 threads, one block an SM (registers). Shared memory (plan(), mirrored
// by ops/fused_attention.py::_smem_bytes): 1024 bytes of alignment slack, two
// Q tiles (2 x NC x 16 KB), the ring (stages x 2 x NC x 16 KB), stages x 512
// bytes of key words, the barriers: 133,712 bytes at head_dim 64, 198,720 at
// 128.
//
// Measured on the H100 (PERF.md): exp2 in place of expf and the persistent
// grid moved device time; an intra-warpgroup software pipeline with ping-pong
// between the consumer warpgroups did not, and tree reductions put their
// arrays on the stack and cost more than they saved, so neither is kept.
//
// Ablations (attention_ablate.cu, the stage-by-stage timing of the fused kind):
// a third template parameter removes one stage at compile time, each branch an
// ``if constexpr`` on it, so the default kFull is the code above unchanged.
//   kNoMax    pass 0 keeps no running max: m = 0, l = sum 2^s', no rescale;
//   kNoSmax   one pass, p = bf16(s * scale + bias) in natural units (nothing
//             folds log2(e)); the key words are 0 past L, where the zero-filled
//             K rows give S = 0 too, so p = 0 there (-inf times a zero V row
//             would be NaN);
//   kNoPV     the softmax as kFull, no P V product and no V tiles; the epilogue
//             stores the first D keys of tile 0's bf16 P, from the register A
//             fragments, as ctx's D columns of the head (D <= 128 = KT);
//   kAligned  every item reads and writes head 0's columns (column origin 0 in
//             the Q/K/V boxes and the store). TMA lands every box in the same
//             swizzled tile whatever its column origin, so on this card the
//             variant measures the HBM/L2 traffic of twelve distinct heads
//             against one head read twelve times, not a layout cost.
#pragma once

#include <climits>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime

#include "common.cuh"

namespace mdhs {
namespace sm90 {

constexpr int QT = 128;          // query rows of a block: two consumer warpgroups of 64
constexpr int KT = 128;          // keys of a streamed tile
constexpr int CHUNK = 64;        // bf16 columns of one 128-byte swizzled chunk
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_D = 128;
constexpr uint32_t TILE_BYTES = KT * 128;     // one chunk of a K or V tile
constexpr uint32_t QCHUNK_BYTES = QT * 128;   // one chunk of the Q tile

enum Kind : int { kFused = 0, kFlash = 1 };
// the stage a fused-kind build removes (kFull: none); ops/attention_ablate.py::MODES in this order
enum Ablate : int { kFull = 0, kNoMax = 1, kNoSmax = 2, kNoPV = 3, kAligned = 4 };

__host__ __device__ constexpr int chunks(int D) { return (D + CHUNK - 1) / CHUNK; }
__host__ __device__ constexpr int stages(int nc) { return nc == 1 ? 3 : 2; }

struct Plan {
  int nc, st;
  uint32_t q, kv, stage_bytes, aux, bar, bytes;  // offsets from the 1024-aligned base
};

// Q twice (the current work item's and the next one's), the ring, each stage's key
// words, the barriers: full and empty of each Q buffer, full and empty of each stage
__host__ __device__ inline Plan plan(int nc) {
  Plan p;
  p.nc = nc;
  p.st = stages(nc);
  p.q = 0;
  p.kv = 2 * nc * QCHUNK_BYTES;
  p.stage_bytes = 2 * nc * TILE_BYTES;
  p.aux = p.kv + p.st * p.stage_bytes;
  p.bar = p.aux + p.st * KT * 4;
  p.bytes = 1024 + p.bar + (4 + 2 * p.st) * 8;
  return p;
}

// --------------------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (coordinates innermost first) into shared memory;
// completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// keeps the compiler from moving a read of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a 128-byte-swizzled operand whose 8-row groups lie
// 1024 bytes apart. K-major (Q, K): one instruction's 16-deep slice lies
// inside a swizzle row, so the leading offset is unused. MN-major (V, the
// transposed B): one instruction's 64 columns are one swizzle atom, so the
// offset of a next atom along N is unused; both offsets are set to 1024.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d[0 .. 64) (+)= A (64 x 16, shared memory, K-major) * B (16 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. 32) += A (64 x 16, registers) * B (16 x 64, shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --------------------------------------------------------------------------- consumer pieces
// the library's DEFAULT_MASK_VALUE, -0.7 * float32 max taken in double, then rounded
constexpr float kMask = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// 2^x on the MUFU (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(s - m) of scores that carry the factor log2(e)
__device__ __forceinline__ float exp_diff(float s, float m) { return ex2(s - m); }

template <int NC>
__device__ __forceinline__ void fence_acc(float (&o)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
}

// S = Q K^T of one tile (64 x 128 a warpgroup), issued and committed; Q is zero past D
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_wg, uint32_t k_base, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t c = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n128k16(s, desc_sw128(q_wg + c * QCHUNK_BYTES + off, 16), desc_sw128(k_base + c * TILE_BYTES + off, 16),
                        kk > 0);
  }
  wgmma_commit();
}

// acc[c] += A B over KS steps of 16 rows, fenced, issued and committed as a group of its own:
// A from registers, B (KS * 16 rows, NC chunks of 64 columns b_chunk bytes apart) MN-major
// from shared memory
template <int NC, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[NC][32], const uint32_t (&pa)[KS][4], uint32_t b,
                                         uint32_t b_chunk) {
  fence_acc<NC>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) wgmma_rs_m64n64k16(acc[c], pa[kk], desc_sw128(b + c * b_chunk + kk * 16 * 128, 1024));
  wgmma_commit();
  fence_acc<NC>(acc);
}

// an m64nN accumulator, rounded to bf16, as the register A operand of KS = N / 16 k-steps
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[KS][4], const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// The box reads 64 columns: zero columns D .. 64 NC of the warpgroup's rows row0 .. row0 + 64
// of a resident tensor whose chunk 0 is at t (t128: the thread's index in its warpgroup)
template <int NC>
__device__ __forceinline__ void zero_past_d(unsigned char* t, int row0, int D, int t128) {
  for (int i = t128; i < 64 * NC * 8; i += 128) {
    const int row = row0 + i / (NC * 8), j = i % (NC * 8);  // j: logical 16-byte column group
    if (8 * j >= D)
      *reinterpret_cast<uint4*>(t + (j / 8) * QCHUNK_BYTES + row * 128 + (((j % 8) ^ (row & 7)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int NC>
__device__ __forceinline__ void zero_acc(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
}

// s[4 j + 2 i + e] is row r + 8 i, key k0 + 8 j + 2 qd + e of the tile: scores in units of
// log2(e) = S * scale plus the key bias (fused; -inf past L) or the segment mask (flash;
// -inf past L)
template <int KIND>
__device__ __forceinline__ void tile_scores(float (&s)[64], const uint32_t* words, float scale, const int (&segq)[2],
                                            int qd, int k0, int L) {
  if (KIND == kFused) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = __uint_as_float(words[8 * j + 2 * qd + e]);
        s[4 * j + e] = s[4 * j + e] * scale + bias;
        s[4 * j + 2 + e] = s[4 * j + 2 + e] * scale + bias;
      }
  } else {
    const bool partial = k0 + KT > L;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * qd + e;
        const int sk = static_cast<int>(words[col]);
        const bool in = !partial || k0 + col < L;
        s[4 * j + e] = in ? s[4 * j + e] * scale + (segq[0] == sk ? 0.0f : kMask) : -INFINITY;
        s[4 * j + 2 + e] = in ? s[4 * j + 2 + e] * scale + (segq[1] == sk ? 0.0f : kMask) : -INFINITY;
      }
  }
}

// max of the 32 values of row i that the thread holds, then over the quad
__device__ __forceinline__ float row_max(const float (&s)[64], int i) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
  return quad_max(mx);
}

// fused, pass 0: the running row max and the thread's part of the row sum of exp(s - max)
__device__ __forceinline__ void row_stats(const float (&s)[64], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], row_max(s, i));
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) e += exp_diff(s[4 * j + 2 * i], m_new) + exp_diff(s[4 * j + 2 * i + 1], m_new);
    l[i] = l[i] * exp_diff(m[i], m_new) + e;
    m[i] = m_new;
  }
}

// nomax, pass 0: the thread's part of the row sum of exp(s), with no max taken
__device__ __forceinline__ void row_sums(const float (&s)[64], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) e += ex2(s[4 * j + 2 * i]) + ex2(s[4 * j + 2 * i + 1]);
    l[i] += e;
  }
}

// fused, pass 1: p = exp(s - m) / l, normalised before its rounding to bf16 (rl = 1 / l)
__device__ __forceinline__ void normalised_p(float (&s)[64], const float (&m)[2], const float (&rl)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * j + 2 * i + e] = exp_diff(s[4 * j + 2 * i + e], m[i]) * rl[i];
}

// flash: the online step. m_next = max(m, row max), alpha = exp(m - m_next) (0 on the first
// tile), p = exp(s - m_next) (0 past L), l = alpha l + the thread's part of sum p
__device__ __forceinline__ void online_p(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_next = fmaxf(m[i], row_max(s, i));
    alpha[i] = exp_diff(m[i], m_next);
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float p = exp_diff(s[4 * j + 2 * i + x], m_next);
        s[4 * j + 2 * i + x] = p;
        e += p;
      }
    l[i] = alpha[i] * l[i] + e;
    m[i] = m_next;
  }
}

// flash: o = o * alpha row by row, before the next P V is added
template <int NC>
__device__ __forceinline__ void rescale(float (&o)[NC][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) o[c][4 * j + 2 * i + e] *= alpha[i];
}

// --------------------------------------------------------------------------- the block
struct Args {
  const CUtensorMap *tq, *tk, *tv;  // box (64, 128, 1) over the (B, L, HD) bf16 tensors
  const uint32_t* key_words;        // (B, L): float32 key bias (fused) or int32 segment ids (flash)
  bf16* out;                        // (B, L, HD)
  float *m_out, *l_out;             // (B, heads, L) or null (flash)
  int B, L, HD, D;
  float sm_scale;
};

// One work item: 128 query rows of one (head, batch row); q-tiles vary fastest, so
// the items in flight at once share their K and V in L2.
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item_of(int item, int L, int heads) {
  const int qtiles = (L + QT - 1) / QT;
  const int rest = item / qtiles;
  return {(item % qtiles) * QT, rest % heads, rest / heads};
}

// The block's work: a persistent loop over work items (grid = min(items, SMs)).
// The producer loads the next item's Q into the other Q buffer and runs on into
// its K/V tiles while the consumers finish the current item, so one item's
// start and end overlap its neighbours' work. Fused: two passes over the keys,
// pass 0 streaming K alone for the row max and sum, pass 1 K and V for the
// normalised bf16 p and ctx += P V. Flash: one pass, the online rescale of o.
// ABL removes one stage of the fused kind (the header comment).
template <int NC, int KIND, int ABL = kFull>
__device__ __forceinline__ void attention_sm90(const Args& a) {
  static_assert(ABL == kFull || KIND == kFused, "the ablations are of the fused kind");
  constexpr int ST = stages(NC);
  constexpr int PASSES = KIND == kFused ? (ABL == kNoSmax ? 1 : 2) : 1;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(sm90_smem) + 1023) & ~uintptr_t(1023));
  const Plan sp = plan(NC);
  const uint32_t sbase = smem_u32(base);
  auto q_buf = [&](int qb) { return sbase + sp.q + qb * NC * QCHUNK_BYTES; };
  auto bar_q_full = [&](int qb) { return sbase + sp.bar + 8 * qb; };
  auto bar_q_empty = [&](int qb) { return sbase + sp.bar + 8 * (2 + qb); };
  auto bar_full = [&](int s) { return sbase + sp.bar + 8 * (4 + s); };
  auto bar_empty = [&](int s) { return sbase + sp.bar + 8 * (4 + ST + s); };
  auto k_base = [&](int s) { return sbase + sp.kv + s * sp.stage_bytes; };
  auto v_base = [&](int s) { return sbase + sp.kv + s * sp.stage_bytes + NC * TILE_BYTES; };
  uint32_t* aux = reinterpret_cast<uint32_t*>(base + sp.aux);

  const int L = a.L, D = a.D, T = (L + KT - 1) / KT, heads = a.HD / a.D;
  const int items = (L + QT - 1) / QT * heads * a.B;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(bar_q_full(qb), 1);
      mbar_init(bar_q_empty(qb), CONSUMER_WARPS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 32);               // the producer warp's lanes (+ the bytes of the tiles)
      mbar_init(bar_empty(s), CONSUMER_WARPS);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ----------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32) return;
    const int lane = tid;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const Item w = item_of(item, L, heads);
      const int col0 = ABL == kAligned ? 0 : w.h * D, qb = it & 1;
      const uint32_t* words = a.key_words + static_cast<size_t>(w.b) * L;
      mbar_wait(bar_q_empty(qb), ((it >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_q_full(qb), NC * QCHUNK_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(q_buf(qb) + c * QCHUNK_BYTES, a.tq, bar_q_full(qb), col0 + CHUNK * c, w.q0, w.b);
      }
      for (int pass = 0; pass < PASSES; ++pass) {
        const bool with_v = ABL != kNoPV && pass == PASSES - 1;
        for (int t = 0; t < T; ++t) {
          const int k0 = t * KT;
          mbar_wait(bar_empty(stage), phase ^ 1);
          if (lane == 0) {
            const uint32_t full = bar_full(stage);
            mbar_expect_tx(full, (with_v ? 2 : 1) * NC * TILE_BYTES);
            for (int c = 0; c < NC; ++c) {
              tma_load_3d(k_base(stage) + c * TILE_BYTES, a.tk, full, col0 + CHUNK * c, k0, w.b);
              if (with_v) tma_load_3d(v_base(stage) + c * TILE_BYTES, a.tv, full, col0 + CHUNK * c, k0, w.b);
            }
          }
          // the tile's key words beside it: the bias in units of log2(e) (-inf past L),
          // or the segment ids (INT_MIN past L); nosmax: the bias as it is (0 past L)
          uint32_t* dst = aux + stage * KT;
#pragma unroll
          for (int i = 0; i < KT / 32; ++i) {
            const int k = lane + 32 * i;
            if constexpr (ABL == kNoSmax)
              dst[k] = k0 + k < L ? words[k0 + k] : 0u;
            else if (KIND == kFused)
              dst[k] = __float_as_uint(k0 + k < L ? __uint_as_float(words[k0 + k]) * kLog2e : -INFINITY);
            else
              dst[k] = k0 + k < L ? words[k0 + k] : 0x80000000u;
          }
          mbar_arrive(bar_full(stage));
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;              // consumer warpgroup: query rows 64 cw .. 64 cw + 64 of an item
  const int t128 = tid - 128 * wg;
  const int warp = t128 >> 5, lane = t128 & 31;
  const int r = 16 * warp + (lane >> 2);  // this thread's rows r and r + 8 of the warpgroup's 64
  const int qd = lane & 3;                // its quad position: columns 2 qd, 2 qd + 1 of each 8
  const int ksteps = (D + 15) / 16;       // Q K^T depth in steps of 16; Q is zero past D
  const float scale = ABL == kNoSmax ? a.sm_scale : a.sm_scale * kLog2e;
  float s[64], m[2], l[2], alpha[2];
  float o[NC][32];
  uint32_t pa[8][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    const Item w = item_of(item, L, heads);
    const int qb = it & 1;
    const uint32_t q_wg = q_buf(qb) + cw * 64 * 128;
    mbar_wait(bar_q_full(qb), (it >> 1) & 1);
    if (D % CHUNK != 0) {
      zero_past_d<NC>(base + sp.q + qb * NC * QCHUNK_BYTES, 64 * cw, D, t128);  // Q's columns past D
      fence_proxy_async();
      named_barrier_sync(1 + cw, 128);
    }
    int segq[2] = {0, 0};
    if (KIND == kFlash) {
      const int* seg_row = reinterpret_cast<const int*>(a.key_words) + static_cast<size_t>(w.b) * L;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = w.q0 + 64 * cw + r + 8 * i;
        segq[i] = qi < L ? seg_row[qi] : INT_MIN;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = ABL == kNoMax ? 0.0f : -INFINITY;
      l[i] = 0.0f;
    }
    zero_acc<NC>(o);

    for (int step = 0; step < PASSES * T; ++step) {  // (pass, tile) in order
      const int pass = step / T, t = step % T;
      mbar_wait(bar_full(stage), phase);
      wgmma_fence();
      issue_qk(s, q_wg, k_base(stage), ksteps);
      wgmma_wait0();
      fence_regs(s);
      tile_scores<KIND>(s, aux + stage * KT, scale, segq, qd, t * KT, L);
      if (KIND == kFlash) {
        online_p(s, m, l, alpha);
        rescale<NC>(o, alpha);
      } else if constexpr (ABL == kNoSmax) {
        // p is the score itself, rounded to bf16 by pack_a
      } else if (pass == 0) {
        if constexpr (ABL == kNoMax)
          row_sums(s, l);
        else
          row_stats(s, m, l);
      } else {
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) l[i] = 1.0f / quad_sum(l[i]);  // l holds 1 / l from here
        }
        normalised_p(s, m, l);
        if constexpr (ABL == kNoPV) {
          fence_regs(s);  // every p stays computed, as with the product, though only D keys are stored
          if (t == 0) pack_a(pa, s);
        }
      }
      if (ABL != kNoPV && (KIND == kFlash || pass == PASSES - 1)) {
        pack_a(pa, s);
        issue_rs<NC, 8>(o, pa, v_base(stage), TILE_BYTES);  // O += P V
        wgmma_wait0();
        fence_acc<NC>(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(stage));
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the item's Q is no longer read
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_q_empty(qb));

    // --------------------------------------------------------------- epilogue
    if (KIND == kFlash) {
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
    }
    const size_t head = static_cast<size_t>(w.b) * L * a.HD + (ABL == kAligned ? 0 : w.h * D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = w.q0 + 64 * cw + r + 8 * i;
      if (qi >= L) continue;
      bf16* row = a.out + head + static_cast<size_t>(qi) * a.HD;
      if constexpr (ABL == kNoPV) {
        // keys 8 j + 2 qd, + 1 of row i are pa[j / 2][2 (j % 2) + i] (pack_a of s[4 j + 2 i + e])
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (8 * j + 2 * qd < D) *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * qd) = pa[j / 2][2 * (j % 2) + i];
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = CHUNK * c + 8 * j + 2 * qd;
            if (col < D) {
              // flash: o / l, as the plain version divides; fused: ctx as accumulated
              const float v0 = KIND == kFlash ? o[c][4 * j + 2 * i] / l[i] : o[c][4 * j + 2 * i];
              const float v1 = KIND == kFlash ? o[c][4 * j + 2 * i + 1] / l[i] : o[c][4 * j + 2 * i + 1];
              *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
            }
          }
        if (KIND == kFlash && a.m_out != nullptr && qd == 0) {
          const size_t stat = (static_cast<size_t>(w.b) * heads + w.h) * L + qi;
          a.m_out[stat] = m[i] * kLn2;  // back to natural units
          a.l_out[stat] = l[i];
        }
      }
    }
  }
}

// --------------------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against nothing more than before
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// The current device, with its primary context bound to this thread. The tensor maps are
// encoded by the driver, which needs a current context; a host thread that has made no
// runtime call yet (autograd's backward thread, say) may hold none.
inline cudaError_t bind_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  return err != cudaSuccess ? err : cudaSetDevice(*device);
}

// 3-D map over a (B, L, HD) bf16 tensor, innermost first, box (64 columns, ``rows`` rows, 1),
// 128-byte swizzle; rows past L and columns past HD read as zero. Its rows lie ``pitch``
// elements apart (0: HD, a tensor of its own; 3 HD: one third of a packed (B, L, 3 HD)
// qkv, which TMA takes when the base and the pitch are multiples of 16 bytes).
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int L, int HD, int rows = KT, int pitch = 0) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(pitch > 0 ? pitch : HD) * 2;  // bytes
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row, static_cast<cuuint64_t>(L) * row};
  const cuuint32_t box[3] = {CHUNK, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Checks, tensor maps and the launch of one forward call: kernel1 (one
// 64-column chunk) at head_dim <= 64, kernel2 (two) above; a persistent grid,
// one block an SM (at most one a work item). q, k, v, out: (B, L, HD) bf16 with
// HD = num_heads * D, D % 8 == 0, D <= 128; key_words (B, L) 32-bit. The rows of
// q, k and v lie ``pitch`` elements apart (0: HD; head_map), out's HD apart.
template <typename Kernel>
cudaError_t launch(Kernel kernel1, Kernel kernel2, const void* q, const void* k, const void* v, const void* key_words,
                   void* out, float* m_out, float* l_out, int B, int L, int HD, int num_heads, float sm_scale,
                   void* stream, int pitch = 0) {
  if (B <= 0 || B > 65535 || L <= 0 || num_heads <= 0 || num_heads > 65535 || HD % num_heads != 0)
    return cudaErrorInvalidValue;
  const int D = HD / num_heads;
  if (D % 8 != 0 || D > MAX_D) return cudaErrorInvalidValue;
  const int nc = chunks(D);
  const Kernel kernel = nc == 1 ? kernel1 : kernel2;
  const Plan sp = plan(nc);
  if (sp.bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = bind_device(&device)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = head_map(&tq, q, B, L, HD, KT, pitch)) != cudaSuccess) return err;
  if ((err = head_map(&tk, k, B, L, HD, KT, pitch)) != cudaSuccess) return err;
  if ((err = head_map(&tv, v, B, L, HD, KT, pitch)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sp.bytes))) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const long long items = static_cast<long long>((L + QT - 1) / QT) * num_heads * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, THREADS, sp.bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const uint32_t*>(key_words), static_cast<bf16*>(out), m_out, l_out, B, L, HD, D,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace mdhs
