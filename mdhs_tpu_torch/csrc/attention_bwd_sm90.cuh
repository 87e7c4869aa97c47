// The Hopper flash-attention backward, for flash_attention.cu: the dQ kernel
// (query-stationary; it also takes di = rowsum(o * do)) and the dK/dV kernel
// (key-stationary; it reads the di that dQ wrote), both on the pieces of
// attention_sm90.cuh.
//
//     p_ij  = exp(s_ij - m_i) / l_i,   s_ij = (q_i . k_j) * sm_scale + mask_ij
//     ds_ij = (do_i . v_j - di_i) * p_ij * sm_scale
//     dv_j  = sum_i bf16(p_ij) do_i,  dk_j = sum_i bf16(ds_ij) q_i,  dq_i = sum_j bf16(ds_ij) k_j
//
// Both kernels have the forward's shape: a persistent grid, one block an SM,
// 384 threads. Warpgroup 0 is the producer (setmaxnreg 24): one warp loads a
// work item's resident tiles into one of RB buffers and streams the other
// side's tiles through a ring of shared-memory stages with TMA (3-D tensor
// maps over (B, L, heads * D), 128-byte swizzle, rows past L zero-filled),
// copying each streamed row's words beside them. Warpgroups 1 and 2 are the
// consumers (setmaxnreg 240), 64 resident rows each. Per streamed tile:
//   dQ    (item: 128 queries; Q, dO, O resident; K, V and the key segment
//          ids streamed, 128 keys a tile, in products of 64 keys):
//            S = Q K^T and dP = dO V^T, wgmma m64n64k16 from shared memory;
//            p = 2^(s * sm_scale * log2(e) - lse_i) with lse_i = m_i log2(e)
//            + log2(l_i) in registers (0 across segments), ds in registers,
//            rounded to bf16 in place as the register A operand of
//            dQ += dS K (wgmma m64n64k16, K MN-major from the stage).
//          di: in each item's prologue, the diagonal of dO O^T by the same
//          wgmma as dP (each product of two bf16 values exact in float32,
//          summed in the tensor cores' fixed order), written to (B, heads,
//          L). Where o = v (a row whose only key is itself) dp - di then
//          cancels to 0 exactly, as in the plain version.
//   dK/dV (item: 128 keys; K, V resident; Q, dO and per query lse, di and the
//          segment id streamed, QN queries a tile, in products of 64):
//            S^T = K Q^T and dP^T = V dO^T (wgmma, 64 keys a warpgroup); P^T
//            and dS^T in registers, each thread reading its columns' words
//            from the stage; dV += P^T dO and dK += dS^T Q by wgmma with the
//            packed P^T and dS^T as register A operands and dO, Q MN-major.
// No S, dP, P or dS goes through shared memory, and no atomics: each output
// element is summed by one warpgroup in a fixed order, so a second launch
// gives the same bits.
//
// Registers: a consumer thread holds S and dP of a 64-column product (32
// floats each) beside its outputs (32 floats per 64 head columns each): at
// head_dim 128, 32 + 32 + 64 for dQ and 32 + 32 + 128 for dK/dV. Products of
// 128 columns (64 + 64 floats) spilled in dQ even at head_dim 64, where ptxas
// overlapped S and dP. Each product is fenced and committed as a group of its
// own, as CUTLASS's warpgroup GEMMs are. Streamed tiles are 128 rows, but 64
// for dK/dV at head_dim > 64 (shared memory). bwd_plan lays
// out the resident buffers, the ring, the words and the barriers; the dQ
// kernel's resident tile is Q, dO and O, so at head_dim > 64 it keeps one
// buffer (two would not fit beside two stages).
//
// Masking: a query always matches its own key, so m_i is at least a matching
// score and a pair across segments has p = exp(MASK - m) = 0 exactly in the
// plain version: the kernels select 0. Rows past L come in as zero rows with
// the segment id INT_MIN (it matches no real id) and statistics m 0, l 1, di
// 0; a zero row adds nothing to a product, and no output row past L is
// stored. At a head_dim that is not a multiple of 64 the 64-column box reads
// the next head's columns: the consumers zero the resident tiles' columns past
// D (Q and dO in dQ, K and V in dK/dV), so they add nothing to S or dP, and
// the stores are masked to D.
#pragma once

#include "attention_sm90.cuh"

namespace mdhs {
namespace sm90 {
namespace bwd {

enum BwdKind : int { kDq = 0, kDkv = 1 };

constexpr int ROWS = QT;                        // resident rows of a work item: queries (dQ) or keys (dK/dV)
constexpr uint32_t RCHUNK = QCHUNK_BYTES;       // one 64-column chunk of a resident tile

constexpr int SN = 64;  // streamed rows of one product: S and dP are m64n64 a warpgroup

// query rows of a streamed dK/dV tile
__host__ __device__ constexpr int dkv_rows(int nc) { return nc == 1 ? 128 : 64; }

struct BwdPlan {
  int rb, st, rows;                             // resident buffers, ring stages, rows of a streamed tile
  uint32_t res_bytes, stage_bytes, words_bytes;  // one resident buffer, one stage's tiles, one stage's words
  uint32_t ring, words, bar, bytes;              // offsets from the 1024-aligned base; the block's request
};

// dQ: resident Q, dO, O (3 NC chunks), stages of K and V (128 rows), one word a key;
// dK/dV: resident K, V (2 NC chunks), stages of Q and dO (QN rows), three words a query
__host__ __device__ constexpr BwdPlan bwd_plan(int kind, int nc) {
  BwdPlan p{};
  const bool dq = kind == kDq;
  p.rows = dq ? KT : dkv_rows(nc);
  p.rb = dq && nc == 2 ? 1 : 2;
  p.st = nc == 2 ? 2 : (dq ? 3 : 4);
  p.res_bytes = (dq ? 3 : 2) * nc * RCHUNK;
  p.stage_bytes = 2 * nc * p.rows * 128;
  p.words_bytes = (dq ? 1 : 3) * p.rows * 4;
  p.ring = p.rb * p.res_bytes;
  p.words = p.ring + p.st * p.stage_bytes;
  p.bar = p.words + p.st * p.words_bytes;
  p.bytes = 1024 + p.bar + (2 * p.rb + 2 * p.st) * 8;
  return p;
}

// --------------------------------------------------------------------------- PTX helpers
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// d[0 .. 32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 64, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc = A B^T over the head dim (ksteps of 16), fenced, issued and committed as a group of its
// own: A and B (64 rows each), both K-major in 128-byte-swizzled chunks of 64 columns, a_chunk
// and b_chunk bytes apart
__device__ __forceinline__ void issue_ss(float (&acc)[SN / 2], uint32_t a, uint32_t a_chunk, uint32_t b,
                                         uint32_t b_chunk, int ksteps) {
  fence_regs(acc);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t c = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n64k16(acc, desc_sw128(a + c * a_chunk + off, 16), desc_sw128(b + c * b_chunk + off, 16), kk > 0);
  }
  wgmma_commit();
  fence_regs(acc);
}

// m log2(e) + log2(l): p = 2^(s log2(e) - lse) is exp(s - m) / l
__device__ __forceinline__ float lse2(float m, float l) { return m * kLog2e + __log2f(l); }

// the thread's value of row r + 8 i, column ``row`` (0 .. 64) of an m64n64 accumulator, or 0
// where another thread of the quad holds it
__device__ __forceinline__ float diagonal(const float (&s)[SN / 2], int row, int qd, int i) {
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < SN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) d = 8 * j + 2 * qd + e == row ? s[4 * j + 2 * i + e] : d;
  return d;
}

// rows row0 + r and row0 + r + 8 of a warpgroup's accumulators, bf16, into one head of a
// (B, L, HD) tensor at ``head``; rows past L and columns past D are not stored
template <int NC>
__device__ __forceinline__ void store_rows(bf16* head, const float (&acc)[NC][32], int row0, int r, int qd, int L,
                                           int HD, int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= L) continue;
    bf16* p = head + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = CHUNK * c + 8 * j + 2 * qd;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(acc[c][4 * j + 2 * i],
                                                                              acc[c][4 * j + 2 * i + 1]);
      }
  }
}

// --------------------------------------------------------------------------- the blocks
struct BwdArgs {
  const CUtensorMap *tq, *tk, *tv, *tdo, *to;  // (B, L, HD) bf16; to is read by dQ only
  const int* seg;                              // (B, L)
  const float *m, *l;                          // (B, heads, L): the forward's statistics
  float* di;                                   // (B, heads, L): written by dQ, read by dK/dV
  bf16 *dq, *dk, *dv;                          // (B, L, HD)
  int B, L, HD, D;
  float sm_scale;
};

// The shared memory, barriers and work items both kernels walk alike.
template <int KIND, int NC>
struct Block {
  static constexpr int RB = bwd_plan(KIND, NC).rb, ST = bwd_plan(KIND, NC).st;
  static constexpr uint32_t RES = bwd_plan(KIND, NC).res_bytes, RING = bwd_plan(KIND, NC).ring,
                            STAGE = bwd_plan(KIND, NC).stage_bytes, WORDS = bwd_plan(KIND, NC).words,
                            WBYTES = bwd_plan(KIND, NC).words_bytes, BAR = bwd_plan(KIND, NC).bar;
  unsigned char* base;
  uint32_t sbase;
  int L, heads, items;

  __device__ __forceinline__ Block(unsigned char* smem, const BwdArgs& a) {
    base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    sbase = smem_u32(base);
    L = a.L, heads = a.HD / a.D;
    items = (L + ROWS - 1) / ROWS * heads * a.B;
  }
  __device__ __forceinline__ uint32_t res(int rb) const { return sbase + rb * RES; }
  __device__ __forceinline__ uint32_t stage(int s) const { return sbase + RING + s * STAGE; }
  __device__ __forceinline__ unsigned char* words(int s) const { return base + WORDS + s * WBYTES; }
  __device__ __forceinline__ uint32_t res_full(int rb) const { return sbase + BAR + 8 * rb; }
  __device__ __forceinline__ uint32_t res_empty(int rb) const { return sbase + BAR + 8 * (RB + rb); }
  __device__ __forceinline__ uint32_t full(int s) const { return sbase + BAR + 8 * (2 * RB + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return sbase + BAR + 8 * (2 * RB + ST + s); }

  __device__ __forceinline__ void init_barriers() const {
    if (threadIdx.x == 0) {
      for (int rb = 0; rb < RB; ++rb) {
        mbar_init(res_full(rb), 1);
        mbar_init(res_empty(rb), CONSUMER_WARPS);
      }
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(s), 32);               // the producer warp's lanes (+ the bytes of the tiles)
        mbar_init(empty(s), CONSUMER_WARPS);  // one arrival a consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the producer warp: each item's resident tiles (lane 0), then its streamed tiles and their words
  template <typename Resident, typename Streamed>
  __device__ __forceinline__ void produce(Resident resident, Streamed streamed, int tiles) const {
    const int lane = threadIdx.x;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const Item w = item_of(item, L, heads);
      const int rb = it % RB;
      mbar_wait(res_empty(rb), ((it / RB) & 1) ^ 1);
      if (lane == 0) resident(w, rb);
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(empty(stage), phase ^ 1);
        streamed(w, t, stage, lane);
        mbar_arrive(full(stage));
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
};

// dQ (and di) of one item: 128 queries of one (head, batch row) against every key tile.
template <int NC>
__device__ __forceinline__ void flash_bwd_dq_sm90(const BwdArgs& a) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  using Blk = Block<kDq, NC>;
  const Blk blk(bwd_smem, a);
  const int L = a.L, D = a.D, heads = blk.heads, T = (L + KT - 1) / KT;
  const int tid = threadIdx.x, wg = tid / 128;
  blk.init_barriers();

  if (wg == 0) {
    // ----------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32) return;
    auto resident = [&](const Item& w, int rb) {  // Q, dO, O chunks
      const uint32_t full = blk.res_full(rb), dst = blk.res(rb);
      mbar_arrive_expect_tx(full, 3 * NC * RCHUNK);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(dst + c * RCHUNK, a.tq, full, w.h * D + CHUNK * c, w.q0, w.b);
        tma_load_3d(dst + (NC + c) * RCHUNK, a.tdo, full, w.h * D + CHUNK * c, w.q0, w.b);
        tma_load_3d(dst + (2 * NC + c) * RCHUNK, a.to, full, w.h * D + CHUNK * c, w.q0, w.b);
      }
    };
    auto streamed = [&](const Item& w, int t, int stage, int lane) {  // K, V chunks and the key segment ids
      const int k0 = t * KT;
      if (lane == 0) {
        const uint32_t full = blk.full(stage), dst = blk.stage(stage);
        mbar_expect_tx(full, 2 * NC * TILE_BYTES);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(dst + c * TILE_BYTES, a.tk, full, w.h * D + CHUNK * c, k0, w.b);
          tma_load_3d(dst + (NC + c) * TILE_BYTES, a.tv, full, w.h * D + CHUNK * c, k0, w.b);
        }
      }
      const int* seg_row = a.seg + static_cast<size_t>(w.b) * L;
      int* dst = reinterpret_cast<int*>(blk.words(stage));
#pragma unroll
      for (int i = 0; i < KT / 32; ++i) {
        const int k = lane + 32 * i;
        dst[k] = k0 + k < L ? seg_row[k0 + k] : INT_MIN;
      }
    };
    blk.produce(resident, streamed, T);
    return;
  }

  // ------------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;  // consumer warpgroup: query rows 64 cw .. 64 cw + 64 of an item
  const int t128 = tid - 128 * wg;
  const int warp = t128 >> 5, lane = t128 & 31;
  const int r = 16 * warp + (lane >> 2);  // this thread's rows r and r + 8 of the warpgroup's 64
  const int qd = lane & 3;                // its quad position: columns 2 qd, 2 qd + 1 of each 8
  const int ksteps = (D + 15) / 16;       // depth of S and dP in steps of 16; Q and dO are zero past D
  const float scale2 = a.sm_scale * kLog2e;
  float s[SN / 2], dp[SN / 2], dq[NC][32];
  uint32_t pa[SN / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < blk.items; item += gridDim.x, ++it) {
    const Item w = item_of(item, L, heads);
    const int rb = it % Blk::RB;
    unsigned char* res = blk.base + rb * Blk::RES;  // Q, dO, O: chunk c of each at c, NC + c, 2 NC + c
    const uint32_t q_wg = blk.res(rb) + cw * 64 * 128, do_wg = q_wg + NC * RCHUNK;
    mbar_wait(blk.res_full(rb), (it / Blk::RB) & 1);
    if (D % CHUNK != 0) {
      zero_past_d<NC>(res, 64 * cw, D, t128);
      zero_past_d<NC>(res + NC * RCHUNK, 64 * cw, D, t128);
      fence_proxy_async();
      named_barrier_sync(1 + cw, 128);
    }
    // di = sum over the head's columns of o * do: the diagonal of dO O^T, made by the same
    // wgmma as dP = dO V^T, so that dp - di cancels exactly where o = v (a row with one key)
    issue_ss(s, do_wg, RCHUNK, blk.res(rb) + 2 * NC * RCHUNK + 64 * cw * 128, RCHUNK, ksteps);
    wgmma_wait0();
    fence_regs(s);
    const size_t stat = (static_cast<size_t>(w.b) * heads + w.h) * L;
    int segq[2];
    float lse[2], di[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 64 * cw + r + 8 * i, qi = w.q0 + row;
      const bool in = qi < L;
      segq[i] = in ? a.seg[static_cast<size_t>(w.b) * L + qi] : INT_MIN;
      lse[i] = in ? lse2(a.m[stat + qi], a.l[stat + qi]) : 0.0f;
      di[i] = quad_sum(diagonal(s, r + 8 * i, qd, i));  // one thread of the quad holds it
      if (in && qd == 0) a.di[stat + qi] = di[i];
    }
    zero_acc<NC>(dq);

    for (int t = 0; t < T; ++t) {
      mbar_wait(blk.full(stage), phase);
      const int* segk = reinterpret_cast<const int*>(blk.words(stage));
#pragma unroll
      for (int h = 0; h < KT / SN; ++h) {
        const uint32_t k_base = blk.stage(stage) + h * SN * 128, v_base = k_base + NC * TILE_BYTES;
        issue_ss(s, q_wg, RCHUNK, k_base, TILE_BYTES, ksteps);
        issue_ss(dp, do_wg, RCHUNK, v_base, TILE_BYTES, ksteps);
        wgmma_wait1();
        fence_regs(s);
        // p, with s[4 j + 2 i + e] at row r + 8 i, key h SN + 8 j + 2 qd + e of the tile
#pragma unroll
        for (int j = 0; j < SN / 8; ++j) {
          const int2 sk = *reinterpret_cast<const int2*>(segk + h * SN + 8 * j + 2 * qd);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[4 * j + 2 * i] = segq[i] == sk.x ? ex2(s[4 * j + 2 * i] * scale2 - lse[i]) : 0.0f;
            s[4 * j + 2 * i + 1] = segq[i] == sk.y ? ex2(s[4 * j + 2 * i + 1] * scale2 - lse[i]) : 0.0f;
          }
        }
        wgmma_wait0();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < SN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              dp[x] = (dp[x] - di[i]) * s[x] * a.sm_scale;
            }
        pack_a(pa, dp);
        issue_rs<NC, SN / 16>(dq, pa, k_base, TILE_BYTES);  // dQ += dS K
        wgmma_wait0();
        fence_acc<NC>(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(blk.empty(stage));
      if (++stage == Blk::ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(blk.res_empty(rb));  // the item's Q, dO and O are no longer read
    store_rows<NC>(a.dq + static_cast<size_t>(w.b) * L * a.HD + w.h * D, dq, w.q0 + 64 * cw, r, qd, L, a.HD, D);
  }
}

// dK and dV of one item: 128 keys of one (head, batch row) against every query tile.
template <int NC>
__device__ __forceinline__ void flash_bwd_dkv_sm90(const BwdArgs& a) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  using Blk = Block<kDkv, NC>;
  constexpr int QN = dkv_rows(NC);
  constexpr uint32_t QCHUNK = QN * 128;  // one chunk of a streamed Q or dO tile
  const Blk blk(bwd_smem, a);
  const int L = a.L, D = a.D, heads = blk.heads, T = (L + QN - 1) / QN;
  const int tid = threadIdx.x, wg = tid / 128;
  blk.init_barriers();

  if (wg == 0) {
    // ----------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32) return;
    auto resident = [&](const Item& w, int rb) {  // K, V chunks
      const uint32_t full = blk.res_full(rb), dst = blk.res(rb);
      mbar_arrive_expect_tx(full, 2 * NC * RCHUNK);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(dst + c * RCHUNK, a.tk, full, w.h * D + CHUNK * c, w.q0, w.b);
        tma_load_3d(dst + (NC + c) * RCHUNK, a.tv, full, w.h * D + CHUNK * c, w.q0, w.b);
      }
    };
    // Q, dO chunks and per query lse (log2 units), di and the segment id: 0, 0, INT_MIN past L
    auto streamed = [&](const Item& w, int t, int stage, int lane) {
      const int q0 = t * QN;
      if (lane == 0) {
        const uint32_t full = blk.full(stage), dst = blk.stage(stage);
        mbar_expect_tx(full, 2 * NC * QCHUNK);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(dst + c * QCHUNK, a.tq, full, w.h * D + CHUNK * c, q0, w.b);
          tma_load_3d(dst + (NC + c) * QCHUNK, a.tdo, full, w.h * D + CHUNK * c, q0, w.b);
        }
      }
      const size_t stat = (static_cast<size_t>(w.b) * heads + w.h) * L;
      const int* seg_row = a.seg + static_cast<size_t>(w.b) * L;
      float* wl = reinterpret_cast<float*>(blk.words(stage));
      float* wd = wl + QN;
      int* ws = reinterpret_cast<int*>(wd + QN);
#pragma unroll
      for (int i = 0; i < QN / 32; ++i) {
        const int q = lane + 32 * i, qq = q0 + q;
        const bool in = qq < L;
        wl[q] = in ? lse2(a.m[stat + qq], a.l[stat + qq]) : 0.0f;
        wd[q] = in ? a.di[stat + qq] : 0.0f;
        ws[q] = in ? seg_row[qq] : INT_MIN;
      }
    };
    blk.produce(resident, streamed, T);
    return;
  }

  // ------------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;  // consumer warpgroup: keys 64 cw .. 64 cw + 64 of an item
  const int t128 = tid - 128 * wg;
  const int warp = t128 >> 5, lane = t128 & 31;
  const int r = 16 * warp + (lane >> 2);  // this thread's keys r and r + 8 of the warpgroup's 64
  const int qd = lane & 3;                // its quad position: queries 2 qd, 2 qd + 1 of each 8
  const int ksteps = (D + 15) / 16;       // K and V are zero past D
  const float scale2 = a.sm_scale * kLog2e;
  float s[SN / 2], dp[SN / 2], dk[NC][32], dv[NC][32];
  uint32_t pp[SN / 16][4], pd[SN / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < blk.items; item += gridDim.x, ++it) {
    const Item w = item_of(item, L, heads);  // w.q0: the item's first key
    const int rb = it % Blk::RB;
    unsigned char* res = blk.base + rb * Blk::RES;  // K, V: chunk c of each at c, NC + c
    const uint32_t k_wg = blk.res(rb) + cw * 64 * 128, v_wg = k_wg + NC * RCHUNK;
    mbar_wait(blk.res_full(rb), (it / Blk::RB) & 1);
    if (D % CHUNK != 0) {
      zero_past_d<NC>(res, 64 * cw, D, t128);
      zero_past_d<NC>(res + NC * RCHUNK, 64 * cw, D, t128);
      fence_proxy_async();
      named_barrier_sync(1 + cw, 128);
    }
    int segk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = w.q0 + 64 * cw + r + 8 * i;
      segk[i] = kj < L ? a.seg[static_cast<size_t>(w.b) * L + kj] : INT_MIN;
    }
    zero_acc<NC>(dk);
    zero_acc<NC>(dv);

    for (int t = 0; t < T; ++t) {
      mbar_wait(blk.full(stage), phase);
#pragma unroll
      for (int h = 0; h < QN / SN; ++h) {
        const uint32_t q_base = blk.stage(stage) + h * SN * 128, do_base = q_base + NC * QCHUNK;
        const float* wl = reinterpret_cast<const float*>(blk.words(stage)) + SN * h;
        const float* wd = wl + QN;
        const int* ws = reinterpret_cast<const int*>(wd + QN);
        issue_ss(s, k_wg, RCHUNK, q_base, QCHUNK, ksteps);
        issue_ss(dp, v_wg, RCHUNK, do_base, QCHUNK, ksteps);
        wgmma_wait1();
        fence_regs(s);
        // P^T, with s[4 j + 2 i + e] at key r + 8 i, query SN h + 8 j + 2 qd + e of the tile
#pragma unroll
        for (int j = 0; j < SN / 8; ++j) {
          const float2 lc = *reinterpret_cast<const float2*>(wl + 8 * j + 2 * qd);
          const int2 sc = *reinterpret_cast<const int2*>(ws + 8 * j + 2 * qd);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[4 * j + 2 * i] = segk[i] == sc.x ? ex2(s[4 * j + 2 * i] * scale2 - lc.x) : 0.0f;
            s[4 * j + 2 * i + 1] = segk[i] == sc.y ? ex2(s[4 * j + 2 * i + 1] * scale2 - lc.y) : 0.0f;
          }
        }
        wgmma_wait0();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < SN / 8; ++j) {
          const float2 dc = *reinterpret_cast<const float2*>(wd + 8 * j + 2 * qd);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dp[4 * j + 2 * i] = (dp[4 * j + 2 * i] - dc.x) * s[4 * j + 2 * i] * a.sm_scale;
            dp[4 * j + 2 * i + 1] = (dp[4 * j + 2 * i + 1] - dc.y) * s[4 * j + 2 * i + 1] * a.sm_scale;
          }
        }
        pack_a(pp, s);
        pack_a(pd, dp);
        issue_rs<NC, SN / 16>(dv, pp, do_base, QCHUNK);  // dV += P^T dO
        issue_rs<NC, SN / 16>(dk, pd, q_base, QCHUNK);   // dK += dS^T Q
        wgmma_wait0();
        fence_acc<NC>(dk);
        fence_acc<NC>(dv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(blk.empty(stage));
      if (++stage == Blk::ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(blk.res_empty(rb));  // the item's K and V are no longer read
    const size_t head = static_cast<size_t>(w.b) * L * a.HD + w.h * D;
    store_rows<NC>(a.dk + head, dk, w.q0 + 64 * cw, r, qd, L, a.HD, D);
    store_rows<NC>(a.dv + head, dv, w.q0 + 64 * cw, r, qd, L, a.HD, D);
  }
}

// --------------------------------------------------------------------------- host side
// Checks, tensor maps and the launch of one backward kernel: kernel1 at head_dim <= 64,
// kernel2 above; a persistent grid, one block an SM (at most one a work item), any B.
template <typename Kernel>
cudaError_t launch_bwd(int kind, Kernel kernel1, Kernel kernel2, const void* q, const void* k, const void* v,
                       const void* dout, const void* o, const int* seg, const float* m, const float* l, float* di,
                       bf16* dq, bf16* dk, bf16* dv, int B, int L, int HD, int num_heads, float sm_scale,
                       void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || HD % num_heads != 0) return cudaErrorInvalidValue;
  const int D = HD / num_heads;
  if (D % 8 != 0 || D > MAX_D) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>((L + ROWS - 1) / ROWS) * num_heads * B;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int nc = chunks(D);
  const Kernel kernel = nc == 1 ? kernel1 : kernel2;
  const BwdPlan sp = bwd_plan(kind, nc);
  if (sp.bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  // resident tiles are ROWS rows; streamed ones sp.rows (K, V in dQ: ROWS; Q, dO in dK/dV: QN)
  const int q_rows = kind == kDq ? ROWS : sp.rows;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = bind_device(&device)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo, to;
  if ((err = head_map(&tq, q, B, L, HD, q_rows)) != cudaSuccess) return err;
  if ((err = head_map(&tdo, dout, B, L, HD, q_rows)) != cudaSuccess) return err;
  if ((err = head_map(&tk, k, B, L, HD, ROWS)) != cudaSuccess) return err;
  if ((err = head_map(&tv, v, B, L, HD, ROWS)) != cudaSuccess) return err;
  if ((err = head_map(&to, kind == kDq ? o : q, B, L, HD, ROWS)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sp.bytes))) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, THREADS, sp.bytes, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tdo, to, seg, m, l, di, dq, dk,
                                                                         dv, B, L, HD, D, sm_scale);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace sm90
}  // namespace mdhs
