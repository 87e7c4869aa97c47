// KANLinear forward for Hopper, float32, over a bank of experts:
//
//     y[e, b, o] = sum_i silu(x[e, b, i]) * Wb[e, o, i]
//                + sum_i sum_c bases_c(x[e, b, i]; grid[e, i, :]) * Ws[e, o, i, c]
//
// x is (E, B, IN), or (B, IN) shared by every expert (x_shared: its expert
// stride is 0, as nn.vmap(in_axes=None) hands layer 0 of the MoE bank one x);
// grid is (E, IN, P), Wb (E, OUT, IN), Ws (E, OUT, IN, C) already scaled;
// y is (E, B, OUT). The bases are the cubic B-splines of efficient-KAN on
// P = 12 knots (grid_size 5, spline_order 3: C = 8 coefficients), by the
// Cox-de Boor recursion with mdhs_tpu/modules/kan.py::b_splines' formula, each
// division by a knot difference taken as a product with its reciprocal.
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/kan_spline.py::_kernel
// (pl.pallas_call at :114), vmapped over the experts. Like it, this reads the
// product as a GEMM whose bases operand (silu(x), then the C bases of each
// input) is made on chip from x and never stored in device memory. K runs in
// stages of 32 floats (one 128-byte swizzle row): a silu stage is 32 inputs of
// Wb, a spline stage 4 inputs of Ws (flattened to (OUT, IN * C)).
//
// The products, at float32 accuracy on the tensor cores: 3xTF32. Each operand
// v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and the three
// products hi*hi + hi*lo + lo*hi accumulate in float32 with wgmma .tf32 (k8,
// both operands K-major, as tf32 requires). The dropped lo*lo term is about
// 2^-22 of each product. Two orientations, picked by the wrapper's plan
// (ops/kan_spline.py::plan):
//   - wide (BN = 64; OUT > 16, layer 0 of the MoE bank): the weights are the M
//     side, 128 rows of one expert a tile (two consumer warpgroups of 64), and
//     the batch the N side, 64 rows. A producer warp streams the weight stages
//     by TMA through a ring; each consumer thread reads its wgmma A fragment
//     from the stage, splits it into hi and lo in registers and gives the stage
//     back, so the split never touches shared memory. The bases tile (64 batch
//     rows x 32 K) is made on chip as a hi and a lo copy and is the B operand
//     of both warpgroups' 128 weight rows;
//   - narrow (BN = 8 or 16; OUT <= 16, the classifier layer's OUT = 7): the
//     batch is the M side, 64 rows a tile (warpgroup 0's products; both
//     warpgroups make the bases), and the weights the N side, so a tile spends
//     1 of 8 columns on padding at OUT = 7 (a 64-row weight tile would spend 57
//     of 64 rows). The consumers split the small weight stage into hi and lo
//     copies in shared memory; both operands come from shared memory.
// The narrow tile's three products go to three accumulators (its small wgmmas
// would otherwise be one chain of 12 a stage), added at the end.
// The consumers make the next stage's bases while the tensor cores run the
// current stage's products (wgmma is asynchronous), into the other of two
// buffers; one named barrier a stage publishes them. They make them from shared
// memory: the stages go chunk by chunk of 32 inputs (a silu stage, then 8
// spline stages), and a chunk's x rows (cp.async) and its inputs' knot tables
// (the 18 knots a window can reach, and the reciprocals of the knot
// differences the recursion divides by, made once an input and block) are
// prepared while the chunk before is walked. Making the bases is the longest
// part of a stage, and its latency is what the rest of the design cuts
// (PERF.md): the loop's code kept small (the silu stage, the copies and the
// tables out of line), shared-memory pointers that stay in the shared address
// space, a branch-free select of a window's bases. The wide tile's weights
// are read once for its 64 batch rows: each expert's weights once a forward at
// batch <= 64.
//
// Split K: where the tiles are too few to fill the card (layer 0: 32 tiles;
// layer 1: 4), the grid also splits the inputs into `splits` ranges of whole
// silu stages. Each block writes its float32 partial tile to a workspace; the
// last block of a tile to finish (a per-tile counter, atomicAdd after a
// __threadfence) adds the splits in order 0 .. splits - 1 into y and resets
// the counter to 0, so one launch does it and the result does not depend on
// scheduling. A cluster reduction through distributed shared memory was not
// taken: layer 1 splits 32 ways and a cluster holds at most 8 blocks (16
// non-portable).
//
// Only 4 of the 8 cubic bases of an input are nonzero: the recursion runs on
// the window of knots around x's interval, the entries the full recursion
// would compute from nonzero terms, with the same formula (an entry whose
// terms are both zero is exactly zero there too), so the result is the full
// recursion's at a third of its work. A product with a reciprocal is within an
// ulp of the division it stands for, at a fraction of an IEEE division's
// instructions (PERF.md).
//
// gemm_sm90.cuh's mainloop is not reused: there both operands stream from
// device memory by TMA, and each k step is one product; here one operand is
// made on chip by the consumers themselves, the other is split into two in
// registers (wide) or in shared memory (narrow), and each k step is three
// products. Its PTX pieces (TMA, mbarriers, descriptors, operand_map) are.
//
// What bounds it on the H100: at layer 0 of the baseline MoE head (x (64, 256)
// shared, 4 experts, OUT 1024) bytes, the 37.7 MB of weights (11.6 us at 3.35
// TB/s) against 3 x 1.21 GFLOP of TF32 products (7.3 us at 495 TFLOP/s).
#include <atomic>

#include "gemm_sm90.cuh"

namespace mdhs {
namespace {

using sm90::desc_sw128;
using sm90::fence_proxy_async;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_barrier_sync;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait0;

constexpr int kPts = 12;                   // knots per input (grid_size + 2 * order + 1)
constexpr int kOrder = 3;                  // spline order
constexpr int kCoeff = kPts - 1 - kOrder;  // 8 bases per input
constexpr int KC = 32;                     // floats of K a stage: one 128-byte swizzle row
constexpr int kSplineInputs = KC / kCoeff; // inputs of a spline stage (Ws)
constexpr int kRowsM = 128;                // weight rows of a wide tile: two consumer warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kGenBarrier = 1;             // named barrier of the consumers
constexpr int kChunkStages = 1 + KC / kSplineInputs;  // a chunk of 32 inputs: its silu stage, 8 spline stages
// An input's knot table: K[u] = g[clamp(u - 3, 0, 11)] for u < 18, then for k = 1, 2, 3
// R_k[u] = 1 / (K[u + k] - K[u]) (u + k < 18): the window around interval s reads
// knots K[s ..] and the recursion's denominators from R_k[s ..]
constexpr int kTabK = kPts + 2 * kOrder;   // 18
constexpr int kTab = 4 * kTabK;            // K, R_1, R_2, R_3

// the tensor map's element type for wg::operand_map (boxes of 32 floats)
struct TF32 {
  static constexpr int kBytes = 4;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Shared memory of a block: the weight ring, two generation buffers, two chunk buffers,
// the barriers.
template <int BN>
struct Layout {
  static constexpr bool kNarrow = BN < 64;
  static constexpr int kGenRows = 64;                      // batch rows of the bases tile
  static constexpr int kWRows = kNarrow ? BN : kRowsM;    // weight rows of a stage
  static constexpr int kStages = kNarrow ? 8 : 6;
  static constexpr uint32_t kWBytes = kWRows * 128;
  static constexpr uint32_t kGenBytes = kGenRows * 128;  // one copy (hi or lo) of the bases tile
  // a generation buffer: bases hi, bases lo and (narrow) the weight stage's hi, lo
  static constexpr uint32_t kBufBytes = 2 * kGenBytes + (kNarrow ? 2 * kWBytes : 0);
  static constexpr uint32_t kBuf = kStages * kWBytes;
  // a chunk of 32 inputs (two, by chunk parity): x (kGenRows x 32, rows padded to 33
  // floats: conflict-free columns), the inputs' knots as copied, their tables (kTab floats)
  static constexpr uint32_t kXBytes = kGenRows * (KC + 1) * 4;
  static constexpr uint32_t kKnotBytes = KC * kPts * 4;
  static constexpr uint32_t kChunkBytes = kXBytes + kKnotBytes + KC * kTab * 4;
  static constexpr uint32_t kChunk = kBuf + 2 * kBufBytes;
  static constexpr uint32_t kBar = kChunk + 2 * kChunkBytes;  // full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = 1024 + kBar + 2 * kStages * 8;
};

// ---------------------------------------------------------------------------- arithmetic
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// The kCoeff cubic bases of v from its input's knot table (shared memory). The
// recursion is mdhs_tpu/modules/kan.py::b_splines' formula on the window of knots around
// v's interval, with each division by a knot difference taken as a product with that
// difference's reciprocal, made once an input (the table): within an ulp of the
// division at every step.
__device__ __forceinline__ void spline_bases(float v, const float* __restrict__ tab, float (&a)[kCoeff]) {
  const float* K = tab;
  // the interval g[s] <= v < g[s + 1], g[j] = K[j + 3], the last such j (none outside the
  // knots): a max over the 11 tests, so that they run side by side
  int m[kPts - 1];
#pragma unroll
  for (int j = 0; j < kPts - 1; ++j) m[j] = v >= K[j + kOrder] && v < K[j + kOrder + 1] ? j : -1;
#pragma unroll
  for (int w = 1; w < kPts - 1; w *= 2)
#pragma unroll
    for (int j = 0; j + w < kPts - 1; j += 2 * w) m[j] = max(m[j], m[j + w]);
  const int s = m[0];
#pragma unroll
  for (int c = 0; c < kCoeff; ++c) a[c] = 0.0f;
  if (s < 0) return;
  // window position p stands for base index j = s - kOrder + p; its knots are K[s + p ..]
  float gw[2 * kOrder + 2];
#pragma unroll
  for (int t = 0; t < 2 * kOrder + 2; ++t) gw[t] = K[s + t];
  float n[kOrder + 2];
#pragma unroll
  for (int p = 0; p < kOrder + 2; ++p) n[p] = p == kOrder ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 1; k <= kOrder; ++k) {
    const float* R = tab + k * kTabK + s;
#pragma unroll
    for (int p = kOrder - k; p <= kOrder; ++p) {  // the entries with a nonzero term
      const float left = (v - gw[p]) * R[p];
      const float right = (gw[p + k + 1] - v) * R[p + 1];
      n[p] = left * n[p] + right * n[p + 1];
    }
  }
#pragma unroll
  for (int c = 0; c < kCoeff; ++c) {
    const int p = c - s + kOrder;  // base c sits at window position p, if 0 <= p <= 3
    float v = 0.0f;                // (selects, not branches: the lanes' s differ)
#pragma unroll
    for (int i = 0; i <= kOrder; ++i) v = p == i ? n[i] : v;
    a[c] = v;
  }
}

// v's TF32 high part (cvt.rna: round to nearest, ties away from zero), a float with
// its low 13 mantissa bits zero; v - hi is exact, and its own TF32 rounding is lo.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// Float offset of element (row n, k) of a tile of 128-byte rows with the 128-byte
// swizzle (the 16-byte chunk k / 4 of row n lies at chunk (k / 4) ^ (n % 8)), the
// layout TMA writes and wgmma reads; the tile starts on a 1024-byte boundary.
__device__ __forceinline__ int swz(int n, int k) { return n * KC + ((((k >> 2) ^ (n & 7)) << 2) | (k & 3)); }

// four consecutive values (k % 4 == 0) into the hi and lo copies of a tile
__device__ __forceinline__ void store_split(float* hi, float* lo, int n, int k, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], h[i], l[i]);
  const int off = swz(n, k);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// 4 bytes from device memory into shared memory, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------- wgmma .tf32
// The accumulator layout is the bf16 one: d[4 j + 2 i + e] is row 16 warp + lane / 4 + 8 i,
// column 8 j + 2 (lane % 4) + e of the warpgroup's 64-row tile.

// d[0 .. 32) += A (64 x 8, registers) * B (8 x 64, shared memory, K-major). The A
// fragment of a warp's 16 rows: a0 (lane / 4, lane % 4), a1 (+8 rows), a2 (+4
// columns), a3 (+8 rows, +4 columns), as mma.m16n8k8's tf32 A.
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0 .. 4) += A (64 x 8, shared memory, K-major) * B (8 x 8, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// d[0 .. 8) += A (64 x 8, shared memory, K-major) * B (8 x 16, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---------------------------------------------------------------------------- the block
struct Args {
  const float* x;
  const float* grid;
  float* y;
  float* ws;       // splits x E x B x OUT partial sums (splits > 1)
  int* counters;   // a tile's finished splits (splits > 1), 0 between launches
  int E, B, IN, OUT;
  long long x_expert_stride;
  int row_tiles, col_tiles, splits, per;
};

// Stage q of a block's inputs i0 .. i1, chunk by chunk of 32 inputs: the chunk's silu
// stage (32 inputs of Wb), then its spline stages (4 inputs of Ws each).
struct Stages {
  int i0, i1, n, chunks;
  __device__ Stages(int i0_, int i1_) : i0(i0_), i1(i1_) {
    const int full = (i1 - i0) / KC, rest = (i1 - i0) % KC;
    chunks = full + (rest > 0);
    n = full * kChunkStages + (rest > 0 ? 1 + (rest + kSplineInputs - 1) / kSplineInputs : 0);
  }
  __device__ static int chunk(int q) { return q / kChunkStages; }
  __device__ static bool silu(int q) { return q % kChunkStages == 0; }
  __device__ int first_input(int q) const {  // of the stage
    const int j = q % kChunkStages;
    return i0 + chunk(q) * KC + (j == 0 ? 0 : (j - 1) * kSplineInputs);
  }
};

// Chunk c's x (kGenRows batch rows from b0) and its inputs' knots, by cp.async, into
// chunk buffer c % 2; zero past B and past the block's inputs.
template <int BN>
__device__ __noinline__ void prepare_chunk(const Args& a, const Stages& st, int c, int e, int b0,
                                              unsigned char* buf, int t) {
  using Lay = Layout<BN>;
  constexpr int R = Lay::kGenRows;
  float* xs = reinterpret_cast<float*>(buf);
  float* knots = reinterpret_cast<float*>(buf + Lay::kXBytes);
  const int ci = st.i0 + c * KC;
  const float* xe = a.x + e * a.x_expert_stride;
  for (int i = t; i < R * KC; i += kConsumers) {
    const int n = i / KC, k = i % KC;
    const bool ok = b0 + n < a.B && ci + k < st.i1;
    cp_async4(xs + n * (KC + 1) + k, ok ? xe + static_cast<long long>(b0 + n) * a.IN + ci + k : a.x, ok);
  }
  const float* g = a.grid + (static_cast<long long>(e) * a.IN + ci) * kPts;  // the chunk's knots are contiguous
  for (int i = t; i < KC * kPts; i += kConsumers) {
    const bool ok = ci + i / kPts < st.i1;
    cp_async4(knots + i, ok ? g + i : a.grid, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Chunk c's knot tables from its copied knots (after the copies have landed).
template <int BN>
__device__ __noinline__ void build_tables(unsigned char* buf, int t) {
  using Lay = Layout<BN>;
  const float* knots = reinterpret_cast<const float*>(buf + Lay::kXBytes);
  float* tab = reinterpret_cast<float*>(buf + Lay::kXBytes + Lay::kKnotBytes);
  for (int i = t; i < KC * kTabK; i += kConsumers) {
    const int il = i / kTabK, u = i % kTabK;
    const float* g = knots + il * kPts;
    float* tb = tab + il * kTab;
    auto knot = [&](int w) { return g[min(max(w - kOrder, 0), kPts - 1)]; };
    const float ku = knot(u);
    tb[u] = ku;
#pragma unroll
    for (int k = 1; k <= kOrder; ++k)
      if (u + k < kTabK) tb[k * kTabK + u] = 1.0f / (knot(u + k) - ku);
  }
}

// A silu stage's tile: silu(x) of its 32 inputs (out of line: once in 9 stages, and
// the hot loop's code stays small).
template <int BN>
__device__ __noinline__ void make_silu(const Args& a, const Stages& st, int ib, int b0, const float* xs, float* hi,
                                       float* lo, int t) {
  constexpr int R = Layout<BN>::kGenRows;
  constexpr int per_thread = KC * R / kConsumers;  // 8 inputs
  const int n = t % R;
  const int k0 = (t / R) * per_thread;
  const bool row = b0 + n < a.B;
#pragma unroll
  for (int k = 0; k < per_thread; k += 4) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = row && ib + k0 + k + i < st.i1 ? silu(xs[n * (KC + 1) + k0 + k + i]) : 0.0f;
    store_split(hi, lo, n, k0 + k, v);
  }
}

// The bases tile of stage q (kGenRows batch rows from b0, 32 K) as hi and lo copies,
// from its chunk's buffer: silu(x) for a silu stage, the 8 bases of 4 inputs for a
// spline stage; zero for a batch row past B or an input past the block's range.
template <int BN>
__device__ __forceinline__ void make_bases(const Args& a, const Stages& st, int q, int b0, const unsigned char* chunk,
                                           float* hi, float* lo, int t) {
  using Lay = Layout<BN>;
  constexpr int R = Lay::kGenRows;
  const float* xs = reinterpret_cast<const float*>(chunk);
  const float* tab = reinterpret_cast<const float*>(chunk + Lay::kXBytes + Lay::kKnotBytes);
  const int ib = st.first_input(q), kb = ib - (st.i0 + Stages::chunk(q) * KC);  // kb: the stage's first input in the chunk
  if (Stages::silu(q)) {
    make_silu<BN>(a, st, ib, b0, xs, hi, lo, t);
  } else {
#pragma unroll
    for (int p = t; p < R * kSplineInputs; p += kConsumers) {
      const int n = p % R, il = p / R;
      float c[kCoeff];
      if (b0 + n < a.B && ib + il < st.i1) {
        spline_bases(xs[n * (KC + 1) + kb + il], tab + (kb + il) * kTab, c);
      } else {
#pragma unroll
        for (int i = 0; i < kCoeff; ++i) c[i] = 0.0f;
      }
      store_split(hi, lo, n, il * kCoeff, {c[0], c[1], c[2], c[3]});
      store_split(hi, lo, n, il * kCoeff + 4, {c[4], c[5], c[6], c[7]});
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    kan_forward_kernel(const __grid_constant__ CUtensorMap tWb, const __grid_constant__ CUtensorMap tWs, Args a) {
  using Lay = Layout<BN>;
  constexpr bool kNarrow = Lay::kNarrow;
  constexpr int ST = Lay::kStages;
  constexpr int NACC = kNarrow ? BN / 2 : 32;
  extern __shared__ __align__(1024) unsigned char kan_smem[];
  // 1024-byte aligned, by an offset from the array (not through an integer, which would
  // leave the compiler generic loads and stores for every shared-memory access)
  unsigned char* base = kan_smem + ((1024u - (smem_u32(kan_smem) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  auto bar_full = [&](int s) { return sbase + Lay::kBar + 8 * s; };
  auto bar_empty = [&](int s) { return sbase + Lay::kBar + 8 * (ST + s); };
  auto ring = [&](int s) { return base + s * Lay::kWBytes; };
  auto buf = [&](int b) { return base + Lay::kBuf + b * Lay::kBufBytes; };
  auto chunk_buf = [&](int b) { return base + Lay::kChunk + b * Lay::kChunkBytes; };
  __shared__ int last_split;

  // the block's tile and split; wide: rows o0 .. of the weights x batch rows b0 ..;
  // narrow: batch rows b0 .. x outputs o0 ..
  const int tiles = a.E * a.row_tiles * a.col_tiles;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int e = tile / (a.row_tiles * a.col_tiles);
  const int rt = tile % (a.row_tiles * a.col_tiles) / a.col_tiles, ct = tile % a.col_tiles;
  const int o0 = kNarrow ? ct * BN : rt * kRowsM;
  const int b0 = kNarrow ? rt * Lay::kGenRows : ct * BN;
  const Stages st(split * a.per, min(a.IN, (split + 1) * a.per));
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warp: stage q's weights into ring slot q % ST
    if (tid == kConsumers) {
      const int row = e * a.OUT + o0;
      for (int q = 0; q < st.n; ++q) {
        const int s = q % ST;
        mbar_wait(bar_empty(s), ((q / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full(s), Lay::kWBytes);
        const int col = st.silu(q) ? st.first_input(q) : st.first_input(q) * kCoeff;
        wg::tma_load_2d(smem_u32(ring(s)), st.silu(q) ? &tWb : &tWs, bar_full(s), col, row);
      }
    }
  } else {
    // ---- the consumers
    const int w = tid / 128, t128 = tid % 128, warp = t128 / 32, lane = tid % 32;
    // wide: one accumulator; narrow: one a product (hi hi, hi lo, lo hi), so that its tiny
    // wgmmas are three independent chains, added at the end
    float acc[NACC], acc1[kNarrow ? NACC : 1], acc2[kNarrow ? NACC : 1];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (kNarrow ? NACC : 1); ++i) acc1[i] = acc2[i] = 0.0f;
    // narrow: a tile is 64 batch rows, warpgroup 0's products; both warpgroups make the bases
    const bool active = !kNarrow || w == 0;

    // stage q's generated operands into buffer q % 2: the bases and (narrow) the
    // weights' hi and lo copies, after which the weight stage goes back to the ring
    auto generate = [&](int q) {
      const int c = Stages::chunk(q);
      unsigned char* chunk = chunk_buf(c & 1);
      if (Stages::silu(q)) {
        // chunk c's copies have landed (each thread's own, then everyone's); the next
        // chunk's copies start, into the other buffer (the last stage that read it is done)
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        named_barrier_sync(kGenBarrier, kConsumers);
        if (c + 1 < st.chunks) prepare_chunk<BN>(a, st, c + 1, e, b0, chunk_buf((c + 1) & 1), tid);
      }
      unsigned char* g = buf(q & 1);
      make_bases<BN>(a, st, q, b0, chunk, reinterpret_cast<float*>(g), reinterpret_cast<float*>(g + Lay::kGenBytes),
                     tid);
      // the chunk's spline stages read its tables from the next stage on, after the barrier
      if (Stages::silu(q)) build_tables<BN>(chunk, tid);
      if constexpr (kNarrow) {
        const int s = q % ST;
        mbar_wait(bar_full(s), (q / ST) & 1);
        const float* raw = reinterpret_cast<const float*>(ring(s));
        uint32_t* whi = reinterpret_cast<uint32_t*>(g + 2 * Lay::kGenBytes);
        uint32_t* wlo = reinterpret_cast<uint32_t*>(g + 2 * Lay::kGenBytes + Lay::kWBytes);
        for (int i = tid; i < BN * KC; i += kConsumers) split_tf32(raw[i], whi[i], wlo[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(s));
      }
      fence_proxy_async();  // the generic stores, visible to wgmma
    };

    prepare_chunk<BN>(a, st, 0, e, b0, chunk_buf(0), tid);
    generate(0);
    named_barrier_sync(kGenBarrier, kConsumers);
    uint32_t fhi[4][4], flo[4][4];  // wide: the A fragments of a stage's four k8 steps
    for (int q = 0; q < st.n; ++q) {
      const uint32_t g = smem_u32(buf(q & 1));
      if constexpr (!kNarrow) {
        const int s = q % ST;
        mbar_wait(bar_full(s), (q / ST) & 1);
        const float* raw = reinterpret_cast<const float*>(ring(s));
        const int r0 = 64 * w + 16 * warp + lane / 4;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int c0 = 8 * kk + lane % 4;
          const float v[4] = {raw[swz(r0, c0)], raw[swz(r0 + 8, c0)], raw[swz(r0, c0 + 4)],
                              raw[swz(r0 + 8, c0 + 4)]};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(v[i], fhi[kk][i], flo[kk][i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(s));
        wgmma_fence();
        const uint32_t bhi = g, blo = g + Lay::kGenBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_tf32_n64(acc, fhi[kk], desc_sw128(bhi + kk * 32, 16));
          wgmma_rs_tf32_n64(acc, fhi[kk], desc_sw128(blo + kk * 32, 16));
          wgmma_rs_tf32_n64(acc, flo[kk], desc_sw128(bhi + kk * 32, 16));
        }
        wgmma_commit();
      } else if (active) {
        wgmma_fence();
        const uint32_t ahi = g, alo = ahi + Lay::kGenBytes;
        const uint32_t whi = g + 2 * Lay::kGenBytes, wlo = whi + Lay::kWBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_tf32(acc, desc_sw128(ahi + kk * 32, 16), desc_sw128(whi + kk * 32, 16));
          wgmma_ss_tf32(acc1, desc_sw128(ahi + kk * 32, 16), desc_sw128(wlo + kk * 32, 16));
          wgmma_ss_tf32(acc2, desc_sw128(alo + kk * 32, 16), desc_sw128(whi + kk * 32, 16));
        }
        wgmma_commit();
      }
      if (q + 1 < st.n) generate(q + 1);  // under this stage's products
      wgmma_wait0();
      sm90::fence_regs(acc);
      if constexpr (kNarrow) {
        sm90::fence_regs(acc1);
        sm90::fence_regs(acc2);
      }
      if constexpr (!kNarrow) {
        fence_u32(fhi);
        fence_u32(flo);
      }
      // the next buffer is complete, and this one (stage q's) is read by every warpgroup
      if (q + 1 < st.n) named_barrier_sync(kGenBarrier, kConsumers);
    }

    // ---- the tile: into y (one split) or this split's slice of the workspace
    if constexpr (kNarrow) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += acc1[i] + acc2[i];
    }
    if (active) {
      float* out = a.splits == 1 ? a.y : a.ws + static_cast<long long>(split) * a.E * a.B * a.OUT;
      out += static_cast<long long>(e) * a.B * a.OUT;
      const int r = 64 * w + 16 * warp + lane / 4, c = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // wide: the accumulator's rows are outputs, its columns batch rows; narrow: the reverse
            const int o = kNarrow ? o0 + 8 * j + c + h : o0 + r + 8 * i;
            const int b = kNarrow ? b0 + r + 8 * i : b0 + 8 * j + c + h;
            if (o < a.OUT && b < a.B) out[static_cast<long long>(b) * a.OUT + o] = acc[4 * j + 2 * i + h];
          }
    }
  }
  if (a.splits == 1) return;

  // ---- split K: the last block of the tile adds the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_split = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  const int nb = min(Lay::kGenRows, a.B - b0), no = min(kNarrow ? BN : kRowsM, a.OUT - o0);
  const long long slice = static_cast<long long>(a.E) * a.B * a.OUT;
  const float* __restrict__ ws = a.ws + (static_cast<long long>(e) * a.B + b0) * a.OUT + o0;
  float* __restrict__ yt = a.y + (static_cast<long long>(e) * a.B + b0) * a.OUT + o0;
  // the sums in split order, with a thread's U elements and S splits of loads in flight together
  auto reduce = [&](auto zero, auto load, auto add, auto store, int count, int width, int step, auto u_tag,
                    auto s_tag) {
    constexpr int U = decltype(u_tag)::value, S = decltype(s_tag)::value;
    for (int i0 = tid; i0 < count; i0 += U * kThreads) {
      decltype(zero) v[U];
      long long idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        idx[u] = static_cast<long long>(i / width) * a.OUT + (i % width) * step;
        v[u] = i < count ? load(idx[u]) : zero;
      }
      for (int s0 = 1; s0 < a.splits; s0 += S) {
        decltype(zero) w[S][U];
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int u = 0; u < U; ++u)
            w[s][u] = s0 + s < a.splits && i0 + u * kThreads < count ? load((s0 + s) * slice + idx[u]) : zero;
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (s0 + s < a.splits) v[u] = add(v[u], w[s][u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * kThreads < count) store(idx[u], v[u]);
    }
  };
  if (a.OUT % 4 == 0 && no % 4 == 0) {
    reduce(make_float4(0.f, 0.f, 0.f, 0.f),
           [&](long long i) { return __ldcg(reinterpret_cast<const float4*>(ws + i)); },
           [](float4 p, float4 q) { return make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w); },
           [&](long long i, float4 v) { *reinterpret_cast<float4*>(yt + i) = v; }, nb * (no / 4), no / 4, 4,
           std::integral_constant<int, 4>(), std::integral_constant<int, 4>());
  } else {
    reduce(0.0f, [&](long long i) { return __ldcg(ws + i); }, [](float p, float q) { return p + q; },
           [&](long long i, float v) { yt[i] = v; }, nb * no, no, 1, std::integral_constant<int, 2>(),
           std::integral_constant<int, 16>());
  }
  if (tid == 0) a.counters[tile] = 0;
}

// A weight operand's tensor map, kept: a served model hands the same stacked weights
// to every call, and encoding a map (cuTensorMapEncodeTiled) takes host time. A map is
// a function of its arguments alone, so an entry with the same arguments is the same map.
cudaError_t weight_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  struct Kept {
    const void* ptr;
    int rows, K, box_rows;
    CUtensorMap map;
  };
  constexpr int kKept = 8;  // a few banks' two layers, two maps each
  thread_local Kept kept[kKept] = {};
  thread_local int next = 0;
  for (const Kept& k : kept)
    if (k.ptr == ptr && k.rows == rows && k.K == K && k.box_rows == box_rows) {
      *map = k.map;
      return cudaSuccess;
    }
  const cudaError_t err = wg::operand_map<TF32>(map, ptr, rows, K, box_rows);
  if (err != cudaSuccess) return err;
  kept[next] = {ptr, rows, K, box_rows, *map};
  next = (next + 1) % kKept;
  return cudaSuccess;
}

template <int BN>
cudaError_t launch(const void* x, const void* grid, const void* bw, const void* sw, void* y, void* ws,
                   void* counters, int E, int B, int IN, int OUT, int ldb, int x_shared, int row_tiles,
                   int col_tiles, int splits, int per, cudaStream_t stream) {
  using Lay = Layout<BN>;
  const long long blocks = static_cast<long long>(E) * row_tiles * col_tiles * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err;
  if ((err = sm90::bind_device(&device)) != cudaSuccess) return err;
  CUtensorMap tWb, tWs;
  if ((err = weight_map(&tWb, bw, E * OUT, ldb, Lay::kWRows)) != cudaSuccess) return err;
  if ((err = weight_map(&tWs, sw, E * OUT, IN * kCoeff, Lay::kWRows)) != cudaSuccess) return err;
  // the shared-memory size is set once a device (a bit each for devices 0 .. 63)
  static std::atomic<unsigned long long> sized{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  auto kernel = kan_forward_kernel<BN>;
  if (!(sized.load(std::memory_order_relaxed) & bit)) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(Lay::kBytes))) != cudaSuccess)
      return err;
    sized.fetch_or(bit, std::memory_order_relaxed);
  }
  Args a;
  a.x = static_cast<const float*>(x);
  a.grid = static_cast<const float*>(grid);
  a.y = static_cast<float*>(y);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.E = E;
  a.B = B;
  a.IN = IN;
  a.OUT = OUT;
  a.x_expert_stride = x_shared ? 0 : static_cast<long long>(B) * IN;
  a.row_tiles = row_tiles;
  a.col_tiles = col_tiles;
  a.splits = splits;
  a.per = per;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Lay::kBytes, stream>>>(tWb, tWs, a);
  return cudaGetLastError();
}

// n tiles of `size` cover `extent` rows exactly: none missing, none empty
bool covers(int n, int size, int extent) {
  return n >= 1 && static_cast<long long>(n) * size >= extent && static_cast<long long>(n - 1) * size < extent;
}

}  // namespace
}  // namespace mdhs

// The plan (ops/kan_spline.py::plan), its one source: bn 64 (wide: row_tiles of 128
// weight rows x col_tiles of 64 batch rows) or 8, 16 (narrow: row_tiles of 64 batch rows
// x col_tiles of bn outputs); the inputs in `splits` ranges of `per` (a multiple of 32),
// none empty. Wb's rows lie `ldb` floats apart (a multiple of 4, at least IN: TMA's
// 16-byte pitch), Ws's IN * 8. ws holds splits * E * B * OUT floats and counters one int
// a tile (E * row_tiles * col_tiles), zero, when splits > 1 (unused otherwise).
extern "C" int kan_forward(const void* x, const void* grid, const void* bw, const void* sw, void* y, void* ws,
                           void* counters, int E, int B, int IN, int OUT, int ldb, int x_shared, int bn,
                           int row_tiles, int col_tiles, int splits, int per, void* stream) {
  const bool narrow = bn < 64;
  if (E <= 0 || B <= 0 || IN <= 0 || OUT <= 0 || splits <= 0 || per <= 0 || per % mdhs::KC != 0 ||
      static_cast<long long>(per) * splits < IN || static_cast<long long>(per) * (splits - 1) >= IN ||
      ldb < IN || ldb % 4 != 0 || static_cast<long long>(E) * OUT > 0x7fffffffLL ||
      !mdhs::covers(row_tiles, narrow ? 64 : mdhs::kRowsM, narrow ? B : OUT) ||
      !mdhs::covers(col_tiles, narrow ? bn : 64, narrow ? OUT : B) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  decltype(&mdhs::launch<64>) run = bn == 64   ? &mdhs::launch<64>
                                    : bn == 16 ? &mdhs::launch<16>
                                    : bn == 8  ? &mdhs::launch<8>
                                               : nullptr;
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(x, grid, bw, sw, y, ws, counters, E, B, IN, OUT, ldb, x_shared, row_tiles, col_tiles, splits, per,
             static_cast<cudaStream_t>(stream));
}
