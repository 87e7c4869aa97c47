// Per-channel BatchNorm statistics for Hopper, and their gradient: the mean and the
// biased variance over the rows of a channels-last activation x (R, C), bf16 or
// float32 in, float32 out (training-mode BatchNorm of the ResNet towers,
// models/norm.py::BatchNorm2d with bn_stats_kernel=True); and dx from (dmean, dvar).
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/bn_stats.py::_impl (pl.pallas_call at
// :138), which ran its row blocks in grid order and carried a running Chan combine
// from one grid step to the next; and the JAX package's analytic VJP of it
// (mdhs_tpu/ops/bn_stats.py:190-203, XLA ops that XLA fuses into one pass).
//
// What bounds both on the H100: bytes. The statistics read x once (about five float
// operations an element); the gradient reads x and writes dx once. The statistics'
// design:
//
//   * Whole rows, contiguous ranges. A block owns a contiguous range of rows of one
//     channel group (all C channels where C is narrow, so the range is one span of
//     memory), and a thread a fixed 16 bytes of channels: 8 bf16 or 4 float32 values
//     (`Vec`). Where rows are few and C wide, the plan (ops/bn_stats.py::plan) splits
//     the channels too (rows of at least 128 bytes a group), so that the grid fills
//     the card and the last block of a group combines at most 8 partials a thread.
//   * Bytes in flight. Each thread keeps two chunks of four 16-byte loads in flight in
//     registers (the next chunk's loads issued before this one's arithmetic); two
//     blocks an SM hold 64 KB in flight, where 3.35 TB/s needs about 25 KB. A ring of
//     1-D bulk asynchronous copies (cp.async.bulk) into shared memory was measured
//     first on the H100 and was slower: 0.034 against 0.029 ms at (401,408, 64), 0.044
//     against 0.028 at (100,352, 256), where a channel group's rows take one copy each.
//   * Statistics in registers. A chunk is four rows of a thread's channels. Its
//     statistics are two-pass (the mean, then the sum of squared deviations from it;
//     never E[x^2] - mu^2, whose cancellation mdhs_tpu/models/norm.py:66-73 measured),
//     merged into the thread's running (n, mean, M2) with Chan's combine
//         delta = m_b - m_a;  m = m_a + delta * n_b / n;  M2 = M2_a + M2_b + delta^2 * n_a * n_b / n
//     (n_b / n as n_b times the correctly rounded 1 / n: a chain of combines waits on no
//     division).
//     The threads of a block that share channels combine in a fixed pairwise order:
//     by warp shuffles, then across warps through shared memory (`tree`).
//   * One launch. Each block writes its (mean, M2) partials to a workspace the wrapper
//     keeps; the last block of a channel group to finish (an atomicAdd ticket, reset to
//     0 by that block, as kan_spline.cu's split K) combines the group's partials in
//     group order and writes mean and var = M2 / R. The result does not depend on how
//     the blocks were scheduled: two calls give the same bits.
//
// Row counts are float32 in the combine, so R < 2^24 (ops/bn_stats.py::supports).
// Where a row is not a multiple of 16 bytes, or x is not 16-byte aligned, the same
// kernel runs with one channel a thread (Vec = 1).
//
// The gradient (bn_stats_backward_kernel): dx = dmean / n + dvar * 2 * (x - mean) / n in
// float32, in the JAX VJP's order of operations, one rounding to x's dtype at the end.
// A thread owns 16 bytes of channels (its three coefficients in registers) and walks
// rows with eight 16-byte loads in flight, then eight 16-byte stores; four blocks an SM.
#include <type_traits>

#include <cuda/atomic>

#include "common.cuh"

namespace mdhs {
namespace {

constexpr int kThreads = 256;  // a block
constexpr int kChunk = 4;      // rows a thread holds at once

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) *p = f[0];
    else *p = __float2bfloat16_rn(f[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// V float32 values: from the workspace past L1 (another block wrote them), or to memory
template <int V>
__device__ __forceinline__ void load_cg(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p + i));
      f[i] = u.x, f[i + 1] = u.y, f[i + 2] = u.z, f[i + 3] = u.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// A running (n, mean, M2) of V channels
template <int V>
struct Stats {
  float n;
  float mean[V], m2[V];
};

// Chan's combine of (n_b, mean_b, m2_b) into a; a.n may be 0
template <int V>
__device__ __forceinline__ void chan(Stats<V>& a, float n_b, const float (&mean_b)[V], const float (&m2_b)[V]) {
  if (n_b == 0.0f) return;
  if (a.n == 0.0f) {
    a.n = n_b;
#pragma unroll
    for (int e = 0; e < V; ++e) a.mean[e] = mean_b[e], a.m2[e] = m2_b[e];
    return;
  }
  const float n = a.n + n_b;
  const float f = n_b * __frcp_rn(n), g = a.n * f;  // n_b / n and n_a n_b / n, one reciprocal
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float delta = mean_b[e] - a.mean[e];
    a.mean[e] = a.mean[e] + delta * f;
    a.m2[e] = a.m2[e] + m2_b[e] + delta * delta * g;
  }
  a.n = n;
}

// A chunk's k rows (1 <= k <= kChunk): their two-pass statistics, then Chan's combine
template <int V>
__device__ __forceinline__ void add_chunk(Stats<V>& s, const float (&v)[kChunk][V], int k) {
  const float inv = k == kChunk ? 1.0f / kChunk : 1.0f / static_cast<float>(k);
  float mean_b[V], m2_b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < k) t += v[i][e];
    mean_b[e] = t * inv;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < k) {
        const float d = v[i][e] - mean_b[e];
        t += d * d;
      }
    m2_b[e] = t;
  }
  chan(s, static_cast<float>(k), mean_b, m2_b);
}

// The statistics of the Q row lanes q = 0 .. Q-1 that share vector j, combined pairwise
// in a fixed order; lane 0 ends with the whole. Where a warp holds W = 32 / vg of the
// lanes (vg a power of two below 32), first inside each warp by shuffles: at h = W/2,
// W/4, .. 1, lane p < h of the warp takes in lane p + h. Then the U holders left (lanes
// q = u * W) through shared memory: at h the largest power of two below U, then its
// halves, holder u < h takes in holder u + h. Every thread of the block calls it;
// `scratch` holds (1 + 2V) * kThreads floats.
template <int V>
__device__ __forceinline__ void tree(Stats<V>& s, bool active, int q, int Q, int j, int vg, float* scratch) {
  int W = 1;
  if (vg < 32 && 32 % vg == 0) {
    W = 32 / vg;
    for (int h = W / 2; h >= 1; h >>= 1) {
      const float n_b = __shfl_down_sync(0xffffffffu, s.n, h * vg);
      float mb[V], qb[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mb[e] = __shfl_down_sync(0xffffffffu, s.mean[e], h * vg);
        qb[e] = __shfl_down_sync(0xffffffffu, s.m2[e], h * vg);
      }
      if (q % W < h) chan(s, n_b, mb, qb);
    }
  }
  float* sn = scratch;
  float* sm = scratch + kThreads;
  float* sq = scratch + (1 + V) * kThreads;
  const int U = (Q + W - 1) / W, u = q / W, t = u * vg + j;
  const bool holder = active && q % W == 0;
  if (holder) {
    sn[t] = s.n;
#pragma unroll
    for (int e = 0; e < V; ++e) sm[e * kThreads + t] = s.mean[e], sq[e * kThreads + t] = s.m2[e];
  }
  int h = 1;
  while (2 * h < U) h *= 2;
  for (; h >= 1; h >>= 1) {
    __syncthreads();
    if (holder && u < h && u + h < U) {
      const int w = t + h * vg;
      float mb[V], qb[V];
#pragma unroll
      for (int e = 0; e < V; ++e) mb[e] = sm[e * kThreads + w], qb[e] = sq[e * kThreads + w];
      chan(s, sn[w], mb, qb);
      sn[t] = s.n;
#pragma unroll
      for (int e = 0; e < V; ++e) sm[e * kThreads + t] = s.mean[e], sq[e * kThreads + t] = s.m2[e];
    }
  }
}

struct Args {
  const void* x;
  float* ws;        // (2, row_groups, C): each block's mean, then its M2
  int* counters;    // one a channel group, 0 between calls
  float* out;       // (2, C): mean, then var
  int R, C, cols, rows, row_groups;
};

// A thread's chunk of kChunk rows as loaded: 16-byte vectors (Vec > 1) or values
template <typename T, int Vec>
using Raw = std::conditional_t<Vec == 1, T, uint4>;

template <typename T, int Vec>
__device__ __forceinline__ void unpack(const Raw<T, Vec>& r, float (&f)[Vec]) {
  if constexpr (Vec == 1) {
    f[0] = to_float(r);
  } else if constexpr (std::is_same_v<T, float>) {
    f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y), f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

// Grid (row_groups, col_groups) of kThreads; Vec 8 (bf16) or 4 (float32) channels a
// thread in 16-byte loads, or 1.
template <typename T, int Vec>
__global__ void __launch_bounds__(kThreads, 2) bn_stats_kernel(const Args a) {
  __shared__ float scratch[(1 + 2 * Vec) * kThreads];
  __shared__ int last;
  const int tid = threadIdx.x, g = blockIdx.x, cg = blockIdx.y;
  const int c0 = cg * a.cols, cw = min(a.cols, a.C - c0);  // this group's channels
  const int vg = cw / Vec;                                  // vectors a row
  const int Q = kThreads / vg;                              // row lanes
  const int q = tid / vg, j = tid % vg;
  const bool active = tid < Q * vg;
  const int S = kChunk * Q;                                 // rows a step: a chunk for each row lane
  const int r0 = g * a.rows, nr = min(a.rows, a.R - r0);
  const int steps = (nr + S - 1) / S;
  // lane q's rows in step `it`: q, q + Q, ... below the block's end, at most kChunk
  auto lane_rows = [&](int it) {
    const int n = nr - it * S;
    return active && it < steps && q < n ? min(kChunk, (n - q + Q - 1) / Q) : 0;
  };
  const T* base = static_cast<const T*>(a.x) + static_cast<size_t>(r0 + q) * a.C + c0 + j * Vec;
  auto load = [&](Raw<T, Vec> (&buf)[kChunk], int it, int k) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < k) buf[i] = *reinterpret_cast<const Raw<T, Vec>*>(base + static_cast<size_t>(it * S + Q * i) * a.C);
  };
  Stats<Vec> s;
  s.n = 0.0f;
#pragma unroll
  for (int e = 0; e < Vec; ++e) s.mean[e] = 0.0f, s.m2[e] = 0.0f;
  auto work = [&](const Raw<T, Vec> (&buf)[kChunk], int k) {
    if (k == 0) return;
    float v[kChunk][Vec];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < k) unpack<T, Vec>(buf[i], v[i]);
    add_chunk(s, v, k);
  };
  // two chunks in flight: the next one's loads go out before this one's arithmetic
  Raw<T, Vec> b0[kChunk], b1[kChunk];
  int k0 = lane_rows(0), k1;
  load(b0, 0, k0);
  for (int it = 0; it < steps; it += 2) {
    k1 = lane_rows(it + 1);
    load(b1, it + 1, k1);
    work(b0, k0);
    k0 = lane_rows(it + 2);
    load(b0, it + 2, k0);
    work(b1, k1);
  }

  // the block's partial
  tree(s, active, q, Q, j, vg, scratch);
  if (active && q == 0) {
    float* pm = a.ws + static_cast<size_t>(g) * a.C + c0 + j * Vec;
    store_f32(pm, s.mean);
    store_f32(pm + static_cast<size_t>(a.row_groups) * a.C, s.m2);
  }

  // the last block of the channel group combines the groups' partials in group order:
  // lane q takes groups [q * per, (q + 1) * per), then the lanes combine as above. The
  // ticket releases the block's partial (the barrier orders its writers before thread 0)
  // and acquires the others'.
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(a.counters[cg]);
    last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == a.row_groups - 1;
  }
  __syncthreads();
  if (!last) return;
  Stats<Vec> t;
  t.n = 0.0f;
#pragma unroll
  for (int e = 0; e < Vec; ++e) t.mean[e] = 0.0f, t.m2[e] = 0.0f;
  if (active) {
    const int per = (a.row_groups + Q - 1) / Q;
    const int h0 = min(a.row_groups, q * per), h1 = min(a.row_groups, h0 + per);
    const float* pm = a.ws + c0 + j * Vec;
    const float* pq = pm + static_cast<size_t>(a.row_groups) * a.C;
    constexpr int kBatch = 32 / Vec > 4 ? 4 : 32 / Vec;  // partials loaded at once: 32 floats of each
    for (int h = h0; h < h1; h += kBatch) {
      float mb[kBatch][Vec], qb[kBatch][Vec];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (h + b < h1) {
          load_cg(pm + static_cast<size_t>(h + b) * a.C, mb[b]);
          load_cg(pq + static_cast<size_t>(h + b) * a.C, qb[b]);
        }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (h + b < h1) chan(t, static_cast<float>(min(a.rows, a.R - (h + b) * a.rows)), mb[b], qb[b]);
    }
  }
  tree(t, active, q, Q, j, vg, scratch);
  if (active && q == 0) {
    float var[Vec];
#pragma unroll
    for (int e = 0; e < Vec; ++e) var[e] = t.m2[e] / static_cast<float>(a.R);
    store_f32(a.out + c0 + j * Vec, t.mean);
    store_f32(a.out + a.C + c0 + j * Vec, var);
  }
  if (tid == 0) a.counters[cg] = 0;
}

// dx (R, C) from x, mean, dmean, dvar. Grid (row blocks, channel groups of vb vectors);
// thread (q, j) of a block owns vector j of its group and rows blockIdx.x * Q + q, then
// every gridDim.x * Q rows.
template <typename T, int Vec>
__global__ void __launch_bounds__(kThreads) bn_stats_backward_kernel(const T* __restrict__ x,
                                                                     const float* __restrict__ mean,
                                                                     const float* __restrict__ dmean,
                                                                     const float* __restrict__ dvar,
                                                                     T* __restrict__ dx, int R, int C, int vb,
                                                                     float n) {
  constexpr int U = 8;  // loads in flight a thread
  const int tid = threadIdx.x;
  const int Q = kThreads / vb, q = tid / vb, j = tid % vb;
  const int c = (blockIdx.y * vb + j) * Vec;
  if (tid >= Q * vb || c >= C) return;
  float m[Vec], ca[Vec], cb[Vec];
  load_cg(mean + c, m);
  load_cg(dmean + c, ca);
  load_cg(dvar + c, cb);
#pragma unroll
  for (int e = 0; e < Vec; ++e) ca[e] = ca[e] / n, cb[e] = cb[e] * 2.0f;
  const size_t step = static_cast<size_t>(gridDim.x) * Q;
  for (size_t r0 = static_cast<size_t>(blockIdx.x) * Q + q; r0 < static_cast<size_t>(R); r0 += U * step) {
    Raw<T, Vec> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * step < static_cast<size_t>(R))
        raw[u] = *reinterpret_cast<const Raw<T, Vec>*>(x + (r0 + u * step) * C + c);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * step < static_cast<size_t>(R)) {
        float v[Vec], o[Vec];
        unpack<T, Vec>(raw[u], v);
#pragma unroll
        for (int e = 0; e < Vec; ++e) {
          const float d = v[e] - m[e];
          const float p = cb[e] * d;
          o[e] = ca[e] + p / n;
        }
        store_vec<T, Vec>(dx + (r0 + u * step) * C + c, o);
      }
  }
}

template <typename T, int Vec>
cudaError_t launch_forward(const Args& a, int col_groups, cudaStream_t stream) {
  bn_stats_kernel<T, Vec><<<dim3(a.row_groups, col_groups), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int Vec>
cudaError_t launch_backward(const void* x, const void* mean, const void* dmean, const void* dvar, void* dx, int R,
                            int C, int sms, cudaStream_t stream) {
  const int vecs = C / Vec;
  const int vb = vecs < kThreads ? vecs : kThreads;
  const int groups = (vecs + vb - 1) / vb, Q = kThreads / vb;
  if (groups > 65535) return cudaErrorInvalidValue;
  const long long want = 4LL * sms / groups;  // four 256-thread blocks an SM
  const long long rows = (static_cast<long long>(R) + Q - 1) / Q;
  const int blocks = static_cast<int>(rows < want ? rows : (want > 0 ? want : 1));
  bn_stats_backward_kernel<T, Vec><<<dim3(blocks, groups), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean), static_cast<const float*>(dmean),
      static_cast<const float*>(dvar), static_cast<T*>(dx), R, C, vb, static_cast<float>(R));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// n pieces of `size` cover `extent` exactly: none missing, none empty
bool covers(int n, int size, int extent) {
  return n >= 1 && size >= 1 && static_cast<long long>(n) * size >= extent &&
         static_cast<long long>(n - 1) * size < extent;
}

}  // namespace
}  // namespace mdhs

// The statistics of x (R, C) on the plan of ops/bn_stats.py::plan, its one source. dtype:
// 0 float32, 1 bf16. vec: 16 bytes of channels a thread (4 float32, 8 bf16; needs C a
// multiple of it and x 16-byte aligned) or 1. col_groups groups of `cols` channels (a
// multiple of vec, at most 256 vectors) cover C; row_groups groups of `rows` rows cover
// R, R < 2^24. ws holds 2 * row_groups * C floats; counters col_groups ints, zero (the
// kernel leaves them zero); out (2, C) float32: mean, then the biased variance.
extern "C" int bn_stats_forward(const void* x, int dtype, void* ws, void* counters, void* out, int R, int C,
                                int vec, int col_groups, int cols, int row_groups, int rows, void* stream) {
  using namespace mdhs;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (R < 1 || R >= (1 << 24) || C < 1) return cudaErrorInvalidValue;
  if (vec != 1 && (vec != 16 / itemsize || C % vec != 0 || cols % vec != 0 || !aligned16(x)))
    return cudaErrorInvalidValue;
  if (cols / vec > kThreads || !covers(col_groups, cols, C) || !covers(row_groups, rows, R) || col_groups > 65535)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<float*>(out);
  a.R = R;
  a.C = C;
  a.cols = cols;
  a.rows = rows;
  a.row_groups = row_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return vec > 1 ? launch_forward<float, 4>(a, col_groups, s) : launch_forward<float, 1>(a, col_groups, s);
  return vec > 1 ? launch_forward<bf16, 8>(a, col_groups, s) : launch_forward<bf16, 1>(a, col_groups, s);
}

// dx (R, C), x's dtype, from x (R, C), mean, dmean, dvar (C,) float32; sms the card's SM
// count. 16-byte vectors where C * itemsize is a multiple of 16 and every pointer is
// 16-byte aligned, one value a thread otherwise.
extern "C" int bn_stats_backward(const void* x, int dtype, const void* mean, const void* dmean, const void* dvar,
                                 void* dx, int R, int C, int sms, void* stream) {
  using namespace mdhs;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (R < 1 || R >= (1 << 24) || C < 1 || sms < 1) return cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool vector = (static_cast<long long>(C) * itemsize) % 16 == 0 && aligned16(x) && aligned16(dx) &&
                      aligned16(mean) && aligned16(dmean) && aligned16(dvar);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch_backward<float, 4>(x, mean, dmean, dvar, dx, R, C, sms, s)
                  : launch_backward<float, 1>(x, mean, dmean, dvar, dx, R, C, sms, s);
  return vector ? launch_backward<bf16, 8>(x, mean, dmean, dvar, dx, R, C, sms, s)
                : launch_backward<bf16, 1>(x, mean, dmean, dvar, dx, R, C, sms, s);
}
